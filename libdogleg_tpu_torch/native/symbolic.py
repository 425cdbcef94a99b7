"""ctypes wrappers over the host library of the symbolic analysis
(csrc/host/*.cpp, built by loader.build_host), with the numpy signatures of
the Python forms they stand in for (counterpart of
libdogleg_tpu/native/symbolic.py). Each returns None when the library is
unavailable; its caller then runs the Python form."""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np

from libdogleg_tpu_torch.native.loader import load_host_library

# Calls answered by the host library in this process, per wrapper.
native_calls = {"mindeg": 0, "jtj_schedule": 0, "chol_symbolic": 0,
                "bcsr_pattern": 0}


def _i32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _i64p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def mindeg_native(rows: np.ndarray, cols: np.ndarray,
                  n: int) -> Optional[np.ndarray]:
    """ordering._mindeg_python's permutation (the same tie-breaking), or
    None."""
    lib = load_host_library()
    if lib is None:
        return None
    rows = np.ascontiguousarray(rows, np.int32)
    cols = np.ascontiguousarray(cols, np.int32)
    perm = np.empty(n, np.int32)
    lib.mindeg_order(_i32p(rows), _i32p(cols), rows.shape[0], n,
                     _i32p(perm))
    native_calls["mindeg"] += 1
    return perm


def jtj_schedule_native(indptr: np.ndarray, indices: np.ndarray,
                        nbcol: int) -> Optional[Tuple[np.ndarray, ...]]:
    """The output-sorted JtJ pair schedule (pair_i, pair_j, out_idx, out_ci,
    out_cj), bcsr_kernels.build_jtj_schedule's arrays, or None."""
    lib = load_host_library()
    if lib is None:
        return None
    indptr = np.ascontiguousarray(indptr, np.int32)
    indices = np.ascontiguousarray(indices, np.int32)
    nbrow = len(indptr) - 1
    npairs = lib.jtj_pair_count(_i32p(indptr), nbrow)
    pair_i = np.empty(npairs, np.int32)
    pair_j = np.empty(npairs, np.int32)
    out_idx = np.empty(npairs, np.int32)
    out_ci = np.empty(max(npairs, 1), np.int32)
    out_cj = np.empty(max(npairs, 1), np.int32)
    nblocks = lib.jtj_schedule(_i32p(indptr), _i32p(indices), nbrow,
                               int(nbcol), _i32p(pair_i), _i32p(pair_j),
                               _i32p(out_idx), _i32p(out_ci), _i32p(out_cj))
    native_calls["jtj_schedule"] += 1
    return (pair_i, pair_j, out_idx,
            out_ci[:nblocks].copy(), out_cj[:nblocks].copy())


def chol_symbolic_native(rows: np.ndarray, cols: np.ndarray, nb: int):
    """sparse_cholesky._symbolic_python's outputs (rows, cols,
    a_slot_of_input, OpSchedule, forward SolveSchedule, backward
    SolveSchedule) for the permuted lower pattern, or None."""
    from libdogleg_tpu_torch.sparse_cholesky import OpSchedule, SolveSchedule
    lib = load_host_library()
    if lib is None:
        return None
    rows = np.ascontiguousarray(rows, np.int32)
    cols = np.ascontiguousarray(cols, np.int32)
    h = lib.chol_symbolic_build(_i32p(rows), _i32p(cols), rows.shape[0], nb)
    try:
        counts = np.empty(12, np.int64)
        lib.chol_symbolic_counts(ctypes.c_void_p(h), _i64p(counts))
        (nslots, nlevels, n_upd, n_fac, n_sol, n_fwd_lv, n_fwd_p, n_fwd_d,
         n_bwd_lv, n_bwd_p, n_bwd_d, n_input) = (int(c) for c in counts)

        def e(n):
            return np.empty(n, np.int32)
        out_rows, out_cols, a_slot = e(nslots), e(nslots), e(n_input)
        ut, ui, uj, uoff = e(n_upd), e(n_upd), e(n_upd), e(nlevels + 1)
        fac, foff = e(n_fac), e(nlevels + 1)
        st, sd, soff = e(n_sol), e(n_sol), e(nlevels + 1)
        fwd = [e(n_fwd_p), e(n_fwd_p), e(n_fwd_p), e(n_fwd_lv + 1),
               e(n_fwd_d), e(n_fwd_d), e(n_fwd_lv + 1)]
        bwd = [e(n_bwd_p), e(n_bwd_p), e(n_bwd_p), e(n_bwd_lv + 1),
               e(n_bwd_d), e(n_bwd_d), e(n_bwd_lv + 1)]
        lib.chol_symbolic_export(
            ctypes.c_void_p(h),
            *map(_i32p, (out_rows, out_cols, a_slot, ut, ui, uj, uoff, fac,
                         foff, st, sd, soff, *fwd, *bwd)))
    finally:
        lib.chol_symbolic_free(ctypes.c_void_p(h))
    sched = OpSchedule(upd_tgt=ut, upd_i=ui, upd_j=uj, upd_off=uoff,
                       fac=fac, fac_off=foff,
                       sol_tgt=st, sol_diag=sd, sol_off=soff)
    native_calls["chol_symbolic"] += 1
    return (out_rows, out_cols, a_slot, sched, SolveSchedule(*fwd),
            SolveSchedule(*bwd))


def bcsr_pattern_native(rowptr: np.ndarray, colidx: np.ndarray,
                        nmeas: int, nstate: int,
                        block_rows: int, block_cols: int
                        ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """The block pattern (indptr, indices) of a scalar CSR pattern,
    sparsity.bcsr_from_scalar_csr's arrays, or None."""
    lib = load_host_library()
    if lib is None:
        return None
    rowptr = np.ascontiguousarray(rowptr, np.int64)
    colidx = np.ascontiguousarray(colidx, np.int32)
    indptr = np.empty(nmeas // block_rows + 1, np.int32)
    null = ctypes.cast(None, ctypes.POINTER(ctypes.c_int32))
    nnzb = lib.bcsr_block_pattern(_i64p(rowptr), _i32p(colidx), nmeas,
                                  nstate, block_rows, block_cols,
                                  _i32p(indptr), null)
    indices = np.empty(nnzb, np.int32)
    lib.bcsr_block_pattern(_i64p(rowptr), _i32p(colidx), nmeas, nstate,
                           block_rows, block_cols, _i32p(indptr),
                           _i32p(indices))
    native_calls["bcsr_pattern"] += 1
    return indptr, indices
