"""Kernels K3 and K4: block-sparse Jacobian products in CUDA (counterpart of
libdogleg_tpu/ops/pallas_bcsr.py).

K3 forms the blocks of J^T J over a static schedule of block pairs sorted by
output block (`build_jtj_schedule`, the host-side symbolic analysis); K4
forms J v. Both are opt-in, as in the JAX package: SparseProblem.products
uses the plain ops of ops/bcsr.py. Each kernel's wrapper launches the
hand-written kernel in csrc/bcsr.cu for CUDA tensors and runs its plain twin
(`*_reference`) for CPU tensors; a CUDA tensor launches the kernel or
raises.

A structure's and a schedule's index arrays are numpy arrays on the host.
The wrappers copy each to the card once (`device_indices`) and keep the
tensor for as long as the array lives, so a second product on one structure
copies nothing. The arrays are static by contract: one changed in place
after its first product would leave a stale copy behind.
"""

from __future__ import annotations

import weakref
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from libdogleg_tpu_torch.native.loader import launch_target, load_library
from libdogleg_tpu_torch.ops.bcsr import (BCSRJacobian, BCSRStructure,
                                         _index, bcsr_matvec)

# Kernel launches made in this process, per wrapper.
launch_counts = {"bcsr_jtj_blocks_kernel": 0, "bcsr_matvec_kernel": 0}


class JtJSchedule(NamedTuple):
    """Static work list for block-JtJ formation: one block product per pair
    of stored blocks sharing a block row, pairs sorted by output block so
    that each output block is one contiguous run (the one-time symbolic
    analysis, reference dogleg.c:649-654)."""
    pair_i: np.ndarray    # (npairs,) int32 index into values
    pair_j: np.ndarray    # (npairs,) int32 index into values
    out_idx: np.ndarray   # (npairs,) int32 index into the output block list
    out_ci: np.ndarray    # (nnzb_out,) block-row (state) coordinate
    out_cj: np.ndarray    # (nnzb_out,) block-col (state) coordinate


def build_jtj_schedule(s: BCSRStructure) -> JtJSchedule:
    """The schedule of pallas_bcsr.py:64-75, in numpy: identical arrays to
    the JAX package's (whose native C++ fast path is not ported)."""
    pi, pj = s.jtj_pairs()
    ci = s.indices[pi]
    cj = s.indices[pj]
    order = np.lexsort((cj, ci))
    pi, pj, ci, cj = pi[order], pj[order], ci[order], cj[order]
    keys = ci.astype(np.int64) * s.nbcol + cj
    uniq, out_idx = np.unique(keys, return_inverse=True)
    return JtJSchedule(pair_i=pi.astype(np.int32),
                       pair_j=pj.astype(np.int32),
                       out_idx=out_idx.astype(np.int32),
                       out_ci=(uniq // s.nbcol).astype(np.int32),
                       out_cj=(uniq % s.nbcol).astype(np.int32))


def supports_kernels(s: BCSRStructure, dtype=torch.float32) -> bool:
    """Whether the CUDA kernels take this structure and dtype: any block
    shape, float32 or float64 values, and index ranges within int32. (The
    TPU kernels wanted (8, 128)-friendly blocks; these do not.)"""
    return (dtype in (torch.float32, torch.float64)
            and s.nnzb * s.block_rows * s.block_cols < 2 ** 31
            and s.nmeas < 2 ** 31)


def _check(J: BCSRJacobian) -> None:
    v, s = J.values, J.structure
    if tuple(v.shape) != (s.nnzb, s.block_rows, s.block_cols):
        raise ValueError(f"values must be {(s.nnzb, s.block_rows, s.block_cols)}"
                         f", got {tuple(v.shape)}")
    if not supports_kernels(s, v.dtype):
        raise ValueError("structure or dtype outside the kernels' range "
                         "(see supports_kernels)")


# id(owner array) -> {(name, device): int32 tensor}; an entry goes when its
# owner is collected.
_DEVICE_INDICES: dict = {}


def device_indices(owner: np.ndarray, device, name: str = "",
                   make: Optional[Callable[[], np.ndarray]] = None
                   ) -> torch.Tensor:
    """The index array `owner` (or, with `make`, an array derived from it,
    told apart by `name`) as an int32 tensor on `device`: copied there once
    and kept for as long as `owner` lives."""
    if not isinstance(device, torch.device):
        device = torch.device(device)
    held = _DEVICE_INDICES.get(id(owner))
    if held is None:
        held = _DEVICE_INDICES[id(owner)] = {}
        weakref.finalize(owner, _DEVICE_INDICES.pop, id(owner), None)
    t = held.get((name, device))
    if t is None:
        a = owner if make is None else make()
        # a copy on every device: a tensor sharing the array's memory would
        # keep the owner alive
        t = held[(name, device)] = torch.tensor(
            np.ascontiguousarray(a, np.int32), device=device)
    return t


def _run_ptr(schedule: JtJSchedule) -> np.ndarray:
    """Offsets of each output block's run in the output-sorted schedule."""
    counts = np.bincount(schedule.out_idx,
                         minlength=int(schedule.out_ci.shape[0]))
    return np.concatenate([[0], np.cumsum(counts)])


def _jtj_operands(schedule: JtJSchedule) -> np.ndarray:
    """K3's int32 operands in one array: pair_i, pair_j, then the run
    pointers, so that a product finds them on the card with one lookup."""
    return np.concatenate([schedule.pair_i, schedule.pair_j,
                           _run_ptr(schedule)])


def matvec_instance(bm: int, bn: int, dtype) -> str:
    """Which of K4's kernels csrc/bcsr.cu launches for 16-byte-aligned
    (bm, bn) blocks of `dtype`: "words" (a group of lanes per block row, one
    16-byte word of a block per lane) for the grid model's (8, 8) blocks,
    "rows" (one thread per measurement row, any block shape) otherwise, as
    for operands that are not aligned. The launcher decides; this names its
    rule."""
    if (bm, bn) == (8, 8) and dtype in (torch.float32, torch.float64):
        return "words"
    return "rows"


def jtj_instance(bm: int, bn: int, dtype) -> str:
    """Which of K3's kernels csrc/bcsr.cu launches for 16-byte-aligned
    (bm, bn) blocks of `dtype`: "words" (a group of lanes per output block,
    one 16-byte word of it per lane) for the grid model's (8, 8) blocks,
    "entries" (a thread block per output block, a thread per entry, any
    block shape) otherwise, as for values that are not aligned. Both sum in
    the same order. The launcher decides; this names its rule."""
    if (bm, bn) == (8, 8) and dtype in (torch.float32, torch.float64):
        return "words"
    return "entries"


def bcsr_jtj_blocks_reference(J: BCSRJacobian,
                              schedule: JtJSchedule) -> torch.Tensor:
    """K3's plain twin: (nnzb_out, bn, bn) blocks of J^T J in the schedule's
    output order."""
    v = J.values
    contrib = (v[_index(schedule.pair_i, v)].mT
               @ v[_index(schedule.pair_j, v)])
    bn = J.structure.block_cols
    out = torch.zeros((schedule.out_ci.shape[0], bn, bn), dtype=v.dtype,
                      device=v.device)
    return out.index_add_(0, _index(schedule.out_idx, v), contrib)


def bcsr_jtj_blocks_kernel(J: BCSRJacobian,
                           schedule: Optional[JtJSchedule] = None):
    """Block-sparse J^T J. Returns (blocks (nnzb_out, bn, bn), schedule):
    the blocks in the schedule's output pattern; jtj_blocks_to_dense
    materializes them. CUDA values go to kernel K3 (of its two kernels the
    one `jtj_instance` names), CPU values to bcsr_jtj_blocks_reference."""
    _check(J)
    if schedule is None:
        schedule = build_jtj_schedule(J.structure)
    v = J.values
    if v.device.type == "cpu":
        return bcsr_jtj_blocks_reference(J, schedule), schedule
    if v.device.type != "cuda":
        raise ValueError(f"no kernel for device {v.device}")
    lib = load_library()
    entry = (lib.dogleg_bcsr_jtj_f32 if v.dtype == torch.float32
             else lib.dogleg_bcsr_jtj_f64)
    s = J.structure
    nout = int(schedule.out_ci.shape[0])
    npairs = int(schedule.pair_i.shape[0])
    vals = v.contiguous()
    ops = device_indices(schedule.out_idx, v.device, "jtj",
                         lambda: _jtj_operands(schedule)).data_ptr()
    out = torch.empty((nout, s.block_cols, s.block_cols), dtype=v.dtype,
                      device=v.device)
    err = entry(vals.data_ptr(), s.block_rows, s.block_cols, ops,
                ops + 4 * npairs, ops + 8 * npairs, nout, out.data_ptr(),
                *launch_target(v.device))
    if err:
        raise RuntimeError(f"bcsr_jtj_blocks_kernel launch failed: "
                           f"cudaError_t {err}")
    launch_counts["bcsr_jtj_blocks_kernel"] += 1
    return out, schedule


def jtj_blocks_to_dense(blocks: torch.Tensor, schedule: JtJSchedule,
                        s: BCSRStructure) -> torch.Tensor:
    """Scatter schedule-ordered JtJ blocks into a dense (nstate, nstate)
    matrix (one write per output block, no accumulation)."""
    out = torch.zeros((s.nbcol, s.nbcol, s.block_cols, s.block_cols),
                      dtype=blocks.dtype, device=blocks.device)
    out[_index(schedule.out_ci, blocks),
        _index(schedule.out_cj, blocks)] = blocks
    return out.permute(0, 2, 1, 3).reshape(s.nstate, s.nstate)


def bcsr_jtj_dense_kernel(J: BCSRJacobian,
                          schedule: Optional[JtJSchedule] = None
                          ) -> torch.Tensor:
    """Dense J^T J through bcsr_jtj_blocks_kernel."""
    blocks, schedule = bcsr_jtj_blocks_kernel(J, schedule)
    return jtj_blocks_to_dense(blocks, schedule, J.structure)


def bcsr_matvec_reference(J: BCSRJacobian, vec: torch.Tensor) -> torch.Tensor:
    """K4's plain twin: J v as a gather, a batched product and a segment
    sum (ops/bcsr.bcsr_matvec)."""
    return bcsr_matvec(J, vec)


def bcsr_matvec_kernel(J: BCSRJacobian, vec: torch.Tensor) -> torch.Tensor:
    """J v for a (nstate,) vector. CUDA values go to kernel K4 (of its two
    kernels the one `matvec_instance` names), CPU values to
    bcsr_matvec_reference."""
    _check(J)
    s, v = J.structure, J.values
    if (tuple(vec.shape) != (s.nstate,) or vec.dtype != v.dtype
            or vec.device != v.device):
        raise ValueError(f"v must be ({s.nstate},) of {v.dtype} on "
                         f"{v.device}")
    if v.device.type == "cpu":
        return bcsr_matvec_reference(J, vec)
    if v.device.type != "cuda":
        raise ValueError(f"no kernel for device {v.device}")
    lib = load_library()
    entry = (lib.dogleg_bcsr_matvec_f32 if v.dtype == torch.float32
             else lib.dogleg_bcsr_matvec_f64)
    vals, x = v.contiguous(), vec.contiguous()
    indptr = device_indices(s.indptr, v.device)
    indices = device_indices(s.indices, v.device)
    out = torch.empty(s.nmeas, dtype=v.dtype, device=v.device)
    err = entry(vals.data_ptr(), s.block_rows, s.block_cols,
                indptr.data_ptr(), indices.data_ptr(), x.data_ptr(), s.nmeas,
                out.data_ptr(), *launch_target(v.device))
    if err:
        raise RuntimeError(f"bcsr_matvec_kernel launch failed: "
                           f"cudaError_t {err}")
    launch_counts["bcsr_matvec_kernel"] += 1
    return out
