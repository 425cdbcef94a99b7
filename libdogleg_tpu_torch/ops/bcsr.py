"""Block-CSR Jacobian storage and products (counterpart of
libdogleg_tpu/ops/bcsr.py).

The reference stores sparse Jacobians in scalar CSR and loops over nonzeros
one double at a time (reference dogleg.h:11-20, dogleg.c:249-281). Here the
Jacobian is block-CSR: a static block sparsity pattern, fixed per problem
(the reference's one-time symbolic analysis, dogleg.c:649-654), plus a dense
(nnzb, bm, bn) value tensor, so every product is a batch of dense block
contractions and a segment sum. The structure is numpy metadata on the
host, identical to the JAX one.

The products (bcsr_jt_x, bcsr_matvec, bcsr_jtj_lower_blocks,
bcsr_jtj_dense) work out of place, so that torch.func.vmap batches a
products function built from them, and sum in a fixed order, so that a
solve gives the same bits on every run: on a CUDA device
bcsr_jtj_lower_blocks forms its blocks with kernel K3
(ops/bcsr_kernels.py), and bcsr_jt_x, bcsr_matvec and bcsr_jtj_dense add
their block contractions through ops/segsum.py's plan, in index order per
target (what index_add and index_put_'s accumulation do on the CPU, where
their atomics on the card would not). bcsr_to_dense writes each block once.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from libdogleg_tpu_torch.ops import segsum


class BCSRStructure(NamedTuple):
    """Static block sparsity pattern of a (nmeas x nstate) Jacobian tiled
    into (block_rows x block_cols) blocks. Host-side metadata, fixed per
    problem (reference dogleg.c:649-654)."""
    nmeas: int
    nstate: int
    block_rows: int                 # bm: measurement rows per block
    block_cols: int                 # bn: state columns per block
    indptr: np.ndarray              # (nbrow + 1,) int32: CSR over block rows
    indices: np.ndarray             # (nnzb,) int32: block column of each block

    @property
    def nbrow(self) -> int:
        return self.nmeas // self.block_rows

    @property
    def nbcol(self) -> int:
        return self.nstate // self.block_cols

    @property
    def nnzb(self) -> int:
        return int(self.indices.shape[0])

    def row_of_block(self) -> np.ndarray:
        """(nnzb,) block-row index of each stored block."""
        counts = np.diff(self.indptr)
        return np.repeat(np.arange(self.nbrow, dtype=np.int32),
                         counts).astype(np.int32)

    def jtj_pairs(self) -> tuple[np.ndarray, np.ndarray]:
        """All ordered pairs (i, j) of stored blocks sharing a block row:
        the static schedule for forming J^T J block by block, row by row
        and row-major within a row (the JAX package's loop, vectorized)."""
        counts = np.diff(np.asarray(self.indptr, np.int64))
        sq = counts * counts
        start = np.repeat(np.asarray(self.indptr[:-1], np.int64), sq)
        width = np.repeat(counts, sq)
        local = np.arange(int(sq.sum())) - np.repeat(np.cumsum(sq) - sq, sq)
        return ((start + local // width).astype(np.int32),
                (start + local % width).astype(np.int32))


class BCSRJacobian(NamedTuple):
    """A block-CSR Jacobian: static structure + block values."""
    structure: BCSRStructure
    values: torch.Tensor  # (nnzb, block_rows, block_cols)


def _index(a, like: torch.Tensor) -> torch.Tensor:
    """An index array as an int64 tensor on like's device: a numpy array is
    copied there, a tensor already there is taken as it is."""
    if isinstance(a, torch.Tensor):
        return a.to(device=like.device, dtype=torch.int64)
    return torch.as_tensor(np.asarray(a, np.int64), device=like.device)


def dense_to_bcsr_values(J: torch.Tensor, s: BCSRStructure) -> torch.Tensor:
    """The stored blocks of a dense (nmeas, nstate) J."""
    Jb = J.reshape(s.nbrow, s.block_rows, s.nbcol, s.block_cols)
    Jb = Jb.permute(0, 2, 1, 3)  # (nbrow, nbcol, bm, bn)
    return Jb[_index(s.row_of_block(), J), _index(s.indices, J)]


def bcsr_to_dense(J: BCSRJacobian) -> torch.Tensor:
    """Densify (O(nmeas * nstate) memory)."""
    s, v = J.structure, J.values
    out = torch.zeros((s.nbrow, s.nbcol, s.block_rows, s.block_cols),
                      dtype=v.dtype, device=v.device)
    out.index_put_((_index(s.row_of_block(), v), _index(s.indices, v)), v,
                   accumulate=True)
    return out.permute(0, 2, 1, 3).reshape(s.nmeas, s.nstate)


def bcsr_jt_x(J: BCSRJacobian, x: torch.Tensor) -> torch.Tensor:
    """J^T x: per-block (bm, bn)^T @ (bm,) contractions and a segment sum
    over block columns (reference mul_spmatrix_densevector,
    dogleg.c:249-261)."""
    s, v = J.structure, J.values
    xg = x.reshape(s.nbrow, s.block_rows)[_index(s.row_of_block(), v)]
    partial = (v.mT @ xg[..., None])[..., 0]          # (nnzb, bn)
    out = partial.new_zeros((s.nbcol, s.block_cols))
    plan = segsum.plan_of(s.indices, "cols", lambda: s.indices)
    return segsum.add(out, 0, plan, partial).reshape(s.nstate)


def bcsr_matvec(J: BCSRJacobian, vec: torch.Tensor) -> torch.Tensor:
    """J v: the forward product (reference
    norm2_mul_spmatrix_t_densevector's inner loop, dogleg.c:262-281)."""
    s, v = J.structure, J.values
    vg = vec.reshape(s.nbcol, s.block_cols)[_index(s.indices, v)]
    partial = (v @ vg[..., None])[..., 0]             # (nnzb, bm)
    out = partial.new_zeros((s.nbrow, s.block_rows))
    plan = segsum.plan_of(s.indptr, "rows", s.row_of_block)
    return segsum.add(out, 0, plan, partial).reshape(s.nmeas)


class JtJLowerSchedule(NamedTuple):
    """Static schedule for the lower triangle of J^T J as block-sparse
    values in the input layout of sparse_cholesky.analyze: output block k
    holds JtJ[rows[k], cols[k]] (block coordinates, rows >= cols). The
    one-time symbolic artifact of the sparse path (the other half of the
    reference's cholmod_analyze, dogleg.c:649-654)."""
    rows: np.ndarray      # (nnzb_jtj,) output block-row (state) coords
    cols: np.ndarray      # (nnzb_jtj,) output block-col, rows >= cols
    pair_i: np.ndarray    # (npairs,) index into J.values
    pair_j: np.ndarray    # (npairs,) index into J.values
    out_idx: np.ndarray   # (npairs,) output block per pair


def jtj_lower_schedule(s: BCSRStructure) -> JtJLowerSchedule:
    """Lower-triangle JtJ block pattern and pair schedule for `s`: the
    output-sorted schedule of ops/bcsr_kernels.build_jtj_schedule filtered
    to rows >= cols (the JAX package's arrays)."""
    from libdogleg_tpu_torch.ops.bcsr_kernels import build_jtj_schedule
    sch = build_jtj_schedule(s)
    keep_block = sch.out_ci >= sch.out_cj
    new_id = np.cumsum(keep_block) - 1
    keep_pair = keep_block[sch.out_idx]
    return JtJLowerSchedule(
        rows=sch.out_ci[keep_block].astype(np.int64),
        cols=sch.out_cj[keep_block].astype(np.int64),
        pair_i=sch.pair_i[keep_pair],
        pair_j=sch.pair_j[keep_pair],
        out_idx=new_id[sch.out_idx[keep_pair]].astype(np.int32))


def jtj_pair_sum(values: torch.Tensor, pair_i, pair_j, out_idx,
                 nout: int) -> torch.Tensor:
    """out[o] = sum over the pairs k with out_idx[k] = o of
    values[pair_i[k]]^T values[pair_j[k]]: one batched product and one
    segment sum, out of place. values (..., nnzb, bm, bn) with any leading
    axes give (..., nout, bn, bn). Kernel K3's plain version."""
    contrib = (values.index_select(-3, _index(pair_i, values)).mT
               @ values.index_select(-3, _index(pair_j, values)))
    out = contrib.new_zeros(contrib.shape[:-3] + (nout,)
                            + contrib.shape[-2:])
    return out.index_add(-3, _index(out_idx, values), contrib)


def bcsr_jtj_lower_blocks(J: BCSRJacobian,
                          sched: JtJLowerSchedule) -> torch.Tensor:
    """The stored lower-triangle blocks of J^T J, (nnzb_jtj, bn, bn) in the
    schedule's (rows, cols) order: the input of sparse_cholesky.factorize;
    JtJ never densifies. CUDA values go to kernel K3, one launch for a
    whole batch under torch.func.vmap (a structure or dtype outside
    bcsr_kernels.supports_kernels raises there); CPU values to
    jtj_pair_sum, its plain version. The schedule's pair_i, pair_j and
    out_idx may be numpy arrays or int64 tensors on the values' device."""
    v = J.values
    if v.device.type == "cuda":
        from libdogleg_tpu_torch.ops import bcsr_kernels
        return bcsr_kernels.bcsr_jtj_lower_kernel(J, sched)
    return jtj_pair_sum(v, sched.pair_i, sched.pair_j, sched.out_idx,
                        int(sched.rows.shape[0]))


def bcsr_jtj_dense(J: BCSRJacobian) -> torch.Tensor:
    """J^T J as a dense (nstate, nstate) matrix, formed block by block: the
    static list of same-row block pairs as one batched product, then a
    scatter-add into block coordinates (the reference's packed outer-product
    accumulation, dogleg.c:709-714), in a fixed order: each block's pair
    products in schedule order, as index_put_(accumulate=True) adds them
    on the CPU. For moderate nstate; the block-sparse JtJ and sparse
    Cholesky cover large ones."""
    s, v = J.structure, J.values
    pi, pj = s.jtj_pairs()
    contrib = v[_index(pi, v)].mT @ v[_index(pj, v)]  # (npairs, bn, bn)
    # the pairs' (ci, cj) blocks, flattened; new_zeros is batched under vmap
    plan = segsum.plan_of(s.indptr, f"jtj_dense/{s.nbcol}", lambda: (
        s.indices[pi].astype(np.int64) * s.nbcol + s.indices[pj]),
        also=s.indices)
    out = segsum.add_(contrib.new_zeros((s.nbcol * s.nbcol, s.block_cols,
                                         s.block_cols)), 0, plan, contrib)
    return out.reshape(s.nbcol, s.nbcol, s.block_cols, s.block_cols
                       ).permute(0, 2, 1, 3).reshape(s.nstate, s.nstate)
