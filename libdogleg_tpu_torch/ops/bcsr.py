"""Block-CSR Jacobian storage and products (counterpart of
libdogleg_tpu/ops/bcsr.py:25-118,165-185).

The reference stores sparse Jacobians in scalar CSR and loops over nonzeros
one double at a time (reference dogleg.h:11-20, dogleg.c:249-281). Here the
Jacobian is block-CSR: a static block sparsity pattern, fixed per problem
(the reference's one-time symbolic analysis, dogleg.c:649-654), plus a dense
(nnzb, bm, bn) value tensor, so every product is a batch of dense block
contractions and a segment sum (index_add_ / index_put_ with accumulate).
The structure is numpy metadata on the host, identical to the JAX one.

On a CUDA device index_add_ and index_put_(accumulate=True) add with atomics,
so the summation order, and the last bits of a sum, can differ from run to
run. The opt-in kernels of ops/bcsr_kernels.py (K3, K4) sum in a fixed order.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


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


def _index(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
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
    out = torch.zeros((s.nbcol, s.block_cols), dtype=v.dtype,
                      device=v.device)
    out.index_add_(0, _index(s.indices, v), partial)
    return out.reshape(s.nstate)


def bcsr_matvec(J: BCSRJacobian, vec: torch.Tensor) -> torch.Tensor:
    """J v: the forward product (reference
    norm2_mul_spmatrix_t_densevector's inner loop, dogleg.c:262-281)."""
    s, v = J.structure, J.values
    vg = vec.reshape(s.nbcol, s.block_cols)[_index(s.indices, v)]
    partial = (v @ vg[..., None])[..., 0]             # (nnzb, bm)
    out = torch.zeros((s.nbrow, s.block_rows), dtype=v.dtype,
                      device=v.device)
    out.index_add_(0, _index(s.row_of_block(), v), partial)
    return out.reshape(s.nmeas)


def bcsr_jtj_dense(J: BCSRJacobian) -> torch.Tensor:
    """J^T J as a dense (nstate, nstate) matrix, formed block by block: the
    static list of same-row block pairs as one batched product, then a
    scatter-add into block coordinates (the reference's packed outer-product
    accumulation, dogleg.c:709-714). For moderate nstate; the block-sparse
    JtJ and sparse Cholesky cover large ones."""
    s, v = J.structure, J.values
    pi, pj = s.jtj_pairs()
    contrib = v[_index(pi, v)].mT @ v[_index(pj, v)]  # (npairs, bn, bn)
    out = torch.zeros((s.nbcol, s.nbcol, s.block_cols, s.block_cols),
                      dtype=v.dtype, device=v.device)
    out.index_put_((_index(s.indices[pi], v), _index(s.indices[pj], v)),
                   contrib, accumulate=True)
    return out.permute(0, 2, 1, 3).reshape(s.nstate, s.nstate)
