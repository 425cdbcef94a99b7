"""Symbolic (structure-only) analysis for block-sparse Jacobians
(counterpart of libdogleg_tpu/sparsity.py).

The reference analyses the sparsity pattern once per problem with
cholmod_analyze (reference dogleg.c:649-654), since the pattern of zeros
stays the same. Here that analysis is a static block pattern computed on the
host with numpy. (The JAX package's C++ fast path for very large patterns is
not ported.)
"""

from __future__ import annotations

import numpy as np

from libdogleg_tpu_torch.ops.bcsr import BCSRStructure


def _check_divisible(nmeas, nstate, block_rows, block_cols) -> None:
    if nmeas % block_rows or nstate % block_cols:
        raise ValueError(f"({nmeas}, {nstate}) does not divide into "
                         f"({block_rows}, {block_cols}) blocks")


def bcsr_from_scalar_csr(rowptr: np.ndarray,
                         colidx: np.ndarray,
                         nmeas: int,
                         nstate: int,
                         block_rows: int = 1,
                         block_cols: int = 1) -> BCSRStructure:
    """A block sparsity pattern from a scalar CSR pattern (the reference's
    J CSR layout, dogleg.h:11-20, sample.c:89-125): block (br, bc) is stored
    iff any scalar nonzero falls inside it. nmeas and nstate must divide
    into the block sizes (pad the problem otherwise)."""
    _check_divisible(nmeas, nstate, block_rows, block_cols)
    nbrow = nmeas // block_rows
    indptr = np.zeros(nbrow + 1, dtype=np.int32)
    rowptr = np.asarray(rowptr)
    colidx = np.asarray(colidx)
    per_row = []
    for br in range(nbrow):
        lo = rowptr[br * block_rows]
        hi = rowptr[(br + 1) * block_rows]
        cols = np.unique(colidx[lo:hi] // block_cols).astype(np.int32)
        per_row.append(cols)
        indptr[br + 1] = indptr[br] + len(cols)
    indices = np.concatenate(per_row) if per_row else np.zeros(0, np.int32)
    return BCSRStructure(nmeas=nmeas, nstate=nstate, block_rows=block_rows,
                         block_cols=block_cols, indptr=indptr,
                         indices=indices)


def dense_structure(nmeas: int, nstate: int,
                    block_rows: int = 1,
                    block_cols: int = 1) -> BCSRStructure:
    """Fully dense block pattern (every block stored)."""
    _check_divisible(nmeas, nstate, block_rows, block_cols)
    nbrow = nmeas // block_rows
    nbcol = nstate // block_cols
    indptr = np.arange(nbrow + 1, dtype=np.int32) * nbcol
    indices = np.tile(np.arange(nbcol, dtype=np.int32), nbrow)
    return BCSRStructure(nmeas=nmeas, nstate=nstate, block_rows=block_rows,
                         block_cols=block_cols, indptr=indptr,
                         indices=indices)
