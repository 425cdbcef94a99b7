"""Unrolled Cholesky for small static N (counterpart of
libdogleg_tpu/ops/smallchol.py).

For the batched small-problem regime the Gauss-Newton solve is a batch of
tiny (Nstate x Nstate) SPD systems. Unrolling the factorization and the
substitutions over the static N turns each into a short chain of whole-batch
elementwise ops, and gives a per-matrix `ok` flag instead of an exception
(the signal that replaces LAPACK's info, reference dogleg.c:667,806).
"""

from __future__ import annotations

import torch

# Above this, unrolling bloats the op count for no gain.
SMALL_N_MAX = 16


def small_cholesky(A: torch.Tensor):
    """Unrolled Cholesky-Crout of a (..., n, n) SPD matrix.

    Returns (L, ok): L lower-triangular (strict upper = 0), ok (...) = every
    pivot positive and finite. A failed pivot leaves NaN or inf in L.
    """
    n = A.shape[-1]
    L = [[None] * n for _ in range(n)]
    ok = None
    for j in range(n):
        s = A[..., j, j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        pivot_ok = (s > 0) & torch.isfinite(s)
        ok = pivot_ok if ok is None else (ok & pivot_ok)
        inv_d = torch.rsqrt(s)
        L[j][j] = s * inv_d  # == sqrt(s), one rsqrt + mul
        for i in range(j + 1, n):
            t = A[..., i, j]
            for k in range(j):
                t = t - L[i][k] * L[j][k]
            L[i][j] = t * inv_d
    zero = torch.zeros_like(A[..., 0, 0])
    rows = [torch.stack([L[i][j] if j <= i else zero for j in range(n)],
                        dim=-1) for i in range(n)]
    return torch.stack(rows, dim=-2), ok


def small_fwd_solve_mat(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve L Y = B for (..., n, k) right-hand sides: unrolled forward
    substitution, each step a (..., k) vector op dividing by the diagonal
    (as the JAX package does; small_cho_solve multiplies by a
    reciprocal). L's batch axes broadcast against B's."""
    n = L.shape[-1]
    Y = [None] * n
    for i in range(n):
        s = B[..., i, :]
        for m in range(i):
            s = s - L[..., i, m, None] * Y[m]
        Y[i] = s / L[..., i, i, None]
    return torch.stack(Y, dim=-2)


def small_bwd_solve_mat(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve L^T Z = B for (..., n, k) right-hand sides."""
    n = L.shape[-1]
    Z = [None] * n
    for i in reversed(range(n)):
        s = B[..., i, :]
        for m in range(i + 1, n):
            s = s - L[..., m, i, None] * Z[m]
        Z[i] = s / L[..., i, i, None]
    return torch.stack(Z, dim=-2)


def small_cho_solve_mat(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve (L L^T) Z = B for (..., n, k) right-hand sides."""
    return small_bwd_solve_mat(L, small_fwd_solve_mat(L, B))


def small_cho_solve(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unrolled forward and back substitution: solve (L L^T) z = b for one
    (..., n) right-hand side."""
    n = L.shape[-1]
    inv_d = [1.0 / L[..., i, i] for i in range(n)]
    y = [None] * n
    for i in range(n):
        s = b[..., i]
        for k in range(i):
            s = s - L[..., i, k] * y[k]
        y[i] = s * inv_d[i]
    z = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[..., k, i] * z[k]
        z[i] = s * inv_d[i]
    return torch.stack(z, dim=-1)
