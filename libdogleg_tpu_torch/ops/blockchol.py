"""Blocked Cholesky for mid-size n, 17..256 (counterpart of
libdogleg_tpu/ops/blockchol.py).

A right-looking blocked factorization with static 16-wide panels: the
unrolled 16x16 diagonal Cholesky of ops/smallchol.py, an unrolled 16-column
triangular solve for the panel below it, and the trailing update as one
batched matrix product. The reference's analog is LAPACK dpotrf's blocked
algorithm (reference dogleg.c:778-804). Plain torch: the JAX package leaves
this to XLA, and its Pallas twin (pallas_blockchol.py) is on no path.
"""

from __future__ import annotations

import torch

from libdogleg_tpu_torch.ops import smallchol

BLOCK = 16


def _pad_to_block(A: torch.Tensor, n: int, b: int):
    """Pad (..., n, n) to the next multiple of b with an identity diagonal
    block: [[A, 0], [0, I]] factors as [[L, 0], [0, I]]."""
    npad = (-n) % b
    if npad == 0:
        return A, n
    W = torch.zeros(A.shape[:-2] + (n + npad, n + npad), dtype=A.dtype,
                    device=A.device)
    W[..., :n, :n] = A
    idx = torch.arange(n, n + npad, device=A.device)
    W[..., idx, idx] = 1.0
    return W, n + npad


def _trsm_right_lt(P: torch.Tensor, Lkk: torch.Tensor) -> torch.Tensor:
    """Solve X @ Lkk^T = P for X, with Lkk (..., b, b) lower-triangular and
    P (..., r, b). Unrolled over the b columns."""
    b = Lkk.shape[-1]
    X = []
    for j in range(b):
        s = P[..., :, j]
        for m in range(j):
            s = s - X[m] * Lkk[..., j, m][..., None]
        X.append(s / Lkk[..., j, j][..., None])
    return torch.stack(X, dim=-1)


def blocked_cholesky(A: torch.Tensor, block: int = BLOCK):
    """Cholesky of a (..., n, n) SPD matrix (padded internally to a multiple
    of `block`). Returns (L, ok): L lower-triangular, ok (...) every pivot
    positive and finite, the contract of smallchol.small_cholesky."""
    n = A.shape[-1]
    b = block
    if n <= b:
        return smallchol.small_cholesky(A)
    W, npad = _pad_to_block(A, n, b)
    L = torch.zeros_like(W)
    ok = None
    for j0 in range(0, npad, b):
        Lkk, okk = smallchol.small_cholesky(W[..., :b, :b])
        ok = okk if ok is None else ok & okk
        L[..., j0:j0 + b, j0:j0 + b] = Lkk
        if j0 + b < npad:
            Pl = _trsm_right_lt(W[..., b:, :b], Lkk)
            L[..., j0 + b:, j0:j0 + b] = Pl
            # the trailing block shrinks: W becomes W[rest, rest] - Pl Pl^T
            W = W[..., b:, b:] - Pl @ Pl.mT
    return L[..., :n, :n], ok


def _fwd_block(Lkk: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Unrolled forward substitution: y with Lkk y = s, (..., b)."""
    b = Lkk.shape[-1]
    y = []
    for i in range(b):
        t = s[..., i]
        for m in range(i):
            t = t - Lkk[..., i, m] * y[m]
        y.append(t / Lkk[..., i, i])
    return torch.stack(y, dim=-1)


def _bwd_block(Lkk: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Unrolled backward substitution: z with Lkk^T z = s, (..., b)."""
    b = Lkk.shape[-1]
    z = [None] * b
    for i in reversed(range(b)):
        t = s[..., i]
        for m in range(i + 1, b):
            t = t - Lkk[..., m, i] * z[m]
        z[i] = t / Lkk[..., i, i]
    return torch.stack(z, dim=-1)


def blocked_cho_solve(L: torch.Tensor, rhs: torch.Tensor,
                      block: int = BLOCK) -> torch.Tensor:
    """Solve (L L^T) z = rhs for one (..., n) right-hand side given the
    factor from blocked_cholesky (reference dpptrs_, dogleg.c:853-897):
    block matrix-vector products and unrolled 16-substitutions."""
    n = L.shape[-1]
    b = block
    if n <= b:
        return smallchol.small_cho_solve(L, rhs)
    npad = (-n) % b
    if npad:
        L, _ = _pad_to_block(L, n, b)
        rhs = torch.nn.functional.pad(rhs, (0, npad))
    nb = (n + npad) // b

    def blk(k):
        return slice(k * b, (k + 1) * b)

    y = []
    for k in range(nb):
        s = rhs[..., blk(k)]
        for j in range(k):
            s = s - (L[..., blk(k), blk(j)] @ y[j][..., None])[..., 0]
        y.append(_fwd_block(L[..., blk(k), blk(k)], s))
    z = [None] * nb
    for k in reversed(range(nb)):
        s = y[k]
        for j in range(k + 1, nb):
            s = s - (L[..., blk(j), blk(k)].mT @ z[j][..., None])[..., 0]
        z[k] = _bwd_block(L[..., blk(k), blk(k)], s)
    return torch.cat(z, dim=-1)[..., :n]
