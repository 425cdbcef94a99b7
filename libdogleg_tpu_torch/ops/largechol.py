"""Large-n dense Cholesky: blocked right-looking with 256-wide panels, its
work in matrix products (counterpart of libdogleg_tpu/ops/largechol.py).

Outer loop over panels of width 256:
  1. factor the diagonal block and invert its factor: ops/panelchol.py
     (kernel K2 on a CUDA tensor, its plain twin on the CPU);
  2. panel = W[rest, kk] @ inv(Lkk)^T           (matrix product)
  3. trailing update W[rest, rest] -= P @ P^T  (matrix product)
The trailing updates carry 1 - (panel/n)^2 of the n^3/3 flops. The reference's
analog is LAPACK dpotrf's blocked algorithm (reference dogleg.c:778-804).

The trailing block shrinks each panel (W <- W[rest, rest] - P P^T), so each
panel touches only the remaining (n - j0)^2 block, and the factor's columns
are assembled once at the end.

Numerics: the products must be true float32 for a float32 factor, as the JAX
package's Precision.HIGHEST is. torch.matmul is, as long as TF32 stays off
(torch.backends.cuda.matmul.allow_tf32 False, float32 matmul precision
"highest", PyTorch's defaults); this module never changes either.

Failure contract of smallchol/blockchol: (L, ok), ok the all-pivots
positive-and-finite flag (reference dogleg.c:667,806) that the escalating
lambda keys on.
"""

from __future__ import annotations

import torch

from libdogleg_tpu_torch.ops.batchchol import (BLOCK, _trsm_right_lt,
                                                pad_to_block)

SUB = BLOCK   # sub-panel width inside a panel: pad_to_block's 16
PANEL = 256   # outer panel width
PANEL_IMPLS = ("auto", "cuda", "torch")


def _leaf_chol(D: torch.Tensor):
    """Column-form Cholesky of (..., m, m), m <= SUB, with kernel K2's pivot
    rule (pallas_panelchol.py:44-62): d = sqrt(max(d2, float32 tiny)), and
    ok = every pivot d2 positive and finite. Returns (L, ok)."""
    m = D.shape[-1]
    tiny = torch.finfo(torch.float32).tiny
    rows = torch.arange(m, device=D.device)
    cols = []
    ok = None
    for j in range(m):
        acc = D[..., :, j]
        if j:
            Lj = torch.stack(cols, dim=-1)                  # (..., m, j)
            acc = acc - (Lj @ Lj[..., j, :, None])[..., 0]
        d2 = acc[..., j]
        okj = (d2 > 0) & torch.isfinite(d2)
        ok = okj if ok is None else ok & okj
        col = acc / torch.sqrt(torch.clamp(d2, min=tiny))[..., None]
        cols.append(torch.where(rows >= j, col, torch.zeros_like(col)))
    return torch.stack(cols, dim=-1), ok


def _chol_fori(W: torch.Tensor):
    """Cholesky of (..., p, p), p a multiple of SUB, over SUB-wide
    sub-panels: leaf Cholesky, triangular solve of the rows below, rank-SUB
    trailing update. (The JAX package runs this as a fori_loop with masked
    full-width updates to bound its compile size; eagerly, the trailing
    block shrinks instead.) Returns (L, ok)."""
    p = W.shape[-1]
    L = torch.zeros_like(W)
    ok = None
    for j0 in range(0, p, SUB):
        Lkk, okk = _leaf_chol(W[..., :SUB, :SUB])
        ok = okk if ok is None else ok & okk
        L[..., j0:j0 + SUB, j0:j0 + SUB] = Lkk
        if j0 + SUB < p:
            X = _trsm_right_lt(W[..., SUB:, :SUB], Lkk)
            L[..., j0 + SUB:, j0:j0 + SUB] = X
            W = W[..., SUB:, SUB:] - X @ X.mT
    return L, ok


def _tri_inv_leaf(L: torch.Tensor) -> torch.Tensor:
    """Inverse of a (..., m, m) lower-triangular block, m <= SUB: rows
    built front to back, each a vector op over the row."""
    m = L.shape[-1]
    eye = torch.eye(m, dtype=L.dtype, device=L.device)
    rows = []
    for i in range(m):
        r = eye[i]
        for k in range(i):
            r = r - L[..., i, k][..., None] * rows[k]
        rows.append(r / L[..., i, i][..., None])
    return torch.stack(rows, dim=-2)


def _tri_inv(L: torch.Tensor) -> torch.Tensor:
    """inv(L) for lower-triangular (..., m, m), m a multiple of SUB, by the
    recursion inv([[A, 0], [C, B]]) = [[Ai, 0], [-Bi C Ai, Bi]]."""
    m = L.shape[-1]
    if m <= SUB:
        return _tri_inv_leaf(L)
    h = SUB * max(1, (m // 2) // SUB)
    Ai = _tri_inv(L[..., :h, :h])
    Bi = _tri_inv(L[..., h:, h:])
    out = torch.zeros_like(L)
    out[..., :h, :h] = Ai
    out[..., h:, h:] = Bi
    out[..., h:, :h] = -((Bi @ L[..., h:, :h]) @ Ai)
    return out


def large_cholesky(A: torch.Tensor, panel: int = PANEL,
                   panel_impl: str = "auto"):
    """Cholesky of (..., n, n) SPD, n large (above 256 is where
    BlockedDenseNewtonSolver sends it). Returns (L, ok). n is padded to a
    multiple of SUB with an identity diagonal extension (exact).

    panel_impl selects the diagonal-block factorization:
      "cuda"  -- kernel K2 (ops/panelchol.panel_factor); a CUDA tensor only;
      "torch" -- K2's plain twin, panelchol.panel_factor_reference;
      "auto"  -- "cuda" for a CUDA tensor, "torch" for a CPU tensor.
    """
    from libdogleg_tpu_torch.ops import panelchol

    if panel_impl not in PANEL_IMPLS:
        raise ValueError(f"panel_impl must be one of {PANEL_IMPLS}, got "
                         f"{panel_impl!r}")
    if panel_impl == "auto":
        panel_impl = "cuda" if A.is_cuda else "torch"
    if panel_impl == "cuda" and not A.is_cuda:
        raise ValueError("panel_impl='cuda' needs a CUDA tensor")
    if panel % SUB or panel > panelchol.MAX_PANEL:
        raise ValueError(f"panel must be a multiple of {SUB} and at most "
                         f"{panelchol.MAX_PANEL}, got {panel}")
    factor = (panelchol.panel_factor if panel_impl == "cuda"
              else panelchol.panel_factor_reference)
    n = A.shape[-1]
    W = pad_to_block(A)
    npad = W.shape[-1]
    L = torch.zeros_like(W)
    ok = None
    for j0 in range(0, npad, panel):
        pw = min(panel, npad - j0)
        Lkk, Tinv, okk = factor(W[..., :pw, :pw])
        ok = okk if ok is None else ok & okk
        L[..., j0:j0 + pw, j0:j0 + pw] = Lkk
        if j0 + pw < npad:
            P = W[..., pw:, :pw] @ Tinv.mT
            L[..., j0 + pw:, j0:j0 + pw] = P
            W = W[..., pw:, pw:] - P @ P.mT
    return L[..., :n, :n], ok
