"""Error-free transformations: residuals in double working precision
(counterpart of libdogleg_tpu/ops/compensated.py).

Iterative refinement (ops/newton._refine) can only correct errors its
residual can see, and a residual r = b - A u computed in working precision
carries rounding noise of the same order as the solve error it measures. The
functions here accumulate it as a non-overlapping (hi, lo) pair with plain
working-precision operations: Knuth's two-sum, Dekker's split product and
cascaded pairwise summation (Ogita-Rump-Oishi).

Every function is a sequence of separate eager tensor operations. Each
operation is its own kernel, so nothing is reassociated or contracted into a
fused multiply-add, which would void the error-free property of two_sum and
two_prod. Do not wrap these functions in torch.compile.
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch

Pair = Tuple[torch.Tensor, torch.Tensor]


def two_sum(a: torch.Tensor, b: torch.Tensor) -> Pair:
    """Knuth: s + e == a + b exactly, s = fl(a + b)."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def _split(a: torch.Tensor) -> Pair:
    """Dekker split: a == hi + lo with mantissas short enough that the
    products of parts are exact. Split factor 2^ceil(p/2) + 1 for the
    dtype's p-bit mantissa (float32: 4097, float64: 2^27 + 1)."""
    f = 4097.0 if a.dtype == torch.float32 else float(2 ** 27 + 1)
    c = f * a
    hi = c - (c - a)
    return hi, a - hi


def two_prod(a: torch.Tensor, b: torch.Tensor) -> Pair:
    """Dekker/Veltkamp: p + e == a * b exactly, p = fl(a * b)."""
    p = a * b
    a1, a2 = _split(a)
    b1, b2 = _split(b)
    e = ((a1 * b1 - p) + a1 * b2 + a2 * b1) + a2 * b2
    return p, e


def comp_reduce(p: torch.Tensor, e: torch.Tensor, axis: int) -> Pair:
    """Sum p along `axis` with a cascaded pairwise two_sum, folding every
    rounding term and the elementwise error tensor e into a compensation.
    Returns (hi, lo): hi the pairwise sum, hi + lo the exact sum to
    O(eps^2)."""
    p = torch.movedim(p, axis, -1)
    c = torch.movedim(e, axis, -1).sum(-1)
    n = p.shape[-1]
    m = 1 << max(0, n - 1).bit_length()
    if m != n:
        p = torch.nn.functional.pad(p, (0, m - n))
    while p.shape[-1] > 1:
        s, err = two_sum(p[..., 0::2], p[..., 1::2])
        c = c + err.sum(-1)
        p = s
    return p[..., 0], c


def pair_add(h1, l1, h2, l2) -> Pair:
    """(h1 + l1) + (h2 + l2) as a compensated pair."""
    s, e = two_sum(h1, h2)
    return s, l1 + l2 + e


def pair_add_prod(hi, lo, a, b) -> Pair:
    """(hi + lo) + a * b as a compensated pair (a * b exact by two_prod)."""
    p, pe = two_prod(a, b)
    s, e = two_sum(hi, p)
    return s, lo + pe + e


def comp_matvec(A: torch.Tensor, u: torch.Tensor) -> Pair:
    """A @ u as a compensated pair, for A (..., m, n) and u (..., n): exact
    elementwise products, pairwise compensated row sums. Materializes one
    (..., m, n) error tensor: meant for refinement, not factorization."""
    p, e = two_prod(A, u.unsqueeze(-2))
    return comp_reduce(p, e, axis=-1)


def comp_contract(A: torch.Tensor, v: torch.Tensor,
                  reduce_axes: Sequence[int],
                  broadcast: Callable[[torch.Tensor], torch.Tensor]) -> Pair:
    """einsum-style compensated contraction: multiply A elementwise by
    broadcast(v) expanded to A's shape, then compensated-reduce over
    reduce_axes (flattened, innermost last)."""
    vb = broadcast(v).expand(A.shape)
    p, e = two_prod(A, vb)
    keep = [d for d in range(A.dim()) if d not in reduce_axes]
    perm = keep + list(reduce_axes)
    shape = tuple(A.shape[d] for d in keep) + (-1,)
    p = p.permute(perm).reshape(shape)
    e = e.permute(perm).reshape(shape)
    return comp_reduce(p, e, axis=-1)


def comp_matvec_pair(Ahi, Alo, u) -> Pair:
    """(Ahi + Alo) @ u as a compensated pair, for a matrix stored as a
    double-working-precision pair: exact products with the hi part, the
    lo-part products join the error channel."""
    p, e = two_prod(Ahi, u.unsqueeze(-2))
    return comp_reduce(p, e + Alo * u.unsqueeze(-2), axis=-1)


def pair_dot_pair(u, vhi, vlo) -> Pair:
    """u . (vhi + vlo) as a compensated pair."""
    p, e = two_prod(u, vhi)
    return comp_reduce(p, e + u * vlo, axis=-1)


def collapse(hi, lo) -> torch.Tensor:
    """The working-precision value closest to hi + lo."""
    return hi + lo


def residual(b, hi, lo) -> torch.Tensor:
    """fl(b - (hi + lo)), accurate to ~eps of the residual's own size."""
    s, e = two_sum(b, -hi)
    return s + (e - lo)
