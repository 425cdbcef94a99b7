"""Dense step-computation primitives (counterpart of libdogleg_tpu/ops/dense.py).

Every function works on the trailing axes, so the same code serves one
problem ((n,) vectors, 0-d scalars) and a batch ((B, n) vectors, (B,)
scalars). All quantities derive from the products (norm2_x, Jt_x, JtJ); in
particular norm2(J v) is the quadratic form v^T JtJ v (reference
dogleg.c:580-602, 1129-1163).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from libdogleg_tpu_torch.ops import treevec as tv


def build_jtj(J: torch.Tensor) -> torch.Tensor:
    """J^T J for a dense (..., Nmeasurements, Nstate) Jacobian (reference
    accum_outerproduct_packed_upper, dogleg.c:283-307)."""
    return J.mT @ J


def jt_dot(J: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """J^T x (reference mul_matrix_t_densevector, dogleg.c:249-261)."""
    return (J.mT @ x[..., None])[..., 0]


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Inner product over the trailing axis."""
    return (a * b).sum(-1)


def norm2(v: torch.Tensor) -> torch.Tensor:
    """Sum of squares (reference norm2, dogleg.c:193-199)."""
    return dot(v, v)


def quad_form(JtJ: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """v^T (J^T J) v == norm2(J v) (reference mul_xt_A_x, dogleg.c:335-347)."""
    return dot(v, (JtJ @ v[..., None])[..., 0])


class CauchyStep(NamedTuple):
    step: torch.Tensor        # (..., Nstate)
    norm2_step: torch.Tensor  # (...)
    k: torch.Tensor           # (...): step = k * Jt_x


def cauchy_step(Jt_x: torch.Tensor, JtJ: torch.Tensor) -> CauchyStep:
    """Steepest-descent minimizer of the local quadratic model:
    k = -norm2(Jt x) / norm2(J Jt x), step = k Jt x (reference
    dogleg.c:536-610)."""
    n2_jtx = norm2(Jt_x)
    k = -n2_jtx / quad_form(JtJ, Jt_x)
    return CauchyStep(step=k[..., None] * Jt_x, norm2_step=k * k * n2_jtx,
                      k=k)


class InterpolatedStep(NamedTuple):
    step: torch.Tensor        # (..., Nstate), or a tree of tensors
    norm2_step: torch.Tensor  # (...)
    k: torch.Tensor           # (...): cauchy -> gn interpolation factor


def interpolated_step(cauchy: torch.Tensor,
                      norm2_cauchy: torch.Tensor,
                      gn: torch.Tensor,
                      trustregion: torch.Tensor,
                      shards=None) -> InterpolatedStep:
    """The point on the segment cauchy -> gn that crosses the trust-region
    sphere: the + root of norm2(a + k (b - a)) = tr^2, with a numerically
    negative discriminant clamped to zero (reference dogleg.c:936-987). The
    clamp keeps a NaN discriminant NaN, as jnp.maximum does. The steps are
    (..., n) tensors or trees of tensors (ops/treevec.py): of one problem
    where norm2_cauchy is 0-d, of a batch (every leaf (B, ...)) where it is
    (B,). shards: a point-sharded tree's PointShards (tv.tree_dot)."""
    batched = not isinstance(cauchy, torch.Tensor) and norm2_cauchy.dim() > 0
    d = tv.tree_sub(cauchy, gn)
    if batched:
        l2, neg_c = tv.batch_dot(d, d), tv.batch_dot(d, cauchy)
    elif shards is None:
        l2, neg_c = tv.tree_dot(d, d), tv.tree_dot(d, cauchy)
    else:   # the two sums in one all_reduce
        l2, neg_c = tv.tree_dots([(d, d), (d, cauchy)], shards)
    dsq = trustregion * trustregion
    discriminant = torch.clamp(neg_c * neg_c - l2 * (norm2_cauchy - dsq),
                               min=0.0)
    k = (neg_c + torch.sqrt(discriminant)) / l2
    if isinstance(cauchy, torch.Tensor):   # k (...) scales (..., n) rows
        step = cauchy + k[..., None] * (gn - cauchy)
    else:
        scale = tv.batch_scale if batched else tv.tree_scale
        step = tv.tree_add(cauchy, scale(k, tv.tree_sub(gn, cauchy)))
    n2 = (tv.batch_dot(step, step) if batched
          else tv.tree_dot(step, step, shards))
    return InterpolatedStep(step=step, norm2_step=n2, k=k)


def expected_improvement(Jt_x: torch.Tensor,
                         JtJ: torch.Tensor,
                         step: torch.Tensor) -> torch.Tensor:
    """Linearized model decrease -2 <Jt_x, step> - norm2(J step) (reference
    dogleg.c:1085-1165)."""
    return -2.0 * dot(Jt_x, step) - quad_form(JtJ, step)


def trust_region_update(rho: torch.Tensor,
                        trustregion: torch.Tensor,
                        stepped_to_edge,
                        norm2_update_gn: torch.Tensor,
                        *,
                        decrease_factor: float,
                        decrease_threshold: float,
                        increase_factor: float,
                        increase_threshold: float) -> torch.Tensor:
    """New trust-region radius given the gain ratio rho (reference
    dogleg.c:1322-1350): below decrease_threshold, snap an interior (full
    Gauss-Newton) step's radius to the GN step length, then shrink; above
    increase_threshold with the step at the edge, grow; otherwise keep. A
    NaN rho fails every comparison and leaves the radius unchanged.
    `stepped_to_edge` is a bool tensor or a Python bool."""
    edge = torch.as_tensor(stepped_to_edge, device=trustregion.device)
    snapped = torch.where(edge, trustregion, torch.sqrt(norm2_update_gn))
    decreased = snapped * decrease_factor
    increased = torch.where(edge & (rho > increase_threshold),
                            trustregion * increase_factor, trustregion)
    return torch.where(rho < decrease_threshold, decreased, increased)
