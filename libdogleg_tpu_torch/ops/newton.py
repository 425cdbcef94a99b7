"""Newton-system strategies (counterpart of libdogleg_tpu/ops/newton.py:31-163).

The trust-region iteration needs two operations on Products.JtJ:

    quad_form(JtJ, v)                  == norm2(J v)
    gauss_newton(JtJ, Jt_x, lam, ...)  == solve (JtJ + lam I) u = Jt_x; -u

DenseNewtonSolver serves a dense (..., n, n) JtJ through cholesky_ex (the
reference's LAPACK path); BlockedDenseNewtonSolver through the blocked
Cholesky of ops/blockchol.py for 17 <= n <= 256 and the panel Cholesky of
ops/largechol.py (kernel K2) above. Both keep the reference's permanent
escalating lambda (dogleg.c:137-138, 670-676) and take the `active` mask of
the masked batched solver. refine_iters > 0 adds iterative-refinement passes
whose residual is accumulated in compensated arithmetic (ops/compensated.py).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch

from libdogleg_tpu_torch.ops import cholesky as chol
from libdogleg_tpu_torch.ops import compensated as comp
from libdogleg_tpu_torch.ops import dense as dops


class GNResult(NamedTuple):
    step: torch.Tensor        # (..., Nstate) the negated Newton solution
    norm2_step: torch.Tensor  # (...)
    lam: torch.Tensor         # (...) possibly escalated permanent lambda
    ok: torch.Tensor          # (...) bool: factorization succeeded


def _refine(u: torch.Tensor, solve_fn: Callable, resid_fn: Callable,
            iters: int) -> torch.Tensor:
    """Classical iterative refinement against the computed factor:
    u <- u + A^{-1} r(u), with r from resid_fn (compensated) and the
    correction solved with the existing factor (one matvec and one factor
    solve per pass, no refactorization)."""
    for _ in range(iters):
        u = u + solve_fn(resid_fn(u))
    return u


def _damped_residual(JtJ: torch.Tensor, lam: torch.Tensor,
                     Jt_x: torch.Tensor) -> Callable:
    """v -> Jt_x - (JtJ + lam I) v, accumulated as a compensated pair."""
    def resid(v):
        hi, lo = comp.comp_matvec(JtJ, v)
        hi, lo = comp.pair_add_prod(hi, lo, lam[..., None], v)
        return comp.residual(Jt_x, hi, lo)
    return resid


@dataclasses.dataclass(frozen=True)
class DenseNewtonSolver:
    """Dense JtJ (the reference's LAPACK path): unrolled Cholesky for
    Nstate <= 16, cholesky_ex above. refine_iters > 0 runs that many
    iterative-refinement passes of the GN solve against the factor."""
    refine_iters: int = 0

    def quad_form(self, JtJ, v):
        return dops.quad_form(JtJ, v)

    def gauss_newton(self, JtJ, Jt_x, lam, *, lambda_initial,
                     lambda_max_tries,
                     active: Optional[torch.Tensor] = None) -> GNResult:
        fac = chol.factorize_jtj(JtJ, lam, lambda_initial=lambda_initial,
                                 lambda_max_tries=lambda_max_tries,
                                 active=active)
        step, n2 = chol.gauss_newton_step(fac.L, Jt_x)
        if self.refine_iters:
            u = _refine(-step, lambda r: chol.cholesky_solve(fac.L, r),
                        _damped_residual(JtJ, fac.lam, Jt_x),
                        self.refine_iters)
            step = -u
            n2 = dops.norm2(step)
        return GNResult(step=step, norm2_step=n2, lam=fac.lam, ok=fac.ok)


# BlockedDenseNewtonSolver's blocked range; above it, the panel Cholesky.
BLOCKED_MIN_N = 17
BLOCKED_MAX_N = 256


@dataclasses.dataclass(frozen=True)
class BlockedDenseNewtonSolver:
    """Dense JtJ through the 16-block-panel Cholesky (ops/blockchol.py) for
    n <= 256, and through ops/largechol.large_cholesky above, whose 256-wide
    diagonal panels go to kernel K2 on a CUDA tensor. The triangular solves
    of the large path are torch.cholesky_solve.

    panel_impl is large_cholesky's ("auto", "cuda" or "torch"): "auto" takes
    K2 for CUDA tensors and its plain twin for CPU tensors."""
    refine_iters: int = 0
    panel_impl: str = "auto"

    def quad_form(self, JtJ, v):
        return dops.quad_form(JtJ, v)

    def gauss_newton(self, JtJ, Jt_x, lam, *, lambda_initial,
                     lambda_max_tries,
                     active: Optional[torch.Tensor] = None) -> GNResult:
        from libdogleg_tpu_torch.ops import blockchol, largechol

        n = JtJ.shape[-1]
        eye = torch.eye(n, dtype=JtJ.dtype, device=JtJ.device)
        large = n > BLOCKED_MAX_N

        def try_factor(lm):
            damped = JtJ + lm[..., None, None] * eye
            if large:
                return largechol.large_cholesky(damped,
                                                panel_impl=self.panel_impl)
            return blockchol.blocked_cholesky(damped)

        L, lam, ok = chol.escalating_lambda(
            try_factor, torch.as_tensor(lam, dtype=JtJ.dtype,
                                        device=JtJ.device),
            lambda_initial=lambda_initial, lambda_max_tries=lambda_max_tries,
            active=active)

        def solve(r):
            if large:
                return chol.cholesky_solve(L, r)
            return blockchol.blocked_cho_solve(L, r)

        u = solve(Jt_x)
        if self.refine_iters:
            u = _refine(u, solve, _damped_residual(JtJ, lam, Jt_x),
                        self.refine_iters)
        step = -u
        return GNResult(step=step, norm2_step=dops.norm2(step), lam=lam,
                        ok=ok)
