"""JtJ factorization with permanent escalating-lambda singularity handling
(counterpart of libdogleg_tpu/ops/cholesky.py).

On a singular JtJ the reference adds lambda*I, starting at lambda_initial and
multiplying by 10 per repeated failure; lambda is permanent for the rest of
the solve (reference dogleg.c:137-138, 670-676, dogleg.h:197-201). Failure is
detected numerically (a non-positive or non-finite pivot), never through an
exception: torch.linalg.cholesky raises on a non-SPD matrix, so the large-n
path uses cholesky_ex and maps its info to `ok`.

Every function takes a leading batch of matrices. The escalation is masked:
only elements that are `active` and not yet factorized escalate, each on its
own schedule, which gives every element exactly the decisions of a solve on
its own.
"""

from __future__ import annotations

import contextlib
from typing import Callable, NamedTuple, Optional

import torch

from libdogleg_tpu_torch.ops import smallchol


class Factorization(NamedTuple):
    L: torch.Tensor    # (..., n, n) lower-triangular Cholesky factor
    lam: torch.Tensor  # (...) the (possibly escalated) permanent lambda
    ok: torch.Tensor   # (...) bool: factorization succeeded


def _try_factor(JtJ: torch.Tensor, lam: torch.Tensor):
    n = JtJ.shape[-1]
    eye = torch.eye(n, dtype=JtJ.dtype, device=JtJ.device)
    damped = JtJ + lam[..., None, None] * eye
    if n <= smallchol.SMALL_N_MAX:
        return smallchol.small_cholesky(damped)
    L, info = torch.linalg.cholesky_ex(damped)
    diag = torch.diagonal(L, dim1=-2, dim2=-1)
    ok = ((info == 0) & torch.isfinite(L).all(-1).all(-1)
          & (diag > 0).all(-1))
    return L, ok


# Set while a solve runs in its traced form (traced_loops): every
# escalating_lambda then takes its while_loop form.
_TRACED = False


@contextlib.contextmanager
def traced_loops():
    """Within this block escalating_lambda runs as a traced while_loop
    (ops/traced.py), the form torch.export captures. The solver's traced
    loop (solver.run_batched_solver_traced) enters it; the strategies call
    escalating_lambda as before."""
    global _TRACED
    old, _TRACED = _TRACED, True
    try:
        yield
    finally:
        _TRACED = old


def escalating_lambda(try_factor: Callable, lam: torch.Tensor, *,
                      lambda_initial: float = 1e-10,
                      lambda_max_tries: int = 60,
                      active: Optional[torch.Tensor] = None):
    """The reference's permanent escalating-lambda loop: try the current
    lambda; while singular, lambda <- lambda_initial if zero else lambda*10,
    and retry, at most lambda_max_tries times (reference dogleg.c:670-676,
    811-815).

    try_factor(lam) -> (state, ok), state a tensor or a tuple of them.
    `active` (bool, shaped like lam) limits the escalation to those
    elements; the others keep their lambda. Returns (state, lam, ok) with
    ok as computed for every element. Inside traced_loops() the loop is a
    while_loop carrying (tries, lam, ok, state) while tries <
    lambda_max_tries and an active element failed: the same decisions,
    since elements that kept their lambda refactor to the same factor.
    """
    state, ok = try_factor(lam)
    if active is None:
        active = torch.ones_like(ok)

    def escalate(lam, ok):
        fail = active & ~ok
        return torch.where(fail,
                           torch.where(lam == 0.0,
                                       torch.full_like(lam, lambda_initial),
                                       lam * 10.0),
                           lam)

    if _TRACED:
        from libdogleg_tpu_torch.ops import traced

        def body(tries, lam, ok, state):
            lam = escalate(lam, ok)
            state, ok = try_factor(lam)
            return tries + 1, lam, ok, state

        _, lam, ok, state = traced.while_loop(
            lambda tries, lam, ok, state: ((tries < lambda_max_tries)
                                           & (active & ~ok).any()),
            body, (torch.zeros((), dtype=torch.int64, device=ok.device),
                   lam, ok, state))
        return state, lam, ok
    for _ in range(lambda_max_tries):
        if not bool((active & ~ok).any()):
            break
        lam = escalate(lam, ok)
        # Elements that kept their lambda refactor to the same factor.
        state, ok = try_factor(lam)
    return state, lam, ok


def factorize_jtj(JtJ: torch.Tensor,
                  lam: torch.Tensor,
                  *,
                  lambda_initial: float = 1e-10,
                  lambda_max_tries: int = 60,
                  active: Optional[torch.Tensor] = None) -> Factorization:
    """Cholesky-factorize JtJ + lam*I, escalating lam on singularity
    (reference dogleg_computeJtJfactorization, dogleg.c:634-820)."""
    L, lam, ok = escalating_lambda(
        lambda lm: _try_factor(JtJ, lm), torch.as_tensor(lam, dtype=JtJ.dtype,
                                                         device=JtJ.device),
        lambda_initial=lambda_initial, lambda_max_tries=lambda_max_tries,
        active=active)
    return Factorization(L=L, lam=lam, ok=ok)


def cholesky_solve(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve (L L^T) z = b given the lower factor L (..., n, n) (reference
    dpptrs_ / cholmod_solve, dogleg.c:853-897).

    The rank of b against L's decides the case: b of L.dim() - 1 dimensions
    is one (..., n) right-hand side per matrix; b of L.dim() dimensions is a
    (..., n, k) matrix of k right-hand sides, as the JAX package's
    (Nstate, k) form. n <= 16 takes the unrolled substitutions, larger n
    two triangular solves (torch.cholesky_solve for a vector)."""
    if b.dim() == L.dim():
        if L.shape[-1] <= smallchol.SMALL_N_MAX:
            return smallchol.small_cho_solve_mat(L, b)
        y = torch.linalg.solve_triangular(L, b, upper=False)
        return torch.linalg.solve_triangular(L.mT, y, upper=True)
    if b.dim() != L.dim() - 1:
        raise ValueError(f"cholesky_solve: b of shape {tuple(b.shape)} is "
                         f"neither a vector nor a matrix right-hand side "
                         f"for L of shape {tuple(L.shape)}")
    if L.shape[-1] <= smallchol.SMALL_N_MAX:
        return smallchol.small_cho_solve(L, b)
    return torch.cholesky_solve(b[..., None], L)[..., 0]


def gauss_newton_step(L: torch.Tensor, Jt_x: torch.Tensor):
    """Solve JtJ u = Jt_x and negate: the Gauss-Newton update (reference
    compute_updateGN, dogleg.c:822-908). Returns (step, norm2_step)."""
    step = -cholesky_solve(L, Jt_x)
    return step, (step * step).sum(-1)
