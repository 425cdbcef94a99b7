"""Powell's dog-leg, as libdogleg runs it, in plain PyTorch: the reference
that the benchmark holds the program's answers to.

It follows libdogleg's decision rules (dogleg.c: the Cauchy step once an
operating point, the Gauss-Newton step lazily under the escalating
Tikhonov lambda, the step on the trust-region edge, the gain ratio, the
radius update and the four stopping criteria) on a batch of B independent
problems with flat (B, n) states, each masked once it stops. It imports
nothing of the program: the linear algebra is a `system` object the
caller builds from its own products.

    products(p) -> (norm2 (B,), grad (B, n), system)

`grad` is J^T x (half the cost gradient); `system` has
`quad(v) -> (B,)`, the form v^T J^T J v, and
`gn(grad, lam, active) -> (step (B, n), lam (B,), ok (B,))`, the
Gauss-Newton step -(J^T J + lam I)^-1 J^T x with lambda escalated on the
active elements while the factorization fails, and `select(mask, other)`,
the system of `mask`'s elements taken from self and the rest from other.
"""

from __future__ import annotations

import dataclasses

import torch

RUNNING, GRADIENT, SMALL_STEP, SMALL_TR, MAX_ITER, STALLED, FACT_FAIL = range(7)


@dataclasses.dataclass(frozen=True)
class Rules:
    """libdogleg's parameters (dogleg.c:117-128), with the stopping rule
    the benchmark's configurations state."""
    max_iterations: int = 100
    trustregion0: float = 1.0e3
    decrease_factor: float = 0.1
    decrease_threshold: float = 0.25
    increase_factor: float = 2.0
    increase_threshold: float = 0.75
    Jt_x_threshold: float = 1e-8
    update_threshold: float = 1e-8
    trustregion_threshold: float = 1e-8
    lambda_initial: float = 1e-10
    lambda_max_tries: int = 60

    @classmethod
    def of(cls, stopping: dict) -> "Rules":
        return cls(**stopping)

    @property
    def max_attempts(self) -> int:
        return self.max_iterations * 64


def escalate(factor, lam, active, rules: Rules):
    """libdogleg's permanent escalating lambda: factor(lam) -> (state, ok);
    on the active elements that fail, lam <- lambda_initial if 0 else
    10 lam, at most lambda_max_tries times."""
    state, ok = factor(lam)
    for _ in range(rules.lambda_max_tries):
        fail = active & ~ok
        if not bool(fail.any()):
            break
        lam = torch.where(fail, torch.where(
            lam == 0, torch.full_like(lam, rules.lambda_initial), lam * 10.0),
            lam)
        state, ok = factor(lam)
    return state, lam, ok


def _exceeds(v, threshold):
    return (v.abs() > threshold).any(-1)


def solve(products, p0: torch.Tensor, rules: Rules):
    """Solve the B problems from p0 (B, n). Returns a dict of p, norm2,
    grad, step_count, n_attempts and reason, each with the batch axis."""
    B = p0.shape[0]
    dev, dt = p0.device, p0.dtype
    p = p0.clone()
    norm2, grad, system = products(p)
    done = ~_exceeds(grad, rules.Jt_x_threshold)
    reason = torch.where(done, GRADIENT, RUNNING).to(torch.int32)
    tr = torch.full((B,), rules.trustregion0, dtype=dt, device=dev)
    lam = torch.zeros((B,), dtype=dt, device=dev)
    steps = torch.zeros((B,), dtype=torch.int32, device=dev)
    attempts = torch.zeros((B,), dtype=torch.int32, device=dev)
    have_cauchy = torch.zeros((B,), dtype=torch.bool, device=dev)
    have_gn = torch.zeros_like(have_cauchy)
    cauchy = torch.zeros_like(p)
    gn = torch.zeros_like(p)
    n2_cauchy = torch.zeros((B,), dtype=dt, device=dev)
    n2_gn = torch.zeros_like(n2_cauchy)

    def rows(m, a, b):
        return torch.where(m[:, None], a, b)

    while not bool(done.all()):
        live = ~done
        tr2 = tr * tr
        g2 = (grad * grad).sum(-1)
        k = -g2 / system.quad(grad)
        cauchy = rows(have_cauchy, cauchy, k[:, None] * grad)
        n2_cauchy = torch.where(have_cauchy, n2_cauchy, k * k * g2)
        use_cauchy = n2_cauchy >= tr2
        need_gn = live & ~use_cauchy & ~have_gn
        fac_ok = torch.ones_like(done)
        if bool(need_gn.any()):
            step_gn, lam_new, ok = system.gn(grad, lam, need_gn)
            gn = rows(need_gn, step_gn, gn)
            n2_gn = torch.where(need_gn, (step_gn * step_gn).sum(-1), n2_gn)
            lam = torch.where(need_gn, lam_new, lam)
            fac_ok = ok | ~need_gn
        have_gn = have_gn | need_gn
        use_gn = ~use_cauchy & (n2_gn <= tr2)
        # the segment cauchy -> gn crossing the sphere (dogleg.c:936-987)
        d = cauchy - gn
        l2, neg_c = (d * d).sum(-1), (d * cauchy).sum(-1)
        disc = torch.clamp(neg_c * neg_c - l2 * (n2_cauchy - tr2), min=0.0)
        kk = (neg_c + torch.sqrt(disc)) / l2
        interp = cauchy + kk[:, None] * (gn - cauchy)
        step = rows(use_cauchy, (tr / torch.sqrt(n2_cauchy))[:, None] * cauchy,
                    rows(use_gn, gn, interp))
        expected = -2.0 * (grad * step).sum(-1) - system.quad(step)
        small = ~_exceeds(step, rules.update_threshold)
        p_new = p + step
        t_norm2, t_grad, t_system = products(p_new)
        skip = small | ~fac_ok
        t_norm2 = torch.where(skip, norm2, t_norm2)
        t_grad = rows(skip, grad, t_grad)
        rho = (norm2 - t_norm2) / expected
        edge = ~use_gn
        snapped = torch.where(edge, tr, torch.sqrt(n2_gn))
        tr_new = torch.where(
            rho < rules.decrease_threshold, snapped * rules.decrease_factor,
            torch.where(edge & (rho > rules.increase_threshold),
                        tr * rules.increase_factor, tr))
        accept = rho > 0.0
        n_att = attempts + 1
        exhausted = n_att >= rules.max_attempts
        steps_acc = steps + 1
        conv = ~_exceeds(t_grad, rules.Jt_x_threshold)
        max_it = steps_acc >= rules.max_iterations
        acc_reason = torch.where(conv, GRADIENT, torch.where(
            max_it, MAX_ITER, torch.where(exhausted, STALLED, RUNNING)))
        small_tr = tr_new < rules.trustregion_threshold
        rej_reason = torch.where(small_tr, SMALL_TR,
                                 torch.where(exhausted, STALLED, RUNNING))
        m_fail = live & ~fac_ok
        m_small = live & fac_ok & small
        m_acc = live & fac_ok & ~small & accept
        m_rej = live & fac_ok & ~small & ~accept
        new_reason = torch.where(m_fail, FACT_FAIL, torch.where(
            m_small, SMALL_STEP, torch.where(m_acc, acc_reason, rej_reason)))
        p = rows(m_acc, p_new, p)
        norm2 = torch.where(m_acc, t_norm2, norm2)
        grad = rows(m_acc, t_grad, grad)
        system = t_system.select(m_acc, system)
        have_cauchy = torch.where(live, ~m_acc, have_cauchy)
        have_gn = torch.where(m_acc, False, have_gn)
        tr = torch.where(m_acc | m_rej, tr_new, tr)
        steps = torch.where(m_acc, steps_acc, steps)
        attempts = torch.where(live, n_att, attempts)
        reason = torch.where(live, new_reason, reason).to(torch.int32)
        done = done | (live & (reason != RUNNING))
    return dict(p=p, norm2=norm2, grad=grad, step_count=steps,
                n_attempts=attempts, reason=reason)


class DenseSystem:
    """A batch of dense (B, n, n) J^T J, factored by Cholesky."""

    def __init__(self, jtj: torch.Tensor, rules: Rules):
        self.jtj, self.rules = jtj, rules

    def quad(self, v):
        return torch.einsum('bi,bij,bj->b', v, self.jtj, v)

    def gn(self, grad, lam, active):
        n = grad.shape[-1]
        eye = torch.eye(n, dtype=grad.dtype, device=grad.device)

        def factor(lm):
            L, info = torch.linalg.cholesky_ex(self.jtj + lm[:, None, None]
                                               * eye)
            return L, info == 0
        L, lam, ok = escalate(factor, lam, active, self.rules)
        x = torch.cholesky_solve(grad[..., None], L)[..., 0]
        return -torch.where(ok[:, None], x, torch.zeros_like(x)), lam, ok

    def select(self, mask, other):
        return DenseSystem(
            torch.where(mask[:, None, None], self.jtj, other.jtj), self.rules)
