"""The sample-fleet configuration's reference and its judgement, in plain
PyTorch: sample.c's model and closed-form Jacobian, solved by the
reference dog-leg (dogleg.py) from the same starts on the same
measurements as the program, then each sampled answer compared.

Four numbers are compared:

- cost_gap, the worst answer's: the program's reported norm2_x against the
  cost of its own p, evaluated here in float64, over the magnitude of that
  evaluation's arithmetic (sum over the measurements of 2 |x_j| t_j +
  x_j^2, t_j the sum of the absolute values of the model's terms and the
  measurement): whether each answer's p and cost belong together.
- excess_cost_p999, the 99.9th percentile over the answers of how much
  worse the cost at the program's p is than at the reference's own float64
  answer for the same start, as a share of the latter: whether the answers
  are as good fits as the stated rule gives. Not the worst answer's: one
  fit in about a million takes other decisions in float32 than in float64
  and, stopped by the cap of 10 iterations, ends far from the float64
  answer (PERF.md has the readings).
- decision_share, the share of the answers whose stopping reason or count
  of accepted steps differs from the reference's solved in float32, the
  configuration's precision: whether the program takes the reference's
  decisions (float64's cannot serve: float32 never meets the gradient
  threshold).
- stop_rule_breaches, over every answer: how many break the stated cap
  of max_iterations accepted steps (more steps than the cap, or a stop for
  the cap at another count, or the cap's count reached with neither that
  stop nor convergence). Exact: limit 0.

LIMITS holds each number's limit, set between the program's largest
reading over a dozen seeds and more at the cells' sizes and the control's
smallest (the reference in bfloat16 in the program's place; on an H100);
PERF.md gives the readings.
"""

from __future__ import annotations

import math

import torch

from reference.modules import load

LIMITS = {"cost_gap": 1e-4, "excess_cost_p999": 1e-1,
          "decision_share": 0.5, "stop_rule_breaches": 0}


def _dogleg():
    return load("reference", "dogleg")


def _grid(cfg, dtype, device):
    g = cfg["grid"]
    coords = g["min"] + g["delta"] * torch.arange(
        g["width"], dtype=torch.float64, device=device)
    gx, gy = torch.meshgrid(coords, coords, indexing="ij")
    return gx.reshape(-1).to(dtype), gy.reshape(-1).to(dtype)


def residuals(p, meas, gx, gy):
    """x (B, nmeas) and the magnitude t (B, nmeas) of its terms."""
    p0, p1, p2, p3, p4, p5 = (p[:, i:i + 1] for i in range(6))
    terms = (p0 * p1 * gx * gx, p1 * p2 * gy * gy, p2 * gx * gy, p3 * gx,
             p4 * gy, p5 + 0 * gx)
    x = sum(terms) - meas
    t = sum(a.abs() for a in terms) + meas.abs()
    return x, t


def products(p, meas, gx, gy):
    """norm2 (B,), J^T x (B, 6), J^T J (B, 6, 6) of sample.c's problem."""
    x, _ = residuals(p, meas, gx, gy)
    p0, p1, p2 = p[:, 0:1], p[:, 1:2], p[:, 2:3]
    one = torch.ones_like(x)
    J = torch.stack([p1 * gx * gx, p0 * gx * gx + p2 * gy * gy,
                     p1 * gy * gy + gx * gy, gx * one, gy * one, one], -1)
    return ((x * x).sum(-1), torch.einsum('bmi,bm->bi', J, x),
            torch.einsum('bmi,bmj->bij', J, J))


def reference_solve(cfg, p0, meas, dtype=torch.float64, block=65536):
    """The reference's answers (p, norm2, reason, ...) for starts p0 (B, 6)
    on meas (B, nmeas), solved in `dtype` in blocks of problems."""
    dl = _dogleg()
    rules = dl.Rules.of(cfg["stopping"])
    gx, gy = _grid(cfg, dtype, p0.device)
    low = dtype not in (torch.float32, torch.float64)
    out = []
    for lo in range(0, p0.shape[0], block):
        m = meas[lo:lo + block].to(dtype)

        def prods(p):
            n2, g, H = products(p, m, gx, gy)
            system = (LowPrecisionSystem(H, rules) if low
                      else dl.DenseSystem(H, rules))
            return n2, g, system
        out.append(dl.solve(prods, p0[lo:lo + block].to(dtype), rules))
    return {k: torch.cat([o[k] for o in out]) for k in out[0]}


class LowPrecisionSystem:
    """DenseSystem's contract in a dtype that torch.linalg does not factor
    (bfloat16): Cholesky and its two substitutions written out over the
    batch, every operation in that dtype."""

    def __init__(self, jtj, rules):
        self.jtj, self.rules = jtj, rules

    def quad(self, v):
        return (v[:, :, None] * self.jtj * v[:, None, :]).sum((-1, -2))

    def gn(self, grad, lam, active):
        dl = _dogleg()
        n = grad.shape[-1]
        eye = torch.eye(n, dtype=grad.dtype, device=grad.device)

        def factor(lm):
            A = self.jtj + lm[:, None, None] * eye
            L = torch.zeros_like(A)
            ok = torch.ones(A.shape[0], dtype=torch.bool, device=A.device)
            for j in range(n):
                d = A[:, j, j] - (L[:, j, :j] * L[:, j, :j]).sum(-1)
                ok &= d > 0
                ljj = torch.sqrt(torch.clamp(d, min=0))
                L[:, j, j] = ljj
                for i in range(j + 1, n):
                    L[:, i, j] = (A[:, i, j] - (L[:, i, :j] * L[:, j, :j])
                                  .sum(-1)) / ljj
            return L, ok
        L, lam, ok = dl.escalate(factor, lam, active, self.rules)
        y = torch.zeros_like(grad)
        for i in range(n):
            y[:, i] = (grad[:, i] - (L[:, i, :i] * y[:, :i]).sum(-1)) \
                / L[:, i, i]
        x = torch.zeros_like(grad)
        for i in reversed(range(n)):
            x[:, i] = (y[:, i] - (L[:, i + 1:, i] * x[:, i + 1:]).sum(-1)) \
                / L[:, i, i]
        return -torch.where(ok[:, None], x, torch.zeros_like(x)), lam, ok

    def select(self, mask, other):
        return LowPrecisionSystem(
            torch.where(mask[:, None, None], self.jtj, other.jtj), self.rules)


def cost_gaps(cfg, meas, p, norm2_x, block=262144):
    """cost_gap per answer, float64, for answers (p, norm2_x) on meas, in
    blocks of answers; a non-finite answer reads as infinitely wrong."""
    gx, gy = _grid(cfg, torch.float64, p.device)
    out = []
    for lo in range(0, p.shape[0], block):
        x, t = residuals(p[lo:lo + block].to(torch.float64),
                         meas[lo:lo + block].to(torch.float64), gx, gy)
        cost = (x * x).sum(-1)
        mag = (2.0 * x.abs() * t + x * x).sum(-1)
        gap = (norm2_x[lo:lo + block].to(torch.float64) - cost).abs() / mag
        out.append(torch.where(torch.isfinite(gap), gap,
                               torch.full_like(gap, float("inf"))))
    return torch.cat(out)


def excesses(cfg, p0, meas, p, ref=None):
    """excess_cost per answer, float64, for answers p from starts p0 on
    meas; ref, the reference's answers for the same problems (computed
    here when None)."""
    gx, gy = _grid(cfg, torch.float64, p0.device)
    m64 = meas.to(torch.float64)
    if ref is None:
        ref = reference_solve(cfg, p0, meas)
    x, _ = residuals(p.to(torch.float64), m64, gx, gy)
    xr, _ = residuals(ref["p"], m64, gx, gy)
    cost, ref_cost = (x * x).sum(-1), (xr * xr).sum(-1)
    excess = (cost - ref_cost) / ref_cost
    return torch.where(torch.isfinite(excess), excess,
                       torch.full_like(excess, float("inf"))), ref


def stop_rule_breaches(reason, step_count, max_iterations):
    """Per answer, whether it breaks the cap of max_iterations accepted
    steps: more steps than the cap, a stop for the cap (reason 4) at
    another count, or the cap's count with neither that stop nor
    convergence (reason 1)."""
    dl = _dogleg()
    steps, reason = step_count.long(), reason.long()
    capped = steps == max_iterations
    for_cap = reason == dl.MAX_ITER
    return ((steps > max_iterations) | (for_cap & ~capped)
            | (capped & ~for_cap & (reason != dl.GRADIENT)))


def _spread(excess, gap, a, ref, differ):
    """How the readings of one call's answers spread: quantiles, the
    stopping reasons program against reference, the worst ones, and how
    many decisions differ from float32's."""
    qs = torch.tensor([0.5, 0.9, 0.99, 0.999], dtype=excess.dtype,
                      device=excess.device)
    fin = torch.where(torch.isfinite(excess), excess,
                      torch.full_like(excess, 1e300))
    worst = torch.argsort(fin, descending=True)[:5]
    return {
        "excess_q": [float(v) for v in torch.quantile(fin, qs)],
        "gap_q": [float(v) for v in torch.quantile(gap.nan_to_num(1e300),
                                                    qs)],
        "excess_over": {t: int((excess > float(t)).sum())
                        for t in ("1e-6", "1e-4", "1e-2")},
        "reasons": [int(v) for v in torch.bincount(
            a["reason"].long().clamp(0, 6), minlength=7)],
        "ref_reasons": [int(v) for v in torch.bincount(
            ref["reason"].long(), minlength=7)],
        "decisions_differ": int(differ.sum()),
        "worst": [[float(excess[i]), int(a["reason"][i]),
                   int(ref["reason"][i]), int(ref["step_count"][i])]
                  for i in worst.tolist()],
    }


FIELDS = ("p0", "meas", "p", "reason", "step_count")


def judge(cfg, mix, inputs, answers, limits=None):
    """Each compared number, with its limit: [(name, value, limit)], and a
    dict of diagnostics. cost_gap and stop_rule_breaches are read on every
    answer of each sampled call, excess_cost_p999 and decision_share on
    the answers of its `sample` (indices drawn from the seed; all of them
    where it is None)."""
    limits = LIMITS if limits is None else limits
    cap = cfg["stopping"]["max_iterations"]
    gaps, excess_all, differ_all, breaches = [], [], [], 0
    diag = {"answers": 0, "solved": 0, "frames": []}
    for a in answers:
        gap = cost_gaps(cfg, a["meas"], a["p"], a["norm2_x"])
        breaches += int(stop_rule_breaches(a["reason"], a["step_count"],
                                           cap).sum())
        idx = a.get("sample")
        sub = ({k: a[k] for k in FIELDS} if idx is None
               else {k: a[k][idx] for k in FIELDS})
        excess, ref = excesses(cfg, sub["p0"], sub["meas"], sub["p"])
        ref32 = reference_solve(cfg, sub["p0"], sub["meas"],
                                dtype=torch.float32)
        differ = ((sub["reason"].long() != ref32["reason"].long())
                  | (sub["step_count"].long()
                     != ref32["step_count"].long()))
        gaps.append(float(gap.max()))
        excess_all.append(excess)
        differ_all.append(differ)
        diag["answers"] += gap.numel()
        diag["solved"] += excess.numel()
        diag["frames"].append(_spread(excess, gap, sub, ref, differ))
    if answers:
        e = torch.cat(excess_all)
        e = torch.where(torch.isnan(e), torch.full_like(e, float("inf")), e)
        # the order statistic itself (no interpolation), over every answer
        k = min(e.numel() - 1, math.ceil(0.999 * e.numel()) - 1)
        values = {"cost_gap": max(gaps),
                  "excess_cost_p999": float(torch.kthvalue(e, k + 1).values),
                  "decision_share": float(
                      torch.cat(differ_all).double().mean()),
                  "stop_rule_breaches": float(breaches)}
        diag["excess_cost_max"] = float(e.max())
    else:
        values = {k: float("inf") for k in LIMITS}
    return [(k, v, limits[k]) for k, v in values.items()], diag


CONTROL = "the reference solved in bfloat16 in the program's place"


def _reference_answers(mix, inputs, cfg, dtype):
    out = []
    for f in range(mix["frames"]):
        p0, meas = inputs["p0"][f], inputs["meas"][f]
        r = reference_solve(cfg, p0, meas, dtype=dtype)
        out.append({"frame": f, "p0": p0, "meas": meas, "p": r["p"],
                    "norm2_x": r["norm2"], "reason": r["reason"],
                    "step_count": r["step_count"]})
    return out


def control_answers(cfg, mix, inputs):
    """The control's answers, in the drivers' form: the reference in the
    nearest precision below the configuration's float32, bfloat16, from
    the same starts on the same measurements."""
    return _reference_answers(mix, inputs, cfg, torch.bfloat16)

