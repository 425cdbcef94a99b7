"""Gradient verification (counterpart of libdogleg_tpu/analysis/gradients.py).

The reference ships a central-difference checker as a development tool
(reference dogleg.c:349-522, recommended for every variable in
README.pod:225-227): evaluate the callback at p +- delta/2 with
delta = 1e-6, compare the observed (x - x0)/delta against the reported
Jacobian averaged at both points, and print a vnlog table
"# ivar imeasurement gradient_reported gradient_observed error
error_relative" (dogleg.c:400, 454-476).

This module reproduces that tool over all measurements at once, adds a
products-mode check (which the reference leaves unimplemented,
dogleg.c:440-446) and an exact check against forward-mode autodiff
(torch.func.jacfwd).
"""

from __future__ import annotations

import io
from typing import NamedTuple

import numpy as np
import torch

GRADTEST_DELTA = 1e-6  # reference dogleg.c:352


class GradientCheck(NamedTuple):
    ivar: int
    reported: torch.Tensor        # (nmeas,) user Jacobian column (midpoint)
    observed: torch.Tensor        # (nmeas,) central difference
    error: torch.Tensor           # (nmeas,) |reported - observed|
    error_relative: torch.Tensor  # (nmeas,) reference's 2|d|/(|a|+|b|)


def _relative(reported, observed):
    err = (reported - observed).abs()
    sum_abs = reported.abs() + observed.abs()
    return err, torch.where(sum_abs == 0.0, 0.0, err / (sum_abs / 2.0))


def _unit(p0: torch.Tensor, ivar: int) -> torch.Tensor:
    e = torch.zeros_like(p0)
    e[ivar] = 1.0
    return e


def check_gradients(problem, p0: torch.Tensor, ivar: int,
                    delta: float = GRADTEST_DELTA) -> GradientCheck:
    """Central-difference check of one state variable's Jacobian column
    (reference _dogleg_testGradient, dogleg.c:373-493): the problem at
    p -+ delta/2, (x - x0)/delta against the mean of the two reported
    columns. Works for any adapter with .full() (dense, sparse, residual).
    """
    e = _unit(p0, ivar)
    x0, J0 = problem.full(p0 - e * (delta / 2.0))
    x1, J1 = problem.full(p0 + e * (delta / 2.0))
    observed = (x1 - x0) / delta
    reported = (J0[:, ivar] + J1[:, ivar]) / 2.0
    err, rel = _relative(reported, observed)
    return GradientCheck(ivar=ivar, reported=reported, observed=observed,
                         error=err, error_relative=rel)


def check_gradients_products(problem, p0: torch.Tensor, ivar: int,
                             delta: float = GRADTEST_DELTA):
    """Products-mode check (unimplemented in the reference,
    dogleg.c:440-446): d(norm2x)/dp_ivar against 2 (Jt_x)_ivar, which holds
    if the user's Jt_x is consistent with norm2x. Returns (reported,
    observed, error, error_relative) 0-d tensors."""
    e = _unit(p0, ivar)
    n0, g0, _ = problem.f(p0 - e * (delta / 2.0))
    n1, g1, _ = problem.f(p0 + e * (delta / 2.0))
    observed = (n1 - n0) / delta
    reported = g0[ivar] + g1[ivar]  # the mean of 2 Jt_x at both points
    err, rel = _relative(reported, observed)
    return reported, observed, err, rel


def check_gradients_autodiff(problem, p0: torch.Tensor) -> torch.Tensor:
    """Exact check: the relative error between the user's full Jacobian and
    torch.func.jacfwd of the residuals, all variables at once, with no
    finite-difference error. Returns the (nmeas, nstate) matrix."""
    J_auto = torch.func.jacfwd(lambda p: problem.full(p)[0])(p0)
    _, J_user = problem.full(p0)
    err = (J_user - J_auto).abs()
    scale = J_user.abs() + J_auto.abs()
    return torch.where(scale == 0.0, 0.0, err / (scale / 2.0))


def format_gradient_table(check: GradientCheck) -> str:
    """The reference's vnlog gradient table, same legend and row format
    (dogleg.c:400, 472-475)."""
    out = io.StringIO()
    print("# ivar imeasurement gradient_reported gradient_observed "
          "error error_relative", file=out)
    rep, obs, err, rel = (np.asarray(t.detach().cpu()) for t in check[1:])
    for i in range(rep.shape[0]):
        print(f"{check.ivar} {i} {rep[i]:.6g} {obs[i]:.6g} "
              f"{err[i]:.6g} {rel[i]:.6g}", file=out)
    return out.getvalue()
