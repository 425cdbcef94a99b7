"""Exponential-decay curve fit, a small dense-Jacobian model family
(counterpart of libdogleg_tpu/models/curve_fit.py).

The dense path's workload (BASELINE.md config 2; the reference's dense
entry points dogleg_optimize_dense/dense2, reference dogleg.c:1767-1790):
fit

    m(t; p) = p0 * exp(p1 * t) + p2

to nmeas samples on t in [0, 1]. Nstate = 3 with a closed-form Jacobian,
so the problem tests the trust-region iteration and the dense Cholesky; it is
nonlinear in p, unlike the quadratic-surface demo, which converges in one
Gauss-Newton step from anywhere.
"""

from __future__ import annotations

import numpy as np
import torch

from libdogleg_tpu_torch.device import resolve_device
from libdogleg_tpu_torch.problems import (DenseProblem, ProductsProblem,
                                          ResidualProblem)

NSTATE = 3
P_TRUE = np.array([2.0, -1.5, 0.5])


def make_t(nmeas: int = 64, dtype=torch.float64, device=None) -> torch.Tensor:
    """nmeas sample times evenly spaced on [0, 1], made in float64 on the
    host (the JAX package's linspace formula, start + i * step, with the
    last point exactly 1) and rounded to dtype on `device` (None: the CUDA
    device)."""
    return torch.as_tensor(np.linspace(0.0, 1.0, nmeas), dtype=dtype,
                           device=resolve_device(device))


def model(p: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return p[0] * torch.exp(p[1] * t) + p[2]


def jacobian(p: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    e = torch.exp(p[1] * t)
    return torch.stack([e, p[0] * t * e, torch.ones_like(t)], dim=-1)


def simulate(generator: torch.Generator, nmeas: int = 64,
             dtype=torch.float64, device=None,
             noise: float = 0.02) -> torch.Tensor:
    """The model at P_TRUE plus noise N(0, 1), drawn on the generator's
    device and returned on `device` (None: the CUDA device)."""
    t = make_t(nmeas, dtype, generator.device)
    truth = model(torch.as_tensor(P_TRUE, dtype=dtype,
                                  device=generator.device), t)
    n = torch.randn((nmeas,), generator=generator, dtype=dtype,
                    device=generator.device)
    return (truth + noise * n).to(resolve_device(device))


def initial_state(generator: torch.Generator, dtype=torch.float64,
                  device=None) -> torch.Tensor:
    """A spread-out start, uniform in [-0.5, 0.5), which takes several
    trust-region iterations; drawn on the generator's device and returned
    on `device` (None: the CUDA device)."""
    u = torch.rand((NSTATE,), generator=generator, dtype=dtype,
                   device=generator.device)
    return (u - 0.5).to(resolve_device(device))


def residuals(p, measurements, t):
    return model(p, t) - measurements


def _times(measurements: torch.Tensor) -> torch.Tensor:
    return make_t(measurements.shape[0], measurements.dtype,
                  measurements.device)


def make_dense_problem(measurements: torch.Tensor) -> DenseProblem:
    t = _times(measurements)

    def f(p):
        return residuals(p, measurements, t), jacobian(p, t)
    return DenseProblem(f=f)


def make_products_problem(measurements: torch.Tensor) -> ProductsProblem:
    t = _times(measurements)

    def f(p):
        x = residuals(p, measurements, t)
        J = jacobian(p, t)
        return x @ x, J.T @ x, J.T @ J
    return ProductsProblem(f=f)


def make_residual_problem(measurements: torch.Tensor) -> ResidualProblem:
    t = _times(measurements)
    return ResidualProblem(f=lambda p: residuals(p, measurements, t))
