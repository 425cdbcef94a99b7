"""The reference's demo problem (counterpart of
libdogleg_tpu/models/quadratic_surface.py).

Fit the 6-parameter model

    m(x, y; p) = p0*p1*x^2 + p1*p2*y^2 + p2*x*y + p3*x + p4*y + p5

to 100 noisy measurements on the 10x10 grid x, y in {-10, -8, ..., 8}
(reference sample.c:24-80), true parameters (1, 2, 3, 4, 5, 6), +-0.5 units
of uniform noise, and an initial state uniform in [-0.1, 0.9]
(sample.c:371). Random draws come from an explicit torch.Generator; they are
not the JAX package's jax.random streams, so tests that compare the two
packages make their inputs with numpy and hand them to both.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from libdogleg_tpu_torch.problems import (DenseProblem, ProductsProblem,
                                          ResidualProblem, SparseProblem)
from libdogleg_tpu_torch.device import resolve_device
from libdogleg_tpu_torch.solver import Products
from libdogleg_tpu_torch.sparsity import dense_structure

NSTATE = 6
GRID_WIDTH = 10
GRID_MIN = -10.0
GRID_DELTA = 2.0
NMEAS = GRID_WIDTH * GRID_WIDTH
P_TRUE = np.array([1.0, 2.0, 3.0, 4.0, 5.0, 6.0])


def make_grid(dtype=torch.float64, device=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The 10x10 sampling grid (reference sample.c:64-80; x-major order),
    on `device` (None: the CUDA device, see device.resolve_device)."""
    device = resolve_device(device)
    coords = GRID_MIN + GRID_DELTA * np.arange(GRID_WIDTH)
    gx, gy = np.meshgrid(coords, coords, indexing="ij")
    return (torch.as_tensor(gx.ravel(), dtype=dtype, device=device),
            torch.as_tensor(gy.ravel(), dtype=dtype, device=device))


def model(p: torch.Tensor, gx: torch.Tensor, gy: torch.Tensor) -> torch.Tensor:
    return (p[0] * p[1] * gx * gx
            + p[1] * p[2] * gy * gy
            + p[2] * gx * gy
            + p[3] * gx
            + p[4] * gy
            + p[5])


def jacobian(p: torch.Tensor, gx: torch.Tensor,
             gy: torch.Tensor) -> torch.Tensor:
    """Closed-form (nmeas, 6) Jacobian (reference sample.c:118-123)."""
    one = torch.ones_like(gx)
    return torch.stack([
        p[1] * gx * gx,
        p[0] * gx * gx + p[2] * gy * gy,
        p[1] * gy * gy + gx * gy,
        gx,
        gy,
        one,
    ], dim=-1)


def residuals(p: torch.Tensor, measurements: torch.Tensor,
              gx: torch.Tensor, gy: torch.Tensor) -> torch.Tensor:
    return model(p, gx, gy) - measurements


def products(p: torch.Tensor, meas: torch.Tensor) -> Products:
    """Per-element products for batched_optimize: p (6,), meas (100,).

    The `cuda_device_function` attribute names the device function in
    csrc/mega.cu that computes the same products inside the whole-solve
    kernel; batched_optimize hands the batch to that kernel when it sees it.
    """
    gx, gy = make_grid(p.dtype, p.device)
    x = residuals(p, meas, gx, gy)
    J = jacobian(p, gx, gy)
    return Products(norm2_x=x @ x, Jt_x=J.T @ x, JtJ=J.T @ J)


products.cuda_device_function = "quadratic_surface_products"


def products_minor(p: torch.Tensor, meas: torch.Tensor,
                   X: torch.Tensor, Y: torch.Tensor):
    """Batch-MINOR products, the plain twin of the kernel's device function
    `quadratic_surface_products`: p (6, bt), meas (nmeas, bt), X/Y
    (nmeas, 1) grid columns -> (norm2 (1, bt), Jt_x (6, bt),
    JtJ (6, 6, bt))."""
    x = (p[0:1] * p[1:2] * X * X + p[1:2] * p[2:3] * Y * Y
         + p[2:3] * X * Y + p[3:4] * X + p[4:5] * Y + p[5:6]
         - meas)                                     # (m, bt)
    ones = torch.ones_like(x)
    J = torch.stack([p[1:2] * X * X,
                     p[0:1] * X * X + p[2:3] * Y * Y,
                     p[1:2] * Y * Y + X * Y,
                     X * ones, Y * ones, ones])      # (6, m, bt)
    norm2 = (x * x).sum(0, keepdim=True)
    jtx = (J * x).sum(1)
    jtj = (J[:, None] * J[None]).sum(2)              # (6, 6, bt)
    return norm2, jtx, jtj


def simulate(generator: torch.Generator, dtype=torch.float64, device=None,
             noise: float = 1.0, batch: Tuple[int, ...] = ()) -> torch.Tensor:
    """Noisy measurements (batch..., NMEAS): truth +- 0.5*noise units uniform
    (reference sample.c:46-62). Drawn on the generator's device, returned
    on `device` (None: the CUDA device)."""
    device = resolve_device(device)
    gx, gy = make_grid(dtype, generator.device)
    truth = model(torch.as_tensor(P_TRUE, dtype=dtype,
                                  device=generator.device), gx, gy)
    u = torch.rand(tuple(batch) + (NMEAS,), generator=generator, dtype=dtype,
                   device=generator.device)
    return (truth + (u - 0.5) * noise).to(device)


def initial_state(generator: torch.Generator, dtype=torch.float64,
                  device=None, batch: Tuple[int, ...] = ()) -> torch.Tensor:
    """Initial guess (batch..., NSTATE) uniform in [-0.1, 0.9] (reference
    sample.c:371). Drawn on the generator's device, returned on `device`
    (None: the CUDA device)."""
    device = resolve_device(device)
    u = torch.rand(tuple(batch) + (NSTATE,), generator=generator,
                   dtype=dtype, device=generator.device)
    return (u - 0.1).to(device)


def make_dense_problem(measurements: torch.Tensor) -> DenseProblem:
    """Dense mode (reference optimizerCallback_dense, sample.c:130-162)."""
    gx, gy = make_grid(measurements.dtype, measurements.device)

    def f(p):
        return residuals(p, measurements, gx, gy), jacobian(p, gx, gy)
    return DenseProblem(f=f)


def make_sparse_problem(measurements: torch.Tensor,
                        block_rows: int = 4) -> SparseProblem:
    """Sparse mode. The demo problem is fully dense (sample.c:113-116), so
    the block pattern stores every block: the block-CSR machinery exercised
    the way sample.c exercises the CHOLMOD path with a dense pattern."""
    gx, gy = make_grid(measurements.dtype, measurements.device)
    structure = dense_structure(NMEAS, NSTATE, block_rows=block_rows,
                                block_cols=NSTATE)

    def f(p):
        x = residuals(p, measurements, gx, gy)
        J = jacobian(p, gx, gy)
        return x, J.reshape(structure.nnzb, block_rows, NSTATE)
    return SparseProblem(f=f, structure=structure)


def make_products_problem(measurements: torch.Tensor) -> ProductsProblem:
    """Products mode (reference optimizerCallback_dense_products,
    sample.c:165-237): the user reduces over measurements themselves."""
    gx, gy = make_grid(measurements.dtype, measurements.device)

    def f(p):
        x = residuals(p, measurements, gx, gy)
        J = jacobian(p, gx, gy)
        return x @ x, J.T @ x, J.T @ J
    return ProductsProblem(f=f)


def make_residual_problem(measurements: torch.Tensor) -> ResidualProblem:
    """Autodiff mode (no reference equivalent)."""
    gx, gy = make_grid(measurements.dtype, measurements.device)
    return ResidualProblem(f=lambda p: residuals(p, measurements, gx, gy))
