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

from libdogleg_tpu_torch.problems import (DenseProblem, FactoredBasisProblem,
                                          ProductsProblem, ResidualProblem,
                                          SparseProblem)
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


# make_grid's tensors per (dtype, device), built once, for the port's own
# read-only uses on the kernel path (parallel/batched.py, factored_statistics)
_GRIDS = {}


def _cached_grid(dtype, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """make_grid(dtype, device), built once per (dtype, device) and shared:
    the caller must not write to it. make_grid copies from host memory and
    waits for the device each time; this does so only the first time."""
    key = (dtype, torch.device(device))
    grid = _GRIDS.get(key)
    if grid is None:
        grid = _GRIDS[key] = make_grid(dtype, device)
    return grid


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


# ---------------------------------------------------------------------------
# Basis-factored sufficient-statistics form (quadratic_surface.py:212-307 of
# the JAX package). The model is linear in a static basis, model(p) =
# basis @ coeffs(p) with basis = [x^2, y^2, xy, x, y, 1] fixed by the grid,
# so with G = basis^T basis (once) and h = basis^T meas (once per instance):
#     JtJ = T^T G T,  Jt_x = T^T (G c - h),  norm2 = c.(G c - h) + (m.m - c.h)
# with T = d coeffs / dp. An evaluation reads 14 values of statistics
# instead of the 100 measurements. G c and h are ~1e7 and cancel to the
# gradient's scale, so G, h and m.m are (hi, lo) pairs and the cancelling
# combinations run in compensated arithmetic (ops/compensated.py).
# ---------------------------------------------------------------------------

def basis(gx: torch.Tensor, gy: torch.Tensor) -> torch.Tensor:
    """The static (nmeas, 6) basis: model(p) = basis @ coeffs(p). Its
    entries are integers <= 100 on the sample grid, exact in float32."""
    return torch.stack([gx * gx, gy * gy, gx * gy, gx, gy,
                        torch.ones_like(gx)], dim=-1)


def coeffs(p: torch.Tensor) -> torch.Tensor:
    """c = [p0 p1, p1 p2, p2, p3, p4, p5]; p (..., 6) -> (..., 6)."""
    return torch.stack([p[..., 0] * p[..., 1], p[..., 1] * p[..., 2],
                        p[..., 2], p[..., 3], p[..., 4], p[..., 5]], dim=-1)


def coeffs_jac(p: torch.Tensor) -> torch.Tensor:
    """T[i, j] = d coeffs_i / d p_j; p (..., 6) -> (..., 6, 6)."""
    z = torch.zeros_like(p[..., 0])
    o = torch.ones_like(z)
    p0, p1, p2 = p[..., 0], p[..., 1], p[..., 2]
    rows = ((p1, p0, z, z, z, z), (z, p2, p1, z, z, z), (z, z, o, z, z, z),
            (z, z, z, o, z, z), (z, z, z, z, o, z), (z, z, z, z, z, o))
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def factored_statistics(measurements: torch.Tensor):
    """Per-instance sufficient statistics as compensated pairs, on the
    measurements' device: (h_hi, h_lo) = basis^T meas (..., 6) and
    (n2m_hi, n2m_lo) = meas . meas (...), for meas (..., NMEAS)."""
    gx, gy = _cached_grid(measurements.dtype, measurements.device)
    return FactoredBasisProblem.statistics(basis(gx, gy), measurements)


def gram_pair(dtype=torch.float32, device=None):
    """G = basis^T basis as a double-float32 pair, on `device` (None: the
    CUDA device). Its exact integer entries, up to ~1e10, exceed float32's
    24-bit integers: computed in float64 numpy and split."""
    coords = GRID_MIN + GRID_DELTA * np.arange(GRID_WIDTH)
    gx, gy = np.meshgrid(coords, coords, indexing="ij")
    gx, gy = gx.ravel(), gy.ravel()
    B = np.stack([gx * gx, gy * gy, gx * gy, gx, gy, np.ones_like(gx)],
                 axis=-1)
    return FactoredBasisProblem.gram(B, dtype, device)


def factored_products(p: torch.Tensor, stats, G_pair) -> Products:
    """Products from sufficient statistics: stats =
    factored_statistics(meas), G_pair = gram_pair(dtype, device). p and the
    statistics may carry leading batch axes."""
    return FactoredBasisProblem(coeffs=coeffs, G_pair=G_pair, stats=stats,
                                coeffs_jac=coeffs_jac).products(p)


def factored_products_fn(G_pair):
    """(p, stats) -> factored_products(p, stats, G_pair), the per-element
    products function that batched_optimize takes with
    problem_data=(h_hi, h_lo, n2m_hi, n2m_lo). It names the device function
    `quadratic_surface_factored_products` of csrc/mega.cu in its
    `cuda_device_function` attribute and carries the Gram pair as `G_pair`,
    so batched_optimize hands a batch on the card to that kernel instance.
    (The JAX package passes a lambda around factored_products, which its
    megakernel cannot recognize.)"""
    def products(p, stats):
        return factored_products(p, stats, G_pair)
    products.cuda_device_function = "quadratic_surface_factored_products"
    products.G_pair = G_pair
    return products


def factored_products_minor(p, h_hi, h_lo, n2m_hi, n2m_lo, Ghi, Glo):
    """Batch-minor factored products, the plain twin of the kernel's device
    function `quadratic_surface_factored_products`: p (6, bt), h_hi/h_lo
    (6, bt), n2m_hi/n2m_lo (1, bt), Ghi/Glo (6, 6) -> (norm2 (1, bt),
    Jt_x (6, bt), JtJ (6, 6, bt)).

    The cancelling combinations (G c - h, m.m - c.h) run in compensated
    arithmetic like FactoredBasisProblem.products, with the pairwise
    reduction replaced by a sequential two_sum cascade (the same O(eps^2)
    error class), and T's eight nonzero entries applied by hand. Every
    operation is a separate eager op, in the JAX package's order, which the
    device function repeats operation for operation."""
    from libdogleg_tpu_torch.ops.compensated import two_prod, two_sum

    c = [p[0:1] * p[1:2], p[1:2] * p[2:3], p[2:3], p[3:4], p[4:5], p[5:6]]

    # (G c) as compensated pairs, row by row
    gh, gl = [], []
    for i in range(6):
        s, lo = two_prod(Ghi[i:i + 1, 0:1], c[0])
        lo = lo + Glo[i:i + 1, 0:1] * c[0]
        for j in range(1, 6):
            pj, pe = two_prod(Ghi[i:i + 1, j:j + 1], c[j])
            s, se = two_sum(s, pj)
            lo = lo + pe + se + Glo[i:i + 1, j:j + 1] * c[j]
        gh.append(s)
        gl.append(lo)

    # g = (G c - h) collapsed; the pair keeps the cancellation exact
    g = []
    for i in range(6):
        s, e = two_sum(gh[i], -h_hi[i:i + 1])
        g.append(s + (gl[i] - h_lo[i:i + 1] + e))

    # Jt_x = T^T g
    jtx = torch.cat([p[1:2] * g[0], p[0:1] * g[0] + p[2:3] * g[1],
                     p[1:2] * g[1] + g[2], g[3], g[4], g[5]], dim=0)

    # JtJ = T^T (Ghi + Glo) T: M = G T column by column, then rows of T^T M
    Gf = Ghi + Glo
    ones = torch.ones_like(p[0:1])
    M = [Gf[:, 0:1] * p[1:2],
         Gf[:, 0:1] * p[0:1] + Gf[:, 1:2] * p[2:3],
         Gf[:, 1:2] * p[1:2] + Gf[:, 2:3]] + [Gf[:, j:j + 1] * ones
                                              for j in (3, 4, 5)]
    Mm = torch.stack(M, dim=1)             # (6, 6, bt): Mm[i, b]
    jtj = torch.stack([p[1:2] * Mm[0], p[0:1] * Mm[0] + p[2:3] * Mm[1],
                       p[1:2] * Mm[1] + Mm[2], Mm[3], Mm[4], Mm[5]], dim=0)

    # norm2 = c.g + ((m.m) - c.h), the second term compensated
    cg = sum(c[i] * g[i] for i in range(6))
    wh, wl = two_prod(c[0], h_hi[0:1])
    wl = wl + c[0] * h_lo[0:1]
    for i in range(1, 6):
        pi, pe = two_prod(c[i], h_hi[i:i + 1])
        wh, se = two_sum(wh, pi)
        wl = wl + pe + se + c[i] * h_lo[i:i + 1]
    uh, ue = two_sum(n2m_hi, -wh)
    norm2 = cg + (uh + (n2m_lo - wl + ue))
    norm2 = torch.maximum(norm2, torch.zeros_like(norm2))
    return norm2, jtx, jtj


def make_factored_problem(measurements: torch.Tensor) -> FactoredBasisProblem:
    """The sufficient-statistics form as a problem: the optimum of
    make_dense_problem / make_products_problem, at a cost per evaluation
    independent of the measurement count."""
    return FactoredBasisProblem(
        coeffs=coeffs,
        G_pair=gram_pair(measurements.dtype, measurements.device),
        stats=factored_statistics(measurements),
        coeffs_jac=coeffs_jac)


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
