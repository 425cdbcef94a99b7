"""Batched independent solves (counterpart of
libdogleg_tpu/parallel/batched.py:121-226).

A batch of independent problem instances goes either to the whole-solve
kernel K1 (ops/mega.py), when the products function is one the kernel
computes on the device, or to the masked batched solver of solver.py, with
the per-element products function batched by torch.func.vmap. On the masked
path a dense mid-size JtJ in a large batch takes BlockedDenseNewtonSolver
by default (_auto_newton).
"""

from __future__ import annotations

from typing import Any, Optional

import torch
from torch.utils import _pytree as pytree

from libdogleg_tpu_torch.params import DoglegParameters
from libdogleg_tpu_torch.solver import SolveResult, solve_products_batched

# Auto-selection bounds for BlockedDenseNewtonSolver (the JAX package's,
# parallel/batched.py:31-38): a real batch and a capped Nstate. Explicit
# newton_solver=BlockedDenseNewtonSolver() covers the whole 17..256 window.
AUTO_BLOCKED_MIN_BATCH = 128
AUTO_BLOCKED_MAX_N = 128


def _check_layout(layout: str) -> None:
    if layout not in ("leading", "minor"):
        raise ValueError(
            f"layout must be 'leading' or 'minor', got {layout!r}")


def _kernel_takes(products_fn, p0_batch, newton_solver,
                  use_megakernel) -> bool:
    """The gate in front of kernel K1.

    The kernel takes the batch when the products function names a device
    function it has, the states are on CUDA, and no custom Newton strategy
    is asked for (a history is refused before the gate). use_megakernel=True
    raises where
    the kernel cannot take the batch; False disables it. There is no
    minimum batch (the JAX package's AUTO_MEGA_MIN_BATCH amortizes a Mosaic
    compile; here the build happens once per process and the kernel is the
    faster path at any batch), and no fallback: a batch the kernel takes
    runs on it or raises.
    """
    if use_megakernel is False:
        return False
    from libdogleg_tpu_torch.ops.mega import DEVICE_FUNCTIONS
    known = getattr(products_fn, "cuda_device_function",
                    None) in DEVICE_FUNCTIONS
    if use_megakernel:
        if not known:
            raise ValueError(
                "use_megakernel=True needs a products function the kernel "
                f"computes on the device (one of {sorted(DEVICE_FUNCTIONS)})")
        if newton_solver is not None:
            raise ValueError("use_megakernel=True is incompatible with "
                             "newton_solver")
        return True
    return known and p0_batch.is_cuda and newton_solver is None


def _auto_newton(products_fn, p0_batch, problem_data):
    """The batch-regime strategy default: BlockedDenseNewtonSolver for a
    dense square JtJ with BLOCKED_MIN_N <= Nstate <= AUTO_BLOCKED_MAX_N and
    a batch of at least AUTO_BLOCKED_MIN_BATCH; None (the solver default)
    otherwise, and for structured JtJ representations. The JtJ's shape comes
    from the products of the first element (the JAX package traces them
    with eval_shape)."""
    from libdogleg_tpu_torch.ops.newton import (BLOCKED_MIN_N,
                                                BlockedDenseNewtonSolver)
    if p0_batch.shape[0] < AUTO_BLOCKED_MIN_BATCH:
        return None
    data0 = (() if problem_data is None
             else (pytree.tree_map(lambda a: a[0], problem_data),))
    jtj = products_fn(p0_batch[0], *data0).JtJ
    shp = getattr(jtj, "shape", None)
    if (shp is not None and len(shp) == 2 and shp[0] == shp[1]
            and BLOCKED_MIN_N <= shp[0] <= AUTO_BLOCKED_MAX_N):
        return BlockedDenseNewtonSolver()
    return None


def batched_optimize(products_fn,
                     p0_batch: torch.Tensor,
                     parameters: Optional[DoglegParameters] = None,
                     *,
                     mesh=None,
                     axis_name: str = "dp",
                     problem_data: Any = None,
                     newton_solver=None,
                     layout: str = "leading",
                     record_history: bool = False,
                     history_capacity: Optional[int] = None,
                     wavefront_unroll: int = 1,
                     use_megakernel: Optional[bool] = None) -> SolveResult:
    """Solve a batch of independent problems.

    Args:
      products_fn: p -> Products (shared problem data, distinct starts), or
        (p, data_i) -> Products when problem_data is given, for one element;
        it must be batchable by torch.func.vmap.
      p0_batch: (B, Nstate) initial states.
      problem_data: a tensor (or tuple of tensors) with a leading batch axis.
      newton_solver: strategy override for the masked path; None
        auto-selects BlockedDenseNewtonSolver for a dense mid-size JtJ in
        a large batch (see _auto_newton).
      layout, wavefront_unroll: accepted and ignored. In the JAX package they
        tune the XLA program's carry layout and fusion on a TPU; the masked
        solver's decisions do not depend on them.
      use_megakernel: None selects kernel K1 when it can take the batch (see
        _kernel_takes); True requires it; False disables it.
      mesh, axis_name, record_history, history_capacity: sharding and the
        batched History are not ported yet; mesh= and record_history=True
        raise NotImplementedError.

    Returns a SolveResult whose leaves carry the leading batch axis.
    """
    _check_layout(layout)
    if mesh is not None:
        raise NotImplementedError("mesh= is not ported yet")
    if record_history:
        raise NotImplementedError("record_history=True is not ported yet")
    prm = parameters if parameters is not None else DoglegParameters()
    if _kernel_takes(products_fn, p0_batch, newton_solver, use_megakernel):
        from libdogleg_tpu_torch.models import quadratic_surface as qs
        from libdogleg_tpu_torch.ops.mega import megakernel_optimize
        if not isinstance(problem_data, torch.Tensor):
            raise ValueError("the kernel's products take the (B, 100) "
                             "measurements as problem_data")
        gx, gy = qs.make_grid(p0_batch.dtype, p0_batch.device)
        return megakernel_optimize(p0_batch, problem_data, gx, gy, prm)
    if newton_solver is None:
        newton_solver = _auto_newton(products_fn, p0_batch, problem_data)

    if problem_data is None:
        batched = torch.func.vmap(products_fn)
    else:
        vf = torch.func.vmap(products_fn)

        def batched(p):
            return vf(p, problem_data)
    return solve_products_batched(batched, p0_batch, prm,
                                  newton_solver=newton_solver)


def batched_optimize_compacted(*args, **kwargs):
    """Straggler compaction (JAX parallel/batched.py:229) is not ported
    yet."""
    raise NotImplementedError("batched_optimize_compacted is not ported yet")
