"""Batched independent solves (counterpart of
libdogleg_tpu/parallel/batched.py:121-406).

A batch of independent problem instances goes to the whole-solve kernel K1
(ops/mega.py) in the instance whose device function the products function
names; else, where parallel/mega_auto.py can take the products function (a
(B, n <= 16) state, a dense JtJ, float32 on the card from a batch of 1024,
or use_megakernel=True), to K1 on a functor generated from it; else to the
masked batched solver of solver.py, with
the per-element products function batched by torch.func.vmap. On the masked
path a dense mid-size JtJ in a large batch takes BlockedDenseNewtonSolver
by default (_auto_newton), whose factorization is kernel K5 on CUDA tensors,
and tree starts with a SchurJtJ (a batch of bundle adjustments, each with
its own observations as problem_data) take TreeSchurNewtonSolver, or
SparseWSchurNewtonSolver for a SparseWSchurJtJ (sparse visibility).
batched_optimize_compacted is the same solve with straggler compaction.

mesh= shards the batch axis over a mesh axis (parallel/mesh.py), as the JAX
package's in_shardings/out_shardings do: each rank solves its contiguous
block of the batch on the path it would take alone (K1's named instance,
K1 generated, or the masked driver), with no communication, and the
results come back as DTensors sharded on that axis. Compaction's adaptive
phase 1 counts the live elements over the whole batch, one all_reduce a
wavefront, so every rank runs the same number of attempts there.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from libdogleg_tpu_torch.ops import treevec as tv
from libdogleg_tpu_torch.params import DoglegParameters
from libdogleg_tpu_torch.solver import (SolveResult, init_batched_state,
                                        result_from_batched_state,
                                        run_batched_solver,
                                        solve_products_batched)
from libdogleg_tpu_torch.telemetry import span

# Auto-selection bounds for BlockedDenseNewtonSolver (the JAX package's,
# parallel/batched.py:31-38): a real batch and a capped Nstate. Explicit
# newton_solver=BlockedDenseNewtonSolver() covers the whole 17..256 window.
AUTO_BLOCKED_MIN_BATCH = 128
AUTO_BLOCKED_MAX_N = 128


def _placements(mesh, axis_name: str, dim: int = 0):
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import Replicate, Shard
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a torch.distributed DeviceMesh "
                        f"(parallel.make_mesh); got {type(mesh).__name__}")
    if axis_name not in (mesh.mesh_dim_names or ()):
        raise ValueError(f"the mesh has no axis {axis_name!r}: "
                         f"{mesh.mesh_dim_names}")
    return [Shard(dim) if n == axis_name else Replicate()
            for n in mesh.mesh_dim_names]


def _from_local(local: torch.Tensor, mesh, axis_name: str, dim: int = 0):
    """A rank's block of a tensor as the DTensor of the whole, sharded on
    its axis `dim` (the batch axis by default) over the mesh axis (blocks
    of one size)."""
    from torch.distributed.tensor import DTensor
    from libdogleg_tpu_torch.parallel.mesh import axis_size
    shape = list(local.shape)
    shape[dim] *= axis_size(mesh, axis_name)
    shape = tuple(shape)
    return DTensor.from_local(local, mesh, _placements(mesh, axis_name, dim),
                              run_check=False, shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta")
                              .stride())


def shard_batch(tree: Any, mesh, axis_name: str = "dp") -> Any:
    """Each leaf of a tree of batch-leading tensors, held whole on every
    rank, as a DTensor sharded on its leading axis over the mesh axis (the
    rank keeps its contiguous block; the JAX package's device_put with
    NamedSharding(mesh, P(axis_name))). A batch the axis does not divide
    raises."""
    from libdogleg_tpu_torch.parallel.mesh import local_rows
    _placements(mesh, axis_name)
    return pytree.tree_map_only(
        torch.Tensor, lambda a: _from_local(
            local_rows(a, mesh, axis_name).contiguous(), mesh, axis_name),
        tree)


def sharded_like(tree: Any, mesh, axis_name: str = "dp") -> Any:
    """A tree of a rank's batch-leading blocks (a SolveResult, a
    BatchedSolverState) as DTensors of the whole batch, sharded on the
    axis."""
    return pytree.tree_map_only(
        torch.Tensor, lambda a: _from_local(a, mesh, axis_name), tree)


def local_blocks(tree: Any, mesh, axis_name: str = "dp") -> Any:
    """The rank's blocks of a tree's batch-leading leaves: a DTensor's
    local tensor, a whole tensor's contiguous block."""
    from libdogleg_tpu_torch.parallel.mesh import local_tree
    _placements(mesh, axis_name)
    return local_tree(tree, mesh, axis_name)


def _check_layout(layout: str) -> None:
    if layout not in ("leading", "minor"):
        raise ValueError(
            f"layout must be 'leading' or 'minor', got {layout!r}")


def _kernel_takes(products_fn, p0_batch, newton_solver, record_history,
                  use_megakernel) -> bool:
    """The gate in front of kernel K1's named instances, which comes first.

    A named instance takes the batch when the products function names a
    device function it has (in its `cuda_device_function` attribute: the
    general instance for quadratic_surface.products, the factored one for
    quadratic_surface.factored_products_fn(G_pair)), the states are one
    tensor on CUDA, and neither a custom Newton strategy nor a History is
    asked for; use_megakernel=True raises where it cannot, and False
    disables it. There is no minimum batch (the library is built once per
    process, and the kernel is the faster path at any batch) and no
    fallback: a batch it takes runs on it or raises. A products function
    that names no device function goes on to _try_megakernel.
    """
    if use_megakernel is False:
        return False
    from libdogleg_tpu_torch.ops.mega import DEVICE_FUNCTIONS
    if getattr(products_fn, "cuda_device_function",
               None) not in DEVICE_FUNCTIONS:
        return False
    flat = isinstance(p0_batch, torch.Tensor)
    if use_megakernel:
        if not flat:
            raise ValueError("use_megakernel=True needs a (B, Nstate) start")
        if newton_solver is not None or record_history:
            raise ValueError("use_megakernel=True is incompatible with "
                             "record_history and newton_solver")
        return True
    return (flat and p0_batch.is_cuda and newton_solver is None
            and not record_history)


def _try_megakernel(products_fn, p0_batch, prm, problem_data, newton_solver,
                    record_history, use_megakernel, global_batch):
    """Auto-promotion into K1 on a generated functor (the JAX package's
    parallel/batched.py:87-119): a plan (parallel/mega_auto.plan_megakernel)
    to call, or None for the masked path. None as well where
    use_megakernel is False or LIBDOGLEG_TPU_NO_MEGAKERNEL is set, and for a
    History or a custom strategy; with use_megakernel=True those, and a
    function outside the regime, raise. Once a plan exists nothing falls
    back: its build or launch errors raise. The JAX package traces the
    function once under jax.jit's cache; here plan_megakernel's plan cache
    takes that role: a repeated call with the same function and shapes
    traces nothing (mega_auto.trace_count). Under a mesh p0_batch is the
    rank's block, and the promotion threshold reads global_batch. A
    measurement-sharded products function is never promoted."""
    from libdogleg_tpu_torch.parallel.mega_auto import (_env_disabled,
                                                        plan_megakernel)
    if use_megakernel is False or _env_disabled():
        return None
    forced = bool(use_megakernel)
    if record_history or newton_solver is not None:
        if forced:
            raise ValueError("use_megakernel=True is incompatible with "
                             "record_history and newton_solver")
        return None
    if getattr(products_fn, "batched", None) is not None:
        # a products function with its own batched form
        # (parallel/sharded.py) sums over the ranks with an all_reduce,
        # which a kernel cannot hold: never traced
        if forced:
            raise ValueError("use_megakernel=True cannot take a products "
                             "function with its own batched form (a "
                             "measurement-sharded one): its all_reduce "
                             "does not run inside K1")
        return None
    plan = plan_megakernel(products_fn, p0_batch, prm,
                           problem_data=problem_data, forced=forced,
                           global_batch=global_batch)
    if plan is None and forced:
        raise ValueError(
            "use_megakernel=True but the problem is outside the megakernel "
            "regime (needs a single (B, n <= 16) state batch and a dense "
            "JtJ)")
    return plan


def _auto_newton(products_fn, p0_batch, problem_data, global_batch=None):
    """The batch-regime strategy default: BlockedDenseNewtonSolver for a
    dense square JtJ with BLOCKED_MIN_N <= Nstate <= AUTO_BLOCKED_MAX_N and
    a batch of at least AUTO_BLOCKED_MIN_BATCH; None (the solver default)
    otherwise, and for structured JtJ representations. The JtJ's shape
    comes from the products of the first element (the JAX package traces
    them with eval_shape). A tree start never comes here: _check_start
    requires its strategy. Under a mesh the batch is the global one."""
    from libdogleg_tpu_torch.ops.newton import (BLOCKED_MIN_N,
                                                BlockedDenseNewtonSolver)
    if (global_batch or p0_batch.shape[0]) < AUTO_BLOCKED_MIN_BATCH:
        return None
    data0 = (() if problem_data is None
             else (pytree.tree_map(lambda a: a[0], problem_data),))
    jtj = products_fn(p0_batch[0], *data0).JtJ
    shp = getattr(jtj, "shape", None)
    if (shp is not None and len(shp) == 2 and shp[0] == shp[1]
            and BLOCKED_MIN_N <= shp[0] <= AUTO_BLOCKED_MAX_N):
        return BlockedDenseNewtonSolver()
    return None


def _check_start(p0_batch, newton_solver) -> None:
    """Refuse a start the masked solver cannot take: a tree whose leaves
    differ in their leading (batch) size, and a tree without a strategy for
    batched tree states (TreeSchurNewtonSolver, or SparseWSchurNewtonSolver
    for sparse visibility)."""
    from libdogleg_tpu_torch.ops.newton import (SparseWSchurNewtonSolver,
                                                TreeSchurNewtonSolver)
    if isinstance(p0_batch, torch.Tensor):
        return
    sizes = {leaf.shape[0] if leaf.dim() else None
             for leaf in tv.tree_leaves(p0_batch)}
    if len(sizes) != 1 or None in sizes:
        raise ValueError(
            "every leaf of a tree start must have the same leading (batch) "
            f"size; got {sorted(map(str, sizes))}")
    if not isinstance(newton_solver, (TreeSchurNewtonSolver,
                                      SparseWSchurNewtonSolver)):
        raise ValueError(
            "a tree start needs a newton_solver for batched tree states: "
            "TreeSchurNewtonSolver or SparseWSchurNewtonSolver")


class _Prepared(NamedTuple):
    """What both entry points do first (_prepare): the parameters, the
    strategy, the masked path's products (batched_of) or the kernel's
    zero-argument call (kernel), the rank's start and the global batch."""
    prm: DoglegParameters
    newton_solver: Any
    batched_of: Any
    kernel: Any
    p0: Any
    global_batch: int


def _vmapped(products_fn):
    """The batch-leading form of a per-element products function: its own
    `batched` where it has one (parallel/sharded.py: one all_reduce for
    the whole batch), else torch.func.vmap of it."""
    batched = getattr(products_fn, "batched", None)
    return batched if batched is not None else torch.func.vmap(products_fn)


def _prepare(products_fn, p0_batch, parameters, mesh, axis_name,
             problem_data, newton_solver, layout, record_history,
             use_megakernel) -> _Prepared:
    """Refuse what the masked solver cannot take, resolve the parameters,
    take the rank's blocks of the start and the data under a mesh, and pick
    the path: kernel, a zero-argument callable that runs the solve on K1
    (a named instance, else a generated one), or None; when it is None,
    batched_of() is the batch-leading products function of the whole
    (local) batch for the masked solver and batched_of(idx) that of the
    elements idx (their problem_data gathered), and newton_solver is the
    given or auto-selected strategy."""
    with span("dogleg.route"):
        _check_layout(layout)
        global_batch = tv.tree_leaves(p0_batch)[0].shape[0]
        if mesh is not None:
            p0_batch = local_blocks(p0_batch, mesh, axis_name)
            if problem_data is not None:
                problem_data = local_blocks(problem_data, mesh, axis_name)
        prm = parameters if parameters is not None else DoglegParameters()
        if _kernel_takes(products_fn, p0_batch, newton_solver, record_history,
                         use_megakernel):
            return _Prepared(prm, None, None, lambda: _run_megakernel(
                products_fn, p0_batch, problem_data, prm), p0_batch,
                global_batch)
        plan = _try_megakernel(products_fn, p0_batch, prm, problem_data,
                               newton_solver, record_history, use_megakernel,
                               global_batch)
        if plan is not None:
            return _Prepared(prm, None, None, plan, p0_batch, global_batch)
        _check_start(p0_batch, newton_solver)
        if newton_solver is None:
            newton_solver = _auto_newton(products_fn, p0_batch, problem_data,
                                         global_batch)
        vf = _vmapped(products_fn)

        def batched_of(idx=None):
            if problem_data is None:
                return vf
            data = (problem_data if idx is None else
                    pytree.tree_map(lambda a: a[idx], problem_data))
            return lambda p: vf(p, data)
        return _Prepared(prm, newton_solver, batched_of, None, p0_batch,
                         global_batch)


def _global_count(n: torch.Tensor, mesh, axis_name: str) -> int:
    """A count over the whole batch: the ranks' counts summed over the
    mesh axis (a CPU tensor where the axis's backend is gloo)."""
    if mesh is None:
        return int(n)
    group = mesh.get_group(axis_name)
    if "nccl" not in str(dist.get_backend(group)):
        n = n.cpu()
    n = n.to(torch.int64).reshape(1)
    dist.all_reduce(n, group=group)
    return int(n)


def _run_megakernel(products_fn, p0_batch, problem_data,
                    prm) -> SolveResult:
    """Kernel K1's instance for the device function products_fn names:
    the general one takes the (B, 100) measurements as problem_data, the
    factored one the statistics (h_hi, h_lo, n2m_hi, n2m_lo) and the Gram
    pair the products function carries (quadratic_surface.
    factored_products_fn)."""
    from libdogleg_tpu_torch.models import quadratic_surface as qs
    from libdogleg_tpu_torch.ops import mega
    if products_fn.cuda_device_function == "quadratic_surface_products":
        if not isinstance(problem_data, torch.Tensor):
            raise ValueError("the kernel's products take the (B, 100) "
                             "measurements as problem_data")
        gx, gy = qs._cached_grid(p0_batch.dtype, p0_batch.device)
        return mega.megakernel_optimize(p0_batch, problem_data, gx, gy, prm)
    if (not isinstance(problem_data, (tuple, list)) or len(problem_data) != 4
            or getattr(products_fn, "G_pair", None) is None):
        raise ValueError("the kernel's factored products take (h_hi, h_lo, "
                         "n2m_hi, n2m_lo) as problem_data and the Gram pair "
                         "from quadratic_surface.factored_products_fn")
    return mega.megakernel_optimize_factored(p0_batch, *problem_data,
                                             products_fn.G_pair, prm)


def batched_optimize(products_fn,
                     p0_batch,
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
      p0_batch: (B, Nstate) initial states, or a tree whose every leaf has
        the leading batch axis, such as {"c": (B, nc), "q": (B, n_points,
        bs)} (bundle adjustment; newton_solver=TreeSchurNewtonSolver, or
        SparseWSchurNewtonSolver for sparse visibility).
      problem_data: a tensor (or tuple of tensors) with a leading batch axis.
      newton_solver: strategy override for the masked path; None
        auto-selects BlockedDenseNewtonSolver for a dense mid-size JtJ in
        a large batch (see _auto_newton). A structured JtJ such as
        SchurJtJ needs its strategy (SchurNewtonSolver for flat states).
      record_history, history_capacity: keep the per-attempt History, one
        (B, cap) buffer a field, cap defaulting to the attempt cap.
      layout, wavefront_unroll: accepted and ignored. In the JAX package they
        tune the XLA program's carry layout and fusion on a TPU; the masked
        solver's decisions do not depend on them.
      use_megakernel: None selects kernel K1 when it can take the batch: a
        named instance (_kernel_takes), else, for float32 CUDA states (B,
        n <= 16) with B >= 1024 and a dense JtJ, a functor generated from
        products_fn (parallel/mega_auto.py; not under
        LIBDOGLEG_TPU_NO_MEGAKERNEL). True requires K1 (a generated functor
        at any batch and in float64 too, the plain version on CPU tensors)
        and raises where it cannot; False disables both. A batch K1 takes
        runs on it or raises: nvcc and launch errors are not caught.
      mesh, axis_name: a DeviceMesh (parallel/mesh.make_mesh) and the
        axis the batch is sharded over. p0_batch's and problem_data's
        leaves are DTensors sharded on their leading axis there
        (shard_batch), or whole tensors held the same on every rank, of
        which each rank takes its contiguous block; a batch the axis does
        not divide raises. Each rank solves its block on the path it would
        take alone (K1 on its block; the promotion threshold and
        _auto_newton read the global batch), with no communication.

    Returns a SolveResult whose leaves carry the leading batch axis; under
    a mesh they are DTensors sharded on it (Shard(0) on the axis).
    """
    with span("dogleg.call"):
        pr = _prepare(products_fn, p0_batch, parameters, mesh, axis_name,
                      problem_data, newton_solver, layout, record_history,
                      use_megakernel)
        if pr.kernel is not None:
            r = pr.kernel()
        else:
            r = solve_products_batched(pr.batched_of(), pr.p0, pr.prm,
                                       newton_solver=pr.newton_solver,
                                       record_history=record_history,
                                       history_capacity=history_capacity)
        return r if mesh is None else sharded_like(r, mesh, axis_name)


def batched_optimize_compacted(products_fn,
                               p0_batch,
                               parameters: Optional[DoglegParameters] = None,
                               *,
                               mesh=None,
                               axis_name: str = "dp",
                               problem_data: Any = None,
                               phase1_attempts: Optional[int] = None,
                               compact_capacity: Optional[int] = None,
                               newton_solver=None,
                               layout: str = "leading",
                               record_history: bool = False,
                               history_capacity: Optional[int] = None,
                               wavefront_unroll: int = 1,
                               use_megakernel: Optional[bool] = None
                               ) -> SolveResult:
    """Batched solves with straggler compaction (counterpart of the JAX
    package's parallel/batched.py:229-406).

    The masked batched solver runs every attempt at full width until the
    slowest element terminates. This variant runs a full-width phase 1,
    gathers the unfinished minority (state and problem_data), finishes only
    those, scatters them back, and runs a last full-width pass as the safety
    net: a no-op when the capacity held, a full finish when it did not.
    Every element takes the decisions batched_optimize gives it.

      phase1_attempts: None runs phase 1 adaptively, one attempt at a time
        until the live count fits compact_capacity; an integer pins its
        length.
      compact_capacity: how many stragglers the compact pass takes; None
        means max(batch // 16, 1). Any value gives the same results; it
        only moves work between the phases.

    The JAX package gathers into a buffer of exactly compact_capacity
    elements, padded with duplicates of element 0, because a jitted program
    needs static shapes; eager PyTorch gathers exactly the live elements (at
    most compact_capacity of them) and needs no fill. When kernel K1 takes
    the batch (a named instance or a generated functor), compaction is moot
    and the kernel runs it, as in batched_optimize. Under a mesh the
    adaptive phase 1 stops on the live count of the whole batch (one
    all_reduce a wavefront, the JAX package's global while_loop
    predicate), compact_capacity defaults to the global batch // 16, and
    each rank compacts its own stragglers (the JAX package gathers them
    into a buffer sharded over the same axis). The other arguments are
    batched_optimize's.
    """
    with span("dogleg.call"):
        pr = _prepare(products_fn, p0_batch, parameters, mesh, axis_name,
                      problem_data, newton_solver, layout, record_history,
                      use_megakernel)
        if pr.kernel is not None:
            r = pr.kernel()
            return r if mesh is None else sharded_like(r, mesh, axis_name)
        prm, newton_solver = pr.prm, pr.newton_solver
        batched_of = pr.batched_of
        cap = compact_capacity or max(pr.global_batch // 16, 1)
        full = batched_of()

        def advance(st, k):
            return run_batched_solver(full, st, prm,
                                      newton_solver=newton_solver,
                                      max_new_attempts=k)

        st = init_batched_state(full, pr.p0, prm,
                                record_history=record_history,
                                history_capacity=history_capacity)
        if phase1_attempts is not None:
            st = advance(st, phase1_attempts)
        else:
            # the live count of the whole batch: one all_reduce a wavefront
            # under a mesh, so that every rank runs the same attempts here
            while _global_count((~st.done).sum(), mesh, axis_name) > cap:
                st = advance(st, 1)
        idx = torch.nonzero(~st.done)[:cap, 0]
        if idx.numel():
            # every field of the state, trees, SchurJtJ and History included,
            # gathered on its leading axis and scattered back
            sub = run_batched_solver(
                batched_of(idx), tv.tree_map(lambda a: a[idx], st), prm,
                newton_solver=newton_solver)
            st = tv.tree_map(lambda a, part: a.index_copy(0, idx, part), st,
                             sub)
        r = result_from_batched_state(advance(st, None))
        return r if mesh is None else sharded_like(r, mesh, axis_name)
