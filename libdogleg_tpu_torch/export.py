"""Ahead-of-time export: solver artifacts for serving (counterpart of
libdogleg_tpu/export.py, on torch.export).

The reference ships a C shared library: deploying it means linking
libdogleg.so and calling into it. Here the whole dog-leg solve is captured
ONCE as a torch.export program, saved to bytes, and served by another
process that loads it and calls it, without the problem's source:

    exp = export_solver(products, nstate=6, batch_size=8192)
    save_exported("solver.pt2", exp)
    # serving process (imports libdogleg_tpu_torch.export, nothing else of
    # the problem):
    solve = load_exported("solver.pt2")
    result = solve.call(p0_batch)        # a full SolveResult

What the solve closes over (measurement data, BCSR patterns and K3's pair
schedule, the sparse Cholesky's symbolic schedules) is baked into the
program as constants on the export's device. The solve loop is a traced
while_loop (solver.run_batched_solver_traced): the masked wavefront loop,
with the Gauss-Newton step a cond and lambda's escalation a nested
while_loop, so that no value is read on the host. The single solve is that
loop over a batch of one. The hand-written kernels the solve reaches (K3,
K5, K6, K7, and the sparse path's segment add, ops/segsum.py) are
operators of the program (libdogleg_tpu_torch::*), which
launch the CUDA kernels when it runs; this module registers them and the
result types, so a process that loads an artifact imports it first.

The artifact is a graph run op by op by PyTorch, not compiled code: it
needs a torch that loads it, libdogleg_tpu_torch importable for its
operators, and, when exported for CUDA, a card (it raises without one).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils import _pytree as pytree

from libdogleg_tpu_torch.device import resolve_device
# the kernels' operators, which an artifact's graph calls
from libdogleg_tpu_torch.ops import (batchchol, bcsr_kernels,  # noqa: F401
                                     segsum, tilechol)
from libdogleg_tpu_torch.ops import treevec as tv
from libdogleg_tpu_torch.ops.traced import materialized
from libdogleg_tpu_torch.ops.newton import SchurJtJ, SparseWSchurJtJ
from libdogleg_tpu_torch.params import DoglegParameters
from libdogleg_tpu_torch.solver import (History, SolveResult,
                                        init_batched_state,
                                        result_from_batched_state,
                                        run_batched_solver_traced)

# The result types, under stable names that are part of the artifact format
# (the JAX package's register_namedtuple_serialization, export.py:37-48).
for _cls in (SolveResult, History, SchurJtJ, SparseWSchurJtJ):
    pytree._register_namedtuple(
        _cls, serialized_type_name=f"libdogleg_tpu_torch.{_cls.__name__}")


def _state_shapes(nstate, batch_size):
    """The start's shape, or a dict of leaf shapes for a tree state, with
    the batch axis where there is a batch."""
    lead = (batch_size,) if batch_size else ()
    if isinstance(nstate, dict):
        return {k: lead + tuple(v) for k, v in nstate.items()}
    return lead + (int(nstate),)


def flatten_products(products_fn, p_batch, batched: bool = True):
    """The products of a batch as a plain aten graph, recorded by make_fx on
    the real start p_batch (leading batch axis): torch.func.vmap of
    products_fn, or for a single solve (batched=False, a batch of one)
    products_fn of the one start with a unit axis added to every output.
    Any vmap or jacfwd is written out, closed-over tensors are held as
    constants (an efficient zero tensor as real zeros, which a loop can
    carry) and K3 is its operator node. Python control flow of
    products_fn that depends on p's values is fixed at p_batch's values,
    as JAX's trace fixes it."""
    from torch.fx.experimental.proxy_tensor import make_fx
    if batched:
        fn = torch.func.vmap(products_fn)
    else:
        def fn(pb):
            return tv.tree_map(lambda t: t[None], products_fn(
                tv.tree_map(lambda t: t[0], pb)))
    gm = make_fx(lambda p: tv.tree_map(materialized, fn(p)),
                 tracing_mode="real")(p_batch)
    for node in gm.graph.nodes:
        if node.op == "get_attr":
            setattr(gm, node.target, materialized(getattr(gm, node.target)))
    return gm


def solve_traced(products_batched, p0, parameters: DoglegParameters, *,
                 newton_solver=None, batched: bool = True,
                 outputs: str = "full"):
    """The program an artifact holds, as a function: the traced solve of
    p0 ((B, ...) leaves, or one problem's start if not `batched`) with
    products_batched taking a batch (flatten_products). Run eagerly it
    gives the artifact's result."""
    pb = p0 if batched else tv.tree_map(lambda t: t[None], p0)
    state = init_batched_state(products_batched, pb, parameters)
    r = result_from_batched_state(run_batched_solver_traced(
        products_batched, state, parameters, newton_solver=newton_solver))
    if not batched:
        r = r._replace(**{f: tv.tree_map(lambda t: t[0], getattr(r, f))
                          for f in r._fields if getattr(r, f) is not None})
    return r.p if outputs == "p" else r


class _Solve(torch.nn.Module):
    def __init__(self, products_batched, prm, newton_solver, batched,
                 outputs):
        super().__init__()
        # a closure, not a submodule: its tensors are constants, not state
        self._run = lambda p0: solve_traced(
            products_batched, p0, prm, newton_solver=newton_solver,
            batched=batched, outputs=outputs)

    def forward(self, p0):
        return self._run(p0)


def export_solver(products_fn,
                  nstate,
                  parameters: Optional[DoglegParameters] = None,
                  *,
                  batch_size: Optional[int] = None,
                  dtype=torch.float32,
                  newton_solver=None,
                  device=None,
                  outputs: str = "full"):
    """Trace the dog-leg solve into a torch.export program for serving.

    Args:
      products_fn: p -> Products for ONE problem (its data closed over and
        baked into the program as constants).
      nstate: the state size, or for a tree state a dict of leaf shapes
        such as {"c": (nc,), "q": (n_points, 3)}.
      parameters: solver parameters, frozen into the program.
      batch_size: if given, export the batched solve over (batch_size,
        nstate) starts that share the problem; otherwise a single (nstate,)
        solve.
      dtype: the start's dtype (float32 for serving, float64 for parity).
      newton_solver: optional strategy (BlockedDenseNewtonSolver for
        mid-size batches, a problem's SparseNewtonSolver), frozen in.
      device: where the program's constants live and it runs; None means
        the CUDA device (JAX's `platforms=` names a backend to lower for;
        here the device is the trace's). Pass "cpu" to export for the CPU.
      outputs: "full" returns the SolveResult, "p" only the solution.

    The products are flattened on a start of zeros (flatten_products):
    Python branches of products_fn on p's values are fixed there.

    Returns a torch.export.ExportedProgram; save it with save_exported.
    """
    if outputs not in ("full", "p"):
        raise ValueError(f"outputs must be 'full' or 'p', got {outputs!r}")
    dev = resolve_device(device)
    prm = parameters if parameters is not None else DoglegParameters()
    p0 = pytree.tree_map(lambda s: torch.zeros(s, dtype=dtype, device=dev),
                         _state_shapes(nstate, batch_size),
                         is_leaf=lambda s: isinstance(s, tuple))
    batched = bool(batch_size)
    pb = p0 if batched else tv.tree_map(lambda t: t[None], p0)
    products_batched = flatten_products(products_fn, pb, batched)
    module = _Solve(products_batched, prm, newton_solver, batched, outputs)
    # the nodes' Python stack traces are for debugging, and a quarter of the
    # trace's time
    fx_config = torch.fx.config
    keep = getattr(fx_config, "do_not_emit_stack_traces", None)
    fx_config.do_not_emit_stack_traces = True
    try:
        return torch.export.export(module, (p0,))
    finally:
        fx_config.do_not_emit_stack_traces = keep


def save_exported(path: str, exported) -> None:
    """Write the program (torch.export's archive format)."""
    torch.export.save(exported, path)


class LoadedSolver:
    """A loaded artifact: `.call(p0)` runs it, `.program` is the
    torch.export.ExportedProgram."""

    def __init__(self, program):
        self.program = program
        self._module = program.module()

    def call(self, p0):
        return self._module(p0)


def load_exported(path: str) -> LoadedSolver:
    """Load an artifact saved by save_exported. One exported for CUDA
    raises where there is no CUDA device: it has no fallback."""
    try:
        program = torch.export.load(path)
    except Exception as e:
        if torch.cuda.is_available():
            raise
        raise RuntimeError(f"{path} did not load, and there is no CUDA "
                           f"device (was it exported for CUDA?)") from e
    tensors = list(program.state_dict.values()) + list(
        program.constants.values())
    if not torch.cuda.is_available() and any(
            isinstance(t, torch.Tensor) and t.device.type == "cuda"
            for t in tensors):
        raise RuntimeError(f"{path} was exported for CUDA and there is no "
                           f"CUDA device")
    return LoadedSolver(program)
