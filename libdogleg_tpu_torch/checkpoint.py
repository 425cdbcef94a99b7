"""Checkpoint and resume of solver states (counterpart of
libdogleg_tpu/checkpoint.py:24-59).

A state between two segments of a run (solver.run_solver /
run_batched_solver with max_new_attempts) holds every cache of the
iteration: the Cauchy and Gauss-Newton steps, lambda, the trust region and
the History. Saved, loaded in another process and run on, it takes the
decisions of the one-shot solve.

The file is the JAX package's own .npz layout: one array per state field,
under the field's name, and `history__<field>` for each History field. The
single solve's SolverState and the JAX package's _Carry share the names, as
do both History classes, so a state saved by either package loads in this
one. A batched state is the same layout with a leading batch axis on every
array (the JAX package saves a vmapped _Carry so).

Like the JAX module, it takes flat states whose JtJ is one tensor. A tree
state or a structured JtJ (a NamedTuple such as SchurJtJ or
SparseWSchurJtJ) raises ValueError at save, naming the limitation.

save_state_orbax / load_state_orbax keep the JAX package's names for its
orbax pair, the checkpoint of states sharded over many hosts, and are
written on torch.distributed.checkpoint (dcp): each rank writes its own
shards of a batched state whose leaves are DTensors sharded on the batch
axis (parallel/batched.sharded_like; a plain tensor is written once, as
dcp writes a replicated one), and the load restores onto the shapes and
placements of a `like` state. The files are dcp's format, a directory, not
orbax's: the .npz pair above stays the format both packages read. Like
dcp, they work without a process group, in one process.
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

from libdogleg_tpu_torch.device import resolve_device
from libdogleg_tpu_torch.solver import (BatchedSolverState, History,
                                        SolverState)

# the fields the single solve keeps as Python values, and their .npz types
_FLAGS = ("have_cauchy", "have_gn", "have_prev_step", "done")
_COUNTERS = ("step_count", "n_attempts", "reason")
# carried by the batched state only with a History
_PREV = ("prev_step", "norm2_prev_step", "have_prev_step")

State = Union[SolverState, BatchedSolverState]


def _host(name: str, value) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    if name in _FLAGS:
        return np.asarray(value, dtype=np.bool_)
    if name in _COUNTERS:
        return np.asarray(value, dtype=np.int32)
    raise ValueError(
        f"checkpoint: state field {name!r} is a "
        f"{type(value).__name__}; only flat states (tensor p and Jt_x) "
        f"with a dense JtJ tensor are saved, as in the JAX package: tree "
        f"states and structured JtJ (SchurJtJ, SparseWSchurJtJ) are not")


def _flatten(state: State) -> dict:
    fields = state._asdict()
    if (isinstance(state, BatchedSolverState) and state.history is None
            and isinstance(state.p, torch.Tensor)):
        # the JAX layout always has the accepted step into the current
        # point; a batch without History does not carry it: zeros
        B = state.norm2_x.shape[0]
        fields.update(prev_step=torch.zeros_like(state.p),
                      norm2_prev_step=torch.zeros_like(state.norm2_x),
                      have_prev_step=torch.zeros(B, dtype=torch.bool))
    out = {}
    for name, value in fields.items():
        if name == "history":
            if value is not None:
                for hname, hval in value._asdict().items():
                    out[f"history__{hname}"] = _host(hname, hval)
            continue
        out[name] = _host(name, value)
    return out


def save_state(path: str, state: State) -> None:
    """Write a SolverState or a BatchedSolverState to an .npz file in the
    JAX package's layout."""
    np.savez(path, **_flatten(state))


def load_state(path: str, device=None) -> State:
    """Load a state saved by save_state, or by the JAX package's
    save_state, onto `device` (None: the CUDA device). A 0-d `done` gives a
    SolverState, its flags and counters as Python bool and int; a leading
    axis gives a BatchedSolverState, which carries prev_step,
    norm2_prev_step and have_prev_step only with a History."""
    dev = resolve_device(device)
    with np.load(path) as data:
        arrays = {k: data[k] for k in data.files}
    hist = {k[len("history__"):]: torch.as_tensor(v, device=dev)
            for k, v in arrays.items() if k.startswith("history__")}
    history = History(**hist) if hist else None
    fields = {k: v for k, v in arrays.items()
              if not k.startswith("history__")}
    if fields["done"].ndim == 0:
        state = {k: (bool(v) if k in _FLAGS else int(v) if k in _COUNTERS
                     else torch.as_tensor(v, device=dev))
                 for k, v in fields.items()}
        return SolverState(history=history, **state)
    state = {k: torch.as_tensor(v, device=dev) for k, v in fields.items()
             if history is not None or k not in _PREV}
    return BatchedSolverState(history=history, **state)


def _dcp_state_dict(state: State) -> dict:
    """The state's fields as dcp's flat state dict: tensors (DTensors
    included) by field name, `history__<field>` for the History, the
    single solve's Python flags and counters as 0-d tensors; absent
    fields (None) left out."""
    out = {}
    for name, value in state._asdict().items():
        if name == "history":
            if value is not None:
                for hname, hval in value._asdict().items():
                    out[f"history__{hname}"] = hval
        elif isinstance(value, torch.Tensor):
            out[name] = value
        elif value is not None:
            out[name] = torch.as_tensor(_host(name, value))
    return out


def save_state_orbax(path: str, state: State) -> None:
    """Write a SolverState or a BatchedSolverState with
    torch.distributed.checkpoint into the directory `path`. With a process
    group every rank calls it, and a state whose leaves are DTensors
    (sharded on the batch axis) is written shard by shard, each rank its
    own. dcp's format, not orbax's (module docstring)."""
    import torch.distributed.checkpoint as dcp
    dcp.save(_dcp_state_dict(state), checkpoint_id=path)


def _empty_like(t: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import DTensor
    if isinstance(t, DTensor):
        return DTensor.from_local(torch.empty_like(t.to_local()),
                                  t.device_mesh, t.placements,
                                  run_check=False, shape=t.shape,
                                  stride=t.stride())
    return torch.empty_like(t)


def load_state_orbax(path: str, like: State) -> State:
    """Restore a state saved by save_state_orbax onto the structure, shapes,
    dtypes, devices and placements of `like` (for example the live state,
    or a fresh init_batched_state's of the same shapes on the same mesh):
    each rank reads the shards its DTensors hold. Returns a new state of
    like's type; the single solve's flags and counters come back as Python
    values."""
    import torch.distributed.checkpoint as dcp
    sd = {k: _empty_like(v) for k, v in _dcp_state_dict(like).items()}
    dcp.load(sd, checkpoint_id=path)
    fields = {}
    for name, value in like._asdict().items():
        if name == "history":
            fields[name] = None if value is None else type(value)(**{
                h: sd[f"history__{h}"] for h in value._fields})
        elif isinstance(value, torch.Tensor):
            fields[name] = sd[name]
        elif value is None:
            fields[name] = None
        else:
            t = sd[name]
            fields[name] = bool(t) if name in _FLAGS else int(t)
    return type(like)(**fields)
