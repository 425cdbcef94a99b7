"""Carrying parameters, data and results across the package boundary.

What crosses between the JAX package and this one are the solver
parameters, the measurements, the start points and model instances; both
sides speak numpy at the boundary. Nothing here imports jax: a JAX
DoglegParameters or GridMRF is read by field name.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np
import torch

from libdogleg_tpu_torch.device import resolve_device
from libdogleg_tpu_torch.params import DoglegParameters
from libdogleg_tpu_torch.solver import History, SolveResult

_FIELDS = tuple(f.name for f in dataclasses.fields(DoglegParameters))


def parameters_from_reference(obj_or_dict: Any) -> DoglegParameters:
    """A DoglegParameters with the field values of `obj_or_dict`: a mapping
    keyed by field name, or any object with those attributes (such as
    libdogleg_tpu.DoglegParameters). Every field must be present."""
    if isinstance(obj_or_dict, Mapping):
        values = dict(obj_or_dict)
    else:
        values = {k: getattr(obj_or_dict, k) for k in _FIELDS
                  if hasattr(obj_or_dict, k)}
    missing = [k for k in _FIELDS if k not in values]
    if missing:
        raise ValueError(f"parameters lack fields {missing}")
    return DoglegParameters(**{k: values[k] for k in _FIELDS})


def from_numpy(array, device=None, dtype=None) -> torch.Tensor:
    """A tensor holding a copy of `array` on `device` (None: the CUDA
    device, see device.resolve_device)."""
    return torch.as_tensor(np.array(array), dtype=dtype,
                           device=resolve_device(device))


def result_to_numpy(result: SolveResult) -> SolveResult:
    """The same SolveResult with every tensor (history included) copied to
    a numpy array."""
    def conv(t):
        return None if t is None else t.detach().cpu().numpy()
    history = (None if result.history is None
               else History(*(conv(t) for t in result.history)))
    return result._replace(
        **{k: conv(v) for k, v in result._asdict().items()
           if k != "history"}, history=history)


def grid_mrf_from_reference(jax_grid: Any, device=None,
                            dtype=torch.float64):
    """The port's GridMRF holding the arrays of a JAX GridMRF
    (libdogleg_tpu.models.grid_mrf), on `device` (None: the CUDA device)
    in `dtype`, so both packages solve the same instance."""
    from libdogleg_tpu_torch.models import grid_mrf
    g = jax_grid
    return grid_mrf.from_arrays(
        g.width, g.height, g.block_size, np.asarray(g.edges),
        np.asarray(g.z_prior), np.asarray(g.z_edge), g.w_prior, g.w_edge,
        np.asarray(g.p_true), None if g.mix is None else np.asarray(g.mix),
        dtype=dtype, device=device)
