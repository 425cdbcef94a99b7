"""Carrying parameters, data and results across the package boundary.

What crosses between the JAX package and this one are the solver
parameters, the measurements, the start points (tensors or {"c", "q"}
trees) and model instances; both sides speak numpy at the boundary. Nothing
here imports jax: a JAX DoglegParameters, GridMRF, BAProblem or pinhole
instance is read by field name.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np
import torch

from libdogleg_tpu_torch.device import resolve_device
from libdogleg_tpu_torch.params import DoglegParameters
from libdogleg_tpu_torch.solver import SolveResult

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


def tree_from_numpy(tree, device=None, dtype=None):
    """from_numpy leaf by leaf over a dict, tuple or list of arrays, such as
    a {"c", "q"} start of the bundle-adjustment models."""
    if isinstance(tree, Mapping):
        return {k: tree_from_numpy(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_from_numpy(v, device, dtype) for v in tree)
    return from_numpy(tree, device, dtype)


def _to_numpy(t):
    if t is None:
        return None
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    if isinstance(t, Mapping):
        return {k: _to_numpy(v) for k, v in t.items()}
    if hasattr(t, "_fields"):
        return type(t)(*(_to_numpy(v) for v in t))
    return type(t)(_to_numpy(v) for v in t)


def result_to_numpy(result: SolveResult) -> SolveResult:
    """The same SolveResult with every tensor (history included, and every
    leaf of a tree state or a structured JtJ) copied to a numpy array."""
    return result._replace(**{k: _to_numpy(v)
                              for k, v in result._asdict().items()})


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


def grid_mrf_batch_from_reference(jax_grids, device=None,
                                  dtype=torch.float64):
    """A batch of JAX GridMRF instances that share one graph (the same
    width, height, block size, edges and weights; element s made with its
    own seed, say): the port's GridMRF of the first, and each element's
    (z_prior (B, n_nodes, b), z_edge (B, n_edges, b), mix (B, n_edges, b,
    b) or None) stacked on a leading batch axis, on `device` (None: the
    CUDA device) in `dtype`, as the problem_data of a batched solve."""
    grids = list(jax_grids)
    g0 = grids[0]
    for g in grids[1:]:
        same = ((g.width, g.height, g.block_size, g.w_prior, g.w_edge)
                == (g0.width, g0.height, g0.block_size, g0.w_prior,
                    g0.w_edge)
                and np.array_equal(np.asarray(g.edges), np.asarray(g0.edges))
                and (g.mix is None) == (g0.mix is None))
        if not same:
            raise ValueError("the instances of a batch must share their "
                             "graph, block size, weights and coupling")

    def stacked(name):
        return from_numpy(np.stack([np.asarray(getattr(g, name))
                                    for g in grids]), device, dtype)
    data = (stacked("z_prior"), stacked("z_edge"),
            None if g0.mix is None else stacked("mix"))
    return grid_mrf_from_reference(g0, device, dtype), data


def bundle_adjustment_from_reference(jax_ba: Any, device=None,
                                     dtype=torch.float64):
    """The port's BAProblem holding the arrays of a JAX BAProblem
    (libdogleg_tpu.models.bundle_adjustment), on `device` (None: the CUDA
    device) in `dtype`."""
    from libdogleg_tpu_torch.models import bundle_adjustment
    return bundle_adjustment.BAProblem(
        A=from_numpy(jax_ba.A, device, dtype),
        B=from_numpy(jax_ba.B, device, dtype),
        obs=from_numpy(jax_ba.obs, device, dtype),
        p_true=from_numpy(jax_ba.p_true, device, dtype), nc=int(jax_ba.nc),
        n_points=int(jax_ba.n_points), block_size=int(jax_ba.block_size))


def pinhole_ba_from_reference(jax_ba: Any, device=None, dtype=torch.float64):
    """The port's PinholeBA or SparseVisibilityPinholeBA holding the arrays
    of the JAX instance of the same name (libdogleg_tpu.models.pinhole_ba),
    on `device` (None: the CUDA device) in `dtype`; index arrays become
    int64."""
    from libdogleg_tpu_torch.models import pinhole_ba
    b = jax_ba
    common = dict(
        ncam=int(b.ncam), npts=int(b.npts), focal=float(b.focal),
        obs=from_numpy(b.obs, device, dtype),
        w_prior_cam0=float(b.w_prior_cam0), w_prior_pts=float(b.w_prior_pts),
        cam0_prior=from_numpy(b.cam0_prior, device, dtype),
        pts_prior=from_numpy(b.pts_prior, device, dtype),
        p_true=tree_from_numpy(dict(b.p_true), device, dtype))
    if hasattr(b, "cam_of"):
        return pinhole_ba.SparseVisibilityPinholeBA(
            k_obs=int(b.k_obs),
            cam_of=from_numpy(b.cam_of, device, torch.int64),
            obs_mask=(None if b.obs_mask is None
                      else from_numpy(b.obs_mask, device, dtype)),
            **common)
    return pinhole_ba.PinholeBA(
        cam_idx=from_numpy(b.cam_idx, device, torch.int64),
        pt_idx=from_numpy(b.pt_idx, device, torch.int64), **common)
