"""Device meshes on torch.distributed (counterpart of
libdogleg_tpu/parallel/mesh.py).

The JAX package names a mesh of devices (jax.sharding.Mesh) and lets XLA
insert the collectives. Here the program is SPMD, one process a device
(torchrun starts it, or torch.multiprocessing in the tests): a mesh is a
torch.distributed DeviceMesh over the ranks of the process group, its named
axes the mesh dimensions, and `psum` over an axis is an all_reduce on
`mesh.get_group(axis_name)`.

Every process group made here has a 60 s timeout, so that a collective
that one rank never joins ends in an error, not a hang.
"""

from __future__ import annotations

import datetime
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.utils import _pytree as pytree

# a collective that waits longer has lost a rank
TIMEOUT = datetime.timedelta(seconds=60)


def make_mesh(axis_names: Sequence[str],
              shape: Optional[Sequence[int]] = None,
              devices=None, *, device_type: str = "cuda") -> DeviceMesh:
    """A named mesh over the ranks of the process group.

    With no shape, every rank goes on the first axis. devices= takes a list
    of ranks (default: all of them, in order); a shape that needs more
    ranks than there are raises, with the JAX package's message. Without an
    initialized process group the world is this one process (NCCL for
    "cuda", gloo for "cpu", through an in-process store: no address, no
    port); with one (torchrun, or two ranks sharing one card over gloo)
    the mesh is built on it. Every rank of the group calls make_mesh with
    the same arguments. device_type "cuda" (the default) needs a card; the
    CPU tests pass "cpu"."""
    axis_names = tuple(axis_names)
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_mesh(device_type='cuda') needs a CUDA "
                           "device; pass device_type='cpu' for the CPU")
    if not dist.is_initialized():
        dist.init_process_group(
            "nccl" if device_type == "cuda" else "gloo",
            store=dist.HashStore(), rank=0, world_size=1, timeout=TIMEOUT)
    world = dist.get_world_size()
    ranks = list(range(world)) if devices is None else [int(r) for r in
                                                        devices]
    if shape is None:
        shape = (len(ranks),) + (1,) * (len(axis_names) - 1)
    shape = tuple(int(s) for s in shape)
    n = int(np.prod(shape))
    if n > len(ranks):
        raise ValueError(f"mesh shape {shape} needs {n} devices, "
                         f"have {len(ranks)}")
    if ranks[:n] == list(range(world)):
        return init_device_mesh(device_type, shape,
                                mesh_dim_names=axis_names)
    return DeviceMesh(device_type, torch.tensor(ranks[:n]).reshape(shape),
                      mesh_dim_names=axis_names)


def axis_size(mesh: DeviceMesh, axis_name: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis_name))


def axis_rank(mesh: DeviceMesh, axis_name: str) -> int:
    """This rank's coordinate along the axis."""
    return mesh.get_local_rank(axis_name)


def local_rows(a, mesh: DeviceMesh, axis_name: str, dim: int = 0):
    """This rank's block of `a` along `dim` over the mesh axis: a DTensor
    sharded there gives its local tensor; a whole tensor, held the same on
    every rank, its contiguous block (the JAX package's in_shardings). An
    axis the ranks do not divide raises."""
    # torch.distributed.tensor takes a second to import: only when used
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if isinstance(a, DTensor):
        names = a.device_mesh.mesh_dim_names
        want = [Shard(dim) if n == axis_name else Replicate() for n in names]
        if list(a.placements) != want:
            raise ValueError(f"a DTensor sharded as {a.placements} over "
                             f"{names}; expected {tuple(want)}")
        return a.to_local()
    k = axis_size(mesh, axis_name)
    m = a.shape[dim]
    if m % k:
        raise ValueError(f"an axis of {m} does not divide over the {k} "
                         f"ranks of mesh axis {axis_name!r}")
    return a.narrow(dim, axis_rank(mesh, axis_name) * (m // k), m // k)


def local_tree(tree, mesh: DeviceMesh, axis_name: str, dim: int = 0):
    """local_rows of every tensor leaf of a tree."""
    return pytree.tree_map_only(
        torch.Tensor, lambda a: local_rows(a, mesh, axis_name, dim), tree)
