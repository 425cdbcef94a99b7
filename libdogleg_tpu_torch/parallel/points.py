"""Point-axis sharding of tree states (the port's counterpart of what GSPMD
does for the JAX package's BAProblem.shard / shard_p_tree).

In bundle adjustment the point count, not the camera count, outgrows one
device. A state {"c": cameras, "q": points} is then held with its point
leaf sharded on its leading axis over a mesh axis ("pts") and its camera
leaf replicated; the problem's point data (the per-point rows of A, B and
obs, or of cam_of, obs, pts_prior and obs_mask) is sharded the same way.
Each rank holds only its block of points: its rows of the residual, its
gradient rows, its point blocks V and its coupling blocks W or Wv. The
camera system (its gradient, U, the Schur complement S) is replicated, and
every sum over points is a local partial sum plus one explicit all_reduce
on the axis's group (parallel/sharded.all_reduce_sum), where JAX lets GSPMD
insert the collective.

solve_products takes the sharding from its start: a DTensor leaf with
Shard(0) over one mesh axis marks a point leaf (point_shards). The solve
runs on the ranks' local tensors, with a PointShards handed to the tree
reductions (ops/treevec.py) and to the Schur strategies (ops/newton.py);
the result's state and gradient come back as DTensors (PointShards.wrap).

Replicated decisions (hazard F16): every value a rank takes bool() of is
replicated or the output of an all_reduce, which gives every rank the same
bits. With one rank every all_reduce is an identity and every reduction
below keeps the unsharded order of operations, so a world of one gives the
unsharded solve's bits.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from libdogleg_tpu_torch.ops import compensated as comp
from libdogleg_tpu_torch.parallel.mesh import axis_rank, axis_size
from libdogleg_tpu_torch.parallel.sharded import all_reduce_sum


class PointShards:
    """Where a tree state's point leaves live: the top-level keys whose
    leaves are sharded on their leading axis over mesh axis `axis_name`;
    every other leaf is replicated over it."""

    def __init__(self, mesh, axis_name: str, keys):
        self.mesh = mesh
        self.axis_name = axis_name
        self.keys = frozenset(keys)

    @property
    def first(self) -> bool:
        """Whether this rank is the axis's first: a replicated term that
        an unsharded sum takes before its point terms enters there only."""
        return axis_rank(self.mesh, self.axis_name) == 0

    def sum(self, tensors) -> List[torch.Tensor]:
        """Local partial sums (one dtype and device) summed over the axis,
        in one all_reduce."""
        return all_reduce_sum(tensors, self.mesh, self.axis_name)

    def sum_pair(self, hi: torch.Tensor,
                 lo: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """A compensated pair's partial sums over the axis, still a
        compensated pair: each rank writes its pair into its own slot of
        a zeroed buffer, so the one all_reduce adds only zeros to it and
        hands every rank every pair exactly; the pairs are then added in
        rank order with the error-free sum (ops/compensated.py)."""
        k = axis_size(self.mesh, self.axis_name)
        buf = hi.new_zeros((k, 2) + tuple(hi.shape))
        r = axis_rank(self.mesh, self.axis_name)
        buf[r, 0] = hi
        buf[r, 1] = lo
        (buf,) = self.sum([buf])
        h, l = buf[0, 0], buf[0, 1]
        for i in range(1, k):
            h, l = comp.pair_add(h, l, buf[i, 0], buf[i, 1])
        return h, l

    def wrap(self, tree):
        """A tree of local leaves (a state, a gradient) as DTensors: the
        point leaves sharded over the axis, the others replicated."""
        from libdogleg_tpu_torch.parallel.batched import _from_local
        return {k: (_from_local(v, self.mesh, self.axis_name)
                    if k in self.keys else replicate(v, self.mesh))
                for k, v in tree.items()}


def replicate(t: torch.Tensor, mesh):
    """t, held the same on every rank, as a DTensor replicated over every
    axis of the mesh (the JAX package's NamedSharding(mesh, P()))."""
    from torch.distributed.tensor import DTensor, Replicate
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def _point_axis(t) -> Optional[str]:
    """The mesh axis a DTensor is sharded over on its leading axis (the
    others replicated), or None where it is replicated over all of them;
    any other placement raises."""
    from torch.distributed.tensor import Replicate, Shard
    names = t.device_mesh.mesh_dim_names
    sharded = [n for n, pl in zip(names, t.placements) if pl != Replicate()]
    if not sharded:
        return None
    if len(sharded) > 1 or t.placements[names.index(sharded[0])] != Shard(0):
        raise ValueError(f"a point-sharded state leaf is sharded on its "
                         f"leading axis over one mesh axis; got "
                         f"{tuple(t.placements)} over {names}")
    return sharded[0]


def point_shards(p0) -> Tuple[Optional[PointShards], object]:
    """(the PointShards of a start, the start's local leaves). A start whose
    leaves are all plain tensors gives (None, p0). A dict whose DTensor
    leaves are sharded on their leading axis over one mesh axis, or
    replicated, gives the keys of the sharded ones; anything else
    raises."""
    from torch.distributed.tensor import DTensor
    if isinstance(p0, torch.Tensor) and not isinstance(p0, DTensor):
        return None, p0
    if not (isinstance(p0, dict) and all(isinstance(v, torch.Tensor)
                                         for v in p0.values())):
        raise ValueError("a point-sharded start is a dict of tensors, such "
                         "as BAProblem.shard_p_tree's {'c', 'q'}")
    dts = {k: v for k, v in p0.items() if isinstance(v, DTensor)}
    if not dts:
        return None, p0
    meshes = {id(v.device_mesh) for v in dts.values()}
    axes = {k: _point_axis(v) for k, v in dts.items()}
    names = {a for a in axes.values() if a is not None}
    if len(meshes) > 1 or len(names) != 1:
        raise ValueError(f"a point-sharded start has its point leaves over "
                         f"one axis of one mesh; got axes {axes}")
    mesh = next(iter(dts.values())).device_mesh
    local = {k: v.to_local() if isinstance(v, DTensor) else v
             for k, v in p0.items()}
    return (PointShards(mesh, names.pop(),
                        [k for k, a in axes.items() if a is not None]),
            local)


def local_of(t):
    """A DTensor's local tensor; any other tensor as it is."""
    from torch.distributed.tensor import DTensor
    return t.to_local() if isinstance(t, DTensor) else t


def sharding_of(*tensors) -> Optional[Tuple[object, str]]:
    """(mesh, axis name) of the first DTensor among `tensors` sharded on its
    leading axis (a point-sharded problem's data), or None where none
    is."""
    from torch.distributed.tensor import DTensor
    for t in tensors:
        if isinstance(t, DTensor):
            axis = _point_axis(t)
            if axis is not None:
                return t.device_mesh, axis
    return None
