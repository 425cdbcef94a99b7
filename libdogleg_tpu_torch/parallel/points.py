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

init_solver_state, run_solver and solve_products take the sharding from
their start or state: a DTensor leaf with Shard(0) over one mesh axis
marks a point leaf (point_shards). The solve runs on the ranks' local
tensors, with a PointShards handed to the tree reductions
(ops/treevec.py) and to the Schur strategies (ops/newton.py), and the
state comes back as DTensors (PointShards.wrap): the point leaves of every
tree, the structured JtJ's point blocks (SchurJtJ.W on its axis 1, its
point axis; V, and SparseWSchurJtJ's Wv and cam_of, on axis 0) sharded,
U, every scalar and the History replicated, the Python flags and counters
as they are. Such a state is what the distributed checkpoint saves shard
by shard (checkpoint.save_state_orbax) and a later segment resumes, as
the JAX package's state under GSPMD.

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
from libdogleg_tpu_torch.ops.newton import SchurJtJ, SparseWSchurJtJ
from libdogleg_tpu_torch.parallel.mesh import axis_rank, axis_size
from libdogleg_tpu_torch.parallel.sharded import all_reduce_sum

# the point axis of each structured JtJ's point-major fields; its other
# fields (U) are replicated
_JTJ_POINT_AXES = {SchurJtJ: {"W": 1, "V": 0},
                   SparseWSchurJtJ: {"Wv": 0, "cam_of": 0, "V": 0}}


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
        """A tree of local leaves (a start, a gradient, a JtJ, a
        SolverState) as DTensors: a dict's point leaves (its keys in
        self.keys) sharded over the axis on their leading axis, a
        structured JtJ's point blocks on their point axis
        (_JTJ_POINT_AXES), every other tensor replicated (a state's
        scalars, U, the History); Python values and None as they are."""
        from libdogleg_tpu_torch.parallel.batched import _from_local
        if isinstance(tree, torch.Tensor):
            return replicate(tree, self.mesh)
        if isinstance(tree, dict):
            return {k: (_from_local(v, self.mesh, self.axis_name)
                        if k in self.keys else self.wrap(v))
                    for k, v in tree.items()}
        if not hasattr(tree, "_fields"):
            return tree
        axes = _JTJ_POINT_AXES.get(type(tree), {})
        return type(tree)(*(
            _from_local(v, self.mesh, self.axis_name, axes[f]) if f in axes
            else self.wrap(v) for f, v in zip(tree._fields, tree)))


def replicate(t: torch.Tensor, mesh):
    """t, held the same on every rank, as a DTensor replicated over every
    axis of the mesh (the JAX package's NamedSharding(mesh, P()))."""
    from torch.distributed.tensor import DTensor, Replicate
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def _point_axis(t, dim: int = 0) -> Optional[str]:
    """The mesh axis a DTensor is sharded over on its axis `dim` (its
    point axis; the others replicated), or None where it is replicated
    over all of them; any other placement raises."""
    from torch.distributed.tensor import Replicate, Shard
    names = t.device_mesh.mesh_dim_names
    sharded = [n for n, pl in zip(names, t.placements) if pl != Replicate()]
    if not sharded:
        return None
    if (len(sharded) > 1
            or t.placements[names.index(sharded[0])] != Shard(dim)):
        raise ValueError(f"a point-sharded state leaf is sharded on its "
                         f"point axis ({dim}) over one mesh axis; got "
                         f"{tuple(t.placements)} over {names}")
    return sharded[0]


def point_shards(tree) -> Tuple[Optional[PointShards], object]:
    """(the PointShards of a start or a state, its local leaves): the
    inverse of PointShards.wrap. A start is a dict of tensors such as
    BAProblem.shard_p_tree's {"c", "q"}; a state a SolverState or a
    structured JtJ whose dicts and JtJ are so. Its DTensor leaves are
    sharded over one mesh axis on their point axis (the leading one, axis
    1 for a SchurJtJ's W) or replicated; the keys of the dicts' sharded
    leaves are the point keys. A tree of plain tensors gives (None, tree);
    anything else raises."""
    from torch.distributed.tensor import DTensor
    if isinstance(tree, torch.Tensor) and not isinstance(tree, DTensor):
        return None, tree
    start = isinstance(tree, dict) and all(isinstance(v, torch.Tensor)
                                           for v in tree.values())
    if not (start or hasattr(tree, "_fields")):
        raise ValueError("a point-sharded start is a dict of tensors, such "
                         "as BAProblem.shard_p_tree's {'c', 'q'}, or a "
                         "solver state or JtJ holding them")
    seen = []       # (mesh, axis name or None, the leaf's dict key)

    def local(t, key=None, dim=0):
        if isinstance(t, DTensor):
            seen.append((t.device_mesh, _point_axis(t, dim), key))
            return t.to_local()
        if isinstance(t, dict):
            return {k: local(v, k) for k, v in t.items()}
        if hasattr(t, "_fields"):
            axes = _JTJ_POINT_AXES.get(type(t), {})
            return type(t)(*(local(v, None, axes.get(f, 0))
                             for f, v in zip(t._fields, t)))
        return t
    out = local(tree)
    if not seen:
        return None, tree
    meshes = {id(m) for m, _, _ in seen}
    names = {a for _, a, _ in seen if a is not None}
    if len(meshes) > 1 or len(names) != 1:
        raise ValueError(f"a point-sharded start has its point leaves over "
                         f"one axis of one mesh; got axes "
                         f"{[(k, a) for _, a, k in seen]}")
    return (PointShards(seen[0][0], names.pop(),
                        [k for _, a, k in seen
                         if a is not None and k is not None]),
            out)


def sharded_factor(ns, JtJ, lam):
    """ns.factor(JtJ, lam) of a point-sharded JtJ (DTensor fields, as a
    point-sharded state holds it): the Schur strategy with this sharding
    on the rank's blocks, its point-block factors Lv sharded as V, the
    reduced system's factor Ls and ok replicated."""
    import dataclasses
    shards, JtJ = point_shards(JtJ)
    (Lv, Ls), ok = dataclasses.replace(ns, shards=shards).factor(
        JtJ, local_of(lam))
    from libdogleg_tpu_torch.parallel.batched import _from_local
    return ((_from_local(Lv, shards.mesh, shards.axis_name),
             replicate(Ls, shards.mesh)), replicate(ok, shards.mesh))


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
