"""Synthetic bundle-adjustment-style model family: arrow-structured systems
(counterpart of libdogleg_tpu/models/bundle_adjustment.py).

A small dense "global" block c (cameras, intrinsics) coupled to many
independent small "point" blocks q_p, with JtJ the arrow matrix
[[U, W], [W^T, V]], V block-diagonal: the structure libdogleg's author wrote
it for (camera calibration, structure from motion; reference
README.pod:5-15). The point blocks are eliminated by Schur complement
(ops/newton.SchurNewtonSolver). The instance is linear-Gaussian: each point
is observed k_obs times through maps A_p (k_obs, bs), coupled to c through
B_p (k_obs, nc):

    r_{p,k} = A_p[k] . q_p + B_p[k] . c - obs_{p,k}

State p = [c (nc) | q (n_points * bs)] flat, or the tree
{"c": (nc,), "q": (n_points, bs)}. shard and shard_p_tree (the JAX
package's names and defaults) place the per-point data (A, B, obs) and the
state's point leaf over a mesh axis "pts", the camera leaf replicated:
each rank then evaluates its points' residuals, its gradient rows and its
point blocks, and one all_reduce an evaluation sums the camera gradient, U
and the cost; the tree Schur strategy sums its own point terms over the
same axis (parallel/points.py). solve_products(ba_s.products_tree,
ba.shard_p_tree(ba.p0_tree(), mesh), prm,
newton_solver=ba_s.tree_newton_solver()) runs it on every rank.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from libdogleg_tpu_torch.device import resolve_device
from libdogleg_tpu_torch.ops.newton import (SchurJtJ, SchurNewtonSolver,
                                            TreeSchurNewtonSolver)
from libdogleg_tpu_torch.solver import Products


class BAProblem(NamedTuple):
    A: torch.Tensor        # (n_points, k_obs, bs) point observation maps
    B: torch.Tensor        # (n_points, k_obs, nc) global coupling maps
    obs: torch.Tensor      # (n_points, k_obs) observations
    p_true: torch.Tensor   # (nstate,) generating state
    nc: int
    n_points: int
    block_size: int

    @property
    def nstate(self) -> int:
        return self.nc + self.n_points * self.block_size

    @property
    def nmeasurements(self) -> int:
        return int(self.obs.shape[0] * self.obs.shape[1])

    def split(self, p):
        return (p[:self.nc],
                p[self.nc:].reshape(self.n_points, self.block_size))

    def _local(self, c, q, obs):
        """(A, B, c, q, obs, axis) as this rank works on them: as given, or
        for a point-sharded instance (shard) the rank's rows of A, B, obs
        and q (a DTensor's local tensor, a whole obs's block) and axis the
        (mesh, axis name); None unsharded."""
        A, B = self.A, self.B
        axis = None
        if type(A) is not torch.Tensor:
            from libdogleg_tpu_torch.parallel.points import sharding_of
            axis = sharding_of(A)
        if axis is None:
            return A, B, c, q, obs, None
        from libdogleg_tpu_torch.parallel.mesh import local_rows
        from libdogleg_tpu_torch.parallel.points import local_of
        A, B, q = local_of(A), local_of(B), local_of(q)
        if q.shape[0] != A.shape[0]:
            raise ValueError(
                f"a point-sharded BAProblem takes the state's point rows "
                f"sharded as its own ({A.shape[0]} a rank; shard_p_tree), "
                f"got {q.shape[0]}")
        return A, B, local_of(c), q, local_rows(obs, *axis), axis

    @staticmethod
    def _residuals(A, B, c, q, obs):
        B2 = B.reshape(-1, c.shape[-1])
        return ((A * q[:, None, :]).sum(-1)
                + (B2 @ c).reshape(obs.shape) - obs)

    def _core(self, c, q, obs):
        """Cost, structured gradient and arrow JtJ, shared by the flat and
        tree product forms. On a point-sharded instance they are a rank's
        own rows of gq, W and V, and the cost, gc and U are summed over the
        axis in one all_reduce of 1 + nc + nc^2 values."""
        A, B, c, q, obs, axis = self._local(c, q, obs)
        r = self._residuals(A, B, c, q, obs)
        B2 = B.reshape(-1, self.nc)
        n2, gc, U = (r * r).sum(), B2.mT @ r.reshape(-1), B2.mT @ B2
        if axis is not None:
            from libdogleg_tpu_torch.parallel.sharded import all_reduce_sum
            n2, gc, U = all_reduce_sum([n2, gc, U], *axis)
        gq = (A * r[..., None]).sum(1)
        JtJ = SchurJtJ(U=U, W=(B.mT @ A).permute(1, 0, 2).contiguous(),
                       V=A.mT @ A)
        return n2, gc, gq, JtJ

    def residuals(self, p):
        return self._residuals(*self._local(*self.split(p), self.obs)[:5])

    def products(self, p) -> Products:
        """One reduction over all observations into the arrow system (the
        dense-products form, reference dogleg.h:34-45)."""
        return self.products_obs(p, self.obs)

    def products_obs(self, p, obs) -> Products:
        """products at the observations obs (n_points, k_obs) in place of
        the instance's: the form torch.func.vmap batches over per-element
        observations (batched_optimize(ba.products_obs, p0,
        problem_data=obs_b, newton_solver=ba.newton_solver()))."""
        n2, gc, gq, JtJ = self._core(*self.split(p), obs)
        return Products(norm2_x=n2, Jt_x=torch.cat([gc, gq.reshape(-1)]),
                        JtJ=JtJ)

    def newton_solver(self) -> SchurNewtonSolver:
        return SchurNewtonSolver(nc=self.nc, n_points=self.n_points,
                                 block_size=self.block_size)

    # the tree form: p = {"c": (nc,), "q": (n_points, bs)}

    def residuals_tree(self, p):
        """The residuals (n_points, k_obs); a point-sharded instance's
        rank gets its own rows."""
        return self._residuals(*self._local(p["c"], p["q"], self.obs)[:5])

    def products_tree(self, p) -> Products:
        return self.products_tree_obs(p, self.obs)

    def products_tree_obs(self, p, obs) -> Products:
        """products_tree at the observations obs, as products_obs."""
        n2, gc, gq, JtJ = self._core(p["c"], p["q"], obs)
        return Products(norm2_x=n2, Jt_x={"c": gc, "q": gq}, JtJ=JtJ)

    def tree_newton_solver(self) -> TreeSchurNewtonSolver:
        return TreeSchurNewtonSolver(nc=self.nc, n_points=self.n_points,
                                     block_size=self.block_size)

    def p0_tree(self, dtype=None):
        dtype = dtype or self.A.dtype
        dev = self.A.device
        return {"c": torch.zeros((self.nc,), dtype=dtype, device=dev),
                "q": torch.zeros((self.n_points, self.block_size),
                                 dtype=dtype, device=dev)}

    def shard(self, mesh, axis_name: str = "pts") -> "BAProblem":
        """The instance with its per-point data (A, B, obs), held whole on
        every rank, as DTensors sharded on the point axis over the mesh
        axis: each rank keeps its contiguous block of points (the JAX
        package's device_put with NamedSharding(mesh, P(axis_name))).
        Shard the start the same way (shard_p_tree). A point count the
        axis does not divide raises."""
        from libdogleg_tpu_torch.parallel.batched import shard_batch
        A, B, obs = shard_batch((self.A, self.B, self.obs), mesh, axis_name)
        return self._replace(A=A, B=B, obs=obs)

    def shard_p_tree(self, p, mesh, axis_name: str = "pts"):
        """A tree state {"c", "q"}, held whole on every rank, with p["q"]
        sharded as shard shards the points and p["c"] replicated."""
        from libdogleg_tpu_torch.parallel.batched import shard_batch
        from libdogleg_tpu_torch.parallel.points import replicate
        return {"c": replicate(p["c"], mesh),
                "q": shard_batch(p["q"], mesh, axis_name)}


def make_synthetic(seed: int = 0,
                   nc: int = 64,
                   n_points: int = 20000,
                   block_size: int = 3,
                   k_obs: int = 4,
                   coupling: float = 0.05,
                   noise: float = 0.0,
                   dtype=torch.float32,
                   device=None) -> BAProblem:
    """The JAX package's instance for `seed` (numpy default_rng, the same
    draws in the same order), on `device` (None: the CUDA device). noise=0
    makes the generating state the exact optimum."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=dev)
    A = t(rng.normal(size=(n_points, k_obs, block_size)))
    B = t(rng.normal(size=(n_points, k_obs, nc)) * coupling)
    c_true = t(rng.normal(size=(nc,)))
    q_true = t(rng.normal(size=(n_points, block_size)))
    obs = ((A * q_true[:, None, :]).sum(-1)
           + (B.reshape(-1, nc) @ c_true).reshape(n_points, k_obs))
    if noise:
        obs = obs + t(rng.normal(size=obs.shape) * noise)
    return BAProblem(A=A, B=B, obs=obs,
                     p_true=torch.cat([c_true, q_true.reshape(-1)]), nc=nc,
                     n_points=n_points, block_size=block_size)
