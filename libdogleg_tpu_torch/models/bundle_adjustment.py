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
{"c": (nc,), "q": (n_points, bs)}. The JAX package's shard and shard_p_tree
place the per-point data over a device mesh; they belong to the parallel
layer, which is not ported yet, and are left out here.
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

    def _residuals(self, c, q, obs):
        B2 = self.B.reshape(-1, self.nc)
        return ((self.A * q[:, None, :]).sum(-1)
                + (B2 @ c).reshape(obs.shape) - obs)

    def _core(self, c, q, obs):
        """Residual, structured gradient and arrow JtJ, shared by the flat
        and tree product forms."""
        r = self._residuals(c, q, obs)
        B2 = self.B.reshape(-1, self.nc)
        gc = B2.mT @ r.reshape(-1)
        gq = (self.A * r[..., None]).sum(1)
        JtJ = SchurJtJ(
            U=B2.mT @ B2,
            W=(self.B.mT @ self.A).permute(1, 0, 2).contiguous(),
            V=self.A.mT @ self.A)
        return r, gc, gq, JtJ

    def residuals(self, p):
        return self._residuals(*self.split(p), self.obs)

    def products(self, p) -> Products:
        """One reduction over all observations into the arrow system (the
        dense-products form, reference dogleg.h:34-45)."""
        return self.products_obs(p, self.obs)

    def products_obs(self, p, obs) -> Products:
        """products at the observations obs (n_points, k_obs) in place of
        the instance's: the form torch.func.vmap batches over per-element
        observations (batched_optimize(ba.products_obs, p0,
        problem_data=obs_b, newton_solver=ba.newton_solver()))."""
        c, q = self.split(p)
        r, gc, gq, JtJ = self._core(c, q, obs)
        return Products(norm2_x=(r * r).sum(),
                        Jt_x=torch.cat([gc, gq.reshape(-1)]), JtJ=JtJ)

    def newton_solver(self) -> SchurNewtonSolver:
        return SchurNewtonSolver(nc=self.nc, n_points=self.n_points,
                                 block_size=self.block_size)

    # the tree form: p = {"c": (nc,), "q": (n_points, bs)}

    def residuals_tree(self, p):
        return self._residuals(p["c"], p["q"], self.obs)

    def products_tree(self, p) -> Products:
        return self.products_tree_obs(p, self.obs)

    def products_tree_obs(self, p, obs) -> Products:
        """products_tree at the observations obs, as products_obs."""
        r, gc, gq, JtJ = self._core(p["c"], p["q"], obs)
        return Products(norm2_x=(r * r).sum(), Jt_x={"c": gc, "q": gq},
                        JtJ=JtJ)

    def tree_newton_solver(self) -> TreeSchurNewtonSolver:
        return TreeSchurNewtonSolver(nc=self.nc, n_points=self.n_points,
                                     block_size=self.block_size)

    def p0_tree(self, dtype=None):
        dtype = dtype or self.A.dtype
        dev = self.A.device
        return {"c": torch.zeros((self.nc,), dtype=dtype, device=dev),
                "q": torch.zeros((self.n_points, self.block_size),
                                 dtype=dtype, device=dev)}


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
