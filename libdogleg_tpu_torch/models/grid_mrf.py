"""2-D grid Markov-random-field model family: large block-sparse problems
(counterpart of libdogleg_tpu/models/grid_mrf.py).

The workload class the reference's sparse path exists for (reference
README.pod:17-38): many small state blocks coupled on a sparse graph. A
W x H grid of b-dimensional node states with per-node priors and 4-neighbor
relative measurements:

    prior residual  r_v    = sqrt(w_prior) * (p_v - z_v)
    edge  residual  r_(uv) = sqrt(w_edge)  * (M_e p_v - p_u - z_uv)

with M_e = I (coupling="diag") or a dense well-conditioned mixing matrix
(coupling="dense"). The Jacobian is block-CSR: one block row per prior, two
blocks per edge row. The problem is linear, so one Gauss-Newton step reaches
the optimum from anywhere.

The instance is drawn from numpy's default_rng(seed) in the JAX package's
order, so one seed gives the same instance in both packages.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from libdogleg_tpu_torch.device import resolve_device
from libdogleg_tpu_torch.ops.bcsr import BCSRStructure
from libdogleg_tpu_torch.problems import SparseProblem


class GridMRF(NamedTuple):
    width: int
    height: int
    block_size: int
    structure: BCSRStructure
    edges: np.ndarray        # (n_edges, 2) node indices (u, v)
    z_prior: torch.Tensor    # (n_nodes, b) prior targets
    z_edge: torch.Tensor     # (n_edges, b) relative targets
    w_prior: float
    w_edge: float
    p_true: torch.Tensor     # (n_nodes * b,)
    # per-edge mixing matrices (n_edges, b, b); None = identity
    mix: Optional[torch.Tensor] = None

    @property
    def n_nodes(self) -> int:
        return self.width * self.height

    @property
    def nstate(self) -> int:
        return self.n_nodes * self.block_size

    def problem(self, jtj: str = "sparse", ordering="mindeg") -> SparseProblem:
        """The SparseProblem of this instance. The default, jtj="sparse"
        with the "mindeg" ordering, keeps JtJ block-sparse and solves
        through SparseNewtonSolver (the simplicial block-sparse Cholesky,
        kernels K6 and K7 on a CUDA device); jtj="dense" forms the dense
        JtJ. The block values do not depend on p: priors sqrt(wp) I; edges
        [-sqrt(we) I, +sqrt(we) M_e] in (u, v) column order per block
        row."""
        b = self.block_size
        n_nodes, n_edges = self.n_nodes, self.edges.shape[0]
        dt, dev = self.z_prior.dtype, self.z_prior.device
        sp_w, se_w = math.sqrt(self.w_prior), math.sqrt(self.w_edge)
        eu = torch.as_tensor(self.edges[:, 0], device=dev)
        ev = torch.as_tensor(self.edges[:, 1], device=dev)
        eye = torch.eye(b, dtype=dt, device=dev)
        if self.mix is None:
            v_blocks = torch.stack([-se_w * eye, se_w * eye]).repeat(
                n_edges, 1, 1)
        else:
            v_blocks = torch.stack(
                [(-se_w * eye).expand(n_edges, b, b), se_w * self.mix],
                dim=1).reshape(2 * n_edges, b, b)
        values = torch.cat([(sp_w * eye).expand(n_nodes, b, b), v_blocks])
        z_prior, z_edge, mix = self.z_prior, self.z_edge, self.mix

        def f(p):
            pb = p.reshape(n_nodes, b)
            r_prior = sp_w * (pb - z_prior)
            pv = pb[ev] if mix is None else (mix @ pb[ev][..., None])[..., 0]
            r_edge = se_w * (pv - pb[eu] - z_edge)
            return torch.cat([r_prior.reshape(-1), r_edge.reshape(-1)]), values

        return SparseProblem(f=f, structure=self.structure, jtj=jtj,
                             ordering=ordering)


def grid_edges(width: int, height: int) -> np.ndarray:
    """(n_edges, 2) right and down neighbor pairs (u, v), u < v, row-major
    over the nodes."""
    edges = []
    for iy in range(height):
        for ix in range(width):
            u = iy * width + ix
            if ix + 1 < width:
                edges.append((u, u + 1))
            if iy + 1 < height:
                edges.append((u, u + width))
    return np.asarray(edges, np.int64).reshape(-1, 2)


def make_grid_mrf(width: int = 32, height: int = 32, block_size: int = 4,
                  w_prior: float = 0.01, w_edge: float = 1.0,
                  noise: float = 0.05, seed: int = 0,
                  coupling: str = "diag",
                  dtype=torch.float64, device=None) -> GridMRF:
    if coupling not in ("diag", "dense"):
        raise ValueError(f"coupling must be 'diag' or 'dense', "
                         f"got {coupling!r}")
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    n_nodes = width * height
    b = block_size
    edges = grid_edges(width, height)
    n_edges = edges.shape[0]

    p_true = rng.normal(size=(n_nodes, b))
    z_prior = p_true + rng.normal(size=(n_nodes, b)) * noise
    if coupling == "dense":
        # well-conditioned dense per-edge mixing: M_e = I + 0.3 G_e
        mix = (np.eye(b)[None]
               + 0.3 * rng.normal(size=(n_edges, b, b)) / np.sqrt(b))
        pv = np.einsum('ebc,ec->eb', mix, p_true[edges[:, 1]])
    else:
        mix = None
        pv = p_true[edges[:, 1]]
    z_edge = (pv - p_true[edges[:, 0]]
              + rng.normal(size=(n_edges, b)) * noise)
    return from_arrays(width, height, b, edges, z_prior, z_edge, w_prior,
                       w_edge, p_true.reshape(-1), mix, dtype=dtype,
                       device=device)


def from_arrays(width: int, height: int, block_size: int, edges, z_prior,
                z_edge, w_prior: float, w_edge: float, p_true, mix=None, *,
                dtype=torch.float64, device=None) -> GridMRF:
    """A GridMRF from numpy arrays; builds the block-CSR structure. Block
    rows: priors, then edges; a prior touches its node's block, an edge its
    u then v block (u < v keeps the indices sorted per row). The tensors
    go to `device` (None: the CUDA device, see device.resolve_device)."""
    device = resolve_device(device)
    b = block_size
    edges = np.asarray(edges, np.int64)
    n_nodes, n_edges = width * height, edges.shape[0]
    indptr = np.empty(n_nodes + n_edges + 1, np.int32)
    indptr[0] = 0
    indptr[1:n_nodes + 1] = np.arange(1, n_nodes + 1)
    indptr[n_nodes + 1:] = n_nodes + 2 * np.arange(1, n_edges + 1)
    indices = np.concatenate([np.arange(n_nodes, dtype=np.int32),
                              edges.astype(np.int32).reshape(-1)])
    structure = BCSRStructure(
        nmeas=(n_nodes + n_edges) * b, nstate=n_nodes * b,
        block_rows=b, block_cols=b, indptr=indptr, indices=indices)

    def t(a):
        return torch.as_tensor(np.array(a), dtype=dtype, device=device)
    return GridMRF(width=width, height=height, block_size=b,
                   structure=structure, edges=edges, z_prior=t(z_prior),
                   z_edge=t(z_edge), w_prior=float(w_prior),
                   w_edge=float(w_edge), p_true=t(p_true),
                   mix=None if mix is None else t(mix))
