"""Measurement-axis (row-block) sharding of the Jacobian (counterpart of
libdogleg_tpu/parallel/sharded.py).

The products the solver consumes, norm2(x), J^T x and J^T J, are sums over
the measurement axis, so each rank of a mesh axis evaluates only its rows
of the residual and the Jacobian, forms its partial products, and one
all_reduce over the axis (the JAX package's psum) sums them exactly. The
Nstate-sized trust-region iteration then runs replicated on every rank of
the axis. All three partial products travel in one flat buffer of
1 + Nstate + Nstate^2 values (the stored lower blocks in place of Nstate^2
for the block-sparse problem): one all_reduce an evaluation.

Replicated decisions (hazard F16): every rank takes bool() of its own copy
of each decision value, so every rank must hold the same bits. The
all_reduce gives every rank the same sums; everything after it on the
solver's path sums in a fixed order (the sparse path since ops/segsum.py),
so the ranks' decisions, and their sequence of collectives, never part.

A batch of starts over a sharded problem (a dp x meas mesh): the products
functions here carry `.batched`, which the masked batched driver
(parallel/batched.py) takes in place of torch.func.vmap. It vmaps the local
partial products over the batch and runs one all_reduce on the whole
batch's partials an evaluation. torch.func.vmap of the products
themselves would fail: c10d's in-place all_reduce has no batching rule
(hazard F15).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from libdogleg_tpu_torch.ops import dense as dops
from libdogleg_tpu_torch.parallel.mesh import local_tree
from libdogleg_tpu_torch.solver import Products

# all_reduce calls and bytes of this module's products since the last reset
all_reduce_calls = 0
all_reduce_bytes = 0


def reset_counts() -> None:
    global all_reduce_calls, all_reduce_bytes
    all_reduce_calls = all_reduce_bytes = 0


def all_reduce_sum(tensors, mesh: DeviceMesh, axis_name: str):
    """The sums of each tensor over the ranks of the mesh axis, by one
    all_reduce of a flat buffer (tensors of one dtype and device); a list
    in the given order and shapes. Every rank gets the same bits."""
    global all_reduce_calls, all_reduce_bytes
    tensors = list(tensors)
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=mesh.get_group(axis_name))
    all_reduce_calls += 1
    all_reduce_bytes += flat.numel() * flat.element_size()
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].reshape(t.shape))
        at += t.numel()
    return out


def _batched_sum(partial: Products, mesh, axis_name) -> Products:
    """A batch's partial products (leading axis B) summed over the axis in
    one all_reduce: each element's three products side by side."""
    B = partial.norm2_x.shape[0]
    flat = torch.cat([t.reshape(B, -1) for t in partial], 1)
    (summed,) = all_reduce_sum([flat], mesh, axis_name)
    out, at = [], 0
    for t in partial:
        n = t[0].numel()
        out.append(summed[:, at:at + n].reshape(t.shape))
        at += n
    return Products(*out)


class ShardedProducts:
    """products(p, *data) -> Products, the local partial products summed
    over the mesh axis by one all_reduce; `batched` is the same for a batch
    of states (and a batch of data, each element's own), with one
    all_reduce for the whole batch. `local(p, *data)` gives a rank's
    partial Products from its rows of data (DTensors sharded over the
    axis, or whole tensors; a problem binds its rows and takes none)."""

    def __init__(self, local: Callable[..., Products], mesh: DeviceMesh,
                 axis_name: str):
        self.local = local
        self.mesh = mesh
        self.axis_name = axis_name

    def __call__(self, p, *data) -> Products:
        partial = self.local(p, *local_tree(data, self.mesh,
                                            self.axis_name))
        return Products(*all_reduce_sum(partial, self.mesh, self.axis_name))

    def batched(self, p, *data) -> Products:
        data = local_tree(data, self.mesh, self.axis_name, 1)
        partial = torch.func.vmap(self.local)(p, *data)
        return _batched_sum(partial, self.mesh, self.axis_name)


def _dense_partial(x, J) -> Products:
    return Products(norm2_x=dops.norm2(x), Jt_x=dops.jt_dot(J, x),
                    JtJ=dops.build_jtj(J))


def measurement_sharded_products(
        f_shard: Callable[[torch.Tensor, Any],
                          Tuple[torch.Tensor, torch.Tensor]],
        mesh: DeviceMesh,
        axis_name: str) -> ShardedProducts:
    """Wrap a per-shard dense residual function into a global products
    function.

    f_shard: (p, data_shard) -> (x_shard, J_shard), evaluating only this
      rank's measurement rows; data_shard is a tree whose leaves have the
      measurement axis leading.
    Returns products(p, data) -> Products, where data's leaves are DTensors
    sharded along their leading axis over the mesh axis, or whole tensors
    (the same on every rank) from which each rank takes its rows. The
    partial products are summed by one all_reduce. Under the batched
    entry points, problem_data's leaves carry the batch axis first and the
    measurement axis second."""
    return ShardedProducts(lambda p, data: _dense_partial(*f_shard(p, data)),
                           mesh, axis_name)


@dataclasses.dataclass(frozen=True)
class MeasurementShardedProblem:
    """A dense problem whose measurement rows are partitioned over a mesh
    axis, with the `products` interface of the single-device adapters, so
    that optimize, solve_products (record_history included) and the
    batched entry points take it unchanged.

    f: (p, data_shard) -> (x_shard, J_shard), evaluated per rank.
    data: a tree whose leaves have the measurement axis leading: DTensors
      sharded over the axis, or whole tensors from which each rank takes
      its rows (once, here).
    mesh / axis_name: where the measurement axis lives. Every rank of the
    axis calls products at the same points: the solve is replicated."""
    f: Callable[[torch.Tensor, Any], Tuple[torch.Tensor, torch.Tensor]]
    data: Any
    mesh: DeviceMesh
    axis_name: str = "meas"
    _products: ShardedProducts = dataclasses.field(
        init=False, default=None, repr=False, compare=False)

    def __post_init__(self):
        shard = local_tree(self.data, self.mesh, self.axis_name)
        object.__setattr__(self, "_products", ShardedProducts(
            lambda p: _dense_partial(*self.f(p, shard)), self.mesh,
            self.axis_name))

    @property
    def products(self) -> ShardedProducts:
        return self._products


@dataclasses.dataclass(frozen=True)
class MeasurementShardedSparseProblem:
    """Row-sharded measurements producing a block-sparse JtJ: the large-
    Nstate companion of MeasurementShardedProblem, for problems whose
    dense Nstate^2 JtJ does not fit.

    Each rank evaluates its measurement rows (dense rows of J), contracts
    them into the stored lower-triangle JtJ block pattern (the JAX
    package's einsum 'mkb,mkc->kbc' over the gathered block columns, plain
    torch.einsum), and one all_reduce sums norm2(x), J^T x and the blocks;
    the replicated solve runs through SparseNewtonSolver, whose
    factorization is kernels K6 and K7 on the card. The analysis
    (SparseNewtonSolver.analyze) runs here, at construction.

    f: (p, data_shard) -> (x_shard, J_shard), J_shard (m_local, nstate).
    data: as for MeasurementShardedProblem.
    pattern_rows / pattern_cols: the stored lower-triangle block pattern
      (rows >= cols, diagonal present), as fed to SparseNewtonSolver.analyze.
    b: the JtJ block size; ordering, amalgamate: the analysis's.
    Pair with newton_solver(); Products.JtJ is the (nnzb, b, b) block
    tensor in pattern order."""
    f: Callable[[torch.Tensor, Any], Tuple[torch.Tensor, torch.Tensor]]
    data: Any
    pattern_rows: Any
    pattern_cols: Any
    b: int
    mesh: DeviceMesh
    axis_name: str = "meas"
    ordering: object = None
    amalgamate: int = 1
    _newton: object = dataclasses.field(init=False, default=None,
                                        repr=False, compare=False)
    _products: ShardedProducts = dataclasses.field(
        init=False, default=None, repr=False, compare=False)

    def __post_init__(self):
        from libdogleg_tpu_torch.ops.newton import SparseNewtonSolver
        rows = np.asarray(self.pattern_rows, np.int64)
        cols = np.asarray(self.pattern_cols, np.int64)
        nbcol = max(int(rows.max()), int(cols.max())) + 1
        object.__setattr__(self, "_newton", SparseNewtonSolver.analyze(
            rows, cols, nbcol, self.b, self.ordering,
            amalgamate=self.amalgamate))
        shard = local_tree(self.data, self.mesh, self.axis_name)
        b, index = self.b, {}

        def local(p):
            x, J = self.f(p, shard)
            if p.device not in index:
                index[p.device] = (torch.as_tensor(rows, device=p.device),
                                   torch.as_tensor(cols, device=p.device))
            pr, pc = index[p.device]
            Jb = J.reshape(J.shape[:-1] + (J.shape[-1] // b, b))
            # one gathered batched contraction per stored lower block
            blocks = torch.einsum("...mkb,...mkc->...kbc",
                                  Jb.index_select(-2, pr),
                                  Jb.index_select(-2, pc))
            return Products(norm2_x=dops.norm2(x), Jt_x=dops.jt_dot(J, x),
                            JtJ=blocks)
        object.__setattr__(self, "_products", ShardedProducts(
            local, self.mesh, self.axis_name))

    def newton_solver(self):
        return self._newton

    @property
    def products(self) -> ShardedProducts:
        return self._products
