"""Problem adapters (counterpart of libdogleg_tpu/problems.py).

Each adapter reduces an operating point to the solver's Products, following
the reference's callback flavors (reference dogleg.h:11-45): dense
(x + J), sparse (x + block-CSR J), dense-products (norm2x, Jt_x, JtJ), and,
beyond the reference, residual-only with the Jacobian from forward-mode
autodiff.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from libdogleg_tpu_torch.ops import bcsr as bops
from libdogleg_tpu_torch.ops import dense as dops
from libdogleg_tpu_torch.ops.bcsr import BCSRJacobian, BCSRStructure
from libdogleg_tpu_torch.params import DoglegParameters
from libdogleg_tpu_torch.solver import Products, SolveResult, solve_products


@dataclasses.dataclass(frozen=True)
class DenseProblem:
    """f(p) -> (x, J), J of shape (nmeas, nstate) (reference
    dogleg_callback_dense_t, dogleg.h:21-30)."""
    f: Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]

    def products(self, p: torch.Tensor) -> Products:
        x, J = self.f(p)
        return Products(norm2_x=dops.norm2(x), Jt_x=dops.jt_dot(J, x),
                        JtJ=dops.build_jtj(J))

    def full(self, p: torch.Tensor):
        return self.f(p)

    def dense_jacobian(self, p: torch.Tensor) -> torch.Tensor:
        return self.f(p)[1]


@dataclasses.dataclass(frozen=True)
class SparseProblem:
    """f(p) -> (x, values), values the (nnzb, bm, bn) block values of J for
    the fixed block-CSR `structure` (reference dogleg_callback_t,
    dogleg.h:11-20, the static structure in the role of the one-time
    symbolic analysis).

    jtj selects the Gauss-Newton system representation:
      "dense" (default): JtJ materializes as (nstate, nstate) and the
        Newton step is a dense Cholesky (right while nstate is moderate);
      "sparse": JtJ stays block-sparse on its lower-triangle pattern and
        the Newton step runs through the level-scheduled block-sparse
        Cholesky (the CHOLMOD regime, for large nstate), whose symbolic
        analysis runs here, once, on the host. `ordering` is its
        fill-reducing ordering (None: "mindeg" simplicial, "rcm"
        amalgamated) and `amalgamate` its supernode width.
    optimize() asks default_newton_solver() when no newton_solver is
    given."""
    f: Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]
    structure: BCSRStructure
    jtj: str = "dense"
    ordering: object = None
    amalgamate: int = 1
    _jtj_sched: object = dataclasses.field(init=False, default=None,
                                           repr=False, compare=False)
    _newton: object = dataclasses.field(init=False, default=None,
                                        repr=False, compare=False)
    # the schedule's index arrays on each device they were used on
    _sched_on: dict = dataclasses.field(init=False, default_factory=dict,
                                        repr=False, compare=False)

    def __post_init__(self):
        if self.jtj not in ("dense", "sparse"):
            raise ValueError(f"jtj must be 'dense' or 'sparse', "
                             f"got {self.jtj!r}")
        if self.jtj == "sparse":
            from libdogleg_tpu_torch.ops.newton import SparseNewtonSolver
            s = self.structure
            if s.block_rows > 1 and s.nmeas % s.block_rows:
                raise ValueError("nmeas must divide into block rows")
            sched = bops.jtj_lower_schedule(s)
            ns = SparseNewtonSolver.analyze(
                sched.rows, sched.cols, s.nbcol, s.block_cols,
                self.ordering, amalgamate=self.amalgamate)
            object.__setattr__(self, "_jtj_sched", sched)
            object.__setattr__(self, "_newton", ns)

    def _schedule_on(self, device: torch.device) -> bops.JtJLowerSchedule:
        sched = self._sched_on.get(device)
        if sched is None:
            sched = self._jtj_sched._replace(**{
                k: torch.as_tensor(np.asarray(getattr(self._jtj_sched, k),
                                              np.int64), device=device)
                for k in ("pair_i", "pair_j", "out_idx")})
            self._sched_on[device] = sched
        return sched

    def jacobian(self, p: torch.Tensor
                 ) -> Tuple[torch.Tensor, BCSRJacobian]:
        x, values = self.f(p)
        return x, BCSRJacobian(structure=self.structure, values=values)

    def products(self, p: torch.Tensor) -> Products:
        x, J = self.jacobian(p)
        if self.jtj == "sparse":
            JtJ = bops.bcsr_jtj_lower_blocks(
                J, self._schedule_on(J.values.device))
        else:
            JtJ = bops.bcsr_jtj_dense(J)
        return Products(norm2_x=dops.norm2(x), Jt_x=bops.bcsr_jt_x(J, x),
                        JtJ=JtJ)

    def default_newton_solver(self):
        """The SparseNewtonSolver of jtj="sparse"; None for "dense" (the
        solver's default)."""
        return self._newton

    def full(self, p: torch.Tensor):
        x, J = self.jacobian(p)
        return x, bops.bcsr_to_dense(J)

    def dense_jacobian(self, p: torch.Tensor) -> torch.Tensor:
        return self.full(p)[1]


@dataclasses.dataclass(frozen=True)
class ProductsProblem:
    """f(p) -> (norm2x, Jt_x, JtJ) with JtJ full symmetric (reference
    dogleg_callback_dense_products_t, dogleg.h:34-45). Packed-triangle
    callbacks adapt through utils.packed.packed_to_full."""
    f: Callable[[torch.Tensor],
                Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]

    def products(self, p: torch.Tensor) -> Products:
        norm2x, Jt_x, JtJ = self.f(p)
        return Products(norm2_x=norm2x, Jt_x=Jt_x, JtJ=JtJ)


@dataclasses.dataclass(frozen=True)
class ResidualProblem:
    """f(p) -> x; the Jacobian comes from torch.func.jacfwd (nmeas >= nstate
    makes forward mode the right default)."""
    f: Callable[[torch.Tensor], torch.Tensor]

    def products(self, p: torch.Tensor) -> Products:
        x, J = self.full(p)
        return Products(norm2_x=dops.norm2(x), Jt_x=dops.jt_dot(J, x),
                        JtJ=dops.build_jtj(J))

    def full(self, p: torch.Tensor):
        return self.f(p), self.dense_jacobian(p)

    def dense_jacobian(self, p: torch.Tensor) -> torch.Tensor:
        return torch.func.jacfwd(self.f)(p)


def optimize(problem,
             p0: torch.Tensor,
             parameters: Optional[DoglegParameters] = None,
             *,
             newton_solver=None,
             record_history: bool = False,
             history_capacity: Optional[int] = None) -> SolveResult:
    """Top-level single solve, the counterpart of dogleg_optimize2 /
    dogleg_optimize_dense2 / dogleg_optimize_dense_products (reference
    dogleg.c:1755-1818), dispatching through the adapter's `products`.
    Without a newton_solver it takes the problem's default_newton_solver(),
    where the problem has one."""
    if newton_solver is None:
        default = getattr(problem, "default_newton_solver", None)
        if default is not None:
            newton_solver = default()
    return solve_products(problem.products, p0, parameters,
                          newton_solver=newton_solver,
                          record_history=record_history,
                          history_capacity=history_capacity)
