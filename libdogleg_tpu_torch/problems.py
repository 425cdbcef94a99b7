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
      "sparse": the block-sparse JtJ and level-scheduled sparse Cholesky,
        not ported yet (raises NotImplementedError).
    `ordering` and `amalgamate` configure the sparse analysis and are kept
    for the JAX signature. optimize() asks default_newton_solver() when no
    newton_solver is given."""
    f: Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]
    structure: BCSRStructure
    jtj: str = "dense"
    ordering: object = None
    amalgamate: int = 1

    def __post_init__(self):
        if self.jtj not in ("dense", "sparse"):
            raise ValueError(f"jtj must be 'dense' or 'sparse', "
                             f"got {self.jtj!r}")
        if self.jtj == "sparse":
            raise NotImplementedError(
                "jtj='sparse' needs the block-sparse JtJ and the sparse "
                "Cholesky (sparse_cholesky.py, supernodal.py), which wait "
                "for the sparse-Cholesky slice of the port")

    def jacobian(self, p: torch.Tensor
                 ) -> Tuple[torch.Tensor, BCSRJacobian]:
        x, values = self.f(p)
        return x, BCSRJacobian(structure=self.structure, values=values)

    def products(self, p: torch.Tensor) -> Products:
        x, J = self.jacobian(p)
        return Products(norm2_x=dops.norm2(x), Jt_x=bops.bcsr_jt_x(J, x),
                        JtJ=bops.bcsr_jtj_dense(J))

    def default_newton_solver(self):
        return None  # the solver's default for the dense JtJ

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
