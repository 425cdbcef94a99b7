"""Problem adapters (counterpart of libdogleg_tpu/problems.py).

Each adapter reduces an operating point to the solver's Products, following
the reference's callback flavors (reference dogleg.h:11-45): dense
(x + J), sparse (x + block-CSR J), dense-products (norm2x, Jt_x, JtJ), and,
beyond the reference, residual-only with the Jacobian from forward-mode
autodiff and the basis-factored form on sufficient statistics.
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
            from libdogleg_tpu_torch.ops.traced import real_constant
            sched = self._jtj_sched._replace(**{
                k: real_constant(lambda k=k: torch.as_tensor(
                    np.asarray(getattr(self._jtj_sched, k), np.int64),
                    device=device))
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


@dataclasses.dataclass(frozen=True)
class FactoredBasisProblem:
    """Separable (basis-factored) residual: x(p) = B @ coeffs(p) - meas
    with B a static (nmeas, nbasis) basis and coeffs(p) the (usually much
    smaller) nonlinear core. With G = B^T B and h = B^T meas computed once,

        J     = B T,  T = d coeffs / dp
        JtJ   = T^T G T
        Jt_x  = T^T (G c - h)
        norm2 = c.(G c - h) + (meas.meas - c.h)

    so an evaluation never touches the measurement axis: it reads
    2 nbasis + 2 values of sufficient statistics and does O(nbasis^2)
    operations. The reference's callbacks always walk the measurement
    vector (reference dogleg.h:24-45); this is a reformulation of the same
    mathematics, exact up to float association.

    Numerics: G c and h are large and cancel down to the gradient's scale,
    far below float32 resolution, so G, h and meas.meas are held as
    double-working-precision (hi, lo) pairs and the cancelling combinations
    run in compensated arithmetic (ops/compensated.py). The products are
    plain torch.matmul, which runs in true float32 on the card (TF32 off,
    hazard F1).

    coeffs_jac defaults to torch.func.jacfwd(coeffs); pass a closed form
    when there is one. Build per-instance statistics with
    FactoredBasisProblem.statistics(B, meas) (a leading batch axis on meas
    gives a batch of them) and the static Gram pair with
    FactoredBasisProblem.gram(B64, dtype, device): B in float64 there, Gram
    entries routinely exceed float32's exact-integer range.

    The products take leading batch axes on p and the statistics where
    coeffs and coeffs_jac do (the default jacfwd does not; torch.func.vmap
    the products then). Counterpart of libdogleg_tpu/problems.py:158-241."""
    coeffs: Callable[[torch.Tensor], torch.Tensor]
    G_pair: Tuple[torch.Tensor, torch.Tensor]
    stats: Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]
    coeffs_jac: Optional[Callable[[torch.Tensor], torch.Tensor]] = None

    @staticmethod
    def gram(B64, dtype, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """G = B^T B as a double-float32 (or degenerate float64) pair, on
        `device` (None: the CUDA device); B64 is taken as numpy float64 so
        that the split keeps the low bits."""
        from libdogleg_tpu_torch.device import resolve_device
        device = resolve_device(device)
        B64 = np.asarray(B64, np.float64)
        G = B64.T @ B64
        hi = G.astype(np.float32).astype(np.float64)
        return (torch.as_tensor(hi, dtype=dtype, device=device),
                torch.as_tensor(G - hi, dtype=dtype, device=device))

    @staticmethod
    def statistics(B, measurements):
        """Per-instance sufficient statistics as compensated pairs:
        (h_hi, h_lo, n2m_hi, n2m_lo) with h = B^T meas, n2m = meas.meas.
        measurements (..., nmeas) gives h (..., nbasis), n2m (...)."""
        from libdogleg_tpu_torch.ops import compensated as comp
        hh, hl = comp.comp_matvec(B.mT, measurements)
        p, e = comp.two_prod(measurements, measurements)
        nh, nl = comp.comp_reduce(p, e, axis=-1)
        return hh, hl, nh, nl

    def products(self, p: torch.Tensor) -> Products:
        from libdogleg_tpu_torch.ops import compensated as comp
        hh, hl, nh, nl = self.stats
        Ghi, Glo = self.G_pair
        c = self.coeffs(p)
        T = (self.coeffs_jac or torch.func.jacfwd(self.coeffs))(p)
        gh, gl = comp.comp_matvec_pair(Ghi, Glo, c)      # G c
        dh, dl = comp.pair_add(gh, gl, -hh, -hl)         # g = G c - h
        g = comp.collapse(dh, dl)
        Jt_x = (T.mT @ g[..., None])[..., 0]
        JtJ = T.mT @ ((Ghi + Glo) @ T)
        wh, wl = comp.pair_dot_pair(c, hh, hl)           # c . h
        uh, ul = comp.pair_add(nh, nl, -wh, -wl)         # n2m - c.h
        norm2 = dops.dot(c, g) + comp.collapse(uh, ul)
        # c.(Gc - h) + (m.m - c.h) can cancel a hair below zero near the
        # optimum, where x @ x cannot: clamp, so that no consumer sees a
        # negative cost. Exact whenever the true value is nonnegative.
        norm2 = torch.maximum(norm2, torch.zeros_like(norm2))
        return Products(norm2_x=norm2, Jt_x=Jt_x, JtJ=JtJ)


def optimize(problem,
             p0: torch.Tensor,
             parameters: Optional[DoglegParameters] = None,
             *,
             newton_solver=None,
             record_history: bool = False,
             history_capacity: Optional[int] = None,
             debug: bool = False) -> SolveResult:
    """Top-level single solve, the counterpart of dogleg_optimize2 /
    dogleg_optimize_dense2 / dogleg_optimize_dense_products (reference
    dogleg.c:1755-1818), dispatching through the adapter's `products`.
    Without a newton_solver it takes the problem's default_newton_solver(),
    where the problem has one. debug=True prints one line an attempt
    (solve_products)."""
    if newton_solver is None:
        default = getattr(problem, "default_newton_solver", None)
        if default is not None:
            newton_solver = default()
    return solve_products(problem.products, p0, parameters,
                          newton_solver=newton_solver,
                          record_history=record_history,
                          history_capacity=history_capacity, debug=debug)
