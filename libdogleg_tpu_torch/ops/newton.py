"""Newton-system strategies (counterpart of libdogleg_tpu/ops/newton.py:31-163
and 373-488).

The trust-region iteration needs two operations on Products.JtJ:

    quad_form(JtJ, v)                  == norm2(J v)
    gauss_newton(JtJ, Jt_x, lam, ...)  == solve (JtJ + lam I) u = Jt_x; -u

DenseNewtonSolver serves a dense (..., n, n) JtJ through cholesky_ex (the
reference's LAPACK path); BlockedDenseNewtonSolver through the blocked
Cholesky of ops/blockchol.py (kernel K5) for 17 <= n <= 256 and the panel
Cholesky of ops/largechol.py (kernel K2) above; SparseNewtonSolver serves
the stored lower blocks of a block-sparse JtJ through the level-scheduled
sparse Cholesky (sparse_cholesky.py, supernodal.py; kernels K6 and K7). All
keep the reference's permanent escalating lambda (dogleg.c:137-138,
670-676); the dense ones take the `active` mask of the masked batched solver.
refine_iters > 0 adds iterative-refinement passes whose residual is
accumulated in compensated arithmetic (ops/compensated.py).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from libdogleg_tpu_torch.ops import cholesky as chol
from libdogleg_tpu_torch.ops import compensated as comp
from libdogleg_tpu_torch.ops import dense as dops


class GNResult(NamedTuple):
    step: torch.Tensor        # (..., Nstate) the negated Newton solution
    norm2_step: torch.Tensor  # (...)
    lam: torch.Tensor         # (...) possibly escalated permanent lambda
    ok: torch.Tensor          # (...) bool: factorization succeeded


def _refine(u: torch.Tensor, solve_fn: Callable, resid_fn: Callable,
            iters: int) -> torch.Tensor:
    """Classical iterative refinement against the computed factor:
    u <- u + A^{-1} r(u), with r from resid_fn (compensated) and the
    correction solved with the existing factor (one matvec and one factor
    solve per pass, no refactorization)."""
    for _ in range(iters):
        u = u + solve_fn(resid_fn(u))
    return u


def _damped_residual(JtJ: torch.Tensor, lam: torch.Tensor,
                     Jt_x: torch.Tensor) -> Callable:
    """v -> Jt_x - (JtJ + lam I) v, accumulated as a compensated pair."""
    def resid(v):
        hi, lo = comp.comp_matvec(JtJ, v)
        hi, lo = comp.pair_add_prod(hi, lo, lam[..., None], v)
        return comp.residual(Jt_x, hi, lo)
    return resid


@dataclasses.dataclass(frozen=True)
class DenseNewtonSolver:
    """Dense JtJ (the reference's LAPACK path): unrolled Cholesky for
    Nstate <= 16, cholesky_ex above. refine_iters > 0 runs that many
    iterative-refinement passes of the GN solve against the factor."""
    refine_iters: int = 0

    def quad_form(self, JtJ, v):
        return dops.quad_form(JtJ, v)

    def gauss_newton(self, JtJ, Jt_x, lam, *, lambda_initial,
                     lambda_max_tries,
                     active: Optional[torch.Tensor] = None) -> GNResult:
        fac = chol.factorize_jtj(JtJ, lam, lambda_initial=lambda_initial,
                                 lambda_max_tries=lambda_max_tries,
                                 active=active)
        step, n2 = chol.gauss_newton_step(fac.L, Jt_x)
        if self.refine_iters:
            u = _refine(-step, lambda r: chol.cholesky_solve(fac.L, r),
                        _damped_residual(JtJ, fac.lam, Jt_x),
                        self.refine_iters)
            step = -u
            n2 = dops.norm2(step)
        return GNResult(step=step, norm2_step=n2, lam=fac.lam, ok=fac.ok)


# BlockedDenseNewtonSolver's blocked range; above it, the panel Cholesky.
BLOCKED_MIN_N = 17
BLOCKED_MAX_N = 256


@dataclasses.dataclass(frozen=True)
class BlockedDenseNewtonSolver:
    """Dense JtJ through the 16-block-panel Cholesky (ops/blockchol.py) for
    n <= 256, kernel K5 on a CUDA tensor, and through
    ops/largechol.large_cholesky above, whose 256-wide diagonal panels go to
    kernel K2 on a CUDA tensor. The triangular solves are
    ops/cholesky.cholesky_solve on either path and either device.

    panel_impl is large_cholesky's ("auto", "cuda" or "torch"): "auto" takes
    K2 for CUDA tensors and its plain twin for CPU tensors."""
    refine_iters: int = 0
    panel_impl: str = "auto"

    def quad_form(self, JtJ, v):
        return dops.quad_form(JtJ, v)

    def gauss_newton(self, JtJ, Jt_x, lam, *, lambda_initial,
                     lambda_max_tries,
                     active: Optional[torch.Tensor] = None) -> GNResult:
        from libdogleg_tpu_torch.ops import blockchol, largechol

        n = JtJ.shape[-1]
        eye = torch.eye(n, dtype=JtJ.dtype, device=JtJ.device)
        large = n > BLOCKED_MAX_N

        def try_factor(lm):
            damped = JtJ + lm[..., None, None] * eye
            if large:
                return largechol.large_cholesky(damped,
                                                panel_impl=self.panel_impl)
            return blockchol.blocked_cholesky(damped)

        L, lam, ok = chol.escalating_lambda(
            try_factor, torch.as_tensor(lam, dtype=JtJ.dtype,
                                        device=JtJ.device),
            lambda_initial=lambda_initial, lambda_max_tries=lambda_max_tries,
            active=active)

        u = chol.cholesky_solve(L, Jt_x)
        if self.refine_iters:
            u = _refine(u, lambda r: chol.cholesky_solve(L, r),
                        _damped_residual(JtJ, lam, Jt_x), self.refine_iters)
        step = -u
        return GNResult(step=step, norm2_step=dops.norm2(step), lam=lam,
                        ok=ok)


@dataclasses.dataclass(frozen=True)
class SparseNewtonSolver:
    """Block-sparse Gauss-Newton systems through the level-scheduled
    block-sparse Cholesky, the CHOLMOD replacement for patterns that are
    neither dense nor arrow-structured.

    Products.JtJ is the (n_input_blocks, b, b) tensor of stored
    lower-triangle blocks in the pattern this strategy was analyzed for.
    The symbolic analysis (ordering, fill, level schedules) happens once, at
    construction, as the reference's single cholmod_analyze
    (dogleg.c:649-654); its index arrays go to a device once, on first use.
    One problem at a time: a batch of block tensors raises."""
    symbolic: object  # SparseCholeskySymbolic or AmalgamatedSymbolic
    # iterative-refinement passes of the GN solve (see _refine)
    refine_iters: int = 0

    @staticmethod
    def analyze(rows, cols, nb: int, b: int = 1, ordering=None,
                amalgamate: int = 1) -> "SparseNewtonSolver":
        """amalgamate > 1 merges that many consecutive (post-ordering) block
        columns into supernodes (supernodal.py): fewer, wider levels. The
        ordering defaults to the companion of the factorization style:
        "mindeg" (fill-minimizing) simplicial, "rcm" (bandwidth-minimizing,
        keeps grouped supernodes banded) when amalgamating."""
        if ordering is None:
            ordering = "rcm" if amalgamate > 1 else "mindeg"
        if amalgamate > 1:
            from libdogleg_tpu_torch import supernodal as sn
            return SparseNewtonSolver(symbolic=sn.analyze(
                rows, cols, nb, b, ordering, amalgamate=amalgamate))
        from libdogleg_tpu_torch import sparse_cholesky as sc
        return SparseNewtonSolver(symbolic=sc.analyze(rows, cols, nb, b,
                                                      ordering))

    def _backend(self):
        if hasattr(self.symbolic, "inner"):
            from libdogleg_tpu_torch import supernodal as sn
            return sn
        from libdogleg_tpu_torch import sparse_cholesky as sc
        return sc

    def _index(self, device, name, make=None):
        from libdogleg_tpu_torch.sparse_cholesky import device_array
        return device_array(self.symbolic, device, name, make)

    @staticmethod
    def _check(blocks):
        if blocks.dim() != 3:
            raise NotImplementedError(
                "SparseNewtonSolver takes one problem's (n_blocks, b, b) "
                "JtJ blocks; batched block-sparse solves wait for the "
                "batched-sparse item of the port (the JAX package batches "
                "them with vmap)")

    def quad_form(self, blocks, v):
        """v^T JtJ v from the stored lower blocks: off-diagonal blocks count
        twice. in_rows, in_cols, nb and b are the original pattern's on
        either kind of analysis."""
        self._check(blocks)
        sym = self.symbolic
        vb = v.reshape(sym.nb, sym.b)
        vi = vb.index_select(0, self._index(v.device, "in_rows"))
        vj = vb.index_select(0, self._index(v.device, "in_cols"))
        per_block = ((vi[:, None, :] @ blocks) @ vj[:, :, None])[:, 0, 0]
        weight = self._index(
            v.device, "quad_weight",
            lambda: np.where(sym.in_rows != sym.in_cols, 2, 1)).to(v.dtype)
        return (per_block * weight).sum()

    def _refine_table(self) -> np.ndarray:
        """A per-block-row gather table over the products of the stored
        blocks: stored lower block B_k at (i, j) contributes product k
        (B_k v_j) to row i and, off the diagonal, product K+k (B_k^T v_i)
        to row j; rows are padded with 2K, a zero row. A scatter-add matvec
        would round every accumulation and defeat the compensated residual;
        rows instead compensated-reduce their gathered exact-product
        pairs."""
        sym = self.symbolic
        K = len(sym.in_rows)
        terms = [[] for _ in range(sym.nb)]
        for k, (i, j) in enumerate(zip(sym.in_rows, sym.in_cols)):
            terms[int(i)].append(k)
            if i != j:
                terms[int(j)].append(K + k)
        tbl = np.full((sym.nb, max(len(t) for t in terms)), 2 * K, np.int64)
        for i, t in enumerate(terms):
            tbl[i, :len(t)] = t
        return tbl

    def gauss_newton(self, blocks, Jt_x, lam, *, lambda_initial,
                     lambda_max_tries,
                     active: Optional[torch.Tensor] = None) -> GNResult:
        """One problem's GN step; `active` is taken for the batched
        solver's signature, whose batched blocks raise."""
        self._check(blocks)
        be, sym = self._backend(), self.symbolic
        L, lam, ok = be.factorize_with_lambda(
            sym, blocks, lam, lambda_initial=lambda_initial,
            lambda_max_tries=lambda_max_tries)
        u = be.solve(sym, L, Jt_x)
        if self.refine_iters:
            dev, b = blocks.device, sym.b
            tbl = self._index(dev, "refine_table", self._refine_table)
            rows, cols = (self._index(dev, "in_rows"),
                          self._index(dev, "in_cols"))

            def resid(v):
                vb = v.reshape(sym.nb, b)
                pl, el = comp.comp_contract(      # B_k @ v_{cols[k]}
                    blocks, vb[cols], reduce_axes=(2,),
                    broadcast=lambda x: x[:, None, :])
                pu, eu = comp.comp_contract(      # B_k^T @ v_{rows[k]}
                    blocks, vb[rows], reduce_axes=(1,),
                    broadcast=lambda x: x[:, :, None])
                zero = v.new_zeros((1, b))
                H = torch.cat([pl, pu, zero])[tbl]
                E = torch.cat([el, eu, zero])[tbl]
                hi, lo = comp.comp_reduce(H, E, axis=1)
                hi, lo = comp.pair_add_prod(hi.reshape(-1), lo.reshape(-1),
                                            lam, v)
                return comp.residual(Jt_x, hi, lo)

            u = _refine(u, lambda r: be.solve(sym, L, r), resid,
                        self.refine_iters)
        step = -u
        return GNResult(step=step, norm2_step=dops.norm2(step), lam=lam,
                        ok=ok)
