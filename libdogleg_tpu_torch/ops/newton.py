"""Newton-system strategies (counterpart of libdogleg_tpu/ops/newton.py).

The trust-region iteration needs two operations on Products.JtJ:

    quad_form(JtJ, v)                  == norm2(J v)
    gauss_newton(JtJ, Jt_x, lam, ...)  == solve (JtJ + lam I) u = Jt_x; -u

DenseNewtonSolver serves a dense (..., n, n) JtJ through cholesky_ex (the
reference's LAPACK path); BlockedDenseNewtonSolver through the blocked
Cholesky of ops/blockchol.py (kernel K5) for 17 <= n <= 256 and the panel
Cholesky of ops/largechol.py (kernel K2) above; SparseNewtonSolver serves
the stored lower blocks of a block-sparse JtJ through the level-scheduled
sparse Cholesky (sparse_cholesky.py, supernodal.py; kernels K6 and K7).
The Schur strategies serve the arrow systems of bundle adjustment,
JtJ = [[U, W], [W^T, V]] with V block-diagonal, by eliminating the point
blocks: SchurNewtonSolver on a flat state, TreeSchurNewtonSolver on a
{"c", "q"} tree state, SparseWSchurNewtonSolver when each point couples to
k_obs cameras only. They are plain torch ops (the unrolled smallchol for
the point blocks, torch.linalg.cholesky_ex for the reduced camera system,
matmuls with TF32 off). All keep the reference's permanent escalating
lambda (dogleg.c:137-138, 670-676) and take the `active` mask of the masked
batched solver, and the three Schur strategies a leading batch axis.
refine_iters > 0 adds iterative-refinement passes whose residual is
accumulated in compensated arithmetic (ops/compensated.py), with or
without a batch axis.

Every camera-axis reduction is deterministic on the card: a matmul (a
one-hot product where the coupling is sparse) or a sum over a gathered
table, never an index_add_, whose float atomics on CUDA may sum in any
order.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from libdogleg_tpu_torch.ops import cholesky as chol
from libdogleg_tpu_torch.ops import compensated as comp
from libdogleg_tpu_torch.ops import dense as dops
from libdogleg_tpu_torch.ops import smallchol
from libdogleg_tpu_torch.ops import treevec as tv


class GNResult(NamedTuple):
    step: Any                 # (..., Nstate) the negated Newton solution,
                              # or a tree of tensors
    norm2_step: torch.Tensor  # (...)
    lam: torch.Tensor         # (...) possibly escalated permanent lambda
    ok: torch.Tensor          # (...) bool: factorization succeeded


def _refine(u, solve_fn: Callable, resid_fn: Callable, iters: int):
    """Classical iterative refinement against the computed factor:
    u <- u + A^{-1} r(u), with r from resid_fn (compensated) and the
    correction solved with the existing factor (one matvec and one factor
    solve per pass, no refactorization). u is a tensor or a tree of tensors,
    such as the (cameras, points) pair of the Schur strategies."""
    for _ in range(iters):
        u = tv.tree_add(u, solve_fn(resid_fn(u)))
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
    A batch of problems that share the pattern (the masked batched solver's
    JtJ (B, n_input_blocks, b, b), Jt_x (B, n), lam (B,)) goes through the
    same level loop at once, each element escalating lambda on its own
    where `active` allows; quad_form gives one value an element."""
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

    def _check(self, blocks, v):
        """The blocks (n_input, b, b), or a batch (B, n_input, b, b), and a
        vector of the same batch."""
        sym = self.symbolic
        shape = (len(sym.in_rows), sym.b, sym.b)
        if (blocks.dim() not in (3, 4) or tuple(blocks.shape[-3:]) != shape
                or tuple(v.shape) != tuple(blocks.shape[:-3])
                + (sym.nb * sym.b,)):
            raise ValueError(
                f"SparseNewtonSolver takes JtJ blocks (..., {shape}) and "
                f"vectors (..., {sym.nb * sym.b}) of one batch shape (none, "
                f"or (B,)); got {tuple(blocks.shape)} and {tuple(v.shape)}")

    def quad_form(self, blocks, v):
        """v^T JtJ v from the stored lower blocks: off-diagonal blocks count
        twice, per element of a batch. in_rows, in_cols, nb and b are the
        original pattern's on either kind of analysis."""
        self._check(blocks, v)
        sym = self.symbolic
        vb = v.reshape(v.shape[:-1] + (sym.nb, sym.b))
        vi = vb.index_select(-2, self._index(v.device, "in_rows"))
        vj = vb.index_select(-2, self._index(v.device, "in_cols"))
        per_block = ((vi[..., None, :] @ blocks) @ vj[..., None])[..., 0, 0]
        weight = self._index(
            v.device, "quad_weight",
            lambda: np.where(sym.in_rows != sym.in_cols, 2, 1)).to(v.dtype)
        return (per_block * weight).sum(-1)

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
        """The GN step of one problem, or of each element of a batch, where
        only the `active` elements escalate lambda."""
        self._check(blocks, Jt_x)
        be, sym = self._backend(), self.symbolic
        L, lam, ok = be.factorize_with_lambda(
            sym, blocks, lam, lambda_initial=lambda_initial,
            lambda_max_tries=lambda_max_tries, active=active)
        u = be.solve(sym, L, Jt_x)
        if self.refine_iters:
            dev, b = blocks.device, sym.b
            tbl = self._index(dev, "refine_table", self._refine_table)
            rows, cols = (self._index(dev, "in_rows"),
                          self._index(dev, "in_cols"))
            # the compensated contractions' axes shift past a batch axis
            a = blocks.dim() - 3

            def resid(v):
                vb = v.reshape(v.shape[:-1] + (sym.nb, b))
                pl, el = comp.comp_contract(      # B_k @ v_{cols[k]}
                    blocks, vb.index_select(-2, cols), reduce_axes=(a + 2,),
                    broadcast=lambda x: x[..., None, :])
                pu, eu = comp.comp_contract(      # B_k^T @ v_{rows[k]}
                    blocks, vb.index_select(-2, rows), reduce_axes=(a + 1,),
                    broadcast=lambda x: x[..., :, None])
                zero = v.new_zeros(v.shape[:-1] + (1, b))
                H = torch.cat([pl, pu, zero], -2)[..., tbl, :]
                E = torch.cat([el, eu, zero], -2)[..., tbl, :]
                hi, lo = comp.comp_reduce(H, E, axis=-2)
                hi, lo = comp.pair_add_prod(hi.reshape(v.shape),
                                            lo.reshape(v.shape),
                                            lam[..., None], v)
                return comp.residual(Jt_x, hi, lo)

            u = _refine(u, lambda r: be.solve(sym, L, r), resid,
                        self.refine_iters)
        step = -u
        return GNResult(step=step, norm2_step=dops.norm2(step), lam=lam,
                        ok=ok)


# ---------------------------------------------------------------------------
# Schur elimination of the point blocks (libdogleg_tpu/ops/newton.py:166-370,
# 491-782)
# ---------------------------------------------------------------------------


class SchurJtJ(NamedTuple):
    """Arrow-structured Gauss-Newton system of bundle adjustment: state
    p = [dense block (nc) | n_points blocks of bs], JtJ = [[U, W], [W^T, V]]
    with V block-diagonal. The reference hands such systems whole to
    CHOLMOD. A batch of systems carries a leading batch axis on every
    field."""
    U: torch.Tensor   # (..., nc, nc) dense camera/global block
    W: torch.Tensor   # (..., nc, n_points, bs) coupling blocks
    V: torch.Tensor   # (..., n_points, bs, bs) point diagonal blocks


def schur_split(v: torch.Tensor, nc: int, n_points: int, bs: int):
    """A flat (..., nc + n_points * bs) vector as (camera part (..., nc),
    point part (..., n_points, bs))."""
    return v[..., :nc], v[..., nc:].reshape(v.shape[:-1] + (n_points, bs))


def block_diag(blocks: torch.Tensor) -> torch.Tensor:
    """The (..., m b, m b) block-diagonal matrix of (..., m, b, b) blocks,
    selected out of place from the blocks by an identity mask over the
    (m, b, m, b) layout, so that torch.func.vmap can batch it."""
    m, b = blocks.shape[-3], blocks.shape[-1]
    eye = torch.eye(m, dtype=torch.bool, device=blocks.device)
    out = torch.where(eye[:, None, :, None], blocks[..., :, :, None, :],
                      blocks.new_zeros(()))
    return out.reshape(blocks.shape[:-3] + (m * b, m * b))


def _cholesky_ok(A: torch.Tensor, batch_shape=()):
    """cholesky_ex of (..., n, n) A, with ok (batch_shape) = every matrix
    of the element factored with positive finite pivots: the reduction
    runs over the axes after batch_shape only, so one element's failure
    fails no other. A matrix that is not SPD gives ok False, never an
    exception (hazard F3)."""
    L, info = torch.linalg.cholesky_ex(A)
    good = ((info == 0) & torch.isfinite(L).all(-1).all(-1)
            & (torch.diagonal(L, dim1=-2, dim2=-1) > 0).all(-1))
    return L, good.reshape(tuple(batch_shape) + (-1,)).all(-1)


def _sum_last(x: torch.Tensor, nd: int) -> torch.Tensor:
    """The sum of x over its last nd axes: over all of them for one
    problem, per element for a batch."""
    return x.sum() if x.dim() == nd else x.flatten(-nd).sum(-1)


# A batch's matrix-vector products are products and sums over one axis: a
# batched matmul with one column is a gemv at batch 1 and a gemm above, so
# an element's bits would depend on how many others share its call (the
# compacted solve runs the stragglers in a smaller batch).


def _mv(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A x for (..., m, n) A and (..., n) x."""
    return A @ x if x.dim() == 1 else (A * x[..., None, :]).sum(-1)


def _vm(x: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """x^T A for (..., m) x and (..., m, n) A."""
    return x @ A if x.dim() == 1 else (x[..., :, None] * A).sum(-2)


def _block_quad(V: torch.Tensor, vp: torch.Tensor) -> torch.Tensor:
    """sum_p vp_p^T V_p vp_p for (..., n_points, bs, bs) blocks."""
    return _sum_last(vp[..., :, :, None] * V * vp[..., :, None, :], 3)


@dataclasses.dataclass(frozen=True)
class SchurNewtonSolver:
    """Gauss-Newton on a SchurJtJ by Schur elimination of the point blocks,
    over a flat state.

    factor: Vhat_p = V_p + lam I (batched small Cholesky);
            S = U + lam I - sum_p W_p Vhat_p^{-1} W_p^T (one matmul);
            the dense Cholesky of S.
    solve:  y_p = Vhat_p^{-1} rp_p; dc = S^{-1}(rc - sum_p W_p y_p);
            dp_p = Vhat_p^{-1}(rp_p - W_p^T dc).

    One problem (a 0-d lam) or a batch of B independent ones (lam (B,),
    every JtJ and state field with a leading B axis): factor, quad_form and
    gauss_newton(active=) then return a per-element ok and lam, and each
    element escalates lambda on its own (the masked batched solver).

    point_solver, for block_size <= 16: "unrolled" (smallchol's unrolled
    factor and substitutions) or "lax" (torch.linalg.cholesky_ex and
    solve_triangular, the library path; the JAX package's lax.linalg).
    Larger blocks always take the library path. refine_iters > 0 runs that
    many refinement passes against the factors, with a compensated
    residual.

    shards: the PointShards (parallel/points.py) of a point-sharded tree
    state, which solve_products sets from its start (None: unsharded).
    The point blocks are then a rank's own and every sum over points is
    summed over the mesh axis: S's W Y^T term with the point blocks' ok in
    one all_reduce a lambda try, W y in the solve, the refinement's camera
    rows as a compensated pair, the quadratic form's W and V terms, the
    step's point norm. The sizes come from the data, not n_points."""
    nc: int
    n_points: int
    block_size: int
    point_solver: str = "unrolled"
    refine_iters: int = 0
    shards: Any = dataclasses.field(default=None, repr=False, compare=False)

    def _unrolled(self) -> bool:
        return (self.block_size <= smallchol.SMALL_N_MAX
                and self.point_solver == "unrolled")

    def _split(self, v):
        return schur_split(v, self.nc, self.n_points, self.block_size)

    def quad_form(self, JtJ: SchurJtJ, v):
        vc, vp = self._split(v)
        return _schur_quad(JtJ, vc, vp)

    def factor(self, JtJ: SchurJtJ, lam):
        """Factorize JtJ + lam I once at a fixed lambda (no escalation).

        Returns ((Lv, Ls), ok): Lv (..., n_points, bs, bs) the lower
        Cholesky factors of the damped point blocks, Ls (..., nc, nc) that
        of the Schur complement S, ok (lam's shape) bool. The public
        cached-factor handle, whose tuple layout the analysis passes rely
        on (the JAX package's contract)."""
        bs = self.block_size
        dt, dev = JtJ.V.dtype, JtJ.V.device
        lam = torch.as_tensor(lam, dtype=dt, device=dev)
        Vhat = JtJ.V + lam[..., None, None, None] * torch.eye(
            bs, dtype=dt, device=dev)
        Wt = JtJ.W.movedim(-3, -1)                    # (..., np, bs, nc)
        if self._unrolled():
            Lv, okb = smallchol.small_cholesky(Vhat)
            ok_v = okb.reshape(lam.shape + (-1,)).all(-1)
        else:
            Lv, ok_v = _cholesky_ok(Vhat, lam.shape)
        Y = self._vsolve(Lv, Wt)
        S = (_s_start(self.shards, JtJ.U + lam[..., None, None] * torch.eye(
            self.nc, dtype=dt, device=dev))
             - JtJ.W.flatten(-2) @ Y.flatten(-3, -2))
        S, ok_v = _s_finish(self.shards, S, ok_v)
        Ls, ok_s = _cholesky_ok(S, lam.shape)
        return (Lv, Ls), ok_v & ok_s

    def _vsolve(self, Lv, b):
        """(..., n_points, bs, k) right-hand sides solved with the
        point-block factors."""
        if self._unrolled():
            return smallchol.small_cho_solve_mat(Lv, b)
        y = torch.linalg.solve_triangular(Lv, b, upper=False)
        return torch.linalg.solve_triangular(Lv.mT, y, upper=True)

    def _gn_core(self, JtJ: SchurJtJ, rc, rp, lam, lambda_initial,
                 lambda_max_tries, active=None):
        """Factor (with the escalating lambda, limited to `active` elements
        of a batch) and solve for the camera and point parts (dc, dp) of
        the Newton step."""
        (Lv, Ls), lam, ok = chol.escalating_lambda(
            lambda lm: self.factor(JtJ, lm),
            torch.as_tensor(lam, dtype=rc.dtype, device=rc.device),
            lambda_initial=lambda_initial, lambda_max_tries=lambda_max_tries,
            active=active)
        W2 = JtJ.W.flatten(-2)                        # (..., nc, np bs)

        def solve_pair(bc, bp):
            # the exact inverse given the factors
            y = self._vsolve(Lv, bp[..., None])[..., 0]   # (..., np, bs)
            (wy,) = _point_sum(self.shards, _mv(W2, y.flatten(-2)))
            sc = chol.cholesky_solve(Ls, bc - wy)
            sp = self._vsolve(
                Lv, (bp - _vm(sc, W2).reshape(bp.shape))[..., None])[..., 0]
            return sc, sp

        dc, dp = solve_pair(rc, rp)
        if self.refine_iters:
            # the compensated contractions of the JAX package, their axes
            # shifted past a leading batch axis (b = 1) where there is one
            b = rc.dim() - 1

            def resid(v):
                vc, vp = v
                # camera rows: U vc + lam vc + sum_pb W[c, p, b] vp[p, b]
                hc, lc = comp.comp_matvec(JtJ.U, vc)
                hc, lc = comp.pair_add_prod(hc, lc, lam[..., None], vc)
                hw, lw = comp.comp_contract(
                    JtJ.W, vp, reduce_axes=(b + 1, b + 2),
                    broadcast=lambda x: x[..., None, :, :])
                if self.shards is not None:
                    hw, lw = self.shards.sum_pair(hw, lw)
                hc, lc = comp.pair_add(hc, lc, hw, lw)
                # point rows: W^T vc + V vp + lam vp
                h1, l1 = comp.comp_contract(
                    JtJ.W, vc, reduce_axes=(b,),
                    broadcast=lambda x: x[..., :, None, None])
                h2, l2 = comp.comp_contract(
                    JtJ.V, vp, reduce_axes=(b + 2,),
                    broadcast=lambda x: x[..., None, :])
                hp, lp = comp.pair_add(h1, l1, h2, l2)
                hp, lp = comp.pair_add_prod(hp, lp, lam[..., None, None], vp)
                return comp.residual(rc, hc, lc), comp.residual(rp, hp, lp)

            dc, dp = _refine((dc, dp), lambda r: solve_pair(*r), resid,
                             self.refine_iters)
        return dc, dp, lam, ok

    def gauss_newton(self, JtJ: SchurJtJ, Jt_x, lam, *, lambda_initial,
                     lambda_max_tries,
                     active: Optional[torch.Tensor] = None) -> GNResult:
        rc, rp = self._split(Jt_x)
        dc, dp, lam, ok = self._gn_core(JtJ, rc, rp, lam, lambda_initial,
                                        lambda_max_tries, active)
        step = -torch.cat([dc, dp.flatten(-2)], -1)
        return GNResult(step=step, norm2_step=dops.norm2(step), lam=lam,
                        ok=ok)


def _point_sum(shards, *partials):
    """Partial sums over a rank's points summed over the mesh axis in one
    all_reduce where the state is point-sharded; as they are otherwise."""
    return list(partials) if shards is None else shards.sum(partials)


def _s_start(shards, S0):
    """Where the Schur complement's sum starts: S0 = U + lam I, replicated,
    enters on the mesh axis's first rank only, the others start from zero
    and subtract their own points' terms (_s_finish sums them), so a world
    of one adds in the unsharded order."""
    return S0 if shards is None or shards.first else torch.zeros_like(S0)


def _s_finish(shards, S, ok_v):
    """(S, ok_v) summed and and-ed over the mesh axis in one all_reduce
    (the points' blocks factor on their ranks); as they are unsharded."""
    if shards is None:
        return S, ok_v
    S, failed = shards.sum([S, (~ok_v).to(S.dtype)])
    return S, failed == 0


def _schur_quad(JtJ: SchurJtJ, vc, vp, shards=None) -> torch.Tensor:
    """v^T JtJ v for the arrow system, v = (vc, vp), per element of a
    batch."""
    uv = dops.dot(vc, _mv(JtJ.U, vc))
    wv, vq = _point_sum(shards, _mv(JtJ.W.flatten(-2), vp.flatten(-2)),
                        _block_quad(JtJ.V, vp))
    return uv + 2.0 * dops.dot(vc, wv) + vq


@dataclasses.dataclass(frozen=True)
class TreeSchurNewtonSolver(SchurNewtonSolver):
    """SchurNewtonSolver over tree states {"c": (..., nc), "q": (...,
    n_points, bs)} in place of one flat vector. The point leaf may be
    sharded over a mesh axis, the camera leaf replicated
    (BAProblem.shard_p_tree; `shards`, which solve_products sets): the
    JAX package's tree solver under GSPMD, its all-reduces explicit."""

    def quad_form(self, JtJ: SchurJtJ, v):
        return _schur_quad(JtJ, v["c"], v["q"], self.shards)

    def gauss_newton(self, JtJ: SchurJtJ, Jt_x, lam, *, lambda_initial,
                     lambda_max_tries,
                     active: Optional[torch.Tensor] = None) -> GNResult:
        dc, dp, lam, ok = self._gn_core(JtJ, Jt_x["c"], Jt_x["q"], lam,
                                        lambda_initial, lambda_max_tries,
                                        active)
        (q2,) = _point_sum(self.shards, _sum_last(dp * dp, 2))
        n2 = dops.dot(dc, dc) + q2
        return GNResult(step={"c": -dc, "q": -dp}, norm2_step=n2, lam=lam,
                        ok=ok)


def schur_to_dense(JtJ: SchurJtJ) -> torch.Tensor:
    """The arrow system as a dense matrix (a test oracle)."""
    nc = JtJ.U.shape[0]
    W = JtJ.W.reshape(nc, -1)
    return torch.cat([torch.cat([JtJ.U, W], 1),
                      torch.cat([W.mT, block_diag(JtJ.V)], 1)], 0)


class SparseWSchurJtJ(NamedTuple):
    """Arrow system whose camera-point coupling is sparse: each point
    couples to k_obs cameras, and only those (cb, bs) blocks are stored.
    The dense SchurJtJ.W would be (nc, n_points, bs): 460 MB in float32 at
    ncam = 128, n_points = 50000. Camera-axis reductions are one-hot
    products and camera-axis broadcasts gathers, both deterministic. A
    batch of systems carries a leading batch axis on every field but
    cam_of, which is (n_points, k_obs) when the elements share one rig and
    (B, n_points, k_obs) otherwise (torch.func.vmap of the products gives
    the second form)."""
    U: torch.Tensor       # (..., nc, nc) dense camera block (nc = ncam * cb)
    Wv: torch.Tensor      # (..., n_points, k_obs, cb, bs) nonzero W blocks
    cam_of: torch.Tensor  # ([B,] n_points, k_obs) int: each block's camera
    V: torch.Tensor       # (..., n_points, bs, bs) point diagonal blocks


@dataclasses.dataclass(frozen=True)
class SparseWSchurNewtonSolver:
    """Schur elimination of the point blocks for a SparseWSchurJtJ, over
    tree states {"c": (nc,), "q": (n_points, bs)}, or a batch of B
    independent problems: states {"c": (B, nc), "q": (B, n_points, bs)},
    every JtJ field (B, ...), lam (B,). A batch returns a per-element ok
    and lam, and each element escalates lambda on its own (the masked
    batched solver's `active`).

    S = U + lam I - sum_p F_p F_p^T with
    F[p, c cb + i, j] = sum_k onehot(cam_of[p, k], c) (Wv[p, k] Lv_p^{-T}),
    one one-hot product and one matmul, no scatter. Where F would exceed
    s_chunk_limit elements (the whole batch's F counts), S accumulates
    over chunks of points (a Python loop in place of the JAX package's
    lax.scan), and so does every camera reduction (onehot_cam_reduce):
    chunking changes only the order of summation. cam_gather, from
    build_cam_gather over the rig's cam_of, makes the refinement's camera
    rows fully compensated; without it they are a plain product in the
    working precision (TF32 off).

    shards: as SchurNewtonSolver's. On a point-sharded problem every
    camera reduction, S's chunked accumulation (with the point blocks' ok,
    one all_reduce a lambda try) and quad_form's point terms are summed
    over the mesh axis; the chunks count a rank's points; cam_gather is
    built over the rank's own cam_of."""
    nc: int
    n_points: int
    block_size: int
    k_obs: int
    cam_block: int = 6
    s_chunk_limit: int = 1 << 24
    refine_iters: int = 0
    cam_gather: Any = None
    shards: Any = dataclasses.field(default=None, repr=False, compare=False)

    @property
    def ncam(self) -> int:
        return self.nc // self.cam_block

    def _cam_reduce(self, JtJ: SparseWSchurJtJ, vals):
        """(..., nc): the camera rows of W v from the (..., n_points,
        k_obs, cb) block products vals, per element of a batch."""
        out = onehot_cam_reduce(JtJ.cam_of, vals, self.ncam,
                                chunk_limit=self.s_chunk_limit,
                                batched=vals.dim() > 3)
        (out,) = _point_sum(self.shards, out)
        return out.flatten(-2)

    def _gather_cams(self, JtJ: SparseWSchurJtJ, vc):
        """(..., n_points, k_obs, cb): each block's camera slice of vc."""
        vcr = vc.reshape(vc.shape[:-1] + (self.ncam, self.cam_block))
        cam = JtJ.cam_of
        if vc.dim() == 1:
            return vcr[cam]
        if cam.dim() == 2:
            return vcr[:, cam]
        rows = torch.arange(vc.shape[0], device=vc.device)
        return vcr[rows[:, None, None], cam]

    def quad_form(self, JtJ: SparseWSchurJtJ, v):
        vc, vp = v["c"], v["q"]
        uv = dops.dot(vc, _mv(JtJ.U, vc))
        vcg = self._gather_cams(JtJ, vc)
        wv, vq = _point_sum(self.shards,
                            _sum_last(vcg[..., :, None] * JtJ.Wv
                                      * vp[..., :, None, None, :], 4),
                            _block_quad(JtJ.V, vp))
        return uv + 2.0 * wv + vq

    def factor(self, JtJ: SparseWSchurJtJ, lam):
        """Factorize JtJ + lam I once at a fixed lambda (no escalation):
        ((Lv, Ls), ok), SchurNewtonSolver.factor's contract, with the
        batch axis of lam (B,) leading every factor and ok. A
        point-sharded JtJ (DTensor fields, as a point-sharded solve's
        state and result hold it) factors over its mesh axis: Lv comes
        back sharded as V, Ls and ok replicated (the handle the analysis
        passes take, get_outlierness_factors_ba)."""
        if self.shards is None and tv.is_sharded(JtJ):
            from libdogleg_tpu_torch.parallel.points import sharded_factor
            return sharded_factor(self, JtJ, lam)
        dt, dev = JtJ.U.dtype, JtJ.U.device
        bs, nc = self.block_size, self.nc
        lam = torch.as_tensor(lam, dtype=dt, device=dev)
        Vhat = JtJ.V + lam[..., None, None, None] * torch.eye(
            bs, dtype=dt, device=dev)
        Lv, okb = smallchol.small_cholesky(Vhat)   # (..., np, bs, bs)
        ok_v = okb.reshape(lam.shape + (-1,)).all(-1)
        # B[p, k] = Wv[p, k] Lv_p^{-T}: solve Lv Y = Wv^T per block, Lv
        # broadcast over the k_obs axis
        B = smallchol.small_fwd_solve_mat(
            Lv[..., :, None, :, :], JtJ.Wv.transpose(-1, -2)).transpose(-1, -2)
        S = _s_start(self.shards, JtJ.U + lam[..., None, None] * torch.eye(
            nc, dtype=dt, device=dev))
        # F whole is (..., np, nc, bs), the size of the dense W this form
        # avoids: accumulate S over chunks of points whose F, over the
        # whole batch, is bounded
        n_points = JtJ.V.shape[-3]
        per_point = lam.numel() * nc * bs
        chunk = (n_points if n_points * per_point <= self.s_chunk_limit
                 else max(1, self.s_chunk_limit // per_point))
        cams = torch.arange(self.ncam, device=dev)
        lead = lam.shape
        for lo in range(0, n_points, chunk):
            Bc = B[..., lo:lo + chunk, :, :, :]
            E = (JtJ.cam_of[..., lo:lo + chunk, :, None] == cams).to(dt)
            n = Bc.shape[-4]
            F = E.transpose(-1, -2) @ Bc.reshape(lead + (n, self.k_obs, -1))
            F2 = (F.reshape(lead + (n, nc, bs)).transpose(-3, -2)
                  .reshape(lead + (nc, n * bs)))
            S = S - F2 @ F2.mT
        S, ok_v = _s_finish(self.shards, S, ok_v)
        Ls, ok_s = _cholesky_ok(S, lead)
        return (Lv, Ls), ok_v & ok_s

    def gauss_newton(self, JtJ: SparseWSchurJtJ, Jt_x, lam, *,
                     lambda_initial, lambda_max_tries,
                     active: Optional[torch.Tensor] = None) -> GNResult:
        rc, rp = Jt_x["c"], Jt_x["q"]
        (Lv, Ls), lam, ok = chol.escalating_lambda(
            lambda lm: self.factor(JtJ, lm),
            torch.as_tensor(lam, dtype=rc.dtype, device=rc.device),
            lambda_initial=lambda_initial, lambda_max_tries=lambda_max_tries,
            active=active)
        Wv = JtJ.Wv
        # the axes of a point's blocks, shifted past a batch axis (b = 1)
        b = rc.dim() - 1

        def vsolve(r):                                    # (..., np, bs)
            return smallchol.small_cho_solve_mat(Lv, r[..., None])[..., 0]

        def w_times(vp):                                  # (..., np, k, cb)
            return (Wv * vp[..., :, None, None, :]).sum(-1)

        def solve_pair(bc, bp):
            y = vsolve(bp)
            sc = chol.cholesky_solve(Ls, bc - self._cam_reduce(JtJ,
                                                               w_times(y)))
            scg = self._gather_cams(JtJ, sc)
            sp = vsolve(bp - (Wv * scg[..., None]).sum((-3, -2)))
            return sc, sp

        dc, dp = solve_pair(rc, rp)
        if self.refine_iters:
            # Point rows are fully compensated. Camera rows are compensated
            # through the static gather table when one is given; otherwise
            # their one-hot reduction rounds in the working precision.
            cg = self.cam_gather

            def resid(v):
                vc, vp = v
                if cg is not None:
                    tbl, msk = cg
                    hw, lw = comp.comp_contract(    # (..., np, k, cb) pairs
                        Wv, vp, reduce_axes=(b + 3,),
                        broadcast=lambda x: x[..., :, None, None, :])
                    zero = hw.new_zeros(())
                    H = torch.where(msk, hw.flatten(-3, -2)[..., tbl, :],
                                    zero)
                    E = torch.where(msk, lw.flatten(-3, -2)[..., tbl, :],
                                    zero)
                    hc, lc = comp.comp_reduce(H, E, axis=-2)
                    if self.shards is not None:
                        hc, lc = self.shards.sum_pair(hc, lc)
                    hc, lc = hc.flatten(-2), lc.flatten(-2)
                    h1, l1 = comp.comp_matvec(JtJ.U, vc)
                    hc, lc = comp.pair_add(hc, lc, h1, l1)
                    hc, lc = comp.pair_add_prod(hc, lc, lam[..., None], vc)
                    mc = comp.residual(rc, hc, lc)
                else:
                    mc = rc - (_mv(JtJ.U, vc) + lam[..., None] * vc
                               + self._cam_reduce(JtJ, w_times(vp)))
                h1, l1 = comp.comp_contract(
                    Wv, self._gather_cams(JtJ, vc),
                    reduce_axes=(b + 1, b + 2),
                    broadcast=lambda x: x[..., None])
                h2, l2 = comp.comp_contract(
                    JtJ.V, vp, reduce_axes=(b + 2,),
                    broadcast=lambda x: x[..., None, :])
                hp, lp = comp.pair_add(h1, l1, h2, l2)
                hp, lp = comp.pair_add_prod(hp, lp, lam[..., None, None], vp)
                return mc, comp.residual(rp, hp, lp)

            dc, dp = _refine((dc, dp), lambda r: solve_pair(*r), resid,
                             self.refine_iters)
        (q2,) = _point_sum(self.shards, _sum_last(dp * dp, 2))
        n2 = dops.dot(dc, dc) + q2
        return GNResult(step={"c": -dc, "q": -dp}, norm2_step=n2, lam=lam,
                        ok=ok)


def build_cam_gather(cam_of, ncam: int, device=None):
    """A static per-camera gather table over the flattened (n_points *
    k_obs) observation axis, for SparseWSchurNewtonSolver.cam_gather: the
    refinement's camera reduction then runs as a gather and a compensated
    pairwise sum. cam_of is read on the host (numpy or a tensor); slots
    padded out must name a valid camera and carry zero Wv blocks. Returns
    (tbl (ncam, width) int64, mask (ncam, width, 1) bool) on `device`
    (None: cam_of's device if it is a tensor, else the CUDA device). A
    point-sharded cam_of (a DTensor) gives the table of the rank's own
    points, the observation axis its solver sees."""
    from libdogleg_tpu_torch.device import resolve_device
    if hasattr(cam_of, "to_local"):
        cam_of = cam_of.to_local()
    if device is None and isinstance(cam_of, torch.Tensor):
        device = cam_of.device
    device = resolve_device(device)
    cam = (cam_of.cpu().numpy() if isinstance(cam_of, torch.Tensor)
           else np.asarray(cam_of)).reshape(-1)
    if not np.all((cam >= 0) & (cam < ncam)):
        raise ValueError(
            "build_cam_gather: cam_of entries must be in [0, ncam); pad "
            "invalid observation slots with a valid camera id and zero Wv "
            "blocks")
    order = np.argsort(cam, kind="stable")
    counts = np.bincount(cam, minlength=ncam)
    width = max(1, int(counts.max()))
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    col = np.arange(cam.size) - np.repeat(starts, counts)
    tbl = np.zeros((ncam, width), np.int64)
    msk = np.zeros((ncam, width), bool)
    tbl[cam[order], col] = order
    msk[cam[order], col] = True
    return (torch.as_tensor(tbl, device=device),
            torch.as_tensor(msk[..., None], device=device))


def onehot_cam_reduce(cam_of: torch.Tensor, vals: torch.Tensor, ncam: int,
                      chunk_limit: int = 1 << 24, *,
                      batched: bool = False) -> torch.Tensor:
    """out[c] = sum over (p, k) with cam_of[p, k] == c of vals[p, k], for
    vals (n_points, k_obs, ...): a one-hot matmul (deterministic, no
    atomics), over chunks of points so that the one-hot selector never
    exceeds chunk_limit elements. batched=True takes vals (B, n_points,
    k_obs, ...) and reduces each element on its own into (B, ncam, ...),
    with cam_of (n_points, k_obs) shared or (B, n_points, k_obs); the
    selector's bound then counts the whole batch."""
    dt = vals.dtype
    n_points, k_obs = cam_of.shape[-2:]
    lead = vals.shape[:1] if batched else ()
    trailing = vals.shape[len(lead) + 2:]
    v2 = vals.reshape(lead + (n_points * k_obs, -1))
    cams = torch.arange(ncam, device=cam_of.device)
    flat = cam_of.reshape(cam_of.shape[:-2] + (-1,))
    per_point = math.prod(lead) * k_obs * ncam
    rows = (n_points if n_points * per_point <= chunk_limit
            else max(1, chunk_limit // per_point)) * k_obs
    out = None
    for lo in range(0, n_points * k_obs, rows):
        E = (flat[..., lo:lo + rows, None] == cams).to(dt)
        part = E.mT @ v2[..., lo:lo + rows, :]
        out = part if out is None else out + part
    return out.reshape(lead + (ncam,) + trailing)
