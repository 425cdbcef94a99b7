"""Outlierness factors, outlier marking, and query-point confidence
(counterpart of libdogleg_tpu/analysis/outlierness.py).

The reference's analysis suite (reference dogleg.c:1826-3149): Cook's-D
family leverage factors from the factorized JtJ,

    A = J* inv(JtJ) J*^T      (per feature: a featureSize x featureSize block)
    B = inv(A - I)
    factor = k * x*^T (B + B^2) x*        (Cook's self+others, featureSize 2)
    factor = k * x*^2 / (1 - A)           (featureSize 1, dogleg.c:2319-2330)

with the scale k chosen so the outlier threshold is 1 (dogleg.c:2281-2289),
including the reference's k/8 hack (dogleg.c:2374-2378), kept for parity.

All measurements are solved at once as one triangular solve against the
factor, and the per-feature blocks are one batched product; featureSize is
unrestricted (the reference supports 1 and 2). Nothing here synchronizes
with the host but mark_outliers and report_outliers, which call back into
user code: inverses are torch.linalg.inv_ex (torch.linalg.inv checks its
info on the host and raises on a singular matrix, where the determinant
guard below is what decides), and a failed factorization stays a device
flag (NaN factors, never a bool()).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from libdogleg_tpu_torch.ops import smallchol
from libdogleg_tpu_torch.ops import treevec as tv
from libdogleg_tpu_torch.ops.cholesky import cholesky_solve

# The reference marks an outlier only if removing it costs < 5% confidence
# (dogleg.c:3015).
OUTLIER_CONFIDENCE_DROP_THRESHOLD = 0.05


def get_outlierness_scale(norm2_x,
                          nmeasurements: int,
                          nstate: int,
                          n_outlier_features: int = 0,
                          feature_size: int = 1):
    """Normalization scale so the outlierness threshold is 1.0 (reference
    getOutliernessScale, dogleg.c:2381-2399):
      scale = Nnon / (4 (Nstate+1) norm2_x / (Nnon - Nstate - 1))
    with Nnon = measurements not already marked as outliers."""
    n_non = nmeasurements - n_outlier_features * feature_size
    return n_non / (4.0 * ((nstate + 1) * norm2_x / (n_non - nstate - 1)))


def pseudoinverse_rows(J: torch.Tensor, L: Optional[torch.Tensor],
                       solve_fn=None) -> torch.Tensor:
    """pinv(J) = inv(JtJ) J^T for all measurements at once, given the lower
    Cholesky factor L of JtJ (+ lambda): one triangular solve with nmeas
    right-hand sides (the reference solves chunks of 4, dogleg.c:1826-1921).
    solve_fn replaces the dense factor: any (nstate, k) right-hand side ->
    solution map for JtJ, such as
    `lambda r: sparse_cholesky.solve(sym, L_blocks, r)`.
    Returns (nstate, nmeas)."""
    if solve_fn is not None:
        return solve_fn(J.T)
    return cholesky_solve(L, J.T)


def _feature_blocks(x: torch.Tensor, J: torch.Tensor, L, feature_size: int,
                    solve_fn=None):
    """A_f = J_f inv(JtJ) J_f^T for every consecutive feature group
    (nf, fs, fs), and the residuals grouped (nf, fs)."""
    nmeas, nstate = J.shape
    nf = nmeas // feature_size
    W = pseudoinverse_rows(J, L, solve_fn)                # (nstate, nmeas)
    Jr = J.reshape(nf, feature_size, nstate)
    Wr = W.reshape(nstate, nf, feature_size).permute(1, 0, 2)
    return Jr @ Wr, x.reshape(nf, feature_size)


def _cooks_fs2(a00, a01, a11, x0, x1):
    """Cook's self+others closed 2x2 form (reference dogleg.c:2332-2365):
    the unscaled factor and the singular-leverage flag, elementwise over any
    batch shape. Shared by the dense-J and the bundle-adjustment paths."""
    det = (1.0 - a00) * (1.0 - a11) - a01 * a01
    b00 = a11 - 1.0
    b11 = a00 - 1.0
    b01 = -a01
    xBx = (x0 * x0 * b00 + 2.0 * x0 * x1 * b01 + x1 * x1 * b11) / det
    v1 = x0 * b00 + x1 * b01
    v2 = x0 * b01 + x1 * b11
    xBBx = (v1 * v1 + v2 * v2) / (det * det)
    return xBx + xBBx, det.abs() < 1e-8


def _eye_like(n: int, t: torch.Tensor) -> torch.Tensor:
    return torch.eye(n, dtype=t.dtype, device=t.device)


def get_outlierness_factors(x: torch.Tensor,
                            J: torch.Tensor,
                            L: Optional[torch.Tensor],
                            *,
                            feature_size: int = 1,
                            n_outlier_features: int = 0,
                            scale=None,
                            solve_fn=None):
    """Outlierness factor per feature (reference
    dogleg_getOutliernessFactors, dogleg.c:2621-2667). Factors > 1.0 are
    outlier candidates.

    Args:
      x: (nmeas,) residuals at the operating point.
      J: (nmeas, nstate) dense Jacobian.
      L: lower Cholesky factor of JtJ (+ permanent lambda), e.g.
        factorize_jtj(result.JtJ, result.lam).L; None with solve_fn.
      feature_size: measurements per feature (any size; reference: 1 or 2).
      n_outlier_features: already-marked outliers, excluded from the scale.
      scale: reuse a previously computed scale if not None (the reference's
        scale<0-means-recompute convention, dogleg.h:337).
      solve_fn: a JtJ solve used instead of the dense factor, e.g. the
        block-sparse factor of a large problem,
        `lambda r: sparse_cholesky.solve(sym, L_blocks, r)`.

    Returns (factors (nfeatures,), scale). Singular leverage returns the
    dtype's largest value, unscaled.
    """
    nmeas, nstate = J.shape
    big = torch.finfo(J.dtype).max  # the reference's DBL_MAX sentinel
    if scale is None:
        scale = get_outlierness_scale(torch.dot(x, x), nmeas, nstate,
                                      n_outlier_features, feature_size)
    A, xr = _feature_blocks(x, J, L, feature_size, solve_fn)

    if feature_size == 1:
        # x^2 / (1 - A), guarded like the reference (dogleg.c:2319-2330)
        denom = 1.0 - A[:, 0, 0]
        singular = denom.abs() < 1e-8
        raw = xr[:, 0] * xr[:, 0] / denom
    elif feature_size == 2:
        raw, singular = _cooks_fs2(A[:, 0, 0], A[:, 0, 1], A[:, 1, 1],
                                   xr[:, 0], xr[:, 1])
    else:
        # any featureSize (beyond the reference): the same Cook's
        # self+others through a batched inverse of (A - I), guarded by
        # |det(A - I)| < 1e-8; the inverse of a singular block is masked
        AmI = A - _eye_like(feature_size, A)
        B = torch.linalg.inv_ex(AmI).inverse
        Bx = (B @ xr[..., None])[..., 0]
        singular = torch.linalg.det(AmI).abs() < 1e-8
        raw = (xr * Bx).sum(-1) + (Bx * Bx).sum(-1)

    # Singular leverage means "definitely an outlier": the sentinel is
    # returned unscaled, as the reference's early returns skip the k
    # multiplication (dogleg.c:2325, 2336).
    k = scale / 8.0
    return torch.where(singular, big, raw * k), scale


class MarkResult(NamedTuple):
    marked: np.ndarray        # (nfeatures,) bool
    n_outliers: int
    marked_any: bool


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def mark_outliers(factors,
                  get_confidence: Callable[[int], float],
                  marked: Optional[np.ndarray] = None) -> MarkResult:
    """Accept factor>1 candidates as outliers iff removing them drops the
    user-supplied confidence by less than 5% (reference dogleg_markOutliers,
    dogleg.c:3016-3100). get_confidence(i) returns the solution confidence
    with feature i excluded; get_confidence(-1) is the baseline. Host-side
    Python: the callback typically re-solves the problem."""
    factors = _host(factors)
    marked = (np.zeros(factors.shape[0], bool) if marked is None
              else np.asarray(marked).copy())
    confidence0 = float(get_confidence(-1))
    if confidence0 < 0.0:
        return MarkResult(marked, int(marked.sum()), False)

    marked_any = False
    n_outliers = 0
    for i in range(factors.shape[0]):
        if marked[i]:
            n_outliers += 1
            continue
        if factors[i] < 1.0:
            continue
        confidence_excluded = float(get_confidence(i))
        if confidence_excluded < 0.0:
            return MarkResult(marked, n_outliers, marked_any)
        drop = 1.0 - confidence_excluded / confidence0
        if drop < OUTLIER_CONFIDENCE_DROP_THRESHOLD:
            marked[i] = True
            marked_any = True
            n_outliers += 1
    return MarkResult(marked, n_outliers, marked_any)


def report_outliers(factors, get_confidence) -> str:
    """Every feature's factor and the relative confidence drop were it
    removed (reference dogleg_reportOutliers, dogleg.c:3106-3149). Slow by
    design: it calls get_confidence per feature."""
    factors = _host(factors)
    lines = ["## Outlier statistics",
             "# i_feature outlier_factor confidence_drop_relative_if_removed"]
    confidence_full = float(get_confidence(-1))
    for i in range(factors.shape[0]):
        drop = 1.0 - float(get_confidence(i)) / confidence_full
        lines.append(f"{i:5d} {factors[i]:9.3g} {drop:9.3g}")
    return "\n".join(lines) + "\n"


def outlierness_trace_new_feature(Jq: torch.Tensor,
                                  L: Optional[torch.Tensor],
                                  norm2_x,
                                  nmeasurements: int,
                                  *,
                                  n_outlier_features: int = 0,
                                  solve_fn=None):
    """Expected outlierness of a hypothetical new feature, the query-point
    confidence metric (reference
    dogleg_getOutliernessTrace_newFeature_sparse, dogleg.c:2793-3012).

    Given the would-be feature Jacobian Jq (feature_size, nstate), computes
    A = Jq inv(JtJ) Jq^T, B = inv(A + I), and returns
    scale * (feature_size - trace(B)): the reference's scale*(2 - traceB)
    (dogleg.c:3005-3006) for any feature_size.
    """
    feature_size, nstate = Jq.shape
    W = solve_fn(Jq.T) if solve_fn is not None else \
        cholesky_solve(L, Jq.T)                      # (nstate, fs)
    A = Jq @ W
    B = torch.linalg.inv_ex(A + _eye_like(feature_size, A)).inverse
    scale = get_outlierness_scale(norm2_x, nmeasurements, nstate,
                                  n_outlier_features, feature_size)
    return scale * (feature_size - torch.trace(B))


def outlierness_trace_new_features_windowed(Jq_win: torch.Tensor,
                                            istate_active: torch.Tensor,
                                            L: Optional[torch.Tensor],
                                            norm2_x,
                                            nmeasurements: int,
                                            *,
                                            nstate: int = None,
                                            n_outlier_features: int = 0,
                                            solve_fn=None):
    """Windowed, batched query-point confidence: the reference's
    istateActive/NstateActive window (dogleg.c:2794-2842) for many
    hypothetical features at once, against one factor solve.

    Args:
      Jq_win: (nq, fs, w) query Jacobians, each touching only its w
        consecutive states (pad with zeros for narrower queries).
      istate_active: (nq,) int window starts.
      L: lower Cholesky factor of JtJ (+ permanent lambda), or None when
        solve_fn is given.
      nstate: required when solve_fn is given (otherwise from L).
      solve_fn: an (nstate, k) right-hand side JtJ solve used instead of L.

    Returns (nq,) traces scale * (fs - trace(inv(A_q + I))), those of the
    dense form on the zero-padded Jq. Window columns outside [0, nstate)
    count as exactly zero, so a query entirely out of range returns 0.
    """
    nq, fs, w = Jq_win.shape
    n = L.shape[-1] if L is not None else nstate
    if n is None:
        raise ValueError("pass nstate when using solve_fn without L")
    dev = Jq_win.device
    istate = torch.as_tensor(istate_active, device=dev)
    idx = istate[:, None] + torch.arange(w, device=dev)      # (nq, w)
    valid = (idx >= 0) & (idx < n)
    qrow = torch.arange(nq, device=dev)[:, None]

    # Scatter every window into one (nstate, nq*fs) right-hand side: one
    # solve against the factor (the reference re-solves per query,
    # dogleg.c:2864-2868). Invalid rows go to the spare row n, which is cut
    # off; the valid rows of one query are distinct.
    rows = torch.where(valid[..., None], Jq_win.transpose(1, 2), 0.0)
    rhs = Jq_win.new_zeros((nq, n + 1, fs))
    rhs[qrow, torch.where(valid, idx, n)] = rows
    rhs_flat = rhs[:, :n].permute(1, 0, 2).reshape(n, nq * fs)
    W = solve_fn(rhs_flat) if solve_fn is not None else \
        cholesky_solve(L, rhs_flat)                          # (nstate, nq*fs)
    Wq = W.reshape(n, nq, fs).permute(1, 0, 2)               # (nq, nstate, fs)

    # A_q = Jq_win @ W[window rows]: gather each query's w rows, those
    # outside [0, nstate) zero, as the scatter dropped them
    Wwin = torch.where(valid[..., None], Wq[qrow, torch.where(valid, idx, 0)],
                       0.0)                                  # (nq, w, fs)
    A = Jq_win @ Wwin
    B = torch.linalg.inv_ex(A + _eye_like(fs, A)).inverse
    traceB = torch.diagonal(B, dim1=-2, dim2=-1).sum(-1)     # (nq,)
    scale = get_outlierness_scale(norm2_x, nmeasurements, n,
                                  n_outlier_features, fs)
    return scale * (fs - traceB)


def get_outlierness_factors_ba(x_obs: torch.Tensor,
                               Jc: torch.Tensor,
                               Jq: torch.Tensor,
                               JtJ,
                               lam,
                               norm2_x,
                               nmeasurements: int,
                               solver,
                               *,
                               n_outlier_features: int = 0,
                               scale=None,
                               chunk: int = 4096,
                               factorization=None):
    """Observation-level outlierness factors at bundle-adjustment scale.

    The featureSize-2 Cook's factors of get_outlierness_factors (one
    feature per observation, the reference's camera-calibration usage,
    dogleg.c:2318-2371) from the sparse-visibility structure: each
    observation touches one camera block and one 3-dof point block, so
    A_f = J_f inv(JtJ) J_f^T needs only the covariance sub-block at
    (camera c, point p), assembled from the Schur factors by

        Sigma_cc = S^{-1}
        Sigma_cq[:, p] = -S^{-1} T_p,      T_p = W_p Vhat_p^{-1}
        Sigma_qq[p]    = Vhat_p^{-1} + T_p^T S^{-1} T_p

    over chunks of points (a Python loop whose last chunk is shorter);
    nothing nstate-sized exists beyond the nc x nc S^{-1}.

    Args:
      x_obs: (np, k_obs, 2) reprojection residuals at the operating point.
      Jc: (np, k_obs, 2, cb) camera Jacobians; Jq: (np, k_obs, 2, 3) point
        Jacobians (SparseVisibilityPinholeBA.observation_jacobians).
      JtJ: the SparseWSchurJtJ at the operating point.
      lam: the solve's permanent lambda (SolveResult.lam).
      norm2_x: total norm2 of all residuals, priors included.
      nmeasurements: total measurement count, prior rows included.
      solver: the SparseWSchurNewtonSolver.
      factorization: ((Lv, Ls), ok) from solver.factor(JtJ, lam), to reuse
        one factorization across passes (the reference reuses its cached
        factorization, dogleg.c:2636-2652); computed here if None.

    Returns (factors (np, k_obs), scale): factors > 1 are candidates, the
    dtype's largest value marks singular leverage, and all are NaN when the
    factorization failed (ok stays on the device).

    Over sharded points (the JAX package's pass under GSPMD): x_obs, Jc and
    Jq DTensors sharded over a mesh axis on the point axis, as a
    point-sharded instance's observation_jacobians gives them, and the
    JtJ, lam, norm2_x and a factorization as a point-sharded solve's
    result and solver.factor give them (DTensors) or the rank's local
    blocks. Every rank of the axis calls it. S is factored over the axis
    (one all_reduce, none with a factorization), nstate counts the global
    points, each rank's chunks run over its own points, and the factors
    come back sharded as x_obs; the scale is the same bits on every rank.
    A point's factor depends only on its rows and S^-1, so a world of one
    gives the unsharded pass's bits.
    """
    shards, ranks = None, 1
    if tv.is_sharded((x_obs, Jc, Jq, JtJ)):
        from libdogleg_tpu_torch.parallel.mesh import axis_size
        from libdogleg_tpu_torch.parallel.points import (PointShards,
                                                         local_of,
                                                         sharding_of)
        axis = sharding_of(x_obs, Jc, Jq, JtJ.V)
        if axis is None:
            raise ValueError("a point-sharded outlierness pass takes x_obs, "
                             "Jc, Jq or JtJ.V sharded over a mesh axis")
        shards, ranks = PointShards(*axis, ()), axis_size(*axis)
        x_obs, Jc, Jq, lam, norm2_x, scale = (
            local_of(t) for t in (x_obs, Jc, Jq, lam, norm2_x, scale))
        JtJ = type(JtJ)(*(local_of(t) for t in JtJ))
        if factorization is not None:
            (Lv, Ls), ok = factorization
            factorization = ((local_of(Lv), local_of(Ls)), local_of(ok))
        solver = dataclasses.replace(solver, shards=shards)
    dt, dev = x_obs.dtype, x_obs.device
    n_points, k_obs = JtJ.cam_of.shape
    nc, cb, ncam = solver.nc, solver.cam_block, solver.ncam
    bs = JtJ.V.shape[-1]
    big = torch.finfo(dt).max

    (Lv, Ls), ok = (factorization if factorization is not None
                    else solver.factor(JtJ, torch.as_tensor(lam, dtype=dt,
                                                            device=dev)))
    Sinv = cholesky_solve(Ls, _eye_like(nc, Ls))                # (nc, nc)
    # Sb4[c, d, i, j] = Sinv[c cb + i, d cb + j]
    Sb4 = Sinv.reshape(ncam, cb, ncam, cb).permute(0, 2, 1, 3)
    eye_bs = _eye_like(bs, Lv)
    cams = torch.arange(ncam, device=dev)

    # hazard F22: the scale counts every point, not the rank's (blocks of
    # one size)
    nstate = nc + n_points * ranks * bs
    if scale is None:
        scale = get_outlierness_scale(norm2_x, nmeasurements, nstate,
                                      n_outlier_features, 2)
    k = scale / 8.0

    out = []
    for lo in range(0, n_points, chunk):
        hi = min(lo + chunk, n_points)
        n = hi - lo
        camc = JtJ.cam_of[lo:hi]
        xc, Jcc, Jqc = x_obs[lo:hi], Jc[lo:hi], Jq[lo:hi]
        Vinv = smallchol.small_cho_solve_mat(Lv[lo:hi], eye_bs)  # (n, 3, 3)
        Tb = JtJ.Wv[lo:hi] @ Vinv[:, None]                       # (n,k,cb,3)
        # T_p spread over the cameras by a one-hot product: (n, nc, 3)
        E = (camc[..., None] == cams).to(dt)                     # (n, k, ncam)
        T = (E.transpose(1, 2) @ Tb.reshape(n, k_obs, cb * bs)
             ).reshape(n, nc, bs)
        # Z_p = S^{-1} T_p for every point of the chunk in one product
        Z = (Sinv @ T.permute(1, 0, 2).reshape(nc, n * bs)
             ).reshape(nc, n, bs).permute(1, 0, 2)               # (n, nc, 3)
        Sqq = Vinv + T.transpose(1, 2) @ Z                       # (n, 3, 3)
        rows = torch.arange(n, device=dev)[:, None]
        Scq = -Z.reshape(n, ncam, cb, bs)[rows, camc]            # (n,k,cb,3)
        Scc = Sb4[camc, camc]                                    # (n,k,cb,cb)
        # A_f = Jc Scc Jc^T + X + X^T + Jq Sqq Jq^T, X = Jc Scq Jq^T
        X = Jcc @ Scq @ Jqc.transpose(-1, -2)
        A = (Jcc @ Scc @ Jcc.transpose(-1, -2) + X + X.transpose(-1, -2)
             + Jqc @ Sqq[:, None] @ Jqc.transpose(-1, -2))
        raw, singular = _cooks_fs2(A[..., 0, 0], A[..., 0, 1], A[..., 1, 1],
                                   xc[..., 0], xc[..., 1])
        out.append(torch.where(singular, big, raw * k))
    factors = torch.cat(out) if len(out) > 1 else out[0]
    ok = torch.as_tensor(ok, device=dev)
    # the reference returns false when the factorization fails
    # (dogleg_getOutliernessFactors); here every factor is NaN
    factors = torch.where(ok, factors, torch.nan)
    if shards is not None:
        from libdogleg_tpu_torch.parallel.batched import _from_local
        factors = _from_local(factors, shards.mesh, shards.axis_name)
    return factors, scale
