"""Nonlinear pinhole-camera bundle adjustment (counterpart of
libdogleg_tpu/models/pinhole_ba.py).

libdogleg was written for camera calibration and structure from motion
(reference README.pod:5-15; its companion project mrcal). ncam pinhole
cameras with axis-angle poses (6 dof each) observe npts 3-D points; the
residuals are 2-D reprojection errors. States are trees:

    p = {"c": (ncam * 6,) camera poses, "q": (npts, 3) points}

Every observation's (2, 6) camera and (2, 3) point Jacobian comes from
forward-mode differentiation of the projection (torch.func.jacfwd, vmapped
over observations), and the arrow system is solved by Schur elimination of
the points. The gauge is fixed by a strong prior on camera 0's pose and a
weak prior on all points.

Every reduction is deterministic on the card: over the full-visibility grid
and over the points of the sparse form they are matmuls, the camera axis of
the sparse form is a one-hot product (ops/newton.onehot_cam_reduce), and
the generic observation list sums each segment over a gather table built
once at construction. None uses index_add_, whose CUDA float atomics sum in
no fixed order.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from libdogleg_tpu_torch.device import resolve_device
from libdogleg_tpu_torch.ops.newton import (SchurJtJ, SparseWSchurJtJ,
                                            SparseWSchurNewtonSolver,
                                            TreeSchurNewtonSolver,
                                            block_diag, build_cam_gather,
                                            onehot_cam_reduce)
from libdogleg_tpu_torch.solver import Products


def rodrigues(r, v):
    """Rotate v by the axis-angle vector r (Rodrigues' formula), over
    leading axes. Near r = 0 the expanded small-angle form v + r x v is
    taken, whose derivatives stay finite there."""
    theta2 = (r * r).sum(-1, keepdim=True)
    theta = torch.sqrt(theta2 + 1e-24)
    k = r / theta
    c, s = torch.cos(theta), torch.sin(theta)
    rotated = (v * c + torch.cross(k, v, dim=-1) * s
               + k * (k * v).sum(-1, keepdim=True) * (1.0 - c))
    return torch.where(theta2 < 1e-16, v + torch.cross(r, v, dim=-1),
                       rotated)


def project(cam, point, focal):
    """Pinhole projection of 3-D points through cameras cam = (rvec(3),
    tvec(3)), over leading axes: (..., 2) pixel coordinates."""
    pc = rodrigues(cam[..., :3], point) + cam[..., 3:]
    return focal * pc[..., :2] / pc[..., 2:3]


def observation_terms(cams, points, obs, focal):
    """Residual r (n, 2), camera Jacobian Jc (n, 2, 6) and point Jacobian
    Jq (n, 2, 3) of n observations, Jacobians by forward mode."""
    jac = torch.func.vmap(torch.func.jacfwd(
        lambda c, q: project(c, q, focal), argnums=(0, 1)))
    Jc, Jq = jac(cams, points)
    return project(cams, points, focal) - obs, Jc, Jq


def _assemble(ba, p, r, gc_blk, gq_obs, U_blk, V_obs, W, pts_prior=None,
              axis=None):
    """(norm2_x, Jt_x, U, V, W) from the observations' residuals and sums
    (camera gradient blocks (ncam, 6), point gradients (npts, 3), camera
    blocks (ncam, 6, 6), point blocks (npts, 3, 3), the coupling) and the
    two priors: the gauge prior on camera 0 and the weak point prior.

    A point-sharded instance passes its rank's points (p["q"], pts_prior,
    the observations' sums) and axis, its (mesh, axis name): the point
    terms of the cost and the camera sums are summed over the axis in one
    all_reduce before camera 0's prior, which is replicated, enters them
    once."""
    c, q = p["c"], p["q"]
    pts_prior = ba.pts_prior if pts_prior is None else pts_prior
    dt, dev = c.dtype, c.device
    w0 = torch.as_tensor(ba.w_prior_cam0, dtype=dt, device=dev)
    wp = torch.as_tensor(ba.w_prior_pts, dtype=dt, device=dev)
    r_cam0 = torch.sqrt(w0) * (c[:6] - ba.cam0_prior)
    r_pts = torch.sqrt(wp) * (q - pts_prior)
    n2_obs, n2_pts = (r * r).sum(), (r_pts * r_pts).sum()
    if axis is not None:
        from libdogleg_tpu_torch.parallel.sharded import all_reduce_sum
        n2_obs, n2_pts, gc_blk, U_blk = all_reduce_sum(
            [n2_obs, n2_pts, gc_blk, U_blk], *axis)
    norm2_x = n2_obs + (r_cam0 * r_cam0).sum() + n2_pts
    gc = gc_blk.reshape(-1).clone()
    gc[:6] += w0 * (c[:6] - ba.cam0_prior)
    gq = gq_obs + wp * (q - pts_prior)
    U = block_diag(U_blk)
    U[:6, :6] += w0 * torch.eye(6, dtype=dt, device=dev)
    V = V_obs + wp * torch.eye(3, dtype=dt, device=dev)
    return norm2_x, {"c": gc, "q": gq}, U, V, W


def _segment_sum(vals, gather):
    """Sum of vals (n, ...) over each segment of a (table, mask) from
    build_cam_gather: (n_segments, ...), each segment in ascending order."""
    tbl, msk = gather
    m = msk.reshape(msk.shape[:2] + (1,) * (vals.dim() - 1))
    return torch.where(m, vals[tbl], vals.new_zeros(())).sum(1)


def _jitter_start(ba, generator, jitter, dtype):
    """p_true + jitter N(0, 1), drawn from `generator` on its own device and
    moved to the instance's, so one CPU generator gives one start on every
    device."""
    if generator is None:
        raise ValueError("a jittered start needs a torch.Generator")
    dev = ba.obs.device

    def draw(t):
        return (t.to(dtype) + jitter * torch.randn(
            t.shape, generator=generator, dtype=dtype,
            device=generator.device).to(dev))
    return {"c": draw(ba.p_true["c"]), "q": draw(ba.p_true["q"])}


def _prior_start(ba, dtype):
    c0 = torch.zeros((ba.ncam * 6,), dtype=dtype, device=ba.obs.device)
    c0[:6] = ba.cam0_prior.to(dtype)
    return {"c": c0, "q": ba.pts_prior.to(dtype)}


@dataclasses.dataclass(frozen=True)
class PinholeBA:
    ncam: int
    npts: int
    focal: float
    cam_idx: torch.Tensor     # (nobs,) int64 camera of each observation
    pt_idx: torch.Tensor      # (nobs,) int64 point of each observation
    obs: torch.Tensor         # (nobs, 2) observed pixels
    w_prior_cam0: float       # pins camera 0 (gauge)
    w_prior_pts: float        # weak depth/scale prior
    cam0_prior: torch.Tensor  # (6,) the pose camera 0 is pinned to
    pts_prior: torch.Tensor   # (npts, 3) prior point positions
    p_true: dict              # generating state {"c", "q"}
    # decided once here from the host indices: whether the observations are
    # the cam-major full-visibility grid (make_synthetic's layout), and for
    # any other list the segment tables of the generic products
    dense_grid: bool = dataclasses.field(init=False, compare=False)
    _gathers: Optional[tuple] = dataclasses.field(
        init=False, repr=False, compare=False)

    def __post_init__(self):
        ci = self.cam_idx.cpu().numpy()
        pi = self.pt_idx.cpu().numpy()
        grid = bool(ci.shape[0] == self.ncam * self.npts
                    and (ci == np.repeat(np.arange(self.ncam),
                                         self.npts)).all()
                    and (pi == np.tile(np.arange(self.npts),
                                       self.ncam)).all())
        gathers = None
        if not grid:
            dev = self.obs.device
            gathers = (build_cam_gather(ci, self.ncam, dev),
                       build_cam_gather(pi, self.npts, dev),
                       build_cam_gather(ci * self.npts + pi,
                                        self.ncam * self.npts, dev))
        object.__setattr__(self, "dense_grid", grid)
        object.__setattr__(self, "_gathers", gathers)

    @property
    def nobs(self) -> int:
        return int(self.obs.shape[0])

    @property
    def nstate(self) -> int:
        return self.ncam * 6 + self.npts * 3

    def residuals_obs(self, p):
        cams = p["c"].reshape(self.ncam, 6)
        proj = project(cams[self.cam_idx], p["q"][self.pt_idx], self.focal)
        return (proj - self.obs).reshape(-1)

    def _products_grid(self, p, obs) -> Products:
        """The arrow system over the (ncam, npts) grid of full visibility:
        every (camera, point) pair exists, so every reduction is an einsum
        and W a transpose."""
        ncam, npts = self.ncam, self.npts
        cams = p["c"].reshape(ncam, 6)
        r, Jc, Jq = observation_terms(
            cams[:, None, :].expand(ncam, npts, 6).reshape(-1, 6),
            p["q"][None].expand(ncam, npts, 3).reshape(-1, 3),
            obs, self.focal)
        r = r.reshape(ncam, npts, 2)
        Jc = Jc.reshape(ncam, npts, 2, 6)
        Jq = Jq.reshape(ncam, npts, 2, 3)
        n2, g, U, V, W = _assemble(
            self, p, r, torch.einsum('cpij,cpi->cj', Jc, r),
            torch.einsum('cpij,cpi->pj', Jq, r),
            torch.einsum('cpij,cpik->cjk', Jc, Jc),
            torch.einsum('cpij,cpik->pjk', Jq, Jq),
            torch.einsum('cpij,cpik->cjpk', Jc, Jq).reshape(
                ncam * 6, npts, 3))
        return Products(norm2_x=n2, Jt_x=g, JtJ=SchurJtJ(U=U, W=W, V=V))

    def products(self, p) -> Products:
        """Per-observation Jacobians summed into the arrow system; the
        full-visibility grid takes _products_grid, any other observation
        list the segment sums."""
        return self.products_obs(p, self.obs)

    def products_obs(self, p, obs) -> Products:
        """products at the observations obs (nobs, 2) in place of the
        instance's, with the layout decided at construction: the form
        torch.func.vmap batches over per-element observations
        (batched_optimize(ba.products_obs, p0, problem_data=obs_b)), as the
        JAX package's ba._replace(obs=obs_i).products does."""
        if self.dense_grid:
            return self._products_grid(p, obs)
        cams = p["c"].reshape(self.ncam, 6)
        r, Jc, Jq = observation_terms(cams[self.cam_idx],
                                      p["q"][self.pt_idx], obs, self.focal)
        by_cam, by_pt, by_pair = self._gathers
        Wc = _segment_sum(torch.einsum('oij,oik->ojk', Jc, Jq), by_pair)
        W = Wc.reshape(self.ncam, self.npts, 6, 3).permute(0, 2, 1, 3)
        n2, g, U, V, W = _assemble(
            self, p, r,
            _segment_sum(torch.einsum('oij,oi->oj', Jc, r), by_cam),
            _segment_sum(torch.einsum('oij,oi->oj', Jq, r), by_pt),
            _segment_sum(torch.einsum('oij,oik->ojk', Jc, Jc), by_cam),
            _segment_sum(torch.einsum('oij,oik->ojk', Jq, Jq), by_pt),
            W.reshape(self.ncam * 6, self.npts, 3))
        return Products(norm2_x=n2, Jt_x=g, JtJ=SchurJtJ(U=U, W=W, V=V))

    def newton_solver(self) -> TreeSchurNewtonSolver:
        return TreeSchurNewtonSolver(nc=self.ncam * 6, n_points=self.npts,
                                     block_size=3)

    def p0(self, generator: Optional[torch.Generator] = None,
           jitter: float = 0.0, dtype=None):
        """The prior points and zero poses (camera 0 at its prior); with
        jitter, the true state plus jitter N(0, 1) from `generator`."""
        dtype = dtype or self.obs.dtype
        if jitter:
            return _jitter_start(self, generator, jitter, dtype)
        return _prior_start(self, dtype)


def _ring_scene(rng, ncam: int, npts: int):
    """The JAX package's scene, in its order of draws: a point cloud near
    the origin, then per camera a small rotation on a ring at depth 6."""
    pts = rng.normal(size=(npts, 3)) * np.array([2.0, 2.0, 0.5])
    cams = []
    for i in range(ncam):
        ang = 2 * np.pi * i / ncam
        rvec = rng.normal(size=3) * 0.05
        tvec = np.array([1.5 * np.cos(ang), 1.5 * np.sin(ang), 6.0])
        cams.append(np.concatenate([rvec, tvec]))
    return pts, np.asarray(cams)


def _np_project(cams, pts, focal):
    """Rodrigues and the pinhole projection in numpy float64 for rows of
    cameras (n, 6) and points (n, 3); the exact form at r = 0."""
    r, t = cams[:, :3], cams[:, 3:]
    theta = np.linalg.norm(r, axis=-1, keepdims=True)
    k = r / np.where(theta < 1e-12, 1.0, theta)
    rot = (pts * np.cos(theta) + np.cross(k, pts) * np.sin(theta)
           + k * (k * pts).sum(-1, keepdims=True) * (1 - np.cos(theta)))
    pc = np.where(theta < 1e-12, pts, rot) + t
    return focal * pc[:, :2] / pc[:, 2:3]


def _instance_tensors(cams, pts, dtype, dev):
    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=dev)
    return dict(cam0_prior=t(cams[0]), pts_prior=t(pts),
                p_true={"c": t(cams.reshape(-1)), "q": t(pts)})


def make_synthetic(seed: int = 0, ncam: int = 6, npts: int = 200,
                   focal: float = 500.0, pixel_noise: float = 0.5,
                   dtype=torch.float64, device=None) -> PinholeBA:
    """Cameras on a ring looking at a point cloud near the origin; every
    camera observes every point. The JAX package's instance for `seed`, on
    `device` (None: the CUDA device)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    pts, cams = _ring_scene(rng, ncam, npts)
    cam_idx = np.repeat(np.arange(ncam), npts)
    pt_idx = np.tile(np.arange(npts), ncam)
    obs = (_np_project(cams[cam_idx], pts[pt_idx], focal)
           + rng.normal(size=(len(cam_idx), 2)) * pixel_noise)
    return PinholeBA(
        ncam=ncam, npts=npts, focal=focal,
        cam_idx=torch.as_tensor(cam_idx, device=dev),
        pt_idx=torch.as_tensor(pt_idx, device=dev),
        obs=torch.as_tensor(obs, dtype=dtype, device=dev),
        w_prior_cam0=1e6, w_prior_pts=1e-4,
        **_instance_tensors(cams, pts, dtype, dev))


@dataclasses.dataclass(frozen=True)
class SparseVisibilityPinholeBA:
    """Pinhole BA where point p is observed by the cameras cam_of[p, :]
    only (k_obs each): the coupling is stored as the k_obs nonzero blocks a
    point (SparseWSchurJtJ). Per-point reductions are einsums over the
    (npts, k_obs) grid, camera-axis reductions one-hot products, camera
    broadcasts gathers.

    Variable visibility is padding to k_obs slots with obs_mask zero on the
    extra ones: their residual and Jacobian rows are zeroed before every
    reduction, so the solve equals the unpadded problem's.

    Point-sharded: cam_of, obs, pts_prior and obs_mask given as DTensors
    sharded on the point axis over a mesh axis (parallel.batched.
    shard_batch; the JAX package's NamedSharding(mesh, P("pts")) on the
    same fields) and the start's p["q"] the same way. Each rank then works
    on its points: its rows of the residual, Jq, V and Wv, and its cam_of
    in the JtJ; the camera gradient, U and the cost are summed over the
    axis in one all_reduce an evaluation, and camera 0's gauge prior
    enters once. npts, nobs and nstate keep their global values; a solver
    from newton_solver() of the unsharded instance serves."""
    ncam: int
    npts: int
    k_obs: int
    focal: float
    cam_of: torch.Tensor      # (npts, k_obs) int64
    obs: torch.Tensor         # (npts, k_obs, 2)
    w_prior_cam0: float
    w_prior_pts: float
    cam0_prior: torch.Tensor  # (6,)
    pts_prior: torch.Tensor   # (npts, 3)
    p_true: dict
    obs_mask: Optional[torch.Tensor] = None  # (npts, k_obs) {0, 1}

    @property
    def nobs(self) -> int:
        return self.npts * self.k_obs

    @property
    def nstate(self) -> int:
        return self.ncam * 6 + self.npts * 3

    def _local(self, p, obs):
        """(p, cam_of, obs, pts_prior, obs_mask, axis) as this rank works on
        them: as given, or for a point-sharded instance the rank's points
        (a DTensor's local tensor, a whole obs's block) and axis the (mesh,
        axis name); None unsharded."""
        fields = (self.cam_of, self.pts_prior, self.obs_mask)
        axis = None
        if any(t is not None and type(t) is not torch.Tensor
               for t in fields + (obs,)):
            from libdogleg_tpu_torch.parallel.points import sharding_of
            axis = sharding_of(*fields, obs)
        if axis is None:
            return p, self.cam_of, obs, self.pts_prior, self.obs_mask, None
        from libdogleg_tpu_torch.parallel.mesh import local_rows
        from libdogleg_tpu_torch.parallel.points import local_of
        cam_of, pts_prior, mask = (None if t is None else local_rows(t, *axis)
                                   for t in fields)
        p = {k: local_of(v) for k, v in p.items()}
        if p["q"].shape[0] != cam_of.shape[0]:
            raise ValueError(
                f"a point-sharded SparseVisibilityPinholeBA takes the "
                f"state's point rows sharded as its own ({cam_of.shape[0]} "
                f"a rank), got {p['q'].shape[0]}")
        return p, cam_of, local_rows(obs, *axis), pts_prior, mask, axis

    def observation_jacobians(self, p, obs=None):
        """(r, Jc, Jq) per observation, (npts, k_obs, 2), (..., 2, 6),
        (..., 2, 3), at the observations obs (None: the instance's); masked
        slots come back zeroed. A point-sharded instance computes its
        rank's points and returns them as DTensors sharded over the
        instance's axis (get_outlierness_factors_ba reads the sharding
        from them)."""
        p, cam_of, obs, _, mask, axis = self._local(
            p, self.obs if obs is None else obs)
        out = self._jacobians(p, cam_of, obs, mask)
        if axis is None:
            return out
        from libdogleg_tpu_torch.parallel.batched import _from_local
        return tuple(_from_local(t, *axis) for t in out)

    def _jacobians(self, p, cam_of, obs, mask):
        npts, k = cam_of.shape
        cam_g = p["c"].reshape(self.ncam, 6)[cam_of]
        r, Jc, Jq = observation_terms(
            cam_g.reshape(-1, 6),
            p["q"][:, None, :].expand(npts, k, 3).reshape(-1, 3),
            obs.reshape(-1, 2), self.focal)
        r = r.reshape(npts, k, 2)
        Jc = Jc.reshape(npts, k, 2, 6)
        Jq = Jq.reshape(npts, k, 2, 3)
        if mask is not None:
            m = mask[..., None].to(r.dtype)
            r, Jc, Jq = r * m, Jc * m[..., None], Jq * m[..., None]
        return r, Jc, Jq

    def products(self, p) -> Products:
        return self.products_obs(p, self.obs)

    def products_obs(self, p, obs) -> Products:
        """products at the observations obs (npts, k_obs, 2) in place of
        the instance's, visibility and mask unchanged: the form
        torch.func.vmap batches over per-element observations
        (batched_optimize(ba.products_obs, p0, problem_data=obs_b,
        newton_solver=ba.newton_solver())), as the JAX package's
        ba._replace(obs=obs_i).products does."""
        p, cam_of, obs, pts_prior, mask, axis = self._local(p, obs)
        r, Jc, Jq = self._jacobians(p, cam_of, obs, mask)
        n2, g, U, V, Wv = _assemble(
            self, p, r,
            onehot_cam_reduce(cam_of, torch.einsum('pkij,pki->pkj', Jc, r),
                              self.ncam),
            torch.einsum('pkij,pki->pj', Jq, r),
            onehot_cam_reduce(cam_of,
                              torch.einsum('pkij,pkim->pkjm', Jc, Jc),
                              self.ncam),
            torch.einsum('pkij,pkim->pjm', Jq, Jq),
            torch.einsum('pkij,pkim->pkjm', Jc, Jq), pts_prior, axis)
        return Products(norm2_x=n2, Jt_x=g,
                        JtJ=SparseWSchurJtJ(U=U, Wv=Wv, cam_of=cam_of, V=V))

    def dense_w_products(self, p) -> Products:
        """The same system with W densified into a SchurJtJ: the
        equivalence oracle of the tests (and the memory-infeasible form
        this model exists to avoid). One slot at a time, so that no index
        repeats inside one accumulation."""
        pr = self.products(p)
        J = pr.JtJ
        Wc = J.U.new_zeros((self.ncam, self.npts, 6, 3))
        pts = torch.arange(self.npts, device=J.U.device)
        for k in range(self.k_obs):
            Wc.index_put_((self.cam_of[:, k], pts), J.Wv[:, k],
                          accumulate=True)
        W = Wc.permute(0, 2, 1, 3).reshape(self.ncam * 6, self.npts, 3)
        return Products(norm2_x=pr.norm2_x, Jt_x=pr.Jt_x,
                        JtJ=SchurJtJ(U=J.U, W=W, V=J.V))

    def newton_solver(self) -> SparseWSchurNewtonSolver:
        return SparseWSchurNewtonSolver(nc=self.ncam * 6, n_points=self.npts,
                                        block_size=3, k_obs=self.k_obs)

    def p0(self, generator: Optional[torch.Generator] = None,
           jitter: float = 0.0, dtype=None):
        """As PinholeBA.p0."""
        dtype = dtype or self.obs.dtype
        if jitter:
            return _jitter_start(self, generator, jitter, dtype)
        return _prior_start(self, dtype)


def make_synthetic_sparse(seed: int = 0, ncam: int = 16, npts: int = 1000,
                          k_obs: int = 4, focal: float = 500.0,
                          pixel_noise: float = 0.5, dtype=torch.float64,
                          device=None) -> SparseVisibilityPinholeBA:
    """Ring of cameras, each point seen by the k_obs consecutive cameras
    nearest its azimuth. The JAX package's instance for `seed`, on `device`
    (None: the CUDA device)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    pts, cams = _ring_scene(rng, ncam, npts)
    az = np.arctan2(pts[:, 1], pts[:, 0])
    base = np.round(az / (2 * np.pi) * ncam).astype(int)
    cam_of = (base[:, None] + np.arange(k_obs)[None, :]) % ncam
    obs = _np_project(cams[cam_of.reshape(-1)],
                      np.repeat(pts, k_obs, axis=0),
                      focal).reshape(npts, k_obs, 2)
    obs = obs + rng.normal(size=obs.shape) * pixel_noise
    return SparseVisibilityPinholeBA(
        ncam=ncam, npts=npts, k_obs=k_obs, focal=focal,
        cam_of=torch.as_tensor(cam_of, dtype=torch.int64, device=dev),
        obs=torch.as_tensor(obs, dtype=dtype, device=dev),
        w_prior_cam0=1e6, w_prior_pts=1e-4,
        **_instance_tensors(cams, pts, dtype, dev))
