"""The bundle-adjustment slice on the CPU: models/bundle_adjustment.py and
models/pinhole_ba.py with the Schur strategies and the single solve over
tree states, against the JAX package on the same instances, in float64.

Instances: linear BA nc 8, n_points 50; pinhole ncam 4, npts 60 (the grid
of full visibility); sparse visibility ncam 8, npts 80, k_obs 3. The JAX
side is jitted once per case and cached for the module.

Tolerances: the instances equal the JAX package's (index arrays exactly,
the numpy-made arrays to 1e-15 of their largest entry); products to 1e-12
(linear) or 1e-10 (pinhole, forward-mode Jacobians) of each array's largest
entry; solves take identical decisions (step_count, n_attempts, reason,
History step types) and reach p within 1e-9.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libdogleg_tpu as dl
from libdogleg_tpu.models import bundle_adjustment as jba
from libdogleg_tpu.models import pinhole_ba as jpb
import libdogleg_tpu_torch as tl
from libdogleg_tpu_torch import interop
from libdogleg_tpu_torch.models import bundle_adjustment as tba
from libdogleg_tpu_torch.models import pinhole_ba as tpb
from libdogleg_tpu_torch.ops import newton as tnewton
from libdogleg_tpu_torch.parallel import batched_optimize

torch.set_num_threads(1)


def _close(got, want, rtol):
    """|got - want| <= rtol * max|want|, leaf by leaf."""
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-300)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


@functools.lru_cache(maxsize=None)
def _jax_instance(name):
    if name == "linear":
        return jba.make_synthetic(seed=3, nc=8, n_points=50,
                                  dtype=jnp.float64)
    if name == "dense":
        return jpb.make_synthetic(seed=0, ncam=4, npts=60)
    return jpb.make_synthetic_sparse(seed=0, ncam=8, npts=80, k_obs=3)


def _jax_start(name):
    ba = _jax_instance(name)
    if name == "linear":
        return jnp.zeros(ba.nstate)
    return ba.p0(jax.random.PRNGKey(2), jitter=0.02)


def _port(name):
    ba = _jax_instance(name)
    if name == "linear":
        return interop.bundle_adjustment_from_reference(ba, device="cpu")
    return interop.pinhole_ba_from_reference(ba, device="cpu")


def _port_start(name):
    start = jax.device_get(_jax_start(name))
    if name == "linear":
        return interop.from_numpy(start, device="cpu")
    return interop.tree_from_numpy(start, device="cpu")


@functools.lru_cache(maxsize=None)
def _jax_solve(case):
    name = "linear" if case.startswith("linear") else case
    ba = _jax_instance(name)
    if case == "linear-tree":
        fn, ns, p0 = ba.products_tree, ba.tree_newton_solver(), \
            ba.p0_tree(jnp.float64)
    else:
        fn, ns, p0 = ba.products, ba.newton_solver(), _jax_start(name)
    return jax.jit(lambda p: dl.solve_products(
        fn, p, dl.DoglegParameters(), newton_solver=ns,
        record_history=True))(p0)


def test_linear_instance_equals_jax():
    j = _jax_instance("linear")
    t = tba.make_synthetic(seed=3, nc=8, n_points=50, dtype=torch.float64,
                           device="cpu")
    for name in ("A", "B", "p_true"):
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      np.asarray(getattr(j, name)))
    _close(t.obs, j.obs, 1e-14)
    assert (t.nc, t.n_points, t.block_size, t.nstate, t.nmeasurements) == (
        j.nc, j.n_points, j.block_size, j.nstate, j.nmeasurements)
    t32 = tba.make_synthetic(seed=3, nc=8, n_points=50, noise=0.1,
                             device="cpu")
    j32 = jba.make_synthetic(seed=3, nc=8, n_points=50, noise=0.1)
    assert t32.A.dtype == torch.float32
    _close(t32.obs, j32.obs, 1e-6)


@pytest.mark.parametrize("form", ["flat", "tree"])
def test_linear_products_match_jax(form):
    j, t = _jax_instance("linear"), _port("linear")
    p = np.random.default_rng(0).normal(size=j.nstate)
    if form == "flat":
        pj, pt = j.products(jnp.asarray(p)), t.products(torch.as_tensor(p))
        _close(pt.Jt_x, pj.Jt_x, 1e-12)
        _close(t.residuals(torch.as_tensor(p)), j.residuals(jnp.asarray(p)),
               1e-12)
    else:
        tree = {"c": p[:j.nc], "q": p[j.nc:].reshape(j.n_points, 3)}
        pj = j.products_tree(jax.tree_util.tree_map(jnp.asarray, tree))
        pt = t.products_tree(interop.tree_from_numpy(tree, device="cpu"))
        for k in ("c", "q"):
            _close(pt.Jt_x[k], pj.Jt_x[k], 1e-12)
    _close(pt.norm2_x, pj.norm2_x, 1e-12)
    for k in ("U", "W", "V"):
        _close(getattr(pt.JtJ, k), getattr(pj.JtJ, k), 1e-12)


@pytest.mark.parametrize("name", ["dense", "sparse"])
def test_pinhole_instance_equals_jax(name):
    """The vectorized numpy projection of make_synthetic* gives the JAX
    package's loop's observations to 1e-15 of their largest entry."""
    j = _jax_instance(name)
    if name == "dense":
        t = tpb.make_synthetic(seed=0, ncam=4, npts=60, device="cpu")
        np.testing.assert_array_equal(t.cam_idx.numpy(),
                                      np.asarray(j.cam_idx))
        np.testing.assert_array_equal(t.pt_idx.numpy(), np.asarray(j.pt_idx))
        assert t.dense_grid
    else:
        t = tpb.make_synthetic_sparse(seed=0, ncam=8, npts=80, k_obs=3,
                                      device="cpu")
        np.testing.assert_array_equal(t.cam_of.numpy(), np.asarray(j.cam_of))
        assert t.obs_mask is None and t.k_obs == j.k_obs
    _close(t.obs, j.obs, 1e-15)
    for k in ("cam0_prior", "pts_prior"):
        np.testing.assert_array_equal(getattr(t, k).numpy(),
                                      np.asarray(getattr(j, k)))
    for k in ("c", "q"):
        np.testing.assert_array_equal(t.p_true[k].numpy(),
                                      np.asarray(j.p_true[k]))
    assert (t.nobs, t.nstate, t.w_prior_cam0, t.w_prior_pts, t.focal) == (
        j.nobs, j.nstate, j.w_prior_cam0, j.w_prior_pts, j.focal)


def _permuted(j, t, seed=1):
    """The same observations in another order: not the grid, so the
    generic segment-sum path runs on both sides."""
    perm = np.random.default_rng(seed).permutation(j.nobs)
    jp = j._replace(cam_idx=j.cam_idx[perm], pt_idx=j.pt_idx[perm],
                    obs=j.obs[perm])
    tp = (None if t is None else dataclasses.replace(
        t, cam_idx=t.cam_idx[perm], pt_idx=t.pt_idx[perm], obs=t.obs[perm]))
    return jp, tp


@functools.lru_cache(maxsize=None)
def _jax_products(path):
    """The JAX instance's products at its start, jitted (eager, its vmapped
    jacfwd takes seconds)."""
    name = "dense" if path in ("grid", "generic") else "sparse"
    j = _jax_instance(name)
    if path == "generic":
        j = _permuted(j, None)[0]
    fn = j.dense_w_products if path == "dense-w" else j.products
    return jax.jit(fn)(_jax_start(name))


@pytest.mark.parametrize("path", ["grid", "generic", "sparse"])
def test_pinhole_products_match_jax(path):
    name = "sparse" if path == "sparse" else "dense"
    j, t = _jax_instance(name), _port(name)
    if path == "generic":
        j, t = _permuted(j, t)
        assert not t.dense_grid
    pj = _jax_products(path)
    pt = t.products(_port_start(name))
    _close(pt.norm2_x, pj.norm2_x, 1e-12)
    for k in ("c", "q"):
        _close(pt.Jt_x[k], pj.Jt_x[k], 1e-10)
    fields = ("U", "Wv", "V") if path == "sparse" else ("U", "W", "V")
    for k in fields:
        _close(getattr(pt.JtJ, k), getattr(pj.JtJ, k), 1e-10)
    if path == "generic":
        _close(t.residuals_obs(_port_start(name)),
               j.residuals_obs(_jax_start(name)), 1e-12)


def test_pinhole_grid_equals_generic():
    t = _port("dense")
    _, tp = _permuted(_jax_instance("dense"), t, seed=4)
    p = _port_start("dense")
    a, b = t.products(p), tp.products(p)
    _close(b.norm2_x, a.norm2_x, 1e-13)
    for x, y in ((b.Jt_x["c"], a.Jt_x["c"]), (b.Jt_x["q"], a.Jt_x["q"]),
                 (b.JtJ.U, a.JtJ.U), (b.JtJ.W, a.JtJ.W), (b.JtJ.V, a.JtJ.V)):
        _close(x, y.numpy(), 1e-12)


def test_sparse_dense_w_and_jacobians_match_jax():
    j, t = _jax_instance("sparse"), _port("sparse")
    pj, pt = _jax_products("dense-w"), t.dense_w_products(
        _port_start("sparse"))
    _close(pt.JtJ.W, pj.JtJ.W, 1e-10)
    for got, want in zip(t.observation_jacobians(_port_start("sparse")),
                         jax.jit(j.observation_jacobians)(
                             _jax_start("sparse"))):
        _close(got, want, 1e-12)
    # the same system: the sparse-W strategy's quadratic form and step
    # equal the dense-W strategy's
    ns_s, ns_d = t.newton_solver(), tnewton.TreeSchurNewtonSolver(
        nc=t.ncam * 6, n_points=t.npts, block_size=3)
    ps = t.products(_port_start("sparse"))
    v = {"c": pt.Jt_x["c"] * 0.5, "q": pt.Jt_x["q"] - 1.0}
    _close(ns_s.quad_form(ps.JtJ, v), ns_d.quad_form(pt.JtJ, v).numpy(),
           1e-12)
    zero = torch.tensor(0.0, dtype=torch.float64)
    kw = dict(lambda_initial=1e-10, lambda_max_tries=60)
    gs = ns_s.gauss_newton(ps.JtJ, ps.Jt_x, zero, **kw)
    gd = ns_d.gauss_newton(pt.JtJ, pt.Jt_x, zero, **kw)
    for k in ("c", "q"):
        _close(gs.step[k], gd.step[k].numpy(), 1e-8)


@pytest.mark.parametrize("r", [0.0, 1e-9, 0.05])
def test_projection_jacobians_match_jax_near_zero_rotation(r):
    """Forward-mode Jacobians of the projection at and near r = 0 (the
    small-angle branch) equal JAX's jacfwd, and are finite at r = 0."""
    rng = np.random.default_rng(5)
    cams = np.concatenate([r * rng.normal(size=(6, 3)),
                           rng.normal(size=(6, 3)) + [0.0, 0.0, 6.0]], 1)
    pts = rng.normal(size=(6, 3))
    obs = rng.normal(size=(6, 2))
    rt, Jc, Jq = tpb.observation_terms(torch.as_tensor(cams),
                                       torch.as_tensor(pts),
                                       torch.as_tensor(obs), 500.0)
    assert bool(torch.isfinite(Jc).all()) and bool(torch.isfinite(Jq).all())

    def proj(c, q):
        return jpb.project(c, q, 500.0)
    jc = jax.vmap(jax.jacfwd(proj, argnums=0))(cams, pts)
    jq = jax.vmap(jax.jacfwd(proj, argnums=1))(cams, pts)
    _close(rt, jax.vmap(proj)(cams, pts) - obs, 1e-14)
    _close(Jc, jc, 1e-12)
    _close(Jq, jq, 1e-12)


def test_obs_mask_padding_equals_unpadded():
    t = _port("sparse")
    pad = dataclasses.replace(
        t, k_obs=4,
        cam_of=torch.cat([t.cam_of, torch.zeros((t.npts, 1),
                                                dtype=t.cam_of.dtype)], 1),
        obs=torch.cat([t.obs, torch.zeros((t.npts, 1, 2),
                                          dtype=t.obs.dtype)], 1),
        obs_mask=torch.cat([torch.ones((t.npts, 3), dtype=torch.float64),
                            torch.zeros((t.npts, 1), dtype=torch.float64)],
                           1))
    p = _port_start("sparse")
    a, b = t.products(p), pad.products(p)
    _close(b.norm2_x, a.norm2_x, 1e-14)
    for k in ("c", "q"):
        _close(b.Jt_x[k], a.Jt_x[k].numpy(), 1e-13)
    _close(b.JtJ.U, a.JtJ.U.numpy(), 1e-13)
    _close(b.JtJ.V, a.JtJ.V.numpy(), 1e-14)
    assert float(b.JtJ.Wv[:, 3].abs().max()) == 0.0
    zero = torch.tensor(0.0, dtype=torch.float64)
    kw = dict(lambda_initial=1e-10, lambda_max_tries=60)
    ga = t.newton_solver().gauss_newton(a.JtJ, a.Jt_x, zero, **kw)
    gb = pad.newton_solver().gauss_newton(b.JtJ, b.Jt_x, zero, **kw)
    for k in ("c", "q"):
        _close(gb.step[k], ga.step[k].numpy(), 1e-9)


def _flat(p):
    if isinstance(p, dict):
        return np.concatenate([np.asarray(p[k]).ravel() for k in ("c", "q")])
    return np.asarray(p)


@pytest.mark.parametrize("case", ["linear-flat", "linear-tree", "dense",
                                  "sparse"])
def test_solve_matches_jax(case):
    rj = _jax_solve(case)
    name = "linear" if case.startswith("linear") else case
    t = _port(name)
    if case == "linear-tree":
        fn, ns, p0 = t.products_tree, t.tree_newton_solver(), t.p0_tree()
    else:
        fn, ns, p0 = t.products, t.newton_solver(), _port_start(name)
    rt = tl.solve_products(fn, p0, tl.DoglegParameters(), newton_solver=ns,
                           record_history=True)
    for field in ("step_count", "n_attempts", "reason"):
        assert int(getattr(rt, field)) == int(getattr(rj, field)), field
    np.testing.assert_array_equal(rt.history.step_type.numpy(),
                                  np.asarray(rj.history.step_type))
    out = interop.result_to_numpy(rt)
    np.testing.assert_allclose(_flat(out.p), _flat(rj.p), rtol=1e-9,
                               atol=1e-9)
    np.testing.assert_allclose(float(out.norm2_x), float(rj.norm2_x),
                               rtol=1e-9, atol=1e-20)
    assert float(out.lam) == float(rj.lam)
    assert isinstance(out.p, dict) == (case != "linear-flat")


@functools.lru_cache(maxsize=None)
def _dead_points(jax_side):
    """tests/test_models.py's rank-deficient instance, smaller: the last
    16 points have no observation and no prior, so their V blocks are
    exactly singular and lambda must escalate. Without the point prior the
    scene's scale is free, so the Newton steps are set along it by rounding
    alone (the first trial cost differs at 5e-5 between the two packages)
    and the attempts are not compared: lambda, the reason's class and the
    final cost are."""
    ba = jpb.make_synthetic_sparse(seed=3, ncam=8, npts=120, k_obs=4,
                                   pixel_noise=0.1)
    mask = jnp.ones((ba.npts, ba.k_obs)).at[-16:].set(0.0)
    ba = ba._replace(obs_mask=mask, w_prior_pts=0.0)
    p0 = ba.p0(jax.random.PRNGKey(5), jitter=0.01)
    if jax_side:
        return jax.jit(lambda c, q: dl.solve_products(
            ba.products, {"c": c, "q": q}, dl.DoglegParameters(),
            newton_solver=ba.newton_solver()))(p0["c"], p0["q"])
    return (interop.pinhole_ba_from_reference(ba, device="cpu"),
            interop.tree_from_numpy(jax.device_get(p0), device="cpu"))


def test_singular_points_escalate_lambda_as_jax():
    rj = _dead_points(True)
    t, p0 = _dead_points(False)
    rt = tl.solve_products(t.products, p0, tl.DoglegParameters(),
                           newton_solver=t.newton_solver())
    converged = {int(tl.StopReason.GRADIENT_CONVERGED),
                 int(tl.StopReason.SMALL_STEP),
                 int(tl.StopReason.MAX_ITERATIONS)}
    assert int(rt.reason) in converged and int(rj.reason) in converged
    assert float(rt.lam) > 0.0
    assert float(rt.lam) == float(rj.lam)
    np.testing.assert_allclose(float(rt.norm2_x), float(rj.norm2_x),
                               rtol=1e-9)
    # unobserved, prior-free points have no gradient: never moved
    assert torch.equal(rt.p["q"][-16:], p0["q"][-16:])
    stuck = tl.solve_products(
        t.products, p0, tl.DoglegParameters(lambda_max_tries=0),
        newton_solver=t.newton_solver())
    assert int(stuck.reason) == int(tl.StopReason.FACTORIZATION_FAILED)


@pytest.mark.parametrize("case", ["no-tree-strategy", "leading-sizes",
                                  "sparse-w"])
def test_batched_optimize_refuses_tree_start(case):
    """The tree starts batched_optimize refuses: one without a strategy for
    batched tree states, and one whose leaves differ in their leading size
    (here the unbatched start), with TreeSchurNewtonSolver and with
    SparseWSchurNewtonSolver, whose batch is a tree start too."""
    t = _port("linear")
    batch = {k: v[None].expand((2,) + v.shape)
             for k, v in t.p0_tree().items()}
    if case == "no-tree-strategy":
        with pytest.raises(ValueError, match="TreeSchurNewtonSolver"):
            batched_optimize(t.products_tree, batch)
    elif case == "leading-sizes":
        with pytest.raises(ValueError, match="same leading"):
            batched_optimize(t.products_tree, t.p0_tree(),
                             newton_solver=t.tree_newton_solver())
    else:
        s = _port("sparse")
        with pytest.raises(ValueError, match="same leading"):
            batched_optimize(s.products, s.p0(),
                             newton_solver=s.newton_solver())


def test_constructors_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tba.make_synthetic(nc=4, n_points=5)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpb.make_synthetic(ncam=2, npts=5)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpb.make_synthetic_sparse(ncam=4, npts=5, k_obs=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        interop.pinhole_ba_from_reference(_jax_instance("dense"))
