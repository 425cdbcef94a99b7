"""The batched sparse-W Schur solve on the CPU: SparseWSchurNewtonSolver with
a leading batch axis (ops/newton.py), onehot_cam_reduce per element,
SparseVisibilityPinholeBA.products_obs under torch.func.vmap, and
refine_iters with a batch axis in the three Schur strategies, against the
JAX package's jax.vmap of the same functions, in float64.

Instance: make_synthetic_sparse(seed 0, ncam 6, npts 60, k_obs 3), B 5
under config 9's thresholds with max_iterations 6: element 0 starts at the
truth under observations made from it (done at the start), elements 1-4
from truths jittered by 0.02 to 0.6 under observations + 0.5 N(0, 1), all
numpy-seeded (two stop at max_iterations). S is assembled whole and, with
s_chunk_limit 512, over chunks of points. The JAX side is jitted once per
case and cached for the module.

Tolerances: decisions (step_count, n_attempts, reason, History step types
and step_accepted) identical and lambda exactly equal; p within 1e-9 of the
element's largest entry and the costs within 1e-9 of the batch's largest
(the convention of test_torch_batched_schur's _close_rows), but element 4
at 1e-6: started 0.6 from the truth, it ends unconverged at max_iterations
(cost 9787) on a system the 1e6 gauge prior conditions badly, and the JAX
package's own solve of it moves by 6.8e-8 of its largest entry in q and
3.7e-7 in the cost when S is chunked (the port is 9.7e-8 from JAX there).
A Gauss-Newton step computed in another order of summation (unbatched,
S chunked, the JAX package's einsums, a refinement residual in working
precision) moves by up to eps cond(S) of its largest entry, with cond(S)
of the element's reduced system at its lambda (2e2 to 2.8e9 here, the 1e6
gauge prior against the 1e-4 point prior): that is the tolerance of the
batched step against those.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libdogleg_tpu as dl
from libdogleg_tpu.models import pinhole_ba as jpb
from libdogleg_tpu.ops import newton as jnewton
from libdogleg_tpu.solver import solve_products as j_solve
import libdogleg_tpu_torch as tl
from libdogleg_tpu_torch import interop
from libdogleg_tpu_torch.ops import newton as tnewton
from libdogleg_tpu_torch.ops import treevec as tv
from libdogleg_tpu_torch.parallel import batched_optimize

torch.set_num_threads(1)
RTOL = 1e-9
PRM = dict(max_iterations=6, Jt_x_threshold=1e-3, update_threshold=1e-5,
           trustregion_threshold=1e-5)
KW = dict(lambda_initial=1e-10, lambda_max_tries=60)
JITTER = (0.0, 0.02, 0.1, 0.3, 0.6)
CHUNKED = 512   # s_chunk_limit that splits S's 60 points into chunks
# per element: the reason for element 4's in the module docstring
ELEMENT_RTOL = (RTOL,) * 4 + (1e-6,)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


def _close_rows(got, want, rtol=RTOL):
    """Row by row (one row an element): the entries within rtol (one for
    all rows, or one a row) of the row's largest magnitude."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    got, want = got.reshape(got.shape[0], -1), want.reshape(want.shape[0], -1)
    rtols = np.broadcast_to(rtol, (got.shape[0],))
    for g, w, r in zip(got, want, rtols):
        scale = max(float(np.abs(w).max()), 1e-300)
        np.testing.assert_allclose(g, w, rtol=0, atol=float(r) * scale)


def _assert_same_decisions(rt, rj, elements=slice(None)):
    """rt (the port's batch, or the rows `elements` of it) takes rj's
    decisions, lambda and History step types, with p and the costs within
    ELEMENT_RTOL."""
    for field in ("step_count", "n_attempts", "reason"):
        np.testing.assert_array_equal(_np(getattr(rt, field)),
                                      _np(getattr(rj, field)), err_msg=field)
    np.testing.assert_array_equal(_np(rt.lam), _np(rj.lam))
    rtol = np.asarray(ELEMENT_RTOL)[elements]
    for k in ("c", "q"):
        _close_rows(rt.p[k], rj.p[k], rtol)
    scale = float(np.abs(_np(_port_batch(1 << 24).norm2_x)).max())
    diff = np.abs(_np(rt.norm2_x) - _np(rj.norm2_x))
    assert np.all(diff <= rtol * scale), (diff, rtol * scale)
    if rj.history is not None:
        for name in ("step_type", "step_accepted", "iteration"):
            np.testing.assert_array_equal(_np(getattr(rt.history, name)),
                                          _np(getattr(rj.history, name)),
                                          err_msg=name)


@functools.lru_cache(maxsize=None)
def _instance():
    """(JAX instance, port instance, per-element obs (B, npts, k_obs, 2),
    starts {"c", "q"} as numpy)."""
    ba = jpb.make_synthetic_sparse(seed=0, ncam=6, npts=60, k_obs=3)
    t = interop.pinhole_ba_from_reference(ba, device="cpu")
    rng = np.random.default_rng(5)
    obs = np.asarray(ba.obs)
    obs_b = obs[None] + 0.5 * rng.normal(size=(len(JITTER),) + obs.shape)
    r_true, _, _ = t.observation_jacobians(t.p_true)
    obs_b[0] = obs + _np(r_true)           # exact at the truth
    truth = jax.device_get(ba.p_true)
    p0 = {k: np.stack([truth[k] + j * rng.normal(size=truth[k].shape)
                       for j in JITTER]) for k in ("c", "q")}
    return ba, t, obs_b, p0


def _port_inputs():
    _, t, obs_b, p0 = _instance()
    return (t, torch.as_tensor(obs_b),
            interop.tree_from_numpy(p0, device="cpu"))


@functools.lru_cache(maxsize=None)
def _jax_batch():
    """The JAX package's vmap(solve_products) over ba._replace(obs=...)."""
    ba, _, obs_b, p0 = _instance()
    ns = ba.newton_solver()

    def one(c, q, obs):
        return j_solve(ba._replace(obs=obs).products, {"c": c, "q": q},
                       dl.DoglegParameters(**PRM), newton_solver=ns,
                       record_history=True)
    return jax.device_get(jax.jit(jax.vmap(one))(p0["c"], p0["q"], obs_b))


@functools.lru_cache(maxsize=None)
def _port_batch(chunk_limit):
    t, obs_b, p0 = _port_inputs()
    ns = dataclasses.replace(t.newton_solver(), s_chunk_limit=chunk_limit)
    return batched_optimize(t.products_obs, p0, tl.DoglegParameters(**PRM),
                            problem_data=obs_b, newton_solver=ns,
                            record_history=True)


# ---------------------------------------------------------------------------
# the batched solve
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chunk_limit", [1 << 24, CHUNKED])
def test_batch_matches_jax_vmap(chunk_limit):
    rt = _port_batch(chunk_limit)
    _assert_same_decisions(rt, _jax_batch())
    assert int(rt.n_attempts[0]) == 0
    assert {int(tl.StopReason.SMALL_STEP),
            int(tl.StopReason.MAX_ITERATIONS)} <= set(_np(rt.reason).tolist())
    assert len(set(_np(rt.n_attempts).tolist())) > 2


@pytest.mark.parametrize("chunk_limit", [1 << 24, CHUNKED])
def test_elements_match_their_single_solves(chunk_limit):
    """Each element of the batch takes its own single solve's decisions
    and History step types, p within RTOL."""
    t, obs_b, p0 = _port_inputs()
    ns = dataclasses.replace(t.newton_solver(), s_chunk_limit=chunk_limit)
    rb = _port_batch(chunk_limit)
    for i in range(obs_b.shape[0]):
        ri = tl.solve_products(
            lambda p, o=obs_b[i]: t.products_obs(p, o),
            {k: v[i] for k, v in p0.items()}, tl.DoglegParameters(**PRM),
            newton_solver=ns, record_history=True)
        one = tv.tree_map(lambda a: a[None], ri._replace(JtJ=None))
        _assert_same_decisions(one, tv.tree_map(lambda a: a[i:i + 1],
                                                rb._replace(JtJ=None)),
                               slice(i, i + 1))


def test_chunked_s_changes_only_the_order_of_summation():
    """The chunked batch takes the unchunked batch's decisions."""
    _assert_same_decisions(_port_batch(CHUNKED), _port_batch(1 << 24))


def test_products_obs_is_products_at_those_observations():
    t, obs_b, p0 = _port_inputs()
    p = {k: v[2] for k, v in p0.items()}
    t2 = dataclasses.replace(t, obs=obs_b[2])
    for a, b in zip(tv.tree_leaves(t.products_obs(p, obs_b[2])),
                    tv.tree_leaves(t2.products(p))):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the batched strategy, one Gauss-Newton step
# ---------------------------------------------------------------------------


SINGULAR = (1, 3)   # elements with a zeroed point block


@functools.lru_cache(maxsize=None)
def _systems():
    """The systems of every element at its start as numpy, with
    right-hand sides N(0, 1): (U, Wv, cam_of, V, rc, rq); elements SINGULAR
    have point block 7 zeroed."""
    t, obs_b, p0 = _port_inputs()
    pr = torch.func.vmap(t.products_obs)(p0, obs_b)
    V = pr.JtJ.V.clone()
    for e in SINGULAR:
        V[e, 7] = 0.0
    rng = np.random.default_rng(13)
    return tuple(_np(a) for a in (pr.JtJ.U, pr.JtJ.Wv, t.cam_of, V)) + (
        rng.normal(size=pr.Jt_x["c"].shape),
        rng.normal(size=pr.Jt_x["q"].shape))


def _strategy(pkg, refine, gather, chunk_limit=1 << 24):
    _, t, _, _ = _instance()
    cls = (jnewton if pkg == "jax" else tnewton).SparseWSchurNewtonSolver
    cg = None
    if gather:
        cam = np.asarray(t.cam_of)
        cg = (jnewton.build_cam_gather(cam, t.ncam) if pkg == "jax" else
              tnewton.build_cam_gather(cam, t.ncam, device="cpu"))
    return cls(nc=t.ncam * 6, n_points=t.npts, block_size=3, k_obs=t.k_obs,
               s_chunk_limit=chunk_limit, refine_iters=refine,
               cam_gather=cg)


@functools.lru_cache(maxsize=None)
def _jax_gn(refine, gather):
    U, Wv, cam, V, rc, rq = _systems()
    ns = _strategy("jax", refine, gather)

    def one(u, w, v, c, q):
        return ns.gauss_newton(
            jnewton.SparseWSchurJtJ(U=u, Wv=w, cam_of=jnp.asarray(cam), V=v),
            {"c": c, "q": q}, jnp.asarray(0.0), **KW)
    return jax.device_get(jax.jit(jax.vmap(one))(U, Wv, V, rc, rq))


def _cond_rtol(ns, jtj, lam):
    """eps cond(S) per element: S's condition number at lam, from its
    factor."""
    (_, Ls), _ = ns.factor(jtj, lam)
    S = Ls @ Ls.mT
    return np.finfo(np.float64).eps * np.linalg.cond(_np(S))


@pytest.mark.parametrize("refine,gather", [(0, False), (2, False),
                                           (2, True)])
@pytest.mark.parametrize("cam_axis", ["shared", "per-element"])
def test_batched_gauss_newton(refine, gather, cam_axis):
    """The batched step against each element's unbatched step (cam_of
    shared or one per element) and the JAX package's vmap; only the
    singular elements escalate lambda."""
    U, Wv, cam, V, rc, rq = (torch.as_tensor(a) for a in _systems())
    B = U.shape[0]
    cam_b = cam if cam_axis == "shared" else cam.expand(B, -1, -1).clone()
    lam0 = torch.zeros(B, dtype=torch.float64)
    res = {}
    for limit in (1 << 24, CHUNKED):
        ns = _strategy("torch", refine, gather, limit)
        res[limit] = ns.gauss_newton(
            tnewton.SparseWSchurJtJ(U=U, Wv=Wv, cam_of=cam_b, V=V),
            {"c": rc, "q": rq}, lam0, **KW)
    r = res[1 << 24]
    assert r.ok.shape == (B,) and bool(r.ok.all())
    assert torch.nonzero(r.lam > 0)[:, 0].tolist() == list(SINGULAR)
    ns = _strategy("torch", refine, gather)
    rtol = _cond_rtol(ns, tnewton.SparseWSchurJtJ(U=U, Wv=Wv, cam_of=cam,
                                                  V=V), r.lam)
    for e in range(B):
        one = ns.gauss_newton(
            tnewton.SparseWSchurJtJ(U=U[e], Wv=Wv[e], cam_of=cam, V=V[e]),
            {"c": rc[e], "q": rq[e]}, torch.tensor(0.0, dtype=torch.float64),
            **KW)
        assert float(one.lam) == float(r.lam[e]) and bool(one.ok)
        for x, y in zip(tv.tree_leaves(one.step), tv.tree_leaves(r.step)):
            np.testing.assert_allclose(
                y[e].numpy(), x.numpy(), rtol=0,
                atol=rtol[e] * float(x.abs().max()))
    assert torch.equal(res[CHUNKED].lam, r.lam)
    for x, y in zip(tv.tree_leaves(res[CHUNKED].step),
                    tv.tree_leaves(r.step)):
        _close_rows(x, y, rtol)
    rj = _jax_gn(refine, gather)
    np.testing.assert_array_equal(r.lam.numpy(), np.asarray(rj.lam))
    np.testing.assert_array_equal(r.ok.numpy(), np.asarray(rj.ok))
    for x, y in zip(tv.tree_leaves(r.step),
                    jax.tree_util.tree_leaves(rj.step)):
        _close_rows(x, y, rtol)
    diff = np.abs(r.norm2_step.numpy() - np.asarray(rj.norm2_step))
    assert np.all(diff <= 2 * rtol * np.asarray(rj.norm2_step))


@pytest.mark.parametrize("chunk_limit", [1 << 24, CHUNKED])
def test_batched_quad_form_and_factor(chunk_limit):
    """quad_form and factor of a batch against each element's (S = Ls Ls^T
    within 1e-12 of its largest entry, the chunks of a batch and of one
    element holding other points), and ok per element at lambda 0: the
    singular elements fail alone."""
    U, Wv, cam, V, rc, rq = (torch.as_tensor(a) for a in _systems())
    B = U.shape[0]
    ns = _strategy("torch", 0, False, chunk_limit)
    jtj = tnewton.SparseWSchurJtJ(U=U, Wv=Wv, cam_of=cam, V=V)
    v = {"c": rc, "q": rq}
    q = ns.quad_form(jtj, v)
    (Lv, Ls), ok = ns.factor(jtj, torch.zeros(B, dtype=torch.float64))
    assert torch.nonzero(~ok)[:, 0].tolist() == list(SINGULAR)
    for e in range(B):
        je = tnewton.SparseWSchurJtJ(U=U[e], Wv=Wv[e], cam_of=cam, V=V[e])
        qe = ns.quad_form(je, {"c": rc[e], "q": rq[e]})
        np.testing.assert_allclose(float(q[e]), float(qe), rtol=1e-13)
        (Lve, Lse), oke = ns.factor(je, torch.tensor(0.0,
                                                     dtype=torch.float64))
        assert bool(oke) == bool(ok[e])
        if bool(oke):
            assert torch.equal(Lve, Lv[e])
            S, Se = Ls[e] @ Ls[e].mT, Lse @ Lse.mT
            np.testing.assert_allclose(S.numpy(), Se.numpy(), rtol=0,
                                       atol=1e-12 * float(Se.abs().max()))


@pytest.mark.parametrize("chunk_limit", [1 << 24, 300])
def test_onehot_cam_reduce_batched_is_per_element(chunk_limit):
    rng = np.random.default_rng(3)
    cam = torch.as_tensor(rng.integers(0, 5, size=(40, 3)))
    vals = torch.as_tensor(rng.normal(size=(4, 40, 3, 2, 3)))
    for cam_of in (cam, torch.stack([cam, cam.flip(0), cam, cam.roll(1)])):
        got = tnewton.onehot_cam_reduce(cam_of, vals, 5, chunk_limit,
                                        batched=True)
        assert got.shape == (4, 5, 2, 3)
        for e in range(4):
            ce = cam_of if cam_of.dim() == 2 else cam_of[e]
            want = tnewton.onehot_cam_reduce(ce, vals[e], 5)
            np.testing.assert_allclose(got[e].numpy(), want.numpy(),
                                       rtol=1e-13, atol=1e-13)


# ---------------------------------------------------------------------------
# refine_iters with a batch axis: the flat and tree Schur strategies
# ---------------------------------------------------------------------------


NC, NP, BS = 5, 12, 3


@functools.lru_cache(maxsize=None)
def _schur_stack():
    """Four (U, W, V, b) arrow systems as numpy stacks; element 2 carries
    a singular point block."""
    rng = np.random.default_rng(12)
    n = NC + NP * BS
    out = []
    for e in range(4):
        J = rng.normal(size=(3 * n, n))
        JtJ = J.T @ J
        V = np.stack([JtJ[NC + i * BS:NC + (i + 1) * BS,
                          NC + i * BS:NC + (i + 1) * BS] for i in range(NP)])
        if e == 2:
            V[5] = 0.0
        out.append((JtJ[:NC, :NC], JtJ[:NC, NC:].reshape(NC, NP, BS), V,
                    rng.normal(size=n)))
    return tuple(np.stack(parts) for parts in zip(*out))


@functools.lru_cache(maxsize=None)
def _jax_schur_refined():
    U, W, V, b = _schur_stack()
    ns = jnewton.SchurNewtonSolver(nc=NC, n_points=NP, block_size=BS,
                                   refine_iters=2)

    def one(u, w, v, rhs):
        return ns.gauss_newton(jnewton.SchurJtJ(U=u, W=w, V=v), rhs,
                               jnp.asarray(0.0), **KW)
    return jax.device_get(jax.jit(jax.vmap(one))(U, W, V, b))


@pytest.mark.parametrize("tree", [False, True])
def test_schur_refine_with_a_batch(tree):
    """refine_iters=2 on a batch: each element its unbatched refined step
    (which the flat and tree forms share), and the JAX package's vmap."""
    U, W, V, b = (torch.as_tensor(a) for a in _schur_stack())
    cls = tnewton.TreeSchurNewtonSolver if tree else tl.SchurNewtonSolver
    ns = cls(nc=NC, n_points=NP, block_size=BS, refine_iters=2)

    def rhs(x):
        if not tree:
            return x
        return {"c": x[..., :NC],
                "q": x[..., NC:].reshape(x.shape[:-1] + (NP, BS))}

    def flat(step):
        if not tree:
            return step
        return torch.cat([step["c"], step["q"].flatten(-2)], -1)
    r = ns.gauss_newton(tl.SchurJtJ(U=U, W=W, V=V), rhs(b),
                        torch.zeros(4, dtype=torch.float64), **KW)
    assert bool(r.ok.all()) and torch.nonzero(r.lam > 0)[:, 0].tolist() == [2]
    for e in range(4):
        one = ns.gauss_newton(tl.SchurJtJ(U=U[e], W=W[e], V=V[e]),
                              rhs(b[e]),
                              torch.tensor(0.0, dtype=torch.float64), **KW)
        assert float(one.lam) == float(r.lam[e])
        np.testing.assert_allclose(flat(r.step)[e].numpy(),
                                   flat(one.step).numpy(), rtol=0,
                                   atol=1e-12 * float(flat(one.step)
                                                      .abs().max()))
    rj = _jax_schur_refined()
    np.testing.assert_array_equal(r.lam.numpy(), np.asarray(rj.lam))
    _close_rows(flat(r.step), np.asarray(rj.step))
    unrefined = cls(nc=NC, n_points=NP, block_size=BS).gauss_newton(
        tl.SchurJtJ(U=U, W=W, V=V), rhs(b),
        torch.zeros(4, dtype=torch.float64), **KW)
    assert not torch.equal(flat(unrefined.step), flat(r.step))
