"""Batched structured solves on the CPU: the masked batched solver over tree
states and Schur systems (solver.py), the batched Schur strategies
(ops/newton.py), the batched tree reductions (ops/treevec.py), the BA
products over per-element observations and the batched History, against the
JAX package's batched_optimize (a jax.vmap of solve_products) on the same
inputs, in float64.

Instances: pinhole ncam 3, npts 16 (the grid of full visibility), B 6 under
config 9's thresholds: one element started at the truth with observations
made from it (done at the start), five from truths jittered by 0.01 to 0.4
under noisy observations (the last stops at max_iterations 6); linear BA
nc 6, n_points 24, B 4, flat and tree, under the default parameters.
Observation noise is numpy-seeded, starts come from the JAX package's p0
and cross by interop. The JAX side is jitted once per case and cached for
the module.

Tolerances: decisions (step_count, n_attempts, reason, History step types
and step_accepted) identical and lambda exactly equal; p and every History
float column within rtol 1e-9 of the largest finite entry of that
element's state or column (the convention of test_torch_ba's _close), the
costs within 1e-9 of the batch's largest, inf in the same places. Five
History columns of the pinhole instance are held looser (PINHOLE_HISTORY):
on it the port's single solve and the JAX package's already differ by 1.9e-9
in the trial costs and step lengths, and by 1.9e-6 and 1.7e-6 in rho and
the direction change (a ratio of near-equal differences, and the angle
between two steps of a system that the 1e6 gauge prior conditions badly);
the linear instance holds every column to 1e-9.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libdogleg_tpu as dl
from libdogleg_tpu.models import bundle_adjustment as jba
from libdogleg_tpu.models import pinhole_ba as jpb
from libdogleg_tpu.ops import newton as jnewton
from libdogleg_tpu.ops import treevec as jtv
from libdogleg_tpu.parallel.batched import batched_optimize as j_batched
import libdogleg_tpu_torch as tl
from libdogleg_tpu_torch import interop
from libdogleg_tpu_torch.ops import newton as tnewton
from libdogleg_tpu_torch.ops import treevec as tv
from libdogleg_tpu_torch.parallel import (batched_optimize,
                                          batched_optimize_compacted)

torch.set_num_threads(1)
RTOL = 1e-9
# config 9's thresholds (bench_all.py:46-48) and max_iterations 6, which the
# start of jitter 0.4 reaches
PRM = dict(max_iterations=6, Jt_x_threshold=1e-3, update_threshold=1e-5,
           trustregion_threshold=1e-5)
KW = dict(lambda_initial=1e-10, lambda_max_tries=60)
PINHOLE_HISTORY = {"norm2x_after": 1e-8, "step_len_gauss_newton": 1e-8,
                   "step_len": 1e-8, "rho": 1e-5,
                   "step_direction_change_deg": 1e-5}


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


def _close_rows(got, want, rtol=RTOL):
    """Row by row (one row an element): inf where want has inf, and the
    finite entries within rtol of the row's largest finite magnitude."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    got, want = got.reshape(got.shape[0], -1), want.reshape(want.shape[0], -1)
    for g, w in zip(got, want):
        fin = np.isfinite(w)
        np.testing.assert_array_equal(np.isfinite(g), fin)
        np.testing.assert_array_equal(g[~fin], w[~fin])
        if fin.any():
            scale = max(float(np.abs(w[fin]).max()), 1e-300)
            np.testing.assert_allclose(g[fin], w[fin], rtol=0,
                                       atol=rtol * scale)


def _same_bits(a, b) -> bool:
    """Whether two tensors hold the same bits (NaN included)."""
    ints = {torch.float64: torch.int64, torch.float32: torch.int32}
    if a.dtype in ints:
        a, b = a.view(ints[a.dtype]), b.view(ints[b.dtype])
    return a.shape == b.shape and torch.equal(a, b)


def _assert_same_solves(rt, rj, flat_p=None, history_rtol=None):
    """Every element of the port's batched result rt takes the decisions
    of rj (the JAX package's, or another batched result) and agrees;
    history_rtol names the History columns held to another rtol."""
    for field in ("step_count", "n_attempts", "reason"):
        np.testing.assert_array_equal(_np(getattr(rt, field)),
                                      _np(getattr(rj, field)), err_msg=field)
    np.testing.assert_array_equal(_np(rt.lam), _np(rj.lam))
    pt = [_np(x) for x in tv.tree_leaves(rt.p)]
    pj = [_np(x) for x in jax.tree_util.tree_leaves(rj.p)]
    if flat_p is not None:
        pt = [flat_p(*pt)]
    for a, b in zip(pt, pj):
        _close_rows(a, b)
    # the costs as one row: the element started at the truth has a cost of
    # roundoff size, held to the batch's scale
    _close_rows(rt.norm2_x[None], _np(rj.norm2_x)[None])
    ht, hj = rt.history, rj.history
    for name in ht._fields:
        a, b = _np(getattr(ht, name)), _np(getattr(hj, name))
        if a.dtype.kind == "f":
            _close_rows(a, b, (history_rtol or {}).get(name, RTOL))
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)


# ---------------------------------------------------------------------------
# the instances
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _pinhole():
    """(JAX instance, per-element obs (B, nobs, 2), starts {"c", "q"}):
    element 0 starts at the truth under observations made from it,
    elements 1-5 from truths jittered by 0.01 to 0.4 under noisy
    observations."""
    ba = jpb.make_synthetic(seed=0, ncam=3, npts=16)
    B = 6
    rng = np.random.default_rng(5)
    obs = np.asarray(ba.obs)
    exact = obs + np.asarray(ba.residuals_obs(ba.p_true)).reshape(obs.shape)
    obs_b = obs[None] + 0.5 * rng.normal(size=(B,) + obs.shape)
    obs_b[0] = exact
    keys = jax.random.split(jax.random.PRNGKey(7), B)
    jitter = (0.0, 0.01, 0.05, 0.15, 0.3, 0.4)
    starts = [jax.device_get(ba.p0(keys[i], jitter=jitter[i]))
              if i else jax.device_get(ba.p_true) for i in range(B)]
    p0 = {k: np.stack([s[k] for s in starts]) for k in ("c", "q")}
    return ba, obs_b, p0


@functools.lru_cache(maxsize=None)
def _linear():
    """(JAX instance, per-element obs (B, n_points, k_obs), zero starts)."""
    ba = jba.make_synthetic(seed=3, nc=6, n_points=24, dtype=jnp.float64)
    B = 4
    rng = np.random.default_rng(6)
    obs_b = (np.asarray(ba.obs)[None]
             + 0.1 * rng.normal(size=(B,) + ba.obs.shape))
    return ba, obs_b, np.zeros((B, ba.nstate))


@functools.lru_cache(maxsize=None)
def _jax_pinhole():
    ba, obs_b, p0 = _pinhole()

    def products(p, obs):
        return ba._replace(obs=obs).products(p)
    return jax.jit(lambda c, q, obs: j_batched(
        products, {"c": c, "q": q}, dl.DoglegParameters(**PRM),
        problem_data=obs, newton_solver=ba.newton_solver(),
        record_history=True))(p0["c"], p0["q"], obs_b)


@functools.lru_cache(maxsize=None)
def _jax_linear():
    ba, obs_b, p0 = _linear()

    def products(p, obs):
        return ba._replace(obs=obs).products(p)
    return jax.jit(lambda p, obs: j_batched(
        products, p, dl.DoglegParameters(), problem_data=obs,
        newton_solver=ba.newton_solver(), record_history=True))(p0, obs_b)


def _port_pinhole():
    ba, obs_b, p0 = _pinhole()
    return (interop.pinhole_ba_from_reference(ba, device="cpu"),
            interop.from_numpy(obs_b, device="cpu"),
            interop.tree_from_numpy(p0, device="cpu"))


def _port_linear():
    ba, obs_b, p0 = _linear()
    return (interop.bundle_adjustment_from_reference(ba, device="cpu"),
            interop.from_numpy(obs_b, device="cpu"),
            interop.from_numpy(p0, device="cpu"))


@functools.lru_cache(maxsize=None)
def _port_pinhole_solve():
    t, obs_b, p0 = _port_pinhole()
    return batched_optimize(t.products_obs, p0, tl.DoglegParameters(**PRM),
                            problem_data=obs_b,
                            newton_solver=t.newton_solver(),
                            record_history=True)


# ---------------------------------------------------------------------------
# the solves against the JAX package's
# ---------------------------------------------------------------------------


def test_pinhole_tree_batch_matches_jax():
    rt, rj = _port_pinhole_solve(), _jax_pinhole()
    _assert_same_solves(rt, rj, history_rtol=PINHOLE_HISTORY)
    reasons = set(_np(rt.reason).tolist())
    # the batch holds an element done at the start and one stopped by
    # max_iterations, beside converged ones
    assert int(rt.n_attempts[0]) == 0
    assert int(tl.StopReason.GRADIENT_CONVERGED) in reasons
    assert int(tl.StopReason.MAX_ITERATIONS) in reasons
    assert len(set(_np(rt.n_attempts).tolist())) > 2


@pytest.mark.parametrize("form", ["flat", "tree"])
def test_linear_batch_matches_jax(form):
    """The flat SchurNewtonSolver and the tree form batched over obs; the
    tree result is held to the JAX package's flat solve (the same
    algorithm on the split state)."""
    t, obs_b, p0 = _port_linear()
    rj = _jax_linear()
    if form == "flat":
        rt = batched_optimize(t.products_obs, p0, tl.DoglegParameters(),
                              problem_data=obs_b,
                              newton_solver=t.newton_solver(),
                              record_history=True)
        _assert_same_solves(rt, rj)
        return
    p0t = {"c": p0[:, :t.nc], "q": p0[:, t.nc:].reshape(-1, t.n_points, 3)}
    rt = batched_optimize(t.products_tree_obs, p0t, tl.DoglegParameters(),
                          problem_data=obs_b,
                          newton_solver=t.tree_newton_solver(),
                          record_history=True)
    _assert_same_solves(
        rt, rj, flat_p=lambda c, q: np.concatenate(
            [c, q.reshape(q.shape[0], -1)], 1))


def test_elements_match_their_single_solves():
    """Each element of the batch takes the decisions of the port's own
    single solve of that element, History included."""
    t, obs_b, p0 = _port_pinhole()
    rb = _port_pinhole_solve()
    prm = tl.DoglegParameters(**PRM)
    for i in range(obs_b.shape[0]):
        ri = tl.solve_products(
            lambda p, o=obs_b[i]: t.products_obs(p, o),
            {k: v[i] for k, v in p0.items()}, prm,
            newton_solver=t.newton_solver(), record_history=True)
        one = tv.tree_map(lambda a: a[None], ri._replace(JtJ=None))
        _assert_same_solves(one, tv.tree_map(lambda a: a[i:i + 1],
                                             rb._replace(JtJ=None)),
                            history_rtol=PINHOLE_HISTORY)


def test_batch_of_one_matches_single_solve():
    t, obs_b, p0 = _port_linear()
    r1 = batched_optimize(t.products_obs, p0[2:3], tl.DoglegParameters(),
                          problem_data=obs_b[2:3],
                          newton_solver=t.newton_solver(),
                          record_history=True)
    rs = tl.solve_products(lambda p: t.products_obs(p, obs_b[2]), p0[2],
                           tl.DoglegParameters(),
                           newton_solver=t.newton_solver(),
                           record_history=True)
    assert r1.p.shape == (1, t.nstate) and r1.history.rho.shape[0] == 1
    _assert_same_solves(r1, tv.tree_map(lambda a: a[None],
                                        rs._replace(JtJ=None)))


@pytest.mark.parametrize("capacity", [1, 2, 6])
def test_compacted_gives_the_same_bits(capacity):
    """batched_optimize_compacted over tree states, SchurJtJ and History:
    every leaf of the result equals batched_optimize's bit for bit, with
    the stragglers finished in a smaller batch (capacity 1 and 2) or all
    of them at once."""
    t, obs_b, p0 = _port_pinhole()
    ref = _port_pinhole_solve()
    rc = batched_optimize_compacted(
        t.products_obs, p0, tl.DoglegParameters(**PRM), problem_data=obs_b,
        newton_solver=t.newton_solver(), record_history=True,
        compact_capacity=capacity)
    got, want = tv.tree_leaves(rc), tv.tree_leaves(ref)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert _same_bits(a, b)


def test_history_capacity_and_segments():
    """A short History keeps the last attempt in its last row, per element;
    the segmented run (max_new_attempts) resumes to the same result."""
    t, obs_b, p0 = _port_pinhole()
    prm = tl.DoglegParameters(**PRM)
    fn = torch.func.vmap(t.products_obs)

    def products(p):
        return fn(p, obs_b)
    ns = t.newton_solver()
    st = tl.init_batched_state(products, p0, prm, record_history=True,
                               history_capacity=3)
    assert st.history.rho.shape == (obs_b.shape[0], 3)
    st = tl.run_batched_solver(products, st, prm, newton_solver=ns,
                               max_new_attempts=2)
    assert int(st.n_attempts.max()) == 2
    full = tl.result_from_batched_state(
        tl.run_batched_solver(products, st, prm, newton_solver=ns))
    ref = _port_pinhole_solve()
    for field in ("step_count", "n_attempts", "reason"):
        assert torch.equal(getattr(full, field), getattr(ref, field))
    last = (ref.n_attempts - 1).clamp(min=0).long()
    rows = torch.arange(obs_b.shape[0])
    moved = ref.n_attempts > 0
    assert torch.equal(full.history.step_type[rows, last.clamp(max=2)][moved],
                       ref.history.step_type[rows, last][moved])
    assert torch.equal(full.history.step_type[~moved],
                       ref.history.step_type[~moved, :3])


# ---------------------------------------------------------------------------
# the batched Schur strategies
# ---------------------------------------------------------------------------

NC, NP, BS = 5, 12, 3
SINGULAR = (1, 4)   # elements with a zeroed point block


@functools.lru_cache(maxsize=None)
def _schur_stack():
    """Six (U, W, V, b) arrow systems as numpy stacks; elements 1 and 4
    carry a singular point block."""
    rng = np.random.default_rng(11)
    n = NC + NP * BS
    out = []
    for e in range(6):
        J = rng.normal(size=(3 * n, n))
        JtJ = J.T @ J
        V = np.stack([JtJ[NC + i * BS:NC + (i + 1) * BS,
                          NC + i * BS:NC + (i + 1) * BS] for i in range(NP)])
        if e in SINGULAR:
            V[e + 2] = 0.0
        out.append((JtJ[:NC, :NC], JtJ[:NC, NC:].reshape(NC, NP, BS), V,
                    rng.normal(size=n)))
    return tuple(np.stack(parts) for parts in zip(*out))


def _split(b, mod):
    return {"c": mod(b[..., :NC]),
            "q": mod(b[..., NC:].reshape(b.shape[:-1] + (NP, BS)))}


@functools.lru_cache(maxsize=None)
def _jax_schur_gn(tree):
    U, W, V, b = _schur_stack()
    cls = jnewton.TreeSchurNewtonSolver if tree else jnewton.SchurNewtonSolver
    ns = cls(nc=NC, n_points=NP, block_size=BS)

    def one(u, w, v, rhs):
        rhs = _split(rhs, lambda x: x) if tree else rhs
        return ns.gauss_newton(jnewton.SchurJtJ(U=u, W=w, V=v), rhs,
                               jnp.asarray(0.0), **KW)
    return jax.device_get(jax.jit(jax.vmap(one))(U, W, V, b))


@pytest.mark.parametrize("point_solver", ["unrolled", "lax"])
@pytest.mark.parametrize("tree", [False, True])
def test_batched_gauss_newton_matches_unbatched_and_jax(tree, point_solver):
    U, W, V, b = (torch.as_tensor(a) for a in _schur_stack())
    cls = tnewton.TreeSchurNewtonSolver if tree else tl.SchurNewtonSolver
    ns = cls(nc=NC, n_points=NP, block_size=BS, point_solver=point_solver)
    rhs = _split(b, lambda x: x) if tree else b
    lam0 = torch.zeros(6, dtype=torch.float64)
    res = ns.gauss_newton(tl.SchurJtJ(U=U, W=W, V=V), rhs, lam0, **KW)
    assert res.ok.shape == (6,) and bool(res.ok.all())
    escalated = torch.nonzero(res.lam > 0)[:, 0].tolist()
    assert escalated == list(SINGULAR)
    for e in range(6):
        one = ns.gauss_newton(tl.SchurJtJ(U=U[e], W=W[e], V=V[e]),
                              tv.tree_map(lambda x: x[e], rhs),
                              torch.tensor(0.0, dtype=torch.float64), **KW)
        assert float(one.lam) == float(res.lam[e]) and bool(one.ok)
        for x, y in zip(tv.tree_leaves(one.step), tv.tree_leaves(res.step)):
            np.testing.assert_allclose(y[e].numpy(), x.numpy(), rtol=1e-12,
                                       atol=1e-12)
        np.testing.assert_allclose(float(res.norm2_step[e]),
                                   float(one.norm2_step), rtol=1e-12)
    rj = _jax_schur_gn(tree)
    np.testing.assert_array_equal(res.lam.numpy(), np.asarray(rj.lam))
    np.testing.assert_array_equal(res.ok.numpy(), np.asarray(rj.ok))
    for x, y in zip(tv.tree_leaves(res.step),
                    jax.tree_util.tree_leaves(rj.step)):
        _close_rows(x, y)


@pytest.mark.parametrize("tree", [False, True])
def test_batched_gauss_newton_inactive_elements_keep_lambda(tree):
    """Only active elements escalate: a singular element left inactive
    keeps its lambda and reports its failed factor; with no escalation
    allowed, only the singular elements fail."""
    U, W, V, b = (torch.as_tensor(a) for a in _schur_stack())
    cls = tnewton.TreeSchurNewtonSolver if tree else tl.SchurNewtonSolver
    ns = cls(nc=NC, n_points=NP, block_size=BS)
    rhs = _split(b, lambda x: x) if tree else b
    jtj = tl.SchurJtJ(U=U, W=W, V=V)
    lam0 = torch.full((6,), 1e-12, dtype=torch.float64)
    active = torch.tensor([True, False, True, True, True, True])
    res = ns.gauss_newton(jtj, rhs, lam0, active=active, **KW)
    assert float(res.lam[1]) == 1e-12 and not bool(res.ok[1])
    assert float(res.lam[4]) > 1e-12 and bool(res.ok[4])
    assert torch.equal(res.lam[[0, 2, 3, 5]], lam0[[0, 2, 3, 5]])
    stuck = ns.gauss_newton(jtj, rhs, torch.zeros(6, dtype=torch.float64),
                            lambda_initial=1e-10, lambda_max_tries=0)
    assert torch.nonzero(~stuck.ok)[:, 0].tolist() == list(SINGULAR)
    (_, _), ok = ns.factor(jtj, torch.zeros(6, dtype=torch.float64))
    assert torch.equal(ok, stuck.ok)


# ---------------------------------------------------------------------------
# the batched tree reductions
# ---------------------------------------------------------------------------


def test_batched_treevec_matches_jax_vmap():
    rng = np.random.default_rng(4)
    trees = [{"q": rng.normal(size=(5, 4, 3)), "c": rng.normal(size=(5, 6))}
             for _ in range(2)]
    trees[0]["q"][2, 1, 1] = np.nan
    tt = [{k: torch.as_tensor(v) for k, v in t.items()} for t in trees]
    jt = [jax.tree_util.tree_map(jnp.asarray, t) for t in trees]
    np.testing.assert_allclose(
        tv.batch_dot(*tt).numpy(),
        np.asarray(jax.vmap(jtv.tree_dot)(*jt)), rtol=1e-14)
    for thr in (0.5, 2.0, 3.5):
        np.testing.assert_array_equal(
            tv.batch_any_exceeds(tt[0], thr).numpy(),
            np.asarray(jax.vmap(lambda a: jtv.tree_any_exceeds(a, thr))(
                jt[0])))
    mask = np.array([True, False, True, False, False])
    got = tv.batch_where(torch.as_tensor(mask), tt[0], tt[1])
    want = jax.vmap(jtv.tree_where)(jnp.asarray(mask), jt[0], jt[1])
    for k in ("c", "q"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    k = rng.normal(size=5)
    got = tv.batch_scale(torch.as_tensor(k), tt[1])
    want = jax.vmap(jtv.tree_scale)(jnp.asarray(k), jt[1])
    for name in ("c", "q"):
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]))


def test_batched_treevec_on_a_bare_tensor_is_the_flat_ops():
    rng = np.random.default_rng(8)
    a, b = (torch.as_tensor(rng.normal(size=(7, 9))) for _ in range(2))
    a[3, 2] = float("nan")
    mask = torch.as_tensor(rng.normal(size=7) > 0)
    k = torch.as_tensor(rng.normal(size=7))

    def bits(x):
        return x.view(torch.int64) if x.dtype == torch.float64 else x
    assert torch.equal(bits(tv.batch_dot(a, b)), bits((a * b).sum(-1)))
    assert torch.equal(tv.batch_any_exceeds(a, 1.0),
                       (a.abs() > 1.0).any(-1))
    assert torch.equal(bits(tv.batch_where(mask, a, b)),
                       bits(torch.where(mask[:, None], a, b)))
    assert torch.equal(bits(tv.batch_scale(k, a)), bits(k[:, None] * a))


def test_block_diag_keeps_the_bits_of_the_in_place_form():
    """The out-of-place block_diag equals the old diagonal-view write bit
    for bit, NaN and -0.0 included, and batches under torch.func.vmap."""
    rng = np.random.default_rng(9)
    blocks = torch.as_tensor(rng.normal(size=(4, 3, 3)))
    blocks[1, 0, 2] = float("nan")
    blocks[2, 1, 1] = -0.0

    def in_place(bl):
        m, s, _ = bl.shape
        out = bl.new_zeros((m, s, m, s))
        idx = torch.arange(m)
        out[idx, :, idx, :] = bl
        return out.reshape(m * s, m * s)
    want = in_place(blocks)
    got = tnewton.block_diag(blocks)
    assert torch.equal(got.view(torch.int64), want.view(torch.int64))
    stack = torch.stack([blocks, 2 * blocks])
    for batched in (torch.func.vmap(tnewton.block_diag)(stack),
                    tnewton.block_diag(stack)):
        assert torch.equal(batched[1].view(torch.int64),
                           in_place(2 * blocks).view(torch.int64))


def test_result_crosses_to_numpy():
    """interop.result_to_numpy takes a batch-leading result with a tree p
    and a History."""
    r = interop.result_to_numpy(_port_pinhole_solve())
    assert isinstance(r.p["q"], np.ndarray) and r.p["q"].shape[0] == 6
    assert isinstance(r.history.rho, np.ndarray)
    assert r.history.rho.shape[0] == 6
    assert isinstance(r.JtJ.W, np.ndarray)
