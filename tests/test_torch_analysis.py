"""The port's analysis suite (libdogleg_tpu_torch.analysis) and its matrix
right-hand-side cholesky_solve against the JAX package, in float64 on the
CPU, on the same numpy inputs.

Replays tests/test_analysis.py: outlierness factors at the sample problem's
solved point (feature sizes 1, 2, 4), the planted outlier, the scale, the
mark_outliers gate and its report, the query-point traces on a dense and a
block-sparse factor (windows in range, before the start and past the end),
the bundle-adjustment factors from the Schur factors, and the gradient
checks. The JAX side is jitted once per case and cached for the module.

Tolerances: cholesky_solve 1e-10 of the largest entry; factors and traces
rtol 1e-10 against JAX (1e-8 against the test's numpy oracle); BA factors
rtol 1e-9, atol 1e-12 against JAX at the same operating point; gradient
checks rtol 1e-8 (the finite difference amplifies the last bits of x).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libdogleg_tpu as dl
import libdogleg_tpu.sample_problem as jsp
from libdogleg_tpu import analysis as ja
from libdogleg_tpu.models import pinhole_ba as jpb
from libdogleg_tpu.ops import cholesky as jchol
import libdogleg_tpu_torch as tl
import libdogleg_tpu_torch.sample_problem as tsp
from libdogleg_tpu_torch import analysis as ta
from libdogleg_tpu_torch import interop
from libdogleg_tpu_torch import sparse_cholesky as tsc
from libdogleg_tpu_torch.ops import cholesky as tchol
from libdogleg_tpu_torch.problems import DenseProblem

torch.set_num_threads(1)


def _t(a):
    return torch.as_tensor(np.array(a))


def _np(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) else \
        np.asarray(a)


def _spd(n, rng, batch=()):
    A = rng.normal(size=batch + (n, n))
    return A @ np.swapaxes(A, -1, -2) + n * np.eye(n)


# ------------------------------------------------- cholesky_solve (repair)

@pytest.mark.parametrize("n", [8, 64])
@pytest.mark.parametrize("rhs", ["vector", "matrix", "square"])
def test_cholesky_solve_matches_jax(n, rhs):
    """(n,), (n, k) with k != n and (n, n) right-hand sides, on both the
    unrolled (n = 8) and the triangular-solve (n = 64) branches: the port
    equals JAX's cholesky_solve and numpy's solve."""
    rng = np.random.default_rng(n)
    S = _spd(n, rng)
    L = np.linalg.cholesky(S)
    b = rng.normal(size={"vector": (n,), "matrix": (n, 5),
                         "square": (n, n)}[rhs])
    want = np.asarray(jchol.cholesky_solve(jnp.asarray(L), jnp.asarray(b)))
    got = _np(tchol.cholesky_solve(_t(L), _t(b)))
    assert got.shape == want.shape == b.shape
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10 * scale)
    np.testing.assert_allclose(got, np.linalg.solve(S, b), rtol=0,
                               atol=1e-10 * scale)


@pytest.mark.parametrize("n", [8, 64])
@pytest.mark.parametrize("rhs", ["vector", "matrix"])
def test_cholesky_solve_batched_matches_jax(n, rhs):
    """A (B, n, n) batch of factors with (B, n) and (B, n, k) right-hand
    sides against JAX's cholesky_solve mapped over the batch."""
    rng = np.random.default_rng(100 + n)
    S = _spd(n, rng, batch=(3,))
    L = np.linalg.cholesky(S)
    b = rng.normal(size=(3, n) if rhs == "vector" else (3, n, 4))
    want = np.asarray(jax.vmap(jchol.cholesky_solve)(jnp.asarray(L),
                                                     jnp.asarray(b)))
    got = _np(tchol.cholesky_solve(_t(L), _t(b)))
    assert got.shape == want.shape == b.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-10 * np.abs(want).max())


def test_cholesky_solve_refuses_other_ranks():
    L = torch.eye(4, dtype=torch.float64)
    with pytest.raises(ValueError):
        tchol.cholesky_solve(L, torch.ones(2, 3, 4, dtype=torch.float64))


# ------------------------------------------------------------ outlierness

@functools.lru_cache(maxsize=None)
def _measurements(planted):
    meas = jsp.simulate(jax.random.PRNGKey(0))
    if planted:
        meas = meas.at[37].add(50.0)
    return np.asarray(meas)


@functools.lru_cache(maxsize=None)
def _solved_point(planted=False):
    """x, J, JtJ, lam, norm2_x, p at the JAX package's solved point of the
    sample problem, as numpy."""
    problem = jsp.make_dense_problem(jnp.asarray(_measurements(planted)))
    r = jax.jit(lambda p: dl.optimize(problem, p))(
        jsp.initial_state(jax.random.PRNGKey(1)))
    x, J = problem.full(r.p)
    return tuple(np.asarray(a) for a in (x, J, r.JtJ, r.lam, r.norm2_x, r.p))


def _np_factor(JtJ, lam=0.0):
    """numpy's lower factor of JtJ + lam I: the JAX side's L (the JAX
    package's factorize_jtj compiles for seconds per shape)."""
    return jnp.asarray(np.linalg.cholesky(
        np.asarray(JtJ) + float(lam) * np.eye(np.shape(JtJ)[0])))


def _factors_both(x, J, JtJ, lam, **kw):
    """(port factors, port scale, JAX factors, JAX scale) on the same
    inputs, the port with its own factorize_jtj of JtJ + lam I."""
    Lj = _np_factor(JtJ, lam)
    fj, sj = ja.get_outlierness_factors(jnp.asarray(x), jnp.asarray(J), Lj,
                                        **kw)
    Lt = tchol.factorize_jtj(_t(JtJ), _t(lam)).L
    ft, st = ta.get_outlierness_factors(_t(x), _t(J), Lt, **kw)
    return _np(ft).copy(), float(st), np.array(fj), float(sj)


def _oracle_factors(x, J, feature_size):
    """The reference's own numpy self-check (dogleg.c:2748-2783), with the
    k/8 hack of dogleg.c:2374-2378 applied as the code does (a copy of
    tests/test_analysis.py's oracle)."""
    nmeas, nstate = J.shape
    nf = nmeas // feature_size
    scale = nmeas / (4.0 * ((nstate + 1) * (x @ x) / (nmeas - nstate - 1)))
    inv_jtj = np.linalg.inv(J.T @ J)
    factors = np.zeros(nf)
    for f in range(nf):
        sl = slice(f * feature_size, (f + 1) * feature_size)
        Jf = J[sl]
        xf = x[sl]
        A = Jf @ inv_jtj @ Jf.T
        if feature_size == 1:
            factors[f] = float(xf[0] ** 2 / (1.0 - A[0, 0]))
        else:
            B = np.linalg.inv(A - np.eye(feature_size))
            factors[f] = float(xf @ (B + B @ B) @ xf)
    return factors * scale / 8.0, scale


@pytest.mark.parametrize("feature_size", [1, 2, 4])
def test_outlierness_factors_match_jax_and_oracle(feature_size):
    x, J, JtJ, lam, _, _ = _solved_point()
    ft, st, fj, sj = _factors_both(x, J, JtJ, lam, feature_size=feature_size)
    assert ft.shape == (jsp.NMEAS // feature_size,)
    np.testing.assert_allclose(st, sj, rtol=1e-15)
    np.testing.assert_allclose(ft, fj, rtol=1e-10)
    oracle, oracle_scale = _oracle_factors(x, J, feature_size)
    np.testing.assert_allclose(st, oracle_scale, rtol=1e-12)
    np.testing.assert_allclose(ft, oracle, rtol=1e-8)


def test_outlierness_scale_matches_jax():
    for args in [(12.5, 100, 6, 0, 1), (3.0, 100, 6, 3, 2),
                 (1e4, 100000, 64, 17, 2)]:
        np.testing.assert_allclose(
            float(ta.get_outlierness_scale(torch.tensor(args[0],
                                                        dtype=torch.float64),
                                           *args[1:])),
            float(ja.get_outlierness_scale(jnp.asarray(args[0]), *args[1:])),
            rtol=1e-15)


@pytest.mark.parametrize("feature_size", [1, 2, 4])
def test_singular_leverage_returns_unscaled_max(feature_size):
    """A row whose state only it touches has leverage 1: both packages
    return the dtype's largest value, unscaled, for its feature."""
    rng = np.random.default_rng(5)
    J = np.zeros((32, 5))
    J[:, :4] = rng.normal(size=(32, 4))
    J[7, 4] = 1.3
    x = rng.normal(size=32)
    ft, _, fj, _ = _factors_both(x, J, J.T @ J, 0.0,
                                 feature_size=feature_size)
    big = np.finfo(np.float64).max
    assert ft[7 // feature_size] == big and fj[7 // feature_size] == big
    np.testing.assert_allclose(ft, fj, rtol=1e-10)


def test_planted_outlier_flagged_like_jax():
    """One measurement corrupted hard: the port's own solve ends where the
    JAX package's does, and the factors at that point single it out, as
    JAX's do."""
    x, J, JtJ, lam, _, p = _solved_point(planted=True)
    problem = tsp.make_dense_problem(_t(_measurements(True)))
    r = tl.optimize(problem, tsp.initial_state(torch.Generator().manual_seed(
        1), device="cpu").new_tensor(np.asarray(
            jsp.initial_state(jax.random.PRNGKey(1)))))
    np.testing.assert_allclose(_np(r.p), p, rtol=1e-9, atol=1e-12)
    ft, _, fj, _ = _factors_both(x, J, JtJ, lam, feature_size=1)
    np.testing.assert_allclose(ft, fj, rtol=1e-10)
    assert int(np.argmax(ft)) == 37 and ft[37] > 1.0


def test_scale_reuse_convention():
    x, J, JtJ, lam, _, _ = _solved_point()
    L = tchol.factorize_jtj(_t(JtJ), _t(lam)).L
    f1, scale = ta.get_outlierness_factors(_t(x), _t(J), L)
    f2, scale2 = ta.get_outlierness_factors(_t(x), _t(J), L, scale=scale)
    assert float(scale2) == float(scale)
    assert torch.equal(f1, f2)
    # n_outlier_features enters the scale as in JAX
    _, s3 = ta.get_outlierness_factors(_t(x), _t(J), L, n_outlier_features=3)
    Lj = _np_factor(JtJ, lam)
    _, s3j = ja.get_outlierness_factors(jnp.asarray(x), jnp.asarray(J), Lj,
                                        n_outlier_features=3)
    np.testing.assert_allclose(float(s3), float(s3j), rtol=1e-15)


def _gate_callbacks():
    """Confidence callbacks, each made afresh per package: candidates
    accepted, confidence collapsing, a negative baseline, and one that goes
    negative at the second candidate it is asked about."""
    def midway():
        asked = []

        def conf(i):
            if i < 0:
                return 100.0
            asked.append(i)
            return 99.9 if len(asked) < 2 else -1.0
        return conf
    return {
        "accept": lambda: (lambda i: 100.0 if i < 0 else 99.9),
        "collapse": lambda: (lambda i: 100.0 if i < 0 else 10.0),
        "negative_baseline": lambda: (lambda i: -1.0),
        "negative_midway": midway,
    }


@pytest.mark.parametrize("case", ["accept", "collapse", "negative_baseline",
                                  "negative_midway"])
@pytest.mark.parametrize("premarked", [False, True])
def test_mark_outliers_gate_matches_jax(case, premarked):
    x, J, JtJ, lam, _, _ = _solved_point(planted=True)
    ft, _, fj, _ = _factors_both(x, J, JtJ, lam, feature_size=1)
    # more candidates than the planted one, so the midway case has a second
    ft[[3, 50, 90]] = fj[[3, 50, 90]] = [2.0, 1.5, 7.0]
    pre = None
    if premarked:
        pre = np.zeros(ft.shape[0], bool)
        pre[5] = True
    make = _gate_callbacks()[case]
    got = ta.mark_outliers(torch.as_tensor(ft), make(), marked=pre)
    want = ja.mark_outliers(jnp.asarray(fj), make(), marked=pre)
    np.testing.assert_array_equal(got.marked, want.marked)
    assert got.n_outliers == want.n_outliers
    assert got.marked_any == want.marked_any
    if case == "accept":
        assert got.marked[37] and got.marked_any


def test_report_outliers_text_matches_jax():
    x, J, JtJ, lam, _, _ = _solved_point()
    ft, _, fj, _ = _factors_both(x, J, JtJ, lam, feature_size=1)
    conf = (lambda i: 100.0 if i < 0 else 99.0 - 0.01 * i)
    got = ta.report_outliers(torch.as_tensor(ft[:9]), conf)
    assert got == ja.report_outliers(jnp.asarray(fj[:9]), conf)
    assert got.startswith("## Outlier statistics")
    assert len(got.strip().split("\n")) == 2 + 9


# -------------------------------------------------------- query traces

def test_query_trace_matches_jax():
    x, J, JtJ, lam, n2, _ = _solved_point()
    rng = np.random.default_rng(0)
    Jq = rng.normal(size=(2, jsp.NSTATE))
    Lj = _np_factor(JtJ, lam)
    Lt = tchol.factorize_jtj(_t(JtJ), _t(lam)).L
    want = ja.outlierness_trace_new_feature(jnp.asarray(Jq), Lj,
                                            jnp.asarray(n2), jsp.NMEAS)
    got = ta.outlierness_trace_new_feature(_t(Jq), Lt, _t(n2), jsp.NMEAS)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-10)
    zero = ta.outlierness_trace_new_feature(
        torch.zeros(2, jsp.NSTATE, dtype=torch.float64), Lt, _t(n2),
        jsp.NMEAS)
    assert abs(float(zero)) <= 1e-12


def _block_factor(JtJ, nb, b):
    """The port's block-sparse factor of the dense-pattern JtJ: (solve_fn,
    ok)."""
    rows, cols = zip(*[(i, j) for i in range(nb) for j in range(i + 1)])
    rows, cols = np.asarray(rows), np.asarray(cols)
    blocks = _t(np.stack([JtJ[i * b:(i + 1) * b, j * b:(j + 1) * b]
                          for i, j in zip(rows, cols)]))
    sym = tsc.analyze(rows, cols, nb, b)
    L, ok = tsc.factorize(sym, blocks, torch.tensor(0.0,
                                                    dtype=torch.float64))
    return (lambda r: tsc.solve(sym, L, r)), bool(ok)


@pytest.mark.parametrize("b", [2, 3])
def test_query_trace_on_sparse_factor_matches_jax(b):
    """The trace off the port's block-sparse factor (solve_fn) equals the
    JAX package's off its dense factor."""
    rng = np.random.default_rng(9)
    nb = 6
    nstate = nb * b
    J = rng.normal(size=(40, nstate))
    JtJ = J.T @ J
    Jq = rng.normal(size=(2, nstate))
    want = ja.outlierness_trace_new_feature(jnp.asarray(Jq), _np_factor(JtJ),
                                            jnp.asarray(12.0), 40)
    solve_fn, ok = _block_factor(JtJ, nb, b)
    assert ok
    got = ta.outlierness_trace_new_feature(
        _t(Jq), None, torch.tensor(12.0, dtype=torch.float64), 40,
        solve_fn=solve_fn)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-10)


def _window_case(seed, nstate, nmeas):
    rng = np.random.default_rng(seed)
    J = rng.normal(size=(nmeas, nstate))
    JtJ = J.T @ J
    Lj = _np_factor(JtJ)
    Lt = tchol.factorize_jtj(_t(JtJ), torch.tensor(0.0,
                                                   dtype=torch.float64)).L
    return rng, JtJ, Lj, Lt


@pytest.mark.parametrize("fs,w", [(1, 4), (2, 5), (3, 6)])
def test_windowed_traces_match_jax(fs, w):
    """Windows in range, narrower windows zero-padded, one before the start
    and one past the end: the port's windowed traces against JAX's, and
    against its own dense form on the zero-padded Jq."""
    nstate, nmeas = 24, 96
    rng, _, Lj, Lt = _window_case(21, nstate, nmeas)
    starts = np.array([0, 3, 11, nstate - w, 5, -3, 22, 30, -10])
    Jq_win = rng.normal(size=(len(starts), fs, w))
    Jq_win[1, :, -2:] = 0.0
    want = ja.outlierness_trace_new_features_windowed(
        jnp.asarray(Jq_win), jnp.asarray(starts), Lj, jnp.asarray(37.5),
        nmeas)
    got = ta.outlierness_trace_new_features_windowed(
        _t(Jq_win), _t(starts), Lt, torch.tensor(37.5, dtype=torch.float64),
        nmeas)
    assert got.shape == (len(starts),)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-10,
                               atol=1e-12)
    for q, s in enumerate(starts):
        Jq = np.zeros((fs, nstate))
        lo, hi = max(s, 0), min(s + w, nstate)
        if lo < hi:
            Jq[:, lo:hi] = Jq_win[q][:, lo - s:hi - s]
        ref = ta.outlierness_trace_new_feature(
            _t(Jq), Lt, torch.tensor(37.5, dtype=torch.float64), nmeas)
        np.testing.assert_allclose(float(got[q]), float(ref), rtol=1e-10,
                                   atol=1e-12)
    # entirely out of range: exactly zero
    assert float(got[-2]) == 0.0 and float(got[-1]) == 0.0


@pytest.mark.parametrize("b", [2, 4])
def test_windowed_traces_on_sparse_factor_match_jax(b):
    """Windowed traces off the port's block-sparse factor (solve_fn) against
    JAX's off its dense factor, windows past both ends included."""
    nb = 8
    nstate = nb * b
    rng, JtJ, Lj, _ = _window_case(22, nstate, 64)
    nq, fs, w = 6, 2, 4
    Jq_win = rng.normal(size=(nq, fs, w))
    starts = np.array([0, 4, 7, nstate - 3, -2, 2])
    want = ja.outlierness_trace_new_features_windowed(
        jnp.asarray(Jq_win), jnp.asarray(starts), Lj, jnp.asarray(10.0), 64)
    solve_fn, ok = _block_factor(JtJ, nb, b)
    assert ok
    got = ta.outlierness_trace_new_features_windowed(
        _t(Jq_win), _t(starts), None, torch.tensor(10.0, dtype=torch.float64),
        64, nstate=nstate, solve_fn=solve_fn)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-10)
    with pytest.raises(ValueError):
        ta.outlierness_trace_new_features_windowed(
            _t(Jq_win), _t(starts), None, 10.0, 64, solve_fn=solve_fn)


# ------------------------------------------------- bundle adjustment

@functools.lru_cache(maxsize=None)
def _ba_case():
    """The JAX instance, the port's, and the port's float64 solve from the
    JAX package's start."""
    jba = jpb.make_synthetic_sparse(seed=3, ncam=6, npts=60, k_obs=3)
    tba = interop.pinhole_ba_from_reference(jba, device="cpu")
    p0 = interop.tree_from_numpy(
        jax.device_get(jba.p0(jax.random.PRNGKey(2), jitter=0.02)),
        device="cpu")
    r = tl.solve_products(tba.products, p0, tl.DoglegParameters(),
                          newton_solver=tba.newton_solver())
    return jba, tba, r


@functools.lru_cache(maxsize=None)
def _jax_ba_pass(chunk):
    """JAX's get_outlierness_factors_ba at a given point, jitted once per
    chunk, the factorization passed in (bench_all.py config 7o's form)."""
    jba = _ba_case()[0]
    solver = jba.newton_solver()
    nmeas = 2 * jba.nobs + 6 + 3 * jba.npts

    def outl(pc, pq, lam, n2, fac):
        p = {"c": pc, "q": pq}
        robs, Jc, Jq = jba.observation_jacobians(p)
        return ja.get_outlierness_factors_ba(
            robs, Jc, Jq, jba.products(p).JtJ, lam, n2, nmeas, solver,
            chunk=chunk, factorization=fac)
    return jax.jit(outl)


@functools.lru_cache(maxsize=None)
def _jax_ba_factor():
    jba = _ba_case()[0]
    solver = jba.newton_solver()
    return jax.jit(lambda pc, pq, lam: solver.factor(
        jba.products({"c": pc, "q": pq}).JtJ, lam))


def _ba_port_pass(tba, p, lam, n2, **kw):
    robs, Jc, Jq = tba.observation_jacobians(p)
    nmeas = 2 * tba.nobs + 6 + 3 * tba.npts
    return ta.get_outlierness_factors_ba(
        robs, Jc, Jq, tba.products(p).JtJ, lam, n2, nmeas,
        tba.newton_solver(), **kw)


def _ba_jax_pass(p, lam, n2, chunk):
    pc, pq = (jnp.asarray(_np(p[k])) for k in ("c", "q"))
    lam_j = jnp.asarray(_np(lam))
    fac = _jax_ba_factor()(pc, pq, lam_j)
    f, s = _jax_ba_pass(chunk)(pc, pq, lam_j, jnp.asarray(_np(n2)), fac)
    return np.asarray(f), float(s)


def _ba_exact_factors(JtJ, lam, robs, Jc, Jq, scale):
    """The featureSize-2 factors of every observation evaluated in extended
    precision (numpy longdouble, 64-bit significand) from the float64
    inputs the pass was given: the dense JtJ + lam I inverted by
    Gauss-Jordan, A_f from each observation's 9 columns. What float64
    arithmetic can deliver here is bounded by this, not by agreement
    between two float64 orders of summation."""
    ld = np.longdouble
    U, Wv, cam_of, V = (_np(a) for a in (JtJ.U, JtJ.Wv, JtJ.cam_of, JtJ.V))
    npts, k_obs = cam_of.shape
    nc = U.shape[0]
    n = nc + 3 * npts
    H = np.zeros((n, n), ld)
    H[:nc, :nc] = U
    for pi in range(npts):
        q = slice(nc + 3 * pi, nc + 3 * pi + 3)
        for kk in range(k_obs):
            c = slice(6 * cam_of[pi, kk], 6 * cam_of[pi, kk] + 6)
            H[c, q] += Wv[pi, kk]
            H[q, c] += Wv[pi, kk].T
        H[q, q] = V[pi]
    H += ld(float(lam)) * np.eye(n, dtype=ld)
    G = np.concatenate([H, np.eye(n, dtype=ld)], 1)
    for i in range(n):             # SPD: no pivoting
        G[i] /= G[i, i]
        col = G[:, i].copy()
        col[i] = 0
        G -= np.outer(col, G[i])
    Hinv = G[:, n:]
    robs, Jc, Jq = (_np(a).astype(ld) for a in (robs, Jc, Jq))
    out = np.zeros((npts, k_obs))
    for pi in range(npts):
        for kk in range(k_obs):
            idx = np.r_[6 * cam_of[pi, kk]:6 * cam_of[pi, kk] + 6,
                        nc + 3 * pi:nc + 3 * pi + 3]
            Jf = np.concatenate([Jc[pi, kk], Jq[pi, kk]], 1)
            AmI = Jf @ Hinv[np.ix_(idx, idx)] @ Jf.T - np.eye(2, dtype=ld)
            B = np.linalg.inv(AmI.astype(np.float64)).astype(ld)
            # one Newton step takes the 2x2 inverse to extended precision
            B = B + B @ (np.eye(2, dtype=ld) - AmI @ B)
            x = robs[pi, kk]
            out[pi, kk] = float(x @ (B + B @ B) @ x)
    return out * scale / 8.0


@pytest.mark.parametrize("chunk", [16, 64])
def test_ba_outlierness_matches_jax(chunk):
    """At the port's solved point, chunk 16 (a short last chunk of 12
    points) and chunk >= npts: the port's factors against JAX's and
    against an extended-precision evaluation from the same inputs, and
    (chunk 16) against the port's dense entry point on the densified
    system.

    The factors of this instance are ill-conditioned (S has condition
    number ~1.7e8 under the 1e6 camera-0 prior, and A_f is a sum of large
    terms that cancel to a leverage below 1): the JAX package itself lies
    2e-8 from the extended-precision factors, and two float64 orders of
    summation differ by as much even on identical inputs, factors and
    S^-1. So each package is held to the extended-precision factors, and
    the two to each other, at the JAX package's own tolerance for these
    factors (tests/test_analysis.py:431-432); the scale, which no
    cancellation touches, at 1e-15."""
    _, tba, r = _ba_case()
    assert int(r.reason) > 0
    ft, st = _ba_port_pass(tba, r.p, r.lam, r.norm2_x, chunk=chunk)
    fj, sj = _ba_jax_pass(r.p, r.lam, r.norm2_x, chunk)
    assert ft.shape == (tba.npts, tba.k_obs)
    np.testing.assert_allclose(float(st), sj, rtol=1e-15)
    np.testing.assert_allclose(_np(ft), fj, rtol=1e-7, atol=1e-10)
    robs, Jc, Jq = tba.observation_jacobians(r.p)
    exact = _ba_exact_factors(tba.products(r.p).JtJ, r.lam, robs, Jc, Jq,
                              float(st))
    np.testing.assert_allclose(_np(ft), exact, rtol=1e-7, atol=1e-10)
    np.testing.assert_allclose(fj, exact, rtol=1e-7, atol=1e-10)
    if chunk == 16:
        _ba_matches_dense(tba, r, _np(ft), float(st))


def _ba_matches_dense(tba, r, fac_ba, scale_ba):
    """tests/test_analysis.py's dense oracle through the port: projection
    rows first (feature pairs), then the prior rows."""
    p = r.p
    robs, Jc, Jq = (_np(a) for a in tba.observation_jacobians(p))
    nc = tba.ncam * 6
    nmeas = 2 * tba.nobs + 6 + 3 * tba.npts
    J = np.zeros((nmeas, tba.nstate))
    x = np.zeros(nmeas)
    cam_of = _np(tba.cam_of)
    row = 0
    for pi in range(tba.npts):
        for kk in range(tba.k_obs):
            ci = int(cam_of[pi, kk])
            for a in range(2):
                x[row] = robs[pi, kk, a]
                J[row, ci * 6:(ci + 1) * 6] = Jc[pi, kk, a]
                J[row, nc + 3 * pi:nc + 3 * pi + 3] = Jq[pi, kk, a]
                row += 1
    sw0, swp = np.sqrt(tba.w_prior_cam0), np.sqrt(tba.w_prior_pts)
    pc, q = _np(p["c"]), _np(p["q"])
    c0, qp = _np(tba.cam0_prior), _np(tba.pts_prior)
    for i in range(6):
        x[row] = sw0 * (pc[i] - c0[i])
        J[row, i] = sw0
        row += 1
    for pi in range(tba.npts):
        for j in range(3):
            x[row] = swp * (q[pi, j] - qp[pi, j])
            J[row, nc + 3 * pi + j] = swp
            row += 1
    assert row == nmeas
    L = tchol.factorize_jtj(_t(J.T @ J), r.lam).L
    fd, scale_d = ta.get_outlierness_factors(_t(x), _t(J), L, feature_size=2)
    np.testing.assert_allclose(scale_ba, float(scale_d), rtol=1e-10)
    np.testing.assert_allclose(
        fac_ba, _np(fd)[:tba.nobs].reshape(tba.npts, tba.k_obs), rtol=1e-7,
        atol=1e-10)


def test_ba_outlierness_factor_reuse_bit_identical():
    """A precomputed solver.factor(JtJ, lam) passed in gives the bits of the
    pass that factorizes by itself."""
    _, tba, r = _ba_case()
    solver = tba.newton_solver()
    fac = solver.factor(tba.products(r.p).JtJ, r.lam)
    assert bool(fac[1])
    f_reused, s1 = _ba_port_pass(tba, r.p, r.lam, r.norm2_x,
                                 factorization=fac)
    f_fresh, s2 = _ba_port_pass(tba, r.p, r.lam, r.norm2_x)
    assert float(s1) == float(s2)
    assert torch.equal(f_reused.view(torch.int64), f_fresh.view(torch.int64))


def test_ba_outlierness_failed_factor_gives_nan():
    """A factorization that fails (ok False: lambda far below zero makes
    the point blocks indefinite) gives NaN in every factor, in both
    packages."""
    _, tba, r = _ba_case()
    lam = torch.tensor(-1e6, dtype=torch.float64)
    fac = tba.newton_solver().factor(tba.products(r.p).JtJ, lam)
    assert not bool(fac[1])
    ft, _ = _ba_port_pass(tba, r.p, lam, r.norm2_x)
    assert bool(torch.isnan(ft).all())
    fj, _ = _ba_jax_pass(r.p, lam, r.norm2_x, 64)
    assert np.isnan(fj).all()


# ------------------------------------------------------------ gradients

def _problems(mode):
    """The JAX problem and the port's on the same measurements."""
    meas = _measurements(False)
    make = {"dense": ("make_dense_problem",),
            "sparse": ("make_sparse_problem",),
            "residual": ("make_residual_problem",),
            "products": ("make_products_problem",)}[mode][0]
    return (getattr(jsp, make)(jnp.asarray(meas)),
            getattr(tsp, make)(_t(meas)))


def _p0():
    return np.asarray(jsp.initial_state(jax.random.PRNGKey(1)))


@pytest.mark.parametrize("mode", ["dense", "sparse", "residual"])
def test_check_gradients_match_jax(mode):
    """Every variable: reported, observed, error and error_relative against
    JAX's at rtol 1e-8; the hand-written Jacobian passes the reference's
    check; the tables have JAX's legend, rows and fields."""
    pj, pt = _problems(mode)
    p0 = _p0()
    for ivar in range(jsp.NSTATE):
        want = ja.check_gradients(pj, jnp.asarray(p0), ivar)
        got = ta.check_gradients(pt, _t(p0), ivar)
        assert got.ivar == want.ivar == ivar
        for name in ("reported", "observed", "error", "error_relative"):
            np.testing.assert_allclose(_np(getattr(got, name)),
                                       np.asarray(getattr(want, name)),
                                       rtol=1e-8, atol=0, err_msg=name)
        assert float(got.error_relative.max()) < 1e-5
    table_t = ta.format_gradient_table(got).strip().split("\n")
    table_j = ja.format_gradient_table(want).strip().split("\n")
    assert table_t[0] == table_j[0]
    assert table_t[0].startswith("# ivar imeasurement gradient_reported")
    assert len(table_t) == len(table_j) == jsp.NMEAS + 1
    for rt, rj in zip(table_t[1:], table_j[1:]):
        ft, fj = rt.split(), rj.split()
        assert ft[:2] == fj[:2]
        np.testing.assert_allclose([float(v) for v in ft[2:]],
                                   [float(v) for v in fj[2:]], rtol=1e-8)


def test_check_gradients_detects_broken_jacobian():
    pj, pt = _problems("dense")

    def broken(p):
        x, J = pt.f(p)
        J = J.clone()
        J[:, 2] *= 1.5
        return x, J

    p0 = _t(_p0())
    assert float(ta.check_gradients(DenseProblem(f=broken), p0, 0)
                 .error_relative.max()) < 1e-5
    bad = ta.check_gradients(DenseProblem(f=broken), p0, 2)
    assert float(bad.error_relative.max()) > 0.1

    def broken_j(p):
        x, J = pj.f(p)
        return x, J.at[:, 2].mul(1.5)
    want = ja.check_gradients(dl.DenseProblem(f=broken_j), jnp.asarray(_p0()),
                              2)
    np.testing.assert_allclose(_np(bad.error_relative),
                               np.asarray(want.error_relative), rtol=1e-8)


def test_check_gradients_products_mode_matches_jax():
    """The products-mode check against JAX's. reported at rtol 1e-8.
    observed is a difference of two norm2x values of ~1e7 over delta, so
    it is held to what the two packages' norm2x evaluations give: those
    within 100 eps (a sum of 100 squares), observed within their
    differences over delta, the error within the sum of the differences in
    reported and observed (its definition |reported - observed|)."""
    from libdogleg_tpu.analysis.gradients import check_gradients_products
    pj, pt = _problems("products")
    p0 = _p0()
    eps = np.finfo(np.float64).eps
    for ivar in range(jsp.NSTATE):
        rep, obs, err, rel = (float(v) for v in ta.check_gradients_products(
            pt, _t(p0), ivar))
        rep_j, obs_j, err_j, _ = (float(v) for v in check_gradients_products(
            pj, jnp.asarray(p0), ivar))
        e = np.zeros(jsp.NSTATE)
        e[ivar] = ta.gradients.GRADTEST_DELTA / 2.0
        dn = 0.0
        for q in (p0 - e, p0 + e):
            n_t, n_j = float(pt.f(_t(q))[0]), float(pj.f(jnp.asarray(q))[0])
            assert abs(n_t - n_j) <= jsp.NMEAS * eps * abs(n_j)
            dn += abs(n_t - n_j)
        np.testing.assert_allclose(rep, rep_j, rtol=1e-8)
        assert abs(obs - obs_j) <= (dn / ta.gradients.GRADTEST_DELTA
                                    + 4 * eps * abs(obs_j))
        assert abs(err - err_j) <= abs(rep - rep_j) + abs(obs - obs_j)
        assert err == abs(rep - obs)
        assert rel < 1e-5


@pytest.mark.parametrize("mode", ["dense", "sparse"])
def test_check_gradients_autodiff(mode):
    _, pt = _problems(mode)
    rel = ta.check_gradients_autodiff(pt, _t(_p0()))
    assert rel.shape == (jsp.NMEAS, jsp.NSTATE)
    assert float(rel.max()) < 1e-12


def test_analysis_exports_match_jax():
    assert sorted(ta.__all__) == sorted(ja.__all__)
    assert ta.gradients.GRADTEST_DELTA == ja.gradients.GRADTEST_DELTA
    assert (ta.outlierness.OUTLIER_CONFIDENCE_DROP_THRESHOLD
            == ja.outlierness.OUTLIER_CONFIDENCE_DROP_THRESHOLD)
