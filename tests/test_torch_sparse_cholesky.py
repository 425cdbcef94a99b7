"""The port's block-sparse Cholesky (ordering.py, sparse_cholesky.py,
supernodal.py, ops/tilechol.py) and its sparse path (ops/bcsr.py lower
JtJ blocks, SparseNewtonSolver, SparseProblem(jtj="sparse")) against the
JAX package, on numpy-seeded inputs.

Symbolic analyses and orderings are host numpy in both packages and must be
identical array for array. Numerics are float64: factors and solves agree
to rtol 1e-12 (the port sums duplicate scatter targets and block products
in other orders than XLA); the escalated lambda and the solver's decisions
(step_count, n_attempts, reason) must be identical, with p within rtol
1e-9. Kernels K6 and K7 run on the card only; here their plain twins stand
in, held against the JAX tile ops and the Pallas kernels in interpret mode.

The JAX side is jitted and cached per module: its level scans take seconds
to compile on the CPU.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libdogleg_tpu as dl
from libdogleg_tpu import ordering as jord
from libdogleg_tpu import sparse_cholesky as jsc
from libdogleg_tpu import supernodal as jsn
from libdogleg_tpu.models import grid_mrf as jgrid
from libdogleg_tpu.ops import bcsr as jbcsr
from libdogleg_tpu.ops import newton as jnewton
from libdogleg_tpu.ops import pallas_chol
from libdogleg_tpu.problems import SparseProblem as JSparseProblem
import libdogleg_tpu_torch as tl
from libdogleg_tpu_torch import interop
from libdogleg_tpu_torch import ordering as tord
from libdogleg_tpu_torch import sparse_cholesky as tsc
from libdogleg_tpu_torch import supernodal as tsn
from libdogleg_tpu_torch.ops import bcsr as tbcsr
from libdogleg_tpu_torch.ops import tilechol

torch.set_num_threads(1)
KW = dict(lambda_initial=1e-10, lambda_max_tries=60)
RTOL = 1e-12


def _random_spd_pattern(seed, nb, b, extra_offdiag):
    """A random sparse SPD block matrix (tests/test_sparse_cholesky.py's
    construction): its dense form, stored lower blocks and the pattern."""
    rng = np.random.default_rng(seed)
    n = nb * b
    pairs = {(j, j) for j in range(nb)}
    while len(pairs) < nb + extra_offdiag:
        i = rng.integers(1, nb)
        j = rng.integers(0, i)
        pairs.add((int(i), int(j)))
    rows, cols = map(np.asarray, zip(*sorted(pairs, key=lambda t: (t[1],
                                                                   t[0]))))
    dense = np.zeros((n, n))
    blocks = []
    for i, j in zip(rows, cols):
        blk = rng.normal(size=(b, b))
        if i == j:
            blk = blk @ blk.T + b * np.eye(b) * (2 + nb * 0.5)
        else:
            blk = blk * 0.3
        dense[i * b:(i + 1) * b, j * b:(j + 1) * b] = blk
        if i != j:
            dense[j * b:(j + 1) * b, i * b:(i + 1) * b] = blk.T
        blocks.append(blk)
    assert np.linalg.eigvalsh(dense).min() > 0
    return dense, np.stack(blocks), rows, cols


@functools.lru_cache(maxsize=None)
def _grid(width, height, b, coupling="diag"):
    return jgrid.make_grid_mrf(width, height, b, coupling=coupling)


def _grid_pattern():
    """The lower JtJ block pattern of the 6x5 grid (b = 3)."""
    s = jbcsr.jtj_lower_schedule(_grid(6, 5, 3).structure)
    return s.rows, s.cols, 30, 3


PATTERNS = {
    "random-8x1": lambda: _random_spd_pattern(0, 8, 1, 10)[2:] + (8, 1),
    "random-12x2": lambda: _random_spd_pattern(0, 12, 2, 20)[2:] + (12, 2),
    "random-14x2": lambda: _random_spd_pattern(9, 14, 2, 30)[2:] + (14, 2),
    "grid-6x5": _grid_pattern,
}
ORDERINGS = ["natural", "mindeg", "rcm", "nd"]


def _assert_fields_equal(got, want, fields, prefix=""):
    for name in fields:
        g, w = getattr(got, name), getattr(want, name)
        if isinstance(w, (int, np.integer)):
            assert g == w, prefix + name
        else:
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                          err_msg=prefix + name)


def _assert_symbolic_equal(got, want):
    _assert_fields_equal(got, want, ("nb", "b", "rows", "cols",
                                     "diag_slot_of", "a_slot_of_input",
                                     "a_transpose", "perm", "in_rows",
                                     "in_cols"))
    assert got.nslots == want.nslots
    assert got.sched.nlevels == want.sched.nlevels
    _assert_fields_equal(got.sched, want.sched, jsc.OpSchedule._fields,
                         "sched.")
    for phase in ("fwd", "bwd"):
        _assert_fields_equal(getattr(got, phase), getattr(want, phase),
                             jsc.SolveSchedule._fields, phase + ".")


# -- (a) symbolic parity -----------------------------------------------------

@pytest.mark.parametrize("pattern", sorted(PATTERNS))
@pytest.mark.parametrize("ordering", ORDERINGS)
def test_symbolic_matches_jax(pattern, ordering):
    rows, cols, nb, b = PATTERNS[pattern]()
    _assert_symbolic_equal(tsc.analyze(rows, cols, nb, b, ordering),
                           jsc.analyze(rows, cols, nb, b, ordering))


@pytest.mark.parametrize("pattern", sorted(PATTERNS))
@pytest.mark.parametrize("S,ordering,inner", [(2, "rcm", "auto"),
                                              (4, "natural", "auto"),
                                              (3, "mindeg", "nd"),
                                              (4, "rcm", "natural")])
def test_supernodal_symbolic_matches_jax(pattern, S, ordering, inner):
    rows, cols, nb, b = PATTERNS[pattern]()
    got = tsn.analyze(rows, cols, nb, b, ordering, amalgamate=S,
                      inner_ordering=inner)
    want = jsn.analyze(rows, cols, nb, b, ordering, amalgamate=S,
                       inner_ordering=inner)
    _assert_fields_equal(got, want, ("S", "nb", "b", "nb_pad", "perm",
                                     "scatter_idx", "mirror_src",
                                     "mirror_idx", "ones_idx",
                                     "n_super_input", "in_rows", "in_cols"))
    assert got.sb == want.sb
    _assert_symbolic_equal(got.inner, want.inner)


@pytest.mark.parametrize("pattern", sorted(PATTERNS))
@pytest.mark.parametrize("fn", ["_mindeg_python", "mindeg_ordering",
                                "rcm_ordering", "nd_ordering"])
def test_orderings_match_jax(pattern, fn):
    rows, cols, nb, _ = PATTERNS[pattern]()
    got = getattr(tord, fn)(rows, cols, nb)
    np.testing.assert_array_equal(got, getattr(jord, fn)(rows, cols, nb))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(np.sort(got), np.arange(nb))


def test_resolve_ordering_matches_jax():
    rows, cols, nb, _ = PATTERNS["random-12x2"]()
    for spec in (None, "amd", "natural", np.arange(nb)[::-1]):
        np.testing.assert_array_equal(
            tord.resolve_ordering(spec, rows, cols, nb),
            jord.resolve_ordering(spec, rows, cols, nb))
    with pytest.raises(ValueError, match="unknown ordering"):
        tord.resolve_ordering("metis", rows, cols, nb)
    with pytest.raises(ValueError, match="permutation"):
        tord.resolve_ordering(np.zeros(nb), rows, cols, nb)


# -- (b) numeric parity -------------------------------------------------------

NUMERIC_CASES = {
    # name: (seed, nb, b, extra, ordering, amalgamate)
    "simplicial-mindeg": (1, 10, 3, 18, "mindeg", 1),
    "simplicial-nd": (0, 8, 2, 10, "nd", 1),
    "simplicial-natural": (4, 8, 2, 12, "natural", 1),
    "supernodal-13-S2": (21, 13, 3, 22, "rcm", 2),
    "supernodal-13-S4": (21, 13, 3, 22, "rcm", 4),
    "supernodal-13-S4-natural": (21, 13, 3, 22, "natural", 4),
}


def _analyze(mod, case):
    seed, nb, b, extra, ordering, S = NUMERIC_CASES[case]
    dense, blocks, rows, cols = _random_spd_pattern(seed, nb, b, extra)
    if S > 1:
        sym = mod.analyze(rows, cols, nb, b, ordering, amalgamate=S)
    else:
        sym = mod.analyze(rows, cols, nb, b, ordering)
    return sym, blocks, dense


@functools.lru_cache(maxsize=None)
def _jax_factor_solve(case):
    """The JAX package's factor and its solve of four right-hand sides.
    (Its jitted solve at b = 1 disagreed with the dense oracle under this
    suite's 8-device CPU configuration, so the cases here use b >= 2 and
    the b = 1 path is held against the dense oracle alone.)"""
    S = NUMERIC_CASES[case][-1]
    mod = jsn if S > 1 else jsc
    sym, blocks, _ = _analyze(mod, case)
    R = np.random.default_rng(5).normal(size=(sym.nb * sym.b, 4))

    @jax.jit
    def run(blocks, R):
        L, ok = mod.factorize(sym, blocks, jnp.asarray(0.0))
        return L, ok, mod.solve(sym, L, R)

    L, ok, X = run(jnp.asarray(blocks), jnp.asarray(R))
    return np.asarray(L), bool(ok), np.asarray(X), R


@pytest.mark.parametrize("case", sorted(NUMERIC_CASES))
def test_factorize_and_solve_match_jax(case):
    S = NUMERIC_CASES[case][-1]
    mod = tsn if S > 1 else tsc
    sym, blocks, dense = _analyze(mod, case)
    jL, jok, jX, R = _jax_factor_solve(case)
    before = dict(tilechol.launch_counts)
    L, ok = mod.factorize(sym, torch.as_tensor(blocks), 0.0)
    assert tilechol.launch_counts == before   # CPU: the twins
    assert bool(ok) and jok
    np.testing.assert_allclose(L.numpy(), jL, rtol=RTOL, atol=RTOL)
    x1 = mod.solve(sym, L, torch.as_tensor(R[:, 0]))
    x4 = mod.solve(sym, L, torch.as_tensor(R))
    assert x1.shape == (R.shape[0],) and x4.shape == R.shape
    np.testing.assert_allclose(x4.numpy(), jX, rtol=RTOL, atol=RTOL)
    np.testing.assert_allclose(x1.numpy(), jX[:, 0], rtol=RTOL, atol=RTOL)
    np.testing.assert_allclose(dense @ x4.numpy(), R, rtol=1e-10,
                               atol=1e-12)


def test_scalar_blocks_match_dense():
    """b = 1, the scalar simplicial regime, against the dense oracle."""
    dense, blocks, rows, cols = _random_spd_pattern(0, 8, 1, 10)
    R = np.random.default_rng(5).normal(size=(8, 4))
    for ordering in ORDERINGS:
        sym = tsc.analyze(rows, cols, 8, 1, ordering)
        L, ok = tsc.factorize(sym, torch.as_tensor(blocks), 0.0)
        assert bool(ok)
        X = tsc.solve(sym, L, torch.as_tensor(R)).numpy()
        np.testing.assert_allclose(X, np.linalg.solve(dense, R), rtol=1e-12,
                                   atol=1e-12)


# -- (c) lambda escalation ----------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_escalation(S):
    mod = jsn if S > 1 else jsc
    _, blocks, rows, cols = _random_spd_pattern(3, 6, 2, 8)
    idx = [k for k, (i, j) in enumerate(zip(rows, cols)) if i == j == 2][0]
    blocks[idx] = 0.0
    sym = (mod.analyze(rows, cols, 6, 2, amalgamate=S) if S > 1
           else mod.analyze(rows, cols, 6, 2))
    L, lam, ok = jax.jit(lambda bl: mod.factorize_with_lambda(
        sym, bl, jnp.asarray(0.0)))(jnp.asarray(blocks))
    return blocks, rows, cols, np.asarray(L), float(lam), bool(ok)


@pytest.mark.parametrize("S", [1, 2])
def test_lambda_escalation_matches_jax(S):
    """Hazard F3: a zeroed diagonal block fails FACTOR, and the escalating
    lambda retries to the same final lambda as the JAX package."""
    blocks, rows, cols, jL, jlam, jok = _jax_escalation(S)
    mod = tsn if S > 1 else tsc
    sym = (mod.analyze(rows, cols, 6, 2, amalgamate=S) if S > 1
           else mod.analyze(rows, cols, 6, 2))
    _, ok0 = mod.factorize(sym, torch.as_tensor(blocks), 0.0)
    assert not bool(ok0)
    L, lam, ok = mod.factorize_with_lambda(sym, torch.as_tensor(blocks),
                                           torch.tensor(0.0,
                                                        dtype=torch.float64))
    assert bool(ok) and jok
    assert float(lam) == jlam > 0.0
    np.testing.assert_allclose(L.numpy(), jL, rtol=1e-10, atol=1e-12)


# -- (d) optimize end to end --------------------------------------------------

SOLVES = {
    # name: (coupling, amalgamate, params, refine_iters)
    "diag-default": ("diag", 1, (), 0),
    "diag-amal4": ("diag", 4, (), 0),
    "dense-default": ("dense", 1, (), 0),
    "dense-amal4": ("dense", 4, (), 0),
    "diag-default-tr0.05": ("diag", 1, (("trustregion0", 0.05),), 0),
    "dense-amal4-tr0.05": ("dense", 4, (("trustregion0", 0.05),), 0),
    "dense-default-refine1": ("dense", 1, (), 1),
}


def _problem(sp_cls, base, amalgamate):
    if amalgamate == 1:
        return None
    return sp_cls(f=base.f, structure=base.structure, jtj="sparse",
                  ordering="rcm", amalgamate=amalgamate)


@functools.lru_cache(maxsize=None)
def _jax_optimize(name):
    coupling, S, prm, refine = SOLVES[name]
    m = _grid(6, 5, 3, coupling)
    prob = _problem(JSparseProblem, m.problem(jtj="dense"), S) or m.problem()
    ns = prob.default_newton_solver()
    if refine:
        ns = jnewton.SparseNewtonSolver(ns.symbolic, refine_iters=refine)
    r = jax.jit(lambda q: dl.optimize(prob, q, dl.DoglegParameters(
        **dict(prm)), newton_solver=ns))(jnp.zeros(m.nstate))
    return jax.tree_util.tree_map(np.asarray, r)


@pytest.mark.parametrize("name", sorted(SOLVES))
def test_optimize_matches_jax(name):
    """optimize on the 6x5x3 grid through g.problem() (mindeg, simplicial)
    or the rcm/amalgamate=4 problem, in both couplings; trustregion0=0.05
    takes Cauchy and interpolated steps (quad_form), refine_iters=1 the
    compensated refinement."""
    coupling, S, prm, refine = SOLVES[name]
    r_j = _jax_optimize(name)
    t = interop.grid_mrf_from_reference(_grid(6, 5, 3, coupling),
                                        device="cpu")
    prob = (_problem(tl.SparseProblem, t.problem(jtj="dense"), S)
            or t.problem())
    ns = prob.default_newton_solver()
    assert isinstance(ns, tl.SparseNewtonSolver)
    if refine:
        ns = tl.SparseNewtonSolver(ns.symbolic, refine_iters=refine)
    r_t = tl.optimize(prob, torch.zeros(t.nstate, dtype=torch.float64),
                      tl.DoglegParameters(**dict(prm)), newton_solver=ns)
    for field in ("step_count", "n_attempts", "reason"):
        assert int(getattr(r_t, field)) == int(getattr(r_j, field)), field
    assert int(r_t.reason) > 0
    if prm:
        assert int(r_t.n_attempts) > 1
    np.testing.assert_allclose(r_t.p.numpy(), r_j.p, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(float(r_t.norm2_x), float(r_j.norm2_x),
                               rtol=1e-9)
    np.testing.assert_allclose(float(r_t.lam), float(r_j.lam), rtol=1e-12)


def test_quad_form_and_refinement_match_jax():
    """quad_form on the stored lower blocks equals v^T JtJ v, and one
    refinement pass of the GN step equals the JAX strategy's."""
    m = _grid(6, 5, 3, "dense")
    jprob = m.problem()
    rng = np.random.default_rng(8)
    p, v = rng.normal(size=m.nstate), rng.normal(size=m.nstate)
    jpr = jprob.products(jnp.asarray(p))
    t = interop.grid_mrf_from_reference(m, device="cpu")
    tprob = t.problem()
    tpr = tprob.products(torch.as_tensor(p))
    ns = tprob.default_newton_solver()
    dense = tprob.full(torch.as_tensor(p))[1]
    want = float(torch.sum((dense @ torch.as_tensor(v)) ** 2))
    np.testing.assert_allclose(float(ns.quad_form(tpr.JtJ,
                                                  torch.as_tensor(v))),
                               want, rtol=1e-12)
    jns = jnewton.SparseNewtonSolver(jprob.default_newton_solver().symbolic,
                                     refine_iters=1)
    r_j = jax.jit(lambda JtJ, g: jns.gauss_newton(
        JtJ, g, jnp.asarray(1e-3), **KW))(jpr.JtJ, jpr.Jt_x)
    r_t = tl.SparseNewtonSolver(ns.symbolic, refine_iters=1).gauss_newton(
        tpr.JtJ, tpr.Jt_x, torch.tensor(1e-3, dtype=torch.float64), **KW)
    np.testing.assert_allclose(r_t.step.numpy(), np.asarray(r_j.step),
                               rtol=1e-10, atol=1e-13)
    assert float(r_t.lam) == float(r_j.lam) and bool(r_t.ok)


def test_batched_blocks_raise():
    ns = interop.grid_mrf_from_reference(
        _grid(6, 5, 3), device="cpu").problem().default_newton_solver()
    blocks = torch.zeros((2, len(ns.symbolic.in_rows), 3, 3),
                         dtype=torch.float64)
    with pytest.raises(NotImplementedError, match="batched"):
        ns.gauss_newton(blocks, torch.zeros(2, 90, dtype=torch.float64),
                        torch.zeros(2, dtype=torch.float64), **KW)


# -- (e) lower JtJ blocks -----------------------------------------------------

@pytest.mark.parametrize("coupling", ["diag", "dense"])
def test_jtj_lower_blocks_match_jax(coupling):
    m = _grid(6, 5, 3, coupling)
    jsched = jbcsr.jtj_lower_schedule(m.structure)
    tsched = tbcsr.jtj_lower_schedule(m.structure)
    _assert_fields_equal(tsched, jsched, jbcsr.JtJLowerSchedule._fields)
    p = np.random.default_rng(1).normal(size=m.nstate)
    _, values = m.problem(jtj="dense").f(jnp.asarray(p))
    want = np.asarray(jbcsr.bcsr_jtj_lower_blocks(
        jbcsr.BCSRJacobian(m.structure, values), jsched))
    J = tbcsr.BCSRJacobian(m.structure, torch.as_tensor(np.asarray(values)))
    got = tbcsr.bcsr_jtj_lower_blocks(J, tsched)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-14, atol=1e-14)
    # the schedule's arrays as device tensors, as SparseProblem caches them
    got_t = tbcsr.bcsr_jtj_lower_blocks(J, tsched._replace(
        pair_i=torch.as_tensor(tsched.pair_i, dtype=torch.int64)))
    assert torch.equal(got_t, got)


# -- the twins of K6 and K7 ---------------------------------------------------

@pytest.mark.parametrize("n", [3, 8, 16, 32])
def test_tile_twins_match_jax(n):
    """tile_cholesky's twin against the JAX FACTOR op (_chol_blocks) and
    the Pallas kernel K6 in interpret mode; tri_solve_right's twin against
    the JAX SOLVE op and K7 in interpret mode. A batch of three, the last
    tile non-SPD (ok False everywhere)."""
    rng = np.random.default_rng(n)
    A = rng.normal(size=(3, n, n))
    S = A @ np.swapaxes(A, -1, -2) + n * np.eye(n)
    S[2, n // 2, n // 2] = -S[2, n // 2, n // 2]
    C = rng.normal(size=(3, 5, n))
    L, ok = tilechol.tile_cholesky(torch.as_tensor(S))
    jL, jok = jsc._chol_blocks(jnp.asarray(S))
    pL, pok = pallas_chol.pallas_cholesky(jnp.asarray(S), interpret=True)
    assert ok.tolist() == np.asarray(jok).tolist() == [True, True, False]
    assert np.asarray(pok).tolist() == [True, True, False]
    for want in (jL, pL):
        np.testing.assert_allclose(L[:2].numpy(), np.asarray(want)[:2],
                                   rtol=1e-12, atol=1e-12)
    assert bool((torch.triu(L, 1) == 0).all())
    D = L[:2]
    X = tilechol.tri_solve_right(D, torch.as_tensor(C[:2]))
    for want in (jsc._tri_solve_right(jnp.asarray(D.numpy()),
                                      jnp.asarray(C[:2])),
                 pallas_chol.pallas_tri_solve_right(
                     jnp.asarray(D.numpy()), jnp.asarray(C[:2]),
                     interpret=True)):
        np.testing.assert_allclose(X.numpy(), np.asarray(want), rtol=1e-12,
                                   atol=1e-12)
    np.testing.assert_allclose(X.numpy() @ np.swapaxes(D.numpy(), -1, -2),
                               C[:2], rtol=1e-12, atol=1e-12)


def test_tile_wrappers_reject_bad_input():
    with pytest.raises(ValueError, match="n <= 256"):
        tilechol.tile_cholesky(torch.zeros((2, 300, 300)))
    with pytest.raises(ValueError):
        tilechol.tile_cholesky(torch.zeros((4, 3)))
    with pytest.raises(ValueError, match="float32 or float64"):
        tilechol.tile_cholesky(torch.zeros((2, 4, 4), dtype=torch.int32))
    with pytest.raises(ValueError, match="C must be"):
        tilechol.tri_solve_right(torch.eye(4)[None], torch.zeros((2, 3, 4)))
    with pytest.raises(ValueError, match="share dtype"):
        tilechol.tri_solve_right(torch.eye(4)[None],
                                 torch.zeros((1, 3, 4), dtype=torch.float64))


def test_analysis_caches_device_copies():
    """The index arrays go to a device once and are reused."""
    rows, cols, nb, b = PATTERNS["random-12x2"]()
    sym = tsc.analyze(rows, cols, nb, b)
    _, blocks, _, _ = _random_spd_pattern(0, 12, 2, 20)
    L, _ = tsc.factorize(sym, torch.as_tensor(blocks), 0.0)
    cpu = torch.device("cpu")
    cached = dict(sym._device)
    assert (cpu, "sched.upd_tgt") in cached
    assert cached[(cpu, "sched.upd_tgt")].dtype == torch.int64
    tsc.factorize(sym, torch.as_tensor(blocks), 0.0)
    tsc.solve(sym, L, torch.ones(nb * b, dtype=torch.float64))
    for key, t in cached.items():
        assert sym._device[key] is t
    assert (cpu, "fwd.pair_j") in sym._device and (cpu, "perm") in sym._device
