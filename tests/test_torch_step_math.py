"""The port's step math (ops/dense, smallchol, cholesky, newton) against the
JAX package's functions on the same float64 inputs, rtol 1e-12: both sides
do the same arithmetic and differ only in summation order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libdogleg_tpu.ops import cholesky as jchol
from libdogleg_tpu.ops import dense as jdense
from libdogleg_tpu.ops import newton as jnewton
from libdogleg_tpu.ops import smallchol as jsmall
from libdogleg_tpu_torch.ops import cholesky as tchol
from libdogleg_tpu_torch.ops import dense as tdense
from libdogleg_tpu_torch.ops import newton as tnewton
from libdogleg_tpu_torch.ops import smallchol as tsmall

torch.set_num_threads(1)
RTOL = 1e-12


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _close(t, j, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=rtol,
                               atol=atol)


def _problem(seed, nmeas=40, nstate=7):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(nmeas, nstate)), rng.normal(size=(nmeas,))


def _spd(seed, n, batch=()):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=batch + (n + 3, n))
    return np.swapaxes(A, -1, -2) @ A


def test_products_match_jax():
    J, x = _problem(0)
    v = np.random.default_rng(1).normal(size=(J.shape[1],))
    JtJ = J.T @ J
    _close(tdense.build_jtj(_t(J)), jdense.build_jtj(jnp.asarray(J)))
    _close(tdense.jt_dot(_t(J), _t(x)), jdense.jt_dot(jnp.asarray(J),
                                                      jnp.asarray(x)))
    _close(tdense.quad_form(_t(JtJ), _t(v)),
           jdense.quad_form(jnp.asarray(JtJ), jnp.asarray(v)))
    _close(tdense.norm2(_t(x)), jdense.norm2(jnp.asarray(x)))


def test_cauchy_step_matches_jax():
    J, x = _problem(2)
    JtJ, Jt_x = J.T @ J, J.T @ x
    t = tdense.cauchy_step(_t(Jt_x), _t(JtJ))
    j = jdense.cauchy_step(jnp.asarray(Jt_x), jnp.asarray(JtJ))
    for a, b in zip(t, j):
        _close(a, b)


@pytest.mark.parametrize("gn_scale", [10.0, 1.0])
def test_interpolated_step_matches_jax(gn_scale):
    """gn_scale=1 puts the GN point inside the sphere too, where the
    discriminant can go negative and is clamped (dogleg.c:945-947)."""
    rng = np.random.default_rng(3)
    a = rng.normal(size=(5,)) * 0.5
    b = rng.normal(size=(5,)) * gn_scale
    tr = 2.0 if gn_scale > 1 else 0.1
    t = tdense.interpolated_step(_t(a), tdense.norm2(_t(a)), _t(b),
                                 torch.tensor(tr, dtype=torch.float64))
    j = jdense.interpolated_step(jnp.asarray(a), jdense.norm2(jnp.asarray(a)),
                                 jnp.asarray(b), jnp.asarray(tr))
    for x, y in zip(t, j):
        _close(x, y)


def test_interpolated_step_batched_rows_match_single():
    rng = np.random.default_rng(4)
    a, b = rng.normal(size=(5, 4)) * 0.5, rng.normal(size=(5, 4)) * 10.0
    tr = np.full(5, 2.0)
    batched = tdense.interpolated_step(_t(a), tdense.norm2(_t(a)), _t(b),
                                       _t(tr))
    for i in range(5):
        one = tdense.interpolated_step(_t(a[i]), tdense.norm2(_t(a[i])),
                                       _t(b[i]), _t(tr[i]))
        _close(batched.step[i], one.step.numpy())


def test_expected_improvement_matches_jax():
    J, x = _problem(5)
    step = np.random.default_rng(6).normal(size=(J.shape[1],))
    _close(tdense.expected_improvement(_t(J.T @ x), _t(J.T @ J), _t(step)),
           jdense.expected_improvement(jnp.asarray(J.T @ x),
                                       jnp.asarray(J.T @ J),
                                       jnp.asarray(step)))


@pytest.mark.parametrize("rho,edge", [
    (0.1, True), (0.1, False), (0.5, True), (0.9, True), (0.9, False),
    (-1.0, True), (float("nan"), True), (float("nan"), False)])
def test_trust_region_update_matches_jax(rho, edge):
    """Includes the interior snap and the NaN-rho rule: a NaN rho fails
    every comparison and leaves the radius unchanged."""
    kw = dict(decrease_factor=0.1, decrease_threshold=0.25,
              increase_factor=2.0, increase_threshold=0.75)
    tr, n2gn = 3.0, 0.25
    t = tdense.trust_region_update(torch.tensor(rho, dtype=torch.float64),
                                   torch.tensor(tr, dtype=torch.float64),
                                   edge, torch.tensor(n2gn,
                                                      dtype=torch.float64),
                                   **kw)
    j = jdense.trust_region_update(jnp.asarray(rho), jnp.asarray(tr),
                                   jnp.asarray(edge), jnp.asarray(n2gn), **kw)
    _close(t, j)
    if np.isnan(rho):
        assert float(t) == tr


@pytest.mark.parametrize("n", [1, 6, 16])
def test_small_cholesky_and_solve_match_jax(n):
    A = _spd(7, n, batch=(3,))
    b = np.random.default_rng(8).normal(size=(3, n))
    L_t, ok_t = tsmall.small_cholesky(_t(A))
    L_j, ok_j = jsmall.small_cholesky(jnp.asarray(A))
    _close(L_t, L_j)
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    _close(tsmall.small_cho_solve(L_t, _t(b)),
           jsmall.small_cho_solve(L_j, jnp.asarray(b)))


def test_small_cholesky_flags_non_spd_like_jax():
    A = _spd(9, 6, batch=(4,))
    A[1, 2, 2] = -5.0
    A[3] = np.nan
    _, ok_t = tsmall.small_cholesky(_t(A))
    _, ok_j = jsmall.small_cholesky(jnp.asarray(A))
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    assert ok_t.tolist() == [True, False, True, False]


@pytest.mark.parametrize("case", ["spd", "singular", "hopeless", "large"])
def test_factorize_jtj_matches_jax(case):
    """Same final lambda and ok as the JAX escalation, including a singular
    JtJ that escalates and a NaN one that exhausts its tries."""
    n, tries = (20 if case == "large" else 5), 60
    A = _spd(10, n)
    if case == "singular":
        A[:, -1] = 0.0
        A[-1, :] = 0.0
    if case == "hopeless":
        A[:] = np.nan
        tries = 5
    kw = dict(lambda_initial=1e-10, lambda_max_tries=tries)
    t = tchol.factorize_jtj(_t(A), torch.tensor(0.0, dtype=torch.float64),
                            **kw)
    j = jchol.factorize_jtj(jnp.asarray(A), jnp.asarray(0.0), **kw)
    assert bool(t.ok) == bool(j.ok)
    assert float(t.lam) == float(j.lam)
    if case == "singular":
        assert float(t.lam) > 0.0
    if bool(j.ok):
        _close(t.L, j.L, rtol=1e-10, atol=1e-12)
        b = np.random.default_rng(11).normal(size=(n,))
        _close(tchol.gauss_newton_step(t.L, _t(b))[0],
               jchol.gauss_newton_step(j.L, jnp.asarray(b))[0], rtol=1e-10)


def test_masked_batched_escalation_matches_each_element():
    """A batch with healthy, singular and inactive elements: each active
    element reaches the lambda its own JAX factorization reaches; inactive
    elements keep theirs."""
    A = _spd(12, 6, batch=(4,))
    A[1, :, 0] = A[1, 0, :] = 0.0
    A[2, :, 3] = A[2, 3, :] = 0.0
    active = torch.tensor([True, True, False, True])
    lam0 = np.array([0.0, 0.0, 0.0, 1e-3])
    kw = dict(lambda_initial=1e-10, lambda_max_tries=60)
    t = tchol.factorize_jtj(_t(A), _t(lam0), active=active, **kw)
    for i in range(4):
        if not bool(active[i]):
            assert float(t.lam[i]) == lam0[i]
            assert not bool(t.ok[i])
            continue
        j = jchol.factorize_jtj(jnp.asarray(A[i]), jnp.asarray(lam0[i]), **kw)
        assert bool(t.ok[i]) and bool(j.ok)
        assert float(t.lam[i]) == float(j.lam)


def test_dense_newton_solver_matches_jax():
    J, x = _problem(13)
    JtJ, Jt_x = J.T @ J, J.T @ x
    kw = dict(lambda_initial=1e-10, lambda_max_tries=60)
    t = tnewton.DenseNewtonSolver().gauss_newton(
        _t(JtJ), _t(Jt_x), torch.tensor(0.0, dtype=torch.float64), **kw)
    j = jnewton.DenseNewtonSolver().gauss_newton(
        jnp.asarray(JtJ), jnp.asarray(Jt_x), jnp.asarray(0.0), **kw)
    _close(t.step, j.step, rtol=1e-10)
    _close(t.norm2_step, j.norm2_step, rtol=1e-10)
    assert bool(t.ok) == bool(j.ok) and float(t.lam) == float(j.lam)
    _close(tnewton.DenseNewtonSolver().quad_form(_t(JtJ), _t(Jt_x)),
           jnewton.DenseNewtonSolver().quad_form(jnp.asarray(JtJ),
                                                 jnp.asarray(Jt_x)))


def test_dense_newton_solver_refinement_not_ported():
    """refine_iters > 0 was refused before ops/compensated.py was ported;
    it now runs the JAX package's refinement: same step as JAX, rtol
    1e-10, on a 16-state system (the unrolled small-Cholesky path)."""
    rng = np.random.default_rng(11)
    A = rng.normal(size=(40, 16))
    JtJ, Jt_x = A.T @ A, rng.normal(size=16)
    kw = dict(lambda_initial=1e-10, lambda_max_tries=60)
    t = tnewton.DenseNewtonSolver(refine_iters=1).gauss_newton(
        _t(JtJ), _t(Jt_x), torch.tensor(0.0, dtype=torch.float64), **kw)
    j = jnewton.DenseNewtonSolver(refine_iters=1).gauss_newton(
        jnp.asarray(JtJ), jnp.asarray(Jt_x), jnp.asarray(0.0), **kw)
    _close(t.step, j.step, rtol=1e-10)
    _close(t.norm2_step, j.norm2_step, rtol=1e-10)
