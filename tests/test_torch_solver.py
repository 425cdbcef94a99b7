"""The port's single-solve `optimize` and its masked batched solver against
the JAX package's `optimize` in float64 on the same inputs.

Decisions (step_count, n_attempts, reason and the History step types) must
be identical: in float64 the two programs' roundoff sits far below every
solver threshold. Values agree to rtol 1e-10, atol 1e-12 (summation order
differs between XLA and torch).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libdogleg_tpu as dl
import libdogleg_tpu.models.quadratic_surface as jsp
from libdogleg_tpu.utils import packed as jpacked
import libdogleg_tpu_torch as tl
import libdogleg_tpu_torch.models.quadratic_surface as tsp
from libdogleg_tpu_torch import interop
from libdogleg_tpu_torch.utils import packed as tpacked

torch.set_num_threads(1)
MODES = ("sparse", "dense", "dense-products-packed-upper",
         "dense-products-unpacked", "residual")


def _instance(seed):
    """Measurements and a start point for the sample problem, from numpy."""
    rng = np.random.default_rng(seed)
    c = jsp.GRID_MIN + jsp.GRID_DELTA * np.arange(jsp.GRID_WIDTH)
    gx, gy = (a.ravel() for a in np.meshgrid(c, c, indexing="ij"))
    p = jsp.P_TRUE
    truth = (p[0] * p[1] * gx * gx + p[1] * p[2] * gy * gy + p[2] * gx * gy
             + p[3] * gx + p[4] * gy + p[5])
    meas = truth + rng.uniform(size=truth.shape) - 0.5
    return meas, rng.uniform(size=(jsp.NSTATE,)) - 0.1


def _jax_problem(mode, meas):
    if mode == "sparse":
        return jsp.make_sparse_problem(meas)
    if mode == "dense":
        return jsp.make_dense_problem(meas)
    if mode == "residual":
        return jsp.make_residual_problem(meas)
    base = jsp.make_products_problem(meas)
    if mode == "dense-products-unpacked":
        return base

    def f(p):
        n2, jtx, jtj = base.f(p)
        return n2, jtx, jpacked.packed_to_full(
            jpacked.full_to_packed(jtj, upper=True), jsp.NSTATE, upper=True)
    return dl.ProductsProblem(f=f)


def _torch_problem(mode, meas):
    if mode == "sparse":
        return tsp.make_sparse_problem(meas)
    if mode == "dense":
        return tsp.make_dense_problem(meas)
    if mode == "residual":
        return tsp.make_residual_problem(meas)
    base = tsp.make_products_problem(meas)
    if mode == "dense-products-unpacked":
        return base

    def f(p):
        n2, jtx, jtj = base.f(p)
        return n2, jtx, tpacked.packed_to_full(
            tpacked.full_to_packed(jtj, upper=True), tsp.NSTATE, upper=True)
    return tl.ProductsProblem(f=f)


@functools.lru_cache(maxsize=None)
def _jax_solver(mode, prm_items):
    prm = dl.DoglegParameters(**dict(prm_items))
    return jax.jit(lambda m, p0: dl.optimize(_jax_problem(mode, m), p0, prm,
                                             record_history=True))


def _both(mode, meas, p0, **prm_kw):
    r_j = _jax_solver(mode, tuple(sorted(prm_kw.items())))(
        jnp.asarray(meas), jnp.asarray(p0))
    r_t = tl.optimize(_torch_problem(mode, torch.as_tensor(meas)),
                      torch.as_tensor(p0), tl.DoglegParameters(**prm_kw),
                      record_history=True)
    return r_j, interop.result_to_numpy(r_t)


def _assert_decisions_equal(r_t, r_j):
    for field in ("step_count", "n_attempts", "reason"):
        np.testing.assert_array_equal(getattr(r_t, field),
                                      np.asarray(getattr(r_j, field)),
                                      err_msg=field)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("mode", MODES)
def test_optimize_matches_jax(mode, seed):
    meas, p0 = _instance(seed)
    r_j, r_t = _both(mode, meas, p0)
    _assert_decisions_equal(r_t, r_j)
    np.testing.assert_array_equal(r_t.history.step_type,
                                  np.asarray(r_j.history.step_type))
    np.testing.assert_array_equal(r_t.history.step_accepted,
                                  np.asarray(r_j.history.step_accepted))
    np.testing.assert_allclose(r_t.p, np.asarray(r_j.p), rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(r_t.norm2_x, np.asarray(r_j.norm2_x),
                               rtol=1e-10)
    np.testing.assert_allclose(r_t.trustregion,
                               np.asarray(r_j.trustregion), rtol=1e-10)
    np.testing.assert_allclose(r_t.history.rho, np.asarray(r_j.history.rho),
                               rtol=1e-6, atol=1e-9)
    # the benchmark's recovery gate (bench.py:279-281); sample.c's 5e-2
    # holds for its own instance, not for every noise draw
    assert np.all(np.abs(r_t.p - jsp.P_TRUE) < 0.2)


def test_initial_convergence_matches_jax():
    """Criterion 1 on the initial point (reference dogleg.c:1364-1371)."""
    meas, p0 = _instance(3)
    r_j, r_t = _both("dense", meas, p0, Jt_x_threshold=1e9)
    _assert_decisions_equal(r_t, r_j)
    assert int(r_t.reason) == int(tl.StopReason.GRADIENT_CONVERGED)
    assert int(r_t.n_attempts) == 0
    assert np.all(r_t.history.step_type == int(tl.StepType.UNINITIALIZED))


def _rank_deficient():
    rng = np.random.default_rng(12)
    A = np.concatenate([rng.normal(size=(30, 3)), np.zeros((30, 1))], axis=1)
    return A, rng.normal(size=(30,))


def _linear_products(A, b, xp):
    def products(p):
        x = A @ p - b
        return (dl.solver.Products if xp is jnp else tl.Products)(
            norm2_x=x @ x, Jt_x=A.T @ x, JtJ=A.T @ A)
    return products


@pytest.mark.parametrize("lambda_max_tries", [60, 0])
def test_rank_deficient_lambda_and_factorization_failure_match_jax(
        lambda_max_tries):
    """A zero Jacobian column: the escalating lambda engages (60 tries), or
    with no tries the solve ends FACTORIZATION_FAILED on its first GN step."""
    A, b = _rank_deficient()
    kw = dict(lambda_max_tries=lambda_max_tries)
    r_j = dl.solve_products(_linear_products(jnp.asarray(A), jnp.asarray(b),
                                             jnp),
                            jnp.zeros(4), dl.DoglegParameters(**kw))
    r_t = interop.result_to_numpy(tl.solve_products(
        _linear_products(torch.as_tensor(A), torch.as_tensor(b), torch),
        torch.zeros(4, dtype=torch.float64), tl.DoglegParameters(**kw)))
    _assert_decisions_equal(r_t, r_j)
    assert float(r_t.lam) == float(r_j.lam)
    if lambda_max_tries:
        assert float(r_t.lam) > 0.0
        np.testing.assert_allclose(r_t.p, np.asarray(r_j.p), rtol=1e-8)
    else:
        assert int(r_t.reason) == int(tl.StopReason.FACTORIZATION_FAILED)
        np.testing.assert_array_equal(r_t.p, np.zeros(4))


def test_all_rejects_and_nan_residuals_match_jax():
    """Two adversarial products: an uphill gradient that rejects every step
    (SMALL_TRUSTREGION, dogleg.c:1460-1466), and NaN trial costs that end at
    the attempt cap (STALLED), since a NaN rho keeps the radius."""
    def uphill(xp, stack, ones):
        def products(p):
            return (dl.solver.Products if xp is jnp else tl.Products)(
                norm2_x=p[0] * p[0] + 1.0, Jt_x=stack([-p[0]]),
                JtJ=ones((1, 1), dtype=p.dtype))
        return products

    def nan_zone(xp, stack, full):
        def products(p):
            bad = xp.where(xp.abs(p[0] - 1.0) > 0.5, xp.nan, 0.0)
            return (dl.solver.Products if xp is jnp else tl.Products)(
                norm2_x=(p[0] - 1.0) ** 2 + bad,
                Jt_x=stack([0.01 * (p[0] - 1.0)]),
                JtJ=full((1, 1), 1e-4, dtype=p.dtype))
        return products

    cases = [(uphill(jnp, jnp.stack, jnp.ones),
              uphill(torch, torch.stack, torch.ones),
              dict(update_threshold=1e-12), 1.0),
             (nan_zone(jnp, jnp.stack, jnp.full),
              nan_zone(torch, torch.stack, torch.full),
              dict(max_iterations=5, max_attempts=20), 1.3)]
    for f_j, f_t, kw, x0 in cases:
        r_j = dl.solve_products(f_j, jnp.asarray([x0]),
                                dl.DoglegParameters(**kw))
        r_t = interop.result_to_numpy(tl.solve_products(
            f_t, torch.tensor([x0], dtype=torch.float64),
            tl.DoglegParameters(**kw)))
        _assert_decisions_equal(r_t, r_j)
        np.testing.assert_allclose(r_t.trustregion,
                                   np.asarray(r_j.trustregion), rtol=1e-12)


def test_batched_solver_matches_single_solves():
    """The masked batched solver takes each element's own decisions (a
    small max_iterations gives a mix of MAX_ITERATIONS and converged
    elements, so elements freeze at different attempts)."""
    insts = [_instance(s) for s in range(8)]
    meas = torch.as_tensor(np.stack([m for m, _ in insts]))
    p0 = torch.as_tensor(np.stack([p for _, p in insts]))
    prm = tl.DoglegParameters(max_iterations=4)
    vf = torch.func.vmap(tsp.products)
    r_b = tl.solve_products_batched(lambda p: vf(p, meas), p0, prm)
    reasons = set()
    for i in range(8):
        r_1 = tl.solve_products(lambda p: tsp.products(p, meas[i]), p0[i],
                                prm)
        for field in ("step_count", "n_attempts", "reason"):
            assert int(getattr(r_b, field)[i]) == int(getattr(r_1, field))
        np.testing.assert_allclose(r_b.p[i].numpy(), r_1.p.numpy(),
                                   rtol=1e-12, atol=1e-14)
        reasons.add(int(r_1.reason))
    assert int(tl.StopReason.MAX_ITERATIONS) in reasons


@pytest.mark.parametrize("k", [0, 1, 3, 100])
def test_batched_segments_compose_to_one_run(k):
    """k attempts and then the rest equal one run, field for field: the
    state between segments carries the caches, lambda and the trust region.
    After the first segment no element has made more than k attempts, and
    one that is not done has made exactly k."""
    insts = [_instance(s) for s in range(8)]
    meas = torch.as_tensor(np.stack([m for m, _ in insts]))
    p0 = torch.as_tensor(np.stack([p for _, p in insts]))
    prm = tl.DoglegParameters(max_iterations=6)
    vf = torch.func.vmap(tsp.products)

    def products(p):
        return vf(p, meas)

    ref = tl.solve_products_batched(products, p0, prm)
    st = tl.init_batched_state(products, p0, prm)
    assert isinstance(st, tl.BatchedSolverState)
    assert int(st.n_attempts.max()) == 0
    st = tl.run_batched_solver(products, st, prm, max_new_attempts=k)
    assert int(st.n_attempts.max()) <= k
    assert bool((st.n_attempts[~st.done] == k).all())
    if k == 100:
        assert bool(st.done.all())
    r = tl.result_from_batched_state(
        tl.run_batched_solver(products, st, prm))
    for field in ("p", "norm2_x", "Jt_x", "JtJ", "step_count", "n_attempts",
                  "reason", "trustregion", "lam"):
        assert torch.equal(getattr(r, field), getattr(ref, field)), field


def test_history_capacity_overwrites_last_row():
    meas, p0 = _instance(4)
    r = tl.optimize(tsp.make_dense_problem(torch.as_tensor(meas)),
                    torch.as_tensor(p0), record_history=True,
                    history_capacity=3)
    assert r.history.step_type.shape == (3,)
    assert int(r.n_attempts) > 3
    assert int(r.history.step_accepted[-1]) == 1  # the final attempt
