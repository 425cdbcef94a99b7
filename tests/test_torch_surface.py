"""The rest of the single solve's public surface on the CPU, against the
JAX package in float64: models/curve_fit.py (config 2's family), legacy.py
(the reference's global setters), the package's exports, the sample CLI in
a subprocess, and the hypothesis properties of the step math (ops/dense.py,
ops/cholesky.py). The cases replay tests/test_models.py:21-50,
tests/test_params.py:39-72, tests/test_cli.py and tests/test_properties.py
on the port.

Inputs cross as numpy arrays. curve_fit has two instances: "numpy",
config 2's recipe on the card (measurements P_TRUE's curve + 0.02 N(0, 1)
from default_rng(0), the start U(-0.5, 0.5) from default_rng(1)), and
"keys", tests/test_models.py's own (the JAX package's simulate and
initial_state at PRNGKey 0 and 1); legacy takes the JAX package's sample
instance at PRNGKey 0 and 1.

Tolerances: decisions (step_count, n_attempts, reason, History step types)
identical, p within 1e-12 of the JAX package's, but within 1e-8 on the
"numpy" instance: its start has a positive decay rate (0.45), and the solve
runs into the valley where p1 -> 0 and p0, p2 grow apart (p0 -1.07 after
10 steps, -148.8 after 100), so rounding is amplified: the JAX package's
own solve moves by 2.0e-10 (10 steps) and 1.27e-9 (100) when one
coordinate of the start moves by one ulp, and the port is 2.3e-10 and
1.22e-9 from it. The Jacobian is within 1e-12 of forward-mode autodiff
(tests/test_models.py's).
"""

import dataclasses
import importlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import libdogleg_tpu as dl
import libdogleg_tpu.sample_problem as jsp
from libdogleg_tpu.models import curve_fit as jcf
import libdogleg_tpu_torch as tl
from libdogleg_tpu_torch import legacy
from libdogleg_tpu_torch.models import curve_fit as cf
from libdogleg_tpu_torch.models import quadratic_surface as qs
from libdogleg_tpu_torch.ops import cholesky as tchol
from libdogleg_tpu_torch.ops import dense as dops

torch.set_num_threads(1)
RTOL = 1e-12
FORMS = ("make_dense_problem", "make_products_problem",
         "make_residual_problem")
# bench_all.py:46-48, config 2's stopping rule
PRM = dict(max_iterations=10, Jt_x_threshold=1e-3, update_threshold=1e-5,
           trustregion_threshold=1e-5)
P_ATOL = {"numpy": 1e-8, "keys": RTOL}   # the module docstring says why


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


def _assert_jax_decisions(r, rj, atol=RTOL):
    for field in ("step_count", "n_attempts", "reason"):
        assert int(getattr(r, field)) == int(getattr(rj, field)), field
    np.testing.assert_allclose(_np(r.p), np.asarray(rj.p), rtol=RTOL,
                               atol=atol)
    np.testing.assert_array_equal(_np(r.history.step_type),
                                  np.asarray(rj.history.step_type))


# ---------------------------------------------------------------------------
# curve_fit
# ---------------------------------------------------------------------------


def _curve_inputs(instance="numpy", nmeas=64):
    if instance == "keys":
        return (np.asarray(jcf.simulate(jax.random.PRNGKey(0), nmeas)),
                np.asarray(jcf.initial_state(jax.random.PRNGKey(1))))
    t = np.linspace(0.0, 1.0, nmeas)
    meas = (cf.P_TRUE[0] * np.exp(cf.P_TRUE[1] * t) + cf.P_TRUE[2]
            + 0.02 * np.random.default_rng(0).normal(size=nmeas))
    p0 = np.random.default_rng(1).uniform(size=cf.NSTATE) - 0.5
    return meas, p0


@pytest.mark.parametrize("prm", ["default", "config2"])
@pytest.mark.parametrize("instance", ["numpy", "keys"])
@pytest.mark.parametrize("form", FORMS)
def test_curve_fit_matches_jax(form, instance, prm):
    """All three problem forms take the JAX package's decisions, History
    step types included, under the default parameters and config 2's; the
    "keys" instance recovers P_TRUE (to 5e-2 at convergence, to config 2's
    0.2 after its 10 steps)."""
    meas, p0 = _curve_inputs(instance)
    kw = PRM if prm == "config2" else {}
    r = tl.optimize(getattr(cf, form)(torch.as_tensor(meas)),
                    torch.as_tensor(p0), tl.DoglegParameters(**kw),
                    record_history=True)
    rj = jax.jit(lambda m, q: dl.optimize(
        getattr(jcf, form)(m), q, dl.DoglegParameters(**kw),
        record_history=True))(meas, p0)
    _assert_jax_decisions(r, rj, P_ATOL[instance])
    if instance == "keys" and prm == "default":
        assert tl.StopReason(int(r.reason)) in (
            tl.StopReason.GRADIENT_CONVERGED, tl.StopReason.SMALL_STEP)
        np.testing.assert_allclose(_np(r.p), cf.P_TRUE, atol=5e-2)
    elif instance == "keys":
        np.testing.assert_array_less(np.abs(_np(r.p) - cf.P_TRUE), 0.2)


def test_curve_fit_times_and_model_match_jax():
    for n in (16, 64, 100):
        np.testing.assert_array_equal(_np(cf.make_t(n, device="cpu")),
                                      np.asarray(jcf.make_t(n)))
    t = np.asarray(jcf.make_t(16))
    p = np.array([1.3, -0.7, 0.2])
    np.testing.assert_allclose(
        _np(cf.model(torch.as_tensor(p), torch.as_tensor(t))),
        np.asarray(jcf.model(jnp.asarray(p), jnp.asarray(t))), rtol=1e-15)


def test_curve_fit_jacobian_matches_autodiff():
    t = cf.make_t(16, device="cpu")
    p = torch.tensor([1.3, -0.7, 0.2], dtype=torch.float64)
    J = cf.jacobian(p, t)
    J_ad = torch.func.jacfwd(lambda q: cf.model(q, t))(p)
    np.testing.assert_allclose(_np(J), _np(J_ad), rtol=1e-12, atol=1e-12)


def test_curve_fit_is_nonlinear():
    """More than one accepted step from a cold start (the quadratic-surface
    demo is linear in p)."""
    meas, p0 = _curve_inputs("keys")
    r = tl.optimize(cf.make_dense_problem(torch.as_tensor(meas)),
                    torch.as_tensor(p0), tl.DoglegParameters())
    assert int(r.step_count) > 1


def test_curve_fit_generators_make_a_solvable_instance():
    """simulate and initial_state draw from a torch.Generator on its device
    and return on the one asked for; the instance converges."""
    g = torch.Generator().manual_seed(0)
    meas = cf.simulate(g, device="cpu")
    p0 = cf.initial_state(g, device="cpu")
    assert meas.shape == (64,) and p0.shape == (cf.NSTATE,)
    assert float(p0.abs().max()) <= 0.5
    again = cf.simulate(torch.Generator().manual_seed(0), device="cpu")
    assert torch.equal(meas, again)
    r = tl.optimize(cf.make_residual_problem(meas), p0)
    assert int(r.reason) in (int(tl.StopReason.GRADIENT_CONVERGED),
                             int(tl.StopReason.SMALL_STEP))
    np.testing.assert_allclose(_np(r.p), cf.P_TRUE, atol=5e-2)
    if not torch.cuda.is_available():   # the default device is the card
        with pytest.raises(RuntimeError, match='device="cpu"'):
            cf.make_t(8)


# ---------------------------------------------------------------------------
# legacy
# ---------------------------------------------------------------------------


def test_legacy_global_setters():
    """tests/test_params.py:39-72 on the port, the result equal to the JAX
    package's legacy.optimize under the same globals."""
    from libdogleg_tpu import legacy as jlegacy
    meas = np.asarray(jsp.simulate(jax.random.PRNGKey(0)))
    p0 = np.asarray(jsp.initial_state(jax.random.PRNGKey(1)))
    importlib.reload(legacy)
    importlib.reload(jlegacy)
    try:
        for mod in (legacy, jlegacy):
            mod.set_max_iterations(8)
            mod.set_initial_trustregion(500.0)
            mod.set_thresholds(-1.0, 1e-9, -1.0)   # <= 0 leaves unchanged
            mod.set_trustregion_update_parameters(0.2, 0.3, 3.0, 0.8)
            mod.set_debug(mod.DOGLEG_DEBUG_VNLOG)
        prm = legacy.get_global_parameters()
        assert prm.max_iterations == 8
        assert prm.trustregion0 == 500.0
        assert prm.Jt_x_threshold == 1e-8            # unchanged
        assert prm.update_threshold == 1e-9
        assert prm.trustregion_threshold == 1e-8     # unchanged
        assert prm.trustregion_decrease_factor == 0.2
        assert prm.trustregion_decrease_threshold == 0.3
        assert prm.trustregion_increase_factor == 3.0
        assert prm.trustregion_increase_threshold == 0.8
        assert (dataclasses.asdict(prm)
                == dataclasses.asdict(jlegacy.get_global_parameters()))
        r = legacy.optimize(qs.make_dense_problem(torch.as_tensor(meas)),
                            torch.as_tensor(p0))
        assert r.history is not None                 # vnlog bit -> history
        assert int(r.step_count) <= 8
        assert np.max(np.abs(_np(r.p) - qs.P_TRUE)) < 5e-2
        rj = jlegacy.optimize(jsp.make_dense_problem(meas), p0)
        _assert_jax_decisions(r, rj)
    finally:
        importlib.reload(legacy)                     # reset the globals
        importlib.reload(jlegacy)
    assert legacy.get_global_parameters() == tl.DoglegParameters()


def test_legacy_debug_bits(capsys):
    """Bit 30 alone records the History and prints nothing; any other bit
    prints the human stream, one line an attempt."""
    meas = qs.simulate(torch.Generator().manual_seed(0), device="cpu")
    p0 = qs.initial_state(torch.Generator().manual_seed(1), device="cpu")
    importlib.reload(legacy)
    try:
        r = legacy.optimize(qs.make_dense_problem(meas), p0)
        assert r.history is None and capsys.readouterr().out == ""
        legacy.set_debug(1)
        r = legacy.optimize(qs.make_dense_problem(meas), p0)
        lines = capsys.readouterr().out.splitlines()
        assert r.history is None and len(lines) == int(r.n_attempts)
        assert all(line.startswith("libdogleg-tpu: attempt ")
                   for line in lines)
        legacy.set_debug(legacy.DOGLEG_DEBUG_VNLOG | 1)
        r = legacy.optimize(qs.make_dense_problem(meas), p0,
                            record_history=False)
        assert r.history is None
        assert len(capsys.readouterr().out.splitlines()) == int(r.n_attempts)
    finally:
        importlib.reload(legacy)


# ---------------------------------------------------------------------------
# exports and the CLI
# ---------------------------------------------------------------------------


def test_every_jax_export_is_exported():
    import libdogleg_tpu
    missing = sorted(set(libdogleg_tpu.__all__) - set(tl.__all__))
    assert not missing, missing
    for name in tl.__all__:
        assert hasattr(tl, name), name
    from libdogleg_tpu_torch.ops.bcsr import BCSRJacobian, BCSRStructure
    from libdogleg_tpu_torch.sparsity import bcsr_from_scalar_csr
    assert tl.BCSRStructure is BCSRStructure
    assert tl.BCSRJacobian is BCSRJacobian
    assert tl.bcsr_from_scalar_csr is bcsr_from_scalar_csr


@pytest.mark.parametrize("mode", ["dense", "residual"])
def test_sample_cli_check(mode):
    """--check asserts convergence and 5e-2 recovery (reference
    sample.c:424-457): a zero exit is the assertion."""
    out = subprocess.run(
        [sys.executable, "-m", "libdogleg_tpu_torch.sample", "--check",
         "--device", "cpu", mode],
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def test_sample_cli_vnlog_stream():
    out = subprocess.run(
        [sys.executable, "-m", "libdogleg_tpu_torch.sample", "--diag",
         "vnlog", "--device", "cpu", "dense"],
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    lines = [line for line in out.stdout.splitlines() if line.strip()]
    assert lines[0].startswith("# iteration step_accepted norm2x_before")
    assert len(lines) > 2


# ---------------------------------------------------------------------------
# properties of the step math
# ---------------------------------------------------------------------------


def _problem(seed, n, m):
    rng = np.random.default_rng(seed)
    J = rng.normal(size=(m, n))
    x = rng.normal(size=(m,))
    JtJ = J.T @ J + 1e-6 * np.eye(n)
    return torch.as_tensor(JtJ), torch.as_tensor(J.T @ x)


@settings(max_examples=60, deadline=None)
@given(seed=st.integers(0, 10_000), n=st.integers(2, 10))
def test_cauchy_is_descent(seed, n):
    JtJ, Jt_x = _problem(seed, n, n + 6)
    c = dops.cauchy_step(Jt_x, JtJ)
    assert float(dops.expected_improvement(Jt_x, JtJ, c.step)) >= -1e-9
    assert float(dops.dot(Jt_x, c.step)) <= 1e-12


@settings(max_examples=60, deadline=None)
@given(seed=st.integers(0, 10_000), n=st.integers(2, 8),
       log_tr=st.floats(-3.0, 2.0))
def test_interpolated_step_on_sphere(seed, n, log_tr):
    JtJ, Jt_x = _problem(seed, n, n + 4)
    tr = float(10.0 ** log_tr)
    c = dops.cauchy_step(Jt_x, JtJ)
    fac = tchol.factorize_jtj(JtJ, torch.tensor(0.0, dtype=torch.float64))
    gn, n2_gn = tchol.gauss_newton_step(fac.L, Jt_x)
    # only the dog-leg case: Cauchy strictly inside, GN strictly outside
    if not (float(c.norm2_step) < tr * tr < float(n2_gn)):
        return
    interp = dops.interpolated_step(c.step, c.norm2_step, gn,
                                    torch.tensor(tr, dtype=torch.float64))
    np.testing.assert_allclose(float(torch.sqrt(interp.norm2_step)), tr,
                               rtol=1e-8)
    assert 0.0 <= float(interp.k) <= 1.0 + 1e-12


def _tr_update(rho, tr, edge, n2gn):
    return float(dops.trust_region_update(
        torch.tensor(rho, dtype=torch.float64),
        torch.tensor(tr, dtype=torch.float64), edge,
        torch.tensor(n2gn, dtype=torch.float64),
        decrease_factor=0.1, decrease_threshold=0.25,
        increase_factor=2.0, increase_threshold=0.75))


@settings(max_examples=80, deadline=None)
@given(rho=st.floats(-5.0, 5.0, allow_nan=False),
       tr=st.floats(1e-6, 1e3),
       edge=st.booleans(),
       n2gn=st.floats(1e-12, 1e6))
def test_trust_region_update_rules(rho, tr, edge, n2gn):
    out = _tr_update(rho, tr, edge, n2gn)
    if rho < 0.25:
        # shrink; an interior step snaps to the GN length first
        base = tr if edge else float(np.sqrt(n2gn))
        np.testing.assert_allclose(out, base * 0.1, rtol=1e-12)
    elif rho > 0.75 and edge:
        np.testing.assert_allclose(out, tr * 2.0, rtol=1e-12)
    else:
        np.testing.assert_allclose(out, tr, rtol=1e-12)


@settings(max_examples=40, deadline=None)
@given(tr=st.floats(1e-3, 1e3), edge=st.booleans())
def test_trust_region_nan_rho_keeps_radius(tr, edge):
    """A NaN gain ratio fails every comparison and leaves the radius alone
    (C comparison semantics, reference dogleg.c:1324-1354)."""
    assert _tr_update(float("nan"), tr, edge, 1.0) == tr
