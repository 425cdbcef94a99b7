"""The port's diagnostics (libdogleg_tpu_torch.diagnostics), the single
solve's debug=True stream and the sample CLI's --diag and --test-gradients,
against the JAX package, in float64 on the CPU, on the same numpy inputs.

Replays the vnlog cases of tests/test_analysis.py and the CLI's streams:
texts are parsed, words compared exactly and numbers at rtol 1e-9 (vnlog
and debug lines print 6 significant digits) or 1e-8 (gradient tables, whose
finite differences amplify the last bits of x). The port's CLI is fed the
JAX package's measurements and start (its own come from torch generators),
so both solve the same instance. The JAX side is jitted once per case and
cached for the module.
"""

import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libdogleg_tpu as dl
import libdogleg_tpu.sample_problem as jsp
from libdogleg_tpu import diagnostics as jd
from libdogleg_tpu import sample as jsample
import libdogleg_tpu_torch as tl
import libdogleg_tpu_torch.sample_problem as tsp
from libdogleg_tpu_torch import diagnostics as td
from libdogleg_tpu_torch import sample as tsample
from libdogleg_tpu_torch.solver import History

torch.set_num_threads(1)

_WORDS = {"cauchy", "gaussnewton", "interpolated", "failed", "-", "True",
          "False", "nan"}


@functools.lru_cache(maxsize=None)
def _data():
    meas = np.asarray(jsp.simulate(jax.random.PRNGKey(0)))
    p0 = np.asarray(jsp.initial_state(jax.random.PRNGKey(1)))
    return meas, p0


@functools.lru_cache(maxsize=None)
def _jax_result(record=True):
    meas, p0 = _data()
    problem = jsp.make_dense_problem(jnp.asarray(meas))
    return jax.jit(lambda p: dl.optimize(problem, p, record_history=record))(
        jnp.asarray(p0))


def _port_result(**kw):
    meas, p0 = _data()
    return tl.optimize(tsp.make_dense_problem(torch.as_tensor(meas)),
                       torch.as_tensor(p0), **kw)


def _fields(text):
    """Every whitespace-separated field of every line, numbers as floats
    where they parse; separators and words kept as strings."""
    out = []
    for line in text.strip().split("\n"):
        row = []
        for cell in re.split(r"[\s|/]+", line.strip()):
            if not cell:
                continue
            try:
                row.append(float(cell) if cell not in _WORDS else cell)
            except ValueError:
                row.append(cell)
        out.append(row)
    return out


def _same_fields(got, want, rtol):
    """Two texts with the same lines and words, their numbers within rtol
    (nan where the other has nan)."""
    g, w = _fields(got), _fields(want)
    assert len(g) == len(w)
    for rg, rw in zip(g, w):
        assert len(rg) == len(rw), (rg, rw)
        for a, b in zip(rg, rw):
            if isinstance(b, float) and isinstance(a, float):
                if np.isnan(b):
                    assert np.isnan(a)
                else:
                    np.testing.assert_allclose(a, b, rtol=rtol, atol=0)
            else:
                assert a == b, (rg, rw)


def _history_from_jax(h):
    """A JAX History as the port's (the renderers then see the same
    numbers)."""
    return History(*(torch.as_tensor(np.array(v)) for v in h))


# ---------------------------------------------------------------- vnlog

def test_vnlog_legend_identical():
    assert td.vnlog_legend() == jd.vnlog_legend()


def test_vnlog_of_same_history_identical():
    """The renderer on one History (the JAX solve's, carried over) gives
    JAX's text byte for byte."""
    rj = _jax_result()
    assert td.format_vnlog(_history_from_jax(rj.history), rj.n_attempts) \
        == jd.format_vnlog(rj.history, rj.n_attempts)
    assert td.format_vnlog(_history_from_jax(rj.history)) \
        == jd.format_vnlog(rj.history)


def test_vnlog_rows_match_jax_solve():
    """The port's own solve with History against JAX's: iteration,
    step_accepted and step type identical, '-' in the same places, numbers
    within rtol 1e-9; the reference's schema checks of
    tests/test_analysis.py:36-54."""
    rt, rj = _port_result(record_history=True), _jax_result()
    got = td.format_vnlog(rt.history, rt.n_attempts)
    _same_fields(got, jd.format_vnlog(rj.history, rj.n_attempts), 1e-9)
    lines = got.strip().split("\n")
    assert lines[0] == td.vnlog_legend()
    assert len(lines) - 1 == int(rt.n_attempts)
    for row in lines[1:]:
        cells = row.split()
        assert len(cells) == 16
        assert cells[1] in ("0", "1")
        assert cells[9] in ("cauchy", "gaussnewton", "interpolated", "-")
    assert sum(int(row.split()[1]) for row in lines[1:]) == \
        int(rt.step_count)


def test_print_vnlog_matches_and_requires_history(capsys):
    rt, rj = _port_result(record_history=True), _jax_result()
    td.print_vnlog(rt)
    got = capsys.readouterr().out
    jd.print_vnlog(rj)
    _same_fields(got, capsys.readouterr().out, 1e-9)
    with pytest.raises(ValueError):
        td.print_vnlog(_port_result())
    with pytest.raises(ValueError):
        jd.print_vnlog(_jax_result(record=False))


def test_explain_result_matches_jax():
    got = td.explain_result(_port_result())
    _same_fields(got, jd.explain_result(_jax_result(record=False)), 1e-9)
    assert "accepted steps" in got and "stop=" in got


# ---------------------------------------------------------------- debug

@functools.lru_cache(maxsize=None)
def _jax_debug_text():
    """The JAX solve's jax.debug.print stream (captured by the caller)."""
    meas, p0 = _data()
    problem = jsp.make_dense_problem(jnp.asarray(meas))
    r = jax.jit(lambda p: dl.optimize(
        problem, p, dl.DoglegParameters(max_iterations=8), debug=True))(
            jnp.asarray(p0))
    jax.effects_barrier()
    return int(r.n_attempts)


def test_debug_lines_match_jax(capsys):
    """debug=True prints one line an attempt with the JAX package's text:
    the same count as JAX's jax.debug.print stream, words identical, numbers
    within rtol 1e-9; the solve's results unchanged."""
    n_j = _jax_debug_text()
    want = capsys.readouterr().out
    prm = tl.DoglegParameters(max_iterations=8)
    r = _port_result(parameters=prm, debug=True)
    got = capsys.readouterr().out
    assert int(r.n_attempts) == n_j == len(got.strip().split("\n"))
    assert got.startswith("libdogleg-tpu: attempt 0: trustregion ")
    _same_fields(got, want, 1e-9)
    quiet = _port_result(parameters=prm)
    assert capsys.readouterr().out == ""
    for a, b in zip(r, quiet):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)


@pytest.mark.parametrize("record", [False, True])
def test_debug_false_is_todays_solve(record, capsys):
    """debug=False (the default) prints nothing and gives the bits of the
    call without the argument, History included."""
    base = _port_result(record_history=record)
    off = _port_result(record_history=record, debug=False)
    assert capsys.readouterr().out == ""
    for name in base._fields:
        a, b = getattr(base, name), getattr(off, name)
        if a is None:
            assert b is None
        elif isinstance(a, History):
            assert all(torch.equal(x, y) for x, y in zip(a, b))
        else:
            assert torch.equal(a, b), name


def test_debug_on_tree_state(capsys):
    """The debug stream on a {"c", "q"} bundle-adjustment solve: one line
    an attempt, the History's step types."""
    from libdogleg_tpu_torch.models import pinhole_ba as tpb
    ba = tpb.make_synthetic_sparse(seed=0, ncam=4, npts=30, k_obs=2,
                                   dtype=torch.float64, device="cpu")
    r = tl.solve_products(ba.products, ba.p0(torch.Generator().manual_seed(2),
                                             jitter=0.02),
                          newton_solver=ba.newton_solver(),
                          record_history=True, debug=True)
    lines = capsys.readouterr().out.strip().split("\n")
    assert len(lines) == int(r.n_attempts)
    types = [int(re.search(r"step type (\d)", ln).group(1)) for ln in lines]
    assert types == r.history.step_type[:int(r.n_attempts)].tolist()


def test_profile_op_summary_table():
    text = td.profile_op_summary(lambda a: a @ a, torch.ones(64, 64), top=3)
    lines = text.split("\n")
    assert lines[0].split() == ["ms", "calls", "op"]
    assert 2 <= len(lines) <= 4
    for row in lines[1:]:
        ms, calls, _ = row.split(maxsplit=2)
        assert float(ms) >= 0.0 and int(calls) >= 1


# ---------------------------------------------------------------- CLI

_CLI_MODES = ["dense", "sparse", "dense-products-unpacked"]

@pytest.fixture
def same_instance(monkeypatch):
    """The port's CLI on the JAX package's measurements and start."""
    meas, p0 = _data()
    monkeypatch.setattr(tsp, "simulate", lambda g, dtype, device:
                        torch.as_tensor(meas, dtype=dtype, device=device))
    monkeypatch.setattr(tsp, "initial_state", lambda g, dtype, device:
                        torch.as_tensor(p0, dtype=dtype, device=device))


def _run_both(capsys, argv):
    """(port's rc, stdout, stderr, JAX's rc, stdout, stderr)."""
    rc_t = tsample.main(["--device", "cpu"] + argv)
    out_t = capsys.readouterr()
    rc_j = jsample.main(["--platform", "cpu"] + argv)
    jax.effects_barrier()
    out_j = capsys.readouterr()
    return rc_t, out_t.out, out_t.err, rc_j, out_j.out, out_j.err


@pytest.mark.parametrize("mode", _CLI_MODES)
def test_cli_diag_vnlog_matches_jax(mode, capsys, same_instance):
    rc_t, out_t, err_t, rc_j, out_j, err_j = _run_both(
        capsys, ["--diag", "vnlog", mode])
    assert rc_t == rc_j == 0
    assert out_t.split("\n")[0] == td.vnlog_legend()
    _same_fields(out_t, out_j, 1e-9)
    # the stderr narration: the same lines, numbers to the printed digits
    _same_fields(err_t, err_j, 1e-9)


@pytest.mark.parametrize("mode", _CLI_MODES)
def test_cli_test_gradients_matches_jax(mode, capsys, same_instance):
    """The gradient tables: the .full() modes' tables equal JAX's (legend,
    row count, words; numbers rtol 1e-8). The products mode prints what
    check_gradients_products gives (held to JAX in
    tests/test_torch_analysis.py); its reported column equals JAX's at
    rtol 1e-8 and every relative error is below 1e-5 in both."""
    from libdogleg_tpu_torch.analysis import check_gradients_products
    rc_t, out_t, _, rc_j, out_j, _ = _run_both(
        capsys, ["--test-gradients", mode])
    assert rc_t == rc_j == 0
    if not mode.startswith("dense-products"):
        assert len(out_t.strip().split("\n")) == tsp.NSTATE * (tsp.NMEAS + 1)
        _same_fields(out_t, out_j, 1e-8)
        return
    lines_t, lines_j = out_t.strip().split("\n"), out_j.strip().split("\n")
    assert lines_t[0] == lines_j[0] and len(lines_t) == len(lines_j) == 7
    meas, p0 = _data()
    problem = tsp.make_products_problem(torch.as_tensor(meas))
    for ivar, (rt, rj) in enumerate(zip(lines_t[1:], lines_j[1:])):
        rep, obs, err, rel = (float(v) for v in check_gradients_products(
            problem, torch.as_tensor(p0), ivar))
        assert rt == (f"{ivar} {rep:.6g} {obs:.6g} {err:.6g} {rel:.6g}")
        ft, fj = rt.split(), rj.split()
        assert ft[0] == fj[0]
        np.testing.assert_allclose(float(ft[1]), float(fj[1]), rtol=1e-8)
        assert float(ft[4]) < 1e-5 and float(fj[4]) < 1e-5


@pytest.mark.parametrize("mode", _CLI_MODES)
def test_cli_check_with_test_gradients_returns_1(mode, capsys):
    rc_t, _, err_t, rc_j, _, err_j = _run_both(
        capsys, ["--check", "--test-gradients", mode])
    assert rc_t == rc_j == 1
    assert err_t == err_j


def test_cli_diag_human_matches_jax(capsys, same_instance):
    """--diag human: the debug lines on stdout and the summary on stderr,
    as JAX's."""
    rc_t, out_t, err_t, rc_j, out_j, err_j = _run_both(
        capsys, ["--diag", "human", "dense"])
    assert rc_t == rc_j == 0
    assert out_t.startswith("libdogleg-tpu: attempt 0:")
    _same_fields(out_t, out_j, 1e-9)
    _same_fields(err_t, err_j, 1e-9)
    assert "accepted steps" in err_t
