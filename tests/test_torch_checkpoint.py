"""Segmented runs and checkpoints on the CPU: run_solver(max_new_attempts=,
wavefront_unroll=), run_batched_solver's segments and checkpoint.py's
save_state/load_state, against the JAX package's, in float64. The cases
replay tests/test_checkpoint.py on the port, and load states that the JAX
package saved.

Instance: the sample problem of the JAX package (sample_problem.simulate and
initial_state at PRNGKey 0 and 1), its measurements and start crossing as
numpy arrays; the batch is eight starts from PRNGKey 2. The JAX side is
computed once for the module.

Tolerances: decisions (step_count, n_attempts, reason, History step types)
identical; a segmented port run equals the one-shot port run bit for bit;
p within 1e-12 of the JAX package's (tests/test_checkpoint.py's).
"""

import functools

import jax
import numpy as np
import pytest
import torch

import libdogleg_tpu.sample_problem as jsp
from libdogleg_tpu import checkpoint as jck
from libdogleg_tpu.solver import (init_solver_state as j_init,
                                  result_from_state as j_result,
                                  run_solver as j_run,
                                  solve_products as j_solve)
import libdogleg_tpu_torch as tl
from libdogleg_tpu_torch import checkpoint as ck
from libdogleg_tpu_torch.models import bundle_adjustment
from libdogleg_tpu_torch.models import pinhole_ba as pba
from libdogleg_tpu_torch.models import quadratic_surface as qs
from libdogleg_tpu_torch.ops import treevec as tv

torch.set_num_threads(1)
RTOL = 1e-12
DECISIONS = ("step_count", "n_attempts", "reason")


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


def _same_bits(a, b) -> bool:
    ints = {torch.float64: torch.int64, torch.float32: torch.int32}
    if a.dtype in ints:
        a, b = a.view(ints[a.dtype]), b.view(ints[b.dtype])
    return a.shape == b.shape and torch.equal(a, b)


def _assert_same_state(a, b):
    """Two states of the port: every field equal, bit for bit."""
    assert type(a) is type(b)
    for name in a._fields:
        x, y = getattr(a, name), getattr(b, name)
        if name == "history":
            assert (x is None) == (y is None)
            if x is not None:
                for h1, h2 in zip(x, y):
                    assert _same_bits(h1, h2), name
        elif isinstance(x, torch.Tensor):
            assert _same_bits(x, y), name
        else:
            assert x == y and type(x) is type(y), name


@functools.lru_cache(maxsize=None)
def _inputs():
    meas = np.asarray(jsp.simulate(jax.random.PRNGKey(0)))
    p0 = np.asarray(jsp.initial_state(jax.random.PRNGKey(1)))
    keys = jax.random.split(jax.random.PRNGKey(2), 8)
    p0s = np.asarray(jax.vmap(jsp.initial_state)(keys))
    return meas, p0, p0s


def _jax_products():
    return jsp.make_dense_problem(_inputs()[0]).products


def _port_products():
    return qs.make_dense_problem(torch.as_tensor(_inputs()[0])).products


@functools.lru_cache(maxsize=None)
def _jax_one_shot():
    return jax.device_get(j_solve(_jax_products(), _inputs()[1],
                                  record_history=True))


def _assert_jax_decisions(r, rj):
    for field in DECISIONS:
        np.testing.assert_array_equal(_np(getattr(r, field)),
                                      np.asarray(getattr(rj, field)),
                                      err_msg=field)
    np.testing.assert_allclose(_np(r.p), np.asarray(rj.p), rtol=RTOL,
                               atol=RTOL)
    if r.history is not None and rj.history is not None:
        np.testing.assert_array_equal(_np(r.history.step_type),
                                      np.asarray(rj.history.step_type))


# ---------------------------------------------------------------------------
# segments
# ---------------------------------------------------------------------------


def test_segmented_run_matches_one_shot():
    """One attempt a segment gives the one-shot run's bits, and JAX's
    decisions."""
    products = _port_products()
    p0 = torch.as_tensor(_inputs()[1])
    state0 = tl.init_solver_state(products, p0, record_history=True)
    one = tl.run_solver(products, tl.init_solver_state(
        products, p0, record_history=True))
    state, segments = state0, 0
    while not state.done:
        state = tl.run_solver(products, state, max_new_attempts=1)
        segments += 1
        assert state.n_attempts == segments
    assert segments > 3
    _assert_same_state(state, one)
    _assert_jax_decisions(tl.result_from_state(state), _jax_one_shot())


@pytest.mark.parametrize("budget,unroll", [(3, 2), (3, 1), (4, 4), (0, 3)])
def test_budget_rounds_up_to_the_unroll(budget, unroll):
    """max_new_attempts with wavefront_unroll=k runs the budget rounded up
    to a multiple of k, as the JAX package's while_loop does."""
    products = _port_products()
    p0 = torch.as_tensor(_inputs()[1])
    st = tl.run_solver(products, tl.init_solver_state(products, p0),
                       max_new_attempts=budget, wavefront_unroll=unroll)
    js = j_run(_jax_products(), j_init(_jax_products(), _inputs()[1]),
               max_new_attempts=budget, wavefront_unroll=unroll)
    assert st.n_attempts == int(js.n_attempts) == -(-budget // unroll) * unroll
    assert st.step_count == int(js.step_count)
    assert not st.done
    r = tl.result_from_state(st)
    assert int(r.reason) == int(tl.StopReason.RUNNING) == int(js.reason)


def test_run_on_finished_state_is_noop():
    products = _port_products()
    st = tl.run_solver(products, tl.init_solver_state(
        products, torch.as_tensor(_inputs()[1])))
    assert st.done
    again = tl.run_solver(products, st, max_new_attempts=5,
                          wavefront_unroll=2)
    _assert_same_state(again, st)
    assert tl.run_solver(products, st) is st


def test_batched_segments_round_up_to_the_unroll():
    products = torch.func.vmap(_port_products())
    p0s = torch.as_tensor(_inputs()[2])
    st = tl.init_batched_state(products, p0s)
    st = tl.run_batched_solver(products, st, max_new_attempts=3,
                               wavefront_unroll=2)
    assert int(st.n_attempts.max()) == 4
    assert bool(((st.n_attempts == 4) | st.done).all())
    full = tl.run_batched_solver(products, st)
    ref = tl.solve_products_batched(products, p0s)
    for field in DECISIONS:
        assert torch.equal(getattr(full, field), getattr(ref, field))
    assert _same_bits(full.p, ref.p)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def test_checkpoint_roundtrip_and_resume(tmp_path):
    products = _port_products()
    p0 = torch.as_tensor(_inputs()[1])
    state = tl.run_solver(products, tl.init_solver_state(
        products, p0, record_history=True), max_new_attempts=3)
    assert not state.done
    path = str(tmp_path / "ckpt.npz")
    ck.save_state(path, state)
    restored = ck.load_state(path, device="cpu")
    _assert_same_state(restored, state)
    final = tl.run_solver(products, restored)
    one = tl.run_solver(products, tl.init_solver_state(
        products, p0, record_history=True))
    _assert_same_state(final, one)
    _assert_jax_decisions(tl.result_from_state(final), _jax_one_shot())


def test_jax_saved_state_resumes_in_the_port(tmp_path):
    """A state the JAX package saved after 3 attempts, History included,
    loads with Python flags and counters and runs on to JAX's one-shot
    decisions."""
    js = j_run(_jax_products(), j_init(_jax_products(), _inputs()[1],
                                       record_history=True),
               max_new_attempts=3)
    path = str(tmp_path / "jax.npz")
    jck.save_state(path, js)
    st = ck.load_state(path, device="cpu")
    assert isinstance(st, tl.solver.SolverState)
    assert st.n_attempts == 3 and type(st.n_attempts) is int
    assert type(st.done) is bool and type(st.have_gn) is bool
    assert st.p.dtype == torch.float64 and st.history is not None
    final = tl.result_from_state(tl.run_solver(_port_products(), st))
    _assert_jax_decisions(final, _jax_one_shot())


def test_port_saved_state_loads_in_jax(tmp_path):
    products = _port_products()
    st = tl.run_solver(products, tl.init_solver_state(
        products, torch.as_tensor(_inputs()[1])), max_new_attempts=2)
    path = str(tmp_path / "port.npz")
    ck.save_state(path, st)
    js = jck.load_state(path)
    assert int(js.n_attempts) == 2
    _assert_jax_decisions(tl.result_from_state(tl.run_solver(products, st)),
                          j_result(j_run(_jax_products(), js)))


@functools.lru_cache(maxsize=None)
def _jax_batched():
    """(state after 2 attempts, vmap(solve_products)) of the JAX package."""
    products = _jax_products()
    p0s = _inputs()[2]
    st = jax.vmap(lambda q: j_init(products, q))(p0s)
    st = jax.jit(jax.vmap(lambda s: j_run(products, s,
                                          max_new_attempts=2)))(st)
    ref = jax.vmap(lambda q: j_solve(products, q))(p0s)
    return jax.device_get(st), jax.device_get(ref)


@pytest.mark.parametrize("saved_by,history", [("port", False),
                                              ("port", True),
                                              ("jax", False)])
def test_batched_checkpoint(tmp_path, saved_by, history):
    """A batched state after 2 attempts, through save and load, resumes to
    the JAX package's vmap(solve_products) result and to the port's
    one-shot bits. Without a History the loaded state carries no
    prev_step; with one it keeps it. The JAX package's batch is saved
    without a History, as tests/test_checkpoint.py saves it."""
    js, ref = _jax_batched()
    products = torch.func.vmap(_port_products())
    p0s = torch.as_tensor(_inputs()[2])
    path = str(tmp_path / "batch.npz")
    if saved_by == "jax":
        jck.save_state(path, js)
    else:
        st = tl.run_batched_solver(
            products, tl.init_batched_state(products, p0s,
                                            record_history=history),
            max_new_attempts=2)
        ck.save_state(path, st)
    loaded = ck.load_state(path, device="cpu")
    assert isinstance(loaded, tl.BatchedSolverState)
    assert (loaded.prev_step is None) == (not history)
    assert (loaded.history is None) == (not history)
    assert int(loaded.n_attempts.max()) == 2
    if saved_by == "port":
        for name in loaded._fields:
            for a, b in zip(tv.tree_leaves(getattr(loaded, name)),
                            tv.tree_leaves(getattr(st, name))):
                assert _same_bits(a, b), name
    final = tl.result_from_batched_state(
        tl.run_batched_solver(products, loaded))
    _assert_jax_decisions(final._replace(history=None), ref)
    if saved_by == "port":
        one = tl.solve_products_batched(products, p0s,
                                        record_history=history)
        assert _same_bits(final.p, one.p)
        if history:
            assert torch.equal(final.history.step_type,
                               one.history.step_type)


def test_tree_and_structured_states_raise(tmp_path):
    """A tree state, or a flat state with a structured JtJ, is refused at
    save, naming the limitation, for the single and the batched state."""
    ba = pba.make_synthetic(seed=0, ncam=3, npts=8, device="cpu")
    p0 = ba.p0()
    st = tl.init_solver_state(ba.products, p0)
    with pytest.raises(ValueError, match="'p' is a dict.*tree states"):
        ck.save_state(str(tmp_path / "tree.npz"), st)
    pb = {k: v[None].expand((2,) + v.shape).clone() for k, v in p0.items()}
    bst = tl.init_batched_state(torch.func.vmap(ba.products), pb)
    with pytest.raises(ValueError, match="tree states"):
        ck.save_state(str(tmp_path / "tree_batch.npz"), bst)
    lin = bundle_adjustment.make_synthetic(seed=3, nc=6, n_points=10,
                                           dtype=torch.float64, device="cpu")
    flat = tl.init_solver_state(lin.products,
                                torch.zeros(lin.nstate, dtype=torch.float64))
    with pytest.raises(ValueError, match="'JtJ' is a SchurJtJ.*structured"):
        ck.save_state(str(tmp_path / "schur.npz"), flat)
    assert not list(tmp_path.iterdir())
