"""The port's distributed checkpoint (checkpoint.save_state_orbax /
load_state_orbax on torch.distributed.checkpoint) against the JAX
package's orbax pair: a roundtrip in one process without a process group,
bit for bit, and a dp-sharded batched state on a group of four gloo ranks
(tests/torch_mesh_worker.py, leg ckpt), whose resumed run takes the
one-shot run's decisions and the JAX package's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libdogleg_tpu as dl
import libdogleg_tpu.models.quadratic_surface as jsp
import torch_mesh_worker as worker
from libdogleg_tpu.parallel.batched import batched_optimize as jax_batched
from libdogleg_tpu_torch import DoglegParameters, checkpoint
from libdogleg_tpu_torch.solver import (BatchedSolverState, SolverState,
                                        init_batched_state, init_solver_state,
                                        run_batched_solver, run_solver)

DECISIONS = ("step_count", "n_attempts", "reason")


def _instances(seed, batch):
    rng = np.random.default_rng(seed)
    c = jsp.GRID_MIN + jsp.GRID_DELTA * np.arange(jsp.GRID_WIDTH)
    gx, gy = (a.ravel() for a in np.meshgrid(c, c, indexing="ij"))
    p = jsp.P_TRUE
    truth = (p[0] * p[1] * gx * gx + p[1] * p[2] * gy * gy + p[2] * gx * gy
             + p[3] * gx + p[4] * gy + p[5])
    meas = truth + rng.uniform(size=(batch, truth.size)) - 0.5
    return meas, rng.uniform(size=(batch, jsp.NSTATE)) - 0.1


def _products():
    return worker.qs_products()


def _same(a, b):
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a, b)
    return type(a) is type(b) and a == b


@pytest.mark.parametrize("history", [False, True])
def test_orbax_roundtrip_single(tmp_path, history):
    """test_checkpoint.py:94: a single solve's state after two attempts
    comes back exactly, its flags and counters as Python values, without
    a process group."""
    import torch.distributed as dist
    assert not dist.is_initialized()
    meas, p0 = (torch.as_tensor(a[0]) for a in _instances(0, 1))
    prods = _products()

    def fn(p):
        return prods(p, meas)
    st = run_solver(fn, init_solver_state(fn, p0, record_history=history),
                    max_new_attempts=2)
    path = str(tmp_path / "ckpt")
    checkpoint.save_state_orbax(path, st)
    back = checkpoint.load_state_orbax(path, st)
    assert isinstance(back, SolverState)
    for name in SolverState._fields:
        a, b = getattr(st, name), getattr(back, name)
        if name == "history":
            assert (a is None) == (b is None)
            if a is not None:
                assert all(_same(x, y) for x, y in zip(a, b))
        else:
            assert _same(a, b), name
    # the resumed solve is the one-shot solve
    done = run_solver(fn, back)
    once = run_solver(fn, init_solver_state(fn, p0, record_history=history))
    assert torch.equal(done.p, once.p)
    assert done.n_attempts == once.n_attempts


def test_orbax_roundtrip_batched(tmp_path):
    """A batched state without a History (its prev_step fields absent)."""
    meas, p0 = (torch.as_tensor(a) for a in _instances(1, 8))
    vf = torch.func.vmap(_products())

    def fn(p):
        return vf(p, meas)
    prm = DoglegParameters(max_iterations=8)
    st = run_batched_solver(fn, init_batched_state(fn, p0, prm), prm,
                            max_new_attempts=3)
    path = str(tmp_path / "ckpt")
    checkpoint.save_state_orbax(path, st)
    back = checkpoint.load_state_orbax(path, st)
    assert isinstance(back, BatchedSolverState)
    for name in BatchedSolverState._fields:
        a, b = getattr(st, name), getattr(back, name)
        assert (a is None and b is None) or _same(a, b), name


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_ckpt")
    meas, p0 = _instances(4, 16)
    path = str(tmp / "inputs.npz")
    np.savez(path, meas_16=meas, p0_16=p0)
    outs = worker.spawn_group(path, str(tmp), legs="ckpt", limit=180.0)
    ref = jax_batched(_jax_products, jnp.asarray(p0),
                      dl.DoglegParameters(max_iterations=8),
                      problem_data=jnp.asarray(meas), use_megakernel=False)
    return outs, ref


def _jax_products(p, m):
    gx, gy = jsp.make_grid(m.dtype)
    x = jsp.model(p, gx, gy) - m
    J = jsp.jacobian(p, gx, gy)
    return dl.solver.Products(norm2_x=x @ x, Jt_x=J.T @ x, JtJ=J.T @ J)


def test_sharded_state_loads_each_ranks_shards(group):
    """Each rank wrote its shards of the dp-sharded state and read them
    back onto a fresh state's placements, bit for bit."""
    outs, _ = group
    for o in outs:
        assert bool(o["ckpt/loaded_equal"])
        assert str(o["ckpt/placements"]) == "(Shard(dim=0),)"


@pytest.mark.parametrize("field", DECISIONS + ("p",))
def test_resumed_sharded_run_is_the_one_shot_run(group, field):
    """The resumed run gives the one-shot sharded run's bits and the JAX
    package's unsharded decisions (p within rtol 1e-12); every rank the
    same."""
    outs, ref = group
    o = outs[0]
    got = o[f"ckpt_resumed/{field}"]
    assert got.tobytes() == o[f"ckpt_oneshot/{field}"].tobytes()
    if field == "p":
        np.testing.assert_allclose(got, np.asarray(ref.p), rtol=1e-12,
                                   atol=1e-13)
    else:
        np.testing.assert_array_equal(got, np.asarray(getattr(ref, field)))
    for other in outs[1:]:
        assert other[f"ckpt_resumed/{field}"].tobytes() == got.tobytes()
