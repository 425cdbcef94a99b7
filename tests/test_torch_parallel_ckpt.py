"""The port's distributed checkpoint (checkpoint.save_state_orbax /
load_state_orbax on torch.distributed.checkpoint) against the JAX
package's orbax pair: roundtrips in one process without a process group,
bit for bit (flat states, tree states with a SchurJtJ or a SparseWSchurJtJ,
a batched tree state), and on a group of four gloo ranks
(tests/torch_mesh_worker.py, legs ckpt and pts_ckpt) a dp-sharded batched
state and the two bundle adjustments point-sharded, whose resumed runs
take the one-shot runs' bits and the JAX package's decisions; the
point-sharded checkpoints then load in this process onto unsharded
states. The JAX side, in float64 on the CPU, is computed once for the
module (one jitted program an instance) while the group runs."""

import functools
import threading

import jax
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
                                        result_from_state, run_batched_solver,
                                        run_solver, solve_products)

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


# ---------------------------------------------------------------------------
# tree states with structured JtJ, in one process
# ---------------------------------------------------------------------------

PTS = ("schur", "sparse")


@functools.lru_cache(maxsize=None)
def _pts_start():
    """test_parallel.py:334's start (jax.random key 4, jitter 0.02), as
    numpy arrays."""
    from libdogleg_tpu.models import pinhole_ba
    sp = pinhole_ba.make_synthetic_sparse(seed=2, ncam=8, npts=160, k_obs=3)
    return {k: np.asarray(v) for k, v in
            sp.p0(jax.random.PRNGKey(4), jitter=0.02).items()}


@functools.lru_cache(maxsize=None)
def _jax_pts():
    """The JAX package's unsharded runs of test_parallel.py:155's linear
    instance (tree form) and :334's sparse-visibility one from the port's
    starts: name -> (the state after run_solver(max_new_attempts=2), the
    one-shot run's state), one jitted program an instance."""
    from libdogleg_tpu.models import bundle_adjustment, pinhole_ba
    prm = dl.DoglegParameters()

    def runs(fn, start, ns):
        st = dl.init_solver_state(fn, start, prm)
        return (dl.run_solver(fn, st, prm, newton_solver=ns,
                              max_new_attempts=2),
                dl.run_solver(fn, st, prm, newton_solver=ns))
    ba = bundle_adjustment.make_synthetic(seed=3, nc=8, n_points=64,
                                          block_size=3, k_obs=4,
                                          dtype=jnp.float64, noise=0.05)
    sp = pinhole_ba.make_synthetic_sparse(seed=2, ncam=8, npts=160, k_obs=3)
    p0 = _pts_start()
    return {"schur": jax.jit(lambda: runs(ba.products_tree, ba.p0_tree(),
                                          ba.tree_newton_solver()))(),
            "sparse": jax.jit(lambda c, q: runs(
                sp.products, {"c": c, "q": q}, sp.newton_solver()))(
                    p0["c"], p0["q"])}


def _port_pts(name):
    """The port's unsharded (products, start, strategy) of an instance,
    the starts those of the 4-rank legs."""
    from libdogleg_tpu_torch.models import bundle_adjustment as lba
    from libdogleg_tpu_torch.models import pinhole_ba as pba
    if name == "schur":
        ba = lba.make_synthetic(seed=3, nc=8, n_points=64, block_size=3,
                                k_obs=4, dtype=torch.float64, noise=0.05,
                                device="cpu")
        return ba.products_tree, ba.p0_tree(), ba.tree_newton_solver()
    sp = pba.make_synthetic_sparse(seed=2, ncam=8, npts=160, k_obs=3,
                                   device="cpu")
    return (sp.products, {k: torch.tensor(v)
                          for k, v in _pts_start().items()},
            sp.newton_solver())


def _assert_same_state(a, b):
    assert type(a) is type(b)
    assert all(worker._same_bits(x, y) for x, y in zip(a, b))


@functools.lru_cache(maxsize=None)
def _port_two_attempts(name):
    fn, p0, ns = _port_pts(name)
    prm = DoglegParameters()
    st = run_solver(fn, init_solver_state(fn, p0, prm, record_history=True),
                    prm, newton_solver=ns, max_new_attempts=2)
    return fn, p0, ns, st


@pytest.mark.parametrize("name", PTS)
def test_orbax_roundtrip_tree_state(tmp_path, name):
    """A tree state after two attempts, with a SchurJtJ (the linear
    instance, test_parallel.py:155) and with a SparseWSchurJtJ
    (test_parallel.py:334's instance), its History recorded, comes back
    bit for bit, its JtJ's type and its flags and counters as Python
    values."""
    _, _, _, st = _port_two_attempts(name)
    path = str(tmp_path / "ckpt")
    checkpoint.save_state_orbax(path, st)
    back = checkpoint.load_state_orbax(path, st)
    assert type(back.JtJ) is type(st.JtJ)
    assert isinstance(back.done, bool) and isinstance(back.n_attempts, int)
    _assert_same_state(back, st)


@pytest.mark.parametrize("name", PTS)
def test_orbax_resumed_tree_run_is_the_one_shot_run(tmp_path, name):
    """The tree state loaded from the checkpoint runs on to the one-shot
    solve's bits in every result field, History included."""
    fn, p0, ns, st = _port_two_attempts(name)
    path = str(tmp_path / "ckpt")
    checkpoint.save_state_orbax(path, st)
    back = checkpoint.load_state_orbax(path, st)
    done = result_from_state(run_solver(fn, back, newton_solver=ns))
    once = solve_products(fn, p0, newton_solver=ns, record_history=True)
    assert worker._same_bits(done, once)


@pytest.mark.parametrize("name", PTS)
def test_two_attempts_take_jax_decisions(name):
    """After run_solver(max_new_attempts=2) the state's decisions are the
    JAX package's after its run_solver(max_new_attempts=2) from the same
    start."""
    _, _, _, st = _port_two_attempts(name)
    two, _ = _jax_pts()[name]
    for f in ("step_count", "n_attempts", "reason", "done"):
        assert getattr(st, f) == getattr(two, f).item(), f


def test_orbax_roundtrip_batched_tree_state(tmp_path):
    """Config 9 small (torch_mesh_worker.config9_small: the pinhole
    instance of ncam 3, npts 16, a batch of 8 under per-element
    observations): a batched tree state with a batched SchurJtJ and a
    History, after two attempts, comes back bit for bit and resumes to
    the one-shot batched run's bits."""
    from libdogleg_tpu_torch import (result_from_batched_state,
                                     solve_products_batched)
    vf, obs_b, p0, ns = worker.config9_small()

    def fn(p):
        return vf(p, obs_b)
    prm = DoglegParameters(max_iterations=6)
    st = run_batched_solver(fn, init_batched_state(fn, p0, prm,
                                                   record_history=True),
                            prm, newton_solver=ns, max_new_attempts=2)
    path = str(tmp_path / "ckpt")
    checkpoint.save_state_orbax(path, st)
    back = checkpoint.load_state_orbax(path, st)
    _assert_same_state(back, st)
    done = result_from_batched_state(run_batched_solver(
        fn, back, prm, newton_solver=ns))
    once = solve_products_batched(fn, p0, prm, newton_solver=ns,
                                  record_history=True)
    assert worker._same_bits(done, once)


# ---------------------------------------------------------------------------
# the four gloo ranks
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """The four ranks' outputs (legs ckpt and pts_ckpt), the JAX batched
    reference and the directory the ranks wrote their checkpoints to. The
    group starts first and runs while JAX computes its references."""
    tmp = tmp_path_factory.mktemp("mesh_ckpt")
    meas, p0 = _instances(4, 16)
    path = str(tmp / "inputs.npz")
    p0_pts = _pts_start()
    np.savez(path, meas_16=meas, p0_16=p0, pts_p0_c=p0_pts["c"],
             pts_p0_q=p0_pts["q"])
    box = {}

    def run():
        try:
            box["outs"] = worker.spawn_group(path, str(tmp), legs="ckpt",
                                             limit=180.0)
        except Exception as e:  # handed to the tests, which fail on it
            box["error"] = e
    th = threading.Thread(target=run)
    th.start()
    ref = jax_batched(_jax_products, jnp.asarray(p0),
                      dl.DoglegParameters(max_iterations=8),
                      problem_data=jnp.asarray(meas), use_megakernel=False)
    _jax_pts()
    th.join()
    if "error" in box:
        raise box["error"]
    return box["outs"], ref, tmp


def _jax_products(p, m):
    gx, gy = jsp.make_grid(m.dtype)
    x = jsp.model(p, gx, gy) - m
    J = jsp.jacobian(p, gx, gy)
    return dl.solver.Products(norm2_x=x @ x, Jt_x=J.T @ x, JtJ=J.T @ J)


def test_sharded_state_loads_each_ranks_shards(group):
    """Each rank wrote its shards of the dp-sharded state and read them
    back onto a fresh state's placements, bit for bit."""
    outs, _, _ = group
    for o in outs:
        assert bool(o["ckpt/loaded_equal"])
        assert str(o["ckpt/placements"]) == "(Shard(dim=0),)"


def test_dp_sharded_batched_tree_state_roundtrip(group):
    """Config 9 small's batch of 8 tree states, dp-sharded over the 4
    ranks (2 each), through the checkpoint after two attempts: each rank
    reads its blocks back bit for bit, and its resumed run gives the
    unsharded batched run's bits on its elements."""
    outs, _, _ = group
    for o in outs:
        assert bool(o["ckpt9/loaded_equal"])
        assert bool(o["ckpt9/same_bits"])


@pytest.mark.parametrize("field", DECISIONS + ("p",))
def test_resumed_sharded_run_is_the_one_shot_run(group, field):
    """The resumed run gives the one-shot sharded run's bits and the JAX
    package's unsharded decisions (p within rtol 1e-12); every rank the
    same."""
    outs, ref, _ = group
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


PTS_PLACEMENTS = {
    "schur": "c (Replicate(),) q (Shard(dim=0),) U (Replicate(),) "
             "W (Shard(dim=1),) V (Shard(dim=0),)",
    "sparse": "c (Replicate(),) q (Shard(dim=0),) U (Replicate(),) "
              "Wv (Shard(dim=0),) cam_of (Shard(dim=0),) V (Shard(dim=0),)"}


@pytest.mark.parametrize("name", PTS)
def test_point_sharded_state_loads_each_ranks_blocks(group, name):
    """Each rank wrote its blocks of the point-sharded state after two
    attempts and read them back onto a fresh init_solver_state's
    placements, bit for bit: q and the JtJ's point blocks sharded on
    their point axis (a SchurJtJ's W on axis 1), c and U replicated."""
    outs, _, _ = group
    for o in outs:
        assert bool(o[f"pts_ckpt_{name}/loaded_equal"])
        assert str(o[f"pts_ckpt_{name}/placements"]) == PTS_PLACEMENTS[name]


@pytest.mark.parametrize("name", PTS)
def test_point_sharded_resumed_run_is_the_one_shot_run(group, name):
    """On every rank the resumed point-sharded run gives the one-shot
    sharded run's bits in every result field; its decisions are the JAX
    package's unsharded ones after two attempts and at the end, p within
    test_parallel.py's rtol 1e-9, atol 1e-11; every rank holds the same
    bits of c, q and the decisions."""
    outs, _, _ = group
    two, full = _jax_pts()[name]
    leg = f"pts_ckpt_{name}"
    o = outs[0]
    for other in outs:
        assert bool(other[f"{leg}/same_bits"])
    for f in ("step_count", "n_attempts", "reason", "done"):
        assert o[f"{leg}/two_{f}"].item() == getattr(two, f).item(), f
    for f in ("step_count", "n_attempts", "reason"):
        assert o[f"{leg}/{f}"].item() == getattr(full, f).item(), f
    for k in ("c", "q"):
        np.testing.assert_allclose(o[f"{leg}/{k}"], np.asarray(full.p[k]),
                                   rtol=1e-9, atol=1e-11)
    keys = [k for k in o if k.startswith(leg + "/")]
    for other in outs[1:]:
        for k in keys:
            assert other[k].tobytes() == o[k].tobytes(), k


@pytest.mark.parametrize("name", PTS)
def test_point_sharded_checkpoint_resumes_unsharded(group, name):
    """The checkpoint the four ranks wrote loads in this process, with no
    process group, onto an unsharded state (dcp reads each chunk into
    its rows) and resumes to the JAX package's decisions, p within rtol
    1e-9."""
    import torch.distributed as dist
    _, _, tmp = group
    assert not dist.is_initialized()
    fn, p0, ns = _port_pts(name)
    like = init_solver_state(fn, p0)
    back = checkpoint.load_state_orbax(str(tmp / f"pts_{name}"), like)
    assert all(type(v) is torch.Tensor for v in back.p.values())
    r = result_from_state(run_solver(fn, back, newton_solver=ns))
    _, full = _jax_pts()[name]
    for f in ("step_count", "n_attempts", "reason"):
        assert int(getattr(r, f)) == getattr(full, f).item(), f
    for k in ("c", "q"):
        np.testing.assert_allclose(r.p[k].numpy(), np.asarray(full.p[k]),
                                   rtol=1e-9, atol=1e-11)
