"""The port's public batched entry point against the JAX package's, the
kernel gate, the package's independence from jax, and the sample CLI."""

import os
import pathlib
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libdogleg_tpu as dl
import libdogleg_tpu.models.quadratic_surface as jsp
from libdogleg_tpu.parallel.batched import batched_optimize as jax_batched
from libdogleg_tpu_torch import (DenseNewtonSolver, DoglegParameters, interop,
                                 sample)
from libdogleg_tpu_torch.device import resolve_device
from libdogleg_tpu_torch.models import grid_mrf as tgrid
from libdogleg_tpu_torch.models import quadratic_surface as tsp
from libdogleg_tpu_torch.ops import mega
from libdogleg_tpu_torch.parallel import (batched_optimize,
                                          batched_optimize_compacted)

torch.set_num_threads(1)
REPO = pathlib.Path(__file__).resolve().parent.parent


def _instances(seed, batch):
    rng = np.random.default_rng(seed)
    c = jsp.GRID_MIN + jsp.GRID_DELTA * np.arange(jsp.GRID_WIDTH)
    gx, gy = (a.ravel() for a in np.meshgrid(c, c, indexing="ij"))
    p = jsp.P_TRUE
    truth = (p[0] * p[1] * gx * gx + p[1] * p[2] * gy * gy + p[2] * gx * gy
             + p[3] * gx + p[4] * gy + p[5])
    meas = truth + rng.uniform(size=(batch, truth.size)) - 0.5
    return meas, rng.uniform(size=(batch, jsp.NSTATE)) - 0.1


def _jax_products(p, m):
    gx, gy = jsp.make_grid(m.dtype)
    x = jsp.model(p, gx, gy) - m
    J = jsp.jacobian(p, gx, gy)
    return dl.solver.Products(norm2_x=x @ x, Jt_x=J.T @ x, JtJ=J.T @ J)


def test_batched_optimize_matches_jax_f64():
    meas, p0 = _instances(0, 64)
    r_j = jax_batched(_jax_products, jnp.asarray(p0), dl.DoglegParameters(),
                      problem_data=jnp.asarray(meas), use_megakernel=False)
    before = mega.launch_count
    r_t = batched_optimize(tsp.products, torch.as_tensor(p0),
                           DoglegParameters(),
                           problem_data=torch.as_tensor(meas))
    assert mega.launch_count == before
    for field in ("step_count", "n_attempts", "reason"):
        np.testing.assert_array_equal(getattr(r_t, field).numpy(),
                                      np.asarray(getattr(r_j, field)))
    np.testing.assert_allclose(r_t.p.numpy(), np.asarray(r_j.p), rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(r_t.JtJ.numpy(), np.asarray(r_j.JtJ),
                               rtol=1e-10)


def test_forced_kernel_on_cpu_runs_the_twin():
    """use_megakernel=True with CPU tensors goes through the kernel's
    wrapper, which takes the plain twin on the CPU: same decisions as the
    masked path, and no launch."""
    meas, p0 = (torch.as_tensor(a) for a in _instances(1, 16))
    prm = DoglegParameters(max_iterations=10)
    before = mega.launch_count
    r_k = batched_optimize(tsp.products, p0, prm, problem_data=meas,
                           use_megakernel=True, layout="minor",
                           wavefront_unroll=4)
    r_m = batched_optimize(tsp.products, p0, prm, problem_data=meas,
                           use_megakernel=False)
    assert mega.launch_count == before
    for field in ("step_count", "n_attempts", "reason"):
        assert torch.equal(getattr(r_k, field), getattr(r_m, field))
    for field in ("p", "norm2_x", "JtJ", "trustregion"):
        np.testing.assert_allclose(getattr(r_k, field).numpy(),
                                   getattr(r_m, field).numpy(), rtol=1e-10,
                                   atol=1e-12)
    # the gradient at the solution is roundoff-sized, ~1e-10
    np.testing.assert_allclose(r_k.Jt_x.numpy(), r_m.Jt_x.numpy(), atol=1e-8)


def test_shared_data_products_without_problem_data():
    """products_fn(p) with data closed over: vmap batches the starts."""
    meas, p0 = (torch.as_tensor(a) for a in _instances(2, 4))
    r = batched_optimize(lambda p: tsp.products(p, meas[0]), p0)
    assert r.p.shape == (4, tsp.NSTATE)
    assert np.all(np.abs(r.p.numpy() - tsp.P_TRUE) < 0.2)


@pytest.mark.parametrize("kw,exc", [
    # a function outside K1's regime (cumsum has no generated code): a
    # forced call raises; an ordinary one is promoted (test_torch_mega_auto)
    (dict(use_megakernel=True,
          products=lambda p, m: tsp.products(p.cumsum(0), m)), ValueError),
    (dict(use_megakernel=True, newton_solver=DenseNewtonSolver()),
     ValueError),
    (dict(mesh=object()), TypeError),
    (dict(record_history=True, use_megakernel=True), ValueError),
    (dict(layout="diagonal"), ValueError),
])
def test_gate_raises(kw, exc):
    meas, p0 = (torch.as_tensor(a) for a in _instances(3, 4))
    products = kw.pop("products", tsp.products)
    with pytest.raises(exc):
        batched_optimize(products, p0, problem_data=meas, **kw)


_DECISIONS = ("step_count", "n_attempts", "reason")
_VALUES = ("p", "norm2_x", "Jt_x", "JtJ", "trustregion", "lam")


def _assert_same_result(r, ref, tol):
    for field in _DECISIONS:
        assert torch.equal(getattr(r, field), getattr(ref, field)), field
    for field in _VALUES:
        np.testing.assert_allclose(getattr(r, field).numpy(),
                                   getattr(ref, field).numpy(), rtol=tol,
                                   atol=tol, err_msg=field)


@pytest.fixture(scope="module")
def straggling_batch():
    """48 sample-problem instances whose attempt counts differ, so a
    compact pass has stragglers to take, with batched_optimize's result."""
    meas, p0 = (torch.as_tensor(a) for a in _instances(4, 48))
    prm = DoglegParameters()
    ref = batched_optimize(tsp.products, p0, prm, problem_data=meas)
    assert int(ref.n_attempts.max()) > int(ref.n_attempts.min()) + 2
    return meas, p0, prm, ref


@pytest.mark.parametrize("compact_capacity", [None, 1, 48])
@pytest.mark.parametrize("phase1_attempts", [None, 1, 3])
def test_compacted_matches_batched_optimize(straggling_batch,
                                            phase1_attempts,
                                            compact_capacity):
    """Every element takes batched_optimize's decisions whatever the phase
    lengths: the default capacity (48 // 16 = 3), a capacity the stragglers
    overflow (the safety net finishes them) and one that takes them all."""
    meas, p0, prm, ref = straggling_batch
    r = batched_optimize_compacted(
        tsp.products, p0, prm, problem_data=meas,
        phase1_attempts=phase1_attempts, compact_capacity=compact_capacity,
        layout="minor", wavefront_unroll=2)
    assert r.history is None
    _assert_same_result(r, ref, 1e-12)


def test_compacted_shared_data_and_all_done_in_phase_one():
    """products_fn(p) without problem_data; a phase 1 long enough that no
    element is left for the compact pass."""
    meas, p0 = (torch.as_tensor(a) for a in _instances(2, 6))
    products = lambda p: tsp.products(p, meas[0])  # noqa: E731
    ref = batched_optimize(products, p0)
    for phase1 in (None, 1000):
        r = batched_optimize_compacted(products, p0, phase1_attempts=phase1,
                                       compact_capacity=2)
        _assert_same_result(r, ref, 1e-12)


def test_compacted_matches_jax_f64():
    from libdogleg_tpu.parallel.batched import (
        batched_optimize_compacted as jax_compacted)
    meas, p0 = _instances(5, 32)
    r_j = jax_compacted(_jax_products, jnp.asarray(p0), dl.DoglegParameters(),
                        problem_data=jnp.asarray(meas), phase1_attempts=3,
                        compact_capacity=4, use_megakernel=False)
    r_t = batched_optimize_compacted(
        tsp.products, torch.as_tensor(p0), DoglegParameters(),
        problem_data=torch.as_tensor(meas), phase1_attempts=3,
        compact_capacity=4)
    for field in _DECISIONS:
        np.testing.assert_array_equal(getattr(r_t, field).numpy(),
                                      np.asarray(getattr(r_j, field)))
    np.testing.assert_allclose(r_t.p.numpy(), np.asarray(r_j.p), rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(r_t.trustregion.numpy(),
                               np.asarray(r_j.trustregion), rtol=1e-10)


def test_compacted_kernel_gate_on_cpu_runs_the_twin():
    """When the whole-solve kernel takes the batch, compaction is moot:
    use_megakernel=True goes to the kernel's wrapper, on the CPU its plain
    twin, and gives batched_optimize's result for the same arguments."""
    meas, p0 = (torch.as_tensor(a) for a in _instances(1, 16))
    prm = DoglegParameters(max_iterations=10)
    before = mega.launch_count
    r_c = batched_optimize_compacted(tsp.products, p0, prm,
                                     problem_data=meas, use_megakernel=True,
                                     compact_capacity=2)
    r_k = batched_optimize(tsp.products, p0, prm, problem_data=meas,
                           use_megakernel=True)
    assert mega.launch_count == before
    for field in _DECISIONS + _VALUES:
        assert torch.equal(getattr(r_c, field), getattr(r_k, field)), field
    with pytest.raises(ValueError):    # outside K1's regime: cumsum
        batched_optimize_compacted(lambda p, m: tsp.products(p.cumsum(0), m),
                                   p0, prm, problem_data=meas,
                                   use_megakernel=True)


@pytest.mark.parametrize("kw,exc", [
    (dict(mesh=object()), TypeError),
    (dict(record_history=True, use_megakernel=True), ValueError),
    (dict(layout="diagonal"), ValueError),
])
def test_compacted_raises(kw, exc):
    meas, p0 = (torch.as_tensor(a) for a in _instances(3, 4))
    with pytest.raises(exc):
        batched_optimize_compacted(tsp.products, p0, problem_data=meas, **kw)


def test_import_leaves_jax_out():
    """Importing every module of the port loads no jax, and no source file
    of the port names jax or the JAX package in an import."""
    code = ("import importlib, pkgutil, sys, libdogleg_tpu_torch as t; "
            "[importlib.import_module(m.name) for m in "
            "pkgutil.walk_packages(t.__path__, 'libdogleg_tpu_torch.')]; "
            "bad = sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'libdogleg_tpu')); "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|libdogleg_tpu)\b",
                         re.M)
    for path in (REPO / "libdogleg_tpu_torch").rglob("*.py"):
        assert not pattern.search(path.read_text()), path


@pytest.mark.parametrize("mode", sample.MODES)
def test_sample_check_passes_on_cpu(mode, capsys):
    assert sample.main(["--check", "--device", "cpu", mode]) == 0
    assert "NOT recovered" not in capsys.readouterr().out


def test_sample_module_entry_f32():
    proc = subprocess.run(
        [sys.executable, "-m", "libdogleg_tpu_torch.sample", "--check",
         "--f32", "--device", "cpu", "dense"], cwd=REPO, capture_output=True,
        text=True, timeout=300, env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _from_arrays_default_device():
    g = tgrid.make_grid_mrf(3, 2, 2, device="cpu")
    return tgrid.from_arrays(
        g.width, g.height, g.block_size, g.edges, g.z_prior.numpy(),
        g.z_edge.numpy(), g.w_prior, g.w_edge, g.p_true.numpy())


def _reference_grid_default_device():
    import libdogleg_tpu.models.grid_mrf as jgrid
    return interop.grid_mrf_from_reference(jgrid.make_grid_mrf(3, 2, 2))


_DEFAULT_DEVICE_CALLS = {
    "resolve_device": lambda: resolve_device(None),
    "make_grid": lambda: tsp.make_grid(),
    "simulate": lambda: tsp.simulate(torch.Generator().manual_seed(0)),
    "initial_state": lambda: tsp.initial_state(
        torch.Generator().manual_seed(0)),
    "make_grid_mrf": lambda: tgrid.make_grid_mrf(3, 2, 2),
    "from_arrays": _from_arrays_default_device,
    "from_numpy": lambda: interop.from_numpy(np.zeros(3)),
    "grid_mrf_from_reference": _reference_grid_default_device,
}


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="checks the default device where there is no card")
@pytest.mark.parametrize("name", sorted(_DEFAULT_DEVICE_CALLS))
def test_default_device_is_the_card_and_says_so_without_one(name):
    """A constructor given no device does not fall back to the CPU: it
    raises, and the message names the remedy."""
    with pytest.raises(RuntimeError, match='device="cpu"'):
        _DEFAULT_DEVICE_CALLS[name]()


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="checks the default device where there is no card")
def test_sample_defaults_to_the_card_and_says_so_without_one(capsys):
    assert sample.main(["--check", "dense"]) == 1
    captured = capsys.readouterr()
    assert "--device cpu" in captured.out + captured.err


def test_auto_newton_selection():
    """The masked path auto-selects BlockedDenseNewtonSolver exactly for a
    dense square JtJ with 17 <= Nstate <= AUTO_BLOCKED_MAX_N and a batch of
    at least AUTO_BLOCKED_MIN_BATCH (the JAX gate,
    tests/test_blockchol.py:75-106), and the bounds are the JAX package's."""
    from libdogleg_tpu.parallel import batched as jbatched
    from libdogleg_tpu_torch import BlockedDenseNewtonSolver, Products
    from libdogleg_tpu_torch.parallel import batched as tbatched

    assert tbatched.AUTO_BLOCKED_MIN_BATCH == jbatched.AUTO_BLOCKED_MIN_BATCH
    assert tbatched.AUTO_BLOCKED_MAX_N == jbatched.AUTO_BLOCKED_MAX_N

    def products(p, J):
        x = J @ p
        return Products(norm2_x=x @ x, Jt_x=J.T @ x, JtJ=J.T @ J)

    big = tbatched.AUTO_BLOCKED_MIN_BATCH
    for nstate, expect in [(8, False), (16, False), (17, True), (64, True),
                           (128, True), (129, False), (256, False)]:
        data = torch.zeros((big, nstate, nstate))
        ns = tbatched._auto_newton(products, torch.zeros((big, nstate)),
                                   data)
        assert isinstance(ns, BlockedDenseNewtonSolver) == expect, nstate
    data = torch.zeros((big - 1, 64, 64))
    assert tbatched._auto_newton(products, torch.zeros((big - 1, 64)),
                                 data) is None
    assert tbatched._auto_newton(lambda p: products(p, data[0]),
                                 torch.zeros((big, 64)), None) is not None


def _mid_size(seed, batch, nstate=20, nmeas=60):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(nmeas, nstate))
    B = rng.normal(size=(nstate, nstate)) * 0.5
    C = rng.normal(size=(nmeas, nstate)) * 0.3
    p_true = rng.normal(size=(batch, nstate))
    d = (np.tanh(p_true @ B.T) @ A.T + p_true @ C.T
         + rng.normal(size=(batch, nmeas)) * 0.05)
    return A, B, C, d, rng.normal(size=(batch, nstate))


def test_auto_blocked_batch_matches_jax_f64():
    """B = 128 problems with Nstate 20 take the auto-selected blocked
    strategy in both packages, with identical decisions."""
    from libdogleg_tpu_torch import Products
    A, B, C, d, p0 = _mid_size(7, 128)

    def make(xp, prod_cls, a, b, c):
        def products(p, di):
            t = xp.tanh(b @ p)
            J = a @ ((1.0 - t * t)[:, None] * b) + c
            x = a @ t + c @ p - di
            return prod_cls(norm2_x=x @ x, Jt_x=J.T @ x, JtJ=J.T @ J)
        return products

    jf = make(jnp, dl.solver.Products, *(jnp.asarray(m) for m in (A, B, C)))
    tf = make(torch, Products, *(torch.as_tensor(m) for m in (A, B, C)))
    r_j = jax_batched(jf, jnp.asarray(p0), dl.DoglegParameters(),
                      problem_data=jnp.asarray(d), use_megakernel=False)
    r_t = batched_optimize(tf, torch.as_tensor(p0), DoglegParameters(),
                           problem_data=torch.as_tensor(d))
    for field in ("step_count", "n_attempts", "reason"):
        np.testing.assert_array_equal(getattr(r_t, field).numpy(),
                                      np.asarray(getattr(r_j, field)))
    np.testing.assert_allclose(r_t.p.numpy(), np.asarray(r_j.p), rtol=1e-9,
                               atol=1e-9)
