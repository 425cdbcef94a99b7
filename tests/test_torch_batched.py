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
from libdogleg_tpu_torch import DenseNewtonSolver, DoglegParameters, sample
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
    (dict(use_megakernel=True, products=lambda p, m: tsp.products(p, m)),
     ValueError),
    (dict(use_megakernel=True, newton_solver=DenseNewtonSolver()),
     ValueError),
    (dict(mesh=object()), NotImplementedError),
    (dict(record_history=True), NotImplementedError),
    (dict(layout="diagonal"), ValueError),
])
def test_gate_raises(kw, exc):
    meas, p0 = (torch.as_tensor(a) for a in _instances(3, 4))
    products = kw.pop("products", tsp.products)
    with pytest.raises(exc):
        batched_optimize(products, p0, problem_data=meas, **kw)


def test_compacted_not_ported():
    with pytest.raises(NotImplementedError):
        batched_optimize_compacted(tsp.products, torch.zeros(4, 6))


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
    assert sample.main(["--check", mode]) == 0
    assert "NOT recovered" not in capsys.readouterr().out


def test_sample_module_entry_f32():
    proc = subprocess.run(
        [sys.executable, "-m", "libdogleg_tpu_torch.sample", "--check",
         "--f32", "dense"], cwd=REPO, capture_output=True, text=True,
        timeout=300, env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stdout + proc.stderr


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
