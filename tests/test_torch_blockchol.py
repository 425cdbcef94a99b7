"""The batched blocked Cholesky (libdogleg_tpu_torch/ops/batchchol.py, kernel
K5's wrapper and plain version) against the JAX package's Pallas kernel and
its blocked Cholesky, and the mid-size batched solve behind it against the
JAX package's batched_optimize.

On the CPU the wrapper runs the plain version, which is also what the card
holds the kernel against; the kernel itself is tested on the card
(tests/test_torch_cuda.py). The JAX-side calls are few: the un-jitted
blocked strategy takes tens of seconds to trace on the CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libdogleg_tpu as dl
from libdogleg_tpu.ops import blockchol as jblock
from libdogleg_tpu.ops.pallas_blockchol import pallas_blocked_cholesky
from libdogleg_tpu.parallel.batched import batched_optimize as jax_batched
from libdogleg_tpu_torch import (BlockedDenseNewtonSolver, DoglegParameters,
                                 Products)
from libdogleg_tpu_torch.ops import batchchol, blockchol
from libdogleg_tpu_torch.ops import cholesky as chol
from libdogleg_tpu_torch.parallel import batched_optimize
from libdogleg_tpu_torch.parallel import batched as tbatched

torch.set_num_threads(1)


def _spd(seed, batch, n, dtype=np.float64):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=tuple(batch) + (n, n))
    S = np.einsum('...ij,...kj->...ik', A, A) + n * np.eye(n)
    return S.astype(dtype)


def test_plain_version_matches_pallas_kernel_f32():
    """The TPU kernel in interpret mode and K5's plain version on the same
    float32 batch; the tolerance is the one tests/test_blockchol.py holds
    the Pallas kernel to (float32 factors of matrices with entries ~n)."""
    S = _spd(5, (8,), 32, np.float32)
    jL, jok = pallas_blocked_cholesky(jnp.asarray(S), batch_tile=4,
                                      interpret=True)
    L, ok = batchchol.batched_blocked_cholesky(torch.as_tensor(S))
    assert L.dtype == torch.float32 and bool(ok.all()) and bool(jok.all())
    np.testing.assert_allclose(L.numpy(), np.asarray(jL), rtol=2e-4,
                               atol=2e-4)
    assert float(torch.triu(L, 1).abs().max()) == 0.0


def test_plain_version_matches_jax_blocked_cholesky_f64():
    S = _spd(6, (3,), 48)
    jL, jok = jblock.blocked_cholesky(jnp.asarray(S))
    L, ok = batchchol.batched_blocked_cholesky(torch.as_tensor(S))
    assert bool(ok.all()) and bool(jok.all())
    np.testing.assert_allclose(L.numpy(), np.asarray(jL), rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize("batch,n", [((4,), 40), ((), 33), ((2, 3), 24),
                                     ((5,), 16), ((2,), 7)])
def test_padding_and_batch_axes(batch, n):
    """n that needs the identity padding, a single matrix, two leading
    batch axes, and n <= 16 (the unrolled small Cholesky), against numpy."""
    S = _spd(7, batch, n)
    L, ok = blockchol.blocked_cholesky(torch.as_tensor(S))
    assert L.shape == S.shape and ok.shape == tuple(batch)
    assert bool(ok.all())
    np.testing.assert_allclose(L.numpy(), np.linalg.cholesky(S), rtol=1e-11,
                               atol=1e-11)
    rhs = np.random.default_rng(8).normal(size=tuple(batch) + (n,))
    z = chol.cholesky_solve(L, torch.as_tensor(rhs))
    np.testing.assert_allclose(
        z.numpy(), np.linalg.solve(S, rhs[..., None])[..., 0], rtol=1e-9,
        atol=1e-9)


def test_pad_to_block_is_identity_padded():
    S = torch.as_tensor(_spd(9, (2,), 20))
    W = batchchol.pad_to_block(S)
    assert W.shape == (2, 32, 32)
    assert torch.equal(W[:, :20, :20], S)
    assert torch.equal(W[:, 20:, 20:], torch.eye(12, dtype=S.dtype)
                       .expand(2, 12, 12))
    assert float(W[:, :20, 20:].abs().max()) == 0.0
    assert batchchol.pad_to_block(W) is W


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_ok_is_false_for_exactly_the_matrix_that_is_not_spd(dtype):
    S = _spd(10, (6,), 48, dtype)
    S[2, 30, 30] = -1.0          # a negative pivot late in the second panel
    S[4] = 0.0                   # a zero pivot in the first panel
    L, ok = batchchol.batched_blocked_cholesky(torch.as_tensor(S))
    assert ok.tolist() == [True, True, False, True, False, True]
    good = [0, 1, 3, 5]
    tol = 1e-11 if dtype == np.float64 else 2e-4
    np.testing.assert_allclose(
        L.numpy()[good], np.linalg.cholesky(S[good].astype(np.float64)),
        rtol=tol, atol=tol)
    # the same flags as the JAX package's blocked Cholesky
    _, jok = jblock.blocked_cholesky(jnp.asarray(S))
    assert np.asarray(jok).tolist() == ok.tolist()


@pytest.mark.parametrize("bad,exc", [
    (torch.zeros(32, 32), ValueError),                        # no batch axis
    (torch.zeros(2, 3, 32, 32), ValueError),                  # two batch axes
    (torch.zeros(2, 32, 48), ValueError),                     # not square
    (torch.zeros(2, 272, 272), ValueError),                   # n > 256
    (torch.zeros(2, 0, 0), ValueError),                       # n = 0
    (torch.zeros(2, 32, 32, dtype=torch.float16), ValueError),
    (torch.zeros(2, 32, 32, dtype=torch.int64), ValueError),
    (torch.zeros(2, 32, 32, device="meta"), ValueError),      # no kernel
])
def test_wrapper_refuses(bad, exc):
    with pytest.raises(exc):
        batchchol.batched_blocked_cholesky(bad)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_wrapper_ok_is_bool_on_the_cpu(dtype):
    """The wrapper's ok is a torch.bool tensor, one flag a matrix, as the
    kernel writes it on the card."""
    S = torch.as_tensor(_spd(10, (3,), 40), dtype=dtype)
    S[1, 20, 20] = -S[1, 20, 20]
    L, ok = batchchol.batched_blocked_cholesky(S)
    assert ok.dtype == torch.bool and ok.shape == (3,)
    assert ok.tolist() == [True, False, True]
    assert L.shape == S.shape and L.dtype == dtype


def test_cpu_tensors_launch_nothing():
    before = batchchol.launch_count
    batchchol.batched_blocked_cholesky(torch.as_tensor(_spd(11, (2,), 32)))
    blockchol.blocked_cholesky(torch.as_tensor(_spd(11, (2,), 32)))
    assert batchchol.launch_count == before


def test_strategy_matches_dense_strategy():
    """BlockedDenseNewtonSolver and DenseNewtonSolver give one Gauss-Newton
    step on a batch, with the masked escalating lambda: the singular
    element escalates in both, the inactive one keeps its lambda."""
    from libdogleg_tpu_torch import DenseNewtonSolver
    S = torch.as_tensor(_spd(12, (4,), 40))
    S[1] = 0.0
    S[3] = 0.0
    g = torch.as_tensor(np.random.default_rng(13).normal(size=(4, 40)))
    lam = torch.zeros(4, dtype=S.dtype)
    active = torch.tensor([True, True, True, False])
    kw = dict(lambda_initial=1e-10, lambda_max_tries=60, active=active)
    rb = BlockedDenseNewtonSolver().gauss_newton(S, g, lam, **kw)
    rd = DenseNewtonSolver().gauss_newton(S, g, lam, **kw)
    assert rb.ok.tolist() == rd.ok.tolist() == [True, True, True, False]
    assert torch.equal(rb.lam, rd.lam)
    assert rb.lam.tolist() == [0.0, 1e-10, 0.0, 0.0]
    ok = [0, 1, 2]
    np.testing.assert_allclose(rb.step[ok].numpy(), rd.step[ok].numpy(),
                               rtol=1e-9, atol=1e-12)


# ---------------------------------------------------------------------------
# the slice: the mid-size batched benchmark's family through batched_optimize
# ---------------------------------------------------------------------------

PRM = dict(max_iterations=10, Jt_x_threshold=1e-3, update_threshold=1e-5,
           trustregion_threshold=1e-5)


def _midsize_family(nstate, batch, seed=8, meas_factor=4):
    """r = A tanh(B p) + C p - d with one (A, B, C, d) per element, drawn in
    the order and with the scales of the JAX benchmark's mid-size batched
    configuration (bench_all.py config8_batched_midsize), in float64."""
    nmeas = meas_factor * nstate
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(batch, nmeas, nstate))
    Bm = rng.normal(size=(batch, nstate, nstate)) * 0.5 / np.sqrt(nstate)
    C = rng.normal(size=(batch, nmeas, nstate)) * 0.3
    p_true = rng.normal(size=(batch, nstate))
    d = (np.einsum('bms,bs->bm', A,
                   np.tanh(np.einsum('bst,bt->bs', Bm, p_true)))
         + np.einsum('bms,bs->bm', C, p_true)
         + rng.normal(size=(batch, nmeas)) * 0.01)
    p0 = p_true + rng.normal(size=(batch, nstate)) * 0.1
    return (A, Bm, C, d), p0, p_true


def _make_products(xp, prod_cls):
    def products(p, data):
        Ab, Bb, Cb, db = data
        t = xp.tanh(Bb @ p)
        x = Ab @ t + Cb @ p - db
        J = Ab @ ((1.0 - t * t)[:, None] * Bb) + Cb
        return prod_cls(norm2_x=x @ x, Jt_x=J.T @ x, JtJ=J.T @ J)
    return products


def test_midsize_batched_solve_matches_jax_f64():
    """Nstate 24, batch 128, float64: the gate picks the blocked strategy
    in both packages; identical decisions, p within 1e-9, every parameter
    recovered within 0.05 of the truth."""
    data, p0, p_true = _midsize_family(24, 128)
    tproducts = _make_products(torch, Products)
    tdata = tuple(torch.as_tensor(a) for a in data)
    assert isinstance(
        tbatched._auto_newton(tproducts, torch.as_tensor(p0), tdata),
        BlockedDenseNewtonSolver)
    r_j = jax_batched(_make_products(jnp, dl.solver.Products),
                      jnp.asarray(p0), dl.DoglegParameters(**PRM),
                      problem_data=tuple(jnp.asarray(a) for a in data),
                      use_megakernel=False)
    r_t = batched_optimize(tproducts, torch.as_tensor(p0),
                           DoglegParameters(**PRM), problem_data=tdata)
    for field in ("step_count", "n_attempts", "reason"):
        np.testing.assert_array_equal(getattr(r_t, field).numpy(),
                                      np.asarray(getattr(r_j, field)))
    assert bool((r_t.reason > 0).all())
    np.testing.assert_allclose(r_t.p.numpy(), np.asarray(r_j.p), rtol=1e-9,
                               atol=1e-9)
    assert np.all(np.abs(r_t.p.numpy() - p_true) < 0.05)
