"""The port's blocked and panel Cholesky (ops/blockchol.py, ops/panelchol.py,
ops/largechol.py) and BlockedDenseNewtonSolver against the JAX package, in
float64 on numpy-seeded inputs.

Kernel K2's plain twin is held against the JAX kernel
`pallas_panelchol.panel_factor` run in interpret mode, and so is the
algorithm of K2's inverse kernel in its plain form
`panel_inverse_columns_reference` (inv(L) one slab of columns at a time,
float64 to 1e-12 and float32 to 2e-4 of the largest entry). The factorizations
sum in other orders than XLA's, so factors agree to rtol 1e-10 (atol scaled
by n); the failure flag `ok` and the escalated lambda must be identical.

The JAX strategy is costly to run on the CPU (its unrolled factorizations
take 17-30 s per un-jitted gauss_newton call), so the JAX references are
computed once per module and the strategy's no-escalation path is spelled
out from the JAX package's own pieces (blocked_cholesky + blocked_cho_solve
at n <= 256, large_cholesky + cholesky_solve above, which is what
BlockedDenseNewtonSolver runs when lambda = 0 factors); escalation and
refinement are held against the JAX DenseNewtonSolver, which takes the same
lambda decisions (tests/test_blockchol.py:41-73, test_largechol.py:69-91).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libdogleg_tpu.ops import blockchol as jblock
from libdogleg_tpu.ops import cholesky as jchol
from libdogleg_tpu.ops import largechol as jlarge
from libdogleg_tpu.ops import newton as jnewton
from libdogleg_tpu.ops.pallas_panelchol import panel_factor as jpanel
from libdogleg_tpu_torch.ops import blockchol as tblock
from libdogleg_tpu_torch.ops import cholesky as tchol
from libdogleg_tpu_torch.ops import largechol as tlarge
from libdogleg_tpu_torch.ops import newton as tnewton
from libdogleg_tpu_torch.ops import panelchol

torch.set_num_threads(1)
KW = dict(lambda_initial=1e-10, lambda_max_tries=10)


def _spd(n, rng, batch=()):
    A = rng.normal(size=batch + (n, n))
    return A @ np.swapaxes(A, -1, -2) + n * np.eye(n)


def _system(n):
    rng = np.random.default_rng(n)
    return _spd(n, rng), rng.normal(size=n)


@functools.lru_cache(maxsize=None)
def _jax_factor_and_step(n):
    """The JAX package's factor of _system(n) (blocked_cholesky for n <= 256,
    large_cholesky above) and the Gauss-Newton step solved with it."""
    JtJ, b = (jnp.asarray(a) for a in _system(n))
    if n > 256:
        L, ok = jlarge.large_cholesky(JtJ)
        u = jchol.cholesky_solve(L, b)
    else:
        L, ok = jblock.blocked_cholesky(JtJ)
        u = jblock.blocked_cho_solve(L, b)
    assert bool(ok)
    return np.asarray(L), -np.asarray(u)


@pytest.mark.parametrize("p", [32, 64])
def test_panel_twin_matches_jax_kernel(p):
    """A batch of two: one SPD panel, and one whose pivot in the second
    sub-panel is negative (ok False in both)."""
    rng = np.random.default_rng(p)
    W = _spd(p, rng, batch=(2,))
    W[1, 20, 20] = -W[1, 20, 20]
    before = panelchol.launch_count
    L, Linv, ok = panelchol.panel_factor(torch.as_tensor(W))
    assert panelchol.launch_count == before   # a CPU tensor takes the twin
    jL, jLinv, jok = jpanel(jnp.asarray(W), interpret=True)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    assert ok.tolist() == [True, False]
    np.testing.assert_allclose(L[0].numpy(), np.asarray(jL[0]), rtol=1e-10,
                               atol=1e-10 * p)
    np.testing.assert_allclose(Linv[0].numpy(), np.asarray(jLinv[0]),
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(L[0].numpy() @ Linv[0].numpy(), np.eye(p),
                               atol=1e-12)
    assert np.all(np.triu(L[0].numpy(), 1) == 0)
    # before the failing pivot the factor is still the JAX kernel's
    np.testing.assert_allclose(L[1, :20].numpy(), np.asarray(jL[1, :20]),
                               rtol=1e-10, atol=1e-10 * p)


@functools.lru_cache(maxsize=None)
def _jax_panel(p, np_dtype):
    """Two SPD panels as a numpy array of `np_dtype` and the JAX kernel's
    (L, inv(L), ok) for them, in interpret mode."""
    W = _spd(p, np.random.default_rng(900 + p), batch=(2,)).astype(np_dtype)
    jL, jLinv, jok = jpanel(jnp.asarray(W), interpret=True)
    assert np.asarray(jL).dtype == np_dtype
    return W, np.asarray(jL), np.asarray(jLinv), np.asarray(jok)


@pytest.mark.parametrize("np_dtype,tol", [(np.float64, 1e-12),
                                          (np.float32, 2e-4)])
@pytest.mark.parametrize("cols", [16, 32])
@pytest.mark.parametrize("p", [16, 64])
def test_panel_inverse_by_columns_matches_twin_and_jax_kernel(p, cols,
                                                             np_dtype, tol):
    """inv(L) slab by slab against the twin's recursive inverse, against the
    JAX kernel's inv(L), and as an inverse; zeros above the diagonal. The
    factor the slabs start from is the twin's, itself held to the JAX
    kernel's."""
    W, jL, jLinv, jok = _jax_panel(p, np_dtype)
    L, Linv, ok = panelchol.panel_factor_reference(torch.as_tensor(W))
    assert ok.tolist() == jok.tolist() == [True, True]
    X = panelchol.panel_inverse_columns_reference(L, cols=cols)
    assert X.shape == L.shape and X.dtype == L.dtype
    assert bool((torch.triu(X, 1) == 0).all())

    def close(got, want):
        assert float(np.abs(got - want).max()) <= tol * float(
            np.abs(want).max())
    close(L.numpy(), jL)
    close(X.numpy(), Linv.numpy())
    close(X.numpy(), jLinv)
    close(X.numpy() @ L.numpy(), np.broadcast_to(np.eye(p), (2, p, p)))


def test_panel_inverse_by_columns_wants_whole_blocks():
    L = torch.eye(32, dtype=torch.float64)
    with pytest.raises(ValueError, match="cols"):
        panelchol.panel_inverse_columns_reference(L, cols=24)
    X = panelchol.panel_inverse_columns_reference(2.0 * L, cols=48)
    np.testing.assert_array_equal(X.numpy(), 0.5 * np.eye(32))


@pytest.mark.parametrize("p", [16, 32])
def test_panel_twin_flags_a_nan_entry_like_the_jax_kernel(p):
    """A NaN in the first panel of two: ok False for it and True for the
    other from the twin and from the JAX kernel, and the other's factor and
    inverse untouched."""
    W = _jax_panel(p, np.float64)[0].copy()
    W[0, p - 3, 2] = W[0, 2, p - 3] = np.nan
    L, Linv, ok = panelchol.panel_factor(torch.as_tensor(W))
    assert ok.dtype == torch.bool
    jL, jLinv, jok = jpanel(jnp.asarray(W), interpret=True)
    assert ok.tolist() == np.asarray(jok).tolist() == [False, True]
    np.testing.assert_allclose(L[1].numpy(), np.asarray(jL[1]), rtol=1e-10,
                               atol=1e-10 * p)
    np.testing.assert_allclose(Linv[1].numpy(), np.asarray(jLinv[1]),
                               rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("shape", [(24, 24), (2, 300, 300), (16, 16, 8)])
def test_panel_factor_rejects_bad_shapes(shape):
    with pytest.raises(ValueError):
        panelchol.panel_factor(torch.zeros(shape, dtype=torch.float64))


@pytest.mark.parametrize("n,panel", [(40, 32), (320, 64), (320, 256)])
def test_large_cholesky_matches_jax(n, panel):
    A, _ = _system(n)
    L, ok = tlarge.large_cholesky(torch.as_tensor(A), panel=panel)
    assert bool(ok)
    if n > 256:
        want = _jax_factor_and_step(n)[0]
    else:
        jL, jok = jlarge.large_cholesky(jnp.asarray(A), panel=panel)
        assert bool(jok)
        want = np.asarray(jL)
    np.testing.assert_allclose(L.numpy(), want, rtol=1e-10, atol=1e-10 * n)


@pytest.mark.parametrize("n,batch,panel", [(40, (), 32), (320, (2,), 256)])
def test_large_cholesky_matches_numpy(n, batch, panel):
    rng = np.random.default_rng(n)
    A = _spd(n, rng, batch)
    L, ok = tlarge.large_cholesky(torch.as_tensor(A), panel=panel)
    assert ok.shape == batch and bool(ok.all())
    np.testing.assert_allclose(L.numpy(), np.linalg.cholesky(A), rtol=1e-10,
                               atol=1e-10 * n)
    assert np.all(np.triu(L.numpy(), 1) == 0)


def test_large_cholesky_failure_flag_and_impl_checks():
    rng = np.random.default_rng(2)
    A = _spd(320, rng)
    A[300, 300] = -5.0 * A[300, 300]
    _, ok = tlarge.large_cholesky(torch.as_tensor(A), panel=64)
    assert not bool(ok)
    with pytest.raises(ValueError, match="CUDA"):
        tlarge.large_cholesky(torch.as_tensor(A), panel_impl="cuda")
    with pytest.raises(ValueError, match="panel_impl"):
        tlarge.large_cholesky(torch.as_tensor(A), panel_impl="pallas")
    with pytest.raises(ValueError, match="panel"):
        tlarge.large_cholesky(torch.as_tensor(A), panel=24)


def test_tri_inv_matches_jax():
    rng = np.random.default_rng(3)
    L = np.linalg.cholesky(_spd(96, rng))
    X = tlarge._tri_inv(torch.as_tensor(L)).numpy()
    np.testing.assert_allclose(X, np.asarray(jlarge._tri_inv(jnp.asarray(L))),
                               rtol=1e-10, atol=1e-13)
    np.testing.assert_allclose(X @ L, np.eye(96), atol=1e-12)


def test_blocked_cholesky_matches_jax():
    n, batch = 33, (5,)
    rng = np.random.default_rng(0)
    S = _spd(n, rng, batch)
    b = rng.normal(size=batch + (n,))
    L, ok = tblock.blocked_cholesky(torch.as_tensor(S))
    jL, jok = jblock.blocked_cholesky(jnp.asarray(S))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    np.testing.assert_allclose(L.numpy(), np.asarray(jL), rtol=1e-10,
                               atol=1e-10)
    # the port's substitutions are cholesky_solve; JAX unrolls them
    z = tchol.cholesky_solve(L, torch.as_tensor(b)).numpy()
    np.testing.assert_allclose(
        z, np.asarray(jblock.blocked_cho_solve(jL, jnp.asarray(b))),
        rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(z, np.linalg.solve(S, b[..., None])[..., 0],
                               rtol=1e-9, atol=1e-12)


def test_blocked_cholesky_flags_singular():
    S = torch.as_tensor(np.diag(np.r_[np.ones(10), 0.0, np.ones(9)]))
    _, ok = tblock.blocked_cholesky(S)
    assert not bool(ok)


@pytest.mark.parametrize("n", [40, 320])
def test_blocked_newton_solver_matches_jax(n):
    """The n <= 256 (blockchol) and n > 256 (largechol with K2's twin)
    paths; refine_iters 0 against the JAX strategy's step, refine_iters 1
    against the JAX DenseNewtonSolver(refine_iters=1)."""
    JtJ, b = _system(n)
    args = (torch.as_tensor(JtJ), torch.as_tensor(b),
            torch.tensor(0.0, dtype=torch.float64))
    r0 = tnewton.BlockedDenseNewtonSolver().gauss_newton(*args, **KW)
    assert bool(r0.ok) and float(r0.lam) == 0.0
    step_j = _jax_factor_and_step(n)[1]
    np.testing.assert_allclose(r0.step.numpy(), step_j, rtol=1e-9,
                               atol=1e-12)
    np.testing.assert_allclose(float(r0.norm2_step), step_j @ step_j,
                               rtol=1e-9)
    r1 = tnewton.BlockedDenseNewtonSolver(refine_iters=1).gauss_newton(
        *args, **KW)
    r1_j = jnewton.DenseNewtonSolver(refine_iters=1).gauss_newton(
        jnp.asarray(JtJ), jnp.asarray(b), jnp.asarray(0.0), **KW)
    np.testing.assert_allclose(r1.step.numpy(), np.asarray(r1_j.step),
                               rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("n", [40, 320])
def test_blocked_newton_solver_escalates_like_jax(n):
    """Hazard F3: a singular JtJ (a zero row and column, inside the first
    256-wide panel at n = 320) fails the factorization, and the escalating
    lambda retries to the same final lambda as the JAX strategy."""
    rng = np.random.default_rng(5)
    JtJ, b = _spd(n, rng), rng.normal(size=n)
    JtJ[7, :] = 0.0
    JtJ[:, 7] = 0.0
    b[7] = 0.0
    r_t = tnewton.BlockedDenseNewtonSolver().gauss_newton(
        torch.as_tensor(JtJ), torch.as_tensor(b),
        torch.tensor(0.0, dtype=torch.float64), **KW)
    r_j = jnewton.DenseNewtonSolver().gauss_newton(
        jnp.asarray(JtJ), jnp.asarray(b), jnp.asarray(0.0), **KW)
    assert bool(r_t.ok) and bool(r_j.ok)
    assert float(r_t.lam) == float(r_j.lam) > 0.0
    np.testing.assert_allclose(r_t.step.numpy(), np.asarray(r_j.step),
                               rtol=1e-8, atol=1e-12)


def test_blocked_newton_solver_masked_batch():
    """The active mask of the masked batched solver: an inactive singular
    element keeps its lambda, the active ones escalate on their own."""
    rng = np.random.default_rng(6)
    JtJ = np.stack([_spd(24, rng) for _ in range(3)])
    JtJ[1, 3, :] = JtJ[1, :, 3] = 0.0
    JtJ[2, 5, :] = JtJ[2, :, 5] = 0.0
    b = rng.normal(size=(3, 24))
    ns = tnewton.BlockedDenseNewtonSolver()
    rb = ns.gauss_newton(torch.as_tensor(JtJ), torch.as_tensor(b),
                         torch.zeros(3, dtype=torch.float64),
                         active=torch.tensor([True, True, False]), **KW)
    assert rb.ok.tolist() == [True, True, False]
    assert float(rb.lam[0]) == 0.0 and float(rb.lam[2]) == 0.0
    for i in (0, 1):
        r1 = ns.gauss_newton(torch.as_tensor(JtJ[i]), torch.as_tensor(b[i]),
                             torch.tensor(0.0, dtype=torch.float64), **KW)
        assert float(rb.lam[i]) == float(r1.lam)
        np.testing.assert_allclose(rb.step[i].numpy(), r1.step.numpy(),
                                   rtol=1e-12, atol=1e-15)
