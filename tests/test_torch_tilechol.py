"""The algorithms of kernels K6 and K7 (csrc/tilechol.cu), in their plain
PyTorch forms `tile_cholesky_blocked_reference` and
`tri_solve_right_blocked_reference`, against the wrappers' plain twins
(`tile_cholesky_reference`, `tri_solve_right_reference`) and against the JAX
package's Pallas kernels `pallas_cholesky` and `pallas_tri_solve_right` in
interpret mode, on numpy-seeded inputs.

The kernels themselves run on the card only (tests/test_torch_cuda.py); here
their arithmetic is held through its plain form. K6: the tile padded to a
multiple of the panel width with an identity diagonal, right-looking over
16-wide panels, the unclamped pivot rule L_jj = d * rsqrt(d). K7:
left-looking over 16- or 32-wide column blocks, the solve inside a block
column by column, a true division by the diagonal. The forms sum each entry's
terms in different orders, so they agree to rounding: float64 to 1e-12 of
the largest entry, float32 to 2e-4 of it (the tolerance the card tests hold
the kernels to).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libdogleg_tpu.ops import pallas_chol
from libdogleg_tpu_torch.ops import tilechol

torch.set_num_threads(1)

TOL = {np.float64: 1e-12, np.float32: 2e-4}


def _m_of(kind: str, n: int) -> int:
    return {"1": 1, "3": 3, "n": n, "n+5": n + 5}[kind]


@functools.lru_cache(maxsize=None)
def _case(n, m, np_dtype, k=3):
    """(D, C) as numpy arrays of `np_dtype`, and the JAX kernel's X (the
    Pallas kernel in interpret mode, as the JAX package's own tests run it
    on the CPU). D is the Cholesky factor of a well-conditioned SPD tile."""
    rng = np.random.default_rng(1000 * n + m)
    A = rng.normal(size=(k, n, n))
    D = np.linalg.cholesky(A @ np.swapaxes(A, -1, -2) / n + np.eye(n))
    C = rng.normal(size=(k, m, n))
    D, C = D.astype(np_dtype), C.astype(np_dtype)
    Xj = np.asarray(pallas_chol.pallas_tri_solve_right(
        jnp.asarray(D), jnp.asarray(C), interpret=True))
    assert Xj.dtype == np_dtype
    return D, C, Xj


def _close(got, want, tol):
    scale = max(float(np.abs(want).max()), 1e-300)
    assert float(np.abs(got - want).max()) <= tol * scale


@pytest.mark.parametrize("np_dtype", [np.float64, np.float32])
@pytest.mark.parametrize("block", [16, 32])
@pytest.mark.parametrize("m_kind", ["1", "3", "n", "n+5"])
@pytest.mark.parametrize("n", [1, 8, 24, 40, 128])
def test_blocked_version_matches_twin_and_jax_kernel(n, m_kind, block,
                                                     np_dtype):
    """n below, equal to and not a multiple of the block; m below and above
    n. The blocked form against solve_triangular, against the JAX Pallas
    kernel, and as a solution of X D^T = C."""
    D, C, Xj = _case(n, _m_of(m_kind, n), np_dtype)
    Dt, Ct = torch.as_tensor(D), torch.as_tensor(C)
    X = tilechol.tri_solve_right_blocked_reference(Dt, Ct, block=block)
    assert X.shape == Ct.shape and X.dtype == Ct.dtype
    tol = TOL[np_dtype]
    _close(X.numpy(), tilechol.tri_solve_right_reference(Dt, Ct).numpy(), tol)
    _close(X.numpy(), Xj, tol)
    _close(X.numpy() @ np.swapaxes(D, -1, -2), C, 10 * tol)


@pytest.mark.parametrize("block", [16, 32])
def test_blocked_version_takes_an_empty_batch(block):
    D = torch.zeros((0, 24, 24), dtype=torch.float64)
    C = torch.zeros((0, 5, 24), dtype=torch.float64)
    X = tilechol.tri_solve_right_blocked_reference(D, C, block=block)
    assert X.shape == (0, 5, 24)
    assert tilechol.tri_solve_right(D, C).shape == (0, 5, 24)


@pytest.mark.parametrize("np_dtype", [np.float64, np.float32])
@pytest.mark.parametrize("n", [8, 40])
def test_nan_in_c_stays_in_its_row(n, np_dtype):
    """The rows of X are independent: a NaN in one row of C makes that row
    of X NaN from its column on, and touches no other row or tile."""
    D, C, _ = _case(n, n + 5, np_dtype)
    Dt, Ct = torch.as_tensor(D), torch.as_tensor(C).clone()
    want = tilechol.tri_solve_right_blocked_reference(Dt, Ct)
    Ct[1, 2, 3] = float("nan")
    for X in (tilechol.tri_solve_right_blocked_reference(Dt, Ct),
              tilechol.tri_solve_right(Dt, Ct)):
        bad = torch.isnan(X)
        assert bool(bad[1, 2, 3:].all()) and not bool(bad[1, 2, :3].any())
        bad[1, 2] = False
        assert not bool(bad.any())
        keep = torch.ones_like(bad)
        keep[1, 2] = False
        _close(X[keep].numpy(), want[keep].numpy(), TOL[np_dtype])


def test_blocked_version_does_not_use_the_strict_upper_part():
    D, C, _ = _case(24, 3, np.float64)
    Dt, Ct = torch.as_tensor(D), torch.as_tensor(C)
    junk = Dt + torch.triu(torch.full_like(Dt, float("nan")), 1)
    got = tilechol.tri_solve_right_blocked_reference(junk, Ct)
    want = tilechol.tri_solve_right_blocked_reference(Dt, Ct)
    assert torch.equal(got, want)


def test_wrapper_on_cpu_tensors_takes_the_twin_and_counts_nothing():
    D, C, Xj = _case(40, 40, np.float64)
    before = dict(tilechol.launch_counts)
    X = tilechol.tri_solve_right(torch.as_tensor(D), torch.as_tensor(C))
    assert tilechol.launch_counts == before
    _close(X.numpy(), Xj, 1e-12)


@pytest.mark.parametrize("D_shape,C_shape", [
    ((2, 8, 8), (3, 8, 8)),        # batch sizes differ
    ((2, 8, 8), (2, 8, 7)),        # widths differ
    ((2, 8, 7), (2, 8, 7)),        # D not square
    ((2, 8, 8), (2, 0, 8)),        # no row
    ((1, 257, 257), (1, 2, 257)),  # beyond the largest tile
    ((8, 8), (8, 8)),              # no batch dimension
])
def test_wrapper_refuses_what_the_kernel_does_not_take(D_shape, C_shape):
    with pytest.raises(ValueError):
        tilechol.tri_solve_right(torch.zeros(D_shape), torch.zeros(C_shape))


def test_wrapper_refuses_mixed_types():
    with pytest.raises(ValueError):
        tilechol.tri_solve_right(torch.zeros((1, 4, 4), dtype=torch.float64),
                                 torch.zeros((1, 4, 4), dtype=torch.float32))
    with pytest.raises(ValueError):
        tilechol.tri_solve_right(torch.zeros((1, 4, 4), dtype=torch.float16),
                                 torch.zeros((1, 4, 4), dtype=torch.float16))


@functools.lru_cache(maxsize=None)
def _chol_case(n, np_dtype, bad=None, k=3):
    """(k, n, n) SPD tiles as a numpy array of `np_dtype`, tile `bad` (if
    any) with one diagonal entry negated so that it is not SPD, and the JAX
    kernel's (L, ok): the Pallas kernel in interpret mode."""
    rng = np.random.default_rng(77 * n)
    A = rng.normal(size=(k, n, n))
    S = A @ np.swapaxes(A, -1, -2) / n + np.eye(n)
    if bad is not None:
        S[bad, n // 2, n // 2] = -S[bad, n // 2, n // 2]
    S = S.astype(np_dtype)
    Lj, okj = pallas_chol.pallas_cholesky(jnp.asarray(S), interpret=True)
    Lj = np.asarray(Lj)
    assert Lj.dtype == np_dtype
    return S, Lj, np.asarray(okj)


@pytest.mark.parametrize("np_dtype", [np.float64, np.float32])
@pytest.mark.parametrize("block", [8, 16])
@pytest.mark.parametrize("n", [8, 24, 40, 128])
def test_blocked_cholesky_matches_twin_and_jax_kernel(n, block, np_dtype):
    """n below, equal to, a multiple of and no multiple of the panel width
    (the last padded with an identity diagonal). The blocked form against
    the wrapper's twin, against the JAX Pallas kernel, and as a factor of
    the tile; ok identical; zeros above the diagonal."""
    S, Lj, okj = _chol_case(n, np_dtype)
    St = torch.as_tensor(S)
    L, ok = tilechol.tile_cholesky_blocked_reference(St, block=block)
    assert L.shape == St.shape and L.dtype == St.dtype
    assert ok.dtype == torch.bool
    Lr, okr = tilechol.tile_cholesky_reference(St)
    assert ok.tolist() == okr.tolist() == okj.tolist() == [True] * 3
    assert bool((torch.triu(L, 1) == 0).all())
    tol = TOL[np_dtype]
    _close(L.numpy(), Lr.numpy(), tol)
    _close(L.numpy(), Lj, tol)
    _close(L.numpy() @ np.swapaxes(L.numpy(), -1, -2), S, 10 * tol)


@pytest.mark.parametrize("np_dtype", [np.float64, np.float32])
@pytest.mark.parametrize("n", [24, 40])
def test_blocked_cholesky_flags_only_the_tile_that_is_not_spd(n, np_dtype):
    """A negative pivot in the second panel of tile 1: ok False for that
    tile from the blocked form, the twin and the JAX kernel, its factor not
    finite or not positive on the diagonal, and the other tiles as before."""
    S, Lj, okj = _chol_case(n, np_dtype, bad=1)
    St = torch.as_tensor(S)
    L, ok = tilechol.tile_cholesky_blocked_reference(St)
    _, okr = tilechol.tile_cholesky_reference(St)
    assert ok.tolist() == okr.tolist() == okj.tolist() == [True, False, True]
    d = torch.diagonal(L[1])
    assert not bool(torch.isfinite(L[1]).all()) or not bool((d > 0).all())
    keep = [0, 2]
    _close(L[keep].numpy(), Lj[keep], TOL[np_dtype])
    assert bool((torch.triu(L[keep], 1) == 0).all())


def test_cholesky_wrapper_on_cpu_tensors_takes_the_twin():
    S, Lj, _ = _chol_case(40, np.float64)
    before = dict(tilechol.launch_counts)
    L, ok = tilechol.tile_cholesky(torch.as_tensor(S))
    assert tilechol.launch_counts == before
    assert ok.dtype == torch.bool and ok.tolist() == [True] * 3
    _close(L.numpy(), Lj, 1e-12)
    empty = torch.zeros((0, 24, 24), dtype=torch.float64)
    for fn in (tilechol.tile_cholesky,
               tilechol.tile_cholesky_blocked_reference):
        L, ok = fn(empty)
        assert L.shape == (0, 24, 24) and ok.shape == (0,)


@pytest.mark.parametrize("shape", [(2, 8, 7), (8, 8), (1, 257, 257),
                                   (2, 0, 0)])
def test_cholesky_wrapper_refuses_what_the_kernel_does_not_take(shape):
    with pytest.raises(ValueError):
        tilechol.tile_cholesky(torch.zeros(shape))
    with pytest.raises(ValueError):
        tilechol.tile_cholesky(torch.zeros((1, 4, 4), dtype=torch.float16))
