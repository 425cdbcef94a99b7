"""The factored sample path of the port against the JAX package: the
sufficient-statistics form of the quadratic surface
(models/quadratic_surface.py: gram_pair, factored_statistics,
factored_products, factored_products_minor, make_factored_problem),
problems.FactoredBasisProblem, its batched solve and kernel K1's factored
twin (ops/mega.py::megakernel_optimize_factored_reference), on the same
numpy-made inputs.

In float64 decisions must be identical. The statistics and the products
reduce in another order than XLA does, so their numbers are held to
rtol 1e-14 (statistics, as hi + lo) and 1e-12 (products) in float64, and
in float32 to the tolerances of tests/test_pallas_mega.py:177-183. The CUDA
instance itself is held to this twin by tests/test_torch_cuda.py and
chip_smoke.py on a card. JAX-side results are computed once per module.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libdogleg_tpu as dl
import libdogleg_tpu.models.quadratic_surface as jsp
from libdogleg_tpu.ops.pallas_mega import megakernel_optimize as jax_mega
from libdogleg_tpu.parallel.batched import batched_optimize as jax_batched
from libdogleg_tpu.problems import FactoredBasisProblem as JFactored
import libdogleg_tpu_torch as tl
from libdogleg_tpu_torch.models import quadratic_surface as tsp
from libdogleg_tpu_torch.ops import mega
from libdogleg_tpu_torch.parallel import batched_optimize

torch.set_num_threads(1)
BENCH = dict(max_iterations=10, Jt_x_threshold=1e-3, update_threshold=1e-5,
             trustregion_threshold=1e-5)
DTYPES = [np.float64, np.float32]
# (rtol of norm2 and Jt_x, atol of Jt_x, rtol of JtJ) for the products
PRODUCTS_TOL = {np.float64: (1e-12, 1e-12, 1e-12),
                np.float32: (1e-6, 1e-8, 1e-5)}


@functools.lru_cache(maxsize=None)
def _instances(seed, batch, dtype):
    """(meas (B, 100), p0 (B, 6)) on the grid: truth + U(-0.5, 0.5) noise,
    starts uniform in [-0.1, 0.9]."""
    rng = np.random.default_rng(seed)
    c = jsp.GRID_MIN + jsp.GRID_DELTA * np.arange(jsp.GRID_WIDTH)
    gx, gy = (a.ravel() for a in np.meshgrid(c, c, indexing="ij"))
    p = jsp.P_TRUE
    truth = (p[0] * p[1] * gx * gx + p[1] * p[2] * gy * gy + p[2] * gx * gy
             + p[3] * gx + p[4] * gy + p[5])
    meas = truth + rng.uniform(size=(batch, truth.size)) - 0.5
    p0 = rng.uniform(size=(batch, jsp.NSTATE)) - 0.1
    return meas.astype(dtype), p0.astype(dtype)


def _np(t):
    return tuple(np.asarray(a) for a in t)


@functools.lru_cache(maxsize=None)
def _jax_stats(seed, batch, dtype):
    meas, _ = _instances(seed, batch, dtype)
    return _np(jax.jit(jax.vmap(jsp.factored_statistics))(
        jnp.asarray(meas)))


def _torch_stats(seed, batch, dtype):
    meas, _ = _instances(seed, batch, dtype)
    return tsp.factored_statistics(torch.as_tensor(meas))


def _gram(dtype):
    return tsp.gram_pair(torch.float32 if dtype == np.float32
                         else torch.float64, "cpu")


@pytest.mark.parametrize("dtype", DTYPES)
def test_gram_pair_identical(dtype):
    j = jsp.gram_pair(jnp.dtype(dtype))
    t = _gram(dtype)
    for a, b in zip(t, j):
        assert a.dtype == torch.float32 or dtype == np.float64
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("dtype", DTYPES)
def test_factored_statistics_match_jax(dtype):
    rtol = 1e-14 if dtype == np.float64 else 1e-6
    j = _jax_stats(0, 64, dtype)
    t = [a.numpy() for a in _torch_stats(0, 64, dtype)]
    assert [a.shape for a in t] == [a.shape for a in j]
    for hi, lo, jhi, jlo in ((t[0], t[1], j[0], j[1]),
                             (t[2], t[3], j[2], j[3])):
        np.testing.assert_allclose(hi.astype(np.float64) + lo,
                                   jhi.astype(np.float64) + jlo, rtol=rtol)
    if dtype == np.float32:
        # the pair is exact to O(eps^2): h_hi + h_lo is B^T meas in float64
        meas, _ = _instances(0, 64, dtype)
        B = np.asarray(jsp.basis(*jsp.make_grid(jnp.float64)))
        np.testing.assert_allclose(t[0].astype(np.float64) + t[1],
                                   meas.astype(np.float64) @ B, rtol=1e-12)


@functools.lru_cache(maxsize=None)
def _jax_products(dtype, autodiff):
    """The JAX FactoredBasisProblem's products of the four instances of
    seed 1, as numpy (norm2 (4,), Jt_x (4, 6), JtJ (4, 6, 6))."""
    meas, p0 = _instances(1, 4, dtype)
    B = np.asarray(jsp.basis(*jsp.make_grid(jnp.float64)))
    G = JFactored.gram(B, jnp.dtype(dtype))

    def one(m, q):
        if autodiff:
            prob = JFactored(coeffs=jsp.coeffs, G_pair=G,
                             stats=JFactored.statistics(
                                 jnp.asarray(B, dtype), m))
        else:
            prob = jsp.make_factored_problem(m)
        return tuple(prob.products(q))
    return _np(jax.jit(jax.vmap(one))(jnp.asarray(meas), jnp.asarray(p0)))


def _assert_products(got, want, dtype):
    rtol, atol, rtol_jtj = PRODUCTS_TOL[dtype]
    n2, jtx, jtj = (np.asarray(a, np.float64) for a in got)
    np.testing.assert_allclose(n2, np.asarray(want[0]), rtol=rtol)
    np.testing.assert_allclose(jtx, np.asarray(want[1]), rtol=rtol,
                               atol=atol)
    np.testing.assert_allclose(jtj, np.asarray(want[2]), rtol=rtol_jtj)


@pytest.mark.parametrize("autodiff", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_factored_basis_problem_matches_jax(dtype, autodiff):
    meas, p0 = _instances(1, 4, dtype)
    for i in range(4):
        m = torch.as_tensor(meas[i])
        if autodiff:
            gx, gy = tsp.make_grid(torch.float64, "cpu")
            B = tsp.basis(gx, gy)
            prob = tl.FactoredBasisProblem(
                coeffs=tsp.coeffs,
                G_pair=tl.FactoredBasisProblem.gram(B.numpy(), m.dtype,
                                                    "cpu"),
                stats=tl.FactoredBasisProblem.statistics(B.to(m.dtype), m))
        else:
            prob = tsp.make_factored_problem(m)
        got = prob.products(torch.as_tensor(p0[i]))
        assert got.JtJ.dtype == m.dtype
        _assert_products(got, [a[i] for a in _jax_products(dtype, autodiff)],
                         dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_factored_products_minor_matches_jax_and_per_element(dtype):
    meas, p0 = _instances(1, 4, dtype)
    G = _gram(dtype)
    jG = jsp.gram_pair(jnp.dtype(dtype))
    hh, hl, nh, nl = _torch_stats(1, 4, dtype)
    jhh, jhl, jnh, jnl = _jax_stats(1, 4, dtype)
    got = tsp.factored_products_minor(torch.as_tensor(p0).t(), hh.t(),
                                      hl.t(), nh[None], nl[None], *G)
    want = jax.jit(jsp.factored_products_minor)(
        jnp.asarray(p0.T), jnp.asarray(jhh.T), jnp.asarray(jhl.T),
        jnp.asarray(jnh)[None], jnp.asarray(jnl)[None], *jG)
    _assert_products((a.numpy() for a in got), want, dtype)
    batched = tsp.factored_products(torch.as_tensor(p0), (hh, hl, nh, nl), G)
    for i in range(4):
        one = tsp.factored_products(torch.as_tensor(p0[i]),
                                    (hh[i], hl[i], nh[i], nl[i]), G)
        _assert_products((got[0][0, i], got[1][:, i], got[2][..., i]),
                         (one.norm2_x, one.Jt_x, one.JtJ), dtype)
        _assert_products((batched.norm2_x[i], batched.Jt_x[i],
                          batched.JtJ[i]),
                         (one.norm2_x, one.Jt_x, one.JtJ), dtype)


@functools.lru_cache(maxsize=None)
def _jax_single():
    return jax.jit(lambda m, q: dl.optimize(
        jsp.make_factored_problem(m), q,
        dl.DoglegParameters(max_iterations=8), record_history=True))


@pytest.mark.parametrize("seed", [0, 1])
def test_single_solve_matches_jax(seed):
    meas, p0 = _instances(10 + seed, 1, np.float64)
    r_j = _jax_single()(jnp.asarray(meas[0]), jnp.asarray(p0[0]))
    r_t = tl.optimize(tsp.make_factored_problem(torch.as_tensor(meas[0])),
                      torch.as_tensor(p0[0]),
                      tl.DoglegParameters(max_iterations=8),
                      record_history=True)
    for field in ("step_count", "n_attempts", "reason"):
        assert int(getattr(r_t, field)) == int(getattr(r_j, field)), field
    np.testing.assert_array_equal(r_t.history.step_type.numpy(),
                                  np.asarray(r_j.history.step_type))
    np.testing.assert_array_equal(r_t.history.step_accepted.numpy(),
                                  np.asarray(r_j.history.step_accepted))
    np.testing.assert_allclose(r_t.p.numpy(), np.asarray(r_j.p), rtol=1e-10)
    assert np.all(np.abs(r_t.p.numpy() - jsp.P_TRUE) < 0.2)


def _jax_factored_batched(dtype, prm_kw):
    meas, p0 = _instances(2, 128, dtype)
    G = jsp.gram_pair(jnp.dtype(dtype))
    return jax_batched(lambda p, st: jsp.factored_products(p, st, G),
                       jnp.asarray(p0), dl.DoglegParameters(**prm_kw),
                       problem_data=tuple(jnp.asarray(a) for a in
                                          _jax_stats(2, 128, dtype)))


def _torch_factored_batched(dtype, prm_kw, **kw):
    _, p0 = _instances(2, 128, dtype)
    before = (mega.launch_count, mega.factored_launch_count)
    r = batched_optimize(tsp.factored_products_fn(_gram(dtype)),
                         torch.as_tensor(p0), tl.DoglegParameters(**prm_kw),
                         problem_data=_torch_stats(2, 128, dtype), **kw)
    # CPU tensors never launch
    assert (mega.launch_count, mega.factored_launch_count) == before
    return r


def test_batched_solve_f64_decisions_match_jax():
    r_j = _jax_factored_batched(np.float64, {})
    r_t = _torch_factored_batched(np.float64, {})
    for field in ("step_count", "n_attempts", "reason"):
        np.testing.assert_array_equal(getattr(r_t, field).numpy(),
                                      np.asarray(getattr(r_j, field)),
                                      err_msg=field)
    np.testing.assert_allclose(r_t.p.numpy(), np.asarray(r_j.p), rtol=1e-10,
                               atol=1e-12)
    # the K1 gate on CPU tensors: use_megakernel=True takes the kernel's
    # plain twin, with the masked path's decisions
    r_k = _torch_factored_batched(np.float64, {}, use_megakernel=True)
    for field in ("step_count", "n_attempts", "reason"):
        assert torch.equal(getattr(r_k, field), getattr(r_t, field)), field
    np.testing.assert_allclose(r_k.p.numpy(), r_t.p.numpy(), rtol=1e-10,
                               atol=1e-12)


def test_batched_solve_f32_benchmark_rule():
    r_j = _jax_factored_batched(np.float32, BENCH)
    r_t = _torch_factored_batched(np.float32, BENCH)
    assert r_t.p.dtype == torch.float32
    same = ((r_t.step_count.numpy() == np.asarray(r_j.step_count))
            & (r_t.n_attempts.numpy() == np.asarray(r_j.n_attempts)))
    assert np.mean(same) > 0.85
    for p in (r_t.p.numpy(), np.asarray(r_j.p)):
        err = np.abs(p.astype(np.float64) - jsp.P_TRUE[None])
        assert np.mean(np.all(err < 0.2, axis=1)) >= 0.99


def test_twin_f64_decisions_match_pallas_kernel():
    meas, p0 = _instances(3, 128, np.float64)
    hh, hl, nh, nl = (jnp.asarray(a) for a in _jax_stats(3, 128, np.float64))
    r_j = jax_mega(jsp.factored_products_minor, jnp.asarray(p0),
                   dl.DoglegParameters(),
                   problem_data=(hh, hl, nh[:, None], nl[:, None]),
                   shared_data=jsp.gram_pair(jnp.float64), interpret=True)
    before = mega.factored_launch_count
    r_t = mega.megakernel_optimize_factored(
        torch.as_tensor(p0), *_torch_stats(3, 128, np.float64),
        _gram(np.float64))
    assert mega.factored_launch_count == before  # CPU tensors never launch
    for field in ("step_count", "n_attempts", "reason"):
        np.testing.assert_array_equal(getattr(r_t, field).numpy(),
                                      np.asarray(getattr(r_j, field)),
                                      err_msg=field)
    np.testing.assert_allclose(r_t.p.numpy(), np.asarray(r_j.p), rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(r_t.JtJ.numpy(), np.asarray(r_j.JtJ),
                               rtol=1e-10)
    np.testing.assert_allclose(r_t.trustregion.numpy(),
                               np.asarray(r_j.trustregion), rtol=1e-10)
    np.testing.assert_array_equal(r_t.lam.numpy(), np.asarray(r_j.lam))


def test_factored_f32_gradient_beats_general():
    """tests/test_factored.py:40-76 against the port: near the optimum the
    compensated float32 gradient matches the float64 oracle at the
    float32-rounded coefficients to 1e-6, 1000x closer than the general
    form's per-measurement float32 reduction."""
    meas, p0 = _instances(4, 1, np.float64)
    r = tl.optimize(tsp.make_dense_problem(torch.as_tensor(meas[0])),
                    torch.as_tensor(p0[0]),
                    tl.DoglegParameters(max_iterations=8))
    p32 = r.p.numpy().astype(np.float32)
    meas32 = meas[0].astype(np.float32)
    gx, gy = (a.numpy() for a in tsp.make_grid(torch.float64, "cpu"))
    B = np.stack([gx * gx, gy * gy, gx * gy, gx, gy, np.ones_like(gx)], -1)
    c32 = np.float32([p32[0] * p32[1], p32[1] * p32[2], p32[2], p32[3],
                      p32[4], p32[5]]).astype(np.float64)
    T = tsp.coeffs_jac(torch.as_tensor(p32, dtype=torch.float64)).numpy()
    jtx_true = T.T @ (B.T @ (B @ c32 - meas32.astype(np.float64)))
    m, q = torch.as_tensor(meas32), torch.as_tensor(p32)
    pf = tsp.make_factored_problem(m).products(q)
    pg = tsp.make_products_problem(m).products(q)
    err_f = np.max(np.abs(pf.Jt_x.numpy().astype(np.float64) - jtx_true))
    err_g = np.max(np.abs(pg.Jt_x.numpy().astype(np.float64) - jtx_true))
    assert err_f < 1e-6, err_f
    assert err_f < err_g * 1e-3, (err_f, err_g)


def test_factored_wrapper_and_gate_reject_what_they_cannot_take():
    _, p0 = (torch.as_tensor(a) for a in _instances(5, 4, np.float64))
    hh, hl, nh, nl = _torch_stats(5, 4, np.float64)
    G = _gram(np.float64)
    # n2m as (B,) or (B, 1)
    r = mega.megakernel_optimize_factored(p0, hh, hl, nh[:, None],
                                          nl[:, None], G)
    assert r.p.shape == (4, tsp.NSTATE)
    with pytest.raises(ValueError, match="h_hi"):
        mega.megakernel_optimize_factored(p0, hh[:, :5], hl, nh, nl, G)
    with pytest.raises(ValueError, match="n2m_lo"):
        mega.megakernel_optimize_factored(p0, hh, hl, nh, nl[:3], G)
    with pytest.raises(ValueError, match="dtype"):
        mega.megakernel_optimize_factored(p0, hh, hl.float(), nh, nl, G)
    with pytest.raises(ValueError, match="Ghi"):
        mega.megakernel_optimize_factored(p0, hh, hl, nh, nl,
                                          (G[0][:5], G[1]))
    # the check entries take their twins on CPU tensors
    n2, jtx, jtj = mega.factored_products_device(p0, (hh, hl, nh, nl), G)
    one = tsp.factored_products(p0[1], (hh[1], hl[1], nh[1], nl[1]), G)
    _assert_products((n2[1], jtx[1], jtj[1]),
                     (one.norm2_x, one.Jt_x, one.JtJ), np.float64)
    eft = mega.error_free_transforms(hh[:, 0], hl[:, 0])
    assert torch.equal(eft[0] + eft[1], hh[:, 0] * hl[:, 0] + eft[1])
    assert torch.equal(eft[2], hh[:, 0] + hl[:, 0])

    # a products function no instance of K1 computes, with
    # use_megakernel=True: outside the generated functors' regime too
    # (cumsum has no generated code), so the forced call raises
    def products(p, st):
        return tsp.factored_products(p.cumsum(0), st, G)
    with pytest.raises(ValueError, match="cumsum"):
        batched_optimize(products, p0, problem_data=(hh, hl, nh, nl),
                         use_megakernel=True)
    # the factored instance needs the statistics as problem_data
    with pytest.raises(ValueError, match="problem_data"):
        batched_optimize(tsp.factored_products_fn(G), p0, problem_data=hh,
                         use_megakernel=True)
