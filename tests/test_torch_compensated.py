"""The port's compensated arithmetic (ops/compensated.py) and the refinement
it feeds (ops/newton.py) against the JAX package, on numpy-seeded inputs.

The error-free transformations are checked for exactness directly: in
float32, s + e and p + e, summed in float64, must equal the float64 sum and
product exactly (hazard F2: a fused multiply-add would break this).
Elementwise transformations are bitwise equal to the JAX ones; reductions
sum in another order, so their hi parts agree to rtol 1e-6 (float32) and
their hi + lo to the exact sum within a few eps^2 of the terms' magnitude.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libdogleg_tpu.ops import compensated as jcomp
from libdogleg_tpu.ops import newton as jnewton
from libdogleg_tpu_torch.ops import compensated as tcomp
from libdogleg_tpu_torch.ops import newton as tnewton

torch.set_num_threads(1)


def _f32(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def test_two_prod_and_two_sum_are_exact_in_f32():
    rng = np.random.default_rng(0)
    a = _f32(rng, 4096, scale=1e3)
    b = _f32(rng, 4096, scale=1e-2)
    p, e = tcomp.two_prod(torch.as_tensor(a), torch.as_tensor(b))
    exact = a.astype(np.float64) * b.astype(np.float64)
    np.testing.assert_array_equal(
        p.numpy().astype(np.float64) + e.numpy().astype(np.float64), exact)
    s, e = tcomp.two_sum(torch.as_tensor(a), torch.as_tensor(b))
    np.testing.assert_array_equal(
        s.numpy().astype(np.float64) + e.numpy().astype(np.float64),
        a.astype(np.float64) + b.astype(np.float64))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_elementwise_transformations_equal_jax(dtype):
    rng = np.random.default_rng(1)
    a = rng.normal(size=257).astype(dtype) * 1e4
    b = rng.normal(size=257).astype(dtype) * 1e-3
    c = rng.normal(size=257).astype(dtype)
    d = rng.normal(size=257).astype(dtype) * 1e-9
    ta, tb, tc, td = (torch.as_tensor(x) for x in (a, b, c, d))
    ja, jb, jc, jd = (jnp.asarray(x) for x in (a, b, c, d))
    for t_out, j_out in [
            (tcomp.two_sum(ta, tb), jcomp.two_sum(ja, jb)),
            (tcomp._split(ta), jcomp._split(ja)),
            (tcomp.two_prod(ta, tb), jcomp.two_prod(ja, jb)),
            (tcomp.pair_add(ta, tb, tc, td), jcomp.pair_add(ja, jb, jc, jd)),
            (tcomp.pair_add_prod(ta, td, tb, tc),
             jcomp.pair_add_prod(ja, jd, jb, jc)),
            ((tcomp.collapse(ta, tb),), (jcomp.collapse(ja, jb),)),
            ((tcomp.residual(tc, ta, tb),), (jcomp.residual(jc, ja, jb),))]:
        for t, j in zip(t_out, j_out):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def _assert_pair_close(t_pair, j_pair, exact, terms_abs, dtype):
    eps = np.finfo(dtype).eps
    hi, lo = (x.numpy().astype(np.float64) for x in t_pair)
    jhi = np.asarray(j_pair[0]).astype(np.float64)
    np.testing.assert_allclose(hi, jhi, rtol=4 * eps,
                               atol=4 * eps * terms_abs.max())
    # double working precision: within a few eps^2 of the terms' magnitude
    assert np.all(np.abs(hi + lo - exact) <= 8 * eps * eps * terms_abs
                  + np.abs(exact) * 1e-15)


def test_compensated_reductions_match_jax_f32():
    rng = np.random.default_rng(2)
    dt = np.float32
    A = _f32(rng, 24, 37, scale=1e2)
    Alo = _f32(rng, 24, 37, scale=1e-6)
    u = _f32(rng, 37)
    tA, tAlo, tu = (torch.as_tensor(x) for x in (A, Alo, u))
    jA, jAlo, ju = (jnp.asarray(x) for x in (A, Alo, u))
    A64, u64 = A.astype(np.float64), u.astype(np.float64)
    mag = np.abs(A64) @ np.abs(u64)
    _assert_pair_close(tcomp.comp_matvec(tA, tu), jcomp.comp_matvec(jA, ju),
                       A64 @ u64, mag, dt)
    _assert_pair_close(tcomp.comp_matvec_pair(tA, tAlo, tu),
                       jcomp.comp_matvec_pair(jA, jAlo, ju),
                       (A64 + Alo.astype(np.float64)) @ u64, mag, dt)
    _assert_pair_close(tcomp.pair_dot_pair(tu, tA[0], tAlo[0]),
                       jcomp.pair_dot_pair(ju, jA[0], jAlo[0]),
                       u64 @ (A64[0] + Alo[0].astype(np.float64)),
                       np.abs(u64) @ np.abs(A64[0]), dt)
    p, e = tcomp.two_prod(tA, tA)
    jp, je = jcomp.two_prod(jA, jA)
    _assert_pair_close(tcomp.comp_reduce(p, e, axis=0),
                       jcomp.comp_reduce(jp, je, axis=0),
                       (A64 * A64).sum(0), (A64 * A64).sum(0), dt)
    V = _f32(rng, 5, 7, 3)
    _assert_pair_close(
        tcomp.comp_contract(torch.as_tensor(V), torch.as_tensor(V[0, 0]),
                            reduce_axes=(1, 2),
                            broadcast=lambda x: x[None, None, :]),
        jcomp.comp_contract(jnp.asarray(V), jnp.asarray(V[0, 0]),
                            reduce_axes=(1, 2),
                            broadcast=lambda x: x[None, None, :]),
        np.einsum('pbk,k->p', V.astype(np.float64),
                  V[0, 0].astype(np.float64)),
        np.einsum('pbk,k->p', np.abs(V.astype(np.float64)),
                  np.abs(V[0, 0].astype(np.float64))), dt)


def _spd(n, rng, cond_scale=1.0):
    A = rng.normal(size=(n, n))
    return A @ A.T + cond_scale * n * np.eye(n)


@pytest.mark.parametrize("n", [6, 40])
def test_dense_refinement_matches_jax_f64(n):
    rng = np.random.default_rng(3)
    JtJ, b = _spd(n, rng), rng.normal(size=n)
    kw = dict(lambda_initial=1e-10, lambda_max_tries=10)
    r_t = tnewton.DenseNewtonSolver(refine_iters=2).gauss_newton(
        torch.as_tensor(JtJ), torch.as_tensor(b),
        torch.tensor(0.0, dtype=torch.float64), **kw)
    r_j = jnewton.DenseNewtonSolver(refine_iters=2).gauss_newton(
        jnp.asarray(JtJ), jnp.asarray(b), jnp.asarray(0.0), **kw)
    assert bool(r_t.ok) and bool(r_j.ok)
    np.testing.assert_allclose(r_t.step.numpy(), np.asarray(r_j.step),
                               rtol=1e-10, atol=1e-13)
    np.testing.assert_allclose(float(r_t.norm2_step),
                               float(r_j.norm2_step), rtol=1e-10)


def test_refinement_recovers_f32_accuracy():
    """Against the float64 solution, two compensated passes leave a float32
    step at least 10x closer than the unrefined one on an ill-conditioned
    system (the purpose of refine_iters)."""
    rng = np.random.default_rng(4)
    n = 48
    Q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    JtJ = (Q * np.logspace(0, 4, n)) @ Q.T
    JtJ = (JtJ + JtJ.T) / 2
    b = rng.normal(size=n)
    exact = -np.linalg.solve(JtJ.astype(np.float32).astype(np.float64),
                             b.astype(np.float32).astype(np.float64))
    kw = dict(lambda_initial=1e-10, lambda_max_tries=10)
    args = (torch.as_tensor(JtJ, dtype=torch.float32),
            torch.as_tensor(b, dtype=torch.float32), torch.tensor(0.0))
    errs = []
    for iters in (0, 2):
        r = tnewton.DenseNewtonSolver(refine_iters=iters).gauss_newton(
            *args, **kw)
        errs.append(np.abs(r.step.double().numpy() - exact).max())
    assert errs[1] * 10 < errs[0], errs


def test_dense_refinement_masked_batch():
    """refine_iters on a batch with an active mask: each element's step is
    its own single solve's."""
    rng = np.random.default_rng(5)
    JtJ = np.stack([_spd(20, rng) for _ in range(3)])
    b = rng.normal(size=(3, 20))
    kw = dict(lambda_initial=1e-10, lambda_max_tries=10)
    ns = tnewton.DenseNewtonSolver(refine_iters=1)
    rb = ns.gauss_newton(torch.as_tensor(JtJ), torch.as_tensor(b),
                         torch.zeros(3, dtype=torch.float64),
                         active=torch.tensor([True, False, True]), **kw)
    for i in range(3):
        r1 = ns.gauss_newton(torch.as_tensor(JtJ[i]), torch.as_tensor(b[i]),
                             torch.tensor(0.0, dtype=torch.float64), **kw)
        np.testing.assert_allclose(rb.step[i].numpy(), r1.step.numpy(),
                                   rtol=1e-12, atol=1e-15)
