"""The slice as a whole on the CPU: the grid MRF (models/grid_mrf.py) with
Nstate > 256, solved by the port's optimize through SparseProblem, the
block-CSR products and BlockedDenseNewtonSolver (largechol with K2's plain
twin), against the JAX package's optimize on the same instance, in float64.

The JAX side uses its default DenseNewtonSolver: jitting its
BlockedDenseNewtonSolver at this size takes about a minute on the CPU, and
in float64 both strategies take the same decisions (tests/test_blockchol.py,
tests/test_largechol.py). Decisions (step_count, n_attempts, reason) must
be identical; p agrees to rtol 1e-10 (summation orders differ), and equals
the linear problem's normal-equation solution to rtol 1e-8.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libdogleg_tpu as dl
from libdogleg_tpu.models import grid_mrf as jgrid
import libdogleg_tpu_torch as tl
from libdogleg_tpu_torch import interop
from libdogleg_tpu_torch.models import grid_mrf as tgrid
from libdogleg_tpu_torch.ops import panelchol

torch.set_num_threads(1)
SHAPE = (8, 8, 5)   # Nstate 320: the n > 256 path, two 256-wide panels


@functools.lru_cache(maxsize=None)
def _jax_solve(coupling):
    m = jgrid.make_grid_mrf(*SHAPE, coupling=coupling)
    prob = m.problem(jtj="dense")
    r = jax.jit(lambda q: dl.optimize(prob, q, dl.DoglegParameters()))(
        jnp.zeros(m.nstate))
    return m, r


@pytest.mark.parametrize("coupling", ["diag", "dense"])
def test_instance_equals_jax(coupling):
    m, _ = _jax_solve(coupling)
    t = tgrid.make_grid_mrf(*SHAPE, coupling=coupling)
    t2 = interop.grid_mrf_from_reference(m)
    for g in (t, t2):
        assert g.structure.nmeas == m.structure.nmeas
        np.testing.assert_array_equal(g.structure.indptr, m.structure.indptr)
        np.testing.assert_array_equal(g.structure.indices,
                                      m.structure.indices)
        np.testing.assert_array_equal(g.edges, m.edges)
        for name in ("z_prior", "z_edge", "p_true"):
            np.testing.assert_array_equal(getattr(g, name).numpy(),
                                          np.asarray(getattr(m, name)))
        assert (g.mix is None) == (coupling == "diag")
        if g.mix is not None:
            np.testing.assert_array_equal(g.mix.numpy(), np.asarray(m.mix))
    p = np.random.default_rng(0).normal(size=m.nstate)
    jprob, tprob = m.problem(jtj="dense"), t.problem(jtj="dense")
    x_j, J_j = jprob.full(jnp.asarray(p))
    x_t, J_t = tprob.full(torch.as_tensor(p))
    np.testing.assert_allclose(x_t.numpy(), np.asarray(x_j), rtol=1e-14,
                               atol=1e-14)
    np.testing.assert_array_equal(J_t.numpy(), np.asarray(J_j))
    np.testing.assert_array_equal(tprob.dense_jacobian(torch.as_tensor(p)),
                                  J_t)


@pytest.mark.parametrize("coupling", ["diag", "dense"])
def test_slice_matches_jax_f64(coupling):
    m, r_j = _jax_solve(coupling)
    t = interop.grid_mrf_from_reference(m)
    prob = t.problem(jtj="dense")
    p0 = torch.zeros(t.nstate, dtype=torch.float64)
    before = panelchol.launch_count
    r_t = tl.optimize(prob, p0, tl.DoglegParameters(),
                      newton_solver=tl.BlockedDenseNewtonSolver())
    assert panelchol.launch_count == before   # CPU: K2's twin
    for field in ("step_count", "n_attempts", "reason"):
        assert int(getattr(r_t, field)) == int(getattr(r_j, field)), field
    assert int(r_t.reason) > 0
    np.testing.assert_allclose(r_t.p.numpy(), np.asarray(r_j.p), rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(float(r_t.norm2_x), float(r_j.norm2_x),
                               rtol=1e-10)
    assert float(r_t.Jt_x.abs().max()) < 1e-9
    # the linear problem's normal equations on the densified system
    x0, J = (a.numpy() for a in prob.full(p0))
    p_opt = np.linalg.solve(J.T @ J, -J.T @ x0)
    np.testing.assert_allclose(r_t.p.numpy(), p_opt, rtol=1e-8, atol=1e-9)


def test_sparse_problem_options():
    t = tgrid.make_grid_mrf(3, 2, 2)
    ns = t.problem().default_newton_solver()   # jtj="sparse", "mindeg"
    assert isinstance(ns, tl.SparseNewtonSolver)
    assert not hasattr(ns.symbolic, "inner")    # simplicial
    r = tl.optimize(t.problem(), torch.zeros(t.nstate, dtype=torch.float64))
    assert int(r.reason) > 0 and float(r.Jt_x.abs().max()) < 1e-9
    with pytest.raises(ValueError, match="jtj"):
        t.problem(jtj="banded")
    with pytest.raises(ValueError, match="coupling"):
        tgrid.make_grid_mrf(3, 2, 2, coupling="full")
    prob = t.problem(jtj="dense")
    assert prob.default_newton_solver() is None


def test_optimize_takes_the_problems_default_strategy():
    """optimize() without newton_solver asks default_newton_solver(), as the
    JAX package's does (problems.py:262-265)."""
    t = tgrid.make_grid_mrf(4, 4, 2)
    base = t.problem(jtj="dense")
    calls = []

    class Spy(tl.DenseNewtonSolver):
        def gauss_newton(self, *a, **kw):
            calls.append(1)
            return super().gauss_newton(*a, **kw)

    class WithDefault(tl.SparseProblem):
        def default_newton_solver(self):
            return Spy()

    prob = WithDefault(f=base.f, structure=base.structure)
    r = tl.optimize(prob, torch.zeros(t.nstate, dtype=torch.float64))
    assert calls and int(r.reason) > 0
