"""The port's tree vectors, matrix small solves and Schur strategies
(libdogleg_tpu_torch/ops/treevec.py, smallchol.py, newton.py) against the
JAX package's, in float64 on the CPU, on the same numpy-seeded inputs.

Tolerances: 1e-12 relative where both sides run the same formula in another
summation order; the Schur solves also against the dense system
(schur_to_dense) to 1e-8. Lambda escalation must give the same final
lambda. The refinement tests hold a float32 solve to the exact solution of
the stored system, as tests/test_refinement.py does.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libdogleg_tpu.ops import newton as jnewton
from libdogleg_tpu.ops import smallchol as jsmall
from libdogleg_tpu.ops import treevec as jtv
import libdogleg_tpu_torch as tl
from libdogleg_tpu_torch.ops import dense as dops
from libdogleg_tpu_torch.ops import newton as tnewton
from libdogleg_tpu_torch.ops import smallchol as tsmall
from libdogleg_tpu_torch.ops import treevec as tv

torch.set_num_threads(1)
NC, NP, BS = 5, 12, 3
KW = dict(lambda_initial=1e-10, lambda_max_tries=60)


def _t(a, dtype=torch.float64):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _trees(kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "flat":
        return [rng.normal(size=7) for _ in range(2)]
    if kind == "dict":
        # keys out of sorted order: both packages visit "c" before "q"
        return [{"q": rng.normal(size=(4, 3)), "c": rng.normal(size=5)}
                for _ in range(2)]
    return [(rng.normal(size=3), rng.normal(size=(2, 2))) for _ in range(2)]


def _to_t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_t(v) for v in tree)
    return _t(tree)


def _to_j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _leaves_equal(got, want, rtol=0.0):
    lg, lw = tv.tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(lg) == len(lw)
    for g, w in zip(lg, lw):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=rtol,
                                   atol=0)


@pytest.mark.parametrize("kind", ["flat", "dict", "tuple"])
def test_treevec_matches_jax(kind):
    a, b = _trees(kind, 0)
    ta, tb, ja, jb = _to_t(a), _to_t(b), _to_j(a), _to_j(b)
    np.testing.assert_allclose(float(tv.tree_dot(ta, tb)),
                               float(jtv.tree_dot(ja, jb)), rtol=1e-14)
    _leaves_equal(tv.tree_scale(torch.tensor(0.3, dtype=torch.float64), ta),
                  jtv.tree_scale(0.3, ja))
    _leaves_equal(tv.tree_add(ta, tb), jtv.tree_add(ja, jb))
    _leaves_equal(tv.tree_sub(ta, tb), jtv.tree_sub(ja, jb))
    _leaves_equal(tv.tree_zeros_like(ta), jtv.tree_zeros_like(ja))
    for pred in (True, False):
        _leaves_equal(tv.tree_where(torch.tensor(pred), ta, tb),
                      jtv.tree_where(pred, ja, jb))
    for thr in (0.5, 2.0, 10.0):
        assert (bool(tv.tree_any_exceeds(ta, thr))
                == bool(jtv.tree_any_exceeds(ja, thr)))
    # the structure is kept, the order of a dict's keys included
    out = tv.tree_add(ta, tb)
    assert type(out) is type(ta)
    if kind == "dict":
        assert list(out) == list(ta)


def test_treevec_flat_is_the_flat_ops():
    """On a bare tensor the tree functions are the solver's flat ops, over
    the trailing axis of a batch too."""
    rng = np.random.default_rng(1)
    a, b = _t(rng.normal(size=(4, 6))), _t(rng.normal(size=(4, 6)))
    assert torch.equal(tv.tree_dot(a, b), (a * b).sum(-1))
    assert torch.equal(tv.tree_any_exceeds(a, 1.0), (a.abs() > 1.0).any(-1))
    assert tv.tree_leaves(a)[0] is a
    nan = torch.full((3,), float("nan"), dtype=torch.float64)
    assert not bool(tv.tree_any_exceeds({"c": nan, "q": nan}, 0.0))


def test_interpolated_step_tree_equals_flat():
    rng = np.random.default_rng(2)
    c, g = rng.normal(size=11), 3.0 * rng.normal(size=11)
    n2c = torch.tensor(float(c @ c), dtype=torch.float64)
    tr = 1.5 * torch.sqrt(n2c)   # between the Cauchy and the GN lengths
    flat = dops.interpolated_step(_t(c), n2c, _t(g), tr)
    tree = dops.interpolated_step({"c": _t(c[:5]), "q": _t(c[5:])}, n2c,
                                  {"c": _t(g[:5]), "q": _t(g[5:])}, tr)
    np.testing.assert_allclose(float(tree.k), float(flat.k), rtol=1e-14)
    np.testing.assert_allclose(
        torch.cat([tree.step["c"], tree.step["q"]]).numpy(),
        flat.step.numpy(), rtol=1e-14, atol=1e-15)
    np.testing.assert_allclose(float(tree.norm2_step), float(tr * tr),
                               rtol=1e-12)


@pytest.mark.parametrize("fn", ["small_fwd_solve_mat", "small_bwd_solve_mat",
                                "small_cho_solve_mat"])
def test_small_solve_mat_matches_jax(fn):
    rng = np.random.default_rng(3)
    A = rng.normal(size=(9, 3, 3))
    A = A @ np.swapaxes(A, -1, -2) + 3 * np.eye(3)
    L = np.linalg.cholesky(A)
    B = rng.normal(size=(9, 3, 4))
    got = getattr(tsmall, fn)(_t(L), _t(B)).numpy()
    want = np.asarray(getattr(jsmall, fn)(jnp.asarray(L), jnp.asarray(B)))
    np.testing.assert_allclose(got, want, rtol=1e-14, atol=1e-14)
    # the broadcast SparseWSchurNewtonSolver uses: (np, 1) factors against
    # (np, k) right-hand sides
    B4 = rng.normal(size=(9, 2, 3, 6))
    got = getattr(tsmall, fn)(_t(L)[:, None], _t(B4)).numpy()
    want = np.asarray(getattr(jsmall, fn)(jnp.asarray(L)[:, None],
                                          jnp.asarray(B4)))
    np.testing.assert_allclose(got, want, rtol=1e-14, atol=1e-14)


def _random_schur(seed, singular_block=None):
    rng = np.random.default_rng(seed)
    n = NC + NP * BS
    J = rng.normal(size=(3 * n, n))
    JtJ = J.T @ J
    U = JtJ[:NC, :NC]
    W = JtJ[:NC, NC:].reshape(NC, NP, BS)
    V = np.stack([JtJ[NC + i * BS:NC + (i + 1) * BS,
                      NC + i * BS:NC + (i + 1) * BS] for i in range(NP)])
    if singular_block is not None:
        V[singular_block] = 0.0
    b = rng.normal(size=n)
    j = jnewton.SchurJtJ(U=jnp.asarray(U), W=jnp.asarray(W),
                         V=jnp.asarray(V))
    t = tl.SchurJtJ(U=_t(U), W=_t(W), V=_t(V))
    return j, t, b


def test_schur_to_dense_matches_jax():
    j, t, _ = _random_schur(0)
    np.testing.assert_array_equal(tnewton.schur_to_dense(t).numpy(),
                                  np.asarray(jnewton.schur_to_dense(j)))


@pytest.mark.parametrize("point_solver", ["unrolled", "lax"])
@pytest.mark.parametrize("tree", [False, True])
def test_schur_matches_jax_and_dense(point_solver, tree):
    j, t, b = _random_schur(2)
    cls_t = tnewton.TreeSchurNewtonSolver if tree else tl.SchurNewtonSolver
    cls_j = (jnewton.TreeSchurNewtonSolver if tree
             else jnewton.SchurNewtonSolver)
    ns_t = cls_t(nc=NC, n_points=NP, block_size=BS, point_solver=point_solver)
    ns_j = cls_j(nc=NC, n_points=NP, block_size=BS, point_solver=point_solver)
    dense = tnewton.schur_to_dense(t)
    v = np.random.default_rng(3).normal(size=NC + NP * BS)
    if tree:
        def split(x, mod):
            return {"c": mod(x[:NC]), "q": mod(x[NC:].reshape(NP, BS))}
        vt, vj, bt, bj = split(v, _t), split(v, jnp.asarray), split(b, _t), \
            split(b, jnp.asarray)
    else:
        vt, vj, bt, bj = _t(v), jnp.asarray(v), _t(b), jnp.asarray(b)
    qt = float(ns_t.quad_form(t, vt))
    np.testing.assert_allclose(qt, float(ns_j.quad_form(j, vj)), rtol=1e-12)
    np.testing.assert_allclose(qt, float(_t(v) @ dense @ _t(v)), rtol=1e-10)
    rt = ns_t.gauss_newton(t, bt, torch.tensor(0.0, dtype=torch.float64),
                           **KW)
    rj = ns_j.gauss_newton(j, bj, jnp.asarray(0.0), **KW)
    assert bool(rt.ok) and bool(rj.ok)
    assert float(rt.lam) == float(rj.lam) == 0.0
    _leaves_equal(rt.step, rj.step, rtol=1e-12)
    np.testing.assert_allclose(float(rt.norm2_step), float(rj.norm2_step),
                               rtol=1e-12)
    flat = torch.cat([x.reshape(-1) for x in tv.tree_leaves(rt.step)])
    want = -torch.linalg.solve(dense, _t(b))
    np.testing.assert_allclose(flat.numpy(), want.numpy(), rtol=1e-8,
                               atol=1e-10)


@pytest.mark.parametrize("point_solver", ["unrolled", "lax"])
def test_schur_lambda_escalation_matches_jax(point_solver):
    """A singular point block escalates lambda to the JAX package's final
    lambda, ok on both sides and no exception (hazard F3), and the step
    solves the damped system; with no escalation allowed ok is False."""
    j, t, b = _random_schur(4, singular_block=3)
    ns_t = tl.SchurNewtonSolver(nc=NC, n_points=NP, block_size=BS,
                                point_solver=point_solver)
    ns_j = jnewton.SchurNewtonSolver(nc=NC, n_points=NP, block_size=BS,
                                     point_solver=point_solver)
    zero = torch.tensor(0.0, dtype=torch.float64)
    rt = ns_t.gauss_newton(t, _t(b), zero, **KW)
    rj = ns_j.gauss_newton(j, jnp.asarray(b), jnp.asarray(0.0), **KW)
    assert bool(rt.ok) and bool(rj.ok)
    assert float(rt.lam) > 0.0
    assert float(rt.lam) == float(rj.lam)
    np.testing.assert_allclose(rt.step.numpy(), np.asarray(rj.step),
                               rtol=1e-9, atol=1e-12)
    damped = tnewton.schur_to_dense(t) + rt.lam * torch.eye(NC + NP * BS,
                                                            dtype=zero.dtype)
    np.testing.assert_allclose((damped @ -rt.step).numpy(), b, rtol=1e-6,
                               atol=1e-9)
    (Lv, Ls), ok = ns_t.factor(t, zero)
    assert not bool(ok)
    assert Lv.shape == (NP, BS, BS) and Ls.shape == (NC, NC)
    stuck = ns_t.gauss_newton(t, _t(b), zero, lambda_initial=1e-10,
                              lambda_max_tries=0)
    assert not bool(stuck.ok) and float(stuck.lam) == 0.0


def _ill_conditioned_arrow(seed):
    """tests/test_refinement.py's arrow system: J^T J of a BA-shaped J with
    shuffled logspace column scaling, cond ~ 1e5."""
    rng = np.random.default_rng(seed)
    nc, npts, bs, mrows = 12, 50, 3, 6
    scale = np.logspace(0, 1.25, nc + npts * bs)
    rng.shuffle(scale)
    Jc = rng.normal(size=(npts, mrows, nc)) * scale[:nc]
    Jp = rng.normal(size=(npts, mrows, bs)) * scale[nc:].reshape(npts, 1, bs)
    JtJ = tl.SchurJtJ(
        U=_t(np.einsum('pmc,pmd->cd', Jc, Jc), torch.float32),
        W=_t(np.einsum('pmc,pmb->cpb', Jc, Jp), torch.float32),
        V=_t(np.einsum('pmb,pmk->pbk', Jp, Jp), torch.float32))
    b = _t(rng.normal(size=nc + npts * bs), torch.float32)
    return JtJ, b, (nc, npts, bs)


def _rel_err(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("tree", [False, True])
def test_schur_refinement_tightens_f32_solve(tree):
    JtJ, b, (nc, npts, bs) = _ill_conditioned_arrow(1)
    u64 = np.linalg.solve(tnewton.schur_to_dense(JtJ).double().numpy(),
                          b.double().numpy())
    cls = tnewton.TreeSchurNewtonSolver if tree else tl.SchurNewtonSolver
    rhs = {"c": b[:nc], "q": b[nc:].reshape(npts, bs)} if tree else b

    def solve(iters):
        ns = cls(nc=nc, n_points=npts, block_size=bs, refine_iters=iters)
        r = ns.gauss_newton(JtJ, rhs, torch.tensor(0.0), lambda_initial=1e-10,
                            lambda_max_tries=10)
        assert bool(r.ok)
        return -torch.cat([x.reshape(-1) for x in
                           tv.tree_leaves(r.step)]).double().numpy()

    e0, e2 = _rel_err(solve(0), u64), _rel_err(solve(2), u64)
    assert e2 < e0 * 1e-1 and e2 < 1e-5, (e0, e2)


def _sparse_w_system(seed, dtype=torch.float64, npts=40, ncam=6, k_obs=3):
    """A random SparseWSchurJtJ with SPD U and V (not from a model)."""
    rng = np.random.default_rng(seed)
    nc = ncam * 6
    Jc = rng.normal(size=(3 * nc, nc))
    U = Jc.T @ Jc
    cam_of = np.stack([rng.choice(ncam, size=k_obs, replace=False)
                       for _ in range(npts)])
    Wv = rng.normal(size=(npts, k_obs, 6, 3))
    A = rng.normal(size=(npts, 5, 3))
    V = A.transpose(0, 2, 1) @ A + 50.0 * np.eye(3)
    rc, rp = rng.normal(size=nc), rng.normal(size=(npts, 3))
    t = tnewton.SparseWSchurJtJ(U=_t(U, dtype), Wv=_t(Wv, dtype),
                                cam_of=torch.as_tensor(cam_of),
                                V=_t(V, dtype))
    j = jnewton.SparseWSchurJtJ(U=jnp.asarray(U), Wv=jnp.asarray(Wv),
                                cam_of=jnp.asarray(cam_of, jnp.int32),
                                V=jnp.asarray(V))
    return t, j, {"c": _t(rc, dtype), "q": _t(rp, dtype)}, \
        {"c": jnp.asarray(rc), "q": jnp.asarray(rp)}, (nc, npts, k_obs)


@pytest.mark.parametrize("chunked", [False, True])
def test_sparse_w_schur_matches_jax(chunked):
    """quad_form and gauss_newton against the JAX strategy; a small
    s_chunk_limit forces the chunked S and camera reductions, whose result
    equals the single pass."""
    t, j, bt, bj, (nc, npts, k_obs) = _sparse_w_system(5)
    limit = 500 if chunked else 1 << 24
    ns_t = tnewton.SparseWSchurNewtonSolver(nc=nc, n_points=npts,
                                            block_size=3, k_obs=k_obs,
                                            s_chunk_limit=limit)
    ns_j = jnewton.SparseWSchurNewtonSolver(nc=nc, n_points=npts,
                                            block_size=3, k_obs=k_obs,
                                            s_chunk_limit=limit)
    np.testing.assert_allclose(float(ns_t.quad_form(t, bt)),
                               float(ns_j.quad_form(j, bj)), rtol=1e-12)
    zero = torch.tensor(0.0, dtype=torch.float64)
    rt = ns_t.gauss_newton(t, bt, zero, **KW)
    rj = ns_j.gauss_newton(j, bj, jnp.asarray(0.0), **KW)
    assert bool(rt.ok) and bool(rj.ok) and float(rt.lam) == float(rj.lam)
    _leaves_equal(rt.step, rj.step, rtol=1e-11)
    single = dataclasses.replace(ns_t, s_chunk_limit=1 << 24)
    (Lv1, Ls1), _ = single.factor(t, zero)
    (Lv2, Ls2), _ = ns_t.factor(t, zero)
    np.testing.assert_allclose(Ls2.numpy(), Ls1.numpy(), rtol=1e-13,
                               atol=1e-12)


def test_onehot_cam_reduce_and_gather_match_jax():
    rng = np.random.default_rng(6)
    ncam, npts, k = 7, 30, 3
    cam_of = rng.integers(0, ncam, size=(npts, k))
    vals = rng.normal(size=(npts, k, 6, 2))
    want = np.asarray(jnewton.onehot_cam_reduce(jnp.asarray(cam_of),
                                                jnp.asarray(vals), ncam))
    for limit in (1 << 24, 50, 1):
        got = tnewton.onehot_cam_reduce(torch.as_tensor(cam_of), _t(vals),
                                        ncam, chunk_limit=limit)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-13,
                                   atol=1e-13)
    tbl, msk = tnewton.build_cam_gather(cam_of, ncam, device="cpu")
    jtbl, jmsk = jnewton.build_cam_gather(cam_of, ncam)
    np.testing.assert_array_equal(msk.numpy(), np.asarray(jmsk))
    np.testing.assert_array_equal(np.where(msk.numpy()[..., 0], tbl.numpy(),
                                           0),
                                  np.where(np.asarray(jmsk)[..., 0],
                                           np.asarray(jtbl), 0))
    with pytest.raises(ValueError):
        tnewton.build_cam_gather(np.array([[0, -1]]), ncam, device="cpu")


@pytest.mark.parametrize("gather", [False, True])
def test_sparse_w_refinement_tightens_f32_solve(gather):
    """tests/test_refinement.py's sparse-W case: a sparse-visibility BA
    system cast to float32, against the float64 solution of the stored
    system. With the static gather table the camera rows of the residual are
    compensated and two passes gain more than an order of magnitude.
    Without it they are a plain float32 product (the JAX package's HIGHEST
    precision, which on a TPU corrects bf16 multiplies): its rounding is as
    large as the error it measures, so the passes only stay at that floor
    (the JAX package's own errors wander there too, 3e-3 to 1e-2 on this
    system)."""
    from libdogleg_tpu_torch.models import pinhole_ba
    ba = pinhole_ba.make_synthetic_sparse(seed=1, ncam=6, npts=80, k_obs=3,
                                          device="cpu")
    pr = ba.products(ba.p0(torch.Generator().manual_seed(0), jitter=0.02))
    t = pr.JtJ._replace(U=pr.JtJ.U.float(), Wv=pr.JtJ.Wv.float(),
                        V=pr.JtJ.V.float())
    rhs = {k: v.float() for k, v in pr.Jt_x.items()}
    lam = torch.tensor(0.01)                  # keeps the system solvable
    nc, npts = ba.ncam * 6, ba.npts
    dense = tnewton.SchurJtJ(U=t.U.double(), W=_dense_w(t, nc, npts),
                             V=t.V.double())
    A = tnewton.schur_to_dense(dense) + 0.01 * torch.eye(nc + npts * 3,
                                                         dtype=torch.float64)
    b = torch.cat([rhs["c"], rhs["q"].reshape(-1)]).double()
    u64 = np.linalg.solve(A.numpy(), b.numpy())
    cg = (tnewton.build_cam_gather(t.cam_of, ba.ncam, device="cpu")
          if gather else None)

    def solve(iters):
        ns = dataclasses.replace(ba.newton_solver(), refine_iters=iters,
                                 cam_gather=cg)
        r = ns.gauss_newton(t, rhs, lam, lambda_initial=1e-10,
                            lambda_max_tries=10)
        assert bool(r.ok)
        return -torch.cat([r.step["c"], r.step["q"].reshape(-1)]
                          ).double().numpy()

    e0, e2 = _rel_err(solve(0), u64), _rel_err(solve(2), u64)
    if gather:
        assert e2 < max(e0 * 1e-1, 5e-7), (e0, e2)
    else:
        assert e2 < 10 * e0, (e0, e2)


def _dense_w(t, nc, npts):
    W = torch.zeros((nc // 6, npts, 6, 3), dtype=torch.float64)
    for p in range(npts):
        for k in range(t.cam_of.shape[1]):
            W[t.cam_of[p, k], p] += t.Wv[p, k].double()
    return W.permute(0, 2, 1, 3).reshape(nc, npts, 3)


def test_refine_over_a_pair():
    """_refine adds the correction leaf by leaf: a pair of tensors refines
    as its concatenation does."""
    def solve_fn(r):
        return (0.5 * r[0], 0.25 * r[1])

    def resid_fn(u):
        return (1.0 - u[0], 2.0 - u[1])
    u = tnewton._refine((torch.zeros(2), torch.zeros(3)), solve_fn, resid_fn,
                        3)
    np.testing.assert_allclose(u[0].numpy(), 1.0 - 0.5 ** 3)
    np.testing.assert_allclose(u[1].numpy(), 2.0 * (1.0 - 0.75 ** 3))
    flat = tnewton._refine(torch.zeros(2), lambda r: 0.5 * r,
                           lambda u: 1.0 - u, 3)
    np.testing.assert_allclose(flat.numpy(), 1.0 - 0.5 ** 3)
