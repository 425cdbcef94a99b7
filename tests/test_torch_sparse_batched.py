"""Batched block-sparse solves on the CPU: a batch of problems that share one
sparsity pattern (the batched-SLAM regime) through the batched level loop of
sparse_cholesky.py and supernodal.py, SparseNewtonSolver on a batch, the
out-of-place block-sparse products under torch.func.vmap (ops/bcsr.py) and
the masked batched solver with newton_solver=SparseNewtonSolver, against the
JAX package's vmap of the same functions, in float64.

Instances: the JAX package's random sparse SPD block patterns
(tests/test_sparse_cholesky.py's construction) scaled per element, and
batches of four 6x6 grid MRFs (b 2 and 3, coupling "dense"), element s made
with seed s. The products function is the one a user writes from the public
functions of either package: the grid's residual with the element's
(z_prior, z_edge, mix) and a per-node and per-edge weight scale, so that one
element can be made singular (node 0's prior and edges weighted 0, a zero
block column of J) and escalate lambda alone. The JAX side is jitted once a
case and cached for the module.

Tolerances: decisions (step_count, n_attempts, reason, History step types
and step_accepted) identical and lambda exactly equal; p within 1e-9 of the
largest entry of its element, the costs within 1e-9 of the batch's largest;
the vmapped factorize/solve replays within rtol 1e-10 of JAX's x, ok
identical. An element of a batch against its own single solve in the port:
the same decisions, p within 1e-12 (the masked solver's per-element
reductions are not the single solve's); a batched factorize or Newton step
against the single one: the same bits.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libdogleg_tpu as dl
from libdogleg_tpu import sparse_cholesky as jsc
from libdogleg_tpu import supernodal as jsn
from libdogleg_tpu.models import grid_mrf as jgrid
from libdogleg_tpu.ops import bcsr as jbcsr
from libdogleg_tpu.ops import newton as jnewton
from libdogleg_tpu.parallel.batched import batched_optimize as j_batched
from libdogleg_tpu.problems import SparseProblem as JSparseProblem
import libdogleg_tpu_torch as tl
from libdogleg_tpu_torch import interop
from libdogleg_tpu_torch import sparse_cholesky as tsc
from libdogleg_tpu_torch import supernodal as tsn
from libdogleg_tpu_torch.models import grid_mrf as tgrid
from libdogleg_tpu_torch.ops import bcsr as tbcsr
from libdogleg_tpu_torch.ops import bcsr_kernels as tk
from libdogleg_tpu_torch.parallel import (batched_optimize,
                                          batched_optimize_compacted)

torch.set_num_threads(1)
RTOL = 1e-9
KW = dict(lambda_initial=1e-10, lambda_max_tries=60)
# a small first trust region, so that the linear grid problem takes Cauchy,
# interpolated and Gauss-Newton steps before it converges
PRM = dict(trustregion0=0.5)
B = 4
SINGULAR = 3   # the element whose node 0 is weighted 0


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


def _close_rows(got, want, rtol=RTOL):
    """Row by row: inf where want has inf, the finite entries within rtol
    of the row's largest finite magnitude."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    got, want = got.reshape(got.shape[0], -1), want.reshape(want.shape[0], -1)
    for g, w in zip(got, want):
        fin = np.isfinite(w)
        np.testing.assert_array_equal(np.isfinite(g), fin)
        np.testing.assert_array_equal(g[~fin], w[~fin])
        if fin.any():
            scale = max(float(np.abs(w[fin]).max()), 1e-300)
            np.testing.assert_allclose(g[fin], w[fin], rtol=0,
                                       atol=rtol * scale)


def _assert_same_solves(rt, rj):
    """The port's batched result rt takes rj's decisions and agrees."""
    for field in ("step_count", "n_attempts", "reason"):
        np.testing.assert_array_equal(_np(getattr(rt, field)),
                                      _np(getattr(rj, field)), err_msg=field)
    np.testing.assert_array_equal(_np(rt.lam), _np(rj.lam))
    _close_rows(rt.p, rj.p)
    _close_rows(_np(rt.norm2_x)[None], _np(rj.norm2_x)[None])
    for name in ("step_type", "step_accepted", "iteration"):
        np.testing.assert_array_equal(_np(getattr(rt.history, name)),
                                      _np(getattr(rj.history, name)),
                                      err_msg=name)
    for name in ("norm2x_after", "step_len", "rho", "trustregion_after"):
        _close_rows(getattr(rt.history, name), getattr(rj.history, name))


# ---------------------------------------------------------------------------
# the vmapped factorize/solve replays (tests/test_sparse_cholesky.py:366-424)
# ---------------------------------------------------------------------------


def _random_spd_pattern(seed, nb, b, extra_offdiag):
    """tests/test_sparse_cholesky.py's random sparse SPD block matrix: its
    dense form, stored lower blocks and the pattern."""
    rng = np.random.default_rng(seed)
    pairs = {(j, j) for j in range(nb)}
    while len(pairs) < nb + extra_offdiag:
        i = rng.integers(1, nb)
        j = rng.integers(0, i)
        pairs.add((int(i), int(j)))
    rows, cols = map(np.asarray, zip(*sorted(pairs, key=lambda t: (t[1],
                                                                   t[0]))))
    dense = np.zeros((nb * b, nb * b))
    blocks = []
    for i, j in zip(rows, cols):
        blk = rng.normal(size=(b, b)) * 0.1
        if i == j:
            blk = blk @ blk.T + np.eye(b) * (3 + nb * 0.2)
        dense[i * b:(i + 1) * b, j * b:(j + 1) * b] = blk
        if i != j:
            dense[j * b:(j + 1) * b, i * b:(i + 1) * b] = blk.T
        blocks.append(blk)
    return dense, np.stack(blocks), rows, cols


@functools.lru_cache(maxsize=None)
def _vmapped_case(kind):
    """(port analysis, blocks (B, n_input, 3, 3), rhs (B, 27), JAX x, JAX
    ok). The last element's first diagonal block is zeroed: not SPD, so
    its ok is False in both packages."""
    seed = 40 if kind == "simplicial" else 50
    _, blocks0, rows, cols = _random_spd_pattern(seed, 9, 3, 14)
    rng = np.random.default_rng(seed + 1)
    scales = 1.0 + rng.uniform(0.1, 2.0, size=B)
    blocks = blocks0[None] * scales[:, None, None, None]
    first_diag = int(np.flatnonzero((rows == 0) & (cols == 0))[0])
    blocks[-1, first_diag] = 0.0
    rhs = rng.normal(size=(B, 27))
    if kind == "simplicial":
        jm, tm = jsc, tsc
        jsym, tsym = jsc.analyze(rows, cols, 9, 3), tsc.analyze(rows, cols,
                                                                9, 3)
    else:
        jm, tm = jsn, tsn
        jsym = jsn.analyze(rows, cols, 9, 3, amalgamate=4)
        tsym = tsn.analyze(rows, cols, 9, 3, amalgamate=4)

    def solve_one(blk, r):
        L, ok = jm.factorize(jsym, blk, jnp.asarray(0.0))
        return jm.solve(jsym, L, r), ok

    xs, oks = jax.jit(jax.vmap(solve_one))(jnp.asarray(blocks),
                                           jnp.asarray(rhs))
    return tm, tsym, blocks, rhs, np.asarray(xs), np.asarray(oks)


@pytest.mark.parametrize("kind", ["simplicial", "supernodal"])
def test_vmapped_solves_match_jax(kind):
    tm, sym, blocks, rhs, xj, okj = _vmapped_case(kind)
    L, ok = tm.factorize(sym, torch.as_tensor(blocks),
                         torch.zeros(B, dtype=torch.float64))
    x = tm.solve(sym, L, torch.as_tensor(rhs))
    np.testing.assert_array_equal(ok.numpy(), okj)
    assert okj.tolist() == [True] * (B - 1) + [False]
    np.testing.assert_allclose(x.numpy()[:-1], xj[:-1], rtol=1e-10,
                               atol=1e-13)


@pytest.mark.parametrize("kind", ["simplicial", "supernodal"])
def test_batched_factor_elements_match_single(kind):
    """Each element of a batched factorize/solve, k right-hand sides at
    once, is the single call's, bit for bit; a (B,) lam damps each element
    with its own lambda."""
    tm, sym, blocks, rhs, _, _ = _vmapped_case(kind)
    lam = torch.tensor([0.0, 1e-3, 1e-1, 0.0], dtype=torch.float64)
    L, ok = tm.factorize(sym, torch.as_tensor(blocks), lam)
    R = torch.as_tensor(np.stack([rhs, 2.0 * rhs], -1))       # (B, n, 2)
    x = tm.solve(sym, L, R)
    assert x.shape == (B, 27, 2)
    for i in range(B):
        Li, oki = tm.factorize(sym, torch.as_tensor(blocks[i]), lam[i])
        assert bool(oki) == bool(ok[i])
        assert torch.equal(Li, L[i]) or not bool(oki)
        if bool(oki):
            assert torch.equal(tm.solve(sym, Li, R[i]), x[i])


# ---------------------------------------------------------------------------
# batched grid MRF solves through the masked solver
# ---------------------------------------------------------------------------


def _weights(g):
    """Per-node and per-edge weight scales (B, n_nodes), (B, n_edges): 1,
    but 0 on element SINGULAR's node 0 and the edges that touch it."""
    wp = np.ones((B, g.width * g.height))
    we = np.ones((B, g.edges.shape[0]))
    wp[SINGULAR, 0] = 0.0
    we[SINGULAR, (np.asarray(g.edges) == 0).any(1)] = 0.0
    return wp, we


def _jax_products(g, sched):
    n, ne, b = g.width * g.height, g.edges.shape[0], g.block_size
    eu, ev = jnp.asarray(g.edges[:, 0]), jnp.asarray(g.edges[:, 1])
    sp, se = math.sqrt(g.w_prior), math.sqrt(g.w_edge)
    eye = jnp.eye(b)

    def products(p, data):
        zp, ze, mix, wp, we = data
        pb = p.reshape(n, b)
        rp = sp * wp[:, None] * (pb - zp)
        re = se * we[:, None] * (jnp.einsum("eab,eb->ea", mix, pb[ev])
                                 - pb[eu] - ze)
        x = jnp.concatenate([rp.reshape(-1), re.reshape(-1)])
        w3 = we[:, None, None]
        values = jnp.concatenate([
            sp * wp[:, None, None] * eye,
            jnp.stack([-se * w3 * eye, se * w3 * mix], 1).reshape(2 * ne, b,
                                                                  b)])
        J = jbcsr.BCSRJacobian(structure=g.structure, values=values)
        return dl.Products(norm2_x=x @ x, Jt_x=jbcsr.bcsr_jt_x(J, x),
                           JtJ=jbcsr.bcsr_jtj_lower_blocks(J, sched))
    return products


def _port_products(g, sched):
    n, ne, b = g.n_nodes, g.edges.shape[0], g.block_size
    eu = torch.as_tensor(g.edges[:, 0])
    ev = torch.as_tensor(g.edges[:, 1])
    sp, se = math.sqrt(g.w_prior), math.sqrt(g.w_edge)
    eye = torch.eye(b, dtype=torch.float64)

    def products(p, data):
        zp, ze, mix, wp, we = data
        pb = p.reshape(n, b)
        rp = sp * wp[:, None] * (pb - zp)
        re = se * we[:, None] * ((mix @ pb[ev][..., None])[..., 0] - pb[eu]
                                 - ze)
        x = torch.cat([rp.reshape(-1), re.reshape(-1)])
        w3 = we[:, None, None]
        values = torch.cat([
            sp * wp[:, None, None] * eye,
            torch.stack([-se * w3 * eye, se * w3 * mix], 1).reshape(
                2 * ne, b, b)])
        J = tbcsr.BCSRJacobian(g.structure, values)
        return tl.Products(norm2_x=x @ x, Jt_x=tbcsr.bcsr_jt_x(J, x),
                           JtJ=tbcsr.bcsr_jtj_lower_blocks(J, sched))
    return products


@functools.lru_cache(maxsize=None)
def _grids(b):
    """The JAX instances, the port's batch (GridMRF, (z_prior, z_edge, mix)
    by interop) and the weight scales."""
    jgs = [jgrid.make_grid_mrf(6, 6, b, coupling="dense", seed=s)
           for s in range(B)]
    g, data = interop.grid_mrf_batch_from_reference(jgs, device="cpu")
    return jgs, g, data, _weights(g)


def _solver_pair(g, amalgamate, refine):
    """(JAX strategy, port strategy) on the lower JtJ pattern, both
    packages' analyses of it."""
    jsched = jbcsr.jtj_lower_schedule(g.structure)
    b = g.block_size
    jns = jnewton.SparseNewtonSolver.analyze(
        jsched.rows, jsched.cols, g.structure.nbcol, b,
        amalgamate=amalgamate)
    tns = tl.SparseNewtonSolver.analyze(
        jsched.rows, jsched.cols, g.structure.nbcol, b,
        amalgamate=amalgamate)
    return (jnewton.SparseNewtonSolver(jns.symbolic, refine_iters=refine),
            tl.SparseNewtonSolver(tns.symbolic, refine_iters=refine))


@functools.lru_cache(maxsize=None)
def _case(b, amalgamate, refine):
    """Everything one batched case needs, the JAX result included."""
    jgs, g, data, (wp, we) = _grids(b)
    jns, tns = _solver_pair(g, amalgamate, refine)
    jsched = jbcsr.jtj_lower_schedule(g.structure)
    tsched = tbcsr.jtj_lower_schedule(g.structure)
    jdata = (jnp.stack([x.z_prior for x in jgs]),
             jnp.stack([x.z_edge for x in jgs]),
             jnp.stack([x.mix for x in jgs]), jnp.asarray(wp),
             jnp.asarray(we))
    tdata = data + (torch.as_tensor(wp), torch.as_tensor(we))
    p0 = np.zeros((B, g.nstate))
    rj = j_batched(_jax_products(jgs[0], jsched), jnp.asarray(p0),
                   dl.DoglegParameters(**PRM), problem_data=jdata,
                   newton_solver=jns, record_history=True)
    rj = jax.device_get(rj)
    return (_port_products(g, tsched), torch.as_tensor(p0), tdata, tns, rj)


CASES = [(2, 1, 0), (2, 4, 0), (3, 1, 0), (3, 4, 0), (3, 1, 1), (2, 4, 1)]


def _ids(case):
    b, am, refine = case
    return (f"b{b}-{'simplicial' if am == 1 else f'amalgamate{am}'}"
            + (f"-refine{refine}" if refine else ""))


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_batched_optimize_matches_jax(case):
    products, p0, data, ns, rj = _case(*case)
    rt = batched_optimize(products, p0, tl.DoglegParameters(**PRM),
                          problem_data=data, newton_solver=ns,
                          record_history=True)
    _assert_same_solves(rt, rj)
    # every element converged; the singular one alone escalated lambda,
    # and the solve took every kind of step
    assert (_np(rt.reason) > 0).all()
    lam = _np(rt.lam)
    assert lam[SINGULAR] > 0 and not lam[np.arange(B) != SINGULAR].any()
    assert set(_np(rt.history.step_type).ravel()) >= {0, 1, 2}


@pytest.mark.parametrize("case", [CASES[0], CASES[3], CASES[4]], ids=_ids)
def test_compacted_takes_the_same_decisions(case):
    products, p0, data, ns, rj = _case(*case)
    prm = tl.DoglegParameters(**PRM)
    rt = batched_optimize(products, p0, prm, problem_data=data,
                          newton_solver=ns)
    rc = batched_optimize_compacted(products, p0, prm, problem_data=data,
                                    newton_solver=ns, phase1_attempts=2,
                                    compact_capacity=2)
    for field in ("step_count", "n_attempts", "reason", "lam"):
        np.testing.assert_array_equal(_np(getattr(rc, field)),
                                      _np(getattr(rj, field)), err_msg=field)
        assert torch.equal(getattr(rc, field), getattr(rt, field)), field
    assert torch.equal(rc.p, rt.p)
    _close_rows(rc.p, rj.p)


@pytest.mark.parametrize("case", [CASES[1], CASES[2], CASES[4]], ids=_ids)
def test_elements_match_single_solves(case):
    """Each element of the batched solve takes the decisions of its own
    single solve in the port."""
    products, p0, data, ns, _ = _case(*case)
    prm = tl.DoglegParameters(**PRM)
    rt = batched_optimize(products, p0, prm, problem_data=data,
                          newton_solver=ns, record_history=True)
    for i in range(B):
        di = tuple(d[i] for d in data)
        r1 = tl.solve_products(lambda p: products(p, di), p0[i], prm,
                               newton_solver=ns, record_history=True)
        for field in ("step_count", "n_attempts", "reason"):
            assert int(getattr(r1, field)) == int(getattr(rt, field)[i])
        assert float(r1.lam) == float(rt.lam[i])
        np.testing.assert_allclose(rt.p[i].numpy(), r1.p.numpy(),
                                   rtol=1e-12, atol=1e-14)
        n = int(r1.n_attempts)
        assert torch.equal(r1.history.step_type[:n],
                           rt.history.step_type[i, :n])


# ---------------------------------------------------------------------------
# batchable products
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("coupling", ["diag", "dense"])
@pytest.mark.parametrize("amalgamate", [1, 4])
def test_vmap_of_sparse_products(coupling, amalgamate):
    """torch.func.vmap(SparseProblem(jtj="sparse").products) gives each
    element's products, bit for bit, and the batch's Newton step is each
    element's."""
    g = tgrid.make_grid_mrf(5, 4, 3, coupling=coupling,
                                         device="cpu")
    base = g.problem()
    prob = tl.SparseProblem(f=base.f, structure=base.structure,
                            jtj="sparse", amalgamate=amalgamate)
    P = torch.as_tensor(np.random.default_rng(6).normal(size=(3,
                                                             g.nstate)))
    pr = torch.func.vmap(prob.products)(P)
    ns = prob.default_newton_solver()
    gn = ns.gauss_newton(pr.JtJ, pr.Jt_x, torch.zeros(3, dtype=P.dtype),
                         **KW)
    q = ns.quad_form(pr.JtJ, pr.Jt_x)
    for i in range(3):
        one = prob.products(P[i])
        for a, c in zip(pr, one):
            assert torch.equal(a[i], c)
        assert torch.equal(gn.step[i], ns.gauss_newton(
            one.JtJ, one.Jt_x, torch.tensor(0.0, dtype=P.dtype),
            **KW).step)
        assert torch.equal(q[i], ns.quad_form(one.JtJ, one.Jt_x))


@pytest.mark.parametrize("bm,bn", [(2, 2), (3, 5), (8, 8)])
def test_k3_route_under_vmap(bm, bn, monkeypatch):
    """K3's wrapper under torch.func.vmap: values under the transform take
    the operator, others the launch itself; the operator's vmap rule folds
    the vmapped axis into the launch's own batch axis, one call for all,
    and gives each element's blocks; on CPU values the wrapper is the plain
    version, once and nested."""
    g = tgrid.make_grid_mrf(4, 3, 2, device="cpu")
    s = g.structure
    if (bm, bn) != (2, 2):
        s = s._replace(nmeas=s.nbrow * bm, nstate=s.nbcol * bn,
                       block_rows=bm, block_cols=bn)
    sched = tbcsr.jtj_lower_schedule(s)
    nout, npairs = len(sched.rows), len(sched.pair_i)
    ops = torch.as_tensor(tk._jtj_operands(sched))
    V = torch.as_tensor(np.random.default_rng(bm).normal(
        size=(2, 3, s.nnzb, bm, bn)))
    want = tbcsr.jtj_pair_sum(V, sched.pair_i, sched.pair_j, sched.out_idx,
                              nout)

    routes = []
    torch.func.vmap(lambda v: routes.append(tk._jtj_launcher(v)) or v)(V)
    assert routes == [tk._jtj_op]
    assert tk._jtj_launcher(V) is tk._jtj_batched_launch

    calls = []

    def launch(values, operands, npairs_, nout_):
        # the launch's function on the card's operands: pair_i, pair_j,
        # then each output block's run
        calls.append(tuple(values.shape))
        o = operands.long()
        out_idx = torch.repeat_interleave(torch.arange(nout_),
                                          o[2 * npairs_:].diff())
        return tbcsr.jtj_pair_sum(values, o[:npairs_],
                                  o[npairs_:2 * npairs_], out_idx, nout_)

    monkeypatch.setattr(tk, "_jtj_op", launch)
    out, dim = tk._jtj_op_vmap(None, (1, None, None, None), V.movedim(0, 1),
                               ops, npairs, nout)
    assert dim == 0 and torch.equal(out, want)
    assert calls == [(6, s.nnzb, bm, bn)]
    out, dim = tk._jtj_op_vmap(None, (None, None, None, None), V[0], ops,
                               npairs, nout)
    assert dim is None and torch.equal(out, want[0])

    def one(v):
        return tk.bcsr_jtj_lower_kernel(tbcsr.BCSRJacobian(s, v), sched)

    assert torch.equal(torch.func.vmap(torch.func.vmap(one))(V), want)
    assert torch.equal(torch.func.vmap(one)(V[0]), want[0])
    assert torch.equal(one(V[0, 0]), want[0, 0])


def test_lower_blocks_on_cpu_are_the_plain_version():
    """bcsr_jtj_lower_blocks on CPU values is jtj_pair_sum (K3's plain
    version), with or without a leading batch axis, and the kernel
    wrapper's CPU branch is the same."""
    g = tgrid.make_grid_mrf(5, 5, 2, coupling="dense",
                                         device="cpu")
    sched = tbcsr.jtj_lower_schedule(g.structure)
    vals = g.problem().f(g.p_true)[1]
    J = tbcsr.BCSRJacobian(g.structure, vals)
    want = tbcsr.jtj_pair_sum(vals, sched.pair_i, sched.pair_j,
                              sched.out_idx, len(sched.rows))
    assert torch.equal(tbcsr.bcsr_jtj_lower_blocks(J, sched), want)
    assert torch.equal(tk.bcsr_jtj_lower_kernel(J, sched), want)
    Vb = torch.stack([vals, 2 * vals])
    got = tk.bcsr_jtj_lower_kernel(tbcsr.BCSRJacobian(g.structure, Vb),
                                   sched)
    assert torch.equal(got[0], want) and torch.equal(got[1],
                                                     tk.bcsr_jtj_lower_kernel(
        tbcsr.BCSRJacobian(g.structure, 2 * vals), sched))


# ---------------------------------------------------------------------------
# replays of tests/test_bcsr.py:78-145 and tests/test_refinement.py:99-135
# ---------------------------------------------------------------------------


def _random_block_sparse(seed, nbrow=10, nbcol=6, bm=3, bn=2, density=0.4):
    rng = np.random.default_rng(seed)
    indptr, indices = [0], []
    for _ in range(nbrow):
        cols = np.flatnonzero(rng.random(nbcol) < density)
        if cols.size == 0:
            cols = np.asarray([rng.integers(nbcol)])
        indices.extend(cols.tolist())
        indptr.append(len(indices))
    s = tbcsr.BCSRStructure(nmeas=nbrow * bm, nstate=nbcol * bn,
                            block_rows=bm, block_cols=bn,
                            indptr=np.asarray(indptr, np.int32),
                            indices=np.asarray(indices, np.int32))
    vals = rng.normal(size=(s.nnzb, bm, bn))
    return s, vals


@pytest.mark.parametrize("seed", [5, 6])
def test_jtj_lower_blocks_match_dense_and_jax(seed):
    s, vals = _random_block_sparse(seed)
    sched = tbcsr.jtj_lower_schedule(s)
    J = tbcsr.BCSRJacobian(s, torch.as_tensor(vals))
    blocks = tbcsr.bcsr_jtj_lower_blocks(J, sched).numpy()
    dense = tbcsr.bcsr_to_dense(J).numpy()
    JtJ = dense.T @ dense
    bn = s.block_cols
    assert np.all(sched.rows >= sched.cols)
    for k in range(sched.rows.shape[0]):
        i, j = int(sched.rows[k]), int(sched.cols[k])
        np.testing.assert_allclose(
            blocks[k], JtJ[i * bn:(i + 1) * bn, j * bn:(j + 1) * bn],
            rtol=1e-12, atol=1e-12)
    js = jbcsr.BCSRStructure(*s)
    jblocks = jbcsr.bcsr_jtj_lower_blocks(
        jbcsr.BCSRJacobian(structure=js, values=jnp.asarray(vals)),
        jbcsr.jtj_lower_schedule(js))
    np.testing.assert_allclose(blocks, np.asarray(jblocks), rtol=1e-12,
                               atol=1e-13)


def _banded_problem(xp):
    """test_bcsr.py's nonlinear block-banded problem, M g(p) - target with
    g = p + 0.3 sin p, in numpy arrays for both packages."""
    nbcol, bn, bm = 6, 2, 4
    rng = np.random.default_rng(8)
    indptr, indices, mblocks = [0], [], []
    for r in range(nbcol):
        cols = [r] + ([r + 1] if r + 1 < nbcol else [])
        indices.extend(cols)
        indptr.append(len(indices))
        for _ in cols:
            mblocks.append(rng.normal(size=(bm, bn)))
    fields = dict(nmeas=nbcol * bm, nstate=nbcol * bn, block_rows=bm,
                  block_cols=bn, indptr=np.asarray(indptr, np.int32),
                  indices=np.asarray(indices, np.int32))
    target = rng.normal(size=(nbcol * bm,))
    p0 = rng.normal(size=(nbcol * bn,)) * 0.5
    return fields, np.stack(mblocks), target, p0


def test_sparse_jtj_mode_end_to_end_matches_dense_and_jax():
    """SparseProblem(jtj="sparse") takes the trajectory of jtj="dense" on
    the nonlinear block-banded problem, and the JAX package's, and a
    vmapped batch of two starts takes each start's."""
    fields, mblocks, target, p0 = _banded_problem(np)
    nbcol, bn = 6, 2
    s = tbcsr.BCSRStructure(**fields)
    M = torch.as_tensor(mblocks)
    Md = tbcsr.bcsr_to_dense(tbcsr.BCSRJacobian(s, M))
    cols = torch.as_tensor(s.indices, dtype=torch.int64)
    tgt = torch.as_tensor(target)

    def f(p):
        g = p + 0.3 * torch.sin(p)
        gp = (1.0 + 0.3 * torch.cos(p)).reshape(nbcol, bn)
        return Md @ g - tgt, M * gp[cols][:, None, :]

    prm = tl.DoglegParameters()
    p0t = torch.as_tensor(p0)
    r_dense = tl.optimize(tl.SparseProblem(f=f, structure=s), p0t, prm)
    sparse = tl.SparseProblem(f=f, structure=s, jtj="sparse")
    r_sparse = tl.optimize(sparse, p0t, prm)
    assert int(r_sparse.step_count) == int(r_dense.step_count)
    np.testing.assert_allclose(r_sparse.p.numpy(), r_dense.p.numpy(),
                               rtol=1e-8, atol=1e-9)
    assert float(r_sparse.Jt_x.abs().max()) < 1e-7

    js = jbcsr.BCSRStructure(**fields)
    Mj = jnp.asarray(mblocks)
    Mdj = jnp.asarray(Md.numpy())
    colj = jnp.asarray(s.indices)

    def fj(p):
        g = p + 0.3 * jnp.sin(p)
        gp = (1.0 + 0.3 * jnp.cos(p)).reshape(nbcol, bn)
        return Mdj @ g - jnp.asarray(target), Mj * gp[colj][:, None, :]

    rj = jax.jit(lambda q: dl.optimize(
        JSparseProblem(f=fj, structure=js, jtj="sparse"), q,
        dl.DoglegParameters()))(jnp.asarray(p0))
    for field in ("step_count", "n_attempts", "reason"):
        assert int(getattr(r_sparse, field)) == int(getattr(rj, field))
    np.testing.assert_allclose(r_sparse.p.numpy(), np.asarray(rj.p),
                               rtol=1e-9, atol=1e-12)

    P0 = torch.stack([p0t, 0.5 * p0t])
    rb = batched_optimize(sparse.products, P0, prm,
                          newton_solver=sparse.default_newton_solver())
    for i in range(2):
        ri = tl.optimize(sparse, P0[i], prm)
        for field in ("step_count", "n_attempts", "reason"):
            assert int(getattr(rb, field)[i]) == int(getattr(ri, field))
        np.testing.assert_allclose(rb.p[i].numpy(), ri.p.numpy(),
                                   rtol=1e-12, atol=1e-14)


def test_sparse_refinement_tightens_f32_batch():
    """test_refinement.py's banded biharmonic system (cond ~5e5) in
    float32, as a batch of two right-hand sides: two refinement passes
    cut each element's error tenfold, below 5e-7, and each element's step
    is its single solve's."""
    rng = np.random.default_rng(2)
    nb, b = 10, 4
    n = nb * b
    rows, cols = zip(*[(i, j) for j in range(nb)
                       for i in range(j, min(nb, j + 3))])
    rows, cols = np.asarray(rows), np.asarray(cols)
    K = (np.diag(2.0 * np.ones(n)) + np.diag(-np.ones(n - 1), 1)
         + np.diag(-np.ones(n - 1), -1))
    A64 = np.float32(K @ K).astype(np.float64)
    blocks64 = np.stack([A64[i * b:(i + 1) * b, j * b:(j + 1) * b]
                         for i, j in zip(rows, cols)])
    b64 = np.float32(rng.normal(size=(2, n))).astype(np.float64)
    u64 = np.linalg.solve(A64, b64.T).T
    blocks = torch.as_tensor(np.stack([blocks64] * 2), dtype=torch.float32)
    rhs = torch.as_tensor(b64, dtype=torch.float32)
    lam = torch.zeros(2, dtype=torch.float32)
    sym = tl.SparseNewtonSolver.analyze(rows, cols, nb, b).symbolic

    def solve(iters):
        ns = tl.SparseNewtonSolver(sym, refine_iters=iters)
        r = ns.gauss_newton(blocks, rhs, lam, lambda_initial=1e-10,
                            lambda_max_tries=10)
        assert bool(r.ok.all())
        for i in range(2):
            one = ns.gauss_newton(blocks[i], rhs[i], lam[i],
                                  lambda_initial=1e-10, lambda_max_tries=10)
            assert torch.equal(one.step, r.step[i])
        return -r.step.double().numpy()

    def err(u):
        return np.abs(u - u64).max(-1) / np.abs(u64).max(-1)

    e0, e2 = err(solve(0)), err(solve(2))
    assert (e2 < e0 * 1e-1).all() and (e2 < 5e-7).all(), (e0, e2)
