"""Ahead-of-time export (libdogleg_tpu_torch/export.py) against the JAX
package's, in float64 on the CPU: tests/test_export.py's four cases
replayed on the same inputs (numpy arrays given to both packages), and the
pieces the traced solve is made of.

For each case the artifact, saved and loaded, takes the JAX package's
decisions (step_count, n_attempts, reason) and those of the port's eager
solve; p agrees with JAX's to rtol 1e-10, atol 1e-12 (the port's standing
tolerance, summation orders differ), and equals the same traced loop run
eagerly bit for bit (as JAX's test holds its artifact to the live jit).
The JAX side is jitted once per case and cached for the module.
"""

import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

import libdogleg_tpu as dl
import libdogleg_tpu.models.quadratic_surface as jsp
from libdogleg_tpu.models import grid_mrf as jgrid
from libdogleg_tpu.models import pinhole_ba as jpb
import libdogleg_tpu_torch as tl
import libdogleg_tpu_torch.models.quadratic_surface as tsp
from libdogleg_tpu_torch import export as tex
from libdogleg_tpu_torch import interop
from libdogleg_tpu_torch.models import grid_mrf as tgrid
from libdogleg_tpu_torch.models import pinhole_ba as tpb
from libdogleg_tpu_torch.ops import batchchol, bcsr_kernels, tilechol
from libdogleg_tpu_torch.ops import cholesky as tchol
from libdogleg_tpu_torch.ops import traced

torch.set_num_threads(1)
PRM = dict(max_iterations=8)
BATCH = 16
DECISIONS = ("step_count", "n_attempts", "reason")


def _instance(seed, batch=None):
    """The sample problem's measurements and start(s), from numpy."""
    rng = np.random.default_rng(seed)
    c = jsp.GRID_MIN + jsp.GRID_DELTA * np.arange(jsp.GRID_WIDTH)
    gx, gy = (a.ravel() for a in np.meshgrid(c, c, indexing="ij"))
    p = jsp.P_TRUE
    truth = (p[0] * p[1] * gx * gx + p[1] * p[2] * gy * gy + p[2] * gx * gy
             + p[3] * gx + p[4] * gy + p[5])
    meas = truth + rng.uniform(size=truth.shape) - 0.5
    shape = (jsp.NSTATE,) if batch is None else (batch, jsp.NSTATE)
    return meas, rng.uniform(size=shape) - 0.1


def _roundtrip(tmp_path, exp, p0, name="solver.pt2"):
    path = str(tmp_path / name)
    tex.save_exported(path, exp)
    assert os.path.getsize(path) > 0
    return tex.load_exported(path).call(p0)


def _numpy(t):
    return {k: _numpy(v) for k, v in t.items()} if isinstance(t, dict) \
        else t.detach().numpy()


def _assert_case(r, r_eager, r_jax, r_loop, p_of=lambda r: r.p):
    """The artifact's result r against the port's eager solve, JAX's live
    solve and the traced loop run eagerly."""
    for field in DECISIONS:
        got = getattr(r, field).numpy()
        np.testing.assert_array_equal(got, np.asarray(getattr(r_jax, field)),
                                      err_msg=field)
        np.testing.assert_array_equal(got, getattr(r_eager, field).numpy(),
                                      err_msg=field)
    got, want = _numpy(p_of(r)), jax.device_get(p_of(r_jax))
    for g, w, loop in zip(jax.tree_util.tree_leaves(got),
                          jax.tree_util.tree_leaves(want),
                          jax.tree_util.tree_leaves(_numpy(p_of(r_loop)))):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-10, atol=1e-12)
        np.testing.assert_array_equal(g, loop)


# --- the sample problem: single, batched, sparse ----------------------------


@functools.lru_cache(maxsize=None)
def _jax_single(kind):
    meas, p0 = _instance(1)
    make = jsp.make_dense_problem if kind == "dense" else \
        jsp.make_sparse_problem
    prob = make(jnp.asarray(meas))
    ns = None if kind == "dense" else prob.default_newton_solver()
    return jax.jit(lambda q: dl.optimize(
        prob, q, dl.DoglegParameters(**PRM), newton_solver=ns))(
        jnp.asarray(p0))


def _torch_problem(kind, meas):
    make = tsp.make_dense_problem if kind == "dense" else \
        tsp.make_sparse_problem
    return make(torch.as_tensor(meas))


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_export_single_matches_jax(tmp_path, kind):
    """tests/test_export.py's single round trip (dense) and its sparse
    problem with default_newton_solver()."""
    meas, p0 = _instance(1)
    prob, p0 = _torch_problem(kind, meas), torch.as_tensor(p0)
    prm = tl.DoglegParameters(**PRM)
    ns = prob.default_newton_solver() if kind == "sparse" else None
    exp = tex.export_solver(prob.products, nstate=tsp.NSTATE, parameters=prm,
                            dtype=torch.float64, newton_solver=ns,
                            device="cpu")
    r = _roundtrip(tmp_path, exp, p0)
    assert r.p.shape == (tsp.NSTATE,) and r.step_count.shape == ()
    flat = tex.flatten_products(prob.products, p0[None], batched=False)
    loop = tex.solve_traced(flat, p0, prm, newton_solver=ns, batched=False)
    _assert_case(r, tl.optimize(prob, p0, prm, newton_solver=ns),
                 _jax_single(kind), loop)


def _torch_products(meas):
    gx, gy = tsp.make_grid(torch.float64, "cpu")

    def products(p):
        x = tsp.model(p, gx, gy) - meas
        J = tsp.jacobian(p, gx, gy)
        return tl.Products(norm2_x=x @ x, Jt_x=J.T @ x, JtJ=J.T @ J)
    return products


@functools.lru_cache(maxsize=None)
def _jax_batched(nan_at=None):
    meas, p0 = _instance(2, BATCH)
    if nan_at is not None:
        p0[nan_at] = np.nan
    gx, gy = jsp.make_grid(jnp.float64)
    m = jnp.asarray(meas)

    def products(p):
        x = jsp.model(p, gx, gy) - m
        J = jsp.jacobian(p, gx, gy)
        return dl.Products(norm2_x=x @ x, Jt_x=J.T @ x, JtJ=J.T @ J)
    prm = dl.DoglegParameters(**PRM)
    return jax.jit(jax.vmap(lambda q: dl.solve_products(products, q, prm)))(
        jnp.asarray(p0))


@pytest.fixture(scope="module")
def batched_artifact(tmp_path_factory):
    """outputs -> (program, its products, the artifact saved and loaded):
    the batched artifact (B = 16), exported and round-tripped once."""
    meas, _ = _instance(2, BATCH)
    products = _torch_products(torch.as_tensor(meas))
    made = {}

    def get(outputs="full"):
        if outputs not in made:
            exp = tex.export_solver(
                products, nstate=tsp.NSTATE,
                parameters=tl.DoglegParameters(**PRM), batch_size=BATCH,
                dtype=torch.float64, device="cpu", outputs=outputs)
            path = str(tmp_path_factory.mktemp("batched") / "a.pt2")
            tex.save_exported(path, exp)
            made[outputs] = (exp, products, path,
                             tex.load_exported(path))
        return made[outputs]
    return get


def _batched(batched_artifact, nan_at=None, outputs="full"):
    _, p0 = _instance(2, BATCH)
    if nan_at is not None:
        p0[nan_at] = np.nan
    p0 = torch.as_tensor(p0)
    _, products, _, solver = batched_artifact(outputs)
    prm = tl.DoglegParameters(**PRM)
    r = solver.call(p0)
    eager = tl.solve_products_batched(torch.func.vmap(products), p0, prm)
    loop = tex.solve_traced(tex.flatten_products(products, p0), p0, prm)
    return r, eager, loop


def test_export_batched_matches_jax(batched_artifact):
    """tests/test_export.py's batched round trip, B = 16."""
    r, eager, loop = _batched(batched_artifact)
    assert r.p.shape == (BATCH, tsp.NSTATE)
    _assert_case(r, eager, _jax_batched(), loop)
    assert bool((r.reason > 0).all())


def test_export_outputs_p(batched_artifact):
    """outputs="p" returns the solution alone, the full result's bits."""
    p, _, loop = _batched(batched_artifact, outputs="p")
    assert isinstance(p, torch.Tensor) and p.shape == (BATCH, tsp.NSTATE)
    full, _, _ = _batched(batched_artifact)
    assert torch.equal(p, full.p) and torch.equal(p, loop.p)


def test_export_nan_start_in_batch(batched_artifact):
    """F7: a NaN start in a batch reaches no other element, which keeps its
    decisions; the NaN element's reason is the eager solve's (and JAX's)."""
    nan_at = 3
    r, eager, loop = _batched(batched_artifact, nan_at=nan_at)
    clean, _, _ = _batched(batched_artifact)
    others = np.arange(BATCH) != nan_at
    for field in DECISIONS:
        got = getattr(r, field).numpy()
        np.testing.assert_array_equal(got, getattr(eager, field).numpy())
        np.testing.assert_array_equal(got[others],
                                      getattr(clean, field).numpy()[others])
        np.testing.assert_array_equal(
            got, np.asarray(getattr(_jax_batched(nan_at), field)))
    assert torch.equal(r.p[others], clean.p[others])
    assert torch.equal(r.p[others], loop.p[others])
    assert bool(r.p[nan_at].isnan().all() and loop.p[nan_at].isnan().all())


# --- bundle adjustment: a tree state with a structured JtJ -----------------


@functools.lru_cache(maxsize=None)
def _jax_ba():
    ba = jpb.make_synthetic_sparse(seed=1, ncam=6, npts=80, k_obs=3)
    q0 = ba.p0(jax.random.PRNGKey(3), jitter=0.02)
    r = jax.jit(lambda p: dl.solve_products(
        ba.products, p, dl.DoglegParameters(),
        newton_solver=ba.newton_solver()))(q0)
    return ba, jax.device_get(q0), r


def test_export_pytree_state_ba(tmp_path):
    """tests/test_export.py's tree-state case: sparse-visibility pinhole BA
    ({"c", "q"} state, SparseWSchurJtJ in the result)."""
    jba, q0, r_jax = _jax_ba()
    ba = interop.pinhole_ba_from_reference(jba, device="cpu")
    p0 = interop.tree_from_numpy(dict(q0), device="cpu")
    prm, ns = tl.DoglegParameters(), ba.newton_solver()
    shapes = {k: tuple(v.shape) for k, v in p0.items()}
    exp = tex.export_solver(ba.products, nstate=shapes, parameters=prm,
                            dtype=torch.float64, newton_solver=ns,
                            device="cpu")
    r = _roundtrip(tmp_path, exp, p0)
    assert type(r.JtJ).__name__ == "SparseWSchurJtJ"
    pb = {k: v[None] for k, v in p0.items()}
    flat = tex.flatten_products(ba.products, pb, batched=False)
    loop = tex.solve_traced(flat, p0, prm, newton_solver=ns, batched=False)
    _assert_case(r, tl.solve_products(ba.products, p0, prm,
                                      newton_solver=ns), r_jax, loop)


# --- a fresh process, and the caches a trace passes through ----------------


_CHILD = """
import sys, torch
from libdogleg_tpu_torch.export import load_exported
r = load_exported(sys.argv[1]).call(torch.load(sys.argv[2]))
torch.save(r, sys.argv[3])
bad = [m for m in sys.modules if m.split(".")[0] in (
    "jax", "libdogleg_tpu", "tests", "test_torch_export", "chip_smoke")]
sys.exit(3 if bad else 0)
"""


def test_export_loads_in_a_fresh_process(tmp_path, batched_artifact):
    """A fresh interpreter loads and runs the artifact importing only
    libdogleg_tpu_torch.export: not the module the problem was written in
    (this one), not jax."""
    _, p0 = _instance(2, BATCH)
    p0 = torch.as_tensor(p0)
    exp, _, art, _ = batched_artifact()
    start, out = (str(tmp_path / n) for n in ("p0.pt", "r.pt"))
    torch.save(p0, start)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    proc = subprocess.run([sys.executable, "-c", _CHILD, art, start, out],
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    got = torch.load(out, weights_only=False)
    want = exp.module()(p0)
    for field in ("p",) + DECISIONS:
        assert torch.equal(getattr(got, field), getattr(want, field)), field


@functools.lru_cache(maxsize=None)
def _jax_grid():
    m = jgrid.make_grid_mrf(4, 4, 5)
    prob = m.problem(jtj="sparse")
    return m, jax.jit(lambda q: dl.optimize(
        prob, q, dl.DoglegParameters(**PRM)))(jnp.zeros(m.nstate))


def test_eager_sparse_solve_after_export(tmp_path):
    """Finding 5: the trace leaves no fake tensor in the index caches, so
    an eager sparse solve of the exported problem gives its bits after the
    export; the artifact takes JAX's decisions on the block-sparse path
    (SparseNewtonSolver, supernodal as config 6's)."""
    m, r_jax = _jax_grid()

    def problem():
        g = interop.grid_mrf_from_reference(m, device="cpu")
        return tl.SparseProblem(f=g.problem(jtj="dense").f,
                                structure=g.structure, jtj="sparse",
                                amalgamate=4)
    prm = tl.DoglegParameters(**PRM)
    p0 = torch.zeros(m.nstate, dtype=torch.float64)
    fresh = problem()
    want = tl.optimize(fresh, p0, prm)
    prob = problem()
    ns = prob.default_newton_solver()
    exp = tex.export_solver(prob.products, nstate=m.nstate, parameters=prm,
                            dtype=torch.float64, newton_solver=ns,
                            device="cpu")
    after = tl.optimize(prob, p0, prm)
    for field in ("p",) + DECISIONS:
        assert torch.equal(getattr(after, field), getattr(want, field))
    r = _roundtrip(tmp_path, exp, p0)
    flat = tex.flatten_products(prob.products, p0[None], batched=False)
    loop = tex.solve_traced(flat, p0, prm, newton_solver=ns, batched=False)
    _assert_case(r, want, r_jax, loop)


# --- the pieces: the operators, the traced escalation, the flattening ------


def _fake_vs_plain(op, plain, *args):
    """The operator under FakeTensorMode gives the plain version's output
    shapes and dtypes on the same inputs."""
    want = plain(*args)
    with FakeTensorMode() as mode:
        fake = [mode.from_tensor(a) if isinstance(a, torch.Tensor) else a
                for a in args]
        got = op(*fake)
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (tuple(g.shape), g.dtype) == (tuple(w.shape), w.dtype)


def _spd(k, n, seed, dtype=torch.float64):
    g = torch.Generator().manual_seed(seed)
    a = torch.randn(k, n, n, generator=g, dtype=dtype)
    return a @ a.mT + n * torch.eye(n, dtype=dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_register_fake_shapes(dtype):
    """register_fake of K3, K5, K6 and K7 gives the plain versions' shapes
    and dtypes."""
    A = _spd(3, 40, 0, dtype)
    _fake_vs_plain(batchchol._op, batchchol.batched_blocked_cholesky_reference,
                   A)
    T = _spd(5, 24, 1, dtype)
    _fake_vs_plain(tilechol._tile_cholesky_op,
                   tilechol.tile_cholesky_reference, T)
    L = torch.linalg.cholesky(T)
    C = torch.randn(5, 7, 24, dtype=dtype)
    _fake_vs_plain(tilechol._tri_solve_right_op,
                   tilechol.tri_solve_right_reference, L, C)
    g = tgrid.make_grid_mrf(3, 3, 2, dtype=dtype, device="cpu")
    sched = tl.SparseProblem(f=None, structure=g.structure,
                             jtj="sparse")._jtj_sched
    values = torch.randn((2,) + (g.structure.nnzb, 2, 2), dtype=dtype)
    ops = torch.as_tensor(bcsr_kernels._jtj_operands(sched))
    npairs, nout = len(sched.pair_i), bcsr_kernels._nout(sched)
    _fake_vs_plain(bcsr_kernels._jtj_op,
                   lambda v, o, n1, n2: torch.func.vmap(
                       lambda x: bcsr_kernels.jtj_pair_sum(
                           x, sched.pair_i, sched.pair_j, sched.out_idx,
                           n2))(v), values, ops, npairs, nout)


def _escalation_case(traced_form, lambda_max_tries):
    """A batch with an SPD element, two singular ones (escalating a few
    times) and an indefinite one that needs many tries."""
    n = 5
    A = _spd(4, n, 2)
    u = torch.randn(n, 2, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(3))
    A[1] = u @ u.T                                       # rank 2
    A[2] = torch.zeros(n, n, dtype=torch.float64)        # rank 0
    A[3] = A[3] - 1e-3 * torch.eye(n, dtype=torch.float64) * 1e6
    active = torch.tensor([True, True, True, True])

    def run(lam):
        def try_factor(lm):
            return tchol._try_factor(A, lm)
        return tchol.escalating_lambda(try_factor, lam, lambda_initial=1e-10,
                                       lambda_max_tries=lambda_max_tries,
                                       active=active)
    lam0 = torch.zeros(4, dtype=torch.float64)
    if not traced_form:
        return run(lam0)

    class M(torch.nn.Module):
        def forward(self, lam):
            with tchol.traced_loops():
                return run(lam)
    with tchol.traced_loops():
        eager_traced = run(lam0)
    exported = torch.export.export(M(), (lam0,)).module()(lam0)
    return eager_traced, exported


@pytest.mark.parametrize("tries", [60, 5])
def test_traced_escalating_lambda(tries):
    """The traced escalation takes the eager form's lambda and ok, run
    eagerly and exported, with elements that escalate and, at 5 tries,
    one that hits the lambda_max_tries cap."""
    L, lam, ok = _escalation_case(False, tries)
    assert bool(ok[:3].all())
    assert bool(ok[3]) == (tries == 60)
    for L2, lam2, ok2 in _escalation_case(True, tries):
        assert torch.equal(lam2, lam) and torch.equal(ok2, ok)
        assert torch.equal(L2[ok], L[ok])


def test_flatten_jacfwd_bits():
    """make_fx of vmap(jacfwd(project)) gives the eager Jacobians' bits."""
    from torch.fx.experimental.proxy_tensor import make_fx
    g = torch.Generator().manual_seed(4)
    cams = 0.1 * torch.randn(9, 6, dtype=torch.float64, generator=g)
    pts = torch.randn(9, 3, dtype=torch.float64, generator=g)
    pts[:, 2] += 5.0
    jac = torch.func.vmap(torch.func.jacfwd(
        lambda c, q: tpb.project(c, q, 500.0), argnums=(0, 1)))
    flat = make_fx(lambda c, q: jac(c, q), tracing_mode="real")(cams, pts)
    cams2 = cams + 0.01
    for got, want in zip(flat(cams2, pts), jac(cams2, pts)):
        assert torch.equal(got, want)


def test_traced_cond_hoists_constants():
    """A branch closing over a real tensor exports and saves: the constant
    becomes an input of the cond."""
    k = torch.arange(4, dtype=torch.float64)

    class M(torch.nn.Module):
        def forward(self, x):
            return traced.cond(x.sum() > 0, lambda y: (y + k,),
                               lambda y: (y - k,), (x,))[0]
    x = torch.ones(4, dtype=torch.float64)
    exp = torch.export.export(M(), (x,))
    for s in (1.0, -1.0):
        assert torch.equal(exp.module()(s * x), M()(s * x))
