"""The port's parallel layer (libdogleg_tpu_torch.parallel on
torch.distributed) against the JAX package's, on a group of four gloo
ranks.

One group of four processes (tests/torch_mesh_worker.py) runs every leg
once for the whole module, on inputs made here from numpy seeds; the JAX
package's unsharded results on the same inputs, in float64 on the CPU, are
the oracle (plus one JAX sharded single solve with History, for the vnlog
rows). Each test replays one JAX test: decisions identical, numbers within
the JAX test's own tolerance, DTensor results sharded on the batch axis,
and every rank's results bitwise equal to the others'.
"""

import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libdogleg_tpu as dl
import libdogleg_tpu.models.quadratic_surface as jsp
import torch_mesh_worker as worker
from libdogleg_tpu.parallel.batched import batched_optimize as jax_batched
from libdogleg_tpu_torch import diagnostics as td
from libdogleg_tpu_torch.solver import History

DECISIONS = ("step_count", "n_attempts", "reason")


def _grid():
    c = jsp.GRID_MIN + jsp.GRID_DELTA * np.arange(jsp.GRID_WIDTH)
    gx, gy = (a.ravel() for a in np.meshgrid(c, c, indexing="ij"))
    return gx, gy


def _instances(seed, batch):
    """batch measurement vectors and starts, the sample problem's
    distributions (uniform noise of 1 unit, starts in [-0.1, 0.9])."""
    rng = np.random.default_rng(seed)
    gx, gy = _grid()
    p = jsp.P_TRUE
    truth = (p[0] * p[1] * gx * gx + p[1] * p[2] * gy * gy + p[2] * gx * gy
             + p[3] * gx + p[4] * gy + p[5])
    meas = truth + rng.uniform(size=(batch, truth.size)) - 0.5
    return meas, rng.uniform(size=(batch, jsp.NSTATE)) - 0.1


def _multihost_inputs():
    """tests/multihost_worker.py's instances (its numpy seeds)."""
    out = {}
    rng = np.random.default_rng(7)
    nstate, nmeas, batch = 5, 32, 8
    A = rng.normal(size=(batch, nmeas, nstate))
    Bm = rng.normal(size=(batch, nstate, nstate)) * 0.5
    C = rng.normal(size=(batch, nmeas, nstate)) * 0.3
    p_true = rng.normal(size=(batch, nstate))
    d = (np.einsum('bms,bs->bm', A, np.tanh(np.einsum('bst,bt->bs',
                                                      Bm, p_true)))
         + np.einsum('bms,bs->bm', C, p_true)
         + rng.normal(size=(batch, nmeas)) * 0.05)
    out.update(A=A, Bm=Bm, C=C, d=d, p0s=rng.normal(size=(batch, nstate)))
    gx, gy = (np.asarray(a) for a in jsp.make_grid(jnp.float64))
    meas = np.asarray(jsp.model(jnp.asarray(jsp.P_TRUE), jnp.asarray(gx),
                                jnp.asarray(gy)))
    out["meas"] = meas + np.random.default_rng(3).normal(size=meas.shape) * .3
    out["p0"] = jsp.P_TRUE + np.random.default_rng(4).normal(size=6)
    rngc = np.random.default_rng(11)
    b, nbcol, nmeas_c = 2, 8, 64
    nstate_c = b * nbcol
    k = 6
    starts = (np.floor(np.arange(nmeas_c) * (nstate_c - k)
                       / (nmeas_c - 1)).astype(int) // b) * b
    cols = starts[:, None] + np.arange(k)[None, :]
    a_c = rngc.normal(size=(nmeas_c, k))
    w_c = rngc.normal(size=(nmeas_c, k)) * 0.5
    pt_c = rngc.normal(size=nstate_c)
    d_c = (a_c * np.tanh(w_c * pt_c[cols])).sum(1) \
        + rngc.normal(size=nmeas_c) * 0.02
    p0_c = rngc.normal(size=nstate_c)
    pat = set()
    for i in range(nmeas_c):
        blocks = np.unique(cols[i] // b)
        pat.update((int(r), int(c)) for r in blocks for c in blocks
                   if r >= c)
    pat.update((j, j) for j in range(nbcol))
    pat = sorted(pat)
    out.update(a_c=a_c, w_c=w_c, d_c=d_c, cols=cols.astype(np.int64),
               p0_c=p0_c,
               prows=np.array([r for r, _ in pat], np.int64),
               pcols=np.array([c for _, c in pat], np.int64))
    return {f"mh_{k}": v for k, v in out.items()}


def _grid_inputs():
    """test_parallel.py:291's 8x4x2 grid: dense J rows, the target and the
    stored lower JtJ pattern, from the JAX model."""
    from libdogleg_tpu.models import grid_mrf
    from libdogleg_tpu.ops.bcsr import jtj_lower_schedule
    m = grid_mrf.make_grid_mrf(width=8, height=4, block_size=2)
    x0, Jd = m.problem(jtj="dense").full(jnp.zeros(m.nstate))
    sched = jtj_lower_schedule(m.structure)
    return m, {"grid_J": np.asarray(Jd), "grid_target": -np.asarray(x0),
               "grid_rows": np.asarray(sched.rows, np.int64),
               "grid_cols": np.asarray(sched.cols, np.int64),
               "grid_b": np.array(m.block_size)}


def _pts_sparse():
    """test_parallel.py:334's instance and its start (jax.random key 4,
    jitter 0.02)."""
    from libdogleg_tpu.models import pinhole_ba
    ba = pinhole_ba.make_synthetic_sparse(seed=2, ncam=8, npts=160, k_obs=3)
    return ba, ba.p0(jax.random.PRNGKey(4), jitter=0.02)


def _inputs():
    inp = {}
    _, p0 = _pts_sparse()
    inp.update(pts_p0_c=np.asarray(p0["c"]), pts_p0_q=np.asarray(p0["q"]))
    meas, p0 = _instances(0, 1)
    inp.update(meas1=meas[0], p0_1=p0[0])
    _, inp["p0_32"] = _instances(3, 32)
    inp["meas_16"], inp["p0_16"] = _instances(4, 16)
    _, inp["p0_8"] = _instances(6, 8)
    inp["meas_128"], inp["p0_128"] = _instances(1, 128)
    inp["meas_64"], inp["p0_64"] = _instances(2, 64)
    inp.update(_multihost_inputs())
    grid, g = _grid_inputs()
    inp.update(g)
    return inp, grid


def _jax_products(p, m):
    gx, gy = jsp.make_grid(m.dtype)
    x = jsp.model(p, gx, gy) - m
    J = jsp.jacobian(p, gx, gy)
    return dl.solver.Products(norm2_x=x @ x, Jt_x=J.T @ x, JtJ=J.T @ J)


def _jax_refs(inp, grid):
    """The JAX package's results on the same inputs, float64 on the CPU:
    unsharded, but one sharded single solve with History (the vnlog
    leg)."""
    from libdogleg_tpu import DenseProblem, optimize
    from libdogleg_tpu.ops import dense as dops
    from libdogleg_tpu.parallel import MeasurementShardedProblem, make_mesh
    from libdogleg_tpu.solver import solve_products
    a = {k: jnp.asarray(v) for k, v in inp.items()}
    prm8 = dl.DoglegParameters(max_iterations=8)
    refs = {}
    dense = jsp.make_dense_problem(a["meas1"])
    refs["products"] = dense.products(a["p0_1"])
    refs["meas_solve"] = jax.jit(lambda q: optimize(dense, q, prm8))(
        a["p0_1"])
    gx, gy = jsp.make_grid(jnp.float64)

    def f_shard(p, data):
        gx_s, gy_s, m_s = data
        return jsp.model(p, gx_s, gy_s) - m_s, jsp.jacobian(p, gx_s, gy_s)
    sharded = MeasurementShardedProblem(
        f=f_shard, data=(gx, gy, a["meas1"]),
        mesh=make_mesh(("meas",), shape=(4,)), axis_name="meas")
    refs["vnlog"] = jax.jit(lambda q: solve_products(
        sharded.products, q, prm8, record_history=True))(a["p0_1"])
    refs["dp_shared"] = jax_batched(dense.products, a["p0_32"])
    refs["dp_data"] = jax_batched(_jax_products, a["p0_16"],
                                  problem_data=a["meas_16"])
    refs["dp_meas"] = jax_batched(dense.products, a["p0_8"])
    refs["b128"] = jax_batched(_jax_products, a["p0_128"], prm8,
                               problem_data=a["meas_128"],
                               use_megakernel=False)
    refs["stats"] = jax.vmap(jsp.factored_statistics)(
        a["meas_64"].astype(jnp.float32))
    sp_prob = grid.problem(jtj="sparse")
    refs["sparse"] = optimize(sp_prob, jnp.zeros(grid.nstate),
                              dl.DoglegParameters(),
                              newton_solver=sp_prob.default_newton_solver())

    def products(p, data):
        Ab, Bb, Cb, db = data
        t = jnp.tanh(Bb @ p)
        x = Ab @ t + Cb @ p - db
        J = Ab @ (((1.0 - t * t)[:, None]) * Bb) + Cb
        return dl.solver.Products(norm2_x=dops.norm2(x),
                                  Jt_x=dops.jt_dot(J, x),
                                  JtJ=dops.build_jtj(J))
    refs["legA"] = jax_batched(products, a["mh_p0s"], dl.DoglegParameters(),
                               problem_data=(a["mh_A"], a["mh_Bm"],
                                             a["mh_C"], a["mh_d"]))

    def f_dense(p):
        return (jsp.model(p, gx, gy) - a["mh_meas"], jsp.jacobian(p, gx, gy))
    refs["legB"] = jax.jit(lambda q: optimize(DenseProblem(f=f_dense), q))(
        a["mh_p0"])
    nstate_c = inp["mh_p0_c"].shape[0]

    def f_dense_c(p):
        t = jnp.tanh(a["mh_w_c"] * p[a["mh_cols"]])
        x = (a["mh_a_c"] * t).sum(1) - a["mh_d_c"]
        J = jnp.zeros((x.shape[0], nstate_c), p.dtype)
        J = jax.vmap(lambda row, c, v: row.at[c].set(v))(
            J, a["mh_cols"], a["mh_a_c"] * a["mh_w_c"] * (1.0 - t * t))
        return x, J
    refs["legC"] = jax.jit(lambda q: optimize(DenseProblem(f=f_dense_c),
                                              q))(a["mh_p0_c"])
    try:
        make_mesh(("dp",), shape=(16,))
    except ValueError as e:
        refs["mesh_error"] = str(e)
    refs.update(_jax_point_refs())
    return refs


def _jax_point_refs():
    """The unsharded JAX solves that test_parallel.py:155 and :334 hold
    their point-sharded solves to, with History: the linear instance in
    tree form, the sparse-visibility one plain and with refine_iters=2
    and a cam_gather."""
    import dataclasses

    from libdogleg_tpu.models import bundle_adjustment
    from libdogleg_tpu.ops.newton import build_cam_gather
    prm = dl.DoglegParameters()
    ba = bundle_adjustment.make_synthetic(seed=3, nc=8, n_points=64,
                                          block_size=3, k_obs=4,
                                          dtype=jnp.float64, noise=0.05)
    refs = {"pts_schur": jax.jit(lambda: dl.solve_products(
        ba.products_tree, ba.p0_tree(), prm,
        newton_solver=ba.tree_newton_solver(), record_history=True))()}
    sp, p0 = _pts_sparse()
    ns = sp.newton_solver()
    for leg, s in (("pts_sparse", ns),
                   ("pts_sparse_refine", dataclasses.replace(
                       ns, refine_iters=2, cam_gather=build_cam_gather(
                           np.asarray(sp.cam_of), sp.ncam)))):
        refs[leg] = jax.jit(lambda c, q, s=s: dl.solve_products(
            sp.products, {"c": c, "q": q}, prm, newton_solver=s,
            record_history=True))(p0["c"], p0["q"])
    return refs


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """The four ranks' outputs, the JAX references and the inputs. The
    group starts first and runs while JAX computes its references."""
    import threading
    tmp = tmp_path_factory.mktemp("mesh")
    inp, grid = _inputs()
    path = str(tmp / "inputs.npz")
    np.savez(path, **inp)
    box = {}

    def run():
        try:
            box["outs"] = worker.spawn_group(path, str(tmp), limit=300.0)
        except Exception as e:  # handed to the tests, which fail on it
            box["error"] = e
    th = threading.Thread(target=run)
    th.start()
    refs = _jax_refs(inp, grid)
    th.join()
    if "error" in box:
        raise box["error"]
    return box["outs"], refs, inp


@pytest.fixture(scope="module")
def world_of_one(tmp_path_factory):
    """tests/torch_mesh_worker.py's "one" leg in a process of its own, a
    world of one on gloo (hazard F19: no group inside pytest)."""
    tmp = tmp_path_factory.mktemp("one")
    _, p0 = _pts_sparse()
    path = str(tmp / "inputs.npz")
    np.savez(path, pts_p0_c=np.asarray(p0["c"]),
             pts_p0_q=np.asarray(p0["q"]))
    (out,) = worker.spawn_group(path, str(tmp), legs="one", world=1,
                                limit=120.0)
    return out


def _same_fields(got, want, rtol):
    """Two vnlog texts with the same lines and words, their numbers within
    rtol (nan where the other has nan)."""
    def fields(text):
        rows = []
        for line in text.strip().split("\n"):
            row = []
            for cell in re.split(r"[\s|/]+", line.strip()):
                if not cell:
                    continue
                try:
                    row.append(float(cell))
                except ValueError:
                    row.append(cell)
            rows.append(row)
        return rows
    g, w = fields(got), fields(want)
    assert len(g) == len(w)
    for rg, rw in zip(g, w):
        assert len(rg) == len(rw), (rg, rw)
        for a, b in zip(rg, rw):
            if isinstance(a, float) and isinstance(b, float):
                if np.isnan(b):
                    assert np.isnan(a)
                else:
                    np.testing.assert_allclose(a, b, rtol=rtol, atol=0)
            else:
                assert a == b, (rg, rw)


def _same_on_every_rank(outs, prefix):
    keys = [k for k in outs[0] if k.startswith(prefix + "/")]
    assert keys, prefix
    for o in outs[1:]:
        for k in keys:
            a, b = outs[0][k], o[k]
            assert a.dtype == b.dtype and a.shape == b.shape, k
            assert a.tobytes() == b.tobytes(), k


def _decisions_equal(out, leg, ref, fields=DECISIONS):
    for f in fields:
        np.testing.assert_array_equal(out[f"{leg}/{f}"],
                                      np.asarray(getattr(ref, f)), err_msg=f)


def _close(got, ref, rtol, atol=0.0):
    np.testing.assert_allclose(got, np.asarray(ref), rtol=rtol, atol=atol)


def test_mesh_has_4_ranks(group):
    """test_parallel.py:26: the mesh spans the group; a shape that needs
    more ranks raises the JAX package's message."""
    outs, refs, _ = group
    for r, o in enumerate(outs):
        assert int(o["mesh/size"]) == 4
        assert str(o["mesh/names"]) == "dp"
        assert o["mesh/coords"].tolist() == [r // 2, r % 2]
    assert str(outs[0]["mesh/error"]) == "mesh shape (8,) needs 8 devices, " \
        "have 4"
    template = re.sub(r"\d+", "N", refs["mesh_error"])
    assert re.sub(r"\d+", "N", str(outs[0]["mesh/error"])) == template
    assert len({str(o["mesh/error"]) for o in outs}) == 1
    for kw in (0, 1):
        assert str(outs[0][f"mesh/indivisible{kw}"]) == (
            "an axis of 6 does not divide over the 4 ranks of mesh axis "
            "'dp'")


def test_promotion_threshold_reads_the_global_batch():
    """K1's auto-promotion under a mesh: a rank's block of 256 of a global
    batch of 1024 is promoted, as the JAX package's threshold reads the
    global batch; the block alone is not. Meta tensors stand for the card
    (no process group needed)."""
    from libdogleg_tpu_torch.models import quadratic_surface as qs
    from libdogleg_tpu_torch.parallel import mega_auto
    from libdogleg_tpu_torch.solver import Products
    gx, gy = (torch.empty(100, device="meta") for _ in range(2))

    def products(p, m):
        x = qs.model(p, gx, gy) - m
        J = qs.jacobian(p, gx, gy)
        return Products(norm2_x=x @ x, Jt_x=J.T @ x, JtJ=J.T @ J)
    p0 = torch.empty((256, 6), device="meta")
    meas = torch.empty((256, 100), device="meta")
    assert mega_auto.plan_megakernel(products, p0, None,
                                     problem_data=meas) is None
    assert mega_auto.plan_megakernel(products, p0, None, problem_data=meas,
                                     global_batch=1024) is not None


@pytest.mark.parametrize("use_megakernel", [None, True])
def test_sharded_products_are_never_promoted(use_megakernel):
    """A measurement-sharded products function (a dp x meas batch) holds
    an all_reduce, which K1 cannot: auto-promotion refuses it without a
    trace, and use_megakernel=True raises, where the same per-element
    function unsharded is promoted. Meta tensors stand for the card; the
    wrapper is never called, so no process group is needed."""
    from libdogleg_tpu_torch.models import quadratic_surface as qs
    from libdogleg_tpu_torch.parallel import batched, mega_auto
    from libdogleg_tpu_torch.parallel.sharded import ShardedProducts
    from libdogleg_tpu_torch.solver import Products
    gx, gy = (torch.empty(100, device="meta") for _ in range(2))

    def products(p, m):
        x = qs.model(p, gx, gy) - m
        J = qs.jacobian(p, gx, gy)
        return Products(norm2_x=x @ x, Jt_x=J.T @ x, JtJ=J.T @ J)
    sharded = ShardedProducts(products, mesh=None, axis_name="meas")
    p0 = torch.empty((4096, 6), device="meta")
    meas = torch.empty((4096, 100), device="meta")
    args = (p0, None, meas, None, False, use_megakernel, 4096)
    before = mega_auto.trace_count
    if use_megakernel:
        with pytest.raises(ValueError, match="all_reduce"):
            batched._try_megakernel(sharded, *args)
    else:
        assert batched._try_megakernel(sharded, *args) is None
    assert mega_auto.trace_count == before
    assert batched._try_megakernel(products, *args) is not None


def test_measurement_sharded_products_match_dense(group):
    """test_parallel.py:49, with measurement_sharded_products giving the
    problem's bits."""
    outs, refs, _ = group
    for f in ("norm2_x", "Jt_x", "JtJ"):
        _close(outs[0][f"meas_products/{f}"], getattr(refs["products"], f),
               1e-12)
    assert bool(outs[0]["meas_products/same_as_problem"])
    _same_on_every_rank(outs, "meas_products")


def test_measurement_sharded_solve(group):
    """test_parallel.py:59: the sharded single solve takes the dense
    single solve's decisions."""
    outs, refs, _ = group
    o = outs[0]
    _decisions_equal(o, "meas_solve", refs["meas_solve"])
    _close(o["meas_solve/p"], refs["meas_solve"].p, 1e-9)
    assert int(o["meas_solve/step_count"]) <= 8
    np.testing.assert_allclose(o["meas_solve/p"], jsp.P_TRUE, atol=5e-2)
    _same_on_every_rank(outs, "meas_solve")


def test_sharded_solve_vnlog_rows(group):
    """test_reference_parity.py:97: the sharded single solve's vnlog rows
    are the JAX sharded solve's: iteration, step_accepted and step type
    identical, numbers within rtol 1e-9."""
    from libdogleg_tpu import diagnostics as jd
    outs, refs, _ = group
    o = outs[0]
    hist = History(**{f: torch.as_tensor(o[f"vnlog/history/{f}"])
                      for f in History._fields})
    rj = refs["vnlog"]
    _decisions_equal(o, "vnlog", rj)
    np.testing.assert_array_equal(o["vnlog/history/step_type"],
                                  np.asarray(rj.history.step_type))
    _same_fields(td.format_vnlog(hist, int(o["vnlog/n_attempts"])),
                 jd.format_vnlog(rj.history, rj.n_attempts), 1e-9)
    _same_on_every_rank(outs, "vnlog")


@pytest.mark.parametrize("leg", ["dp_shared", "dp_data"])
def test_batched_optimize_sharded(group, leg):
    """test_parallel.py:75 (shared measurements, 32 starts) and :90
    (each element its own measurements): the unsharded JAX decisions,
    DTensor results with Shard(0)."""
    outs, refs, _ = group
    o = outs[0]
    _decisions_equal(o, leg, refs[leg])
    _close(o[f"{leg}/p"], refs[leg].p, 1e-12, 1e-13)
    assert str(o[f"{leg}/placements"]) == "(Shard(dim=0),)"
    bound = 5e-2 if leg == "dp_shared" else 0.2
    assert np.all(np.abs(o[f"{leg}/p"] - jsp.P_TRUE) < bound)
    _same_on_every_rank(outs, leg)


def test_two_axis_mesh_dp_by_meas(group):
    """test_parallel.py:112: a (2, 2) dp x meas mesh, the starts over dp,
    each solve's rows over meas: one all_reduce a batch evaluation."""
    outs, refs, _ = group
    o = outs[0]
    _decisions_equal(o, "dp_meas", refs["dp_meas"])
    _close(o["dp_meas/p"], refs["dp_meas"].p, 1e-12, 1e-13)
    assert str(o["dp_meas/placements"]) == \
        "(Shard(dim=0), Replicate())"
    assert np.all(np.abs(o["dp_meas/p"] - jsp.P_TRUE) < 5e-2)
    _same_on_every_rank(outs, "dp_meas")


@pytest.mark.parametrize("leg", ["compact_4", "compact_64",
                                 "compact_adaptive", "plain_sharded"])
def test_batched_compaction_sharded(group, leg):
    """test_parallel.py:187 (both capacities, phase 1 of 3 attempts) and
    :218 (adaptive, and the plain sharded batch): the unsharded decisions
    on every element."""
    outs, refs, _ = group
    o = outs[0]
    _decisions_equal(o, leg, refs["b128"])
    _close(o[f"{leg}/p"], refs["b128"].p, 1e-12, 1e-13)
    if leg == "compact_adaptive":
        assert str(o[f"{leg}/placements"]) == "(Shard(dim=0),)"
    _same_on_every_rank(outs, leg)


@pytest.mark.parametrize("leg", ["minor", "compact_minor"])
def test_layout_minor_sharded(group, leg):
    """test_parallel.py:466 and :488: layout="minor" with the mesh."""
    outs, refs, _ = group
    o = outs[0]
    _decisions_equal(o, leg, refs["b128"])
    _close(o[f"{leg}/p"], refs["b128"].p, 1e-12, 1e-13)
    if leg == "minor":
        assert str(o[f"{leg}/placements"]) == "(Shard(dim=0),)"
    _same_on_every_rank(outs, leg)


@pytest.mark.parametrize("leg", ["mega_general", "mega_generated"])
def test_megakernel_sharded(group, leg):
    """test_pallas_mega.py:200 and test_mega_auto.py:108: K1 (its plain
    versions on the CPU) on each rank's block, the named general instance
    and the forced generated one; the unsharded decisions."""
    outs, refs, _ = group
    o = outs[0]
    _decisions_equal(o, leg, refs["b128"])
    _close(o[f"{leg}/p"], refs["b128"].p, 1e-10, 1e-12)
    if leg == "mega_general":
        assert str(o[f"{leg}/placements"]) == "(Shard(dim=0),)"
    _same_on_every_rank(outs, leg)


def test_megakernel_meas_sharded_staged(group):
    """test_pallas_mega.py:225: statistics over a (2, 2) dp x meas mesh
    summed over meas (their pair sums the unsharded ones), then K1's
    factored instance (its plain version) on the dp axis, float32."""
    outs, refs, _ = group
    o = outs[0]
    rh, rl, rn, rm = (np.asarray(t) for t in refs["stats"])
    np.testing.assert_allclose(o["staged/hh"] + o["staged/hl"], rh + rl,
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(o["staged/nh"] + o["staged/nl"], rn + rm,
                               rtol=1e-5, atol=1e-5)
    err = np.abs(o["staged/p"] - jsp.P_TRUE[None])
    assert float(np.mean(np.all(err < 0.2, axis=1))) >= 0.98
    assert np.all(o["staged/reason"] > 0)
    _same_on_every_rank(outs, "staged")


def test_measurement_sharded_sparse_jtj(group):
    """test_parallel.py:291: row-sharded measurements into the block-sparse
    JtJ (amalgamate 2), against the single-device simplicial sparse
    solve."""
    outs, refs, _ = group
    o = outs[0]
    _close(o["sparse/p"], refs["sparse"].p, 1e-9, 1e-11)
    assert int(o["sparse/step_count"]) == int(refs["sparse"].step_count)
    _same_on_every_rank(outs, "sparse")


@pytest.mark.parametrize("leg", ["legA", "legB", "legC"])
def test_multihost_legs(group, leg):
    """tests/multihost_worker.py's legs on the four ranks: A data-parallel
    (rtol 1e-12), B measurement-sharded dense (1e-9), C row-sharded
    block-sparse (1e-6, the sparse against the dense factorization); every
    rank's results bitwise equal."""
    outs, refs, _ = group
    o = outs[0]
    tol = {"legA": 1e-12, "legB": 1e-9, "legC": 1e-6}[leg]
    _close(o[f"{leg}/p"], refs[leg].p, tol, tol)
    np.testing.assert_array_equal(o[f"{leg}/step_count"],
                                  np.asarray(refs[leg].step_count))
    _same_on_every_rank(outs, leg)


def test_group_that_hangs_fails_within_its_limit(tmp_path):
    """Three ranks of a group of four: they wait for the fourth, and the
    group is killed at its wall limit, not left hanging (hazard F18)."""
    import time
    path = str(tmp_path / "inputs.npz")
    np.savez(path, **{"unused": np.zeros(1)})
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="did not end within"):
        worker.spawn_group(path, str(tmp_path), legs="ckpt", limit=10.0,
                           ranks=[0, 1, 2])
    assert time.monotonic() - t0 < 40


PTS_LEGS = ("pts_schur", "pts_sparse", "pts_sparse_refine")
# the points of each replayed instance and the ranks they are split over
PTS_POINTS = {"pts_schur": 64, "pts_sparse": 160, "pts_sparse_refine": 160}
RANKS = 4


@pytest.mark.parametrize("leg", PTS_LEGS)
def test_point_sharded_solve_matches_jax(group, leg):
    """test_parallel.py:155 (the linear instance, tree form) and :334 (the
    sparse-visibility instance with a solver of the unsharded one, plain
    and refined): points over a 4-rank 'pts' axis, the unsharded JAX
    solve's decisions and History step types, p within the JAX tests'
    rtol 1e-9, atol 1e-11, every rank the same bits of c, the whole q and
    every decision field, q sharded and c replicated."""
    outs, refs, _ = group
    o, rj = outs[0], refs[leg]
    _decisions_equal(o, leg, rj)
    np.testing.assert_array_equal(o[f"{leg}/history/step_type"],
                                  np.asarray(rj.history.step_type))
    _close(o[f"{leg}/c"], rj.p["c"], 1e-9, 1e-11)
    _close(o[f"{leg}/q"], rj.p["q"], 1e-9, 1e-11)
    assert str(o[f"{leg}/placements"]) == \
        "c (Replicate(),) q (Shard(dim=0),)"
    _same_on_every_rank(outs, leg)


@pytest.mark.parametrize("leg", PTS_LEGS)
def test_point_sharded_rank_holds_its_points(group, leg):
    """Each rank's JtJ holds its n_points / 4 point rows of V and of W or
    Wv (and cam_of), never the whole point axis; its q block is its rows
    of the whole q."""
    outs, _, _ = group
    n = PTS_POINTS[leg] // RANKS
    for r, o in enumerate(outs):
        shapes = {k.split("/")[1][:-len("_shape")]: tuple(v) for k, v in
                  o.items() if k.startswith(f"{leg}_local/")
                  and k.endswith("_shape")}
        assert shapes["V"][0] == n
        if "W" in shapes:
            assert shapes["W"][1] == n
        else:
            assert shapes["Wv"][0] == n and shapes["cam_of"][0] == n
        np.testing.assert_array_equal(o[f"{leg}_local/q"],
                                      o[f"{leg}/q"][r * n:(r + 1) * n])


def _expected_all_reduces(o, leg):
    """PERF.md section 3's count of a point-sharded solve's all_reduces:
    the start 1 (the gradient test), each products evaluation 1, each
    lambda try 1, each Gauss-Newton solve 2 + 2 refine_iters, and each
    attempt 3 (the expected improvement's dot and quadratic form, the
    small-step test), + 2 on a new point (the Cauchy step's norm and
    quadratic form), + 2 if interpolated, + 1 for an accepted trial's
    gradient test, + 1 for the History's direction change after an
    accepted step."""
    from libdogleg_tpu_torch.solver import StepType, StopReason
    n = int(o[f"{leg}/n_attempts"])
    acc = o[f"{leg}/history/step_accepted"][:n] == 1
    if int(o[f"{leg}/reason"]) == StopReason.SMALL_STEP:
        acc[-1] = False     # recorded as accepted, it evaluates nothing
    new_point = np.concatenate([[True], acc[:-1]])
    prev = (np.cumsum(acc) - acc) > 0
    interp = o[f"{leg}/history/step_type"][:n] == StepType.INTERPOLATED
    refine = 2 if leg.endswith("refine") else 0
    count = {k: int(o[f"{leg}_count/{k}"]) for k in ("products", "factor",
                                                    "gn")}
    return (1 + count["products"] + count["factor"]
            + count["gn"] * (2 + 2 * refine)
            + int((3 + 2 * new_point + 2 * interp + acc + prev).sum()))


@pytest.mark.parametrize("leg", PTS_LEGS)
def test_point_sharded_all_reduce_count(group, leg):
    """A point-sharded solve runs the all_reduces PERF.md states, each
    one all_reduce_sum call (sharded.all_reduce_calls), and no other
    collective: a dispatch mode around the solve sees c10d's allreduce_
    alone, as often, so no rank gathers point data (no all_gather, no
    DTensor full_tensor); the same count on every rank."""
    outs, _, _ = group
    for o in outs:
        calls = int(o[f"{leg}_count/all_reduce_calls"])
        assert calls == _expected_all_reduces(o, leg)
        assert o[f"{leg}_count/collectives"].tolist() == \
            ["c10d.allreduce_.default"]
        assert int(o[f"{leg}_count/collective_calls"]) == calls
    _same_on_every_rank(outs, f"{leg}_count")


def test_point_count_the_axis_does_not_divide_raises(group):
    """BAProblem.shard of 66 points over the 4 ranks raises, with the
    message of the JAX package's batch axes."""
    outs, _, _ = group
    for o in outs:
        assert str(o["pts_schur/indivisible"]) == (
            "an axis of 66 does not divide over the 4 ranks of mesh axis "
            "'pts'")


def test_sharded_instances_keep_global_sizes(group):
    """A point-sharded instance keeps the whole problem's sizes: points,
    states and measurements (observations) of the linear instance and of
    the sparse-visibility one."""
    outs, _, _ = group
    for o in outs:
        assert o["pts_sizes/schur"].tolist() == [64, 8 + 64 * 3, 64 * 4]
        assert o["pts_sizes/sparse"].tolist() == [160, 48 + 160 * 3,
                                                  160 * 3]


@pytest.mark.parametrize("masked", [0, 1])
def test_camera0_prior_counted_once(group, masked):
    """The sparse-visibility products at the start, point-sharded (with
    an obs_mask sharded too, masked=1) against the whole instance's: the
    cost, the camera gradient and U agree to rounding, so the replicated
    gauge prior on camera 0 entered once, not once a rank (its weight
    1e6 would move them by about 3e6 x its residual)."""
    outs, _, _ = group
    for o in outs:
        for f in ("norm2_x", "gc", "U"):
            _close(o[f"pts_prior/sharded{masked}/{f}"],
                   o[f"pts_prior/whole{masked}/{f}"], 1e-12, 1e-9)
    _same_on_every_rank(outs, "pts_prior")


@pytest.mark.parametrize("case", ["schur", "sparse", "sparse_refine"])
def test_point_sharded_world_of_one_bits(world_of_one, case):
    """A world of one: every all_reduce an identity, so the point-sharded
    solve gives the unsharded port solve's bits in every result field
    (History included), q a DTensor sharded over the axis."""
    o = world_of_one
    assert int(o["one/world"]) == 1
    assert bool(o[f"one/{case}/same_bits"])
    assert str(o[f"one/{case}/placements"]) == "(Shard(dim=0),)"


@functools.lru_cache(maxsize=None)
def _jax_outlierness(pc, pq, lam, n2):
    """JAX's unsharded get_outlierness_factors_ba of test_parallel.py:334's
    instance at a point given as bytes of float64 arrays (the port's
    sharded solution put together), its lam and norm2_x: (factors,
    scale), one jitted program."""
    from libdogleg_tpu.analysis import outlierness as ja
    ba, _ = _pts_sparse()
    nq = np.frombuffer(pq).reshape(ba.npts, 3)
    nmeas = 2 * ba.nobs + 6 + 3 * ba.npts

    def outl(c, q, lam, n2):
        p = {"c": c, "q": q}
        robs, Jc, Jq = ba.observation_jacobians(p)
        return ja.get_outlierness_factors_ba(
            robs, Jc, Jq, ba.products(p).JtJ, lam, n2, nmeas,
            ba.newton_solver(), chunk=16)
    f, scale = jax.jit(outl)(np.frombuffer(pc), nq,
                             np.frombuffer(lam)[0], np.frombuffer(n2)[0])
    return np.asarray(f), float(scale)


def test_point_sharded_outlierness_matches_jax(group):
    """test_parallel.py:334's instance at its point-sharded solution: the
    factors of get_outlierness_factors_ba over the 4 ranks' points (40 a
    rank, chunks of 16), put together, match the JAX package's unsharded
    pass at the same point within rtol 1e-7, atol 1e-10 (the tolerance of
    tests/test_torch_analysis.py's BA factors: S has cond ~1.7e8 and two
    float64 orders of summation differ by ~2e-8); the scale, which counts
    the global 160 points (hazard F22: a rank's 40 would make it about
    4.4 times as large), within 1e-15 and the same bits on every rank;
    the factors come back sharded over pts."""
    outs, _, _ = group
    o = outs[0]
    args = tuple(o[f"pts_outl/{k}"].astype(np.float64).tobytes()
                 for k in ("p_c", "p_q", "lam", "norm2_x"))
    fj, sj = _jax_outlierness(*args)
    assert np.isfinite(o["pts_outl/factors"]).all()
    np.testing.assert_allclose(o["pts_outl/factors"], fj, rtol=1e-7,
                               atol=1e-10)
    np.testing.assert_allclose(float(o["pts_outl/scale"]), sj, rtol=1e-15)
    for other in outs:
        assert str(other["pts_outl_local/placements"]) == "(Shard(dim=0),)"
    _same_on_every_rank(outs, "pts_outl")


def test_point_sharded_outlierness_all_reduces_and_reuse(group):
    """A fresh pass over sharded points runs one all_reduce (S and the
    point blocks' ok, in the strategy's factor), a pass given the
    strategy's sharded factor none; the reused factor gives the fresh
    pass's bits on every rank."""
    outs, _, _ = group
    for o in outs:
        assert int(o["pts_outl_count/fresh"]) == 1
        assert int(o["pts_outl_count/reused"]) == 0
        assert bool(o["pts_outl_local/reuse_same"])


@pytest.mark.parametrize("case", ["fresh", "reused"])
def test_point_sharded_outlierness_world_of_one_bits(world_of_one, case):
    """A world of one: the outlierness pass over the sharded solution,
    fresh and reusing the sharded factor, gives the unsharded pass's bits
    in every factor and in the scale."""
    assert bool(world_of_one[f"one/outl/{case}_same_bits"])


def test_point_shards_reads_each_leaf_on_its_point_axis(world_of_one):
    """point_shards takes a SchurJtJ's W sharded on its axis 1 (its point
    axis) and V on its axis 0, and refuses V on axis 1 and W on axis 0,
    naming the placement."""
    errors = world_of_one["one/placement_errors"].tolist()
    assert "point axis (0)" in errors[0] and "Shard(dim=1)" in errors[0]
    assert "point axis (1)" in errors[1] and "Shard(dim=0)" in errors[1]
    assert errors[2] == "pts Tensor"


def test_shards_keyword_on_local_leaves(world_of_one):
    """The `shards=` keyword of init_solver_state and run_solver, on local
    leaves with the strategy's shards set by the caller, gives the bits of
    the solve that reads the sharding from its DTensor start."""
    assert bool(world_of_one["one/keyword/same_bits"])
