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


def _inputs():
    inp = {}
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
