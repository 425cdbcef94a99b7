"""One rank of the port's parallel layer on a gloo process group.

Launched by tests/test_torch_parallel.py and tests/test_torch_parallel_ckpt.py
(not collected by pytest itself), four ranks at once:

    python tests/torch_mesh_worker.py --rank R --world 4 --port P \
        --inputs in.npz --out out_R.npz --legs all|ckpt

Imports torch, numpy and libdogleg_tpu_torch only. Reads its inputs (made
from numpy seeds by the parent) from in.npz, runs every leg on CPU tensors
in float64 unless named, and writes what each leg gives (whole tensors:
DTensors gathered with full_tensor) to out_R.npz; the parent holds them to
the JAX package's unsharded results and the four ranks' files to each
other, bit for bit. Every process group has a 60 s timeout; the parent
kills the group at its own wall limit.
"""

import argparse
import dataclasses
import datetime
import os
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

F64 = torch.float64
# the float32 stopping rule of the JAX package's benchmarks (bench_all.py:46)
PRM = dict(max_iterations=10, Jt_x_threshold=1e-3, update_threshold=1e-5,
           trustregion_threshold=1e-5)


def _np(t):
    from torch.distributed.tensor import DTensor
    if isinstance(t, DTensor):
        t = t.full_tensor()
    return t.detach().cpu().numpy()


def _result(out, leg, r, fields=("p", "step_count", "n_attempts",
                                 "reason")):
    for f in fields:
        out[f"{leg}/{f}"] = _np(getattr(r, f))
    if getattr(r, "history", None) is not None:
        for name, v in r.history._asdict().items():
            out[f"{leg}/history/{name}"] = _np(v)


def _placements(out, leg, t):
    out[f"{leg}/placements"] = np.array(str(tuple(t.placements)))


def qs_products():
    from libdogleg_tpu_torch.models import quadratic_surface as qs
    from libdogleg_tpu_torch.solver import Products
    gx, gy = qs.make_grid(F64, "cpu")

    def products(p, m):
        x = qs.model(p, gx, gy) - m
        J = qs.jacobian(p, gx, gy)
        return Products(norm2_x=x @ x, Jt_x=J.T @ x, JtJ=J.T @ J)
    return products


def qs_f_shard(p, data):
    from libdogleg_tpu_torch.models import quadratic_surface as qs
    gx_s, gy_s, m_s = data
    return qs.model(p, gx_s, gy_s) - m_s, qs.jacobian(p, gx_s, gy_s)


def leg_mesh(inp, out):
    from libdogleg_tpu_torch.parallel import make_mesh
    mesh = make_mesh(("dp",), device_type="cpu")
    out["mesh/size"] = np.array(mesh.size())
    out["mesh/names"] = np.array(",".join(mesh.mesh_dim_names))
    try:
        make_mesh(("dp",), shape=(8,), device_type="cpu")
        out["mesh/error"] = np.array("")
    except ValueError as e:
        out["mesh/error"] = np.array(str(e))
    mesh2 = make_mesh(("dp", "meas"), shape=(2, 2), device_type="cpu")
    out["mesh/coords"] = np.array([mesh2.get_local_rank("dp"),
                                   mesh2.get_local_rank("meas")])
    # a batch the axis does not divide raises, K1 forced or not
    from libdogleg_tpu_torch.models import quadratic_surface as qs
    from libdogleg_tpu_torch.parallel import batched_optimize
    p6 = torch.as_tensor(inp["p0_8"][:6])
    m6 = torch.as_tensor(inp["meas_16"][:6])
    for kw in ({}, {"use_megakernel": True}):
        try:
            batched_optimize(qs.products, p6, problem_data=m6, mesh=mesh,
                             **kw)
            out[f"mesh/indivisible{len(kw)}"] = np.array("")
        except ValueError as e:
            out[f"mesh/indivisible{len(kw)}"] = np.array(str(e))


def leg_measurement(inp, out):
    from libdogleg_tpu_torch import DoglegParameters, optimize
    from libdogleg_tpu_torch.models import quadratic_surface as qs
    from libdogleg_tpu_torch.parallel import (MeasurementShardedProblem,
                                              make_mesh,
                                              measurement_sharded_products)
    from libdogleg_tpu_torch.solver import solve_products
    mesh = make_mesh(("meas",), device_type="cpu")
    gx, gy = qs.make_grid(F64, "cpu")
    meas = torch.as_tensor(inp["meas1"])
    p0 = torch.as_tensor(inp["p0_1"])
    problem = MeasurementShardedProblem(f=qs_f_shard, data=(gx, gy, meas),
                                        mesh=mesh, axis_name="meas")
    pr = problem.products(p0)
    for f in pr._fields:
        out[f"meas_products/{f}"] = _np(getattr(pr, f))
    fn = measurement_sharded_products(qs_f_shard, mesh, "meas")
    pr2 = fn(p0, (gx, gy, meas))
    out["meas_products/same_as_problem"] = np.array(all(
        torch.equal(a, b) for a, b in zip(pr, pr2)))
    r = optimize(problem, p0, DoglegParameters(max_iterations=8))
    _result(out, "meas_solve", r)
    # the vnlog leg: the sharded single solve with History
    rh = solve_products(problem.products, p0,
                        DoglegParameters(max_iterations=8),
                        record_history=True)
    _result(out, "vnlog", rh)


def leg_dp(inp, out):
    from libdogleg_tpu_torch import DoglegParameters
    from libdogleg_tpu_torch.models import quadratic_surface as qs
    from libdogleg_tpu_torch.parallel import (MeasurementShardedProblem,
                                              batched_optimize, make_mesh,
                                              shard_batch)
    mesh = make_mesh(("dp",), device_type="cpu")
    # test_parallel.py:75: shared measurements, 32 starts
    meas = torch.as_tensor(inp["meas1"])
    problem = qs.make_dense_problem(meas)
    r = batched_optimize(problem.products,
                         shard_batch(torch.as_tensor(inp["p0_32"]), mesh),
                         mesh=mesh)
    _placements(out, "dp_shared", r.p)
    _result(out, "dp_shared", r)
    # :90: per-element data
    r = batched_optimize(qs_products(),
                         shard_batch(torch.as_tensor(inp["p0_16"]), mesh),
                         mesh=mesh, problem_data=shard_batch(
                             torch.as_tensor(inp["meas_16"]), mesh))
    _placements(out, "dp_data", r.p)
    _result(out, "dp_data", r)
    # :112: a (2, 2) dp x meas mesh over a batch of starts
    mesh2 = make_mesh(("dp", "meas"), shape=(2, 2), device_type="cpu")
    gx, gy = qs.make_grid(F64, "cpu")
    sharded = MeasurementShardedProblem(f=qs_f_shard, data=(gx, gy, meas),
                                        mesh=mesh2, axis_name="meas")
    r = batched_optimize(sharded.products, torch.as_tensor(inp["p0_8"]),
                         mesh=mesh2, axis_name="dp")
    _placements(out, "dp_meas", r.p)
    _result(out, "dp_meas", r)


def leg_compaction(inp, out):
    from libdogleg_tpu_torch import DoglegParameters
    from libdogleg_tpu_torch.parallel import (batched_optimize,
                                              batched_optimize_compacted,
                                              make_mesh, shard_batch)
    mesh = make_mesh(("dp",), device_type="cpu")
    products = qs_products()
    p0 = torch.as_tensor(inp["p0_128"])
    meas = torch.as_tensor(inp["meas_128"])
    prm = DoglegParameters(max_iterations=8)
    p0_s, meas_s = shard_batch((p0, meas), mesh)
    for frac in (4, 64):
        r = batched_optimize_compacted(products, p0_s, prm,
                                       problem_data=meas_s, mesh=mesh,
                                       phase1_attempts=3,
                                       compact_capacity=128 // frac)
        _result(out, f"compact_{frac}", r)
    r = batched_optimize_compacted(products, p0_s, prm, problem_data=meas_s,
                                   mesh=mesh)
    _placements(out, "compact_adaptive", r.p)
    _result(out, "compact_adaptive", r)
    r = batched_optimize(products, p0, prm, problem_data=meas, mesh=mesh)
    _result(out, "plain_sharded", r)
    # :466, :488: layout="minor" with the mesh
    r = batched_optimize(products, p0_s, prm, problem_data=meas_s,
                         mesh=mesh, layout="minor")
    _placements(out, "minor", r.p)
    _result(out, "minor", r)
    r = batched_optimize_compacted(products, p0_s, prm, problem_data=meas_s,
                                   mesh=mesh, layout="minor")
    _result(out, "compact_minor", r)


def leg_mega(inp, out):
    """K1 under the mesh, on CPU tensors its plain versions: the named
    general instance, the generated one (forced), and the factored one on
    statistics reduced over a meas axis."""
    from libdogleg_tpu_torch import DoglegParameters
    from libdogleg_tpu_torch.models import quadratic_surface as qs
    from libdogleg_tpu_torch.parallel import (batched_optimize, make_mesh,
                                              shard_batch)
    from libdogleg_tpu_torch.parallel.batched import sharded_like
    from libdogleg_tpu_torch.parallel.mesh import local_rows
    from libdogleg_tpu_torch.parallel.sharded import all_reduce_sum
    from libdogleg_tpu_torch.problems import FactoredBasisProblem
    mesh = make_mesh(("dp",), device_type="cpu")
    p0 = torch.as_tensor(inp["p0_128"])
    meas = torch.as_tensor(inp["meas_128"])
    prm = DoglegParameters(max_iterations=8)
    r = batched_optimize(qs.products, shard_batch(p0, mesh), prm,
                         problem_data=shard_batch(meas, mesh), mesh=mesh,
                         use_megakernel=True)
    _placements(out, "mega_general", r.p)
    _result(out, "mega_general", r)
    r = batched_optimize(qs_products(), p0, prm, problem_data=meas,
                         mesh=mesh, use_megakernel=True)
    _result(out, "mega_generated", r)

    # the staged composition: statistics over a (2, 2) dp x meas mesh,
    # summed over meas, into the factored instance on the dp axis
    mesh2 = make_mesh(("dp", "meas"), shape=(2, 2), device_type="cpu")
    f32 = torch.float32
    meas32 = torch.as_tensor(inp["meas_64"]).to(f32)
    p0_32 = torch.as_tensor(inp["p0_64"]).to(f32)
    gx, gy = qs.make_grid(f32, "cpu")
    basis = qs.basis(gx, gy)
    m_blk = local_rows(local_rows(meas32, mesh2, "dp"), mesh2, "meas", 1)
    b_blk = local_rows(basis, mesh2, "meas")
    stats = torch.func.vmap(
        lambda m: FactoredBasisProblem.statistics(b_blk, m))(m_blk)
    stats = all_reduce_sum(stats, mesh2, "meas")
    for name, t in zip(("hh", "hl", "nh", "nl"), stats):
        out[f"staged/{name}"] = _np(sharded_like(t, mesh2, "dp"))
    G = qs.gram_pair(f32, "cpu")
    r = batched_optimize(qs.factored_products_fn(G), p0_32,
                         DoglegParameters(**PRM),
                         problem_data=sharded_like(tuple(stats), mesh2,
                                                   "dp"),
                         mesh=mesh2, axis_name="dp", use_megakernel=True)
    _result(out, "staged", r)


def leg_sparse(inp, out):
    """test_parallel.py:291: row-sharded measurements into the block-sparse
    JtJ, amalgamate 2, on the 8x4x2 grid."""
    from libdogleg_tpu_torch.parallel import (MeasurementShardedSparseProblem,
                                              make_mesh)
    from libdogleg_tpu_torch.solver import solve_products
    mesh = make_mesh(("meas",), device_type="cpu")
    Jd = torch.as_tensor(inp["grid_J"])
    target = torch.as_tensor(inp["grid_target"])

    def f_shard(p, data):
        J_rows, t_rows = data
        return J_rows @ p - t_rows, J_rows

    prob = MeasurementShardedSparseProblem(
        f=f_shard, data=(Jd, target), pattern_rows=inp["grid_rows"],
        pattern_cols=inp["grid_cols"], b=int(inp["grid_b"]), mesh=mesh,
        amalgamate=2)
    r = solve_products(prob.products, torch.zeros(Jd.shape[1], dtype=F64),
                       newton_solver=prob.newton_solver())
    _result(out, "sparse", r)


def leg_multihost(inp, out):
    """tests/multihost_worker.py's legs A-C on the four ranks."""
    from libdogleg_tpu_torch import DoglegParameters
    from libdogleg_tpu_torch.models import quadratic_surface as qs
    from libdogleg_tpu_torch.ops import dense as dops
    from libdogleg_tpu_torch.parallel import (MeasurementShardedProblem,
                                              MeasurementShardedSparseProblem,
                                              batched_optimize, make_mesh)
    from libdogleg_tpu_torch.solver import Products, solve_products
    mesh = make_mesh(("ax",), device_type="cpu")
    prm = DoglegParameters()
    t = {k: torch.as_tensor(inp[f"mh_{k}"]) for k in
         ("A", "Bm", "C", "d", "p0s", "meas", "p0", "a_c", "w_c", "d_c",
          "cols", "p0_c", "prows", "pcols")}

    def products(p, data):
        Ab, Bb, Cb, db = data
        th = torch.tanh(Bb @ p)
        x = Ab @ th + Cb @ p - db
        J = Ab @ (((1.0 - th * th)[:, None]) * Bb) + Cb
        return Products(norm2_x=dops.norm2(x), Jt_x=dops.jt_dot(J, x),
                        JtJ=dops.build_jtj(J))
    r = batched_optimize(products, t["p0s"], prm, mesh=mesh, axis_name="ax",
                         problem_data=(t["A"], t["Bm"], t["C"], t["d"]))
    _result(out, "legA", r, ("p", "step_count"))

    gx, gy = qs.make_grid(F64, "cpu")
    sharded = MeasurementShardedProblem(f=qs_f_shard,
                                        data=(gx, gy, t["meas"]), mesh=mesh,
                                        axis_name="ax")
    r = solve_products(sharded.products, t["p0"], prm)
    _result(out, "legB", r, ("p", "step_count"))

    nstate_c = t["p0_c"].shape[0]

    def f_rows2(p, data):
        aj, wj, dj, cj = data
        th = torch.tanh(wj * p[cj])
        x = (aj * th).sum(1) - dj
        J = torch.zeros((aj.shape[0], nstate_c), dtype=p.dtype).scatter(
            1, cj, aj * wj * (1.0 - th * th))
        return x, J
    sp = MeasurementShardedSparseProblem(
        f=f_rows2, data=(t["a_c"], t["w_c"], t["d_c"], t["cols"]),
        pattern_rows=inp["mh_prows"], pattern_cols=inp["mh_pcols"], b=2,
        mesh=mesh, axis_name="ax")
    r = solve_products(sp.products, t["p0_c"], prm,
                       newton_solver=sp.newton_solver())
    _result(out, "legC", r, ("p", "step_count"))


def leg_ckpt(inp, out, tmp):
    """A dp-sharded batched state through the distributed checkpoint: two
    attempts, save, load onto a fresh state's placements, run to the end;
    and the one-shot run. Then the same for config 9 small's batched tree
    states (a batched SchurJtJ, a History)."""
    from libdogleg_tpu_torch import DoglegParameters, checkpoint
    from libdogleg_tpu_torch.parallel import batched_optimize, make_mesh
    from libdogleg_tpu_torch.parallel.batched import (local_blocks,
                                                      sharded_like)
    from libdogleg_tpu_torch.solver import (init_batched_state,
                                            result_from_batched_state,
                                            run_batched_solver)
    mesh = make_mesh(("dp",), device_type="cpu")
    prm = DoglegParameters(max_iterations=8)
    products = torch.func.vmap(qs_products())
    p0 = local_blocks(torch.as_tensor(inp["p0_16"]), mesh)
    meas = local_blocks(torch.as_tensor(inp["meas_16"]), mesh)

    def fn(p):
        return products(p, meas)
    st = run_batched_solver(fn, init_batched_state(fn, p0, prm), prm,
                            max_new_attempts=2)
    path = os.path.join(tmp, "state")
    checkpoint.save_state_orbax(path, sharded_like(st, mesh))
    dist.barrier()
    like = sharded_like(init_batched_state(fn, p0, prm), mesh)
    loaded = checkpoint.load_state_orbax(path, like)
    _placements(out, "ckpt", loaded.p)
    out["ckpt/loaded_equal"] = np.array(all(
        a is None and b is None or torch.equal(a, b)
        for a, b in zip(local_blocks(loaded, mesh), st)))
    r = result_from_batched_state(run_batched_solver(
        fn, local_blocks(loaded, mesh), prm))
    _result(out, "ckpt_resumed", sharded_like(r, mesh))
    one = batched_optimize(qs_products(), torch.as_tensor(inp["p0_16"]),
                           prm, problem_data=torch.as_tensor(
                               inp["meas_16"]), mesh=mesh)
    _result(out, "ckpt_oneshot", one)

    # a batch of 8 pinhole tree states (config 9 small) with a batched
    # SchurJtJ and a History, dp-sharded the same way
    from libdogleg_tpu_torch.solver import solve_products_batched
    vf, obs9, p9, ns9 = config9_small()
    p9_l = local_blocks(p9, mesh)
    obs_l = local_blocks(obs9, mesh)

    def fn(p):
        return vf(p, obs_l)
    st = run_batched_solver(fn, init_batched_state(fn, p9_l, prm,
                                                   record_history=True),
                            prm, newton_solver=ns9, max_new_attempts=2)
    path = os.path.join(tmp, "state9")
    checkpoint.save_state_orbax(path, sharded_like(st, mesh))
    dist.barrier()
    loaded = checkpoint.load_state_orbax(path, sharded_like(
        init_batched_state(fn, p9_l, prm, record_history=True), mesh))
    out["ckpt9/loaded_equal"] = np.array(_same_bits(
        local_blocks(loaded, mesh), st))
    r = result_from_batched_state(run_batched_solver(
        fn, local_blocks(loaded, mesh), prm, newton_solver=ns9))
    whole = solve_products_batched(lambda p: vf(p, obs9), p9, prm,
                                   newton_solver=ns9, record_history=True)
    out["ckpt9/same_bits"] = np.array(_same_bits(
        r, local_blocks(whole, mesh)))


def config9_small():
    """Config 9 small: a batch of 8 full-visibility pinhole problems (ncam
    3, npts 16, one rig) under per-element observations, from numpy and
    torch seeds: (the products vmapped over (p, obs), the observations
    (8, ...), the tree starts (8, ...), the strategy)."""
    from libdogleg_tpu_torch.models import pinhole_ba as pba
    ba = pba.make_synthetic(seed=0, ncam=3, npts=16, device="cpu")
    B = 8
    rng = np.random.default_rng(5)
    obs_b = ba.obs[None] + torch.as_tensor(
        0.5 * rng.normal(size=(B,) + tuple(ba.obs.shape)))
    gen = torch.Generator().manual_seed(7)
    starts = [ba.p0(gen, jitter=0.05 * i) for i in range(B)]
    p0 = {k: torch.stack([s[k] for s in starts]) for k in ("c", "q")}
    return torch.func.vmap(ba.products_obs), obs_b, p0, ba.newton_solver()


def _counted(ns, counts):
    """ns as an instance of a subclass of its class that counts its
    factorizations (one a lambda try) and Gauss-Newton solves in
    `counts`."""
    base = type(ns)

    class Counted(base):
        def factor(self, JtJ, lam):
            counts["factor"] += 1
            return base.factor(self, JtJ, lam)

        def gauss_newton(self, *args, **kw):
            counts["gn"] += 1
            return base.gauss_newton(self, *args, **kw)
    return Counted(**{f.name: getattr(ns, f.name)
                      for f in dataclasses.fields(ns)})


def _collectives():
    """A dispatch mode that records the name of every c10d operation (a
    collective of torch.distributed, a DTensor's gather among them) run
    while it is active, in `.ops`."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Collectives(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if "c10d" in str(func):
                self.ops.append(str(func))
            return func(*args, **(kwargs or {}))
    return Collectives()


def _pts_solve(out, leg, products, p0s, ns):
    """The point-sharded solve with History: what every rank must hold the
    same (the replicated c, decisions, History, the whole q) under `leg`,
    the rank's own blocks under `leg`_local, and the counts that fix its
    all_reduces."""
    from libdogleg_tpu_torch import DoglegParameters, solve_products
    from libdogleg_tpu_torch.parallel import sharded
    counts = {"products": 0, "factor": 0, "gn": 0}

    def fn(p):
        counts["products"] += 1
        return products(p)
    sharded.reset_counts()
    with _collectives() as seen:
        r = solve_products(fn, p0s, DoglegParameters(),
                           newton_solver=_counted(ns, counts),
                           record_history=True)
    out[f"{leg}_count/collectives"] = np.array(sorted(set(seen.ops)))
    out[f"{leg}_count/collective_calls"] = np.array(len(seen.ops))
    out[f"{leg}_count/all_reduce_calls"] = np.array(sharded.all_reduce_calls)
    out[f"{leg}_count/all_reduce_bytes"] = np.array(sharded.all_reduce_bytes)
    for k, v in counts.items():
        out[f"{leg}_count/{k}"] = np.array(v)
    _result(out, leg, r, ("step_count", "n_attempts", "reason", "norm2_x",
                          "lam", "trustregion"))
    out[f"{leg}/c"] = _np(r.p["c"].to_local())
    out[f"{leg}/jtx_c"] = _np(r.Jt_x["c"].to_local())
    out[f"{leg}/q"] = _np(r.p["q"])
    out[f"{leg}/placements"] = np.array(
        f"c {tuple(r.p['c'].placements)} q {tuple(r.p['q'].placements)}")
    out[f"{leg}/U"] = _np(r.JtJ.U)
    for name in r.JtJ._fields:
        if name != "U":
            out[f"{leg}_local/{name}_shape"] = np.array(
                getattr(r.JtJ, name).to_local().shape)
    out[f"{leg}_local/q"] = _np(r.p["q"].to_local())


def pts_sparse_instance(inp, mesh, obs_mask=False):
    """test_parallel.py:334's instance, its start from the JAX package's
    key (in the inputs), and both point-sharded over the mesh's "pts"
    axis; obs_mask=True masks every fifth observation slot."""
    from libdogleg_tpu_torch.models import pinhole_ba as pba
    from libdogleg_tpu_torch.parallel.batched import shard_batch
    from libdogleg_tpu_torch.parallel.points import replicate
    ba = pba.make_synthetic_sparse(seed=2, ncam=8, npts=160, k_obs=3,
                                   device="cpu")
    if obs_mask:
        mask = torch.ones((ba.npts, ba.k_obs), dtype=F64)
        mask.view(-1)[::5] = 0.0
        ba = dataclasses.replace(ba, obs_mask=mask)
    names = ("cam_of", "obs", "pts_prior") + (("obs_mask",) if obs_mask
                                              else ())
    ba_s = dataclasses.replace(ba, **dict(zip(names, shard_batch(
        tuple(getattr(ba, n) for n in names), mesh, "pts"))))
    p0 = {"c": torch.as_tensor(inp["pts_p0_c"]),
          "q": torch.as_tensor(inp["pts_p0_q"])}
    p0s = {"c": replicate(p0["c"], mesh),
           "q": shard_batch(p0["q"], mesh, "pts")}
    return ba, ba_s, p0, p0s


def leg_pts_schur(inp, out):
    """test_parallel.py:155: the linear instance's points over the 'pts'
    axis (16 a rank), the camera block replicated; and a point count the
    axis does not divide."""
    from libdogleg_tpu_torch.models import bundle_adjustment as lba
    from libdogleg_tpu_torch.parallel import make_mesh
    mesh = make_mesh(("pts",), device_type="cpu")
    ba = lba.make_synthetic(seed=3, nc=8, n_points=64, block_size=3,
                            k_obs=4, dtype=F64, noise=0.05, device="cpu")
    ba_s = ba.shard(mesh)
    _pts_solve(out, "pts_schur", ba_s.products_tree,
               ba.shard_p_tree(ba.p0_tree(), mesh), ba_s.tree_newton_solver())
    out["pts_sizes/schur"] = np.array([ba_s.n_points, ba_s.nstate,
                                       ba_s.nmeasurements])
    odd = lba.make_synthetic(seed=3, nc=8, n_points=66, dtype=F64,
                             device="cpu")
    try:
        odd.shard(mesh)
        out["pts_schur/indivisible"] = np.array("")
    except ValueError as e:
        out["pts_schur/indivisible"] = np.array(str(e))


def leg_pts_sparse(inp, out):
    """test_parallel.py:334: the sparse-visibility instance's points over
    the 'pts' axis (40 a rank) with a solver of the unsharded instance,
    plain and with refine_iters=2 and a per-rank cam_gather; and the
    products at the start, sharded (with an obs_mask too) and not."""
    from libdogleg_tpu_torch.ops.newton import build_cam_gather
    from libdogleg_tpu_torch.parallel import make_mesh
    mesh = make_mesh(("pts",), device_type="cpu")
    ba, ba_s, p0, p0s = pts_sparse_instance(inp, mesh)
    out["pts_sizes/sparse"] = np.array([ba_s.npts, ba_s.nstate, ba_s.nobs])
    ns = ba.newton_solver()
    _pts_solve(out, "pts_sparse", ba_s.products, p0s, ns)
    _pts_solve(out, "pts_sparse_refine", ba_s.products, p0s,
               dataclasses.replace(ns, refine_iters=2,
                                   cam_gather=build_cam_gather(
                                       ba_s.cam_of, ba.ncam)))
    for masked in (False, True):
        ba, ba_s, p0, p0s = pts_sparse_instance(inp, mesh, masked)
        for side, pr in (("whole", ba.products(p0)),
                         ("sharded", ba_s.products(p0s))):
            key = f"pts_prior/{side}{int(masked)}"
            out[f"{key}/norm2_x"] = _np(pr.norm2_x)
            out[f"{key}/gc"] = _np(pr.Jt_x["c"])
            out[f"{key}/U"] = _np(pr.JtJ.U)


def pts_instances(inp, mesh):
    """test_parallel.py:155's linear instance (tree form) and :334's
    sparse-visibility one, point-sharded over the mesh's "pts" axis:
    name -> (products, sharded start, strategy)."""
    from libdogleg_tpu_torch.models import bundle_adjustment as lba
    ba = lba.make_synthetic(seed=3, nc=8, n_points=64, block_size=3,
                            k_obs=4, dtype=F64, noise=0.05, device="cpu")
    ba_s = ba.shard(mesh)
    sp, sp_s, _, p0s = pts_sparse_instance(inp, mesh)
    return {"schur": (ba_s.products_tree,
                      ba.shard_p_tree(ba.p0_tree(), mesh),
                      ba_s.tree_newton_solver()),
            "sparse": (sp_s.products, p0s, sp.newton_solver())}


def leg_pts_ckpt(inp, out, tmp):
    """Both point-sharded instances through the distributed checkpoint:
    two attempts, save (each rank its blocks) into tmp/pts_<name>, load
    onto a fresh init_solver_state's placements, run to the end; and the
    one-shot sharded run. The parent loads the same directories into one
    process afterwards."""
    from libdogleg_tpu_torch import (DoglegParameters, checkpoint,
                                     init_solver_state, result_from_state,
                                     run_solver, solve_products)
    from libdogleg_tpu_torch.parallel import make_mesh
    mesh = make_mesh(("pts",), device_type="cpu")
    prm = DoglegParameters()
    for name, (fn, p0s, ns) in pts_instances(inp, mesh).items():
        leg = f"pts_ckpt_{name}"
        st = run_solver(fn, init_solver_state(fn, p0s, prm), prm,
                        newton_solver=ns, max_new_attempts=2)
        for f in ("step_count", "n_attempts", "reason", "done"):
            out[f"{leg}/two_{f}"] = np.array(getattr(st, f))
        path = os.path.join(tmp, f"pts_{name}")
        checkpoint.save_state_orbax(path, st)
        dist.barrier()
        loaded = checkpoint.load_state_orbax(
            path, init_solver_state(fn, p0s, prm))
        out[f"{leg}/loaded_equal"] = np.array(_same_bits(loaded, st))
        out[f"{leg}/placements"] = np.array(" ".join(
            f"{k} {tuple(v.placements)}" for k, v in
            list(loaded.p.items()) + list(loaded.JtJ._asdict().items())))
        r = result_from_state(run_solver(fn, loaded, prm, newton_solver=ns))
        one = solve_products(fn, p0s, prm, newton_solver=ns)
        out[f"{leg}/same_bits"] = np.array(_same_bits(r, one))
        _result(out, leg, r, ("step_count", "n_attempts", "reason",
                              "norm2_x", "lam"))
        out[f"{leg}/c"] = _np(r.p["c"].to_local())
        out[f"{leg}/q"] = _np(r.p["q"])


def _outlierness_pass(ba, r, **kw):
    """get_outlierness_factors_ba of the sparse instance at a solve's
    result (tests/test_torch_analysis.py's measurement count)."""
    from libdogleg_tpu_torch.analysis import get_outlierness_factors_ba
    robs, Jc, Jq = ba.observation_jacobians(r.p)
    return get_outlierness_factors_ba(
        robs, Jc, Jq, r.JtJ, r.lam, r.norm2_x, 2 * ba.nobs + 6 + 3 * ba.npts,
        ba.newton_solver(), **kw)


def leg_pts_outl(inp, out):
    """The sparse-visibility instance's outlierness factors over its
    point-sharded solution: a fresh pass and one reusing the strategy's
    sharded factor, each pass's all_reduces counted, the factors
    gathered (chunk 16: a rank's 40 points in three chunks)."""
    from libdogleg_tpu_torch import DoglegParameters, solve_products
    from libdogleg_tpu_torch.parallel import make_mesh, sharded
    mesh = make_mesh(("pts",), device_type="cpu")
    ba, ba_s, _, p0s = pts_sparse_instance(inp, mesh)
    ns = ba.newton_solver()
    r = solve_products(ba_s.products, p0s, DoglegParameters(),
                       newton_solver=ns)
    sharded.reset_counts()
    f, scale = _outlierness_pass(ba_s, r, chunk=16)
    out["pts_outl_count/fresh"] = np.array(sharded.all_reduce_calls)
    fac = ns.factor(r.JtJ, r.lam)
    sharded.reset_counts()
    f2, scale2 = _outlierness_pass(ba_s, r, chunk=16, factorization=fac)
    out["pts_outl_count/reused"] = np.array(sharded.all_reduce_calls)
    out["pts_outl_local/reuse_same"] = np.array(
        _same_bits((f, scale), (f2, scale2)))
    out["pts_outl_local/placements"] = np.array(str(tuple(f.placements)))
    out["pts_outl/factors"] = _np(f)
    out["pts_outl/scale"] = _np(scale)
    for k in ("c", "q"):
        out[f"pts_outl/p_{k}"] = _np(r.p[k])
    out["pts_outl/lam"] = _np(r.lam)
    out["pts_outl/norm2_x"] = _np(r.norm2_x)


def _same_bits(a, b) -> bool:
    """Two trees of tensors (NamedTuples, dicts, DTensors) of the same
    bits, NaN included."""
    from torch.distributed.tensor import DTensor
    from torch.utils import _pytree as pytree
    la, lb = pytree.tree_leaves(a), pytree.tree_leaves(b)
    if len(la) != len(lb):
        return False
    for x, y in zip(la, lb):
        x = x.to_local() if isinstance(x, DTensor) else x
        y = y.to_local() if isinstance(y, DTensor) else y
        if not isinstance(x, torch.Tensor):
            if x != y:
                return False
        elif (x.dtype != y.dtype or x.shape != y.shape
              or x.numpy().tobytes() != y.numpy().tobytes()):
            return False
    return True


def _keyword_solve(fn, p0s, ns):
    """The point-sharded solve through the `shards=` keyword on local
    leaves (the strategy's shards set by the caller), its state wrapped
    as solve_products wraps its own."""
    from libdogleg_tpu_torch import (DoglegParameters, init_solver_state,
                                     result_from_state, run_solver)
    from libdogleg_tpu_torch.parallel.points import point_shards
    shards, p0 = point_shards(p0s)
    prm = DoglegParameters()
    st = init_solver_state(fn, p0, prm, record_history=True, shards=shards)
    st = run_solver(fn, st, prm, shards=shards,
                    newton_solver=dataclasses.replace(ns, shards=shards))
    return result_from_state(shards.wrap(st))


def _placement_errors(mesh):
    """point_shards of a SchurJtJ whose V is sharded on its axis 1, and of
    one whose W is sharded on its axis 0: the ValueError texts."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from libdogleg_tpu_torch.ops.newton import SchurJtJ
    from libdogleg_tpu_torch.parallel.points import point_shards

    def dt(t, pl):
        return DTensor.from_local(t, mesh, [pl], run_check=False)
    U, W, V = (torch.zeros(s, dtype=F64) for s in ((4, 4), (4, 6, 3),
                                                    (6, 3, 3)))
    texts = []
    for jtj in (SchurJtJ(dt(U, Replicate()), dt(W, Shard(1)),
                         dt(V, Shard(1))),
                SchurJtJ(dt(U, Replicate()), dt(W, Shard(0)),
                         dt(V, Shard(0)))):
        try:
            point_shards(jtj)
            texts.append("")
        except ValueError as e:
            texts.append(str(e))
    ok = SchurJtJ(dt(U, Replicate()), dt(W, Shard(1)), dt(V, Shard(0)))
    shards, local = point_shards(ok)
    texts.append(f"{shards.axis_name} {type(local.W).__name__}")
    return np.array(texts)


def leg_one(inp, out):
    """A world of one: each point-sharded solve of the pts legs against
    the same solve unsharded, every result field bit for bit; and the
    sparse instance's outlierness pass over its sharded solution against
    the unsharded pass, fresh and reusing the sharded factor."""
    from libdogleg_tpu_torch import DoglegParameters, solve_products
    from libdogleg_tpu_torch.models import bundle_adjustment as lba
    from libdogleg_tpu_torch.ops.newton import build_cam_gather
    from libdogleg_tpu_torch.parallel import make_mesh
    mesh = make_mesh(("pts",), device_type="cpu")
    out["one/world"] = np.array(dist.get_world_size())
    out["one/placement_errors"] = _placement_errors(mesh)
    ba = lba.make_synthetic(seed=3, nc=8, n_points=64, block_size=3,
                            k_obs=4, dtype=F64, noise=0.05, device="cpu")
    ba_s = ba.shard(mesh)
    sp, sp_s, p0, p0s = pts_sparse_instance(inp, mesh)
    ns = sp.newton_solver()
    ns_r = dataclasses.replace(ns, refine_iters=2,
                               cam_gather=build_cam_gather(sp.cam_of,
                                                           sp.ncam))
    cases = {
        "schur": ((ba.products_tree, ba.p0_tree(), ba.tree_newton_solver()),
                  (ba_s.products_tree, ba.shard_p_tree(ba.p0_tree(), mesh),
                   ba_s.tree_newton_solver())),
        "sparse": ((sp.products, p0, ns), (sp_s.products, p0s, ns)),
        "sparse_refine": ((sp.products, p0, ns_r),
                          (sp_s.products, p0s, ns_r))}
    for name, (whole, shard) in cases.items():
        r = [solve_products(fn, start, DoglegParameters(), newton_solver=s,
                            record_history=True)
             for fn, start, s in (whole, shard)]
        out[f"one/{name}/same_bits"] = np.array(_same_bits(r[0], r[1]))
        out[f"one/{name}/placements"] = np.array(str(tuple(
            r[1].p["q"].placements)))
        if name == "schur":
            out["one/keyword/same_bits"] = np.array(_same_bits(
                _keyword_solve(*shard), r[1]))
        if name == "sparse":
            # the outlierness pass over the sharded solution against the
            # unsharded pass, fresh and with the sharded factor
            passes = [_outlierness_pass(sp, r[0], chunk=64),
                      _outlierness_pass(sp_s, r[1], chunk=64),
                      _outlierness_pass(sp_s, r[1], chunk=64,
                                        factorization=ns.factor(
                                            r[1].JtJ, r[1].lam))]
            for k, got in (("fresh", passes[1]), ("reused", passes[2])):
                out[f"one/outl/{k}_same_bits"] = np.array(
                    _same_bits(got, passes[0]))


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn_group(inputs: str, tmp: str, legs: str = "all", world: int = 4,
                limit: float = 240.0, ranks=None):
    """Run the ranks of this script (all `world` of them, or only `ranks`)
    on one gloo group and return each rank's outputs as a dict. Past
    `limit` seconds every process is killed and TimeoutError raised: a
    group that hangs fails within its limit. A rank that exits other than
    0 raises RuntimeError with its standard error."""
    import subprocess
    import time
    port = _free_port()
    ranks = list(range(world)) if ranks is None else list(ranks)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs, logs = [], []
    for r in ranks:
        log = open(os.path.join(tmp, f"rank{r}.log"), "w+")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--rank", str(r),
             "--world", str(world), "--port", str(port), "--inputs", inputs,
             "--out", os.path.join(tmp, f"out{r}.npz"), "--legs", legs],
            stdout=log, stderr=subprocess.STDOUT, env=env))
    deadline = time.monotonic() + limit
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.01))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.wait()
        raise TimeoutError(f"the group of ranks {ranks} did not end within "
                           f"{limit} s; all killed")
    finally:
        for log in logs:
            log.seek(0)
    texts = [log.read() for log in logs]
    for log in logs:
        log.close()
    for r, p, text in zip(ranks, procs, texts):
        if p.returncode != 0 or "TORCH_MESH_WORKER_OK" not in text:
            raise RuntimeError(f"rank {r} exited {p.returncode}:\n"
                               f"{text[-4000:]}")
    outs = []
    for r in ranks:
        with np.load(os.path.join(tmp, f"out{r}.npz")) as f:
            outs.append({k: f[k] for k in f.files})
    return outs


LEGS = {"all": ("mesh", "measurement", "dp", "compaction", "mega", "sparse",
                "multihost", "pts_schur", "pts_sparse", "pts_outl"),
        "ckpt": ("ckpt", "pts_ckpt"),
        "one": ("one",)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--inputs", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--legs", default="all")
    args = ap.parse_args()
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"tcp://localhost:{args.port}", rank=args.rank,
        world_size=args.world, timeout=datetime.timedelta(seconds=60))
    with np.load(args.inputs) as f:
        inp = {k: f[k] for k in f.files}
    out = {}
    for leg in LEGS[args.legs]:
        if leg in ("ckpt", "pts_ckpt"):
            globals()[f"leg_{leg}"](inp, out, os.path.dirname(args.out))
        else:
            globals()[f"leg_{leg}"](inp, out)
    np.savez(args.out, **out)
    dist.barrier()
    dist.destroy_process_group()
    print("TORCH_MESH_WORKER_OK", args.rank, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
