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
    and the one-shot run."""
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
                "multihost"),
        "ckpt": ("ckpt",)}


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
        if leg == "ckpt":
            leg_ckpt(inp, out, os.path.dirname(args.out))
        else:
            globals()[f"leg_{leg}"](inp, out)
    np.savez(args.out, **out)
    dist.barrier()
    dist.destroy_process_group()
    print("TORCH_MESH_WORKER_OK", args.rank, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
