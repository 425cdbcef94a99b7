#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (libdogleg_tpu_torch) once on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases, each printing its own lines:
  1. the card (nvidia-smi name and power limit) and the software versions;
  2. build kernel K1 (csrc/mega.cu) from the checkout with nvcc;
  3. K1 against its plain PyTorch twin on the card, on numpy-seeded inputs:
     float64 at B=1024 (identical decisions, p within rtol 1e-9) and float32
     at B=8192 under the benchmark stopping rule (decision agreement >= 0.85,
     kernel recovered_frac >= 0.99, norm2_x within rtol 1e-2, atol 1e-4);
  4. the public path: batched_optimize(quadratic_surface.products, ...) on
     8192 float32 problems, which must launch K1 and recover >= 99%;
  5. the single-solve CLI, `sample --check --device cuda <mode>`, in every
     ported mode (float64);
  6. CUDA-event timing of K1 and of the twin at B=8192 float32;
  7. K2 (csrc/panelchol.cu) against its twin: panels p in {16, 64, 256},
     batch {1, 8}, float32 and float64 (L and inv(L) within 1e-10 (f64) or
     2e-4 (f32) of their largest entry, ok identical), a non-SPD panel
     (ok False in both), and large_cholesky(panel_impl="cuda") at
     n=2048 x 8 and n=8192 x 1 in float32 against a float64 factor
     (max error / max |L| below 1e-4);
  8. the slice at full width: the 32x32x8 grid MRF (Nstate 8192),
     optimize(grid.problem(jtj="dense"), 0, PRM,
     newton_solver=BlockedDenseNewtonSolver()) in float32 with >= 32 K2
     launches, reason > 0, max|Jt_x| <= 1e-3 and p within 1e-3 (abs) of
     the float64 solve; in float64 panel_impl="cuda" against "torch"
     (identical decisions, p within rtol 1e-9); the dense-coupling grid
     once in float32;
  9. K3 and K4 (csrc/bcsr.cu): the opt-in entry points driven once on the
     full-width dense-coupling grid Jacobian (8 x 8 blocks), then held
     against their twins there and on a 512 x 16 pattern of (32, 128)
     blocks, in float32 (1e-4 of the largest entry) and float64 (1e-12);
 10. CUDA-event timing: K2 and its twin at p=256, large_cholesky at n=8192
     with K2, with the twin and torch.linalg.cholesky_ex, the slice's whole
     solve with BlockedDenseNewtonSolver and DenseNewtonSolver (host wall
     and a profiler's device-time split), K3 and K4 and their twins.
Then one JSON line about the kernels, the card line again, and a last JSON
line with "ok": true. Any failure exits non-zero before the last line; so
does a machine without a CUDA device, or a directory without the package.
"""

from __future__ import annotations

import json
import platform
import subprocess
import sys
import time

import numpy as np

BATCH = 8192
# f32-appropriate thresholds: the benchmark stopping rule (bench.py:166-169,
# and PRM of bench_all.py:46-48)
BENCH = dict(max_iterations=10, Jt_x_threshold=1e-3, update_threshold=1e-5,
             trustregion_threshold=1e-5)
GRID = (32, 32, 8)   # config 6 of bench_all.py:330-374: Nstate 8192


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def instances(seed, batch, dtype, device):
    """Sample-problem instances made with numpy: truth + U(-0.5, 0.5) noise
    on the 10x10 grid, starts uniform in [-0.1, 0.9]."""
    import torch

    from libdogleg_tpu_torch.models import quadratic_surface as qs
    rng = np.random.default_rng(seed)
    gx, gy = (t.numpy() for t in qs.make_grid(torch.float64))
    truth = qs.model(qs.P_TRUE, gx, gy)
    meas = truth + rng.uniform(size=(batch, qs.NMEAS)) - 0.5
    p0 = rng.uniform(size=(batch, qs.NSTATE)) - 0.1

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=device)
    return t(p0), t(meas), t(gx), t(gy)


def recovered_frac(p) -> float:
    """Share of problems with every parameter within 0.2 of the truth
    (bench.py:279-281)."""
    from libdogleg_tpu_torch.models import quadratic_surface as qs
    err = np.abs(p.double().cpu().numpy() - qs.P_TRUE[None])
    return float(np.mean(np.all(err < 0.2, axis=1)))


def spd_on_device(n, batch, seed, dtype, device):
    """(batch, n, n) well-conditioned SPD matrices (A A^T / n + I, condition
    number below about 5) drawn on the card from a seeded generator."""
    import torch
    g = torch.Generator(device=device).manual_seed(seed)
    A = torch.randn((batch, n, n), generator=g, dtype=torch.float64,
                    device=device)
    eye = torch.eye(n, dtype=torch.float64, device=device)
    return (A @ A.mT / n + eye).to(dtype)


def rel_err(got, want) -> float:
    """max |got - want| over max |want|."""
    return float((got.double() - want.double()).abs().max()
                 / want.double().abs().max())


def phase7_panel(dev) -> dict:
    """K2 against its twin, and large_cholesky on K2 against float64."""
    import torch

    from libdogleg_tpu_torch.ops import largechol, panelchol
    out = {}
    for dtype, tol in ((torch.float64, 1e-10), (torch.float32, 2e-4)):
        name = str(dtype).split(".")[-1]
        for p in (16, 64, 256):
            for batch in (1, 8):
                W = spd_on_device(p, batch, p + batch, dtype, dev) * p
                L, Linv, ok = panelchol.panel_factor(W)
                Lr, Linvr, okr = panelchol.panel_factor_reference(W)
                torch.cuda.synchronize()
                check(bool(ok.all()) and torch.equal(ok, okr),
                      f"K2 {name} p={p} B={batch} ok")
                check(bool((torch.triu(L, 1) == 0).all()),
                      f"K2 {name} p={p} zeros above the diagonal")
                e_l, e_i = rel_err(L, Lr), rel_err(Linv, Linvr)
                check(max(e_l, e_i) < tol,
                      f"K2 {name} p={p} B={batch} within {tol}: "
                      f"{e_l:.3e} {e_i:.3e}")
                abs_err = max(float((L - Lr).abs().max()),
                              float((Linv - Linvr).abs().max()))
                if dtype == torch.float32 and p == 256 and batch == 1:
                    out["max_abs_err"] = abs_err
                print(f"[7 K2 {name} p={p} B={batch}] vs twin: L {e_l:.3e} "
                      f"inv(L) {e_i:.3e} of max (tol {tol}); max abs "
                      f"{abs_err:.3e}", flush=True)
        W = spd_on_device(256, 2, 1, dtype, dev) * 256
        W[1, 100, 100] = -W[1, 100, 100]
        _, _, ok = panelchol.panel_factor(W)
        _, _, okr = panelchol.panel_factor_reference(W)
        check(ok.tolist() == okr.tolist() == [True, False],
              f"K2 {name} non-SPD panel flagged: {ok.tolist()} "
              f"{okr.tolist()}")
        print(f"[7 K2 {name} non-SPD] ok {ok.tolist()} (twin "
              f"{okr.tolist()})", flush=True)
    for n, batch in ((2048, 8), (8192, 1)):
        A = spd_on_device(n, batch, n, torch.float64, dev)
        L64 = torch.linalg.cholesky(A)
        before = panelchol.launch_count
        L32, ok = largechol.large_cholesky(A.float(), panel_impl="cuda")
        torch.cuda.synchronize()
        e = rel_err(L32, L64)
        check(bool(ok.all()), f"large_cholesky n={n} ok")
        check(panelchol.launch_count > before,
              f"large_cholesky n={n} launched K2")
        check(e < 1e-4, f"large_cholesky n={n} f32 vs f64 {e:.3e} < 1e-4")
        print(f"[7 large_cholesky n={n} B={batch} f32, K2] max |L32 - L64| "
              f"/ max |L64| = {e:.3e} (tol 1e-4); K2 launches "
              f"{panelchol.launch_count - before}", flush=True)
        del A, L64, L32
    return out


def phase8_slice(dev, bench) -> dict:
    """The grid MRF at full width through BlockedDenseNewtonSolver."""
    import torch

    from libdogleg_tpu_torch import BlockedDenseNewtonSolver, optimize
    from libdogleg_tpu_torch.models import grid_mrf
    from libdogleg_tpu_torch.ops import panelchol

    def solve(coupling, dtype, prm, panel_impl="auto"):
        g = grid_mrf.make_grid_mrf(*GRID, coupling=coupling, dtype=dtype,
                                   device=dev)
        p0 = torch.zeros(g.nstate, dtype=dtype, device=dev)
        t0 = time.perf_counter()
        r = optimize(g.problem(jtj="dense"), p0, prm,
                     newton_solver=BlockedDenseNewtonSolver(
                         panel_impl=panel_impl))
        torch.cuda.synchronize()
        return r, time.perf_counter() - t0

    panelchol.launch_count = 0
    r32, wall = solve("diag", torch.float32, bench)
    launches = panelchol.launch_count
    jtx = float(r32.Jt_x.abs().max())
    check(r32.p.shape == (GRID[0] * GRID[1] * GRID[2],)
          and bool(torch.isfinite(r32.p).all()), "finite (8192,) p")
    check(launches >= 32, f"K2 launched {launches} >= 32 times")
    check(int(r32.reason) > 0, "the f32 solve terminated")
    check(jtx <= 1e-3, f"f32 max|Jt_x| {jtx:.3e} <= 1e-3")
    r64, wall64 = solve("diag", torch.float64, None, "cuda")
    r64t, wall64t = solve("diag", torch.float64, None, "torch")
    for field in ("step_count", "n_attempts", "reason"):
        check(int(getattr(r64, field)) == int(getattr(r64t, field)),
              f"f64 K2 vs twin {field} identical")
    check(torch.allclose(r64.p, r64t.p, rtol=1e-9, atol=1e-12),
          "f64 K2 vs twin p within rtol 1e-9")
    dp = float((r32.p.double() - r64.p).abs().max())
    check(dp <= 1e-3, f"f32 p within 1e-3 of the f64 solve: {dp:.3e}")
    print(f"[8 grid {GRID} f32 PRM] K2 launches {launches}; step_count "
          f"{int(r32.step_count)} n_attempts {int(r32.n_attempts)} reason "
          f"{int(r32.reason)}; max|Jt_x| {jtx:.3e} (<= 1e-3); max |p32 - "
          f"p64| {dp:.3e} (<= 1e-3); wall {wall:.3f} s (first call)",
          flush=True)
    print(f"[8 grid {GRID} f64] K2 vs twin panels: step_count "
          f"{int(r64.step_count)} n_attempts {int(r64.n_attempts)} reason "
          f"{int(r64.reason)} identical; max |dp| "
          f"{float((r64.p - r64t.p).abs().max()):.3e} (rtol 1e-9); wall "
          f"{wall64:.3f} s K2, {wall64t:.3f} s twin", flush=True)
    rd, walld = solve("dense", torch.float32, bench)
    jtxd = float(rd.Jt_x.abs().max())
    check(int(rd.reason) > 0 and jtxd <= 1e-3,
          f"dense-coupling f32 solve: reason {int(rd.reason)}, max|Jt_x| "
          f"{jtxd:.3e}")
    print(f"[8 grid {GRID} coupling=dense f32 PRM] reason {int(rd.reason)} "
          f"step_count {int(rd.step_count)}; max|Jt_x| {jtxd:.3e}; wall "
          f"{walld:.3f} s", flush=True)
    return {"launches": launches}


def random_bcsr(nbrow, nbcol, bm, bn, density, seed, dtype, device):
    """A block-CSR Jacobian on a random pattern (every row stores column
    0), values drawn on the card."""
    import torch

    from libdogleg_tpu_torch.ops.bcsr import BCSRJacobian, BCSRStructure
    rng = np.random.default_rng(seed)
    mask = rng.uniform(size=(nbrow, nbcol)) < density
    mask[:, 0] = True
    indptr = np.concatenate([[0], np.cumsum(mask.sum(1))]).astype(np.int32)
    indices = np.nonzero(mask)[1].astype(np.int32)
    s = BCSRStructure(nmeas=nbrow * bm, nstate=nbcol * bn, block_rows=bm,
                      block_cols=bn, indptr=indptr, indices=indices)
    g = torch.Generator(device=device).manual_seed(seed)
    values = torch.randn((s.nnzb, bm, bn), generator=g, dtype=dtype,
                         device=device)
    return BCSRJacobian(s, values)


def grid_jacobian(dtype, dev):
    """The full-width dense-coupling grid's block-CSR Jacobian, the problem
    and its true state."""
    from libdogleg_tpu_torch.models import grid_mrf
    from libdogleg_tpu_torch.ops.bcsr import BCSRJacobian
    g = grid_mrf.make_grid_mrf(*GRID, coupling="dense", dtype=dtype,
                               device=dev)
    prob = g.problem(jtj="dense")
    _, values = prob.f(g.p_true)
    return BCSRJacobian(g.structure, values), prob, g.p_true


def phase9_bcsr(dev) -> dict:
    """K3 and K4: their opt-in path once, counted, then against twins."""
    import torch

    from libdogleg_tpu_torch.ops import bcsr_kernels as tk
    J, prob, p_true = grid_jacobian(torch.float32, dev)
    for k in tk.launch_counts:
        tk.launch_counts[k] = 0
    JtJ = tk.bcsr_jtj_dense_kernel(J)
    Jp = tk.bcsr_matvec_kernel(J, p_true)
    torch.cuda.synchronize()
    launches = dict(tk.launch_counts)
    check(all(v >= 1 for v in launches.values()),
          f"K3 and K4 launched on their path: {launches}")
    # the problem is linear: J p = x(p) - x(0); JtJ is the plain products'
    x1, x0 = prob.f(p_true)[0], prob.f(torch.zeros_like(p_true))[0]
    e_jp = rel_err(Jp, x1 - x0)
    e_jtj = rel_err(JtJ, prob.products(p_true).JtJ)
    check(e_jp < 1e-5 and e_jtj < 1e-5,
          f"K4 J p and K3 JtJ agree with the problem: {e_jp:.3e} "
          f"{e_jtj:.3e}")
    print(f"[9 grid {GRID} f32, opt-in path] launches {launches}; J p vs "
          f"x(p) - x(0) {e_jp:.3e}, JtJ vs products {e_jtj:.3e} (tol "
          f"1e-5 of max)", flush=True)
    out = {"K3": {"launches": launches["bcsr_jtj_blocks_kernel"]},
           "K4": {"launches": launches["bcsr_matvec_kernel"]}}
    for dtype, tol in ((torch.float32, 1e-4), (torch.float64, 1e-12)):
        name = str(dtype).split(".")[-1]
        cases = (("grid 8x8", grid_jacobian(dtype, dev)[0]),
                 ("512x16 of 32x128",
                  random_bcsr(512, 16, 32, 128, 0.25, 9, dtype, dev)))
        for label, Jc in cases:
            sched = tk.build_jtj_schedule(Jc.structure)
            v = torch.linspace(-1.0, 1.0, Jc.structure.nstate, dtype=dtype,
                               device=dev)
            blocks, _ = tk.bcsr_jtj_blocks_kernel(Jc, sched)
            Jv = tk.bcsr_matvec_kernel(Jc, v)
            blocks_r = tk.bcsr_jtj_blocks_reference(Jc, sched)
            Jv_r = tk.bcsr_matvec_reference(Jc, v)
            torch.cuda.synchronize()
            e3, e4 = rel_err(blocks, blocks_r), rel_err(Jv, Jv_r)
            check(e3 < tol and e4 < tol,
                  f"K3/K4 {name} {label} within {tol}: {e3:.3e} {e4:.3e}")
            if dtype == torch.float32 and label.startswith("grid"):
                out["K3"]["max_abs_err"] = float(
                    (blocks - blocks_r).abs().max())
                out["K4"]["max_abs_err"] = float((Jv - Jv_r).abs().max())
            print(f"[9 {label} {name}] vs twins: K3 {e3:.3e} K4 {e4:.3e} "
                  f"of max (tol {tol}); {len(sched.pair_i)} pairs, "
                  f"{Jc.structure.nnzb} blocks", flush=True)
            del Jc, blocks, blocks_r
    return out


def device_split(fn, *args) -> str:
    """Device time of one call of fn, summed by kernel group from a
    torch.profiler trace: K2, cuBLAS/CUTLASS products, and the rest."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn(*args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    groups = {"K2": 0.0, "gemm": 0.0, "other": 0.0}
    for ev in prof.key_averages():
        # device-side events only: a CPU op's device time repeats that of
        # the kernels it launched
        if ev.device_type != DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0.0))
        key = ev.key.lower()
        if "panelchol" in key:
            groups["K2"] += us
        elif "gemm" in key or "cutlass" in key or "xmma" in key:
            groups["gemm"] += us
        else:
            groups["other"] += us
    total = sum(groups.values())
    if total == 0:
        return f"wall {wall * 1e3:.1f} ms; the profiler saw no device time"
    shares = " ".join(f"{k} {v / 1e3:.2f} ms ({100 * v / total:.1f}%)"
                      for k, v in groups.items())
    return (f"wall {wall * 1e3:.1f} ms (profiled); device {total / 1e3:.2f} "
            f"ms: {shares}; host and idle {wall * 1e3 - total / 1e3:.1f} ms")


def phase10_timing(dev, bench, card, k2, k34) -> None:
    """CUDA-event times at the slice's shapes, with the card line."""
    import torch

    from libdogleg_tpu_torch import (BlockedDenseNewtonSolver,
                                     DenseNewtonSolver, optimize)
    from libdogleg_tpu_torch.models import grid_mrf
    from libdogleg_tpu_torch.ops import bcsr_kernels as tk
    from libdogleg_tpu_torch.ops import largechol, panelchol
    from libdogleg_tpu_torch.utils.benchtime import measure_ms

    for dtype in (torch.float32, torch.float64):
        W = spd_on_device(256, 1, 3, dtype, dev) * 256
        ms = measure_ms(panelchol.panel_factor, W, warmup=3, reps=20)
        plain = measure_ms(panelchol.panel_factor_reference, W, warmup=1,
                           reps=3)
        if dtype == torch.float32:
            k2.update(ms=ms, plain_ms=plain)
        print(f"[10 K2 p=256 B=1 {str(dtype).split('.')[-1]}] K2 {ms:.4f} "
              f"ms, twin {plain:.4f} ms; card {card}", flush=True)
    # how K2's time scales: with p (work per block) and with the batch
    # (blocks on other SMs)
    scaling = []
    for p, batch in ((64, 1), (128, 1), (256, 8), (256, 132)):
        W = spd_on_device(p, batch, 4, torch.float32, dev) * p
        scaling.append(f"p={p} B={batch} "
                       f"{measure_ms(panelchol.panel_factor, W, reps=10):.4f}")
    print(f"[10 K2 f32 scaling, ms per launch] {'; '.join(scaling)}; card "
          f"{card}", flush=True)
    A = spd_on_device(8192, 1, 5, torch.float32, dev)[0]
    t_k2 = measure_ms(largechol.large_cholesky, A, 256, "cuda", warmup=1,
                      reps=3)
    t_tw = measure_ms(largechol.large_cholesky, A, 256, "torch", warmup=1,
                      reps=1)
    t_lib = measure_ms(torch.linalg.cholesky_ex, A, warmup=1, reps=3)
    gflop = 8192 ** 3 / 3 / 1e9
    print(f"[10 large_cholesky n=8192 f32] K2 panels {t_k2:.2f} ms "
          f"({gflop / t_k2:.2f} TFLOP/s), twin panels {t_tw:.2f} ms, "
          f"torch.linalg.cholesky_ex {t_lib:.2f} ms; card {card}",
          flush=True)
    print(f"[10 large_cholesky n=8192 f32, K2 panels] "
          f"{device_split(largechol.large_cholesky, A, 256, 'cuda')}",
          flush=True)
    del A

    g = grid_mrf.make_grid_mrf(*GRID, dtype=torch.float32, device=dev)
    prob = g.problem(jtj="dense")
    p0 = torch.zeros(g.nstate, dtype=torch.float32, device=dev)
    for label, ns in (("BlockedDenseNewtonSolver", BlockedDenseNewtonSolver()),
                      ("DenseNewtonSolver", DenseNewtonSolver())):
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            optimize(prob, p0, bench, newton_solver=ns)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        split = device_split(
            lambda: optimize(prob, p0, bench, newton_solver=ns))
        print(f"[10 grid {GRID} f32 solve, {label}] wall ms "
              f"{', '.join(f'{w:.1f}' for w in walls)}; {split}; "
              f"card {card}", flush=True)

    J = grid_jacobian(torch.float32, dev)[0]
    sched = tk.build_jtj_schedule(J.structure)
    v = torch.linspace(-1.0, 1.0, J.structure.nstate, device=dev)
    for key, fn, ref, args in (
            ("K3", tk.bcsr_jtj_blocks_kernel, tk.bcsr_jtj_blocks_reference,
             (J, sched)),
            ("K4", tk.bcsr_matvec_kernel, tk.bcsr_matvec_reference, (J, v))):
        ms = measure_ms(fn, *args, warmup=3, reps=20)
        plain = measure_ms(ref, *args, warmup=3, reps=20)
        k34[key].update(ms=ms, plain_ms=plain)
        print(f"[10 {key} grid {GRID} f32] kernel {ms:.4f} ms, twin "
              f"{plain:.4f} ms; card {card}", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    card = card_line()
    print(f"[1 card] {card}", flush=True)
    print(f"[1 versions] python {platform.python_version()} torch "
          f"{torch.__version__} cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)} count "
          f"{torch.cuda.device_count()}", flush=True)
    # hazard F1: float32 products must be true float32, never TF32
    check(torch.backends.cuda.matmul.allow_tf32 is False,
          "torch.backends.cuda.matmul.allow_tf32 is False")
    check(torch.get_float32_matmul_precision() == "highest",
          "float32 matmul precision is 'highest'")

    from libdogleg_tpu_torch import DoglegParameters, sample
    from libdogleg_tpu_torch.models import quadratic_surface as qs
    from libdogleg_tpu_torch.native import loader
    from libdogleg_tpu_torch.ops import mega
    from libdogleg_tpu_torch.parallel import batched_optimize
    from libdogleg_tpu_torch.utils.benchtime import measure_ms

    dev = torch.device("cuda")
    bench = DoglegParameters(**BENCH)

    # 2. build
    info = loader.build()
    loader.load_library()
    print(f"[2 build] {info.path.name} in {info.seconds:.2f} s", flush=True)
    for line in info.log.splitlines():
        if ("registers" in line or "spill" in line
                or "entry function" in line):
            print(f"[2 ptxas] {line.strip()}", flush=True)

    # 3. kernel vs twin
    args64 = instances(0, 1024, torch.float64, dev)
    r_k = mega.megakernel_optimize(*args64)
    r_t = mega.megakernel_optimize_reference(*args64)
    torch.cuda.synchronize()
    for field in ("step_count", "n_attempts", "reason"):
        check(torch.equal(getattr(r_k, field), getattr(r_t, field)),
              f"f64 {field} identical")
    err64 = (r_k.p - r_t.p).abs().max().item()
    check(torch.allclose(r_k.p, r_t.p, rtol=1e-9, atol=0.0),
          "f64 p within rtol 1e-9")
    print(f"[3 f64 B=1024] decisions identical; max |dp| {err64:.3e} "
          f"(rtol 1e-9); reasons "
          f"{torch.bincount(r_k.reason, minlength=7).tolist()}", flush=True)

    args32 = instances(1, BATCH, torch.float32, dev)
    r_k = mega.megakernel_optimize(*args32, bench)
    r_t = mega.megakernel_optimize_reference(*args32, bench)
    torch.cuda.synchronize()
    same = ((r_k.step_count == r_t.step_count)
            & (r_k.n_attempts == r_t.n_attempts))
    agree = same.float().mean().item()
    rec_k, rec_t = recovered_frac(r_k.p), recovered_frac(r_t.p)
    max_abs_err = (r_k.p - r_t.p).abs()[same].max().item()
    check(agree >= 0.85, f"f32 decision agreement {agree} >= 0.85")
    check(rec_k >= 0.99, f"f32 kernel recovered_frac {rec_k} >= 0.99")
    check(torch.allclose(r_k.norm2_x, r_t.norm2_x, rtol=1e-2, atol=1e-4),
          "f32 norm2_x within rtol 1e-2, atol 1e-4")
    print(f"[3 f32 B={BATCH}] decision agreement {agree:.4f} (>= 0.85); "
          f"recovered_frac kernel {rec_k:.4f} twin {rec_t:.4f} (>= 0.99); "
          f"max |dp| where decisions agree {max_abs_err:.3e}", flush=True)

    # 4. the public path, counted
    p0, meas, _, _ = instances(2, BATCH, torch.float32, dev)
    mega.launch_count = 0
    r = batched_optimize(qs.products, p0, bench, problem_data=meas)
    torch.cuda.synchronize()
    launches = mega.launch_count
    rec = recovered_frac(r.p)
    check(launches >= 1, "batched_optimize launched K1")
    check(r.p.shape == (BATCH, qs.NSTATE) and bool(torch.isfinite(r.p).all())
          and bool(torch.isfinite(r.norm2_x).all()),
          "finite (B, 6) result")
    check(bool((r.reason > 0).all()), "every problem terminated")
    check(rec >= 0.99, f"public path recovered_frac {rec} >= 0.99")
    print(f"[4 batched_optimize B={BATCH} f32] K1 launches {launches}; "
          f"recovered_frac {rec:.4f}; reasons "
          f"{torch.bincount(r.reason, minlength=7).tolist()}", flush=True)

    # 5. the single-solve CLI on the card
    for mode in sample.MODES:
        t0 = time.perf_counter()
        rc = sample.main(["--check", "--device", "cuda", mode])
        check(rc == 0, f"sample --check --device cuda {mode}")
        print(f"[5 sample {mode}] rc 0 in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)

    # 6. timing at the main path's shapes
    ms = measure_ms(mega.megakernel_optimize, *args32, bench, warmup=3,
                    reps=20)
    plain_ms = measure_ms(mega.megakernel_optimize_reference, *args32,
                          bench, warmup=1, reps=5)
    print(f"[6 timing B={BATCH} f32] K1 {ms:.4f} ms "
          f"({BATCH / ms * 1e3:.0f} solves/s); twin {plain_ms:.4f} ms "
          f"({BATCH / plain_ms * 1e3:.0f} solves/s); card {card}",
          flush=True)

    k2 = phase7_panel(dev)
    k2.update(phase8_slice(dev, bench))
    k34 = phase9_bcsr(dev)
    phase10_timing(dev, bench, card, k2, k34)

    def entry(name, source, replaces, d):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": d["launches"],
                "max_abs_err": d["max_abs_err"], "ms": d["ms"],
                "plain_ms": d["plain_ms"]}
    print(json.dumps({"kernels": [
        entry("megakernel_optimize", "libdogleg_tpu_torch/csrc/mega.cu",
              "libdogleg_tpu/ops/pallas_mega.py:522",
              dict(launches=launches, max_abs_err=max_abs_err, ms=ms,
                   plain_ms=plain_ms)),
        entry("panel_factor", "libdogleg_tpu_torch/csrc/panelchol.cu",
              "libdogleg_tpu/ops/pallas_panelchol.py:157", k2),
        entry("bcsr_jtj_blocks_kernel", "libdogleg_tpu_torch/csrc/bcsr.cu",
              "libdogleg_tpu/ops/pallas_bcsr.py:117", k34["K3"]),
        entry("bcsr_matvec_kernel", "libdogleg_tpu_torch/csrc/bcsr.cu",
              "libdogleg_tpu/ops/pallas_bcsr.py:212", k34["K4"])]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
