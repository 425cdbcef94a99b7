#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (libdogleg_tpu_torch) once on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

It holds and times the kernels the package ships; the grid of K1's lanes
per problem that chose them is artifacts/exp_torch_k1_parent.py's.

Phases, each printing its own lines:
  1. the card (nvidia-smi name and power limit) and the software versions;
  2. build the kernels (csrc/*.cu) from the checkout with nvcc, with
     ptxas's registers and spills, and the lanes per problem of K1's two
     instances as the library reports them;
  3. K1 against its plain PyTorch twin on the card, on numpy-seeded inputs:
     float64 at B=1024 and at B = 1, 31, 1000, 8193 (identical decisions,
     p within rtol 1e-9) and float32 at B=8192 under the benchmark stopping
     rule (decision agreement >= 0.85, kernel recovered_frac >= 0.99,
     norm2_x within rtol 1e-2, atol 1e-4); the general device function
     alone against grouped_products_reference (float64 1e-12, float32 1e-5
     of products_magnitude, at the starts and near the truth);
  4. the public path: batched_optimize(quadratic_surface.products, ...) on
     8192 float32 problems, which must launch K1 and recover >= 99%; its
     host wall, alone and over a loop of calls ended by one synchronize,
     and a call that must not wait for the card;
  5. the single-solve CLI, `sample --check --device cuda <mode>`, in every
     ported mode (float64), `factored` among them, and its diagnostic
     streams `--diag vnlog dense` and `--test-gradients dense`;
  6. CUDA-event timing of K1 and of the twin at B=8192 float32, and the
     attempts a problem took;
  7. K2 (csrc/panelchol.cu) against its twin: panels p in {16, 32, 64, 128,
     240, 256}, batch {1, 8}, float32 and float64 (L and inv(L) within 1e-10
     (f64) or 2e-4 (f32) of their largest entry, L inv(L) within the same of
     the identity, zeros above both diagonals, ok identical), a non-SPD
     panel (ok False in both), a panel with a NaN entry (ok False, nothing
     hangs), and large_cholesky(panel_impl="cuda") at n=2048 x 8 and
     n=8192 x 1 in float32 against a float64 factor (max error / max |L|
     below 1e-4);
  8. the slice at full width: the 32x32x8 grid MRF (Nstate 8192),
     optimize(grid.problem(jtj="dense"), 0, PRM,
     newton_solver=BlockedDenseNewtonSolver()) in float32 with >= 32 K2
     launches, reason > 0, max|Jt_x| <= 1e-3 and p within 1e-3 (abs) of
     the float64 solve; in float64 panel_impl="cuda" against "torch"
     (identical decisions, p within rtol 1e-9); the dense-coupling grid
     once in float32;
  9. K3 and K4 (csrc/bcsr.cu): the opt-in entry points driven once on the
     full-width dense-coupling grid Jacobian (8 x 8 blocks), then held
     against their twins there, on a 512 x 16 pattern of (32, 128) blocks
     and on patterns with empty block rows of (8, 8), (4, 8) and (3, 5)
     blocks, so that both kernels of each run (the 16-byte-word ones and
     the generic ones), in float32 (1e-4 of the largest entry) and float64
     (1e-12); the kernels that ran read from a profiler trace, which must
     show those that jtj_instance and matvec_instance name; on the (8, 8)
     patterns K3 also through values that are not 16-byte aligned, whose
     generic kernel (jtj_blocks in the trace) must give the word kernel's
     bits;
 10. CUDA-event timing: K2 and its twin at p=256, K2 alone and each of its
     two kernels alone (profiler), large_cholesky at n=8192 with K2 and
     torch.linalg.cholesky_ex in alternating turns and with the twin, the
     slice's whole solve with BlockedDenseNewtonSolver and DenseNewtonSolver
     (host wall and a profiler's device-time split), K3 and K4 and their
     twins, K4 and
     torch.mv of the BSR tensor in alternating turns, each kernel alone
     (profiler, the word kernels by name), and a later call on one
     structure traced: no host-to-device copy, one launch of the word
     kernel;
 11. K6 and K7 (csrc/tilechol.cu) against their twins: tiles n in {8, 16,
     24, 33, 40, 48, 64, 100, 128, 250, 256}, k in {1, 7, 455}, float64
     (1e-10 of the largest entry) and float32 (2e-4), zeros above the
     diagonal, K7 with m = n and m = 3 and, at k = 7, m in {1, 37, 130} and
     a row of NaN in C (it stays in its row), ok identical, and a batch with
     one non-SPD tile (ok False for that one only, from both, the others
     within tolerance);
 12. the block-sparse slice at full width, each problem analyzed once: the
     model's default optimize(grid.problem(), 0, PRM) (mindeg, simplicial,
     8x8 tiles) and config 6's SparseProblem(jtj="sparse", ordering="rcm",
     amalgamate=16) (supernodal, 128x128 tiles) in float32, K6 and K7
     launched, reason > 0, max|Jt_x| <= 1e-3, p within 1e-3 (abs) of the
     float64 solve; both in float64 on the card (kernels) against the same
     code on CPU tensors (twins): identical decisions, p within rtol 1e-9;
     the dense-coupling grid once, supernodal, in float32;
 13. timing: K6 at (21, 128, 128), (21, 256, 256) and (455, 8, 8), K7 at
     (68, 128, 128)
     and (1756, 8, 8), each in alternating turns with the one PyTorch call
     that computes the same (cholesky_ex, solve_triangular), against their
     twins, and alone (profiler); one factorize and one solve per path;
     each sparse solve's host wall, profiler split (K6, K7, products,
     scatter/gather, other, host and idle), its analysis time, and
     sparse_speedup_vs_dense against phase 10's dense-JtJ walls;
 14. K5 (csrc/batchchol.cu) against its plain version: n in {32, 40, 64,
     128, 256}, B in {1, 7, 512} (512 up to n = 128), float64 (1e-10 of the
     largest entry) and float32 (1e-5), ok identical, zeros above the
     diagonal, and a batch with one matrix that is not SPD (ok False for
     that one only, from both, the others within tolerance); which of its
     kernels ran, from a profiler trace;
 15. the mid-size batched slice at full width: the tanh family of the JAX
     benchmark's config 8 (bench_all.py:515-555), one instance per element,
     at (Nstate 64, batch 512) and (128, 256) in float32 through
     batched_optimize with no newton_solver: K5 launched, K1 not, every
     reason > 0, recovered_frac (all parameters within 0.05 of the truth)
     >= 0.99; in float64 at (64, 128) the card against the same call on
     CPU tensors (identical decisions, p within rtol 1e-9);
     batched_optimize_compacted at (64, 512) float32 (batched_optimize's
     decisions on every element);
 16. timing: K5, its plain version, batched torch.linalg.cholesky_ex and
     K6 at (512, 64, 64) and (256, 128, 128) float32, on the JtJ of the
     path's starts, K5 held to its plain version there, its streamed
     kernel the one the trace shows at both shapes; the substitutions
     (torch.cholesky_solve); K6 at (21, 128, 128) and K2's factor kernel
     at p = 256 alone beside K5, the three kernels sharing
     csrc/cholstage.cuh; the public call's
     host wall with the gate's strategy, with DenseNewtonSolver and
     compacted, attempts and K5 launches per solve, and a profiler split;
 17. K1's factored instance (the sufficient-statistics products): hazard F2,
     the device two_prod and two_sum on 2^20 pairs, exact and bit for bit
     the eager split forms; the device function against
     factored_products_minor at B=8192 (float64 rtol 1e-12, float32 the
     tolerances of tests/test_pallas_mega.py:177-183); the kernel against
     its twin in float64 at B=1024 (identical decisions, p within rtol
     1e-9; also at B = 1, 31, 1000, 8193) and in float32 at B=8192 under
     the benchmark rule (agreement >= 0.85, recovered_frac >= 0.99), the
     statistics made on the card; the
     public path, factored_statistics then
     batched_optimize(factored_products_fn(G), ...), at B=8192 float32: the
     factored K1 launched, the general one not, every reason > 0,
     recovered_frac >= 0.99; CUDA-event times of the kernel with its
     wrapper (in turns with phase 6's general K1), alone (profiler), its
     twin, the statistics transform, the whole call, and a profiler split;
     and the attempts a problem took;
 18. bundle adjustment through Schur elimination, no kernel of K1-K7 on its
     path: in float64 at a small size (linear BA nc 8, n_points 50, flat
     and tree; pinhole ncam 4, npts 60; sparse visibility ncam 8, npts 80)
     the card against the CPU (identical decisions and History step types,
     p within 1e-9); then bench_all.py's configs 4 (linear, nc 64,
     n_points 20000, flat SchurNewtonSolver, gate norm2_x < 1e-3, also
     with refine_iters=2), 7 (pinhole, ncam 32, npts 20000, 640000
     observations, the grid path, TreeSchurNewtonSolver, start p_true +
     0.02 N(0, 1), gate reason > 0 and norm2_x < 2 nobs) and 7s (sparse
     visibility, ncam 128, npts 50000, k_obs 4, SparseWSchurNewtonSolver
     with its chunked S and camera reductions, gate norm2_x < 2 nobs, also
     with refine_iters=2 and cam_gather) in float32 under the benchmark
     rule: each gate, the host wall and CUDA-event time of a solve, its
     host synchronizations, a profiler split of each config's plain leg
     (device time, device events, host and idle share), the camera-axis
     reductions and a second solve bit for bit, and the float64 solve of
     the same instance from the same start (costs, max |p32 - p64|);
 19. the analysis layer, no kernel of K1-K7 on its path: bench_all.py's
     config 5 (get_outlierness_factors, nmeas 100000, nstate 64,
     feature_size 2: float64 card vs CPU within rtol 1e-9, float32 vs
     float64, CUDA-event time of the float32 pass with its factorization,
     features/s, a per-op profile) and config 7o
     (get_outlierness_factors_ba on phase 18's config 7s float32 solution,
     the factorization taken once and reused: ok, every factor finite,
     two passes the same bits, float32 vs float64 at the same point,
     the pass's time and observations/s, its S^-1 T products alone, a
     per-op profile; at ncam 6, npts 60 float64 card vs CPU within rtol
     1e-7), and windowed query traces (256 queries, fs 2, w 16) on the
     32x32x8 grid's supernodal factor against its dense factor (float64,
     rtol 1e-9);
 20. batched structured solves, no kernel of K1-K7 on their path
     (batched_optimize over {"c", "q"} tree starts with
     TreeSchurNewtonSolver, each element with its own observations as
     problem_data): in float64 (B 8, ncam 4, npts 64) the card against the
     CPU (identical decisions, lambda and History step types, p within
     1e-9) and each element against its own single solve; bench_all.py's
     config 9 at full width (B 64, ncam 4, npts 2048, obs + 0.5 N(0, 1),
     starts p_true + 0.02 N(0, 1), float32): converged_frac (norm2_x < 2
     nobs) >= 0.95 and every reason > 0, solves/s by CUDA events with a
     dependent fetch, host walls, wavefronts, device events and host
     synchronizations a wavefront, the lambda histogram, a profiler split,
     two runs the same bits, batched_optimize_compacted in turns with it
     (the same decisions and bits on every element), the
     History on the batch (same bits otherwise) and, in float64 at npts
     256, four elements' History rows against their single solves; then
     config 7xl once (sparse visibility, ncam 256, npts 200000, k_obs 4,
     float32: gate norm2_x < 2 nobs, attempts, wall, device split,
     max_memory_allocated);
 21. the rest of the single solve and the batched sparse-W Schur solve:
     bench_all.py's config 2 (curve_fit, nmeas 64, Nstate 3; measurements
     and start from numpy's default_rng(0) and (1)) in its dense, products
     and residual forms, float32 and float64 (finite, reason > 0, float64
     decisions and History step types the CPU's, p within 1e-8; max |p -
     P_TRUE| and bench_all.py's recovered flag printed), one solve's host
     wall and CUDA events, and one attempt a segment against the one-shot
     run bit for bit; config 8 (Nstate 64, batch 512, float32) run 2
     attempts, saved with checkpoint.save_state, loaded onto the card and
     run to the end: bit for bit the one-shot run, K5 launched in both
     segments; the batched sparse-W solve in float64 (B 4, ncam 8, npts 80,
     k_obs 3) card vs CPU and each element vs its single solve; then
     config 7s at full width as the batch ba-sparse-batched-B8-f32 (ncam
     128, npts 50000, k_obs 4, obs + 0.5 N(0, 1), starts p_true + 0.02 N(0,
     1), S chunked): gate norm2_x < 2 nobs and reason > 0 on every element,
     wavefronts, the lambda histogram, device events and host
     synchronizations a wavefront, host walls and CUDA events a batch,
     peak memory, two runs the same bits, a profiler split, and the
     refined leg (refine_iters=2 with cam_gather) under the same gate;
 22. batched block-sparse solves and the native symbolic analysis: the host
     library's g++ build seconds; each analysis of the 32x32x8 and 64x64x8
     grids (the JtJ schedule, the block pattern of the scalar CSR pattern,
     mindeg, the simplicial and the rcm/amalgamate-16 supernodal symbolic
     factorization) through the host library and through its Python form,
     the same arrays and the seconds of each; a float64 batch (B 4, 8x8
     grids, b 4, coupling "dense", simplicial and amalgamate 4) through
     batched_optimize with SparseNewtonSolver, the card (K3, K6, K7)
     against the CPU (identical decisions, lambda and History step types,
     p within 1e-9); config 6b at full width (the 64x64x8 grid, Nstate
     32768, rcm/amalgamate 16: 45 levels, 1691 slots, the native analysis
     checked to have run) in float32 under PRM: reason > 0, finite p
     within 1e-3 of the float64 solve on the card, max|Jt_x|, host wall,
     CUDA events, a profiler split and the K3/K6/K7 launches, then the
     model's default problem (mindeg, simplicial, 611 levels) once under
     the same gate; grid-mrf-32x32x8-sparse-batched-B16-f32 (16 config-6
     grids, coupling "dense", element s seed s, one rcm/amalgamate-16
     analysis, each element's (z_prior, z_edge, mix) as problem_data):
     every reason > 0 and norm2_x finite, elements 0-3 within 1e-3 of
     their float64 single solves, every element its single solve's
     decisions, solves/s by CUDA events with a dependent fetch in turns
     with the 16 single solves, K3/K6/K7 launches a batch against the 16
     singles', one factorization of the batch launching K6 and K7 as
     often as a single one (by wrapper count and by kernel name in a
     trace), device events and host synchronizations a wavefront, the
     lambda histogram, peak memory, whether two runs give the same bits,
     a profiler split; K3 at both runs' shapes against its plain version
     (the index_add form) and in turns with it; K6 and K7 at the batch's
     widest FACTOR and SOLVE levels (16 x k tiles of 128 x 128) against
     their plain versions and in turns with cholesky_ex and
     solve_triangular.
     Each phase prints its seconds.
Then one JSON line about the kernels (time, plain version's time, the
library call's where one exists, and the bound from this run's shapes; K1
once per instance; K3, K6 and K7 with their launches on each path that
runs them, `launches` their sum), the card line again, and a last JSON
line with "ok": true. Any failure exits non-zero before the last line; so
does a machine without a CUDA device, or a directory without the package.
"""

from __future__ import annotations

import contextlib
import io
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
# config 8 of bench_all.py:577-578: (Nstate, batch), nmeas = 4 Nstate
MIDSIZE = ((64, 512), (128, 256))
# NVIDIA's data sheet for the H100 SXM: device memory rate, and the float32
# rate outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def bound(nbytes: float, flops: float) -> dict:
    """The least time the card could take: every input byte read once and
    every output byte written once at the memory rate, or the operations at
    the float32 rate, whichever is larger."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOP_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def nbytes_of(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def lower_nbytes(S) -> int:
    """Bytes of the lower triangles, diagonal included, of the (..., n, n)
    matrices S: what a factorization or a substitution that reads nothing
    above the diagonal must read of them."""
    n = S.shape[-1]
    return S.numel() // (n * n) * (n * (n + 1) // 2) * S.element_size()


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
    gx, gy = (t.numpy() for t in qs.make_grid(torch.float64, "cpu"))
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
        for p in (16, 32, 64, 128, 240, 256):
            eye = torch.eye(p, dtype=torch.float64, device=dev)
            for batch in (1, 8):
                W = spd_on_device(p, batch, p + batch, dtype, dev) * p
                L, Linv, ok = panelchol.panel_factor(W)
                Lr, Linvr, okr = panelchol.panel_factor_reference(W)
                torch.cuda.synchronize()
                check(ok.dtype == torch.bool and bool(ok.all())
                      and torch.equal(ok, okr),
                      f"K2 {name} p={p} B={batch} ok")
                check(bool((torch.triu(L, 1) == 0).all())
                      and bool((torch.triu(Linv, 1) == 0).all()),
                      f"K2 {name} p={p} zeros above both diagonals")
                e_l, e_i = rel_err(L, Lr), rel_err(Linv, Linvr)
                e_eye = float((L.double() @ Linv.double() - eye).abs().max())
                check(max(e_l, e_i, e_eye) < tol,
                      f"K2 {name} p={p} B={batch} within {tol}: "
                      f"{e_l:.3e} {e_i:.3e}, L inv(L) - I {e_eye:.3e}")
                abs_err = max(float((L - Lr).abs().max()),
                              float((Linv - Linvr).abs().max()))
                if dtype == torch.float32 and p == 256 and batch == 1:
                    out["max_abs_err"] = abs_err
                print(f"[7 K2 {name} p={p} B={batch}] vs twin: L {e_l:.3e} "
                      f"inv(L) {e_i:.3e} of max, |L inv(L) - I| {e_eye:.3e} "
                      f"(tol {tol}); max abs {abs_err:.3e}", flush=True)
        W = spd_on_device(256, 2, 1, dtype, dev) * 256
        W[1, 100, 100] = -W[1, 100, 100]
        _, _, ok = panelchol.panel_factor(W)
        _, _, okr = panelchol.panel_factor_reference(W)
        check(ok.tolist() == okr.tolist() == [True, False],
              f"K2 {name} non-SPD panel flagged: {ok.tolist()} "
              f"{okr.tolist()}")
        print(f"[7 K2 {name} non-SPD] ok {ok.tolist()} (twin "
              f"{okr.tolist()})", flush=True)
        # a NaN entry: ok False for its panel, from both, and nothing hangs
        W = spd_on_device(256, 2, 2, dtype, dev) * 256
        W[0, 40, 17] = W[0, 17, 40] = float("nan")
        L, _, ok = panelchol.panel_factor(W)
        Lr, _, okr = panelchol.panel_factor_reference(W)
        torch.cuda.synchronize()
        check(ok.tolist() == okr.tolist() == [False, True],
              f"K2 {name} a NaN entry flags its panel: {ok.tolist()} "
              f"{okr.tolist()}")
        check(rel_err(L[1], Lr[1]) < tol,
              f"K2 {name} the panel beside a NaN panel within {tol}")
        print(f"[7 K2 {name} NaN entry] ok {ok.tolist()} (twin "
              f"{okr.tolist()}), the other panel within {tol}", flush=True)
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
        # no device given: the constructors' default is the card
        g = grid_mrf.make_grid_mrf(*GRID, coupling=coupling, dtype=dtype)
        check(g.z_prior.device.type == "cuda", "the default device is cuda")
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


def random_bcsr(nbrow, nbcol, bm, bn, density, seed, dtype, device,
                empty_rows=()):
    """A block-CSR Jacobian on a random pattern (every row stores column
    0, except `empty_rows`, which store nothing), values drawn on the
    card."""
    import torch

    from libdogleg_tpu_torch.ops.bcsr import BCSRJacobian, BCSRStructure
    rng = np.random.default_rng(seed)
    mask = rng.uniform(size=(nbrow, nbcol)) < density
    mask[:, 0] = True
    mask[list(empty_rows)] = False
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
    from libdogleg_tpu_torch.ops.bcsr import BCSRJacobian
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
        # K4's two kernels: the 16-byte-word one on (8, 8), the generic one
        # on (4, 8), (3, 5) and (32, 128); patterns with empty rows
        cases = (("grid 8x8", grid_jacobian(dtype, dev)[0], "words"),
                 ("512x16 of 32x128",
                  random_bcsr(512, 16, 32, 128, 0.25, 9, dtype, dev), "rows"),
                 ("300x40 of 8x8, empty rows",
                  random_bcsr(300, 40, 8, 8, 0.2, 10, dtype, dev,
                              empty_rows=(0, 7, 299)), "words"),
                 ("301x40 of 4x8, empty rows",
                  random_bcsr(301, 40, 4, 8, 0.2, 11, dtype, dev,
                              empty_rows=(0, 150, 300)), "rows"),
                 ("97x24 of 3x5, empty rows",
                  random_bcsr(97, 24, 3, 5, 0.3, 12, dtype, dev,
                              empty_rows=(1, 96)), "rows"))
        for label, Jc, instance in cases:
            st = Jc.structure
            check(tk.matvec_instance(st.block_rows, st.block_cols, dtype)
                  == instance, f"K4 {name} {label} takes the {instance} "
                  f"kernel")
            # K3's kernels: the word kernel where K4 takes its word kernel
            k3_instance = tk.jtj_instance(st.block_rows, st.block_cols, dtype)
            check(k3_instance == {"words": "words", "rows": "entries"}[
                instance], f"K3 {name} {label} takes the {k3_instance} kernel")
            sched = tk.build_jtj_schedule(Jc.structure)
            v = torch.linspace(-1.0, 1.0, Jc.structure.nstate, dtype=dtype,
                               device=dev)
            # the kernels that ran, from the trace, are those the two rules
            # name
            want = {K3_KERNELS[k3_instance], K4_KERNELS[instance]}
            ran = kernels_launched(
                lambda: (tk.bcsr_jtj_blocks_kernel(Jc, sched),
                         tk.bcsr_matvec_kernel(Jc, v)), (),
                (*K3_KERNELS.values(), *K4_KERNELS.values()), want)
            check(ran == want, f"K3/K4 {name} {label} launched {want} "
                  f"(profiler): {ran}")
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
            generic = ""
            if k3_instance == "words":
                # values that are not 16-byte aligned take the generic
                # kernel, which sums in the same order: the same bits
                buf = torch.empty(Jc.values.numel() + 1, dtype=dtype,
                                  device=dev)
                shifted = buf[1:].view(Jc.values.shape)
                shifted.copy_(Jc.values)
                Js = BCSRJacobian(st, shifted)
                other, _ = tk.bcsr_jtj_blocks_kernel(Js, sched)
                torch.cuda.synchronize()
                check(shifted.data_ptr() % 16 != 0
                      and torch.equal(other, blocks),
                      f"K3 {name} {label}: the generic kernel on unaligned "
                      f"values gives the word kernel's bits")
                ran_s = kernels_launched(
                    tk.bcsr_jtj_blocks_kernel, (Js, sched),
                    tuple(K3_KERNELS.values()), {K3_KERNELS["entries"]})
                check(ran_s == {K3_KERNELS["entries"]},
                      f"K3 {name} {label}: unaligned values launched "
                      f"jtj_blocks (profiler): {ran_s}")
                generic = (f"; unaligned values ({', '.join(ran_s)}, "
                           f"profiler) give the same bits")
                del buf, shifted, other, Js
            print(f"[9 {label} {name}] vs twins: K3 "
                  f"({K3_KERNELS[k3_instance]}, profiler) {e3:.3e} K4 "
                  f"({K4_KERNELS[instance]}, profiler) {e4:.3e} of max (tol "
                  f"{tol}){generic}; {len(sched.pair_i)} pairs, "
                  f"{Jc.structure.nnzb} blocks", flush=True)
            del Jc, blocks, blocks_r
    return out


def spd_tiles(n, k, seed, dtype, dev):
    """(k, n, n) SPD tiles A A^T / n + I (condition number below about 5),
    A drawn with numpy from `seed`, the product formed on the card."""
    import torch
    rng = np.random.default_rng(seed)
    A = torch.as_tensor(rng.normal(size=(k, n, n)), device=dev)
    eye = torch.eye(n, dtype=torch.float64, device=dev)
    return (A @ A.mT / n + eye).to(dtype)


def phase11_tiles(dev) -> dict:
    """K6 and K7 against their twins on the card: n in {8, 16, 24, 33, 40,
    48, 64, 100, 128, 250, 256}, k in {1, 7, 455}, float64 and float32, K7
    with m = n and m = 3 and, at k = 7, m in {1, 37, 130} and a row of NaN
    in C (it stays in its row), and a batch with one non-SPD tile (ok False
    for that one only, from both, the others within tolerance)."""
    import torch

    from libdogleg_tpu_torch.ops import tilechol
    out = {"K6": {"max_abs_err": 0.0}, "K7": {"max_abs_err": 0.0}}
    for dtype, tol in ((torch.float64, 1e-10), (torch.float32, 2e-4)):
        name = str(dtype).split(".")[-1]
        for n in (8, 16, 24, 33, 40, 48, 64, 100, 128, 250, 256):
            errs6, errs7 = [], []
            for k in (1, 7, 455):
                S = spd_tiles(n, k, 1000 * n + k, dtype, dev)
                L, ok = tilechol.tile_cholesky(S)
                Lr, okr = tilechol.tile_cholesky_reference(S)
                torch.cuda.synchronize()
                check(ok.dtype == torch.bool and bool(ok.all())
                      and torch.equal(ok, okr), f"K6 {name} n={n} k={k} ok")
                check(bool((torch.triu(L, 1) == 0).all()),
                      f"K6 {name} n={n} zeros above the diagonal")
                errs6.append(rel_err(L, Lr))
                check(errs6[-1] < tol, f"K6 {name} n={n} k={k} within "
                      f"{tol}: {errs6[-1]:.3e}")
                if dtype == torch.float32 and n in (8, 128):
                    out["K6"]["max_abs_err"] = max(
                        out["K6"]["max_abs_err"],
                        float((L - Lr).abs().max()))
                for m in (n, 3) + ((1, 37, 130) if k == 7 else ()):
                    rng = np.random.default_rng(7 * n + k + m)
                    C = torch.as_tensor(rng.normal(size=(k, m, n)),
                                        dtype=dtype, device=dev)
                    X = tilechol.tri_solve_right(Lr, C)
                    Xr = tilechol.tri_solve_right_reference(Lr, C)
                    torch.cuda.synchronize()
                    errs7.append(rel_err(X, Xr))
                    check(errs7[-1] < tol, f"K7 {name} n={n} k={k} m={m} "
                          f"within {tol}: {errs7[-1]:.3e}")
                    if dtype == torch.float32 and n in (8, 128) and m == n:
                        out["K7"]["max_abs_err"] = max(
                            out["K7"]["max_abs_err"],
                            float((X - Xr).abs().max()))
                if k == 7:
                    # a row of NaN in C: its row of X is NaN, no other is
                    C[2, 1] = float("nan")
                    Xn = tilechol.tri_solve_right(Lr, C)
                    bad = torch.isnan(Xn)
                    check(bool(bad[2, 1].all())
                          and int(bad.sum()) == C.shape[-1],
                          f"K7 {name} n={n} a row of NaN in C stays in "
                          f"its row")
                    keep = ~bad
                    check(rel_err(Xn[keep], Xr[keep]) < tol,
                          f"K7 {name} n={n} the rows beside a NaN row "
                          f"within {tol}")
                del S, L, Lr, C, X, Xr
            S = spd_tiles(n, 3, n, dtype, dev)
            S[1, n // 2, n // 2] = -S[1, n // 2, n // 2]
            L, ok = tilechol.tile_cholesky(S)
            Lr, okr = tilechol.tile_cholesky_reference(S)
            check(ok.tolist() == okr.tolist() == [True, False, True],
                  f"K6 {name} n={n} flags exactly the non-SPD tile: "
                  f"{ok.tolist()} {okr.tolist()}")
            e_good = rel_err(L[[0, 2]], Lr[[0, 2]])
            check(e_good < tol and bool((torch.triu(L, 1) == 0).all()),
                  f"K6 {name} n={n} the neighbours of a failed tile within "
                  f"{tol}: {e_good:.3e}")
            print(f"[11 K6/K7 {name} n={n}] vs twins, k 1/7/455: K6 max "
                  f"{max(errs6):.3e}, K7 (m = n, 3 and, at k = 7, 1, 37, "
                  f"130) max {max(errs7):.3e} of the largest entry (tol "
                  f"{tol}); a row of NaN in C stays in its row; one "
                  f"non-SPD tile: ok {ok.tolist()} (twin {okr.tolist()}), "
                  f"the others within {e_good:.3e}", flush=True)
    return out


# Device-time groups of the profiler splits: a kernel falls in the first
# group one of whose substrings its name holds, else in "other".
K2_GROUPS = (("K2", ("panelchol",)), ("gemm", ("gemm", "cutlass", "xmma")))
SPARSE_GROUPS = (("K6", ("tilechol",)), ("K7", ("trisolve",)),
                 ("products", ("gemm", "gemv", "cutlass", "xmma")),
                 ("scatter/gather", ("index", "scatter", "gather")))


def device_split(fn, *args, groups=K2_GROUPS) -> str:
    """Device time of one call of fn, summed by kernel group from a
    torch.profiler trace, beside the call's host wall, and the six device
    kernels with the most time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn(*args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    sums = {name: 0.0 for name, _ in groups}
    sums["other"] = 0.0
    kernels = 0
    by_name = []
    for ev in prof.key_averages():
        # device-side events only: a CPU op's device time repeats that of
        # the kernels it launched
        if ev.device_type != DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0.0))
        key = ev.key.lower()
        name = next((n for n, subs in groups
                     if any(sub in key for sub in subs)), "other")
        sums[name] += us
        kernels += ev.count
        by_name.append((us, ev.count, ev.key))
    total = sum(sums.values())
    if total == 0:
        return f"wall {wall * 1e3:.1f} ms; the profiler saw no device time"
    shares = " ".join(f"{k} {v / 1e3:.2f} ms ({100 * v / total:.1f}%)"
                      for k, v in sums.items())
    largest = "; ".join(
        f"{key[:60]} {us / 1e3:.2f} ms in {count}"
        for us, count, key in sorted(by_name, reverse=True)[:6])
    return (f"wall {wall * 1e3:.1f} ms (profiled); device {total / 1e3:.2f} "
            f"ms in {kernels} device events: {shares}; host and idle "
            f"{wall * 1e3 - total / 1e3:.1f} ms "
            f"({100 - 100 * total / 1e3 / (wall * 1e3):.1f}%); largest "
            f"kernels: {largest}")


def device_events(fn, args, reps: int):
    """The device-side events of `reps` calls of fn, from a torch.profiler
    trace. Now and then a trace comes back empty (the activity buffers of
    two traces taken in quick succession get lost): it is taken again after
    a growing pause, from the second time on with the host's activities
    traced too as device_split does, up to six times; then the list is
    empty."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn(*args)
    torch.cuda.synchronize()
    for attempt in range(6):
        time.sleep(0.5 * attempt)
        activities = [ProfilerActivity.CUDA]
        if attempt:
            activities.append(ProfilerActivity.CPU)
        with profile(activities=activities) as prof:
            for _ in range(reps):
                fn(*args)
            torch.cuda.synchronize()
        events = [ev for ev in prof.key_averages()
                  if ev.device_type == DeviceType.CUDA]
        if events:
            return events
    return []


def kernels_us(fn, args, names, reps: int = 20) -> dict:
    """Per name in `names`, the device time in microseconds per launch of
    the kernels whose names hold it, from one trace of `reps` calls of fn:
    the kernels alone, without their wrapper's host work. None where the
    profiler gave no such event."""
    traced = device_events(fn, args, reps)
    out = {}
    for name in names:
        events = [ev for ev in traced if name in ev.key.lower()]
        count = sum(ev.count for ev in events)
        total = sum(getattr(ev, "self_device_time_total",
                            getattr(ev, "self_cuda_time_total", 0.0))
                    for ev in events)
        out[name] = total / count if count else None
    return out


def kernel_us(fn, args, name: str, reps: int = 20):
    """kernels_us for one name."""
    return kernels_us(fn, args, (name,), reps)[name]


# the kernels' names, by the instance each wrapper's launcher chooses
K3_KERNELS = {"words": "jtj_words", "entries": "jtj_blocks"}
K4_KERNELS = {"words": "matvec_words", "rows": "matvec_kernel"}
K5_KERNELS = ("batchchol_streamed", "batchchol_kernel")


def kernels_launched(fn, args, names, want=None, reps: int = 3) -> set:
    """Which of `names` the kernels that `reps` calls of fn launched hold in
    their names, read from a profiler trace. A trace now and then loses an
    event: with `want` given, it is taken again, up to six times, until it
    shows exactly the names in `want`."""
    for _ in range(6):
        keys = [ev.key.lower() for ev in device_events(fn, args, reps)]
        found = {name for name in names if any(name in k for k in keys)}
        if want is None or found == set(want):
            break
    return found


def us_text(us) -> str:
    """A kernel_us reading for a printed line."""
    return ("not measured (the profiler returned no events)" if us is None
            else f"{us:.2f} us per launch (profiler)")


def bsr_tensor(J, v):
    """J as a torch.sparse_bsr_tensor, the operand of the one PyTorch call
    that computes K4's function (torch.mv), its indices on the card, held
    to K4's plain version first. None, with the error printed, where this
    PyTorch has no BSR matrix-vector product on the card."""
    import torch

    from libdogleg_tpu_torch.ops import bcsr_kernels as tk
    st = J.structure
    dev = J.values.device
    bsr = torch.sparse_bsr_tensor(
        torch.as_tensor(st.indptr, dtype=torch.int32, device=dev),
        torch.as_tensor(st.indices, dtype=torch.int32, device=dev),
        J.values, size=(st.nmeas, st.nstate))
    try:
        got = torch.mv(bsr, v)
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError) as e:
        print(f"[10 K4 library call] torch.mv on a BSR tensor raised: "
              f"{str(e).splitlines()[0][:200]}", flush=True)
        return None
    err = rel_err(got, tk.bcsr_matvec_reference(J, v))
    check(err < 1e-4, f"the BSR product computes K4's function: {err:.3e}")
    return bsr


def later_call_copies_nothing(fn, args, name: str) -> str:
    """A call of fn on a structure it has seen must find the index arrays
    on the card: the cache of device tensors holds the same tensors after
    the call as before it, and a profiler trace of ten calls shows no
    host-to-device copy and at most one launch a call of the kernel whose
    name holds `name` (a trace now and then loses an event, so fewer are
    taken for as many). Fails where the profiler gives no trace to show
    it."""
    from libdogleg_tpu_torch.ops import bcsr_kernels as tk

    def held():
        return {id(t) for per_array in tk._DEVICE_INDICES.values()
                for t in per_array.values()}
    fn(*args)
    before = held()
    fn(*args)
    check(held() == before, f"a later {name} call puts no new index tensor "
          f"on the card")
    calls = 10  # a trace of a single small kernel comes back empty more often
    events = device_events(fn, args, calls)
    check(bool(events), f"the profiler traced later {name} calls")
    copies = sum(ev.count for ev in events
                 if "memcpy" in ev.key.lower() and "htod" in ev.key.lower())
    launches = sum(ev.count for ev in events if name in ev.key.lower())
    check(copies == 0 and 0 < launches <= calls,
          f"a later {name} call copies nothing to the card and launches "
          f"once: {copies} copies, {launches} launches in {calls} calls")
    return (f"same cached index tensors, {copies} host-to-device copies, "
            f"{launches} launches in {calls} calls (profiler)")


def phase10_timing(dev, bench, card, k2, k34) -> dict:
    """CUDA-event times at the slice's shapes, with the card line. Returns
    the dense-JtJ solves' fastest walls in ms, by strategy."""
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
            # in: W's lower triangle (the function reads nothing above the
            # diagonal); out: L, inv(L), ok. p^3/3 for the factor and p^3/3
            # for the triangular inverse. No single PyTorch call gives both.
            k2.update(ms=ms, plain_ms=plain, library_ms=None,
                      **bound(lower_nbytes(W) + 2 * nbytes_of(W) + 1,
                              2 * 256 ** 3 / 3))
        # the kernels alone, from one trace: the factor and the inverse
        parts = kernels_us(panelchol.panel_factor, (W,),
                           ("panelchol_factor", "panelchol_inverse"))
        both = (None if None in parts.values() else sum(parts.values()))
        alone = (f"K2 alone {us_text(both)}: its factor kernel "
                 f"{us_text(parts['panelchol_factor'])}, its inverse kernel "
                 f"{us_text(parts['panelchol_inverse'])}")
        print(f"[10 K2 p=256 B=1 {str(dtype).split('.')[-1]}] K2 with its "
              f"wrapper {ms:.4f} ms, twin {plain:.4f} ms; {alone}; card "
              f"{card}", flush=True)
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
    turns = []
    for _ in range(2):  # in turns, so that a drift shows
        turns.append((measure_ms(largechol.large_cholesky, A, 256, "cuda",
                                 warmup=1, reps=3),
                      measure_ms(torch.linalg.cholesky_ex, A, warmup=1,
                                 reps=3)))
    t_tw = measure_ms(largechol.large_cholesky, A, 256, "torch", warmup=1,
                      reps=1)
    gflop = 8192 ** 3 / 3 / 1e9
    print(f"[10 large_cholesky n=8192 f32] K2 panels {turns[0][0]:.2f} / "
          f"{turns[1][0]:.2f} ms ({gflop / turns[0][0]:.2f} TFLOP/s), "
          f"torch.linalg.cholesky_ex {turns[0][1]:.2f} / {turns[1][1]:.2f} "
          f"ms (two turns), twin panels {t_tw:.2f} ms; card {card}",
          flush=True)
    print(f"[10 large_cholesky n=8192 f32, K2 panels] "
          f"{device_split(largechol.large_cholesky, A, 256, 'cuda')}",
          flush=True)
    del A

    g = grid_mrf.make_grid_mrf(*GRID, dtype=torch.float32, device=dev)
    prob = g.problem(jtj="dense")
    p0 = torch.zeros(g.nstate, dtype=torch.float32, device=dev)
    dense_walls = {}
    for label, ns in (("BlockedDenseNewtonSolver", BlockedDenseNewtonSolver()),
                      ("DenseNewtonSolver", DenseNewtonSolver())):
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            optimize(prob, p0, bench, newton_solver=ns)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        dense_walls[label] = min(walls)
        split = device_split(
            lambda: optimize(prob, p0, bench, newton_solver=ns))
        print(f"[10 grid {GRID} f32 solve, {label}] wall ms "
              f"{', '.join(f'{w:.1f}' for w in walls)}; {split}; "
              f"card {card}", flush=True)

    J = grid_jacobian(torch.float32, dev)[0]
    sched = tk.build_jtj_schedule(J.structure)
    v = torch.linspace(-1.0, 1.0, J.structure.nstate, device=dev)
    st = J.structure
    bm, bn = st.block_rows, st.block_cols
    # K3: the stored blocks, the int32 schedule (two indices per pair, one
    # run pointer per output block) and the float32 output blocks; one
    # (bn, bm) x (bm, bn) product per scheduled pair
    npairs, nout = len(sched.pair_i), len(sched.out_ci)
    k34["K3"].update(bound(
        nbytes_of(J.values) + 4 * (2 * npairs + nout + 1)
        + 4 * nout * bn * bn, 2.0 * npairs * bm * bn * bn))
    # K4: the stored blocks, indptr, indices, v and the output vector; one
    # (bm, bn) matrix-vector product per stored block
    k34["K4"].update(bound(
        nbytes_of(J.values, v) + 4 * (len(st.indptr) + len(st.indices))
        + 4 * st.nmeas, 2.0 * st.nnzb * bm * bn))
    # K3: no one PyTorch call gives the stored blocks of JtJ from block-CSR
    # values (a sparse-sparse product of BSR tensors is not implemented).
    # K4: a BSR tensor times v, timed in turns with K4.
    bsr = bsr_tensor(J, v)
    for key, fn, ref, args, kname in (
            ("K3", tk.bcsr_jtj_blocks_kernel, tk.bcsr_jtj_blocks_reference,
             (J, sched), K3_KERNELS["words"]),
            ("K4", tk.bcsr_matvec_kernel, tk.bcsr_matvec_reference, (J, v),
             K4_KERNELS["words"])):
        turns = []
        for _ in range(2):  # in turns, so that a drift shows
            turns.append((
                measure_ms(fn, *args, warmup=3, reps=20),
                measure_ms(torch.mv, bsr, v, warmup=3, reps=20)
                if key == "K4" and bsr is not None else None))
        plain = measure_ms(ref, *args, warmup=3, reps=20)
        alone = us_text(kernel_us(fn, args, kname))
        # the structure's index arrays went to the card at the first call
        later = later_call_copies_nothing(fn, args, kname)
        k34[key].update(ms=turns[0][0], plain_ms=plain,
                        library_ms=turns[0][1])
        library = ("none" if turns[0][1] is None else
                   f"torch.mv of the BSR tensor {turns[0][1]:.4f} / "
                   f"{turns[1][1]:.4f} ms")
        print(f"[10 {key} grid {GRID} f32] kernel with its wrapper "
              f"{turns[0][0]:.4f} / {turns[1][0]:.4f} ms, library call "
              f"{library} (two turns, CUDA events over 20 back-to-back "
              f"calls), twin {plain:.4f} ms; the kernel ({kname}) alone "
              f"{alone}; bound "
              f"{k34[key]['bound_ms'] * 1e3:.2f} us by "
              f"{k34[key]['bound_by']}; a later call: {later}; card {card}",
              flush=True)
    return dense_walls


def with_residual(prob, grid):
    """A copy of the sparse problem `prob` solving `grid`'s instance (same
    block pattern, another dtype, device or coupling), sharing its symbolic
    analysis instead of running it again."""
    import copy
    out = copy.copy(prob)
    object.__setattr__(out, "f", grid.problem(jtj="dense").f)
    return out


def phase12_sparse(dev, bench) -> dict:
    """The slice at full width: the model's default problem (mindeg,
    simplicial) and config 6's headline leg (rcm, amalgamate=16), each
    analyzed once."""
    import torch

    from libdogleg_tpu_torch import SparseProblem, optimize
    from libdogleg_tpu_torch.models import grid_mrf
    from libdogleg_tpu_torch.ops import bcsr_kernels as tk
    from libdogleg_tpu_torch.ops import tilechol

    def counts():
        return {"bcsr_jtj_blocks_kernel":
                tk.launch_counts["bcsr_jtj_blocks_kernel"],
                **tilechol.launch_counts}

    g = grid_mrf.make_grid_mrf(*GRID, dtype=torch.float32, device=dev)
    t0 = time.perf_counter()
    probs = {"simplicial": g.problem()}
    t1 = time.perf_counter()
    probs["supernodal"] = SparseProblem(
        f=g.problem(jtj="dense").f, structure=g.structure, jtj="sparse",
        ordering="rcm", amalgamate=16)
    t2 = time.perf_counter()
    analysis = {"simplicial": t1 - t0, "supernodal": t2 - t1}
    for name, prob in probs.items():
        sym = prob.default_newton_solver().symbolic
        inner = getattr(sym, "inner", sym)
        s = inner.sched
        print(f"[12 analysis {name}] {analysis[name]:.3f} s on the host: "
              f"block {inner.b}, {inner.nslots} slots, {s.nlevels} levels, "
              f"{len(s.upd_tgt)} UPDATE, {len(s.fac)} FACTOR, "
              f"{len(s.sol_tgt)} SOLVE ops (at most "
              f"{int(np.diff(s.fac_off).max())} FACTOR and "
              f"{int(np.diff(s.sol_off).max())} SOLVE in a level); "
              f"{len(inner.fwd.pair_off) - 1} forward and "
              f"{len(inner.bwd.pair_off) - 1} backward levels", flush=True)

    p0 = torch.zeros(g.nstate, dtype=torch.float32, device=dev)
    tk.launch_counts["bcsr_jtj_blocks_kernel"] = 0
    for k in tilechol.launch_counts:
        tilechol.launch_counts[k] = 0
    r32, walls, per_leg = {}, {}, {}
    for name, prob in probs.items():
        before = counts()
        t0 = time.perf_counter()
        r32[name] = optimize(prob, p0, bench)
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        per_leg[name] = {k: v - before[k] for k, v in counts().items()}
    # read here, before the float64 and coupling="dense" solves below
    launches = counts()
    check(all(v > 0 for v in launches.values()),
          f"K3, K6 and K7 launched on the main path: {launches}")

    g64 = grid_mrf.make_grid_mrf(*GRID, dtype=torch.float64, device=dev)
    g64c = grid_mrf.make_grid_mrf(*GRID, dtype=torch.float64, device="cpu")
    for name, prob in probs.items():
        r = r32[name]
        jtx = float(r.Jt_x.abs().max())
        check(r.p.shape == (g.nstate,) and bool(torch.isfinite(r.p).all()),
              f"{name}: finite ({g.nstate},) p")
        check(int(r.reason) > 0, f"{name}: the f32 solve terminated")
        check(jtx <= 1e-3, f"{name}: f32 max|Jt_x| {jtx:.3e} <= 1e-3")
        before = dict(tilechol.launch_counts)
        r64 = optimize(with_residual(prob, g64),
                       torch.zeros(g.nstate, dtype=torch.float64,
                                   device=dev))
        torch.cuda.synchronize()
        check(all(tilechol.launch_counts[k] > before[k] for k in before),
              f"{name}: the f64 card solve launched K6 and K7")
        t0 = time.perf_counter()
        r64c = optimize(with_residual(prob, g64c),
                        torch.zeros(g.nstate, dtype=torch.float64))
        wall_cpu = time.perf_counter() - t0
        for field in ("step_count", "n_attempts", "reason"):
            check(int(getattr(r64, field)) == int(getattr(r64c, field)),
                  f"{name}: f64 card vs CPU {field} identical")
        dp64 = float((r64.p.cpu() - r64c.p).abs().max())
        check(torch.allclose(r64.p.cpu(), r64c.p, rtol=1e-9, atol=1e-12),
              f"{name}: f64 card vs CPU p within rtol 1e-9: {dp64:.3e}")
        dp = float((r.p.double() - r64.p).abs().max())
        check(dp <= 1e-3, f"{name}: f32 p within 1e-3 of f64: {dp:.3e}")
        print(f"[12 grid {GRID} {name} f32 PRM] step_count "
              f"{int(r.step_count)} n_attempts {int(r.n_attempts)} reason "
              f"{int(r.reason)}; max|Jt_x| {jtx:.3e} (<= 1e-3); max |p32 - "
              f"p64| {dp:.3e} (<= 1e-3); wall {walls[name]:.3f} s (first "
              f"call)", flush=True)
        print(f"[12 grid {GRID} {name} f64] card (K6, K7) vs CPU (twins): "
              f"step_count {int(r64.step_count)} n_attempts "
              f"{int(r64.n_attempts)} reason {int(r64.reason)} identical; "
              f"max |dp| {dp64:.3e} (rtol 1e-9); CPU wall {wall_cpu:.2f} s",
              flush=True)
    print(f"[12 main path] kernel launches over both f32 solves: "
          f"{launches}; per solve: {per_leg}", flush=True)

    gd = grid_mrf.make_grid_mrf(*GRID, coupling="dense",
                                dtype=torch.float32, device=dev)
    rd = optimize(with_residual(probs["supernodal"], gd), p0, bench)
    jtxd = float(rd.Jt_x.abs().max())
    check(int(rd.reason) > 0 and jtxd <= 1e-3,
          f"dense-coupling supernodal f32 solve: reason {int(rd.reason)}, "
          f"max|Jt_x| {jtxd:.3e}")
    print(f"[12 grid {GRID} coupling=dense supernodal f32 PRM] reason "
          f"{int(rd.reason)} step_count {int(rd.step_count)}; max|Jt_x| "
          f"{jtxd:.3e}", flush=True)
    return {"probs": probs, "analysis": analysis, "launches": launches,
            "p0": p0}


def phase13_timing(dev, bench, card, sparse, tiles, dense_walls) -> None:
    """CUDA-event times of K6 and K7 at the slice's shapes against their
    twins, of one factorize and one solve per path, and the whole sparse
    solves' host wall and device split."""
    import torch

    from libdogleg_tpu_torch import optimize
    from libdogleg_tpu_torch import sparse_cholesky as sc
    from libdogleg_tpu_torch import supernodal as sn
    from libdogleg_tpu_torch.ops import tilechol
    from libdogleg_tpu_torch.utils.benchtime import measure_ms

    for key, n, k in (("K6", 128, 21), ("K6", 256, 21), ("K6", 8, 455),
                      ("K7", 128, 68), ("K7", 8, 1756)):
        S = spd_tiles(n, k, n + k, torch.float32, dev)
        if key == "K6":
            fn, ref, args = (tilechol.tile_cholesky,
                             tilechol.tile_cholesky_reference, (S,))
        else:
            L = tilechol.tile_cholesky_reference(S)[0]
            C = torch.as_tensor(np.random.default_rng(k).normal(
                size=(k, n, n)), dtype=torch.float32, device=dev)
            fn, ref, args = (tilechol.tri_solve_right,
                             tilechol.tri_solve_right_reference, (L, C))
        # the one PyTorch call that computes the same function
        if key == "K6":
            lib, lib_args = torch.linalg.cholesky_ex, (S,)
            # in: the tiles' lower triangles (the function reads nothing
            # above the diagonal); out: L and ok (a byte a tile). n^3/3
            # operations a tile
            limit = bound(lower_nbytes(S) + nbytes_of(S) + k,
                          k * n ** 3 / 3)
        else:
            lib, lib_args = (lambda D, Cm: torch.linalg.solve_triangular(
                D.mT, Cm, upper=True, left=False)), (L, C)
            # in: D's lower triangle (the function reads nothing above the
            # diagonal) and C; out: X. m n^2 operations a tile (m = n here)
            limit = bound(lower_nbytes(L) + 2 * nbytes_of(C),
                          float(k) * n * n * n)
        turns = []
        for _ in range(2):  # in turns, so that a drift shows
            turns.append((measure_ms(fn, *args, warmup=3, reps=20),
                          measure_ms(lib, *lib_args, warmup=3, reps=20)))
        plain = measure_ms(ref, *args, warmup=3, reps=20)
        alone = us_text(kernel_us(fn, args, "tilechol" if key == "K6" else
                                  "trisolve"))
        if n == 128:
            tiles[key].update(ms=turns[0][0], plain_ms=plain,
                              library_ms=turns[0][1], **limit)
        print(f"[13 {key} ({k}, {n}, {n}) f32] kernel with its wrapper "
              f"{turns[0][0]:.4f} / {turns[1][0]:.4f} ms, library call "
              f"{turns[0][1]:.4f} / {turns[1][1]:.4f} ms (two turns, CUDA "
              f"events over 20 back-to-back calls), twin {plain:.4f} ms; "
              f"the kernel alone {alone}; "
              f"bound {limit['bound_ms'] * 1e3:.2f} us by "
              f"{limit['bound_by']}; card {card}", flush=True)

    probs, p0 = sparse["probs"], sparse["p0"]
    for name, prob in probs.items():
        ns = prob.default_newton_solver()
        blocks = prob.products(p0).JtJ
        be = sn if name == "supernodal" else sc
        L, ok = be.factorize(ns.symbolic, blocks, 0.0)
        rhs = torch.linspace(-1.0, 1.0, p0.shape[0], device=dev)
        for label, fn, args in (
                ("factorize", be.factorize, (ns.symbolic, blocks, 0.0)),
                ("solve", be.solve, (ns.symbolic, L, rhs))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(*args)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            ms = measure_ms(fn, *args, warmup=1, reps=5)
            print(f"[13 {name} {label} f32] {ms:.3f} ms per call (CUDA "
                  f"events over 5 back-to-back calls), host wall of one "
                  f"call {wall:.3f} ms; card {card}", flush=True)
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            optimize(prob, p0, bench)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        split = device_split(lambda: optimize(prob, p0, bench),
                             groups=SPARSE_GROUPS)
        speedup = " ".join(
            f"{dense_walls[k] / min(walls):.2f}x vs {k}"
            for k in ("DenseNewtonSolver", "BlockedDenseNewtonSolver"))
        print(f"[13 grid {GRID} f32 solve, {name}] wall ms "
              f"{', '.join(f'{w:.1f}' for w in walls)}; {split}; analysis "
              f"{sparse['analysis'][name]:.3f} s; sparse_speedup_vs_dense "
              f"{speedup} (phase 10 walls); card {card}", flush=True)


def midsize_family(nstate, batch, dtype, dev, meas_factor=4):
    """Config 8's problem family (bench_all.py:522-536), letter for letter:
    r = A tanh(B p) + C p - d, one (A, B, C, d) per element, drawn from
    np.random.default_rng(8) in that order and with those scales, A, B and C
    rounded to `dtype` before d is formed from them. Returns the problem
    data and the starts on `dev`, and the true states."""
    import torch
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    nmeas = meas_factor * nstate
    rng = np.random.default_rng(8)
    A = rng.normal(size=(batch, nmeas, nstate)).astype(np_dtype)
    Bm = (rng.normal(size=(batch, nstate, nstate)) * 0.5
          / np.sqrt(nstate)).astype(np_dtype)
    C = (rng.normal(size=(batch, nmeas, nstate)) * 0.3).astype(np_dtype)
    p_true = rng.normal(size=(batch, nstate))
    d = (np.einsum('bms,bs->bm', A,
                   np.tanh(np.einsum('bst,bt->bs', Bm, p_true)))
         + np.einsum('bms,bs->bm', C, p_true)
         + rng.normal(size=(batch, nmeas)) * 0.01)
    p0 = p_true + rng.normal(size=(batch, nstate)) * 0.1

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=dev)
    return (t(A), t(Bm), t(C), t(d)), t(p0), p_true


def midsize_products(p, data):
    """Config 8's per-element products with the analytic Jacobian
    (bench_all.py:538-546)."""
    import torch

    from libdogleg_tpu_torch import Products
    Ab, Bb, Cb, db = data
    t = torch.tanh(Bb @ p)
    x = Ab @ t + Cb @ p - db
    J = Ab @ ((1.0 - t * t)[:, None] * Bb) + Cb
    return Products(norm2_x=x @ x, Jt_x=J.T @ x, JtJ=J.T @ J)


def midsize_recovered(p, p_true) -> float:
    """Share of problems with every parameter within 0.05 of the truth
    (bench_all.py:552-555)."""
    err = np.abs(p.double().cpu().numpy() - p_true)
    return float(np.mean(np.all(err < 0.05, axis=-1)))


def phase14_batchchol(dev) -> None:
    """K5 against its plain version on the card."""
    import torch

    from libdogleg_tpu_torch.ops import batchchol
    for dtype, tol in ((torch.float64, 1e-10), (torch.float32, 1e-5)):
        name = str(dtype).split(".")[-1]
        first = True
        for n in (32, 40, 64, 128, 256):
            errs = []
            for B in (1, 7, 512):
                if B == 512 and n > 128:
                    continue
                S = spd_tiles(n, B, 100 * n + B, dtype, dev) * n
                L, ok = batchchol.batched_blocked_cholesky(S)
                if first:
                    torch.cuda.synchronize()
                    first = False
                Lr, okr = batchchol.batched_blocked_cholesky_reference(S)
                torch.cuda.synchronize()
                check(L.shape == S.shape and ok.shape == (B,)
                      and ok.dtype == torch.bool,
                      f"K5 {name} n={n} B={B} shapes, ok a bool tensor")
                check(bool(ok.all()) and torch.equal(ok, okr),
                      f"K5 {name} n={n} B={B} ok")
                check(bool((torch.triu(L, 1) == 0).all()),
                      f"K5 {name} n={n} zeros above the diagonal")
                errs.append(rel_err(L, Lr))
                check(errs[-1] < tol, f"K5 {name} n={n} B={B} within {tol}: "
                      f"{errs[-1]:.3e}")
                del S, L, Lr
            S = spd_tiles(n, 5, n, dtype, dev) * n
            h = S.shape[-1] // 2
            S[3, h, h] = -S[3, h, h]
            L, ok = batchchol.batched_blocked_cholesky(S)
            Lr, okr = batchchol.batched_blocked_cholesky_reference(S)
            torch.cuda.synchronize()
            want = [True, True, True, False, True]
            check(ok.tolist() == okr.tolist() == want,
                  f"K5 {name} n={n} flags exactly the matrix that is not "
                  f"SPD: {ok.tolist()} {okr.tolist()}")
            good = [0, 1, 2, 4]
            e_good = rel_err(L[good], Lr[good])
            check(e_good < tol, f"K5 {name} n={n} the neighbours of a failed "
                  f"matrix within {tol}: {e_good:.3e}")
            ran = kernels_launched(batchchol.batched_blocked_cholesky, (S,),
                                   K5_KERNELS)
            check(len(ran) == 1, f"K5 {name} n={n} launched one of its "
                  f"kernels (profiler): {ran}")
            print(f"[14 K5 {name} n={n}, {ran.pop()} (profiler)] vs its "
                  f"plain version, B 1/7/512: "
                  f"max {max(errs):.3e} of the largest entry (tol {tol}); "
                  f"one matrix not SPD: ok {ok.tolist()} from both, the "
                  f"others within {e_good:.3e}", flush=True)


def phase15_midsize(dev, bench) -> dict:
    """The mid-size batched slice at config 8's full width."""
    import torch

    from libdogleg_tpu_torch import BlockedDenseNewtonSolver
    from libdogleg_tpu_torch.ops import batchchol, mega
    from libdogleg_tpu_torch.parallel import (batched_optimize,
                                              batched_optimize_compacted)
    from libdogleg_tpu_torch.parallel.batched import _auto_newton

    decisions = ("step_count", "n_attempts", "reason")
    families = {}
    batchchol.launch_count = 0
    k1_before = mega.launch_count
    for nstate, batch in MIDSIZE:
        data, p0, p_true = midsize_family(nstate, batch, torch.float32, dev)
        families[nstate] = (data, p0, p_true)
        check(isinstance(_auto_newton(midsize_products, p0, data),
                         BlockedDenseNewtonSolver),
              f"the gate picks BlockedDenseNewtonSolver at Nstate {nstate}")
        before = batchchol.launch_count
        t0 = time.perf_counter()
        r = batched_optimize(midsize_products, p0, bench, problem_data=data)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        k5 = batchchol.launch_count - before
        rec = midsize_recovered(r.p, p_true)
        check(k5 >= 1, f"batched_optimize launched K5 at Nstate {nstate}")
        check(r.p.shape == (batch, nstate)
              and bool(torch.isfinite(r.p).all())
              and bool(torch.isfinite(r.norm2_x).all()),
              f"finite ({batch}, {nstate}) result")
        check(bool((r.reason > 0).all()), "every problem terminated")
        check(rec >= 0.99, f"Nstate {nstate} recovered_frac {rec} >= 0.99")
        print(f"[15 batched_optimize Nstate {nstate} B={batch} f32 PRM] K5 "
              f"launches {k5}; attempts {int(r.n_attempts.min())}.."
              f"{int(r.n_attempts.max())}; reasons "
              f"{torch.bincount(r.reason, minlength=7).tolist()}; "
              f"recovered_frac {rec:.4f} (>= 0.99); wall {wall:.3f} s (first "
              f"call)", flush=True)
    launches = batchchol.launch_count
    check(mega.launch_count == k1_before, "the mid-size path launched no K1")

    # the compacted entry point, after the launches of the main path are read
    nstate, batch = MIDSIZE[0]
    data, p0, _ = families[nstate]
    r = batched_optimize(midsize_products, p0, bench, problem_data=data)
    rc = batched_optimize_compacted(midsize_products, p0, bench,
                                    problem_data=data)
    torch.cuda.synchronize()
    for field in decisions:
        check(torch.equal(getattr(rc, field), getattr(r, field)),
              f"compacted: {field} of batched_optimize")
    dpc = float((rc.p - r.p).abs().max())
    check(dpc <= 1e-4, f"compacted: p within 1e-4: {dpc:.3e}")
    print(f"[15 batched_optimize_compacted Nstate {nstate} B={batch} "
          f"f32] decisions of batched_optimize on every element; "
          f"max |dp| {dpc:.3e}", flush=True)

    nstate, batch = MIDSIZE[0][0], 128
    before = batchchol.launch_count
    data, p0, p_true = midsize_family(nstate, batch, torch.float64, dev)
    r64 = batched_optimize(midsize_products, p0, problem_data=data)
    torch.cuda.synchronize()
    check(batchchol.launch_count > before, "the f64 card solve launched K5")
    data_c, p0_c, _ = midsize_family(nstate, batch, torch.float64, "cpu")
    r64c = batched_optimize(midsize_products, p0_c, problem_data=data_c)
    for field in decisions:
        check(torch.equal(getattr(r64, field).cpu(), getattr(r64c, field)),
              f"f64 card vs CPU {field} identical")
    dp = float((r64.p.cpu() - r64c.p).abs().max())
    check(torch.allclose(r64.p.cpu(), r64c.p, rtol=1e-9, atol=1e-12),
          f"f64 card vs CPU p within rtol 1e-9: {dp:.3e}")
    print(f"[15 Nstate {nstate} B={batch} f64] card (K5) vs CPU (plain "
          f"version): decisions identical on every element, attempts "
          f"{int(r64.n_attempts.min())}..{int(r64.n_attempts.max())}; max "
          f"|dp| {dp:.3e} (rtol 1e-9); recovered_frac "
          f"{midsize_recovered(r64.p, p_true):.4f}", flush=True)
    return {"launches": launches, "families": families}


MIDSIZE_GROUPS = (("K5", ("batchchol",)),
                  ("cholesky_solve", ("trsm", "trsv", "potrs", "triang")),
                  ("products", ("gemm", "gemv", "cutlass", "xmma", "bmm")))


def phase16_timing(dev, bench, card, mid, k5) -> None:
    """CUDA-event times of K5 at config 8's shapes against its plain
    version, the library call and K6; the substitutions; the public call's
    wall by strategy, with a profiler split."""
    import torch

    from libdogleg_tpu_torch import DenseNewtonSolver
    from libdogleg_tpu_torch.ops import batchchol, panelchol, tilechol
    from libdogleg_tpu_torch.ops import cholesky as chol
    from libdogleg_tpu_torch.parallel import (batched_optimize,
                                              batched_optimize_compacted)
    from libdogleg_tpu_torch.utils.benchtime import measure_ms

    for nstate, batch in MIDSIZE:
        data, p0, _ = mid["families"][nstate]
        pr = torch.func.vmap(midsize_products)(p0, data)
        S, rhs = pr.JtJ.contiguous(), pr.Jt_x
        shape = f"({batch}, {nstate}, {nstate}) f32"
        # in: the matrices' lower triangles (the function reads nothing
        # above the diagonal); out: L and ok (a byte a matrix). n^3/3
        # operations a matrix
        limit = bound(lower_nbytes(S) + nbytes_of(S) + batch,
                      batch * nstate ** 3 / 3)
        turns = []
        for _ in range(2):  # in turns, so that a drift shows
            turns.append((
                measure_ms(batchchol.batched_blocked_cholesky, S, warmup=3,
                           reps=20),
                measure_ms(torch.linalg.cholesky_ex, S, warmup=3, reps=20),
                measure_ms(tilechol.tile_cholesky, S, warmup=3, reps=20)))
        plain = measure_ms(batchchol.batched_blocked_cholesky_reference, S,
                           warmup=1, reps=3)
        # the kernel against its plain version on the path's own JtJ
        L, ok = batchchol.batched_blocked_cholesky(S)
        Lr, okr = batchchol.batched_blocked_cholesky_reference(S)
        torch.cuda.synchronize()
        err = rel_err(L, Lr)
        check(bool(ok.all()) and torch.equal(ok, okr),
              f"K5 {shape} on the path's JtJ: ok")
        check(err < 1e-5, f"K5 {shape} on the path's JtJ within 1e-5 of the "
              f"largest entry: {err:.3e}")
        k5["max_abs_err"] = max(k5["max_abs_err"],
                                float((L - Lr).abs().max()))
        # the streamed kernel runs at both shapes (from the trace)
        ran = kernels_launched(batchchol.batched_blocked_cholesky, (S,),
                               K5_KERNELS, {"batchchol_streamed"})
        check(ran == {"batchchol_streamed"},
              f"K5 {shape} launched batchchol_streamed (profiler): {ran}")
        alone = us_text(kernel_us(batchchol.batched_blocked_cholesky, (S,),
                                  "batchchol_streamed"))
        if nstate == MIDSIZE[-1][0]:
            k5.update(ms=turns[0][0], plain_ms=plain,
                      library_ms=turns[0][1], **limit)
        print(f"[16 K5 {shape}] K5 {turns[0][0]:.4f} / {turns[1][0]:.4f} ms, "
              f"torch.linalg.cholesky_ex {turns[0][1]:.4f} / "
              f"{turns[1][1]:.4f} ms, K6 {turns[0][2]:.4f} / "
              f"{turns[1][2]:.4f} ms (two turns, CUDA events over 20 "
              f"back-to-back calls), plain version {plain:.3f} ms; the "
              f"kernel (batchchol_streamed, profiler) alone {alone}; bound "
              f"{limit['bound_ms'] * 1e3:.2f} us by {limit['bound_by']}; on "
              f"the path's JtJ K5 within {err:.3e} of its plain version's "
              f"largest entry (tol 1e-5), ok identical; card {card}",
              flush=True)
        t_sub = measure_ms(chol.cholesky_solve, L, rhs, warmup=3, reps=20)
        print(f"[16 substitutions {shape}] ops/cholesky.cholesky_solve "
              f"(torch.cholesky_solve, PyTorch around the kernel) "
              f"{t_sub:.4f} ms; card {card}", flush=True)

        def gate():
            return batched_optimize(midsize_products, p0, bench,
                                    problem_data=data)

        def dense():
            return batched_optimize(midsize_products, p0, bench,
                                    problem_data=data,
                                    newton_solver=DenseNewtonSolver())

        def compacted():
            return batched_optimize_compacted(midsize_products, p0, bench,
                                              problem_data=data)

        # in turns: the wall is host time, which drifts by several ms
        # within a run on a shared host
        variants = (("gate (BlockedDenseNewtonSolver, K5)", gate),
                    ("DenseNewtonSolver", dense),
                    ("compacted, gate's strategy", compacted))
        walls = {label: [] for label, _ in variants}
        per_solve, wavefronts = {}, {}
        for turn in range(7):
            for label, fn in variants:
                before = batchchol.launch_count
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                r = fn()
                torch.cuda.synchronize()
                if turn:  # the first turn warms up
                    walls[label].append((time.perf_counter() - t0) * 1e3)
                per_solve[label] = batchchol.launch_count - before
                wavefronts[label] = int(r.n_attempts.max())
        for label, _ in variants:
            w = sorted(walls[label])
            median = (w[2] + w[3]) / 2
            print(f"[16 Nstate {nstate} B={batch} f32 solve, {label}] wall "
                  f"ms {', '.join(f'{x:.1f}' for x in walls[label])} (six "
                  f"turns after one to warm up, the variants alternating): "
                  f"median {median:.2f} ms, {batch / median * 1e3:.0f} "
                  f"solves/s; fastest {w[0]:.2f} ms; wavefronts "
                  f"{wavefronts[label]}, K5 launches {per_solve[label]} per "
                  f"solve; card {card}", flush=True)
        print(f"[16 Nstate {nstate} B={batch} f32 solve, gate] "
              f"{device_split(gate, groups=MIDSIZE_GROUPS)}",
              flush=True)
    # the other two kernels on csrc/cholstage.cuh, alone, beside K5
    S = spd_tiles(128, 21, 149, torch.float32, dev)
    W = spd_on_device(256, 1, 3, torch.float32, dev) * 256
    k6 = kernel_us(tilechol.tile_cholesky, (S,), "tilechol")
    k2 = kernel_us(panelchol.panel_factor, (W,), "panelchol_factor")
    print(f"[16 beside K5, f32] K6 (21, 128, 128) alone {us_text(k6)}; K2's "
          f"factor kernel p=256 alone {us_text(k2)}; card {card}",
          flush=True)


def error_free_pairs(n, seed, dtype, device):
    """n pairs (a, b) of random sign with exponents spanning -60..60, the
    pair's exponents summing to at least -96, so that the exact error of
    a * b is no subnormal (below that no two_prod is exact)."""
    import torch
    rng = np.random.default_rng(seed)
    ea = rng.integers(-60, 61, n)
    eb = rng.integers(np.maximum(-60, -96 - ea), 61)

    def draw(e):
        m = rng.uniform(1.0, 2.0, n) * rng.choice([-1.0, 1.0], n)
        return torch.as_tensor(np.ldexp(m, e), dtype=dtype, device=device)
    return draw(ea), draw(eb)


def factored_args(seed, batch, dtype, device):
    """instances(seed, ...) in the factored form: p0, the statistics made
    on the device, and the Gram pair."""
    from libdogleg_tpu_torch.models import quadratic_surface as qs
    p0, meas, _, _ = instances(seed, batch, dtype, device)
    return (p0, *qs.factored_statistics(meas),
            qs.gram_pair(dtype, device)), meas


# Operations of one factored products evaluation, counted from
# quadratic_surface.factored_products_minor as the device function runs it
# (an fma counts 2, a two_prod 3, a two_sum 6): c 2; per row of G c a
# two_prod and a product and sum of the low part (5), five columns of a
# two_prod, a two_sum and four operations on the low part (65), and g from
# the pair (9): 79, six rows 474; Jt_x 6; the 21 entries of JtJ's lower
# triangle from the columns of G T, 52; c.g 11; c.h as a pair 70; the last
# two_sum, four sums and the clamp 11.
FACTORED_PRODUCTS_OPS = 2 + 474 + 6 + 52 + 11 + 70 + 11
FACTORED_GROUPS = (("K1 factored", ("dogleg_mega_factored",)),
                   ("reductions", ("reduce",)),
                   ("copies and concatenation", ("memcpy", "cat", "copy")))


def phase17_factored(dev, bench) -> dict:
    """K1's factored instance: hazard F2 on the card, the factored products
    against their twin, the kernel against its twin in float64 and float32,
    the public path counted, and its times. Returns its kernels-line entry's
    numbers."""
    import torch

    from libdogleg_tpu_torch.models import quadratic_surface as qs
    from libdogleg_tpu_torch.ops import mega
    from libdogleg_tpu_torch.parallel import batched_optimize
    from libdogleg_tpu_torch.utils.benchtime import measure_ms

    card = card_line()
    # F2: the device two_prod (fma) and two_sum (uncontracted)
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).split(".")[-1]
        a, b = error_free_pairs(1 << 20, 17, dtype, dev)
        got = mega.error_free_transforms(a, b)
        want = mega.error_free_transforms_reference(a, b)
        torch.cuda.synchronize()
        for label, g, w in zip(("p", "e_p", "s", "e_s"), got, want):
            check(torch.equal(g, w), f"F2 {name} {label} bit for bit the "
                  f"eager twin's")
        exact = ""
        if dtype == torch.float32:
            p, e, s, es = (t.double() for t in got)
            check(torch.equal(p + e, a.double() * b.double()),
                  "F2 float32 p + e == a * b exactly")
            check(torch.equal(s + es, a.double() + b.double()),
                  "F2 float32 s + e == a + b exactly")
            exact = ("; p + e == a b and s + e == a + b exactly in float64 "
                     "on every pair")
        print(f"[17 F2 {name}] two_prod and two_sum on {a.numel()} pairs "
              f"(exponents -60..60): bit for bit the eager split forms"
              f"{exact}", flush=True)

    # the device function against factored_products_minor
    for dtype, rtol, rtol_jtj, atol in ((torch.float64, 1e-12, 1e-12, 1e-12),
                                        (torch.float32, 1e-6, 1e-5, 1e-8)):
        name = str(dtype).split(".")[-1]
        (p0, hh, hl, nh, nl, G), _ = factored_args(3, BATCH, dtype, dev)
        near = torch.as_tensor(qs.P_TRUE, dtype=dtype, device=dev) + 1e-3 * p0
        for where, p in (("the starts", p0), ("near the truth", near)):
            got = mega.factored_products_device(p, (hh, hl, nh, nl), G)
            n2, jtx, jtj = qs.factored_products_minor(
                p.t(), hh.t(), hl.t(), nh[None], nl[None], *G)
            # the kernel computes JtJ's lower triangle and mirrors it; the
            # twin's upper triangle sums the same terms in another order
            check(torch.equal(got[2], got[2].mT),
                  f"factored products {name} JtJ symmetric")
            got = (got[0], got[1], torch.tril(got[2]))
            want = (n2[0], jtx.t(), torch.tril(jtj.permute(2, 0, 1)))
            torch.cuda.synchronize()
            for label, g, w, rt, at in zip(
                    ("norm2", "Jt_x", "JtJ's lower triangle"), got, want,
                    (rtol, rtol, rtol_jtj), (0.0, atol, 0.0)):
                bad = ~torch.isclose(g, w, rtol=rt, atol=at)
                check(not bool(bad.any()),
                      f"factored products {name} {label} at {where} within "
                      f"rtol {rt}, atol {at}: {int(bad.sum())} outside, "
                      f"first {g[bad][:3].tolist()} against "
                      f"{w[bad][:3].tolist()}")
            differ = [int((g != w).sum()) for g, w in zip(got, want)]
            print(f"[17 factored products {name} B={BATCH} at {where}] "
                  f"within tolerance of factored_products_minor; elements "
                  f"not bit for bit: norm2 {differ[0]}, Jt_x {differ[1]}, "
                  f"JtJ's lower triangle {differ[2]}", flush=True)

    # the kernel against its twin: float64, then float32 under the rule
    args64, _ = factored_args(0, 1024, torch.float64, dev)
    r_k = mega.megakernel_optimize_factored(*args64)
    r_t = mega.megakernel_optimize_factored_reference(*args64)
    torch.cuda.synchronize()
    for field in ("step_count", "n_attempts", "reason"):
        check(torch.equal(getattr(r_k, field), getattr(r_t, field)),
              f"factored f64 {field} identical")
    check(torch.allclose(r_k.p, r_t.p, rtol=1e-9, atol=0.0),
          "factored f64 p within rtol 1e-9")
    print(f"[17 K1 factored f64 B=1024] decisions identical to the twin's; "
          f"max |dp| {(r_k.p - r_t.p).abs().max().item():.3e} (rtol 1e-9); "
          f"reasons {torch.bincount(r_k.reason, minlength=7).tolist()}",
          flush=True)
    print(f"[17 K1 factored f64] {ragged_f64_decisions(dev, factored=True)}",
          flush=True)

    args32, meas32 = factored_args(1, BATCH, torch.float32, dev)
    r_k = mega.megakernel_optimize_factored(*args32, bench)
    r_t = mega.megakernel_optimize_factored_reference(*args32, bench)
    torch.cuda.synchronize()
    same = ((r_k.step_count == r_t.step_count)
            & (r_k.n_attempts == r_t.n_attempts))
    agree = same.float().mean().item()
    rec_k, rec_t = recovered_frac(r_k.p), recovered_frac(r_t.p)
    max_abs_err = (r_k.p - r_t.p).abs()[same].max().item()
    check(agree >= 0.85, f"factored f32 decision agreement {agree} >= 0.85")
    check(rec_k >= 0.99, f"factored f32 kernel recovered_frac {rec_k} >= 0.99")
    print(f"[17 K1 factored f32 B={BATCH}] decision agreement {agree:.4f} "
          f"(>= 0.85); recovered_frac kernel {rec_k:.4f} twin {rec_t:.4f} "
          f"(>= 0.99); max |dp| where decisions agree {max_abs_err:.3e}",
          flush=True)

    # the public path, counted: statistics, then batched_optimize
    p0, meas, _, _ = instances(2, BATCH, torch.float32, dev)
    fn = qs.factored_products_fn(qs.gram_pair(torch.float32, dev))

    def solve(p0, meas):
        return batched_optimize(fn, p0, bench,
                                problem_data=qs.factored_statistics(meas))

    mega.launch_count = mega.factored_launch_count = 0
    r = solve(p0, meas)
    torch.cuda.synchronize()
    launches, general = mega.factored_launch_count, mega.launch_count
    rec = recovered_frac(r.p)
    check(launches >= 1 and general == 0,
          f"batched_optimize on the factored products launched the factored "
          f"K1 ({launches}) and not the general one ({general})")
    check(r.p.shape == (BATCH, qs.NSTATE) and bool(torch.isfinite(r.p).all())
          and bool(torch.isfinite(r.norm2_x).all()), "finite (B, 6) result")
    check(bool((r.reason > 0).all()), "every factored problem terminated")
    check(rec >= 0.99, f"factored public path recovered_frac {rec} >= 0.99")
    print(f"[17 batched_optimize factored B={BATCH} f32] factored K1 "
          f"launches {launches}, general {general}; recovered_frac "
          f"{rec:.4f}; reasons "
          f"{torch.bincount(r.reason, minlength=7).tolist()}", flush=True)

    # times at the main path's shapes, the two instances in turns
    gargs = instances(1, BATCH, torch.float32, dev)
    turns = []
    for _ in range(2):
        turns.append((
            measure_ms(mega.megakernel_optimize, *gargs, bench, warmup=3,
                       reps=20),
            measure_ms(mega.megakernel_optimize_factored, *args32, bench,
                       warmup=3, reps=20)))
    ms = turns[0][1]
    alone = kernels_us(mega.megakernel_optimize_factored, (*args32, bench),
                       ("dogleg_mega_factored_kernel",))
    alone_g = kernels_us(mega.megakernel_optimize, (*gargs, bench),
                         ("dogleg_mega_kernel",))
    plain_ms = measure_ms(mega.megakernel_optimize_factored_reference,
                          *args32, bench, warmup=1, reps=5)
    stats_ms = measure_ms(qs.factored_statistics, meas32, warmup=3, reps=20)
    def solve_general(p0, meas):
        return batched_optimize(qs.products, p0, bench, problem_data=meas)

    # host walls in turns with phase 4's call on the same measurements
    walls = {"factored": [], "general": []}
    for turn in range(8):
        for label, call in (("factored", solve),
                            ("general", solve_general)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call(p0, meas)
            torch.cuda.synchronize()
            if turn:  # the first turn warms up
                walls[label].append((time.perf_counter() - t0) * 1e3)
    call_ms = measure_ms(solve, p0, meas, warmup=3, reps=20)
    # the bound from this run's data: p0, the statistics and the Gram pair
    # in, the nine result fields out; one products evaluation at the start
    # and one per attempt, and per attempt the step math as phase 6 counts
    r_b = mega.megakernel_optimize_factored(*args32, bench)
    n = qs.NSTATE
    evals = float((r_b.n_attempts + 1).sum())
    limit = bound(
        nbytes_of(*args32[:5], *args32[5])
        + nbytes_of(*(t for t in r_b if t is not None)),
        evals * FACTORED_PRODUCTS_OPS
        + float(r_b.n_attempts.sum()) * (n ** 3 / 3 + 6 * n * n + 10 * n))
    print(f"[17 timing B={BATCH} f32] factored K1 {turns[0][1]:.4f} / "
          f"{turns[1][1]:.4f} ms with its wrapper, general K1 (phase 6) "
          f"{turns[0][0]:.4f} / {turns[1][0]:.4f} ms (two turns, CUDA events "
          f"over 20 back-to-back calls); alone: factored "
          f"{us_text(alone['dogleg_mega_factored_kernel'])}, general "
          f"{us_text(alone_g['dogleg_mega_kernel'])}; twin {plain_ms:.4f} "
          f"ms; bound {limit['bound_ms'] * 1e3:.2f} us by "
          f"{limit['bound_by']} ({evals / BATCH:.2f} products evaluations "
          f"a problem, {FACTORED_PRODUCTS_OPS} operations each); "
          f"{attempts_text(r_b.n_attempts)}; card {card}", flush=True)
    print(f"[17 timing B={BATCH} f32] factored_statistics on the (B, 100) "
          f"measurements {stats_ms:.4f} ms; the whole call (statistics and "
          f"batched_optimize) {call_ms:.4f} ms by CUDA events over 20 calls "
          f"({BATCH / call_ms * 1e3:.0f} solves/s); host wall ms "
          f"{', '.join(f'{w:.3f}' for w in walls['factored'])}, in turns "
          f"with phase 4's call on the same measurements "
          f"{', '.join(f'{w:.3f}' for w in walls['general'])}; card {card}",
          flush=True)
    print(f"[17 whole call B={BATCH} f32] "
          f"{device_split(solve, p0, meas, groups=FACTORED_GROUPS)}",
          flush=True)
    return dict(launches=launches, max_abs_err=max_abs_err, ms=ms,
                plain_ms=plain_ms, library_ms=None, **limit)


F64_BATCHES = (1, 31, 1000, 8193)  # no multiple of a group, warp or block


# bench_all.py's bundle-adjustment workloads at their full width: config 4
# (:282-308), 7 (:377-400) and 7s (:403-445)
BA_LINEAR = dict(seed=0, nc=64, n_points=20000, block_size=3, k_obs=4)
BA_PINHOLE = dict(seed=0, ncam=32, npts=20000)
BA_SPARSE = dict(seed=0, ncam=128, npts=50000, k_obs=4)
BA_GROUPS = (("matmul", ("gemm", "gemv", "cutlass", "xmma", "bmm",
                         "dot_kernel", "splitk")),
             ("cholesky", ("potrf", "potf", "chol", "trsm", "trsv", "syrk")),
             ("gather/index", ("index", "gather", "scatter")),
             ("reduce", ("reduce",)))


def kernel_launch_counts() -> dict:
    """Every kernel wrapper's launch count, by kernel."""
    from libdogleg_tpu_torch.ops import (batchchol, bcsr_kernels, mega,
                                         panelchol, tilechol)
    return {"K1": mega.launch_count, "K1 factored": mega.factored_launch_count,
            "K2": panelchol.launch_count, **bcsr_kernels.launch_counts,
            "K5": batchchol.launch_count, **tilechol.launch_counts}


def host_syncs(fn) -> tuple:
    """(the host synchronizations one call of fn makes, its result), counted
    as the warnings of torch.cuda's sync debug mode; None where the mode
    gives none to count."""
    import warnings

    import torch
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    n = sum("synchroniz" in str(w.message).lower() for w in caught)
    return (n or None), out


def ba_small(name, device):
    """(products, strategy, start) of a small float64 instance, the same on
    every device: linear BA nc 8, n_points 50 (flat or tree), pinhole ncam 4,
    npts 60 (full visibility), sparse visibility ncam 8, npts 80, k_obs 3;
    the pinhole starts drawn from one CPU generator."""
    import torch

    from libdogleg_tpu_torch.models import bundle_adjustment as lba
    from libdogleg_tpu_torch.models import pinhole_ba as pba
    if name.startswith("linear"):
        ba = lba.make_synthetic(seed=3, nc=8, n_points=50,
                                dtype=torch.float64, device=device)
        if name == "linear-tree":
            return ba.products_tree, ba.tree_newton_solver(), ba.p0_tree()
        return (ba.products, ba.newton_solver(),
                torch.zeros(ba.nstate, dtype=torch.float64, device=device))
    ba = (pba.make_synthetic(seed=0, ncam=4, npts=60, device=device)
          if name == "dense" else
          pba.make_synthetic_sparse(seed=0, ncam=8, npts=80, k_obs=3,
                                    device=device))
    return (ba.products, ba.newton_solver(),
            ba.p0(torch.Generator().manual_seed(2), jitter=0.02))


def flat_p(p):
    """A state as one float64 vector."""
    import torch
    if isinstance(p, dict):
        return torch.cat([p["c"].reshape(-1), p["q"].reshape(-1)]).double()
    return p.double()


def flat_batch(p):
    """A batch of states as one (B, n) float64 tensor."""
    import torch
    if isinstance(p, dict):
        return torch.cat([p["c"].reshape(p["c"].shape[0], -1),
                          p["q"].reshape(p["q"].shape[0], -1)], 1).double()
    return p.double()


def same_bits(a, b) -> bool:
    """Whether two float tensors hold the same bits (NaN included)."""
    import torch
    ints = {torch.float32: torch.int32, torch.float64: torch.int64}
    return (a.shape == b.shape and a.dtype == b.dtype
            and torch.equal(a.view(ints[a.dtype]), b.view(ints[b.dtype])))


def ba_deterministic(label, products_fn, ns, p) -> str:
    """Two evaluations of the products and two factorizations at p (at
    lambda 0 and 1e-3): every camera-axis reduction (the camera gradient,
    U, the reduced system S and its factor) must give the same bits."""
    import torch
    pr = [products_fn(p) for _ in range(2)]
    gc = [q.Jt_x["c"] if isinstance(q.Jt_x, dict) else q.Jt_x for q in pr]
    check(same_bits(gc[0], gc[1]), f"{label}: the camera gradient bit for "
          f"bit on a second run")
    check(same_bits(pr[0].JtJ.U, pr[1].JtJ.U),
          f"{label}: U bit for bit on a second run")
    oks = []
    for lam in (0.0, 1e-3):
        lam = torch.tensor(lam, dtype=pr[0].norm2_x.dtype,
                           device=pr[0].norm2_x.device)
        fac = [ns.factor(q.JtJ, lam) for q in pr]
        check(all(same_bits(x, y) for x, y in zip(fac[0][0], fac[1][0]))
              and bool(fac[0][1]) == bool(fac[1][1]),
              f"{label}: the point and reduced-system factors at lambda "
              f"{float(lam):g} bit for bit")
        oks.append(f"{float(lam):g}: {bool(fac[0][1])}")
    return (f"camera gradient, U, Lv and Ls bit for bit on two runs (factor "
            f"ok at lambda {', '.join(oks)})")


def ba_leg(label, products_fn, ns, p0, bench, gate, gate_text, card,
           profile=True):
    """One config's solve at full width: the first call, the gate, the host
    wall of single calls, CUDA-event time, the host synchronizations a
    solve, the bits of two solves, and (profile) a profiler split. Returns
    the result."""
    import torch

    from libdogleg_tpu_torch import solve_products
    from libdogleg_tpu_torch.utils.benchtime import measure_ms

    def solve():
        return solve_products(products_fn, p0, bench, newton_solver=ns)
    before = kernel_launch_counts()
    t0 = time.perf_counter()
    r = solve()
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    check(kernel_launch_counts() == before,
          f"{label}: the path launches none of K1-K7")
    p = flat_p(r.p)
    check(bool(torch.isfinite(p).all()) and bool(torch.isfinite(r.norm2_x)),
          f"{label}: finite result")
    check(gate(r), f"{label}: gate {gate_text}: norm2_x "
          f"{float(r.norm2_x):.6g}, reason {int(r.reason)}")
    walls = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r2 = solve()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    check(torch.equal(flat_p(r2.p), p), f"{label}: p bit for bit on a "
          f"second solve")
    ms = measure_ms(solve, warmup=0, reps=2)
    syncs, _ = host_syncs(solve)
    attempts = int(r.n_attempts)
    sync_text = ("not measured (no sync warnings)" if syncs is None else
                 f"{syncs} ({syncs / attempts:.1f} an attempt)")
    print(f"[18 {label}] gate {gate_text}: norm2_x {float(r.norm2_x):.6g}, "
          f"reason {int(r.reason)}, steps {int(r.step_count)}, attempts "
          f"{attempts}, lambda {float(r.lam):.3g}; no kernel of K1-K7 "
          f"launched; first call {first:.3f} s; host wall ms "
          f"{', '.join(f'{w:.2f}' for w in walls)}; CUDA events "
          f"{ms:.2f} ms a solve; host synchronizations a solve {sync_text}; "
          f"card {card}", flush=True)
    if profile:
        print(f"[18 {label} profile] "
              f"{device_split(solve, groups=BA_GROUPS)}; {attempts} "
              f"attempts", flush=True)
    return r


def ba_f64_accuracy(label, products_fn, ns, p0, r32, since) -> None:
    """The same instance cast up to float64, solved on the card from the
    same start under the reference's default (tight) thresholds, as
    bench_all.py's f64_accuracy_cols: the costs and the largest difference
    in p from the float32 result."""
    import torch

    from libdogleg_tpu_torch import DoglegParameters, solve_products
    from libdogleg_tpu_torch.ops import treevec as tv
    t0 = time.perf_counter()
    r64 = solve_products(products_fn, tv.tree_map(lambda x: x.double(), p0),
                         DoglegParameters(), newton_solver=ns)
    torch.cuda.synchronize()
    dp = float((flat_p(r32.p) - flat_p(r64.p)).abs().max())
    print(f"[18 {label} f64] from the same start, default thresholds: "
          f"reason {int(r64.reason)}, attempts {int(r64.n_attempts)}, "
          f"norm2_x f64 {float(r64.norm2_x):.9g}, f32 "
          f"{float(r32.norm2_x):.9g} (ratio "
          f"{float(r32.norm2_x) / float(r64.norm2_x):.6g}); max |p32 - p64| "
          f"{dp:.3e}; {time.perf_counter() - t0:.2f} s; the config's "
          f"checks and timing {time.perf_counter() - since:.1f} s in all",
          flush=True)


def phase18_ba(dev, bench) -> None:
    """Bundle adjustment through Schur elimination: float64 decisions on
    the card against the CPU at a small size, then bench_all.py's configs
    4, 7 and 7s at full width in float32 (gates, timing, determinism,
    float64 accuracy)."""
    import dataclasses

    import torch

    from libdogleg_tpu_torch import DoglegParameters, solve_products
    from libdogleg_tpu_torch.models import bundle_adjustment as lba
    from libdogleg_tpu_torch.models import pinhole_ba as pba
    from libdogleg_tpu_torch.ops import newton

    card = card_line()
    decisions = ("step_count", "n_attempts", "reason")
    for name in ("linear", "linear-tree", "dense", "sparse"):
        out = []
        for device in (dev, torch.device("cpu")):
            fn, ns, p0 = ba_small(name, device)
            out.append(solve_products(fn, p0, DoglegParameters(),
                                      newton_solver=ns, record_history=True))
        r_d, r_c = out
        for field in decisions:
            check(int(getattr(r_d, field)) == int(getattr(r_c, field)),
                  f"BA {name} f64 card vs CPU {field} identical")
        check(torch.equal(r_d.history.step_type.cpu(), r_c.history.step_type),
              f"BA {name} f64 card vs CPU History step types identical")
        dp = float((flat_p(r_d.p).cpu() - flat_p(r_c.p)).abs().max())
        check(torch.allclose(flat_p(r_d.p).cpu(), flat_p(r_c.p), rtol=1e-9,
                             atol=1e-9),
              f"BA {name} f64 card vs CPU p within 1e-9: {dp:.3e}")
        print(f"[18 decisions {name} f64] card vs CPU: step_count, "
              f"n_attempts, reason and History step types identical "
              f"({int(r_c.step_count)} steps, {int(r_c.n_attempts)} "
              f"attempts, reason {int(r_c.reason)}); max |dp| {dp:.3e}",
              flush=True)

    # config 4: linear BA, flat state, from zeros
    since = time.perf_counter()
    ba = lba.make_synthetic(dtype=torch.float32, device=dev, **BA_LINEAR)
    p0 = torch.zeros(ba.nstate, dtype=torch.float32, device=dev)
    ns = ba.newton_solver()
    print(f"[18 config 4] nc {ba.nc}, n_points {ba.n_points}, nstate "
          f"{ba.nstate}, nmeas {ba.nmeasurements}, B "
          f"{nbytes_of(ba.B) / 1e6:.1f} MB; "
          f"{ba_deterministic('config 4', ba.products, ns, p0)}", flush=True)
    legs = (("config 4", ns),
            ("config 4 refine_iters=2",
             dataclasses.replace(ns, refine_iters=2)))
    for label, strategy in legs:
        r4 = ba_leg(label, ba.products, strategy, p0, bench,
                    lambda r: float(r.norm2_x) < 1e-3, "norm2_x < 1e-3",
                    card, profile=strategy is ns)
        if strategy is ns:
            r4_plain = r4
    ba64 = ba._replace(A=ba.A.double(), B=ba.B.double(), obs=ba.obs.double(),
                       p_true=ba.p_true.double())
    ba_f64_accuracy("config 4", ba64.products, ba64.newton_solver(), p0,
                    r4_plain, since)
    del ba, ba64

    # config 7: pinhole BA, the full-visibility grid, tree state
    since = time.perf_counter()
    ba = pba.make_synthetic(dtype=torch.float32, device=dev, **BA_PINHOLE)
    check(ba.dense_grid, "config 7 takes the grid path")
    p0 = ba.p0(torch.Generator(device=dev).manual_seed(2), jitter=0.02)
    ns = ba.newton_solver()
    nobs = ba.nobs
    print(f"[18 config 7] ncam {ba.ncam}, npts {ba.npts}, nobs {nobs}, "
          f"nstate {ba.nstate}, W {ba.ncam * 6 * ba.npts * 3 * 4 / 1e6:.1f} "
          f"MB; {ba_deterministic('config 7', ba.products, ns, p0)}",
          flush=True)
    r7 = ba_leg("config 7", ba.products, ns, p0, bench,
                lambda r: int(r.reason) > 0 and float(r.norm2_x) < 2 * nobs,
                "reason > 0, norm2_x < 2 nobs", card)
    ba64 = dataclasses.replace(
        ba, obs=ba.obs.double(), cam0_prior=ba.cam0_prior.double(),
        pts_prior=ba.pts_prior.double(),
        p_true={k: v.double() for k, v in ba.p_true.items()})
    ba_f64_accuracy("config 7", ba64.products, ba64.newton_solver(), p0, r7,
                    since)
    del ba, ba64

    # config 7s: sparse visibility, the chunked S and camera reductions
    since = time.perf_counter()
    ba = pba.make_synthetic_sparse(dtype=torch.float32, device=dev,
                                   **BA_SPARSE)
    p0 = ba.p0(torch.Generator(device=dev).manual_seed(2), jitter=0.02)
    ns = ba.newton_solver()
    nobs = ba.nobs
    onehot = ba.npts * ba.k_obs * ba.ncam
    check(onehot > ns.s_chunk_limit
          and ba.npts * ns.nc * 3 > ns.s_chunk_limit,
          "config 7s takes the chunked S and camera reductions")
    print(f"[18 config 7s] ncam {ba.ncam}, npts {ba.npts}, k_obs "
          f"{ba.k_obs}, nobs {nobs}, nstate {ba.nstate}, Wv "
          f"{ba.npts * ba.k_obs * 18 * 4 / 1e6:.1f} MB, one-hot elements "
          f"{onehot} > {ns.s_chunk_limit} (chunked); "
          f"{ba_deterministic('config 7s', ba.products, ns, p0)}",
          flush=True)
    legs = (("config 7s", ns),
            ("config 7s refine_iters=2 cam_gather",
             dataclasses.replace(ns, refine_iters=2,
                                 cam_gather=newton.build_cam_gather(
                                     ba.cam_of, ba.ncam))))
    for label, strategy in legs:
        r7s = ba_leg(label, ba.products, strategy, p0, bench,
                     lambda r: float(r.norm2_x) < 2 * nobs,
                     "norm2_x < 2 nobs", card, profile=strategy is ns)
        if strategy is ns:
            r7s_plain = r7s
    ba64 = dataclasses.replace(
        ba, obs=ba.obs.double(), cam0_prior=ba.cam0_prior.double(),
        pts_prior=ba.pts_prior.double(),
        p_true={k: v.double() for k, v in ba.p_true.items()})
    ba_f64_accuracy("config 7s", ba64.products, ba64.newton_solver(), p0,
                    r7s_plain, since)
    return ba, r7s_plain


# config 5 of bench_all.py:311-327 (nmeas, nstate, feature_size) and the
# windowed queries on the grid's supernodal factor (queries, fs, w)
CONFIG5 = (100000, 64, 2)
QUERIES = (256, 2, 16)


def op_summary_line(fn, *args, top: int = 6) -> str:
    """diagnostics.profile_op_summary of one call, its rows (ms, calls,
    op) on one line."""
    from libdogleg_tpu_torch.diagnostics import profile_op_summary
    rows = profile_op_summary(fn, *args, top=top).split("\n")[1:]
    return "ms, calls, op: " + "; ".join(" ".join(r.split()) for r in rows)


def rel_diff_text(lo, hi) -> str:
    """Max and median of |lo - hi| / |hi|."""
    d = ((lo.double() - hi.double()).abs() / hi.double().abs()).cpu().numpy()
    return f"max {d.max():.3e}, median {np.median(d):.3e}"


def phase19_analysis(dev, card, ba7s, r7s) -> None:
    """The analysis layer (no kernel of K1-K7 on its path): bench_all.py's
    config 5 (dense outlierness factors) and config 7o (the bundle-
    adjustment pass on phase 18's config 7s solve) at full width, the
    windowed query traces on the grid's supernodal factor, each gated."""
    import dataclasses

    import torch

    from libdogleg_tpu_torch import (DoglegParameters, SparseProblem,
                                     solve_products)
    from libdogleg_tpu_torch.analysis import (
        get_outlierness_factors, get_outlierness_factors_ba,
        outlierness_trace_new_features_windowed)
    from libdogleg_tpu_torch.models import grid_mrf
    from libdogleg_tpu_torch.models import pinhole_ba as pba
    from libdogleg_tpu_torch.ops.cholesky import cholesky_solve, factorize_jtj
    from libdogleg_tpu_torch.utils.benchtime import measure_ms

    check(torch.backends.cuda.matmul.allow_tf32 is False,
          "phase 19: torch.backends.cuda.matmul.allow_tf32 is False")

    # config 5: J, x from numpy's default_rng(0), JtJ = J^T J; the pass
    # factorizes inside, as bench_all.py times it
    nmeas, nstate, fs = CONFIG5
    rng = np.random.default_rng(0)
    J_np, x_np = rng.normal(size=(nmeas, nstate)), rng.normal(size=nmeas)

    def inputs(dtype, device):
        J = torch.as_tensor(J_np, dtype=dtype, device=device)
        return J, torch.as_tensor(x_np, dtype=dtype, device=device), J.T @ J

    def pass5(J, x, JtJ):
        L = factorize_jtj(JtJ, torch.zeros((), dtype=J.dtype,
                                           device=J.device)).L
        return get_outlierness_factors(x, J, L, feature_size=fs)[0]
    since = time.perf_counter()
    f64 = pass5(*inputs(torch.float64, dev))
    f64_cpu = pass5(*inputs(torch.float64, "cpu"))
    args32 = inputs(torch.float32, dev)
    f32 = pass5(*args32)
    check(f64.shape == (nmeas // fs,) and bool(torch.isfinite(f64).all())
          and bool(torch.isfinite(f32).all()), "config 5: finite factors")
    err = float(((f64.cpu() - f64_cpu).abs() / f64_cpu.abs()).max())
    check(torch.allclose(f64.cpu(), f64_cpu, rtol=1e-9, atol=0.0),
          f"config 5: f64 card vs CPU within rtol 1e-9: {err:.3e}")
    ms = measure_ms(pass5, *args32, warmup=2, reps=10)
    print(f"[19 config 5] nmeas {nmeas}, nstate {nstate}, feature_size "
          f"{fs}: f64 card vs CPU max rel {err:.3e} (rtol 1e-9); f32 vs f64 "
          f"{rel_diff_text(f32, f64)}; factors > 1: f32 "
          f"{int((f32 > 1).sum())}, f64 {int((f64 > 1).sum())} of "
          f"{nmeas // fs}; f32 pass (factorization included) {ms:.4f} ms by "
          f"CUDA events, {nmeas // fs / ms * 1e3:.4g} features/s; "
          f"{time.perf_counter() - since:.1f} s; card {card}", flush=True)
    print(f"[19 config 5 profile] {op_summary_line(pass5, *args32)}; "
          f"{device_split(pass5, *args32, groups=BA_GROUPS)}", flush=True)
    del f64, f64_cpu, f32, args32

    # config 7o: phase 18's config 7s float32 solve, its factorization
    # taken once and reused by every pass (bench_all.py:448-483)
    since = time.perf_counter()
    ba, r = ba7s, r7s
    ns = ba.newton_solver()
    nmeas7 = 2 * ba.nobs + 6 + 3 * ba.npts
    fac = ns.factor(ba.products(r.p).JtJ, r.lam)
    check(bool(fac[1]), "config 7o: the factorization at the solution is ok")

    ba64 = dataclasses.replace(
        ba, obs=ba.obs.double(), cam0_prior=ba.cam0_prior.double(),
        pts_prior=ba.pts_prior.double(),
        p_true={k: v.double() for k, v in ba.p_true.items()})

    def pass7o(p, lam, n2, fac):
        model = ba64 if p["c"].dtype == torch.float64 else ba
        robs, Jc, Jq = model.observation_jacobians(p)
        return get_outlierness_factors_ba(robs, Jc, Jq, model.products(p).JtJ,
                                          lam, n2, nmeas7, ns,
                                          factorization=fac)[0]

    f1 = pass7o(r.p, r.lam, r.norm2_x, fac)
    f2 = pass7o(r.p, r.lam, r.norm2_x, fac)
    check(f1.shape == (ba.npts, ba.k_obs) and bool(torch.isfinite(f1).all()),
          "config 7o: every factor finite")
    check(same_bits(f1, f2), "config 7o: two passes give the same bits")
    p64 = {k: v.double() for k, v in r.p.items()}
    pr64 = ba64.products(p64)
    lam64 = r.lam.double()
    fac64 = ns.factor(pr64.JtJ, lam64)
    check(bool(fac64[1]), "config 7o f64: the factorization is ok")
    f64 = pass7o(p64, lam64, pr64.norm2_x, fac64)
    check(bool(torch.isfinite(f64).all()), "config 7o f64: finite factors")
    ms = measure_ms(pass7o, r.p, r.lam, r.norm2_x, fac, warmup=1, reps=5)
    # the factors alone, from the Jacobians and JtJ computed once
    robs, Jc, Jq = ba.observation_jacobians(r.p)
    JtJ = ba.products(r.p).JtJ

    def factors7o():
        return get_outlierness_factors_ba(robs, Jc, Jq, JtJ, r.lam,
                                          r.norm2_x, nmeas7, ns,
                                          factorization=fac)[0]
    ms_f = measure_ms(factors7o, warmup=1, reps=5)
    # the pass's dense S^-1 T products alone, at its shapes: one
    # (nc, nc) x (nc, 3 chunk) product a chunk of 4096 points
    Sinv = cholesky_solve(fac[0][1], torch.eye(ns.nc, dtype=torch.float32,
                                                 device=dev))
    Ts = [torch.randn(ns.nc, 3 * min(4096, ba.npts - lo), device=dev)
          for lo in range(0, ba.npts, 4096)]

    def sinv_t():
        return [Sinv @ T for T in Ts]
    ms_st = measure_ms(sinv_t, warmup=1, reps=5)
    st_ops = 2.0 * ns.nc * ns.nc * 3 * ba.npts
    print(f"[19 config 7o] ncam {ba.ncam}, npts {ba.npts}, k_obs {ba.k_obs}, "
          f"nobs {ba.nobs}, nmeas {nmeas7}: factorization ok, reused; "
          f"every factor finite, two passes the same bits; f32 vs f64 at the "
          f"same point {rel_diff_text(f1, f64)}; candidates (> 1) f32 "
          f"{int((f1 > 1).sum())}, f64 {int((f64 > 1).sum())} of {ba.nobs}; "
          f"f32 pass (Jacobians, JtJ and factors) {ms:.3f} ms by CUDA "
          f"events, {ba.nobs / ms * 1e3:.4g} observations/s; the factors "
          f"alone (Jacobians and JtJ given) {ms_f:.3f} ms; the S^-1 T "
          f"products alone {ms_st:.3f} ms ({100 * ms_st / ms:.1f}% of the "
          f"pass, {100 * ms_st / ms_f:.1f}% of the factors; {st_ops:.3g} "
          f"operations, {st_ops / ms_st / 1e9:.3g} TFLOP/s, bound "
          f"{st_ops / PEAK_F32_FLOP_PER_S * 1e3:.3f} ms); "
          f"{time.perf_counter() - since:.1f} s; card {card}", flush=True)
    args7o = (r.p, r.lam, r.norm2_x, fac)
    print(f"[19 config 7o profile] {op_summary_line(pass7o, *args7o)}; "
          f"{device_split(pass7o, *args7o, groups=BA_GROUPS)}", flush=True)
    print(f"[19 config 7o factors profile] "
          f"{device_split(factors7o, groups=BA_GROUPS)}", flush=True)
    del f1, f2, f64, fac64, pr64, Sinv, Ts, robs, Jc, Jq, JtJ

    # the BA pass at a small size, float64, card against CPU: the factors
    # of this instance amplify rounding ~1e8 times (S's condition number
    # under the camera-0 prior), so two orders of summation agree to
    # ~2e-8, the JAX package's own tolerance for them 1e-7
    out = []
    small = None
    for device in (torch.device("cpu"), dev):
        b = pba.make_synthetic_sparse(seed=3, ncam=6, npts=60, k_obs=3,
                                      dtype=torch.float64, device=device)
        if small is None:
            small = solve_products(
                b.products, b.p0(torch.Generator().manual_seed(2),
                                 jitter=0.02),
                DoglegParameters(), newton_solver=b.newton_solver())
        p = {k: v.to(device) for k, v in small.p.items()}
        robs, Jc, Jq = b.observation_jacobians(p)
        out.append(get_outlierness_factors_ba(
            robs, Jc, Jq, b.products(p).JtJ, small.lam.to(device),
            small.norm2_x.to(device), 2 * b.nobs + 6 + 3 * b.npts,
            b.newton_solver(), chunk=16)[0].cpu())
    f_cpu, f_card = out
    err = float(((f_card - f_cpu).abs() / f_cpu.abs()).max())
    check(torch.allclose(f_card, f_cpu, rtol=1e-7, atol=1e-10),
          f"BA outlierness small f64 card vs CPU within rtol 1e-7: {err:.3e}")
    print(f"[19 config 7o small f64] ncam 6, npts 60, k_obs 3, chunk 16: "
          f"card vs CPU max rel {err:.3e} (rtol 1e-7)", flush=True)

    # windowed query traces on the 32x32x8 grid's supernodal factor
    # (config 6's rcm, amalgamate=16) against its dense factor, f64
    since = time.perf_counter()
    nq, qfs, w = QUERIES
    g = grid_mrf.make_grid_mrf(*GRID, dtype=torch.float64, device=dev)
    prob = SparseProblem(f=g.problem(jtj="dense").f, structure=g.structure,
                         jtj="sparse", ordering="rcm", amalgamate=16)
    p = torch.zeros(g.nstate, dtype=torch.float64, device=dev)
    pr = prob.products(p)
    sn = prob.default_newton_solver()
    be = sn._backend()
    zero = torch.zeros((), dtype=torch.float64, device=dev)
    Lb, ok = be.factorize(sn.symbolic, pr.JtJ, zero)
    check(bool(ok), "the grid's supernodal factor is ok")
    Ld = factorize_jtj(g.problem(jtj="dense").products(p).JtJ, zero)
    check(bool(Ld.ok) and float(Ld.lam) == 0.0,
          "the grid's dense factor is ok at lambda 0")
    qrng = np.random.default_rng(19)
    Jq_win = torch.as_tensor(qrng.normal(size=(nq, qfs, w)), device=dev)
    starts = qrng.integers(0, g.nstate - w, size=nq)
    starts[:2] = -w // 2, g.nstate - w // 2   # past either end
    starts = torch.as_tensor(starts, device=dev)
    nmeas_g = prob.f(p)[0].numel()
    t_sp = outlierness_trace_new_features_windowed(
        Jq_win, starts, None, pr.norm2_x, nmeas_g, nstate=g.nstate,
        solve_fn=lambda rhs: be.solve(sn.symbolic, Lb, rhs))
    t_d = outlierness_trace_new_features_windowed(
        Jq_win, starts, Ld.L, pr.norm2_x, nmeas_g)
    err = float(((t_sp - t_d).abs() / t_d.abs()).max())
    check(bool(torch.isfinite(t_sp).all()) and torch.allclose(
        t_sp, t_d, rtol=1e-9, atol=0.0),
        f"windowed traces: supernodal vs dense factor within rtol 1e-9: "
        f"{err:.3e}")
    print(f"[19 windowed traces] grid {GRID}, nstate {g.nstate}: {nq} "
          f"queries, fs {qfs}, w {w}, starts from {int(starts.min())} to "
          f"{int(starts.max())}; supernodal factor vs dense factor max rel "
          f"{err:.3e} (rtol 1e-9); {time.perf_counter() - since:.1f} s",
          flush=True)


# config 9 of bench_all.py:486-512: (batch, ncam, npts), with the
# observation noise and the start jitter its instances are drawn with;
# config 7xl of bench_all.py:573-575
CONFIG9 = (64, 4, 2048)
CONFIG9_NOISE, CONFIG9_JITTER = 0.5, 0.02
CONFIG7XL = dict(seed=0, ncam=256, npts=200000, k_obs=4)


def config9_inputs(ba, batch, obs_gen, p0_gen):
    """Per-element observations obs + 0.5 N(0, 1) and starts p_true + 0.02
    N(0, 1), drawn from the two generators on their own devices and moved
    to the instance's, so CPU generators give one batch on every device."""
    import torch
    dev, dt = ba.obs.device, ba.obs.dtype

    def draw(shape, gen):
        return torch.randn(shape, generator=gen, dtype=dt,
                           device=gen.device).to(dev)
    obs_b = ba.obs[None] + CONFIG9_NOISE * draw(
        (batch,) + tuple(ba.obs.shape), obs_gen)
    p0 = {k: v[None] + CONFIG9_JITTER * draw((batch,) + tuple(v.shape),
                                             p0_gen)
          for k, v in sorted(ba.p_true.items())}
    return obs_b, p0


def schur_batch(ba, p0, obs_b, bench, compacted=False, **kw):
    """The batch through the public entry point, each element with its own
    observations, TreeSchurNewtonSolver."""
    from libdogleg_tpu_torch.parallel import (batched_optimize,
                                              batched_optimize_compacted)
    fn = batched_optimize_compacted if compacted else batched_optimize
    return fn(ba.products_obs, p0, bench, problem_data=obs_b,
              newton_solver=ba.newton_solver(), **kw)


def same_result_bits(a, b) -> list:
    """Per element, whether every leaf of two batch-leading results (p,
    Jt_x, the SchurJtJ, History) holds the same bits."""
    import torch

    from libdogleg_tpu_torch.ops import treevec as tv
    ints = {torch.float32: torch.int32, torch.float64: torch.int64}
    per = None
    for x, y in zip(tv.tree_leaves(a), tv.tree_leaves(b)):
        if x.dtype in ints:
            x, y = x.view(ints[x.dtype]), y.view(ints[y.dtype])
        eq = (x == y).reshape(x.shape[0], -1).all(-1)
        per = eq if per is None else per & eq
    return per.tolist()


def history_rows_agree(hb, hs, n, what) -> float:
    """One element's batched History rows (hb, fields (cap,)) against its
    single solve's (hs): integer columns identical, float columns inf in
    the same places and within 1e-8 of the column's largest finite entry
    (1e-5 for rho and the direction change, ratios of near-equal
    differences and angles between steps; tests/test_torch_batched_schur.py
    measures why). Returns the largest relative difference."""
    import torch
    loose = {"rho", "step_direction_change_deg"}
    worst = 0.0
    for name in hb._fields:
        a, b = getattr(hb, name)[:n + 1].cpu(), getattr(hs, name)[:n + 1].cpu()
        if not a.dtype.is_floating_point:
            check(torch.equal(a, b), f"{what}: History {name} identical")
            continue
        fin = torch.isfinite(b)
        check(torch.equal(torch.isfinite(a), fin)
              and torch.equal(a[~fin], b[~fin]),
              f"{what}: History {name} inf in the same rows")
        if bool(fin.any()):
            err = float((a[fin] - b[fin]).abs().max()
                        / b[fin].abs().max().clamp(min=1e-300))
            tol = 1e-5 if name in loose else 1e-8
            check(err <= tol, f"{what}: History {name} within {tol}: "
                  f"{err:.3e}")
            if name not in loose:
                worst = max(worst, err)
    return worst


def phase20_batched_schur(dev, bench, card) -> None:
    """Batched structured solves: config 9 (bench_all.py:486-512), a fleet
    of pinhole bundle adjustments each solved by Schur elimination in one
    masked batched program; then config 7xl once."""
    import torch

    from libdogleg_tpu_torch import solve_products
    from libdogleg_tpu_torch.models import pinhole_ba as pba
    from libdogleg_tpu_torch.utils.benchtime import measure_ms

    check(torch.backends.cuda.matmul.allow_tf32 is False,
          "F1: torch.backends.cuda.matmul.allow_tf32 is False")
    decisions = ("step_count", "n_attempts", "reason")
    cpu = torch.device("cpu")

    # float64, small: the card against the CPU on one batch, then each
    # element against its own single solve on the card
    since = time.perf_counter()
    runs = []
    for device in (dev, cpu):
        ba = pba.make_synthetic(seed=0, ncam=4, npts=64, device=device)
        obs_b, p0 = config9_inputs(ba, 8, torch.Generator().manual_seed(8),
                                   torch.Generator().manual_seed(7))
        runs.append((ba, obs_b, p0, schur_batch(ba, p0, obs_b, bench,
                                                record_history=True)))
    (ba_d, obs_d, p0_d, r_d), (_, _, _, r_c) = runs
    for field in decisions:
        check(torch.equal(getattr(r_d, field).cpu(), getattr(r_c, field)),
              f"config 9 f64 card vs CPU {field} identical")
    check(torch.equal(r_d.history.step_type.cpu(), r_c.history.step_type),
          "config 9 f64 card vs CPU History step types identical")
    check(torch.equal(r_d.lam.cpu(), r_c.lam), "config 9 f64 card vs CPU "
          "lambda identical")
    dp = float((flat_batch(r_d.p).cpu() - flat_batch(r_c.p)).abs().max())
    check(torch.allclose(flat_batch(r_d.p).cpu(), flat_batch(r_c.p),
                         rtol=1e-9, atol=1e-9),
          f"config 9 f64 card vs CPU p within 1e-9: {dp:.3e}")
    worst_h, dps = 0.0, 0.0
    for i in range(8):
        ri = solve_products(
            lambda p, o=obs_d[i]: ba_d.products_obs(p, o),
            {k: v[i] for k, v in p0_d.items()}, bench,
            newton_solver=ba_d.newton_solver(), record_history=True)
        for field in decisions:
            check(int(getattr(ri, field)) == int(getattr(r_d, field)[i]),
                  f"config 9 f64 element {i}: {field} of its single solve")
        pi = flat_p(ri.p)
        pb = flat_batch(r_d.p)[i]
        dps = max(dps, float((pi - pb).abs().max()))
        check(torch.allclose(pb, pi, rtol=1e-9, atol=1e-9),
              f"config 9 f64 element {i}: p within 1e-9 of its single solve")
        hb = type(ri.history)(*(h[i] for h in r_d.history))
        worst_h = max(worst_h, history_rows_agree(
            hb, ri.history, int(ri.n_attempts), f"config 9 f64 element {i}"))
    print(f"[20 decisions f64 B=8 ncam 4 npts 64] card vs CPU: step_count, "
          f"n_attempts, reason, lambda and History step types identical "
          f"(attempts {r_c.n_attempts.tolist()}, reasons "
          f"{r_c.reason.tolist()}); max |dp| {dp:.3e}; each element "
          f"against its own single solve on the card: decisions and "
          f"History step types identical, max |dp| {dps:.3e}, History "
          f"columns within {worst_h:.2e}; "
          f"{time.perf_counter() - since:.1f} s", flush=True)
    del runs, ba_d, obs_d, p0_d, r_d, r_c

    # config 9 at full width, float32
    since = time.perf_counter()
    batch, ncam, npts = CONFIG9
    ba = pba.make_synthetic(seed=0, ncam=ncam, npts=npts,
                            dtype=torch.float32, device=dev)
    obs_b, p0 = config9_inputs(ba, batch,
                               torch.Generator(device=dev).manual_seed(8),
                               torch.Generator(device=dev).manual_seed(7))
    nobs = ba.nobs

    def solve():
        return schur_batch(ba, p0, obs_b, bench)

    def compacted():
        return schur_batch(ba, p0, obs_b, bench, compacted=True)
    before = kernel_launch_counts()
    t0 = time.perf_counter()
    r = solve()
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    check(kernel_launch_counts() == before,
          "config 9: the path launches none of K1-K7")
    check(bool(torch.isfinite(flat_batch(r.p)).all())
          and bool(torch.isfinite(r.norm2_x).all()),
          "config 9: finite result")
    check(r.p["q"].shape == (batch, npts, 3) and r.norm2_x.shape == (batch,),
          "config 9: the result's shapes")
    conv = float((r.norm2_x < 2.0 * nobs).float().mean())
    check(conv >= 0.95, f"config 9: converged_frac {conv} >= 0.95")
    check(bool((r.reason > 0).all()), "config 9: every reason > 0")
    wavefronts = int(r.n_attempts.max())
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r2 = solve()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    same = same_result_bits(r2, r)
    check(all(same), f"config 9: two runs the same bits on every element "
          f"({sum(same)} of {batch})")
    ms = measure_ms(lambda: float(solve().norm2_x.sum()), warmup=0, reps=3)
    syncs, _ = host_syncs(solve)
    events = sum(ev.count for ev in device_events(solve, (), reps=1))
    lams, counts = torch.unique(r.lam.cpu(), return_counts=True)
    hist = ", ".join(f"{float(v):g}: {int(c)}" for v, c in zip(lams, counts))
    sync_text = ("not measured (no sync warnings)" if syncs is None else
                 f"{syncs} ({syncs / wavefronts:.1f} a wavefront)")
    event_text = ("not measured (the profiler returned no events)"
                  if not events else
                  f"{events} ({events / wavefronts:.0f} a wavefront)")
    print(f"[20 config 9 B={batch} ncam {ncam} npts {npts} f32] "
          f"converged_frac {conv:.4f} (>= 0.95, norm2_x < 2 nobs = "
          f"{2 * nobs}); reasons "
          f"{torch.bincount(r.reason.cpu(), minlength=7).tolist()}; "
          f"{wavefronts} wavefronts, {attempts_text(r.n_attempts)}"
          f"; no kernel of K1-K7 launched; first call {first:.3f} s; host "
          f"wall ms {', '.join(f'{w:.2f}' for w in walls)}; CUDA events "
          f"{ms:.2f} ms a batch with a dependent fetch "
          f"({batch / ms * 1e3:.1f} solves/s); device events a solve "
          f"{event_text}; host synchronizations a solve {sync_text}; "
          f"lambda histogram {{{hist}}}; two runs the same bits; card "
          f"{card}", flush=True)
    print(f"[20 config 9 profile] {device_split(solve, groups=BA_GROUPS)}; "
          f"{wavefronts} wavefronts", flush=True)

    # the compacted entry point beside the plain one, in turns
    rc = compacted()
    for field in decisions:
        check(torch.equal(getattr(rc, field), getattr(r, field)),
              f"config 9 compacted: {field} of batched_optimize")
    same = same_result_bits(rc, r)
    check(all(same), f"config 9 compacted: batched_optimize's bits on every "
          f"element ({sum(same)} of {batch})")
    dpc = float((flat_batch(rc.p) - flat_batch(r.p)).abs().max())
    turns = {"batched_optimize": [], "compacted": []}
    for order in (("batched_optimize", "compacted"),
                  ("compacted", "batched_optimize")):
        for name in order:
            fn = solve if name == "batched_optimize" else compacted
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            turns[name].append((time.perf_counter() - t0) * 1e3)
    print(f"[20 config 9 compacted] decisions and bits of batched_optimize "
          f"on all {batch} elements (max |dp| {dpc:.3e}); host wall ms in "
          f"turns: "
          + "; ".join(f"{k} {', '.join(f'{w:.2f}' for w in v)}"
                      for k, v in turns.items()), flush=True)

    # the History on the same batch: the same result, and its cost
    t0 = time.perf_counter()
    rh = schur_batch(ba, p0, obs_b, bench, record_history=True)
    torch.cuda.synchronize()
    wall_h = (time.perf_counter() - t0) * 1e3
    same = same_result_bits(rh._replace(history=None), r)
    check(all(same), "config 9 record_history: the result's bits unchanged")
    check(bool((rh.history.step_type[:, 0] != 4).sum()
               == (r.n_attempts > 0).sum()),
          "config 9 record_history: a first row for every element that "
          "took an attempt")
    print(f"[20 config 9 record_history] the same bits as without on every "
          f"element; host wall {wall_h:.2f} ms (without: "
          f"{min(walls):.2f}-{max(walls):.2f})", flush=True)
    del r, r2, rc, rh, obs_b, p0, ba

    # the batched History against single solves, float64, npts 256
    ba = pba.make_synthetic(seed=0, ncam=ncam, npts=256, device=dev)
    obs_b, p0 = config9_inputs(ba, batch,
                               torch.Generator(device=dev).manual_seed(8),
                               torch.Generator(device=dev).manual_seed(7))
    rh = schur_batch(ba, p0, obs_b, bench, record_history=True)
    worst = 0.0
    picked = (0, batch // 3, 2 * batch // 3, batch - 1)
    for i in picked:
        ri = solve_products(
            lambda p, o=obs_b[i]: ba.products_obs(p, o),
            {k: v[i] for k, v in p0.items()}, bench,
            newton_solver=ba.newton_solver(), record_history=True)
        check(int(ri.n_attempts) == int(rh.n_attempts[i]),
              f"config 9 History f64 element {i}: attempts")
        hb = type(ri.history)(*(h[i] for h in rh.history))
        worst = max(worst, history_rows_agree(
            hb, ri.history, int(ri.n_attempts),
            f"config 9 History f64 element {i}"))
    print(f"[20 config 9 History f64 B={batch} npts 256] the rows of "
          f"elements {picked} equal their single solves' (integer "
          f"columns identical, float columns within {worst:.2e}); "
          f"{time.perf_counter() - since:.1f} s for config 9", flush=True)
    del ba, obs_b, p0, rh

    # config 7xl, once: sparse visibility at ncam 256, npts 200000
    since = time.perf_counter()
    ba = pba.make_synthetic_sparse(dtype=torch.float32, device=dev,
                                   **CONFIG7XL)
    p0 = ba.p0(torch.Generator(device=dev).manual_seed(2), jitter=0.02)
    ns = ba.newton_solver()
    nobs = ba.nobs

    def solve7xl():
        return solve_products(ba.products, p0, bench, newton_solver=ns)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    r = solve7xl()
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    check(bool(torch.isfinite(flat_p(r.p)).all())
          and bool(torch.isfinite(r.norm2_x)), "config 7xl: finite result")
    check(float(r.norm2_x) < 2 * nobs,
          f"config 7xl: gate norm2_x < 2 nobs: {float(r.norm2_x):.6g}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    solve7xl()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    print(f"[20 config 7xl ncam {ba.ncam} npts {ba.npts} k_obs {ba.k_obs} "
          f"f32] gate norm2_x < 2 nobs: {float(r.norm2_x):.6g} < "
          f"{2 * nobs}; reason {int(r.reason)}, steps {int(r.step_count)}, "
          f"attempts {int(r.n_attempts)}, lambda {float(r.lam):.3g}; first "
          f"call {first:.2f} s, host wall {wall:.1f} ms; "
          f"max_memory_allocated {peak / 2 ** 30:.2f} GiB; card {card}",
          flush=True)
    print(f"[20 config 7xl profile] "
          f"{device_split(solve7xl, groups=BA_GROUPS)}; "
          f"{int(r.n_attempts)} attempts; "
          f"{time.perf_counter() - since:.1f} s for config 7xl", flush=True)


# config 2 of bench_all.py:145-154 (nmeas, Nstate 3), its three problem
# forms, and the batch of config 7s's cell ba-sparse-batched-B8-f32
CONFIG2_NMEAS = 64
CONFIG2_FORMS = ("make_dense_problem", "make_products_problem",
                 "make_residual_problem")
SPARSE_BATCH = 8


def config2_inputs(dtype, device):
    """Config 2's instance with numpy seeds in place of the JAX package's
    keys: measurements P_TRUE's curve + 0.02 N(0, 1) from default_rng(0),
    the start U(-0.5, 0.5) from default_rng(1) (curve_fit.simulate's and
    initial_state's distributions)."""
    import torch

    from libdogleg_tpu_torch.models import curve_fit as cf
    t = np.linspace(0.0, 1.0, CONFIG2_NMEAS)
    meas = (cf.P_TRUE[0] * np.exp(cf.P_TRUE[1] * t) + cf.P_TRUE[2]
            + 0.02 * np.random.default_rng(0).normal(size=CONFIG2_NMEAS))
    p0 = np.random.default_rng(1).uniform(size=cf.NSTATE) - 0.5
    return (torch.as_tensor(meas, dtype=dtype, device=device),
            torch.as_tensor(p0, dtype=dtype, device=device))


def states_same_bits(a, b) -> bool:
    """Whether two solve states (single or batched) hold the same values
    in every field, tensors bit for bit (NaN included)."""
    import torch

    from libdogleg_tpu_torch.ops import treevec as tv

    def equal(u, v):
        if u.is_floating_point():
            return same_bits(u, v)
        return u.dtype == v.dtype and torch.equal(u, v)
    for name in a._fields:
        x, y = getattr(a, name), getattr(b, name)
        if isinstance(x, (bool, int)) or x is None:
            if x != y or type(x) is not type(y):
                return False
            continue
        xs, ys = tv.tree_leaves(x), tv.tree_leaves(y)
        if len(xs) != len(ys) or not all(equal(u, v)
                                         for u, v in zip(xs, ys)):
            return False
    return True


def phase21_surface(dev, bench, card) -> None:
    """The rest of the single solve's surface and the batched sparse-W
    Schur solve: config 2 (curve_fit) in its three forms, one attempt a
    segment; config 8's masked solve in two segments across a checkpoint
    (K5 on both); config 7s's sparse-W bundle adjustment as a batch of 8."""
    import dataclasses
    import os
    import tempfile

    import torch

    from libdogleg_tpu_torch import (checkpoint, init_batched_state,
                                     init_solver_state, optimize,
                                     run_batched_solver, run_solver,
                                     solve_products)
    from libdogleg_tpu_torch.models import curve_fit as cf
    from libdogleg_tpu_torch.models import pinhole_ba as pba
    from libdogleg_tpu_torch.ops import batchchol, newton
    from libdogleg_tpu_torch.parallel import batched_optimize
    from libdogleg_tpu_torch.utils.benchtime import measure_ms

    check(torch.backends.cuda.matmul.allow_tf32 is False,
          "F1: torch.backends.cuda.matmul.allow_tf32 is False")
    decisions = ("step_count", "n_attempts", "reason")
    cpu = torch.device("cpu")

    # config 2: the three forms in float32 and float64; float64 against
    # the same code on CPU tensors
    since = time.perf_counter()
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).split(".")[-1]
        meas, p0 = config2_inputs(dtype, dev)
        parts = []
        for form in CONFIG2_FORMS:
            r = optimize(getattr(cf, form)(meas), p0, bench,
                         record_history=True)
            check(bool(torch.isfinite(r.p).all()) and int(r.reason) > 0,
                  f"config 2 {form} {name}: finite p and reason > 0")
            err = float((r.p.double().cpu()
                         - torch.as_tensor(cf.P_TRUE)).abs().max())
            text = (f"{form[5:-8]}: steps {int(r.step_count)}, attempts "
                    f"{int(r.n_attempts)}, reason {int(r.reason)}, max "
                    f"|p - P_TRUE| {err:.4g} (recovered {err < 0.2})")
            if dtype == torch.float64:
                mc, pc = config2_inputs(dtype, cpu)
                rc = optimize(getattr(cf, form)(mc), pc, bench,
                              record_history=True)
                for field in decisions:
                    check(int(getattr(r, field)) == int(getattr(rc, field)),
                          f"config 2 {form} f64 card vs CPU {field}")
                check(torch.equal(r.history.step_type.cpu(),
                                  rc.history.step_type),
                      f"config 2 {form} f64 card vs CPU History step types")
                dp = float((r.p.cpu() - rc.p).abs().max())
                check(dp <= 1e-8, f"config 2 {form} f64 card vs CPU p "
                      f"within 1e-8: {dp:.3e}")
                text += f", card vs CPU decisions identical, |dp| {dp:.2e}"
            parts.append(text)
        print(f"[21 config 2 nmeas {CONFIG2_NMEAS} {name} PRM] "
              + "; ".join(parts), flush=True)

    # one solve's times, and one attempt a segment against the one-shot run
    meas, p0 = config2_inputs(torch.float32, dev)
    problem = cf.make_dense_problem(meas)

    def solve2():
        return optimize(problem, p0, bench)
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solve2()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    ms2 = measure_ms(lambda: float(solve2().norm2_x), warmup=1, reps=5)
    segs = []
    for dtype in (torch.float32, torch.float64):
        m, q = config2_inputs(dtype, dev)
        prod = cf.make_dense_problem(m).products
        one = run_solver(prod, init_solver_state(prod, q, bench,
                                                 record_history=True),
                         bench)
        st = init_solver_state(prod, q, bench, record_history=True)
        n = 0
        while not st.done:
            st = run_solver(prod, st, bench, max_new_attempts=1)
            n += 1
        check(n == one.n_attempts and states_same_bits(st, one),
              f"config 2 {dtype}: one attempt a segment gives the "
              f"one-shot run's bits")
        segs.append(f"{str(dtype).split('.')[-1]} {n} segments")
    print(f"[21 config 2 f32 dense, one solve] host wall ms "
          f"{', '.join(f'{w:.2f}' for w in walls)}; CUDA events "
          f"{ms2:.2f} ms a solve with a dependent fetch; one attempt a "
          f"segment equals the one-shot run bit for bit, History included "
          f"({', '.join(segs)}); {time.perf_counter() - since:.1f} s; card "
          f"{card}", flush=True)

    # config 8 (Nstate 64, batch 512, f32) in two segments across a
    # checkpoint, beside the one-shot public call
    since = time.perf_counter()
    nstate, batch = MIDSIZE[0]
    data, p0, p_true = midsize_family(nstate, batch, torch.float32, dev)
    vf = torch.func.vmap(midsize_products)

    def products(p):
        return vf(p, data)
    ns = newton.BlockedDenseNewtonSolver()
    batchchol.launch_count = 0
    one = batched_optimize(midsize_products, p0, bench, problem_data=data,
                           newton_solver=ns)
    torch.cuda.synchronize()
    k5_one = batchchol.launch_count
    batchchol.launch_count = 0
    st = run_batched_solver(products, init_batched_state(products, p0,
                                                         bench),
                            bench, newton_solver=ns, max_new_attempts=2)
    torch.cuda.synchronize()
    k5_first = batchchol.launch_count
    check(int(st.n_attempts.max()) == 2 and not bool(st.done.all()),
          "config 8: the first segment stops after 2 attempts")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "config8.npz")
        checkpoint.save_state(path, st)
        size = os.path.getsize(path)
        loaded = checkpoint.load_state(path)
    check(loaded.p.device.type == dev.type and states_same_bits(loaded, st),
          "config 8: the loaded state is on the card, bit for bit the saved")
    batchchol.launch_count = 0
    fin = run_batched_solver(products, loaded, bench, newton_solver=ns)
    torch.cuda.synchronize()
    k5_rest = batchchol.launch_count
    check(k5_first >= 1 and k5_rest >= 1,
          f"config 8: K5 launched in both segments ({k5_first}, {k5_rest})")
    for field in decisions:
        check(torch.equal(getattr(fin, field), getattr(one, field)),
              f"config 8 resumed: {field} of the one-shot run")
    check(same_bits(fin.p, one.p) and same_bits(fin.norm2_x, one.norm2_x),
          "config 8 resumed: p and norm2_x bit for bit the one-shot run's")
    rec = midsize_recovered(fin.p, p_true)
    check(rec >= 0.99, f"config 8 resumed: recovered_frac {rec} >= 0.99")
    print(f"[21 config 8 Nstate {nstate} B={batch} f32 checkpoint] 2 "
          f"attempts, save_state ({size / 1e6:.1f} MB .npz), load_state onto "
          f"the card, run to the end: p, norm2_x, reason and n_attempts bit "
          f"for bit the one-shot batched_optimize's; K5 launches {k5_first} "
          f"+ {k5_rest} (one-shot {k5_one}); attempts "
          f"{int(fin.n_attempts.min())}..{int(fin.n_attempts.max())}; "
          f"recovered_frac {rec:.4f}; {time.perf_counter() - since:.1f} s",
          flush=True)
    del data, p0, one, st, loaded, fin

    # the batched sparse-W solve, float64 at a small size: the card
    # against the CPU, each element against its own single solve
    since = time.perf_counter()
    runs = []
    for device in (dev, cpu):
        ba = pba.make_synthetic_sparse(seed=0, ncam=8, npts=80, k_obs=3,
                                       device=device)
        obs_b, p0 = config9_inputs(ba, 4, torch.Generator().manual_seed(8),
                                   torch.Generator().manual_seed(7))
        runs.append((ba, obs_b, p0, batched_optimize(
            ba.products_obs, p0, bench, problem_data=obs_b,
            newton_solver=ba.newton_solver(), record_history=True)))
    (ba_d, obs_d, p0_d, r_d), (_, _, _, r_c) = runs
    for field in decisions + ("lam",):
        check(torch.equal(getattr(r_d, field).cpu(), getattr(r_c, field)),
              f"sparse-W batch f64 card vs CPU {field} identical")
    check(torch.equal(r_d.history.step_type.cpu(), r_c.history.step_type),
          "sparse-W batch f64 card vs CPU History step types identical")
    dp = float((flat_batch(r_d.p).cpu() - flat_batch(r_c.p)).abs().max())
    check(torch.allclose(flat_batch(r_d.p).cpu(), flat_batch(r_c.p),
                         rtol=1e-9, atol=1e-9),
          f"sparse-W batch f64 card vs CPU p within 1e-9: {dp:.3e}")
    dps = 0.0
    for i in range(4):
        ri = solve_products(lambda p, o=obs_d[i]: ba_d.products_obs(p, o),
                            {k: v[i] for k, v in p0_d.items()}, bench,
                            newton_solver=ba_d.newton_solver())
        for field in decisions:
            check(int(getattr(ri, field)) == int(getattr(r_d, field)[i]),
                  f"sparse-W batch f64 element {i}: {field} of its single "
                  f"solve")
        pi, pb = flat_p(ri.p), flat_batch(r_d.p)[i]
        dps = max(dps, float((pi - pb).abs().max()))
        check(torch.allclose(pb, pi, rtol=1e-9, atol=1e-9),
              f"sparse-W batch f64 element {i}: p within 1e-9 of its single "
              f"solve")
    print(f"[21 sparse-W batch f64 B=4 ncam 8 npts 80 k_obs 3] card vs CPU: "
          f"step_count, n_attempts, reason, lambda and History step types "
          f"identical (attempts {r_c.n_attempts.tolist()}, reasons "
          f"{r_c.reason.tolist()}), max |dp| {dp:.3e}; each element against "
          f"its own single solve on the card: decisions identical, max |dp| "
          f"{dps:.3e}; {time.perf_counter() - since:.1f} s", flush=True)
    del runs, ba_d, obs_d, p0_d, r_d, r_c

    # config 7s at full width as a batch of 8, float32
    since = time.perf_counter()
    ba = pba.make_synthetic_sparse(dtype=torch.float32, device=dev,
                                   **BA_SPARSE)
    obs_b, p0 = config9_inputs(ba, SPARSE_BATCH,
                               torch.Generator(device=dev).manual_seed(8),
                               torch.Generator(device=dev).manual_seed(7))
    ns = ba.newton_solver()
    nobs = ba.nobs
    check(SPARSE_BATCH * ba.npts * ns.nc * 3 > ns.s_chunk_limit,
          "ba-sparse-batched: S is assembled over chunks of points")

    def solve(strategy=ns):
        return batched_optimize(ba.products_obs, p0, bench,
                                problem_data=obs_b, newton_solver=strategy)

    def gate(r, label):
        check(bool(torch.isfinite(flat_batch(r.p)).all())
              and bool(torch.isfinite(r.norm2_x).all()),
              f"{label}: finite result")
        check(r.p["q"].shape == (SPARSE_BATCH, ba.npts, 3),
              f"{label}: the result's shapes")
        check(bool((r.norm2_x < 2 * nobs).all()),
              f"{label}: every element norm2_x < 2 nobs = {2 * nobs}: "
              f"{r.norm2_x.tolist()}")
        check(bool((r.reason > 0).all()), f"{label}: every reason > 0")
    before = kernel_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    r = solve()
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    check(kernel_launch_counts() == before,
          "ba-sparse-batched: the path launches none of K1-K7")
    gate(r, "ba-sparse-batched")
    wavefronts = int(r.n_attempts.max())
    walls = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r2 = solve()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    same = same_result_bits(r2, r)
    check(all(same), f"ba-sparse-batched: two runs the same bits on every "
          f"element ({sum(same)} of {SPARSE_BATCH})")
    ms = measure_ms(lambda: float(solve().norm2_x.sum()), warmup=0, reps=2)
    syncs, _ = host_syncs(solve)
    events = sum(ev.count for ev in device_events(solve, (), reps=1))
    lams, counts = torch.unique(r.lam.cpu(), return_counts=True)
    hist = ", ".join(f"{float(v):g}: {int(c)}" for v, c in zip(lams, counts))
    sync_text = ("not measured (no sync warnings)" if syncs is None else
                 f"{syncs} ({syncs / wavefronts:.1f} a wavefront)")
    event_text = ("not measured (the profiler returned no events)"
                  if not events else
                  f"{events} ({events / wavefronts:.0f} a wavefront)")
    print(f"[21 ba-sparse-batched-B{SPARSE_BATCH}-f32 ncam {ba.ncam} npts "
          f"{ba.npts} k_obs {ba.k_obs}] gate norm2_x < 2 nobs = {2 * nobs} "
          f"and reason > 0 on every element: norm2_x "
          f"{[round(v, 1) for v in r.norm2_x.tolist()]}, reasons "
          f"{r.reason.tolist()}; {wavefronts} wavefronts, "
          f"{attempts_text(r.n_attempts)}; lambda histogram {{{hist}}}; no "
          f"kernel of K1-K7 launched; allow_tf32 False; first call "
          f"{first:.2f} s; host wall ms "
          f"{', '.join(f'{w:.1f}' for w in walls)}; CUDA events {ms:.1f} ms "
          f"a batch with a dependent fetch "
          f"({SPARSE_BATCH / ms * 1e3:.2f} solves/s); device events "
          f"{event_text}; host synchronizations {sync_text}; "
          f"max_memory_allocated {peak / 2 ** 30:.2f} GiB; two runs the "
          f"same bits; card {card}", flush=True)
    print(f"[21 ba-sparse-batched profile] "
          f"{device_split(solve, groups=BA_GROUPS)}; {wavefronts} "
          f"wavefronts", flush=True)
    refined = dataclasses.replace(
        ns, refine_iters=2,
        cam_gather=newton.build_cam_gather(ba.cam_of, ba.ncam))
    t0 = time.perf_counter()
    rr = solve(refined)
    torch.cuda.synchronize()
    wall_r = (time.perf_counter() - t0) * 1e3
    gate(rr, "ba-sparse-batched refine_iters=2 cam_gather")
    dcost = float(((rr.norm2_x - r.norm2_x) / r.norm2_x).abs().max())
    print(f"[21 ba-sparse-batched refine_iters=2 cam_gather] gate met on "
          f"every element: norm2_x "
          f"{[round(v, 1) for v in rr.norm2_x.tolist()]}, reasons "
          f"{rr.reason.tolist()}, attempts {rr.n_attempts.tolist()}, lambda "
          f"{sorted(set(rr.lam.tolist()))}; costs within {dcost:.2e} of the "
          f"plain leg's; host wall {wall_r:.1f} ms; "
          f"{time.perf_counter() - since:.1f} s for the cell", flush=True)


GRID_6B = (64, 64, 8)   # config 6b of bench_all.py:568-570: Nstate 32768
SPARSE_B = 16           # grid-mrf-32x32x8-sparse-batched-B16-f32
K3_GROUPS = (("K3", ("jtj_",)),) + SPARSE_GROUPS


def grid_batch(g, sched):
    """(products(p, data), values(mix)) of a batch of grid MRFs that share
    g's graph, each element with its own data = (z_prior, z_edge, mix):
    the products a user writes from the public functions (the grid's
    residual, BCSRJacobian, bcsr_jt_x, bcsr_jtj_lower_blocks on one shared
    lower schedule); values gives the Jacobian's blocks of one element or,
    for a (B, ...) mix, of a batch."""
    import math

    import torch

    from libdogleg_tpu_torch import Products
    from libdogleg_tpu_torch.ops import bcsr
    n, ne, b = g.n_nodes, g.edges.shape[0], g.block_size
    dev, dt = g.z_prior.device, g.z_prior.dtype
    eu = torch.as_tensor(g.edges[:, 0], device=dev)
    ev = torch.as_tensor(g.edges[:, 1], device=dev)
    sp, se = math.sqrt(g.w_prior), math.sqrt(g.w_edge)
    eye = torch.eye(b, dtype=dt, device=dev)

    def values(mix):
        lead = tuple(mix.shape[:-3])
        return torch.cat([
            (sp * eye).expand(lead + (n, b, b)),
            torch.stack([(-se * eye).expand(mix.shape), se * mix],
                        -3).reshape(lead + (2 * ne, b, b))], -3)

    def products(p, data):
        zp, ze, mix = data
        pb = p.reshape(n, b)
        x = torch.cat([(sp * (pb - zp)).reshape(-1),
                       (se * ((mix @ pb[ev][..., None])[..., 0] - pb[eu]
                              - ze)).reshape(-1)])
        J = bcsr.BCSRJacobian(g.structure, values(mix))
        return Products(norm2_x=x @ x, Jt_x=bcsr.bcsr_jt_x(J, x),
                        JtJ=bcsr.bcsr_jtj_lower_blocks(J, sched))
    return products, values


def grid_batch_data(width, b, batch, dtype, device):
    """The first instance and the stacked (z_prior, z_edge, mix) of a batch
    of grid MRFs, coupling "dense", element s made with seed s."""
    import torch

    from libdogleg_tpu_torch.models import grid_mrf
    gs = [grid_mrf.make_grid_mrf(width, width, b, coupling="dense", seed=s,
                                 dtype=dtype, device=device)
          for s in range(batch)]
    return gs[0], tuple(torch.stack([getattr(x, k) for x in gs])
                        for k in ("z_prior", "z_edge", "mix"))


@contextlib.contextmanager
def python_analysis():
    """The symbolic analysis's Python forms: every wrapper of
    native/symbolic.py answers as without the host library."""
    from libdogleg_tpu_torch.native import symbolic as nsym
    held = nsym.load_host_library
    nsym.load_host_library = lambda: None
    try:
        yield
    finally:
        nsym.load_host_library = held


def scalar_csr(s):
    """The scalar CSR pattern (rowptr, colidx) of a block structure: every
    entry of every stored block."""
    bm, bn = s.block_rows, s.block_cols
    counts = np.diff(s.indptr) * bn                     # per scalar row
    rowptr = np.concatenate([[0], np.cumsum(np.repeat(counts, bm))])
    cols = (s.indices[:, None] * bn + np.arange(bn)).reshape(-1)
    per_row = [cols[s.indptr[r] * bn:s.indptr[r + 1] * bn]
               for r in range(s.nbrow)]
    colidx = np.concatenate([c for c in per_row for _ in range(bm)])
    return rowptr.astype(np.int64), colidx.astype(np.int32)


def analysis_native_vs_python(width) -> str:
    """Each of the four analyses of the width x width x 8 grid through the
    host library and through its Python form: the same arrays, the seconds
    of each; the native one must be the one that ran by default."""
    from libdogleg_tpu_torch import ordering, sparsity
    from libdogleg_tpu_torch import sparse_cholesky as sc
    from libdogleg_tpu_torch import supernodal as sn
    from libdogleg_tpu_torch.models import grid_mrf
    from libdogleg_tpu_torch.native import symbolic as nsym
    from libdogleg_tpu_torch.ops import bcsr
    from libdogleg_tpu_torch.ops import bcsr_kernels as tk
    s = grid_mrf.make_grid_mrf(width, width, 8, device="cpu").structure
    sched = bcsr.jtj_lower_schedule(s)
    rows, cols, nb = sched.rows, sched.cols, s.nbcol
    rowptr, colidx = scalar_csr(s)

    def same(a, b, what):
        fields = getattr(a, "_fields", None)
        if fields is None and hasattr(a, "sched"):
            for f in ("rows", "cols", "a_slot_of_input", "perm"):
                same(getattr(a, f), getattr(b, f), f"{what} {f}")
            for f in ("sched", "fwd", "bwd"):
                same(getattr(a, f), getattr(b, f), f"{what} {f}")
            return
        if fields is not None:
            for f in fields:
                same(getattr(a, f), getattr(b, f), f"{what} {f}")
            return
        check(np.array_equal(np.asarray(a), np.asarray(b)),
              f"{width}x{width}x8 {what}: native and Python the same")

    jobs = (
        ("jtj schedule", lambda: tk.build_jtj_schedule(s), "jtj_schedule"),
        ("block pattern", lambda: sparsity.bcsr_from_scalar_csr(
            rowptr, colidx, s.nmeas, s.nstate, 8, 8), "bcsr_pattern"),
        ("mindeg", lambda: ordering.mindeg_ordering(rows, cols, nb),
         "mindeg"),
        ("simplicial analysis (mindeg)",
         lambda: sc.analyze(rows, cols, nb, 8, "mindeg"), "chol_symbolic"),
        ("supernodal analysis (rcm, amalgamate 16)",
         lambda: sn.analyze(rows, cols, nb, 8, "rcm", amalgamate=16).inner,
         "chol_symbolic"))
    parts = []
    for what, fn, counter in jobs:
        before = nsym.native_calls[counter]
        t0 = time.perf_counter()
        nat = fn()
        t_nat = time.perf_counter() - t0
        check(nsym.native_calls[counter] > before,
              f"{width}x{width}x8 {what}: the host library ran")
        with python_analysis():
            t0 = time.perf_counter()
            py = fn()
            t_py = time.perf_counter() - t0
        if what == "block pattern":
            same(nat.indptr, s.indptr, "block pattern indptr")
            same(nat.indices, s.indices, "block pattern indices")
            nat, py = (nat.indptr, nat.indices), (py.indptr, py.indices)
            for a, b in zip(nat, py):
                same(a, b, what)
        else:
            same(nat, py, what)
        parts.append(f"{what} native {t_nat:.4f} s, Python {t_py:.4f} s")
    return "; ".join(parts)


def phase22_sparse_batched(dev, bench, card, host_build) -> dict:
    """The native symbolic analysis, batched block-sparse solves (K3, K6
    and K7 over a batch) and config 6b at full width. Returns the launch
    counts of K3, K6 and K7 on this phase's paths and K3's readings at
    their shapes."""
    import dataclasses

    import torch

    from libdogleg_tpu_torch import (SparseNewtonSolver, SparseProblem,
                                     optimize, solve_products)
    from libdogleg_tpu_torch.models import grid_mrf
    from libdogleg_tpu_torch.native import symbolic as nsym
    from libdogleg_tpu_torch.ops import bcsr
    from libdogleg_tpu_torch.ops import bcsr_kernels as tk
    from libdogleg_tpu_torch.ops import tilechol
    from libdogleg_tpu_torch.parallel import batched_optimize
    from libdogleg_tpu_torch.utils.benchtime import measure_ms

    def counts():
        return {"K3": tk.launch_counts["bcsr_jtj_blocks_kernel"],
                "K6": tilechol.launch_counts["tile_cholesky"],
                "K7": tilechol.launch_counts["tri_solve_right"]}

    def zero_counts():
        tk.launch_counts["bcsr_jtj_blocks_kernel"] = 0
        for k in tilechol.launch_counts:
            tilechol.launch_counts[k] = 0

    def since(before):
        now = counts()
        return {k: now[k] - before[k] for k in now}

    out = {"paths": {}}
    print(f"[22 host build] {host_build.path.name} in "
          f"{host_build.seconds:.2f} s (g++ -O3 -shared -fPIC -std=c++17, "
          f"0.00 when an existing build of the same sources was found)",
          flush=True)
    for width in (32, 64):
        t0 = time.perf_counter()
        text = analysis_native_vs_python(width)
        print(f"[22 analysis {width}x{width}x8] the same arrays from the "
              f"host library and the Python forms: {text}; "
              f"{time.perf_counter() - t0:.1f} s", flush=True)

    # the float64 batched solve, card against CPU; a small first trust
    # region, so that the linear problem takes Cauchy, interpolated and
    # Gauss-Newton steps
    t_leg = time.perf_counter()
    small_tr = dataclasses.replace(bench, trustregion0=0.5)
    decisions = ("step_count", "n_attempts", "reason", "lam")
    for amalgamate in (1, 4):
        runs = []
        for device in (dev, torch.device("cpu")):
            g, data = grid_batch_data(8, 4, 4, torch.float64, device)
            sched = bcsr.jtj_lower_schedule(g.structure)
            products, _ = grid_batch(g, sched)
            ns = SparseNewtonSolver.analyze(sched.rows, sched.cols,
                                            g.structure.nbcol, 4,
                                            amalgamate=amalgamate)
            before = counts()
            runs.append(batched_optimize(
                products, torch.zeros(4, g.nstate, dtype=torch.float64,
                                      device=device), small_tr,
                problem_data=data, newton_solver=ns, record_history=True))
            launched = since(before)
            on_card = device.type == "cuda"
            check(all(v > 0 if on_card else v == 0
                      for v in launched.values()),
                  f"f64 batch on {device}: K3, K6, K7 launched on the card "
                  f"only: {launched}")
        r_d, r_c = runs
        for field in decisions:
            check(torch.equal(getattr(r_d, field).cpu(), getattr(r_c, field)),
                  f"sparse batch f64 card vs CPU {field} identical")
        check(torch.equal(r_d.history.step_type.cpu(), r_c.history.step_type),
              "sparse batch f64 card vs CPU History step types identical")
        dp = float((r_d.p.cpu() - r_c.p).abs().max())
        check(torch.allclose(r_d.p.cpu(), r_c.p, rtol=1e-9, atol=1e-9),
              f"sparse batch f64 card vs CPU p within 1e-9: {dp:.3e}")
        check(bool((r_c.reason > 0).all()), "sparse batch f64 terminated")
        print(f"[22 sparse batch f64 B=4 8x8 grids b 4 "
              f"{'simplicial' if amalgamate == 1 else 'amalgamate 4'}] card "
              f"(K3, K6, K7) vs CPU (plain versions): step_count, "
              f"n_attempts, reason, lambda and History step types identical "
              f"(attempts {r_c.n_attempts.tolist()}, reasons "
              f"{r_c.reason.tolist()}); max |dp| {dp:.3e} (1e-9)",
              flush=True)
    print(f"[22 sparse batch f64 seconds] {time.perf_counter() - t_leg:.1f}",
          flush=True)

    # config 6b at full width, supernodal then the model's default
    t_leg = time.perf_counter()
    g = grid_mrf.make_grid_mrf(*GRID_6B, dtype=torch.float32, device=dev)
    g64 = grid_mrf.make_grid_mrf(*GRID_6B, dtype=torch.float64, device=dev)
    before_nat = dict(nsym.native_calls)
    t0 = time.perf_counter()
    prob = SparseProblem(f=g.problem(jtj="dense").f, structure=g.structure,
                         jtj="sparse", ordering="rcm", amalgamate=16)
    t_sup = time.perf_counter() - t0
    t0 = time.perf_counter()
    simple = g.problem()
    t_simple = time.perf_counter() - t0
    check(all(nsym.native_calls[k] > before_nat[k]
              for k in ("jtj_schedule", "chol_symbolic", "mindeg")),
          f"config 6b: the native analysis ran: {nsym.native_calls}")
    sym = prob.default_newton_solver().symbolic
    simple_sym = simple.default_newton_solver().symbolic
    check(sym.inner.sched.nlevels == 45 and sym.inner.nslots == 1691,
          f"config 6b supernodal analysis: {sym.inner.sched.nlevels} levels,"
          f" {sym.inner.nslots} slots")
    print(f"[22 config 6b analysis] native: supernodal (rcm, amalgamate 16) "
          f"{t_sup:.3f} s, {sym.inner.sched.nlevels} levels, "
          f"{sym.inner.nslots} slots of {sym.sb}x{sym.sb}; simplicial "
          f"(mindeg) {t_simple:.3f} s, {simple_sym.sched.nlevels} levels, "
          f"{simple_sym.nslots} slots of 8x8", flush=True)

    p0 = torch.zeros(g.nstate, dtype=torch.float32, device=dev)
    zero_counts()
    t0 = time.perf_counter()
    r = optimize(prob, p0, bench)
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    launched = counts()
    out["paths"]["config 6b supernodal"] = launched
    check(all(launched.values()), f"config 6b: K3, K6, K7 launched: "
          f"{launched}")
    r64 = optimize(with_residual(prob, g64),
                   torch.zeros(g.nstate, dtype=torch.float64, device=dev))
    jtx = float(r.Jt_x.abs().max())
    dp = float((r.p.double() - r64.p).abs().max())
    check(int(r.reason) > 0 and bool(torch.isfinite(r.p).all()),
          f"config 6b f32: reason {int(r.reason)}, finite p")
    check(dp <= 1e-3, f"config 6b f32 p within 1e-3 of f64: {dp:.3e}")
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        optimize(prob, p0, bench)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    ev_ms = measure_ms(lambda: float(optimize(prob, p0, bench).norm2_x),
                       warmup=0, reps=3)
    print(f"[22 grid-mrf-64x64x8-supernodal-f32 PRM] reason {int(r.reason)}"
          f" step_count {int(r.step_count)} n_attempts {int(r.n_attempts)}; "
          f"max|Jt_x| {jtx:.3e}; max |p32 - p64| {dp:.3e} (<= 1e-3, f64 "
          f"solve on the card); launches K3 {launched['K3']}, K6 "
          f"{launched['K6']}, K7 {launched['K7']}; first call {first:.2f} s; "
          f"host wall ms {', '.join(f'{w:.1f}' for w in walls)}; CUDA events "
          f"{ev_ms:.1f} ms a solve with a dependent fetch; card {card}",
          flush=True)
    print(f"[22 grid-mrf-64x64x8-supernodal-f32 profile] "
          f"{device_split(lambda: optimize(prob, p0, bench), groups=K3_GROUPS)}",
          flush=True)
    zero_counts()
    t0 = time.perf_counter()
    rs = optimize(simple, p0, bench)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launched = counts()
    out["paths"]["config 6b simplicial"] = launched
    jtx_s = float(rs.Jt_x.abs().max())
    dps = float((rs.p.double() - r64.p).abs().max())
    check(int(rs.reason) > 0 and bool(torch.isfinite(rs.p).all())
          and dps <= 1e-3,
          f"config 6b simplicial f32: reason {int(rs.reason)}, p within "
          f"1e-3 of f64: {dps:.3e}")
    print(f"[22 grid-mrf-64x64x8-simplicial-f32 PRM] the model's default "
          f"problem (mindeg, {simple_sym.sched.nlevels} levels): reason "
          f"{int(rs.reason)} n_attempts {int(rs.n_attempts)}; max|Jt_x| "
          f"{jtx_s:.3e}; max |p32 - p64| {dps:.3e}; launches {launched}; "
          f"wall {wall_s * 1e3:.1f} ms (one call); card {card}", flush=True)

    # K3 at config 6b's shape: against its plain version, in turns
    k3 = {}
    J6 = bcsr.BCSRJacobian(g.structure, prob.f(p0)[1])
    k3["6b"] = k3_readings("config 6b", J6, prob._jtj_sched, card)
    del prob, simple, r, r64, rs, J6
    print(f"[22 config 6b seconds] {time.perf_counter() - t_leg:.1f}",
          flush=True)

    # the batch of 16 config-6 grids, dense coupling
    t_leg = time.perf_counter()
    B = SPARSE_B
    g, data = grid_batch_data(32, 8, B, torch.float32, dev)
    sched = bcsr.jtj_lower_schedule(g.structure)
    products, values = grid_batch(g, sched)
    ns = SparseNewtonSolver.analyze(sched.rows, sched.cols,
                                    g.structure.nbcol, 8, "rcm",
                                    amalgamate=16)
    P0 = torch.zeros(B, g.nstate, dtype=torch.float32, device=dev)

    def solve():
        return batched_optimize(products, P0, bench, problem_data=data,
                                newton_solver=ns)

    def single(i):
        return solve_products(
            lambda p: products(p, tuple(d[i] for d in data)), P0[i], bench,
            newton_solver=ns)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    rb = solve()
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    per_batch = counts()
    peak = torch.cuda.max_memory_allocated()
    out["paths"][f"B{B} batch"] = per_batch
    check(bool((rb.reason > 0).all()) and bool(torch.isfinite(
        rb.norm2_x).all()), f"B{B}: every reason > 0 and norm2_x finite")
    wavefronts = int(rb.n_attempts.max())
    g64, data64 = grid_batch_data(32, 8, 4, torch.float64, dev)
    products64, _ = grid_batch(g64, sched)
    dps = []
    for i in range(4):
        ri = solve_products(
            lambda p: products64(p, tuple(d[i] for d in data64)),
            torch.zeros(g.nstate, dtype=torch.float64, device=dev), bench,
            newton_solver=ns)
        dps.append(float((rb.p[i].double() - ri.p).abs().max()))
    check(max(dps) <= 1e-3, f"B{B}: elements 0-3 within 1e-3 of their f64 "
          f"single solves: {dps}")
    zero_counts()
    singles = [single(i) for i in range(B)]
    torch.cuda.synchronize()
    per_singles = counts()
    for i, ri in enumerate(singles):
        for field in ("step_count", "n_attempts", "reason"):
            check(int(getattr(ri, field)) == int(getattr(rb, field)[i]),
                  f"B{B} element {i}: {field} of its single solve")
    del singles
    rb2 = solve()
    same = same_bits(rb2.p, rb.p)
    turns = []
    for _ in range(2):
        turns.append((
            measure_ms(lambda: float(solve().norm2_x.sum()), warmup=0,
                       reps=2),
            measure_ms(lambda: sum(float(single(i).norm2_x)
                                   for i in range(B)), warmup=0, reps=1)))
    syncs, _ = host_syncs(solve)
    events = sum(ev.count for ev in device_events(solve, (), reps=1))
    # one factorization of the batch against one of a single element,
    # counted by the wrappers and read by kernel name from a trace
    blocks = torch.func.vmap(products)(P0, data).JtJ
    be = ns._backend()
    fac = {}
    for label, args in (("batch", (ns.symbolic, blocks, torch.zeros(
            B, dtype=torch.float32, device=dev))),
            ("single", (ns.symbolic, blocks[0], 0.0))):
        before = counts()
        be.factorize(*args)
        by_wrapper = since(before)
        traced = device_events(be.factorize, args, reps=1)
        by_name = {k: sum(ev.count for ev in traced if sub in ev.key.lower())
                   for k, sub in (("K6", "tilechol"), ("K7", "trisolve"))}
        fac[label] = (by_wrapper, by_name)
    check(fac["batch"][0]["K6"] == fac["single"][0]["K6"] > 0
          and fac["batch"][0]["K7"] == fac["single"][0]["K7"] > 0,
          f"a factorization of the batch launches K6 and K7 as often as a "
          f"single one: {fac}")
    lams, lcounts = torch.unique(rb.lam.cpu(), return_counts=True)
    hist = ", ".join(f"{float(v):g}: {int(c)}" for v, c in zip(lams, lcounts))
    b_ms = min(t[0] for t in turns)
    s_ms = min(t[1] for t in turns)
    sync_text = ("not measured (no sync warnings)" if syncs is None else
                 f"{syncs} ({syncs / wavefronts:.1f} a wavefront)")
    event_text = ("not measured (the profiler returned no events)"
                  if not events else
                  f"{events} ({events / wavefronts:.0f} a wavefront)")
    print(f"[22 grid-mrf-32x32x8-sparse-batched-B{B}-f32 PRM] every reason "
          f"> 0 ({rb.reason.tolist()}), norm2_x finite; elements 0-3 "
          f"within {max(dps):.3e} of their f64 single solves (<= 1e-3); "
          f"each element the decisions of its f32 single solve; "
          f"{wavefronts} wavefronts, {attempts_text(rb.n_attempts)}; "
          f"lambda histogram {{{hist}}}; first call {first:.2f} s; CUDA "
          f"events with a dependent fetch, in turns: the batch "
          f"{turns[0][0]:.1f} / {turns[1][0]:.1f} ms ({B / b_ms * 1e3:.1f} "
          f"solves/s), {B} single solves {turns[0][1]:.1f} / "
          f"{turns[1][1]:.1f} ms ({B / s_ms * 1e3:.1f} solves/s), "
          f"{s_ms / b_ms:.2f}x; launches a batch {per_batch} against "
          f"{per_singles} for the {B} singles; device events {event_text}; "
          f"host synchronizations {sync_text}; max_memory_allocated "
          f"{peak / 2 ** 30:.2f} GiB; two runs "
          f"{'the same bits' if same else 'NOT the same bits'}; card {card}",
          flush=True)
    print(f"[22 B{B} one factorization] K6/K7 launches, by wrapper count and"
          f" by kernel name in a trace: the batch {fac['batch'][0]} / "
          f"{fac['batch'][1]}, a single element {fac['single'][0]} / "
          f"{fac['single'][1]}", flush=True)
    print(f"[22 B{B} profile] {device_split(solve, groups=K3_GROUPS)}; "
          f"{wavefronts} wavefronts", flush=True)
    Jb = bcsr.BCSRJacobian(g.structure, values(data[2]))
    k3[f"B{B}"] = k3_readings(f"B{B}", Jb, sched, card)
    inner = ns.symbolic.inner
    tiles_at_batch(
        B * int(np.diff(inner.sched.fac_off).max()),
        B * int(np.diff(inner.sched.sol_off).max()), inner.b, card)
    print(f"[22 B{B} seconds] {time.perf_counter() - t_leg:.1f}", flush=True)
    out["K3"] = k3
    return out


def tiles_at_batch(kf, ks, n, card) -> None:
    """K6 on kf and K7 on ks (n, n) tiles, the widest FACTOR and SOLVE
    levels of the batch's factorization, each in turns with the one
    PyTorch call that computes the same, against its plain version and
    alone."""
    import torch

    from libdogleg_tpu_torch.ops import tilechol
    from libdogleg_tpu_torch.utils.benchtime import measure_ms
    dev = torch.device("cuda")
    S = spd_tiles(n, kf, n + kf, torch.float32, dev)
    Sd = spd_tiles(n, ks, n + ks, torch.float32, dev)
    D = tilechol.tile_cholesky_reference(Sd)[0]
    C = torch.as_tensor(np.random.default_rng(ks).normal(size=(ks, n, n)),
                        dtype=torch.float32, device=dev)
    for key, fn, ref, lib, args, limit in (
            ("K6", tilechol.tile_cholesky, tilechol.tile_cholesky_reference,
             torch.linalg.cholesky_ex, (S,),
             bound(lower_nbytes(S) + nbytes_of(S) + kf, kf * n ** 3 / 3)),
            ("K7", tilechol.tri_solve_right,
             tilechol.tri_solve_right_reference,
             lambda Dm, Cm: torch.linalg.solve_triangular(
                 Dm.mT, Cm, upper=True, left=False), (D, C),
             bound(lower_nbytes(D) + 2 * nbytes_of(C),
                   float(ks) * n * n * n))):
        got, want = fn(*args), ref(*args)
        got, want = (got[0], want[0]) if key == "K6" else (got, want)
        err = float((got - want).abs().max() / want.abs().max())
        check(err <= 2e-4, f"{key} at {tuple(args[0].shape)} within 2e-4 "
              f"of its plain version: {err:.3e}")
        turns = [(measure_ms(fn, *args, warmup=3, reps=20),
                  measure_ms(lib, *args, warmup=3, reps=20))
                 for _ in range(2)]
        plain = measure_ms(ref, *args, warmup=3, reps=20)
        alone = kernel_us(fn, args, "tilechol" if key == "K6" else
                          "trisolve")
        print(f"[22 {key} {tuple(args[0].shape)} f32, the batch's widest "
              f"level] max error {err:.3e} of the largest entry; kernel with "
              f"its wrapper {turns[0][0]:.4f} / {turns[1][0]:.4f} ms, "
              f"library call {turns[0][1]:.4f} / {turns[1][1]:.4f} ms (two "
              f"turns, CUDA events over 20 calls), plain version "
              f"{plain:.4f} ms; the kernel alone {us_text(alone)}; bound "
              f"{limit['bound_ms'] * 1e3:.2f} us by {limit['bound_by']}; "
              f"card {card}", flush=True)


def k3_readings(label, J, sched, card) -> dict:
    """K3 on J's values (a batch or one Jacobian) against its plain version
    (ops/bcsr.jtj_pair_sum, the index_add form) and in turns with it, the
    kernel alone and its bound at this shape."""
    import torch

    from libdogleg_tpu_torch.ops import bcsr
    from libdogleg_tpu_torch.ops import bcsr_kernels as tk
    from libdogleg_tpu_torch.utils.benchtime import measure_ms
    v = J.values
    nout = len(sched.rows)
    # the plain version's indices on the card once, as the path keeps them
    pi, pj, oi = (torch.as_tensor(np.asarray(a, np.int64), device=v.device)
                  for a in (sched.pair_i, sched.pair_j, sched.out_idx))

    def kernel():
        return tk.bcsr_jtj_lower_kernel(J, sched)

    def plain():
        return bcsr.jtj_pair_sum(v, pi, pj, oi, nout)
    got, want = kernel(), plain()
    err = float((got - want).abs().max() / want.abs().max())
    check(err <= 1e-4, f"K3 {label} within 1e-4 of the largest entry of its "
          f"plain version: {err:.3e}")
    turns = [(measure_ms(kernel, warmup=3, reps=20),
              measure_ms(plain, warmup=3, reps=20)) for _ in range(2)]
    alone = kernel_us(kernel, (), "jtj_")
    batch = v.shape[0] if v.dim() == 4 else 1
    bm, bn = v.shape[-2], v.shape[-1]
    limit = bound(nbytes_of(v, got),
                  2.0 * batch * len(sched.pair_i) * bm * bn * bn)
    print(f"[22 K3 {label} {tuple(v.shape)} -> {tuple(got.shape)} f32] "
          f"max error {err:.3e} of the largest entry (1e-4); the kernel with "
          f"its wrapper {turns[0][0]:.4f} / {turns[1][0]:.4f} ms, the "
          f"index_add form {turns[0][1]:.4f} / {turns[1][1]:.4f} ms (two "
          f"turns, CUDA events over 20 calls); the kernel alone "
          f"{us_text(alone)}; bound {limit['bound_ms'] * 1e3:.2f} us by "
          f"{limit['bound_by']}; card {card}", flush=True)
    return dict(ms=turns[0][0], plain_ms=turns[0][1], max_abs_err=err,
                alone_us=alone, **limit)


def ptxas_k1(log: str) -> list:
    """ptxas's registers and spills of each K1 solve kernel in an nvcc log,
    one short line each."""
    import re
    out, name, spill = [], None, ""
    for line in log.splitlines():
        m = re.search(r"entry function '.*?(dogleg_mega(?:_factored)?_kernel)"
                      r"I([fd])Li(\d+)E", line)
        if "entry function" in line:
            name = (f"{m.group(1)}<{'float' if m.group(2) == 'f' else 'double'}"
                    f", G={m.group(3)}>" if m else None)
        elif name and "spill" in line:
            spill = line.strip()
        elif name and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            out.append(f"{name}: {regs} registers; {spill}")
            name = None
    return out


def attempts_text(n_attempts) -> str:
    """Mean, 99th percentile and largest of the attempts a problem took."""
    a = n_attempts.double()
    return (f"attempts a problem mean {a.mean().item():.2f}, p99 "
            f"{a.quantile(0.99).item():.0f}, max {int(a.max().item())}")


def public_call_walls(p0, meas, bench) -> str:
    """The host wall of the public call batched_optimize(quadratic_surface.
    products, ...): single calls, each ended by a synchronize; a loop of 50
    calls ended by one synchronize (the enqueue and the whole); and whether
    a call waits for the card (torch.cuda's sync debug mode set to raise).
    Fails if it does."""
    import torch

    from libdogleg_tpu_torch.models import quadratic_surface as qs
    from libdogleg_tpu_torch.parallel import batched_optimize

    def call():
        return batched_optimize(qs.products, p0, bench, problem_data=meas)
    single = []
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        single.append((time.perf_counter() - t0) * 1e3)
    loop = 50
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(loop):
        call()
    enqueued = time.perf_counter() - t0
    torch.cuda.synchronize()
    whole = time.perf_counter() - t0
    torch.cuda.set_sync_debug_mode("error")
    try:
        call()
        waits = None
    except RuntimeError as e:
        waits = str(e).splitlines()[0][:160]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    check(waits is None, f"the public call does not wait for the card: "
          f"{waits}")
    return (f"host wall of single calls ms "
            f"{', '.join(f'{w:.3f}' for w in single)}; a loop of {loop} "
            f"calls ended by one synchronize: {enqueued / loop * 1e3:.4f} ms a "
            f"call to enqueue, {whole / loop * 1e3:.4f} ms a call in all; the "
            f"call does not wait for the card (sync debug mode)")


def ragged_f64_decisions(dev, factored: bool) -> str:
    """K1's instance against its twin in float64 at F64_BATCHES: identical
    decisions, p within rtol 1e-9. Returns a line's text."""
    import torch

    from libdogleg_tpu_torch.ops import mega
    fn, twin = ((mega.megakernel_optimize_factored,
                 mega.megakernel_optimize_factored_reference) if factored
                else (mega.megakernel_optimize,
                      mega.megakernel_optimize_reference))
    worst = 0.0
    for i, batch in enumerate(F64_BATCHES):
        args = (factored_args(20 + i, batch, torch.float64, dev)[0]
                if factored else instances(20 + i, batch, torch.float64, dev))
        r_k, r_t = fn(*args), twin(*args)
        torch.cuda.synchronize()
        for field in ("step_count", "n_attempts", "reason"):
            check(torch.equal(getattr(r_k, field), getattr(r_t, field)),
                  f"f64 B={batch} {field} identical")
        check(torch.allclose(r_k.p, r_t.p, rtol=1e-9, atol=1e-12),
              f"f64 B={batch} p within rtol 1e-9")
        check(torch.allclose(r_k.JtJ, r_t.JtJ, rtol=1e-9, atol=0.0),
              f"f64 B={batch} JtJ within rtol 1e-9")
        worst = max(worst, (r_k.p - r_t.p).abs().max().item())
    return (f"decisions identical to the twin's at B = "
            f"{', '.join(map(str, F64_BATCHES))}; max |dp| {worst:.3e}")


def main() -> int:
    started = time.perf_counter()
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
    from libdogleg_tpu_torch.ops import bcsr_kernels, mega
    from libdogleg_tpu_torch.parallel import batched_optimize
    from libdogleg_tpu_torch.utils.benchtime import measure_ms

    dev = torch.device("cuda")
    bench = DoglegParameters(**BENCH)

    # 2. build; the host library of the symbolic analysis beside it, which
    # phase 22 reports
    info = loader.build()
    loader.load_library()
    host_build = loader.build_host()
    print(f"[2 build] {info.path.name} in {info.seconds:.2f} s", flush=True)
    for line in info.log.splitlines():
        if ("registers" in line or "spill" in line
                or "entry function" in line):
            print(f"[2 ptxas] {line.strip()}", flush=True)
    general_g = mega.kernel_group()
    print(f"[2 K1] the library's lanes per problem: general G={general_g}, "
          f"factored G={mega.kernel_group(factored=True)}; "
          f"{'; '.join(ptxas_k1(info.log))}", flush=True)

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
    print(f"[3 f64] {ragged_f64_decisions(dev, factored=False)}", flush=True)
    # the device products against the grouped order of summation
    for dtype, rtol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        p0_, meas_, gx_, gy_ = instances(3, BATCH, dtype, dev)
        near = torch.as_tensor(qs.P_TRUE, dtype=dtype, device=dev) + 1e-2 * p0_
        for where, p in (("the starts", p0_), ("near the truth", near)):
            got = mega.products_device(p, meas_, gx_, gy_)
            want = mega.grouped_products_reference(p, meas_, gx_, gy_,
                                                   general_g)
            worst = []
            for label, g, w, m in zip(
                    ("norm2", "Jt_x", "JtJ"), got, want,
                    mega.products_magnitude(p, meas_, gx_, gy_)):
                worst.append(float(((g - w).abs() / m).max()))
                check(worst[-1] <= rtol,
                      f"general products {dtype} {label} at {where} within "
                      f"rtol {rtol} of products_magnitude: {worst[-1]:.3e}")
            print(f"[3 products {str(dtype).split('.')[-1]} B={BATCH} at "
                  f"{where}] the device function against "
                  f"grouped_products_reference (G={general_g}): largest "
                  f"difference over products_magnitude (rtol {rtol}): norm2 "
                  f"{worst[0]:.2e}, Jt_x {worst[1]:.2e}, JtJ {worst[2]:.2e}",
                  flush=True)

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
    print(f"[4 public call B={BATCH} f32] {public_call_walls(p0, meas, bench)}"
          f"; card {card}", flush=True)

    # 5. the single-solve CLI on the card
    for mode in sample.MODES:
        t0 = time.perf_counter()
        rc = sample.main(["--check", "--device", "cuda", mode])
        check(rc == 0, f"sample --check --device cuda {mode}")
        print(f"[5 sample {mode}] rc 0 in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
    # the diagnostic streams: the vnlog table and the gradient check, their
    # standard output kept and counted
    for argv, first in ((["--diag", "vnlog", "dense"], "# iteration "),
                        (["--test-gradients", "dense"], "# ivar ")):
        t0 = time.perf_counter()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = sample.main(["--device", "cuda"] + argv)
        lines = out.getvalue().splitlines()
        check(rc == 0 and lines and lines[0].startswith(first),
              f"sample --device cuda {' '.join(argv)}: rc {rc}")
        print(f"[5 sample {' '.join(argv)}] rc 0 in "
              f"{time.perf_counter() - t0:.2f} s; {len(lines)} lines on "
              f"stdout, the first {lines[0][:40]!r}", flush=True)

    # 6. timing at the main path's shapes
    ms = measure_ms(mega.megakernel_optimize, *args32, bench, warmup=3,
                    reps=20)
    plain_ms = measure_ms(mega.megakernel_optimize_reference, *args32,
                          bench, warmup=1, reps=5)
    # K1's bound, from what this run's data needed: p0, meas and the grid
    # in, the nine result fields out; one products evaluation at the start
    # and one per attempt (16 operations a measurement for the residual, 11
    # for the Jacobian, 2 for norm2, 12 for Jt_x, 42 for the 21 entries of
    # the symmetric JtJ's lower triangle: 83), and per attempt the step math
    # (Cholesky n^3/3, two substitutions and two quadratic forms 6 n^2,
    # about 10 n besides)
    r_b = mega.megakernel_optimize(*args32, bench)
    n = qs.NSTATE
    evals = float((r_b.n_attempts + 1).sum())
    k1_bound = bound(
        nbytes_of(*args32) + nbytes_of(*(t for t in r_b if t is not None)),
        evals * qs.NMEAS * 83
        + float(r_b.n_attempts.sum()) * (n ** 3 / 3 + 6 * n * n + 10 * n))
    print(f"[6 timing B={BATCH} f32] K1 {ms:.4f} ms "
          f"({BATCH / ms * 1e3:.0f} solves/s); twin {plain_ms:.4f} ms "
          f"({BATCH / plain_ms * 1e3:.0f} solves/s); bound "
          f"{k1_bound['bound_ms'] * 1e3:.2f} us by {k1_bound['bound_by']} "
          f"({evals / BATCH:.2f} products evaluations a problem); "
          f"{attempts_text(r_b.n_attempts)}; card {card}", flush=True)

    print(f"[1-6 seconds] {time.perf_counter() - started:.1f}", flush=True)

    def timed(label, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        print(f"[{label} seconds] {time.perf_counter() - t0:.1f}",
              flush=True)
        return out
    k2 = timed("7", phase7_panel, dev)
    k2.update(timed("8", phase8_slice, dev, bench))
    k34 = timed("9", phase9_bcsr, dev)
    dense_walls = timed("10", phase10_timing, dev, bench, card, k2, k34)
    tiles = timed("11", phase11_tiles, dev)
    sparse = timed("12", phase12_sparse, dev, bench)
    # phase 9's launches test the opt-in entry and are no path's
    paths = {"phase 12 (config 6)": {
                 "K3": sparse["launches"]["bcsr_jtj_blocks_kernel"],
                 "K6": sparse["launches"]["tile_cholesky"],
                 "K7": sparse["launches"]["tri_solve_right"]}}
    tiles["K6"]["launches"] = sparse["launches"]["tile_cholesky"]
    tiles["K7"]["launches"] = sparse["launches"]["tri_solve_right"]
    timed("13", phase13_timing, dev, bench, card, sparse, tiles, dense_walls)
    del sparse
    timed("14", phase14_batchchol, dev)
    mid = timed("15", phase15_midsize, dev, bench)
    # K5's error is taken in phase 16, on the JtJ the main path gives it
    k5 = {"launches": mid["launches"], "max_abs_err": 0.0}
    timed("16", phase16_timing, dev, bench, card, mid, k5)
    k1f = timed("17", phase17_factored, dev, bench)
    ba7s, r7s = timed("18", phase18_ba, dev, bench)
    timed("19", phase19_analysis, dev, card, ba7s, r7s)
    del ba7s, r7s
    timed("20", phase20_batched_schur, dev, bench, card)
    timed("21", phase21_surface, dev, bench, card)
    p22 = timed("22", phase22_sparse_batched, dev, bench, card, host_build)
    print(f"[all seconds] {time.perf_counter() - started:.1f}", flush=True)
    paths.update({f"phase 22 ({k})": v for k, v in p22["paths"].items()})
    # K3, K6 and K7 run on several paths: each path's count, read with the
    # counts set to 0 just before it, and their sum
    for key, d in (("K3", k34["K3"]), ("K6", tiles["K6"]),
                   ("K7", tiles["K7"])):
        d["launches_by_path"] = {path: c[key] for path, c in paths.items()
                                 if key in c}
        d["launches"] = sum(d["launches_by_path"].values())

    def entry(name, source, replaces, d):
        out = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "launches": d["launches"],
               "max_abs_err": d["max_abs_err"], "ms": d["ms"],
               "plain_ms": d["plain_ms"], "bound_ms": d["bound_ms"],
               "bound_by": d["bound_by"], "library_ms": d["library_ms"]}
        if "launches_by_path" in d:
            out["launches_by_path"] = d["launches_by_path"]
        return out
    print(json.dumps({"kernels": [
        entry("megakernel_optimize", "libdogleg_tpu_torch/csrc/mega.cu",
              "libdogleg_tpu/ops/pallas_mega.py:522",
              dict(launches=launches, max_abs_err=max_abs_err, ms=ms,
                   plain_ms=plain_ms, library_ms=None, **k1_bound)),
        entry("megakernel_optimize_factored",
              "libdogleg_tpu_torch/csrc/mega.cu",
              "libdogleg_tpu/ops/pallas_mega.py:522", k1f),
        entry("panel_factor", "libdogleg_tpu_torch/csrc/panelchol.cu",
              "libdogleg_tpu/ops/pallas_panelchol.py:157", k2),
        entry("bcsr_jtj_blocks_kernel", "libdogleg_tpu_torch/csrc/bcsr.cu",
              "libdogleg_tpu/ops/pallas_bcsr.py:117", k34["K3"]),
        entry("bcsr_matvec_kernel", "libdogleg_tpu_torch/csrc/bcsr.cu",
              "libdogleg_tpu/ops/pallas_bcsr.py:212", k34["K4"]),
        entry("batched_blocked_cholesky",
              "libdogleg_tpu_torch/csrc/batchchol.cu",
              "libdogleg_tpu/ops/pallas_blockchol.py:150", k5),
        entry("tile_cholesky", "libdogleg_tpu_torch/csrc/tilechol.cu",
              "libdogleg_tpu/ops/pallas_chol.py:62", tiles["K6"]),
        entry("tri_solve_right", "libdogleg_tpu_torch/csrc/tilechol.cu",
              "libdogleg_tpu/ops/pallas_chol.py:113", tiles["K7"])]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
