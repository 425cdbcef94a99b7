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
     once in float32; the dense JtJ (ops/bcsr.bcsr_jtj_dense, its pair
     products summed in a fixed order by the segment add) the same bits
     twice and within rounding of its index_put_ form, two dense solves
     the same bits, both forms in turns, alone and in the solve;
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
     lambda histogram, peak memory, two runs the same bits (a check, as
     for config 6b's later solves: the sums in a fixed order of
     ops/segsum.py), a profiler split; both solves with the sums in each
     form in turns (sums_as: index_add_, the form before; plain,
     segsum.reference on the card; kernel, the segment-add kernel
     csrc/segsum.cu as shipped), plain and kernel the same bits twice
     and each other's; 6b simplicial's first and second call after its
     analysis, the time to build its level plans and a profiler split of
     its solve; the segment-add kernel at the batch's widest UPDATE level,
     its forward level with the most terms on one row, and 6b
     simplicial's forward and backward levels with the longest run (B 1),
     against its plain version (the same bits), alone, and in turns with
     it and index_add_, beside its bound; K3 at both runs' shapes against its
     plain version
     (the index_add form) and in turns with it; K6 and K7 at the batch's
     widest FACTOR and SOLVE levels (16 x k tiles of 128 x 128) against
     their plain versions and in turns with cholesky_ex and
     solve_triangular;
 23. megakernel auto-promotion (parallel/mega_auto.py), K1 on functors
     generated from ordinary products functions: the named instances'
     SHA-256 digests (every field, f32 B=8192 and f64 B=1024) against the
     parent's, K1_DIGESTS; config 3 (bench_all.py:156-184's closure over
     the grid, B=10000), config 2's curve fit (Nstate 3, B=4096) and config
     8's tanh family at Nstate 16 (nmeas 64, B=1024) planned, each in the
     row form (its G and rows printed), their sources built together with
     config 3's array form and row form at G=1 (nvcc seconds, ptxas
     registers, stack frame and spills of each); the row form at G=1
     giving the array form's bits (every field of config 3's solve);
     config 3 through batched_optimize_compacted launching K1-auto once
     and the masked driver never, recovered_frac >= 0.99, step-count
     agreement >= 0.85 with the masked driver; configs 2 and 8 the same
     way through batched_optimize; in float64 at B=1024 each generated
     kernel's decisions its plain version's on the CPU (p within 1e-10;
     the elements where the plain version run on the card decides
     otherwise printed) and its functor alone within 1e-12 of the graph on
     the CPU; config 3's public
     call with and without promotion in turns (CUDA events, a dependent
     fetch) with the traces it made (the plan cache: none), a cached
     plan's host ms, K1-auto with its wrapper and alone (profiler) in
     turns with the array form and the named general instance on the
     same problems, its plain version, and its bound;
 24. ahead-of-time export (libdogleg_tpu_torch/export.py): three artifacts
     exported on the card in float32 under PRM, each saved, loaded and run
     in a fresh Python process that imports libdogleg_tpu_torch.export and
     no problem module, its result held against the live eager run in this
     one: (a) the sample problem's serving configuration (one measurement
     set, 8192 distinct starts; every reason > 0, recovered_frac >= 0.99,
     the artifact's bits those of the traced loop run eagerly); (b) config
     6's supernodal grid MRF at full width (32x32x8, rcm/amalgamate 16, a
     single solve from 0; K3, K6 and K7 inside the artifact, their
     launches those of the live traced loop; reason > 0, max|Jt_x| <=
     1e-3, p within 1e-3 of float64), and its float64 artifact at
     16x16x8 taking the eager solve's decisions; (c) config 8's tanh
     family at Nstate 64, one instance shared by 512 starts, with
     BlockedDenseNewtonSolver (K5 inside; recovered_frac >= 0.99). Each
     prints the trace's seconds, the artifact's bytes, the fresh process's
     load seconds, the artifact's call and the live eager call in turns
     (CUDA events, a dependent fetch) and the kernels' launches inside;
     the fresh process's decisions and p this process's, bit for bit;
 25. the parallel layer (parallel/mesh.py, parallel/sharded.py, mesh= in
     the batched entry points, checkpoint.save_state_orbax on
     torch.distributed.checkpoint): (a) a world of one on NCCL
     (make_mesh(("dp",))), config 3 at B=10000 through
     batched_optimize(mesh=) on quadratic_surface.products (K1 named) and
     on config 3's closure (K1 generated), and batched_optimize_compacted
     (mesh=), each result field the unsharded call's bits, p a DTensor
     with Shard(0), one K1 launch a call, the walls with and without the
     mesh in turns; (b) two ranks on the one card over gloo, each a
     process of its own (phase25_rank) under a 600 s wall limit: config
     3's 10000 problems 5000 a rank through K1 named and generated (each
     element the unsharded call's bits), the sample problem's 100 rows 50
     a rank in float64 with History (the unsharded solve's decisions and
     step types), config 6's grid (32x32x8, Nstate 8192, 24064
     measurements, 3008 stored lower blocks, rcm/amalgamate 16) with
     12032 dense J rows a rank through MeasurementShardedSparseProblem in
     float32 under metric 2's gate (reason > 0, max|Jt_x| <= 1e-3, p
     within 1e-3 of float64), both ranks and a second solve the same
     bits, K6 and K7 launched; a dp-sharded batched state through the
     distributed checkpoint, resumed to the one-shot run's bits; all_reduce
     calls and bytes an evaluation, walls in turns, peak memory;
 26. point-parallel bundle adjustment (BAProblem.shard/shard_p_tree, the
     point-sharded tree Schur strategies of ops/newton.py): configs 4 in
     tree form (nc 64, 20000 points; norm2_x < 1e-3) and 7s (ncam 128,
     50000 points, the jittered start; reason > 0, norm2_x < 2 nobs),
     plain and with refine_iters=2 and a per-rank cam_gather, float32
     under PRM, their points sharded over a "pts" axis: (a) a world of one
     on NCCL, every result field of two sharded solves the unsharded
     solve's bits, host walls in turns with it; (b) two ranks on the one
     card over gloo (phase26_rank, 10000 and 25000 points a rank, a 600 s
     wall limit), both past the gate with the same bits of c, U and every
     decision field, a second solve the same bits, their q blocks put
     together beside the unsharded solve (steps, reason, largest
     difference); for each leg the host wall, attempts, all_reduce calls
     and bytes an attempt and peak memory, by rank; no kernel of K1-K7.
     Each phase prints its seconds.
Then one JSON line about the kernels (time, plain version's time, the
library call's where one exists, and the bound from this run's shapes; K1
once per instance, the generated one's from phase 23; K1 (by instance),
K3, K6, K7 and the segment add with their launches on each path that runs
them, phase 25's mesh paths among them, `launches` their sum; the segment
add, the sparse path's port-only kernel, names the XLA scatter it replaces
in the JAX package and carries every reading of phase 22 under
`readings`), the card line again, and a last JSON
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
    from libdogleg_tpu_torch.ops import panelchol, segsum

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
    segsum.launch_count = 0
    r32, wall = solve("diag", torch.float32, bench)
    launches = panelchol.launch_count
    seg = segsum.launch_count
    check(seg > 0, f"the dense leg launched the segment add: {seg}")
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
    dense_jtj_turns(dev, bench, card_line())
    return {"launches": launches, "seg_launches": seg}


def jtj_dense_index_put(J):
    """ops/bcsr.bcsr_jtj_dense as it was before its sums took a fixed
    order: the pair products scattered into their blocks by index_put_'s
    accumulation (atomics on the card)."""
    import torch
    s, v = J.structure, J.values
    pi, pj = s.jtj_pairs()

    def idx(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=v.device)
    contrib = v[idx(pi)].mT @ v[idx(pj)]
    out = torch.zeros((s.nbcol, s.nbcol, s.block_cols, s.block_cols),
                      dtype=v.dtype, device=v.device)
    out.index_put_((idx(s.indices[pi]), idx(s.indices[pj])), contrib,
                   accumulate=True)
    return out.permute(0, 2, 1, 3).reshape(s.nstate, s.nstate)


def dense_jtj_turns(dev, bench, card) -> None:
    """Config 6's dense-JtJ leg, float32: bcsr_jtj_dense (the pair products
    summed into their blocks in a fixed order by the segment add) gives the
    same bits twice and the index_put_ form's within rounding; it and the
    whole dense solve in turns with the index_put_ form (CUDA events)."""
    import torch

    from libdogleg_tpu_torch import BlockedDenseNewtonSolver, optimize
    from libdogleg_tpu_torch.models import grid_mrf
    from libdogleg_tpu_torch.ops import bcsr
    from libdogleg_tpu_torch.utils.benchtime import measure_ms
    g = grid_mrf.make_grid_mrf(*GRID, dtype=torch.float32, device=dev)
    prob = g.problem(jtj="dense")
    p0 = torch.zeros(g.nstate, dtype=torch.float32, device=dev)
    _, J = prob.jacobian(p0)
    a, b = bcsr.bcsr_jtj_dense(J), bcsr.bcsr_jtj_dense(J)
    check(same_bits(a, b), "dense JtJ: two evaluations the same bits")
    old = jtj_dense_index_put(J)
    err = float((a - old).abs().max() / old.abs().max())
    check(err <= 1e-6, f"dense JtJ within 1e-6 of the index_put_ form: "
          f"{err:.1e}")
    r1 = optimize(prob, p0, bench, newton_solver=BlockedDenseNewtonSolver())
    r2 = optimize(prob, p0, bench, newton_solver=BlockedDenseNewtonSolver())
    check(same_bits(r1.p, r2.p), "dense leg: two solves the same bits")
    shipped = bcsr.bcsr_jtj_dense
    forms = {"fixed order": shipped, "index_put_": jtj_dense_index_put}
    jtj_ms = {f: [] for f in forms}
    solve_ms = {f: [] for f in forms}
    try:
        for f in ("index_put_", "fixed order", "fixed order", "index_put_"):
            bcsr.bcsr_jtj_dense = forms[f]
            jtj_ms[f].append(measure_ms(forms[f], J, warmup=1, reps=5))
            solve_ms[f].append(measure_ms(lambda: float(optimize(
                prob, p0, bench, newton_solver=BlockedDenseNewtonSolver()
            ).norm2_x), warmup=1, reps=2))
    finally:
        bcsr.bcsr_jtj_dense = shipped
    text = "; ".join(
        f"{f}: JtJ {'/'.join(f'{v:.3f}' for v in jtj_ms[f])} ms, the "
        f"solve {'/'.join(f'{v:.1f}' for v in solve_ms[f])} ms"
        for f in forms)
    print(f"[8 grid {GRID} dense JtJ f32] two evaluations the same bits, "
          f"two solves the same bits; within {err:.1e} of the index_put_ "
          f"form (largest entry); in turns (CUDA events): {text}; card "
          f"{card}", flush=True)


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

    from libdogleg_tpu_torch.ops import segsum

    def counts():
        return {"bcsr_jtj_blocks_kernel":
                tk.launch_counts["bcsr_jtj_blocks_kernel"],
                **tilechol.launch_counts,
                "segment_add": segsum.launch_count}

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
    segsum.launch_count = 0
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
          f"K3, K6, K7 and the segment add launched on the main path: "
          f"{launches}")

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
            "K1 auto": mega.auto_launch_count, "K2": panelchol.launch_count, **bcsr_kernels.launch_counts,
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
K3_GROUPS = (("K3", ("jtj_",)), ("segment add", ("segment_add",))) \
    + SPARSE_GROUPS


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

    from libdogleg_tpu_torch.ops import segsum

    def counts():
        return {"K3": tk.launch_counts["bcsr_jtj_blocks_kernel"],
                "K6": tilechol.launch_counts["tile_cholesky"],
                "K7": tilechol.launch_counts["tri_solve_right"],
                "SEG": segsum.launch_count}

    def zero_counts():
        tk.launch_counts["bcsr_jtj_blocks_kernel"] = 0
        for k in tilechol.launch_counts:
            tilechol.launch_counts[k] = 0
        segsum.launch_count = 0

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
                  f"f64 batch on {device}: K3, K6, K7 and the segment add "
                  f"launched on the card only: {launched}")
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
    check(all(launched.values()), f"config 6b: K3, K6, K7 and the segment "
          f"add launched: {launched}")
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
        again = optimize(prob, p0, bench)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        check(same_bits(again.p, r.p), "config 6b: a later solve the same "
              "bits")
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
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rs2 = optimize(simple, p0, bench)
    torch.cuda.synchronize()
    wall_s2 = time.perf_counter() - t0
    check(same_bits(rs2.p, rs.p), "config 6b simplicial: a second solve "
          "the same bits")
    # what the first call adds for the fixed order: the plans of the
    # analysis's three schedules, built again on the host, and their
    # kernel operands copied to the card
    t0 = time.perf_counter()
    nplans = 0
    for sched_name, tgt, off in (("sched", "upd_tgt", "upd_off"),
                                 ("fwd", "pair_j", "pair_off"),
                                 ("bwd", "pair_j", "pair_off")):
        ss = getattr(simple_sym, sched_name)
        for plan in segsum.level_plans(getattr(ss, tgt), getattr(ss, off)):
            plan.kernel_operands(dev)
            nplans += 1
    torch.cuda.synchronize()
    t_plans = time.perf_counter() - t0
    print(f"[22 grid-mrf-64x64x8-simplicial-f32 PRM] the model's default "
          f"problem (mindeg, {simple_sym.sched.nlevels} levels): reason "
          f"{int(rs.reason)} n_attempts {int(rs.n_attempts)}; max|Jt_x| "
          f"{jtx_s:.3e}; max |p32 - p64| {dps:.3e}; launches {launched}; "
          f"wall {wall_s * 1e3:.1f} ms (the first call after the analysis),"
          f" {wall_s2 * 1e3:.1f} ms (the second); the {nplans} level plans "
          f"of its three schedules built and copied to the card in "
          f"{t_plans * 1e3:.1f} ms; card {card}", flush=True)

    print(f"[22 grid-mrf-64x64x8-simplicial-f32 profile] "
          f"{device_split(lambda: optimize(simple, p0, bench), groups=K3_GROUPS)}",
          flush=True)
    # reading (iii): the simplicial substitutions' levels with the longest
    # run, one right-hand side
    gen = torch.Generator().manual_seed(20)
    out["SEG 6b"] = segment_add_readings(
        [segment_add_level(simple_sym, 1, name, sched, "pair_j", "pair_off",
                           simple_sym.nb, (simple_sym.b, 1), gen)
         for name, sched in (("forward", "fwd"), ("backward", "bwd"))],
        "6b simplicial B1", card)
    p10_forms("config 6b supernodal", lambda: float(
        optimize(prob, p0, bench).norm2_x), lambda: optimize(prob, p0,
                                                            bench).p, card)
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
    # the sums in a fixed order (ops/segsum.py) make a second run the same
    check(same, f"B{B}: two runs the same bits")
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
          f"{peak / 2 ** 30:.2f} GiB; two runs the same bits; card {card}",
          flush=True)
    p10_forms(f"B{B} batch", lambda: float(solve().norm2_x.sum()),
              lambda: solve().p, card)
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
    gen = torch.Generator().manual_seed(22)
    seg = segment_add_readings(
        [segment_add_level(inner, B, "UPDATE", "sched", "upd_tgt", "upd_off",
                           inner.nslots, (inner.b, inner.b), gen),
         segment_add_level(inner, B, "forward pairs", "fwd", "pair_j",
                           "pair_off", inner.nb, (inner.b, 1), gen)],
        f"B{B}", card)
    # the kernels line: the UPDATE level's readings, and every reading's
    out["SEG"] = dict(seg[0], readings=seg + out.pop("SEG 6b"))
    print(f"[22 B{B} seconds] {time.perf_counter() - t_leg:.1f}", flush=True)
    out["K3"] = k3
    return out


def segment_add_level(sym, B, label, sched, tgt, off, width, inner, gen):
    """A reading's case: the level of the schedule `sym.<sched>` with the
    most terms on one target (then the most terms), seeded values of B
    elements of base (B, width, *inner) and of its terms."""
    import torch

    from libdogleg_tpu_torch import sparse_cholesky as sc
    dev = torch.device("cuda")
    plans = sc._level_plans(sym, sched, tgt, off)
    k = max(range(len(plans)), key=lambda i: (plans[i].rounds, plans[i].n))
    base = torch.randn((B, width) + inner, generator=gen).to(dev)
    terms = torch.randn((B, plans[k].n) + inner, generator=gen).to(dev)
    return label, plans[k], base, terms


def segment_add_readings(cases, tag, card) -> list:
    """The segment-add kernel (csrc/segsum.cu) on each case of
    segment_add_level, alpha -1 as the factorization and substitutions
    call it: against its plain version on the same CUDA tensors
    (segsum.reference; the same bits), alone (profiler), and with its
    wrapper in turns with the plain version and with index_add_ (the
    library call, the form before P10's repair; CUDA events over 20 calls,
    in place), beside its bound: the terms, the operands and each target
    row read once, each target row written once. Returns one dict a case,
    in order."""
    import torch

    from libdogleg_tpu_torch.ops import segsum
    from libdogleg_tpu_torch.utils.benchtime import measure_ms
    dev = torch.device("cuda")
    rows, out = [], []
    for label, plan, base, terms in cases:
        got = segsum.add_(base.clone(), 1, plan, terms, alpha=-1)
        want = segsum.reference(base.clone(), 1, plan, terms, alpha=-1)
        err = float((got - want).abs().max())
        check(same_bits(got, want), f"segment add {label}: the kernel "
              f"gives its plain version's bits")
        targets = torch.as_tensor(plan.targets, device=dev)
        fns = {"kernel": lambda: segsum.add_(base, 1, plan, terms, alpha=-1),
               "plain": lambda: segsum.reference(base, 1, plan, terms,
                                                 alpha=-1, in_place=True),
               "library": lambda: base.index_add_(1, targets, terms,
                                                  alpha=-1)}
        ms = {f: [] for f in fns}
        for form in ("kernel", "plain", "library", "library", "plain",
                     "kernel"):
            ms[form].append(measure_ms(fns[form], warmup=2, reps=20))
        alone = kernel_us(fns["kernel"], (), "segment_add")
        nrow = base[0, 0].numel() * base.element_size()
        nruns = len(plan.uniq)
        bnd = bound(nbytes_of(terms, *plan.kernel_operands(dev)[:2])
                    + 4 * plan.n + 2 * base.shape[0] * nruns * nrow,
                    terms.numel())
        rows.append(f"{label} level: {plan.n} terms on {nruns} rows, at "
                    f"most {plan.rounds} on one, of {tuple(base.shape)}: "
                    f"max |kernel - plain| {err:.1e} (the same bits); "
                    f"alone {us_text(alone)}; ms a call, kernel "
                    f"{'/'.join(f'{v:.4f}' for v in ms['kernel'])}, "
                    f"plain (rounds) "
                    f"{'/'.join(f'{v:.4f}' for v in ms['plain'])}, "
                    f"index_add_ "
                    f"{'/'.join(f'{v:.4f}' for v in ms['library'])}; "
                    f"bound {bnd['bound_ms'] * 1e3:.4f} us by "
                    f"{bnd['bound_by']}")
        out.append(dict(label=f"{tag} {label}", max_abs_err=err,
                        ms=min(ms["kernel"]), alone_us=alone,
                        plain_ms=min(ms["plain"]),
                        library_ms=min(ms["library"]), **bnd))
    print(f"[22 segment add at {tag}] {'; '.join(rows)}; card {card}",
          flush=True)
    return out


# the plans' targets on the card for sums_as("index_add_"), each kept with
# its plan
_INDEX_ADD_TARGETS: dict = {}


@contextlib.contextmanager
def sums_as(form):
    """ops/segsum.py's two entry points as another form while the block
    runs, for a comparison: "index_add_" (atomics on the plan's targets,
    the form before P10's repair, not reproducible on the card), "plain"
    (segsum.reference, the kernel's plain version, on the card) or
    "kernel" (as shipped)."""
    import torch

    from libdogleg_tpu_torch.ops import segsum
    shipped = segsum.add_, segsum.add

    def targets(plan, device):
        key = (id(plan), device)
        if key not in _INDEX_ADD_TARGETS:
            _INDEX_ADD_TARGETS[key] = (plan, torch.as_tensor(
                plan.targets, device=device))
        return _INDEX_ADD_TARGETS[key][1]
    if form == "plain":
        segsum.add_ = lambda base, dim, plan, terms, alpha=1: \
            segsum.reference(base, dim, plan, terms, alpha=alpha,
                             in_place=True)
        segsum.add = lambda base, dim, plan, terms: segsum.reference(
            base, dim, plan, terms)
    elif form == "index_add_":
        segsum.add_ = lambda base, dim, plan, terms, alpha=1: \
            base.index_add_(dim, targets(plan, base.device), terms,
                            alpha=alpha)
        segsum.add = lambda base, dim, plan, terms: base.index_add(
            dim, targets(plan, base.device), terms)
    try:
        yield
    finally:
        segsum.add_, segsum.add = shipped


def p10_forms(label, timed, result, card) -> None:
    """The sparse path's sums where several terms meet one target
    (ops/segsum.py) in each form, in turns (index_add_, plain, kernel,
    then back; CUDA events, a dependent fetch; sums_as): the kernel (as
    shipped) and its plain version add in a fixed order and must give the
    same bits on two runs, and the kernel's the plain version's;
    index_add_ is the form before the repair. Prints the times and
    whether each form gives the same bits twice and the shipped form's
    bits."""
    from libdogleg_tpu_torch.utils.benchtime import measure_ms
    forms = ("index_add_", "plain", "kernel")
    ms = {f: [] for f in forms}
    bits = {}
    ref = result()
    for f in forms + forms[::-1]:
        with sums_as(f):
            ms[f].append(measure_ms(timed, warmup=1, reps=2))
    for f in forms:
        with sums_as(f):
            a, b = result(), result()
        bits[f] = (same_bits(a, b), same_bits(a, ref))
    for f in ("plain", "kernel"):
        check(bits[f][0] and bits[f][1], f"{label}: the {f} form gives the "
              f"same bits twice, and the shipped form's")
    text = "; ".join(
        f"{f}{' (shipped)' if f == 'kernel' else ''} "
        f"{'/'.join(f'{v:.2f}' for v in ms[f])} ms, two runs "
        f"{'the same' if bits[f][0] else 'NOT the same'} bits, "
        f"{'the same' if bits[f][1] else 'other'} bits than the shipped form"
        for f in forms)
    print(f"[22 {label} P10 forms, in turns] {text}; card {card}",
          flush=True)


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


# ---------------------------------------------------------------------------
# 23. megakernel auto-promotion: K1 on generated functors

CONFIG3_BATCH = 10000     # bench_all.py:156 config3_batched(batch=10000)
CONFIG2_BATCH = 4096
CONFIG8_N16 = (16, 1024)  # config 8's family at Nstate 16: nmeas 64
AUTO_F64_BATCH = 1024
# The float64 elements of phase 23's instances at which the plain version
# run on the card's tensors (sums in cuBLAS's order) may take other
# decisions than the kernel: config 3's element 587, where max|Jt_x| after
# the fourth step straddles the 1e-8 threshold. There the kernel takes the
# plain version's decisions on the CPU, and the JAX package's (the CPU
# test test_phase23_f64_instances_take_jax_decisions).
AUTO_F64_ORDER_ELEMENTS = {"config 3": (587,), "config 2": (),
                           "config 8 n16": ()}
# SHA-256 of every field of the named instances' results (k1_digests), as
# the kernel stood before its solve moved into csrc/dogleg_solve.cuh (H100,
# CUDA 12.8): the move changed no bit.
K1_DIGESTS = {
    "general float32 B=8192":
        "f0f650dfd025c97b13c31bd0e974cd951c9bcc7e89a3b20c6725322bac7f46bc",
    "factored float32 B=8192":
        "745d436bd1d7e8b5689cc6abe7dc95d77fd4ffbcfe0e7afd8dc08fba7317cf42",
    "general float64 B=1024":
        "562e2c27832cb6d97954ce98186dd48f99ccfcf0ef3b822eee478d5645fddd41",
    "factored float64 B=1024":
        "3bd0a62ceab2f580e91e427b2f32edf324404daaef8d61148431dea32a4907ed",
}


def k1_digests(dev) -> dict:
    """SHA-256 of every field of each named K1 instance's result, float32
    at B=8192 under the benchmark rule and float64 at B=1024 under the
    defaults, on the inputs of phases 3 and 17 (instances() and
    factored_args() with seeds 1 and 0)."""
    import hashlib

    import torch

    from libdogleg_tpu_torch import DoglegParameters
    from libdogleg_tpu_torch.ops import mega
    out = {}
    for dtype, batch, seed, prm in (
            (torch.float32, BATCH, 1, DoglegParameters(**BENCH)),
            (torch.float64, 1024, 0, DoglegParameters())):
        name = str(dtype).split(".")[-1]
        for kind, fn, args in (
                ("general", mega.megakernel_optimize,
                 instances(seed, batch, dtype, dev)),
                ("factored", mega.megakernel_optimize_factored,
                 factored_args(seed, batch, dtype, dev)[0])):
            r = fn(*args, prm)
            h = hashlib.sha256()
            for t in r:
                if t is not None:
                    h.update(t.cpu().numpy().tobytes())
            out[f"{kind} {name} B={batch}"] = h.hexdigest()
    return out


def config3_products(gx, gy):
    """bench_all.py:156-162's products, an ordinary closure over the grid,
    in torch: no device function named, nothing batch-minor."""
    from libdogleg_tpu_torch import Products
    from libdogleg_tpu_torch.models import quadratic_surface as qs

    def products(p, meas):
        x = qs.model(p, gx, gy) - meas
        J = qs.jacobian(p, gx, gy)
        return Products(norm2_x=x @ x, Jt_x=J.T @ x, JtJ=J.T @ J)
    return products


def config2_batch(batch, dtype, device):
    """Config 2's curve fit (nmeas 64, Nstate 3) as a batch of seeded
    instances: element b's measurements P_TRUE's curve + 0.02 N(0, 1), its
    start P_TRUE + 0.1 N(0, 1), from default_rng(2); the products close
    over the sample times t. Returns (products, measurements, starts)."""
    import torch

    from libdogleg_tpu_torch import Products
    from libdogleg_tpu_torch.models import curve_fit as cf
    rng = np.random.default_rng(2)
    t_np = np.linspace(0.0, 1.0, CONFIG2_NMEAS)
    meas = (cf.P_TRUE[0] * np.exp(cf.P_TRUE[1] * t_np) + cf.P_TRUE[2]
            + 0.02 * rng.normal(size=(batch, CONFIG2_NMEAS)))
    p0 = cf.P_TRUE + 0.1 * rng.normal(size=(batch, cf.NSTATE))
    t = torch.as_tensor(t_np, dtype=dtype, device=device)

    def products(p, m):
        x = cf.model(p, t) - m
        J = cf.jacobian(p, t)
        return Products(norm2_x=x @ x, Jt_x=J.T @ x, JtJ=J.T @ J)
    return (products, torch.as_tensor(meas, dtype=dtype, device=device),
            torch.as_tensor(p0, dtype=dtype, device=device))


def auto_cases(dtype, dev, batches):
    """The three functions phase 23 promotes, as (label, products, p0,
    problem_data): config 3 (Nstate 6), config 2 (3) and config 8's family
    at Nstate 16, at the batches given (one each)."""
    from libdogleg_tpu_torch.models import quadratic_surface as qs
    b3, b2, b8 = batches
    p0, meas, _, _ = instances(30, b3, dtype, dev)
    gx, gy = qs.make_grid(dtype, dev)
    f2, m2, p2 = config2_batch(b2, dtype, dev)
    data8, p8, _ = midsize_family(CONFIG8_N16[0], b8, dtype, dev)
    return [("config 3", config3_products(gx, gy), p0, meas),
            ("config 2", f2, p2, m2),
            ("config 8 n16", midsize_products, p8, data8)]


@contextlib.contextmanager
def masked_runs():
    """Counts, in its `count`, the calls of the masked batched driver's
    entry points made by parallel/batched.py inside the context."""
    from libdogleg_tpu_torch.parallel import batched
    names = ("solve_products_batched", "init_batched_state")
    saved = {name: getattr(batched, name) for name in names}
    counter = type("Count", (), {"count": 0})()

    def counted(fn):
        def call(*args, **kwargs):
            counter.count += 1
            return fn(*args, **kwargs)
        return call
    for name in names:
        setattr(batched, name, counted(saved[name]))
    try:
        yield counter
    finally:
        for name in names:
            setattr(batched, name, saved[name])


def ptxas_auto(log: str) -> list:
    """ptxas's registers, stack frame and spills of each generated K1
    kernel in an nvcc log, one short line each."""
    import re
    out, name, frame = [], None, ""
    for line in log.splitlines():
        m = re.search(r"entry function '.*?(dogleg_auto(?:_products)?_kernel)"
                      r"I([fd])Li(\d+)E", line)
        if "entry function" in line:
            name = (f"{m.group(1)}<{'float' if m.group(2) == 'f' else 'double'}"
                    f", N={m.group(3)}>" if m else None)
        elif name and "stack frame" in line:
            frame = line.strip()
        elif name and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            out.append(f"{name}: {regs} registers; {frame}")
            name = None
    return out


def decisions_agree(r, ref) -> float:
    """Share of elements with the same step count (tests/test_mega_auto.py:
    142's rule)."""
    return (r.step_count == ref.step_count).float().mean().item()


def phase23_mega_auto(dev, bench, card) -> dict:
    import torch

    from libdogleg_tpu_torch.models import quadratic_surface as qs
    from libdogleg_tpu_torch.native import loader
    from libdogleg_tpu_torch.ops import mega
    from libdogleg_tpu_torch.parallel import (batched_optimize,
                                              batched_optimize_compacted,
                                              mega_auto)
    from libdogleg_tpu_torch.utils.benchtime import measure_ms

    # the named instances' bits, against the parent's
    digests = k1_digests(dev)
    for key, digest in digests.items():
        check(digest == K1_DIGESTS.get(key),
              f"K1 {key}: SHA-256 {digest} is the parent's "
              f"{K1_DIGESTS.get(key)}")
    print(f"[23 named K1 digests] {len(digests)} results bit for bit the "
          f"parent's: {json.dumps(digests)}", flush=True)

    # plans for the three functions at full width, each in the row form;
    # config 3's array form and row form at G = 1 beside them; their builds
    cases = auto_cases(torch.float32, dev,
                       (CONFIG3_BATCH, CONFIG2_BATCH, CONFIG8_N16[1]))
    plans = []
    for label, fn, p0, data in cases:
        traces = mega_auto.trace_count
        t0 = time.perf_counter()
        plan = mega_auto.plan_megakernel(fn, p0, bench, problem_data=data)
        trace_ms = (time.perf_counter() - t0) * 1e3
        check(plan is not None and plan.kernel.source.form == "row",
              f"{label}: auto-promotion plans K1 in the row form")
        src = plan.kernel.source
        plans.append(plan)
        print(f"[23 plan {label}] B={p0.shape[0]} Nstate {src.nstate} f32: "
              f"the {src.form} form, G={src.group} lanes a problem over "
              f"{src.rows} rows; {mega_auto.trace_count - traces} trace and "
              f"the generation in {trace_ms:.1f} ms; {src.n_inputs} inputs, "
              f"{src.local_values} local values a problem, {src.operations} "
              f"operations an evaluation", flush=True)
    a3 = plans[0].kernel.adapted
    array3, row3 = (mega_auto.GeneratedKernel(
        a3, mega_auto.generate_source(a3, torch.float32, _form=form,
                                      _group=1))
        for form in ("array", "row"))
    built = ([(label, p.kernel) for (label, *_), p in zip(cases, plans)]
             + [("config 3 array form", array3),
                ("config 3 row form G=1", row3)])
    infos = loader.build_generated(*(k.source.text for _, k in built))
    print(f"[23 build] {len(infos)} generated sources, one nvcc process "
          f"each, started together: {infos[0].seconds:.2f} s; card {card}",
          flush=True)
    for (label, k), info in zip(built, infos):
        print(f"[23 ptxas {label}] the {k.source.form} form, "
              f"G={k.source.group}: {'; '.join(ptxas_auto(info.log))}",
              flush=True)

    # the row form at G = 1 gives the array form's bits, every field
    _, fn3, p0, meas = cases[0]
    leaves3, consts3 = plans[0].data_leaves, plans[0].consts
    r_row1, r_array = (mega.megakernel_optimize_generated(
        k, p0, leaves3, bench, consts3) for k in (row3, array3))
    torch.cuda.synchronize()
    differ = [f for f, x, y in zip(r_row1._fields, r_row1, r_array)
              if x is not None and not torch.equal(x, y)]
    check(not differ, f"config 3: the row form at G=1 gives the array "
          f"form's bits (fields that differ: {differ})")
    print(f"[23 config 3 forms B={CONFIG3_BATCH} f32] the row form at G=1 "
          f"and the array form, both built in this run: every field of the "
          f"solve bit for bit", flush=True)

    # config 3's public call: exactly one K1-auto launch, no masked run
    for key in ("launch_count", "factored_launch_count",
                "auto_launch_count"):
        setattr(mega, key, 0)
    before = kernel_launch_counts()
    with masked_runs() as masked:
        r3 = batched_optimize_compacted(fn3, p0, bench, problem_data=meas)
        torch.cuda.synchronize()
    counts = {k: v - before[k] for k, v in kernel_launch_counts().items()}
    launches = counts.pop("K1 auto")
    check(launches == 1 and masked.count == 0 and not any(counts.values()),
          f"config 3: one K1-auto launch ({launches}), no masked run "
          f"({masked.count}), no other kernel ({counts})")
    rec = recovered_frac(r3.p)
    check(bool((r3.reason > 0).all()) and rec >= 0.99
          and bool(torch.isfinite(r3.p).all()),
          f"config 3: every reason > 0, finite p, recovered_frac {rec} >= "
          f"0.99")
    r3m = batched_optimize_compacted(fn3, p0, bench, problem_data=meas,
                                     use_megakernel=False)
    agree = decisions_agree(r3, r3m)
    same = r3.step_count == r3m.step_count
    max_abs_err = (r3.p - r3m.p).abs()[same].max().item()
    check(agree >= 0.85, f"config 3 f32: step-count agreement {agree} with "
          f"the masked driver >= 0.85")
    print(f"[23 config 3 B={CONFIG3_BATCH} f32] batched_optimize_compacted "
          f"with the ordinary closure: K1-auto launches {launches}, masked "
          f"runs {masked.count}, other kernels none; recovered_frac "
          f"{rec:.4f} (>= 0.99; masked {recovered_frac(r3m.p):.4f}); reasons "
          f"{torch.bincount(r3.reason, minlength=7).tolist()}; step-count "
          f"agreement with the masked driver {agree:.4f} (>= 0.85); max "
          f"|dp| where they agree {max_abs_err:.3e}; "
          f"{attempts_text(r3.n_attempts)}", flush=True)

    # the other two functions, each launched once, against the masked path
    for (label, fn, p0_, data), plan in list(zip(cases, plans))[1:]:
        before = mega.auto_launch_count
        with masked_runs() as masked:
            r = batched_optimize(fn, p0_, bench, problem_data=data)
            torch.cuda.synchronize()
        got = mega.auto_launch_count - before
        check(got == 1 and masked.count == 0,
              f"{label}: one K1-auto launch ({got}), no masked run")
        rm = batched_optimize(fn, p0_, bench, problem_data=data,
                              use_megakernel=False)
        agree_ = decisions_agree(r, rm)
        check(agree_ >= 0.85 and bool(torch.isfinite(r.p).all()),
              f"{label} f32: finite, step-count agreement {agree_} >= 0.85")
        print(f"[23 {label} B={p0_.shape[0]} f32] batched_optimize: K1-auto "
              f"launches {got}, masked runs {masked.count}; step-count "
              f"agreement with the masked driver {agree_:.4f} (>= 0.85); "
              f"reasons {torch.bincount(r.reason, minlength=7).tolist()}; "
              f"{attempts_text(r.n_attempts)}", flush=True)

    # float64: the generated kernel against its plain version, as the CPU
    # path runs it (the oracle of the CPU tests, which there takes the JAX
    # package's decisions), and against the plain version run on the card's
    # tensors, which sums in cuBLAS's order: they may differ only at the
    # elements of AUTO_F64_ORDER_ELEMENTS, whose decisions follow the order
    # of the sums
    for (label, fn, p0_, data) in auto_cases(
            torch.float64, dev, (AUTO_F64_BATCH,) * 3):
        plan = mega_auto.plan_megakernel(fn, p0_, None, problem_data=data,
                                         forced=True)
        check(plan.kernel.source.form == "row", f"{label} f64: the row form")
        r_k = plan()
        cpu = (p0_.cpu(), tuple(t.cpu() for t in plan.data_leaves),
               tuple(t.cpu() for t in plan.consts))
        r_p = mega.megakernel_optimize_generated_reference(
            plan.kernel, cpu[0], cpu[1], None, cpu[2])
        r_card = mega.megakernel_optimize_generated_reference(
            plan.kernel, p0_, plan.data_leaves, None, plan.consts)
        got = mega.products_generated(plan.kernel, p0_, plan.data_leaves,
                                      plan.consts)
        want = mega.products_generated(plan.kernel, *cpu)
        torch.cuda.synchronize()
        for field in ("step_count", "n_attempts", "reason"):
            check(torch.equal(getattr(r_k, field).cpu(), getattr(r_p, field)),
                  f"{label} f64 {field} identical to the plain version's")
        check(torch.allclose(r_k.p.cpu(), r_p.p, rtol=1e-10, atol=1e-12),
              f"{label} f64 p within 1e-10 of the plain version's")
        on_card = sorted(set().union(*(
            torch.nonzero(getattr(r_k, f) != getattr(r_card, f)).flatten()
            .tolist() for f in ("step_count", "n_attempts", "reason"))))
        check(set(on_card) <= set(AUTO_F64_ORDER_ELEMENTS[label]),
              f"{label} f64: decisions identical to the plain version's on "
              f"the card but at {AUTO_F64_ORDER_ELEMENTS[label]}: they "
              f"differ at {on_card}")
        perr = [rel_err(g.cpu(), w) for g, w in zip(got, want)]
        check(max(perr) <= 1e-12, f"{label} f64 products within 1e-12 of "
              f"the plain version's: {perr}")
        print(f"[23 {label} f64 B={AUTO_F64_BATCH}] Nstate "
              f"{plan.kernel.source.nstate}, the row form at G="
              f"{plan.kernel.source.group}: step_count, n_attempts, reason "
              f"identical to the plain version's (on the CPU); max |dp| "
              f"{(r_k.p.cpu() - r_p.p).abs().max().item():.3e} (1e-10); the "
              f"plain version run on the card's tensors takes other "
              f"decisions at elements {on_card} (allowed: "
              f"{list(AUTO_F64_ORDER_ELEMENTS[label])}); the functor alone "
              f"against the graph on the CPU, largest difference over largest "
              f"value: norm2 {perr[0]:.2e}, Jt_x {perr[1]:.2e}, JtJ "
              f"{perr[2]:.2e}", flush=True)

    # timing: config 3's public call with and without promotion, in turns,
    # and the traces it makes (the plan cache: none after the first)
    def public(mk):
        return float(batched_optimize_compacted(
            fn3, p0, bench, problem_data=meas,
            use_megakernel=mk).norm2_x.sum())
    traces = mega_auto.trace_count
    turns = [measure_ms(public, mk, warmup=1, reps=3)
             for mk in (None, False, False, None)]
    traces = mega_auto.trace_count - traces
    check(traces == 0, f"config 3's repeated public calls trace nothing "
          f"({traces})")
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        mega_auto.plan_megakernel(fn3, p0, bench, problem_data=meas)
        walls.append((time.perf_counter() - t0) * 1e3)
    # K1-auto (the row form) with its wrapper and alone, in turns with the
    # array form and the named general instance on the same problems
    plan = plans[0]
    gx, gy = qs.make_grid(torch.float32, dev)
    legs = {"row": (mega.megakernel_optimize_generated,
                    (plan.kernel, p0, leaves3, bench, consts3),
                    "dogleg_auto_kernel"),
            "array": (mega.megakernel_optimize_generated,
                      (array3, p0, leaves3, bench, consts3),
                      "dogleg_auto_kernel"),
            "named": (mega.megakernel_optimize, (p0, meas, gx, gy, bench),
                      "dogleg_mega_kernel")}
    readings = {k: [] for k in legs}
    for k in ("row", "array", "named", "named", "array", "row"):
        fn, args, name = legs[k]
        readings[k].append((measure_ms(fn, *args, warmup=3, reps=20),
                            kernel_us(fn, args, name)))
    args = legs["row"][1]
    ms = min(m for m, _ in readings["row"])
    alone = readings["row"][0][1]
    plain_ms = measure_ms(mega.megakernel_optimize_generated_reference,
                          *args, warmup=1, reps=3)
    # the bound: the graph's operations an evaluation, one evaluation at the
    # start and one an attempt, the step math an attempt as phase 6 counts
    # it; p0, the data, the constants in and the results out
    r_b = mega.megakernel_optimize_generated(*args)
    n = plan.kernel.source.nstate
    evals = float((r_b.n_attempts + 1).sum())
    limit = bound(
        nbytes_of(p0, *plan.data_leaves, *consts3)
        + nbytes_of(*(t for t in r_b if t is not None)),
        evals * plan.kernel.source.operations
        + float(r_b.n_attempts.sum()) * (n ** 3 / 3 + 6 * n * n + 10 * n))

    def leg_text(k):
        return ", ".join(f"{m:.4f} ms ({us_text(u)})" for m, u in readings[k])
    print(f"[23 timing config 3 B={CONFIG3_BATCH} f32] the public call "
          f"with a dependent fetch, in turns (auto, masked, masked, auto): "
          f"{', '.join(f'{t:.3f}' for t in turns)} ms, {traces} traces over "
          f"its calls; planning a call (the plan cache), host ms "
          f"{', '.join(f'{w:.3f}' for w in walls)}; in turns with the "
          f"wrapper (CUDA events) and alone: K1-auto, the row form at G="
          f"{plan.kernel.source.group}, {leg_text('row')}; the array form "
          f"{leg_text('array')}; the named general instance "
          f"{leg_text('named')}; K1-auto {CONFIG3_BATCH / ms * 1e3:.0f} "
          f"solves/s; plain version {plain_ms:.2f} ms; bound "
          f"{limit['bound_ms'] * 1e3:.2f} us by {limit['bound_by']} "
          f"({evals / CONFIG3_BATCH:.2f} evaluations of "
          f"{plan.kernel.source.operations} operations a problem); card "
          f"{card}", flush=True)
    return dict(launches=launches, max_abs_err=max_abs_err, ms=ms,
                plain_ms=plain_ms, library_ms=None, alone_us=alone, **limit)


# The serving process of phase 24: it imports the export module (which
# registers the kernels' operators and the result types) and nothing of the
# problem, loads the artifact, runs it once on the saved start and writes
# the result, its seconds and the kernels' launches.
EXPORT_CHILD = """
import json, sys, time
t0 = time.perf_counter()
import torch
from libdogleg_tpu_torch import export
from libdogleg_tpu_torch.ops import batchchol, bcsr_kernels, segsum, tilechol
t1 = time.perf_counter()
solver = export.load_exported(sys.argv[1])
t2 = time.perf_counter()
r = solver.call(torch.load(sys.argv[2]))
if torch.cuda.is_available():
    torch.cuda.synchronize()
t3 = time.perf_counter()
torch.save(r, sys.argv[3])
json.dump({"import_s": t1 - t0, "load_s": t2 - t1, "call_s": t3 - t2,
           "launches": {"K3": bcsr_kernels.launch_counts[
                            "bcsr_jtj_blocks_kernel"],
                        "K5": batchchol.launch_count,
                        "K6": tilechol.launch_counts["tile_cholesky"],
                        "K7": tilechol.launch_counts["tri_solve_right"],
                        "SEG": segsum.launch_count},
           "modules": sorted(m for m in sys.modules
                             if m.split(".")[0] in ("chip_smoke", "jax",
                                                    "libdogleg_tpu"))},
          open(sys.argv[4], "w"))
"""


def export_launches() -> dict:
    from libdogleg_tpu_torch.ops import (batchchol, bcsr_kernels, segsum,
                                         tilechol)
    return {"K3": bcsr_kernels.launch_counts["bcsr_jtj_blocks_kernel"],
            "K5": batchchol.launch_count,
            "K6": tilechol.launch_counts["tile_cholesky"],
            "K7": tilechol.launch_counts["tri_solve_right"],
            "SEG": segsum.launch_count}


def reset_export_launches() -> None:
    from libdogleg_tpu_torch.ops import (batchchol, bcsr_kernels, segsum,
                                         tilechol)
    bcsr_kernels.launch_counts["bcsr_jtj_blocks_kernel"] = 0
    batchchol.launch_count = 0
    for k in tilechol.launch_counts:
        tilechol.launch_counts[k] = 0
    segsum.launch_count = 0


def export_leg(label, products_fn, nstate, p0, bench, tmp, newton_solver=None,
               batch_size=None):
    """Export one artifact on the card, save it, run it in a fresh process
    and in this one (launches counted from 0 around that run), and hold the
    two runs to the same decisions and the same bits of p (the sparse
    factorization's sums in a fixed order since ops/segsum.py).
    Returns the fresh process's result, the program, the loaded solver, the
    launches and the fresh process's report."""
    import os

    import torch

    from libdogleg_tpu_torch import export
    t0 = time.perf_counter()
    exp = export.export_solver(products_fn, nstate, bench,
                               batch_size=batch_size,
                               dtype=p0.dtype, newton_solver=newton_solver,
                               device=p0.device)
    trace_s = time.perf_counter() - t0
    art = os.path.join(tmp, f"{label}.pt2")
    start, out, info = (os.path.join(tmp, f"{label}.{x}")
                        for x in ("p0.pt", "r.pt", "json"))
    export.save_exported(art, exp)
    torch.save(p0, start)
    proc = subprocess.run([sys.executable, "-c", EXPORT_CHILD, art, start,
                           out, info], capture_output=True, text=True,
                          timeout=600)
    check(proc.returncode == 0,
          f"{label}: the fresh process ran the artifact: "
          f"{proc.stderr[-3000:]}")
    child = json.loads(open(info).read())
    check(not child["modules"], f"{label}: the fresh process imported "
          f"{child['modules']}")

    fresh = torch.load(out, map_location=p0.device, weights_only=False)
    solver = export.load_exported(art)
    solver.call(p0)
    torch.cuda.synchronize()
    reset_export_launches()
    here = solver.call(p0)
    torch.cuda.synchronize()
    launches = export_launches()
    fields = ("step_count", "n_attempts", "reason", "p")
    check(all(torch.equal(getattr(fresh, f), getattr(here, f))
              for f in fields),
          f"{label}: the fresh process's {', '.join(fields)} are this "
          f"process's (max |dp| {float((fresh.p - here.p).abs().max()):.3e})")
    print(f"[24 {label}] trace {trace_s:.2f} s; artifact "
          f"{os.path.getsize(art)} bytes; fresh process: import "
          f"{child['import_s']:.2f} s, load {child['load_s']:.2f} s, first "
          f"call {child['call_s']:.2f} s, kernel launches "
          f"{child['launches']}; launches of one call here {launches}",
          flush=True)
    return fresh, exp, solver, launches, child


def export_turns(label, solver, live, loop, p0, card, groups) -> None:
    """The artifact's call, the live eager call and the traced loop run
    eagerly (the artifact's program without torch.export) in turns
    (artifact, live, loop, loop, live, artifact), CUDA events with a
    dependent fetch; then one call of the first two split by the profiler
    into device time by kernel group and host."""
    from libdogleg_tpu_torch.utils.benchtime import measure_ms

    def art():
        return float(solver.call(p0).norm2_x.sum())

    def eager():
        return float(live(p0).norm2_x.sum())

    def traced():
        return float(loop(p0).norm2_x.sum())
    turns = [measure_ms(fn, warmup=1, reps=3)
             for fn in (art, eager, traced, traced, eager, art)]
    print(f"[24 {label} timing] in turns: artifact "
          f"{turns[0]:.2f}, {turns[5]:.2f} ms; live eager call "
          f"{turns[1]:.2f}, {turns[4]:.2f} ms; the traced loop run eagerly "
          f"{turns[2]:.2f}, {turns[3]:.2f} ms; card {card}", flush=True)
    for name, fn in (("artifact", art), ("live", eager)):
        print(f"[24 {label} split {name}] {device_split(fn, groups=groups)}",
              flush=True)


def phase24_export(dev, bench, card) -> dict:
    """Ahead-of-time export at full width: three artifacts, each run in a
    fresh process and held against the live eager run."""
    import tempfile

    import torch

    from libdogleg_tpu_torch import (BlockedDenseNewtonSolver, SparseProblem,
                                     optimize, solve_products_batched)
    from libdogleg_tpu_torch import export
    from libdogleg_tpu_torch.models import grid_mrf
    from libdogleg_tpu_torch.models import quadratic_surface as qs

    decisions = ("step_count", "n_attempts", "reason")
    launches = {}
    tmp = tempfile.mkdtemp(prefix="dogleg_export_")

    # (a) the serving configuration: one measurement set, distinct starts
    p0, meas, _, _ = instances(24, BATCH, torch.float32, dev)
    m0 = meas[0]

    def sample_products(p):
        return qs.products(p, m0)
    fresh, exp, solver, _, _ = export_leg(
        f"a sample B={BATCH}", sample_products, qs.NSTATE, p0, bench, tmp,
        batch_size=BATCH)
    flat = export.flatten_products(sample_products, p0)
    loop = export.solve_traced(flat, p0, bench)
    eager = solve_products_batched(torch.func.vmap(sample_products), p0,
                                   bench)
    torch.cuda.synchronize()
    err = (fresh.p.double() - torch.as_tensor(qs.P_TRUE, device=dev)).abs()
    rec = float((err < 5e-2).all(-1).double().mean())
    check(bool((fresh.reason > 0).all()), "(a) every reason > 0")
    check(rec >= 0.99, f"(a) recovered_frac {rec} >= 0.99")
    check(all(torch.equal(getattr(fresh, f), getattr(loop, f))
              for f in ("p",) + decisions),
          "(a) the artifact's bits are the traced loop's run eagerly")
    same_eager = all(torch.equal(getattr(fresh, f), getattr(eager, f))
                     for f in ("p",) + decisions)
    print(f"[24 a sample B={BATCH} f32 PRM] reasons "
          f"{torch.bincount(fresh.reason, minlength=7).tolist()} (all > 0); "
          f"recovered_frac {rec:.4f} (>= 0.99); bits of the traced loop "
          f"run eagerly; bits of the eager masked loop "
          f"(solve_products_batched): {same_eager}", flush=True)
    export_turns("a", solver, lambda q: solve_products_batched(
        torch.func.vmap(sample_products), q, bench),
                 lambda q: export.solve_traced(flat, q, bench), p0, card,
                 (("cholesky", ("chol", "potrf")),) + K2_GROUPS[1:])
    del exp, solver, loop, eager, fresh, flat

    # (b) config 6's supernodal grid MRF, a single solve from 0
    g = grid_mrf.make_grid_mrf(*GRID, dtype=torch.float32, device=dev)
    prob = SparseProblem(f=g.problem(jtj="dense").f, structure=g.structure,
                         jtj="sparse", ordering="rcm", amalgamate=16)
    ns = prob.default_newton_solver()
    z = torch.zeros(g.nstate, dtype=torch.float32, device=dev)
    fresh, exp, solver, launches_b, child = export_leg(
        f"b grid {GRID} supernodal", prob.products, g.nstate, z, bench, tmp,
        newton_solver=ns)
    flat = export.flatten_products(prob.products, z[None], batched=False)
    reset_export_launches()
    loop = export.solve_traced(flat, z, bench, newton_solver=ns,
                               batched=False)
    torch.cuda.synchronize()
    live_launches = export_launches()
    for k in ("K3", "K6", "K7", "SEG"):
        check(launches_b[k] > 0, f"(b) the artifact launched {k}")
        check(launches_b[k] == live_launches[k] == child["launches"][k],
              f"(b) {k} launches: artifact {launches_b[k]}, fresh process "
              f"{child['launches'][k]}, live traced loop {live_launches[k]}")
    launches.update({k: launches_b[k] for k in ("K3", "K6", "K7", "SEG")})
    jtx = float(fresh.Jt_x.abs().max())
    g64 = grid_mrf.make_grid_mrf(*GRID, dtype=torch.float64, device=dev)
    r64 = optimize(with_residual(prob, g64), z.double(), bench)
    dp = float((fresh.p.double() - r64.p).abs().max())
    check(int(fresh.reason) > 0, "(b) the artifact's solve terminated")
    check(jtx <= 1e-3, f"(b) max|Jt_x| {jtx:.3e} <= 1e-3")
    check(dp <= 1e-3, f"(b) p within 1e-3 of float64: {dp:.3e}")
    print(f"[24 b grid {GRID} supernodal f32 PRM] reason "
          f"{int(fresh.reason)} step_count {int(fresh.step_count)} "
          f"n_attempts {int(fresh.n_attempts)}; max|Jt_x| {jtx:.3e} (<= "
          f"1e-3); max |p - p64| {dp:.3e} (<= 1e-3); K3/K6/K7 launches in "
          f"the artifact {launches_b} = the live traced loop's "
          f"{live_launches}", flush=True)
    export_turns("b", solver, lambda q: optimize(prob, q, bench),
                 lambda q: export.solve_traced(flat, q, bench,
                                               newton_solver=ns,
                                               batched=False), z, card,
                 K3_GROUPS)
    del exp, solver, loop, fresh, flat
    # the float64 decisions at 16x16x8: the artifact against the eager solve
    g16 = grid_mrf.make_grid_mrf(16, 16, 8, dtype=torch.float64, device=dev)
    prob16 = SparseProblem(f=g16.problem(jtj="dense").f,
                           structure=g16.structure, jtj="sparse",
                           ordering="rcm", amalgamate=16)
    z16 = torch.zeros(g16.nstate, dtype=torch.float64, device=dev)
    fresh16, _, _, _, _ = export_leg(
        "b grid 16x16x8 supernodal f64", prob16.products, g16.nstate, z16,
        bench, tmp, newton_solver=prob16.default_newton_solver())
    r16 = optimize(prob16, z16, bench)
    for field in decisions:
        check(int(getattr(fresh16, field)) == int(getattr(r16, field)),
              f"(b) f64 {field}: the artifact's is the eager solve's")
    dp16 = float((fresh16.p - r16.p).abs().max())
    check(torch.allclose(fresh16.p, r16.p, rtol=1e-9, atol=1e-12),
          f"(b) f64 p within rtol 1e-9 of the eager solve's: {dp16:.3e}")
    print(f"[24 b grid 16x16x8 f64 PRM] the artifact takes the eager "
          f"solve's decisions (step_count {int(r16.step_count)}, n_attempts "
          f"{int(r16.n_attempts)}, reason {int(r16.reason)}); max |dp| "
          f"{dp16:.3e} (rtol 1e-9)", flush=True)

    # (c) config 8's tanh family at Nstate 64: one instance, 512 starts
    nstate, batch = MIDSIZE[0]
    data, p0s, p_true = midsize_family(nstate, batch, torch.float32, dev)
    shared = tuple(t[0] for t in data)
    truth = p_true[0]
    starts = (torch.as_tensor(truth, dtype=torch.float32, device=dev)
              + (p0s - torch.as_tensor(p_true, dtype=torch.float32,
                                       device=dev)))

    def tanh_products(p):
        return midsize_products(p, shared)
    bns = BlockedDenseNewtonSolver()
    fresh, exp, solver, launches_c, child = export_leg(
        f"c tanh Nstate {nstate} B={batch}", tanh_products, nstate, starts,
        bench, tmp, newton_solver=bns, batch_size=batch)
    check(launches_c["K5"] > 0 and child["launches"]["K5"] > 0,
          "(c) the artifact launched K5")
    launches["K5"] = launches_c["K5"]
    rec = midsize_recovered(fresh.p, truth[None])
    check(bool((fresh.reason > 0).all()), "(c) every reason > 0")
    check(rec >= 0.99, f"(c) recovered_frac {rec} >= 0.99")
    eager = solve_products_batched(torch.func.vmap(tanh_products), starts,
                                   bench, newton_solver=bns)
    same = float((eager.step_count == fresh.step_count).double().mean())
    print(f"[24 c tanh Nstate {nstate} B={batch} f32 PRM] K5 launches in "
          f"the artifact {launches_c['K5']}; reasons "
          f"{torch.bincount(fresh.reason, minlength=7).tolist()}; "
          f"recovered_frac {rec:.4f} (>= 0.99); step_count agreement with "
          f"the eager masked loop {same:.4f}", flush=True)
    flat = export.flatten_products(tanh_products, starts)
    export_turns("c", solver, lambda q: solve_products_batched(
        torch.func.vmap(tanh_products), q, bench, newton_solver=bns),
                 lambda q: export.solve_traced(flat, q, bench,
                                               newton_solver=bns),
                 starts, card, MIDSIZE_GROUPS)
    # with the card hidden, the serving process raises: no fallback
    import os
    label = f"c tanh Nstate {nstate} B={batch}"
    art, start, out, info = (os.path.join(tmp, f"{label}.{x}") for x in
                             ("pt2", "p0.pt", "hidden.pt", "hidden.json"))
    hidden = subprocess.run([sys.executable, "-c", EXPORT_CHILD, art, start,
                             out, info], capture_output=True, text=True,
                            timeout=600,
                            env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    check(hidden.returncode != 0 and "no CUDA device" in hidden.stderr,
          f"(c) without a visible card the artifact raised: "
          f"{hidden.stderr[-500:]}")
    print(f"[24 c without a card] the serving process raised: "
          f"{hidden.stderr.strip().splitlines()[-1][:160]}", flush=True)
    return launches


# ---------------------------------------------------------------------------
# phase 25: the parallel layer (parallel/mesh.py, parallel/sharded.py, mesh=
# in the batched entry points, the distributed checkpoint)
# ---------------------------------------------------------------------------

P25_RANKS = 2
P25_LIMIT_S = 600.0      # the two ranks' wall limit; past it both are killed
P25_CKPT_BATCH = 2048    # the checkpointed batch (the masked driver)


def p25_same(a, b) -> bool:
    """The same dtype, shape and bits (NaN included)."""
    import torch
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype in (torch.float32, torch.float64):
        return same_bits(a.cpu(), b.cpu())
    return torch.equal(a.cpu(), b.cpu())


def p25_turns(fns, reps=3, timing=True) -> list:
    """CUDA-event ms a call of each fn, in turns a b b a (two readings
    each); "not measured" without timing (a CPU rehearsal)."""
    from libdogleg_tpu_torch.utils.benchtime import measure_ms
    if not timing:
        return [("not measured", "not measured") for _ in fns]
    order = list(range(len(fns))) + list(reversed(range(len(fns))))
    got = {i: [] for i in range(len(fns))}
    for i in order:
        got[i].append(measure_ms(fns[i], warmup=1, reps=reps))
    return [tuple(f"{v:.3f}" for v in got[i]) for i in range(len(fns))]


def p25_grid_problem(grid, dtype, dev):
    """Config 6's grid MRF as dense J rows: the model is linear, so x(p) =
    J p - target with J (nmeas, Nstate) constant; the stored lower JtJ
    pattern of its block structure."""
    import torch

    from libdogleg_tpu_torch.models import grid_mrf
    from libdogleg_tpu_torch.ops import bcsr
    g = grid_mrf.make_grid_mrf(*grid, dtype=dtype, device=dev)
    x0, J = g.problem(jtj="dense").full(torch.zeros(g.nstate, dtype=dtype,
                                                    device=dev))
    sched = bcsr.jtj_lower_schedule(g.structure)
    return g, J, -x0, sched


def p25_grid_f(p, data):
    J_rows, t_rows = data
    return J_rows @ p - t_rows, J_rows


def phase25_rank(rank, port, tmp, device, b3, grid, timing) -> int:
    """One of the two ranks of phase 25 (b), run in a process of its own
    by phase25_parallel on one gloo group whose tensors live on the card:
    the dp leg (config 3, K1 named and generated on this rank's half), the
    measurement-sharded sample problem in float64 with History, config 6's
    measurement-sharded sparse solve at full width (K6, K7), and the
    distributed checkpoint. Writes what it got to tmp/rank<r>.pt; any
    failed check raises, and the process exits non-zero."""
    import datetime
    import os

    import torch
    import torch.distributed as dist

    rank, port, b3 = int(rank), int(port), int(b3)
    grid = tuple(int(v) for v in grid.split("x"))
    timing = timing == "1"
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(0)
        torch.cuda.reset_peak_memory_stats()
        check(torch.backends.cuda.matmul.allow_tf32 is False,
              "rank: allow_tf32 is False")
    dist.init_process_group(
        "gloo", init_method=f"tcp://localhost:{port}", rank=rank,
        world_size=P25_RANKS, timeout=datetime.timedelta(seconds=60))
    from libdogleg_tpu_torch import (DoglegParameters, checkpoint, optimize,
                                     solve_products)
    from libdogleg_tpu_torch.models import quadratic_surface as qs
    from libdogleg_tpu_torch.ops import mega, segsum, tilechol
    from libdogleg_tpu_torch.parallel import (MeasurementShardedProblem,
                                              MeasurementShardedSparseProblem,
                                              batched_optimize, make_mesh)
    from libdogleg_tpu_torch.parallel import sharded
    from libdogleg_tpu_torch.parallel.batched import (local_blocks,
                                                      sharded_like)
    from libdogleg_tpu_torch.solver import (init_batched_state,
                                            result_from_batched_state,
                                            run_batched_solver)
    bench = DoglegParameters(**BENCH)
    t_start = time.perf_counter()
    mesh = make_mesh(("dp",), device_type=dev.type)
    check(mesh.size() == P25_RANKS and dist.get_backend() == "gloo",
          f"rank {rank}: a mesh of {mesh.size()} ranks over "
          f"{dist.get_backend()}")
    out = {"rank": rank}

    # dp leg: config 3, each rank its half, K1 named then generated
    p0, meas, gx, gy = instances(25, b3, torch.float32, dev)
    closure = config3_products(gx, gy)
    # on the card K1 takes these by itself; a CPU rehearsal forces its
    # plain versions
    kw, once = ({}, 1) if dev.type == "cuda" else ({"use_megakernel": True},
                                                   0)
    for label, fn, counter in (("named", qs.products, "launch_count"),
                               ("generated", closure, "auto_launch_count")):
        before = getattr(mega, counter)
        r = batched_optimize(fn, p0, bench, problem_data=meas, mesh=mesh,
                             **kw)
        out[f"{label} launches"] = getattr(mega, counter) - before
        check(out[f"{label} launches"] == once,
              f"rank {rank}: K1 {label} launched once: "
              f"{out[f'{label} launches']}")
        check(str(tuple(r.p.placements)) == "(Shard(dim=0),)",
              f"rank {rank}: {label} p sharded: {r.p.placements}")
        out[label] = {f: getattr(r, f).to_local().cpu() for f in
                      ("p", "step_count", "n_attempts", "reason")}
        dist.barrier()
        out[f"{label} turns"] = p25_turns(
            [lambda: float(batched_optimize(
                fn, p0, bench, problem_data=meas, mesh=mesh,
                **kw).norm2_x.to_local().sum()),
             lambda: float(batched_optimize(
                 fn, p0, bench, problem_data=meas, **kw).norm2_x.sum())],
            timing=timing)
        dist.barrier()

    # meas leg: the sample problem's 100 rows, 50 a rank, float64, History
    p1, m1, gx64, gy64 = instances(26, 1, torch.float64, dev)

    def f_rows(p, data):
        gx_s, gy_s, m_s = data
        return qs.model(p, gx_s, gy_s) - m_s, qs.jacobian(p, gx_s, gy_s)
    # the same two ranks as a measurement axis
    mmesh = make_mesh(("meas",), device_type=dev.type)
    prob = MeasurementShardedProblem(f=f_rows, data=(gx64, gy64, m1[0]),
                                     mesh=mmesh, axis_name="meas")
    sharded.reset_counts()
    r = optimize(prob, p1[0], bench, record_history=True)
    evals = int(r.n_attempts) + 1
    out["meas"] = {"p": r.p.cpu(), "step_count": int(r.step_count),
                   "n_attempts": int(r.n_attempts), "reason": int(r.reason),
                   "step_type": r.history.step_type.cpu(),
                   "calls": sharded.all_reduce_calls / evals,
                   "bytes": sharded.all_reduce_bytes / evals}

    # sparse leg: config 6 at full width, measurement-sharded, float32
    t0 = time.perf_counter()
    g, J, target, sched = p25_grid_problem(grid, torch.float32, dev)
    # this rank's rows as DTensors of the whole, sharded over the axis
    data = sharded_like(local_blocks((J, target), mmesh, "meas"), mmesh,
                        "meas")
    data = sharded_like(tuple(d.to_local().contiguous() for d in data),
                        mmesh, "meas")
    del J, target
    sp = MeasurementShardedSparseProblem(
        f=p25_grid_f, data=data, pattern_rows=sched.rows,
        pattern_cols=sched.cols, b=g.structure.block_cols, mesh=mmesh,
        axis_name="meas", ordering="rcm", amalgamate=16)
    setup_s = time.perf_counter() - t0
    ns = sp.newton_solver()
    z = torch.zeros(g.nstate, dtype=torch.float32, device=dev)
    for k in tilechol.launch_counts:
        tilechol.launch_counts[k] = 0
    segsum.launch_count = 0
    sharded.reset_counts()
    r = solve_products(sp.products, z, bench, newton_solver=ns)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    evals = int(r.n_attempts) + 1
    out["sparse"] = {
        "p": r.p.cpu(), "Jt_x": r.Jt_x.cpu(), "reason": int(r.reason),
        "step_count": int(r.step_count), "n_attempts": int(r.n_attempts),
        "K6": tilechol.launch_counts["tile_cholesky"],
        "K7": tilechol.launch_counts["tri_solve_right"],
        "SEG": segsum.launch_count,
        "calls": sharded.all_reduce_calls / evals,
        "bytes": sharded.all_reduce_bytes / evals,
        "rows": int(data[0].to_local().shape[0]),
        "blocks": len(sched.rows),
        "setup_s": setup_s}
    r2 = solve_products(sp.products, z, bench, newton_solver=ns)
    out["sparse"]["second run same bits"] = p25_same(r2.p, r.p)
    dist.barrier()
    out["sparse turns"] = p25_turns(
        [lambda: float(solve_products(sp.products, z, bench,
                                      newton_solver=ns).norm2_x)],
        reps=2, timing=timing)
    del sp, data
    dist.barrier()

    # the distributed checkpoint: a dp-sharded batched state (the masked
    # driver), two attempts, saved, loaded onto a fresh state, resumed
    pc, mc, _, _ = instances(27, P25_CKPT_BATCH, torch.float32, dev)
    pl, ml = local_blocks((pc, mc), mesh)
    vf = torch.func.vmap(qs.products)

    def fn(p):
        return vf(p, ml)
    st = run_batched_solver(fn, init_batched_state(fn, pl, bench), bench,
                            max_new_attempts=2)
    path = os.path.join(tmp, "ckpt")
    t0 = time.perf_counter()
    checkpoint.save_state_orbax(path, sharded_like(st, mesh))
    dist.barrier()
    loaded = checkpoint.load_state_orbax(path, sharded_like(
        init_batched_state(fn, pl, bench), mesh))
    ckpt_s = time.perf_counter() - t0
    resumed = result_from_batched_state(run_batched_solver(
        fn, local_blocks(loaded, mesh), bench))
    one = batched_optimize(qs.products, pc, bench, problem_data=mc,
                           mesh=mesh, use_megakernel=False)
    for f in ("p", "step_count", "n_attempts", "reason", "norm2_x"):
        check(p25_same(getattr(resumed, f), getattr(one, f).to_local()),
              f"rank {rank}: the resumed run's {f} has the one-shot run's "
              f"bits")
    out["ckpt"] = {"s": ckpt_s, "attempts": int(one.n_attempts.to_local()
                                                .max())}
    out["max_memory_allocated"] = (torch.cuda.max_memory_allocated()
                                   if dev.type == "cuda" else 0)
    out["seconds"] = time.perf_counter() - t_start
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()
    return 0


P25_CHILD = ("import sys, chip_smoke; "
             "sys.exit(chip_smoke.phase25_rank(*sys.argv[1:]))")


def phase25_parallel(dev, bench, card, b3=CONFIG3_BATCH, grid=GRID,
                     timing=True) -> dict:
    """The parallel layer on the card: (a) a world of one on NCCL, config
    3's batch through batched_optimize(mesh=) on K1 named and generated and
    batched_optimize_compacted(mesh=), each with the unsharded call's bits;
    (b) two ranks on the one card over gloo (phase25_rank), their results
    held here against the unsharded ones and each other. Returns the
    launches of K1 (by instance), K6 and K7 on these paths."""
    import os
    import socket
    import tempfile

    import torch
    import torch.distributed as dist

    from libdogleg_tpu_torch.models import quadratic_surface as qs
    from libdogleg_tpu_torch.ops import mega
    from libdogleg_tpu_torch.parallel import (batched_optimize,
                                              batched_optimize_compacted,
                                              make_mesh)
    t_phase = time.perf_counter()
    fields = ("p", "step_count", "n_attempts", "reason", "norm2_x")
    out = {"K1 named": {}, "K1 generated": {}, "paths": {}}

    # (a) a world of one
    check(not dist.is_initialized(), "no process group before phase 25")
    mesh = make_mesh(("dp",), device_type=dev.type)
    backend = dist.get_backend()
    check(backend == ("nccl" if dev.type == "cuda" else "gloo"),
          f"the world of one's backend: {backend}")
    p0, meas, gx, gy = instances(25, b3, torch.float32, dev)
    closure = config3_products(gx, gy)
    # on the card K1 takes these by itself; a CPU rehearsal forces its
    # plain versions
    kw, once = ({}, 1) if dev.type == "cuda" else ({"use_megakernel": True},
                                                   0)
    unsharded = {}
    rows = []
    for label, fn, counter in (("named", qs.products, "launch_count"),
                               ("generated", closure, "auto_launch_count")):
        u = batched_optimize(fn, p0, bench, problem_data=meas, **kw)
        unsharded[label] = u
        before = getattr(mega, counter)
        r = batched_optimize(fn, p0, bench, problem_data=meas, mesh=mesh,
                             **kw)
        n = getattr(mega, counter) - before
        check(n == once, f"(a) {label}: K1 launched once: {n}")
        check(str(tuple(r.p.placements)) == "(Shard(dim=0),)",
              f"(a) {label}: p a DTensor with Shard(0): {r.p.placements}")
        for f in fields:
            check(p25_same(getattr(r, f).to_local(), getattr(u, f)),
                  f"(a) {label}: {f} has the unsharded call's bits")
        before = getattr(mega, counter)
        rc = batched_optimize_compacted(fn, p0, bench, problem_data=meas,
                                        mesh=mesh, **kw)
        nc = getattr(mega, counter) - before
        check(nc == once, f"(a) {label} compacted: K1 launched once: {nc}")
        for f in fields:
            check(p25_same(getattr(rc, f).to_local(), getattr(u, f)),
                  f"(a) {label} compacted: {f} has the unsharded call's "
                  f"bits")
        out[f"K1 {label}"]["phase 25 (world of one)"] = n + nc
        turns = p25_turns(
            [lambda: float(batched_optimize(
                fn, p0, bench, problem_data=meas, mesh=mesh,
                **kw).norm2_x.to_local().sum()),
             lambda: float(batched_optimize(
                 fn, p0, bench, problem_data=meas, **kw).norm2_x.sum())],
            timing=timing)
        rows.append(f"{label}: K1 launches {n} (batched_optimize) + {nc} "
                    f"(compacted); ms a call, mesh {'/'.join(turns[0])}, "
                    f"unsharded {'/'.join(turns[1])}")
    print(f"[25 (a) world of one, {backend}, config 3 B={b3} f32 PRM] every "
          f"result field the unsharded call's bits, p a DTensor with "
          f"Shard(0); {'; '.join(rows)}; card {card}", flush=True)
    dist.destroy_process_group()

    # (b) two ranks on the one card over gloo; the float64 references first
    from libdogleg_tpu_torch import SparseProblem, optimize
    from libdogleg_tpu_torch.models import grid_mrf
    p1, m1, _, _ = instances(26, 1, torch.float64, dev)
    ref_meas = optimize(qs.make_dense_problem(m1[0]), p1[0], bench,
                        record_history=True)
    g64 = grid_mrf.make_grid_mrf(*grid, dtype=torch.float64, device=dev)
    prob64 = SparseProblem(f=g64.problem(jtj="dense").f,
                           structure=g64.structure, jtj="sparse",
                           ordering="rcm", amalgamate=16)
    p64 = optimize(prob64, torch.zeros(g64.nstate, dtype=torch.float64,
                                       device=dev)).p
    del prob64, g64
    tmp = tempfile.mkdtemp(prefix="dogleg_mesh_")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    logs = [open(os.path.join(tmp, f"rank{r}.log"), "w+")
            for r in range(P25_RANKS)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-c", P25_CHILD, str(r), str(port), tmp, dev.type,
         str(b3), "x".join(map(str, grid)), "1" if timing else "0"],
        stdout=logs[r], stderr=subprocess.STDOUT)
        for r in range(P25_RANKS)]
    hung = False
    for p in procs:
        try:
            p.wait(timeout=max(P25_LIMIT_S - (time.perf_counter() - t0),
                               0.01))
        except subprocess.TimeoutExpired:
            hung = True
            break
    if hung:
        for p in procs:
            p.kill()
        for p in procs:
            p.wait()
    wall = time.perf_counter() - t0
    texts = []
    for log in logs:
        log.seek(0)
        texts.append(log.read())
        log.close()
    check(not hung, f"(b) the two ranks ended within {P25_LIMIT_S} s")
    for r, p in enumerate(procs):
        check(p.returncode == 0, f"(b) rank {r} exited {p.returncode}:\n"
              f"{texts[r][-3000:]}")
    got = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
           for r in range(P25_RANKS)]
    half = b3 // P25_RANKS

    # dp leg: each rank's half has the unsharded call's bits
    rows = []
    for label in ("named", "generated"):
        u = unsharded[label]
        for r, o in enumerate(got):
            for f in ("p", "step_count", "n_attempts", "reason"):
                check(p25_same(o[label][f],
                               getattr(u, f)[r * half:(r + 1) * half].cpu()),
                      f"(b) rank {r} {label}: {f} has the unsharded call's "
                      f"bits")
        out[f"K1 {label}"]["phase 25 (two ranks)"] = sum(
            o[f"{label} launches"] for o in got)
        rows.append(f"{label}: K1 launches {[o[f'{label} launches'] for o in got]}"
                    f"; ms a call by rank, mesh / unsharded "
                    + "; ".join(f"{'/'.join(o[f'{label} turns'][0])} / "
                                f"{'/'.join(o[f'{label} turns'][1])}"
                                for o in got))
    print(f"[25 (b) two ranks, gloo, dp leg, config 3 B={b3} ({half} a "
          f"rank) f32 PRM] each element the unsharded call's bits; "
          f"{'; '.join(rows)}; card {card}", flush=True)

    # meas leg: the unsharded solve's decisions and step types, both ranks
    # the same bits
    for r, o in enumerate(got):
        m = o["meas"]
        for f in ("step_count", "n_attempts", "reason"):
            check(m[f] == int(getattr(ref_meas, f)),
                  f"(b) rank {r} meas: {f} {m[f]} the unsharded solve's")
        check(torch.equal(m["step_type"], ref_meas.history.step_type.cpu()),
              f"(b) rank {r} meas: History step types the unsharded "
              f"solve's")
        check(p25_same(m["p"], got[0]["meas"]["p"]),
              f"(b) rank {r} meas: p rank 0's bits")
    dp_meas = float((got[0]["meas"]["p"] - ref_meas.p.cpu()).abs().max())
    m = got[0]["meas"]
    print(f"[25 (b) meas leg, sample problem f64, 50 rows a rank, History] "
          f"step_count {m['step_count']} n_attempts {m['n_attempts']} "
          f"reason {m['reason']} and the History's step types the unsharded "
          f"solve's; max |dp| {dp_meas:.3e}; both ranks the same bits; "
          f"all_reduce calls {m['calls']:.2f} and bytes {m['bytes']:.0f} "
          f"an evaluation", flush=True)

    # sparse leg: metric 2's gate, both ranks the same bits
    s0 = got[0]["sparse"]
    jtx = float(s0["Jt_x"].abs().max())
    dp = float((s0["p"].double() - p64.cpu()).abs().max())
    check(s0["reason"] > 0 and bool(torch.isfinite(s0["p"]).all()),
          f"(b) sparse: reason {s0['reason']}, finite p")
    check(jtx <= 1e-3, f"(b) sparse: max|Jt_x| {jtx:.3e} <= 1e-3")
    check(dp <= 1e-3, f"(b) sparse: p within 1e-3 of float64: {dp:.3e}")
    for r, o in enumerate(got):
        s = o["sparse"]
        check(p25_same(s["p"], s0["p"]) and p25_same(s["Jt_x"], s0["Jt_x"]),
              f"(b) rank {r} sparse: p and Jt_x rank 0's bits")
        check(s["second run same bits"],
              f"(b) rank {r} sparse: a second solve the same bits")
        check((s["K6"] > 0 and s["K7"] > 0 and s["SEG"] > 0)
              == (dev.type == "cuda"),
              f"(b) rank {r} sparse: K6, K7 and the segment add launched: "
              f"{s['K6']}, {s['K7']}, {s['SEG']}")
    out["paths"]["phase 25 (two ranks, meas-sharded sparse)"] = {
        k: sum(o["sparse"][k] for o in got) for k in ("K6", "K7", "SEG")}
    print(f"[25 (b) sparse leg, grid-mrf-{'x'.join(map(str, grid))} f32 "
          f"PRM, rcm amalgamate 16, {s0['rows']} J rows a rank, "
          f"{s0['blocks']} stored lower blocks] reason {s0['reason']} "
          f"step_count {s0['step_count']} n_attempts {s0['n_attempts']}; "
          f"max|Jt_x| {jtx:.3e} (<= 1e-3); max |p32 - p64| {dp:.3e} (<= "
          f"1e-3); both ranks the same bits, and a second solve; launches "
          f"a rank K6 {s0['K6']}, K7 {s0['K7']}, segment add {s0['SEG']}; "
          f"all_reduce calls "
          f"{s0['calls']:.2f} and bytes {s0['bytes']:.0f} an evaluation; "
          f"set-up {s0['setup_s']:.1f} s; ms a solve by rank "
          f"{'; '.join('/'.join(o['sparse turns'][0]) for o in got)}; card "
          f"{card}", flush=True)
    print(f"[25 (b) checkpoint] a dp-sharded batched state of "
          f"{P25_CKPT_BATCH} (the masked driver) after two attempts, saved "
          f"and loaded through torch.distributed.checkpoint in "
          f"{got[0]['ckpt']['s']:.2f} s, resumed: the one-shot run's bits "
          f"on both ranks (attempts up to {got[0]['ckpt']['attempts']})",
          flush=True)
    print(f"[25 (b) ranks] wall {wall:.1f} s for the two processes; "
          f"seconds by rank {[round(o['seconds'], 1) for o in got]}; "
          f"max_memory_allocated GiB by rank "
          f"{[round(o['max_memory_allocated'] / 2 ** 30, 2) for o in got]}",
          flush=True)
    peak = (torch.cuda.max_memory_allocated() / 2 ** 30
            if dev.type == "cuda" else 0.0)
    print(f"[25 seconds] {time.perf_counter() - t_phase:.1f}; this "
          f"process's max_memory_allocated {peak:.2f} GiB; card {card}",
          flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 26: point-parallel bundle adjustment (BAProblem.shard and
# shard_p_tree, the point-sharded tree Schur strategies)
# ---------------------------------------------------------------------------

P26_RANKS = 2
P26_LIMIT_S = 600.0      # the two ranks' wall limit; past it both are killed
P26_LABELS = ("config 4 tree", "config 7s", "config 7s refine_iters=2 "
              "cam_gather")


def p26_cases(dev, linear, sparse):
    """Phase 18's configurations 4 (tree form) and 7s (plain, and with
    refine_iters=2 and a cam_gather) in float32 on `dev`: label -> (the
    unsharded (products, p0, strategy), a function of a mesh giving the
    point-sharded ones, the gate, its text)."""
    import dataclasses

    import torch

    from libdogleg_tpu_torch.models import bundle_adjustment as lba
    from libdogleg_tpu_torch.models import pinhole_ba as pba
    from libdogleg_tpu_torch.ops.newton import build_cam_gather
    from libdogleg_tpu_torch.parallel.batched import shard_batch
    from libdogleg_tpu_torch.parallel.points import replicate
    ba = lba.make_synthetic(dtype=torch.float32, device=dev, **linear)

    def config4(mesh):
        ba_s = ba.shard(mesh)
        return (ba_s.products_tree, ba.shard_p_tree(ba.p0_tree(), mesh),
                ba_s.tree_newton_solver())
    sp = pba.make_synthetic_sparse(dtype=torch.float32, device=dev, **sparse)
    p0 = sp.p0(torch.Generator(device=dev).manual_seed(2), jitter=0.02)
    ns = sp.newton_solver()
    names = ("cam_of", "obs", "pts_prior")

    def config7s(refine):
        def on(mesh):
            sp_s = dataclasses.replace(sp, **dict(zip(names, shard_batch(
                tuple(getattr(sp, n) for n in names), mesh, "pts"))))
            s = (dataclasses.replace(ns, refine_iters=2,
                                     cam_gather=build_cam_gather(
                                         sp_s.cam_of, sp.ncam))
                 if refine else ns)
            return (sp_s.products, {"c": replicate(p0["c"], mesh),
                                    "q": shard_batch(p0["q"], mesh, "pts")},
                    s)
        return on
    ns_r = dataclasses.replace(ns, refine_iters=2,
                               cam_gather=build_cam_gather(sp.cam_of,
                                                           sp.ncam))
    nobs = sp.nobs
    gate7 = (lambda r: int(r.reason) > 0 and float(r.norm2_x) < 2 * nobs,
             "reason > 0, norm2_x < 2 nobs")
    return {
        P26_LABELS[0]: ((ba.products_tree, ba.p0_tree(),
                         ba.tree_newton_solver()), config4,
                        lambda r: float(r.norm2_x) < 1e-3, "norm2_x < 1e-3"),
        P26_LABELS[1]: ((sp.products, p0, ns), config7s(False)) + gate7,
        P26_LABELS[2]: ((sp.products, p0, ns_r), config7s(True)) + gate7}


def p26_solve(dev, bench, products, p0, ns) -> tuple:
    """(result, a record of the solve: host wall s, attempts, all_reduce
    calls and bytes of the sharded layer, peak memory and the part of it
    above what was allocated at the call) of one solve, its host wall
    ended by a synchronize."""
    import torch

    from libdogleg_tpu_torch import solve_products
    from libdogleg_tpu_torch.parallel import sharded
    base = None
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    sharded.reset_counts()
    t0 = time.perf_counter()
    r = solve_products(products, p0, bench, newton_solver=ns)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return r, {"wall_s": wall, "attempts": int(r.n_attempts),
               "calls": sharded.all_reduce_calls,
               "bytes": sharded.all_reduce_bytes,
               "peak": (torch.cuda.max_memory_allocated()
                        if dev.type == "cuda" else None), "base": base}


def p26_collective_us(dev, mesh, reps: int = 200) -> str:
    """Host microseconds a call of all_reduce_sum on the "pts" axis, for
    one value and for config 7s's S with its ok (768^2 + 1 values), over
    `reps` calls ended by one synchronize."""
    import torch

    from libdogleg_tpu_torch.parallel.sharded import all_reduce_sum
    out = []
    for n in (1, 768 * 768 + 1):
        x = torch.ones(n, dtype=torch.float32, device=dev)
        all_reduce_sum([x], mesh, "pts")
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            all_reduce_sum([x], mesh, "pts")
        if dev.type == "cuda":
            torch.cuda.synchronize()
        out.append(f"{n} values {(time.perf_counter() - t0) / reps * 1e6:.1f}")
    return ", ".join(out)


def p26_local(r) -> dict:
    """A point-sharded result's fields as this rank holds them, on the
    host: c, Jt_x's c and the decisions replicated, q the rank's block."""
    from libdogleg_tpu_torch.parallel.points import local_of
    out = {f"p/{k}": local_of(v).cpu() for k, v in r.p.items()}
    out.update({f"Jt_x/{k}": local_of(v).cpu() for k, v in r.Jt_x.items()})
    out.update({f: getattr(r, f).cpu() for f in
                ("norm2_x", "step_count", "n_attempts", "reason",
                 "trustregion", "lam")})
    out.update({f"JtJ/{k}": v.cpu() for k, v in r.JtJ._asdict().items()})
    return out


def p26_text(rec) -> str:
    a = max(rec["attempts"], 1)
    first = (f"first {rec['first_wall_s'] * 1e3:.1f} ms, "
             if "first_wall_s" in rec else "")
    return (f"wall {first}{rec['wall_s'] * 1e3:.1f} ms, attempts "
            f"{rec['attempts']}"
            f", all_reduce calls {rec['calls']} ({rec['calls'] / a:.2f} an "
            f"attempt), bytes {rec['bytes']} ({rec['bytes'] / a:.0f} an "
            f"attempt), peak memory {peak_text(rec)}")


def peak_text(rec) -> str:
    """A solve's peak device memory and the part above what was allocated
    at its call (earlier phases' tensors still held)."""
    if rec["peak"] is None:
        return "not measured"
    return (f"{gib(rec['peak'])} ({gib(rec['peak'] - rec['base'])} above "
            f"the call's start)")


def gib(nbytes) -> str:
    return ("not measured" if nbytes is None
            else f"{nbytes / 2 ** 30:.3f} GiB")


def phase26_rank(rank, port, tmp, device, linear, sparse) -> int:
    """One of the two ranks of phase 26 (b), a process of its own on one
    gloo group whose tensors live on the card: the three point-sharded
    solves on this rank's half of the points. Writes tmp/rank<r>.pt."""
    import datetime
    import os

    import torch
    import torch.distributed as dist

    rank, port = int(rank), int(port)
    linear, sparse = json.loads(linear), json.loads(sparse)
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group(
        "gloo", init_method=f"tcp://localhost:{port}", rank=rank,
        world_size=P26_RANKS, timeout=datetime.timedelta(seconds=60))
    from libdogleg_tpu_torch import DoglegParameters
    from libdogleg_tpu_torch.parallel import make_mesh
    bench = DoglegParameters(**BENCH)
    t_start = time.perf_counter()
    mesh = make_mesh(("pts",), device_type=dev.type)
    check(mesh.size() == P26_RANKS and dist.get_backend() == "gloo",
          f"rank {rank}: a mesh of {mesh.size()} ranks over "
          f"{dist.get_backend()}")
    out = {"rank": rank}
    for label, (_, sharded, gate, gate_text) in p26_cases(
            dev, linear, sparse).items():
        runs = []
        for _ in range(2):
            dist.barrier()
            runs.append(p26_solve(dev, bench, *sharded(mesh)))
        r, rec = runs[1]
        check(gate(r), f"(b) rank {rank} {label}: gate {gate_text}: norm2_x "
              f"{float(r.norm2_x):.6g}, reason {int(r.reason)}")
        check(str(tuple(r.p["q"].placements)) == "(Shard(dim=0),)",
              f"(b) rank {rank} {label}: q sharded over pts")
        first, second = (p26_local(x) for x, _ in runs)
        check(all(p25_same(first[k], second[k]) for k in first),
              f"(b) rank {rank} {label}: a second solve the same bits")
        out[label] = {"fields": second, "first_wall_s": runs[0][1]["wall_s"],
                      **rec}
    out["seconds"] = time.perf_counter() - t_start
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()
    return 0


P26_CHILD = ("import sys, chip_smoke; "
             "sys.exit(chip_smoke.phase26_rank(*sys.argv[1:]))")


def phase26_points(dev, bench, card, linear=BA_LINEAR,
                   sparse=BA_SPARSE) -> None:
    """Point-parallel bundle adjustment on the card: configs 4 (tree form)
    and 7s (plain and refined) with their points sharded over a "pts"
    axis, (a) a world of one on NCCL, every result field the unsharded
    solve's bits, and (b) two ranks sharing the card over gloo
    (phase26_rank), their c and decisions the same bits, their q blocks
    put together beside the unsharded solve."""
    import os
    import socket
    import tempfile

    import torch
    import torch.distributed as dist

    from libdogleg_tpu_torch.parallel import make_mesh
    t_phase = time.perf_counter()
    cases = p26_cases(dev, linear, sparse)

    # (a) a world of one
    check(not dist.is_initialized(), "no process group before phase 26")
    mesh = make_mesh(("pts",), device_type=dev.type)
    backend = dist.get_backend()
    check(backend == ("nccl" if dev.type == "cuda" else "gloo"),
          f"the world of one's backend: {backend}")
    unsharded = {}
    for label, (whole, sharded, gate, gate_text) in cases.items():
        before = kernel_launch_counts()
        # in turns: unsharded, sharded, sharded, unsharded
        runs = [p26_solve(dev, bench, *(sharded(mesh) if k in (1, 2)
                                         else whole)) for k in range(4)]
        check(kernel_launch_counts() == before,
              f"(a) {label}: the path launches none of K1-K7")
        want = p26_local(runs[0][0])
        for k, (r, _) in enumerate(runs[1:], 1):
            got = p26_local(r)
            for f in want:
                check(p25_same(got[f], want[f]), f"(a) {label}: run {k}'s {f} "
                      f"has the first unsharded solve's bits")
        r = runs[1][0]
        check(gate(r), f"(a) {label}: gate {gate_text}")
        check(str(tuple(r.p["q"].placements)) == "(Shard(dim=0),)"
              and str(tuple(r.p["c"].placements)) == "(Replicate(),)",
              f"(a) {label}: q sharded over pts, c replicated")
        unsharded[label] = want
        walls = [f"{rec['wall_s'] * 1e3:.1f}" for _, rec in runs]
        print(f"[26 (a) world of one, {backend}, {label}, f32 PRM] gate "
              f"{gate_text}: norm2_x {float(r.norm2_x):.6g}, reason "
              f"{int(r.reason)}, steps {int(r.step_count)}; every result "
              f"field of both sharded solves and the second unsharded one "
              f"the first unsharded solve's bits; host wall ms in turns "
              f"unsharded {walls[0]}, sharded {walls[1]}, {walls[2]}, "
              f"unsharded {walls[3]}; sharded: {p26_text(runs[2][1])}; "
              f"unsharded peak memory {peak_text(runs[3][1])}; card "
              f"{card}",
              flush=True)
        if dev.type == "cuda" and label == P26_LABELS[1]:
            from libdogleg_tpu_torch import solve_products
            fn, p0, ns = sharded(mesh)
            split = device_split(
                lambda: solve_products(fn, p0, bench, newton_solver=ns),
                groups=BA_GROUPS + (("nccl", ("nccl",)),))
            print(f"[26 (a) {label} profile, sharded] {split}", flush=True)
    print(f"[26 (a) all_reduce_sum alone, {backend}] host us a call, "
          f"{p26_collective_us(dev, mesh)}; card {card}", flush=True)
    dist.destroy_process_group()
    del cases

    # (b) two ranks on the one card over gloo
    tmp = tempfile.mkdtemp(prefix="dogleg_pts_")
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    logs = [open(os.path.join(tmp, f"rank{r}.log"), "w+")
            for r in range(P26_RANKS)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-c", P26_CHILD, str(r), str(port), tmp, dev.type,
         json.dumps(linear), json.dumps(sparse)],
        stdout=logs[r], stderr=subprocess.STDOUT)
        for r in range(P26_RANKS)]
    hung = False
    for p in procs:
        try:
            p.wait(timeout=max(P26_LIMIT_S - (time.perf_counter() - t0),
                               0.01))
        except subprocess.TimeoutExpired:
            hung = True
            break
    if hung:
        for p in procs:
            p.kill()
        for p in procs:
            p.wait()
    wall = time.perf_counter() - t0
    texts = []
    for log in logs:
        log.seek(0)
        texts.append(log.read())
        log.close()
    check(not hung, f"(b) the two ranks ended within {P26_LIMIT_S} s")
    for r, p in enumerate(procs):
        check(p.returncode == 0, f"(b) rank {r} exited {p.returncode}:\n"
              f"{texts[r][-3000:]}")
    got = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
           for r in range(P26_RANKS)]
    replicated = ("p/c", "Jt_x/c", "norm2_x", "step_count", "n_attempts",
                  "reason", "trustregion", "lam", "JtJ/U")
    for label in P26_LABELS:
        f0 = got[0][label]["fields"]
        for r, o in enumerate(got[1:], 1):
            for k in replicated:
                check(p25_same(o[label]["fields"][k], f0[k]),
                      f"(b) {label}: rank {r}'s {k} has rank 0's bits")
        u = unsharded[label]
        q = torch.cat([o[label]["fields"]["p/q"] for o in got])
        dq = float((q.double() - u["p/q"].double()).abs().max())
        dc = float((f0["p/c"].double() - u["p/c"].double()).abs().max())
        npts = q.shape[0]
        print(f"[26 (b) two ranks, gloo, {label}, {npts // P26_RANKS} points "
              f"a rank, f32 PRM] both ranks pass the gate and hold the same "
              f"bits of c, U and every decision field; steps "
              f"{int(f0['step_count'])} reason {int(f0['reason'])} attempts "
              f"{int(f0['n_attempts'])} norm2_x {float(f0['norm2_x']):.6g} "
              f"(unsharded: steps {int(u['step_count'])} reason "
              f"{int(u['reason'])} attempts {int(u['n_attempts'])} norm2_x "
              f"{float(u['norm2_x']):.6g}); the q blocks put together: "
              f"{npts} points, max |dq| {dq:.3e}, max |dc| {dc:.3e} from the "
              f"unsharded solve; a second solve the same bits on each rank; "
              f"by rank: "
              f"{'; '.join(p26_text(o[label]) for o in got)}; card {card}",
              flush=True)
    print(f"[26 (b) ranks] wall {wall:.1f} s for the two processes; seconds "
          f"by rank {[round(o['seconds'], 1) for o in got]}", flush=True)
    print(f"[26 seconds] {time.perf_counter() - t_phase:.1f}; card {card}",
          flush=True)


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
    paths = {"phase 8 (config 6 dense)": {"SEG": k2["seg_launches"]},
             "phase 12 (config 6)": {
                 "K3": sparse["launches"]["bcsr_jtj_blocks_kernel"],
                 "K6": sparse["launches"]["tile_cholesky"],
                 "K7": sparse["launches"]["tri_solve_right"],
                 "SEG": sparse["launches"]["segment_add"]}}
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
    k1a = timed("23", phase23_mega_auto, dev, bench, card)
    p24 = timed("24", phase24_export, dev, bench, card)
    p25 = timed("25", phase25_parallel, dev, bench, card)
    timed("26", phase26_points, dev, bench, card)
    print(f"[all seconds] {time.perf_counter() - started:.1f}", flush=True)
    paths.update({f"phase 22 ({k})": v for k, v in p22["paths"].items()})
    paths["phase 24 (export)"] = {k: p24[k] for k in ("K3", "K6", "K7",
                                                      "SEG")}
    paths.update(p25["paths"])
    # K1 by instance: the public call of phase 4 (named) or 23 (generated)
    # and the mesh paths of phase 25
    k1_named = {"launches_by_path": {"phase 4 (public call)": launches,
                                     **p25["K1 named"]}}
    k1_named["launches"] = sum(k1_named["launches_by_path"].values())
    k1a["launches_by_path"] = {"phase 23 (config 3's call)": k1a["launches"],
                               **p25["K1 generated"]}
    k1a["launches"] = sum(k1a["launches_by_path"].values())
    k5["launches_by_path"] = {"phase 15 (config 8)": mid["launches"],
                              "phase 24 (export)": p24["K5"]}
    k5["launches"] = sum(k5["launches_by_path"].values())
    # K3, K6 and K7 run on several paths: each path's count, read with the
    # counts set to 0 just before it, and their sum
    for key, d in (("K3", k34["K3"]), ("K6", tiles["K6"]),
                   ("K7", tiles["K7"]), ("SEG", p22["SEG"])):
        d["launches_by_path"] = {path: c[key] for path, c in paths.items()
                                 if key in c}
        d["launches"] = sum(d["launches_by_path"].values())

    def entry(name, source, replaces, d):
        out = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "launches": d["launches"],
               "max_abs_err": d["max_abs_err"], "ms": d["ms"],
               "plain_ms": d["plain_ms"], "bound_ms": d["bound_ms"],
               "bound_by": d["bound_by"], "library_ms": d["library_ms"]}
        for extra in ("launches_by_path", "readings"):
            if extra in d:
                out[extra] = d[extra]
        return out
    print(json.dumps({"kernels": [
        entry("megakernel_optimize", "libdogleg_tpu_torch/csrc/mega.cu",
              "libdogleg_tpu/ops/pallas_mega.py:522",
              dict(max_abs_err=max_abs_err, ms=ms, plain_ms=plain_ms,
                   library_ms=None, **k1_named, **k1_bound)),
        entry("megakernel_optimize_factored",
              "libdogleg_tpu_torch/csrc/mega.cu",
              "libdogleg_tpu/ops/pallas_mega.py:522", k1f),
        entry("megakernel_optimize_generated",
              "libdogleg_tpu_torch/csrc/dogleg_auto.cuh",
              "libdogleg_tpu/ops/pallas_mega.py:522", k1a),
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
              "libdogleg_tpu/ops/pallas_chol.py:113", tiles["K7"]),
        # no Pallas kernel: the XLA scatter-add of the sparse UPDATE
        entry("segment_add", "libdogleg_tpu_torch/csrc/segsum.cu",
              "libdogleg_tpu/sparse_cholesky.py:495", p22["SEG"])]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
