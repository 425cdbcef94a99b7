#!/usr/bin/env python3
"""Config 6's block-sparse solves beside the same solves in another tree of
the repository (a parent commit), on one GPU: the 32x32x8 grid MRF (Nstate
8192) in float32 from 0 under PRM, the model's default problem (mindeg,
simplicial) and config 6's headline leg (rcm, amalgamate=16), and the
products call alone, which forms the lower JtJ blocks.

Run from the repository root on a machine with a CUDA card and nvcc, with
the other tree unpacked into an ignored directory first:

    mkdir -p _smoke_tree/parent
    git archive <commit> | tar -x -C _smoke_tree/parent
    python3 artifacts/exp_torch_sparse_parent.py _smoke_tree/parent

It runs itself with `--measure` in each tree (each builds its own
libraries) in the order other, this, this, other. A run prints, for each
leg:
  - the host wall of one whole solve (time.perf_counter to a synchronized
    end), seven solves after one to warm up: the least, the median and the
    most;
  - the solve and the products call by CUDA events (five readings, each
    over 5 solves or 20 products calls back to back): the least, the median
    and the most;
  - K3's launches in one solve where the tree's wrapper counts them;
and the card's name and power limit. It fails if a solve misses config
6's gate (reason > 0, max|Jt_x| <= 1e-3).
"""

from __future__ import annotations

import os
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
GRID = (32, 32, 8)
PRM = dict(max_iterations=10, Jt_x_threshold=1e-3, update_threshold=1e-5,
           trustregion_threshold=1e-5)


def spread(xs) -> str:
    xs = sorted(xs)
    return (f"{xs[0]:.3f} ms (median {xs[len(xs) // 2]:.3f}, most "
            f"{xs[-1]:.3f})")


def measure() -> None:
    import torch

    from libdogleg_tpu_torch import DoglegParameters, SparseProblem, optimize
    from libdogleg_tpu_torch.models import grid_mrf
    from libdogleg_tpu_torch.ops import bcsr_kernels as tk
    from libdogleg_tpu_torch.utils.benchtime import measure_ms
    dev = torch.device("cuda")
    prm = DoglegParameters(**PRM)
    g = grid_mrf.make_grid_mrf(*GRID, dtype=torch.float32, device=dev)
    probs = {"simplicial": g.problem(),
             "supernodal": SparseProblem(
                 f=g.problem(jtj="dense").f, structure=g.structure,
                 jtj="sparse", ordering="rcm", amalgamate=16)}
    p0 = torch.zeros(g.nstate, dtype=torch.float32, device=dev)
    for name, prob in probs.items():
        before = tk.launch_counts.get("bcsr_jtj_blocks_kernel", 0)
        r = optimize(prob, p0, prm)
        torch.cuda.synchronize()
        k3 = tk.launch_counts.get("bcsr_jtj_blocks_kernel", 0) - before
        jtx = float(r.Jt_x.abs().max())
        if int(r.reason) <= 0 or not jtx <= 1e-3:
            raise SystemExit(f"{name}: reason {int(r.reason)}, max|Jt_x| "
                             f"{jtx:.3e}")
        walls = []
        for _ in range(7):
            t0 = time.perf_counter()
            optimize(prob, p0, prm)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        solve = [measure_ms(optimize, prob, p0, prm, warmup=1, reps=5)
                 for _ in range(5)]
        prods = [measure_ms(prob.products, p0, warmup=3, reps=20)
                 for _ in range(5)]
        print(f"[{name}] step_count {int(r.step_count)} reason "
              f"{int(r.reason)} max|Jt_x| {jtx:.3e}; host wall a solve "
              f"{spread(walls)}; by events a solve {spread(solve)}, the "
              f"products call {spread(prods)}; K3 launches a solve {k3}",
              flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(f"[card] {card.stdout.strip()}", flush=True)


def run_in(tree: pathlib.Path, *args) -> list:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, str(pathlib.Path(__file__).resolve()), *args],
        cwd=tree, capture_output=True, text=True, timeout=600,
        env={**env, "PYTHONPATH": str(tree)})
    if out.returncode:
        print(out.stdout + out.stderr, flush=True)
        raise SystemExit(1)
    return out.stdout.splitlines()


def main() -> int:
    if sys.argv[1:2] == ["--measure"]:
        measure()
        return 0
    other = pathlib.Path(sys.argv[1]).resolve()
    for name, tree in (("other", other), ("this", ROOT), ("this", ROOT),
                       ("other", other)):
        for line in run_in(tree, "--measure"):
            print(f"[{name}] {line}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
