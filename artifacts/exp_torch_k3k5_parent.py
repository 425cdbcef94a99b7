#!/usr/bin/env python3
"""Kernels K3 and K5 beside the same kernels in another tree of the
repository (a parent commit), on one GPU, with K6 and K2, which share K5's
factorization header: the results' bits, the kernels' times alone and with
their wrappers, and the wrappers' host cost.

Run from the repository root on a machine with a CUDA card and nvcc, with
the other tree unpacked into an ignored directory first:

    mkdir -p _smoke_tree/parent
    git archive <commit> | tar -x -C _smoke_tree/parent
    python3 artifacts/exp_torch_k3k5_parent.py _smoke_tree/parent

It runs itself with `--measure` in each tree (each builds its own library
and prints ptxas's registers and spills of K3's, K5's, K6's and K2's
kernels) in the order other, this, this, other. A run prints:
  - SHA-256 digests of K3's blocks (k3_digest) and of K5's factors
    (k5_digest), float32 and float64, both functions taken from this tree's
    tests/test_torch_cuda.py and run on the run's own kernels;
  - each kernel alone (torch.profiler, 20 launches), float32: K3 on the
    32x32x8 grid model's dense-coupling Jacobian, K5 at (256, 128, 128)
    and (512, 64, 64), K6 at (21, 128, 128), K2's factor kernel at p = 256;
    and K3 and K5 with their wrappers (CUDA events over 20 calls, five
    readings: the least, the median and the most);
  - the host's time per call of K3's and K5's wrappers (time.perf_counter
    over calls issued back to back, fewer than fill the launch queue).
The script fails unless every run prints the same digests.
"""

from __future__ import annotations

import hashlib
import importlib.util
import os
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
K5_SHAPES = ((256, 128), (512, 64))


def test_module():
    """This tree's tests/test_torch_cuda.py, for k3_digest and k5_digest."""
    spec = importlib.util.spec_from_file_location(
        "card_tests", ROOT / "tests" / "test_torch_cuda.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def host_us(fn, reps: int) -> float:
    """Host time per call of fn over `reps` calls issued back to back."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return us


def wrapper_ms(fn, *args) -> str:
    """Five CUDA-event readings of fn with its wrapper, each over 20 calls
    back to back, in ms a call: the least, the median and the most."""
    from libdogleg_tpu_torch.utils.benchtime import measure_ms
    ms = sorted(measure_ms(fn, *args, warmup=3, reps=20) for _ in range(5))
    return f"{ms[0]:.4f} ms (median {ms[2]:.4f}, most {ms[-1]:.4f})"


def measure() -> None:
    import torch

    import chip_smoke as c
    from libdogleg_tpu_torch.native import loader
    from libdogleg_tpu_torch.ops import batchchol
    from libdogleg_tpu_torch.ops import bcsr_kernels as tk
    from libdogleg_tpu_torch.ops import panelchol, tilechol
    dev = torch.device("cuda")
    tests = test_module()
    info = loader.build()
    loader.load_library()
    entry = ""
    for line in info.log.splitlines():
        if "entry function" in line:
            entry = line.split("'")[1] if "'" in line else line
        elif ("registers" in line or "spill" in line) and any(
                k in entry for k in ("jtj", "batchchol", "tilechol",
                                     "panelchol")):
            print(f"[ptxas] {entry}: {line.strip()}", flush=True)
    for dt in (torch.float32, torch.float64):
        name = str(dt).split(".")[-1]
        print(f"[digest {name}] k3 {tests.k3_digest(dt, dev)} k5 "
              f"{tests.k5_digest(dt, dev)}", flush=True)
    J = c.grid_jacobian(torch.float32, dev)[0]
    sched = tk.build_jtj_schedule(J.structure)
    ms = wrapper_ms(tk.bcsr_jtj_blocks_kernel, J, sched)
    alone = c.kernel_us(tk.bcsr_jtj_blocks_kernel, (J, sched), "jtj")
    host = host_us(lambda: tk.bcsr_jtj_blocks_kernel(J, sched), 3000)
    print(f"[k3 grid f32] with its wrapper {ms}, alone "
          f"{c.us_text(alone)}, the wrapper's host time {host:.2f} us a "
          f"call (3000 calls)", flush=True)
    for k, n in K5_SHAPES:
        S = c.spd_tiles(n, k, n + k, torch.float32, dev)
        ms = wrapper_ms(batchchol.batched_blocked_cholesky, S)
        alone = c.kernel_us(batchchol.batched_blocked_cholesky, (S,),
                            "batchchol")
        host = host_us(lambda: batchchol.batched_blocked_cholesky(S), 300)
        lib_host = host_us(lambda: torch.linalg.cholesky_ex(S), 300)
        print(f"[k5 ({k}, {n}, {n}) f32] with its wrapper {ms}, alone "
              f"{c.us_text(alone)}, the wrapper's host time {host:.2f} us a "
              f"call, cholesky_ex's {lib_host:.2f} (300 calls)", flush=True)
    S = c.spd_tiles(128, 21, 149, torch.float32, dev)
    W = c.spd_on_device(256, 1, 3, torch.float32, dev) * 256
    k6 = c.kernel_us(tilechol.tile_cholesky, (S,), "tilechol")
    k2 = c.kernel_us(panelchol.panel_factor, (W,), "panelchol_factor")
    print(f"[k6 (21, 128, 128) f32] alone {c.us_text(k6)}; [k2 p=256 f32] "
          f"factor alone {c.us_text(k2)}", flush=True)
    print(f"[card] {c.card_line()}", flush=True)


def run_in(tree: pathlib.Path, *args) -> list:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, str(pathlib.Path(__file__).resolve()), *args],
        cwd=tree, capture_output=True, text=True, timeout=1200,
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
    digests = set()
    for name, tree in (("other", other), ("this", ROOT), ("this", ROOT),
                       ("other", other)):
        for line in run_in(tree, "--measure"):
            print(f"[{name}] {line}", flush=True)
            if line.startswith("[digest"):
                digests.add(line)
    h = hashlib.sha256("\n".join(sorted(digests)).encode()).hexdigest()[:16]
    if len(digests) != 2:
        print(f"the digests differ between the runs ({h})", flush=True)
        return 1
    print(f"K3's and K5's digests are the same in every run ({h})",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
