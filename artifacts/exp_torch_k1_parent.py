#!/usr/bin/env python3
"""Kernel K1's general instance beside the same kernel in another tree of
the repository (a parent commit), on one GPU: ptxas's report, the results'
bits and the times.

Run from the repository root on a machine with a CUDA card and nvcc, with
the other tree unpacked into an ignored directory first:

    mkdir -p _smoke_tree/parent
    git archive <commit> | tar -x -C _smoke_tree/parent
    python3 artifacts/exp_torch_k1_parent.py _smoke_tree/parent

It compiles csrc/mega.cu of both trees with the loader's flags and prints
ptxas's registers and spills of every kernel in it, then runs itself with
`--measure` in each tree (each builds its own library) in the order other,
this, this, other. A run prints a SHA-256 of the general K1's results (every
field) on float64 at B=1024 and float32 at B=8192 under the benchmark rule,
the inputs of chip_smoke.py phase 3, and the kernel's time with its wrapper
(CUDA events over 20 calls) and alone (profiler). The script fails unless
every run prints the same digests.
"""

from __future__ import annotations

import hashlib
import os
import pathlib
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parent.parent


def ptxas_report(tree: pathlib.Path) -> list:
    from libdogleg_tpu_torch.native.loader import NVCC_FLAGS, find_nvcc
    with tempfile.TemporaryDirectory() as tmp:
        out = subprocess.run(
            [find_nvcc(), *NVCC_FLAGS, "-c",
             str(tree / "libdogleg_tpu_torch/csrc/mega.cu"), "-o",
             str(pathlib.Path(tmp) / "mega.o")],
            capture_output=True, text=True, check=True, timeout=600)
    return [line.strip() for line in (out.stdout + out.stderr).splitlines()
            if "registers" in line or "spill" in line
            or "entry function" in line]


def measure() -> None:
    import torch

    import chip_smoke as c
    from libdogleg_tpu_torch import DoglegParameters
    from libdogleg_tpu_torch.ops import mega
    from libdogleg_tpu_torch.utils.benchtime import measure_ms
    dev = torch.device("cuda")
    bench = DoglegParameters(**c.BENCH)
    for label, args, prm in (
            ("f64 B=1024", c.instances(0, 1024, torch.float64, dev), None),
            (f"f32 B={c.BATCH}", c.instances(1, c.BATCH, torch.float32, dev),
             bench)):
        r = mega.megakernel_optimize(*args, prm)
        torch.cuda.synchronize()
        h = hashlib.sha256()
        for t in r:
            if t is not None:
                h.update(t.cpu().numpy().tobytes())
        ms = measure_ms(mega.megakernel_optimize, *args, prm, warmup=3,
                        reps=20)
        alone = c.kernel_us(mega.megakernel_optimize, (*args, prm),
                            "dogleg_mega_kernel")
        print(f"[k1 {label}] digest {h.hexdigest()}; {ms:.4f} ms with its "
              f"wrapper; alone {c.us_text(alone)}", flush=True)


def main() -> int:
    if sys.argv[1:] == ["--measure"]:
        measure()
        return 0
    other = pathlib.Path(sys.argv[1]).resolve()
    sys.path.insert(0, str(ROOT))
    import chip_smoke as c
    print(f"[k1 card] {c.card_line()}", flush=True)
    for name, tree in (("other", other), ("this", ROOT)):
        for line in ptxas_report(tree):
            print(f"[k1 ptxas {name}] {line}", flush=True)
    digests = {}
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    for name, tree in (("other", other), ("this", ROOT), ("this", ROOT),
                       ("other", other)):
        out = subprocess.run(
            [sys.executable, str(ROOT / "artifacts/exp_torch_k1_parent.py"),
             "--measure"], cwd=tree, capture_output=True, text=True,
            timeout=900, env={**env, "PYTHONPATH": str(tree)})
        if out.returncode:
            print(out.stdout + out.stderr, flush=True)
            return 1
        for line in out.stdout.splitlines():
            print(f"[{name}] {line}", flush=True)
            if " digest " in line:
                label, rest = line.split(" digest ")
                digests.setdefault(label, set()).add(rest.split(";")[0])
    if any(len(d) != 1 for d in digests.values()):
        print("the general K1's results differ between the trees", flush=True)
        return 1
    print("the general K1's results are bit for bit the same in both trees",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
