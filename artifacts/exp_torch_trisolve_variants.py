#!/usr/bin/env python3
"""Where kernel K7's time goes: time variants of its blocked kernel
(libdogleg_tpu_torch/csrc/tilechol.cu, trisolve_blocked_kernel) on one GPU.

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 artifacts/exp_torch_trisolve_variants.py [variant ...]

With no argument every variant is timed; with names, those, between two
readings of the source as it is.

For each variant the script copies the package into the ignored directory
_smoke_tree/<variant>/, applies the variant's text substitutions to the
kernel source there, and runs itself in that copy (each copy builds its own
library), which prints the device time of the kernel alone (torch.profiler,
20 launches, taken twice) at (68, 128, 128), (21, 256, 256) and
(200, 64, 64) in float32 and float64, and whether the result still agrees
with solve_triangular. Variants:

  base       the source as it is (first and last, so that a drift shows)
  rows16/64  16 or 64 rows of X to a block instead of 32
  jb32       32-wide column blocks instead of 16
  unroll4    the product's loop over the common index unrolled four times
  tile4x4    4 x 4 register tiles in the product: 64 rows of X and a 16-wide
             column block on 64 threads (2 x 2 as it is: 32 rows, 128 threads)
  tile4x4_jb32      4 x 4 tiles: 64 rows, 32-wide column blocks, 128 threads
  tile4x4_r32_jb32  4 x 4 tiles: 32 rows, 32-wide column blocks, 64 threads
  nodiv      the division in the in-block solve left out     (wrong result)
  nosolve    the in-block solve left out                     (wrong result)
  noproduct  the product X[:, <J] D[J, <J]^T left out         (wrong result)

The last three are ablations: base minus the variant is what that part
costs on the block's chain.
"""

from __future__ import annotations

import os
import pathlib
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
SOURCE = "libdogleg_tpu_torch/csrc/tilechol.cu"
ROWS = "launch_trisolve_blocked<T, 32>(D"
THREADS = "constexpr int TS_THREADS = 128;"
WIDTH = "constexpr int JB = 16; "
VARIANTS = {
    "base": [],
    "rows16": [(ROWS, ROWS.replace("32", "16"))],
    "rows64": [(ROWS, ROWS.replace("32", "64"))],
    "jb32": [(WIDTH, WIDTH.replace("16", "32"))],
    "unroll4": [("      for (int l = 0; l < j0; l += V) {",
                 "#pragma unroll 4\n      for (int l = 0; l < j0; l += V) {")],
    "tile4x4": [(THREADS, THREADS.replace("128;", "64; ")),
                ("constexpr int TX = 8,", "constexpr int TX = 4,"),
                (ROWS, ROWS.replace("32", "64"))],
    "tile4x4_jb32": [(WIDTH, WIDTH.replace("16", "32")),
                     (ROWS, ROWS.replace("32", "64"))],
    "tile4x4_r32_jb32": [(THREADS, THREADS.replace("128;", "64; ")),
                         (WIDTH, WIDTH.replace("16", "32"))],
    "nodiv": [("        x[j] = s / Dj[j * ld + j];", "        x[j] = s;")],
    "nosolve": [("    if (t < RM) {\n      // the solve inside",
                 "    if (false) {\n      // the solve inside")],
    "noproduct": [("    if (j0 > 0) {\n      // X[:, J]",
                   "    if (false) {\n      // X[:, J]")],
}
SHAPES = ((68, 128, 128), (21, 256, 256), (200, 64, 64))  # (k, m, n)


def measure(name: str) -> None:
    """Time K7 alone in the tree of the working directory."""
    import numpy as np
    import torch

    import chip_smoke as c
    from libdogleg_tpu_torch.ops import tilechol
    dev = torch.device("cuda")
    out = []
    for dtype, tol in ((torch.float32, 2e-4), (torch.float64, 1e-10)):
        for k, m, n in SHAPES:
            L = tilechol.tile_cholesky_reference(
                c.spd_tiles(n, k, n + k, dtype, dev))[0]
            C = torch.as_tensor(
                np.random.default_rng(k).normal(size=(k, m, n)), dtype=dtype,
                device=dev)
            label = f"{str(dtype).split('.')[-1]} ({k}, {m}, {n})"
            try:
                X = tilechol.tri_solve_right(L, C)
            except RuntimeError as e:  # more shared memory than a block has
                out.append(f"{label} does not launch: {e}")
                continue
            Xr = tilechol.tri_solve_right_reference(L, C)
            torch.cuda.synchronize()
            ok = c.rel_err(X, Xr) < tol
            us = [c.kernel_us(tilechol.tri_solve_right, (L, C), "trisolve")
                  for _ in range(2)]
            took = " / ".join("not measured" if u is None else f"{u:.2f}"
                              for u in us)
            out.append(f"{label} {took} us, "
                       f"{'agrees' if ok else 'WRONG RESULT'}")
    print(f"[K7 alone, {name}] {'; '.join(out)}; card {c.card_line()}",
          flush=True)


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--measure":
        measure(sys.argv[2])
        return 0
    unknown = set(sys.argv[1:]) - set(VARIANTS)
    if unknown:
        print(f"no such variant: {sorted(unknown)}; there are "
              f"{list(VARIANTS)}", file=sys.stderr)
        return 2
    names = (["base"] + sys.argv[1:]) if sys.argv[1:] else list(VARIANTS)
    source = (ROOT / SOURCE).read_text()
    for name in names + ["base"]:
        tree = ROOT / "_smoke_tree" / name
        if not tree.exists():
            shutil.copytree(
                ROOT / "libdogleg_tpu_torch", tree / "libdogleg_tpu_torch",
                ignore=shutil.ignore_patterns("_build", "__pycache__"))
            shutil.copy(ROOT / "chip_smoke.py", tree)
            text = source
            for old, new in VARIANTS[name]:
                if old not in text:
                    raise RuntimeError(f"{name}: {old!r} is not in {SOURCE}")
                text = text.replace(old, new)
            (tree / SOURCE).write_text(text)
        rc = subprocess.run(
            [sys.executable, str(pathlib.Path(__file__).resolve()),
             "--measure", name], cwd=tree,
            env={**os.environ, "PYTHONPATH": str(tree)}
        ).returncode
        if rc:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
