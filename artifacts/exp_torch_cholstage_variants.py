#!/usr/bin/env python3
"""Where the time of kernels K6 and K2 goes: time variants of the blocked
factorization they share (libdogleg_tpu_torch/csrc/cholstage.cuh) on one GPU.

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 artifacts/exp_torch_cholstage_variants.py [variant ...]

With no argument every variant is timed; with names, those, between two
readings of the source as it is.

For each variant the script copies the package into the ignored directory
_smoke_tree/<variant>/, applies the variant's text substitutions to the
header there (a substitution of three parts names another source first), and
runs itself in that copy (each copy builds its own
library), which prints the device time of the kernels alone (torch.profiler,
20 launches): K6 at (21, 128, 128) and (21, 256, 256), K2's factor kernel and
its inverse kernel at p = 256, in float32 and float64, and whether K6's
result still agrees with its plain version; then the same kernels on banded
matrices (entries more than 8 from the diagonal zero, as the tiles and panels
of a block-sparse problem mostly are), and K5, which runs the same header, at
(256, 128, 128) and (512, 64, 64). `--measure NAME` alone times the tree of
the working directory, whatever version of the package it holds. Variants:

  base      the source as it is (first and last, so that a drift shows)
  inplace   the working copy never in shared memory: in place in the output
  nopacked  whole rows in shared memory or in place, never the packed triangle
  noahead   no look-ahead: the diagonal block factored after the whole update
  threads256  K6's and K2's float32 blocks of 256 threads, as K5's, not 512
  copy1     one 16-byte word a thread in flight while a matrix is copied in
  plaindiv  the panel solve's divisions plain, zero numerators and all
  clocks    the stages of a block that looks ahead timed with clock64: the
            first and the last thread of block 0 print, per launch, the
            cycles they spent in the panel solves, in the update (the first
            thread: the next diagonal block's tiles and its factor) and
            waiting at each of the two barriers; and the first thread of
            the inverse kernel's first block the cycles before its loop over
            row blocks, in it (and in each of its steps), and after it
  nofactor  the diagonal blocks after the first not factored  (wrong result)
  nosolve   the panels below the diagonal blocks not solved   (wrong result)
  nodivide  the divisions of the panel solve left out         (wrong result)
  noupdate  the updates beyond the next diagonal block left out
                                                              (wrong result)

The last four are ablations: base minus the variant is what that part costs
on the block's chain, and the update's share is the most that spreading a
matrix's trailing rows over a cluster of blocks could save.
"""

from __future__ import annotations

import os
import pathlib
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
SOURCE = "libdogleg_tpu_torch/csrc/cholstage.cuh"
INVERSE = "libdogleg_tpu_torch/csrc/panelchol.cu"
VARIANTS = {
    "base": [],
    "inplace": [("  *mode = need(STRIDED) <= static_cast<size_t>(optin) ? "
                 "STRIDED\n", "  *mode = false ? STRIDED\n"),
                ("          : take_packed && need(PACKED)",
                 "          : false && need(PACKED)")],
    "nopacked": [("          : take_packed && need(PACKED)",
                  "          : false && need(PACKED)")],
    "noahead": [("constexpr bool LOOK_AHEAD = true;",
                 "constexpr bool LOOK_AHEAD = false;")],
    "threads256": [("constexpr int LONE_THREADS_F32 = 512;",
                    "constexpr int LONE_THREADS_F32 = 256;")],
    "copy1": [("constexpr int COPY_AHEAD = 8;",
               "constexpr int COPY_AHEAD = 1;")],
    "plaindiv": [("        x[j] = quotient(s, Dk[j * DK_LD + j]);",
                  "        x[j] = s / Dk[j * DK_LD + j];")],
    "clocks": [
        ("#include <cfloat>\n", "#include <cfloat>\n#include <cstdio>\n"),
        ("  bool good = true;\n  if constexpr (AHEAD) {",
         "  bool good = true;\n  long long ck[4] = {0, 0, 0, 0}, c0 = 0;\n"
         "  if constexpr (AHEAD) {"),
        ("    // the panel below the block: X Lkk^T = P, one row per thread\n",
         "    c0 = clock64();\n"),
        ("    Group<G>::sync();\n\n    // the trailing block's lower triangle",
         "    ck[0] += clock64() - c0; c0 = clock64();\n"
         "    Group<G>::sync();\n"
         "    ck[1] += clock64() - c0; c0 = clock64();\n\n"
         "    // the trailing block's lower triangle"),
        ("      good = factor_diag<T, Pivot>(W, ld, r0, Dk, t) && good;\n"
         "    }\n    Group<G>::sync();\n  }\n  return good;",
         "      good = factor_diag<T, Pivot>(W, ld, r0, Dk, t) && good;\n"
         "    }\n    ck[2] += clock64() - c0; c0 = clock64();\n"
         "    Group<G>::sync();\n    ck[3] += clock64() - c0;\n  }\n"
         "  if (AHEAD && blockIdx.x == 0 && (t == 0 || t == G - 1))\n"
         "    printf(\"[clocks n=%d %d bytes thread %d] solve %lld wait %lld "
         "update %lld wait %lld\\n\", n, (int)sizeof(T), t, ck[0], ck[1], "
         "ck[2], ck[3]);\n  return good;"),
        (INVERSE, "#include <cuda_pipeline.h>\n",
         "#include <cuda_pipeline.h>\n#include <cstdio>\n"),
        (INVERSE,
         "  for (int ib = 1; ib < AHEAD_ROWS - 1; ++ib) stage(ib);\n",
         "  const long long i0 = clock64();\n"
         "  for (int ib = 1; ib < AHEAD_ROWS - 1; ++ib) stage(ib);\n"),
        (INVERSE, "  for (int ib = 0; ib < nb; ++ib) {\n",
         "  const long long i1 = clock64();\n"
         "  long long cj[6] = {0, 0, 0, 0, 0, 0}, jt = 0;\n"
         "  for (int ib = 0; ib < nb; ++ib) {\n    jt = clock64();\n"),
        (INVERSE, "    const T* Dq = Di + ib * DK_SIZE;\n",
         "    cj[0] += clock64() - jt; jt = clock64();\n"
         "    const T* Dq = Di + ib * DK_SIZE;\n"),
        (INVERSE,
         "      store4(Ps + (part * PANEL + pr) * PS_LD + pc, lo);\n",
         "      cj[1] += clock64() - jt; jt = clock64();\n"
         "      store4(Ps + (part * PANEL + pr) * PS_LD + pc, lo);\n"),
        (INVERSE, "      __syncthreads();\n      T sum = T(0);\n",
         "      __syncthreads();\n"
         "      cj[2] += clock64() - jt; jt = clock64();\n"
         "      T sum = T(0);\n"),
        (INVERSE, "      __syncthreads();\n      out = T(0);\n",
         "      __syncthreads();\n"
         "      cj[3] += clock64() - jt; jt = clock64();\n"
         "      out = T(0);\n"),
        (INVERSE, "    Ys[(kw + r) * PANEL + c] = out;\n",
         "    cj[4] += clock64() - jt; jt = clock64();\n"
         "    Ys[(kw + r) * PANEL + c] = out;\n"),
        (INVERSE,
         "    __syncthreads();  // the slab's new rows, and the next rows of "
         "L\n",
         "    __syncthreads();\n    cj[5] += clock64() - jt;\n"),
        (INVERSE, "  for (int row = r; row < p; row += THREADS / PANEL)\n",
         "  const long long i2 = clock64();\n"
         "  for (int row = r; row < p; row += THREADS / PANEL)\n"),
        (INVERSE, "        row < c0 ? T(0) : Ys[(row - c0) * PANEL + c];\n",
         "        row < c0 ? T(0) : Ys[(row - c0) * PANEL + c];\n"
         "  if (t == 0 && blockIdx.x == 0 && blockIdx.y == 0)\n"
         "    printf(\"[clocks inverse p=%d %d bytes] before %lld loop %lld "
         "after %lld; in the loop: copies issued %lld product %lld barrier "
         "%lld sum and barrier %lld block product %lld store, wait and "
         "barrier %lld\\n\", p, (int)sizeof(T), i1 - i0, i2 - i1, "
         "clock64() - i2, cj[0], cj[1], cj[2], cj[3], cj[4], cj[5]);\n"),
    ],
    "nofactor": [("      good = factor_diag<T, Pivot>(W, ld, r0, Dk, t) && "
                  "good;", "      good = true;")],
    "nosolve": [("    for (int i = r0 + t; i < n; i += G) {",
                 "    for (int i = n + t; i < n; i += G) {")],
    "nodivide": [("        x[j] = quotient(s, Dk[j * DK_LD + j]);",
                  "        x[j] = s;")],
    "noupdate": [("      for (int q = NEXT + t - 32; q < ntiles; q += G - 32)",
                  "      for (int q = ntiles; q < ntiles; q += G - 32)")],
}


def measure(name: str) -> None:
    """Time K6 and K2's two kernels alone in the tree of the working
    directory."""
    import torch

    import chip_smoke as c
    from libdogleg_tpu_torch.ops import batchchol, panelchol, tilechol
    dev = torch.device("cuda")

    def us(fn, args, sub):
        got = c.kernel_us(fn, args, sub)
        return "not measured" if got is None else f"{got:.2f}"

    def banded(S, width=8):
        """S with its entries more than `width` from the diagonal zeroed and
        its diagonal doubled, which keeps it SPD."""
        n = S.shape[-1]
        band = torch.ones(n, n, dtype=S.dtype, device=dev)
        band = band.tril(width).triu(-width)
        return S * band + torch.diag_embed(torch.diagonal(S, dim1=-2, dim2=-1))

    out = []
    for dtype, tol in ((torch.float32, 2e-4), (torch.float64, 1e-10)):
        label = str(dtype).split(".")[-1]
        for k, n in ((21, 128), (21, 256)):
            S = c.spd_tiles(n, k, n + k, dtype, dev)
            L = tilechol.tile_cholesky(S)[0]
            Lr = tilechol.tile_cholesky_reference(S)[0]
            torch.cuda.synchronize()
            ok = c.rel_err(L, Lr) < tol
            out.append(f"{label} K6 ({k}, {n}, {n}) "
                       f"{us(tilechol.tile_cholesky, (S,), 'tilechol')} us, "
                       f"{'agrees' if ok else 'WRONG RESULT'}")
        W = c.spd_on_device(256, 1, 3, dtype, dev) * 256
        out.append(
            f"{label} K2 p=256 factor "
            f"{us(panelchol.panel_factor, (W,), 'panelchol_factor')} us, "
            f"inverse "
            f"{us(panelchol.panel_factor, (W,), 'panelchol_inverse')} us")
        S = banded(c.spd_tiles(128, 21, 149, dtype, dev))
        W = banded(W)
        out.append(
            f"{label} banded: K6 (21, 128, 128) "
            f"{us(tilechol.tile_cholesky, (S,), 'tilechol')} us, K2 p=256 "
            f"factor "
            f"{us(panelchol.panel_factor, (W,), 'panelchol_factor')} us, "
            f"inverse "
            f"{us(panelchol.panel_factor, (W,), 'panelchol_inverse')} us")
        out.append(f"{label} K5 " + ", ".join(
            f"({k}, {n}, {n}) " + us(
                batchchol.batched_blocked_cholesky,
                (c.spd_tiles(n, k, n + k, dtype, dev),), "batchchol") + " us"
            for k, n in ((256, 128), (512, 64))))
    print(f"[K6 and K2 alone, {name}] {'; '.join(out)}; card "
          f"{c.card_line()}", flush=True)


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
    for name in names + ["base"]:
        tree = ROOT / "_smoke_tree" / name
        if not tree.exists():
            shutil.copytree(
                ROOT / "libdogleg_tpu_torch", tree / "libdogleg_tpu_torch",
                ignore=shutil.ignore_patterns("_build", "__pycache__"))
            shutil.copy(ROOT / "chip_smoke.py", tree)
            for sub in VARIANTS[name]:
                path, old, new = sub if len(sub) == 3 else (SOURCE, *sub)
                text = (tree / path).read_text()
                if old not in text:
                    raise RuntimeError(f"{name}: {old!r} is not in {path}")
                (tree / path).write_text(text.replace(old, new))
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
