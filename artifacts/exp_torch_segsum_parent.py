#!/usr/bin/env python3
"""The segment-add kernel (csrc/segsum.cu) beside the same kernel in another
tree of the repository (a parent commit), on one GPU: its results' bits, its
time alone and with its wrapper at the sparse path's level shapes, the
wrapper's host time, and config 6b simplicial's solve with the kernel's
share of its device time.

Run from the repository root on a machine with a CUDA card and nvcc, with
the other tree unpacked into an ignored directory first:

    mkdir -p _smoke_tree/parent
    git archive <commit> | tar -x -C _smoke_tree/parent
    python3 artifacts/exp_torch_segsum_parent.py _smoke_tree/parent

It runs itself with `--measure` in each tree (each builds its own library
and prints ptxas's registers and spills of the segment-add kernels) in the
order other, this, this, other. A run prints, float32, alpha -1 as the
factorization and the substitutions call the kernel, on seeded values:
  (i)   the B16 batch's widest UPDATE level (16 config-6 grids, dense
        coupling, rcm, amalgamate 16): 154 terms on 121 of
        (16, 276, 128, 128);
  (ii)  its forward level with the most terms on one row: 17 terms on one
        row of (16, 64, 128, 1);
  (iii) config 6b simplicial's forward and backward levels with the
        longest run, B = 1: 284 and 100 terms on one row of 8 elements;
for each the SHA-256 digest of the sums, the kernel alone (torch.profiler,
20 launches), with its wrapper and index_add_ in turns (CUDA events over
20 calls, kernel, index_add_, index_add_, kernel), the bound (bytes /
3.35 TB/s), and the wrapper's host time a call at (ii) and (iii); then
config 6b simplicial's solve: three host walls and one profiled solve, the
segment add's summed device time beside the device total.
The script fails unless every run prints the same digests.
"""

from __future__ import annotations

import hashlib
import os
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
GROUPS = (("segment add", ("segment_add",)), ("K3", ("jtj_",)),
          ("K6", ("tilechol",)), ("K7", ("trisolve",)),
          ("products", ("gemm", "gemv", "cutlass", "xmma")),
          ("scatter/gather", ("index", "scatter", "gather")))


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


def level(sym, B, sched, tgt, off, width, inner, seed):
    """The level of sym.<sched> with the most terms on one target (then
    the most terms), and seeded base (B, width, *inner) and terms."""
    import torch

    from libdogleg_tpu_torch import sparse_cholesky as sc
    plans = sc._level_plans(sym, sched, tgt, off)
    k = max(range(len(plans)), key=lambda i: (plans[i].rounds, plans[i].n))
    gen = torch.Generator().manual_seed(seed)
    base = torch.randn((B, width) + inner, generator=gen).cuda()
    terms = torch.randn((B, plans[k].n) + inner, generator=gen).cuda()
    return plans[k], base, terms


def measure() -> None:
    import torch

    import chip_smoke as c
    from libdogleg_tpu_torch import (DoglegParameters, SparseNewtonSolver,
                                     optimize)
    from libdogleg_tpu_torch.models import grid_mrf
    from libdogleg_tpu_torch.native import loader
    from libdogleg_tpu_torch.ops import bcsr, segsum
    from libdogleg_tpu_torch.utils.benchtime import measure_ms
    info = loader.build()
    loader.load_library()
    entry = ""
    for line in info.log.splitlines():
        if "entry function" in line:
            entry = line.split("'")[1] if "'" in line else line
        elif ("registers" in line or "spill" in line) and \
                "segment_add" in entry:
            print(f"[ptxas] {entry}: {line.strip()}", flush=True)
    g, _ = c.grid_batch_data(32, 8, c.SPARSE_B, torch.float32, "cuda")
    sched = bcsr.jtj_lower_schedule(g.structure)
    inner = SparseNewtonSolver.analyze(sched.rows, sched.cols,
                                       g.structure.nbcol, 8, "rcm",
                                       amalgamate=16).symbolic.inner
    g6 = grid_mrf.make_grid_mrf(*c.GRID_6B, dtype=torch.float32,
                                device="cuda")
    simple = g6.problem()
    sym = simple.default_newton_solver().symbolic
    B = c.SPARSE_B
    cases = (
        ("(i) B16 UPDATE", level(inner, B, "sched", "upd_tgt", "upd_off",
                                 inner.nslots, (inner.b, inner.b), 1)),
        ("(ii) B16 forward", level(inner, B, "fwd", "pair_j", "pair_off",
                                   inner.nb, (inner.b, 1), 2)),
        ("(iii) 6b simplicial forward", level(sym, 1, "fwd", "pair_j",
                                              "pair_off", sym.nb,
                                              (sym.b, 1), 3)),
        ("(iii) 6b simplicial backward", level(sym, 1, "bwd", "pair_j",
                                               "pair_off", sym.nb,
                                               (sym.b, 1), 4)))
    for label, (plan, base, terms) in cases:
        got = segsum.add_(base.clone(), 1, plan, terms, alpha=-1)
        torch.cuda.synchronize()
        digest = hashlib.sha256(got.cpu().numpy().tobytes()).hexdigest()
        print(f"[digest {label}] {digest[:32]}", flush=True)
        targets = torch.as_tensor(plan.targets, device="cuda")

        def kernel():
            return segsum.add_(base, 1, plan, terms, alpha=-1)

        def library():
            return base.index_add_(1, targets, terms, alpha=-1)
        ms = {"kernel": [], "index_add_": []}
        for form, fn in (("kernel", kernel), ("index_add_", library),
                         ("index_add_", library), ("kernel", kernel)):
            ms[form].append(measure_ms(fn, warmup=2, reps=20))
        alone = c.kernel_us(kernel, (), "segment_add")
        nrow = base[0, 0].numel() * base.element_size()
        nbytes = (terms.numel() * terms.element_size()
                  + 4 * (2 * len(plan.uniq) + 1 + plan.n)
                  + 2 * base.shape[0] * len(plan.uniq) * nrow)
        text = (f"[{label}] {plan.n} terms on {len(plan.uniq)} rows, at "
                f"most {plan.rounds} on one, of {tuple(base.shape)}: alone "
                f"{c.us_text(alone)}; with its wrapper "
                f"{'/'.join(f'{v:.4f}' for v in ms['kernel'])} ms, "
                f"index_add_ "
                f"{'/'.join(f'{v:.4f}' for v in ms['index_add_'])} ms; "
                f"bound {nbytes / c.PEAK_BYTES_PER_S * 1e6:.4f} us (bytes)")
        if not label.startswith("(i) "):
            text += (f"; host {host_us(kernel, 3000):.2f} us a call, "
                     f"index_add_'s {host_us(library, 3000):.2f}")
        print(text, flush=True)
    bench = DoglegParameters(**c.BENCH)
    p0 = torch.zeros(g6.nstate, dtype=torch.float32, device="cuda")
    optimize(simple, p0, bench)
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        optimize(simple, p0, bench)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    print(f"[6b simplicial solve] host walls "
          f"{', '.join(f'{w:.1f}' for w in walls)} ms; profiled: "
          f"{c.device_split(lambda: optimize(simple, p0, bench), groups=GROUPS)}",
          flush=True)
    print(f"[card] {c.card_line()}", flush=True)


def run_in(tree: pathlib.Path, *args) -> list:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, str(pathlib.Path(__file__).resolve()), *args],
        cwd=tree, capture_output=True, text=True, timeout=900,
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
    digests = {}
    for name, tree in (("other", other), ("this", ROOT), ("this", ROOT),
                       ("other", other)):
        for line in run_in(tree, "--measure"):
            print(f"[{name}] {line}", flush=True)
            if line.startswith("[digest"):
                label, value = line.rsplit(" ", 1)
                digests.setdefault(label, set()).add(value)
    if not digests or any(len(v) != 1 for v in digests.values()):
        print(f"the digests differ between the runs: {digests}", flush=True)
        return 1
    h = hashlib.sha256(repr(sorted(digests.items())).encode()).hexdigest()
    print(f"the segment add's digests are the same in every run "
          f"({len(digests)} readings, {h[:16]})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
