#!/usr/bin/env python3
"""Kernel K1, both instances, beside the same kernel in another tree of the
repository (a parent commit), on one GPU: ptxas's report, the results, the
times, the wrappers' host cost and the public call's host wall.

Run from the repository root on a machine with a CUDA card and nvcc, with
the other tree unpacked into an ignored directory first:

    mkdir -p _smoke_tree/parent
    git archive <commit> | tar -x -C _smoke_tree/parent
    python3 artifacts/exp_torch_k1_parent.py _smoke_tree/parent

It compiles csrc/mega.cu of both trees with the loader's flags and prints
ptxas's registers and spills of every kernel in it, then runs itself with
`--measure` in each tree (each builds its own library) in the order other,
this, this, other. A run prints SHA-256 digests of the general and the
factored K1's results on float64 at B=1024 (the decisions alone, and every
field) and float32 at B=8192 under the benchmark rule, the inputs of
chip_smoke.py phases 3 and 17; each instance's time with its wrapper (CUDA
events over 20 calls) and alone (profiler) in float32 at B = 1024, 8192 and
16384 under the benchmark rule; the public call batched_optimize on each
instance (the factored one on statistics made beforehand) over a loop of 50
calls ended by one synchronize, and whether one call waits for the card
(torch.cuda's sync debug mode). In this tree a run also times the grid of
K1's lanes per problem: csrc/mega.cu built once for each G in K1_GROUPS
(-DK1_GENERAL_GROUP=G -DK1_FACTORED_GROUP=G, one nvcc process each, all
started together), each build's float32 results held to the twin's under
the benchmark rule at B=8192, then every build timed in turns, twice, with
its wrapper and alone at each batch of K1_GRID_BATCHES. Then it runs each
tree's artifacts/exp_torch_wrapper_host_cost.py in the same order. The
script fails unless every run prints the same float64 decisions.
"""

from __future__ import annotations

import hashlib
import os
import pathlib
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
# The grid of K1's lanes per problem (G), and the batches it is timed at.
K1_GROUPS = (1, 2, 4, 8, 16)
K1_GRID_BATCHES = (1024, 8192, 16384)


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


def digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()


def public_call(label, call) -> None:
    """The host wall of `call` over a loop of 50 calls ended by one
    synchronize, and whether one call waits for the card."""
    import warnings

    import torch
    call()
    torch.cuda.synchronize()
    loop = 50
    t0 = time.perf_counter()
    for _ in range(loop):
        call()
    enqueued = time.perf_counter() - t0
    torch.cuda.synchronize()
    whole = time.perf_counter() - t0
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            call()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    syncs = len(caught)
    print(f"[public call {label}] {enqueued / loop * 1e3:.4f} ms a call to "
          f"enqueue, {whole / loop * 1e3:.4f} ms a call in all (a loop of "
          f"{loop} ended by one synchronize); synchronizing operations in "
          f"one call: {syncs}", flush=True)


def build_k1_variants(c) -> dict:
    """csrc/mega.cu built once for each G of K1_GROUPS, one nvcc process
    each, all started together, into libraries under the package's ignored
    _build/ directory. Returns {label: (library, ptxas lines)}, each
    library's K1 entry points declared."""
    import ctypes

    from libdogleg_tpu_torch.native import loader
    out_dir = loader._BUILD_DIR / "k1_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = str(loader._SRC / "mega.cu")
    labels = [f"G={g}" for g in K1_GROUPS]
    libs = [out_dir / f"k1_g{g}.so" for g in K1_GROUPS]
    cmds = [[loader.find_nvcc(), *loader.NVCC_FLAGS, "-shared",
             f"-DK1_GENERAL_GROUP={g}", f"-DK1_FACTORED_GROUP={g}", src,
             "-o", str(lib)] for g, lib in zip(K1_GROUPS, libs)]
    t0 = time.perf_counter()
    logs = loader._run(cmds)
    print(f"[grid build] {len(cmds)} builds of csrc/mega.cu in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    return {label: (loader.bind_mega(ctypes.CDLL(str(lib))), c.ptxas_k1(log))
            for label, lib, log in zip(labels, libs, logs)}


class k1_library:
    """Within this context the package's wrappers launch the kernels of
    `lib` (a build of csrc/mega.cu) in place of the package's library."""

    def __init__(self, lib):
        self.lib = lib

    def __enter__(self):
        from libdogleg_tpu_torch.native import loader
        self.saved = loader.load_library()
        loader._LIB = self.lib

    def __exit__(self, *exc):
        from libdogleg_tpu_torch.native import loader
        loader._LIB = self.saved


def k1_group_grid(c, dev, bench, variants, factored: bool) -> None:
    """One of K1's instances in every build of the grid: the f32 results
    held to the twin's under the benchmark rule at B=8192 (agreement >= 0.85
    general, 0.99 factored; recovered_frac >= 0.99), then in turns over the
    builds, twice, at each batch of K1_GRID_BATCHES: CUDA events over 20
    calls with the wrapper and the kernel alone (profiler). Prints a line
    per build and batch."""
    import torch

    from libdogleg_tpu_torch.ops import mega
    from libdogleg_tpu_torch.utils.benchtime import measure_ms
    if factored:
        fn, twin = (mega.megakernel_optimize_factored,
                    mega.megakernel_optimize_factored_reference)
        name, floor = "dogleg_mega_factored_kernel", 0.99

        def make(seed, batch):
            return c.factored_args(seed, batch, torch.float32, dev)[0]
    else:
        fn, twin = mega.megakernel_optimize, mega.megakernel_optimize_reference
        name, floor = "dogleg_mega_kernel", 0.85

        def make(seed, batch):
            return c.instances(seed, batch, torch.float32, dev)
    args = make(1, c.BATCH)
    r_t = twin(*args, bench)
    for label, (lib, _) in variants.items():
        with k1_library(lib):
            r = fn(*args, bench)
            torch.cuda.synchronize()
        agree = ((r.step_count == r_t.step_count)
                 & (r.n_attempts == r_t.n_attempts)).float().mean().item()
        rec = c.recovered_frac(r.p)
        c.check(agree >= floor and rec >= 0.99,
                f"K1 grid {label}: agreement {agree} >= {floor}, "
                f"recovered_frac {rec} >= 0.99")
    times = {(label, b): [] for label in variants for b in K1_GRID_BATCHES}
    for batch in K1_GRID_BATCHES:
        args = make(1, batch)
        for _ in range(2):
            for label, (lib, _) in variants.items():
                with k1_library(lib):
                    times[label, batch].append((
                        measure_ms(fn, *args, bench, warmup=3, reps=20),
                        c.kernel_us(fn, (*args, bench), name)))
    kind = "factored" if factored else "general"
    for label in variants:
        for batch in K1_GRID_BATCHES:
            t = times[label, batch]
            print(f"[K1 {kind} grid {label} B={batch} f32] with its wrapper "
                  f"{t[0][0]:.4f} / {t[1][0]:.4f} ms (CUDA events over 20 "
                  f"calls, two turns over the builds); alone "
                  f"{c.us_text(t[0][1])} / {c.us_text(t[1][1])}",
                  flush=True)


def measure(grid: bool) -> None:
    import torch

    import chip_smoke as c
    from libdogleg_tpu_torch import DoglegParameters
    from libdogleg_tpu_torch.models import quadratic_surface as qs
    from libdogleg_tpu_torch.ops import mega
    from libdogleg_tpu_torch.parallel import batched_optimize
    from libdogleg_tpu_torch.utils.benchtime import measure_ms
    dev = torch.device("cuda")
    bench = DoglegParameters(**c.BENCH)
    instances = (
        ("general", mega.megakernel_optimize, "dogleg_mega_kernel",
         lambda seed, b, dt: c.instances(seed, b, dt, dev)),
        ("factored", mega.megakernel_optimize_factored,
         "dogleg_mega_factored_kernel",
         lambda seed, b, dt: c.factored_args(seed, b, dt, dev)[0]))
    for kind, fn, _, make in instances:
        for label, args, prm in (
                ("f64 B=1024", make(0, 1024, torch.float64), None),
                (f"f32 B={c.BATCH}", make(1, c.BATCH, torch.float32),
                 bench)):
            r = fn(*args, prm)
            torch.cuda.synchronize()
            print(f"[k1 {kind} {label}] decisions "
                  f"{digest((r.step_count, r.n_attempts, r.reason))}; "
                  f"every field {digest(t for t in r if t is not None)}",
                  flush=True)
    for kind, fn, name, make in instances:
        for batch in (1024, 8192, 16384):
            args = make(1, batch, torch.float32)
            ms = measure_ms(fn, *args, bench, warmup=3, reps=20)
            alone = c.kernel_us(fn, (*args, bench), name)
            print(f"[k1 {kind} B={batch} f32] {ms:.4f} ms with its wrapper; "
                  f"alone {c.us_text(alone)}", flush=True)
    p0, meas, _, _ = c.instances(2, c.BATCH, torch.float32, dev)
    G = qs.gram_pair(torch.float32, dev)
    stats = qs.factored_statistics(meas)
    public_call(f"general B={c.BATCH} f32", lambda: batched_optimize(
        qs.products, p0, bench, problem_data=meas))
    public_call(f"factored B={c.BATCH} f32, statistics made before",
                lambda: batched_optimize(qs.factored_products_fn(G), p0,
                                         bench, problem_data=stats))
    if grid:
        variants = build_k1_variants(c)
        for label, (_, report) in variants.items():
            print(f"[ptxas K1 grid {label}] {'; '.join(report)}", flush=True)
        for factored in (False, True):
            k1_group_grid(c, dev, bench, variants, factored)
        print(f"[grid card] {c.card_line()}", flush=True)


def run_in(tree: pathlib.Path, script: pathlib.Path, *args) -> list:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, str(script), *args], cwd=tree, capture_output=True,
        text=True, timeout=1500, env={**env, "PYTHONPATH": str(tree)})
    if out.returncode:
        print(out.stdout + out.stderr, flush=True)
        raise SystemExit(1)
    return out.stdout.splitlines()


def main() -> int:
    if sys.argv[1:2] == ["--measure"]:
        measure(grid=sys.argv[2:] == ["--grid"])
        return 0
    other = pathlib.Path(sys.argv[1]).resolve()
    sys.path.insert(0, str(ROOT))
    import chip_smoke as c
    print(f"[k1 card] {c.card_line()}", flush=True)
    for name, tree in (("other", other), ("this", ROOT)):
        for line in ptxas_report(tree):
            print(f"[k1 ptxas {name}] {line}", flush=True)
    order = (("other", other), ("this", ROOT), ("this", ROOT),
             ("other", other))
    decisions = {}
    for name, tree in order:
        for line in run_in(tree, ROOT / "artifacts/exp_torch_k1_parent.py",
                           "--measure", *(["--grid"] if name == "this"
                                          else [])):
            print(f"[{name}] {line}", flush=True)
            if "f64" in line and " decisions " in line:
                label, rest = line.split(" decisions ")
                decisions.setdefault(label, set()).add(rest.split(";")[0])
    for name, tree in order:
        for line in run_in(tree,
                           tree / "artifacts/exp_torch_wrapper_host_cost.py"):
            if "K1" in line or "card" in line:
                print(f"[{name}] {line}", flush=True)
    if any(len(d) != 1 for d in decisions.values()):
        print("K1's float64 decisions differ between the trees", flush=True)
        return 1
    print("K1's float64 decisions are the same in both trees", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
