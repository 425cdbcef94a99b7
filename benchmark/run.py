"""The benchmark of libdogleg_tpu_torch: one run of one cell.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout, on a machine with the CUDA cards the cell
asks for. Prints, as the last line of standard output, one JSON object:
correct, attempted, failed, metrics (the cell's end-to-end metrics, or
with --trace 1 its per-layer ones), device, with --trace 1 breakdown, and
last `checks`, each number compared with its limit; the same numbers are
the last lines of standard error. Exits non-zero, with no result line,
without enough cards, when the program cannot be imported, or when a
module of JAX or of the JAX package is loaded.
"""

from __future__ import annotations

import os
import pathlib
import time


def _process_start() -> float:
    """When this process started, on time.time()'s clock (to the kernel's
    clock tick); now, where /proc cannot tell."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        ticks = os.sysconf("SC_CLK_TCK")
        return time.time() - uptime + int(fields[19]) / ticks
    except (OSError, ValueError, IndexError):
        return time.time()


STARTED = _process_start()
HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


def _cache_dirs() -> None:
    """Build and kernel caches at fixed paths inside the checkout (the
    program keeps its own nvcc builds in libdogleg_tpu_torch/_build/)."""
    cache = ROOT / ".bench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")


def main(argv=None) -> int:
    import argparse
    import json
    import sys

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    _cache_dirs()
    sys.path[:0] = [str(HERE), str(ROOT)]
    from harness import cell as hc

    bench = hc.benchmark()
    entry = next((w for w in bench["workloads"]
                  if w["name"] == args.workload), None)
    if entry is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    import torch
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < entry["chips"]):
        print(f"{args.workload} needs {entry['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    out = hc.run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), torch.device("cuda", 0),
                      started=STARTED, chips=entry["chips"])
    diag = out.pop("_diag")
    print(json.dumps({"diagnostics": diag}, default=str), file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
