"""One run of one cell: everything the harness finds by name.

For a cell `<config>.<traffic>` of BENCHMARK.json the run reads
configs/<config>.json, makes the inputs with inputs/<config>.py from the
seed, reads mixes/<traffic>.json, whose "driver" names drivers/<driver>.py,
judges the answers with reference/<config>.py and, in a traced run, takes
each per-layer metric from metrics/<name>.py. Nothing here names a
configuration, a mix or a metric, so a later cell, configuration or metric
is new files and new entries of BENCHMARK.json.

A run: set-up (inputs, the driver, its warm-up: every shape the window
uses), the window of `seconds` (window A), in a traced run a shorter
window under the profiler (window B), then, once the windows are closed
and the peak memory read, the check against the reference.
"""

from __future__ import annotations

import gc
import json
import math
import pathlib
import sys
import time

from reference.modules import load

HERE = pathlib.Path(__file__).resolve().parent.parent      # benchmark/
ROOT = HERE.parent

FORBIDDEN = ("jax", "jaxlib", "flax", "libdogleg_tpu")
TRACED_WINDOW_S = 3.0
MARKER = "bench.traced_window"


def read_json(kind: str, name: str) -> dict:
    with open(HERE / kind / f"{name}.json") as f:
        return json.load(f)


def benchmark() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def forbidden_modules() -> list:
    """Top-level names in sys.modules that the benchmark must not load,
    compared whole."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


def cell_metrics(bench: dict, cell: str):
    """(end_to_end, per_layer) metric entries that this cell reports."""
    def applies(m):
        return "workloads" not in m or cell in m["workloads"]
    e2e = [m for m in bench["end_to_end"] if applies(m)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (cell in m["workloads"] if "workloads" in m
                     else m["moves"] in names)]
    return e2e, per_layer


class Context:
    """What a per-layer metric's reader reads: the records of window A
    (records["A"], untraced) and of the traced window B (records["B"]),
    the program's counters' deltas over each, the trace of window B
    (`window`, a trace.Window), the configuration and the mix."""

    def __init__(self, cfg, mix, records, counters, window):
        self.cfg, self.mix = cfg, mix
        self.records, self.counters, self.window = records, counters, window


def _sync(device):
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_window(driver, device, seconds, rec, start_index=0, min_calls=1):
    """Calls until `seconds` have passed and at least min_calls, each
    complete before the next: (window seconds, calls)."""
    driver.rec = rec
    i = start_index
    t0 = time.perf_counter()
    while (i - start_index < min_calls
           or time.perf_counter() - t0 < seconds):
        driver.call(i)
        i += 1
    _sync(device)
    return time.perf_counter() - t0, i - start_index


def _deltas(before, after):
    return {k: after[k] - before[k] for k in after}


def run_cell(cell: str, seed: int, seconds: float, trace: bool, device,
             *, started: float, cfg=None, mix=None, limits=None,
             chips: int = 1) -> dict:
    """One run; returns the result line's fields (and `checks`, the
    numbers compared with their limits). `started` is the process's start
    on time.time()'s clock; cfg and mix replace the cell's files (tests
    run the harness at small sizes on the CPU with them)."""
    import torch
    bench = benchmark()
    entry = next((w for w in bench["workloads"] if w["name"] == cell), None)
    if entry is None:
        raise KeyError(f"no workload {cell!r} in BENCHMARK.json")
    cfg = cfg if cfg is not None else read_json("configs", entry["config"])
    mix = mix if mix is not None else read_json("mixes", entry["traffic"])
    e2e, per_layer = cell_metrics(bench, cell)

    inputs = load("inputs", entry["config"]).make(cfg, mix, seed, device)
    driver = load("drivers", mix["driver"]).Driver(cfg, mix, inputs, device,
                                                   seed, trace)
    driver.warm()
    _sync(device)
    setup_s = time.time() - started

    records = {"A": {}, "B": {}}
    counters = {}
    c0 = driver.counters()
    window_s, calls = run_window(driver, device, seconds, records["A"])
    c1 = driver.counters()
    counters["A"] = _deltas(c0, c1)
    window = None
    if trace:
        window = _traced_window(driver, device, records, counters, calls,
                                seconds)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    found = forbidden_modules()
    if found:
        raise ImportError(f"modules that the benchmark must not load are "
                          f"loaded: {', '.join(found)}")

    metrics = {}
    if trace:
        ctx = Context(cfg, mix, records, counters, window)
        for m in per_layer:
            value = load("metrics", m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
    else:
        values = driver.end_to_end(records["A"], window_s)
        values["setup_s"] = setup_s
        for m in e2e:
            metrics[m["name"]] = {"value": float(values[m["name"]]),
                                  "unit": m["unit"]}

    answers = driver.answers()
    attempted, failed = driver.attempted, driver.failed
    driver.release()
    del driver
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    checks, diag = load("reference", entry["config"]).judge(
        cfg, mix, inputs, answers, limits)
    diag["reference_s"] = time.perf_counter() - t_ref
    correct = failed == 0 and all(
        limit is not None and value <= limit for _, value, limit in checks)

    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": chips, "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": attempted,
           "failed": failed, "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = window.busy_s
        dev["window_s"] = window.window_s
        out["breakdown"] = window.breakdown()
    # a reading that is not a finite number is printed as text, so that
    # the line stays JSON
    out["checks"] = {name: {"value": value if math.isfinite(value)
                            else str(value), "limit": limit}
                     for name, value, limit in checks}
    out["_diag"] = diag
    return out


def _traced_window(driver, device, records, counters, calls, seconds):
    """Window B under the profiler, its kernel counts held to the
    program's launch counters; taken once more if they differ (the
    profiler now and then loses events), and the run fails if they differ
    again."""
    import torch
    from harness import trace as tr
    span = min(seconds, TRACED_WINDOW_S)
    for _ in range(2):
        records["B"] = {}
        c0 = driver.counters()
        with tr.profiled() as box:
            with torch.profiler.record_function(MARKER):
                run_window(driver, device, span, records["B"],
                           start_index=calls, min_calls=2)
        counters["B"] = _deltas(c0, driver.counters())
        window = tr.Window(box.prof, MARKER)
        wrong = {k: (counters["B"][k], window.kernel(sub)[1])
                 for k, sub in driver.kernels.items()
                 if counters["B"][k] != window.kernel(sub)[1]}
        if not wrong:
            return window
    raise RuntimeError(f"the trace's kernel counts differ from the "
                       f"program's launch counters twice: {wrong}")
