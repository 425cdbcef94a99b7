"""The benchmark's harness on the CPU at small sizes: BENCHMARK.json's
schema, the input generators, the reference against itself, the roofline
arithmetic, the result line, the import check, and that a new cell and
metric are new files and entries only.

    python -m pytest benchmark/tests -q
"""

from __future__ import annotations

import json
import math
import pathlib
import re
import shutil
import subprocess
import sys
import time

import pytest
import torch

from harness import cell as hc

ROOT = hc.ROOT
CPU = torch.device("cpu")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def small(kind, name):
    """A cell's files at a size the CPU holds in a test."""
    d = hc.read_json(kind, name)
    if kind == "mixes":
        d.update(batch=1024, frames=2)
        if "checked" in d:
            d.update(checked=512)
    return d


def run_small(cell, seed=5, trace=False, limits=None):
    entry = next(w for w in hc.benchmark()["workloads"] if w["name"] == cell)
    return hc.run_cell(cell, seed, 0.2, trace, CPU, started=time.time(),
                       cfg=small("configs", entry["config"]),
                       mix=small("mixes", entry["traffic"]), limits=limits)


BENCH = hc.benchmark()
# limits that a run at a test's small size meets whatever its readings
LOOSE = {"cost_gap": 1.0, "excess_cost_p999": 1.0, "decision_share": 1.0,
         "stop_rule_breaches": 0}
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_schema_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and PATH.match(c["file"])
        assert c["file"].startswith("benchmark/")
        assert (ROOT / c["file"]).is_file()
        assert all(NAME.match(k) for k in c["reduced"])
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"]
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
        assert w["name"] == f"{w['config']}.{w['traffic']}"
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert 1 <= len(w["why"]) <= 200
        assert w["config"] in {c["name"] for c in BENCH["configs"]}
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [m["name"] for m in metrics]
    assert len(names) == len(set(names))
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in names


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_reports_what_it_must(cell):
    e2e, per_layer = hc.cell_metrics(BENCH, cell)
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2 and per_layer
    for m in per_layer:
        assert m["moves"] in names, (m["name"], cell)
        assert (hc.HERE / "metrics" / f"{m['name']}.py").is_file()


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 7])
def test_fleet_inputs_repeat_from_the_seed(seed):
    cfg, mix = small("configs", "sample-fleet"), small("mixes",
                                                       "named-B262144")
    mod = hc.load("inputs", "sample-fleet")
    a, b = mod.make(cfg, mix, seed, CPU), mod.make(cfg, mix, seed, CPU)
    assert torch.equal(a["meas"], b["meas"]) and torch.equal(a["p0"], b["p0"])
    assert a["meas"].shape == (2, 1024, 100) and a["p0"].dtype == torch.float32
    assert float(a["p0"].min()) >= -0.1 and float(a["p0"].max()) <= 0.9
    c = mod.make(cfg, mix, seed + 1, CPU)
    assert not torch.equal(a["meas"], c["meas"])


def test_fleet_reference_blocks_agree():
    cfg = hc.read_json("configs", "sample-fleet")
    inp = hc.load("inputs", "sample-fleet").make(
        cfg, dict(batch=96, frames=1), 3, CPU)
    ref = hc.load("reference", "sample-fleet")
    whole = ref.reference_solve(cfg, inp["p0"][0], inp["meas"][0])
    blocks = ref.reference_solve(cfg, inp["p0"][0], inp["meas"][0], block=32)
    for k in whole:
        assert torch.equal(whole[k], blocks[k]), k
    assert bool((whole["reason"] > 0).all())
    # the reference's own answers read as right
    gap = ref.cost_gaps(cfg, inp["meas"][0], whole["p"], whole["norm2"],
                        block=40)
    excess, _ = ref.excesses(cfg, inp["p0"][0], inp["meas"][0], whole["p"],
                             whole)
    assert gap.shape == (96,) and float(gap.max()) < 1e-14
    assert float(excess.abs().max()) == 0.0


def test_k1_roofline_matches_chip_smoke():
    # chip_smoke.py's K1 at B=8192: a 9.45 us bound by operations at 8.98
    # products evaluations a problem
    k1, peaks = hc.load("roofline", "k1"), hc.load("roofline", "peaks")
    B = 8192
    attempts = round(7.98 * B)
    flops, nbytes = k1.work(B, 6, 100, attempts, 4)
    assert peaks.bound_s(flops, nbytes, "float32") * 1e6 == pytest.approx(
        9.45, abs=0.01)
    assert flops / peaks.FLOP_PER_S["float32"] > nbytes / peaks.BYTES_PER_S


def test_trace_reading():
    tr = sys.modules.get("harness.trace") or __import__(
        "harness.trace", fromlist=["x"])
    busy = tr.union([("a", 0, 10), ("b", 5, 20), ("c", 30, 40)], 0, 50)
    assert busy == [[0, 20], [30, 40]]
    g = tr.gaps(busy, [("host.op", 19, 31, 0)], 0, 50)
    assert [round(s * 1e6) for _, s in g] == [10, 10]
    assert g[0][0] in ("host.op", "host idle")


@pytest.mark.parametrize("cell", CELLS)
def test_result_line(cell):
    out = run_small(cell, limits=LOOSE)
    out.pop("_diag")
    assert list(out)[-1] == "checks"
    assert set(out) == {"correct", "attempted", "failed", "metrics",
                        "device", "checks"}
    e2e, _ = hc.cell_metrics(BENCH, cell)
    assert set(out["metrics"]) == {m["name"] for m in e2e}
    assert all(v["value"] > 0 for v in out["metrics"].values())
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 1
    json.dumps(out)


@pytest.mark.parametrize("cell,host", [
    ("sample-fleet.named-B262144", {"gate.host_us"}),
    ("sample-fleet.named-B8192", {"gate.host_us.host-paced",
                                  "calls.p95_ms.host-paced"})])
def test_traced_result_line(cell, host):
    out = run_small(cell, trace=True, limits=LOOSE)
    out.pop("_diag")
    assert {"busy_s", "window_s"} <= set(out["device"])
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    # the host's metrics are read on the CPU too; the device's have
    # nothing to read there and are left out
    assert set(out["metrics"]) == host
    assert all(v["value"] > 0 for v in out["metrics"].values())


def test_stop_rule_breaches():
    ref = hc.load("reference", "sample-fleet")
    reason = torch.tensor([4, 1, 2, 4, 2, 3, 1], dtype=torch.int32)
    steps = torch.tensor([10, 10, 3, 9, 10, 11, 4], dtype=torch.int32)
    assert ref.stop_rule_breaches(reason, steps, 10).tolist() == [
        False, False, False, True, True, True, False]


def test_no_jax_in_the_benchmark():
    code = (
        "import sys, pathlib; here = pathlib.Path('benchmark').resolve(); "
        "sys.path[:0] = [str(here), str(here.parent)]; "
        "from harness import cell as hc, faults, readers, trace; "
        "import libdogleg_tpu_torch; "
        "from libdogleg_tpu_torch.parallel import batched, mega_auto; "
        "import run, calibrate; "
        "[hc.load(k, p.stem) for k in ('inputs', 'drivers', 'reference', "
        "'metrics', 'roofline') for p in (here / k).glob('*.py')]; "
        "print(','.join(hc.forbidden_modules()))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""


def test_a_cell_and_a_metric_are_new_files(tmp_path):
    """A throwaway mix and per-layer metric, added as files and entries in
    a copy of the benchmark, run without an edit of any file there."""
    shutil.copytree(hc.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    (tmp_path / "benchmark" / "mixes" / "named-B64.json").write_text(
        json.dumps({"driver": "fleet", "entry": "named", "batch": 64,
                    "frames": 2}))
    (tmp_path / "benchmark" / "metrics" / "calls.count.py").write_text(
        "def read(ctx):\n    return float(len(ctx.records['A']['call_ms']))\n")
    bench["workloads"].append({"name": "sample-fleet.named-B64",
                               "config": "sample-fleet",
                               "traffic": "named-B64", "chips": 1,
                               "why": "a test's throwaway cell"})
    for m in bench["end_to_end"]:
        if "workloads" in m and "sample-fleet.named-B262144" in m["workloads"]:
            m["workloads"].append("sample-fleet.named-B64")
    bench["per_layer"].append({"name": "calls.count", "unit": "count",
                               "better": "higher", "source": "host_clock",
                               "layer": "entry and gate, parallel/batched.py",
                               "moves": "solves_per_s",
                               "workloads": ["sample-fleet.named-B64"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = (
        "import sys, time, json, torch; "
        f"sys.path[:0] = ['benchmark', {str(ROOT)!r}]; "
        "from harness import cell as hc; "
        f"lim = {LOOSE!r}; "
        "a = hc.run_cell('sample-fleet.named-B64', 1, 0.2, False, "
        "torch.device('cpu'), started=time.time(), limits=lim); "
        "b = hc.run_cell('sample-fleet.named-B64', 1, 0.2, True, "
        "torch.device('cpu'), started=time.time(), limits=lim); "
        "print(json.dumps([a['metrics'], b['metrics'], a['correct']]))")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    e2e, traced, correct = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(e2e) == {"solves_per_s", "batch_ms_p95", "setup_s"}
    assert traced["calls.count"]["value"] >= 1 and correct


def test_run_refuses_without_a_card(monkeypatch, capsys):
    import run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_run_fails_without_the_program(tmp_path):
    shutil.copytree(hc.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.cuda
def test_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "sample-fleet.named-B262144", "--seed", "2147483901", "--seconds",
         "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert math.isfinite(line["metrics"]["solves_per_s"]["value"])
