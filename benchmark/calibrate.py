"""The readings that each check's limit is set from, for one cell, in one
process: for each seed the program's numbers on its timed path at the
timed sizes (each frame or each sampled start once, as the window's calls
make them), the control's (the reference module's control_answers) and,
with --faults, the numbers under each planted fault (harness/faults.py).
One JSON line a seed and a kind on standard output.

    python3 benchmark/calibrate.py --workload <name> --seeds 1,2,3 \\
        [--control] [--faults]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import pathlib
import sys
import time

HERE = pathlib.Path(__file__).resolve().parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--faults", action="store_true")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(HERE), str(HERE.parent)]
    import torch
    from harness import cell as hc
    from harness.faults import FAULTS

    device = torch.device("cuda", 0)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    bench = hc.benchmark()
    entry = next(w for w in bench["workloads"] if w["name"] == args.workload)
    cfg = hc.read_json("configs", entry["config"])
    mix = hc.read_json("mixes", entry["traffic"])
    ref = hc.load("reference", entry["config"])
    drivers = hc.load("drivers", mix["driver"])
    for seed in (int(s) for s in args.seeds.split(",")):
        inputs = hc.load("inputs", entry["config"]).make(cfg, mix, seed,
                                                         device)

        def make_driver():
            d = drivers.Driver(cfg, mix, inputs, device, seed, False)
            d.warm()
            return d

        def once(driver):
            driver.rec = {}
            for i in driver.sample_calls:
                driver.call(i)
            return driver.answers()

        def report(kind, answers, t0):
            t1 = time.perf_counter()
            checks, diag = ref.judge(cfg, mix, inputs, answers,
                                     {k: None for k in ref.LIMITS})
            t2 = time.perf_counter()
            print(json.dumps({"seed": seed, "kind": kind,
                              "readings": {n: v for n, v, _ in checks},
                              "seconds": t2 - t0, "judge_s": t2 - t1,
                              "diag": diag}, default=str), flush=True)

        kinds = [("program", None)]
        if args.faults:
            kinds += [(f"fault:{name}", fault)
                      for name, fault in FAULTS.items()]
        for kind, fault in kinds:
            t0 = time.perf_counter()
            with fault() if fault else contextlib.nullcontext():
                driver = make_driver()
                answers = once(driver)
            report(kind, answers, t0)
            driver.release()
            del driver, answers
        if args.control:
            t0 = time.perf_counter()
            report("control", ref.control_answers(cfg, mix, inputs), t0)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
