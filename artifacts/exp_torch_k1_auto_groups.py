#!/usr/bin/env python3
"""The grid of lanes per problem (G) of K1-generated's row form, beside its
array form, for the three functions chip_smoke.py's phase 23 promotes, on
one GPU.

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 artifacts/exp_torch_k1_auto_groups.py [readings.json]

For config 3's closure (Nstate 6, 100 rows), config 2's curve fit (3, 64)
and config 8's tanh family at Nstate 16 (64 rows), traced once each in
float32 (parallel/mega_auto.plan_megakernel, forced), it generates the
array form and the row form at each G of GROUPS (generate_source's private
_form and _group), builds every source with nvcc at once
(loader.build_generated) and prints ptxas's registers, stack frame and
spills of each solve kernel. Then, for each function:

  - the row form at G=1 against the array form on the same float32 inputs
    at B=10000: every field of the solve's result bit for bit;
  - float64 at B=256: each form's decisions (step_count, n_attempts,
    reason) against the plain version's (the masked solver on the traced
    graph), which must be identical;
  - float32, under chip_smoke.BENCH, at each batch of BATCHES: each form's
    time with its wrapper (CUDA events, 10 calls) and alone (profiler), in
    turns (the forms in order, then in reverse), and each form's
    step-count agreement with the plain version.

It writes its readings as JSON to the path given, if one is, and fails at
its end if a check failed.

    python3 artifacts/exp_torch_k1_auto_groups.py --fmad [readings.json]

times instead what loader.GENERATED_NVCC_FLAGS' -fmad=false costs: the
shipped row form (G = mega_auto.ROW_GROUP) of each function in float32,
built as shipped and built without the flag (nvcc's default contraction of
the step math into fused multiply-adds; dl_add and its kin are rounded
intrinsics either way), ptxas's lines of both, and at each batch of
BATCHES their times with the wrapper and alone in turns (shipped,
contracted, contracted, shipped), whether their results are the same bits,
and each one's step-count agreement with the plain version.
"""

from __future__ import annotations

import ctypes
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
GROUPS = (1, 2, 4, 8)
BATCHES = (1024, 10000)
F64_BATCH = 256


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as c
    from libdogleg_tpu_torch import DoglegParameters
    from libdogleg_tpu_torch.native import loader
    from libdogleg_tpu_torch.ops import mega
    from libdogleg_tpu_torch.parallel import mega_auto
    from libdogleg_tpu_torch.utils.benchtime import measure_ms

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = c.card_line()
    bench = DoglegParameters(**c.BENCH)
    forms = [("array", 1)] + [("row", g) for g in GROUPS]
    cases32 = c.auto_cases(torch.float32, dev, (max(BATCHES),) * 3)
    cases64 = c.auto_cases(torch.float64, dev, (F64_BATCH,) * 3)
    kernels, texts = {}, []
    for (label, fn, p0, data), (_, fn64, p64, d64) in zip(cases32, cases64):
        for dtype, f, p, d in ((torch.float32, fn, p0, data),
                               (torch.float64, fn64, p64, d64)):
            plan = mega_auto.plan_megakernel(f, p, None, problem_data=d,
                                             forced=True)
            a = plan.kernel.adapted
            for form, g in forms:
                src = mega_auto.generate_source(a, dtype, _form=form,
                                                _group=g)
                kernels[label, dtype, form, g] = (
                    mega_auto.GeneratedKernel(a, src), plan.consts)
                texts.append(src.text)
    texts = list(dict.fromkeys(texts))
    t0 = time.perf_counter()
    infos = loader.build_generated(*texts)
    print(f"[build] {len(texts)} sources, one nvcc process each, started "
          f"together: {time.perf_counter() - t0:.1f} s; card {card}",
          flush=True)
    logs = {t: i.log for t, i in zip(texts, infos)}
    for (label, dtype, form, g), (k, _) in kernels.items():
        if dtype == torch.float32:
            ptx = [line for line in c.ptxas_auto(logs.get(k.source.text, ""))
                   if line.startswith("dogleg_auto_kernel")]
            print(f"[ptxas {label} {form} G={g}] {k.source.local_values} "
                  f"local values, {k.source.operations} operations an "
                  f"evaluation; {'; '.join(ptx)}", flush=True)

    readings, failures = [], []

    def expect(cond, what):
        if not cond:
            print(f"[failed] {what}", flush=True)
            failures.append(what)

    for label, fn, p0, data in cases32:
        leaves = data if isinstance(data, tuple) else (data,)

        def solve(form, g, B, dtype=torch.float32, prm=bench):
            k, consts = kernels[label, dtype, form, g]
            return mega.megakernel_optimize_generated(
                k, p0[:B], tuple(t[:B] for t in leaves), prm, consts)

        # the row form at G=1 gives the array form's bits: the products
        # alone, then every field of the solve
        B = max(BATCHES)
        products = [mega.products_generated(
            kernels[label, torch.float32, form, 1][0], p0[:B],
            tuple(t[:B] for t in leaves),
            kernels[label, torch.float32, form, 1][1])
            for form in ("row", "array")]
        r1, ra = solve("row", 1, B), solve("array", 1, B)
        torch.cuda.synchronize()
        differ = [f for f, x, y in zip(r1._fields, r1, ra)
                  if x is not None and not torch.equal(x, y)]
        expect(all(torch.equal(x, y) for x, y in zip(*products))
               and not differ, f"{label}: the row form at G=1 gives the "
                f"array form's bits at B={B} (products "
                f"{[torch.equal(x, y) for x, y in zip(*products)]}, fields "
                f"that differ {differ})")
        # float64 decisions against the plain version
        _, _, p64, d64 = next(x for x in cases64 if x[0] == label)
        l64 = d64 if isinstance(d64, tuple) else (d64,)
        k64, consts64 = kernels[label, torch.float64, "array", 1]
        ref = mega.megakernel_optimize_generated_reference(
            k64, p64, l64, None, consts64)
        for form, g in forms:
            k, consts = kernels[label, torch.float64, form, g]
            r = mega.megakernel_optimize_generated(k, p64, l64, None, consts)
            for field in ("step_count", "n_attempts", "reason"):
                expect(torch.equal(getattr(r, field), getattr(ref, field)),
                       f"{label} f64 {form} G={g}: {field} the plain "
                       f"version's")
        print(f"[{label}] checked: the row form at G=1 against the array "
              f"form (float32, B={B}); float64 decisions of every form "
              f"against the plain version's (B={F64_BATCH})", flush=True)
        # timing in turns, and agreement with the plain version
        for B in BATCHES:
            k0, consts0 = kernels[label, torch.float32, "array", 1]
            plain = mega.megakernel_optimize_generated_reference(
                k0, p0[:B], tuple(t[:B] for t in leaves), bench, consts0)
            times = {f: [] for f in forms}
            for order in (forms, forms[::-1]):
                for form, g in order:
                    ms = measure_ms(solve, form, g, B, warmup=2, reps=10)
                    us = c.kernel_us(solve, (form, g, B),
                                     "dogleg_auto_kernel", reps=10)
                    times[form, g].append((ms, us))
            for form, g in forms:
                agree = c.decisions_agree(solve(form, g, B), plain)
                (ms0, us0), (ms1, us1) = times[form, g]
                readings.append(dict(function=label, batch=B, form=form,
                                     group=g, ms=[ms0, ms1],
                                     alone_us=[us0, us1], agree=agree))
                print(f"[{label} B={B} {form} G={g}] with its wrapper "
                      f"{ms0:.4f} / {ms1:.4f} ms; alone {c.us_text(us0)} / "
                      f"{c.us_text(us1)}; step-count agreement with the "
                      f"plain version {agree:.4f}; card {card}", flush=True)
    if len(sys.argv) > 1:
        out = pathlib.Path(sys.argv[1])
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(dict(card=card, readings=readings),
                                  indent=1))
        print(f"[done] readings in {out}", flush=True)
    c.check(not failures, f"{len(failures)} checks: {failures}")
    return 0


def fmad() -> int:
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as c
    from libdogleg_tpu_torch import DoglegParameters
    from libdogleg_tpu_torch.native import loader
    from libdogleg_tpu_torch.ops import mega
    from libdogleg_tpu_torch.parallel import mega_auto
    from libdogleg_tpu_torch.utils.benchtime import measure_ms

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    card = c.card_line()
    bench = DoglegParameters(**c.BENCH)
    contract = tuple(f for f in loader.GENERATED_NVCC_FLAGS
                     if f != "-fmad=false")

    class Contracted(mega_auto.GeneratedKernel):
        """The same source, bound from its build without -fmad=false."""

        def __init__(self, kernel, lib):
            super().__init__(kernel.adapted, kernel.source)
            self._lib = lib

        def library(self):
            return self._lib

    cases = c.auto_cases(torch.float32, torch.device("cuda"),
                         (max(BATCHES),) * 3)
    plans = [mega_auto.plan_megakernel(fn, p0, None, problem_data=data,
                                       forced=True)
             for _, fn, p0, data in cases]
    texts = [plan.kernel.source.text for plan in plans]
    t0 = time.perf_counter()
    shipped = loader.build_generated(*texts)
    # the loader's own build routine, with the other flags and its own
    # library names
    built = loader._build_sources(
        texts, loader.find_nvcc, contract,
        lambda src: loader._generated_path("libdogleg_auto_fmad", src,
                                           contract))
    print(f"[build] {2 * len(texts)} builds: {time.perf_counter() - t0:.1f}"
          f" s; card {card}", flush=True)
    readings, failures = [], []
    for (label, _, p0, data), plan, a, b in zip(cases, plans, shipped,
                                                built):
        form, g = plan.kernel.source.form, plan.kernel.source.group
        for name, info in (("shipped", a), ("contracted", b)):
            ptx = [line for line in c.ptxas_auto(info.log)
                   if line.startswith("dogleg_auto_kernel<float")]
            print(f"[ptxas {label} {form} G={g} {name}] {'; '.join(ptx)}",
                  flush=True)
        legs = {"shipped": plan.kernel,
                "contracted": Contracted(plan.kernel, loader.bind_generated(
                    ctypes.CDLL(str(b.path))))}
        leaves = plan.data_leaves

        def solve(name, B):
            return mega.megakernel_optimize_generated(
                legs[name], p0[:B], tuple(t[:B] for t in leaves), bench,
                plan.consts)

        for B in BATCHES:
            plain = mega.megakernel_optimize_generated_reference(
                plan.kernel, p0[:B], tuple(t[:B] for t in leaves), bench,
                plan.consts)
            times = {k: [] for k in legs}
            for name in ("shipped", "contracted", "contracted", "shipped"):
                ms = measure_ms(solve, name, B, warmup=2, reps=10)
                us = c.kernel_us(solve, (name, B), "dogleg_auto_kernel",
                                 reps=10)
                times[name].append((ms, us))
            rs = {k: solve(k, B) for k in legs}
            same = all(torch.equal(x, y) for x, y in
                       zip(rs["shipped"], rs["contracted"])
                       if x is not None)
            for name in legs:
                agree = c.decisions_agree(rs[name], plain)
                if agree < 0.85:
                    failures.append(f"{label} B={B} {name}: {agree}")
                (ms0, us0), (ms1, us1) = times[name]
                readings.append(dict(function=label, batch=B, build=name,
                                     form=form, group=g, ms=[ms0, ms1],
                                     alone_us=[us0, us1], agree=agree,
                                     same_bits=same))
                print(f"[{label} B={B} {form} G={g} {name}] with its "
                      f"wrapper {ms0:.4f} / {ms1:.4f} ms; alone "
                      f"{c.us_text(us0)} / {c.us_text(us1)}; step-count "
                      f"agreement with the plain version {agree:.4f}; the "
                      f"two builds' results the same bits: {same}; card "
                      f"{card}", flush=True)
    args = [x for x in sys.argv[1:] if x != "--fmad"]
    if args:
        out = pathlib.Path(args[0])
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(dict(card=card, readings=readings),
                                  indent=1))
        print(f"[done] readings in {out}", flush=True)
    c.check(not failures, f"step-count agreement under 0.85: {failures}")
    return 0


if __name__ == "__main__":
    sys.exit(fmad() if "--fmad" in sys.argv[1:] else main())
