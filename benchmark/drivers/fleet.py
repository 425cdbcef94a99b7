"""Fleets of small independent fits through the program's batched entry
points: a closed loop, one client, of calls that each solve one frame of
`batch` problems and end with a dependent fetch of one scalar (how many
problems stopped with a reason > 0), cycling through the frames made in
set-up.

mix["entry"] picks the path:
- "named": parallel.batched.batched_optimize on the sample problem's own
  products (models.quadratic_surface.products, which names K1's device
  function), the measurements as problem_data;
- "closure": parallel.batched.batched_optimize_compacted on products a user
  writes in plain torch (below), which auto-promotion traces and generates
  a K1 functor for.
"""

from __future__ import annotations

import random
import time

import torch

from harness.readers import p95


def closure_products(gx, gy):
    """sample.c's model and Jacobian as a user would write them for one
    problem: p (6,), meas (100,), closing over the grid."""
    from libdogleg_tpu_torch import Products

    def products(p, meas):
        x = (p[0] * p[1] * gx * gx + p[1] * p[2] * gy * gy + p[2] * gx * gy
             + p[3] * gx + p[4] * gy + p[5]) - meas
        J = torch.stack([p[1] * gx * gx,
                         p[0] * gx * gx + p[2] * gy * gy,
                         p[1] * gy * gy + gx * gy,
                         gx, gy, torch.ones_like(gx)], dim=-1)
        return Products(norm2_x=x @ x, Jt_x=J.T @ x, JtJ=J.T @ J)
    return products


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Driver:
    """One cell's timed path. call() runs one request; the harness times
    the window around the calls."""

    def __init__(self, cfg, mix, inputs, device, seed, trace):
        from libdogleg_tpu_torch import DoglegParameters
        from libdogleg_tpu_torch.models import quadratic_surface as qs
        from libdogleg_tpu_torch.parallel import batched
        self.batched = batched
        self.device, self.trace = device, trace
        self.meas, self.p0 = inputs["meas"], inputs["p0"]
        self.mix = mix
        self.frames, self.batch = mix["frames"], mix["batch"]
        self.prm = DoglegParameters(**cfg["stopping"])
        self.entry = mix["entry"]
        if self.entry == "named":
            self.products = qs.products
        elif self.entry == "closure":
            self.products = closure_products(inputs["gx"], inputs["gy"])
        else:
            raise ValueError(f"unknown fleet entry {self.entry!r}")
        # a sample of the window's answers, one call a frame, drawn from the
        # seed by reservoir sampling over the calls of that frame
        self._rng = random.Random(seed)
        self._seen = [0] * self.frames
        self.kept = [None] * self.frames
        # the current phase's records (the harness swaps them): host ms a
        # call from start to dependent fetch, host us from entry to return,
        # and in a traced run each call's sum of n_attempts on the device
        self.rec = {}
        self.attempted = 0
        self.failed = 0
        self.sample_calls = list(range(self.frames))

    def _solve(self, f):
        p0, meas = self.p0[f], self.meas[f]
        if self.entry == "named":
            return self.batched.batched_optimize(
                self.products, p0, self.prm, problem_data=meas)
        return self.batched.batched_optimize_compacted(
            self.products, p0, self.prm, problem_data=meas)

    def warm(self):
        """A call on every frame: builds and loads the kernels, and plans
        the closure (its trace and build)."""
        for f in range(self.frames):
            r = self._solve(f)
            int((r.reason > 0).sum())
        _sync(self.device)

    def call(self, i: int):
        f = i % self.frames
        t0 = time.perf_counter()
        r = self._solve(f)
        t1 = time.perf_counter()
        if self.trace:
            self.rec.setdefault("attempts", []).append(
                r.n_attempts.sum(dtype=torch.int64))
        done = int((r.reason > 0).sum())      # the dependent fetch
        t2 = time.perf_counter()
        self.rec.setdefault("call_ms", []).append((t2 - t0) * 1e3)
        self.rec.setdefault("gate_us", []).append((t1 - t0) * 1e6)
        self.attempted += 1
        self.failed += done != self.batch
        self._seen[f] += 1
        if self._rng.randrange(self._seen[f]) == 0:
            self.kept[f] = r

    def counters(self) -> dict:
        """The program's counters that the readers take deltas of."""
        from libdogleg_tpu_torch.ops import mega
        from libdogleg_tpu_torch.parallel import mega_auto
        return {"k1": mega.launch_count,
                "k1_generated": mega.auto_launch_count,
                "auto_traces": mega_auto.trace_count}

    # the device operation each launch counter counts, by a substring of
    # its name: the harness holds the traced window's counts to them
    kernels = {"k1": "dogleg_mega_kernel", "k1_generated": "dogleg_auto_kernel"}

    def end_to_end(self, rec: dict, window_s: float) -> dict:
        ms = rec["call_ms"]
        return {"solves_per_s": len(ms) * self.batch / window_s,
                "batch_ms_p95": p95(ms)}

    def answers(self):
        """The sampled calls' answers (p, norm2_x, reason, step_count), one
        a frame, with the frame's start and measurements, and `sample`: the
        problems whose answers the reference solves again, mix["checked"]
        of each call's (all where the mix names no number), drawn from the
        seed."""
        out = []
        checked = self.mix.get("checked", self.batch)
        for f, r in enumerate(self.kept):
            if r is None:
                continue
            sample = None
            if checked < self.batch:
                gen = torch.Generator().manual_seed(self._rng.randrange(2**62))
                sample = torch.randperm(self.batch, generator=gen)[
                    :checked].to(self.device)
            out.append({"frame": f, "p0": self.p0[f], "meas": self.meas[f],
                        "p": r.p, "norm2_x": r.norm2_x, "reason": r.reason,
                        "step_count": r.step_count, "sample": sample})
        return out

    def release(self):
        self.kept = [None] * self.frames

