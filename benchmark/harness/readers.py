"""Shared arithmetic of the per-layer readers (metrics/*.py)."""

from __future__ import annotations

import statistics


def median(values):
    return statistics.median(values) if values else None


def p95(values):
    """The 95th percentile, between order statistics as numpy's default
    interpolates them (statistics.quantiles' "inclusive" method)."""
    if len(values) < 2:
        return float(values[0]) if values else float("nan")
    return statistics.quantiles(values, n=20, method="inclusive")[18]


def idle_share(ctx):
    """The device's idle share of the traced window, %."""
    w = ctx.window
    if w is None or w.window_s <= 0 or w.busy_s <= 0:
        return None
    return 100.0 * (w.window_s - w.busy_s) / w.window_s


def k1_roofline(ctx, kernel: str):
    """K1's share of its roofline in the traced window, %: the work the
    window's calls needed (roofline/k1.py, from each call's attempts) at
    the card's peaks, over the device time of the kernels named `kernel`."""
    from harness.cell import load
    seconds, count = ctx.window.kernel(kernel)
    attempts = ctx.records["B"].get("attempts", [])
    if count == 0 or seconds <= 0 or len(attempts) != count:
        return None
    k1, peaks = load("roofline", "k1"), load("roofline", "peaks")
    cfg, mix = ctx.cfg, ctx.mix
    itemsize = 4 if cfg["dtype"] == "float32" else 8
    flops = nbytes = 0.0
    for a in attempts:
        f, b = k1.work(mix["batch"], cfg["nstate"], cfg["nmeas"], int(a),
                       itemsize)
        flops, nbytes = flops + f, nbytes + b
    return 100.0 * peaks.bound_s(flops, nbytes, cfg["dtype"]) / seconds
