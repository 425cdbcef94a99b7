"""Diagnostics: the vnlog per-attempt metrics stream, a one-line summary,
and a per-op device-time profile (counterpart of libdogleg_tpu/diagnostics.py).

The reference emits two diagnostic streams selected by debug bits (reference
dogleg.h:221-227): a human stream to stderr and a machine-parseable vnlog
table to stdout with one row per step attempt and 14 metric fields
(reference dogleg.c:42-113). The single solve records the same schema into
its History (solver.History, record_history=True), and this module renders
it as vnlog text in the JAX package's format: the same field names, '-' for
unset fields, %g numbers. The human stream is the solve's debug=True.
"""

from __future__ import annotations

import io
import math
from typing import Optional

import numpy as np
import torch

from libdogleg_tpu_torch.solver import (History, SolveResult, StepType,
                                        StopReason)

# Field order matches the reference exactly (dogleg.c:50-64).
_FIELDS = (
    "norm2x_before", "norm2x_after", "step_len_cauchy",
    "step_len_gauss_newton", "step_len_interpolated", "k_cauchy_to_gn",
    "step_len", "step_type", "step_direction_change_deg",
    "expected_improvement", "observed_improvement", "rho",
    "trustregion_before", "trustregion_after",
)

_STEP_TYPE_NAMES = {
    int(StepType.CAUCHY): "cauchy",
    int(StepType.GAUSSNEWTON): "gaussnewton",
    int(StepType.INTERPOLATED): "interpolated",
    int(StepType.FAILED): "failed",
}


def vnlog_legend() -> str:
    """The header row (reference vnlog_debug_emit_legend, dogleg.c:75-81)."""
    return "# iteration step_accepted " + " ".join(_FIELDS)


def _fmt(v) -> str:
    # The reference prints '-' for unset (INFINITY) fields (dogleg.c:83-87)
    # and %g otherwise.
    f = float(v)
    if math.isinf(f):
        return "-"
    return f"{f:g}"


def format_vnlog(history: History, n_attempts: Optional[int] = None) -> str:
    """Render a recorded History as a vnlog table (one row per attempt)."""
    out = io.StringIO()
    print(vnlog_legend(), file=out)
    h = {k: np.asarray(getattr(history, k).detach().cpu())
         for k in History._fields}
    n = (int(n_attempts) if n_attempts is not None
         else int(np.sum(h["iteration"] >= 0)))
    n = min(n, len(h["iteration"]))
    for i in range(n):
        row = [str(int(h["iteration"][i])), str(int(h["step_accepted"][i]))]
        for name in _FIELDS:
            if name == "step_type":
                row.append(_STEP_TYPE_NAMES.get(int(h[name][i]), "-"))
            else:
                row.append(_fmt(h[name][i]))
        print(" ".join(row), file=out)
    return out.getvalue()


def print_vnlog(result: SolveResult) -> None:
    """Print the solve's vnlog stream (requires record_history=True)."""
    if result.history is None:
        raise ValueError("solve was run without record_history=True")
    print(format_vnlog(result.history, result.n_attempts), end="")


def explain_result(result: SolveResult) -> str:
    """A one-line human summary of a solve (the reference scatters it
    through stderr, SAY_IF_VERBOSE)."""
    reason = StopReason(int(result.reason)).name
    return (f"dogleg: {int(result.step_count)} accepted steps "
            f"({int(result.n_attempts)} attempts), stop={reason}, "
            f"norm2_x={float(result.norm2_x):.6g}, "
            f"trustregion={float(result.trustregion):.6g}, "
            f"lambda={float(result.lam):.3g}")


def profile_op_summary(fn, *args, top: int = 15) -> str:
    """A per-op time summary of one call fn(*args) from a torch.profiler
    trace: ms and calls by op name, the `top` largest. The call runs once
    before the trace (so building and caching stay out of it), and the
    traced call ends in a synchronize. With a CUDA device the sums are of
    device-side events only (a CPU op's device time repeats that of the
    kernels it launched); without one, of the CPU ops."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()

    def run():
        fn(*args)
        if cuda:
            torch.cuda.synchronize()

    run()
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    rows = []
    # now and then a trace comes back without its device events: take it
    # again, up to three times
    for _ in range(3):
        with profile(activities=activities) as prof:
            run()
        for ev in prof.key_averages():
            if cuda and ev.device_type == DeviceType.CUDA:
                us = getattr(ev, "self_device_time_total",
                             getattr(ev, "self_cuda_time_total", 0.0))
            elif not cuda and ev.device_type == DeviceType.CPU:
                us = ev.self_cpu_time_total
            else:
                continue
            rows.append((us, ev.count, ev.key))
        if rows:
            break
    if not rows:
        return "no trace captured"
    lines = [f"{'ms':>9}  {'calls':>6}  op"]
    for us, count, name in sorted(rows, key=lambda t: -t[0])[:top]:
        lines.append(f"{us / 1e3:9.3f}  {count:6d}  {name[:80]}")
    return "\n".join(lines)
