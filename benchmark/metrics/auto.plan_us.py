"""Auto-promotion's plan-cache key and lookup, host microseconds a call
under the profiler: the median over the traced window's whole calls of
the `dogleg.plan` span."""

from harness.readers import median
from harness.spans import per_call


def read(ctx):
    if ctx.window is None:
        return None
    return median(per_call(ctx.window, "dogleg.plan"))
