"""The routing's host microseconds a call under the profiler: the median
over the traced window's whole calls of the `dogleg.route` span's self
time (its checks and choice of path, its `dogleg.plan` left out)."""

from harness.readers import median
from harness.spans import per_call


def read(ctx):
    if ctx.window is None:
        return None
    return median(per_call(ctx.window, "dogleg.route"))
