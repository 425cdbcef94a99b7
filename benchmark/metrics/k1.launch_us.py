"""K1's wrapper on the host, microseconds a call under the profiler (its
checks, inputs, library lookup, outputs and entry call): the median over
the traced window's whole calls of the `dogleg.launch` span."""

from harness.readers import median
from harness.spans import per_call


def read(ctx):
    if ctx.window is None:
        return None
    return median(per_call(ctx.window, "dogleg.launch"))
