"""Host microseconds from the entry point's call to its return, before the
dependent fetch: the median over the untraced window's calls."""

from harness.readers import median


def read(ctx):
    return median(ctx.records["A"].get("gate_us", []))
