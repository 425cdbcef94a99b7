"""The 95th percentile of a call's host milliseconds, from its start to
its dependent fetch, over the untraced window's calls of a cell whose
calls the host paces (there a tail swings from machine to machine, so it
is read here and not held to a bound)."""

from harness.readers import p95


def read(ctx):
    ms = ctx.records["A"].get("call_ms", [])
    return p95(ms) if ms else None
