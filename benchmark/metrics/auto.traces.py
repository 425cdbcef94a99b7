"""Traces auto-promotion made during both windows (its plan cache should
answer every call after the warm-up: 0)."""


def read(ctx):
    n = [ctx.counters[w].get("auto_traces") for w in ("A", "B")
         if w in ctx.counters]
    return None if None in n or not n else float(sum(n))
