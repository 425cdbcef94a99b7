"""The program's own spans in the traced window: the host's `dogleg.*`
ranges (libdogleg_tpu_torch/telemetry.py), which the profile lists among
the host's operations, so that the window's `host` (trace.intervals) holds
them on the clock of the device's operations.

`ranges` gives every such range clipped to the window's [lo, hi], so that a
share of the window read from them compares with device.idle_share.fleet;
`calls` groups them by their enclosing `dogleg.call` and leaves out the
calls that the window cuts. A program without the spans, or one whose
spans the profile lists as user annotations, gives neither, and the
readers then report nothing.
"""

from __future__ import annotations

import functools

from harness.trace import union

PREFIX = "dogleg."
CALL = "dogleg.call"


@functools.lru_cache(maxsize=1)
def _host(window) -> tuple:
    """The dogleg.* ranges on the host: (name, start_us, end_us), sorted by
    start, and the longer first."""
    if window is None:
        return ()
    out = [(n, s, e) for n, s, e, _ in window.host if n.startswith(PREFIX)]
    out.sort(key=lambda r: (r[1], -r[2]))
    return tuple(out)


def ranges(window, name: str = None) -> list:
    """The dogleg.* ranges (or those called `name`) clipped to the window's
    [lo, hi]: [(name, start_us, end_us)], those outside it left out."""
    out = []
    for n, s, e in _host(window):
        s, e = max(s, window.lo), min(e, window.hi)
        if e > s and (name is None or n == name):
            out.append((n, s, e))
    return out


@functools.lru_cache(maxsize=1)
def calls(window) -> tuple:
    """One dict a dogleg.call whole inside [lo, hi] and inside no other
    call: "call" its microseconds and, for each span name inside it, the
    microseconds of those ranges summed ("dogleg.route" less the
    "dogleg.plan" ranges inside it: its self time)."""
    whole, call = [], None      # call: (end, its ranges or None)
    for n, s, e in _host(window):
        if call is not None and e <= call[0]:
            if call[1] is not None:
                call[1].append((n, s, e))
        elif n == CALL:
            inside = window.lo <= s and e <= window.hi
            call = (e, [] if inside else None)
            if inside:
                whole.append((e - s, call[1]))
        else:
            call = None
    out = []
    for us, children in whole:
        d = {"call": us}
        routes = [(s, e) for n, s, e in children if n == "dogleg.route"]
        for n, s, e in children:
            d[n] = d.get(n, 0.0) + (e - s)
            if n == "dogleg.plan" and any(rs <= s and e <= re
                                          for rs, re in routes):
                d["dogleg.route"] -= e - s
        out.append(d)
    return tuple(out)


def per_call(window, name: str) -> list:
    """Microseconds of `name` in each whole call that has it (the route's
    self time for dogleg.route)."""
    return [c[name] for c in calls(window) if name in c]


def overlap_us(a, b) -> float:
    """Microseconds that two lists of sorted, disjoint intervals share."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if e > s:
            total += e - s
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_in_call_share(window):
    """The share of the window, %, in which the device is idle and the host
    is inside a dogleg.call; None without a device operation or a call."""
    if window is None or window.window_s <= 0 or window.busy_s <= 0:
        return None
    inside = union(sorted(ranges(window, CALL), key=lambda r: r[1]),
                   window.lo, window.hi)
    if not inside:
        return None
    in_call = sum(e - s for s, e in inside)
    idle = in_call - overlap_us(inside, window.busy)
    return 100.0 * idle * 1e-6 / window.window_s
