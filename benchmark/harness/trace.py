"""Reading a torch.profiler trace of the traced window: the device's
operations as intervals, their union (busy time), time by name, and the
idle gaps between them, each named by what the host was doing then."""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def profiled():
    """A profiler over the host's and the device's activity; yields an
    object whose `prof` is the finished profile after the block."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    box = type("Profiled", (), {})()
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield box
    box.prof = prof


def intervals(prof):
    """(device, host): the device's operations as (name, start_us, end_us)
    and the host's as (name, start_us, end_us, depth) on the same clock."""
    from torch.autograd import DeviceType
    device, host = [], []
    for ev in prof.events():
        start, end = ev.time_range.start, ev.time_range.end
        if getattr(ev, "is_user_annotation", False):
            continue        # a host range's mirror on the device's timeline
        if ev.device_type == DeviceType.CUDA:
            device.append((ev.name, start, end))
        elif ev.device_type == DeviceType.CPU:
            depth = 0
            parent = ev.cpu_parent
            while parent is not None:
                depth += 1
                parent = parent.cpu_parent
            host.append((ev.name, start, end, depth))
    device.sort(key=lambda e: e[1])
    return device, host


def union(device, lo, hi):
    """The device's busy intervals inside [lo, hi], merged: [(start, end)]."""
    merged = []
    for _, s, e in device:
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def by_name(device):
    """Seconds of device time and counts by operation name."""
    out = {}
    for name, s, e in device:
        t, n = out.get(name, (0.0, 0))
        out[name] = (t + (e - s) * 1e-6, n + 1)
    return out


def _host_at(host, t):
    """What the host was doing at t: the innermost host operations that
    span t, outermost first, joined by ' > '; 'host idle' where none."""
    spans = sorted((h for h in host if h[1] <= t < h[2]), key=lambda h: h[3])
    names = [h[0] for h in spans]
    return " > ".join(names[-3:]) if names else "host idle"


def gaps(busy, host, lo, hi, top: int = 10):
    """The longest idle gaps in [lo, hi] between busy intervals, each as
    [what the host was doing at its middle, seconds], longest first."""
    edges, last = [], lo
    for s, e in busy:
        if s > last:
            edges.append((last, s))
        last = max(last, e)
    if hi > last:
        edges.append((last, hi))
    edges.sort(key=lambda g: g[1] - g[0], reverse=True)
    return [[_host_at(host, 0.5 * (s + e)), (e - s) * 1e-6]
            for s, e in edges[:top]]


class Window:
    """The traced window as the readers see it: its bounds on the trace's
    clock, the device's operations, the busy union and the breakdown."""

    def __init__(self, prof, marker: str):
        self.device, self.host = intervals(prof)
        marks = [h for h in self.host if h[0] == marker]
        if marks:
            self.lo, self.hi = marks[0][1], marks[0][2]
        else:
            self.lo = min((d[1] for d in self.device), default=0.0)
            self.hi = max((d[2] for d in self.device), default=0.0)
        self.window_s = (self.hi - self.lo) * 1e-6
        self.busy = union(self.device, self.lo, self.hi)
        self.busy_s = sum(e - s for s, e in self.busy) * 1e-6
        self.names = by_name([d for d in self.device
                              if self.lo <= d[1] < self.hi])

    def kernel(self, substring: str):
        """(seconds, count) of the device operations whose name holds
        substring."""
        t = n = 0
        for name, (s, c) in self.names.items():
            if substring in name:
                t, n = t + s, n + c
        return t, n

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.names.items(), key=lambda kv: kv[1][0],
                     reverse=True)[:top]
        return {"device_ops": [[name, s] for name, (s, _) in ops],
                "idle_gaps": gaps(self.busy, self.host, self.lo, self.hi,
                                  top)}
