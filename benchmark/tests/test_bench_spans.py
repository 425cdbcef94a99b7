"""The program's spans in the traced window (harness/spans.py) and the
per-layer metrics read from them and from the program's set-up counters,
on a CPU profile with hand-made `dogleg.*` ranges (the program's own
`telemetry.span`) and device operations placed on the profile's clock;
and that the spans change nothing that the window's metrics read.

    python -m pytest benchmark/tests -q
"""

from __future__ import annotations

import time
import types

import pytest
import torch
from torch.autograd import DeviceType

from harness import cell as hc
from harness import readers
from harness import spans as sp
from harness import trace as tr

NEW = ("device.idle_share.in_call", "gate.route_us", "auto.plan_us",
       "k1.launch_us", "setup.trace_s", "setup.native_s")
SPAN_METRICS = NEW[:4]
KERNEL = "dogleg_mega_kernel<float, 4>"
KERNEL_US = 1000.0


def _sleep_us(us):
    end = time.perf_counter() + us * 1e-6
    while time.perf_counter() < end:
        pass


def _profile(calls=4, plan=True, mark=None):
    """A CPU profile of `calls` calls as the program marks them (`mark`,
    the program's span by default): call > route (> plan), then launch,
    with host work between the calls."""
    from torch.profiler import ProfilerActivity, profile

    from libdogleg_tpu_torch.telemetry import span
    mark = mark or span
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(calls):
            with mark("dogleg.call"):
                with mark("dogleg.route"):
                    _sleep_us(300)
                    if plan:
                        with mark("dogleg.plan"):
                            _sleep_us(500)
                with mark("dogleg.launch"):
                    _sleep_us(200)
                    torch.zeros(4).add_(1)
            _sleep_us(1500)
    return prof


class _Event(types.SimpleNamespace):
    """A device operation as prof.events() gives one."""


def _device_event(name, start, end):
    return _Event(name=name, time_range=_Event(start=start, end=end),
                  device_type=DeviceType.CUDA,
                  is_user_annotation=False, cpu_parent=None)


class _Profile:
    """A profile's events with a device's beside them: each launch's
    kernel, from the launch's end for KERNEL_US; `drop` leaves the dogleg
    ranges of the host out."""

    def __init__(self, prof, drop=False):
        host = list(prof.events())
        launches = [ev for ev in host if ev.name == "dogleg.launch"]
        device = [_device_event(KERNEL, ev.time_range.end,
                                ev.time_range.end + KERNEL_US)
                  for ev in launches]
        if drop:
            host = [ev for ev in host if not ev.name.startswith("dogleg.")]
        self._events = host + device

    def events(self):
        return self._events


@pytest.fixture(scope="module")
def prof():
    return _profile()


def _ctx(window):
    return hc.Context({}, {}, {"A": {}, "B": {}}, {}, window)


def test_the_spans_leave_what_the_window_read_unchanged(prof):
    with_spans = tr.Window(_Profile(prof), hc.MARKER)
    without = tr.Window(_Profile(prof, drop=True), hc.MARKER)
    for field in ("device", "lo", "hi", "window_s", "busy", "busy_s",
                  "names"):
        assert getattr(with_spans, field) == getattr(without, field), field
    # the spans are host operations: the host's list gains them and
    # nothing else
    assert [h for h in with_spans.host
            if not h[0].startswith(sp.PREFIX)] == without.host
    assert len(with_spans.host) - len(without.host) == 4 * 4
    # the breakdown's device operations and idle gaps are the same; a
    # gap inside a call is now named by the span the host was in
    a, b = with_spans.breakdown(), without.breakdown()
    assert a["device_ops"] == b["device_ops"]
    assert [s for _, s in a["idle_gaps"]] == [s for _, s in b["idle_gaps"]]
    assert all(la == lb or sp.PREFIX in la
               for (la, _), (lb, _) in zip(a["idle_gaps"], b["idle_gaps"]))
    # the spans have no mirror among the device's operations
    assert with_spans.kernel(KERNEL)[1] == 4
    assert with_spans.kernel("dogleg.")[1] == 0


def test_calls_group_the_spans_and_leave_out_the_cut_ones(prof):
    window = tr.Window(_Profile(prof), hc.MARKER)
    # the window opens at the first kernel, inside the first call
    def us(name):
        return [ev.time_range.end - ev.time_range.start
                for ev in prof.events() if ev.name == name]
    host = [ev for ev in prof.events() if ev.name == sp.CALL]
    assert host[0].time_range.start < window.lo <= host[0].time_range.end
    calls = sp.calls(window)
    assert len(calls) == 3
    for k, c in enumerate(calls, start=1):
        assert set(c) == {"call", "dogleg.route", "dogleg.plan",
                          "dogleg.launch"}
        assert c["call"] == us(sp.CALL)[k]
        assert c["dogleg.plan"] == us("dogleg.plan")[k] >= 500
        assert c["dogleg.launch"] == us("dogleg.launch")[k] >= 200
        # the route's self time: its plan left out
        assert c["dogleg.route"] == pytest.approx(
            us("dogleg.route")[k] - us("dogleg.plan")[k])
        assert c["dogleg.route"] >= 300
        assert (c["dogleg.route"] + c["dogleg.plan"] + c["dogleg.launch"]
                <= c["call"])
    # ranges are clipped to the window: the first call's starts at lo
    first = sp.ranges(window, sp.CALL)[0]
    assert first[1] == window.lo


def test_span_readers(prof):
    window = tr.Window(_Profile(prof), hc.MARKER)
    ctx = _ctx(window)
    got = {name: hc.load("metrics", name).read(ctx)
           for name in SPAN_METRICS}
    calls = sp.calls(window)
    assert got["gate.route_us"] == readers.median(
        [c["dogleg.route"] for c in calls])
    assert got["auto.plan_us"] == readers.median(
        [c["dogleg.plan"] for c in calls])
    assert got["k1.launch_us"] == readers.median(
        [c["dogleg.launch"] for c in calls])
    assert (got["gate.route_us"] + got["auto.plan_us"] + got["k1.launch_us"]
            <= readers.median([c["call"] for c in calls]))
    # idle and inside a call: from the window's start, or a kernel's end,
    # to the next call's launch end; checked on a grid of 0.5 us
    inside = [(s, e) for _, s, e in sp.ranges(window, sp.CALL)]
    busy = window.busy
    step, t, idle_in = 0.5, window.lo + 0.25, 0
    while t < window.hi:
        if (any(s <= t < e for s, e in inside)
                and not any(s <= t < e for s, e in busy)):
            idle_in += 1
        t += step
    want = 100.0 * idle_in * step * 1e-6 / window.window_s
    share = got["device.idle_share.in_call"]
    assert share == pytest.approx(want, abs=0.2)
    assert 0 < share <= readers.idle_share(ctx)


def test_no_plan_span_no_plan_reading():
    window = tr.Window(_Profile(_profile(calls=3, plan=False)), hc.MARKER)
    ctx = _ctx(window)
    assert hc.load("metrics", "auto.plan_us").read(ctx) is None
    assert hc.load("metrics", "gate.route_us").read(ctx) >= 250


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_span_readers_without_spans_report_nothing(prof, name):
    """A program without the spans (an older version, say), one that
    marks them as user annotations (record_function), which the window
    leaves out of the host's operations, and a run with no traced window
    or no device operation, read nothing."""
    from torch.profiler import record_function
    reader = hc.load("metrics", name)
    assert reader.read(_ctx(tr.Window(_Profile(prof, drop=True),
                                      hc.MARKER))) is None
    annotated = _Profile(_profile(calls=3, mark=record_function))
    assert reader.read(_ctx(tr.Window(annotated, hc.MARKER))) is None
    assert reader.read(_ctx(None)) is None
    assert reader.read(_ctx(tr.Window(prof, hc.MARKER))) is None


@pytest.mark.parametrize("name", [m["name"] for m in hc.benchmark()[
    "per_layer"] if m["name"] not in NEW])
def test_accepted_metrics_read_as_before(prof, name):
    """Every per-layer metric that the benchmark had reads the same on a
    profile with the program's spans as on the same profile without."""
    records = {"A": {"gate_us": [100.0, 120.0], "call_ms": [0.3, 0.4]},
               "B": {"attempts": [torch.tensor(8000)] * 4}}
    counters = {"A": {"auto_traces": 0}, "B": {"auto_traces": 0}}
    cfg = hc.read_json("configs", "sample-fleet")
    mix = dict(hc.read_json("mixes", "named-B8192"), batch=1000)
    reader = hc.load("metrics", name)
    a = reader.read(hc.Context(cfg, mix, records, counters,
                               tr.Window(_Profile(prof), hc.MARKER)))
    b = reader.read(hc.Context(cfg, mix, records, counters,
                               tr.Window(_Profile(prof, drop=True),
                                         hc.MARKER)))
    assert a == b


@pytest.mark.parametrize("name,module,attr", [
    ("setup.trace_s", "libdogleg_tpu_torch.parallel.mega_auto",
     "trace_seconds"),
    ("setup.native_s", "libdogleg_tpu_torch.native.loader",
     "native_seconds")])
def test_setup_counters(monkeypatch, name, module, attr):
    import importlib
    mod = importlib.import_module(module)
    reader = hc.load("metrics", name)
    monkeypatch.setattr(mod, attr, 2.5)
    assert reader.read(_ctx(None)) == 2.5
    # a program without the counter reads nothing
    monkeypatch.delattr(mod, attr)
    assert reader.read(_ctx(None)) is None


def test_native_s_without_a_load_reads_nothing(monkeypatch):
    from libdogleg_tpu_torch.native import loader
    monkeypatch.setattr(loader, "native_seconds", 0.0)
    assert hc.load("metrics", "setup.native_s").read(_ctx(None)) is None
