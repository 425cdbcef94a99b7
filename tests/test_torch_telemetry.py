"""The port's spans (libdogleg_tpu_torch/telemetry.py) and its set-up
counters: with no profiler a span is one shared no-op that never enters a
profiler range; under torch.profiler one call's spans nest in its
`dogleg.call` and are listed as host operations, not user annotations;
mega_auto.trace_seconds counts the plan cache's misses and
loader.native_seconds the loads of libraries not loaded yet.

This file imports no jax. The card's case (`dogleg.launch`, and that the
spans have no mirror on the device's timeline) runs with
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_telemetry.py
"""

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from libdogleg_tpu_torch import DoglegParameters, Products, telemetry
from libdogleg_tpu_torch.models import quadratic_surface as qs
from libdogleg_tpu_torch.native import loader
from libdogleg_tpu_torch.ops import mega
from libdogleg_tpu_torch.parallel import (batched_optimize,
                                          batched_optimize_compacted,
                                          mega_auto)

PRM = DoglegParameters(max_iterations=10)
ENTRIES = {"batched_optimize": batched_optimize,
           "batched_optimize_compacted": batched_optimize_compacted}


def _problem(device, batch=16, dtype=torch.float32):
    g = torch.Generator().manual_seed(3)
    meas = qs.simulate(g, dtype, "cpu", batch=(batch,)).to(device)
    p0 = qs.initial_state(g, dtype, "cpu", batch=(batch,)).to(device)
    return p0, meas


def _closure(device, dtype=torch.float32, scale=1.0):
    """The sample problem as a user writes it in torch, closed over the
    grid and a scalar."""
    gx, gy = qs.make_grid(dtype, device)

    def products(p, m):
        x = qs.model(p, gx, gy) * scale - m
        J = qs.jacobian(p, gx, gy) * scale
        return Products(norm2_x=x @ x, Jt_x=J.T @ x, JtJ=J.T @ J)
    return products


def _spans(prof):
    """The host's dogleg.* ranges: [(name, parent's name)] in order."""
    out = []
    for ev in prof.events():
        if ev.device_type == DeviceType.CPU and ev.name.startswith("dogleg."):
            parent = ev.cpu_parent
            out.append((ev.name, parent.name if parent is not None else None))
    return out


def test_span_off_is_the_shared_noop(monkeypatch):
    def refused(name):
        raise AssertionError(f"a profiler range {name!r} entered")
    monkeypatch.setattr(telemetry, "record_function", refused)
    monkeypatch.setattr(telemetry, "_RANGE", refused)
    assert not torch.autograd.profiler._is_profiler_enabled
    a, b = telemetry.span("dogleg.call"), telemetry.span("dogleg.route")
    assert a is b
    with a:
        with b:
            pass
    # a whole call, every span of it off
    p0, meas = _problem("cpu")
    r = batched_optimize(qs.products, p0, PRM, problem_data=meas,
                         use_megakernel=True)
    assert bool((r.reason > 0).all())


@pytest.mark.parametrize("entry", sorted(ENTRIES))
@pytest.mark.parametrize("products", ["named", "closure"])
def test_spans_nest_in_the_call(entry, products):
    p0, meas = _problem("cpu")
    fn = qs.products if products == "named" else _closure("cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        r = ENTRIES[entry](fn, p0, PRM, problem_data=meas,
                           use_megakernel=True)
    assert bool((r.reason > 0).all())
    want = [("dogleg.call", None), ("dogleg.route", "dogleg.call")]
    if products == "closure":
        want.append(("dogleg.plan", "dogleg.route"))
    # the CPU tensors take K1's plain version: no launch
    assert _spans(prof) == want


def test_spans_are_host_operations():
    """The spans are listed as host operations, as aten's are, and not as
    user annotations (which a reader of the host's operations leaves out
    with their mirrors on the device's timeline); a raise inside one
    closes it."""
    p0, meas = _problem("cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        batched_optimize(_closure("cpu"), p0, PRM, problem_data=meas,
                         use_megakernel=True)
        with pytest.raises(ValueError):
            with telemetry.span("dogleg.call"):
                raise ValueError("inside")
    spans = [ev for ev in prof.events() if ev.name.startswith("dogleg.")]
    assert [ev.name for ev in spans] == ["dogleg.call", "dogleg.route",
                                         "dogleg.plan", "dogleg.call"]
    assert not any(getattr(ev, "is_user_annotation", False)
                   for ev in spans)
    assert all(ev.time_range.end >= ev.time_range.start for ev in spans)


def test_trace_seconds_counts_misses_only():
    # a scalar no other test closes over: the first plan is a miss
    fn = _closure("cpu", scale=1.0 + 2.0 ** -12)
    p0, meas = _problem("cpu")
    count, seconds = mega_auto.trace_count, mega_auto.trace_seconds
    plan = mega_auto.plan_megakernel(fn, p0, PRM, problem_data=meas,
                                     forced=True)
    assert plan is not None
    assert mega_auto.trace_count == count + 1
    assert mega_auto.trace_seconds > seconds
    seconds = mega_auto.trace_seconds
    assert mega_auto.plan_megakernel(fn, p0, PRM, problem_data=meas,
                                     forced=True) is not None
    assert mega_auto.trace_count == count + 1
    assert mega_auto.trace_seconds == seconds


def test_native_seconds_counts_loads_only():
    # a generated source no other test builds (its scalar), through g++
    fn = _closure("cpu", torch.float64, scale=1.0 + 2.0 ** -11)
    p0, meas = _problem("cpu", dtype=torch.float64)
    text = mega_auto.plan_megakernel(fn, p0, PRM, problem_data=meas,
                                     forced=True).kernel.source.text
    seconds = loader.native_seconds
    lib = loader.load_generated(text, host=True)
    assert loader.native_seconds > seconds
    seconds = loader.native_seconds
    assert loader.load_generated(text, host=True) is lib
    loader.load_host_library()
    seconds = loader.native_seconds
    loader.load_host_library()
    assert loader.native_seconds == seconds


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("products", ["named", "closure"])
def test_launch_span_on_the_card(cuda, products):
    p0, meas = _problem(cuda, batch=2048)
    fn = qs.products if products == "named" else _closure(cuda)
    batched_optimize(fn, p0, PRM, problem_data=meas)      # builds, plans
    torch.cuda.synchronize()
    counter = "launch_count" if products == "named" else "auto_launch_count"
    launches = getattr(mega, counter)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        batched_optimize(fn, p0, PRM, problem_data=meas)
        torch.cuda.synchronize()
    assert getattr(mega, counter) == launches + 1
    want = [("dogleg.call", None), ("dogleg.route", "dogleg.call")]
    if products == "closure":
        want.append(("dogleg.plan", "dogleg.route"))
    want.append(("dogleg.launch", "dogleg.call"))
    assert _spans(prof) == want
    # the spans are host operations with no mirror on the device's
    # timeline, so the device's operations hold only the kernels
    assert not any(ev.name.startswith("dogleg.") for ev in prof.events()
                   if ev.device_type == DeviceType.CUDA)
    assert not any(getattr(ev, "is_user_annotation", False)
                   for ev in prof.events() if ev.name.startswith("dogleg."))
