"""Kernel K1's plain twin (ops/mega.py::megakernel_optimize_reference)
against the JAX whole-solve Pallas kernel, run in interpret mode as
tests/test_pallas_mega.py runs it, on the same numpy-made inputs.

In float64 decisions must be identical. In float32 the two sides reduce in
different orders and knife-edge threshold ties may flip, so the float32 test
holds the tolerances of tests/test_pallas_mega.py:74-88. The CUDA kernel
itself is compared with this twin by tests/test_torch_cuda.py and
chip_smoke.py on a card.
"""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libdogleg_tpu as dl
import libdogleg_tpu.models.quadratic_surface as jsp
from libdogleg_tpu.ops.pallas_mega import megakernel_optimize as jax_mega
from libdogleg_tpu_torch import DoglegParameters
from libdogleg_tpu_torch.models import quadratic_surface as tsp
from libdogleg_tpu_torch.ops import mega
from libdogleg_tpu_torch.solver import SolveResult

torch.set_num_threads(1)
BENCH = dict(max_iterations=10, Jt_x_threshold=1e-3, update_threshold=1e-5,
             trustregion_threshold=1e-5)


def _instances(seed, batch, dtype):
    rng = np.random.default_rng(seed)
    c = jsp.GRID_MIN + jsp.GRID_DELTA * np.arange(jsp.GRID_WIDTH)
    gx, gy = (a.ravel() for a in np.meshgrid(c, c, indexing="ij"))
    p = jsp.P_TRUE
    truth = (p[0] * p[1] * gx * gx + p[1] * p[2] * gy * gy + p[2] * gx * gy
             + p[3] * gx + p[4] * gy + p[5])
    meas = truth + rng.uniform(size=(batch, truth.size)) - 0.5
    p0 = rng.uniform(size=(batch, jsp.NSTATE)) - 0.1
    return (meas.astype(dtype), p0.astype(dtype), gx.astype(dtype),
            gy.astype(dtype))


def _run_both(seed, batch, dtype, prm_kw):
    meas, p0, gx, gy = _instances(seed, batch, dtype)
    r_j = jax_mega(jsp.products_minor, jnp.asarray(p0),
                   dl.DoglegParameters(**prm_kw),
                   problem_data=(jnp.asarray(meas),),
                   shared_data=(jnp.asarray(gx)[:, None],
                                jnp.asarray(gy)[:, None]),
                   interpret=True)
    before = mega.launch_count
    r_t = mega.megakernel_optimize(*(torch.as_tensor(a)
                                     for a in (p0, meas, gx, gy)),
                                   DoglegParameters(**prm_kw))
    assert mega.launch_count == before  # CPU tensors never launch
    return ({k: np.asarray(v) for k, v in r_j._asdict().items()
             if v is not None},
            {k: v.numpy() for k, v in r_t._asdict().items() if v is not None})


def test_twin_f64_decisions_match_pallas_kernel():
    j, t = _run_both(0, 128, np.float64, {})
    for field in ("step_count", "n_attempts", "reason"):
        np.testing.assert_array_equal(t[field], j[field], err_msg=field)
    np.testing.assert_allclose(t["p"], j["p"], rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(t["JtJ"], j["JtJ"], rtol=1e-10)
    np.testing.assert_allclose(t["trustregion"], j["trustregion"],
                               rtol=1e-10)
    np.testing.assert_array_equal(t["lam"], j["lam"])


def test_twin_f32_benchmark_config_matches_pallas_kernel():
    j, t = _run_both(1, 256, np.float32, BENCH)
    assert t["p"].dtype == np.float32
    same = ((t["step_count"] == j["step_count"])
            & (t["n_attempts"] == j["n_attempts"]))
    assert np.mean(same) > 0.85
    np.testing.assert_allclose(t["norm2_x"], j["norm2_x"], rtol=1e-2,
                               atol=1e-4)
    np.testing.assert_allclose(t["p"][same], j["p"][same], rtol=1e-2,
                               atol=1e-3)
    err = np.abs(t["p"] - jsp.P_TRUE[None])
    assert np.mean(np.all(err < 0.2, axis=1)) > 0.95


def test_products_minor_matches_per_element_and_jax():
    meas, p0, gx, gy = _instances(2, 5, np.float64)
    Tm, Tp = torch.as_tensor(meas), torch.as_tensor(p0)
    X, Y = torch.as_tensor(gx)[:, None], torch.as_tensor(gy)[:, None]
    n2, jtx, jtj = tsp.products_minor(Tp.t(), Tm.t(), X, Y)
    jn2, jjtx, jjtj = jsp.products_minor(jnp.asarray(p0.T),
                                         jnp.asarray(meas.T),
                                         jnp.asarray(gx)[:, None],
                                         jnp.asarray(gy)[:, None])
    for a, b in ((n2, jn2), (jtx, jjtx), (jtj, jjtj)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12)
    for i in range(5):
        one = tsp.products(Tp[i], Tm[i])
        np.testing.assert_allclose(one.norm2_x.numpy(), n2[0, i].numpy(),
                                   rtol=1e-12)
        np.testing.assert_allclose(one.JtJ.numpy(), jtj[..., i].numpy(),
                                   rtol=1e-12)


def test_wrapper_rejects_bad_inputs():
    meas, p0, gx, gy = (torch.as_tensor(a)
                        for a in _instances(3, 4, np.float64))
    with pytest.raises(ValueError, match="p0"):
        mega.megakernel_optimize(p0[:, :5], meas, gx, gy)
    with pytest.raises(ValueError, match="meas"):
        mega.megakernel_optimize(p0, meas[:, :99], gx, gy)
    with pytest.raises(ValueError, match="dtype"):
        mega.megakernel_optimize(p0, meas.float(), gx, gy)
    with pytest.raises(ValueError, match="float32 or float64"):
        mega.megakernel_optimize(p0.half(), meas.half(), gx.half(),
                                 gy.half())


# The general device function's order of summation (grouped_products_reference),
# against the JAX products and the per-element PyTorch products.

_JAX_PRODUCTS = {}


def _jax_products_minor(p0, meas, gx, gy):
    """jsp.products_minor, jitted once for the module, batch-leading."""
    import jax
    fn = _JAX_PRODUCTS.setdefault("fn", jax.jit(jsp.products_minor))
    n2, jtx, jtj = fn(jnp.asarray(p0.T), jnp.asarray(meas.T),
                      jnp.asarray(gx)[:, None], jnp.asarray(gy)[:, None])
    return (np.asarray(n2)[0], np.asarray(jtx).T,
            np.moveaxis(np.asarray(jtj), -1, 0))


@pytest.mark.parametrize("group", [1, 2, 4, 8, 16])
def test_grouped_reference_matches_jax_products_minor(group):
    meas, p0, gx, gy = _instances(4, 37, np.float64)
    want = _jax_products_minor(p0, meas, gx, gy)
    got = mega.grouped_products_reference(
        *(torch.as_tensor(a) for a in (p0, meas, gx, gy)), group)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-12)
    # products_device on CPU tensors: its twin, in the kernel's layout
    dev = mega.products_device(
        *(torch.as_tensor(a) for a in (p0, meas, gx, gy)))
    for d, w in zip(dev, want):
        np.testing.assert_allclose(d.numpy(), w, rtol=1e-12)


@pytest.mark.parametrize("group", [1, 2, 4, 8, 16])
def test_grouped_reference_matches_per_element_products_f32(group):
    meas, p0, gx, gy = (torch.as_tensor(a)
                        for a in _instances(5, 6, np.float32))
    near = torch.as_tensor(jsp.P_TRUE, dtype=torch.float32) + 1e-2 * p0
    for p in (p0, near):
        n2, jtx, jtj = mega.grouped_products_reference(p, meas, gx, gy, group)
        for i in range(p.shape[0]):
            one = tsp.products(p[i], meas[i])
            np.testing.assert_allclose(n2[i].numpy(), one.norm2_x.numpy(),
                                       rtol=1e-5)
            for g, w in ((jtx[i], one.Jt_x), (jtj[i], one.JtJ)):
                np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5)


@pytest.mark.parametrize("group", [1, 4, 16])
def test_products_magnitude_bounds_float32_rounding(group):
    """The grouped order in float32 is within 1e-5 of products_magnitude of
    the float64 products, at the starts and near the truth, where x cancels
    ~1e3 to ~0.5; the magnitude bounds each product."""
    meas, p0, gx, gy = (torch.as_tensor(a)
                        for a in _instances(8, 64, np.float64))
    near = torch.as_tensor(jsp.P_TRUE) + 1e-2 * p0
    for p in (p0, near):
        exact = mega.grouped_products_reference(p, meas, gx, gy, 1)
        got = mega.grouped_products_reference(
            *(t.float() for t in (p, meas, gx, gy)), group)
        for g, w, m in zip(got, exact,
                           mega.products_magnitude(p, meas, gx, gy)):
            assert bool((w.abs() <= m * (1 + 1e-12)).all())
            assert bool(((g.double() - w).abs() <= 1e-5 * m).all())


def test_grouped_reference_rejects_a_group_that_is_no_power_of_two():
    meas, p0, gx, gy = (torch.as_tensor(a)
                        for a in _instances(3, 2, np.float64))
    for group in (0, 3, 64):
        with pytest.raises(ValueError, match="power of two"):
            mega.grouped_products_reference(p0, meas, gx, gy, group)


def test_kernels_read_their_inputs_in_place():
    """The general kernel reads meas (B, 100) as the caller holds it, the
    factored one each statistic through its own pointer: no transposing
    copy and no concatenation where the tensors are contiguous, a
    contiguous copy where one is not."""
    meas, p0, gx, gy = (torch.as_tensor(a)
                        for a in _instances(6, 9, np.float64))
    ins = mega._general_inputs(p0, meas, gx, gy)
    assert all(a is b for a, b in zip(ins, (p0, meas, gx, gy)))
    strided = meas.t().contiguous().t()
    ins = mega._general_inputs(p0, strided, gx, gy)
    assert ins[1].is_contiguous() and torch.equal(ins[1], meas)
    hh, hl, nh, nl = tsp.factored_statistics(meas)
    G = tsp.gram_pair(torch.float64, "cpu")
    for n2m in ((nh, nl), (nh[:, None], nl[:, None])):
        args = (p0, hh, hl, *n2m, G)
        ins = mega._factored_inputs(*args)
        assert len(ins) == 7
        assert all(a is b for a, b in zip(ins, (p0, hh, hl, *n2m, *G)))
    ins = mega._factored_inputs(p0, hh.t().contiguous().t(), hl, nh, nl, G)
    assert ins[1].is_contiguous() and torch.equal(ins[1], hh)


def test_grid_cache_built_once_per_dtype_and_device():
    made = tsp.make_grid(torch.float32, "cpu")
    first = tsp._cached_grid(torch.float32, "cpu")
    assert tsp._cached_grid(torch.float32, torch.device("cpu")) is first
    for c, m in zip(first, made):
        assert c.dtype == torch.float32 and torch.equal(c, m)
    other = tsp._cached_grid(torch.float64, "cpu")
    assert other is not first and other[0].dtype == torch.float64
    # make_grid still hands out fresh tensors a caller may write to
    again = tsp.make_grid(torch.float32, "cpu")
    assert all(a is not c for a, c in zip(again, first))
    # the statistics transform takes the cached grid
    meas = torch.as_tensor(_instances(7, 3, np.float64)[0])
    hh, _, _, _ = tsp.factored_statistics(meas)
    basis = tsp.basis(*tsp.make_grid(torch.float64, "cpu"))
    np.testing.assert_allclose(hh.numpy(), (meas @ basis).numpy(),
                               rtol=1e-12)


def test_parameter_struct_built_once_per_parameters():
    prm = DoglegParameters(**BENCH)
    c = mega._c_params(prm)
    assert mega._c_params(DoglegParameters(**BENCH)) is c
    assert mega._c_params(DoglegParameters()) is not c
    for name, _ in mega._MegaParams._fields_:
        want = (prm.resolved_max_attempts() if name == "max_attempts"
                else getattr(prm, name))
        assert getattr(c, name) == want, name


# The CUDA branch of K1's three wrappers without a card: meta tensors stand
# for the card's, and stand-ins for the launcher (csrc/launch.cpp) and the
# libraries record what the wrappers hand them.

class _Library:
    """A library's solve entries, each a C function pointer with an
    address, as ctypes binds them."""

    def __init__(self, *names):
        self.callbacks = []
        for name in names:
            fn = ctypes.CFUNCTYPE(ctypes.c_int)(lambda: 0)
            self.callbacks.append(fn)
            setattr(self, name, fn)

    def address(self, name):
        return ctypes.cast(getattr(self, name), ctypes.c_void_p).value


class _Launcher:
    """Records each call (function, arguments, the spans open around it)
    and returns nine meta tensors in SolveResult's order."""

    def __init__(self, open_spans):
        self.open_spans, self.calls = open_spans, []

    def _record(self, name, entry, params, p0, *rest):
        self.calls.append((name, entry, params, p0, rest,
                           list(self.open_spans)))
        B, n = p0.shape
        f = dict(dtype=p0.dtype, device="meta")
        i = dict(dtype=torch.int32, device="meta")
        return (torch.empty(B, n, **f), torch.empty(B, **f),
                torch.empty(B, n, **f), torch.empty(B, n, n, **f),
                torch.empty(B, **i), torch.empty(B, **i), torch.empty(B, **i),
                torch.empty(B, **f), torch.empty(B, **f))

    def general(self, *args):
        return self._record("general", *args)

    def factored(self, *args):
        return self._record("factored", *args)

    def generated(self, *args):
        return self._record("generated", *args)


@pytest.fixture
def stand_ins(monkeypatch):
    import contextlib

    from libdogleg_tpu_torch.native import loader
    open_spans = []

    @contextlib.contextmanager
    def span(name):
        open_spans.append(name)
        try:
            yield
        finally:
            open_spans.pop()
    launcher = _Launcher(open_spans)
    library = _Library("dogleg_mega_f32", "dogleg_mega_f64",
                       "dogleg_mega_factored_f32", "dogleg_mega_factored_f64")
    monkeypatch.setattr(mega, "span", span)
    monkeypatch.setattr(loader, "load_launcher", lambda: launcher)
    monkeypatch.setattr(loader, "load_library", lambda: library)
    monkeypatch.setattr(mega, "_ENTRIES", {})
    return launcher, library


class _Kernel:
    """A generated kernel as parallel/mega_auto.GeneratedKernel holds it:
    its source's Nstate and data sizes, the trace's constants, its
    library."""

    def __init__(self, nstate, data_numel, consts):
        import types
        self.source = types.SimpleNamespace(nstate=nstate,
                                            data_numel=data_numel)
        self.adapted = types.SimpleNamespace(consts=consts)
        self.lib = _Library("dogleg_auto_solve_f32", "dogleg_auto_solve_f64")

    def library(self):
        return self.lib


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("wrapper", ["general", "factored", "generated",
                                     "generated, its own constants"])
def test_cuda_branch_hands_the_launcher_its_arguments(stand_ins, wrapper,
                                                      dtype):
    """Each wrapper's CUDA branch makes one launcher call inside a
    `dogleg.launch` span, with the solve entry's address, the parameter
    struct's and the tensors as given; returns the launcher's nine outputs
    as a SolveResult and counts one launch."""
    launcher, library = stand_ins
    meta = dict(dtype=dtype, device="meta")
    B, prm = 16, DoglegParameters(**BENCH)
    p0 = torch.empty(B, 6, **meta)
    suffix = "_f32" if dtype == torch.float32 else "_f64"
    if wrapper == "general":
        tensors = (torch.empty(B, 100, **meta), torch.empty(100, **meta),
                   torch.empty(100, **meta))
        count = "launch_count"
        call = lambda: mega.megakernel_optimize(p0, *tensors, prm)  # noqa
        want = ("general", library.address("dogleg_mega" + suffix), tensors)
    elif wrapper == "factored":
        stats = [torch.empty(B, 6, **meta) for _ in range(2)] + [
            torch.empty(B, **meta) for _ in range(2)]
        G = (torch.empty(6, 6, **meta), torch.empty(6, 6, **meta))
        count = "factored_launch_count"
        call = lambda: mega.megakernel_optimize_factored(  # noqa
            p0, *stats, G, prm)
        want = ("factored", library.address("dogleg_mega_factored" + suffix),
                (*stats, *G))
    else:
        traced = (torch.empty(100, **meta), torch.empty(100, **meta))
        consts = (None if wrapper == "generated" else
                  (torch.empty(100, device="meta"),))
        kernel = _Kernel(6, (100,), traced)
        leaves = (torch.empty(B, 100, **meta),)
        count = "auto_launch_count"
        call = lambda: mega.megakernel_optimize_generated(  # noqa
            kernel, p0, leaves, prm, consts)
        want = ("generated", kernel.lib.address("dogleg_auto_solve" + suffix),
                (6, leaves, (100,), traced if consts is None else consts))
    before = getattr(mega, count)
    r = call()
    assert getattr(mega, count) == before + 1
    (name, entry, params, p, rest, spans), = launcher.calls
    assert (name, entry) == want[:2] and entry
    assert params == ctypes.addressof(mega._c_params(prm))
    assert p is p0 and spans == ["dogleg.launch"]
    assert len(rest) == len(want[2])
    for got, expected in zip(rest, want[2]):
        if isinstance(expected, tuple):
            assert len(got) == len(expected)
            assert all(a is b for a, b in zip(got, expected))
        else:
            assert got is expected
    assert isinstance(r, SolveResult) and r.history is None
    assert r.p.shape == (B, 6) and r.JtJ.shape == (B, 6, 6)
    assert r.norm2_x.dtype == dtype and r.reason.dtype == torch.int32
    # a second call reads the entry's address from the cache
    call()
    assert launcher.calls[1][1] == entry


def test_entry_address_looked_up_once_a_library():
    """The solve entry's address is read once for each library, entry and
    dtype, then from the cache."""
    looked = []

    class Counting(_Library):
        def __getattribute__(self, name):
            if name.startswith("dogleg_"):
                looked.append(name)
            return object.__getattribute__(self, name)
    a = Counting("dogleg_mega_f32", "dogleg_mega_f64")
    b = Counting("dogleg_mega_f32")
    first = mega._entry(a, "dogleg_mega", torch.float32)
    assert first == a.address("dogleg_mega_f32")
    assert mega._entry(a, "dogleg_mega", torch.float32) == first
    assert looked.count("dogleg_mega_f32") == 2   # the lookup, address()
    assert mega._entry(a, "dogleg_mega", torch.float64) == a.address(
        "dogleg_mega_f64")
    assert mega._entry(b, "dogleg_mega", torch.float32) == b.address(
        "dogleg_mega_f32") != first


def test_cpu_run_builds_nothing(monkeypatch):
    """CPU tensors take each wrapper's plain twin: nothing is built or
    loaded (no launcher, no kernel library, no generated library) and no
    launch is counted."""
    from libdogleg_tpu_torch.native import loader
    from libdogleg_tpu_torch.parallel import mega_auto
    from libdogleg_tpu_torch.solver import Products

    def refused(*args, **kwargs):
        raise AssertionError("a CPU run built or loaded a native library")
    for name in ("build", "load_library", "build_launcher", "load_launcher",
                 "build_generated", "load_generated"):
        monkeypatch.setattr(loader, name, refused)
    meas, p0, gx, gy = (torch.as_tensor(a)
                        for a in _instances(11, 4, np.float64))
    prm = DoglegParameters(**BENCH)
    G = tsp.gram_pair(torch.float64, "cpu")

    def products(p, m):
        x = tsp.model(p, gx, gy) - m
        J = tsp.jacobian(p, gx, gy)
        return Products(norm2_x=x @ x, Jt_x=J.T @ x, JtJ=J.T @ J)
    plan = mega_auto.plan_megakernel(products, p0, None, problem_data=meas,
                                     forced=True)
    counts = (mega.launch_count, mega.factored_launch_count,
              mega.auto_launch_count)
    results = [
        mega.megakernel_optimize(p0, meas, gx, gy, prm),
        mega.megakernel_optimize_factored(
            p0, *tsp.factored_statistics(meas), G, prm),
        mega.megakernel_optimize_generated(plan.kernel, p0, plan.data_leaves,
                                           prm, plan.consts)]
    assert (mega.launch_count, mega.factored_launch_count,
            mega.auto_launch_count) == counts
    for r in results:
        assert r.p.device.type == "cpu" and bool((r.reason > 0).all())
    assert loader._LAUNCHER is None
