"""The plan cache of megakernel auto-promotion
(libdogleg_tpu_torch/parallel/mega_auto.py, plan_megakernel): a later call
with the same function traces nothing and reads the tensors the call's
function closes over, whatever the batch's size; a changed scalar (in a
closure, a global, or read through a module or a class) or per-element
shape traces again, and a function whose key cannot show that a trace
would be the same traces every time.

Each case runs in float64 through the g++ build of the generated source
(the text nvcc compiles, at the card's G) and against the JAX package's
result on the same problem (computed once per module). On config 3's own
problem every decision is JAX's. On the changed problems (a stretched grid,
a scaled model) element 14 ends its third step with max|Jt_x| 3e-9 to 1e-8
against the 1e-8 threshold, sums of terms near 1e3: whether it stops there
(GRADIENT_CONVERGED) or tries a fourth step follows the order of the sums,
and the port's plain version differs from JAX there too. So on those
problems the JAX comparison holds the step counts and p (rtol 1e-10), and
a fresh trace's g++ solve holds every bit.
"""

import functools
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libdogleg_tpu.models.quadratic_surface as jsp
from libdogleg_tpu import DoglegParameters as JParams
from libdogleg_tpu.parallel.batched import batched_optimize as j_batched
from libdogleg_tpu.solver import Products as JProducts
from libdogleg_tpu_torch import DoglegParameters, Products
from libdogleg_tpu_torch.models import quadratic_surface as tsp
from libdogleg_tpu_torch.parallel import batched_optimize, mega_auto
from test_torch_mega_auto import DECISIONS, _host_solve, _setup

torch.set_num_threads(1)
BATCH = 32
# a module global the products below read: a changed value traces again
SCALE = 1.0


def _surface(gx, gy, scale=1.0):
    """Config 3's products, closed over the grid (gx, gy) and a scalar."""
    def products(p, m):
        x = tsp.model(p, gx, gy) * scale - m
        J = tsp.jacobian(p, gx, gy) * scale
        return Products(norm2_x=x @ x, Jt_x=J.T @ x, JtJ=J.T @ J)
    return products


def _grid(stretch=1.0):
    gx, gy = tsp.make_grid(torch.float64, "cpu")
    return gx * stretch, gy * stretch


@functools.lru_cache(maxsize=None)
def _jax_decisions(stretch, scale=1.0):
    """The JAX package's float64 decisions on _setup's problem, its grid
    stretched and its model scaled."""
    meas, p0 = _setup(np.float64, BATCH)
    gx, gy = (a * stretch for a in jsp.make_grid(jnp.float64))

    def products(p, m):
        x = jsp.model(p, gx, gy) * scale - m
        J = jsp.jacobian(p, gx, gy) * scale
        return JProducts(norm2_x=x @ x, Jt_x=J.T @ x, JtJ=J.T @ J)
    r = j_batched(products, jnp.asarray(p0), JParams(),
                  problem_data=jnp.asarray(meas), use_megakernel=False)
    return {f: np.asarray(getattr(r, f)) for f in DECISIONS + ("p",)}


def _inputs():
    meas, p0 = _setup(np.float64, BATCH)
    return torch.as_tensor(meas), torch.as_tensor(p0)


def _plan(products, meas, p0):
    return mega_auto.plan_megakernel(products, p0, None, problem_data=meas,
                                     forced=True)


def _solve(plan):
    """The plan's solve by the g++ build, with the plan's constants."""
    return _host_solve(plan.kernel, plan.p0, plan.data_leaves,
                       DoglegParameters(), plan.consts)


def _assert_jax(got, ref, fields=DECISIONS):
    p, *decisions = got
    for f, g in zip(DECISIONS, decisions):
        if f in fields:
            np.testing.assert_array_equal(g.numpy(), ref[f], err_msg=f)
    np.testing.assert_allclose(p.numpy(), ref["p"], rtol=1e-10, atol=1e-12)


def _fresh(products, meas, p0):
    """A fresh trace's g++ solve of the same problem: no cache."""
    adapted = mega_auto.adapt_products(products, p0[0], meas[0])
    k = mega_auto.GeneratedKernel(
        adapted, mega_auto.generate_source(adapted, torch.float64))
    return k, _host_solve(k, p0, (meas,), DoglegParameters())


def test_second_call_traces_nothing_and_gives_the_same_bits():
    meas, p0 = _inputs()
    products = _surface(*_grid())
    before = mega_auto.trace_count
    first = _plan(products, meas, p0)
    assert mega_auto.trace_count == before + 1
    second = _plan(products, meas, p0)
    assert mega_auto.trace_count == before + 1
    assert second.kernel.source is first.kernel.source
    assert second.kernel.adapted.graph is first.kernel.adapted.graph
    assert first.kernel.source.form == "row"
    # the cache holds none of the first call's tensors; each plan its own
    assert all(c.device.type == "meta" for (k, _) in mega_auto._PLANS.values()
               if isinstance(k, mega_auto.GeneratedKernel)
               for c in k.adapted.consts)
    for plan in (first, second):
        assert plan.kernel.adapted.consts == plan.consts
        assert all(c.device.type == "cpu" for c in plan.consts)
    a, b = _solve(first), _solve(second)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    _assert_jax(b, _jax_decisions(1.0))
    # the public entry point takes the same plan
    r = batched_optimize(products, p0, problem_data=meas, use_megakernel=True)
    assert mega_auto.trace_count == before + 1
    for f in DECISIONS:
        np.testing.assert_array_equal(getattr(r, f).numpy(),
                                      _jax_decisions(1.0)[f])


def test_new_closure_of_the_same_shapes_reads_its_own_values():
    """A new closure over tensors of the same shapes but other values (a
    stretched grid) traces nothing; the plan reads the new tensors and
    takes a fresh trace's decisions, and the JAX package's."""
    meas, p0 = _inputs()
    _plan(_surface(*_grid()), meas, p0)
    gx, gy = _grid(1.25)
    before = mega_auto.trace_count
    cached = _plan(_surface(gx, gy), meas, p0)
    assert mega_auto.trace_count == before
    assert cached.consts[0] is gx or cached.consts[1] is gx
    fresh, want = _fresh(_surface(gx, gy), meas, p0)
    assert fresh.source.text == cached.kernel.source.text
    got = _solve(cached)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    _assert_jax(got, _jax_decisions(1.25), ("step_count",))
    # and it is not the first closure's result
    assert not torch.equal(got[0], _solve(_plan(_surface(*_grid()), meas,
                                                p0))[0])


@pytest.mark.parametrize("change", ["closure scalar", "global scalar",
                                    "batch", "measurements"])
def test_a_changed_scalar_or_shape_traces_again(change, monkeypatch):
    """A changed scalar or per-element shape traces again; a changed batch
    size alone does not."""
    meas, p0 = _inputs()
    gx, gy = _grid()

    def global_scaled(p, m):
        x = tsp.model(p, gx, gy) * SCALE - m
        J = tsp.jacobian(p, gx, gy) * SCALE
        return Products(norm2_x=x @ x, Jt_x=J.T @ x, JtJ=J.T @ J)
    products = global_scaled if change == "global scalar" else _surface(gx, gy)
    _plan(products, meas, p0)
    before = mega_auto.trace_count
    _plan(products, meas, p0)
    assert mega_auto.trace_count == before
    if change == "closure scalar":
        products = _surface(gx, gy, 1.5)
    elif change == "global scalar":
        monkeypatch.setitem(globals(), "SCALE", 1.5)
    elif change == "batch":
        meas, p0 = meas[:16], p0[:16]
    else:
        products, meas = _surface(gx[:64], gy[:64]), meas[:, :64]
    plan = _plan(products, meas, p0)
    # a new batch size is not seen by the trace: the same kernel
    assert mega_auto.trace_count == before + (change != "batch")
    got = _solve(plan)
    fresh, want = _fresh(products, meas, p0)
    assert fresh.source.text == plan.kernel.source.text
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    if change in ("closure scalar", "global scalar"):
        _assert_jax(got, _jax_decisions(1.0, 1.5), ("step_count",))


class _Grid:
    def __init__(self, gx, gy):
        self.gx, self.gy = gx, gy


def test_an_object_the_function_reads_traces_every_call():
    """A closure over an object whose attributes the function reads: the
    key cannot show that the attributes are the same, so every call
    traces, and each takes the decisions of its own values."""
    meas, p0 = _inputs()
    grid = _Grid(*_grid())

    def products(p, m):
        return _surface(grid.gx, grid.gy)(p, m)
    _plan(products, meas, p0)
    before = mega_auto.trace_count
    _plan(products, meas, p0)
    assert mega_auto.trace_count == before + 1
    grid.gx, grid.gy = _grid(1.25)
    plan = _plan(products, meas, p0)
    assert mega_auto.trace_count == before + 2
    got = _solve(plan)
    assert all(torch.equal(x, y) for x, y in
               zip(got, _fresh(_surface(grid.gx, grid.gy), meas, p0)[1]))
    _assert_jax(got, _jax_decisions(1.25), ("step_count",))


def test_a_constant_made_inside_the_function_traces_every_call():
    """A tensor the function makes itself becomes a constant that the key
    does not hold (it could carry values read in Python): no caching."""
    meas, p0 = _inputs()
    gx, gy = _grid()

    def products(p, m):
        half = torch.tensor(0.5, dtype=p.dtype)
        return _surface(gx, gy, 1.0)(p, m * half * 2.0)
    _plan(products, meas, p0)
    before = mega_auto.trace_count
    plan = _plan(products, meas, p0)
    assert mega_auto.trace_count == before + 1
    _assert_jax(_solve(plan), _jax_decisions(1.0))


def test_a_refused_function_is_refused_again_without_a_trace():
    """A function outside the generator (torch.linalg.solve inside) is
    cached as refused: a forced call raises the same error again, an auto
    call gives None, and neither traces."""
    meas, p0 = _inputs()
    products = _surface(*_grid())

    def unsupported(p, m):
        pr = products(p, m)
        return Products(norm2_x=pr.norm2_x, JtJ=pr.JtJ,
                        Jt_x=torch.linalg.solve(pr.JtJ, pr.Jt_x))
    with pytest.raises(mega_auto.UnsupportedProducts, match="linalg"):
        _plan(unsupported, meas, p0)
    before = mega_auto.trace_count
    with pytest.raises(mega_auto.UnsupportedProducts, match="linalg") as e1:
        _plan(unsupported, meas, p0)
    with pytest.raises(mega_auto.UnsupportedProducts, match="linalg") as e2:
        _plan(unsupported, meas, p0)
    assert mega_auto.trace_count == before
    # each call raises an exception of its own; the cache keeps none (and
    # so no frame of a call, nor the tensors they hold)
    assert e1.value is not e2.value
    assert not any(isinstance(k, BaseException)
                   for k, _ in mega_auto._PLANS.values())
    assert mega_auto.plan_megakernel(unsupported, p0, None,
                                     problem_data=meas) is None
    assert mega_auto.trace_count == before


# A module and a class whose attributes the readers below look up, and a
# function reached through the module, which reads its own global.
_model = types.ModuleType("surface_model")
_model.SCALE = 1.0


class _Cfg:
    scale = 1.0


def _scaled(x):
    return x * _model.SCALE


_model.scaled = _scaled
_READERS = {
    "module attribute": lambda x: x * _model.SCALE,
    "class attribute": lambda x: x * _Cfg.scale,
    "module function": lambda x: _model.scaled(x),
}


@pytest.mark.parametrize("where", list(_READERS))
def test_an_attribute_a_function_reads_is_keyed(where, monkeypatch):
    """A scalar read through a module or a class (`model.SCALE`,
    `Cfg.scale`), or by a function reached through a module
    (`model.scaled`), is keyed by its value: an unchanged one traces
    nothing, a changed one traces again and gives a fresh trace's bits and
    the JAX package's decisions."""
    meas, p0 = _inputs()
    gx, gy = _grid()
    read = _READERS[where]

    def products(p, m):
        x = read(tsp.model(p, gx, gy)) - m
        J = read(tsp.jacobian(p, gx, gy))
        return Products(norm2_x=x @ x, Jt_x=J.T @ x, JtJ=J.T @ J)
    _plan(products, meas, p0)
    before = mega_auto.trace_count
    first = _plan(products, meas, p0)
    assert mega_auto.trace_count == before
    if where == "class attribute":
        monkeypatch.setattr(_Cfg, "scale", 1.5)
    else:
        monkeypatch.setattr(_model, "SCALE", 1.5)
    plan = _plan(products, meas, p0)
    assert mega_auto.trace_count == before + 1
    assert plan.kernel.source.text != first.kernel.source.text
    got = _solve(plan)
    fresh, want = _fresh(products, meas, p0)
    assert fresh.source.text == plan.kernel.source.text
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    _assert_jax(got, _jax_decisions(1.0, 1.5), ("step_count",))
