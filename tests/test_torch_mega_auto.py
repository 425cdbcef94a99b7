"""Megakernel auto-promotion (libdogleg_tpu_torch/parallel/mega_auto.py)
against the JAX package's (libdogleg_tpu/parallel/mega_auto.py).

Replays tests/test_mega_auto.py's decisions on the same inputs, made with
numpy: the port's forced calls run on CPU tensors, where K1's wrapper takes
its plain version (the masked batched solver on the traced graph,
vmapped), and the JAX package's run its Pallas kernel in interpret mode.
Not replayed: forced_mesh_composition (mesh= is not ported; the parallel
layer comes after export) and forced_under_outer_jit (the port has no jit
around which a plan could be traced).

The generated source itself, the text nvcc compiles on the card, is built
here as host C++ with g++ (native/loader.build_generated_host) and called
through ctypes, its G lanes run in turn and summed in the butterfly's
order: its functor against the traced torch function at 1e-12 in float64
for Nstate 3, 6 and 16 and for each supported op alone, and its whole K1
solve against the JAX package's decisions. The row form at one lane is
held to the array form's bits (functor and solve, float32 and float64),
and each op's graph to the form it takes. JAX-side results are computed
once per module.
"""

import ctypes
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libdogleg_tpu.models.curve_fit as jcf
import libdogleg_tpu.models.quadratic_surface as jsp
from libdogleg_tpu import DoglegParameters as JParams
from libdogleg_tpu.parallel.batched import batched_optimize as j_batched
from libdogleg_tpu.parallel.batched import \
    batched_optimize_compacted as j_compacted
from libdogleg_tpu.solver import Products as JProducts
from libdogleg_tpu_torch import DenseNewtonSolver, DoglegParameters, Products
from libdogleg_tpu_torch.models import curve_fit as tcf
from libdogleg_tpu_torch.models import quadratic_surface as tsp
from libdogleg_tpu_torch.native import loader
from libdogleg_tpu_torch.ops import mega
from libdogleg_tpu_torch.parallel import (batched_optimize,
                                          batched_optimize_compacted,
                                          mega_auto)

torch.set_num_threads(1)
F32_PRM = dict(max_iterations=10, Jt_x_threshold=1e-3, update_threshold=1e-5,
               trustregion_threshold=1e-5)
DECISIONS = ("step_count", "n_attempts", "reason")


def _setup(dtype, batch, seed=0):
    """tests/test_mega_auto.py's problem with numpy inputs: measurements
    (truth + U(-0.5, 0.5)) and starts U(-0.1, 0.9), as numpy arrays."""
    rng = np.random.default_rng(seed)
    gx, gy = (np.asarray(a, np.float64) for a in jsp.make_grid(jnp.float64))
    meas = (np.asarray(jsp.model(jnp.asarray(jsp.P_TRUE), jnp.asarray(gx),
                                 jnp.asarray(gy)))
            + rng.uniform(size=(batch, jsp.NMEAS)) - 0.5)
    p0 = rng.uniform(size=(batch, jsp.NSTATE)) - 0.1
    return meas.astype(dtype), p0.astype(dtype)


def _jax_products(dtype):
    gx, gy = jsp.make_grid(dtype)

    def products(p, m):
        x = jsp.model(p, gx, gy) - m
        J = jsp.jacobian(p, gx, gy)
        return JProducts(norm2_x=x @ x, Jt_x=J.T @ x, JtJ=J.T @ J)
    return products


def _torch_products(dtype, device="cpu"):
    """The same closure in torch: no device function named."""
    gx, gy = tsp.make_grid(dtype, device)

    def products(p, m):
        x = tsp.model(p, gx, gy) - m
        J = tsp.jacobian(p, gx, gy)
        return Products(norm2_x=x @ x, Jt_x=J.T @ x, JtJ=J.T @ J)
    return products


@functools.lru_cache(maxsize=None)
def _jax_result(name, batch, forced, shared=False, compacted=False):
    dtype = np.float64 if name == "f64" else np.float32
    meas, p0 = _setup(dtype, batch)
    prm = JParams() if name == "f64" else JParams(**F32_PRM)
    products = _jax_products(jnp.dtype(dtype))
    fn = j_compacted if compacted else j_batched
    if shared:
        m0 = jnp.asarray(meas[0])
        r = fn(lambda p: products(p, m0), jnp.asarray(p0), prm,
               use_megakernel=forced)
    else:
        r = fn(products, jnp.asarray(p0), prm, problem_data=jnp.asarray(meas),
               use_megakernel=forced)
    return {f: np.asarray(getattr(r, f)) for f in DECISIONS + ("p", "JtJ")}


def _assert_decisions_equal(r, ref):
    for f in DECISIONS:
        np.testing.assert_array_equal(getattr(r, f).numpy(), ref[f],
                                      err_msg=f)


def _port(batch, forced, dtype=torch.float64, shared=False, compacted=False,
          prm=None):
    meas, p0 = (torch.as_tensor(a, dtype=dtype)
                for a in _setup(np.float64, batch))
    products = _torch_products(dtype)
    fn = batched_optimize_compacted if compacted else batched_optimize
    if shared:
        m0 = meas[0]
        return fn(lambda p: products(p, m0), p0, prm, use_megakernel=forced)
    return fn(products, p0, prm, problem_data=meas, use_megakernel=forced)


def test_forced_f64_decision_exact():
    before = mega.auto_launch_count
    r = _port(128, True)
    assert mega.auto_launch_count == before   # CPU tensors: no launch
    ref = _jax_result("f64", 128, True)
    _assert_decisions_equal(r, ref)
    np.testing.assert_allclose(r.p.numpy(), ref["p"], rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(r.JtJ.numpy(), ref["JtJ"], rtol=1e-10,
                               atol=1e-10)
    _assert_decisions_equal(r, _jax_result("f64", 128, False))


def test_forced_padding_non_multiple_batch():
    """B=100 is no multiple of the JAX package's lane tiles (it pads); K1
    takes any batch: the result is full-size and exact."""
    r = _port(100, True)
    assert r.p.shape == (100, tsp.NSTATE)
    ref = _jax_result("f64", 100, True)
    _assert_decisions_equal(r, ref)
    np.testing.assert_allclose(r.p.numpy(), ref["p"], rtol=1e-10, atol=1e-12)


def test_forced_shared_problem_data_none():
    """No problem_data: the measurements the function closes over become
    one more hoisted constant."""
    r = _port(128, True, shared=True)
    ref = _jax_result("f64", 128, True, shared=True)
    _assert_decisions_equal(r, ref)
    np.testing.assert_allclose(r.p.numpy(), ref["p"], rtol=1e-10, atol=1e-12)


def test_compacted_promotion_matches():
    r = _port(128, True, compacted=True)
    ref = _jax_result("f64", 128, True, compacted=True)
    _assert_decisions_equal(r, ref)
    np.testing.assert_allclose(r.p.numpy(), ref["p"], rtol=1e-10, atol=1e-12)
    r_plain = _port(128, False, compacted=True)
    _assert_decisions_equal(r_plain, ref)


def test_f32_near_total_agreement():
    r = _port(256, True, dtype=torch.float32,
              prm=DoglegParameters(**F32_PRM))
    ref = _jax_result("f32", 256, True)
    same = r.step_count.numpy() == ref["step_count"]
    assert np.mean(same) > 0.85
    err = np.abs(r.p.double().numpy() - tsp.P_TRUE[None])
    assert np.mean(np.all(err < 0.2, axis=1)) > 0.95


def _meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_auto_is_off_outside_regime():
    """plan_megakernel gives None where K1 is not the path: CPU tensors
    (the plain version is no fast path), a batch under the build's
    amortization floor, Nstate over 16, float64, a structured JtJ (an op
    without generated code: test_unsupported_op_is_outside_the_regime).
    Tensors on the meta device stand for the card: there the regime holds
    at B=2048 float32."""
    meas, p0 = (torch.as_tensor(a) for a in _setup(np.float32, 2048))
    products = _torch_products(torch.float32)
    assert mega_auto.plan_megakernel(products, p0, None,
                                     problem_data=meas) is None
    meta = _torch_products(torch.float32, "meta")
    p0, meas = _meta((2048, 6)), _meta((2048, 100))
    assert mega_auto.plan_megakernel(meta, p0, None,
                                     problem_data=meas) is not None
    assert mega_auto.plan_megakernel(meta, p0[:256], None,
                                     problem_data=meas[:256]) is None
    assert mega_auto.plan_megakernel(
        meta, _meta((2048, 6), torch.float64), None,
        problem_data=_meta((2048, 100), torch.float64)) is None

    def big(p):
        return Products(norm2_x=p @ p, Jt_x=p, JtJ=torch.ones(32, 32))
    assert mega_auto.plan_megakernel(big, _meta((2048, 32)), None) is None

    def structured(p):
        return Products(norm2_x=p @ p, Jt_x=p, JtJ={"diag": p})
    assert mega_auto.plan_megakernel(structured, p0, None) is None


def test_forced_errors_are_loud():
    meas, p0 = (torch.as_tensor(a) for a in _setup(np.float32, 128))
    products = _torch_products(torch.float32)
    with pytest.raises(ValueError, match="record_history"):
        batched_optimize(products, p0, problem_data=meas,
                         record_history=True, use_megakernel=True)
    with pytest.raises(ValueError, match="newton_solver"):
        batched_optimize(products, p0, problem_data=meas,
                         newton_solver=DenseNewtonSolver(),
                         use_megakernel=True)

    def structured(p):
        return Products(norm2_x=p @ p, Jt_x=p,
                        JtJ={"diag": torch.ones_like(p)})
    with pytest.raises(TypeError, match="dense"):
        batched_optimize(structured, p0, use_megakernel=True)
    with pytest.raises(ValueError, match="regime"):
        batched_optimize(products, {"a": p0}, problem_data=meas,
                         use_megakernel=True)


def test_adapter_hoists_consts():
    """The closed-over grid becomes explicit shared inputs, and the graph
    gives the function's products, one element or vmapped."""
    meas, p0 = (torch.as_tensor(a) for a in _setup(np.float32, 128))
    products = _torch_products(torch.float32)
    adapted = mega_auto.adapt_products(products, p0[0], meas[0])
    assert adapted.n_data == 1
    assert len(adapted.consts) >= 2
    assert not any(n.op == "get_attr" for n in adapted.graph.graph.nodes)
    got = torch.func.vmap(adapted.plain)(p0[:8], meas[:8])
    ref = torch.func.vmap(products)(p0[:8], meas[:8])
    for g, w in zip(got, ref):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# The generated source, built as host C++


def _host_library(kernel):
    return loader.load_generated(kernel.source.text, host=True)


def _host_ins(kernel, p, data_leaves, consts=None):
    tensors = [t.contiguous() for t in data_leaves] + [
        c.to(p.dtype).contiguous() for c in
        (kernel.adapted.consts if consts is None else consts)]
    ptrs = (ctypes.c_void_p * max(len(tensors), 1))(
        *(t.data_ptr() for t in tensors))
    return tensors, ptrs


def _host_products(kernel, p, data_leaves, consts=None):
    """The generated functor at p (B, n), run by the g++ build."""
    lib = _host_library(kernel)
    tensors, ptrs = _host_ins(kernel, p, data_leaves, consts)
    B, n = p.shape
    outs = (torch.empty(B, dtype=p.dtype), torch.empty(B, n, dtype=p.dtype),
            torch.empty(B, n, n, dtype=p.dtype))
    entry = (lib.dogleg_auto_host_products_f64 if p.dtype == torch.float64
             else lib.dogleg_auto_host_products_f32)
    assert entry(p.contiguous().data_ptr(), ctypes.addressof(ptrs), B,
                 *(t.data_ptr() for t in outs)) == 0
    assert lib.dogleg_auto_nstate() == n
    assert lib.dogleg_auto_inputs() == len(tensors)
    return outs


def _host_solve_all(kernel, p0, data_leaves, prm, consts=None):
    """The generated K1's whole solve of every element, by the g++ build,
    in p0's dtype: its nine outputs (p, Jt_x, JtJ, norm2_x, trust region,
    lambda, step_count, n_attempts, reason)."""
    lib = _host_library(kernel)
    tensors, ptrs = _host_ins(kernel, p0, data_leaves, consts)
    B, n = p0.shape
    dt = p0.dtype
    outs = ([torch.empty(B, n, dtype=dt), torch.empty(B, n, dtype=dt),
             torch.empty(B, n, n, dtype=dt)]
            + [torch.empty(B, dtype=dt) for _ in range(3)]
            + [torch.empty(B, dtype=torch.int32) for _ in range(3)])
    entry = (lib.dogleg_auto_host_solve_f64 if dt == torch.float64
             else lib.dogleg_auto_host_solve_f32)
    assert entry(
        p0.contiguous().data_ptr(), ctypes.addressof(ptrs), B,
        ctypes.byref(mega._c_params(prm)), *(t.data_ptr() for t in outs)) == 0
    return outs


def _host_solve(kernel, p0, data_leaves, prm, consts=None):
    """The generated K1's whole solve of every element, by the g++ build:
    (p, step_count, n_attempts, reason)."""
    outs = _host_solve_all(kernel, p0, data_leaves, prm, consts)
    return outs[0], outs[6], outs[7], outs[8]


def _assert_products_close(got, want, rtol=1e-12):
    """norm2, Jt_x and JtJ's lower triangle at rtol, each relative to its
    largest value (a sum that cancels is accurate to its terms)."""
    for label, g, w in zip(("norm2", "Jt_x", "JtJ"), got,
                           (want[0], want[1], torch.tril(want[2]))):
        g = torch.tril(g) if label == "JtJ" else g
        scale = float(w.abs().max()) or 1.0
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=rtol,
                                   atol=rtol * scale, err_msg=label)


def _curvefit_case(batch, seed=2):
    """Config 2's curve fit (Nstate 3) as a batch: measurements P_TRUE's
    curve + 0.02 N(0, 1), starts P_TRUE + 0.1 N(0, 1); the products close
    over the sample times. (numpy arrays, torch products, JAX products)."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0.0, 1.0, 64)
    meas = (tcf.P_TRUE[0] * np.exp(tcf.P_TRUE[1] * t) + tcf.P_TRUE[2]
            + 0.02 * rng.normal(size=(batch, 64)))
    p0 = tcf.P_TRUE + 0.1 * rng.normal(size=(batch, 3))
    tt, tj = torch.as_tensor(t), jnp.asarray(t)

    def products(p, m):
        x = tcf.model(p, tt) - m
        J = tcf.jacobian(p, tt)
        return Products(norm2_x=x @ x, Jt_x=J.T @ x, JtJ=J.T @ J)

    def jproducts(p, m):
        x = jcf.model(p, tj) - m
        J = jcf.jacobian(p, tj)
        return JProducts(norm2_x=x @ x, Jt_x=J.T @ x, JtJ=J.T @ J)
    return (meas,), p0, products, jproducts


def _tanh_case(batch, nstate=16, seed=8):
    """Config 8's family (bench_all.py:515-555) at Nstate 16, nmeas 64:
    r = A tanh(B p) + C p - d, one (A, B, C, d) per element."""
    rng = np.random.default_rng(seed)
    nmeas = 4 * nstate
    A = rng.normal(size=(batch, nmeas, nstate))
    Bm = rng.normal(size=(batch, nstate, nstate)) * 0.5 / np.sqrt(nstate)
    C = rng.normal(size=(batch, nmeas, nstate)) * 0.3
    p_true = rng.normal(size=(batch, nstate))
    d = (np.einsum("bms,bs->bm", A,
                   np.tanh(np.einsum("bst,bt->bs", Bm, p_true)))
         + np.einsum("bms,bs->bm", C, p_true)
         + rng.normal(size=(batch, nmeas)) * 0.01)
    p0 = p_true + rng.normal(size=(batch, nstate)) * 0.1

    def products(p, data):
        Ab, Bb, Cb, db = data
        t = torch.tanh(Bb @ p)
        x = Ab @ t + Cb @ p - db
        J = Ab @ ((1.0 - t * t)[:, None] * Bb) + Cb
        return Products(norm2_x=x @ x, Jt_x=J.T @ x, JtJ=J.T @ J)

    def jproducts(p, data):
        Ab, Bb, Cb, db = data
        t = jnp.tanh(Bb @ p)
        x = Ab @ t + Cb @ p - db
        J = Ab @ ((1.0 - t * t)[:, None] * Bb) + Cb
        return JProducts(norm2_x=x @ x, Jt_x=J.T @ x, JtJ=J.T @ J)
    return ((A, Bm, C, d),), p0, products, jproducts


def _surface_case(batch):
    meas, p0 = _setup(np.float64, batch, seed=5)
    return ((meas,), p0, _torch_products(torch.float64),
            _jax_products(jnp.float64))


CASES = {3: _curvefit_case, 6: _surface_case, 16: _tanh_case}


def _case_plan(nstate, batch):
    """(plan, p0, data, torch products, JAX products, numpy inputs) of
    CASES[nstate] in float64, planned by a forced call."""
    arrays, p0, products, jproducts = CASES[nstate](batch)
    data = tuple(torch.as_tensor(a) for a in arrays[0]) \
        if isinstance(arrays[0], tuple) else torch.as_tensor(arrays[0])
    p0_t = torch.as_tensor(p0)
    plan = mega_auto.plan_megakernel(products, p0_t, None,
                                     problem_data=data, forced=True)
    return plan, p0_t, data, products, jproducts, (arrays[0], p0)


@pytest.mark.parametrize("nstate", [3, 6, 16])
def test_generated_functor_matches_torch_function(nstate):
    plan, p0, data, products, _, _ = _case_plan(nstate, 8)
    assert plan.kernel.source.nstate == nstate
    got = _host_products(plan.kernel, p0, plan.data_leaves)
    want = torch.func.vmap(products)(p0, data)
    _assert_products_close(got, want)
    # near the solution too, where Jt_x's sums cancel
    got = _host_products(plan.kernel, p0 * (1 + 1e-3), plan.data_leaves)
    want = torch.func.vmap(products)(p0 * (1 + 1e-3), data)
    _assert_products_close(got, want)


@functools.lru_cache(maxsize=None)
def _jax_case_decisions(nstate, batch):
    arrays, p0, _, jproducts = CASES[nstate](batch)
    data = jnp.asarray(arrays[0]) if not isinstance(arrays[0], tuple) \
        else tuple(jnp.asarray(a) for a in arrays[0])
    r = j_batched(jproducts, jnp.asarray(p0), JParams(), problem_data=data,
                  use_megakernel=False)
    return {f: np.asarray(getattr(r, f)) for f in DECISIONS + ("p",)}


@pytest.mark.parametrize("nstate,batch", [(3, 32), (6, 32), (16, 8)])
def test_generated_solve_takes_jax_decisions(nstate, batch):
    """The generated K1's whole solve (dogleg_solve.cuh on the generated
    functor, built by g++: the row form at the card's G, its lanes run in
    turn and summed in the butterfly's order) takes the JAX package's
    float64 decisions, and so does the forced call's plain version."""
    plan, p0, data, _, _, _ = _case_plan(nstate, batch)
    src = plan.kernel.source
    assert (src.form, src.group) == ("row", mega_auto.ROW_GROUP)
    assert _host_library(plan.kernel).dogleg_auto_group() == src.group
    ref = _jax_case_decisions(nstate, batch)
    p, step_count, n_attempts, reason = _host_solve(
        plan.kernel, p0, plan.data_leaves, DoglegParameters())
    for f, got in zip(DECISIONS, (step_count, n_attempts, reason)):
        np.testing.assert_array_equal(got.numpy(), ref[f], err_msg=f)
    np.testing.assert_allclose(p.numpy(), ref["p"], rtol=1e-10, atol=1e-12)
    r = plan()
    _assert_decisions_equal(r, ref)
    np.testing.assert_allclose(r.p.numpy(), ref["p"], rtol=1e-10, atol=1e-12)


ROWS = {3: 64, 6: 100, 16: 64}


@pytest.mark.parametrize("nstate", [3, 6, 16])
def test_promoted_functions_take_the_row_form(nstate):
    """Configs 2, 3 and 8's functions take the row form at the card's G,
    with config 8's Ab @ t and Bb @ p inner sums over other axes; the
    operations an evaluation are the array form's (the bound counts the
    graph's work whatever form runs it)."""
    plan, *_ = _case_plan(nstate, 4)
    src = plan.kernel.source
    assert (src.form, src.group, src.rows) == (
        "row", mega_auto.ROW_GROUP, ROWS[nstate])
    array = mega_auto.generate_source(plan.kernel.adapted, torch.float64,
                                      _form="array")
    assert (array.form, array.group, array.rows) == ("array", 1, 0)
    assert src.operations == array.operations
    assert src.local_values < array.local_values


def _same_bits(got, want):
    return all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nstate", [3, 6, 16])
def test_row_form_at_one_lane_gives_array_bits(nstate, dtype):
    """At G = 1 each element of the row form does the array form's
    operations in the array form's order: both g++ builds give the same
    bits, for the functor alone (at the starts and near them) and for the
    whole solve, in float32 and float64."""
    plan, p0, _, _, _, _ = _case_plan(nstate, 16)
    a = plan.kernel.adapted
    row, array = (mega_auto.GeneratedKernel(a, mega_auto.generate_source(
        a, torch.float64, _form=form, _group=1)) for form in ("row", "array"))
    assert (row.source.form, array.source.form) == ("row", "array")
    p0 = p0.to(dtype)
    leaves = tuple(t.to(dtype) for t in plan.data_leaves)
    for p in (p0, p0 * (1 + 1e-3)):
        assert _same_bits(_host_products(row, p, leaves),
                          _host_products(array, p, leaves))
    prm = DoglegParameters(**F32_PRM) if dtype == torch.float32 else \
        DoglegParameters()
    assert _same_bits(_host_solve_all(row, p0, leaves, prm),
                      _host_solve_all(array, p0, leaves, prm))


@pytest.mark.parametrize("group", [2, 4, 8])
def test_row_form_lanes_sum_in_the_butterfly_order(group):
    """At G > 1 only the order of the row sums changes: the g++ build at G
    gives Jt_x and JtJ within float64 rounding of the array form's, the
    same decisions in a whole solve, and the library reports its G."""
    plan, p0, _, _, _, _ = _case_plan(6, 16)
    a = plan.kernel.adapted
    k = mega_auto.GeneratedKernel(a, mega_auto.generate_source(
        a, torch.float64, _form="row", _group=group))
    array = mega_auto.GeneratedKernel(a, mega_auto.generate_source(
        a, torch.float64, _form="array"))
    assert _host_library(k).dogleg_auto_group() == group
    _assert_products_close(_host_products(k, p0, plan.data_leaves),
                           _host_products(array, p0, plan.data_leaves))
    got = _host_solve(k, p0, plan.data_leaves, DoglegParameters())
    want = _host_solve(array, p0, plan.data_leaves, DoglegParameters())
    for g, w in zip(got[1:], want[1:]):
        assert torch.equal(g, w)


def _smoke():
    """chip_smoke.py of this tree, for phase 23's inputs."""
    import pathlib
    import sys
    root = str(pathlib.Path(__file__).resolve().parent.parent)
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_smoke
    return chip_smoke


@functools.lru_cache(maxsize=None)
def _jax_phase23(label):
    """The JAX package's float64 decisions on chip_smoke.py phase 23's
    float64 instance of config 3 or config 2 (B=1024)."""
    c = _smoke()
    _, _, p0, data = {x[0]: x for x in c.auto_cases(
        torch.float64, torch.device("cpu"), (c.AUTO_F64_BATCH,) * 3)}[label]
    if label == "config 3":
        jproducts = _jax_products(jnp.float64)
    else:
        t = jnp.asarray(np.linspace(0.0, 1.0, c.CONFIG2_NMEAS))

        def jproducts(p, m):
            x = jcf.model(p, t) - m
            J = jcf.jacobian(p, t)
            return JProducts(norm2_x=x @ x, Jt_x=J.T @ x, JtJ=J.T @ J)
    r = j_batched(jproducts, jnp.asarray(p0.numpy()), JParams(),
                  problem_data=jnp.asarray(data.numpy()),
                  use_megakernel=False)
    return {f: np.asarray(getattr(r, f)) for f in DECISIONS + ("p",)}


@pytest.mark.parametrize("label", ["config 3", "config 2"])
def test_phase23_f64_instances_take_jax_decisions(label):
    """chip_smoke.py phase 23 holds the card's float64 decisions to the
    plain version on the CPU. The g++ build of the same source at the
    card's G (the card's bits where no transcendental function differs)
    takes the JAX package's decisions on those instances, element 587 of
    config 3's too, where max|Jt_x| after the fourth step straddles the
    1e-8 threshold (the array form stops an attempt later there)."""
    c = _smoke()
    _, fn, p0, data = {x[0]: x for x in c.auto_cases(
        torch.float64, torch.device("cpu"), (c.AUTO_F64_BATCH,) * 3)}[label]
    plan = mega_auto.plan_megakernel(fn, p0, None, problem_data=data,
                                     forced=True)
    assert plan.kernel.source.group == mega_auto.ROW_GROUP
    ref = _jax_phase23(label)
    p, *decisions = _host_solve(plan.kernel, p0, plan.data_leaves,
                                DoglegParameters(), plan.consts)
    for f, got in zip(DECISIONS, decisions):
        np.testing.assert_array_equal(got.numpy(), ref[f], err_msg=f)
    np.testing.assert_allclose(p.numpy(), ref["p"], rtol=1e-10, atol=1e-12)
    r = mega.megakernel_optimize_generated_reference(
        plan.kernel, p0, plan.data_leaves, None, plan.consts)
    _assert_decisions_equal(r, ref)


# Each supported op alone, as f(p (4,), d (3, 4)) -> a tensor v; the
# products around it are norm2 = v.v, Jt_x = W v, JtJ = (W * v) W^T with W
# a closed-over (4, 24) constant, so that every op's result reaches them.
OPS = {
    "neg": lambda p, d: -d,
    "exp": lambda p, d: torch.exp(0.3 * d),
    "log": lambda p, d: torch.log(d * d + 1.0),
    "tanh": lambda p, d: torch.tanh(d),
    "sin": lambda p, d: torch.sin(d),
    "cos": lambda p, d: torch.cos(d),
    "sqrt": lambda p, d: torch.sqrt(d * d + 1.0),
    "rsqrt": lambda p, d: torch.rsqrt(d * d + 1.0),
    "reciprocal": lambda p, d: torch.reciprocal(d * d + 1.0),
    "abs": lambda p, d: torch.abs(d),
    "add_broadcast": lambda p, d: d + p,
    "add_scalar": lambda p, d: d + 1.5,
    "add_alpha": lambda p, d: torch.add(d, p, alpha=2.5),
    "sub": lambda p, d: d - p,
    "sub_alpha": lambda p, d: torch.sub(d, p, alpha=0.5),
    "rsub": lambda p, d: 1.0 - d,
    "mul": lambda p, d: d * p,
    "mul_scalar": lambda p, d: 3.0 * d,
    "div": lambda p, d: d / (p * p + 1.0),
    "div_scalar": lambda p, d: d / 7.0,
    "pow_2": lambda p, d: d ** 2,
    "pow_3": lambda p, d: d ** 3,
    "pow_half": lambda p, d: (d * d + 1.0) ** 0.5,
    "pow_minus_1": lambda p, d: (d * d + 1.0) ** -1,
    "pow_minus_2": lambda p, d: (d * d + 1.0) ** -2,
    "pow_minus_half": lambda p, d: (d * d + 1.0) ** -0.5,
    "pow_1_5": lambda p, d: (d * d + 1.0) ** 1.5,
    "select": lambda p, d: d[1] * p[2],
    "slice": lambda p, d: d[:, 1:3],
    "slice_step": lambda p, d: d[::2],
    "unsqueeze": lambda p, d: p[:, None] * d.T,
    "squeeze": lambda p, d: d[None].squeeze(0),
    "view": lambda p, d: d.reshape(12) * 2.0,
    "reshape_copy": lambda p, d: d.T.reshape(12),
    "expand": lambda p, d: p.expand(3, 4) * d,
    "permute": lambda p, d: d.permute(1, 0),
    "t": lambda p, d: d.t(),
    "transpose": lambda p, d: d.transpose(0, 1),
    "stack": lambda p, d: torch.stack([p, 2.0 * p, d[0]], dim=1),
    "cat": lambda p, d: torch.cat([d, d * p], dim=0),
    "cat_dim1": lambda p, d: torch.cat([d, d[:, :2]], dim=1),
    "sum_dim": lambda p, d: d.sum(0),
    "sum_keepdim": lambda p, d: d.sum(1, keepdim=True) * d,
    "sum_all": lambda p, d: d.sum() * p,
    "dot": lambda p, d: (p @ p) * p,
    "mv": lambda p, d: d @ p,
    "mm": lambda p, d: d @ d.T,
    "vector_matrix": lambda p, d: p @ d.T,
    "ones_like": lambda p, d: torch.ones_like(d) + d,
    "zeros_like": lambda p, d: torch.zeros_like(p) + p,
    "full": lambda p, d: torch.full((3,), 2.5, dtype=d.dtype) * d[:, 0],
    "full_like": lambda p, d: torch.full_like(d, -1.25) * d,
    "ones": lambda p, d: torch.ones(4, dtype=p.dtype) * p,
    "scalar_constant": lambda p, d: d * torch.tensor(0.25, dtype=d.dtype),
}


def _op_products(expr):
    W = torch.as_tensor(np.random.default_rng(7).normal(size=(4, 24)))

    def products(p, d):
        v = expr(p, d).reshape(-1)
        Wk = W[:, :v.shape[0]]
        return Products(norm2_x=v @ v, Jt_x=Wk @ v, JtJ=(Wk * v) @ Wk.T)
    return products


@pytest.mark.parametrize("op", sorted(OPS))
def test_generated_op(op):
    rng = np.random.default_rng(11)
    p = torch.as_tensor(rng.normal(size=(5, 4)))
    d = torch.as_tensor(rng.normal(size=(5, 3, 4)))
    products = _op_products(OPS[op])
    plan = mega_auto.plan_megakernel(products, p, None, problem_data=d,
                                     forced=True)
    got = _host_products(plan.kernel, p, plan.data_leaves)
    want = torch.func.vmap(products)(p, d)
    _assert_products_close(got, want)
    # and the graph, the plain version, gives the function's products
    plain = mega.products_generated(plan.kernel, p, plan.data_leaves)
    _assert_products_close(plain, want, rtol=1e-15)


@pytest.mark.parametrize("op", sorted(OPS))
def test_generated_op_form(op):
    """Each op's graph takes the row form where its products are sums over
    one row axis that every value on the way keeps whole, and there the row
    form at G = 1 gives the array form's bits; a graph without one (a
    reshape that merges the row axis, a sum over it that is not a product)
    keeps the array form, and a forced row form raises."""
    rng = np.random.default_rng(11)
    p = torch.as_tensor(rng.normal(size=(5, 4)))
    d = torch.as_tensor(rng.normal(size=(5, 3, 4)))
    plan = mega_auto.plan_megakernel(_op_products(OPS[op]), p, None,
                                     problem_data=d, forced=True)
    a, src = plan.kernel.adapted, plan.kernel.source
    array = mega_auto.generate_source(a, torch.float64, _form="array")
    if src.form == "array":
        assert src.text == array.text
        with pytest.raises(mega_auto.UnsupportedProducts, match="row"):
            mega_auto.generate_source(a, torch.float64, _form="row")
        return
    row1 = mega_auto.generate_source(a, torch.float64, _form="row", _group=1)
    assert _same_bits(
        _host_products(mega_auto.GeneratedKernel(a, row1), p,
                       plan.data_leaves),
        _host_products(mega_auto.GeneratedKernel(a, array), p,
                       plan.data_leaves))


def _unsupported(dtype, device):
    products = _torch_products(dtype, device)

    def unsupported(p, m):
        pr = products(p, m)
        return Products(norm2_x=pr.norm2_x,
                        Jt_x=torch.linalg.solve(pr.JtJ, pr.Jt_x), JtJ=pr.JtJ)
    return unsupported


def test_unsupported_op_is_outside_the_regime():
    """An op without generated code (torch.linalg.solve inside the
    products): auto mode gives None, a forced call raises."""
    p0, meas = _meta((2048, 6)), _meta((2048, 100))
    unsupported = _unsupported(torch.float32, "meta")
    assert mega_auto.plan_megakernel(unsupported, p0, None,
                                     problem_data=meas) is None
    with pytest.raises(mega_auto.UnsupportedProducts, match="linalg"):
        mega_auto.plan_megakernel(unsupported, p0, None, problem_data=meas,
                                  forced=True)
    meas, p0 = (torch.as_tensor(a) for a in _setup(np.float64, 4))
    with pytest.raises(mega_auto.UnsupportedProducts, match="linalg"):
        batched_optimize(_unsupported(torch.float64, "cpu"), p0,
                         problem_data=meas, use_megakernel=True)


def test_named_instances_keep_priority(monkeypatch):
    """A products function that names a device function of mega.cu goes to
    that instance; auto-promotion is not asked."""
    def no_plan(*args, **kwargs):
        raise AssertionError("plan_megakernel asked")
    monkeypatch.setattr(mega_auto, "plan_megakernel", no_plan)
    meas, p0 = (torch.as_tensor(a) for a in _setup(np.float64, 8))
    r = batched_optimize(tsp.products, p0, problem_data=meas,
                         use_megakernel=True)
    ref = mega.megakernel_optimize_reference(
        p0, meas, *tsp.make_grid(torch.float64, "cpu"))
    for f in DECISIONS:
        assert torch.equal(getattr(r, f), getattr(ref, f)), f
    with pytest.raises(AssertionError, match="asked"):
        batched_optimize(_torch_products(torch.float64), p0,
                         problem_data=meas, use_megakernel=True)


def test_environment_disables_promotion(monkeypatch):
    """LIBDOGLEG_TPU_NO_MEGAKERNEL turns auto-promotion off, forced calls
    included (the JAX package's _env_disabled): the masked path runs."""
    monkeypatch.setenv("LIBDOGLEG_TPU_NO_MEGAKERNEL", "1")
    monkeypatch.setattr(mega_auto, "plan_megakernel",
                        lambda *a, **k: pytest.fail("planned"))
    r = _port(16, True)
    _assert_decisions_equal(r, {f: getattr(_port(16, False), f).numpy()
                                for f in DECISIONS})


def test_build_failure_raises(monkeypatch):
    """No fallback once a plan exists: with the loader pointed at an nvcc
    that does not exist, a planned function's call raises RuntimeError in
    auto mode as in forced mode (tensors on the meta device stand for the
    card; a CPU tensor never reaches a build)."""
    monkeypatch.setattr(loader, "find_nvcc", lambda: "/nonexistent/bin/nvcc")
    meta = _torch_products(torch.float32, "meta")
    p0, meas = _meta((1024, 6)), _meta((1024, 100))
    plan = mega_auto.plan_megakernel(meta, p0, None, problem_data=meas,
                                     forced=True)
    with pytest.raises(RuntimeError, match="nvcc"):
        plan()
    with pytest.raises(RuntimeError, match="nvcc"):
        batched_optimize(meta, p0, problem_data=meas)
    with pytest.raises(RuntimeError, match="nvcc"):
        batched_optimize_compacted(meta, p0, problem_data=meas)


def test_generated_library_name_carries_the_hash():
    """A generated library is found again by the hash of its source, the
    headers and the flags: the same function names the same file, another
    function another."""
    plan3, *_ = _case_plan(3, 4)
    plan6, *_ = _case_plan(6, 4)
    again, *_ = _case_plan(3, 4)
    path = loader.generated_library_path(plan3.kernel.source.text)
    assert path.parent == loader._BUILD_DIR
    assert path == loader.generated_library_path(again.kernel.source.text)
    assert path != loader.generated_library_path(plan6.kernel.source.text)
