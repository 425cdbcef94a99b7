"""Whole-solve kernel K1 for batches of the sample problem (counterpart of
libdogleg_tpu/ops/pallas_mega.py).

The kernel in csrc/mega.cu runs the entire dog-leg solve of B independent
quadratic-surface problems (6 states) in one launch, a group of lanes of
one warp per problem (`kernel_group` reads how many from the library), in
one of two instances, as the JAX package builds its Pallas kernel with one
of two products functions:

- `megakernel_optimize` computes the products from the (B, 100)
  measurements (device function `quadratic_surface_products`); its plain
  twin `megakernel_optimize_reference` is the masked batched solver of
  solver.py on models/quadratic_surface.products_minor. Its launches count
  in `launch_count`.
- `megakernel_optimize_factored` computes them from the sufficient
  statistics (h_hi, h_lo, n2m_hi, n2m_lo) and the Gram pair in compensated
  arithmetic (device function `quadratic_surface_factored_products`); its
  twin `megakernel_optimize_factored_reference` is the masked batched solver
  on quadratic_surface.factored_products_minor. Its launches count in
  `factored_launch_count`, apart from the general instance's.

The JAX package pins its kernel to decision parity with its batched solver
(tests/test_pallas_mega.py), which is what makes that solver the kernel's
plain version. On a CPU tensor each wrapper runs its twin; on a CUDA tensor
it launches the kernel on the current stream or raises.

A third form takes any products function that parallel/mega_auto.py can
trace and generate a functor for (K1 at any Nstate <= 16, csrc/
dogleg_auto.cuh on csrc/dogleg_solve.cuh, the solve mega.cu runs):
`megakernel_optimize_generated` launches it on CUDA tensors (one library
per generated source, built by native/loader.build_generated) and counts
in `auto_launch_count`; its plain version
`megakernel_optimize_generated_reference` is the masked batched solver on
the traced graph, vmapped. `products_generated` runs the generated functor
alone.

`products_device`, `factored_products_device` and `error_free_transforms`
run the device functions and the factored one's two_prod/two_sum alone, so
that the card can hold them to their plain versions; they are no launches
of K1 and are not counted. The general device function splits its sums over
the lanes of a group and combines them by a xor butterfly;
`grouped_products_reference` is that order in plain PyTorch, for a group
given explicitly, and `products_magnitude` what its sums are accurate
relative to.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from libdogleg_tpu_torch.models import quadratic_surface as qs
from libdogleg_tpu_torch.ops import compensated
from libdogleg_tpu_torch.params import DoglegParameters
from libdogleg_tpu_torch.solver import (Products, SolveResult,
                                        solve_products_batched)
from libdogleg_tpu_torch.telemetry import span

# Products functions the kernel computes on the device, by the name their
# `cuda_device_function` attribute carries.
DEVICE_FUNCTIONS = frozenset({"quadratic_surface_products",
                              "quadratic_surface_factored_products"})

# Kernel launches made in this process by megakernel_optimize (the general
# instance), by megakernel_optimize_factored (the factored one) and by
# megakernel_optimize_generated (K1 on a generated functor).
launch_count = 0
factored_launch_count = 0
auto_launch_count = 0

Pair = Tuple[torch.Tensor, torch.Tensor]


class _MegaParams(ctypes.Structure):
    # csrc/mega.cu::DoglegMegaParams, field for field
    _fields_ = [(name, ctypes.c_double) for name in (
        "trustregion0", "trustregion_decrease_factor",
        "trustregion_decrease_threshold", "trustregion_increase_factor",
        "trustregion_increase_threshold", "Jt_x_threshold",
        "update_threshold", "trustregion_threshold", "lambda_initial")] + [
        ("max_iterations", ctypes.c_int), ("max_attempts", ctypes.c_int),
        ("lambda_max_tries", ctypes.c_int)]


@functools.lru_cache(maxsize=64)
def _c_params(prm: DoglegParameters) -> _MegaParams:
    """The kernel's parameter struct, built once for each (frozen, hashable)
    DoglegParameters. The kernel only reads it."""
    c = _MegaParams()
    for name, _ in _MegaParams._fields_:
        if name == "max_attempts":
            c.max_attempts = prm.resolved_max_attempts()
        else:
            setattr(c, name, getattr(prm, name))
    return c


def kernel_group(factored: bool = False) -> int:
    """Lanes per problem of the general or the factored instance, as
    csrc/mega.cu sets them (K1_GENERAL_GROUP, K1_FACTORED_GROUP), read from
    the loaded library (building it if need be)."""
    from libdogleg_tpu_torch.native.loader import load_library
    return int(load_library().dogleg_mega_group(int(factored)))


def _check_like(p0, want) -> None:
    """p0 is (B, 6) float32 or float64; each of `want` ({name: (tensor,
    shapes)}) has one of its shapes and p0's dtype and device."""
    if p0.dim() != 2 or p0.shape[1] != qs.NSTATE:
        raise ValueError(f"p0 must be (B, {qs.NSTATE}), got "
                         f"{tuple(p0.shape)}")
    if p0.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"p0 must be float32 or float64, got {p0.dtype}")
    if p0.shape[0] >= 2 ** 31:
        raise ValueError("batch too large for the kernel's int indexing")
    for name, (t, shapes) in want.items():
        if tuple(t.shape) not in shapes:
            raise ValueError(f"{name} must be {' or '.join(map(str, shapes))}"
                             f", got {tuple(t.shape)}")
        if t.dtype != p0.dtype or t.device != p0.device:
            raise ValueError(f"{name} must match p0's dtype and device")


def _check(p0, meas, gx, gy) -> None:
    _check_like(p0, {"meas": (meas, [(p0.shape[0], qs.NMEAS)]),
                     "gx": (gx, [(qs.NMEAS,)]), "gy": (gy, [(qs.NMEAS,)])})


def _check_factored(p0, h_hi, h_lo, n2m_hi, n2m_lo, G_pair) -> None:
    B, n = p0.shape[0], qs.NSTATE
    _check_like(p0, {"h_hi": (h_hi, [(B, n)]), "h_lo": (h_lo, [(B, n)]),
                     "n2m_hi": (n2m_hi, [(B,), (B, 1)]),
                     "n2m_lo": (n2m_lo, [(B,), (B, 1)]),
                     "Ghi": (G_pair[0], [(n, n)]),
                     "Glo": (G_pair[1], [(n, n)])})


def _general_inputs(p0, meas, gx, gy):
    """What the general kernel reads: p0 (B, 6), meas (B, 100) row-major,
    the grid; each tensor itself where it is contiguous, else a contiguous
    copy."""
    return tuple(t.contiguous() for t in (p0, meas, gx, gy))


def _factored_inputs(p0, h_hi, h_lo, n2m_hi, n2m_lo, G_pair):
    """What the factored kernel reads, each through its own pointer: p0,
    h_hi, h_lo (B, 6), n2m_hi, n2m_lo (B,) or (B, 1), Ghi, Glo (6, 6); each
    tensor itself where it is contiguous, else a contiguous copy."""
    return tuple(t.contiguous()
                 for t in (p0, h_hi, h_lo, n2m_hi, n2m_lo, *G_pair))


def _launch_solve(entry, p0: torch.Tensor, ins,
                  prm: DoglegParameters) -> SolveResult:
    """Launch the solve entry `entry` of p0's dtype: p0's pointer, then
    `ins` (pointers as ints), then B, the parameters, the outputs
    allocated on p0's device, and the launch target. Returns the outputs as
    a batch-leading SolveResult."""
    from libdogleg_tpu_torch.native.loader import launch_target
    B, n = p0.shape
    dev, dt = p0.device, p0.dtype
    p = torch.empty((B, n), dtype=dt, device=dev)
    jtx = torch.empty((B, n), dtype=dt, device=dev)
    jtj = torch.empty((B, n, n), dtype=dt, device=dev)
    norm2, tr, lam = torch.empty((3, B), dtype=dt, device=dev).unbind(0)
    step_count, n_attempts, reason = torch.empty(
        (3, B), dtype=torch.int32, device=dev).unbind(0)
    err = entry(p0.data_ptr(), *ins, B, ctypes.byref(_c_params(prm)),
                p.data_ptr(), jtx.data_ptr(), jtj.data_ptr(), norm2.data_ptr(),
                tr.data_ptr(), lam.data_ptr(), step_count.data_ptr(),
                n_attempts.data_ptr(), reason.data_ptr(), *launch_target(dev))
    if err:
        raise RuntimeError(f"megakernel launch failed: cudaError_t {err}")
    return SolveResult(p=p, norm2_x=norm2, Jt_x=jtx, JtJ=jtj,
                       step_count=step_count, n_attempts=n_attempts,
                       reason=reason, trustregion=tr, lam=lam)


def _named_entry(name: str, dtype: torch.dtype):
    from libdogleg_tpu_torch.native.loader import load_library
    return getattr(load_library(),
                   name + ("_f32" if dtype == torch.float32 else "_f64"))


def _require_cuda(t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"no kernel for device {t.device}")


def megakernel_optimize_reference(p0: torch.Tensor, meas: torch.Tensor,
                                  gx: torch.Tensor, gy: torch.Tensor,
                                  parameters: Optional[DoglegParameters]
                                  = None) -> SolveResult:
    """The kernel's plain PyTorch twin: the same function with ordinary
    torch ops, on any device."""
    _check(p0, meas, gx, gy)
    meas_t, X, Y = meas.t(), gx[:, None], gy[:, None]

    def products(p):
        n2, jtx, jtj = qs.products_minor(p.t(), meas_t, X, Y)
        return Products(norm2_x=n2[0], Jt_x=jtx.t(),
                        JtJ=jtj.permute(2, 0, 1))
    return solve_products_batched(products, p0, parameters)


def megakernel_optimize(p0: torch.Tensor, meas: torch.Tensor,
                        gx: torch.Tensor, gy: torch.Tensor,
                        parameters: Optional[DoglegParameters] = None
                        ) -> SolveResult:
    """Solve B sample problems: p0 (B, 6) start points, meas (B, 100)
    measurements, gx/gy (100,) the grid. float32 or float64, all on one
    device. Returns a batch-leading SolveResult (history=None).

    CUDA tensors go to the kernel, which is launched on the current stream
    without synchronizing; CPU tensors go to megakernel_optimize_reference.
    """
    global launch_count
    prm = parameters if parameters is not None else DoglegParameters()
    if p0.device.type == "cpu":
        return megakernel_optimize_reference(p0, meas, gx, gy, prm)
    with span("dogleg.launch"):
        _check(p0, meas, gx, gy)
        _require_cuda(p0)
        ins = _general_inputs(p0, meas, gx, gy)
        result = _launch_solve(_named_entry("dogleg_mega", p0.dtype), ins[0],
                               [t.data_ptr() for t in ins[1:]], prm)
    launch_count += 1
    return result


def megakernel_optimize_factored_reference(
        p0: torch.Tensor, h_hi: torch.Tensor, h_lo: torch.Tensor,
        n2m_hi: torch.Tensor, n2m_lo: torch.Tensor, G_pair: Pair,
        parameters: Optional[DoglegParameters] = None) -> SolveResult:
    """The factored instance's plain PyTorch twin: the masked batched solver
    on quadratic_surface.factored_products_minor, on any device."""
    _check_factored(p0, h_hi, h_lo, n2m_hi, n2m_lo, G_pair)
    B = p0.shape[0]
    hh, hl = h_hi.t(), h_lo.t()
    nh, nl = n2m_hi.reshape(1, B), n2m_lo.reshape(1, B)

    def products(p):
        n2, jtx, jtj = qs.factored_products_minor(p.t(), hh, hl, nh, nl,
                                                  *G_pair)
        return Products(norm2_x=n2[0], Jt_x=jtx.t(),
                        JtJ=jtj.permute(2, 0, 1))
    return solve_products_batched(products, p0, parameters)


def megakernel_optimize_factored(p0: torch.Tensor, h_hi: torch.Tensor,
                                 h_lo: torch.Tensor, n2m_hi: torch.Tensor,
                                 n2m_lo: torch.Tensor, G_pair: Pair,
                                 parameters: Optional[DoglegParameters]
                                 = None) -> SolveResult:
    """Solve B sample problems in the factored form: p0 (B, 6) start points;
    h_hi, h_lo (B, 6) and n2m_hi, n2m_lo (B,) or (B, 1), the statistics of
    quadratic_surface.factored_statistics; G_pair the (6, 6) Gram pair of
    quadratic_surface.gram_pair. float32 or float64, all on one device.
    Returns a batch-leading SolveResult (history=None).

    CUDA tensors go to the kernel's factored instance, launched on the
    current stream without synchronizing; CPU tensors go to
    megakernel_optimize_factored_reference."""
    global factored_launch_count
    prm = parameters if parameters is not None else DoglegParameters()
    if p0.device.type == "cpu":
        return megakernel_optimize_factored_reference(
            p0, h_hi, h_lo, n2m_hi, n2m_lo, G_pair, prm)
    with span("dogleg.launch"):
        _check_factored(p0, h_hi, h_lo, n2m_hi, n2m_lo, G_pair)
        _require_cuda(p0)
        ins = _factored_inputs(p0, h_hi, h_lo, n2m_hi, n2m_lo, G_pair)
        result = _launch_solve(
            _named_entry("dogleg_mega_factored", p0.dtype), ins[0],
            [t.data_ptr() for t in ins[1:]], prm)
    factored_launch_count += 1
    return result


def _check_generated(kernel, p: torch.Tensor, data_leaves) -> None:
    """p is (B, n) float32 or float64 for the kernel's n; each data leaf
    (B, ...) with the element size the kernel was generated for, p's dtype
    and device."""
    src = kernel.source
    if p.dim() != 2 or p.shape[1] != src.nstate:
        raise ValueError(f"p0 must be (B, {src.nstate}), got "
                         f"{tuple(p.shape)}")
    if p.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"p0 must be float32 or float64, got {p.dtype}")
    if p.shape[0] >= 2 ** 31:
        raise ValueError("batch too large for the kernel's int indexing")
    if len(data_leaves) != len(src.data_numel):
        raise ValueError(f"the kernel takes {len(src.data_numel)} "
                         f"problem-data leaves, got {len(data_leaves)}")
    for k, (t, numel) in enumerate(zip(data_leaves, src.data_numel)):
        if t.dim() < 1 or t.shape[0] != p.shape[0] or \
                t[0].numel() != numel:
            raise ValueError(f"problem-data leaf {k} must be (B, ...) with "
                             f"{numel} values an element, got "
                             f"{tuple(t.shape)}")
        if t.dtype != p.dtype or t.device != p.device:
            raise ValueError(f"problem-data leaf {k} must match p0's dtype "
                             "and device")


def _generated_consts(kernel, p: torch.Tensor, consts):
    """The constants a call reads (`consts`, or the trace's where None) on
    p's device and in its dtype, contiguous: taken fresh each call, so that
    a cached kernel reads the values the call's function closes over."""
    return tuple(c.to(device=p.device, dtype=p.dtype).contiguous()
                 for c in (kernel.adapted.consts if consts is None
                           else consts))


def _generated_ins(kernel, p: torch.Tensor, data_leaves, consts):
    """The input tensors (contiguous data leaves, then the constants) and a
    ctypes array of their pointers."""
    tensors = [t.contiguous() for t in data_leaves] + list(
        _generated_consts(kernel, p, consts))
    ptrs = (ctypes.c_void_p * max(len(tensors), 1))(
        *(t.data_ptr() for t in tensors))
    return tensors, ptrs


def megakernel_optimize_generated_reference(
        kernel, p0: torch.Tensor, data_leaves=(),
        parameters: Optional[DoglegParameters] = None,
        consts=None) -> SolveResult:
    """The generated K1's plain version: the masked batched solver of
    solver.py on the traced graph (parallel/mega_auto.AdaptedProducts.
    plain), vmapped over the batch, on any device."""
    _check_generated(kernel, p0, data_leaves)
    vf = torch.func.vmap(functools.partial(
        kernel.adapted.plain, consts=_generated_consts(kernel, p0, consts)))
    return solve_products_batched(lambda p: vf(p, *data_leaves), p0,
                                  parameters)


def megakernel_optimize_generated(kernel, p0: torch.Tensor, data_leaves=(),
                                  parameters: Optional[DoglegParameters]
                                  = None, consts=None) -> SolveResult:
    """Solve B problems on K1 with a generated products functor: `kernel` a
    parallel/mega_auto.GeneratedKernel, p0 (B, n), data_leaves the
    problem data's leaves, each (B, ...), consts the tensors the function
    closes over (None: those of the trace). Returns a batch-leading
    SolveResult (history=None, JtJ its lower triangle mirrored).

    CPU tensors go to megakernel_optimize_generated_reference. Otherwise
    the kernel's library is built (or found) first, which raises
    RuntimeError where nvcc fails, and then the kernel is launched on the
    current stream without synchronizing; a tensor on any other device than
    CUDA raises."""
    global auto_launch_count
    prm = parameters if parameters is not None else DoglegParameters()
    if p0.device.type == "cpu":
        return megakernel_optimize_generated_reference(kernel, p0,
                                                       data_leaves, prm,
                                                       consts)
    with span("dogleg.launch"):
        _check_generated(kernel, p0, data_leaves)
        lib = kernel.library()
        _require_cuda(p0)
        p0 = p0.contiguous()
        tensors, ptrs = _generated_ins(kernel, p0, data_leaves, consts)
        entry = (lib.dogleg_auto_solve_f32 if p0.dtype == torch.float32
                 else lib.dogleg_auto_solve_f64)
        result = _launch_solve(entry, p0, [ctypes.addressof(ptrs)], prm)
        del tensors
    auto_launch_count += 1
    return result


def products_generated(kernel, p: torch.Tensor, data_leaves=(), consts=None):
    """The generated functor alone at p (B, n) -> (norm2 (B,), Jt_x (B, n),
    JtJ (B, n, n), the lower triangle mirrored, as the kernel keeps it).
    CPU tensors take its plain version, the graph vmapped."""
    _check_generated(kernel, p, data_leaves)
    if p.device.type == "cpu":
        r = torch.func.vmap(functools.partial(
            kernel.adapted.plain,
            consts=_generated_consts(kernel, p, consts)))(p, *data_leaves)
        return r.norm2_x, r.Jt_x, _lower_mirrored(r.JtJ)
    from libdogleg_tpu_torch.native.loader import launch_target
    lib = kernel.library()
    _require_cuda(p)
    p = p.contiguous()
    tensors, ptrs = _generated_ins(kernel, p, data_leaves, consts)
    outs = _products_out(p)
    entry = (lib.dogleg_auto_products_f32 if p.dtype == torch.float32
             else lib.dogleg_auto_products_f64)
    err = entry(p.data_ptr(), ctypes.addressof(ptrs), p.shape[0],
                *(t.data_ptr() for t in outs), *launch_target(p.device))
    if err:
        raise RuntimeError(f"dogleg_auto_products launch failed: "
                           f"cudaError_t {err}")
    del tensors
    return outs


def _lower_mirrored(jtj: torch.Tensor) -> torch.Tensor:
    """(..., n, n) with its upper triangle replaced by the lower one's
    mirror, as the kernel keeps JtJ."""
    low = torch.tril(jtj)
    return low + torch.tril(low, -1).mT


def grouped_products_reference(p: torch.Tensor, meas: torch.Tensor,
                               gx: torch.Tensor, gy: torch.Tensor,
                               group: int):
    """The general device function's products in its order of summation:
    lane r of a group of `group` lanes sums the terms of measurements
    r, r + group, r + 2 group, ... in that order, then the lanes' partial
    sums are combined by the xor butterfly (lane r adds lane r ^ k's sums
    to its own, k = 1, 2, ..., group / 2). p (B, 6), meas (B, 100), gx, gy
    (100,) -> (norm2 (B,), Jt_x (B, 6), JtJ (B, 6, 6), the lower triangle
    mirrored). Each term is computed as the kernel computes it; the kernel
    may fuse a product and a sum where this rounds twice."""
    if group < 1 or group > 32 or group & (group - 1):
        raise ValueError(f"group must be a power of two up to 32, got {group}")
    B, n = p.shape
    X, Y = gx[None], gy[None]                      # (1, m)
    p0, p1, p2, p3, p4, p5 = (p[:, a:a + 1] for a in range(n))
    x = ((p0 * p1) * X * X + (p1 * p2) * Y * Y + p2 * X * Y + p3 * X
         + p4 * Y + p5 - meas)                     # (B, m)
    J = [p1 * X * X, p0 * X * X + p2 * Y * Y, p1 * Y * Y + X * Y,
         X.expand_as(x), Y.expand_as(x), torch.ones_like(x)]
    low = [(a, c) for a in range(n) for c in range(a + 1)]
    terms = torch.stack([x * x] + [J[a] * x for a in range(n)]
                        + [J[a] * J[c] for a, c in low], dim=-1)
    m = terms.shape[1]
    rounds = -(-m // group)
    # measurement i = k group + r is lane r's k-th term; a lane with fewer
    # terms adds zeros, which leaves its sum as it is
    terms = torch.cat([terms, terms.new_zeros(
        (B, rounds * group - m, terms.shape[-1]))], dim=1)
    terms = terms.reshape(B, rounds, group, -1)
    acc = terms.new_zeros((B, group, terms.shape[-1]))
    for k in range(rounds):
        acc = acc + terms[:, k]
    lanes = torch.arange(group)
    k = 1
    while k < group:
        acc = acc + acc[:, lanes ^ k]
        k *= 2
    s = acc[:, 0]
    jtj = s.new_zeros((B, n, n))
    for idx, (a, c) in enumerate(low):
        jtj[:, a, c] = s[:, 1 + n + idx]
    return s[:, 0], s[:, 1:1 + n], _lower_mirrored(jtj)


def products_magnitude(p: torch.Tensor, meas: torch.Tensor,
                       gx: torch.Tensor, gy: torch.Tensor):
    """What the general products' sums are accurate relative to, however
    they are rounded or ordered: each sum with every term of it, and every
    term of the residual x = m(X, Y; p) - meas and of the Jacobian, taken in
    absolute value before anything cancels. p (B, 6), meas (B, 100), gx, gy
    (100,) -> (norm2 (B,), Jt_x (B, 6), JtJ (B, 6, 6)). Near the truth x
    cancels ~1e3 to ~0.5, so |x| itself would not bound one rounding of its
    terms."""
    X, Y = gx[None].abs(), gy[None].abs()          # (1, m)
    a = [p[:, k:k + 1].abs() for k in range(p.shape[1])]
    xm = (a[0] * a[1] * X * X + a[1] * a[2] * Y * Y + a[2] * X * Y
          + a[3] * X + a[4] * Y + a[5] + meas.abs())               # (B, m)
    Jm = torch.stack([(a[1] * X * X).expand_as(xm),
                      a[0] * X * X + a[2] * Y * Y,
                      a[1] * Y * Y + X * Y, X.expand_as(xm),
                      Y.expand_as(xm), torch.ones_like(xm)], dim=-1)
    return (xm * xm).sum(-1), (Jm * xm[..., None]).sum(1), Jm.mT @ Jm


def _products_out(p: torch.Tensor):
    B, n = p.shape
    return (torch.empty(B, dtype=p.dtype, device=p.device),
            torch.empty((B, n), dtype=p.dtype, device=p.device),
            torch.empty((B, n, n), dtype=p.dtype, device=p.device))


def _launch_products(name: str, ins, outs) -> None:
    from libdogleg_tpu_torch.native.loader import launch_target, load_library
    p = ins[0]
    entry = getattr(load_library(),
                    name + ("_f32" if p.dtype == torch.float32 else "_f64"))
    err = entry(*(t.data_ptr() for t in ins), p.shape[0],
                *(t.data_ptr() for t in outs), *launch_target(p.device))
    if err:
        raise RuntimeError(f"{name} launch failed: cudaError_t {err}")


def products_device(p: torch.Tensor, meas: torch.Tensor, gx: torch.Tensor,
                    gy: torch.Tensor):
    """The general device function quadratic_surface_products alone: p
    (B, 6), meas (B, 100), gx, gy as for megakernel_optimize -> (norm2 (B,),
    Jt_x (B, 6), JtJ (B, 6, 6), the lower triangle mirrored, as the kernel
    keeps it). The kernel sums in the order of grouped_products_reference
    with kernel_group() lanes. CPU tensors take its twin, products_minor."""
    _check(p, meas, gx, gy)
    if p.device.type == "cpu":
        n2, jtx, jtj = qs.products_minor(p.t(), meas.t(), gx[:, None],
                                         gy[:, None])
        return n2[0], jtx.t(), _lower_mirrored(jtj.permute(2, 0, 1))
    _require_cuda(p)
    outs = _products_out(p)
    _launch_products("dogleg_products", _general_inputs(p, meas, gx, gy),
                     outs)
    return outs


def factored_products_device(p: torch.Tensor, stats, G_pair: Pair):
    """The device function quadratic_surface_factored_products alone: p
    (B, 6), stats (h_hi, h_lo, n2m_hi, n2m_lo) as for
    megakernel_optimize_factored -> (norm2 (B,), Jt_x (B, 6), JtJ (B, 6, 6),
    JtJ its lower triangle mirrored, as the kernel keeps it). CPU tensors
    take its twin, factored_products_minor."""
    _check_factored(p, *stats, G_pair)
    if p.device.type == "cpu":
        B = p.shape[0]
        n2, jtx, jtj = qs.factored_products_minor(
            p.t(), stats[0].t(), stats[1].t(), stats[2].reshape(1, B),
            stats[3].reshape(1, B), *G_pair)
        return n2[0], jtx.t(), _lower_mirrored(jtj.permute(2, 0, 1))
    _require_cuda(p)
    outs = _products_out(p)
    _launch_products("dogleg_factored_products",
                     _factored_inputs(p, *stats, G_pair), outs)
    return outs


def error_free_transforms_reference(a: torch.Tensor, b: torch.Tensor):
    """(p, e_p, s, e_s) = two_prod(a, b) + two_sum(a, b) of
    ops/compensated.py, eager, on any device."""
    return compensated.two_prod(a, b) + compensated.two_sum(a, b)


def error_free_transforms(a: torch.Tensor, b: torch.Tensor):
    """The kernel's two_prod and two_sum on a, b (n,), float32 or float64:
    (p, e_p, s, e_s) with p + e_p == a * b and s + e_s == a + b exactly.
    CPU tensors take the twin, error_free_transforms_reference."""
    from libdogleg_tpu_torch.native.loader import launch_target, load_library
    if (a.dim() != 1 or a.shape != b.shape or a.dtype != b.dtype
            or a.device != b.device
            or a.dtype not in (torch.float32, torch.float64)):
        raise ValueError("a and b must be (n,) tensors of one float type "
                         "on one device")
    if a.device.type == "cpu":
        return error_free_transforms_reference(a, b)
    _require_cuda(a)
    lib = load_library()
    entry = (lib.dogleg_error_free_f32 if a.dtype == torch.float32
             else lib.dogleg_error_free_f64)
    a, b = a.contiguous(), b.contiguous()
    outs = torch.empty((4, a.shape[0]), dtype=a.dtype, device=a.device)
    err = entry(a.data_ptr(), b.data_ptr(), a.shape[0],
                *(o.data_ptr() for o in outs), *launch_target(a.device))
    if err:
        raise RuntimeError(f"error-free transforms launch failed: "
                           f"cudaError_t {err}")
    return tuple(outs)
