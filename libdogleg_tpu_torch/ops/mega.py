"""Whole-solve kernel K1 for batches of the sample problem (counterpart of
libdogleg_tpu/ops/pallas_mega.py).

The kernel in csrc/mega.cu runs the entire dog-leg solve of B independent
quadratic-surface problems (6 states) in one launch, one thread per
problem, in one of two instances, as the JAX package builds its Pallas
kernel with one of two products functions:

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

`factored_products_device` and `error_free_transforms` run the factored
device function and its two_prod/two_sum alone, so that the card can hold
them to their twins; they are no launches of K1 and are not counted.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from libdogleg_tpu_torch.models import quadratic_surface as qs
from libdogleg_tpu_torch.ops import compensated
from libdogleg_tpu_torch.params import DoglegParameters
from libdogleg_tpu_torch.solver import (Products, SolveResult,
                                        solve_products_batched)

# Products functions the kernel computes on the device, by the name their
# `cuda_device_function` attribute carries.
DEVICE_FUNCTIONS = frozenset({"quadratic_surface_products",
                              "quadratic_surface_factored_products"})

# Kernel launches made in this process by megakernel_optimize (the general
# instance) and by megakernel_optimize_factored (the factored one).
launch_count = 0
factored_launch_count = 0

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


def _c_params(prm: DoglegParameters) -> _MegaParams:
    c = _MegaParams()
    for name, _ in _MegaParams._fields_:
        if name == "max_attempts":
            c.max_attempts = prm.resolved_max_attempts()
        else:
            setattr(c, name, getattr(prm, name))
    return c


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


def _launch_args(p0: torch.Tensor, ins, entry_f32: str, entry_f64: str):
    """The entry point for p0's dtype and the outputs of a solve, allocated
    on p0's device; `ins` made contiguous."""
    from libdogleg_tpu_torch.native.loader import load_library
    lib = load_library()
    entry = getattr(lib, entry_f32 if p0.dtype == torch.float32
                    else entry_f64)
    B, n = p0.shape
    dev, dt = p0.device, p0.dtype
    p = torch.empty((B, n), dtype=dt, device=dev)
    jtx = torch.empty((B, n), dtype=dt, device=dev)
    jtj = torch.empty((B, n, n), dtype=dt, device=dev)
    fscal = torch.empty((3, B), dtype=dt, device=dev)
    iscal = torch.empty((3, B), dtype=torch.int32, device=dev)
    result = SolveResult(p=p, norm2_x=fscal[0], Jt_x=jtx, JtJ=jtj,
                         step_count=iscal[0], n_attempts=iscal[1],
                         reason=iscal[2], trustregion=fscal[1],
                         lam=fscal[2])
    outs = (p, jtx, jtj, fscal[0], fscal[1], fscal[2], iscal[0], iscal[1],
            iscal[2])
    return entry, tuple(t.contiguous() for t in ins), outs, result


def _launch_solve(entry, ins, outs, B: int, prm: DoglegParameters,
                  device) -> None:
    from libdogleg_tpu_torch.native.loader import launch_target
    c_prm = _c_params(prm)
    err = entry(*(t.data_ptr() for t in ins), B, ctypes.byref(c_prm),
                *(t.data_ptr() for t in outs), *launch_target(device))
    if err:
        raise RuntimeError(f"megakernel launch failed: cudaError_t {err}")


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
    _check(p0, meas, gx, gy)
    if p0.device.type == "cpu":
        return megakernel_optimize_reference(p0, meas, gx, gy, prm)
    _require_cuda(p0)
    entry, ins, outs, result = _launch_args(
        p0, (p0, meas.t(), gx, gy), "dogleg_mega_f32", "dogleg_mega_f64")
    _launch_solve(entry, ins, outs, p0.shape[0], prm, p0.device)
    launch_count += 1
    return result


def _stats_minor(h_hi, h_lo, n2m_hi, n2m_lo) -> torch.Tensor:
    """The statistics batch-minor, (14, B): h_hi, h_lo, n2m_hi, n2m_lo, as
    the kernel reads them."""
    B = h_hi.shape[0]
    return torch.cat([h_hi.t(), h_lo.t(), n2m_hi.reshape(1, B),
                      n2m_lo.reshape(1, B)])


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
    _check_factored(p0, h_hi, h_lo, n2m_hi, n2m_lo, G_pair)
    if p0.device.type == "cpu":
        return megakernel_optimize_factored_reference(
            p0, h_hi, h_lo, n2m_hi, n2m_lo, G_pair, prm)
    _require_cuda(p0)
    entry, ins, outs, result = _launch_args(
        p0, (p0, _stats_minor(h_hi, h_lo, n2m_hi, n2m_lo), *G_pair),
        "dogleg_mega_factored_f32", "dogleg_mega_factored_f64")
    _launch_solve(entry, ins, outs, p0.shape[0], prm, p0.device)
    factored_launch_count += 1
    return result


def factored_products_device(p: torch.Tensor, stats, G_pair: Pair):
    """The device function quadratic_surface_factored_products alone: p
    (B, 6), stats (h_hi, h_lo, n2m_hi, n2m_lo) as for
    megakernel_optimize_factored -> (norm2 (B,), Jt_x (B, 6), JtJ (B, 6, 6),
    JtJ its lower triangle mirrored, as the kernel keeps it). CPU tensors
    take its twin, factored_products_minor."""
    from libdogleg_tpu_torch.native.loader import launch_target, load_library
    _check_factored(p, *stats, G_pair)
    if p.device.type == "cpu":
        B = p.shape[0]
        n2, jtx, jtj = qs.factored_products_minor(
            p.t(), stats[0].t(), stats[1].t(), stats[2].reshape(1, B),
            stats[3].reshape(1, B), *G_pair)
        low = torch.tril(jtj.permute(2, 0, 1))
        return n2[0], jtx.t(), low + torch.tril(low, -1).mT
    _require_cuda(p)
    lib = load_library()
    entry = (lib.dogleg_factored_products_f32 if p.dtype == torch.float32
             else lib.dogleg_factored_products_f64)
    B, n = p.shape
    ins = (p.contiguous(), _stats_minor(*stats), G_pair[0].contiguous(),
           G_pair[1].contiguous())
    norm2 = torch.empty(B, dtype=p.dtype, device=p.device)
    jtx = torch.empty((B, n), dtype=p.dtype, device=p.device)
    jtj = torch.empty((B, n, n), dtype=p.dtype, device=p.device)
    err = entry(*(t.data_ptr() for t in ins), B, norm2.data_ptr(),
                jtx.data_ptr(), jtj.data_ptr(), *launch_target(p.device))
    if err:
        raise RuntimeError(f"factored products launch failed: cudaError_t "
                           f"{err}")
    return norm2, jtx, jtj


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
