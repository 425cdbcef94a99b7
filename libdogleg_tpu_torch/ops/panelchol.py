"""Kernel K2: Cholesky of a diagonal panel and the inverse of its factor
(counterpart of libdogleg_tpu/ops/pallas_panelchol.py).

ops/largechol.py factors each 256-wide diagonal block with `panel_factor`,
which returns L and inv(L), so that the rest of the panel step is two
matrix products. On a CUDA tensor it launches the hand-written kernel in
csrc/panelchol.cu, one thread block per (p, p) instance; on a CPU tensor it
runs the plain twin `panel_factor_reference`. There is no fallback: a CUDA
tensor launches the kernel or raises.
"""

from __future__ import annotations

import torch

from libdogleg_tpu_torch.ops.largechol import SUB, _chol_fori, _tri_inv

# The kernel's shared-memory buffers hold a 16-wide column panel of at most
# this many rows (csrc/panelchol.cu MAX_P).
MAX_PANEL = 256

# Kernel launches made by panel_factor in this process.
launch_count = 0


def _check(W: torch.Tensor) -> None:
    if W.dim() < 2 or W.shape[-1] != W.shape[-2]:
        raise ValueError(f"W must be (..., p, p), got {tuple(W.shape)}")
    p = W.shape[-1]
    if p % SUB or not 0 < p <= MAX_PANEL:
        raise ValueError(f"panel width {p} must be a positive multiple of "
                         f"{SUB} and at most {MAX_PANEL}")
    if W.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"W must be float32 or float64, got {W.dtype}")


def panel_factor_reference(W: torch.Tensor):
    """The kernel's plain twin: (L, Linv, ok) for (..., p, p) SPD blocks,
    with K2's pivot rule and failure flag, on any device."""
    _check(W)
    L, ok = _chol_fori(W)
    return L, _tri_inv(L), ok


def panel_factor(W: torch.Tensor):
    """Factor (..., p, p) SPD diagonal blocks, p a multiple of 16, p <= 256.

    Returns (L, Linv, ok): L lower-triangular with zeros above the diagonal,
    Linv = inv(L), ok (...) bool, every pivot positive and finite. CUDA
    tensors go to kernel K2, launched on the current stream without
    synchronizing; CPU tensors go to panel_factor_reference.
    """
    global launch_count
    _check(W)
    if W.device.type == "cpu":
        return panel_factor_reference(W)
    if W.device.type != "cuda":
        raise ValueError(f"no kernel for device {W.device}")
    from libdogleg_tpu_torch.native.loader import load_library
    lib = load_library()
    entry = (lib.dogleg_panelchol_f32 if W.dtype == torch.float32
             else lib.dogleg_panelchol_f64)
    batch, p = W.shape[:-2], W.shape[-1]
    Wc = W.reshape((-1, p, p)).contiguous()
    B = Wc.shape[0]
    if B >= 2 ** 31:
        raise ValueError("batch too large for the kernel's grid")
    L = torch.empty_like(Wc)
    Linv = torch.empty_like(Wc)
    ok = torch.empty(B, dtype=torch.int32, device=W.device)
    dev = W.device
    err = entry(Wc.data_ptr(), B, p, L.data_ptr(), Linv.data_ptr(),
                ok.data_ptr(), dev.index or 0,
                torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"panel_factor launch failed: cudaError_t {err}")
    launch_count += 1
    return L.reshape(W.shape), Linv.reshape(W.shape), (ok != 0).reshape(batch)
