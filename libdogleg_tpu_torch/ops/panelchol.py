"""Kernel K2: Cholesky of a diagonal panel and the inverse of its factor
(counterpart of libdogleg_tpu/ops/pallas_panelchol.py).

ops/largechol.py factors each 256-wide diagonal block with `panel_factor`,
which returns L and inv(L), so that the rest of the panel step is two
matrix products. On a CUDA tensor it launches the hand-written kernels in
csrc/panelchol.cu (the factor, one thread block per (p, p) panel, then the
inverse, p / 16 blocks per panel, each a slab of 16 columns); on a CPU tensor
it runs the plain twin `panel_factor_reference`. There is no fallback: a CUDA
tensor launches the kernels or raises.
"""

from __future__ import annotations

import torch

from libdogleg_tpu_torch.ops.largechol import (SUB, _chol_fori, _tri_inv,
                                                _tri_inv_leaf)

# The largest panel the kernel takes (csrc/panelchol.cu MAX_P).
MAX_PANEL = 256

# Launches made by panel_factor in this process: one per call, which puts the
# factor kernel and the inverse kernel on the stream together.
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


def panel_inverse_columns_reference(L: torch.Tensor,
                                    cols: int = SUB) -> torch.Tensor:
    """The inverse kernel's algorithm in plain PyTorch, for the tests:
    inv(L) of lower-triangular (..., p, p), p a multiple of SUB, one slab of
    `cols` columns at a time, each on its own. A slab that starts at column
    c0 starts at row c0 (inv(L) is lower-triangular) and goes left-looking
    over SUB-row blocks I: X[I, :] = inv(L_II) (E_I - L[I, <I] X[<I, :]),
    with the SUB x SUB diagonal blocks inverted first."""
    p = L.shape[-1]
    if cols % SUB:
        raise ValueError(f"cols must be a multiple of {SUB}, got {cols}")
    Dinv = [_tri_inv_leaf(L[..., i:i + SUB, i:i + SUB])
            for i in range(0, p, SUB)]
    X = torch.zeros_like(L)
    for c0 in range(0, p, cols):
        c1 = min(c0 + cols, p)
        for i0 in range(c0, p, SUB):
            rhs = -(L[..., i0:i0 + SUB, c0:i0] @ X[..., c0:i0, c0:c1])
            w = min(c1, i0 + SUB) - i0   # columns of E_I inside the slab
            if w > 0:
                idx = torch.arange(w, device=L.device)
                rhs[..., idx, i0 - c0 + idx] += 1.0
            X[..., i0:i0 + SUB, c0:c1] = Dinv[i0 // SUB] @ rhs
    return X


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
    from libdogleg_tpu_torch.native.loader import launch_target, load_library
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
    ok = torch.empty(B, dtype=torch.bool, device=W.device)
    err = entry(Wc.data_ptr(), B, p, L.data_ptr(), Linv.data_ptr(),
                ok.data_ptr(), *launch_target(W.device))
    if err:
        raise RuntimeError(f"panel_factor launch failed: cudaError_t {err}")
    launch_count += 1
    return L.reshape(W.shape), Linv.reshape(W.shape), ok.reshape(batch)
