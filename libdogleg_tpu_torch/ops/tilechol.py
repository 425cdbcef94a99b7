"""Kernels K6 and K7: the per-level tile ops of the block-sparse Cholesky
(counterpart of libdogleg_tpu/ops/pallas_chol.py).

`tile_cholesky` is the FACTOR op, the Cholesky of a batch of (n, n) SPD
diagonal tiles with a per-tile failure flag; `tri_solve_right` is the SOLVE
op, X with X D^T = C for a batch of lower-triangular D. sparse_cholesky.py
calls them once per elimination level, on 8x8 tiles in the simplicial
factorization and on S*b-wide super tiles in the supernodal one.

On a CUDA tensor each wrapper launches its hand-written kernel in
csrc/tilechol.cu, for every n from 1 to 256; on a CPU tensor it runs its
plain twin (`*_reference`). There is no fallback: a CUDA tensor launches
the kernel or raises.
"""

from __future__ import annotations

import torch

from libdogleg_tpu_torch.ops import smallchol

# Largest tile the kernels take (csrc/tilechol.cu MAX_N).
MAX_N = 256

# Kernel launches made in this process, per wrapper.
launch_counts = {"tile_cholesky": 0, "tri_solve_right": 0}


def _check_tiles(name: str, t: torch.Tensor) -> None:
    if t.dim() != 3:
        raise ValueError(f"{name} must be (k, ., n), got {tuple(t.shape)}")
    if t.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"{name} must be float32 or float64, got {t.dtype}")


def _check_square(name: str, t: torch.Tensor) -> None:
    _check_tiles(name, t)
    n = t.shape[-1]
    if t.shape[-2] != n or not 0 < n <= MAX_N:
        raise ValueError(f"{name} must be (k, n, n) with 1 <= n <= {MAX_N}, "
                         f"got {tuple(t.shape)}")


def _launch(entry: str, device: torch.device, *args) -> None:
    from libdogleg_tpu_torch.native.loader import load_library
    err = getattr(load_library(), entry)(
        *args, device.index or 0, torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(f"{entry} launch failed: cudaError_t {err}")


def tile_cholesky_reference(blocks: torch.Tensor):
    """K6's plain twin, the JAX package's `_chol_blocks` regime split
    (sparse_cholesky.py:338-347): the unrolled small_cholesky for
    n <= 16, cholesky_ex above with its info mapped to `ok`."""
    if blocks.shape[-1] <= smallchol.SMALL_N_MAX:
        return smallchol.small_cholesky(blocks)
    L, info = torch.linalg.cholesky_ex(blocks)
    diag = torch.diagonal(L, dim1=-2, dim2=-1)
    ok = ((info == 0) & torch.isfinite(L).all(-1).all(-1)
          & (diag > 0).all(-1))
    return L, ok


def tile_cholesky(blocks: torch.Tensor):
    """Cholesky of (k, n, n) SPD tiles, 1 <= n <= 256. Returns (L, ok): L
    lower-triangular with zeros above the diagonal; ok (k,) bool, every
    pivot positive and finite and every entry of L finite. The pivot rule
    is L_jj = d * rsqrt(d), unclamped, so a non-SPD tile leaves NaN or a
    non-positive diagonal. CUDA tensors go to kernel K6, CPU tensors to
    tile_cholesky_reference."""
    _check_square("blocks", blocks)
    if blocks.device.type == "cpu":
        return tile_cholesky_reference(blocks)
    if blocks.device.type != "cuda":
        raise ValueError(f"no kernel for device {blocks.device}")
    k, n = blocks.shape[0], blocks.shape[-1]
    A = blocks.contiguous()
    L = torch.empty_like(A)
    ok = torch.empty(k, dtype=torch.int32, device=A.device)
    if k:
        dt = "f32" if A.dtype == torch.float32 else "f64"
        _launch(f"dogleg_tilechol_{dt}", A.device, A.data_ptr(), k, n,
                L.data_ptr(), ok.data_ptr())
        launch_counts["tile_cholesky"] += 1
    return L, ok != 0


def tri_solve_right_reference(D: torch.Tensor, C: torch.Tensor):
    """K7's plain twin: X D^T = C as torch.linalg.solve_triangular with D^T
    upper-triangular on the right."""
    return torch.linalg.solve_triangular(D.mT, C, upper=True, left=False)


def tri_solve_right(D: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """X with X D^T = C, for D (k, n, n) lower-triangular (its strict upper
    part is not read) and C (k, m, n), 1 <= n <= 256, m >= 1. The quotient
    by D_jj is a true division. CUDA tensors go to kernel K7, CPU tensors
    to tri_solve_right_reference."""
    _check_square("D", D)
    _check_tiles("C", C)
    k, n = D.shape[0], D.shape[-1]
    if C.shape[0] != k or C.shape[-1] != n or C.shape[1] < 1:
        raise ValueError(f"C must be ({k}, m, {n}), got {tuple(C.shape)}")
    if C.dtype != D.dtype or C.device != D.device:
        raise ValueError("D and C must share dtype and device")
    if D.device.type == "cpu":
        return tri_solve_right_reference(D, C)
    if D.device.type != "cuda":
        raise ValueError(f"no kernel for device {D.device}")
    Dc, Cc = D.contiguous(), C.contiguous()
    X = torch.empty_like(Cc)
    if k:
        dt = "f32" if D.dtype == torch.float32 else "f64"
        _launch(f"dogleg_trisolve_right_{dt}", D.device, Dc.data_ptr(),
                Cc.data_ptr(), k, n, C.shape[1], X.data_ptr())
        launch_counts["tri_solve_right"] += 1
    return X
