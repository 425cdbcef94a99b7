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

import functools

import torch

from libdogleg_tpu_torch.ops import batchchol, smallchol
from libdogleg_tpu_torch.ops.traced import is_traced

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
    from libdogleg_tpu_torch.native.loader import launch_target, load_library
    err = getattr(load_library(), entry)(*args, *launch_target(device))
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


def tile_cholesky_blocked_reference(blocks: torch.Tensor, block: int = 16):
    """K6's algorithm for tiles wider than 32 in plain PyTorch, for the
    tests: the tile padded to a multiple of `block` with an identity
    diagonal, right-looking over `block`-wide panels (the diagonal block by
    K6's pivot rule, the panel below solved against it with a true division,
    the trailing block's rank-`block` update), and K6's ok: every pivot
    positive and finite and every entry of L finite."""
    L, ok = batchchol.batched_blocked_cholesky_reference(blocks, block)
    return L, ok & torch.isfinite(L).all(-1).all(-1)


@functools.lru_cache(maxsize=None)
def _works_in_shared(n: int, itemsize: int, index: int) -> bool:
    """Whether K6 holds an n-wide tile in shared memory on card `index`;
    otherwise it works in place in its output, which it can only for n a
    multiple of 16 (csrc/tilechol.cu, launch_chol_blocked)."""
    from libdogleg_tpu_torch.native.loader import load_library
    fits = load_library().dogleg_tilechol_in_shared(n, itemsize, index)
    if fits < 0:
        raise RuntimeError(f"dogleg_tilechol_in_shared failed: cudaError_t "
                           f"{-fits}")
    return bool(fits)


def tile_cholesky(blocks: torch.Tensor):
    """Cholesky of (k, n, n) SPD tiles, 1 <= n <= 256. Returns (L, ok): L
    lower-triangular with zeros above the diagonal; ok (k,) bool, every
    pivot positive and finite and every entry of L finite. The pivot rule
    is L_jj = d * rsqrt(d), unclamped, so a non-SPD tile leaves NaN or a
    non-positive diagonal. CUDA tensors go to kernel K6 (a tile too large
    for shared memory whose n is no multiple of 16 is padded to one with an
    identity block first, which the result drops again; while traced,
    ops/traced.is_traced, through the operator
    libdogleg_tpu_torch::tile_cholesky), CPU tensors to
    tile_cholesky_reference."""
    _check_square("blocks", blocks)
    if blocks.device.type == "cpu":
        return tile_cholesky_reference(blocks)
    if blocks.device.type != "cuda":
        raise ValueError(f"no kernel for device {blocks.device}")
    if is_traced(blocks):
        return _tile_cholesky_op(blocks)
    return _tile_cholesky_launch(blocks)


def _tile_cholesky_launch(blocks: torch.Tensor):
    """K6's launch on CUDA tiles (k, n, n): (L, ok), L contiguous."""
    k, n = blocks.shape[0], blocks.shape[-1]
    A = blocks.contiguous()
    if n % batchchol.BLOCK and not _works_in_shared(
            n, A.element_size(), A.device.index or 0):
        A = batchchol.pad_to_block(A)
    L = torch.empty_like(A)
    ok = torch.empty(k, dtype=torch.bool, device=A.device)
    if k:
        dt = "f32" if A.dtype == torch.float32 else "f64"
        _launch(f"dogleg_tilechol_{dt}", A.device, A.data_ptr(), k,
                A.shape[-1], L.data_ptr(), ok.data_ptr())
        launch_counts["tile_cholesky"] += 1
    return (L if A.shape[-1] == n else L[:, :n, :n].contiguous()), ok


@torch.library.custom_op("libdogleg_tpu_torch::tile_cholesky",
                         mutates_args=(), device_types="cuda")
def _tile_cholesky_op(blocks: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """K6 as an operator, the node a traced solve (export.py) carries."""
    return _tile_cholesky_launch(blocks)


@_tile_cholesky_op.register_fake
def _(blocks):
    return (blocks.new_empty(blocks.shape),
            blocks.new_empty(blocks.shape[:1], dtype=torch.bool))


def tri_solve_right_reference(D: torch.Tensor, C: torch.Tensor):
    """K7's plain twin: X D^T = C as torch.linalg.solve_triangular with D^T
    upper-triangular on the right."""
    return torch.linalg.solve_triangular(D.mT, C, upper=True, left=False)


def tri_solve_right_blocked_reference(D: torch.Tensor, C: torch.Tensor,
                                      block: int = 16) -> torch.Tensor:
    """K7's algorithm in plain PyTorch, for the tests: left-looking over
    `block`-wide column blocks J, X[:, J] = C[:, J] - X[:, <J] D[J, <J]^T as
    one product, then the solve inside the block column by column,
    x_j = (x_j - sum_{l in J, l < j} x_l D_jl) / D_jj, a true division."""
    n = D.shape[-1]
    X = C.clone()
    for j0 in range(0, n, block):
        j1 = min(j0 + block, n)
        if j0:
            X[..., j0:j1] -= X[..., :j0] @ D[..., j0:j1, :j0].mT
        for j in range(j0, j1):
            s = X[..., j] - (X[..., j0:j] * D[..., j:j + 1, j0:j]).sum(-1)
            X[..., j] = s / D[..., j, j, None]
    return X


def tri_solve_right(D: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """X with X D^T = C, for D (k, n, n) lower-triangular (its strict upper
    part is not used) and C (k, m, n), 1 <= n <= 256, m >= 1. The quotient
    by D_jj is a true division. CUDA tensors go to kernel K7 (while traced
    through the operator libdogleg_tpu_torch::tri_solve_right), CPU
    tensors to tri_solve_right_reference."""
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
    if is_traced(D) or is_traced(C):
        return _tri_solve_right_op(D, C)
    return _tri_solve_right_launch(D, C)


def _tri_solve_right_launch(D: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """K7's launch on CUDA D (k, n, n) and C (k, m, n)."""
    k, n = D.shape[0], D.shape[-1]
    Dc, Cc = D.contiguous(), C.contiguous()
    X = torch.empty_like(Cc)
    if k:
        dt = "f32" if D.dtype == torch.float32 else "f64"
        _launch(f"dogleg_trisolve_right_{dt}", D.device, Dc.data_ptr(),
                Cc.data_ptr(), k, n, C.shape[1], X.data_ptr())
        launch_counts["tri_solve_right"] += 1
    return X


@torch.library.custom_op("libdogleg_tpu_torch::tri_solve_right",
                         mutates_args=(), device_types="cuda")
def _tri_solve_right_op(D: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """K7 as an operator, the node a traced solve (export.py) carries."""
    return _tri_solve_right_launch(D, C)


@_tri_solve_right_op.register_fake
def _(D, C):
    return C.new_empty(C.shape)
