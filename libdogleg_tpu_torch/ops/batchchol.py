"""Kernel K5: the batched blocked Cholesky for mid-size n (counterpart of
libdogleg_tpu/ops/pallas_blockchol.py).

`batched_blocked_cholesky` factors a (B, n, n) batch of SPD matrices by the
right-looking blocked algorithm in 16-wide panels and returns the factors
with a per-matrix failure flag. ops/blockchol.py calls it for every
Gauss-Newton step of BlockedDenseNewtonSolver at 17 <= Nstate <= 256.

On a CUDA tensor the wrapper launches the hand-written kernel in
csrc/batchchol.cu; on a CPU tensor it runs the plain version
(`batched_blocked_cholesky_reference`), the same algorithm in PyTorch.
There is no fallback: a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import torch

from libdogleg_tpu_torch.native.loader import launch_target, load_library
from libdogleg_tpu_torch.ops import smallchol

BLOCK = 16
# Largest matrix the kernel takes (csrc/batchchol.cu MAX_N).
MAX_N = 256

# Kernel launches made in this process.
launch_count = 0


def pad_to_block(A: torch.Tensor, block: int = BLOCK) -> torch.Tensor:
    """Pad (..., n, n) to the next multiple of `block` with an identity
    diagonal block: [[A, 0], [0, I]] factors as [[L, 0], [0, I]]."""
    n = A.shape[-1]
    npad = (-n) % block
    if npad == 0:
        return A
    W = torch.zeros(A.shape[:-2] + (n + npad, n + npad), dtype=A.dtype,
                    device=A.device)
    W[..., :n, :n] = A
    idx = torch.arange(n, n + npad, device=A.device)
    W[..., idx, idx] = 1.0
    return W


def _trsm_right_lt(P: torch.Tensor, Lkk: torch.Tensor) -> torch.Tensor:
    """Solve X @ Lkk^T = P for X, with Lkk (..., b, b) lower-triangular and
    P (..., r, b). Unrolled over the b columns."""
    b = Lkk.shape[-1]
    X = []
    for j in range(b):
        s = P[..., :, j]
        for m in range(j):
            s = s - X[m] * Lkk[..., j, m][..., None]
        X.append(s / Lkk[..., j, j][..., None])
    return torch.stack(X, dim=-1)


def batched_blocked_cholesky_reference(A: torch.Tensor, block: int = BLOCK):
    """K5's plain version: the right-looking blocked Cholesky of (..., n, n)
    in `block`-wide panels (padded internally to a multiple of `block`, the
    kernel's 16 unless told otherwise): the unrolled diagonal Cholesky of
    ops/smallchol.py, an unrolled triangular solve of the panel below it,
    and the trailing update as one batched matrix product. Returns (L, ok),
    the contract of smallchol.small_cholesky."""
    n = A.shape[-1]
    b = block
    if n <= b:
        return smallchol.small_cholesky(A)
    W = pad_to_block(A, b)
    npad = W.shape[-1]
    L = torch.zeros_like(W)
    ok = None
    for j0 in range(0, npad, b):
        Lkk, okk = smallchol.small_cholesky(W[..., :b, :b])
        ok = okk if ok is None else ok & okk
        L[..., j0:j0 + b, j0:j0 + b] = Lkk
        if j0 + b < npad:
            Pl = _trsm_right_lt(W[..., b:, :b], Lkk)
            L[..., j0 + b:, j0:j0 + b] = Pl
            # the trailing block shrinks: W becomes W[rest, rest] - Pl Pl^T
            W = W[..., b:, b:] - Pl @ Pl.mT
    return L[..., :n, :n], ok


def batched_blocked_cholesky(A: torch.Tensor):
    """Cholesky of a (B, n, n) batch of SPD matrices, 1 <= n <= 256, float32
    or float64. Returns (L, ok): L (B, n, n) lower-triangular with zeros
    above the diagonal; ok (B,) bool, every pivot of that matrix positive
    and finite. The pivot rule is L_jj = d * rsqrt(d), unclamped, so a
    matrix that is not SPD leaves NaN or a non-positive diagonal in its own
    factor. CUDA tensors go to kernel K5 (padded to a multiple of 16 with an
    identity block, which the result drops again), CPU tensors to
    batched_blocked_cholesky_reference."""
    global launch_count
    if A.dim() != 3 or A.shape[-2] != A.shape[-1]:
        raise ValueError(f"A must be (B, n, n), got {tuple(A.shape)}")
    n = A.shape[-1]
    if not 0 < n <= MAX_N:
        raise ValueError(f"A must have 1 <= n <= {MAX_N}, got n = {n}")
    if A.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"A must be float32 or float64, got {A.dtype}")
    if A.device.type == "cpu":
        return batched_blocked_cholesky_reference(A)
    if A.device.type != "cuda":
        raise ValueError(f"no kernel for device {A.device}")
    W = pad_to_block(A)
    if not W.is_contiguous() or W.data_ptr() % 16:  # 16-byte words
        W = W.clone(memory_format=torch.contiguous_format)
    B, npad = W.shape[0], W.shape[-1]
    L = torch.empty_like(W)
    ok = torch.empty(B, dtype=torch.bool, device=W.device)
    if B:
        lib = load_library()
        entry = (lib.dogleg_batchchol_f32 if W.dtype == torch.float32
                 else lib.dogleg_batchchol_f64)
        err = entry(W.data_ptr(), B, npad, L.data_ptr(), ok.data_ptr(),
                    *launch_target(W.device))
        if err:
            raise RuntimeError(f"batched_blocked_cholesky launch failed: "
                               f"cudaError_t {err}")
        launch_count += 1
    return (L if npad == n else L[:, :n, :n]), ok
