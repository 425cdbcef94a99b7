"""Blocked Cholesky for mid-size n, 17..256 (counterpart of
libdogleg_tpu/ops/blockchol.py).

A right-looking blocked factorization with static 16-wide panels: a 16x16
diagonal Cholesky, a 16-column triangular solve for the panel below it, and
the rank-16 trailing update. The reference's analog is LAPACK dpotrf's
blocked algorithm (reference dogleg.c:778-804). On a CUDA tensor the
factorization is kernel K5 (ops/batchchol.py, csrc/batchchol.cu), on a CPU
tensor its plain version, the same loop in PyTorch. The substitutions the
JAX package unrolls in `blocked_cho_solve`, outside any kernel, are
ops/cholesky.cholesky_solve here, on either device: it takes the same
float64 decisions, and the unrolled form is thousands of small launches per
call on the card.
"""

from __future__ import annotations

import torch

from libdogleg_tpu_torch.ops import batchchol, smallchol
from libdogleg_tpu_torch.ops.batchchol import BLOCK


def blocked_cholesky(A: torch.Tensor):
    """Cholesky of a (..., n, n) SPD matrix in 16-wide panels. Returns
    (L, ok): L lower-triangular, ok (...) every pivot positive and finite,
    the contract of smallchol.small_cholesky, which takes n <= 16 itself.
    Above that the leading axes are flattened to one batch axis (a single
    matrix is a batch of one) for ops/batchchol.py, where a CUDA tensor
    goes to kernel K5 and a CPU tensor to the kernel's plain version."""
    n = A.shape[-1]
    if n <= BLOCK:
        return smallchol.small_cholesky(A)
    lead = A.shape[:-2]
    L, ok = batchchol.batched_blocked_cholesky(A.reshape(-1, n, n))
    return L.reshape(lead + (n, n)), ok.reshape(lead)
