"""Where the package's constructors put their tensors by default.

The package is written for the card: a constructor that is given no device
places its tensors on the CUDA device, and says how to ask for the CPU when
there is none. There is no quiet "cuda if available else cpu".
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`device` as a torch.device; None means the CUDA device. Raises a
    RuntimeError naming the remedy when None is given and there is no CUDA
    device."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            'no CUDA device: the default device is "cuda"; pass '
            'device="cpu" to build the tensors on the CPU')
    return torch.device("cuda")
