"""The sample-fleet configuration's inputs, made on the device from the
seed: the frames' measurements and starts, with sample.c's distributions
(truth on the 10x10 grid plus uniform noise of the stated half-width;
starts uniform in [start_low, start_high])."""

from __future__ import annotations

import torch

DTYPES = {"float32": torch.float32, "float64": torch.float64}


def grid(cfg: dict, dtype, device):
    """The grid's x and y, (nmeas,) each, in sample.c's x-major order."""
    g = cfg["grid"]
    coords = g["min"] + g["delta"] * torch.arange(
        g["width"], dtype=torch.float64, device=device)
    gx, gy = torch.meshgrid(coords, coords, indexing="ij")
    return gx.reshape(-1).to(dtype), gy.reshape(-1).to(dtype)


def truth(cfg: dict, gx, gy):
    """sample.c's model at its true parameters, on the grid."""
    p = cfg["p_true"]
    return (p[0] * p[1] * gx * gx + p[1] * p[2] * gy * gy + p[2] * gx * gy
            + p[3] * gx + p[4] * gy + p[5])


def make(cfg: dict, mix: dict, seed: int, device) -> dict:
    """meas (frames, batch, nmeas) and p0 (frames, batch, nstate) in the
    configuration's dtype, both drawn by one generator on `device`."""
    dtype = DTYPES[cfg["dtype"]]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    frames, batch = mix["frames"], mix["batch"]
    gx, gy = grid(cfg, torch.float64, device)
    u = torch.rand((frames, batch, cfg["nmeas"]), generator=gen,
                   dtype=torch.float64, device=device)
    meas = truth(cfg, gx, gy) + (2.0 * u - 1.0) * cfg["noise_halfwidth"]
    s = torch.rand((frames, batch, cfg["nstate"]), generator=gen,
                   dtype=torch.float64, device=device)
    lo, hi = cfg["start_low"], cfg["start_high"]
    p0 = lo + (hi - lo) * s
    return {"meas": meas.to(dtype), "p0": p0.to(dtype), "gx": gx.to(dtype),
            "gy": gy.to(dtype), "dtype": dtype}
