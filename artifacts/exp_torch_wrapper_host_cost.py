#!/usr/bin/env python3
"""What a kernel wrapper's call costs the host, piece by piece, beside the
PyTorch calls the kernels are measured against.

Run from the repository root on a machine with a CUDA card and nvcc:

    PYTHONPATH=. python3 artifacts/exp_torch_wrapper_host_cost.py

Each line is the host's time per call (time.perf_counter over 3000 calls
issued back to back, the card synchronized before and after; 300 or 100
calls where the kernel takes longer than its wrapper, so that the launch
queue never fills and the host never waits for the card), on the
32x32x8 grid model's block-CSR Jacobian for K4's wrapper, on (1756, 8, 8)
tiles for K6's and K7's, and on (21, 128, 128) tiles for K6's and a 256-wide
panel for K2's: the argument checks, the library handle, the cached
index tensors, the output's allocation, the stream handle (through a
torch.cuda.Stream object and through the runtime binding), the ctypes call
that launches the kernel, the whole wrappers, and torch.mv of a BSR tensor,
solve_triangular and an elementwise add for scale. Last, K1's two wrappers
at B=8192 float32 with either stream handle, in turns.
"""

from __future__ import annotations

import time

import torch

import chip_smoke as c
from libdogleg_tpu_torch.native.loader import launch_target, load_library
from libdogleg_tpu_torch.ops import bcsr_kernels as tk
from libdogleg_tpu_torch.ops import panelchol, tilechol


def host_us(label, fn, reps=3000):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    print(f"[host cost] {label}: {us:.2f} us per call", flush=True)


def main() -> None:
    dev = torch.device("cuda", 0)
    print(f"[host cost] card {c.card_line()}", flush=True)
    J = c.grid_jacobian(torch.float32, dev)[0]
    s = J.structure
    v = torch.linspace(-1, 1, s.nstate, device=dev)
    lib = load_library()
    host_us("K4 argument checks", lambda: tk._check(J))
    host_us("library handle", load_library)
    host_us("two cached index tensors",
            lambda: (tk.device_indices(s.indptr, dev),
                     tk.device_indices(s.indices, dev)))
    host_us("torch.empty of the output",
            lambda: torch.empty(s.nmeas, dtype=v.dtype, device=dev))
    host_us("stream handle through torch.cuda.current_stream",
            lambda: torch.cuda.current_stream(dev).cuda_stream)
    host_us("stream handle through launch_target", lambda: launch_target(dev))
    out = torch.empty(s.nmeas, dtype=v.dtype, device=dev)
    args = (J.values.data_ptr(), s.block_rows, s.block_cols,
            tk.device_indices(s.indptr, dev).data_ptr(),
            tk.device_indices(s.indices, dev).data_ptr(), v.data_ptr(),
            s.nmeas, out.data_ptr(), *launch_target(dev))
    host_us("K4 ctypes call (the launch)",
            lambda: lib.dogleg_bcsr_matvec_f32(*args))
    host_us("K4 wrapper", lambda: tk.bcsr_matvec_kernel(J, v))
    bsr = c.bsr_tensor(J, v)
    if bsr is not None:
        host_us("torch.mv of the BSR tensor", lambda: torch.mv(bsr, v))
    L = c.spd_tiles(8, 1756, 1, torch.float32, dev)
    C = torch.randn(1756, 8, 8, device=dev)
    host_us("K7 wrapper (1756, 8, 8)",
            lambda: tilechol.tri_solve_right(L, C))
    host_us("K6 wrapper (1756, 8, 8)", lambda: tilechol.tile_cholesky(L))
    host_us("solve_triangular (1756, 8, 8)",
            lambda: torch.linalg.solve_triangular(L.mT, C, upper=True,
                                                  left=False))
    S = c.spd_tiles(128, 21, 2, torch.float32, dev)
    host_us("K6 wrapper (21, 128, 128)", lambda: tilechol.tile_cholesky(S),
            reps=300)
    host_us("cholesky_ex (21, 128, 128)",
            lambda: torch.linalg.cholesky_ex(S), reps=300)
    W = c.spd_on_device(256, 1, 3, torch.float32, dev) * 256
    host_us("K2 wrapper p=256", lambda: panelchol.panel_factor(W), reps=100)
    host_us("elementwise add of 8192 floats", lambda: v + v)
    k1_host_cost(dev)


def k1_host_cost(dev) -> None:
    """Both of K1's wrappers at B=8192 float32, each taking its stream
    through launch_target and, in turns, through a torch.cuda.Stream object
    built per call (the form they had before), in the order new, old, old,
    new. 100 calls a reading: the kernel takes longer than its wrapper."""
    from libdogleg_tpu_torch import DoglegParameters
    from libdogleg_tpu_torch.native import loader
    from libdogleg_tpu_torch.ops import mega
    bench = DoglegParameters(**c.BENCH)
    general = c.instances(1, c.BATCH, torch.float32, dev)
    factored, _ = c.factored_args(1, c.BATCH, torch.float32, dev)
    new = loader.launch_target

    def old(device):
        return device.index or 0, torch.cuda.current_stream(device).cuda_stream
    for form, target in (("launch_target", new), ("Stream object", old),
                         ("Stream object", old), ("launch_target", new)):
        loader.launch_target = target
        host_us(f"K1 general wrapper B={c.BATCH}, stream by {form}",
                lambda: mega.megakernel_optimize(*general, bench), reps=100)
        host_us(f"K1 factored wrapper B={c.BATCH}, stream by {form}",
                lambda: mega.megakernel_optimize_factored(*factored, bench),
                reps=100)
    loader.launch_target = new


if __name__ == "__main__":
    main()
