#!/usr/bin/env python3
"""The segment-add kernel's source (libdogleg_tpu_torch/csrc/segsum.cu)
compiled for the host and held to its plain version, bit for bit, where
there is no nvcc and no card.

Run from the repository root (g++ with C++20 needed; about 30 s):

    python3 artifacts/exp_torch_segsum_host_emulation.py [tree]

The source is built with g++ against a stub of the few CUDA names it uses:
each lane is a std::thread, a block's threads run together and blocks in
turn, __syncwarp is a barrier of the warp's 32 threads, an asynchronous
copy a plain copy (which checks its size and alignment), and the grid's cap
is cut to 7 blocks, so that the grid-stride loop runs. Both entry points
(the 13-argument one and the one that reads ops/segsum.py's launch record)
are called on CPU tensors, whose pointers the emulated kernel reads, and
each result must be segsum.reference's bits: rows of 1 to 16384 elements,
runs longer than a chunk, more than 512 items with a long run, views one
element past a 16-byte boundary, float32 and float64, alpha 1 and -1. The
emulation checks the kernel's index arithmetic and the order of its adds,
not the ordering of its asynchronous copies, nor its speed.
"""

from __future__ import annotations

import ctypes
import pathlib
import re
import subprocess
import sys
import tempfile

import numpy as np
import torch

STUB = r"""
#pragma once
#include <algorithm>
#include <barrier>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(x)
#define __align__(x) alignas(x)
struct dim3 { unsigned x = 1, y = 1, z = 1; };
struct float4 { float x, y, z, w; };
struct double2 { double x, y; };
inline thread_local dim3 threadIdx, blockIdx;
inline dim3 gridDim, blockDim;
inline thread_local std::barrier<>* warp_barrier = nullptr;
inline thread_local unsigned char* smem_ptr = nullptr;
using std::min;
inline float __fadd_rn(float a, float b) { volatile float r = a + b; return r; }
inline double __dadd_rn(double a, double b) { volatile double r = a + b; return r; }
inline float rsqrtf(float x) { return 1 / __builtin_sqrtf(x); }
inline double rsqrt(double x) { return 1 / __builtin_sqrt(x); }
template <typename T> T __ldg(const T* p) { return *p; }
inline void __syncwarp(unsigned = 0xffffffffu) { warp_barrier->arrive_and_wait(); }
inline void __syncthreads() {}
inline void __pipeline_memcpy_async(void* d, const void* s, size_t n) {
  if ((n != 4 && n != 8 && n != 16) || reinterpret_cast<uintptr_t>(d) % n ||
      reinterpret_cast<uintptr_t>(s) % n) abort();
  std::memcpy(d, s, n);
}
inline void __pipeline_commit() {}
inline void __pipeline_wait_prior(int) {}
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
enum cudaDeviceAttr { cudaDevAttrMaxSharedMemoryPerBlockOptin };
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return 0; }
inline cudaError_t cudaSetDevice(int) { return 0; }
inline cudaError_t cudaGetLastError() { return 0; }
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) { *v = 232448; return 0; }
inline cudaError_t cudaFuncSetAttribute(const void*, cudaFuncAttribute, int) { return 0; }
template <typename F>
void emulate_launch(unsigned blocks, unsigned threads, size_t smem, F body) {
  gridDim.x = blocks;
  blockDim.x = threads;
  for (unsigned b = 0; b < blocks; ++b) {
    std::vector<unsigned char> shared(smem + 16);
    std::vector<std::barrier<>*> bars;
    for (unsigned w = 0; w < threads / 32; ++w) bars.push_back(new std::barrier<>(32));
    std::vector<std::thread> lanes;
    for (unsigned t = 0; t < threads; ++t)
      lanes.emplace_back([&, t] {
        blockIdx.x = b;
        threadIdx.x = t;
        warp_barrier = bars[t / 32];
        smem_ptr = shared.data();
        body();
      });
    for (auto& l : lanes) l.join();
    for (auto* p : bars) delete p;
  }
}
"""


def replaced(src: str, old: str, new: str) -> str:
    """src with old, which must occur in it, replaced by new."""
    if old not in src:
        raise SystemExit(f"segsum.cu no longer holds {old!r}")
    return src.replace(old, new)


def build(tree: pathlib.Path, out: pathlib.Path) -> ctypes.CDLL:
    """segsum.cu and group.cuh of `tree`, rewritten for the stub and built
    with g++ into `out`."""
    csrc = tree / "libdogleg_tpu_torch" / "csrc"
    src = (csrc / "segsum.cu").read_text()
    src = replaced(src, "extern __shared__ __align__(16) unsigned char "
                   "segsum_smem[];", "unsigned char* segsum_smem = smem_ptr;")
    src = replaced(src, "constexpr int MAX_BLOCKS = 1 << 20;",
                   "constexpr int MAX_BLOCKS = 7;")
    src = re.sub(
        r"(segment_add_\w+<[^<>]*>)\s*<<<([^,]+),([^,]+),([^,]+),([^>]+)>>>"
        r"\(([^;]*)\);",
        lambda m: (f"emulate_launch({m.group(2)},{m.group(3)},{m.group(4)},"
                   f" [&] {{ {m.group(1)}({m.group(6)}); }});"),
        src, flags=re.S)
    if "emulate_launch" not in src:
        raise SystemExit("no kernel launch found to emulate")
    (out / "segsum_host.cpp").write_text(src)
    (out / "group.cuh").write_text((csrc / "group.cuh").read_text())
    for name in ("cuda_runtime.h", "cuda_pipeline.h"):
        (out / name).write_text(STUB)
    lib = out / "libsegsum_host.so"
    subprocess.run(["g++", "-std=c++20", "-O1", "-shared", "-fPIC",
                    "-pthread", f"-I{out}", "-o", str(lib),
                    str(out / "segsum_host.cpp")], check=True)
    cdll = ctypes.CDLL(str(lib))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for dt in ("f32", "f64"):
        fn = getattr(cdll, f"dogleg_segment_add_{dt}")
        fn.argtypes = [ptr] * 5 + [i32] * 4 + [ctypes.c_int64, i32, i32, ptr]
        fn.restype = i32
    cdll.dogleg_segment_add_planned.argtypes = [ptr] * 4
    cdll.dogleg_segment_add_planned.restype = i32
    return cdll


def cases(rng, g):
    """(label, base, dim, targets, terms) of every case."""
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).split(".")[-1]

        def draw(*shape):
            return torch.randn(shape, dtype=dtype, generator=g)
        for inner in (1, 3, 8, 64, 128, 200, 16384):
            t = np.minimum(rng.geometric(0.2, 60) - 1, 9)
            yield (f"{name} rows of {inner}", draw(2, 10, inner), 1, t,
                   draw(2, 60, inner))
        for n in (300, 1000):
            t = np.full(n, 2)
            yield f"{name} a run of {n} on 8", draw(1, 5, 8), 1, t, draw(
                1, n, 8)
            yield f"{name} a run of {n} on 1", draw(5), 0, t, draw(n)
        for inner in (8, 3):
            t = np.r_[np.full(1000, 7), rng.permutation(600) + 10]
            rng.shuffle(t)
            yield (f"{name} 600 runs and a run of 1000 on {inner}",
                   draw(610, inner), 0, t, draw(len(t), inner))
        t = rng.integers(0, 10, 40)
        base = draw(1 + 3 * 10 * 8)[1:].view(3, 10, 8)
        terms = draw(1 + 3 * 40 * 8)[1:].view(3, 40, 8)
        yield f"{name} unaligned", base, 1, t, terms
        yield (f"{name} 3000 runs", draw(3000, 2), 0, rng.permutation(3000),
               draw(3000, 2))


def main() -> int:
    tree = pathlib.Path(sys.argv[1] if len(sys.argv) > 1 else ".").resolve()
    sys.path.insert(0, str(tree))
    from libdogleg_tpu_torch.ops import segsum
    with tempfile.TemporaryDirectory() as tmp:
        lib = build(tree, pathlib.Path(tmp))
        segsum._planned_entry = lambda: lib.dogleg_segment_add_planned
        rng, g = np.random.default_rng(0), torch.Generator().manual_seed(1)
        failed = 0
        for label, base, dim, targets, terms in cases(rng, g):
            plan = segsum.AddPlan(targets)
            for alpha in (1, -1):
                want = segsum.reference(base.clone(), dim, plan, terms,
                                        alpha=alpha)
                # the 13-argument entry
                out = base.clone()
                u, rp, tp = plan.kernel_operands(torch.device("cpu"))
                shape = base.shape
                entry = (lib.dogleg_segment_add_f32
                         if base.dtype == torch.float32
                         else lib.dogleg_segment_add_f64)
                err = entry(out.data_ptr(), terms.data_ptr(), u.data_ptr(),
                            rp.data_ptr(), tp.data_ptr(), u.numel(),
                            int(np.prod(shape[:dim])), shape[dim],
                            terms.shape[dim], int(np.prod(shape[dim + 1:])),
                            int(alpha == -1), 0, None)
                # the launch record's entry, on a view of base's own
                # alignment
                out2 = base.clone() if base.data_ptr() % 16 == 0 else \
                    torch.empty(base.numel() + 1, dtype=base.dtype)[1:].view(
                        base.shape).copy_(base)
                rec = segsum._launch_record(plan, out2, dim, terms, alpha)
                err2 = rec.entry(out2.data_ptr(), terms.data_ptr(),
                                 rec.address, None)
                same = (not err and not err2 and torch.equal(out, want)
                        and torch.equal(out2, want))
                failed += not same
                print(f"{label}, alpha {alpha}: "
                      f"{'the same bits' if same else 'DIFFERENT'}",
                      flush=True)
    print("every case the plain version's bits" if not failed
          else f"{failed} cases differ", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
