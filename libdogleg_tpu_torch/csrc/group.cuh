// What the batched-matrix kernels share (tilechol.cu: K6, K7; batchchol.cu:
// K5): the block size, the group of threads that works on one matrix, and
// the sizing of dynamic shared memory.

#pragma once

#include <cstddef>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

// A group of G threads works on one matrix, GX of them along a row and
// G / GX along the column: a warp for the small matrices (eight to a
// block), the whole block for the others.
template <int G>
struct Group;

template <>
struct Group<32> {
  static constexpr int GX = 8;
  __device__ static void sync() { __syncwarp(); }
  __device__ static bool all(bool v) { return __all_sync(0xffffffffu, v); }
};

template <>
struct Group<THREADS> {
  static constexpr int GX = 32;
  __device__ static void sync() { __syncthreads(); }
  __device__ static bool all(bool v) { return __syncthreads_and(v) != 0; }
};

__device__ __forceinline__ float rsqrt_(float x) { return rsqrtf(x); }
__device__ __forceinline__ double rsqrt_(double x) { return rsqrt(x); }

// Dynamic shared memory: `per_tile` bytes for each of a block's matrices when
// they fit in what a block may hold (in_smem = 1), else `fallback` bytes each.
template <typename Kernel>
cudaError_t shared_bytes(Kernel kernel, int device, int tiles_per_block,
                         size_t per_tile, size_t fallback, size_t* bytes,
                         int* in_smem) {
  int optin = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  *in_smem = tiles_per_block * per_tile <= static_cast<size_t>(optin);
  *bytes = tiles_per_block * (*in_smem ? per_tile : fallback);
  if (*bytes > 48 * 1024)
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(*bytes));
  return cudaSuccess;
}

}  // namespace
