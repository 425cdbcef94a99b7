// What the kernels' launchers share (panelchol.cu: K2; bcsr.cu: K3, K4;
// batchchol.cu: K5; tilechol.cu: K6, K7; cholstage.cuh, the factorization
// K2, K5 and K6 build on): the block size and the group of threads that
// works on one matrix, 16-byte words, and the host-side work of a launch
// (selecting the device, sizing dynamic shared memory), done once and
// remembered so that a launch of a small kernel costs the host little more
// than the launch.

#pragma once

#include <cstddef>
#include <map>
#include <mutex>
#include <utility>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

// A group of G threads works on one matrix: a warp for the small matrices
// (eight to a block), the whole block for the others.
template <int G>
struct Group {
  __device__ static void sync() { __syncthreads(); }
};

template <>
struct Group<32> {
  __device__ static void sync() { __syncwarp(); }
};

__device__ __forceinline__ float rsqrt_(float x) { return rsqrtf(x); }
__device__ __forceinline__ double rsqrt_(double x) { return rsqrt(x); }

// The elements of one 16-byte word (four float32, two float64), moved with
// one load or store; the address must be 16-byte aligned.
template <typename T>
struct alignas(16) Word {
  static constexpr int N = 16 / sizeof(T);
  T v[N];
};

template <typename T>
__device__ __forceinline__ Word<T> load_word(const T* p) {
  return *reinterpret_cast<const Word<T>*>(p);
}

template <typename T>
__device__ __forceinline__ void store_word(T* p, const Word<T>& w) {
  *reinterpret_cast<Word<T>*>(p) = w;
}

// A 16-byte word from device memory through the read-only path.
__device__ __forceinline__ Word<float> load_word_readonly(const float* p) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(p));
  Word<float> w;
  w.v[0] = q.x, w.v[1] = q.y, w.v[2] = q.z, w.v[3] = q.w;
  return w;
}

__device__ __forceinline__ Word<double> load_word_readonly(const double* p) {
  const double2 q = __ldg(reinterpret_cast<const double2*>(p));
  Word<double> w;
  w.v[0] = q.x, w.v[1] = q.y;
  return w;
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<size_t>(p) % 16 == 0;
}

// Make `device` the calling thread's device, if it is not already.
inline cudaError_t use_device(int device) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess || current == device) return err;
  return cudaSetDevice(device);
}

// The most dynamic shared memory a block may ask for on `device`, queried
// once per device.
inline cudaError_t optin_shared(int device, int* optin) {
  static std::mutex lock;
  static std::map<int, int> known;
  std::lock_guard<std::mutex> hold(lock);
  auto it = known.find(device);
  if (it == known.end()) {
    int value = 0;
    cudaError_t err = cudaDeviceGetAttribute(
        &value, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err != cudaSuccess) return err;
    it = known.emplace(device, value).first;
  }
  *optin = it->second;
  return cudaSuccess;
}

// Let `kernel` use `bytes` of dynamic shared memory on `device`. Above the
// default 48 KB the kernel's limit has to be raised; the largest size granted
// to each (kernel, device) is remembered, so that only a larger request
// reaches the runtime again.
inline cudaError_t allow_shared(const void* kernel, int device, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  static std::mutex lock;
  static std::map<std::pair<const void*, int>, size_t> granted;
  std::lock_guard<std::mutex> hold(lock);
  size_t& have = granted[std::make_pair(kernel, device)];
  if (bytes <= have) return cudaSuccess;
  int optin = 0;
  cudaError_t err = optin_shared(device, &optin);
  if (err != cudaSuccess) return err;
  if (bytes > static_cast<size_t>(optin)) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess) have = bytes;
  return err;
}

}  // namespace
