// The block-sparse path's fixed-order segment add, for Hopper (sm_90a).
//
// Not a port of a Pallas kernel: it replaces the scatter-adds that XLA
// lowers in the JAX package's sparse factorization and substitutions
// (libdogleg_tpu/sparse_cholesky.py:495, `vals.at[ut].add(-contrib)`, and
// :550, `y.at[pj].add(-contrib)`), which the port first wrote as
// index_add_. On a CUDA device index_add_ adds with atomics: where several
// terms of a level land on one block, the order of the adds, and the last
// bits of the sum, changed from run to run. Caller:
// libdogleg_tpu_torch/ops/segsum.py (wrapper segment_add_kernel), from
// sparse_cholesky.py's UPDATE and pair steps and ops/bcsr.py's J^T x and J v.
//
// What it computes. base is (outer, nbase, inner) and terms (outer, nterm,
// inner), both contiguous; for each distinct target r (uniq[r] < nbase),
// each outer index and each inner element, in place:
//   base[o, uniq[r], e] = (((base + t_0) + t_1) + ...)
// with t_j = terms[o, term_pos[run_ptr[r] + j], e] (negated when `negate`),
// the terms of run r in index order: the order in which index_add_ adds
// them on the CPU, so this kernel gives its plain version's bits
// (segsum.py's `reference`) on every run. Every add is __fadd_rn /
// __dadd_rn: nothing to contract, and a negated term is exact.
//
// Design: one thread a (outer, target, element), a grid-stride loop; the
// threads of a warp take consecutive elements of one block, so a run's
// term reads and the target's read and write are coalesced, and nothing is
// shared between threads (no atomics, no barriers). A thread issues the
// loads of UNROLL terms before it adds them, in order. A level's work is a
// few thousand to a few million elements, one launch for the level where
// the plain version takes two a round. On an H100 (700 W),
// float32, the B16 batch's widest UPDATE level (154 terms of 128x128
// blocks) took 0.21 ms against index_add_'s 0.32; its forward pair level
// with 17 terms on one row of 16 x 128 elements 46 us against 13 before
// the loads were grouped (chip_smoke.py phase 22).

#include <cstdint>

#include "group.cuh"

namespace {

constexpr int UNROLL = 8;

__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}

template <typename T, bool NEGATE>
__global__ void segment_add_kernel(T* __restrict__ base,
                                   const T* __restrict__ terms,
                                   const int* __restrict__ uniq,
                                   const int* __restrict__ run_ptr,
                                   const int* __restrict__ term_pos,
                                   int n_runs, int nbase, int nterm,
                                   int64_t inner, int64_t total) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < total; i += stride) {
    const int64_t e = i % inner;
    const int64_t rest = i / inner;
    const int r = static_cast<int>(rest % n_runs);
    const int64_t o = rest / n_runs;
    T* dst = base + (o * nbase + uniq[r]) * inner + e;
    const T* src = terms + o * nterm * inner + e;
    T acc = *dst;
    int j = run_ptr[r];
    const int end = run_ptr[r + 1];
    // UNROLL loads in flight, then their adds in order: a long run (the
    // substitutions put up to hundreds of terms on one row, a level with
    // few rows) waits for one load latency a group, not one a term
    for (; j + UNROLL <= end; j += UNROLL) {
      T t[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        t[u] = src[static_cast<int64_t>(term_pos[j + u]) * inner];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        acc = add_rn(acc, NEGATE ? -t[u] : t[u]);
    }
    for (; j < end; ++j) {
      const T t = src[static_cast<int64_t>(term_pos[j]) * inner];
      acc = add_rn(acc, NEGATE ? -t : t);
    }
    *dst = acc;
  }
}

template <typename T>
int segment_add(void* base, const void* terms, const void* uniq,
                const void* run_ptr, const void* term_pos, int n_runs,
                int outer, int nbase, int nterm, int64_t inner, int negate,
                int device, void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t total = static_cast<int64_t>(outer) * n_runs * inner;
  if (total == 0) return 0;
  const int64_t want = (total + THREADS - 1) / THREADS;
  const int blocks = static_cast<int>(want < (1 << 20) ? want : (1 << 20));
  auto s = static_cast<cudaStream_t>(stream);
  auto b = static_cast<T*>(base);
  auto t = static_cast<const T*>(terms);
  auto u = static_cast<const int*>(uniq);
  auto rp = static_cast<const int*>(run_ptr);
  auto tp = static_cast<const int*>(term_pos);
  if (negate)
    segment_add_kernel<T, true><<<blocks, THREADS, 0, s>>>(
        b, t, u, rp, tp, n_runs, nbase, nterm, inner, total);
  else
    segment_add_kernel<T, false><<<blocks, THREADS, 0, s>>>(
        b, t, u, rp, tp, n_runs, nbase, nterm, inner, total);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int dogleg_segment_add_f32(void* base, const void* terms,
                                      const void* uniq, const void* run_ptr,
                                      const void* term_pos, int n_runs,
                                      int outer, int nbase, int nterm,
                                      int64_t inner, int negate, int device,
                                      void* stream) {
  return segment_add<float>(base, terms, uniq, run_ptr, term_pos, n_runs,
                            outer, nbase, nterm, inner, negate, device,
                            stream);
}

extern "C" int dogleg_segment_add_f64(void* base, const void* terms,
                                      const void* uniq, const void* run_ptr,
                                      const void* term_pos, int n_runs,
                                      int outer, int nbase, int nterm,
                                      int64_t inner, int negate, int device,
                                      void* stream) {
  return segment_add<double>(base, terms, uniq, run_ptr, term_pos, n_runs,
                             outer, nbase, nterm, inner, negate, device,
                             stream);
}
