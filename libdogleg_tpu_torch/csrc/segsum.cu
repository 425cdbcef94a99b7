// The block-sparse path's fixed-order segment add, for Hopper (sm_90a).
//
// Not a port of a Pallas kernel: it replaces the scatter-adds that XLA
// lowers in the JAX package's sparse factorization and substitutions
// (libdogleg_tpu/sparse_cholesky.py:495, `vals.at[ut].add(-contrib)`, and
// :550, `y.at[pj].add(-contrib)`), which the port first wrote as
// index_add_. On a CUDA device index_add_ adds with atomics: where several
// terms of a level land on one block, the order of the adds, and the last
// bits of the sum, changed from run to run. Caller:
// libdogleg_tpu_torch/ops/segsum.py (wrapper segment_add_kernel and the
// cached launch of add_/add), from sparse_cholesky.py's UPDATE and pair
// steps and ops/bcsr.py's J^T x, J v and dense J^T J.
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
// What bounds it on this card, by regime (a level's plan, f32):
// - substitution levels (rows of 8-128 elements, one right-hand side): a
//   few runs of up to hundreds of terms (config 6b simplicial's forward
//   levels: 121 terms on one row of 8 elements at the median level, 284 at
//   most). The bytes are a few KB, under 10 ns at 3.35 TB/s: the bound is
//   latency, the dependent trips to memory (run pointers, then a term's
//   position, then its row) and the chain of adds itself.
// - UPDATE levels with wide rows (the supernodal factorization's 128x128
//   blocks, 16384 elements): runs of 1-4 terms, megabytes a level: bytes.
//   The B16 batch's widest level reads 154 rows of terms and reads and
//   writes 121 target rows for each of 16 elements, 123.95 us at 3.35 TB/s.
// - UPDATE levels with narrow rows (simplicial, 8x8 blocks): thousands of
//   runs of 1-4 terms, tens of KB: latency again, spread over many runs.
//
// Design. A warp takes one work item, (outer index, run, tile of up to 32
// copy units of the row), so the run's pointers and target are read once
// an item and no thread does index arithmetic per element. A copy unit is a
// 16-byte word (four float32, two float64) where base and terms are 16-byte
// aligned and a row is a whole number of words, else one element (4 or 8
// bytes); the launcher picks the instance from those and from the number of
// items, as K3's and K4's pick theirs. The loads are split from the adds,
// not the adds from each other: the run's term rows for the tile are copied
// into shared memory by cp.async, spread over all 32 lanes (a lane loads
// the positions of the terms it copies, all of a batch before its first
// copy; lanes that copy one term read one address, one transaction), a
// whole chunk kept in flight at once; then the lane that owns a unit of
// the tile adds that unit's terms from shared memory in index order into a
// register that holds the target's value, read once, and writes once. A
// run longer than a chunk goes through a ring of two chunks: the next
// chunk's copies are in flight while this chunk is added.
// - Few items (at most FEW_ITEMS: the substitutions' levels, B16's forward
//   levels): one warp a block and 16 KB chunks, so that a run is one chunk
//   in most levels and a level costs three dependent trips to memory (run
//   pointers, positions, rows) and its chain of adds: the 6b forward
//   level's 284 terms on one 8-element row are one chunk of 9 KB, where a
//   thread an element took 36 dependent index-and-data pairs.
// - Many items (UPDATE levels): four warps a block, 2 KB chunks, so that
//   enough warps fit on an SM to keep the bytes in flight: wide rows take
//   one warp per 512-byte tile with 16-byte loads and stores.
// The grid strides over the items, so it never meets the grid's limits
// (the 6b simplicial UPDATE levels have up to 16248 runs, B16's outer is
// 16). Nothing is shared between warps: no atomics, no block barrier.

#include <cstdint>
#include <climits>
#include <cuda_pipeline.h>

#include "group.cuh"

namespace {

constexpr int SEG_TILE = 32;  // copy units of a row a warp adds, one a lane
// A launch of at most FEW_ITEMS items is bound by latency: one warp a
// block, chunks of 16 KB and up to 512 terms (a whole run in most levels:
// 512 terms of an 8-element float32 row, 32 of a 128-element one). More
// items: four warps a block, chunks of 2 KB and up to 128 terms (the
// UPDATE levels' runs hold 1-4), 20 KB a block, so that the registers,
// not shared memory, bound the warps on an SM.
constexpr int64_t FEW_ITEMS = 512;
// The most blocks a launch takes: the warps stride over the items beyond.
constexpr int MAX_BLOCKS = 1 << 20;

__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}

// V elements moved by one copy: a 16-byte word, or one element.
template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

// The positions of chunk k's terms into the position ring's stage k & 1:
// 4-byte asynchronous copies spread over the lanes, one commit group.
__device__ __forceinline__ void stage_positions(int* pos_ring, int pmax,
                                                int k, int per, int n,
                                                const int* __restrict__ pos_of,
                                                int lane) {
  int* dst = pos_ring + (k & 1) * pmax;
  const int j0 = k * per;
  const int c = min(per, n - j0);
  for (int i = lane; i < c; i += 32)
    __pipeline_memcpy_async(dst + i, pos_of + j0 + i, sizeof(int));
  __pipeline_commit();
}

// Chunk k's term rows for the tile into the ring's stage k & 1, term j's
// unit v at j * w + v: lane l copies l, l + 32, ..., its (term, unit) pair
// stepped without a division; positions from the position ring; one
// commit group.
template <typename T, int V>
__device__ __forceinline__ void stage_rows(Pack<T, V>* ring, int stage,
                                           const int* pos_ring, int pmax,
                                           int k, int per, int n, int w,
                                           const T* __restrict__ src,
                                           int64_t inner, int lane) {
  Pack<T, V>* buf = ring + (k & 1) * stage;
  const int* pos = pos_ring + (k & 1) * pmax;
  const int cnt = min(per, n - k * per) * w;
  const int dj = 32 / w, dv = 32 - dj * w;  // 32 copies = dj terms + dv
  int j = lane / w, v = lane - (lane / w) * w;
#pragma unroll 4
  for (int q = lane; q < cnt; q += 32) {
    __pipeline_memcpy_async(buf + q,
                            src + static_cast<int64_t>(pos[j]) * inner +
                                static_cast<int64_t>(v) * V,
                            sizeof(Pack<T, V>));
    j += dj;
    v += dv;
    if (v >= w) v -= w, ++j;
  }
  __pipeline_commit();
}

template <typename T, int V, bool NEGATE, int WARPS>
__global__ void __launch_bounds__(WARPS * 32)
    segment_add_rows(T* __restrict__ base, const T* __restrict__ terms,
                     const int* __restrict__ uniq,
                     const int* __restrict__ run_ptr,
                     const int* __restrict__ term_pos, int n_runs,
                     int nbase, int nterm, int64_t inner, int nvec,
                     int ntiles, int stage, int pmax, int items) {
  using P = Pack<T, V>;
  extern __shared__ __align__(16) unsigned char segsum_smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // a warp's part: two stages of rows, then two of positions
  P* ring = reinterpret_cast<P*>(segsum_smem) +
            static_cast<size_t>(warp) * 2 * stage;
  int* pos_ring = reinterpret_cast<int*>(
                      reinterpret_cast<P*>(segsum_smem) +
                      static_cast<size_t>(WARPS) * 2 * stage) +
                  warp * 2 * pmax;
  for (int64_t at = static_cast<int64_t>(blockIdx.x) * WARPS + warp;
       at < items; at += static_cast<int64_t>(gridDim.x) * WARPS) {
    const int item = static_cast<int>(at);
    const int tile = item % ntiles;
    const int rest = item / ntiles;
    const int r = rest % n_runs;
    const int64_t o = rest / n_runs;
    const int v0 = tile * SEG_TILE;
    const int w = min(SEG_TILE, nvec - v0);
    const int beg = __ldg(run_ptr + r);
    const int n = __ldg(run_ptr + r + 1) - beg;
    const int tgt = __ldg(uniq + r);
    const int per = min(stage / w, pmax);  // terms a chunk
    const int nch = (n + per - 1) / per;
    const T* src = terms + o * nterm * inner + static_cast<int64_t>(v0) * V;
    P* dst = reinterpret_cast<P*>(base + (o * nbase + tgt) * inner) + v0 +
             lane;
    stage_positions(pos_ring, pmax, 0, per, n, term_pos + beg, lane);
    P acc;
    if (lane < w) acc = *dst;  // in flight while the positions land
    __pipeline_wait_prior(0);
    __syncwarp();
    stage_rows<T, V>(ring, stage, pos_ring, pmax, 0, per, n, w, src, inner,
                     lane);
    for (int k = 0; k < nch; ++k) {
      if (k + 1 < nch)
        stage_positions(pos_ring, pmax, k + 1, per, n, term_pos + beg, lane);
      __pipeline_wait_prior(0);  // chunk k's rows, chunk k + 1's positions
      __syncwarp();
      if (k + 1 < nch)  // in flight while chunk k is added
        stage_rows<T, V>(ring, stage, pos_ring, pmax, k + 1, per, n, w, src,
                         inner, lane);
      if (lane < w) {
        const P* buf = ring + (k & 1) * stage + lane;
        const int m = min(per, n - k * per);
#pragma unroll 4
        for (int j = 0; j < m; ++j) {
          const P t = buf[j * w];
#pragma unroll
          for (int u = 0; u < V; ++u)
            acc.v[u] = add_rn(acc.v[u], NEGATE ? -t.v[u] : t.v[u]);
        }
      }
      __syncwarp();  // stage k & 1 is read before chunk k + 2 refills it
    }
    if (lane < w) *dst = acc;
  }
}

template <typename T, int V, bool NEGATE, int WARPS>
cudaError_t launch_as(T* base, const T* terms, const int* uniq,
                      const int* run_ptr, const int* term_pos, int n_runs,
                      int nbase, int nterm, int64_t inner, int nvec,
                      int ntiles, int stage_bytes, int pmax, int items,
                      cudaStream_t s) {
  const int stage = stage_bytes / static_cast<int>(sizeof(Pack<T, V>));
  const int want = (items + WARPS - 1) / WARPS;
  const int blocks = want < MAX_BLOCKS ? want : MAX_BLOCKS;
  const size_t smem =
      static_cast<size_t>(WARPS) * 2 * (stage_bytes + pmax * sizeof(int));
  segment_add_rows<T, V, NEGATE, WARPS>
      <<<blocks, WARPS * 32, smem, s>>>(base, terms, uniq, run_ptr,
                                        term_pos, n_runs, nbase, nterm,
                                        inner, nvec, ntiles, stage, pmax,
                                        items);
  return cudaGetLastError();
}

template <typename T, int V, bool NEGATE>
cudaError_t launch_rows(T* base, const T* terms, const int* uniq,
                        const int* run_ptr, const int* term_pos, int n_runs,
                        int outer, int nbase, int nterm, int64_t inner,
                        cudaStream_t s) {
  if (inner / V > INT_MAX) return cudaErrorInvalidValue;
  const int nvec = static_cast<int>(inner / V);
  const int ntiles = (nvec + SEG_TILE - 1) / SEG_TILE;
  const int64_t items = static_cast<int64_t>(outer) * n_runs * ntiles;
  if (items == 0) return cudaSuccess;
  if (items > INT_MAX) return cudaErrorInvalidValue;
  const int n = static_cast<int>(items);
  if (items <= FEW_ITEMS)
    return launch_as<T, V, NEGATE, 1>(base, terms, uniq, run_ptr, term_pos,
                                      n_runs, nbase, nterm, inner, nvec,
                                      ntiles, 16384, 512, n, s);
  return launch_as<T, V, NEGATE, 4>(base, terms, uniq, run_ptr, term_pos,
                                    n_runs, nbase, nterm, inner, nvec, ntiles,
                                    2048, 128, n, s);
}

template <typename T>
int segment_add(void* base, const void* terms, const void* uniq,
                const void* run_ptr, const void* term_pos, int n_runs,
                int outer, int nbase, int nterm, int64_t inner, int negate,
                int device, void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (static_cast<int64_t>(outer) * n_runs * inner == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  auto b = static_cast<T*>(base);
  auto t = static_cast<const T*>(terms);
  auto u = static_cast<const int*>(uniq);
  auto rp = static_cast<const int*>(run_ptr);
  auto tp = static_cast<const int*>(term_pos);
  constexpr int WV = Word<T>::N;
  // 16-byte words where every row starts on one, else one element a copy
  const bool words = aligned16(base) && aligned16(terms) && inner % WV == 0;
  if (words)
    err = negate ? launch_rows<T, WV, true>(b, t, u, rp, tp, n_runs, outer,
                                            nbase, nterm, inner, s)
                 : launch_rows<T, WV, false>(b, t, u, rp, tp, n_runs, outer,
                                             nbase, nterm, inner, s);
  else
    err = negate ? launch_rows<T, 1, true>(b, t, u, rp, tp, n_runs, outer,
                                           nbase, nterm, inner, s)
                 : launch_rows<T, 1, false>(b, t, u, rp, tp, n_runs, outer,
                                            nbase, nterm, inner, s);
  return static_cast<int>(err);
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


// The same launch with its arguments but the data pointers read from a
// record on the host (ops/segsum.py keeps one a plan, shapes, dtype and
// device, and passes its address): one ctypes call of four arguments where
// the entries above take thirteen, whose conversion costs the host more
// than the launch. The fields' order is ops/segsum.py's _LaunchArgs.
struct SegmentAddArgs {
  const void* uniq;
  const void* run_ptr;
  const void* term_pos;
  int64_t inner;
  int32_t n_runs, outer, nbase, nterm;
  int32_t negate, device, elem_bytes, unused;
};

extern "C" int dogleg_segment_add_planned(void* base, const void* terms,
                                          const SegmentAddArgs* a,
                                          void* stream) {
  if (a->elem_bytes == 4)
    return segment_add<float>(base, terms, a->uniq, a->run_ptr, a->term_pos,
                              a->n_runs, a->outer, a->nbase, a->nterm,
                              a->inner, a->negate, a->device, stream);
  return segment_add<double>(base, terms, a->uniq, a->run_ptr, a->term_pos,
                             a->n_runs, a->outer, a->nbase, a->nterm,
                             a->inner, a->negate, a->device, stream);
}
