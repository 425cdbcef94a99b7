// Kernels K3 and K4: block-sparse Jacobian products over a block-CSR
// Jacobian J with stored blocks vals (nnzb, bm, bn), for Hopper (sm_90a).
//
// K3 replaces libdogleg_tpu/ops/pallas_bcsr.py::bcsr_jtj_blocks_pallas
// (pallas_call at :117, kernel _jtj_kernel at :84-99): the blocks of J^T J,
// out[o] = sum over the schedule's run of output block o of
// vals[pair_i[k]]^T vals[pair_j[k]]. K4 replaces
// libdogleg_tpu/ops/pallas_bcsr.py::bcsr_matvec_pallas (pallas_call at :212,
// kernel _matvec_kernel at :171-187): J v.
//
// What bounds K3 on this card. It reads each scheduled pair's two blocks
// (2 bm bn values a pair) for bm bn^2 multiply-adds and writes each output
// block once: on the 32x32x8 grid model's dense coupling (4992 stored 8x8
// blocks, 8960 pairs in runs of 1-5, 4992 output blocks, float32) 2.6 MB
// counted once, under a microsecond at 3.35 TB/s, so it is a launch's size:
// what counts is that the reads are wide and in flight together, not a chain
// of dependent trips to memory (run pointers, then a pair's indices, then
// its values) one scalar at a time.
//
// K3's design. For the grid model's (8, 8) blocks, float32 and float64, with
// 16-byte-aligned values, a group of lanes works on one output block, one
// lane per 16-byte word of it (16 lanes in float32, 32 in float64), several
// groups to a thread block, so the grid is one wave. The group reads its
// run's pair indices once, one lane per pair, and passes them round by
// shuffles; every value block of up to JTJ_CHUNK pairs is requested before
// the first product, as 16-byte asynchronous copies into shared memory; each
// lane then sums its word's entries over the run's pairs in schedule order
// and, within a pair, over the block's rows in order, which is the generic
// kernel's order, so the two give the same bits; one 16-byte store a lane.
// Every other block shape, and values that are not 16-byte aligned, take the
// generic kernel: one thread block per output block walking that block's run
// of the schedule (pairs sorted by output block, run offsets derived on the
// host from out_idx), each thread owning output entries (i, j) and summing
// over the run's pairs and the bm rows with scalar loads. Neither needs
// atomics, and the sum order is fixed. The TPU kernels kept each output tile
// in VMEM across the grid; here every output is a register sum written once.
// launch_jtj alone chooses between the two.
//
// A batch of Jacobians that share one structure (vals (B, nnzb, bm, bn), out
// (B, nout, bn, bn)) is one launch: the grid's y index is the element, and
// each element's blocks are summed exactly as a single Jacobian's are, so an
// element's bits do not depend on the batch it is in.
//
// What bounds K4 on this card. It reads each stored block once and v and
// writes J v: 1.4 MB on the 32x32x8 grid model's 8x8 float32 blocks, under
// half a microsecond at 3.35 TB/s, so it is the size of a launch: what
// counts is one launch, no copy before it (the wrapper keeps the structure's
// index arrays on the card) and enough wide loads in flight. One thread per
// measurement row with scalar loads puts neighbouring lanes a block row
// apart: 32 sectors an instruction for 128 useful bytes, and every thread of
// a block row reads the row's indices again.
//
// K4's design. For the grid model's (8, 8) blocks, float32 and float64, a
// group of lanes works on one block row, one lane per 16-byte word of a
// block: 16 lanes for an 8x8 float32 block, so a warp reads two whole
// blocks, 512 contiguous bytes, per load instruction, through the read-only
// path. Each lane multiplies its word by the matching word of v, sums over
// the row's blocks in CSR order, and the lanes of one row of the block are
// summed with xor shuffles: a fixed order, no atomics; one lane writes each
// output entry once. Every other block shape, and operands that are not
// 16-byte aligned, take the generic kernel: one thread per measurement row,
// walking that row's blocks with scalar loads. Both are kernels of this
// file; launch_matvec alone chooses between them.

#include <cuda_pipeline.h>

#include "group.cuh"

namespace {

constexpr int MV_THREADS = 128;   // K4: threads of a block
constexpr int JTJ_THREADS = 128;  // K3's word kernel: threads of a block
constexpr int JTJ_CHUNK = 8;      // pairs of a run staged at a time

template <typename T>
__global__ void jtj_blocks_kernel(const T* __restrict__ vals, int bm, int bn,
                                  const int* __restrict__ pair_i,
                                  const int* __restrict__ pair_j,
                                  const int* __restrict__ run_ptr,
                                  size_t vstride, size_t ostride,
                                  T* __restrict__ out) {
  const int o = blockIdx.x;
  const int k0 = run_ptr[o], k1 = run_ptr[o + 1];
  const size_t blk = static_cast<size_t>(bm) * bn;
  vals += blockIdx.y * vstride;
  T* dst = out + blockIdx.y * ostride + static_cast<size_t>(o) * bn * bn;
  for (int idx = threadIdx.x; idx < bn * bn; idx += blockDim.x) {
    const int i = idx / bn, j = idx - i * bn;
    T s = T(0);
    for (int k = k0; k < k1; ++k) {
      const T* a = vals + pair_i[k] * blk + i;
      const T* b = vals + pair_j[k] * blk + j;
      for (int r = 0; r < bm; ++r) s += a[r * bn] * b[r * bn];
    }
    dst[idx] = s;
  }
}

template <typename T>
__global__ void matvec_kernel(const T* __restrict__ vals, int bm, int bn,
                              const int* __restrict__ indptr,
                              const int* __restrict__ indices,
                              const T* __restrict__ v, int nmeas,
                              T* __restrict__ out) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= nmeas) return;
  const int row = t / bm, i = t - row * bm;
  const size_t blk = static_cast<size_t>(bm) * bn;
  T s = T(0);
  for (int b = indptr[row]; b < indptr[row + 1]; ++b) {
    const T* a = vals + b * blk + static_cast<size_t>(i) * bn;
    const T* x = v + static_cast<size_t>(indices[b]) * bn;
    for (int j = 0; j < bn; ++j) s += a[j] * x[j];
  }
  out[t] = s;
}

// K3 for (8, 8) blocks: lane w of a group of 64 / V lanes holds word w of
// the group's output block, row w / (8 / V), V columns from (w % (8 / V)) V.
template <typename T>
__global__ void __launch_bounds__(JTJ_THREADS)
jtj_words_kernel(const T* __restrict__ vals, const int* __restrict__ pair_i,
                 const int* __restrict__ pair_j,
                 const int* __restrict__ run_ptr, int nout, size_t vstride,
                 size_t ostride, T* __restrict__ out) {
  constexpr int V = Word<T>::N;
  constexpr int BLK = 64;        // entries of a block
  constexpr int LPG = BLK / V;   // lanes of a group: 16 or 32
  constexpr int GPB = JTJ_THREADS / LPG;
  constexpr int CL = 8 / V;      // lanes along a row of the block
  static_assert(JTJ_CHUNK <= LPG, "one lane per pair of a chunk");
  __shared__ __align__(16) T staged[GPB][2 * JTJ_CHUNK][BLK];
  const int g = threadIdx.x / LPG, w = threadIdx.x % LPG;
  const int o = blockIdx.x * GPB + g;
  if (o >= nout) return;  // whole groups only
  // the group's lanes of its warp
  const unsigned mask =
      LPG == 32 ? 0xffffffffu : 0xffffu << (threadIdx.x & 16);
  const int i = w / CL, j = (w % CL) * V;  // the lane's output entries
  T (*buf)[BLK] = staged[g];
  vals += blockIdx.y * vstride;
  out += blockIdx.y * ostride;
  const int k0 = __ldg(run_ptr + o), k1 = __ldg(run_ptr + o + 1);
  T acc[V];
#pragma unroll
  for (int u = 0; u < V; ++u) acc[u] = T(0);
  for (int kc = k0; kc < k1; kc += JTJ_CHUNK) {
    const int m = min(JTJ_CHUNK, k1 - kc);
    int pi = 0, pj = 0;
    if (w < m) pi = __ldg(pair_i + kc + w), pj = __ldg(pair_j + kc + w);
#pragma unroll
    for (int p = 0; p < JTJ_CHUNK; ++p) {
      if (p >= m) break;
      const int bi = __shfl_sync(mask, pi, p, LPG);
      const int bj = __shfl_sync(mask, pj, p, LPG);
      __pipeline_memcpy_async(&buf[2 * p][w * V],
                              vals + static_cast<size_t>(bi) * BLK + w * V,
                              16);
      __pipeline_memcpy_async(&buf[2 * p + 1][w * V],
                              vals + static_cast<size_t>(bj) * BLK + w * V,
                              16);
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncwarp(mask);
    for (int p = 0; p < m; ++p) {
      const T* a = buf[2 * p];
      const T* b = buf[2 * p + 1];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const T ar = a[r * 8 + i];
        const Word<T> br = load_word(b + r * 8 + j);
#pragma unroll
        for (int u = 0; u < V; ++u) acc[u] += ar * br.v[u];
      }
    }
    __syncwarp(mask);  // the chunk's blocks are read before the next lands
  }
  Word<T> res;
#pragma unroll
  for (int u = 0; u < V; ++u) res.v[u] = acc[u];
  store_word(out + static_cast<size_t>(o) * BLK + w * V, res);
}

// The word kernel for (8, 8) blocks whose values are 16-byte aligned (the
// output, from torch.empty, always is), the generic one for everything else.
// A batch wider than the grid's y extent goes in several launches.
template <typename T>
static int launch_jtj(const void* vals_, int bm, int bn, const void* pair_i_,
                      const void* pair_j_, const void* run_ptr_, int nout,
                      int batch, int nnzb, void* out_, int device,
                      void* stream_) {
  if (nout <= 0 || batch <= 0) return 0;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const T* vals = static_cast<const T*>(vals_);
  const int* pair_i = static_cast<const int*>(pair_i_);
  const int* pair_j = static_cast<const int*>(pair_j_);
  const int* run_ptr = static_cast<const int*>(run_ptr_);
  T* out = static_cast<T*>(out_);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const size_t vstride = static_cast<size_t>(nnzb) * bm * bn;
  const size_t ostride = static_cast<size_t>(nout) * bn * bn;
  const bool words = bm == 8 && bn == 8 && aligned16(vals) && aligned16(out);
  constexpr int MAX_Y = 65535;
  for (int b0 = 0; b0 < batch; b0 += MAX_Y) {
    const unsigned ny = static_cast<unsigned>(min(MAX_Y, batch - b0));
    const T* v = vals + b0 * vstride;
    T* o = out + b0 * ostride;
    if (words) {
      constexpr int GPB = JTJ_THREADS / (64 / Word<T>::N);  // outputs a block
      const dim3 grid((nout + GPB - 1) / GPB, ny);
      jtj_words_kernel<T><<<grid, JTJ_THREADS, 0, stream>>>(
          v, pair_i, pair_j, run_ptr, nout, vstride, ostride, o);
    } else {
      int threads = ((bn * bn + 31) / 32) * 32;
      if (threads > 256) threads = 256;
      jtj_blocks_kernel<T><<<dim3(nout, ny), threads, 0, stream>>>(
          v, bm, bn, pair_i, pair_j, run_ptr, vstride, ostride, o);
    }
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

// K4 for blocks of BM rows of BN / V 16-byte words: lane w of a group of
// BM * BN / V lanes holds word w of each block of the group's block row.
template <typename T, int BM, int BN>
__global__ void __launch_bounds__(MV_THREADS)
matvec_words_kernel(const T* __restrict__ vals, const int* __restrict__ indptr,
                    const int* __restrict__ indices, const T* __restrict__ v,
                    int nbrow, T* __restrict__ out) {
  constexpr int V = Word<T>::N;
  constexpr int CL = BN / V;    // lanes along a row of the block
  constexpr int LPB = BM * CL;  // lanes per block row
  static_assert(BN % V == 0 && LPB <= 32 && (LPB & (LPB - 1)) == 0 &&
                MV_THREADS % LPB == 0, "block shape");
  const int row = (blockIdx.x * MV_THREADS + threadIdx.x) / LPB;
  const int lane = threadIdx.x % LPB;
  const int c = lane % CL;
  T s = T(0);
  if (row < nbrow) {
    const int b1 = __ldg(indptr + row + 1);
    for (int b = __ldg(indptr + row); b < b1; ++b) {
      const Word<T> a = load_word_readonly(
          vals + static_cast<size_t>(b) * (BM * BN) + lane * V);
      const Word<T> x = load_word_readonly(
          v + static_cast<size_t>(__ldg(indices + b)) * BN + c * V);
#pragma unroll
      for (int u = 0; u < V; ++u) s += a.v[u] * x.v[u];
    }
  }
  // every lane of the warp takes part; rows beyond the last hold zero
#pragma unroll
  for (int o = CL / 2; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (row < nbrow && c == 0) out[row * BM + lane / CL] = s;
}

// The 16-byte-word kernel for (8, 8) blocks whose operands are 16-byte
// aligned, the generic one for everything else.
template <typename T>
static int launch_matvec(const void* vals_, int bm, int bn,
                         const void* indptr_, const void* indices_,
                         const void* v_, int nmeas, void* out_, int device,
                         void* stream_) {
  if (nmeas <= 0) return 0;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const T* vals = static_cast<const T*>(vals_);
  const int* indptr = static_cast<const int*>(indptr_);
  const int* indices = static_cast<const int*>(indices_);
  const T* v = static_cast<const T*>(v_);
  T* out = static_cast<T*>(out_);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  if (bm == 8 && bn == 8 && aligned16(vals) && aligned16(v)) {
    constexpr int LPB = 8 * 8 / Word<T>::N;  // lanes per block row
    const int nbrow = nmeas / 8;
    const long long threads = static_cast<long long>(nbrow) * LPB;
    matvec_words_kernel<T, 8, 8>
        <<<static_cast<unsigned>((threads + MV_THREADS - 1) / MV_THREADS),
           MV_THREADS, 0, stream>>>(vals, indptr, indices, v, nbrow, out);
  } else {
    matvec_kernel<T><<<(nmeas + MV_THREADS - 1) / MV_THREADS, MV_THREADS, 0,
                       stream>>>(vals, bm, bn, indptr, indices, v, nmeas,
                                 out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry points. Integer arrays are int32. K3 takes `batch` Jacobians of
// nnzb blocks each, one after the other in vals, and writes `batch` outputs
// of nout blocks each. Launch on `stream` without
// synchronizing; return the cudaError_t of the launch (0 on success).
extern "C" int dogleg_bcsr_jtj_f32(const void* vals, int bm, int bn,
                                   const void* pair_i, const void* pair_j,
                                   const void* run_ptr, int nout, int batch,
                                   int nnzb, void* out, int device,
                                   void* stream) {
  return launch_jtj<float>(vals, bm, bn, pair_i, pair_j, run_ptr, nout, batch,
                           nnzb, out, device, stream);
}

extern "C" int dogleg_bcsr_jtj_f64(const void* vals, int bm, int bn,
                                   const void* pair_i, const void* pair_j,
                                   const void* run_ptr, int nout, int batch,
                                   int nnzb, void* out, int device,
                                   void* stream) {
  return launch_jtj<double>(vals, bm, bn, pair_i, pair_j, run_ptr, nout, batch,
                            nnzb, out, device, stream);
}

extern "C" int dogleg_bcsr_matvec_f32(const void* vals, int bm, int bn,
                                      const void* indptr, const void* indices,
                                      const void* v, int nmeas, void* out,
                                      int device, void* stream) {
  return launch_matvec<float>(vals, bm, bn, indptr, indices, v, nmeas, out,
                              device, stream);
}

extern "C" int dogleg_bcsr_matvec_f64(const void* vals, int bm, int bn,
                                      const void* indptr, const void* indices,
                                      const void* v, int nmeas, void* out,
                                      int device, void* stream) {
  return launch_matvec<double>(vals, bm, bn, indptr, indices, v, nmeas, out,
                               device, stream);
}
