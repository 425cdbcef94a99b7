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
// K3's design: one thread block per output block, walking that block's
// contiguous run of the schedule (pairs sorted by output block, run offsets
// derived on the host from out_idx); each thread owns output entries (i, j)
// and sums over the run's pairs and the bm rows, so there are no atomics and
// the sum order is fixed. The TPU kernels kept each output tile in VMEM
// across the grid; here every output is a register sum written once. What
// bounds it: memory, it reads every scheduled pair's two blocks (2 bm bn
// values a pair) for bm bn^2 multiply-adds; the blocks are read straight
// from device memory (L1/L2), not staged. A simple kernel, not tuned.
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

#include "group.cuh"

namespace {

constexpr int MV_THREADS = 128;  // K4: threads of a block

template <typename T>
__global__ void jtj_blocks_kernel(const T* __restrict__ vals, int bm, int bn,
                                  const int* __restrict__ pair_i,
                                  const int* __restrict__ pair_j,
                                  const int* __restrict__ run_ptr,
                                  T* __restrict__ out) {
  const int o = blockIdx.x;
  const int k0 = run_ptr[o], k1 = run_ptr[o + 1];
  const size_t blk = static_cast<size_t>(bm) * bn;
  T* dst = out + static_cast<size_t>(o) * bn * bn;
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

template <typename T>
static int launch_jtj(const void* vals, int bm, int bn, const void* pair_i,
                      const void* pair_j, const void* run_ptr, int nout,
                      void* out, int device, void* stream) {
  if (nout <= 0) return 0;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int threads = ((bn * bn + 31) / 32) * 32;
  if (threads > 256) threads = 256;
  jtj_blocks_kernel<T><<<nout, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(vals), bm, bn, static_cast<const int*>(pair_i),
      static_cast<const int*>(pair_j), static_cast<const int*>(run_ptr),
      static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
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

// C entry points. Integer arrays are int32. Launch on `stream` without
// synchronizing; return the cudaError_t of the launch (0 on success).
extern "C" int dogleg_bcsr_jtj_f32(const void* vals, int bm, int bn,
                                   const void* pair_i, const void* pair_j,
                                   const void* run_ptr, int nout, void* out,
                                   int device, void* stream) {
  return launch_jtj<float>(vals, bm, bn, pair_i, pair_j, run_ptr, nout, out,
                           device, stream);
}

extern "C" int dogleg_bcsr_jtj_f64(const void* vals, int bm, int bn,
                                   const void* pair_i, const void* pair_j,
                                   const void* run_ptr, int nout, void* out,
                                   int device, void* stream) {
  return launch_jtj<double>(vals, bm, bn, pair_i, pair_j, run_ptr, nout, out,
                            device, stream);
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
