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
// Design. K3: one thread block per output block, walking that block's
// contiguous run of the schedule (pairs sorted by output block, run offsets
// derived on the host from out_idx); each thread owns output entries (i, j)
// and sums over the run's pairs and the bm rows, so there are no atomics and
// the sum order is fixed. K4: one thread per output row; the bm threads of a
// block row walk that row's contiguous blocks in CSR order, so again there
// are no atomics. The TPU kernels kept each output tile in VMEM across the
// grid; here every output is a register sum written once.
//
// What bounds them on this card: memory. K3 reads every scheduled pair's two
// blocks (2 * bm * bn values per pair) and does bm * bn^2 multiply-adds per
// pair; K4 reads each stored block once. At the grid model's 8 x 8 blocks
// both are a few MB per call and launch-latency sized. Simple kernels, not
// tuned: the blocks are read straight from device memory (L1/L2), not staged.

#include <cstddef>
#include <cuda_runtime.h>

namespace {

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
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int threads = ((bn * bn + 31) / 32) * 32;
  if (threads > 256) threads = 256;
  jtj_blocks_kernel<T><<<nout, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(vals), bm, bn, static_cast<const int*>(pair_i),
      static_cast<const int*>(pair_j), static_cast<const int*>(run_ptr),
      static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
static int launch_matvec(const void* vals, int bm, int bn, const void* indptr,
                         const void* indices, const void* v, int nmeas,
                         void* out, int device, void* stream) {
  if (nmeas <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int THREADS = 128;
  matvec_kernel<T><<<(nmeas + THREADS - 1) / THREADS, THREADS, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(vals), bm, bn, static_cast<const int*>(indptr),
      static_cast<const int*>(indices), static_cast<const T*>(v), nmeas,
      static_cast<T*>(out));
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
