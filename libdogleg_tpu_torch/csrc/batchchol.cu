// Kernel K5: the batched blocked Cholesky of mid-size matrices, for Hopper
// (sm_90a).
//
// Replaces libdogleg_tpu/ops/pallas_blockchol.py::pallas_blocked_cholesky
// (pallas_call at :150, body _chol_kernel at :95, leaves _small_chol at :57
// and _fwd_solve_rows at :82). Caller: libdogleg_tpu_torch/ops/blockchol.py
// ::blocked_cholesky through ops/batchchol.py, behind
// BlockedDenseNewtonSolver for 17 <= Nstate <= 256: one factorization of
// the whole batch of damped JtJ per Gauss-Newton step of the masked batched
// solver ((512, 64, 64) and (256, 128, 128) float32 in the mid-size
// batched benchmark).
//
// What it computes: (L, ok) for a (B, n, n) batch, n a multiple of 16 up to
// 256. The right-looking blocked algorithm in 16-wide panels: per stage the
// 16x16 diagonal block is factored (pivot rule L_jj = d * rsqrt(d), L_ij =
// a_ij * rsqrt(d), unclamped), the panel below it is solved against the
// block (X Lkk^T = P, a true division by the diagonal), and the trailing
// block takes the rank-16 update W -= X X^T. L has zeros above the diagonal;
// ok[b] = every pivot of matrix b positive and finite. A matrix that is not
// SPD leaves NaN in its own L and nowhere else; no loop depends on the data.
//
// What bounds it. Counted once in and once out, (256, 128, 128) float32
// moves 33.6 MB (10 us at 3.35 TB/s) and does n^3/3 = 0.7 MFLOP a matrix
// (under 3 us for the batch at the float32 rate): the bytes bound it, and
// what holds a simple kernel back is the chain of n/16 dependent stages, each
// with a 16-step pivot recurrence that one warp walks alone.
//
// Design. One group of threads per matrix: the whole 256-thread block for
// n > 32 (hundreds of blocks over 132 SMs, two or more resident per SM, so
// one block's serial diagonal factor overlaps another's update), a warp for
// n <= 32 (eight matrices per block). The working copy sits in dynamic shared
// memory with a row stride of n + 4, which keeps every 4-element group
// 16-byte aligned and spreads the rows over the banks; where it does not fit
// in what a block may hold (n >= 240 in float32, n >= 176 in float64) the
// matrix is worked in place in the output, which stays in L2. The stage
// itself (the warp-factored diagonal block, the panel solved in registers,
// the rank-16 update on 4x4 register tiles) is cholstage.cuh's, which K6 and
// K2 build on too, here with the unclamped pivot rule.
// Products are plain float32 or float64 multiply-adds (nvcc contracts them
// into FMA): no tensor cores, never TF32. Built without --use_fast_math, so
// division and isfinite are IEEE.

#include "cholstage.cuh"

namespace {

constexpr int MAX_N = 256;

template <typename T, int G>
__global__ void __launch_bounds__(THREADS)
batchchol_kernel(const T* __restrict__ A, int k, int n, T* __restrict__ Lg,
                 int* __restrict__ ok_out, int mode) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int g = threadIdx.x / G, t = threadIdx.x % G;
  const size_t mat = static_cast<size_t>(blockIdx.x) * (THREADS / G) + g;
  if (mat >= static_cast<size_t>(k)) return;  // whole groups only

  const size_t nn = static_cast<size_t>(n) * n;
  T* work = reinterpret_cast<T*>(smem_raw) + g * chol_work_elems(n, mode);
  bool finite;  // not part of K5's ok
  const bool good = blocked_cholesky<T, G, RsqrtPivot, false>(
      A + mat * nn, n, Lg + mat * nn, work, mode, true, true, t, &finite);
  if (t == 0) ok_out[mat] = good;
}

template <typename T, int G>
int launch(const void* A, int k, int n, void* L, void* ok, int device,
           void* stream) {
  constexpr int MPB = THREADS / G;  // matrices per block
  size_t bytes = 0;
  int mode = 0;
  // whole rows in shared memory or in place: with hundreds of matrices to a
  // launch, several blocks to an SM count for more than a packed copy
  cudaError_t err = chol_work_mode<T>(batchchol_kernel<T, G>, device, MPB, n,
                                      false, &bytes, &mode);
  if (err != cudaSuccess) return static_cast<int>(err);
  batchchol_kernel<T, G><<<(k + MPB - 1) / MPB, THREADS, bytes,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(A), k, n, static_cast<T*>(L),
      static_cast<int*>(ok), mode);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int batchchol(const void* A, int k, int n, void* L, void* ok, int device,
              void* stream) {
  if (k <= 0) return 0;
  if (n < PANEL || n > MAX_N || n % PANEL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return n <= 32 ? launch<T, 32>(A, k, n, L, ok, device, stream)
                 : launch<T, THREADS>(A, k, n, L, ok, device, stream);
}

}  // namespace

// C entry points. A and L are (k, n, n) row-major, 16-byte aligned, n a
// multiple of 16 in 16..256; ok is (k,) int32. Launch on `stream` without
// synchronizing; return the cudaError_t of the launch.
extern "C" int dogleg_batchchol_f32(const void* A, int k, int n, void* L,
                                    void* ok, int device, void* stream) {
  return batchchol<float>(A, k, n, L, ok, device, stream);
}

extern "C" int dogleg_batchchol_f64(const void* A, int k, int n, void* L,
                                    void* ok, int device, void* stream) {
  return batchchol<double>(A, k, n, L, ok, device, stream);
}
