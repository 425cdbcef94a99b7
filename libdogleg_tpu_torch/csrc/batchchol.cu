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
// with a 16-step pivot recurrence that one warp walks alone, behind a copy of
// the whole matrix in and before a copy of all of L out, which overlap
// nothing: every block of a launch is in the same phase at the same time.
//
// Design. One group of threads per matrix: the whole 256-thread block for
// n > 32 (hundreds of blocks over 132 SMs, two or more resident per SM, so
// one block's serial diagonal factor overlaps another's update), a warp for
// n <= 32 (eight matrices per block). For n > 32 the working copy sits in
// dynamic shared memory with a row stride of n + 4, which keeps every
// 4-element group 16-byte aligned and spreads the rows over the banks, and
// the kernel moves less and overlaps what it moves:
//   - only the lower triangle comes in, each row up to the end of its
//     diagonal block, by 16-byte asynchronous copies (cp.async): the stages
//     never read above the diagonal blocks;
//   - L goes out behind the stages: while warp 0 factors stage j's diagonal
//     block, the other warps, idle until then, write the column panel that
//     stage j - 1 finished and the zeros of its row block right of its
//     diagonal block, so after the last stage only the last diagonal block
//     is left to write.
// The stage itself (the warp-factored diagonal block, the panel solved in
// registers, the rank-16 update on 4x4 register tiles) is cholstage.cuh's,
// which K6 and K2 build on too, here with the unclamped pivot rule; every
// entry of L takes the same operations in the same order as in
// cholstage.cuh's blocked_cholesky, which K5 runs for n <= 32 (a warp a
// matrix) and, in place in the output (L2), where whole rows do not fit in
// what a block may hold (n >= 240 in float32, n >= 176 in float64).
// Measured and not kept (PERF.md §6; H100, 700 W): the lower triangle by
// one bulk copy (TMA) a row on a barrier a row block (no faster); each
// finished piece of L written from registers as its stage ends (scattered
// stores before every barrier, 3-8 us slower); the panel solved in lanes
// 16-31 of the warps that repeat the diagonal block's pivots (one chain a
// stage in place of two, 3-5 us slower: the division sits on the pivots'
// shuffle chain); row block 0 copied first, so that stage 0's diagonal
// factor overlaps the rest of the copy (0.3 us faster at n = 128, 0.1 us
// slower at n = 64). Writing L behind the stages saves 5 us at n = 128 and
// 2 us at n = 64 against writing all of it after the last stage.
// Products are plain float32 or float64 multiply-adds (nvcc contracts them
// into FMA): no tensor cores, never TF32. Built without --use_fast_math, so
// division and isfinite are IEEE.

#include <cuda_pipeline.h>

#include "cholstage.cuh"

namespace {

constexpr int MAX_N = 256;

// Row i of L at columns c..c+3, from row i of the working copy W, with
// zeros above the diagonal.
template <typename T>
__device__ __forceinline__ void put_quad(T* l, int n, const T* W, int ld,
                                         int i, int c) {
  Quad<T> q = load4(W + static_cast<size_t>(i) * ld + (c <= i ? c : 0));
#pragma unroll
  for (int u = 0; u < 4; ++u)
    if (c + u > i) q.v[u] = T(0);
  store4(l + static_cast<size_t>(i) * n + c, q);
}

// One (n, n) matrix, n a multiple of 16 in 48..MAX_N whose rows fit in
// shared memory, by a block of THREADS threads, as the file's head says.
// The result is blocked_cholesky's with the unclamped pivot rule, bit for
// bit.
template <typename T>
__global__ void __launch_bounds__(THREADS)
batchchol_streamed_kernel(const T* __restrict__ A, int n, T* __restrict__ Lg,
                          bool* __restrict__ ok_out) {
  constexpr int V = 16 / sizeof(T);  // elements of a 16-byte copy
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int t = threadIdx.x;
  const size_t nn = static_cast<size_t>(n) * n;
  const T* a = A + blockIdx.x * nn;
  T* l = Lg + blockIdx.x * nn;
  const int ld = n + 4, nw = n / V;
  T* Pt = reinterpret_cast<T*>(smem_raw);  // (16, n) panel^T
  T* Dk = Pt + PANEL * n;                  // the factored block
  T* W = Dk + DK_SIZE;                     // the working copy, stride n + 4

  // the lower triangle in, each row up to the end of its diagonal block, by
  // 16-byte asynchronous copies
  for (int e = t; e < n * nw; e += THREADS) {
    const int i = e / nw, c = (e % nw) * V;
    if (c < (i / PANEL + 1) * PANEL)
      __pipeline_memcpy_async(W + static_cast<size_t>(i) * ld + c,
                              a + static_cast<size_t>(i) * n + c, 16);
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();

  // beside each diagonal factor, by warps 1.. while warp 0 factors: the
  // column panel finished in the stage before written out, with the zeros
  // of its row block right of its diagonal block
  const auto behind = [&](int j0, int thread) {
    if (j0 == 0 || thread < 32) return;
    const int p0 = j0 - PANEL, rows = n - p0;
    const int zq = (n - j0) / 4;  // zero quads a row of the row block
    for (int e = thread - 32; e < rows * 4 + PANEL * zq; e += THREADS - 32) {
      if (e < rows * 4) {
        put_quad(l, n, W, ld, p0 + e / 4, p0 + (e % 4) * 4);
      } else {
        const int z = e - rows * 4;
        store4(l + static_cast<size_t>(p0 + z / zq) * n + j0 + (z % zq) * 4,
               Quad<T>{});
      }
    }
  };
  const bool good =
      chol_stages<T, THREADS, RsqrtPivot, false>(W, ld, n, Pt, Dk, t, behind);

  // the last diagonal block out
  for (int e = t; e < PANEL * 4; e += THREADS)
    put_quad(l, n, W, ld, n - PANEL + e / 4, n - PANEL + (e % 4) * 4);
  if (t == 0) ok_out[blockIdx.x] = good;
}

// The whole matrix in place in the output (too large for shared memory), or
// a warp's small matrix: cholstage.cuh's blocked_cholesky.
template <typename T, int G>
__global__ void __launch_bounds__(THREADS)
batchchol_kernel(const T* __restrict__ A, int k, int n, T* __restrict__ Lg,
                 bool* __restrict__ ok_out, int mode) {
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
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if constexpr (G == THREADS) {
    if (mode == STRIDED) {  // one matrix to a block, streamed
      const auto kernel = batchchol_streamed_kernel<T>;
      err = allow_shared(reinterpret_cast<const void*>(kernel), device,
                         bytes);
      if (err != cudaSuccess) return static_cast<int>(err);
      kernel<<<k, THREADS, bytes, s>>>(static_cast<const T*>(A), n,
                                      static_cast<T*>(L),
                                      static_cast<bool*>(ok));
      return static_cast<int>(cudaGetLastError());
    }
  }
  batchchol_kernel<T, G><<<(k + MPB - 1) / MPB, THREADS, bytes, s>>>(
      static_cast<const T*>(A), k, n, static_cast<T*>(L),
      static_cast<bool*>(ok), mode);
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
// multiple of 16 in 16..256; ok is (k,) bool, one byte each. Launch on
// `stream` without synchronizing; return the cudaError_t of the launch.
extern "C" int dogleg_batchchol_f32(const void* A, int k, int n, void* L,
                                    void* ok, int device, void* stream) {
  return batchchol<float>(A, k, n, L, ok, device, stream);
}

extern "C" int dogleg_batchchol_f64(const void* A, int k, int n, void* L,
                                    void* ok, int device, void* stream) {
  return batchchol<double>(A, k, n, L, ok, device, stream);
}
