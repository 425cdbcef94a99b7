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
// matrix is worked in place in the output, which stays in L2. Each stage:
//   1. the first warp holds the diagonal block's rows in registers and
//      factors it with shuffles (no barrier inside the 16 pivot steps);
//   2. every thread solves whole rows of the panel in registers against the
//      block (read by all threads at once, a broadcast), and writes the
//      solved panel back and, transposed, into a 16 x n staging buffer;
//   3. the rank-16 update runs over the 4x4 tiles of the trailing block's
//      lower triangle only, one tile per thread at a time, its operands two
//      16-byte loads per panel column from the staging buffer, 16
//      multiply-adds each.
// Products are plain float32 or float64 multiply-adds (nvcc contracts them
// into FMA): no tensor cores, never TF32. Built without --use_fast_math, so
// division and isfinite are IEEE.

#include "group.cuh"

namespace {

constexpr int PANEL = 16;
constexpr int DK_LD = PANEL + 1;          // row stride of the staged block
constexpr int DK_SIZE = PANEL * DK_LD;    // 272 elements, a multiple of 4
constexpr int MAX_N = 256;

// Four neighbouring elements, moved as 16-byte words.
template <typename T>
struct alignas(16) Quad {
  T v[4];
};

template <typename T>
__device__ __forceinline__ Quad<T> load4(const T* p) {
  return *reinterpret_cast<const Quad<T>*>(p);
}

template <typename T>
__device__ __forceinline__ void store4(T* p, const Quad<T>& q) {
  *reinterpret_cast<Quad<T>*>(p) = q;
}

// Stage step 1, by one full warp: factor the 16x16 block at `blk` (row
// stride ld) in place and stage it in Dk. Lane l and lane l + 16 both hold
// row l; only the first writes. Returns whether all 16 pivots were positive
// and finite (the same value on every lane).
template <typename T>
__device__ bool factor_diag(T* blk, int ld, T* Dk, int lane) {
  const int row = lane & (PANEL - 1);
  T* wrow = blk + static_cast<size_t>(row) * ld;
  T r[PANEL];
#pragma unroll
  for (int c = 0; c < PANEL; c += 4) {
    const Quad<T> q = load4(wrow + c);
#pragma unroll
    for (int x = 0; x < 4; ++x) r[c + x] = q.v[x];
  }
  bool good = true;
#pragma unroll
  for (int j = 0; j < PANEL; ++j) {
    const T d = __shfl_sync(0xffffffffu, r[j], j);
    const T inv = rsqrt_(d);
    good = good && d > T(0) && isfinite(d);
    // column j of L; zero above the diagonal
    r[j] = row > j ? r[j] * inv : (row == j ? d * inv : T(0));
#pragma unroll
    for (int c = j + 1; c < PANEL; ++c) {
      const T lcj = __shfl_sync(0xffffffffu, r[j], c);  // L[c][j]
      // rows below c: the Schur update; rows above: a symmetric value that
      // is zeroed when the pivot reaches column c
      r[c] -= r[j] * lcj;
    }
  }
  __syncwarp();
  if (lane < PANEL) {
#pragma unroll
    for (int c = 0; c < PANEL; c += 4) {
      Quad<T> q;
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        q.v[x] = r[c + x];
        Dk[row * DK_LD + c + x] = r[c + x];
      }
      store4(wrow + c, q);
    }
  }
  return good;
}

template <typename T, int G>
__global__ void __launch_bounds__(THREADS)
batchchol_kernel(const T* __restrict__ A, int k, int n, T* __restrict__ Lg,
                 int* __restrict__ ok_out, int in_smem) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int g = threadIdx.x / G, t = threadIdx.x % G;
  const size_t mat = static_cast<size_t>(blockIdx.x) * (THREADS / G) + g;
  if (mat >= static_cast<size_t>(k)) return;  // whole groups only

  const size_t nn = static_cast<size_t>(n) * n;
  const T* a = A + mat * nn;
  T* l = Lg + mat * nn;
  const int ld = in_smem ? n + 4 : n;
  const size_t per_group = static_cast<size_t>(PANEL) * n + DK_SIZE +
                           (in_smem ? static_cast<size_t>(n) * ld : 0);
  T* Pt = reinterpret_cast<T*>(smem_raw) + g * per_group;  // (16, n) panel^T
  T* Dk = Pt + PANEL * n;                                  // the factored block
  T* W = in_smem ? Dk + DK_SIZE : l;                       // the working copy

  const int nq = n / 4;
  for (int e = t; e < n * nq; e += G) {
    const int i = e / nq, c = (e % nq) * 4;
    store4(W + static_cast<size_t>(i) * ld + c,
           load4(a + static_cast<size_t>(i) * n + c));
  }
  Group<G>::sync();

  bool good = true;  // every pivot so far positive and finite (first warp)
  for (int j0 = 0; j0 < n; j0 += PANEL) {
    const int r0 = j0 + PANEL;  // first row and column of the trailing block
    if (t < 32)
      good = factor_diag(W + static_cast<size_t>(j0) * ld + j0, ld, Dk, t) &&
             good;
    Group<G>::sync();

    // the panel below the block: X Lkk^T = P, one row per thread
    for (int i = r0 + t; i < n; i += G) {
      T* wrow = W + static_cast<size_t>(i) * ld + j0;
      T x[PANEL];
#pragma unroll
      for (int c = 0; c < PANEL; c += 4) {
        const Quad<T> q = load4(wrow + c);
#pragma unroll
        for (int u = 0; u < 4; ++u) x[c + u] = q.v[u];
      }
#pragma unroll
      for (int j = 0; j < PANEL; ++j) {
        T s = x[j];
#pragma unroll
        for (int m = 0; m < j; ++m) s -= x[m] * Dk[j * DK_LD + m];
        x[j] = s / Dk[j * DK_LD + j];
      }
#pragma unroll
      for (int c = 0; c < PANEL; c += 4) {
        Quad<T> q;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          q.v[u] = x[c + u];
          Pt[(c + u) * n + (i - r0)] = x[c + u];
        }
        store4(wrow + c, q);
      }
    }
    Group<G>::sync();

    // the trailing block's lower triangle, in 4x4 tiles: W -= X X^T
    const int nt = (n - r0) / 4, ntiles = nt * (nt + 1) / 2;
    for (int q = t; q < ntiles; q += G) {
      int ti = static_cast<int>((sqrtf(8.0f * q + 1.0f) - 1.0f) * 0.5f);
      while (ti * (ti + 1) / 2 > q) --ti;
      while ((ti + 1) * (ti + 2) / 2 <= q) ++ti;
      const int tj = q - ti * (ti + 1) / 2;  // tj <= ti
      T acc[4][4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[u][v] = T(0);
#pragma unroll
      for (int m = 0; m < PANEL; ++m) {
        const Quad<T> pa = load4(Pt + m * n + 4 * ti);
        const Quad<T> pb = load4(Pt + m * n + 4 * tj);
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int v = 0; v < 4; ++v) acc[u][v] += pa.v[u] * pb.v[v];
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        T* w = W + static_cast<size_t>(r0 + 4 * ti + u) * ld + r0 + 4 * tj;
        Quad<T> wq = load4(w);
#pragma unroll
        for (int v = 0; v < 4; ++v) wq.v[v] -= acc[u][v];
        store4(w, wq);
      }
    }
    Group<G>::sync();
  }

  for (int e = t; e < n * nq; e += G) {
    const int i = e / nq, c = (e % nq) * 4;
    Quad<T> q = load4(W + static_cast<size_t>(i) * ld + c);
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (c + u > i) q.v[u] = T(0);
    store4(l + static_cast<size_t>(i) * n + c, q);
  }
  if (t == 0) ok_out[mat] = good;
}

template <typename T, int G>
int launch(const void* A, int k, int n, void* L, void* ok, int device,
           void* stream) {
  constexpr int MPB = THREADS / G;  // matrices per block
  const size_t staging = (static_cast<size_t>(PANEL) * n + DK_SIZE) * sizeof(T);
  size_t bytes = 0;
  int in_smem = 0;
  cudaError_t err = shared_bytes(
      batchchol_kernel<T, G>, device, MPB,
      staging + static_cast<size_t>(n) * (n + 4) * sizeof(T), staging, &bytes,
      &in_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  batchchol_kernel<T, G><<<(k + MPB - 1) / MPB, THREADS, bytes,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(A), k, n, static_cast<T*>(L),
      static_cast<int*>(ok), in_smem);
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
