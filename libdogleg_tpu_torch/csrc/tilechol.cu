// Kernels K6 and K7: the per-level tile ops of the block-sparse Cholesky, for
// Hopper (sm_90a).
//
// K6 replaces libdogleg_tpu/ops/pallas_chol.py::pallas_cholesky (pallas_call
// at :62, body _chol_kernel at :30-56, ok at :79-81): the Cholesky factor of
// each (n, n) SPD tile of a batch, the FACTOR op of every elimination level.
// K7 replaces pallas_chol.py::pallas_tri_solve_right (pallas_call at :113,
// body _tri_right_kernel at :85-106): X with X D^T = C for lower-triangular
// D, the SOLVE op. Caller: libdogleg_tpu_torch/sparse_cholesky.py::factorize
// through ops/tilechol.py, on 8x8 tiles (simplicial path, up to a few
// hundred FACTORs and a few thousand SOLVEs per level) and on 128x128 super
// tiles (supernodal path, a few dozen per level).
//
// What they compute. K6: L lower-triangular with zeros above the diagonal,
// with the TPU kernel's pivot rule, L_jj = d * rsqrt(d) and L_ij = a_ij *
// rsqrt(d), unclamped, so a non-SPD tile leaves NaN or a non-positive
// diagonal; ok = every pivot d > 0 and finite and every entry of L finite.
// K7: x_j = (c_j - sum_{l<j} D_jl x_l) / D_jj for each row of C, D (k, n, n),
// C and X (k, m, n). The quotient is a true division. Any 1 <= n <= 256 and
// m >= 1, float32 and float64; NaN inputs flow through without hanging
// anything (no loop depends on the data): a tile that is not SPD spoils its
// own L and no other, and since the rows of X are independent a NaN in C
// stays in its own row.
//
// What bounds K6 on this card. Not the bytes ((21, 128, 128) float32 moves
// 2.75 MB, 0.82 us at 3.35 TB/s) and not the operations (n^3 / 3 a tile,
// 0.2 us for that batch at the float32 rate), but the chain: the n pivots of
// a tile depend on one another, and a supernodal level has a few dozen tiles
// at most, one block each, so nothing hides a block's chain. The TPU
// kernel's loop over columns, carried over, paid two block-wide barriers a
// column and fed every multiply-add from shared memory (168 us at (21, 128,
// 128) float32 on an H100, 700 W, 1.4 us a column).
//
// K6's design, n > 32 (the supernodal super tiles): a block per tile (512
// threads in float32, 256 in float64) runs cholstage.cuh's blocked
// right-looking factorization in 16-wide panels, the one K5 and K2 run: the
// first warp factors the 16x16 diagonal block in registers with shuffles,
// every thread solves a row of the panel below in registers, and the
// trailing triangle takes its rank-16 update on 4x4 register tiles fed by
// 16-byte shared loads: two barriers a panel, 16 at n = 128 where the
// column loop had 256. A tile whose n is no
// multiple of 16 is padded in shared memory with an identity diagonal
// (exact), and rows that are not whole aligned 16-byte words are copied by
// elements. The working copy: whole rows in shared memory where they fit
// (n <= 224 in float32, n <= 144 in float64), else the packed lower triangle
// in shared memory (every n in float32, n <= 208 in float64), else in place
// in the output, which stays in L2; only whole panels work in place, so the
// wrapper pads such a tile first (dogleg_tilechol_in_shared tells it).
// The same block looks ahead: its first warp factors the next diagonal block
// beside the other warps' update. On an H100 (700 W), float32, alone: 26 us
// at (21, 128, 128), dense or mostly zero alike (the divisions go through
// cholstage.cuh's quotient), 79 us at (21, 256, 256); with its wrapper it is
// several times faster than torch.linalg.cholesky_ex there. What holds it
// back in turn: a stage's chain (the 16 dependent divisions of a panel row,
// about 2100 cycles, then a tile and the 16 pivots of the next diagonal
// block, about 3400) on a card of which 21 tiles use a sixth. A cluster of
// blocks per tile would divide only the update beyond the next diagonal
// block, a ninth of the time at n = 128
// (artifacts/exp_torch_cholstage_variants.py).
//
// K6's design, n <= 32 (the simplicial 8x8 tiles, hundreds to a launch): a
// warp per tile, eight tiles per block, right-looking by columns on a copy
// in shared memory; the kernel is a few microseconds and its wrapper's host
// work several times that.
//
// What bounds K7 on this card. Not the bytes ((68, 128, 128) float32 moves
// 11 MB, D's lower triangles, C and X, 3.3 us at 3.35 TB/s) and not the
// operations (m n^2 a tile, 2 us for that batch at the float32 rate), but
// the chain: column j of X needs every earlier column. A kernel that walks
// the n columns one by one pays a barrier pair a column and feeds every
// multiply-add from shared memory; with one block a tile, a level's few
// dozen super tiles leave half of the 132 SMs idle.
//
// K7's design, n > 32. The rows of X are independent, so a tile's m rows are
// split over blocks of 128 threads: grid = k x ceil(m / 32), several blocks
// resident per SM, and since a block holds 32 rows of X and two panels of D,
// not a tile, every n up to 256 fits in shared memory in either type. Each
// block goes left-looking over 16-wide column blocks J:
//   1. X[:, J] = C[:, J] - X[:, <J] D[J, <J]^T, a small matrix product on
//      2 x 2 register tiles fed by 16-byte loads along the common index, so
//      every value loaded serves two multiply-adds; rows J of D are read
//      from device memory by rows (contiguous, 16 bytes at a time) into one
//      of two shared panels with cp.async, the next block's panel during
//      this block's product;
//   2. the solve inside the block: one thread per row of X holds its 16
//      entries in registers and reads D_JJ as broadcasts, no barrier inside.
// Two barriers a column block, 16 for n = 128 where the column loop had 256.
// Rows are padded to a multiple of 16 columns in shared memory (zeros in C,
// the identity in D) with a stride of an odd number of 16-byte words, so
// 16-byte accesses of eight neighbouring rows fall on different banks. When
// n is not a multiple of a word or a pointer is not 16-byte aligned, the
// copies go element by element. What holds this design back in turn: the
// products wait for the in-block solves (16 dependent true divisions each)
// instead of overlapping them, and both are short dependent chains on few
// warps, bound by latency. Measured and not faster
// (artifacts/exp_torch_trisolve_variants.py): 16 or 64 rows per block, a
// 32-wide column block, and 4 x 4 register tiles in three geometries, each
// of which leaves a quarter of the threads to the product.
//
// K7's design, n <= 32 (the simplicial 8x8 tiles, thousands to a launch):
// one thread per row of X, k m threads in blocks of 64, the row in registers
// (padded to 8, 16 or 32 columns), the block's tiles of D once in shared
// memory; one barrier, after that load.
//
// No tensor cores: products are plain float32 or float64 multiply-adds (nvcc
// contracts them into FMA), never TF32. Built without --use_fast_math, so
// division and isfinite are IEEE.

#include <cuda_pipeline.h>

#include "cholstage.cuh"

namespace {

constexpr int MAX_N = 256;
constexpr int TS_THREADS = 128;  // K7, n > 32: threads of a block
constexpr int JB = 16;           // K7, n > 32: width of a column block
constexpr int ROW_THREADS = 64;  // K7, n <= 32: threads, and rows, of a block

// K6 for n <= 32: a warp per tile, eight tiles per block, right-looking by
// columns. The working tile sits in shared memory with a row stride of
// n + 1; each column step stages the scaled column in a shared vector, so
// the trailing update reads rows contiguously.
template <typename T>
__global__ void __launch_bounds__(THREADS)
tilechol_warp_kernel(const T* __restrict__ A, int k, int n,
                     T* __restrict__ Lg, bool* __restrict__ ok_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int GX = 8, GY = 4;  // lanes along a row, along the column
  const int g = threadIdx.x / 32, t = threadIdx.x % 32;
  const int tx = t % GX, ty = t / GX;
  const size_t tile = static_cast<size_t>(blockIdx.x) * (THREADS / 32) + g;
  if (tile >= static_cast<size_t>(k)) return;  // whole warps only

  const size_t nn = static_cast<size_t>(n) * n;
  const T* a = A + tile * nn;
  T* l = Lg + tile * nn;
  const int ld = n + 1;
  T* col = reinterpret_cast<T*>(smem_raw) + g * (n * ld + n);
  T* W = col + n;  // the working tile, lower triangle

  for (int i = ty; i < n; i += GY)
    for (int c = tx; c <= i; c += GX) W[i * ld + c] = a[i * n + c];
  __syncwarp();

  bool good = true;  // every pivot so far positive and finite
  for (int j = 0; j < n; ++j) {
    const T d = W[j * ld + j];
    const T inv = rsqrt_(d);
    good = good && d > T(0) && isfinite(d);
    // column j of L, staged; W is not written in this phase
    for (int i = j + t; i < n; i += 32)
      col[i] = i == j ? d * inv : W[i * ld + j] * inv;
    __syncwarp();
    if (t == 0) W[j * ld + j] = col[j];
    for (int i = j + 1 + ty; i < n; i += GY) {
      const T ci = col[i];
      T* row = W + i * ld;
      if (tx == 0) row[j] = ci;
      for (int c = j + 1 + tx; c <= i; c += GX) row[c] -= ci * col[c];
    }
    __syncwarp();
  }

  bool fin = true;
  for (int i = ty; i < n; i += GY)
    for (int c = tx; c < n; c += GX) {
      const T v = c <= i ? W[i * ld + c] : T(0);
      fin = fin && isfinite(v);
      l[i * n + c] = v;
    }
  const bool all_fin = __all_sync(0xffffffffu, fin);
  if (t == 0) ok_out[tile] = good && all_fin;
}

// K6 for n > 32: a block per tile, cholstage.cuh's blocked factorization
// with the unclamped pivot rule; see the note at the head of this file.
template <typename T>
__global__ void __launch_bounds__(lone_threads<T>, 1)
tilechol_blocked_kernel(const T* __restrict__ A, int n, T* __restrict__ Lg,
                        bool* __restrict__ ok_out, int mode, int vec_in,
                        int vec_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const size_t at = static_cast<size_t>(blockIdx.x) * n * n;
  bool fin;
  const bool good =
      blocked_cholesky<T, lone_threads<T>, RsqrtPivot, LOOK_AHEAD>(
          A + at, n, Lg + at, reinterpret_cast<T*>(smem_raw), mode,
          vec_in != 0, vec_out != 0, threadIdx.x, &fin);
  const bool all_fin = __syncthreads_and(fin) != 0;
  if (threadIdx.x == 0) ok_out[blockIdx.x] = good && all_fin;
}

// K7's staging: rows [row0, row0 + nrows) and columns [0, ncols) of a
// row-major matrix `src` with `vrows` rows of n elements go to shared `dst`
// (row stride ld) as asynchronous copies, 16 bytes at a time where `vec`
// says the rows are whole aligned words and one element at a time otherwise.
// What lies outside the matrix becomes `diag` where the row's index equals
// the column's and zero elsewhere. ncols is a multiple of a word.
template <typename T>
__device__ __forceinline__ void stage_rows(T* dst, int ld, const T* src,
                                           int n, int vrows, int row0,
                                           int nrows, int ncols, bool vec,
                                           T diag) {
  constexpr int V = Word<T>::N;
  const int nq = ncols / V;
  for (int e = threadIdx.x; e < nrows * nq; e += blockDim.x) {
    const int r = e / nq, c = (e - r * nq) * V;
    const int gr = row0 + r;
    T* d = dst + r * ld + c;
    const T* s = src + static_cast<size_t>(gr) * n + c;
    if (vec && gr < vrows && c < n) {  // n is a multiple of V here
      __pipeline_memcpy_async(d, s, 16);
      continue;
    }
#pragma unroll
    for (int u = 0; u < V; ++u) {
      if (gr < vrows && c + u < n)
        __pipeline_memcpy_async(d + u, s + u, sizeof(T));
      else
        d[u] = gr == c + u ? diag : T(0);
    }
  }
}

// K7 for n > 32: one block per (tile, RM rows of X). Left-looking over
// JB-wide column blocks; see the note at the head of this file.
template <typename T, int RM>
__global__ void __launch_bounds__(TS_THREADS)
trisolve_blocked_kernel(const T* __restrict__ D, const T* __restrict__ C,
                        int n, int m, T* __restrict__ X, int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int V = Word<T>::N;
  constexpr int TX = 8, TY = TS_THREADS / TX;  // threads along J, along rows
  constexpr int TR = RM / TY, TC = JB / TX;    // a thread's register tile
  static_assert(RM % TY == 0 && RM <= TS_THREADS && JB % TX == 0 &&
                JB % V == 0, "tile shapes");
  const int t = threadIdx.x, tx = t % TX, ty = t / TX;
  const int r0 = blockIdx.y * RM;
  const int npad = (n + JB - 1) / JB * JB;
  // a row stride of an odd number of words: eight neighbouring rows' words
  // fall on different banks
  const int ld = npad + V;
  const size_t tile = blockIdx.x;
  const T* d = D + tile * n * n;
  T* Xs = reinterpret_cast<T*>(smem_raw);  // (RM, ld): C, then X
  T* Ds = Xs + RM * ld;                    // two panels of JB rows of D

  stage_rows(Xs, ld, C + tile * m * n, n, m, r0, RM, npad, vec != 0, T(0));
  stage_rows(Ds, ld, d, n, n, 0, JB, JB, vec != 0, T(1));
  __pipeline_commit();

  int buf = 0;
  for (int j0 = 0; j0 < npad; j0 += JB, buf ^= 1) {
    const T* Dk = Ds + buf * JB * ld;  // rows J of D, columns 0 .. j0 + JB
    __pipeline_wait_prior(0);
    __syncthreads();  // the panel has landed; X[:, <J] is final
    if (j0 + JB < npad) {  // the next panel loads during this block's work
      stage_rows(Ds + (buf ^ 1) * JB * ld, ld, d, n, n, j0 + JB, JB,
                 j0 + 2 * JB, vec != 0, T(1));
      __pipeline_commit();
    }
    if (j0 > 0) {
      // X[:, J] = C[:, J] - X[:, <J] D[J, <J]^T on TR x TC register tiles;
      // rows ty + u TY and columns tx + w TX, so that a quarter warp reads
      // one word of X (a broadcast) and eight rows of D
      T acc[TR][TC];
#pragma unroll
      for (int u = 0; u < TR; ++u)
#pragma unroll
        for (int w = 0; w < TC; ++w) acc[u][w] = T(0);
      for (int l = 0; l < j0; l += V) {
        Word<T> xv[TR], dv[TC];
#pragma unroll
        for (int u = 0; u < TR; ++u)
          xv[u] = load_word(Xs + (ty + u * TY) * ld + l);
#pragma unroll
        for (int w = 0; w < TC; ++w)
          dv[w] = load_word(Dk + (tx + w * TX) * ld + l);
#pragma unroll
        for (int i = 0; i < V; ++i)
#pragma unroll
          for (int u = 0; u < TR; ++u)
#pragma unroll
            for (int w = 0; w < TC; ++w) acc[u][w] += xv[u].v[i] * dv[w].v[i];
      }
#pragma unroll
      for (int u = 0; u < TR; ++u)
#pragma unroll
        for (int w = 0; w < TC; ++w)
          Xs[(ty + u * TY) * ld + j0 + tx + w * TX] -= acc[u][w];
    }
    __syncthreads();
    if (t < RM) {
      // the solve inside the block: one thread per row of X, its JB
      // entries in registers, D_JJ read as broadcasts, no barrier
      T* xr = Xs + t * ld + j0;
      const T* Dj = Dk + j0;
      T x[JB];
#pragma unroll
      for (int c = 0; c < JB; c += V) {
        const Word<T> q = load_word(xr + c);
#pragma unroll
        for (int i = 0; i < V; ++i) x[c + i] = q.v[i];
      }
#pragma unroll
      for (int j = 0; j < JB; ++j) {
        T s = x[j];
#pragma unroll
        for (int l = 0; l < j; ++l) s -= x[l] * Dj[j * ld + l];
        x[j] = s / Dj[j * ld + j];
      }
#pragma unroll
      for (int c = 0; c < JB; c += V) {
        Word<T> q;
#pragma unroll
        for (int i = 0; i < V; ++i) q.v[i] = x[c + i];
        store_word(xr + c, q);
      }
    }
  }
  __syncthreads();

  T* x_out = X + tile * m * n;
  const int rows = min(RM, m - r0);
  if (vec) {
    const int nq = n / V;
    for (int e = t; e < rows * nq; e += TS_THREADS) {
      const int r = e / nq, c = (e - r * nq) * V;
      store_word(x_out + static_cast<size_t>(r0 + r) * n + c,
                 load_word(Xs + r * ld + c));
    }
  } else {
    for (int e = t; e < rows * n; e += TS_THREADS) {
      const int r = e / n, c = e - r * n;
      x_out[static_cast<size_t>(r0 + r) * n + c] = Xs[r * ld + c];
    }
  }
}

// K7 for n <= 32: one thread per row of X, the row in registers, padded to
// NP columns; the block's `tb` tiles of D in shared memory, their lower
// triangles padded to NP with the identity. One barrier, after D's load.
template <typename T, int NP>
__global__ void __launch_bounds__(ROW_THREADS)
trisolve_rows_kernel(const T* __restrict__ D, const T* __restrict__ C, int k,
                     int n, int m, int tb, T* __restrict__ X) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int DS = NP * NP + 1;  // neighbouring tiles on different banks
  T* Ds = reinterpret_cast<T*>(smem_raw);
  const int t = threadIdx.x;
  const int mm = min(m, ROW_THREADS);  // rows of one tile in this block
  const size_t tile0 = static_cast<size_t>(blockIdx.x) * tb;
  const int ntile = static_cast<int>(
      min(static_cast<size_t>(tb), static_cast<size_t>(k) - tile0));
  for (int e = t; e < ntile * NP * NP; e += ROW_THREADS) {
    const int q = e / (NP * NP), j = e / NP % NP, l = e % NP;
    if (l <= j)
      Ds[q * DS + j * NP + l] =
          j < n ? D[(tile0 + q) * n * n + j * n + l] : T(j == l);
  }
  __syncthreads();

  const int q = t / mm, r = blockIdx.y * mm + t % mm;
  if (q >= ntile || r >= m) return;
  const size_t row = ((tile0 + q) * m + r) * n;
  const T* Dq = Ds + q * DS;
  T x[NP];
#pragma unroll
  for (int c = 0; c < NP; ++c) x[c] = c < n ? C[row + c] : T(0);
#pragma unroll
  for (int j = 0; j < NP; ++j) {
    T s = x[j];
#pragma unroll
    for (int l = 0; l < j; ++l) s -= x[l] * Dq[j * NP + l];
    x[j] = s / Dq[j * NP + j];
  }
#pragma unroll
  for (int c = 0; c < NP; ++c)
    if (c < n) X[row + c] = x[c];
}

template <typename T>
int launch_chol_warp(const void* A, int k, int n, void* L, void* ok,
                     int device, void* stream) {
  constexpr int TPB = THREADS / 32;
  // at most 8 x (32 x 33 + 32) elements: 68 KB in float64
  const size_t bytes =
      TPB * (static_cast<size_t>(n) * (n + 1) + n) * sizeof(T);
  cudaError_t err = allow_shared(
      reinterpret_cast<const void*>(tilechol_warp_kernel<T>), device, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  tilechol_warp_kernel<T><<<(k + TPB - 1) / TPB, THREADS, bytes,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(A), k, n, static_cast<T*>(L),
      static_cast<bool*>(ok));
  return static_cast<int>(cudaGetLastError());
}

// Whether the blocked kernel's working copy of an n-wide tile, padded to a
// multiple of 16, fits in the shared memory a block may hold on `device`.
template <typename T>
cudaError_t blocked_in_shared(int n, int device, int* fits) {
  const int npad = (n + PANEL - 1) / PANEL * PANEL;
  int optin = 0;
  cudaError_t err = optin_shared(device, &optin);
  *fits = chol_work_elems(npad, PACKED) * sizeof(T) <=
          static_cast<size_t>(optin);
  return err;
}

template <typename T>
int launch_chol_blocked(const void* A, int k, int n, void* L, void* ok,
                        int device, void* stream) {
  const int npad = (n + PANEL - 1) / PANEL * PANEL;
  size_t bytes = 0;
  int mode = 0;
  cudaError_t err = chol_work_mode<T>(tilechol_blocked_kernel<T>, device, 1,
                                      npad, true, &bytes, &mode);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec_in = n % 4 == 0 && aligned16(A);
  const int vec_out = n % 4 == 0 && aligned16(L);
  // in place in L: whole panels and aligned rows only (the wrapper pads)
  if (mode == IN_PLACE && !(n == npad && vec_out))
    return static_cast<int>(cudaErrorInvalidValue);
  tilechol_blocked_kernel<T><<<k, lone_threads<T>, bytes,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(A), n, static_cast<T*>(L), static_cast<bool*>(ok),
      mode, vec_in, vec_out);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int RM>
int launch_trisolve_blocked(const void* D, const void* C, int k, int n, int m,
                            void* X, int device, void* stream) {
  constexpr int V = Word<T>::N;
  const int npad = (n + JB - 1) / JB * JB;
  const size_t bytes =
      static_cast<size_t>(RM + 2 * JB) * (npad + V) * sizeof(T);
  const int chunks = (m + RM - 1) / RM;
  if (chunks > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_shared(
      reinterpret_cast<const void*>(trisolve_blocked_kernel<T, RM>), device,
      bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec = n % V == 0 && aligned16(D) && aligned16(C) && aligned16(X);
  trisolve_blocked_kernel<T, RM><<<dim3(k, chunks), TS_THREADS, bytes,
                                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(D), static_cast<const T*>(C), n, m,
      static_cast<T*>(X), vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int NP>
int launch_trisolve_rows(const void* D, const void* C, int k, int n, int m,
                         void* X, void* stream) {
  const int mm = m < ROW_THREADS ? m : ROW_THREADS;
  const size_t per_tile = (NP * NP + 1) * sizeof(T);
  int tb = ROW_THREADS / mm;  // tiles to a block: a thread per row of X
  const int fit = static_cast<int>(32 * 1024 / per_tile);
  if (tb > fit) tb = fit;
  if (tb > k) tb = k;
  const int chunks = (m + mm - 1) / mm;
  if (chunks > 65535) return static_cast<int>(cudaErrorInvalidValue);
  trisolve_rows_kernel<T, NP><<<dim3((k + tb - 1) / tb, chunks), ROW_THREADS,
                                tb * per_tile,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(D), static_cast<const T*>(C), k, n, m, tb,
      static_cast<T*>(X));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int tilechol(const void* A, int k, int n, void* L, void* ok, int device,
             void* stream) {
  if (k <= 0) return 0;
  if (n <= 0 || n > MAX_N) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return n <= 32 ? launch_chol_warp<T>(A, k, n, L, ok, device, stream)
                 : launch_chol_blocked<T>(A, k, n, L, ok, device, stream);
}

template <typename T>
int trisolve(const void* D, const void* C, int k, int n, int m, void* X,
             int device, void* stream) {
  if (k <= 0) return 0;
  if (n <= 0 || n > MAX_N || m <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 8) return launch_trisolve_rows<T, 8>(D, C, k, n, m, X, stream);
  if (n <= 16) return launch_trisolve_rows<T, 16>(D, C, k, n, m, X, stream);
  if (n <= 32) return launch_trisolve_rows<T, 32>(D, C, k, n, m, X, stream);
  return launch_trisolve_blocked<T, 32>(D, C, k, n, m, X, device, stream);
}

}  // namespace

// C entry points. A, L are (k, n, n) row-major and ok is (k,) bool, one byte
// each (K6); D is (k, n, n), C and X (k, m, n) row-major (K7). Launch on
// `stream` without synchronizing; return the cudaError_t of the launch.
extern "C" int dogleg_tilechol_f32(const void* A, int k, int n, void* L,
                                   void* ok, int device, void* stream) {
  return tilechol<float>(A, k, n, L, ok, device, stream);
}

extern "C" int dogleg_tilechol_f64(const void* A, int k, int n, void* L,
                                   void* ok, int device, void* stream) {
  return tilechol<double>(A, k, n, L, ok, device, stream);
}

extern "C" int dogleg_trisolve_right_f32(const void* D, const void* C, int k,
                                         int n, int m, void* X, int device,
                                         void* stream) {
  return trisolve<float>(D, C, k, n, m, X, device, stream);
}

extern "C" int dogleg_trisolve_right_f64(const void* D, const void* C, int k,
                                         int n, int m, void* X, int device,
                                         void* stream) {
  return trisolve<double>(D, C, k, n, m, X, device, stream);
}

// Whether K6 works an n-wide tile of `elt_size`-byte elements in shared
// memory on `device` (1) or in place in its output (0), which it does only
// for n a multiple of 16; a negative value is minus a cudaError_t.
extern "C" int dogleg_tilechol_in_shared(int n, int elt_size, int device) {
  if (n <= 32) return 1;
  int fits = 0;
  const cudaError_t err = elt_size == 4
                              ? blocked_in_shared<float>(n, device, &fits)
                              : blocked_in_shared<double>(n, device, &fits);
  return err == cudaSuccess ? fits : -static_cast<int>(err);
}
