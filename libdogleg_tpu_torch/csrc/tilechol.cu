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
// right-looking by columns with the TPU kernel's pivot rule, L_jj = d *
// rsqrt(d) and L_ij = a_ij * rsqrt(d), unclamped, so a non-SPD tile leaves
// NaN or a non-positive diagonal; ok = every pivot d > 0 and finite and every
// entry of L finite. K7: x_j = (c_j - sum_{l<j} D_jl x_l) / D_jj for each row
// of C, D (k, n, n), C and X (k, m, n). The quotient is a true division. Any
// 1 <= n <= 256 and m >= 1, float32 and float64; NaN inputs flow through
// without hanging anything (no loop depends on the data), and since the rows
// of X are independent a NaN in C stays in its own row.
//
// K6's design. A group of threads works on one tile: one warp for n <= 32
// (eight tiles per 256-thread block), the whole block for n > 32. The working
// tile sits in shared memory with a padded row stride (n + 1) when the
// block's tiles fit in what a block may hold (227 KB on an H100: a 128x128
// tile is 66 KB in float32 and 132 KB in float64); otherwise, as for 256x256,
// it is worked on in place in the output in device memory, L2-resident. Each
// column step stages the scaled column in a shared vector, so the trailing
// update reads rows contiguously: two barriers per column. What bounds it:
// latency, a tile's n column steps are sequential.
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

#include "group.cuh"

namespace {

constexpr int MAX_N = 256;
constexpr int TS_THREADS = 128;  // K7, n > 32: threads of a block
constexpr int JB = 16;           // K7, n > 32: width of a column block
constexpr int ROW_THREADS = 64;  // K7, n <= 32: threads, and rows, of a block

template <typename T, int G>
__global__ void __launch_bounds__(THREADS)
tilechol_kernel(const T* __restrict__ A, int k, int n, T* __restrict__ Lg,
                int* __restrict__ ok_out, int in_smem) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int GX = Group<G>::GX, GY = G / GX;
  const int g = threadIdx.x / G, t = threadIdx.x % G;
  const int tx = t % GX, ty = t / GX;
  const size_t tile = static_cast<size_t>(blockIdx.x) * (THREADS / G) + g;
  if (tile >= static_cast<size_t>(k)) return;  // whole groups only

  const size_t nn = static_cast<size_t>(n) * n;
  const T* a = A + tile * nn;
  T* l = Lg + tile * nn;
  const int ld = in_smem ? n + 1 : n;
  T* col = reinterpret_cast<T*>(smem_raw) +
           g * ((in_smem ? static_cast<size_t>(n) * ld : 0) + n);
  T* W = in_smem ? col + n : l;  // the working tile, lower triangle

  for (int i = ty; i < n; i += GY)
    for (int c = tx; c < n; c += GX) {
      const T v = a[static_cast<size_t>(i) * n + c];
      if (in_smem) {
        if (c <= i) W[i * ld + c] = v;
      } else {
        l[static_cast<size_t>(i) * n + c] = c <= i ? v : T(0);
      }
    }
  Group<G>::sync();

  bool good = true;  // every pivot so far positive and finite
  for (int j = 0; j < n; ++j) {
    const T d = W[j * ld + j];
    const T inv = rsqrt_(d);
    good = good && d > T(0) && isfinite(d);
    // column j of L, staged; W is not written in this phase
    for (int i = j + t; i < n; i += G)
      col[i] = i == j ? d * inv : W[i * ld + j] * inv;
    Group<G>::sync();
    if (t == 0) W[j * ld + j] = col[j];
    for (int i = j + 1 + ty; i < n; i += GY) {
      const T ci = col[i];
      T* row = W + i * ld;
      if (tx == 0) row[j] = ci;
      for (int c = j + 1 + tx; c <= i; c += GX) row[c] -= ci * col[c];
    }
    Group<G>::sync();
  }

  bool fin = true;
  for (int i = ty; i < n; i += GY)
    for (int c = tx; c < n; c += GX) {
      const T v = c <= i ? W[i * ld + c] : T(0);
      fin = fin && isfinite(v);
      if (in_smem) l[static_cast<size_t>(i) * n + c] = v;
    }
  const bool all_fin = Group<G>::all(fin);
  if (t == 0) ok_out[tile] = good && all_fin;
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

template <typename T, int G>
int launch_chol(const void* A, int k, int n, void* L, void* ok, int device,
                void* stream) {
  constexpr int TPB = THREADS / G;
  size_t bytes = 0;
  int in_smem = 0;
  cudaError_t err = shared_bytes(
      tilechol_kernel<T, G>, device, TPB,
      (static_cast<size_t>(n) * (n + 1) + n) * sizeof(T), n * sizeof(T),
      &bytes, &in_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  tilechol_kernel<T, G><<<(k + TPB - 1) / TPB, THREADS, bytes,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(A), k, n, static_cast<T*>(L),
      static_cast<int*>(ok), in_smem);
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
  return n <= 32 ? launch_chol<T, 32>(A, k, n, L, ok, device, stream)
                 : launch_chol<T, THREADS>(A, k, n, L, ok, device, stream);
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

// C entry points. A, L are (k, n, n) row-major and ok is (k,) int32 (K6); D
// is (k, n, n), C and X (k, m, n) row-major (K7). Launch on `stream` without
// synchronizing; return the cudaError_t of the launch.
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
