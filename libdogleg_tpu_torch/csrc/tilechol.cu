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
// of C, right-looking: once column j of X is final, it is subtracted from
// the later columns. The quotient is a true division. Any 1 <= n <= 256,
// float32 and float64; NaN inputs flow through without hanging anything (no
// loop depends on the data).
//
// Design. A group of threads works on one tile: one warp for n <= 32 (eight
// tiles per 256-thread block, as the simplicial 8x8 tiles come hundreds to a
// launch), the whole block for n > 32. The working tile sits in shared memory
// with a padded row stride (n + 1) when the block's tiles fit in what a block
// may hold (227 KB on an H100: a 128x128 tile is 66 KB in float32 and 132 KB
// in float64); otherwise, as for 256x256, it is worked on in place in the
// output in device memory, L2-resident. Each column step stages the scaled
// column (K6) or the column of D (K7, prefetched one step ahead) in a shared
// vector, so the trailing update reads rows contiguously: two barriers per
// column.
//
// What bounds them: latency. A tile's n column steps are sequential, each a
// barrier pair and a rank-1 update of the trailing part (n^3/6 multiply-adds
// for K6, m n^2/2 for K7 over the group's threads); the small tiles are one
// warp each and the level's tiles are spread over the SMs. No tensor cores:
// products are plain float32 or float64 multiply-adds (nvcc contracts them
// into FMA), never TF32. Built without --use_fast_math, so division and
// isfinite are IEEE.

#include <cstddef>
#include <cuda_runtime.h>

namespace {

constexpr int MAX_N = 256;
constexpr int THREADS = 256;

// A group of G threads works on one tile, GX of them along a row and
// G / GX along the column.
template <int G>
struct Group;

template <>
struct Group<32> {
  static constexpr int GX = 8;
  __device__ static void sync() { __syncwarp(); }
  __device__ static bool all(bool v) { return __all_sync(0xffffffffu, v); }
};

template <>
struct Group<THREADS> {
  static constexpr int GX = 32;
  __device__ static void sync() { __syncthreads(); }
  __device__ static bool all(bool v) { return __syncthreads_and(v) != 0; }
};

__device__ __forceinline__ float rsqrt_(float x) { return rsqrtf(x); }
__device__ __forceinline__ double rsqrt_(double x) { return rsqrt(x); }

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

template <typename T, int G>
__global__ void __launch_bounds__(THREADS)
trisolve_kernel(const T* __restrict__ D, const T* __restrict__ C, int k,
                int n, int m, T* __restrict__ X, int in_smem) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int GX = Group<G>::GX, GY = G / GX;
  const int g = threadIdx.x / G, t = threadIdx.x % G;
  const int tx = t % GX, ty = t / GX;
  const size_t tile = static_cast<size_t>(blockIdx.x) * (THREADS / G) + g;
  if (tile >= static_cast<size_t>(k)) return;  // whole groups only

  const size_t mn = static_cast<size_t>(m) * n;
  const T* d = D + tile * static_cast<size_t>(n) * n;
  const T* c_in = C + tile * mn;
  T* x = X + tile * mn;
  const size_t ld = in_smem ? n + 1 : n;
  T* dbuf = reinterpret_cast<T*>(smem_raw) +
            g * ((in_smem ? m * ld : 0) + 2 * static_cast<size_t>(n));
  T* W = in_smem ? dbuf + 2 * n : x;  // the working (m, n) tile

  for (int r = ty; r < m; r += GY)
    for (int c = tx; c < n; c += GX)
      W[r * ld + c] = c_in[static_cast<size_t>(r) * n + c];
  for (int i = t; i < n; i += G) dbuf[i] = d[static_cast<size_t>(i) * n];
  Group<G>::sync();

  for (int j = 0; j < n; ++j) {
    const T* dc = dbuf + (j & 1) * n;      // column j of D
    T* dn = dbuf + ((j + 1) & 1) * n;      // column j + 1, loaded meanwhile
    const T djj = dc[j];
    for (int r = t; r < m; r += G) W[r * ld + j] = W[r * ld + j] / djj;
    Group<G>::sync();
    for (int i = j + 1 + t; i < n; i += G)
      dn[i] = d[static_cast<size_t>(i) * n + j + 1];
    for (int r = ty; r < m; r += GY) {
      T* row = W + r * ld;
      const T xr = row[j];
      for (int c = j + 1 + tx; c < n; c += GX) row[c] -= xr * dc[c];
    }
    Group<G>::sync();
  }

  if (in_smem)
    for (int r = ty; r < m; r += GY)
      for (int c = tx; c < n; c += GX)
        x[static_cast<size_t>(r) * n + c] = W[r * ld + c];
}

// Dynamic shared memory: `per_tile` bytes for each of a block's tiles when
// they fit in what a block may hold (in_smem = 1), else `fallback` bytes each.
template <typename Kernel>
cudaError_t shared_bytes(Kernel kernel, int device, int tiles_per_block,
                         size_t per_tile, size_t fallback, size_t* bytes,
                         int* in_smem) {
  int optin = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  *in_smem = tiles_per_block * per_tile <= static_cast<size_t>(optin);
  *bytes = tiles_per_block * (*in_smem ? per_tile : fallback);
  if (*bytes > 48 * 1024)
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(*bytes));
  return cudaSuccess;
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

template <typename T, int G>
int launch_trisolve(const void* D, const void* C, int k, int n, int m,
                    void* X, int device, void* stream) {
  constexpr int TPB = THREADS / G;
  size_t bytes = 0;
  int in_smem = 0;
  cudaError_t err = shared_bytes(
      trisolve_kernel<T, G>, device, TPB,
      (static_cast<size_t>(m) * (n + 1) + 2 * n) * sizeof(T),
      2 * n * sizeof(T), &bytes, &in_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  trisolve_kernel<T, G><<<(k + TPB - 1) / TPB, THREADS, bytes,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(D), static_cast<const T*>(C), k, n, m,
      static_cast<T*>(X), in_smem);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int tilechol(const void* A, int k, int n, void* L, void* ok, int device,
             void* stream) {
  if (k <= 0) return 0;
  if (n <= 0 || n > MAX_N) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
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
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return n <= 32
             ? launch_trisolve<T, 32>(D, C, k, n, m, X, device, stream)
             : launch_trisolve<T, THREADS>(D, C, k, n, m, X, device, stream);
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
