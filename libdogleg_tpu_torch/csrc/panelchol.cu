// Kernel K2: Cholesky factor L of a (p, p) SPD diagonal panel and its
// inverse inv(L), for Hopper (sm_90a).
//
// Replaces the TPU kernel libdogleg_tpu/ops/pallas_panelchol.py::panel_factor
// (pallas_call at :157, kernel body _make_kernel at :90-136). Caller:
// libdogleg_tpu_torch/ops/largechol.py::large_cholesky, once per 256-wide
// diagonal block of the n > 256 dense factorization.
//
// What it computes, per instance: L lower-triangular with zeros above the
// diagonal, X = inv(L), and ok = every pivot d2 positive and finite. The
// pivot rule is the TPU kernel's: d = sqrt(max(d2, tiny)) with tiny the
// float32 tiny value in both precisions (pallas_panelchol.py:49,58), so a
// failed pivot leaves ok = 0 and the escalating lambda retries.
//
// Design. One thread block of 256 threads per instance; p <= 256, p % 16 == 0.
// Phase 0 copies the lower triangle of W into L, which then serves as the
// working matrix in device memory (at most 512 KB per instance, resident in
// the 50 MB L2). Phase 1 is right-looking over 16-wide column panels: each
// thread holds one row of the panel (p - j0 rows by 16) in registers and the
// panel is factored column by column (pivot, scale, update of the panel's
// later columns), then written back and staged in shared memory, and the
// trailing lower triangle takes its rank-16 update in 64 x 64 tiles, each
// thread a 4 x 4 register tile reading the panel from shared memory. Phase 2 builds X row block by row block (forward
// substitution of L X = I): with the 16 rows of L staged in shared memory, the
// thread of column c forms T = -L[I, :r0] X[:r0, c] for the block's 16 rows in
// registers, then X[I, c] = inv(L_II) T, where the 16 threads of a warp invert
// the 16 x 16 diagonal block by substitution. The whole panel never sits in
// shared memory: the packed lower triangle of a 256-wide float64 panel is
// 257 KB, above the 227 KB a block can hold. Static shared memory per block:
// about 17.5 KB (float32), 35 KB (float64).
//
// What bounds it: it is latency-bound on a single SM. The large solve
// factors one matrix, so each launch is one block on 1 of 132 SMs, with two
// block-wide barriers per column of phase 1 (512 per 256-wide panel), eight
// warps to hide the latency of the L2-resident working matrix (hence the
// unrolled loads), and the p^3/2 multiply-adds of both phases on that one
// SM's floating-point units. On an H100 (700 W) it takes about 0.41 ms
// (float32) at p = 256; timed with each phase compiled out, the inverse
// (phase 2) is the largest part (about 40%), then the trailing update, then
// the column steps. Filling the card needs several instances per launch or a
// multi-block panel, which is later work.
//
// Numerics: built without --use_fast_math, so sqrt and division are IEEE and
// isfinite/isnan work. Products are plain float32 or float64 multiply-adds
// (nvcc contracts them into FMA), never TF32.

#include <cfloat>
#include <cstddef>
#include <cuda_runtime.h>

namespace {

constexpr int SUB = 16;             // column-panel width
constexpr int MAX_P = 256;          // largest panel
constexpr int LDP = MAX_P + 1;      // shared row stride (padding against bank conflicts)
constexpr int THREADS = 256;        // one thread per column in phase 2
constexpr int TILE = 64;            // trailing-update tile: 16 x 16 threads of 4 x 4

template <typename T>
__global__ void __launch_bounds__(THREADS)
panelchol_kernel(const T* __restrict__ W, int p, T* __restrict__ Lg,
                 T* __restrict__ Xg, int* __restrict__ ok_out) {
  // Phase 1: the column panel, column-major: buf[c * LDP + r], r the row
  // relative to j0. Phase 2: 16 rows of L, k-major: buf[k * SUB + r].
  __shared__ __align__(16) T buf[SUB * LDP];
  __shared__ T linv[SUB * SUB];
  __shared__ T scaled[SUB];   // phase 1: column c of the diagonal block
  __shared__ T piv;
  __shared__ int ok_sh;

  const int tid = threadIdx.x;
  const size_t base = static_cast<size_t>(blockIdx.x) * p * p;
  const T* A = W + base;
  T* L = Lg + base;
  T* X = Xg + base;
  const T tiny = T(FLT_MIN);

  // Phase 0: L = the lower triangle of W, one warp per row. The unrolled
  // loop keeps a row's loads in flight together (this kernel runs 8 warps
  // on one SM, too few to hide device-memory latency one load at a time).
  const int lane = tid % 32, warp = tid / 32;
  for (int i = warp; i < p; i += THREADS / 32) {
#pragma unroll
    for (int q = 0; q < MAX_P / 32; ++q) {
      const int j = lane + 32 * q;
      if (j < p) {
        const size_t at = static_cast<size_t>(i) * p + j;
        L[at] = j <= i ? A[at] : T(0);
      }
    }
  }
  if (tid == 0) ok_sh = 1;
  __syncthreads();

  // Phase 1: right-looking over 16-wide column panels.
  for (int j0 = 0; j0 < p; j0 += SUB) {
    const int m = p - j0;
    T* Lp = L + static_cast<size_t>(j0) * p + j0;  // L[j0:, j0:]
    // Factor the column panel; thread r owns row r of it in registers. At
    // column c, thread c publishes the pivot, the owners of rows c+1..15
    // publish their scaled entries of column c, and every row below takes
    // its update: two barriers and one division per thread per column.
    const int r = tid;
    T v[SUB];
#pragma unroll
    for (int c = 0; c < SUB; ++c)
      v[c] = r < m ? Lp[static_cast<size_t>(r) * p + c] : T(0);
#pragma unroll
    for (int c = 0; c < SUB; ++c) {
      if (r == c) piv = v[c];
      __syncthreads();
      const T d2 = piv;
      // max(d2, tiny) propagating NaN, as jnp.maximum does
      const T d = sqrt(isnan(d2) || d2 > tiny ? d2 : tiny);
      if (tid == 0 && !(d2 > T(0) && isfinite(d2))) ok_sh = 0;
      if (r == c) {
        v[c] = d;
      } else if (r > c && r < m) {
        v[c] /= d;
        if (r < SUB) scaled[r] = v[c];
      }
      __syncthreads();
      if (r > c && r < m) {
#pragma unroll
        for (int c2 = c + 1; c2 < SUB; ++c2)
          if (r >= c2) v[c2] -= v[c] * scaled[c2];
      }
    }
    if (r < m) {
#pragma unroll
      for (int c = 0; c < SUB; ++c) {
        Lp[static_cast<size_t>(r) * p + c] = v[c];
        buf[c * LDP + r] = v[c];
      }
    }
    __syncthreads();
    // Trailing update of the lower triangle of L[j0+16:, j0+16:].
    const int nt = (m - SUB + TILE - 1) / TILE;
    const int tx = tid % 16, ty = tid / 16;
    for (int ti = 0; ti < nt; ++ti) {
      for (int tj = 0; tj <= ti; ++tj) {
        const int ib = SUB + ti * TILE + ty, jb = SUB + tj * TILE + tx;
        // load the tile's entries first, so their latency overlaps the sums
        T acc[4][4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
#pragma unroll
          for (int l = 0; l < 4; ++l) {
            const int ri = ib + 16 * k, cj = jb + 16 * l;
            acc[k][l] = ri < m && cj <= ri ? Lp[static_cast<size_t>(ri) * p + cj] : T(0);
          }
        }
#pragma unroll
        for (int c = 0; c < SUB; ++c) {
          T a[4], b[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int ri = ib + 16 * k, cj = jb + 16 * k;
            a[k] = ri < m ? buf[c * LDP + ri] : T(0);
            b[k] = cj < m ? buf[c * LDP + cj] : T(0);
          }
#pragma unroll
          for (int k = 0; k < 4; ++k)
#pragma unroll
            for (int l = 0; l < 4; ++l) acc[k][l] -= a[k] * b[l];
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
#pragma unroll
          for (int l = 0; l < 4; ++l) {
            const int ri = ib + 16 * k, cj = jb + 16 * l;
            if (ri < m && cj <= ri) Lp[static_cast<size_t>(ri) * p + cj] = acc[k][l];
          }
        }
      }
    }
    __syncthreads();
  }

  // Phase 2: X = inv(L), one 16-row block at a time.
  const int c = tid;  // this thread's column
  for (int r0 = 0; r0 < p; r0 += SUB) {
    const int kw = r0 + SUB;  // columns of L the block's rows reach
    for (int r = warp; r < SUB; r += THREADS / 32) {
#pragma unroll
      for (int q = 0; q < MAX_P / 32; ++q) {
        const int k = lane + 32 * q;
        if (k < kw) buf[k * SUB + r] = L[static_cast<size_t>(r0 + r) * p + k];
      }
    }
    __syncthreads();
    if (tid < SUB) {
      // column t of inv(L_II) by forward substitution
      const int t = tid;
      T x[SUB];
#pragma unroll
      for (int r = 0; r < SUB; ++r) {
        if (r < t) {
          x[r] = T(0);
        } else if (r == t) {
          x[r] = T(1) / buf[(r0 + r) * SUB + r];
        } else {
          T s = T(0);
#pragma unroll
          for (int k = 0; k < r; ++k)
            if (k >= t) s += buf[(r0 + k) * SUB + r] * x[k];
          x[r] = -s / buf[(r0 + r) * SUB + r];
        }
      }
#pragma unroll
      for (int r = 0; r < SUB; ++r) linv[r * SUB + t] = x[r];
    }
    // T[r] = -sum_k L[r0 + r, k] X[k, c] over k < r0. X[k, c] is zero for
    // k < c, so the loop starts at the warp's first column: every lane of a
    // warp runs the same trip count.
    T acc[SUB] = {};
    if (c < r0) {
      // unrolled so that several rows of X are loaded at once
#pragma unroll 8
      for (int k = c & ~31; k < r0; ++k) {
        const T xk = X[static_cast<size_t>(k) * p + c];
#pragma unroll
        for (int r = 0; r < SUB; ++r) acc[r] += buf[k * SUB + r] * xk;
      }
    }
    __syncthreads();  // linv is ready
    if (c < p) {
      T out[SUB];
#pragma unroll
      for (int r = 0; r < SUB; ++r) {
        if (c < r0) {
          T s = T(0);
#pragma unroll
          for (int j = 0; j <= r; ++j) s -= linv[r * SUB + j] * acc[j];
          out[r] = s;
        } else if (c < kw) {
          out[r] = linv[r * SUB + (c - r0)];
        } else {
          out[r] = T(0);
        }
      }
#pragma unroll
      for (int r = 0; r < SUB; ++r) X[static_cast<size_t>(r0 + r) * p + c] = out[r];
    }
    __syncthreads();  // the next block reads these rows of X and reuses buf
  }
  if (tid == 0) ok_out[blockIdx.x] = ok_sh;
}

template <typename T>
static int launch(const void* W, int B, int p, void* L, void* X, void* ok,
                  int device, void* stream) {
  if (B <= 0) return 0;
  if (p <= 0 || p > MAX_P || p % SUB) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  panelchol_kernel<T><<<B, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(W), p, static_cast<T*>(L), static_cast<T*>(X),
      static_cast<int*>(ok));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry points: W, L, X are (B, p, p) row-major, ok is (B,) int32. Launch
// on `stream` without synchronizing; return the cudaError_t of the launch.
extern "C" int dogleg_panelchol_f32(const void* W, int B, int p, void* L,
                                    void* X, void* ok, int device,
                                    void* stream) {
  return launch<float>(W, B, p, L, X, ok, device, stream);
}

extern "C" int dogleg_panelchol_f64(const void* W, int B, int p, void* L,
                                    void* X, void* ok, int device,
                                    void* stream) {
  return launch<double>(W, B, p, L, X, ok, device, stream);
}
