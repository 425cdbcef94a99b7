// Kernel K2: Cholesky factor L of a (p, p) SPD diagonal panel and its
// inverse inv(L), for Hopper (sm_90a).
//
// Replaces the TPU kernel libdogleg_tpu/ops/pallas_panelchol.py::panel_factor
// (pallas_call at :157, kernel body _make_kernel at :90-136). Caller:
// libdogleg_tpu_torch/ops/largechol.py::large_cholesky, once per 256-wide
// diagonal block of the n > 256 dense factorization (32 launches at
// n = 8192, one panel each), which turns the rest of a panel step into two
// matrix products with inv(L).
//
// What it computes, per panel: L lower-triangular with zeros above the
// diagonal, X = inv(L), and ok = every pivot d2 positive and finite. The
// pivot rule is the TPU kernel's: d = sqrt(max(d2, tiny)) with tiny the
// float32 tiny value in both precisions (pallas_panelchol.py:49,58), so a
// failed pivot leaves ok = 0 and the escalating lambda retries. p is a
// multiple of 16 up to 256; a NaN entry makes ok false and hangs nothing (no
// loop depends on the data).
//
// What bounds it on this card. Not the bytes (three p x p matrices, 0.79 MB
// at p = 256 in float32, 0.24 us at 3.35 TB/s) and not the operations
// (2 p^3 / 3, 0.17 us at the float32 rate), but two chains of dependent
// steps: the p pivots of the factor, and the p / 16 row blocks of a
// triangular inverse. The large solve factors one matrix, so a launch has
// one panel and cannot hide either chain behind other panels.
//
// Design: two kernels on the same stream, one wrapper call.
//   1. panelchol_factor_kernel, one block per panel (512 threads in
//      float32, 256 in float64):
//      cholstage.cuh's blocked right-looking factorization (the first warp
//      factors each 16x16 diagonal block in registers with shuffles, no
//      barrier inside the 16 pivot steps; rows of the sub-panel solved in
//      registers; the rank-16 update on 4x4 register tiles), with K2's pivot
//      rule as the template parameter, the first warp factoring the next
//      diagonal block beside the other warps' update: 2 barriers a
//      sub-panel, 32 at p = 256, where a pivot loop across the block has
//      512. The working
//      copy sits in shared memory: whole rows where they fit (p <= 224 in
//      float32, p <= 144 in float64), else the packed lower triangle (every
//      p in float32, p <= 208 in float64), else it is L itself, in place,
//      which stays in L2.
//   2. panelchol_inverse_kernel, p / 16 blocks per panel: column c of
//      inv(L) solves L x = e_c and needs no other column, so block cb owns
//      columns [16 cb, 16 cb + 16) and starts at row 16 cb (X is
//      lower-triangular). It first inverts the 16x16 diagonal blocks it will
//      meet, all at once (16 threads a block, a thread a column), then goes
//      left-looking over 16-row blocks I with its slab of X in shared
//      memory: X[I, :] = inv(L_II) (E_I - L[I, <I] X[<I, :]). The product
//      is split eight ways along its sum, a warp a part, a thread two rows
//      and four columns of the 16x16 result, so that six 16-byte shared
//      loads feed 32 multiply-adds; the rows of L arrive through cp.async
//      one row block ahead. Three barriers a row block. Nothing of X is read back
//      from device memory.
//
// On an H100 (700 W) at p = 256, alone: the factor kernel 93 us in float32
// (217 us in float64), the inverse kernel 21 us (33 us); with the wrapper
// 0.12 ms a call (0.25 ms), where the one-block kernel before took 0.41 ms.
// Dense and mostly zero panels take the same time (cholstage.cuh's
// quotient). What holds it back in turn (artifacts/
// exp_torch_cholstage_variants.py has the split and the cycle counts): in
// the factor, a stage's chain on one SM (a panel row's 16 dependent
// divisions, then the next diagonal block's 16 pivots) and, in the early
// stages, the update's 4x4 tiles, which 16 warps feed from shared memory
// faster than it delivers; in the inverse, about 10000 cycles before the
// first row block (the diagonal blocks' loads and inverses) and 1900 a row
// block, half of it the product, which is a 16 x K x 16 one with little
// reuse: shared memory delivers its operands to the registers no faster.
//
// Numerics: built without --use_fast_math, so sqrt and division are IEEE and
// isfinite/isnan work. Products are plain float32 or float64 multiply-adds
// (nvcc contracts them into FMA), never TF32.

#include <cuda_pipeline.h>

#include "cholstage.cuh"

namespace {

constexpr int MAX_P = 256;  // largest panel

template <typename T>
__global__ void __launch_bounds__(lone_threads<T>, 1)
panelchol_factor_kernel(const T* __restrict__ W, int p, T* __restrict__ Lg,
                        bool* __restrict__ ok_out, int mode, int vec_in) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const size_t at = static_cast<size_t>(blockIdx.x) * p * p;
  bool finite;  // not part of K2's ok
  const bool good =
      blocked_cholesky<T, lone_threads<T>, ClampedSqrtPivot, LOOK_AHEAD>(
          W + at, p, Lg + at, reinterpret_cast<T*>(smem_raw), mode,
          vec_in != 0, true, threadIdx.x, &finite);
  if (threadIdx.x == 0) ok_out[blockIdx.x] = good;
}

constexpr int SLICES = 8;         // the inverse's product: parts of the sum
// The inverse: buffers for 16 rows of L, one being read and the others on
// their way. Four (three row blocks ahead) were measured and are no faster.
constexpr int AHEAD_ROWS = 2;
constexpr int PS_LD = PANEL + 4;  // row stride of a part's 16x16 partial sums

// Elements of shared memory of the inverse kernel: the slab of X, the
// buffers of 16 rows of L, the partial sums, the 16x16 right-hand side and
// the inverted diagonal blocks.
inline size_t inverse_elems(int p) {
  return static_cast<size_t>(p) * PANEL + AHEAD_ROWS * PANEL * (p + 4) +
         SLICES * PANEL * PS_LD + DK_SIZE +
         static_cast<size_t>(p / PANEL) * DK_SIZE;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
panelchol_inverse_kernel(const T* __restrict__ Lg, int p,
                         T* __restrict__ Xg) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  static_assert(THREADS == PANEL * PANEL && THREADS == 32 * SLICES,
                "a thread an entry of a 16x16 block; a warp a part");
  constexpr int V = Word<T>::N;
  const int t = threadIdx.x, r = t / PANEL, c = t % PANEL;
  const int c0 = blockIdx.y * PANEL;  // first column, and row, of the slab
  const int nb = (p - c0) / PANEL;    // row blocks the slab reaches
  const size_t base = static_cast<size_t>(blockIdx.x) * p * p;
  const T* L = Lg + base;
  T* X = Xg + base;
  const int lrld = p + 4;
  T* Ys = reinterpret_cast<T*>(smem_raw);  // (p - c0, 16): the slab of X
  T* Lr = Ys + p * PANEL;                  // AHEAD_ROWS buffers of (16, lrld)
  T* Ps = Lr + AHEAD_ROWS * PANEL * lrld;  // SLICES parts of (16, PS_LD)
  T* Ts = Ps + SLICES * PANEL * PS_LD;     // (16, DK_LD)
  T* Di = Ts + DK_SIZE;                    // nb blocks of (16, DK_LD)

  // rows of row block ib of L, columns c0 .. c0 + 16 ib, on their way into
  // buffer ib % AHEAD_ROWS, as the ib-th group of copies (an empty group
  // beyond the last row block keeps the count)
  // (16 threads a row, a 16-byte word each at a time)
  auto stage = [&](int ib) {
    const int nw = ib < nb ? ib * PANEL / V : 0;  // 16-byte words a row
    T* dst = Lr + (ib % AHEAD_ROWS * PANEL + r) * lrld;
    const T* src = L + static_cast<size_t>(c0 + ib * PANEL + r) * p + c0;
    for (int w = c; w < nw; w += PANEL)
      __pipeline_memcpy_async(dst + w * V, src + w * V, 16);
    __pipeline_commit();
  };
  for (int ib = 1; ib < AHEAD_ROWS - 1; ++ib) stage(ib);

  // the diagonal blocks the slab meets, inverted all at once: block r by
  // the 16 threads with that r, thread c its column c by forward
  // substitution in registers
  // (thread (r, c) fetches entry (r, c) of every block, all loads in flight)
  {
    T v[MAX_P / PANEL];
#pragma unroll
    for (int q = 0; q < MAX_P / PANEL; ++q) {
      const int d0 = c0 + q * PANEL;
      if (q < nb) v[q] = L[static_cast<size_t>(d0 + r) * p + d0 + c];
    }
#pragma unroll
    for (int q = 0; q < MAX_P / PANEL; ++q)
      if (q < nb) Di[q * DK_SIZE + r * DK_LD + c] = v[q];
  }
  __syncthreads();
  T x[PANEL];
  if (r < nb) {
    const T* D = Di + r * DK_SIZE;
#pragma unroll
    for (int i = 0; i < PANEL; ++i) {
      if (i < c) {
        x[i] = T(0);
      } else if (i == c) {
        x[i] = T(1) / D[i * DK_LD + i];
      } else {
        T s = T(0);
#pragma unroll
        for (int k = 0; k < i; ++k)
          if (k >= c) s += D[i * DK_LD + k] * x[k];
        x[i] = quotient(-s, D[i * DK_LD + i]);
      }
    }
  }
  __syncthreads();  // every block has been read
  if (r < nb) {
#pragma unroll
    for (int i = 0; i < PANEL; ++i) Di[r * DK_SIZE + i * DK_LD + c] = x[i];
  }
  __syncthreads();

  for (int ib = 0; ib < nb; ++ib) {
    const int kw = ib * PANEL;  // rows of the slab above this block
    stage(ib + AHEAD_ROWS - 1);  // into the buffer the last turn read
    const T* Dq = Di + ib * DK_SIZE;
    T out;
    if (ib == 0) {
      out = Dq[r * DK_LD + c];  // inv(L_II) E_I
    } else {
      // the rows of this block have landed (awaited at the end of the last
      // turn). T = -L[I, <I] X[<I, :]: a warp a part of the sum (every
      // eighth group of four terms), a thread two rows and four columns of
      // T, so that six 16-byte loads feed 32 multiply-adds
      const int part = t / 32, pr = t % 32 / 4, pc = t % 4 * 4;
      const T* lrow = Lr + (ib % AHEAD_ROWS * PANEL + pr) * lrld;
      Quad<T> lo = {}, hi = {};  // rows pr and pr + 8
      for (int k = 4 * part; k < kw; k += 4 * SLICES) {
        const Quad<T> llo = load4(lrow + k);
        const Quad<T> lhi = load4(lrow + PANEL / 2 * lrld + k);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const Quad<T> yq = load4(Ys + (k + i) * PANEL + pc);
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            lo.v[v] += llo.v[i] * yq.v[v];
            hi.v[v] += lhi.v[i] * yq.v[v];
          }
        }
      }
      store4(Ps + (part * PANEL + pr) * PS_LD + pc, lo);
      store4(Ps + (part * PANEL + pr + PANEL / 2) * PS_LD + pc, hi);
      __syncthreads();
      T sum = T(0);
#pragma unroll
      for (int q = 0; q < SLICES; ++q)
        sum += Ps[(q * PANEL + r) * PS_LD + c];
      Ts[r * DK_LD + c] = -sum;
      __syncthreads();
      out = T(0);
#pragma unroll
      for (int j = 0; j < PANEL; ++j)
        if (j <= r) out += Dq[r * DK_LD + j] * Ts[j * DK_LD + c];
    }
    Ys[(kw + r) * PANEL + c] = out;
    __pipeline_wait_prior(AHEAD_ROWS - 2);  // row block ib + 1 has landed
    __syncthreads();  // the slab's new rows, and the next rows of L
  }

  for (int row = r; row < p; row += THREADS / PANEL)
    X[static_cast<size_t>(row) * p + c0 + c] =
        row < c0 ? T(0) : Ys[(row - c0) * PANEL + c];
}

template <typename T>
int panelchol(const void* W, int B, int p, void* L, void* X, void* ok,
              int device, void* stream) {
  if (B <= 0) return 0;
  if (p <= 0 || p > MAX_P || p % PANEL || !aligned16(L))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  size_t bytes = 0;
  int mode = 0;
  err = chol_work_mode<T>(panelchol_factor_kernel<T>, device, 1, p, true,
                          &bytes, &mode);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t inv_bytes = inverse_elems(p) * sizeof(T);
  err = allow_shared(
      reinterpret_cast<const void*>(panelchol_inverse_kernel<T>), device,
      inv_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  panelchol_factor_kernel<T><<<B, lone_threads<T>, bytes, s>>>(
      static_cast<const T*>(W), p, static_cast<T*>(L), static_cast<bool*>(ok),
      mode, aligned16(W));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  panelchol_inverse_kernel<T><<<dim3(B, p / PANEL), THREADS, inv_bytes, s>>>(
      static_cast<const T*>(L), p, static_cast<T*>(X));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry points: W, L, X are (B, p, p) row-major, ok is (B,) bool, one
// byte each. Launch both kernels on `stream` without synchronizing; return
// the cudaError_t of the first launch that failed.
extern "C" int dogleg_panelchol_f32(const void* W, int B, int p, void* L,
                                    void* X, void* ok, int device,
                                    void* stream) {
  return panelchol<float>(W, B, p, L, X, ok, device, stream);
}

extern "C" int dogleg_panelchol_f64(const void* W, int B, int p, void* L,
                                    void* X, void* ok, int device,
                                    void* stream) {
  return panelchol<double>(W, B, p, L, X, ok, device, stream);
}
