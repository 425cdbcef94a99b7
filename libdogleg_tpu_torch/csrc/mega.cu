// Whole-solve dog-leg kernel K1 for batches of the sample quadratic-surface
// problem (6 states, 100 measurements), for Hopper (sm_90a), in two
// instances: one per products function.
//
// Replaces the TPU kernel libdogleg_tpu/ops/pallas_mega.py::megakernel_optimize
// (pallas_call at :522, kernel body _make_kernel at :183-418), which traces
// the products function it is given into its body. The JAX package builds it
// with two, and so does this file:
//   - dogleg_mega_kernel: libdogleg_tpu/models/quadratic_surface.py::
//     products_minor, the products from the 100 measurements;
//   - dogleg_mega_factored_kernel: quadratic_surface.py::
//     factored_products_minor, the products from 14 sufficient statistics
//     and the Gram pair, in compensated double-working precision.
// Both run one solve, dogleg_solve (csrc/dogleg_solve.cuh, templated on the
// type, N and a products functor), here at N = 6; the functors that
// parallel/mega_auto.py generates from ordinary products functions run the
// same solve at their own N (csrc/dogleg_auto.cuh).
//
// What it computes, per problem: the products at the start point, then the
// dog-leg attempt loop of libdogleg_tpu_torch/solver.py -- the Cauchy step
// cached per operating point, the Gauss-Newton step under the permanent
// escalating lambda, step selection, rho and the trust-region update,
// criteria 1-4 and the attempt cap -- and the final p, Jt_x, JtJ, norm2_x,
// trust region, lambda, step count, attempt count and stop reason.
//
// Design. A group of G lanes of one warp per problem (G a power of two, set
// per instance below). Every lane of the group holds the problem's whole
// state in registers (products, cached steps, Cholesky factor: about 160
// values at n=6) and runs the step math redundantly; the lanes share only
// the products:
//   - general (G = 4): lane r of the group takes measurements r, r + G,
//     r + 2G, ... of the problem's row of the (B, 100) measurements, as the
//     caller holds them (a group reads one contiguous 400- or 800-byte row),
//     with the grid in shared memory, loaded once a block; the 28 partial
//     sums (norm2, Jt_x, JtJ's lower triangle) are combined by a xor
//     butterfly within the group;
//   - factored (G = 1): its 14 statistics are read per problem from their
//     own (B, 6) and (B,) arrays, once, into registers; the (6, 6) Gram pair
//     and its sum Ghi + Glo sit in shared memory, once a block. A build
//     with G > 1 has every lane of a group compute all of the products; no
//     such G was faster than G = 1 at every batch of the grid (PERF.md §6),
//     so a problem has one thread, 32 to a block.
// IEEE addition commutes, so after the butterfly every lane of a group holds
// the same bits, takes the same branches and never diverges from the others;
// only lane 0 writes the results. Each thread runs its own attempt loop and
// stops when its own problem is done, so a warp waits for the slowest of its
// 32 / G problems (one thread per problem made it wait for 32). Lanes past
// the batch compute problem B - 1 again and write nothing: no lane leaves
// before a shuffle, and every shuffle names its own group's lanes only,
// because the groups of a warp run different numbers of attempts. The lambda
// escalation is a plain bounded loop, the Gauss-Newton step and its
// factorization are computed only when the attempt needs a fresh one
// (solver.py's lazy cache; the Pallas kernel refactored every attempt), and
// the trial products run only when the attempt evaluates a trial point.
// Blocks are 32 G threads, at most 128, so that ceil(B G / threads) blocks
// cover the 132 SMs at B = 8192 for every G.
//
// What bounds it on this card (the grid of G in PERF.md §6): the dependent
// chain of the batch's slowest problem, its attempts times the latency of
// an attempt's step math (a Cholesky of 6, IEEE divisions and square roots,
// the same on every lane, not shortened by G) and products, and, as G and B
// grow, the schedulers' instruction throughput. The general products are
// 100 x 83 operations an evaluation on one lane; split over G lanes they
// cost 100 / G of that plus 28 log2 G shuffles and sums, which took 99 us to
// 54-58 us at B = 8192 and G = 4 on an H100 80GB HBM3 (700 W), while at
// B = 1024 no G goes below ~32 us: the slowest chain. The factored products
// are 626 operations, and the factored instance stays at 25-30 us at
// B = 1024 and ~35 us at B = 8192 for G = 1 and 2: the chain again (giving
// the lanes of a group the six rows of G c - h in turn shortened it no
// further).
// The 3.3 MB of f32 measurements stay in the 50 MB L2.
//
// Numerics: built without --use_fast_math. Every comparison with a NaN must
// be false (the NaN-rho rule of params.py and solver.py), and the pivot test
// needs isfinite. "Exceeds a threshold" is |v| > threshold, as in solver.py
// and the reference; the Pallas kernel's max-reduce differs from that only
// when a gradient or step holds a NaN. The factored products are exact
// transformations (hazard F2): nvcc contracts a*b + c into a fused
// multiply-add by default, which would break a two_sum or a split product.
// They are written with the __fadd_rn/__fmul_rn family, which is never
// contracted, in the twin's order operation for operation, and two_prod is
// p = a*b, e = fma(a, b, -p), exact without a split. The rest of the file
// keeps the default contraction.

#include "dogleg_solve.cuh"

// Lanes per problem of each instance, chosen by the grid measured on the
// H100 (PERF.md §6), and set here only: the wrappers read them through
// dogleg_mega_group. A build may set them with -D to time another choice,
// as artifacts/exp_torch_k1_parent.py does; the package's library is built
// with these.
#ifndef K1_GENERAL_GROUP
#define K1_GENERAL_GROUP 4
#endif
#ifndef K1_FACTORED_GROUP
#define K1_FACTORED_GROUP 1
#endif

namespace {

constexpr int N = 6;                // states
constexpr int M = 100;              // measurements
constexpr int NP = N * (N + 1) / 2; // packed symmetric / triangular size
constexpr int GENERAL_G = K1_GENERAL_GROUP;
constexpr int FACTORED_G = K1_FACTORED_GROUP;
constexpr int THREADS = 128;        // threads per block of the check kernels

// The general instance's products functor, the device function behind
// quadratic_surface.products: norm2(x), J^T x and J^T J of the model
// m(x, y; p) - meas over the grid (in shared memory), for one problem's
// row of measurements, its sums split over the group's lanes (the plain
// version of that order is ops/mega.py::grouped_products_reference).
template <typename T, int G>
struct SurfaceProducts {
  const T* __restrict__ meas;  // the problem's 100 measurements
  const T* sgx;
  const T* sgy;
  Group<G> group;

  __device__ __forceinline__ void operator()(const T (&p)[N],
                                             Products<T, N>& out) const {
    T n2 = T(0);
    T jtx[N];
    T jtj[NP];
#pragma unroll
    for (int a = 0; a < N; ++a) jtx[a] = T(0);
#pragma unroll
    for (int a = 0; a < NP; ++a) jtj[a] = T(0);
    const T p01 = p[0] * p[1];
    const T p12 = p[1] * p[2];
#pragma unroll 4
    for (int i = group.rank; i < M; i += G) {
      const T X = sgx[i];
      const T Y = sgy[i];
      const T x = p01 * X * X + p12 * Y * Y + p[2] * X * Y + p[3] * X +
                  p[4] * Y + p[5] - meas[i];
      const T J[N] = {p[1] * X * X, p[0] * X * X + p[2] * Y * Y,
                      p[1] * Y * Y + X * Y, X, Y, T(1)};
      n2 += x * x;
#pragma unroll
      for (int a = 0; a < N; ++a) {
        jtx[a] += J[a] * x;
#pragma unroll
        for (int c = 0; c <= a; ++c) jtj[pk(a, c)] += J[a] * J[c];
      }
    }
    out.norm2 = group.sum(n2);
#pragma unroll
    for (int a = 0; a < N; ++a) out.jtx[a] = group.sum(jtx[a]);
#pragma unroll
    for (int a = 0; a < NP; ++a) out.jtj[a] = group.sum(jtj[a]);
  }
};

// Arithmetic that nvcc never contracts into a fused multiply-add (F2).
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float fma_rn(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double fma_rn(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

// Knuth: s + e == a + b exactly, s = fl(a + b) (compensated.py::two_sum).
template <typename T>
__device__ __forceinline__ void two_sum(T a, T b, T& s, T& e) {
  s = add_rn(a, b);
  const T bb = sub_rn(s, a);
  e = add_rn(sub_rn(a, sub_rn(s, bb)), sub_rn(b, bb));
}

// p + e == a * b exactly, p = fl(a * b): the fused multiply-add rounds
// a * b - p once, and that difference is representable. The same (p, e) as
// compensated.py::two_prod's split form wherever e is not subnormal.
template <typename T>
__device__ __forceinline__ void two_prod(T a, T b, T& p, T& e) {
  p = mul_rn(a, b);
  e = fma_rn(a, b, -p);
}

// The device function behind quadratic_surface.factored_products_minor:
// the products from one problem's statistics (in registers) and the Gram
// pair G = Ghi + Glo (in shared memory, (6, 6) row-major; Gf = Ghi + Glo
// formed once), operation for operation in the twin's order. Every lane of
// a group computes all of them, so they need no shuffle.
template <typename T>
struct FactoredProducts {
  T hh[N], hl[N];  // h = basis^T meas as a pair
  T nh, nl;        // meas . meas as a pair
  const T* Ghi;
  const T* Glo;
  const T* Gf;

  // Column j of M = Gf T, row i.
  __device__ __forceinline__ T gt(int i, int j, const T (&p)[N]) const {
    switch (j) {
      case 0: return mul_rn(Gf[i * N], p[1]);
      case 1:
        return add_rn(mul_rn(Gf[i * N], p[0]), mul_rn(Gf[i * N + 1], p[2]));
      case 2: return add_rn(mul_rn(Gf[i * N + 1], p[1]), Gf[i * N + 2]);
      default: return Gf[i * N + j];
    }
  }

  // Row i of g = G c - h: the row of G c as a compensated pair by a
  // sequential two_sum cascade, then the pair minus (h_hi, h_lo), collapsed.
  __device__ __forceinline__ T g_row(int i, const T (&c)[N], T h_hi,
                                     T h_lo) const {
    T s, lo;
    two_prod(Ghi[i * N], c[0], s, lo);
    lo = add_rn(lo, mul_rn(Glo[i * N], c[0]));
#pragma unroll
    for (int j = 1; j < N; ++j) {
      T pj, pe, se;
      two_prod(Ghi[i * N + j], c[j], pj, pe);
      two_sum(s, pj, s, se);
      lo = add_rn(add_rn(add_rn(lo, pe), se), mul_rn(Glo[i * N + j], c[j]));
    }
    T d, e;
    two_sum(s, -h_hi, d, e);
    return add_rn(d, add_rn(sub_rn(lo, h_lo), e));
  }

  __device__ __forceinline__ void operator()(const T (&p)[N],
                                             Products<T, N>& out) const {
    const T c[N] = {mul_rn(p[0], p[1]), mul_rn(p[1], p[2]), p[2], p[3], p[4],
                    p[5]};
    T g[N];
#pragma unroll
    for (int i = 0; i < N; ++i) g[i] = g_row(i, c, hh[i], hl[i]);
    // Jt_x = T^T g
    out.jtx[0] = mul_rn(p[1], g[0]);
    out.jtx[1] = add_rn(mul_rn(p[0], g[0]), mul_rn(p[2], g[1]));
    out.jtx[2] = add_rn(mul_rn(p[1], g[1]), g[2]);
    out.jtx[3] = g[3];
    out.jtx[4] = g[4];
    out.jtx[5] = g[5];
    // JtJ = T^T M, its lower triangle (row a, column j <= a)
#pragma unroll
    for (int a = 0; a < N; ++a) {
#pragma unroll
      for (int j = 0; j <= a; ++j) {
        T v;
        if (a == 0) {
          v = mul_rn(p[1], gt(0, j, p));
        } else if (a == 1) {
          v = add_rn(mul_rn(p[0], gt(0, j, p)), mul_rn(p[2], gt(1, j, p)));
        } else if (a == 2) {
          v = add_rn(mul_rn(p[1], gt(1, j, p)), gt(2, j, p));
        } else {
          v = gt(a, j, p);
        }
        out.jtj[pk(a, j)] = v;
      }
    }
    // norm2 = c.g + ((m.m) - c.h), the second term compensated
    T cg = mul_rn(c[0], g[0]);
#pragma unroll
    for (int i = 1; i < N; ++i) cg = add_rn(cg, mul_rn(c[i], g[i]));
    T wh, wl;
    two_prod(c[0], hh[0], wh, wl);
    wl = add_rn(wl, mul_rn(c[0], hl[0]));
#pragma unroll
    for (int i = 1; i < N; ++i) {
      T pi, pe, se;
      two_prod(c[i], hh[i], pi, pe);
      two_sum(wh, pi, wh, se);
      wl = add_rn(add_rn(add_rn(wl, pe), se), mul_rn(c[i], hl[i]));
    }
    T uh, ue;
    two_sum(nh, -wh, uh, ue);
    const T n2 = add_rn(cg, add_rn(uh, add_rn(sub_rn(nl, wl), ue)));
    out.norm2 = n2 < T(0) ? T(0) : n2;  // a NaN stays NaN, like maximum
  }
};

// The grid into shared memory, once per block.
template <typename T>
__device__ __forceinline__ void load_grid(const T* __restrict__ gx,
                                          const T* __restrict__ gy, T* sgx,
                                          T* sgy) {
  for (int i = threadIdx.x; i < M; i += blockDim.x) {
    sgx[i] = gx[i];
    sgy[i] = gy[i];
  }
  __syncthreads();
}

template <typename T, int G>
__device__ __forceinline__ SurfaceProducts<T, G> surface_products_of(
    const T* __restrict__ meas, int b, const T* sgx, const T* sgy) {
  return {meas + static_cast<size_t>(b) * M, sgx, sgy, Group<G>(threadIdx.x)};
}

template <typename T, int G>
__global__ void __launch_bounds__(threads_for<G>()) dogleg_mega_kernel(
    const T* __restrict__ p0, const T* __restrict__ meas,
    const T* __restrict__ gx, const T* __restrict__ gy, int B,
    DoglegMegaParams prm, SolveOut<T> out) {
  __shared__ T sgx[M];
  __shared__ T sgy[M];
  load_grid(gx, gy, sgx, sgy);
  const Lane l = lane_of<G>(B);
  dogleg_solve<T, N>(surface_products_of<T, G>(meas, l.b, sgx, sgy), p0,
                     l.b, l.write, prm, out);
}

// The factored statistics of one problem, h_hi, h_lo (B, 6) and n2m_hi,
// n2m_lo (B,), each from its own array; the Gram pair from shared memory.
template <typename T>
struct Stats {
  const T* __restrict__ hh;
  const T* __restrict__ hl;
  const T* __restrict__ nh;
  const T* __restrict__ nl;
};

template <typename T>
__device__ __forceinline__ FactoredProducts<T> factored_products_of(
    const Stats<T>& st, int b, const T* sghi, const T* sglo, const T* sgf) {
  FactoredProducts<T> f{};
  const size_t row = static_cast<size_t>(b) * N;
#pragma unroll
  for (int a = 0; a < N; ++a) {
    f.hh[a] = st.hh[row + a];
    f.hl[a] = st.hl[row + a];
  }
  f.nh = st.nh[b];
  f.nl = st.nl[b];
  f.Ghi = sghi;
  f.Glo = sglo;
  f.Gf = sgf;
  return f;
}

// The Gram pair and its sum into shared memory, once per block.
template <typename T>
__device__ __forceinline__ void load_gram(const T* __restrict__ ghi,
                                          const T* __restrict__ glo, T* sghi,
                                          T* sglo, T* sgf) {
  for (int i = threadIdx.x; i < N * N; i += blockDim.x) {
    sghi[i] = ghi[i];
    sglo[i] = glo[i];
    sgf[i] = add_rn(ghi[i], glo[i]);
  }
  __syncthreads();
}

template <typename T, int G>
__global__ void __launch_bounds__(threads_for<G>())
    dogleg_mega_factored_kernel(const T* __restrict__ p0, Stats<T> st,
                                const T* __restrict__ ghi,
                                const T* __restrict__ glo, int B,
                                DoglegMegaParams prm, SolveOut<T> out) {
  __shared__ T sghi[N * N], sglo[N * N], sgf[N * N];
  load_gram(ghi, glo, sghi, sglo, sgf);
  const Lane l = lane_of<G>(B);
  dogleg_solve<T, N>(factored_products_of<T>(st, l.b, sghi, sglo, sgf), p0,
                     l.b, l.write, prm, out);
}

// Each instance's products alone at p (B, 6), for checking the device
// functions against their plain versions: norm2 (B,), Jt_x (B, 6), JtJ
// (B, 6, 6), the lower triangle mirrored.
template <typename T, int G>
__global__ void __launch_bounds__(threads_for<G>()) surface_products_kernel(
    const T* __restrict__ p, const T* __restrict__ meas,
    const T* __restrict__ gx, const T* __restrict__ gy, int B,
    T* __restrict__ norm2, T* __restrict__ jtx, T* __restrict__ jtj) {
  __shared__ T sgx[M];
  __shared__ T sgy[M];
  load_grid(gx, gy, sgx, sgy);
  const Lane l = lane_of<G>(B);
  products_at<T, N>(surface_products_of<T, G>(meas, l.b, sgx, sgy), p, l.b,
                    l.write, norm2, jtx, jtj);
}

template <typename T, int G>
__global__ void __launch_bounds__(threads_for<G>()) factored_products_kernel(
    const T* __restrict__ p, Stats<T> st, const T* __restrict__ ghi,
    const T* __restrict__ glo, int B, T* __restrict__ norm2,
    T* __restrict__ jtx, T* __restrict__ jtj) {
  __shared__ T sghi[N * N], sglo[N * N], sgf[N * N];
  load_gram(ghi, glo, sghi, sglo, sgf);
  const Lane l = lane_of<G>(B);
  products_at<T, N>(factored_products_of<T>(st, l.b, sghi, sglo, sgf), p,
                    l.b, l.write, norm2, jtx, jtj);
}

// two_prod and two_sum on n pairs, for checking their exactness.
template <typename T>
__global__ void error_free_kernel(const T* __restrict__ a,
                                  const T* __restrict__ b, int n,
                                  T* __restrict__ p, T* __restrict__ pe,
                                  T* __restrict__ s, T* __restrict__ se) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  two_prod(a[i], b[i], p[i], pe[i]);
  two_sum(a[i], b[i], s[i], se[i]);
}

template <typename T>
Stats<T> stats_of(const void* hh, const void* hl, const void* nh,
                  const void* nl) {
  return {static_cast<const T*>(hh), static_cast<const T*>(hl),
          static_cast<const T*>(nh), static_cast<const T*>(nl)};
}

cudaStream_t stream_of(void* stream) {
  return static_cast<cudaStream_t>(stream);
}

template <typename T>
int launch_general(const void* p0, const void* meas, const void* gx,
                   const void* gy, int B, const DoglegMegaParams* prm,
                   void* const* outs, int device, void* stream) {
  if (B <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int G = GENERAL_G;
  const int blocks = blocks_for<G>(B), threads = threads_for<G>();
  dogleg_mega_kernel<T, G><<<blocks, threads, 0, stream_of(stream)>>>(
          static_cast<const T*>(p0), static_cast<const T*>(meas),
          static_cast<const T*>(gx), static_cast<const T*>(gy), B, *prm,
          solve_out<T>(outs));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_factored(const void* p0, const void* hh, const void* hl,
                    const void* nh, const void* nl, const void* ghi,
                    const void* glo, int B, const DoglegMegaParams* prm,
                    void* const* outs, int device, void* stream) {
  if (B <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int G = FACTORED_G;
  const int blocks = blocks_for<G>(B), threads = threads_for<G>();
  dogleg_mega_factored_kernel<T, G><<<blocks, threads, 0, stream_of(stream)>>>(
          static_cast<const T*>(p0), stats_of<T>(hh, hl, nh, nl),
          static_cast<const T*>(ghi), static_cast<const T*>(glo), B, *prm,
          solve_out<T>(outs));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_surface_products(const void* p, const void* meas, const void* gx,
                            const void* gy, int B, void* norm2, void* jtx,
                            void* jtj, int device, void* stream) {
  if (B <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int G = GENERAL_G;
  const int blocks = blocks_for<G>(B), threads = threads_for<G>();
  surface_products_kernel<T, G><<<blocks, threads, 0, stream_of(stream)>>>(
          static_cast<const T*>(p), static_cast<const T*>(meas),
          static_cast<const T*>(gx), static_cast<const T*>(gy), B,
          static_cast<T*>(norm2), static_cast<T*>(jtx), static_cast<T*>(jtj));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_factored_products(const void* p, const void* hh, const void* hl,
                             const void* nh, const void* nl, const void* ghi,
                             const void* glo, int B, void* norm2, void* jtx,
                             void* jtj, int device, void* stream) {
  if (B <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int G = FACTORED_G;
  const int blocks = blocks_for<G>(B), threads = threads_for<G>();
  factored_products_kernel<T, G><<<blocks, threads, 0, stream_of(stream)>>>(
          static_cast<const T*>(p), stats_of<T>(hh, hl, nh, nl),
          static_cast<const T*>(ghi), static_cast<const T*>(glo), B,
          static_cast<T*>(norm2), static_cast<T*>(jtx), static_cast<T*>(jtj));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_error_free(const void* a, const void* b, int n, void* p, void* pe,
                      void* s, void* se, int device, void* stream) {
  if (n <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  error_free_kernel<T><<<(n + THREADS - 1) / THREADS, THREADS, 0,
                         stream_of(stream)>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), n,
      static_cast<T*>(p), static_cast<T*>(pe), static_cast<T*>(s),
      static_cast<T*>(se));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry points: launch on `stream` without synchronizing; return the
// cudaError_t of the launch (0 on success). The nine outputs of a solve are
// p, Jt_x, JtJ, norm2_x, trust region, lambda, step count, attempt count
// and reason.
#define DOGLEG_MEGA_ENTRIES(dt, T)                                            \
  extern "C" int dogleg_mega_##dt(                                            \
      const void* p0, const void* meas, const void* gx, const void* gy,      \
      int B, const DoglegMegaParams* prm, void* p, void* jtx, void* jtj,      \
      void* norm2, void* tr, void* lam, void* step_count, void* n_attempts,   \
      void* reason, int device, void* stream) {                               \
    void* const outs[] = {p,  jtx, jtj,        norm2,     tr,                 \
                          lam, step_count, n_attempts, reason};               \
    return launch_general<T>(p0, meas, gx, gy, B, prm, outs, device, stream); \
  }                                                                           \
  extern "C" int dogleg_mega_factored_##dt(                                   \
      const void* p0, const void* hh, const void* hl, const void* nh,        \
      const void* nl, const void* ghi, const void* glo, int B,                \
      const DoglegMegaParams* prm, void* p, void* jtx, void* jtj,             \
      void* norm2, void* tr, void* lam, void* step_count, void* n_attempts,   \
      void* reason, int device, void* stream) {                               \
    void* const outs[] = {p,  jtx, jtj,        norm2,     tr,                 \
                          lam, step_count, n_attempts, reason};               \
    return launch_factored<T>(p0, hh, hl, nh, nl, ghi, glo, B, prm, outs,     \
                              device, stream);                                \
  }                                                                           \
  extern "C" int dogleg_products_##dt(                                        \
      const void* p, const void* meas, const void* gx, const void* gy,       \
      int B, void* norm2, void* jtx, void* jtj, int device, void* stream) {   \
    return launch_surface_products<T>(p, meas, gx, gy, B, norm2, jtx, jtj,    \
                                      device, stream);                        \
  }                                                                           \
  extern "C" int dogleg_factored_products_##dt(                               \
      const void* p, const void* hh, const void* hl, const void* nh,         \
      const void* nl, const void* ghi, const void* glo, int B, void* norm2,   \
      void* jtx, void* jtj, int device, void* stream) {                       \
    return launch_factored_products<T>(p, hh, hl, nh, nl, ghi, glo, B, norm2, \
                                       jtx, jtj, device, stream);             \
  }                                                                           \
  extern "C" int dogleg_error_free_##dt(const void* a, const void* b, int n, \
                                        void* p, void* pe, void* s, void* se, \
                                        int device, void* stream) {           \
    return launch_error_free<T>(a, b, n, p, pe, s, se, device, stream);       \
  }
DOGLEG_MEGA_ENTRIES(f32, float)
DOGLEG_MEGA_ENTRIES(f64, double)
#undef DOGLEG_MEGA_ENTRIES

// Lanes per problem of the general (factored == 0) or the factored instance.
extern "C" int dogleg_mega_group(int factored) {
  return factored ? FACTORED_G : GENERAL_G;
}
