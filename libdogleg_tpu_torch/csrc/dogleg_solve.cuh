// The whole dog-leg solve of kernel K1, for one problem of N states with any
// products functor: what libdogleg_tpu/ops/pallas_mega.py::_make_kernel
// (:183) computes for any Nstate <= 16 with the products traced into its
// body. csrc/mega.cu instantiates it at N = 6 with its two hand-written
// functors; the sources that parallel/mega_auto.py generates instantiate it
// at their own N with a functor generated from a traced products function.
//
// A products functor has the call form
//   void operator()(const T (&p)[N], Products<T, N>& out) const
// and fills norm2, Jt_x and the packed lower triangle of JtJ at p.
//
// dogleg_solve is the attempt loop of libdogleg_tpu_torch/solver.py: the
// Cauchy step cached per operating point, the Gauss-Newton step computed
// only when an attempt needs a fresh one (the lazy cache) under the
// permanent escalating lambda, step selection, rho and the trust-region
// update, criteria 1-4 and the attempt cap. Every comparison with a NaN is
// false (the NaN-rho rule, hazard F5), the pivot test needs isfinite, and
// "exceeds a threshold" is |v| > threshold (hazard F7), so nothing here may
// be built with --use_fast_math.
//
// Everything but the warp-level pieces (Group, lane_of) also compiles as
// host C++ (g++, -std=c++17): DOGLEG_DEVICE is __device__ __forceinline__
// under nvcc and inline elsewhere, so the CPU tests can run the very text
// that nvcc compiles.

#pragma once

#include <cfloat>
#include <cstddef>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define DOGLEG_DEVICE __device__ __forceinline__
#define DOGLEG_HOST_DEVICE __host__ __device__
#else
#include <cmath>
#define DOGLEG_DEVICE inline
#define DOGLEG_HOST_DEVICE
#endif

// Solver parameters; must match ops/mega.py::_MegaParams field for field.
struct DoglegMegaParams {
  double trustregion0;
  double trustregion_decrease_factor;
  double trustregion_decrease_threshold;
  double trustregion_increase_factor;
  double trustregion_increase_threshold;
  double Jt_x_threshold;
  double update_threshold;
  double trustregion_threshold;
  double lambda_initial;
  int max_iterations;
  int max_attempts;
  int lambda_max_tries;
};

namespace {

#ifndef __CUDACC__
using std::fabs;
using std::isfinite;
using std::sqrt;
#endif

// StopReason codes of libdogleg_tpu_torch/solver.py.
enum : int {
  RUNNING = 0,
  GRADIENT_CONVERGED = 1,
  SMALL_STEP = 2,
  SMALL_TRUSTREGION = 3,
  MAX_ITERATIONS = 4,
  STALLED = 5,
  FACTORIZATION_FAILED = 6,
};

// Index of element (i, j) of a packed lower triangle; symmetric access.
DOGLEG_HOST_DEVICE constexpr int pk(int i, int j) {
  return i >= j ? i * (i + 1) / 2 + j : j * (j + 1) / 2 + i;
}

#ifdef __CUDACC__
// The G lanes of one warp that share a problem: this lane's rank in the
// group and the group's lanes as a shuffle mask. Blocks are a multiple of
// 32 threads, so threadIdx.x locates the lane in its warp.
template <int G>
struct Group {
  static_assert(G >= 1 && G <= 32 && (G & (G - 1)) == 0,
                "a group is a power of two of lanes within a warp");
  unsigned mask;
  int rank;

  __device__ __forceinline__ explicit Group(int thread)
      : mask(G == 32 ? 0xffffffffu
                     : ((1u << G) - 1u) << ((thread & 31) & ~(G - 1))),
        rank(thread & (G - 1)) {}

  // v summed over the group by a xor butterfly. Lane r adds v(r ^ k) to
  // its own and lane r ^ k adds v(r) to its own; addition commutes, so
  // every lane ends with the same bits.
  template <typename T>
  __device__ __forceinline__ T sum(T v) const {
#pragma unroll
    for (int k = 1; k < G; k <<= 1) v += __shfl_xor_sync(mask, v, k);
    return v;
  }
};
#endif

// The problem this thread works on and whether it writes the results: the
// global thread's index over G; a lane past the batch takes problem B - 1
// again and writes nothing, so that its group still meets every shuffle.
struct Lane {
  int b;
  bool write;
};

#ifdef __CUDACC__
constexpr int MAX_THREADS = 128;  // threads per block at most

// Threads per block for groups of G lanes: 32 G, at most MAX_THREADS.
template <int G>
constexpr int threads_for() {
  return 32 * G < MAX_THREADS ? 32 * G : MAX_THREADS;
}

// Blocks of threads_for<G>() threads for B problems of G lanes each.
template <int G>
int blocks_for(int B) {
  const long long threads = static_cast<long long>(B) * G;
  return static_cast<int>((threads + threads_for<G>() - 1) / threads_for<G>());
}

template <int G>
__device__ __forceinline__ Lane lane_of(int B) {
  const long long q =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) / G;
  return {q < B ? static_cast<int>(q) : B - 1,
          q < B && (threadIdx.x & (G - 1)) == 0};
}
#endif

template <typename T, int N>
struct Products {
  static constexpr int NP = N * (N + 1) / 2;  // packed triangle's size
  T norm2;
  T jtx[N];
  T jtj[NP];  // packed lower triangle of the symmetric JtJ
};

// Where a solve writes its results: p, Jt_x (B, N), JtJ (B, N, N), and the
// (B,) norm2_x, trust region, lambda, step count, attempt count and reason.
template <typename T>
struct SolveOut {
  T* p;
  T* jtx;
  T* jtj;
  T* norm2;
  T* tr;
  T* lam;
  int* step_count;
  int* n_attempts;
  int* reason;
};

// A solve's nine outputs from their pointers, in SolveOut's order.
template <typename T>
SolveOut<T> solve_out(void* const* outs) {
  return {static_cast<T*>(outs[0]), static_cast<T*>(outs[1]),
          static_cast<T*>(outs[2]), static_cast<T*>(outs[3]),
          static_cast<T*>(outs[4]), static_cast<T*>(outs[5]),
          static_cast<int*>(outs[6]), static_cast<int*>(outs[7]),
          static_cast<int*>(outs[8])};
}

template <typename T, int N>
DOGLEG_DEVICE T dot(const T (&a)[N], const T (&b)[N]) {
  T s = T(0);
#pragma unroll
  for (int i = 0; i < N; ++i) s += a[i] * b[i];
  return s;
}

template <typename T, int N>
DOGLEG_DEVICE bool any_exceeds(const T (&v)[N], T threshold) {
  bool e = false;
#pragma unroll
  for (int i = 0; i < N; ++i) e = e || fabs(v[i]) > threshold;
  return e;
}

// v^T A v with A packed symmetric.
template <typename T, int N>
DOGLEG_DEVICE T quad_form(const T (&A)[N * (N + 1) / 2], const T (&v)[N]) {
  T q = T(0);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    T mv = T(0);
#pragma unroll
    for (int j = 0; j < N; ++j) mv += A[pk(i, j)] * v[j];
    q += v[i] * mv;
  }
  return q;
}

// Cholesky of A + lam*I into packed lower L. Returns whether every pivot was
// positive and finite. A failed pivot is clamped to the smallest normal
// float (as pallas_mega.py:67-76), so a failed factor stays finite unless
// the pivot was NaN.
template <typename T, int N>
DOGLEG_DEVICE bool cholesky(const T (&A)[N * (N + 1) / 2], T lam,
                            T (&L)[N * (N + 1) / 2]) {
  const T tiny = T(FLT_MIN);
  bool ok = true;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    T s = A[pk(j, j)] + lam;
#pragma unroll
    for (int k = 0; k < j; ++k) s -= L[pk(j, k)] * L[pk(j, k)];
    ok = ok && s > T(0) && isfinite(s);
    const T d = sqrt(s < tiny ? tiny : s);
    L[pk(j, j)] = d;
#pragma unroll
    for (int i = j + 1; i < N; ++i) {
      T t = A[pk(i, j)];
#pragma unroll
      for (int k = 0; k < j; ++k) t -= L[pk(i, k)] * L[pk(j, k)];
      L[pk(i, j)] = t / d;
    }
  }
  return ok;
}

// Solve (L L^T) z = g.
template <typename T, int N>
DOGLEG_DEVICE void cho_solve(const T (&L)[N * (N + 1) / 2], const T (&g)[N],
                             T (&z)[N]) {
  T y[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    T s = g[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s -= L[pk(i, k)] * y[k];
    y[i] = s / L[pk(i, i)];
  }
#pragma unroll
  for (int r = 0; r < N; ++r) {
    const int i = N - 1 - r;
    T s = y[i];
#pragma unroll
    for (int k = i + 1; k < N; ++k) s -= L[pk(k, i)] * z[k];
    z[i] = s / L[pk(i, i)];
  }
}

// The whole solve of problem b from p0[b], with the products `products`
// computes; writes row b of `out` where `write` holds. Every lane of a group
// runs it on the same bits, so the lanes take the same branches.
template <typename T, int N, typename ProductsFn>
DOGLEG_DEVICE void dogleg_solve(const ProductsFn& products,
                                const T* __restrict__ p0, int b, bool write,
                                const DoglegMegaParams& prm,
                                const SolveOut<T>& out) {
  constexpr int NP = Products<T, N>::NP;
  // Thresholds and factors in the working type, as the Python solvers
  // compare a tensor of that type with a Python float.
  const T jtx_thr = T(prm.Jt_x_threshold);
  const T upd_thr = T(prm.update_threshold);
  const T tr_thr = T(prm.trustregion_threshold);
  const T dec_f = T(prm.trustregion_decrease_factor);
  const T dec_t = T(prm.trustregion_decrease_threshold);
  const T inc_f = T(prm.trustregion_increase_factor);
  const T inc_t = T(prm.trustregion_increase_threshold);
  const T lam0 = T(prm.lambda_initial);

  T p[N];
#pragma unroll
  for (int a = 0; a < N; ++a) p[a] = p0[static_cast<size_t>(b) * N + a];
  Products<T, N> cur;
  products(p, cur);

  T tr = T(prm.trustregion0);
  T lam = T(0);
  int step_count = 0;
  int n_attempts = 0;
  int reason = any_exceeds(cur.jtx, jtx_thr) ? RUNNING : GRADIENT_CONVERGED;
  T cauchy[N], gn[N];
#pragma unroll
  for (int a = 0; a < N; ++a) cauchy[a] = gn[a] = T(0);
  T n2_cauchy = T(0), n2_gn = T(0);
  bool have_cauchy = false, have_gn = false;

  while (reason == RUNNING) {
    const T tr_sq = tr * tr;

    // Cauchy step, once per operating point.
    if (!have_cauchy) {
      const T n2_jtx = dot(cur.jtx, cur.jtx);
      const T k = -n2_jtx / quad_form<T, N>(cur.jtj, cur.jtx);
#pragma unroll
      for (int a = 0; a < N; ++a) cauchy[a] = k * cur.jtx[a];
      n2_cauchy = k * k * n2_jtx;
      have_cauchy = true;
    }
    const bool use_cauchy = n2_cauchy >= tr_sq;

    // Gauss-Newton step under the permanent escalating lambda, only when
    // the Cauchy step is interior and the cached GN step is stale.
    bool fac_ok = true;
    if (!use_cauchy && !have_gn) {
      T L[NP];
      bool ok = cholesky<T, N>(cur.jtj, lam, L);
      for (int t = 0; !ok && t < prm.lambda_max_tries; ++t) {
        lam = lam == T(0) ? lam0 : lam * T(10);
        ok = cholesky<T, N>(cur.jtj, lam, L);
      }
      T z[N];
      cho_solve<T, N>(L, cur.jtx, z);
#pragma unroll
      for (int a = 0; a < N; ++a) gn[a] = -z[a];
      n2_gn = dot(gn, gn);
      fac_ok = ok;
      have_gn = true;
    }

    // Step selection.
    const bool use_gn = !use_cauchy && n2_gn <= tr_sq;
    T step[N];
    if (use_cauchy) {
      const T s = tr / sqrt(n2_cauchy);
#pragma unroll
      for (int a = 0; a < N; ++a) step[a] = s * cauchy[a];
    } else if (use_gn) {
#pragma unroll
      for (int a = 0; a < N; ++a) step[a] = gn[a];
    } else {
      T d[N];
#pragma unroll
      for (int a = 0; a < N; ++a) d[a] = cauchy[a] - gn[a];
      const T l2 = dot(d, d);
      const T neg_c = dot(d, cauchy);
      T disc = neg_c * neg_c - l2 * (n2_cauchy - tr_sq);
      if (disc < T(0)) disc = T(0);  // a NaN stays NaN, like jnp.maximum
      const T k = (neg_c + sqrt(disc)) / l2;
#pragma unroll
      for (int a = 0; a < N; ++a) step[a] = cauchy[a] + k * (gn[a] - cauchy[a]);
    }
    const T expected =
        T(-2) * dot(cur.jtx, step) - quad_form<T, N>(cur.jtj, step);
    const bool small_step = !any_exceeds(step, upd_thr);
    ++n_attempts;
    const bool exhausted = n_attempts >= prm.max_attempts;
    if (!fac_ok) {
      reason = FACTORIZATION_FAILED;
      break;
    }
    if (small_step) {
      reason = SMALL_STEP;
      break;
    }

    // Trial point, rho and the trust-region update.
    T p_new[N];
#pragma unroll
    for (int a = 0; a < N; ++a) p_new[a] = p[a] + step[a];
    Products<T, N> trial;
    products(p_new, trial);
    const T rho = (cur.norm2 - trial.norm2) / expected;
    const bool edge = !use_gn;
    T tr_new = tr;  // a NaN rho fails both tests and keeps the radius
    if (rho < dec_t) {
      tr_new = (edge ? tr : sqrt(n2_gn)) * dec_f;
    } else if (edge && rho > inc_t) {
      tr_new = tr * inc_f;
    }
    tr = tr_new;
    if (rho > T(0)) {
#pragma unroll
      for (int a = 0; a < N; ++a) p[a] = p_new[a];
      cur = trial;
      have_cauchy = false;
      have_gn = false;
      ++step_count;
      if (!any_exceeds(cur.jtx, jtx_thr)) {
        reason = GRADIENT_CONVERGED;
      } else if (step_count >= prm.max_iterations) {
        reason = MAX_ITERATIONS;
      } else if (exhausted) {
        reason = STALLED;
      }
    } else if (tr_new < tr_thr) {
      reason = SMALL_TRUSTREGION;
    } else if (exhausted) {
      reason = STALLED;
    }
  }

  if (!write) return;
  const size_t row = static_cast<size_t>(b);
#pragma unroll
  for (int a = 0; a < N; ++a) {
    out.p[row * N + a] = p[a];
    out.jtx[row * N + a] = cur.jtx[a];
#pragma unroll
    for (int c = 0; c < N; ++c)
      out.jtj[row * N * N + a * N + c] = cur.jtj[pk(a, c)];
  }
  out.norm2[b] = cur.norm2;
  out.tr[b] = tr;
  out.lam[b] = lam;
  out.step_count[b] = step_count;
  out.n_attempts[b] = n_attempts;
  out.reason[b] = reason;
}

// One evaluation's products of problem b at p (B, N), written where `write`
// holds: norm2 (B,), Jt_x (B, N), JtJ (B, N, N), the lower triangle
// mirrored.
template <typename T, int N, typename ProductsFn>
DOGLEG_DEVICE void products_at(const ProductsFn& products,
                               const T* __restrict__ p, int b, bool write,
                               T* __restrict__ norm2, T* __restrict__ jtx,
                               T* __restrict__ jtj) {
  T q[N];
  const size_t row = static_cast<size_t>(b);
#pragma unroll
  for (int a = 0; a < N; ++a) q[a] = p[row * N + a];
  Products<T, N> r;
  products(q, r);
  if (!write) return;
  norm2[b] = r.norm2;
#pragma unroll
  for (int a = 0; a < N; ++a) {
    jtx[row * N + a] = r.jtx[a];
#pragma unroll
    for (int c = 0; c < N; ++c) jtj[row * N * N + a * N + c] = r.jtj[pk(a, c)];
  }
}

}  // namespace
