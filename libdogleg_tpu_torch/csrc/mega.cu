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
// Both run one solve, dogleg_solve, templated on a products functor.
//
// What it computes, per problem: the products at the start point, then the
// dog-leg attempt loop of libdogleg_tpu_torch/solver.py -- the Cauchy step
// cached per operating point, the Gauss-Newton step under the permanent
// escalating lambda, step selection, rho and the trust-region update,
// criteria 1-4 and the attempt cap -- and the final p, Jt_x, JtJ, norm2_x,
// trust region, lambda, step count, attempt count and stop reason.
//
// Design. One thread per problem; its whole state (products, cached steps,
// Cholesky factor: about 160 values at n=6) lives in registers. Each thread
// runs its own attempt loop and stops when its own problem is done, where the
// Pallas kernel looped its whole lane tile until the slowest lane was done.
// The lambda escalation is a plain bounded loop, the Gauss-Newton step and
// its factorization are computed only when the attempt needs a fresh one
// (solver.py's lazy cache; the Pallas kernel refactored every attempt), and
// the trial products run only when the attempt evaluates a trial point.
// The general instance reads the measurements batch-minor, (100, B), so a
// warp's 32 loads of one measurement index are one contiguous 128-byte read;
// the grid sits in shared memory, loaded once per block. The factored
// instance reads its 14 statistics per problem batch-minor, (14, B), once,
// into registers, and the (6, 6) Gram pair and its sum Ghi + Glo into shared
// memory once per block.
//
// What bounds it on this card: per-thread serial floating-point work and its
// latency. The general products are ~100 x 83 operations a call, about ten
// calls a solve, and the f64 instance is near the register limit, with the
// 3.3 MB of f32 measurements read once a call, mostly from the 50 MB L2. The
// factored products are 626 operations a call on registers and shared
// memory; the step math (a few hundred operations an attempt, a Cholesky of
// 6 among them) is then of the same size. At B=8192 and 128 threads per block the launch has
// 64 blocks, so it fills only 64 of the 132 SMs with 4 warps each: the card
// is far from full, and more work per SM needs a larger batch or several
// threads per problem.
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
// keeps the default contraction, so the general instance's bits do not
// depend on this.

#include <cfloat>
#include <cstddef>
#include <cuda_runtime.h>

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

constexpr int N = 6;                // states
constexpr int M = 100;              // measurements
constexpr int NP = N * (N + 1) / 2; // packed symmetric / triangular size
constexpr int THREADS = 128;        // threads (problems) per block

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
__host__ __device__ constexpr int pk(int i, int j) {
  return i >= j ? i * (i + 1) / 2 + j : j * (j + 1) / 2 + i;
}

template <typename T>
struct Products {
  T norm2;
  T jtx[N];
  T jtj[NP];  // packed lower triangle of the symmetric JtJ
};

// Where a solve writes its results: p, Jt_x (B, 6), JtJ (B, 6, 6), and the
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

template <typename T>
__device__ __forceinline__ T dot(const T (&a)[N], const T (&b)[N]) {
  T s = T(0);
#pragma unroll
  for (int i = 0; i < N; ++i) s += a[i] * b[i];
  return s;
}

template <typename T>
__device__ __forceinline__ bool any_exceeds(const T (&v)[N], T threshold) {
  bool e = false;
#pragma unroll
  for (int i = 0; i < N; ++i) e = e || fabs(v[i]) > threshold;
  return e;
}

// v^T A v with A packed symmetric.
template <typename T>
__device__ __forceinline__ T quad_form(const T (&A)[NP], const T (&v)[N]) {
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

// The device function behind quadratic_surface.products: norm2(x), J^T x
// and J^T J of the model m(x, y; p) - meas over the grid, for problem b.
template <typename T>
__device__ __forceinline__ void quadratic_surface_products(
    const T (&p)[N], const T* __restrict__ meas_t, int B, int b,
    const T* sgx, const T* sgy, Products<T>& out) {
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
  for (int i = 0; i < M; ++i) {
    const T X = sgx[i];
    const T Y = sgy[i];
    const T meas = meas_t[static_cast<size_t>(i) * B + b];
    const T x = p01 * X * X + p12 * Y * Y + p[2] * X * Y + p[3] * X +
                p[4] * Y + p[5] - meas;
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
  out.norm2 = n2;
#pragma unroll
  for (int a = 0; a < N; ++a) out.jtx[a] = jtx[a];
#pragma unroll
  for (int a = 0; a < NP; ++a) out.jtj[a] = jtj[a];
}

// The general instance's products functor: problem b's measurements and the
// grid in shared memory.
template <typename T>
struct SurfaceProducts {
  const T* __restrict__ meas_t;
  int B;
  int b;
  const T* sgx;
  const T* sgy;

  __device__ __forceinline__ void operator()(const T (&p)[N],
                                             Products<T>& out) const {
    quadratic_surface_products(p, meas_t, B, b, sgx, sgy, out);
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
// the products from problem b's statistics (in registers) and the Gram pair
// G = Ghi + Glo (in shared memory, (6, 6) row-major; Gf = Ghi + Glo formed
// once), operation for operation in the twin's order.
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

  __device__ __forceinline__ void operator()(const T (&p)[N],
                                             Products<T>& out) const {
    const T c[N] = {mul_rn(p[0], p[1]), mul_rn(p[1], p[2]), p[2], p[3], p[4],
                    p[5]};
    // g = G c - h: each row of G c as a compensated pair by a sequential
    // two_sum cascade, then the pair minus h, collapsed
    T g[N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
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
      two_sum(s, -hh[i], d, e);
      g[i] = add_rn(d, add_rn(sub_rn(lo, hl[i]), e));
    }
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

// Cholesky of A + lam*I into packed lower L. Returns whether every pivot was
// positive and finite. A failed pivot is clamped to the smallest normal
// float (as pallas_mega.py:67-76), so a failed factor stays finite unless
// the pivot was NaN.
template <typename T>
__device__ __forceinline__ bool cholesky(const T (&A)[NP], T lam,
                                         T (&L)[NP]) {
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
template <typename T>
__device__ __forceinline__ void cho_solve(const T (&L)[NP], const T (&g)[N],
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
// computes; writes row b of `out`.
template <typename T, typename ProductsFn>
__device__ __forceinline__ void dogleg_solve(const ProductsFn& products,
                                             const T* __restrict__ p0, int b,
                                             const DoglegMegaParams& prm,
                                             const SolveOut<T>& out) {
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
  Products<T> cur;
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
      const T k = -n2_jtx / quad_form(cur.jtj, cur.jtx);
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
      bool ok = cholesky(cur.jtj, lam, L);
      for (int t = 0; !ok && t < prm.lambda_max_tries; ++t) {
        lam = lam == T(0) ? lam0 : lam * T(10);
        ok = cholesky(cur.jtj, lam, L);
      }
      T z[N];
      cho_solve(L, cur.jtx, z);
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
    const T expected = T(-2) * dot(cur.jtx, step) - quad_form(cur.jtj, step);
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
    Products<T> trial;
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

template <typename T>
__global__ void __launch_bounds__(THREADS) dogleg_mega_kernel(
    const T* __restrict__ p0, const T* __restrict__ meas_t,
    const T* __restrict__ gx, const T* __restrict__ gy, int B,
    DoglegMegaParams prm, SolveOut<T> out) {
  __shared__ T sgx[M];
  __shared__ T sgy[M];
  for (int i = threadIdx.x; i < M; i += blockDim.x) {
    sgx[i] = gx[i];
    sgy[i] = gy[i];
  }
  __syncthreads();
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  dogleg_solve<T>(SurfaceProducts<T>{meas_t, B, b, sgx, sgy}, p0, b, prm,
                  out);
}

// Problem b's statistics, (14, B) batch-minor: h_hi, h_lo, n2m_hi, n2m_lo;
// the Gram pair from shared memory.
template <typename T>
__device__ __forceinline__ FactoredProducts<T> factored_products_of(
    const T* __restrict__ stats_t, int B, int b, const T* sghi,
    const T* sglo, const T* sgf) {
  FactoredProducts<T> f;
#pragma unroll
  for (int a = 0; a < N; ++a) {
    f.hh[a] = stats_t[static_cast<size_t>(a) * B + b];
    f.hl[a] = stats_t[static_cast<size_t>(N + a) * B + b];
  }
  f.nh = stats_t[static_cast<size_t>(2 * N) * B + b];
  f.nl = stats_t[static_cast<size_t>(2 * N + 1) * B + b];
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

template <typename T>
__global__ void __launch_bounds__(THREADS) dogleg_mega_factored_kernel(
    const T* __restrict__ p0, const T* __restrict__ stats_t,
    const T* __restrict__ ghi, const T* __restrict__ glo, int B,
    DoglegMegaParams prm, SolveOut<T> out) {
  __shared__ T sghi[N * N], sglo[N * N], sgf[N * N];
  load_gram(ghi, glo, sghi, sglo, sgf);
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  dogleg_solve<T>(factored_products_of(stats_t, B, b, sghi, sglo, sgf), p0, b,
                  prm, out);
}

// The factored products alone at p (B, 6), for checking the device function
// against its twin: norm2 (B,), Jt_x (B, 6), JtJ (B, 6, 6).
template <typename T>
__global__ void __launch_bounds__(THREADS) factored_products_kernel(
    const T* __restrict__ p, const T* __restrict__ stats_t,
    const T* __restrict__ ghi, const T* __restrict__ glo, int B,
    T* __restrict__ norm2, T* __restrict__ jtx, T* __restrict__ jtj) {
  __shared__ T sghi[N * N], sglo[N * N], sgf[N * N];
  load_gram(ghi, glo, sghi, sglo, sgf);
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  T q[N];
#pragma unroll
  for (int a = 0; a < N; ++a) q[a] = p[static_cast<size_t>(b) * N + a];
  Products<T> r;
  factored_products_of(stats_t, B, b, sghi, sglo, sgf)(q, r);
  const size_t row = static_cast<size_t>(b);
  norm2[b] = r.norm2;
#pragma unroll
  for (int a = 0; a < N; ++a) {
    jtx[row * N + a] = r.jtx[a];
#pragma unroll
    for (int c = 0; c < N; ++c) jtj[row * N * N + a * N + c] = r.jtj[pk(a, c)];
  }
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

int blocks_for(int n) { return (n + THREADS - 1) / THREADS; }

template <typename T>
SolveOut<T> solve_out(void* p, void* jtx, void* jtj, void* norm2, void* tr,
                      void* lam, void* step_count, void* n_attempts,
                      void* reason) {
  return {static_cast<T*>(p), static_cast<T*>(jtx), static_cast<T*>(jtj),
          static_cast<T*>(norm2), static_cast<T*>(tr), static_cast<T*>(lam),
          static_cast<int*>(step_count), static_cast<int*>(n_attempts),
          static_cast<int*>(reason)};
}

// Both instances take (p0, per-problem data, two shared arrays, B); the
// general one the measurements (100, B) and the grid, the factored one the
// statistics (14, B) and the Gram pair.
template <typename T, bool Factored>
int launch(const void* p0, const void* data_t, const void* shared_a,
           const void* shared_b, int B, const DoglegMegaParams* prm, void* p,
           void* jtx, void* jtj, void* norm2, void* tr, void* lam,
           void* step_count, void* n_attempts, void* reason, int device,
           void* stream) {
  if (B <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const SolveOut<T> out = solve_out<T>(p, jtx, jtj, norm2, tr, lam,
                                       step_count, n_attempts, reason);
  auto kernel = Factored ? &dogleg_mega_factored_kernel<T>
                         : &dogleg_mega_kernel<T>;
  kernel<<<blocks_for(B), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(p0), static_cast<const T*>(data_t),
      static_cast<const T*>(shared_a), static_cast<const T*>(shared_b), B,
      *prm, out);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_factored_products(const void* p, const void* stats_t,
                             const void* ghi, const void* glo, int B,
                             void* norm2, void* jtx, void* jtj, int device,
                             void* stream) {
  if (B <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  factored_products_kernel<T><<<blocks_for(B), THREADS, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(p), static_cast<const T*>(stats_t),
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
  error_free_kernel<T><<<blocks_for(n), THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), n,
      static_cast<T*>(p), static_cast<T*>(pe), static_cast<T*>(s),
      static_cast<T*>(se));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry points: launch on `stream` without synchronizing; return the
// cudaError_t of the launch (0 on success).
#define DOGLEG_MEGA_ENTRY(name, T, factored)                                  \
  extern "C" int name(const void* p0, const void* data_t,                     \
                      const void* shared_a, const void* shared_b, int B,      \
                      const DoglegMegaParams* prm, void* p, void* jtx,        \
                      void* jtj, void* norm2, void* tr, void* lam,            \
                      void* step_count, void* n_attempts, void* reason,       \
                      int device, void* stream) {                             \
    return launch<T, factored>(p0, data_t, shared_a, shared_b, B, prm, p,     \
                               jtx, jtj, norm2, tr, lam, step_count,          \
                               n_attempts, reason, device, stream);           \
  }
DOGLEG_MEGA_ENTRY(dogleg_mega_f32, float, false)
DOGLEG_MEGA_ENTRY(dogleg_mega_f64, double, false)
DOGLEG_MEGA_ENTRY(dogleg_mega_factored_f32, float, true)
DOGLEG_MEGA_ENTRY(dogleg_mega_factored_f64, double, true)
#undef DOGLEG_MEGA_ENTRY

extern "C" int dogleg_factored_products_f32(const void* p, const void* stats_t,
                                            const void* ghi, const void* glo,
                                            int B, void* norm2, void* jtx,
                                            void* jtj, int device,
                                            void* stream) {
  return launch_factored_products<float>(p, stats_t, ghi, glo, B, norm2, jtx,
                                         jtj, device, stream);
}

extern "C" int dogleg_factored_products_f64(const void* p, const void* stats_t,
                                            const void* ghi, const void* glo,
                                            int B, void* norm2, void* jtx,
                                            void* jtj, int device,
                                            void* stream) {
  return launch_factored_products<double>(p, stats_t, ghi, glo, B, norm2, jtx,
                                          jtj, device, stream);
}

extern "C" int dogleg_error_free_f32(const void* a, const void* b, int n,
                                     void* p, void* pe, void* s, void* se,
                                     int device, void* stream) {
  return launch_error_free<float>(a, b, n, p, pe, s, se, device, stream);
}

extern "C" int dogleg_error_free_f64(const void* a, const void* b, int n,
                                     void* p, void* pe, void* s, void* se,
                                     int device, void* stream) {
  return launch_error_free<double>(a, b, n, p, pe, s, se, device, stream);
}
