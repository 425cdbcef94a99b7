// The blocked right-looking Cholesky of one matrix by one group of threads,
// shared by K5 (batchchol.cu), K6 (tilechol.cu, tiles wider than 32) and
// K2's factor kernel (panelchol.cu). The three differ in their pivot rule
// (a template parameter), in what they pad and in their ok flag; the
// arithmetic of a stage is written once, here.
//
// The algorithm, in 16-wide panels. Per stage:
//   1. the first warp holds the 16x16 diagonal block's rows in registers and
//      factors it with shuffles (no barrier inside the 16 pivot steps);
//   2. every thread solves whole rows of the panel below in registers
//      against the block (X Lkk^T = P, a true division by the diagonal; the
//      block is read by all threads at once, a broadcast), and writes the
//      solved panel back and, transposed, into a 16 x n staging buffer;
//   3. the trailing block takes its rank-16 update W -= X X^T over the 4x4
//      tiles of its lower triangle only, one tile per thread at a time, its
//      operands two 16-byte loads per panel column from the staging buffer,
//      16 multiply-adds each.
// Three barriers a stage, 24 at n = 128 where a loop over columns has 256;
// two where a block looks ahead (K6, K2), its first warp factoring the next
// diagonal block beside the other warps' update: step 1 of stage j + 1
// within step 3 of stage j.
// The working copy sits in the group's shared memory with a row stride of
// n + 4 (every 4-element group 16-byte aligned, the rows spread over the
// banks) when there is room for it; else, where the caller allows it, as a
// packed lower triangle in shared memory (the 16 rows of row block I keep
// their first 16 (I + 1) entries and 4 of padding: 143 KB for a 256-wide
// float32 matrix where whole rows take 266 KB); else in place in the
// output, which stays in L2. No loop depends on the data: a matrix that is
// not SPD leaves NaN in its own factor and nowhere else.
//
// Products are plain float32 or float64 multiply-adds (nvcc contracts them
// into FMA): no tensor cores, never TF32.

#pragma once

#include <cfloat>

#include "group.cuh"

namespace {

constexpr int PANEL = 16;
constexpr int DK_LD = PANEL + 1;          // row stride of the staged block
constexpr int DK_SIZE = PANEL * DK_LD;    // 272 elements, a multiple of 4

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

// s / d, bit for bit, without the slow path that an IEEE division takes for
// a zero numerator: for s == 0 and d > 0 the quotient is s itself, sign
// included, and the division runs on a harmless numerator. A block-sparse
// matrix stored densely is mostly zeros, and its panels' rows mostly hit
// that path: K6 on (21, 128, 128) float32 tiles with a band of 17 took 38 us
// with plain divisions where dense tiles took 26 us, and all of the
// difference went with the divisions (H100, 700 W). The choice of the
// numerator is hidden from the compiler, which otherwise folds the two
// selections back into the plain division.
template <typename T>
__device__ __forceinline__ T quotient(T s, T d) {
  const bool zero = s == T(0) && d > T(0);
  int harmless = zero;
  asm volatile("" : "+r"(harmless));
  const T q = (harmless ? T(1) : s) / d;
  return zero ? s : q;
}

// The pivot rule of K5 and K6: L_jj = d * rsqrt(d), L_ij = a_ij * rsqrt(d),
// unclamped, so a pivot that is not positive leaves NaN or a non-positive
// diagonal.
struct RsqrtPivot {
  template <typename T>
  __device__ static T factor(T d) { return rsqrt_(d); }
  template <typename T>
  __device__ static T diag(T d, T f) { return d * f; }
  template <typename T>
  __device__ static T below(T a, T f) { return a * f; }
};

// The pivot rule of K2: d = sqrt(max(d2, tiny)) with the float32 tiny value
// in both types, the maximum propagating NaN as jnp.maximum does; L_jj = d,
// L_ij = a_ij / d, a true division.
struct ClampedSqrtPivot {
  template <typename T>
  __device__ static T factor(T d2) {
    const T tiny = T(FLT_MIN);
    return sqrt(isnan(d2) || d2 > tiny ? d2 : tiny);
  }
  template <typename T>
  __device__ static T diag(T, T f) { return f; }
  template <typename T>
  __device__ static T below(T a, T f) { return quotient(a, f); }
};

// 16-byte words a thread keeps in flight while it copies a matrix in.
constexpr int COPY_AHEAD = 8;

// Where the working copy of a matrix lives.
enum WorkMode { IN_PLACE = 0, PACKED = 1, STRIDED = 2 };

// Elements of shared memory a group needs for an n-wide matrix (n a multiple
// of 16): the 16 x n staging buffer, the staged diagonal block and, when the
// working copy sits in shared memory too, its rows.
__host__ __device__ inline size_t chol_work_elems(int n, int mode) {
  const size_t nb = n / PANEL;
  const size_t rows = mode == STRIDED  ? static_cast<size_t>(n) * (n + 4)
                      : mode == PACKED ? PANEL * PANEL * nb * (nb + 1) / 2 +
                                             4 * static_cast<size_t>(n)
                                       : 0;
  return static_cast<size_t>(PANEL) * n + DK_SIZE + rows;
}

// Row i of the working copy W: rows ld apart, or, with ld == 0, the packed
// lower triangle (row 16 I + b starts 16 (I + 1) (8 I + b) + 4 i elements in,
// so that every row starts on a 16-byte word and eight neighbouring rows
// fall on different banks).
template <typename T>
__device__ __forceinline__ T* row_of(T* W, int ld, int i) {
  if (ld) return W + static_cast<size_t>(i) * ld;
  const int I = i / PANEL, b = i % PANEL;
  return W + PANEL * (I + 1) * (PANEL / 2 * I + b) + 4 * i;
}

// The mode for `groups` matrices of width n (a multiple of 16) to a block of
// `kernel` on `device`, and the dynamic shared memory it takes, which the
// kernel is allowed here: whole rows if they fit in what a block may hold,
// else the packed triangle if the caller takes it and it fits, else in place.
template <typename T, typename Kernel>
cudaError_t chol_work_mode(Kernel kernel, int device, int groups, int n,
                           bool take_packed, size_t* bytes, int* mode) {
  int optin = 0;
  cudaError_t err = optin_shared(device, &optin);
  if (err != cudaSuccess) return err;
  const auto need = [&](int m) {
    return groups * chol_work_elems(n, m) * sizeof(T);
  };
  *mode = need(STRIDED) <= static_cast<size_t>(optin) ? STRIDED
          : take_packed && need(PACKED) <= static_cast<size_t>(optin)
              ? PACKED
              : IN_PLACE;
  *bytes = need(*mode);
  return allow_shared(reinterpret_cast<const void*>(kernel), device, *bytes);
}

// Stage step 1, by one full warp: factor the 16x16 diagonal block at row and
// column j0 of W in place and stage it in Dk. Lane l and lane l + 16 both
// hold row l; only the first writes. Returns whether all 16 pivots were
// positive and finite (the same value on every lane).
template <typename T, typename Pivot>
__device__ bool factor_diag(T* W, int ld, int j0, T* Dk, int lane) {
  const int row = lane & (PANEL - 1);
  T* wrow = row_of(W, ld, j0 + row) + j0;
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
    const T f = Pivot::factor(d);
    good = good && d > T(0) && isfinite(d);
    // column j of L; zero above the diagonal
    r[j] = row > j ? Pivot::below(r[j], f)
                   : (row == j ? Pivot::diag(d, f) : T(0));
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

// Stage step 3 for one 4x4 tile: tile q of the lower triangle of the
// trailing block that starts at row and column r0, W -= X X^T with X read
// from the (16, n) staging buffer Pt.
template <typename T>
__device__ __forceinline__ void update_tile(T* W, int ld, int n,
                                            const T* Pt, int r0, int q) {
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
    T* w = row_of(W, ld, r0 + 4 * ti + u) + r0 + 4 * tj;
    Quad<T> wq = load4(w);
#pragma unroll
    for (int v = 0; v < 4; ++v) wq.v[v] -= acc[u][v];
    store4(w, wq);
  }
}

// Threads of K6's and K2's blocks, one to a matrix and few to a launch, so
// that a block has its SM to itself: in float32 twice the warps of K5's
// block hide more of the latency of the update's shared loads (K6 at
// (21, 256, 256) 87 -> 79 us, K2's factor at p = 256 100 -> 92 us; H100,
// 700 W); in float64 K2's factor, in place in L2 at p = 256, is slower with
// them (217 -> 229 us).
constexpr int LONE_THREADS_F32 = 512;
template <typename T>
constexpr int lone_threads = sizeof(T) == 4 ? LONE_THREADS_F32 : THREADS;

// Whether K6's and K2's blocks, one to a matrix and few to a launch, look
// ahead: the first warp updates the next diagonal block first and factors it
// while the other warps update the rest of the trailing block, so that the
// pivot chain of one stage runs beside the update of the stage before and
// not after it. K5, with hundreds of blocks to a launch and several to an
// SM, hides that chain behind other blocks and does not.
constexpr bool LOOK_AHEAD = true;

// The stages of an n-wide matrix (n a multiple of 16) held in W, its rows
// where row_of finds them, by thread t of a group of G; Pt is the group's
// (16, n) staging buffer and Dk its staged diagonal block. The group is
// synchronized on entry and on return. Returns, on the group's first warp,
// whether every pivot was positive and finite. With AHEAD (whole blocks
// only) the group looks ahead; every entry takes the same operations in the
// same order either way.
template <typename T, int G, typename Pivot, bool AHEAD>
__device__ bool chol_stages(T* W, int ld, int n, T* Pt, T* Dk, int t) {
  static_assert(!AHEAD || G > 32, "a single warp cannot look ahead");
  // the 4x4 tiles of a diagonal block's lower triangle: the first tiles of
  // every trailing block
  constexpr int NEXT = (PANEL / 4) * (PANEL / 4 + 1) / 2;
  bool good = true;
  if constexpr (AHEAD) {
    if (t < 32) good = factor_diag<T, Pivot>(W, ld, 0, Dk, t);
    Group<G>::sync();
  }
  for (int j0 = 0; j0 < n; j0 += PANEL) {
    const int r0 = j0 + PANEL;  // first row and column of the trailing block
    if constexpr (!AHEAD) {
      if (t < 32) good = factor_diag<T, Pivot>(W, ld, j0, Dk, t) && good;
      Group<G>::sync();
    }

    // the panel below the block: X Lkk^T = P, one row per thread
    for (int i = r0 + t; i < n; i += G) {
      T* wrow = row_of(W, ld, i) + j0;
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
        x[j] = quotient(s, Dk[j * DK_LD + j]);
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
    if constexpr (!AHEAD) {
      for (int q = t; q < ntiles; q += G) update_tile(W, ld, n, Pt, r0, q);
    } else if (t >= 32) {
      for (int q = NEXT + t - 32; q < ntiles; q += G - 32)
        update_tile(W, ld, n, Pt, r0, q);
    } else if (r0 < n) {  // the first warp: the next diagonal block
      if (t < NEXT) update_tile(W, ld, n, Pt, r0, t);
      __syncwarp();
      good = factor_diag<T, Pivot>(W, ld, r0, Dk, t) && good;
    }
    Group<G>::sync();
  }
  return good;
}

// The whole factorization of one (n, n) matrix `a` into `l`, both row-major
// with stride n, by thread t of a group of G whose shared memory starts at
// `work` (chol_work_elems(npad, mode) elements, npad = n rounded up to a
// multiple of 16). In shared memory (mode STRIDED or PACKED) the working copy
// is padded to npad with an identity diagonal, which is exact: [[A, 0],
// [0, I]] factors as [[L, 0], [0, I]]. IN_PLACE the matrix is worked in l,
// which then needs n == npad and 16-byte aligned rows (vec_out). vec_in and
// vec_out say that the rows of a and of l are whole aligned 16-byte words;
// otherwise they are copied element by element. l gets zeros above the
// diagonal. Returns, on the group's first warp, whether every pivot was
// positive and finite; *finite says, per thread, whether every entry of L
// this thread wrote was finite.
template <typename T, int G, typename Pivot, bool AHEAD>
__device__ bool blocked_cholesky(const T* __restrict__ a, int n,
                                 T* __restrict__ l, T* work, int mode,
                                 bool vec_in, bool vec_out, int t,
                                 bool* finite) {
  const int npad = (n + PANEL - 1) / PANEL * PANEL;
  const int ld = mode == STRIDED ? npad + 4 : mode == PACKED ? 0 : n;
  T* Pt = work;                           // (16, npad) panel^T
  T* Dk = Pt + PANEL * npad;              // the factored block
  T* W = mode == IN_PLACE ? l : Dk + DK_SIZE;  // the working copy

  // COPY_AHEAD words of a thread are on their way from device memory at a
  // time: a block alone on its SM has too few threads to hide that latency
  // one word at a time
  const int nq = npad / 4;
  for (int e0 = t; e0 < npad * nq; e0 += COPY_AHEAD * G) {
    Quad<T> q[COPY_AHEAD];
#pragma unroll
    for (int k = 0; k < COPY_AHEAD; ++k) {
      const int e = e0 + k * G, i = e / nq, c = (e % nq) * 4;
      if (e >= npad * nq) break;
      if (vec_in && i < n && c < n) {  // n is a multiple of 4 here
        q[k] = load4(a + static_cast<size_t>(i) * n + c);
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          q[k].v[u] = i < n && c + u < n
                          ? a[static_cast<size_t>(i) * n + c + u]
                          : T(i == c + u);
      }
    }
#pragma unroll
    for (int k = 0; k < COPY_AHEAD; ++k) {
      const int e = e0 + k * G, i = e / nq, c = (e % nq) * 4;
      if (e >= npad * nq) break;
      // the packed triangle keeps a row up to the end of its diagonal block
      if (mode == PACKED && c >= (i / PANEL + 1) * PANEL) continue;
      store4(row_of(W, ld, i) + c, q[k]);
    }
  }
  Group<G>::sync();

  const bool good = chol_stages<T, G, Pivot, AHEAD>(W, ld, npad, Pt, Dk, t);

  bool fin = true;
  const int mq = (n + 3) / 4;
  for (int e = t; e < n * mq; e += G) {
    const int i = e / mq, c = (e % mq) * 4;
    Quad<T> q = load4(row_of(W, ld, i) + (c <= i ? c : 0));
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (c + u > i) q.v[u] = T(0);
      fin = fin && isfinite(q.v[u]);
    }
    T* out = l + static_cast<size_t>(i) * n + c;
    if (vec_out) {
      store4(out, q);
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (c + u < n) out[u] = q.v[u];
    }
  }
  *finite = fin;
  return good;
}

}  // namespace
