// Kernel K1 over a generated products functor: the kernel, its products
// check kernel, their launchers and C entry points, and the same solve as a
// plain host loop. parallel/mega_auto.py generates a source that defines
// the functor (template <typename T> struct AutoProducts) after including
// this header, and ends with DOGLEG_AUTO_ENTRIES(AutoProducts, N).
//
// Replaces, with dogleg_solve.cuh, the TPU kernel
// libdogleg_tpu/ops/pallas_mega.py::megakernel_optimize (pallas_call :522)
// as libdogleg_tpu/parallel/mega_auto.py builds it around an ordinary
// per-element products function traced into its body.
//
// Design. A functor comes in one of two forms (parallel/mega_auto.py):
//   - the row form, for graphs whose three products are sums over one row
//     axis (a measurement each): a problem has a group of G lanes of one
//     warp (the functor's kGroup), and lane r computes rows r, r + G, ...
//     in one loop, each row's values scalars or short arrays with
//     compile-time indices (in registers), adding its terms to the
//     accumulators of norm2, Jt_x and JtJ's lower triangle, the only
//     entries Products holds; group_row_sums combines the lanes' partial
//     sums by Group<G>::sum's xor butterfly, so every lane of a group holds
//     the same bits, takes the same branches and never diverges, as the
//     named general instance of csrc/mega.cu does. What has no row axis
//     (the prologue) is computed once an evaluation, before the loop.
//   - the array form, for other graphs: one thread a problem (kGroup 1),
//     every value of the graph in a local array of its own shape.
// Blocks are 32 G threads, at most 128 (threads_for), so that the blocks
// spread over the 132 SMs; each lane keeps its problem's state in
// registers, reads its own rows of the problem data, and the shared
// constants through the read-only cache (dl_ld), and runs its own attempt
// loop. What bounds it: the chain of the batch's slowest problem, its
// attempts times an attempt's step math and products; the products split
// over G lanes cost M / G rows plus log2 G shuffles of each accumulator
// (PERF.md §6).
//
// Numerics (hazards F2, F5, F7): the generated functor does every
// elementwise operation and every term of a sum through dl_add, dl_mul,
// dl_sub and dl_div, the __fadd_rn family on the card, which nvcc never
// contracts into a fused multiply-add, and plain operators on the host,
// built with -ffp-contract=off. So the functor rounds once per operation,
// as PyTorch's elementwise kernels do, and gives the same bits on the card
// and on the host except where a transcendental function (exp, tanh, ...)
// differs between libraries. Built without --use_fast_math, and with
// -fmad=false (loader.GENERATED_NVCC_FLAGS), so that the solve's step math
// around the functor is not contracted either: how nvcc would contract it
// follows the code around it, which differs between the two forms. Each
// element of
// the row form does the array form's operations in the array form's order,
// so at G = 1 the two forms give the same bits; at G > 1 only the order of
// the row sums changes, to the butterfly's. On the host, group_row_sums
// runs a group's G lanes in turn and combines their partial sums in the
// butterfly's own order, so the host build gives the card's bits at the
// card's G.
//
// Under nvcc the entries are dogleg_auto_solve_{f32,f64} and
// dogleg_auto_products_{f32,f64} (device pointers, launched on a stream
// without synchronizing, returning the launch's cudaError_t); under g++
// dogleg_auto_host_solve_{f32,f64} and dogleg_auto_host_products_{f32,f64}
// (host pointers, run in the call). All take the input pointers as a host
// array: the problem data's leaves, each (B, ...) contiguous, then the
// shared constants.

#pragma once

#include "dogleg_solve.cuh"

namespace {

// Input pointers a generated functor may have (problem-data leaves and
// shared constants together); parallel/mega_auto.py refuses more.
constexpr int AUTO_MAX_INPUTS = 32;

struct AutoInputs {
  const void* ptr[AUTO_MAX_INPUTS];
};

// Unrolls an inner loop of the row form, so that its indices are constants
// and its arrays registers.
#ifdef __CUDACC__
#define DOGLEG_UNROLL _Pragma("unroll")
#else
#define DOGLEG_UNROLL
#endif

#ifdef __CUDACC__
template <typename T>
DOGLEG_DEVICE T dl_ld(const T* p) { return __ldg(p); }
DOGLEG_DEVICE float dl_add(float a, float b) { return __fadd_rn(a, b); }
DOGLEG_DEVICE double dl_add(double a, double b) { return __dadd_rn(a, b); }
DOGLEG_DEVICE float dl_sub(float a, float b) { return __fsub_rn(a, b); }
DOGLEG_DEVICE double dl_sub(double a, double b) { return __dsub_rn(a, b); }
DOGLEG_DEVICE float dl_mul(float a, float b) { return __fmul_rn(a, b); }
DOGLEG_DEVICE double dl_mul(double a, double b) { return __dmul_rn(a, b); }
DOGLEG_DEVICE float dl_div(float a, float b) { return __fdiv_rn(a, b); }
DOGLEG_DEVICE double dl_div(double a, double b) { return __ddiv_rn(a, b); }
DOGLEG_DEVICE float dl_sqrt(float a) { return __fsqrt_rn(a); }
DOGLEG_DEVICE double dl_sqrt(double a) { return __dsqrt_rn(a); }
#else
using std::cos;
using std::exp;
using std::log;
using std::pow;
using std::sin;
using std::tanh;
template <typename T>
inline T dl_add(T a, T b) { return a + b; }
template <typename T>
inline T dl_sub(T a, T b) { return a - b; }
template <typename T>
inline T dl_mul(T a, T b) { return a * b; }
template <typename T>
inline T dl_div(T a, T b) { return a / b; }
template <typename T>
inline T dl_sqrt(T a) { return sqrt(a); }
template <typename T>
inline T dl_ld(const T* p) { return *p; }
#endif

// The row form's sums: rows(lane, acc) adds the terms of the rows lane
// `lane` takes to its K partial sums acc; the G lanes' partial sums are then
// combined by the xor butterfly of Group<G>::sum (lane r adds lane r ^ s's,
// s = 1, 2, ..., G / 2), and acc holds the group's sums. On the card each
// lane runs its own rows; on the host the G lanes run in turn, and their
// sums are combined in the same order, so both give the same bits.
template <int G, typename T, int K, typename Rows>
DOGLEG_DEVICE void group_row_sums(const Rows& rows, T (&acc)[K]) {
#ifdef __CUDACC__
  const Group<G> group(threadIdx.x);
#pragma unroll
  for (int k = 0; k < K; ++k) acc[k] = T(0);
  rows(group.rank, acc);
#pragma unroll
  for (int k = 0; k < K; ++k) acc[k] = group.sum(acc[k]);
#else
  T part[G][K];
  for (int r = 0; r < G; ++r) {
    for (int k = 0; k < K; ++k) part[r][k] = T(0);
    rows(r, part[r]);
  }
  for (int s = 1; s < G; s <<= 1) {
    T next[G][K];
    for (int r = 0; r < G; ++r)
      for (int k = 0; k < K; ++k)
        next[r][k] = dl_add(part[r][k], part[r ^ s][k]);
    for (int r = 0; r < G; ++r)
      for (int k = 0; k < K; ++k) part[r][k] = next[r][k];
  }
  for (int k = 0; k < K; ++k) acc[k] = part[0][k];
#endif
}

#ifdef __CUDACC__
template <typename T, int N, template <typename> class F>
__global__ void __launch_bounds__(threads_for<F<T>::kGroup>())
    dogleg_auto_kernel(const T* __restrict__ p0, AutoInputs ins, int B,
                       DoglegMegaParams prm, SolveOut<T> out) {
  const Lane l = lane_of<F<T>::kGroup>(B);
  dogleg_solve<T, N>(F<T>::at(ins.ptr, l.b), p0, l.b, l.write, prm, out);
}

template <typename T, int N, template <typename> class F>
__global__ void __launch_bounds__(threads_for<F<T>::kGroup>())
    dogleg_auto_products_kernel(const T* __restrict__ p, AutoInputs ins,
                                int B, T* __restrict__ norm2,
                                T* __restrict__ jtx, T* __restrict__ jtj) {
  const Lane l = lane_of<F<T>::kGroup>(B);
  products_at<T, N>(F<T>::at(ins.ptr, l.b), p, l.b, l.write, norm2, jtx, jtj);
}

inline AutoInputs auto_inputs(const void* const* ins, int n_ins) {
  AutoInputs a{};
  for (int k = 0; k < n_ins; ++k) a.ptr[k] = ins[k];
  return a;
}

template <typename T, int N, template <typename> class F>
int launch_auto_solve(const void* p0, const void* const* ins, int B,
                      const DoglegMegaParams* prm, void* const* outs,
                      int device, void* stream) {
  if (B <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int G = F<T>::kGroup;
  dogleg_auto_kernel<T, N, F><<<blocks_for<G>(B), threads_for<G>(), 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(p0), auto_inputs(ins, F<T>::kInputs), B, *prm,
      solve_out<T>(outs));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int N, template <typename> class F>
int launch_auto_products(const void* p, const void* const* ins, int B,
                         void* norm2, void* jtx, void* jtj, int device,
                         void* stream) {
  if (B <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int G = F<T>::kGroup;
  dogleg_auto_products_kernel<T, N, F>
      <<<blocks_for<G>(B), threads_for<G>(), 0,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(p), auto_inputs(ins, F<T>::kInputs), B,
          static_cast<T*>(norm2), static_cast<T*>(jtx), static_cast<T*>(jtj));
  return static_cast<int>(cudaGetLastError());
}

#define DOGLEG_AUTO_DTYPE_ENTRIES(F, NS, dt, T)                               \
  extern "C" int dogleg_auto_solve_##dt(                                      \
      const void* p0, const void* const* ins, int B,                          \
      const DoglegMegaParams* prm, void* p, void* jtx, void* jtj,             \
      void* norm2, void* tr, void* lam, void* step_count, void* n_attempts,   \
      void* reason, int device, void* stream) {                               \
    void* const outs[] = {p,  jtx, jtj,        norm2,     tr,                 \
                          lam, step_count, n_attempts, reason};               \
    return launch_auto_solve<T, NS, F>(p0, ins, B, prm, outs, device,         \
                                       stream);                               \
  }                                                                           \
  extern "C" int dogleg_auto_products_##dt(                                   \
      const void* p, const void* const* ins, int B, void* norm2, void* jtx,   \
      void* jtj, int device, void* stream) {                                  \
    return launch_auto_products<T, NS, F>(p, ins, B, norm2, jtx, jtj, device, \
                                          stream);                            \
  }
#else
template <typename T, int N, template <typename> class F>
int host_auto_solve(const void* p0, const void* const* ins, int B,
                    const DoglegMegaParams* prm, void* const* outs) {
  const SolveOut<T> out = solve_out<T>(outs);
  for (int b = 0; b < B; ++b)
    dogleg_solve<T, N>(F<T>::at(ins, b), static_cast<const T*>(p0), b, true,
                       *prm, out);
  return 0;
}

template <typename T, int N, template <typename> class F>
int host_auto_products(const void* p, const void* const* ins, int B,
                       void* norm2, void* jtx, void* jtj) {
  for (int b = 0; b < B; ++b)
    products_at<T, N>(F<T>::at(ins, b), static_cast<const T*>(p), b, true,
                      static_cast<T*>(norm2), static_cast<T*>(jtx),
                      static_cast<T*>(jtj));
  return 0;
}

#define DOGLEG_AUTO_DTYPE_ENTRIES(F, NS, dt, T)                               \
  extern "C" int dogleg_auto_host_solve_##dt(                                 \
      const void* p0, const void* const* ins, int B,                          \
      const DoglegMegaParams* prm, void* p, void* jtx, void* jtj,             \
      void* norm2, void* tr, void* lam, void* step_count, void* n_attempts,   \
      void* reason) {                                                         \
    void* const outs[] = {p,  jtx, jtj,        norm2,     tr,                 \
                          lam, step_count, n_attempts, reason};               \
    return host_auto_solve<T, NS, F>(p0, ins, B, prm, outs);                  \
  }                                                                           \
  extern "C" int dogleg_auto_host_products_##dt(                              \
      const void* p, const void* const* ins, int B, void* norm2, void* jtx,   \
      void* jtj) {                                                            \
    return host_auto_products<T, NS, F>(p, ins, B, norm2, jtx, jtj);          \
  }
#endif

}  // namespace

// The C entry points of a generated source, both types, and what it was
// generated for: its N, its number of input pointers and its lanes a problem.
#define DOGLEG_AUTO_ENTRIES(F, NS)                                            \
  DOGLEG_AUTO_DTYPE_ENTRIES(F, NS, f32, float)                                \
  DOGLEG_AUTO_DTYPE_ENTRIES(F, NS, f64, double)                               \
  extern "C" int dogleg_auto_nstate() { return NS; }                          \
  extern "C" int dogleg_auto_inputs() { return F<float>::kInputs; }           \
  extern "C" int dogleg_auto_group() { return F<float>::kGroup; }
