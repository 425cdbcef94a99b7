// K1's host-side launch (ops/mega.py), one native call: the input checks,
// contiguous inputs, the nine outputs and the call of the solve entry
// (csrc/mega.cu's dogleg_mega_* and dogleg_mega_factored_*, or a generated
// library's dogleg_auto_solve_*, through its address) on PyTorch's current
// stream. It replaces the Python wrapper's checks, allocations and ctypes
// call, whose host time paced the fleets; the kernels are unchanged.
//
// Built with g++ against PyTorch's headers by native/loader.build_launcher
// at the first launch on a card, and imported as a Python module (the
// functions named in PYBIND11_MODULE below). A bad input raises ValueError
// before anything is allocated or launched; a launch the runtime refuses
// raises RuntimeError with its cudaError_t.
//
// The outputs take two allocations from the caching allocator: one of p's
// dtype (p, Jt_x, JtJ, norm2_x, trustregion, lam, each starting on a
// 128-byte boundary) and one of int32 (step_count, n_attempts, reason).
// Each output is a contiguous tensor on its part of the allocation, made
// here without a dispatched operation, so it costs no dispatcher or
// profiler event; the parts do not overlap.

#include <ATen/core/Tensor.h>
#include <ATen/ops/empty.h>
#include <c10/core/impl/DeviceGuardImplInterface.h>
#include <torch/csrc/utils/pybind.h>

#include <cstdint>
#include <sstream>
#include <string>
#include <tuple>
#include <vector>

namespace {

namespace py = pybind11;
using at::Tensor;

// A generated functor's inputs (problem-data leaves, then constants): at
// most csrc/dogleg_auto.cuh's AUTO_MAX_INPUTS.
constexpr int kMaxGeneratedInputs = 32;
constexpr int64_t kAlignBytes = 128;

// The entries' signatures: p0, the inputs, B, the parameter struct
// (csrc/mega.cu's DoglegMegaParams, only read), the nine outputs in
// SolveOut's order (p, jtx, jtj, norm2, tr, lam, step_count, n_attempts,
// reason), the device and the stream.
#define DOGLEG_OUTS void*, void*, void*, void*, void*, void*, void*, void*, void*
using GeneralEntry = int (*)(const void*, const void*, const void*,
                             const void*, int, const void*, DOGLEG_OUTS, int,
                             void*);
using FactoredEntry = int (*)(const void*, const void*, const void*,
                              const void*, const void*, const void*,
                              const void*, int, const void*, DOGLEG_OUTS, int,
                              void*);
using GeneratedEntry = int (*)(const void*, const void* const*, int,
                               const void*, DOGLEG_OUTS, int, void*);
#undef DOGLEG_OUTS

using Result = std::tuple<Tensor, Tensor, Tensor, Tensor, Tensor, Tensor,
                          Tensor, Tensor, Tensor>;

// A shape as Python prints a tuple: (8192, 100), (100,), ().
std::string shape_str(at::IntArrayRef shape) {
  std::ostringstream s;
  s << "(";
  for (size_t k = 0; k < shape.size(); ++k) {
    s << (k ? ", " : "") << shape[k];
  }
  s << (shape.size() == 1 ? ",)" : ")");
  return s.str();
}

// p0 is (B, n) float32 or float64 on a CUDA device, B below 2^31.
void check_p0(const Tensor& p0, int64_t n) {
  TORCH_CHECK_VALUE(p0.dim() == 2 && p0.size(1) == n, "p0 must be (B, ", n,
                    "), got ", shape_str(p0.sizes()));
  TORCH_CHECK_VALUE(p0.scalar_type() == at::kFloat ||
                        p0.scalar_type() == at::kDouble,
                    "p0 must be float32 or float64, got ",
                    p0.scalar_type());
  TORCH_CHECK_VALUE(p0.size(0) < (int64_t(1) << 31),
                    "batch too large for the kernel's int indexing");
}

void check_like(const Tensor& p0, const Tensor& t, const char* name) {
  TORCH_CHECK_VALUE(
      t.scalar_type() == p0.scalar_type() && t.device() == p0.device(), name,
      " must match p0's dtype and device");
}

// `t` has one of `shapes` and p0's dtype and device.
void check_input(const Tensor& p0, const Tensor& t, const char* name,
                 std::initializer_list<std::vector<int64_t>> shapes) {
  bool ok = false;
  std::string want;
  for (const auto& s : shapes) {
    ok = ok || t.sizes() == at::IntArrayRef(s);
    want += (want.empty() ? "" : " or ") + shape_str(s);
  }
  TORCH_CHECK_VALUE(ok, name, " must be ", want, ", got ",
                    shape_str(t.sizes()));
  check_like(p0, t, name);
}

void check_cuda(const Tensor& p0) {
  TORCH_CHECK_VALUE(p0.is_cuda(), "no kernel for device ", p0.device());
}

// A contiguous tensor of `shape` on `buf`'s storage from element `offset`,
// built as at::empty builds its result, with no dispatched operation.
Tensor part(const Tensor& buf, at::IntArrayRef shape, int64_t offset) {
  Tensor t = at::detail::make_tensor<c10::TensorImpl>(
      c10::Storage(buf.storage()), buf.key_set(), buf.dtype());
  t.unsafeGetTensorImpl()->set_sizes_contiguous(shape);
  t.unsafeGetTensorImpl()->set_storage_offset(offset);
  return t;
}

struct Outputs {
  Tensor p, jtx, jtj, norm2, tr, lam, step_count, n_attempts, reason;

  Outputs(const Tensor& p0) {
    const int64_t B = p0.size(0), n = p0.size(1);
    const int64_t align = kAlignBytes / int64_t(p0.element_size());
    const auto round = [align](int64_t k) {
      return (k + align - 1) / align * align;
    };
    const int64_t vec = round(B * n), mat = round(B * n * n), one = round(B);
    const Tensor f = at::empty({2 * vec + mat + 3 * one}, p0.options());
    const Tensor i = at::empty({3 * B}, p0.options().dtype(at::kInt));
    p = part(f, {B, n}, 0);
    jtx = part(f, {B, n}, vec);
    jtj = part(f, {B, n, n}, 2 * vec);
    norm2 = part(f, {B}, 2 * vec + mat);
    tr = part(f, {B}, 2 * vec + mat + one);
    lam = part(f, {B}, 2 * vec + mat + 2 * one);
    step_count = part(i, {B}, 0);
    n_attempts = part(i, {B}, B);
    reason = part(i, {B}, 2 * B);
  }

  // In SolveResult's order.
  Result result() const {
    return {p, norm2, jtx, jtj, step_count, n_attempts, reason, tr, lam};
  }
};

void* current_stream(const Tensor& p0) {
  const auto* impl = c10::impl::getDeviceGuardImpl(p0.device().type());
  return impl->getStreamNativeHandle(impl->getStream(p0.device()));
}

void check_launch(int err) {
  if (err) {
    throw std::runtime_error("megakernel launch failed: cudaError_t " +
                             std::to_string(err));
  }
}

// Runs `body`, raising a c10::ValueError from it as Python's ValueError.
template <typename F>
Result raising_value_errors(F&& body) {
  try {
    return body();
  } catch (const c10::ValueError& e) {
    throw py::value_error(e.what_without_backtrace());
  }
}

// K1's general instance: p0 (B, 6), meas (B, 100), gx, gy (100,).
Result general(std::uintptr_t entry, std::uintptr_t params, const Tensor& p0,
               const Tensor& meas, const Tensor& gx, const Tensor& gy) {
  return raising_value_errors([&] {
    check_p0(p0, 6);
    const int64_t B = p0.size(0);
    check_input(p0, meas, "meas", {{B, 100}});
    check_input(p0, gx, "gx", {{100}});
    check_input(p0, gy, "gy", {{100}});
    check_cuda(p0);
    const Tensor x = p0.contiguous(), m = meas.contiguous(),
                 X = gx.contiguous(), Y = gy.contiguous();
    Outputs o(x);
    check_launch(reinterpret_cast<GeneralEntry>(entry)(
        x.data_ptr(), m.data_ptr(), X.data_ptr(), Y.data_ptr(), int(B),
        reinterpret_cast<const void*>(params), o.p.data_ptr(),
        o.jtx.data_ptr(), o.jtj.data_ptr(), o.norm2.data_ptr(),
        o.tr.data_ptr(), o.lam.data_ptr(), o.step_count.data_ptr(),
        o.n_attempts.data_ptr(), o.reason.data_ptr(), x.get_device(),
        current_stream(x)));
    return o.result();
  });
}

// K1's factored instance: p0, h_hi, h_lo (B, 6), n2m_hi, n2m_lo (B,) or
// (B, 1), the Gram pair Ghi, Glo (6, 6).
Result factored(std::uintptr_t entry, std::uintptr_t params, const Tensor& p0,
                const Tensor& h_hi, const Tensor& h_lo, const Tensor& n2m_hi,
                const Tensor& n2m_lo, const Tensor& g_hi, const Tensor& g_lo) {
  return raising_value_errors([&] {
    check_p0(p0, 6);
    const int64_t B = p0.size(0);
    check_input(p0, h_hi, "h_hi", {{B, 6}});
    check_input(p0, h_lo, "h_lo", {{B, 6}});
    check_input(p0, n2m_hi, "n2m_hi", {{B}, {B, 1}});
    check_input(p0, n2m_lo, "n2m_lo", {{B}, {B, 1}});
    check_input(p0, g_hi, "Ghi", {{6, 6}});
    check_input(p0, g_lo, "Glo", {{6, 6}});
    check_cuda(p0);
    const Tensor x = p0.contiguous();
    const Tensor in[] = {h_hi.contiguous(),   h_lo.contiguous(),
                         n2m_hi.contiguous(), n2m_lo.contiguous(),
                         g_hi.contiguous(),   g_lo.contiguous()};
    Outputs o(x);
    check_launch(reinterpret_cast<FactoredEntry>(entry)(
        x.data_ptr(), in[0].data_ptr(), in[1].data_ptr(), in[2].data_ptr(),
        in[3].data_ptr(), in[4].data_ptr(), in[5].data_ptr(), int(B),
        reinterpret_cast<const void*>(params), o.p.data_ptr(),
        o.jtx.data_ptr(), o.jtj.data_ptr(), o.norm2.data_ptr(),
        o.tr.data_ptr(), o.lam.data_ptr(), o.step_count.data_ptr(),
        o.n_attempts.data_ptr(), o.reason.data_ptr(), x.get_device(),
        current_stream(x)));
    return o.result();
  });
}

// K1 on a generated functor: p0 (B, nstate), each data leaf (B, ...) with
// data_numel[k] values an element, then the constants, each taken to p0's
// device and dtype where it is not there already; the entry reads the
// inputs' pointers from a host array.
Result generated(std::uintptr_t entry, std::uintptr_t params,
                 const Tensor& p0, int64_t nstate,
                 const std::vector<Tensor>& data,
                 const std::vector<int64_t>& data_numel,
                 const std::vector<Tensor>& consts) {
  return raising_value_errors([&] {
    check_p0(p0, nstate);
    const int64_t B = p0.size(0);
    TORCH_CHECK_VALUE(data.size() == data_numel.size(), "the kernel takes ",
                      data_numel.size(), " problem-data leaves, got ",
                      data.size());
    for (size_t k = 0; k < data.size(); ++k) {
      const Tensor& t = data[k];
      int64_t per_element = 1;
      for (int64_t d = 1; d < t.dim(); ++d) per_element *= t.size(d);
      TORCH_CHECK_VALUE(
          t.dim() >= 1 && t.size(0) == B && per_element == data_numel[k],
          "problem-data leaf ", k, " must be (B, ...) with ", data_numel[k],
          " values an element, got ", shape_str(t.sizes()));
      TORCH_CHECK_VALUE(t.scalar_type() == p0.scalar_type() &&
                            t.device() == p0.device(),
                        "problem-data leaf ", k,
                        " must match p0's dtype and device");
    }
    const size_t n_in = data.size() + consts.size();
    TORCH_CHECK_VALUE(n_in <= size_t(kMaxGeneratedInputs),
                      "a generated kernel reads at most ",
                      kMaxGeneratedInputs, " inputs, got ", n_in);
    check_cuda(p0);
    const Tensor x = p0.contiguous();
    std::vector<Tensor> in;
    in.reserve(n_in);
    for (const Tensor& t : data) in.push_back(t.contiguous());
    for (const Tensor& c : consts) {
      in.push_back(c.device() == x.device() &&
                           c.scalar_type() == x.scalar_type()
                       ? c.contiguous()
                       : c.to(x.options()).contiguous());
    }
    const void* ptrs[kMaxGeneratedInputs] = {};
    for (size_t k = 0; k < n_in; ++k) ptrs[k] = in[k].data_ptr();
    Outputs o(x);
    check_launch(reinterpret_cast<GeneratedEntry>(entry)(
        x.data_ptr(), ptrs, int(B), reinterpret_cast<const void*>(params),
        o.p.data_ptr(), o.jtx.data_ptr(), o.jtj.data_ptr(),
        o.norm2.data_ptr(), o.tr.data_ptr(), o.lam.data_ptr(),
        o.step_count.data_ptr(), o.n_attempts.data_ptr(),
        o.reason.data_ptr(), x.get_device(), current_stream(x)));
    return o.result();
  });
}

}  // namespace

PYBIND11_MODULE(dogleg_launch, m) {
  m.doc() = "K1's host-side launch (libdogleg_tpu_torch/csrc/launch.cpp)";
  m.def("general", &general);
  m.def("factored", &factored);
  m.def("generated", &generated);
}
