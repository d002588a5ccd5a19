// The CUDA kernels of the esmstereo:: operators: kernel A (fused_stage0),
// kernel B (correlation_volume) and the conv3d k3 p1 that kernel C launches
// twice (conv3d_bn_gelu in fp32, conv3d_bn_gelu_bf16 in the deploy forms),
// so that an exported graph (torch.export, AOTInductor) can hold their
// launches, which a ctypes call on raw pointers cannot.
//
// Replaces no TPU kernel of its own: each op calls the C entry point of
// fused_head.cu, correlation.cu or fused_hourglass.cu, whose kernels replace
// esmstereo_tpu/ops/pallas/fused_head.py::fused_stage0_apply,
// correlation.py::correlation_volume_folded and fused_agg_stem.py::
// folded_stem_agg_apply. It adds no device code, so what bounds a call is
// its kernel's; the op adds a host-side check and the allocations.
//
// The schemas are not defined here: Python defines them from the table of
// ops/kernels/torch_ops.py, and a process without Python loads the
// definitions library generated from the same table. Each op:
//   * checks what its kernel takes (device, dtype, contiguity, shapes, and
//     that the plan Python computed describes these tensors) and raises on
//     anything else, with no plain fallback;
//   * allocates its output and scratch with at::empty on the input's device;
//   * launches on the current stream and raises on a CUDA error;
//   * counts its launches, readable without Python (esmstereo_op_launches).

#include <atomic>
#include <cstdint>
#include <initializer_list>
#include <vector>

#include <ATen/core/Tensor.h>
#include <ATen/ops/empty.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>
#include <cuda_runtime_api.h>
#include <torch/library.h>

// The C entry points, as fused_head.cu, correlation.cu and
// fused_hourglass.cu define them (tests/test_torch_export.py holds the two
// lists of parameter types equal).
extern "C" int stage0_params_size(int form);
extern "C" int fused_stage0(int form, const float* img, const float* params,
                            void* out, float* ws, int B, int Hi, int Wi,
                            int out_bf16, int grid, int threads, int smem,
                            long long ws_floats, cudaStream_t stream);
extern "C" int correlation_volume(const void* ref, const void* tgt, void* out,
                                  int B, int C, int G, int H, int W, int D,
                                  int form, int normalize, const int* plan,
                                  cudaStream_t stream);
extern "C" int conv3d_k3_bn_gelu(const float* x, const float* wgt,
                                 const float* shift, float* y,
                                 const int* plan, cudaStream_t stream);
extern "C" int conv3d_k3_bn_gelu_bf16(const void* x, const void* wgt,
                                      const float* scale, const float* shift,
                                      void* y, const int* plan,
                                      cudaStream_t stream);

namespace {

// the ops in the order of torch_ops.py's SCHEMAS
enum Op { kStage0, kCorrelation, kConv, kConvBf16, kOps };
const char* const kNames[kOps] = {"fused_stage0", "correlation_volume",
                                  "conv3d_bn_gelu", "conv3d_bn_gelu_bf16"};
std::atomic<long long> g_launches[kOps];

cudaStream_t current_stream() {
    return c10::cuda::getCurrentCUDAStream().stream();
}

void check_launch(int err, Op op) {
    TORCH_CHECK(err == 0, "esmstereo::", kNames[op], ": CUDA error ", err);
    ++g_launches[op];
}

void check_tensor(const at::Tensor& t, const char* name, Op op,
                  std::initializer_list<at::ScalarType> dtypes) {
    TORCH_CHECK(t.is_cuda(), "esmstereo::", kNames[op], ": ", name,
                " is not a CUDA tensor");
    TORCH_CHECK(t.is_contiguous(), "esmstereo::", kNames[op], ": ", name,
                " is not contiguous");
    bool ok = false;
    for (auto d : dtypes) ok = ok || t.scalar_type() == d;
    TORCH_CHECK(ok, "esmstereo::", kNames[op], ": ", name, " is ",
                t.scalar_type(), ", which the kernel does not take");
}

// plan as the C entry points take it (int), checked to fit int
std::vector<int> plan_ints(at::IntArrayRef plan, size_t n, Op op) {
    TORCH_CHECK(plan.size() == n, "esmstereo::", kNames[op], ": a plan of ",
                n, " ints, got ", plan.size());
    std::vector<int> out;
    for (int64_t v : plan) {
        TORCH_CHECK(v >= 0 && v <= INT32_MAX, "esmstereo::", kNames[op],
                    ": plan entry ", v);
        out.push_back(static_cast<int>(v));
    }
    return out;
}

at::Tensor fused_stage0_cuda(const at::Tensor& img, const at::Tensor& params,
                             int64_t form, bool out_bf16,
                             at::IntArrayRef plan) {
    check_tensor(img, "img", kStage0, {at::kFloat});
    check_tensor(params, "params", kStage0, {at::kFloat});
    TORCH_CHECK(img.dim() == 4 && img.size(1) == 3 && img.size(2) % 2 == 0
                    && img.size(3) % 2 == 0,
                "esmstereo::fused_stage0: image ", img.sizes());
    const at::ScalarType out_dtype = out_bf16 ? at::kBFloat16 : at::kFloat;
    const int size = stage0_params_size(static_cast<int>(form));
    TORCH_CHECK(size >= 0 && params.numel() == size,
                "esmstereo::fused_stage0: form ", form, " reads ", size,
                " packed parameters, got ", params.numel());
    // (grid, threads, smem, workspace floats): fused_head.py::stage0_plan;
    // the entry point refuses any other for these shapes
    TORCH_CHECK(plan.size() == 4, "esmstereo::fused_stage0: a plan of 4 "
                "ints, got ", plan.size());
    const c10::cuda::CUDAGuard guard(img.device());
    const int64_t b = img.size(0), h = img.size(2), w = img.size(3);
    at::Tensor ws = at::empty({plan[3]}, img.options());
    at::Tensor out = at::empty({b, 16, h / 2, w / 2},
                               img.options().dtype(out_dtype));
    check_launch(fused_stage0(static_cast<int>(form), img.data_ptr<float>(),
                              params.data_ptr<float>(), out.data_ptr(),
                              ws.data_ptr<float>(), b, h, w, out_bf16,
                              static_cast<int>(plan[0]),
                              static_cast<int>(plan[1]),
                              static_cast<int>(plan[2]), plan[3],
                              current_stream()),
                 kStage0);
    return out;
}

at::Tensor correlation_volume_cuda(const at::Tensor& ref,
                                   const at::Tensor& tgt, int64_t max_disp,
                                   int64_t num_groups, bool normalize,
                                   bool round_products,
                                   at::IntArrayRef plan) {
    check_tensor(ref, "ref", kCorrelation, {at::kFloat, at::kBFloat16});
    check_tensor(tgt, "tgt", kCorrelation, {ref.scalar_type()});
    TORCH_CHECK(ref.dim() == 4 && ref.sizes() == tgt.sizes() && max_disp >= 1
                    && num_groups >= 1 && ref.size(1) % num_groups == 0,
                "esmstereo::correlation_volume: descriptors ", ref.sizes(),
                " and ", tgt.sizes(), ", D ", max_disp, ", G ", num_groups);
    // correlation.py's volume forms: fp32; B's bf16 rounding, gwc or
    // normalised; D's
    const int form = ref.scalar_type() == at::kFloat ? 0
                     : round_products ? (normalize ? 2 : 1)
                                      : (normalize ? 4 : 3);
    // (columns, thread rows, shared bytes): correlation.py::corr_plan
    const std::vector<int> ints = plan_ints(plan, 3, kCorrelation);
    const c10::cuda::CUDAGuard guard(ref.device());
    const int64_t b = ref.size(0), c = ref.size(1), h = ref.size(2),
                  w = ref.size(3);
    at::Tensor out = at::empty({b, num_groups, max_disp, h, w},
                               ref.options());
    check_launch(correlation_volume(ref.data_ptr(), tgt.data_ptr(),
                                    out.data_ptr(), b, c, num_groups, h, w,
                                    max_disp, form, normalize, ints.data(),
                                    current_stream()),
                 kCorrelation);
    return out;
}

// The conv's plan (fused_hourglass.py::ConvPlan.ints): B, CI, CO, D, H, W,
// stride, in_type, out_type, tile_h, tile_d, groups, cluster, smem,
// approximate, k_chunk. The kernel reads the shapes from it, so it must
// describe these tensors.
std::vector<int> conv_plan(const at::Tensor& x, const at::Tensor& w,
                           int64_t stride, bool approximate, int in_type,
                           int out_type, at::IntArrayRef plan, Op op) {
    TORCH_CHECK(x.dim() == 5 && w.dim() == 5 && w.size(1) == x.size(1)
                    && w.size(2) == 3 && w.size(3) == 3 && w.size(4) == 3,
                "esmstereo::", kNames[op], ": input ", x.sizes(),
                ", weight ", w.sizes());
    std::vector<int> ints = plan_ints(plan, 16, op);
    const int64_t want[9] = {x.size(0), x.size(1), w.size(0), x.size(2),
                             x.size(3), x.size(4), stride, in_type,
                             out_type};
    for (int i = 0; i < 9; ++i)
        TORCH_CHECK(ints[i] == want[i], "esmstereo::", kNames[op],
                    ": plan entry ", i, " is ", ints[i], ", the call's ",
                    want[i]);
    TORCH_CHECK(ints[14] == static_cast<int>(approximate), "esmstereo::",
                kNames[op], ": the plan's GELU form is not the call's");
    return ints;
}

at::Tensor conv_output(const at::Tensor& x, const at::Tensor& w,
                       int64_t stride, at::ScalarType dtype) {
    auto out = [stride](int64_t n) { return (n - 1) / stride + 1; };
    return at::empty({x.size(0), w.size(0), out(x.size(2)), out(x.size(3)),
                      out(x.size(4))},
                     x.options().dtype(dtype));
}

at::Tensor conv3d_bn_gelu_cuda(const at::Tensor& x, const at::Tensor& w,
                               const at::Tensor& t, int64_t stride,
                               bool approximate, at::IntArrayRef plan) {
    check_tensor(x, "x", kConv, {at::kFloat});
    check_tensor(w, "w", kConv, {at::kFloat});
    check_tensor(t, "t", kConv, {at::kFloat});
    const std::vector<int> ints =
        conv_plan(x, w, stride, approximate, 2, 2, plan, kConv);
    TORCH_CHECK(t.dim() == 1 && t.size(0) == w.size(0),
                "esmstereo::conv3d_bn_gelu: shift ", t.sizes());
    const c10::cuda::CUDAGuard guard(x.device());
    at::Tensor y = conv_output(x, w, stride, at::kFloat);
    check_launch(conv3d_k3_bn_gelu(x.data_ptr<float>(), w.data_ptr<float>(),
                                   t.data_ptr<float>(), y.data_ptr<float>(),
                                   ints.data(), current_stream()),
                 kConv);
    return y;
}

at::Tensor conv3d_bn_gelu_bf16_cuda(const at::Tensor& x, const at::Tensor& w,
                                    const at::Tensor& scale,
                                    const at::Tensor& shift, bool out_fp32,
                                    int64_t stride, bool approximate,
                                    at::IntArrayRef plan) {
    check_tensor(x, "x", kConvBf16, {at::kBFloat16, at::kChar});
    check_tensor(w, "w", kConvBf16, {at::kBFloat16});
    check_tensor(scale, "scale", kConvBf16, {at::kFloat});
    check_tensor(shift, "shift", kConvBf16, {at::kFloat});
    const at::ScalarType out_dtype = out_fp32 ? at::kFloat : at::kBFloat16;
    TORCH_CHECK(scale.dim() == 1 && shift.dim() == 1
                    && scale.size(0) == w.size(0)
                    && shift.size(0) == w.size(0),
                "esmstereo::conv3d_bn_gelu_bf16: scale ", scale.sizes(),
                ", shift ", shift.sizes());
    // fused_hourglass.py::FORMS: input and output dtype codes
    const std::vector<int> ints = conv_plan(
        x, w, stride, approximate, x.scalar_type() == at::kChar ? 1 : 0,
        out_fp32 ? 1 : 0, plan, kConvBf16);
    const c10::cuda::CUDAGuard guard(x.device());
    at::Tensor y = conv_output(x, w, stride, out_dtype);
    check_launch(conv3d_k3_bn_gelu_bf16(x.data_ptr(), w.data_ptr(),
                                        scale.data_ptr<float>(),
                                        shift.data_ptr<float>(), y.data_ptr(),
                                        ints.data(), current_stream()),
                 kConvBf16);
    return y;
}

}  // namespace

TORCH_LIBRARY_IMPL(esmstereo, CUDA, m) {
    m.impl("fused_stage0", &fused_stage0_cuda);
    m.impl("correlation_volume", &correlation_volume_cuda);
    m.impl("conv3d_bn_gelu", &conv3d_bn_gelu_cuda);
    m.impl("conv3d_bn_gelu_bf16", &conv3d_bn_gelu_bf16_cuda);
}

// The launch counters, for a process without Python (the serving runner)
// and for Python through ctypes.
extern "C" int esmstereo_ops_count() { return kOps; }

extern "C" const char* esmstereo_op_name(int op) {
    return op >= 0 && op < kOps ? kNames[op] : nullptr;
}

extern "C" long long esmstereo_op_launches(int op) {
    return op >= 0 && op < kOps ? g_launches[op].load() : -1;
}

extern "C" void esmstereo_reset_op_launches() {
    for (auto& n : g_launches) n = 0;
}
