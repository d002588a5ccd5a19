// The deploy numerics' bf16 activations, each as jax.nn writes it and
// rounding to bf16 after every op, in one launch: GELU (tanh and erf
// forms), SiLU, sigmoid, and softmax over one dim.
//
// Replaces no TPU kernel. The JAX package leaves these ops to XLA, and the
// JAX reference the port is held to compiles them with
// xla_allow_excess_precision=False, which rounds each op's bf16 result
// (XLA expands lax.logistic into 1 / (1 + exp(-x))). torch's own functions
// evaluate a bf16 tensor in fp32 and round once; the same per-op roundings
// in torch would take 4-9 elementwise launches an activation. Plain
// version: esmstereo_tpu_torch/ops/kernels/activations.py::
// activation_bf16_plain, the same formulas as torch ops on bf16 tensors;
// the model takes this kernel under nn.blocks.set_bf16_per_op(True).
//
//   gelu_tanh  x * (0.5 * (1 + tanh(c * (x + k * (x * x * x)))))
//   gelu_erf   (0.5 * x) * erfc(-x * sqrt(1/2))
//   silu       x * sigmoid(x)
//   sigmoid    1 / (1 + exp(-x))
//   softmax    e = exp(x - max(x)); e / sum(e), the sum in fp32 in index
//              order, rounded once
//
// Every product, sum and function value is computed in fp32 from bf16
// values and rounded to nearest even (__float2bfloat16_rn), as torch and
// XLA compute a bf16 op on the CPU. The constants are bf16 values, as a
// weak-typed Python float meeting a bf16 array is rounded: c = 0.796875
// (sqrt(2/pi)), k = 0.044677734375 (0.044715), 0.70703125 (sqrt(1/2))
// (tests/test_torch_volume_plan.py holds them to the Python ones).
// CUDA's tanhf, expf and erfcf (no --use_fast_math) may differ from the
// CPU's by an fp32 ulp, which moves a result only at a bf16 midpoint.
//
// What bounds it on an H100: bytes (2 read and 2 written a value, a few
// dozen flops). Design for that: the elementwise forms take 8 values (16
// bytes) a thread where the pointers are 16-byte aligned and the count a
// multiple of 8, else one; the softmax takes one thread per (outer, inner)
// position, neighbouring threads on neighbouring addresses, and walks the
// normalised dim three times (max, sum, store; the exp recomputed, as it
// rounds alike), the tensor read from L2 after the first pass.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr float kSqrt2OverPi = 0.796875f;
constexpr float kGeluCubic = 0.044677734375f;
constexpr float kSqrtHalf = 0.70703125f;
constexpr int kThreads = 256;

__device__ __forceinline__ float rb(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float sigmoid_op(float x) {
    const float e = rb(expf(-x));
    return rb(1.0f / rb(1.0f + e));
}

// one bf16 value x (as fp32) through activation kCode, each op rounded
template <int kCode>
__device__ __forceinline__ float act(float x) {
    if constexpr (kCode == 0) {
        float a = rb(x * x);
        a = rb(a * x);
        a = rb(kGeluCubic * a);
        a = rb(x + a);
        a = rb(kSqrt2OverPi * a);
        float u = rb(tanhf(a));
        u = rb(1.0f + u);
        u = rb(0.5f * u);
        return rb(x * u);
    } else if constexpr (kCode == 1) {
        const float h = rb(0.5f * x);
        const float e = rb(erfcf(rb(-x * kSqrtHalf)));
        return rb(h * e);
    } else if constexpr (kCode == 2) {
        return rb(x * sigmoid_op(x));
    } else {
        return sigmoid_op(x);
    }
}

template <int kCode>
__global__ void __launch_bounds__(kThreads)
elementwise_kernel(const __nv_bfloat16* __restrict__ x,
                   __nv_bfloat16* __restrict__ y, int count, bool vec) {
    const int stride = gridDim.x * blockDim.x;
    const int t = blockIdx.x * blockDim.x + threadIdx.x;
    if (vec) {
        const uint4* xv = reinterpret_cast<const uint4*>(x);
        uint4* yv = reinterpret_cast<uint4*>(y);
        for (int i = t; i < count / 8; i += stride) {
            uint4 v = xv[i];
            __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&v);
#pragma unroll
            for (int j = 0; j < 8; ++j)
                e[j] = __float2bfloat16_rn(act<kCode>(__bfloat162float(e[j])));
            yv[i] = v;
        }
        return;
    }
    for (int i = t; i < count; i += stride)
        y[i] = __float2bfloat16_rn(act<kCode>(__bfloat162float(x[i])));
}

// x, y: (outer, n, inner); thread (o, j) normalises x[o, :, j]
__global__ void __launch_bounds__(kThreads)
softmax_kernel(const __nv_bfloat16* __restrict__ x,
               __nv_bfloat16* __restrict__ y, int outer, int n, int inner) {
    const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (p >= (long long)outer * inner) return;
    const int o = (int)(p / inner), j = (int)(p % inner);
    const size_t base = (size_t)o * n * inner + j;
    float m = -INFINITY;
    for (int i = 0; i < n; ++i)
        m = fmaxf(m, __bfloat162float(x[base + (size_t)i * inner]));
    float s = 0.0f;
    for (int i = 0; i < n; ++i)
        s += rb(expf(rb(__bfloat162float(x[base + (size_t)i * inner]) - m)));
    s = rb(s);
    for (int i = 0; i < n; ++i) {
        const float e =
            rb(expf(rb(__bfloat162float(x[base + (size_t)i * inner]) - m)));
        y[base + (size_t)i * inner] = __float2bfloat16_rn(e / s);
    }
}

template <int kCode>
int launch_elementwise(const __nv_bfloat16* x, __nv_bfloat16* y, int count,
                       cudaStream_t stream) {
    const bool vec = count % 8 == 0
        && (reinterpret_cast<uintptr_t>(x) % 16) == 0
        && (reinterpret_cast<uintptr_t>(y) % 16) == 0;
    const int items = vec ? count / 8 : count;
    int blocks = (items + kThreads - 1) / kThreads;
    if (blocks > 132 * 16) blocks = 132 * 16;   // a grid-stride loop past that
    elementwise_kernel<kCode><<<blocks, kThreads, 0, stream>>>(x, y, count,
                                                               vec);
    return (int)cudaGetLastError();
}

}  // namespace

// x, y: bf16, contiguous, viewed as (outer, n, inner). code 0 gelu_tanh,
// 1 gelu_erf, 2 silu, 3 sigmoid (elementwise over outer * n * inner
// values), 4 softmax over n. Returns a cudaError_t; cudaErrorInvalidValue
// for an unknown code or a count of 2**31 or more.
extern "C" int activation_bf16(const void* x, void* y, int code, int outer,
                               int n, int inner, cudaStream_t stream) {
    if (outer < 1 || n < 1 || inner < 1) return (int)cudaErrorInvalidValue;
    const long long total = (long long)outer * n * inner;
    if (total >= (1LL << 31)) return (int)cudaErrorInvalidValue;
    const auto* xb = static_cast<const __nv_bfloat16*>(x);
    auto* yb = static_cast<__nv_bfloat16*>(y);
    const int count = (int)total;
    switch (code) {
        case 0: return launch_elementwise<0>(xb, yb, count, stream);
        case 1: return launch_elementwise<1>(xb, yb, count, stream);
        case 2: return launch_elementwise<2>(xb, yb, count, stream);
        case 3: return launch_elementwise<3>(xb, yb, count, stream);
        case 4: {
            const long long rows = (long long)outer * inner;
            softmax_kernel<<<(int)((rows + kThreads - 1) / kThreads),
                             kThreads, 0, stream>>>(xb, yb, outer, n, inner);
            return (int)cudaGetLastError();
        }
    }
    return (int)cudaErrorInvalidValue;
}
