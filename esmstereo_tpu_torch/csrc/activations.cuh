// Device-side activations shared by the port's kernels.
//
// Replaces esmstereo_tpu/ops/pallas/activations.py::gelu. The TPU kernels
// carry an Abramowitz-Stegun rational erf only because Mosaic has no erf
// lowering; CUDA has erff, so the exact form here is the plain
// 0.5 x (1 + erf(x / sqrt(2))) that torch.nn.functional.gelu computes.
// Plain PyTorch versions: esmstereo_tpu_torch/ops/kernels/activations.py.
// Build without --use_fast_math: it would swap erff/expf/tanhf for
// approximations the parity tolerances do not allow for.
#pragma once

__device__ __forceinline__ float gelu_exact(float x) {
    return 0.5f * x * (1.0f + erff(x * 0.70710678118654752440f));
}

__device__ __forceinline__ float gelu_tanh(float x) {
    const float k = 0.79788456080286535588f;  // sqrt(2 / pi)
    return 0.5f * x * (1.0f + tanhf(k * (x + 0.044715f * x * x * x)));
}

__device__ __forceinline__ float gelu(float x, bool approximate) {
    return approximate ? gelu_tanh(x) : gelu_exact(x);
}

__device__ __forceinline__ float silu(float x) {
    return x / (1.0f + expf(-x));
}

__device__ __forceinline__ float sigmoid(float x) {
    return 1.0f / (1.0f + expf(-x));
}

__device__ __forceinline__ float relu6(float x) {
    return fminf(fmaxf(x, 0.0f), 6.0f);
}
