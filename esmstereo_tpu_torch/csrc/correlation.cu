// Kernel B: group-wise correlation cost volume, fp32.
//
// Replaces esmstereo_tpu/ops/pallas/correlation.py::correlation_volume_folded
// (pallas_call at :218). Computes
//     out[b, g, d, h, w] = mean_{c in group g} ref[b, c, h, w] * tgt[b, c, h, w - d]
// and 0 where w < d, from NCHW features (B, C, H, W) into the (B, G, D, H, W)
// layout the 3-D convs read (the TPU kernel's d-major lane folding is a TPU
// layout and is not ported).
//
// What bounds it on an H100: bytes. On the L main path (C=64, G=32, D=48,
// 136 x 248 at /4) it reads 17 MB and writes 207 MB against 0.2 GFLOP of
// products: some 20 times more time at the memory rate than at the fp32
// rate (bound_ms in chip_smoke.py).
//
// Design for that: one block per (b, h, 64-column tile); the block stages the
// target window of all C channels, columns [w0 - (D-1), w0 + 64), in shared
// memory (zeros outside the image, which also makes w < d vanish), each
// thread keeps its reference pixel's C channels in registers, and the
// threadIdx.y rows split the D shifts. Every store of a warp is 32 neighbouring
// floats of one (g, d, h) row, so the volume is written once, coalesced, and
// never read back. The group mean multiplies the fp32 sum by 1/(C/G) (exact
// for the power-of-two group sizes the model uses).
#include <cuda_runtime.h>

namespace {

constexpr int kTileW = 64;
constexpr int kSplitD = 4;

template <int C, int G>
__global__ void __launch_bounds__(kTileW * kSplitD)
gwc_volume_kernel(const float* __restrict__ ref, const float* __restrict__ tgt,
                  float* __restrict__ out, int H, int W, int D) {
    constexpr int kCpg = C / G;
    extern __shared__ float tsh[];  // [C][kTileW + D - 1]
    const int span = kTileW + D - 1;
    const int w0 = blockIdx.x * kTileW;
    const int h = blockIdx.y;
    const int b = blockIdx.z;
    const size_t plane = (size_t)H * W;
    const float* tb = tgt + (size_t)b * C * plane + (size_t)h * W;
    const float* rb = ref + (size_t)b * C * plane + (size_t)h * W;

    const int tid = threadIdx.y * kTileW + threadIdx.x;
    for (int i = tid; i < C * span; i += kTileW * kSplitD) {
        const int c = i / span;
        const int ws = w0 - (D - 1) + (i - c * span);
        tsh[i] = (ws >= 0 && ws < W) ? tb[(size_t)c * plane + ws] : 0.0f;
    }
    const int w = w0 + threadIdx.x;
    float r[C];
#pragma unroll
    for (int c = 0; c < C; ++c) r[c] = (w < W) ? rb[(size_t)c * plane + w] : 0.0f;
    __syncthreads();
    if (w >= W) return;

    float* ob = out + (size_t)b * G * D * plane + (size_t)h * W + w;
    const float inv = 1.0f / kCpg;
    for (int d = threadIdx.y; d < D; d += kSplitD) {
        const int j = threadIdx.x + (D - 1) - d;  // column w - d in the window
        float* od = ob + (size_t)d * plane;
#pragma unroll
        for (int g = 0; g < G; ++g) {
            float s = 0.0f;
#pragma unroll
            for (int k = 0; k < kCpg; ++k) {
                const int c = g * kCpg + k;
                s = fmaf(r[c], tsh[c * span + j], s);
            }
            od[(size_t)g * D * plane] = s * inv;
        }
    }
}

}  // namespace

extern "C" int gwc_volume_smem_bytes(int C, int D) {
    return (int)(sizeof(float) * C * (kTileW + D - 1));
}

// ref, tgt: (B, C, H, W) fp32 contiguous; out: (B, G, D, H, W) fp32 contiguous.
// Returns a cudaError_t; 1 (cudaErrorInvalidValue) for an unsupported (C, G).
extern "C" int gwc_volume(const float* ref, const float* tgt, float* out,
                          int B, int C, int G, int H, int W, int D,
                          cudaStream_t stream) {
    const dim3 block(kTileW, kSplitD);
    const dim3 grid((W + kTileW - 1) / kTileW, H, B);
    const int smem = gwc_volume_smem_bytes(C, D);
    if (C != 64 || G != 32) return (int)cudaErrorInvalidValue;
    const cudaError_t err = cudaFuncSetAttribute(
        gwc_volume_kernel<64, 32>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    gwc_volume_kernel<64, 32><<<grid, block, smem, stream>>>(ref, tgt, out, H, W, D);
    return (int)cudaGetLastError();
}
