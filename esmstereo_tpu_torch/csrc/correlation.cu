// Kernels B and D: the correlation cost volume, fp32, in its three forms:
// group-wise (gwc, G = 32), group-wise on L2-normalised groups (gwc_norm,
// G = 32) and channel-normalised (norm-correlation, G = 1).
//
// Replaces esmstereo_tpu/ops/pallas/correlation.py::correlation_volume_folded
// (kernel B, pallas_call at :218) and ::correlation_volume (kernel D, :298).
// Computes
//     out[b, g, d, h, w] = mean_{c in group g} ref[b, c, h, w] * tgt[b, c, h, w - d]
// and 0 where w < d, from NCHW features (B, C, H, W) into the (B, G, D, H, W)
// layout the 3-D convs read. That is D's unfolded (B, D, H, W, G) volume with
// the G axis moved ahead, and B's depth-folded one unfolded (the TPU kernels'
// lane layouts are not ported). With normalize, each pixel's channel groups
// are first scaled to x / (||x_g|| + 1e-5), as both JAX kernels do outside
// their pallas_call (correlation.py:159-164,268-273): l2_normalize_groups
// writes the two normalised maps into scratch, then the volume kernel runs.
//
// What bounds it on an H100: bytes. On the L gwc path (C=64, G=32, D=48,
// 136 x 248 at /4) it reads 17 MB and writes 207 MB against 0.2 GFLOP of
// products; on the M paths (D=24, 68 x 124) the gwc volume is 26 MB and the
// norm-correlation one 0.8 MB (bound_ms in chip_smoke.py).
//
// Design for that: one block per (b, h, 64-column tile); the block stages the
// target window of all C channels, columns [w0 - (D-1), w0 + 64), in shared
// memory (zeros outside the image, which also makes w < d vanish), each
// thread keeps its reference pixel's C channels in registers, and the
// threadIdx.y rows split the D shifts. Every store of a warp is 32 neighbouring
// floats of one (g, d, h) row, so the volume is written once, coalesced, and
// never read back. The group mean multiplies the fp32 sum by 1/(C/G) (exact
// for the power-of-two group sizes the model uses). The normalisation is one
// thread per (map, b, g, pixel): the sum of squares in channel order, sqrtf,
// and a true division, each load of a warp 32 neighbouring pixels.
#include <cuda_runtime.h>

namespace {

constexpr int kTileW = 64;
constexpr int kSplitD = 4;
constexpr float kEps = 1e-5f;

template <int C, int G>
__global__ void __launch_bounds__(kTileW * kSplitD)
corr_volume_kernel(const float* __restrict__ ref, const float* __restrict__ tgt,
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

// x0, x1 -> y0, y1 (blockIdx.y picks the map), each (B, G, cpg, HW).
__global__ void __launch_bounds__(256)
l2_normalize_groups_kernel(const float* __restrict__ x0,
                           const float* __restrict__ x1,
                           float* __restrict__ y0, float* __restrict__ y1,
                           int cpg, int HW, int n) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;  // (b, g, pixel)
    if (i >= n) return;
    const float* x = blockIdx.y ? x1 : x0;
    float* y = blockIdx.y ? y1 : y0;
    const size_t base = (size_t)(i / HW) * cpg * HW + i % HW;
    float s = 0.0f;
    for (int k = 0; k < cpg; ++k) {
        const float v = x[base + (size_t)k * HW];
        s = fmaf(v, v, s);
    }
    const float den = sqrtf(s) + kEps;
    for (int k = 0; k < cpg; ++k)
        y[base + (size_t)k * HW] = x[base + (size_t)k * HW] / den;
}

template <int C, int G>
int launch_volume(const float* ref, const float* tgt, float* out, int B, int H,
                  int W, int D, int smem, cudaStream_t stream) {
    const cudaError_t err = cudaFuncSetAttribute(
        corr_volume_kernel<C, G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 block(kTileW, kSplitD);
    const dim3 grid((W + kTileW - 1) / kTileW, H, B);
    corr_volume_kernel<C, G><<<grid, block, smem, stream>>>(ref, tgt, out, H,
                                                            W, D);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int correlation_volume_smem_bytes(int C, int D) {
    return (int)(sizeof(float) * C * (kTileW + D - 1));
}

// x0, x1, y0, y1: (B, C, H, W) fp32 contiguous; y = x / (||x_g|| + 1e-5) per
// pixel and group of C / G channels. Returns a cudaError_t.
extern "C" int l2_normalize_groups(const float* x0, const float* x1, float* y0,
                                   float* y1, int B, int C, int G, int H,
                                   int W, cudaStream_t stream) {
    if (G < 1 || C % G) return (int)cudaErrorInvalidValue;
    const int n = B * G * H * W;
    const dim3 grid((n + 255) / 256, 2);
    l2_normalize_groups_kernel<<<grid, 256, 0, stream>>>(x0, x1, y0, y1, C / G,
                                                         H * W, n);
    return (int)cudaGetLastError();
}

// ref, tgt: (B, C, H, W) fp32 contiguous (normalised beforehand for the
// gwc_norm and norm-correlation forms); out: (B, G, D, H, W) fp32 contiguous.
// Returns a cudaError_t; 1 (cudaErrorInvalidValue) for an unsupported (C, G).
extern "C" int correlation_volume(const float* ref, const float* tgt,
                                  float* out, int B, int C, int G, int H,
                                  int W, int D, cudaStream_t stream) {
    const int smem = correlation_volume_smem_bytes(C, D);
    if (C == 64 && G == 32)
        return launch_volume<64, 32>(ref, tgt, out, B, H, W, D, smem, stream);
    if (C == 64 && G == 1)
        return launch_volume<64, 1>(ref, tgt, out, B, H, W, D, smem, stream);
    return (int)cudaErrorInvalidValue;
}
