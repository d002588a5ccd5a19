// Kernels B and D: the correlation cost volume, fp32, in its three forms:
// group-wise (gwc, G = 32), group-wise on L2-normalised groups (gwc_norm,
// G = 32) and channel-normalised (norm-correlation, G = 1); and the gwc form
// on bf16 descriptors, B's deploy form.
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
//
// The bf16 form (T = __nv_bfloat16) computes what B's bf16 branch computes
// (esmstereo_tpu/ops/pallas/correlation.py:114-122): each product of two
// bf16 values is exact in fp32 and is rounded to bf16 (round to nearest
// even), the group's rounded products are summed in fp32 and scaled by
// 1/(C/G), and the result is rounded to bf16. Scaling by a power of two is
// exact, so this equals the Pallas kernel's bf16 dot against the 1/(C/G)
// group matrix with fp32 accumulation, bit for bit. The descriptors are
// widened to fp32 as they are staged; the volume's stores halve. On the L
// deploy path it reads 8.6 MB and writes 103.6 MB: bytes bound it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kTileW = 64;
constexpr int kSplitD = 4;
constexpr float kEps = 1e-5f;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
    return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
    return __float2bfloat16_rn(v);
}

template <int C, int G, typename T>
__global__ void __launch_bounds__(kTileW * kSplitD)
corr_volume_kernel(const T* __restrict__ ref, const T* __restrict__ tgt,
                   T* __restrict__ out, int H, int W, int D) {
    constexpr bool kBf16 = !std::is_same<T, float>::value;
    constexpr int kCpg = C / G;
    extern __shared__ float tsh[];  // [C][kTileW + D - 1]
    const int span = kTileW + D - 1;
    const int w0 = blockIdx.x * kTileW;
    const int h = blockIdx.y;
    const int b = blockIdx.z;
    const size_t plane = (size_t)H * W;
    const T* tb = tgt + (size_t)b * C * plane + (size_t)h * W;
    const T* rb = ref + (size_t)b * C * plane + (size_t)h * W;

    const int tid = threadIdx.y * kTileW + threadIdx.x;
    for (int i = tid; i < C * span; i += kTileW * kSplitD) {
        const int c = i / span;
        const int ws = w0 - (D - 1) + (i - c * span);
        tsh[i] = (ws >= 0 && ws < W) ? to_float(tb[(size_t)c * plane + ws])
                                     : 0.0f;
    }
    const int w = w0 + threadIdx.x;
    float r[C];
#pragma unroll
    for (int c = 0; c < C; ++c)
        r[c] = (w < W) ? to_float(rb[(size_t)c * plane + w]) : 0.0f;
    __syncthreads();
    if (w >= W) return;

    T* ob = out + (size_t)b * G * D * plane + (size_t)h * W + w;
    const float inv = 1.0f / kCpg;
    for (int d = threadIdx.y; d < D; d += kSplitD) {
        const int j = threadIdx.x + (D - 1) - d;  // column w - d in the window
        T* od = ob + (size_t)d * plane;
#pragma unroll
        for (int g = 0; g < G; ++g) {
            float s = 0.0f;
#pragma unroll
            for (int k = 0; k < kCpg; ++k) {
                const int c = g * kCpg + k;
                if (kBf16)
                    s = __fadd_rn(s, __bfloat162float(__float2bfloat16_rn(
                                         __fmul_rn(r[c], tsh[c * span + j]))));
                else
                    s = fmaf(r[c], tsh[c * span + j], s);
            }
            od[(size_t)g * D * plane] = from_float<T>(__fmul_rn(s, inv));
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

template <int C, int G, typename T>
int launch_volume(const void* ref, const void* tgt, void* out, int B, int H,
                  int W, int D, int smem, cudaStream_t stream) {
    const cudaError_t err = cudaFuncSetAttribute(
        corr_volume_kernel<C, G, T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 block(kTileW, kSplitD);
    const dim3 grid((W + kTileW - 1) / kTileW, H, B);
    corr_volume_kernel<C, G, T><<<grid, block, smem, stream>>>(
        static_cast<const T*>(ref), static_cast<const T*>(tgt),
        static_cast<T*>(out), H, W, D);
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

// ref, tgt: (B, C, H, W) contiguous, fp32 (normalised beforehand for the
// gwc_norm and norm-correlation forms) or, with bf16 set, bf16; out:
// (B, G, D, H, W) contiguous in the same type. Returns a cudaError_t; 1
// (cudaErrorInvalidValue) for an unsupported (C, G, type).
extern "C" int correlation_volume(const void* ref, const void* tgt, void* out,
                                  int B, int C, int G, int H, int W, int D,
                                  int bf16, cudaStream_t stream) {
    const int smem = correlation_volume_smem_bytes(C, D);
    if (C == 64 && G == 32 && bf16)
        return launch_volume<64, 32, __nv_bfloat16>(ref, tgt, out, B, H, W, D,
                                                    smem, stream);
    if (bf16) return (int)cudaErrorInvalidValue;
    if (C == 64 && G == 32)
        return launch_volume<64, 32, float>(ref, tgt, out, B, H, W, D, smem,
                                            stream);
    if (C == 64 && G == 1)
        return launch_volume<64, 1, float>(ref, tgt, out, B, H, W, D, smem,
                                           stream);
    return (int)cudaErrorInvalidValue;
}
