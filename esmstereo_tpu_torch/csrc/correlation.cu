// Kernels B and D: the correlation cost volume in its three forms, group-wise
// (gwc, G = 32), group-wise on L2-normalised groups (gwc_norm, G = 32) and
// channel-normalised (norm-correlation, G = 1): in fp32, and each in bf16
// with B's rounding or with D's (the deploy numerics).
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
// The bf16 forms (the deploy numerics) write a bf16 volume from bf16
// descriptors, or, in the normalised forms, from the fp32 normalised maps
// that l2_normalize_groups writes from bf16 descriptors (both JAX kernels
// upcast the descriptors and normalise in fp32, correlation.py:150-164,
// 262-273). They round where the two Pallas kernels round:
//   * B's (kRound, esmstereo_tpu/ops/pallas/correlation.py:114-122): each
//     fp32 product is rounded to bf16 (round to nearest even), the group's
//     rounded products are summed in fp32 and scaled by 1/(C/G), and the
//     result is rounded to bf16. A product of two bf16 values is exact in
//     fp32, and scaling by a power of two is exact, so on the gwc form this
//     equals the Pallas kernel's bf16 dot against the 1/(C/G) group matrix
//     with fp32 accumulation bit for bit; on the normalised forms the fp32
//     sum of 64 rounded products runs in another order than the matrix
//     unit's, which can move the final rounding by one ulp.
//   * D's (!kRound, correlation.py:45-65): the fp32 products are summed
//     unrounded, as its fp32 HIGHEST dot does, and only the store rounds.
// The descriptors are widened to fp32 as they are staged; the volume's
// stores halve. On the L deploy path B reads 8.6 MB and writes 103.6 MB:
// bytes bound it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

// Tin: the descriptors' type (fp32, or bf16 widened as staged); Tout: the
// volume's; kRound: each product rounded to bf16 before the sum (B's bf16
// forms), else fp32 FMA (the fp32 forms, and D's bf16 forms).
template <int C, int G, typename Tin, typename Tout, bool kRound>
__global__ void __launch_bounds__(kTileW * kSplitD)
corr_volume_kernel(const Tin* __restrict__ ref, const Tin* __restrict__ tgt,
                   Tout* __restrict__ out, int H, int W, int D) {
    constexpr int kCpg = C / G;
    extern __shared__ float tsh[];  // [C][kTileW + D - 1]
    const int span = kTileW + D - 1;
    const int w0 = blockIdx.x * kTileW;
    const int h = blockIdx.y;
    const int b = blockIdx.z;
    const size_t plane = (size_t)H * W;
    const Tin* tb = tgt + (size_t)b * C * plane + (size_t)h * W;
    const Tin* rb = ref + (size_t)b * C * plane + (size_t)h * W;

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

    Tout* ob = out + (size_t)b * G * D * plane + (size_t)h * W + w;
    const float inv = 1.0f / kCpg;
    for (int d = threadIdx.y; d < D; d += kSplitD) {
        const int j = threadIdx.x + (D - 1) - d;  // column w - d in the window
        Tout* od = ob + (size_t)d * plane;
#pragma unroll
        for (int g = 0; g < G; ++g) {
            float s = 0.0f;
#pragma unroll
            for (int k = 0; k < kCpg; ++k) {
                const int c = g * kCpg + k;
                if (kRound)
                    s = __fadd_rn(s, __bfloat162float(__float2bfloat16_rn(
                                         __fmul_rn(r[c], tsh[c * span + j]))));
                else
                    s = fmaf(r[c], tsh[c * span + j], s);
            }
            od[(size_t)g * D * plane] = from_float<Tout>(__fmul_rn(s, inv));
        }
    }
}

// x0, x1 -> y0, y1 (blockIdx.y picks the map), each (B, G, cpg, HW); the
// input fp32 or bf16 (widened), the output fp32.
template <typename Tin>
__global__ void __launch_bounds__(256)
l2_normalize_groups_kernel(const Tin* __restrict__ x0,
                           const Tin* __restrict__ x1,
                           float* __restrict__ y0, float* __restrict__ y1,
                           int cpg, int HW, int n) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;  // (b, g, pixel)
    if (i >= n) return;
    const Tin* x = blockIdx.y ? x1 : x0;
    float* y = blockIdx.y ? y1 : y0;
    const size_t base = (size_t)(i / HW) * cpg * HW + i % HW;
    float s = 0.0f;
    for (int k = 0; k < cpg; ++k) {
        const float v = to_float(x[base + (size_t)k * HW]);
        s = fmaf(v, v, s);
    }
    const float den = sqrtf(s) + kEps;
    for (int k = 0; k < cpg; ++k)
        y[base + (size_t)k * HW] = to_float(x[base + (size_t)k * HW]) / den;
}

template <int C, int G, typename Tin, typename Tout, bool kRound>
int launch_volume(const void* ref, const void* tgt, void* out, int B, int H,
                  int W, int D, cudaStream_t stream) {
    const int smem = (int)(sizeof(float) * C * (kTileW + D - 1));
    auto kernel = corr_volume_kernel<C, G, Tin, Tout, kRound>;
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 block(kTileW, kSplitD);
    const dim3 grid((W + kTileW - 1) / kTileW, H, B);
    kernel<<<grid, block, smem, stream>>>(static_cast<const Tin*>(ref),
                                          static_cast<const Tin*>(tgt),
                                          static_cast<Tout*>(out), H, W, D);
    return (int)cudaGetLastError();
}

// The instances of one (C, G): `form` as correlation_volume takes it.
template <int C, int G>
int launch_form(int form, const void* ref, const void* tgt, void* out, int B,
                int H, int W, int D, cudaStream_t stream) {
    using bf16 = __nv_bfloat16;
    switch (form) {
        case 0: return launch_volume<C, G, float, float, false>(
                    ref, tgt, out, B, H, W, D, stream);
        case 1: return launch_volume<C, G, bf16, bf16, true>(
                    ref, tgt, out, B, H, W, D, stream);
        case 2: return launch_volume<C, G, float, bf16, true>(
                    ref, tgt, out, B, H, W, D, stream);
        case 3: return launch_volume<C, G, bf16, bf16, false>(
                    ref, tgt, out, B, H, W, D, stream);
        case 4: return launch_volume<C, G, float, bf16, false>(
                    ref, tgt, out, B, H, W, D, stream);
    }
    return (int)cudaErrorInvalidValue;
}

}  // namespace

// x0, x1: (B, C, H, W) fp32 or, with in_bf16 set, bf16; y0, y1: (B, C, H,
// W) fp32; y = x / (||x_g|| + 1e-5) per pixel and group of C / G channels.
// All contiguous. Returns a cudaError_t.
extern "C" int l2_normalize_groups(const void* x0, const void* x1, float* y0,
                                   float* y1, int B, int C, int G, int H,
                                   int W, int in_bf16, cudaStream_t stream) {
    if (G < 1 || C % G) return (int)cudaErrorInvalidValue;
    const int n = B * G * H * W;
    const dim3 grid((n + 255) / 256, 2);
    if (in_bf16)
        l2_normalize_groups_kernel<__nv_bfloat16><<<grid, 256, 0, stream>>>(
            static_cast<const __nv_bfloat16*>(x0),
            static_cast<const __nv_bfloat16*>(x1), y0, y1, C / G, H * W, n);
    else
        l2_normalize_groups_kernel<float><<<grid, 256, 0, stream>>>(
            static_cast<const float*>(x0), static_cast<const float*>(x1), y0,
            y1, C / G, H * W, n);
    return (int)cudaGetLastError();
}

// ref, tgt: (B, C, H, W) contiguous; out: (B, G, D, H, W) contiguous. form:
//   0  fp32 descriptors (normalised beforehand for gwc_norm and norm), fp32
//      out;
//   1  B's bf16 gwc form: bf16 descriptors, products rounded, bf16 out;
//   2  B's bf16 normalised forms: the fp32 normalised maps, products
//      rounded, bf16 out;
//   3  D's bf16 gwc form: bf16 descriptors, one rounding at the store;
//   4  D's bf16 normalised forms: the fp32 normalised maps, one rounding.
// Returns a cudaError_t; 1 (cudaErrorInvalidValue) for an unsupported
// (C, G, form).
extern "C" int correlation_volume(const void* ref, const void* tgt, void* out,
                                  int B, int C, int G, int H, int W, int D,
                                  int form, cudaStream_t stream) {
    if (C == 64 && G == 32)
        return launch_form<64, 32>(form, ref, tgt, out, B, H, W, D, stream);
    if (C == 64 && G == 1)
        return launch_form<64, 1>(form, ref, tgt, out, B, H, W, D, stream);
    return (int)cudaErrorInvalidValue;
}
