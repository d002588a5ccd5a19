// The direct 3-D convolutions of the cost-volume section, every conv with
// its eval BatchNorm folded into the weights and a GELU epilogue, fp32:
// kernels C and G, E's agg conv and H.
//
// Replaces esmstereo_tpu/ops/pallas/fused_agg_stem.py::folded_stem_agg_apply
// (pallas_call at :295), esmstereo_tpu/attic/fused_hourglass.py::
// fused_down_pair_apply (:299) and ::fused_up_pair_apply (:698) in the
// unfolded (B, C, D, H, W) layout. The wrappers (ops/kernels/
// fused_agg_stem.py, fused_hourglass.py) launch:
//   C:        conv3d k3 s1 p1 (32 -> 8, group_stem), then (8 -> 8, agg);
//   E's agg:  conv3d k3 s1 p1 (8 -> 8) after csrc/fused_volume_agg.cu;
//   G (down): conv3d k3 s2 p1 (CI -> CO), then conv3d k3 s1 p1 (CO -> CO);
//   H (up):   ConvTranspose3d k4 s2 p1 (CI -> CO), computed only on the
//             skip's (D, H, W) grid (the crop); a 1x1x1 conv over
//             [up | skip], read through two pointers so the concat never
//             exists; then conv3d k3 s1 p1 (CO -> CO).
//
// What bounds them on an H100: operations. On the L main path C is about
// 28 GFLOP against 207 MB read and 52 MB written; the hourglass levels are
// 1.4 to 9.9 GFLOP each against at most ~80 MB of inputs and outputs.
//
// Design for that: direct convolutions. A block owns a 32 x 4 (w, h) tile
// of output pixels, a chunk of kDc output depths and kCot output channels;
// each thread owns one (h, w) column and keeps kDc * kCot sums in
// registers. Tiling the output channels by 8 keeps that register count at
// every width (8 to 72 channels) instead of spilling at the wide ones; each
// channel tile reads the input again, from L2. A width that is not a
// multiple of 8 (ESMStereo-S's 12) runs the kernels' masked instances
// (kMasked): the last tile's weight loads read zeros past CO and its
// stores skip those channels. Whole widths (L's and M's) run the unmasked
// instances, whose code is that of widths of 8 only: masking every width
// cost the shared conv 40-60% at L's and M's shapes, at the same register
// counts. The tail tile's 4 idle channels cost a third of the
// 12-channel level's arithmetic, which at S's tiny levels is not what
// bounds it (a narrower instance would be a second kernel to hold).
// Input channels stream through shared memory one at a time as the tile's
// halo slab, beside that channel's weights for the tile. For each input
// channel and (kh, kw) tap of the stride-1 conv a thread loads its kDc+2
// depth values once and reuses each for three kd taps and 8 outputs. The
// transposed conv is written in gather form (each output sums the 2 x 2 x 2
// input taps that reach it), so it needs no atomics and repeats bit for
// bit. No tensor cores: fp32 parity first.
//
// Kernel C's deploy forms (conv3d_k3_bn_gelu_bf16) are instances of the same
// stride-1 conv that compute what the TPU kernel computes with bf16 operands
// (esmstereo_tpu/ops/pallas/fused_agg_stem.py:141-155,189-192): the input is
// bf16 (the volume, or conv1's bf16 output) or int8 (the quantised volume,
// exact in bf16), the weights are bf16 (raw, BN not folded: conv1's times
// the int8 volume's dequantisation scale), each product of two bf16 values
// is exact in fp32 and the sums are fp32, and the epilogue applies the BN
// scale and shift in fp32 (sum * scale, then + shift, each rounded, as the
// plain version's two ops) before GELU and the store in bf16 or fp32. The
// values are widened to fp32 as the tile is staged, so the inner loop is the
// fp32 one; only the bytes of the volume, the intermediate and the output
// shrink. A tensor-core form is later work.
//
// G's and H's deploy forms (bf16 in, bf16 out) are the same kernels with the
// rounding of esmstereo_tpu/attic/fused_hourglass.py's bf16 operands
// (:160,264,289-293 for G, :472,585,616-622,656 for H): raw bf16 weights,
// fp32 sums, the BN scale then the shift in fp32 after each sum, GELU, and
// every intermediate stored in bf16, which is the rounding the TPU kernel
// applies when that intermediate becomes the next matmul's operand. G runs
// the stride-2 and stride-1 instances of conv3d_k3_bn_gelu_bf16; H runs
// hourglass_deconv_bf16, hourglass_conv1x1_cat_bf16 and the stride-1 conv.
// Widths that are not a multiple of 8 (S's 12) take the masked instances.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "activations.cuh"

namespace {

constexpr int kTw = 32;    // output columns per block, one per thread
constexpr int kTh = 4;     // output rows per block
constexpr int kDc = 8;     // output depths per thread
constexpr int kCot = 8;    // output channels per block
constexpr int kThreads = kTw * kTh;
constexpr int kMaxCat = 256;   // input channels of the 1x1x1 conv, at most

// The input slab a 3x3x3 conv of stride S (padding 1) reads for one tile.
template <int S>
struct Slab3 {
    static constexpr int w = S * (kTw - 1) + 3;
    static constexpr int h = S * (kTh - 1) + 3;
    static constexpr int d = S * (kDc - 1) + 3;
};

__device__ __forceinline__ bool inside(int d, int h, int w, int D, int H,
                                       int W) {
    return d >= 0 && d < D && h >= 0 && h < H && w >= 0 && w < W;
}

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
    return __bfloat162float(v);
}
__device__ __forceinline__ float widen(int8_t v) { return (float)v; }

template <typename T>
__device__ __forceinline__ T narrow(float v);
template <>
__device__ __forceinline__ float narrow<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v) {
    return __float2bfloat16_rn(v);
}

// Writes a thread's kDc x kCot sums through the BN (the folded shift, or
// with kScaled the scale then the shift) and GELU; kMasked skips the
// channels past CO.
template <bool kMasked, typename Tout = float, bool kScaled = false>
__device__ __forceinline__ void store_tile(
        const float (&acc)[kDc][kCot], const float* __restrict__ scale,
        const float* __restrict__ shift, Tout* __restrict__ y, int b, int CO,
        int co0, int d0, int h, int w, int D, int H, int W, int approximate) {
    if (h >= H || w >= W) return;
    const bool approx = approximate != 0;
    const size_t plane = (size_t)H * W;
    const size_t vol = (size_t)D * plane;
    Tout* yb = y + ((size_t)b * CO + co0) * vol + (size_t)h * W + w;
#pragma unroll
    for (int dd = 0; dd < kDc; ++dd) {
        const int d = d0 + dd;
        if (d >= D) break;
#pragma unroll
        for (int o = 0; o < kCot; ++o)
            if (!kMasked || co0 + o < CO) {
                const float v = kScaled
                    ? __fadd_rn(__fmul_rn(acc[dd][o], scale[co0 + o]),
                                shift[co0 + o])
                    : acc[dd][o] + shift[co0 + o];
                yb[(size_t)o * vol + (size_t)d * plane] =
                    narrow<Tout>(gelu(v, approx));
            }
    }
}

// conv3d k3, stride S, padding 1: x (B, CI, D, H, W) -> y (B, CO, Do, Ho, Wo).
// wgt: (CO, CI, 3, 3, 3) with the BN scale folded in and shift (CO,), or
// with kScaled the raw weight and the BN's scale and shift (CO,) each.
template <int S, bool kMasked, typename Tin = float, typename Tw = float,
          typename Tout = float, bool kScaled = false>
__global__ void __launch_bounds__(kThreads)
conv3d_k3_kernel(const Tin* __restrict__ x, const Tw* __restrict__ wgt,
                 const float* __restrict__ scale,
                 const float* __restrict__ shift, Tout* __restrict__ y,
                 int CI, int CO, int D, int H, int W, int Do, int Ho, int Wo,
                 int approximate) {
    using SL = Slab3<S>;
    __shared__ float xsh[SL::d * SL::h * SL::w];
    __shared__ float wsh[27 * kCot];   // [tap][o] for this channel tile

    const int tilesW = (Wo + kTw - 1) / kTw;
    const int wo0 = (blockIdx.x % tilesW) * kTw;
    const int ho0 = (blockIdx.x / tilesW) * kTh;
    const int chunksD = (Do + kDc - 1) / kDc;
    const int do0 = (blockIdx.y % chunksD) * kDc;
    const int co0 = (blockIdx.y / chunksD) * kCot;
    const int b = blockIdx.z;
    const int tx = threadIdx.x, ty = threadIdx.y;
    const int tid = ty * kTw + tx;
    // input coordinates of slab index 0 on each axis
    const int di0 = S * do0 - 1, hi0 = S * ho0 - 1, wi0 = S * wo0 - 1;

    float acc[kDc][kCot];
#pragma unroll
    for (int dd = 0; dd < kDc; ++dd)
#pragma unroll
        for (int o = 0; o < kCot; ++o) acc[dd][o] = 0.0f;

    const size_t plane = (size_t)H * W;
    const size_t vol = (size_t)D * plane;
    const Tin* xb = x + (size_t)b * CI * vol;

    for (int ci = 0; ci < CI; ++ci) {
        __syncthreads();  // the previous channel's slab fully consumed
        const Tin* xc = xb + (size_t)ci * vol;
        for (int i = tid; i < SL::d * SL::h * SL::w; i += kThreads) {
            const int sw = i % SL::w;
            const int sh = (i / SL::w) % SL::h;
            const int sd = i / (SL::w * SL::h);
            const int gd = di0 + sd, gh = hi0 + sh, gw = wi0 + sw;
            xsh[i] = inside(gd, gh, gw, D, H, W)
                         ? widen(xc[(size_t)gd * plane + (size_t)gh * W + gw])
                         : 0.0f;
        }
        for (int i = tid; i < 27 * kCot; i += kThreads) {
            const int k = i % 27, o = i / 27;
            wsh[k * kCot + o] = !kMasked || co0 + o < CO
                ? widen(wgt[((size_t)(co0 + o) * CI + ci) * 27 + k]) : 0.0f;
        }
        __syncthreads();
#pragma unroll
        for (int kh = 0; kh < 3; ++kh) {
#pragma unroll
            for (int kw = 0; kw < 3; ++kw) {
                float col[SL::d];
#pragma unroll
                for (int sd = 0; sd < SL::d; ++sd)
                    col[sd] = xsh[(sd * SL::h + S * ty + kh) * SL::w
                                  + S * tx + kw];
#pragma unroll
                for (int kd = 0; kd < 3; ++kd) {
                    const float* wk = wsh + ((kd * 3 + kh) * 3 + kw) * kCot;
                    float wr[kCot];
#pragma unroll
                    for (int o = 0; o < kCot; ++o) wr[o] = wk[o];
#pragma unroll
                    for (int dd = 0; dd < kDc; ++dd)
#pragma unroll
                        for (int o = 0; o < kCot; ++o)
                            acc[dd][o] = fmaf(col[S * dd + kd], wr[o],
                                              acc[dd][o]);
                }
            }
        }
    }
    store_tile<kMasked, Tout, kScaled>(acc, scale, shift, y, b, CO, co0, do0,
                                       ho0 + ty, wo0 + tx, Do, Ho, Wo,
                                       approximate);
}

// ConvTranspose3d k4 s2 p1 in gather form. On one axis, output q sums the
// input positions i with q = 2i - 1 + k, k in [0, 4): for q = 2t, i = t
// (k = 1) and i = t - 1 (k = 3); for q = 2t + 1, i = t + 1 (k = 0) and i = t
// (k = 2). A tile's origin q0 is even and its input slab starts at
// q0 / 2 - 1, so tap j in {0, 1} of the output at p = q - q0, of parity
// par = p & 1, reads slab index p / 2 + 1 + par - j with kernel tap
// k = 2j + 1 - par.
constexpr int kUw = kTw / 2 + 2;
constexpr int kUh = kTh / 2 + 2;
constexpr int kUd = kDc / 2 + 2;

// x (B, CI, Ds, Hs, Ws) -> y (B, CO, D2, H2, W2), the transposed conv's
// (2 Ds, 2 Hs, 2 Ws) output cropped to its leading D2 x H2 x W2 corner.
// wgt: (CI, CO, 4, 4, 4) with the BN scale folded in; shift: (CO,).
// The deploy form (Tin, Tw, Tout bf16, kScaled): the raw weight, the BN's
// scale and shift (CO,) each.
template <bool kMasked, typename Tin = float, typename Tw = float,
          typename Tout = float, bool kScaled = false>
__global__ void __launch_bounds__(kThreads)
deconv3d_k4s2_kernel(const Tin* __restrict__ x, const Tw* __restrict__ wgt,
                     const float* __restrict__ scale,
                     const float* __restrict__ shift, Tout* __restrict__ y,
                     int CI, int CO, int Ds, int Hs, int Ws, int D2, int H2,
                     int W2, int approximate) {
    __shared__ float xsh[kUd * kUh * kUw];
    __shared__ float wsh[64 * kCot];   // [tap][o] for this channel tile

    const int tilesW = (W2 + kTw - 1) / kTw;
    const int wo0 = (blockIdx.x % tilesW) * kTw;
    const int ho0 = (blockIdx.x / tilesW) * kTh;
    const int chunksD = (D2 + kDc - 1) / kDc;
    const int do0 = (blockIdx.y % chunksD) * kDc;
    const int co0 = (blockIdx.y / chunksD) * kCot;
    const int b = blockIdx.z;
    const int tx = threadIdx.x, ty = threadIdx.y;
    const int tid = ty * kTw + tx;
    const int di0 = do0 / 2 - 1, hi0 = ho0 / 2 - 1, wi0 = wo0 / 2 - 1;
    const int parh = ty & 1, parw = tx & 1;

    float acc[kDc][kCot];
#pragma unroll
    for (int dd = 0; dd < kDc; ++dd)
#pragma unroll
        for (int o = 0; o < kCot; ++o) acc[dd][o] = 0.0f;

    const size_t plane = (size_t)Hs * Ws;
    const size_t vol = (size_t)Ds * plane;
    const Tin* xb = x + (size_t)b * CI * vol;

    for (int ci = 0; ci < CI; ++ci) {
        __syncthreads();
        const Tin* xc = xb + (size_t)ci * vol;
        for (int i = tid; i < kUd * kUh * kUw; i += kThreads) {
            const int sw = i % kUw;
            const int sh = (i / kUw) % kUh;
            const int sd = i / (kUw * kUh);
            const int gd = di0 + sd, gh = hi0 + sh, gw = wi0 + sw;
            xsh[i] = inside(gd, gh, gw, Ds, Hs, Ws)
                ? widen(xc[(size_t)gd * plane + (size_t)gh * Ws + gw])
                : 0.0f;
        }
        for (int i = tid; i < 64 * kCot; i += kThreads) {
            const int k = i % 64, o = i / 64;
            wsh[k * kCot + o] = !kMasked || co0 + o < CO
                ? widen(wgt[((size_t)ci * CO + co0 + o) * 64 + k]) : 0.0f;
        }
        __syncthreads();
#pragma unroll
        for (int jh = 0; jh < 2; ++jh) {
            const int sh = ty / 2 + 1 + parh - jh;
            const int kh = 2 * jh + 1 - parh;
#pragma unroll
            for (int jw = 0; jw < 2; ++jw) {
                const int sw = tx / 2 + 1 + parw - jw;
                const int kw = 2 * jw + 1 - parw;
                float col[kUd];
#pragma unroll
                for (int sd = 0; sd < kUd; ++sd)
                    col[sd] = xsh[(sd * kUh + sh) * kUw + sw];
#pragma unroll
                for (int par = 0; par < 2; ++par) {
#pragma unroll
                    for (int jd = 0; jd < 2; ++jd) {
                        const int kd = 2 * jd + 1 - par;
                        const float* wk = wsh + ((kd * 4 + kh) * 4 + kw) * kCot;
                        float wr[kCot];
#pragma unroll
                        for (int o = 0; o < kCot; ++o) wr[o] = wk[o];
#pragma unroll
                        for (int dd = par; dd < kDc; dd += 2)
#pragma unroll
                            for (int o = 0; o < kCot; ++o)
                                acc[dd][o] = fmaf(col[dd / 2 + 1 + par - jd],
                                                  wr[o], acc[dd][o]);
                    }
                }
            }
        }
    }
    store_tile<kMasked, Tout, kScaled>(acc, scale, shift, y, b, CO, co0, do0,
                                       ho0 + ty, wo0 + tx, D2, H2, W2,
                                       approximate);
}

// 1x1x1 conv over the channel concat [up | skip], each (B, CO, N) with N
// voxels: y = GELU(wgt[:, :CO] up + wgt[:, CO:] skip + shift). wgt: (CO, 2 CO)
// with the BN scale folded in. One thread per voxel and kCot outputs; the
// loads of a warp are 32 neighbouring voxels of one channel.
// The deploy form (T, Tw bf16, kScaled): the raw weight, the BN's scale and
// shift.
template <bool kMasked, typename T = float, typename Tw = float,
          bool kScaled = false>
__global__ void __launch_bounds__(256)
conv1x1_cat_kernel(const T* __restrict__ up, const T* __restrict__ skip,
                   const Tw* __restrict__ wgt,
                   const float* __restrict__ scale,
                   const float* __restrict__ shift, T* __restrict__ y,
                   int CO, int N, int approximate) {
    __shared__ float wsh[kMaxCat * kCot];   // [input channel][o]
    const int co0 = blockIdx.y * kCot;
    const int b = blockIdx.z;
    const int cin = 2 * CO;
    for (int i = threadIdx.x; i < cin * kCot; i += blockDim.x) {
        const int c = i % cin, o = i / cin;
        wsh[c * kCot + o] = !kMasked || co0 + o < CO
            ? widen(wgt[(size_t)(co0 + o) * cin + c]) : 0.0f;
    }
    __syncthreads();
    const int v = blockIdx.x * blockDim.x + threadIdx.x;
    if (v >= N) return;

    float acc[kCot];
#pragma unroll
    for (int o = 0; o < kCot; ++o) acc[o] = 0.0f;
    const T* halves[2] = {up + (size_t)b * CO * N + v,
                          skip + (size_t)b * CO * N + v};
#pragma unroll
    for (int half = 0; half < 2; ++half) {
        const T* src = halves[half];
        const float* wh = wsh + half * CO * kCot;
        for (int c = 0; c < CO; ++c) {
            const float a = widen(src[(size_t)c * N]);
#pragma unroll
            for (int o = 0; o < kCot; ++o)
                acc[o] = fmaf(a, wh[c * kCot + o], acc[o]);
        }
    }
    const bool approx = approximate != 0;
    T* yb = y + ((size_t)b * CO + co0) * N + v;
#pragma unroll
    for (int o = 0; o < kCot; ++o)
        if (!kMasked || co0 + o < CO) {
            const float s = kScaled
                ? __fadd_rn(__fmul_rn(acc[o], scale[co0 + o]), shift[co0 + o])
                : acc[o] + shift[co0 + o];
            yb[(size_t)o * N] = narrow<T>(gelu(s, approx));
        }
}

}  // namespace

// All tensors fp32 and contiguous. Each entry point returns a cudaError_t:
// cudaErrorInvalidValue for shapes it does not take.

static int channel_tiles(int CO) { return (CO + kCot - 1) / kCot; }

// x: (B, CI, D, H, W); wgt: (CO, CI, 3, 3, 3); shift: (CO,);
// y: (B, CO, (D-1)/stride+1, (H-1)/stride+1, (W-1)/stride+1).
extern "C" int conv3d_k3_bn_gelu(const float* x, const float* wgt,
                                 const float* shift, float* y, int B, int CI,
                                 int CO, int D, int H, int W, int stride,
                                 int approximate, cudaStream_t stream) {
    if (CO < 1 || CI < 1 || (stride != 1 && stride != 2))
        return (int)cudaErrorInvalidValue;
    const int Do = (D - 1) / stride + 1;
    const int Ho = (H - 1) / stride + 1;
    const int Wo = (W - 1) / stride + 1;
    const dim3 grid(((Wo + kTw - 1) / kTw) * ((Ho + kTh - 1) / kTh),
                    ((Do + kDc - 1) / kDc) * channel_tiles(CO), B);
    const dim3 block(kTw, kTh);
    auto kernel = stride == 1
        ? (CO % kCot ? conv3d_k3_kernel<1, true> : conv3d_k3_kernel<1, false>)
        : (CO % kCot ? conv3d_k3_kernel<2, true> : conv3d_k3_kernel<2, false>);
    kernel<<<grid, block, 0, stream>>>(x, wgt, nullptr, shift, y, CI, CO, D,
                                       H, W, Do, Ho, Wo, approximate);
    return (int)cudaGetLastError();
}

namespace {

template <int S, bool kMasked, typename Tin, typename Tout>
int launch_conv3d_bf16(const void* x, const void* wgt, const float* scale,
                       const float* shift, void* y, int B, int CI, int CO,
                       int D, int H, int W, int approximate,
                       cudaStream_t stream) {
    const int Do = (D - 1) / S + 1, Ho = (H - 1) / S + 1, Wo = (W - 1) / S + 1;
    const dim3 grid(((Wo + kTw - 1) / kTw) * ((Ho + kTh - 1) / kTh),
                    ((Do + kDc - 1) / kDc) * channel_tiles(CO), B);
    const dim3 block(kTw, kTh);
    conv3d_k3_kernel<S, kMasked, Tin, __nv_bfloat16, Tout, true>
        <<<grid, block, 0, stream>>>(
            static_cast<const Tin*>(x), static_cast<const __nv_bfloat16*>(wgt),
            scale, shift, static_cast<Tout*>(y), CI, CO, D, H, W, Do, Ho, Wo,
            approximate);
    return (int)cudaGetLastError();
}

}  // namespace

// The deploy forms of the direct conv3d k3 p1. x: (B, CI, D, H, W) bf16
// (in_type 0) or int8 (in_type 1); wgt: (CO, CI, 3, 3, 3) bf16, raw; scale,
// shift: (CO,) fp32, the eval BN; y: (B, CO, Do, Ho, Wo) bf16 (out_type 0)
// or fp32 (out_type 1). Instances: bf16 -> bf16 at stride 1 or 2 and any
// CO (kernels C, E's agg, G and H); bf16 -> fp32 and int8 -> either at
// stride 1 with CO a multiple of 8 (kernel C's other forms).
extern "C" int conv3d_k3_bn_gelu_bf16(const void* x, const void* wgt,
                                      const float* scale, const float* shift,
                                      void* y, int B, int CI, int CO, int D,
                                      int H, int W, int stride, int in_type,
                                      int out_type, int approximate,
                                      cudaStream_t stream) {
    if (CO < 1 || CI < 1) return (int)cudaErrorInvalidValue;
    using bf16 = __nv_bfloat16;
    const bool masked = CO % kCot != 0;
    if (in_type == 0 && out_type == 0) {
        if (stride == 1)
            return masked
                ? launch_conv3d_bf16<1, true, bf16, bf16>(
                      x, wgt, scale, shift, y, B, CI, CO, D, H, W,
                      approximate, stream)
                : launch_conv3d_bf16<1, false, bf16, bf16>(
                      x, wgt, scale, shift, y, B, CI, CO, D, H, W,
                      approximate, stream);
        if (stride == 2)
            return masked
                ? launch_conv3d_bf16<2, true, bf16, bf16>(
                      x, wgt, scale, shift, y, B, CI, CO, D, H, W,
                      approximate, stream)
                : launch_conv3d_bf16<2, false, bf16, bf16>(
                      x, wgt, scale, shift, y, B, CI, CO, D, H, W,
                      approximate, stream);
        return (int)cudaErrorInvalidValue;
    }
    if (stride != 1 || masked) return (int)cudaErrorInvalidValue;
    if (in_type == 0 && out_type == 1)
        return launch_conv3d_bf16<1, false, bf16, float>(
            x, wgt, scale, shift, y, B, CI, CO, D, H, W, approximate, stream);
    if (in_type == 1 && out_type == 0)
        return launch_conv3d_bf16<1, false, int8_t, bf16>(
            x, wgt, scale, shift, y, B, CI, CO, D, H, W, approximate, stream);
    if (in_type == 1 && out_type == 1)
        return launch_conv3d_bf16<1, false, int8_t, float>(
            x, wgt, scale, shift, y, B, CI, CO, D, H, W, approximate, stream);
    return (int)cudaErrorInvalidValue;
}

// x: (B, CI, Ds, Hs, Ws); wgt: (CI, CO, 4, 4, 4); shift: (CO,);
// y: (B, CO, D2, H2, W2) with D2 <= 2 Ds, H2 <= 2 Hs, W2 <= 2 Ws.
extern "C" int hourglass_deconv(const float* x, const float* wgt,
                                const float* shift, float* y, int B, int CI,
                                int CO, int Ds, int Hs, int Ws, int D2, int H2,
                                int W2, int approximate, cudaStream_t stream) {
    if (CO < 1 || CI < 1 || D2 > 2 * Ds || H2 > 2 * Hs || W2 > 2 * Ws)
        return (int)cudaErrorInvalidValue;
    const dim3 grid(((W2 + kTw - 1) / kTw) * ((H2 + kTh - 1) / kTh),
                    ((D2 + kDc - 1) / kDc) * channel_tiles(CO), B);
    const dim3 block(kTw, kTh);
    auto kernel = CO % kCot ? deconv3d_k4s2_kernel<true>
                            : deconv3d_k4s2_kernel<false>;
    kernel<<<grid, block, 0, stream>>>(x, wgt, nullptr, shift, y, CI, CO, Ds,
                                       Hs, Ws, D2, H2, W2, approximate);
    return (int)cudaGetLastError();
}

// H's deploy form of the transposed conv: x bf16, wgt (CI, CO, 4, 4, 4) bf16
// raw, scale and shift (CO,) fp32, y bf16; shapes as hourglass_deconv.
extern "C" int hourglass_deconv_bf16(const void* x, const void* wgt,
                                     const float* scale, const float* shift,
                                     void* y, int B, int CI, int CO, int Ds,
                                     int Hs, int Ws, int D2, int H2, int W2,
                                     int approximate, cudaStream_t stream) {
    if (CO < 1 || CI < 1 || D2 > 2 * Ds || H2 > 2 * Hs || W2 > 2 * Ws)
        return (int)cudaErrorInvalidValue;
    using bf16 = __nv_bfloat16;
    const dim3 grid(((W2 + kTw - 1) / kTw) * ((H2 + kTh - 1) / kTh),
                    ((D2 + kDc - 1) / kDc) * channel_tiles(CO), B);
    const dim3 block(kTw, kTh);
    auto kernel = CO % kCot ? deconv3d_k4s2_kernel<true, bf16, bf16, bf16, true>
                            : deconv3d_k4s2_kernel<false, bf16, bf16, bf16, true>;
    kernel<<<grid, block, 0, stream>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(wgt), scale,
        shift, static_cast<bf16*>(y), CI, CO, Ds, Hs, Ws, D2, H2, W2,
        approximate);
    return (int)cudaGetLastError();
}

// up, skip, y: (B, CO, N); wgt: (CO, 2 CO); shift: (CO,).
extern "C" int hourglass_conv1x1_cat(const float* up, const float* skip,
                                     const float* wgt, const float* shift,
                                     float* y, int B, int CO, int N,
                                     int approximate, cudaStream_t stream) {
    if (CO < 1 || 2 * CO > kMaxCat || N < 1)
        return (int)cudaErrorInvalidValue;
    const dim3 grid((N + 255) / 256, channel_tiles(CO), B);
    auto kernel = CO % kCot ? conv1x1_cat_kernel<true>
                            : conv1x1_cat_kernel<false>;
    kernel<<<grid, 256, 0, stream>>>(up, skip, wgt, nullptr, shift, y, CO, N,
                                     approximate);
    return (int)cudaGetLastError();
}

// H's deploy form of the 1x1x1 conv: up, skip, y bf16; wgt (CO, 2 CO) bf16
// raw; scale and shift (CO,) fp32.
extern "C" int hourglass_conv1x1_cat_bf16(const void* up, const void* skip,
                                          const void* wgt, const float* scale,
                                          const float* shift, void* y, int B,
                                          int CO, int N, int approximate,
                                          cudaStream_t stream) {
    if (CO < 1 || 2 * CO > kMaxCat || N < 1)
        return (int)cudaErrorInvalidValue;
    using bf16 = __nv_bfloat16;
    const dim3 grid((N + 255) / 256, channel_tiles(CO), B);
    auto kernel = CO % kCot ? conv1x1_cat_kernel<true, bf16, bf16, true>
                            : conv1x1_cat_kernel<false, bf16, bf16, true>;
    kernel<<<grid, 256, 0, stream>>>(
        static_cast<const bf16*>(up), static_cast<const bf16*>(skip),
        static_cast<const bf16*>(wgt), scale, shift, static_cast<bf16*>(y),
        CO, N, approximate);
    return (int)cudaGetLastError();
}
