// Kernel E: the correlation volume built inside group_stem (corr_stem for
// norm-correlation), fp32. The (B, G, D, H, W) volume is never written to
// device memory.
//
// Replaces esmstereo_tpu/ops/pallas/fused_agg_stem.py::
// folded_volume_stem_agg_apply (pallas_call at :486), in its gwc form (G = 32)
// and its norm-correlation form (G = 1, normalised), in the unfolded layout.
// The wrapper (ops/kernels/fused_agg_stem.py::volume_stem_agg) launches, for
// the normalised form, kernel B's l2_normalize_groups (csrc/correlation.cu)
// into scratch, as JAX E normalises outside its pallas_call
// (fused_agg_stem.py:359-364); then this kernel, which builds each block's
// volume slab in shared memory from the descriptors and applies group_stem
// (G -> 8 channels, 3x3x3, BN folded, GELU), writing the 8-channel
// intermediate; then kernel C's 8 -> 8 conv (csrc/fused_hourglass.cu) for agg.
// The volume is, as in kernel B (csrc/correlation.cu),
//     V[b, g, d, h, w] = mean_{c in group g} ref[b, c, h, w] * tgt[b, c, h, w - d]
// with 0 where w < d, and the conv's zero padding outside the volume.
//
// What bounds it on an H100: operations. On the L gwc path (D=48 at
// 136 x 248) group_stem is 27 * 32 * 8 multiply-adds per voxel, about
// 22 GFLOP, against 2 x 8.6 MB of descriptors read and 52 MB written; the
// volume build adds 2 multiply-adds per volume entry. Kernels B + C move the
// 207 MB volume twice for the same result. At G = 1 group_stem is only
// 27 * 8 multiply-adds per voxel and the volume build 64 per entry.
//
// Design for that: a direct conv on the tile of csrc/fused_hourglass.cu,
// with the volume slab built in place of the load. Each block owns a 32 x 4
// (w, h) tile of output pixels and a chunk of kDc output depths, for all 8
// outputs, with every group's weights staged once; each thread owns one
// (h, w) column and keeps kDc * 8 sums in registers. For each group the
// block stages the group's reference channels over the tile plus a 1-pixel
// halo, and its target channels over the columns w - d that the slab's
// (d, w) pairs reach (B's target window, cut to the depth chunk), at most
// kChunk channels at a time: a G = 1 group's 64 channels staged whole would
// take about 118 KB, far above the 48 KB of static shared memory. Each chunk
// adds its products to the (kDc+2) x 6 x 34 slab's sums in shared memory,
// continuing each sum in channel order, so the slab holds B's arithmetic
// (fp32 products summed in channel order, times 1/(C/G)) bit for bit; the
// gwc group (2 channels) is a single chunk. The 27 taps then run over the
// slab.
//
// The bf16 form (the deploy numerics) computes what the TPU kernel computes
// on bf16 descriptors (fused_agg_stem.py:448-453 there): each fp32 product
// rounded to bf16, the group's rounded products summed in fp32 and scaled by
// 1/(C/G), and the entry rounded to bf16, which is kernel B's bf16 volume
// (csrc/correlation.cu, form 1, or 2 on the normalised fp32 maps) entry for
// entry; then group_stem on the raw bf16 weight with the BN's scale and
// shift after the fp32 sum, as kernel C's bf16 form, writing the 8-channel
// intermediate in bf16. The descriptors are widened as they are staged, so
// the loops are the fp32 ones; E's bf16 form equals B's bf16 form followed by
// C's, without the 103.6 MB bf16 volume at L.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "activations.cuh"

namespace {

constexpr int kTw = 32;
constexpr int kTh = 4;
constexpr int kDc = 8;
constexpr int kSw = kTw + 2;
constexpr int kSh = kTh + 2;
constexpr int kSd = kDc + 2;
// target columns over the slab: w - d for w in [w0-1, w0+kTw+1) and
// d in [d0-1, d0+kDc+1); slab entry (sd, sw) reads column sw - sd + kSd - 1
constexpr int kTgtW = kSw + kSd - 1;
constexpr int kMaxChunk = 8;   // channels of a group staged at once

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
    return __bfloat162float(v);
}
__device__ __forceinline__ float round_bf16(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
}

// Tin: the descriptors' type; kLow: the bf16 form (Tw, Tout bf16, products
// and entries rounded, BN scale after the sum), else fp32 throughout.
template <int C, int G, int CO, typename Tin, typename Tw, typename Tout,
          bool kLow>
__global__ void __launch_bounds__(kTw * kTh)
volume_group_stem_kernel(const Tin* __restrict__ ref,
                         const Tin* __restrict__ tgt,
                         const Tw* __restrict__ wgt,
                         const float* __restrict__ scale,
                         const float* __restrict__ shift,
                         Tout* __restrict__ y, int D, int H, int W,
                         int approximate) {
    // wgt: [CO][G][27] (BN scale folded, or raw with kLow); scale, shift:
    // [CO]; wsh: [G][27][CO]
    constexpr int kCpg = C / G;
    constexpr int kChunk = kCpg < kMaxChunk ? kCpg : kMaxChunk;
    static_assert(kCpg % kChunk == 0, "a group splits into whole chunks");
    constexpr int kThreads = kTw * kTh;
    __shared__ float wsh[G * 27 * CO];
    __shared__ float rsh[kChunk * kSh * kSw];
    __shared__ float tsh[kChunk * kSh * kTgtW];
    __shared__ float vsh[kSd * kSh * kSw];

    const int tilesW = (W + kTw - 1) / kTw;
    const int w0 = (blockIdx.x % tilesW) * kTw;
    const int h0 = (blockIdx.x / tilesW) * kTh;
    const int d0 = blockIdx.y * kDc;
    const int b = blockIdx.z;
    const int tx = threadIdx.x, ty = threadIdx.y;
    const int tid = ty * kTw + tx;
    // least target column over the slab: w = w0 - 1, d = d0 + kDc
    const int tw0 = w0 - 1 - (d0 + kDc);

    for (int i = tid; i < G * 27 * CO; i += kThreads)
        wsh[i] = widen(wgt[(i % CO) * (G * 27) + i / CO]);

    float acc[kDc][CO];
#pragma unroll
    for (int dd = 0; dd < kDc; ++dd)
#pragma unroll
        for (int o = 0; o < CO; ++o) acc[dd][o] = 0.0f;

    const size_t plane = (size_t)H * W;
    const Tin* rb = ref + (size_t)b * C * plane;
    const Tin* tb = tgt + (size_t)b * C * plane;
    const float inv = 1.0f / kCpg;

    for (int g = 0; g < G; ++g) {
        for (int k0 = 0; k0 < kCpg; k0 += kChunk) {
            // previous chunk (or the previous group's slab) fully consumed,
            // and the weights loaded
            __syncthreads();
            const int c0 = g * kCpg + k0;
            for (int i = tid; i < kChunk * kSh * kSw; i += kThreads) {
                const int sw = i % kSw;
                const int sh = (i / kSw) % kSh;
                const int k = i / (kSw * kSh);
                const int gh = h0 - 1 + sh, gw = w0 - 1 + sw;
                rsh[i] = (gh >= 0 && gh < H && gw >= 0 && gw < W)
                             ? widen(rb[(size_t)(c0 + k) * plane
                                        + (size_t)gh * W + gw])
                             : 0.0f;
            }
            for (int i = tid; i < kChunk * kSh * kTgtW; i += kThreads) {
                const int tw = i % kTgtW;
                const int sh = (i / kTgtW) % kSh;
                const int k = i / (kTgtW * kSh);
                const int gh = h0 - 1 + sh, gw = tw0 + tw;
                // columns left of the image are the zeros that make w < d
                // vanish
                tsh[i] = (gh >= 0 && gh < H && gw >= 0 && gw < W)
                             ? widen(tb[(size_t)(c0 + k) * plane
                                        + (size_t)gh * W + gw])
                             : 0.0f;
            }
            __syncthreads();
            const bool last = k0 + kChunk == kCpg;
            // each thread owns the same slab entries in every chunk
            for (int i = tid; i < kSd * kSh * kSw; i += kThreads) {
                const int sw = i % kSw;
                const int sh = (i / kSw) % kSh;
                const int sd = i / (kSw * kSh);
                const int gd = d0 - 1 + sd, gh = h0 - 1 + sh,
                          gw = w0 - 1 + sw;
                float v = 0.0f;   // the conv's zero padding outside the volume
                if (gd >= 0 && gd < D && gh >= 0 && gh < H && gw >= 0
                        && gw < W) {
                    float s = k0 == 0 ? 0.0f : vsh[i];
#pragma unroll
                    for (int k = 0; k < kChunk; ++k) {
                        const float r = rsh[(k * kSh + sh) * kSw + sw];
                        const float t =
                            tsh[(k * kSh + sh) * kTgtW + sw - sd + kSd - 1];
                        s = kLow ? __fadd_rn(s, round_bf16(__fmul_rn(r, t)))
                                 : fmaf(r, t, s);
                    }
                    v = !last ? s
                        : kLow ? round_bf16(__fmul_rn(s, inv)) : s * inv;
                }
                vsh[i] = v;
            }
        }
        __syncthreads();
        const float* wc = wsh + g * 27 * CO;
#pragma unroll
        for (int kh = 0; kh < 3; ++kh) {
#pragma unroll
            for (int kw = 0; kw < 3; ++kw) {
                float col[kSd];
#pragma unroll
                for (int sd = 0; sd < kSd; ++sd)
                    col[sd] = vsh[(sd * kSh + ty + kh) * kSw + tx + kw];
#pragma unroll
                for (int kd = 0; kd < 3; ++kd) {
                    const float* wk = wc + ((kd * 3 + kh) * 3 + kw) * CO;
                    float wr[CO];
#pragma unroll
                    for (int o = 0; o < CO; ++o) wr[o] = wk[o];
#pragma unroll
                    for (int dd = 0; dd < kDc; ++dd)
#pragma unroll
                        for (int o = 0; o < CO; ++o)
                            acc[dd][o] = fmaf(col[dd + kd], wr[o], acc[dd][o]);
                }
            }
        }
    }

    const int h = h0 + ty, w = w0 + tx;
    if (h >= H || w >= W) return;
    const bool approx = approximate != 0;
    const size_t vol = (size_t)D * plane;
    Tout* yb = y + (size_t)b * CO * vol + (size_t)h * W + w;
#pragma unroll
    for (int dd = 0; dd < kDc; ++dd) {
        const int d = d0 + dd;
        if (d >= D) break;
#pragma unroll
        for (int o = 0; o < CO; ++o) {
            const float v = kLow
                ? __fadd_rn(__fmul_rn(acc[dd][o], scale[o]), shift[o])
                : acc[dd][o] + shift[o];
            put(yb + (size_t)o * vol + (size_t)d * plane, gelu(v, approx));
        }
    }
}

template <int C, int G, typename Tin, typename Tw, typename Tout, bool kLow>
int launch(const void* ref, const void* tgt, const void* wgt,
           const float* scale, const float* shift, void* y, int B, int D,
           int H, int W, int approximate, cudaStream_t stream) {
    const int tiles = ((W + kTw - 1) / kTw) * ((H + kTh - 1) / kTh);
    const dim3 grid(tiles, (D + kDc - 1) / kDc, B);
    const dim3 block(kTw, kTh);
    volume_group_stem_kernel<C, G, 8, Tin, Tw, Tout, kLow>
        <<<grid, block, 0, stream>>>(
            static_cast<const Tin*>(ref), static_cast<const Tin*>(tgt),
            static_cast<const Tw*>(wgt), scale, shift, static_cast<Tout*>(y),
            D, H, W, approximate);
    return (int)cudaGetLastError();
}

// The instances of one (C, G): form 0 fp32; 1 the bf16 form on bf16
// descriptors (gwc); 2 the bf16 form on the fp32 normalised maps.
template <int C, int G>
int launch_form(int form, const void* ref, const void* tgt, const void* wgt,
                const float* scale, const float* shift, void* y, int B, int D,
                int H, int W, int approximate, cudaStream_t stream) {
    using bf16 = __nv_bfloat16;
    switch (form) {
        case 0: return launch<C, G, float, float, float, false>(
                    ref, tgt, wgt, scale, shift, y, B, D, H, W, approximate,
                    stream);
        case 1: return launch<C, G, bf16, bf16, bf16, true>(
                    ref, tgt, wgt, scale, shift, y, B, D, H, W, approximate,
                    stream);
        case 2: return launch<C, G, float, bf16, bf16, true>(
                    ref, tgt, wgt, scale, shift, y, B, D, H, W, approximate,
                    stream);
    }
    return (int)cudaErrorInvalidValue;
}

}  // namespace

// ref, tgt: (B, C, H, W), normalised beforehand for norm-correlation (fp32
// maps); y: (B, CO, D, H, W); all contiguous. form 0: fp32 descriptors, wgt
// (CO, G, 3, 3, 3) fp32 with the BN scale folded in, scale unused, shift
// (CO,), fp32 y; form 1: bf16 descriptors, form 2: the fp32 normalised maps
// of bf16 descriptors, both with wgt bf16 raw, the BN's scale and shift
// (CO,) fp32, and bf16 y. Returns a cudaError_t; cudaErrorInvalidValue for
// an unsupported (C, G, CO, form).
extern "C" int volume_group_stem(const void* ref, const void* tgt,
                                 const void* wgt, const float* scale,
                                 const float* shift, void* y, int B, int C,
                                 int G, int CO, int D, int H, int W,
                                 int form, int approximate,
                                 cudaStream_t stream) {
    if (CO != 8 || D < 1) return (int)cudaErrorInvalidValue;
    if (C == 64 && G == 32)
        return launch_form<64, 32>(form, ref, tgt, wgt, scale, shift, y, B,
                                   D, H, W, approximate, stream);
    if (C == 64 && G == 1)
        return launch_form<64, 1>(form, ref, tgt, wgt, scale, shift, y, B, D,
                                  H, W, approximate, stream);
    return (int)cudaErrorInvalidValue;
}
