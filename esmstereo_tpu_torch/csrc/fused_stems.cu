// Kernel F: the stem_2 + stem_4 matching towers, fp32. Each StemBlock is
//   conv3x3 stride 2 pad 1 + folded BN + GELU   (conv_down)
//   conv3x3 stride 1 pad 1 + folded BN + ReLU   (conv)
// with 3 -> 32 channels (stem_2, at 1/2) and 32 -> 48 (stem_4, at 1/4) in
// ESMStereo-L and -M, or 3 -> 16 and 16 -> 24 in ESMStereo-S.
//
// Replaces esmstereo_tpu/ops/pallas/fused_stems.py::fused_stems_apply
// (pallas_call at :302). The TPU kernel splits the image into row-parity
// planes and runs every conv as block-diagonal matmuls; none of that is
// carried over. What it keeps out of device memory is each StemBlock's
// conv_down output, and so does this kernel: one launch per StemBlock, and
// the conv_down map of a tile lives only in shared memory.
//
// What bounds it on an H100: operations. Both eyes at 544x992 are 5.05 G
// multiply-adds (10.1 GFLOP, 0.151 ms at 67 TFLOP/s fp32) against 13 MB
// read and 47.5 MB written (0.018 ms at 3.35 TB/s). At S's widths: 1.33 G
// multiply-adds (0.040 ms) against 13 MB read and 22.7 MB written (0.011
// ms).
//
// Design for that: a block owns an 8 x 32 tile of one StemBlock's output.
//   1. It computes conv_down over the tile plus a 1-px halo (10 x 34 px,
//      all channels) into shared memory, with GELU, and zero outside the
//      map (the padding of the second conv). The input reaches shared
//      memory in chunks of CC channels as the tile's 21 x 69 stride-2
//      window, even columns and odd columns apart, so that the 32 lanes of
//      a warp read 32 neighbouring words for every tap. A thread owns up to
//      4 of the 340 halo pixels and K1 channels (16, or 8 where C is not a
//      multiple of 16), and reuses each weight vector (a broadcast float4)
//      for its pixels. The halo costs (10 * 34) / (8 * 32) = 1.33x of the
//      smaller conv of the pair.
//   2. It runs the stride-1 conv from shared memory. A thread owns 4 rows
//      of one column and C/4 output channels (4 to 12; 16 to 48 sums): for
//      each input channel and column tap it loads 6 values once and reuses
//      them for the 3 row taps; a warp reads 32 neighbouring columns (no
//      bank conflicts) and one weight vector (a broadcast, as float4, or
//      float2 where C/4 is not a multiple of 4).
// Weights arrive as (CI, 3, 3, CO), output channel fastest, and reach
// shared memory in chunks of input channels, so that a block needs
// 65 KB (stem_2, 3 blocks an SM) or 96 KB (stem_4, 2 blocks an SM) at L's
// widths. Every instance asserts the divisibility it relies on at compile
// time. No tensor cores: fp32 parity first.
//
// The deploy form (kLow) computes what the TPU kernel computes with its bf16
// matmul operands (fused_stems.py:74,200-280 there): the BN-folded weights
// in bf16, every conv's input rounded to bf16 (the fp32 image as it is
// staged, the GELU output of conv_down as it enters shared memory), fp32
// sums, the shift added in fp32, and the outputs stored in bf16 (the model
// casts them so, esmstereo.py:563-567 there); stem_4 reads stem_2's bf16
// map. The loops are the fp32 ones on widened values.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "activations.cuh"

namespace {

constexpr int kTh = 8;          // output rows per block
constexpr int kTw = 32;         // output columns per block
constexpr int kP = 4;           // output rows per thread in the second conv
constexpr int kThreads = 256;   // (kTh / kP) * kTw pixel groups x 4 channel groups
constexpr int kMh = kTh + 2;    // conv_down rows a tile needs (1-px halo)
constexpr int kMw = kTw + 2;
constexpr int kMid = kMh * kMw;
constexpr int kSh = 2 * kMh + 1;    // input rows of a tile's window
constexpr int kSw = 2 * kMw + 1;    // input columns of a tile's window
constexpr int kHalf = kMw + 1;      // columns of one parity, at most
constexpr int kSrow = 2 * kHalf;    // a window row: even columns, then odd

static_assert((kTh / kP) * kTw * 4 == kThreads, "thread layout");

// CC: input channels per chunk of the conv_down window.
template <int CI, int C, int CC>
struct Stem {
    static constexpr int kK1 = C % 16 == 0 ? 16 : 8;   // conv_down channels a thread
    static constexpr int kCw = C % 16 == 0 ? 16 : 8;   // input channels a chunk of conv
    static constexpr int kK = C / 4;             // second-conv channels a thread
    static constexpr int kVec = kK % 4 == 0 ? 4 : 2;   // floats a weight load
    static constexpr int kGroups = C / kK1;      // conv_down channel groups
    static constexpr int kP1 =                   // conv_down pixels a thread
        (kMid * kGroups + kThreads - 1) / kThreads;
    static constexpr int kQ = (kMid + kP1 - 1) / kP1;   // threads a group
    static constexpr int kW1 = CC * 9 * C;       // a chunk of conv_down weights
    static constexpr int kBuf1 = kW1 + CC * kSh * kSrow;
    static constexpr int kBuf2 = kCw * 9 * C;    // a chunk of conv weights
    static constexpr int kBuf = kBuf1 > kBuf2 ? kBuf1 : kBuf2;
    static constexpr size_t kSmem = sizeof(float) * (kBuf + C * kMid);
    // every split below must be exact: an instance that does not fit fails
    // to compile rather than computing on a remainder it never visits
    static_assert(CI % CC == 0, "conv_down's input chunks");
    static_assert(C % kCw == 0, "conv's input chunks");
    static_assert(C % kK1 == 0 && kK1 % 4 == 0, "conv_down's channel groups");
    static_assert(C % 4 == 0 && kK % kVec == 0, "conv's 4 channel groups");
    static_assert(kGroups * kQ <= kThreads, "conv_down thread layout");
};

// n = K consecutive weights from shared memory, as float4 (or float2) loads.
template <int K, int V>
__device__ __forceinline__ void load_weights(const float* src, float (&wr)[K]) {
    static_assert(K % V == 0 && (V == 2 || V == 4), "vector width");
    if constexpr (V == 4) {
        const float4* w4 = reinterpret_cast<const float4*>(src);
#pragma unroll
        for (int u = 0; u < K / 4; ++u) {
            const float4 w = w4[u];
            wr[4 * u + 0] = w.x;
            wr[4 * u + 1] = w.y;
            wr[4 * u + 2] = w.z;
            wr[4 * u + 3] = w.w;
        }
    } else {
        const float2* w2 = reinterpret_cast<const float2*>(src);
#pragma unroll
        for (int u = 0; u < K / 2; ++u) {
            const float2 w = w2[u];
            wr[2 * u + 0] = w.x;
            wr[2 * u + 1] = w.y;
        }
    }
}

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

template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src,
                                      int n) {
    for (int i = threadIdx.x; i < n; i += kThreads) dst[i] = widen(src[i]);
}

// One StemBlock: x (B, CI, H, W) -> y (B, C, H/2, W/2); H and W even.
// wd: (CI, 3, 3, C), td: (C,) conv_down; wc: (C, 3, 3, C), tc: (C,) conv.
// kLow: the deploy form (Tw and Tout bf16, the operands rounded to bf16).
template <int CI, int C, int CC, typename Tin, typename Tw, typename Tout,
          bool kLow>
__global__ void __launch_bounds__(kThreads)
stem_block_kernel(const Tin* __restrict__ x, const Tw* __restrict__ wd,
                  const float* __restrict__ td, const Tw* __restrict__ wc,
                  const float* __restrict__ tc, Tout* __restrict__ y, int H,
                  int W, int approximate) {
    using S = Stem<CI, C, CC>;
    constexpr int K = S::kK;
    constexpr int K1 = S::kK1;
    constexpr int Cw = S::kCw;
    constexpr int P1 = S::kP1;
    constexpr int Q = S::kQ;
    extern __shared__ float4 smem4[];
    float* wsh = reinterpret_cast<float*>(smem4);   // weights, 16-byte aligned
    float* win = wsh + S::kW1;                      // (CC, kSh, kSrow) window
    float* mid = wsh + S::kBuf;                     // (C, kMh, kMw)

    const int Ho = H / 2, Wo = W / 2;
    const int tilesW = (Wo + kTw - 1) / kTw;
    const int ox0 = (blockIdx.x % tilesW) * kTw;
    const int oy0 = (blockIdx.x / tilesW) * kTh;
    const int b = blockIdx.y;
    const int tid = threadIdx.x;
    const bool approx = approximate != 0;

    // 1. conv_down over the tile and its halo, into shared memory. Halo
    // pixel p = (my, mx) reads window rows 2 my + kh and columns
    // 2 mx + kw: the even column mx (kw 0), the odd column mx (kw 1), the
    // even column mx + 1 (kw 2).
    const int g = tid / Q, q = tid % Q;
    const bool active = g < S::kGroups;
    int off[P1];
#pragma unroll
    for (int j = 0; j < P1; ++j) {
        const int p = q + Q * j;
        off[j] = p < kMid ? 2 * (p / kMw) * kSrow + p % kMw : 0;
    }
    float acc1[P1][K1];
#pragma unroll
    for (int j = 0; j < P1; ++j)
#pragma unroll
        for (int k = 0; k < K1; ++k) acc1[j][k] = 0.0f;
    const Tin* xb = x + (size_t)b * CI * H * W;
    const int iy0 = 2 * oy0 - 3, ix0 = 2 * ox0 - 3;   // window origin
    for (int c0 = 0; c0 < CI; c0 += CC) {
        __syncthreads();   // the previous chunk fully consumed
        stage(wsh, wd + (size_t)c0 * 9 * C, S::kW1);
        for (int i = tid; i < CC * kSh * kSw; i += kThreads) {
            const int sx = i % kSw, sy = (i / kSw) % kSh, c = i / (kSw * kSh);
            const int gy = iy0 + sy, gx = ix0 + sx;
            float v = 0.0f;
            if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
                v = widen(xb[((size_t)(c0 + c) * H + gy) * W + gx]);
                if (kLow) v = round_bf16(v);
            }
            win[(c * kSh + sy) * kSrow + (sx & 1) * kHalf + (sx >> 1)] = v;
        }
        __syncthreads();
        if (!active) continue;
        for (int c = 0; c < CC; ++c) {
#pragma unroll
            for (int kh = 0; kh < 3; ++kh) {
#pragma unroll
                for (int kw = 0; kw < 3; ++kw) {
                    float wr[K1];
                    load_weights<K1, 4>(
                        wsh + ((c * 3 + kh) * 3 + kw) * C + g * K1, wr);
                    const float* wt = win + (c * kSh + kh) * kSrow
                                      + (kw == 1 ? kHalf : kw / 2);
#pragma unroll
                    for (int j = 0; j < P1; ++j) {
                        const float v = wt[off[j]];
#pragma unroll
                        for (int k = 0; k < K1; ++k)
                            acc1[j][k] = fmaf(v, wr[k], acc1[j][k]);
                    }
                }
            }
        }
    }
    if (active) {
#pragma unroll
        for (int j = 0; j < P1; ++j) {
            const int p = q + Q * j;
            if (p >= kMid) break;
            const int gy = oy0 - 1 + p / kMw, gx = ox0 - 1 + p % kMw;
            const bool inside = gy >= 0 && gy < Ho && gx >= 0 && gx < Wo;
            float* m = mid + g * K1 * kMid + p;
#pragma unroll
            for (int k = 0; k < K1; ++k) {
                float v = 0.0f;
                if (inside) {
                    v = gelu(acc1[j][k] + td[g * K1 + k], approx);
                    if (kLow) v = round_bf16(v);
                }
                m[k * kMid] = v;
            }
        }
    }

    // 2. the stride-1 conv from shared memory, + shift, ReLU
    const int cg = tid / ((kTh / kP) * kTw);          // channel group
    const int pg = tid % ((kTh / kP) * kTw);
    const int r0 = (pg / kTw) * kP, col = pg % kTw;   // first row, column
    const int co0 = cg * K;
    float acc[kP][K];
#pragma unroll
    for (int p = 0; p < kP; ++p)
#pragma unroll
        for (int k = 0; k < K; ++k) acc[p][k] = 0.0f;
    for (int c0 = 0; c0 < C; c0 += Cw) {
        __syncthreads();   // mid complete; the previous chunk consumed
        stage(wsh, wc + (size_t)c0 * 9 * C, S::kBuf2);
        __syncthreads();
        for (int c = 0; c < Cw; ++c) {
            const float* mc = mid + (c0 + c) * kMid + r0 * kMw + col;
#pragma unroll
            for (int kw = 0; kw < 3; ++kw) {
                float colv[kP + 2];
#pragma unroll
                for (int j = 0; j < kP + 2; ++j) colv[j] = mc[j * kMw + kw];
#pragma unroll
                for (int kh = 0; kh < 3; ++kh) {
                    float wr[K];
                    load_weights<K, S::kVec>(
                        wsh + ((c * 3 + kh) * 3 + kw) * C + co0, wr);
#pragma unroll
                    for (int p = 0; p < kP; ++p)
#pragma unroll
                        for (int k = 0; k < K; ++k)
                            acc[p][k] = fmaf(colv[p + kh], wr[k], acc[p][k]);
                }
            }
        }
    }
    const int ox = ox0 + col;
    if (ox >= Wo) return;
    const size_t plane = (size_t)Ho * Wo;
    Tout* yb = y + ((size_t)b * C + co0) * plane + ox;
#pragma unroll
    for (int p = 0; p < kP; ++p) {
        const int oy = oy0 + r0 + p;
        if (oy >= Ho) break;
#pragma unroll
        for (int k = 0; k < K; ++k)
            put(yb + (size_t)k * plane + (size_t)oy * Wo,
                fmaxf(acc[p][k] + tc[co0 + k], 0.0f));
    }
}

template <int CI, int C, int CC, typename Tin, typename Tw, typename Tout,
          bool kLow>
int launch_stem(const void* x, const void* wd, const float* td,
                const void* wc, const float* tc, void* y, int B, int H,
                int W, int approximate, cudaStream_t stream) {
    using S = Stem<CI, C, CC>;
    auto kernel = stem_block_kernel<CI, C, CC, Tin, Tw, Tout, kLow>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::kSmem);
    if (err != cudaSuccess) return (int)err;
    const int Ho = H / 2, Wo = W / 2;
    const dim3 grid(((Wo + kTw - 1) / kTw) * ((Ho + kTh - 1) / kTh), B);
    kernel<<<grid, kThreads, S::kSmem, stream>>>(
        static_cast<const Tin*>(x), static_cast<const Tw*>(wd), td,
        static_cast<const Tw*>(wc), tc, static_cast<Tout*>(y), H, W,
        approximate);
    return (int)cudaGetLastError();
}

// Both StemBlocks at widths (C2, C4): the fp32 form, or the deploy form
// (the fp32 image in, bf16 weights, bf16 stem_2 and stem_4 out).
template <int C2, int C4, bool kLow>
int launch_stems(const void* img, const void* wd2, const float* td2,
                 const void* wc2, const float* tc2, const void* wd4,
                 const float* td4, const void* wc4, const float* tc4,
                 void* s2, void* s4, int B, int H, int W, int approximate,
                 cudaStream_t stream) {
    using Tw = typename std::conditional<kLow, __nv_bfloat16, float>::type;
    using Tout = Tw;
    const int err = launch_stem<3, C2, 3, float, Tw, Tout, kLow>(
        img, wd2, td2, wc2, tc2, s2, B, H, W, approximate, stream);
    if (err != 0) return err;
    return launch_stem<C2, C4, 4, Tout, Tw, Tout, kLow>(
        s2, wd4, td4, wc4, tc4, s4, B, H / 2, W / 2, approximate, stream);
}

}  // namespace

// All tensors contiguous; returns a cudaError_t (cudaErrorInvalidValue for
// H or W not a positive multiple of 4, or widths (C2, C4) other than
// (32, 48) and (16, 24)).
// img: (B, 3, H, W) fp32; s2: (B, C2, H/2, W/2); s4: (B, C4, H/4, W/4).
// wd2: (3, 3, 3, C2), wc2: (C2, 3, 3, C2), wd4: (C2, 3, 3, C4),
// wc4: (C4, 3, 3, C4), each (CI, kh, kw, CO) with the BN scale folded in;
// td*, tc*: the BN shifts, fp32. With low_precision 0 the weights, s2 and
// s4 are fp32; with 1 (the deploy form) they are bf16.
extern "C" int fused_stems(const void* img, const void* wd2, const float* td2,
                           const void* wc2, const float* tc2, const void* wd4,
                           const float* td4, const void* wc4,
                           const float* tc4, void* s2, void* s4, int B, int H,
                           int W, int C2, int C4, int low_precision,
                           int approximate, cudaStream_t stream) {
    if (B < 1 || H < 4 || W < 4 || H % 4 || W % 4)
        return (int)cudaErrorInvalidValue;
#define STEMS_ARGS img, wd2, td2, wc2, tc2, wd4, td4, wc4, tc4, s2, s4, B, \
                   H, W, approximate, stream
    if (C2 == 32 && C4 == 48)
        return low_precision ? launch_stems<32, 48, true>(STEMS_ARGS)
                             : launch_stems<32, 48, false>(STEMS_ARGS);
    if (C2 == 16 && C4 == 24)
        return low_precision ? launch_stems<16, 24, true>(STEMS_ARGS)
                             : launch_stems<16, 24, false>(STEMS_ARGS);
#undef STEMS_ARGS
    return (int)cudaErrorInvalidValue;
}
