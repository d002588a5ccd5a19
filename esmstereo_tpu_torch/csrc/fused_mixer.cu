// Kernel I: the ShuffleMixer section of the cv4 upsampler's stage2x, fp32:
//   v = to_feat(x)                     3x3, 32 -> 16, no bias
//   for each of the two FMBlocks:
//     y  = sm2(sm1(v)), each SMLayer   t = t + mlp1(ln1(t)); t = dw7(t) + b;
//                                      t = t + mlp2(ln2(t))
//     x2 = y + v
//     v  = project(silu(expand(x2))) + x2      expand 3x3 16 -> 32, 1x1 back
//   out = silu(conv1x1 16 -> 64 (v) + b), stored pixel-shuffled:
//         out[c, 2h + i, 2w + j] = y[4c + 2i + j, h, w].
// ln is a bias-free LayerNorm over the 16 channels (biased variance, eps
// 1e-5); mlp takes channels 0-7 through fc1 (8 -> 16) + SiLU and fc2
// (16 -> 8), passes 8-15 through, then shuffles (g d) -> (d g) with g = 8.
//
// Replaces esmstereo_tpu/attic/fused_mixer.py::fused_mixer_apply
// (pallas_call at :302). The TPU kernel runs the whole section in one
// grid step per image, in flat lanes with banded matrices, and stores the
// pre-shuffle phase-major map for the phase-space tail. The port's tail is
// a plain conv, so this kernel stores the shuffled map directly (the
// shuffle is an index map on the store).
//
// What bounds it on an H100: operations, 21,056 multiply-adds per /4 pixel
// (0.71 G, 0.021 ms at 67 TFLOP/s fp32 at 136 x 248) against 4.3 MB read
// and 8.6 MB written (0.004 ms). What it meets is latency: the section is
// a chain of small 16-channel steps, and at 136 x 248 a grid of one thread
// a pixel holds 8 warps an SM.
//
// Design: one cooperative, persistent launch (cudaLaunchCooperativeKernel,
// every block resident; ops/kernels/fused_mixer.py::mixer_plan sizes the
// grid, and the entry point refuses one the card cannot hold) that runs
// the section's seven phases, split at the spatial ops, with a grid
// barrier (an integer counter) between them:
//   1. head:    to_feat, then block0.sm1's ln1/mlp1 residual     -> v, t
//   2. dw:      block0.sm1's dw7 + ln2/mlp2, block0.sm2's ln1/mlp1
//   3. dw:      block0.sm2's dw7 + ln2/mlp2, + v                  -> x2
//   4. expand:  block0's expand + SiLU + project + x2 (= v), then
//               block1.sm1's ln1/mlp1                             -> v, t
//   5, 6.       as 2 and 3 for block1
//   7. expand:  block1's expand/project, then the 1x1 up + SiLU, shuffled.
// The six 16-channel intermediates (2.2 MB each at the main path) live in
// a workspace and stay in the 50 MB L2; a phase reads what another block
// wrote with __ldcg (L2), eight loads in flight a thread.
// A tile is 32 x 3 pixels and a block 192 threads, two a pixel (at 136 x
// 248, 368 tiles: at most 3 an SM, against 2.79 on average): each
// thread of a pixel takes half the channels of the 3x3 convs, of the 1x1
// convs and of each MLP layer (the LayerNorm statistics, which both need,
// each computes in full), and the halves meet in shared memory. The dw 7x7
// gives a thread a column of the tile's rows in one channel at a time, its
// 49 weights in registers, each slab row read once for the taps of all the
// rows. Each
// phase stages its weights in shared memory once (cp.async, transposed so
// that a thread's outputs are consecutive), read as broadcast float4s.
// Every sum runs in the order of the plain version's formula (bias, then
// the inputs, then the taps in row-major order), so a thread's arithmetic
// is that of a single-threaded pass.
//
// The bf16 form (kLow; the deploy numerics) rounds where the TPU kernel's
// bf16 matmul operands round (fused_mixer.py:198-209,246-289 there): the
// packed weights of every conv and linear layer arrive rounded to bf16 (the
// norms and biases stay fp32), and each layer's input is rounded to bf16 as
// it is read: the bf16 spx map, the LayerNorm output into fc1 and its
// pass-through half, fc1's SiLU output into fc2, the dw 7x7's input, x2 into
// expand, expand's SiLU output into project, v into up. The LayerNorm
// statistics, the sums, the biases and the residual stream stay fp32; the
// output is stored in bf16 (phased_upsample.py:497 there casts it so). It
// runs on the CUDA cores as the fp32 form does.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "activations.cuh"
#include "async_copy.cuh"

namespace {

constexpr int kC = 16;      // mixer width
constexpr int kCin = 32;    // spx output channels
constexpr int kTw = 32;     // tile columns
constexpr int kTh = 3;      // tile rows
constexpr int kPix = kTw * kTh;
constexpr int kThreads = 2 * kPix;   // two threads a pixel
constexpr int kBlocksPerSm = 3;      // __launch_bounds__ below

// Packed parameter offsets in floats: ops/kernels/fused_mixer.py::LAYOUT.
// A pre-norm and its split-point MLP:
constexpr int kMlpNorm = 0;                      // (16,)
constexpr int kMlpFc1W = 16;                     // (16 out, 8 in)
constexpr int kMlpFc1B = kMlpFc1W + 16 * 8;      // (16,)
constexpr int kMlpFc2W = kMlpFc1B + 16;          // (8 out, 16 in)
constexpr int kMlpFc2B = kMlpFc2W + 8 * 16;      // (8,)
constexpr int kMlpSize = kMlpFc2B + 8;
// An SMLayer: pre-norm MLP, dw 7x7 (16, 49) + bias, post-norm MLP.
constexpr int kSmDwW = kMlpSize;
constexpr int kSmDwB = kSmDwW + kC * 49;
constexpr int kSmPost = kSmDwB + kC;
constexpr int kSmSize = kSmPost + kMlpSize;
// An FMBlock: sm1, sm2, expand (16 in, 9 taps, 32 out) + bias, project
// (16 out, 32 in) + bias.
constexpr int kBlkSm1 = 0;
constexpr int kBlkSm2 = kSmSize;
constexpr int kBlkExpW = 2 * kSmSize;
constexpr int kBlkExpB = kBlkExpW + kC * 9 * 2 * kC;
constexpr int kBlkProjW = kBlkExpB + 2 * kC;
constexpr int kBlkProjB = kBlkProjW + kC * 2 * kC;
constexpr int kBlkSize = kBlkProjB + kC;
// The section: to_feat (32 in, 9 taps, 16 out), block0, block1, up (64
// out, 16 in) + bias.
constexpr int kToFeat = 0;
constexpr int kBlock0 = kCin * 9 * kC;
constexpr int kBlock1 = kBlock0 + kBlkSize;
constexpr int kUpW = kBlock1 + kBlkSize;
constexpr int kUpB = kUpW + 4 * kC * kC;
constexpr int kParams = kUpB + 4 * kC;
static_assert(kParams == 21600, "packed layout");

// Staged weights in shared memory (floats), each block 16-byte aligned.
// An MLP: norm, fc1 [8 in][16 out], its bias, fc2 [16 in][8 out], its bias.
constexpr int kSNorm = 0, kSFc1 = 16, kSFc1B = kSFc1 + 128, kSFc2 = kSFc1B + 16,
              kSFc2B = kSFc2 + 128, kSMlp = kSFc2B + 8;
// A dw 7x7: [16][52] (49 taps, 16-byte rows), then its bias.
constexpr int kDwRow = 52, kSDwB = kC * kDwRow, kSDw = kSDwB + kC;
// The head: to_feat [32 ci][9][16] as packed, then its MLP.
constexpr int kWHead = kCin * 9 * kC + kSMlp;
// A dw phase: the dw, the post-norm MLP, the next pre-norm MLP.
constexpr int kWDw = kSDw + 2 * kSMlp;
// An expand phase: expand [16 ci][9][32] as packed + bias, project
// [32 in][16 out] + bias, then the next MLP or up [16 in][64 out] + bias.
constexpr int kSExpB = kC * 9 * 2 * kC, kSProj = kSExpB + 2 * kC, kSProjB = kSProj + 2 * kC * kC,
              kSTail = kSProjB + kC, kSUp = 4 * kC * kC + 4 * kC;
constexpr int kWExp = kSTail + (kSUp > kSMlp ? kSUp : kSMlp);
constexpr int kWMax = kWExp > kWHead ? (kWExp > kWDw ? kWExp : kWDw) : (kWHead > kWDw ? kWHead : kWDw);
static_assert(kSMlp % 4 == 0 && kSDw % 4 == 0 && kSTail % 4 == 0 && kWMax % 4 == 0, "float4s");

// The data area after the weights: a phase's slab (and the expand's
// SiLU(z) after it), then, once the slab is read, the MLP's hidden and
// fc2 maps at its start; the residual stream vs at kVs.
template <int CH, int R>
struct Slab {
    static constexpr int h = kTh + 2 * R;
    static constexpr int w = kTw + 2 * R;
    static constexpr int size = CH * h * w;
};
constexpr int kZs = Slab<kC, 1>::size;                 // expand: SiLU(z) [32][kPix]
constexpr int kHs = 0, kYs = kC * kPix;                // MLP: [16][kPix], [8][kPix]
constexpr int kVs = 6144;                              // the residual stream [16][kPix]
static_assert(Slab<kCin, 1>::size <= kVs && Slab<kC, 3>::size <= kVs &&
              kZs + 2 * kC * kPix <= kVs && kYs + 8 * kPix <= kVs, "data layout");
constexpr int kData = kVs + kC * kPix;
constexpr int kSmemFloats = kWMax + kData;   // ops/kernels/fused_mixer.py::mixer_plan mirrors it

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

// A matmul operand: rounded to bf16 in the bf16 form, as it is in fp32.
template <bool kLow>
__device__ __forceinline__ float operand(float v) {
    return kLow ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

__device__ __forceinline__ void store_pair(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a, float b) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

struct Tile {
    int b, y0, x0;
};

// dst[i] = src[i], i < n, by cp.async (read-only weights).
__device__ __forceinline__ void stage_copy(float* dst, const float* __restrict__ src, int n) {
    for (int i = threadIdx.x; i < n; i += kThreads) cp_async4(dst + i, src + i, true);
}

// dst[c * rows + r] = src[r * cols + c] by cp.async: a [rows][cols] matrix
// staged as [cols][rows].
__device__ __forceinline__ void stage_transposed(float* dst, const float* __restrict__ src,
                                                 int rows, int cols) {
    for (int i = threadIdx.x; i < rows * cols; i += kThreads) {
        const int c = i / rows, r = i % rows;
        cp_async4(dst + i, src + r * cols + c, true);
    }
}

// An MLP of the packed layout at p into the staged layout at dst.
__device__ void stage_mlp(float* dst, const float* __restrict__ p) {
    stage_copy(dst + kSNorm, p + kMlpNorm, kC);
    stage_transposed(dst + kSFc1, p + kMlpFc1W, 16, 8);
    stage_copy(dst + kSFc1B, p + kMlpFc1B, 16);
    stage_transposed(dst + kSFc2, p + kMlpFc2W, 8, 16);
    stage_copy(dst + kSFc2B, p + kMlpFc2B, 8);
}

__device__ __forceinline__ float load_map(const float* p) { return __ldcg(p); }
__device__ __forceinline__ float load_map(const __nv_bfloat16* p) { return widen(*p); }

// The tile's (CH, kTh + 2R, kTw + 2R) window of a (CH, H, W) map, zero
// outside the map; with kRound each value rounded to bf16. fp32 maps are
// the workspace, read through L2; a thread's loads are all in flight at
// once.
template <int CH, int R, bool kRound, typename T>
__device__ void stage_slab(float* slab, const T* __restrict__ src, int H, int W, Tile t) {
    using S = Slab<CH, R>;
    constexpr int kU = (S::size + kThreads - 1) / kThreads;
    for (int i0 = threadIdx.x; i0 < S::size; i0 += kU * kThreads) {
        float v[kU];
#pragma unroll
        for (int u = 0; u < kU; ++u) {
            const int i = i0 + u * kThreads;
            const int sx = i % S::w, sy = (i / S::w) % S::h, c = i / (S::w * S::h);
            const int gy = t.y0 - R + sy, gx = t.x0 - R + sx;
            v[u] = (i < S::size && gy >= 0 && gy < H && gx >= 0 && gx < W)
                       ? load_map(src + ((size_t)c * H + gy) * W + gx) : 0.0f;
        }
#pragma unroll
        for (int u = 0; u < kU; ++u)
            if (i0 + u * kThreads < S::size) slab[i0 + u * kThreads] = operand<kRound>(v[u]);
    }
}

// The thread's pixel and half: p (0..kPix-1; a warp a tile row) and h.
struct Lane {
    int p, h, ly, lx;
    __device__ Lane() {
        p = threadIdx.x % kPix;
        h = threadIdx.x / kPix;
        ly = p / kTw;
        lx = p % kTw;
    }
};

// The residual stream's own half (channels 8h .. 8h + 7) of the thread's
// pixel from vs into a (B, 16, H, W) map.
__device__ __forceinline__ void store_half(float* __restrict__ dst, const float* vs, Lane l,
                                           Tile t, int H, int W) {
    const int gy = t.y0 + l.ly, gx = t.x0 + l.lx;
    if (gy >= H || gx >= W) return;
    const size_t plane = (size_t)H * W;
    float* d = dst + (size_t)t.b * kC * plane + (size_t)gy * W + gx;
#pragma unroll
    for (int c = 0; c < 8; ++c) d[(8 * l.h + c) * plane] = vs[(8 * l.h + c) * kPix + l.p];
}

// vs += shuffle([fc2(silu(fc1(n[0:8]))), n[8:16]]) with n = ln(vs), on the
// tile's pixels: each thread of a pixel computes half of fc1's outputs, of
// fc2's and of the residual update; both compute the statistics. m is a
// staged MLP. Ends with the block synchronised.
template <bool kLow>
__device__ void mlp_residual(float* sm, const float* m, Lane l) {
    float* vs = sm + kVs;
    float* hs = sm + kHs;
    float* ys = sm + kYs;
    float v[kC];
#pragma unroll
    for (int c = 0; c < kC; ++c) v[c] = vs[c * kPix + l.p];
    float mu = 0.0f;
#pragma unroll
    for (int c = 0; c < kC; ++c) mu += v[c];
    mu *= 1.0f / kC;
    float var = 0.0f;
#pragma unroll
    for (int c = 0; c < kC; ++c) {
        const float d = v[c] - mu;
        var = fmaf(d, d, var);
    }
    var *= 1.0f / kC;
    const float inv = 1.0f / sqrtf(var + 1e-5f);
    float n[kC];
#pragma unroll
    for (int c = 0; c < kC; ++c) n[c] = operand<kLow>((v[c] - mu) * inv * m[kSNorm + c]);
    float a[8];
#pragma unroll
    for (int o = 0; o < 8; ++o) a[o] = m[kSFc1B + 8 * l.h + o];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        const float4* w4 = reinterpret_cast<const float4*>(m + kSFc1 + i * 16 + 8 * l.h);
        const float4 w0 = w4[0], w1 = w4[1];
        a[0] = fmaf(w0.x, n[i], a[0]);
        a[1] = fmaf(w0.y, n[i], a[1]);
        a[2] = fmaf(w0.z, n[i], a[2]);
        a[3] = fmaf(w0.w, n[i], a[3]);
        a[4] = fmaf(w1.x, n[i], a[4]);
        a[5] = fmaf(w1.y, n[i], a[5]);
        a[6] = fmaf(w1.z, n[i], a[6]);
        a[7] = fmaf(w1.w, n[i], a[7]);
    }
#pragma unroll
    for (int o = 0; o < 8; ++o) hs[(8 * l.h + o) * kPix + l.p] = operand<kLow>(silu_fast(a[o]));
    __syncthreads();
    float y[4];
#pragma unroll
    for (int o = 0; o < 4; ++o) y[o] = m[kSFc2B + 4 * l.h + o];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
        const float4 w = *reinterpret_cast<const float4*>(m + kSFc2 + i * 8 + 4 * l.h);
        const float hv = hs[i * kPix + l.p];
        y[0] = fmaf(w.x, hv, y[0]);
        y[1] = fmaf(w.y, hv, y[1]);
        y[2] = fmaf(w.z, hv, y[2]);
        y[3] = fmaf(w.w, hv, y[3]);
    }
#pragma unroll
    for (int o = 0; o < 4; ++o) ys[(4 * l.h + o) * kPix + l.p] = y[o];
    __syncthreads();
    // channel shuffle (g d) -> (d g), 8 groups of 2: v[j] += cat[(j % 8) * 2
    // + j / 8], cat = [fc2 out (8), n[8:16]]; half h owns j = 8h + q, whose
    // cat index is 2q + h
#pragma unroll
    for (int q = 0; q < 8; ++q) {
        const int k = 2 * q;  // + h
        float cat;
        if (k < 8) {
            cat = ys[(k + l.h) * kPix + l.p];
        } else {
            cat = l.h ? n[k + 1] : n[k];
        }
        vs[(8 * l.h + q) * kPix + l.p] = v[8 * l.h + q] + cat;
    }
    __syncthreads();
}

// Phase 1. x (B, 32, H, W) -> v = to_feat(x) (V), t = v + mlp(ln(v)) (T)
// with block0.sm1's pre-norm MLP.
template <bool kLow, typename Tin>
__device__ void head(const Tin* __restrict__ x, float* wsm, float* sm, Tile t, int H, int W,
                     float* __restrict__ V, float* __restrict__ T) {
    using S = Slab<kCin, 1>;
    const Lane l;
    float* slab = sm;
    __syncthreads();
    stage_slab<kCin, 1, kLow>(slab, x + (size_t)t.b * kCin * H * W, H, W, t);
    cp_async_wait_all();
    __syncthreads();
    float v[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) v[c] = 0.0f;
    for (int ci = 0; ci < kCin; ++ci) {
#pragma unroll
        for (int kh = 0; kh < 3; ++kh) {
#pragma unroll
            for (int kw = 0; kw < 3; ++kw) {
                const float a = slab[(ci * S::h + l.ly + kh) * S::w + l.lx + kw];
                const float4* w4 =
                    reinterpret_cast<const float4*>(wsm + (ci * 9 + kh * 3 + kw) * kC + 8 * l.h);
                const float4 w0 = w4[0], w1 = w4[1];
                v[0] = fmaf(a, w0.x, v[0]);
                v[1] = fmaf(a, w0.y, v[1]);
                v[2] = fmaf(a, w0.z, v[2]);
                v[3] = fmaf(a, w0.w, v[3]);
                v[4] = fmaf(a, w1.x, v[4]);
                v[5] = fmaf(a, w1.y, v[5]);
                v[6] = fmaf(a, w1.z, v[6]);
                v[7] = fmaf(a, w1.w, v[7]);
            }
        }
    }
#pragma unroll
    for (int c = 0; c < 8; ++c) sm[kVs + (8 * l.h + c) * kPix + l.p] = v[c];
    __syncthreads();  // vs whole; the slab is read
    store_half(V, sm + kVs, l, t, H, W);
    mlp_residual<kLow>(sm, wsm + kCin * 9 * kC, l);
    store_half(T, sm + kVs, l, t, H, W);
}

// Phases 2, 3, 5, 6. One SMLayer's dw 7x7 + bias and post-norm MLP
// residual on in (B, 16, H, W); then the next SMLayer's pre-norm MLP
// residual (next) or + residual (the FMBlock's input) -> out.
template <bool kLow>
__device__ void dw_phase(const float* __restrict__ in, float* wsm, float* sm, Tile t, int H,
                         int W, bool next, const float* __restrict__ residual,
                         float* __restrict__ out) {
    using S = Slab<kC, 3>;
    float* slab = sm;
    __syncthreads();
    stage_slab<kC, 3, kLow>(slab, in + (size_t)t.b * kC * H * W, H, W, t);
    cp_async_wait_all();
    __syncthreads();
    // a column of the tile's rows in one channel a task (a warp's tasks
    // share the channel)
#pragma unroll 1
    for (int task = threadIdx.x; task < kTw * kC; task += kThreads) {
        const int lx = task % kTw, c = task / kTw;
        float w[49];
        const float4* w4 = reinterpret_cast<const float4*>(wsm + c * kDwRow);
#pragma unroll
        for (int q = 0; q < 12; ++q) {
            const float4 v4 = w4[q];
            w[4 * q + 0] = v4.x;
            w[4 * q + 1] = v4.y;
            w[4 * q + 2] = v4.z;
            w[4 * q + 3] = v4.w;
        }
        w[48] = wsm[c * kDwRow + 48];
        float a[kTh];
#pragma unroll
        for (int r = 0; r < kTh; ++r) a[r] = wsm[kSDwB + c];
        const float* sc = slab + c * S::h * S::w + lx;
#pragma unroll
        for (int row = 0; row < kTh + 6; ++row) {
            float v[7];
#pragma unroll
            for (int kw = 0; kw < 7; ++kw) v[kw] = sc[row * S::w + kw];
#pragma unroll
            for (int r = 0; r < kTh; ++r) {
                const int kh = row - r;
                if (kh < 0 || kh > 6) continue;
#pragma unroll
                for (int kw = 0; kw < 7; ++kw) a[r] = fmaf(v[kw], w[kh * 7 + kw], a[r]);
            }
        }
#pragma unroll
        for (int r = 0; r < kTh; ++r) sm[kVs + c * kPix + r * kTw + lx] = a[r];
    }
    __syncthreads();
    const Lane l;
    mlp_residual<kLow>(sm, wsm + kSDw, l);
    if (next) {
        mlp_residual<kLow>(sm, wsm + kSDw + kSMlp, l);
    } else {
        const int gy = t.y0 + l.ly, gx = t.x0 + l.lx;
        if (gy < H && gx < W) {
            const size_t plane = (size_t)H * W;
            const float* r = residual + (size_t)t.b * kC * plane + (size_t)gy * W + gx;
#pragma unroll
            for (int c = 0; c < 8; ++c)
                sm[kVs + (8 * l.h + c) * kPix + l.p] += __ldcg(r + (8 * l.h + c) * plane);
        }
    }
    store_half(out, sm + kVs, l, t, H, W);
}

// Phases 4 and 7. An FMBlock's tail on x2 (B, 16, H, W):
// v = project(silu(expand(x2))) + x2. Then either the next block's
// pre-norm MLP residual (y == nullptr: writes v to V and t to T), or the
// up conv + SiLU, stored pixel-shuffled into y (B, 16, 2H, 2W).
template <bool kLow, typename Tout>
__device__ void expand_phase(const float* __restrict__ in, float* wsm, float* sm, Tile t, int H,
                             int W, float* __restrict__ V, float* __restrict__ T,
                             Tout* __restrict__ y) {
    using S = Slab<kC, 1>;
    const Lane l;
    float* slab = sm;
    float* zs = sm + kZs;
    __syncthreads();
    // x2 stays fp32 in the slab: it is also the residual
    stage_slab<kC, 1, false>(slab, in + (size_t)t.b * kC * H * W, H, W, t);
    cp_async_wait_all();
    __syncthreads();
    float z[kC];
#pragma unroll
    for (int o = 0; o < kC; ++o) z[o] = wsm[kSExpB + kC * l.h + o];
    for (int ci = 0; ci < kC; ++ci) {
#pragma unroll
        for (int kh = 0; kh < 3; ++kh) {
#pragma unroll
            for (int kw = 0; kw < 3; ++kw) {
                const float a =
                    operand<kLow>(slab[(ci * S::h + l.ly + kh) * S::w + l.lx + kw]);
                const float4* w4 = reinterpret_cast<const float4*>(
                    wsm + (ci * 9 + kh * 3 + kw) * 2 * kC + kC * l.h);
#pragma unroll
                for (int q = 0; q < kC / 4; ++q) {
                    const float4 w = w4[q];
                    z[4 * q + 0] = fmaf(a, w.x, z[4 * q + 0]);
                    z[4 * q + 1] = fmaf(a, w.y, z[4 * q + 1]);
                    z[4 * q + 2] = fmaf(a, w.z, z[4 * q + 2]);
                    z[4 * q + 3] = fmaf(a, w.w, z[4 * q + 3]);
                }
            }
        }
    }
#pragma unroll
    for (int o = 0; o < kC; ++o) zs[(kC * l.h + o) * kPix + l.p] = operand<kLow>(silu_fast(z[o]));
    float x2[8];
#pragma unroll
    for (int o = 0; o < 8; ++o) x2[o] = slab[((8 * l.h + o) * S::h + l.ly + 1) * S::w + l.lx + 1];
    __syncthreads();
    float v[8];
#pragma unroll
    for (int o = 0; o < 8; ++o) v[o] = wsm[kSProjB + 8 * l.h + o];
#pragma unroll
    for (int i = 0; i < 2 * kC; ++i) {
        const float4* w4 = reinterpret_cast<const float4*>(wsm + kSProj + i * kC + 8 * l.h);
        const float4 w0 = w4[0], w1 = w4[1];
        const float zi = zs[i * kPix + l.p];
        v[0] = fmaf(w0.x, zi, v[0]);
        v[1] = fmaf(w0.y, zi, v[1]);
        v[2] = fmaf(w0.z, zi, v[2]);
        v[3] = fmaf(w0.w, zi, v[3]);
        v[4] = fmaf(w1.x, zi, v[4]);
        v[5] = fmaf(w1.y, zi, v[5]);
        v[6] = fmaf(w1.z, zi, v[6]);
        v[7] = fmaf(w1.w, zi, v[7]);
    }
    float* vs = sm + kVs;
    if (y == nullptr) {
#pragma unroll
        for (int o = 0; o < 8; ++o) vs[(8 * l.h + o) * kPix + l.p] = v[o] + x2[o];
        __syncthreads();
        store_half(V, vs, l, t, H, W);
        mlp_residual<kLow>(sm, wsm + kSTail, l);
        store_half(T, vs, l, t, H, W);
        return;
    }
#pragma unroll
    for (int o = 0; o < 8; ++o) vs[(8 * l.h + o) * kPix + l.p] = operand<kLow>(v[o] + x2[o]);
    __syncthreads();
    // up: outputs o = 32h .. 32h + 31, channel c = o / 4 of the shuffled map
    float u[2 * kC];
#pragma unroll
    for (int o = 0; o < 2 * kC; ++o) u[o] = wsm[kSTail + 4 * kC * kC + 2 * kC * l.h + o];
#pragma unroll
    for (int i = 0; i < kC; ++i) {
        const float vi = vs[i * kPix + l.p];
        const float4* w4 =
            reinterpret_cast<const float4*>(wsm + kSTail + i * 4 * kC + 2 * kC * l.h);
#pragma unroll
        for (int q = 0; q < 2 * kC / 4; ++q) {
            const float4 w = w4[q];
            u[4 * q + 0] = fmaf(w.x, vi, u[4 * q + 0]);
            u[4 * q + 1] = fmaf(w.y, vi, u[4 * q + 1]);
            u[4 * q + 2] = fmaf(w.z, vi, u[4 * q + 2]);
            u[4 * q + 3] = fmaf(w.w, vi, u[4 * q + 3]);
        }
    }
    const int gy = t.y0 + l.ly, gx = t.x0 + l.lx;
    if (gy >= H || gx >= W) return;
    const size_t plane = (size_t)(2 * H) * (2 * W);
    Tout* yb = y + (size_t)t.b * kC * plane;
#pragma unroll
    for (int q = 0; q < 2 * kC; q += 2) {
        const int o = 2 * kC * l.h + q;  // even: j = 0, and o + 1 is j = 1
        const int c = o / 4, i = (o / 2) % 2;
        store_pair(yb + c * plane + (size_t)(2 * gy + i) * (2 * W) + 2 * gx, silu_fast(u[q]),
                   silu_fast(u[q + 1]));
    }
}

// Wait until every block of the (cooperative, all-resident) grid has
// arrived at its n-th barrier: an integer counter zeroed before the launch.
__device__ __forceinline__ void grid_barrier(unsigned* count, int n) {
    __syncthreads();
    if (threadIdx.x == 0) {
        const unsigned target = (unsigned)n * gridDim.x;
        __threadfence();
        atomicAdd(count, 1u);
        while (*(volatile unsigned*)count < target) __nanosleep(32);
        __threadfence();
    }
    __syncthreads();
}

// The weights of phase `phase` (1-7) into wsm, by cp.async.
__device__ void stage_phase(int phase, const float* __restrict__ prm, float* wsm) {
    const float* blk = prm + (phase <= 4 ? kBlock0 : kBlock1);
    if (phase == 1) {
        stage_copy(wsm, prm + kToFeat, kCin * 9 * kC);
        stage_mlp(wsm + kCin * 9 * kC, prm + kBlock0 + kBlkSm1);
    } else if (phase == 4 || phase == 7) {
        stage_copy(wsm, blk + kBlkExpW, kC * 9 * 2 * kC + 2 * kC);
        stage_transposed(wsm + kSProj, blk + kBlkProjW, kC, 2 * kC);
        stage_copy(wsm + kSProjB, blk + kBlkProjB, kC);
        if (phase == 4) {
            stage_mlp(wsm + kSTail, prm + kBlock1 + kBlkSm1);
        } else {
            stage_transposed(wsm + kSTail, prm + kUpW, 4 * kC, kC);
            stage_copy(wsm + kSTail + 4 * kC * kC, prm + kUpB, 4 * kC);
        }
    } else {
        const float* sm = blk + (phase == 2 || phase == 5 ? kBlkSm1 : kBlkSm2);
        for (int i = threadIdx.x; i < kC * 49; i += kThreads)
            cp_async4(wsm + (i / 49) * kDwRow + i % 49, sm + kSmDwW + i, true);
        stage_copy(wsm + kSDwB, sm + kSmDwB, kC);
        stage_mlp(wsm + kSDw, sm + kSmPost);
        if (phase == 2 || phase == 5) stage_mlp(wsm + kSDw + kSMlp, blk + kBlkSm2);
    }
    cp_async_commit();
}

// The section in one cooperative launch, its first `stop` phases (all
// seven in the model; fewer for a check that reads the workspace after
// each). Workspace: V, T, U (B, 16, H, W) each, then the barrier counter.
template <bool kLow, typename Tin, typename Tout>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
mixer_kernel(const Tin* __restrict__ x, const float* __restrict__ prm, Tout* __restrict__ y,
             float* __restrict__ ws, int B, int H, int W, int stop) {
    extern __shared__ float4 smem4[];
    float* wsm = reinterpret_cast<float*>(smem4);
    float* sm = wsm + kWMax;
    const size_t n = (size_t)B * kC * H * W;
    float* V = ws;
    float* T = ws + n;
    float* U = ws + 2 * n;
    unsigned* count = reinterpret_cast<unsigned*>(ws + 3 * n);
    const int tx = (W + kTw - 1) / kTw, tiles = tx * ((H + kTh - 1) / kTh), nt = B * tiles;
    for (int phase = 1; phase <= stop; ++phase) {
        // the phase's weights depend on no other block: their copies fly
        // while the block waits at the barrier
        __syncthreads();  // the last phase's weights are read
        stage_phase(phase, prm, wsm);
        if (phase > 1) grid_barrier(count, phase - 1);
        for (int k = blockIdx.x; k < nt; k += gridDim.x) {
            const int r = k % tiles;
            const Tile t{k / tiles, (r / tx) * kTh, (r % tx) * kTw};
            switch (phase) {
                case 1: head<kLow, Tin>(x, wsm, sm, t, H, W, V, T); break;
                case 2: dw_phase<kLow>(T, wsm, sm, t, H, W, true, nullptr, U); break;
                case 3: dw_phase<kLow>(U, wsm, sm, t, H, W, false, V, T); break;
                case 4: expand_phase<kLow, Tout>(T, wsm, sm, t, H, W, V, U, nullptr); break;
                case 5: dw_phase<kLow>(U, wsm, sm, t, H, W, true, nullptr, T); break;
                case 6: dw_phase<kLow>(T, wsm, sm, t, H, W, false, V, U); break;
                default: expand_phase<kLow, Tout>(U, wsm, sm, t, H, W, nullptr, nullptr, y);
            }
        }
        cp_async_wait_all();  // a block without a tile drains its copies
    }
}

template <bool kLow, typename Tin, typename Tout>
int launch_mixer(const void* xv, const float* params, void* yv, float* ws, int B, int H, int W,
                 int stop, int grid, int smem, cudaStream_t stream) {
    const void* fn = (const void*)mixer_kernel<kLow, Tin, Tout>;
    // once a process per form: the shared memory it may take, and how many
    // of its blocks the card holds resident at that size
    static int capacity = -1;
    static cudaError_t prepared = cudaErrorNotReady;
    if (prepared == cudaErrorNotReady) {
        int dev = 0, sms = 0, per_sm = 0;
        if (!(prepared = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                              smem)) &&
            !(prepared = cudaGetDevice(&dev)) &&
            !(prepared = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) &&
            !(prepared = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads,
                                                                        smem)))
            capacity = per_sm * sms;
    }
    cudaError_t err = prepared;
    if (err != cudaSuccess) return (int)err;
    if (capacity < grid) return (int)cudaErrorCooperativeLaunchTooLarge;
    const size_t n = (size_t)B * kC * H * W;
    if ((err = cudaMemsetAsync(ws + 3 * n, 0, 4 * sizeof(float), stream)) != cudaSuccess)
        return (int)err;
    const Tin* x = static_cast<const Tin*>(xv);
    Tout* y = static_cast<Tout*>(yv);
    void* args[] = {(void*)&x, (void*)&params, (void*)&y, (void*)&ws,
                    (void*)&B, (void*)&H,      (void*)&W, (void*)&stop};
    err = cudaLaunchCooperativeKernel(fn, dim3(grid), dim3(kThreads), args, (size_t)smem, stream);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int mixer_params_size() { return kParams; }

// The plan's counts as the source has them (ops/kernels/fused_mixer.py::
// mixer_plan mirrors them): dynamic shared bytes a block, workspace floats.
extern "C" int mixer_smem_bytes() { return kSmemFloats * (int)sizeof(float); }

extern "C" long long mixer_workspace_floats(int B, int H, int W) {
    return 3LL * B * kC * H * W + 4;
}

// All tensors contiguous; returns a cudaError_t. x: (B, 32, H, W); params:
// the packed layout (kParams floats, fp32); y: (B, 16, 2H, 2W); ws:
// mixer_workspace_floats(B, H, W) floats. With low_precision 0, x and y are
// fp32; with 1 (the bf16 form, its packed weights rounded to bf16) they are
// bf16. stop: the phases to run, 7 (all) in the model, 1-6 to read the
// workspace after each (y is then not written). The plan (grid, threads,
// smem, ws_floats) must be mixer_plan's: anything else is refused
// (cudaErrorInvalidConfiguration), and so is a grid the card cannot hold
// resident (cudaErrorCooperativeLaunchTooLarge).
extern "C" int fused_mixer(const void* x, const float* params, void* y, float* ws, int B, int H,
                           int W, int low_precision, int stop, int grid, int threads, int smem,
                           long long ws_floats, cudaStream_t stream) {
    if (B < 1 || H < 1 || W < 1 || stop < 1 || stop > 7) return (int)cudaErrorInvalidValue;
    const long long tiles = (long long)B * ((W + kTw - 1) / kTw) * ((H + kTh - 1) / kTh);
    if (threads != kThreads || smem != mixer_smem_bytes() ||
        ws_floats != mixer_workspace_floats(B, H, W) || grid < 1 || grid > tiles)
        return (int)cudaErrorInvalidConfiguration;
    using bf16 = __nv_bfloat16;
    return low_precision
        ? launch_mixer<true, bf16, bf16>(x, params, y, ws, B, H, W, stop, grid, smem, stream)
        : launch_mixer<false, float, float>(x, params, y, ws, B, H, W, stop, grid, smem, stream);
}
