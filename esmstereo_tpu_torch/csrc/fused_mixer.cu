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
// and 8.6 MB written (0.004 ms). Latency, not either bound, is what it
// meets: the section is a chain of small 16-channel steps.
//
// Design: seven launches from one entry point, split at the spatial ops,
// with the per-pixel work fused into each launch's prologue and epilogue.
// Every launch owns a 32 x 8 tile, one thread per pixel holding the 16
// channels in registers, and stages the tile's halo slab (1 px for the
// 3x3 convs, 3 px for the 7x7) and its weights in shared memory:
//   1. head:    to_feat, then block0.sm1's ln1/mlp1 residual     -> v, t
//   2. dw:      block0.sm1's dw7 + ln2/mlp2, block0.sm2's ln1/mlp1
//   3. dw:      block0.sm2's dw7 + ln2/mlp2, + v                  -> x2
//   4. expand:  block0's expand + SiLU + project + x2 (= v), then
//               block1.sm1's ln1/mlp1                             -> v, t
//   5, 6.       as 2 and 3 for block1
//   7. expand:  block1's expand/project, then the 1x1 up + SiLU, shuffled.
// The six 16-channel intermediates (2.2 MB each at the main path) live in
// a workspace and stay in the 50 MB L2. The split-point MLP's shuffle is a
// fixed register permutation.
//
// The bf16 form (kLow; the deploy numerics) rounds where the TPU kernel's
// bf16 matmul operands round (fused_mixer.py:198-209,246-289 there): the
// packed weights of every conv and linear layer arrive rounded to bf16 (the
// norms and biases stay fp32), and each layer's input is rounded to bf16 as
// it is read: the bf16 spx map, the LayerNorm output into fc1 and its
// pass-through half, fc1's SiLU output into fc2, the dw 7x7's input, x2 into
// expand, expand's SiLU output into project, v into up. The LayerNorm
// statistics, the sums, the biases and the residual stream stay fp32; the
// output is stored in bf16 (phased_upsample.py:497 there casts it so).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "activations.cuh"

namespace {

constexpr int kC = 16;      // mixer width
constexpr int kCin = 32;    // spx output channels
constexpr int kTw = 32;     // tile columns, one thread each
constexpr int kTh = 8;      // tile rows
constexpr int kThreads = kTw * kTh;

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

// Shared-memory floats of each launch: weights first (16-byte aligned).
template <int CH, int R>
struct Slab {
    static constexpr int h = kTh + 2 * R;
    static constexpr int w = kTw + 2 * R;
    static constexpr int size = CH * h * w;
};
constexpr int kHeadSmem = kCin * 9 * kC + kMlpSize + Slab<kCin, 1>::size;
constexpr int kDwParams = kSmSize - kSmDwW;   // dw weights, bias, post MLP
constexpr int kDwSmem = kDwParams + kMlpSize + Slab<kC, 3>::size;
constexpr int kExpParams = kBlkSize - kBlkExpW;
constexpr int kUpSize = kParams - kUpW;
constexpr int kExpSmem = kExpParams + kUpSize + Slab<kC, 1>::size;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
    return __bfloat162float(v);
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
}

// A matmul operand: rounded to bf16 in the bf16 form, as it is in fp32.
template <bool kLow>
__device__ __forceinline__ float operand(float v) {
    return kLow ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src,
                                      int n) {
    for (int i = threadIdx.x; i < n; i += kThreads) dst[i] = src[i];
}

// The tile's (CH, kTh + 2R, kTw + 2R) window of a (CH, H, W) map, zero
// outside the map; with kLow each value rounded to bf16.
template <int CH, int R, bool kLow = false, typename T = float>
__device__ __forceinline__ void stage_slab(float* slab,
                                           const T* __restrict__ src,
                                           int H, int W, int y0, int x0) {
    using S = Slab<CH, R>;
    for (int i = threadIdx.x; i < S::size; i += kThreads) {
        const int sx = i % S::w, sy = (i / S::w) % S::h, c = i / (S::w * S::h);
        const int gy = y0 - R + sy, gx = x0 - R + sx;
        slab[i] = (gy >= 0 && gy < H && gx >= 0 && gx < W)
                      ? operand<kLow>(widen(src[((size_t)c * H + gy) * W + gx]))
                      : 0.0f;
    }
}

// v += shuffle([fc2(silu(fc1(n[0:8]))), n[8:16]]) with n = ln(v); p is a
// pre-norm MLP block of the packed layout.
template <bool kLow>
__device__ __forceinline__ void mlp_residual(float (&v)[kC],
                                             const float* p) {
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
    for (int c = 0; c < kC; ++c)
        n[c] = operand<kLow>((v[c] - mu) * inv * p[kMlpNorm + c]);
    float h[16];
#pragma unroll
    for (int o = 0; o < 16; ++o) {
        float a = p[kMlpFc1B + o];
#pragma unroll
        for (int i = 0; i < 8; ++i) a = fmaf(p[kMlpFc1W + o * 8 + i], n[i], a);
        h[o] = operand<kLow>(silu(a));
    }
    float cat[kC];
#pragma unroll
    for (int o = 0; o < 8; ++o) {
        float a = p[kMlpFc2B + o];
#pragma unroll
        for (int i = 0; i < 16; ++i) a = fmaf(p[kMlpFc2W + o * 16 + i], h[i], a);
        cat[o] = a;
    }
#pragma unroll
    for (int c = 8; c < kC; ++c) cat[c] = n[c];
    // channel shuffle (g d) -> (d g), 8 groups of 2: out[d * 8 + g] = in[2g + d]
#pragma unroll
    for (int j = 0; j < kC; ++j) v[j] += cat[(j % 8) * 2 + j / 8];
}

__device__ __forceinline__ void store16(float* __restrict__ dst,
                                        const float (&v)[kC], int b, int H,
                                        int W, int gy, int gx) {
    const size_t plane = (size_t)H * W;
    float* d = dst + (size_t)b * kC * plane + (size_t)gy * W + gx;
#pragma unroll
    for (int c = 0; c < kC; ++c) d[c * plane] = v[c];
}

struct Tile {
    int x0, y0, b, tx, ty, gx, gy;
    __device__ Tile(int W) {
        const int tilesW = (W + kTw - 1) / kTw;
        x0 = (blockIdx.x % tilesW) * kTw;
        y0 = (blockIdx.x / tilesW) * kTh;
        b = blockIdx.y;
        tx = threadIdx.x % kTw;
        ty = threadIdx.x / kTw;
        gx = x0 + tx;
        gy = y0 + ty;
    }
};

// Launch 1. x (B, 32, H, W) -> v = to_feat(x), t = v + mlp(ln(v)) with
// block0.sm1's pre-norm MLP.
template <bool kLow, typename Tin>
__global__ void __launch_bounds__(kThreads)
mixer_head_kernel(const Tin* __restrict__ x, const float* __restrict__ prm,
                  float* __restrict__ v_out, float* __restrict__ t_out, int H,
                  int W) {
    extern __shared__ float4 smem4[];
    float* wsh = reinterpret_cast<float*>(smem4);   // (32, 9, 16)
    float* mlp = wsh + kCin * 9 * kC;
    float* slab = mlp + kMlpSize;
    using S = Slab<kCin, 1>;
    const Tile t(W);
    stage(wsh, prm + kToFeat, kCin * 9 * kC);
    stage(mlp, prm + kBlock0 + kBlkSm1, kMlpSize);
    stage_slab<kCin, 1, kLow>(slab, x + (size_t)t.b * kCin * H * W, H, W,
                              t.y0, t.x0);
    __syncthreads();
    float v[kC];
#pragma unroll
    for (int c = 0; c < kC; ++c) v[c] = 0.0f;
    for (int ci = 0; ci < kCin; ++ci) {
#pragma unroll
        for (int kh = 0; kh < 3; ++kh) {
#pragma unroll
            for (int kw = 0; kw < 3; ++kw) {
                const float a =
                    slab[(ci * S::h + t.ty + kh) * S::w + t.tx + kw];
                const float4* w4 = reinterpret_cast<const float4*>(
                    wsh + (ci * 9 + kh * 3 + kw) * kC);
#pragma unroll
                for (int q = 0; q < kC / 4; ++q) {
                    const float4 w = w4[q];
                    v[4 * q + 0] = fmaf(a, w.x, v[4 * q + 0]);
                    v[4 * q + 1] = fmaf(a, w.y, v[4 * q + 1]);
                    v[4 * q + 2] = fmaf(a, w.z, v[4 * q + 2]);
                    v[4 * q + 3] = fmaf(a, w.w, v[4 * q + 3]);
                }
            }
        }
    }
    if (t.gy >= H || t.gx >= W) return;
    store16(v_out, v, t.b, H, W, t.gy, t.gx);
    mlp_residual<kLow>(v, mlp);
    store16(t_out, v, t.b, H, W, t.gy, t.gx);
}

// Launches 2, 3, 5, 6. One SMLayer's dw 7x7 + bias and post-norm MLP
// residual on in (B, 16, H, W); then the next SMLayer's pre-norm MLP
// residual (next != nullptr) or + residual (the FMBlock's input).
template <bool kLow>
__global__ void __launch_bounds__(kThreads)
mixer_dw_kernel(const float* __restrict__ in, const float* __restrict__ sm,
                const float* __restrict__ next,
                const float* __restrict__ residual, float* __restrict__ out,
                int H, int W) {
    extern __shared__ float4 smem4[];
    float* prm = reinterpret_cast<float*>(smem4);   // dw w, dw b, post MLP
    float* nxt = prm + kDwParams;
    float* slab = nxt + kMlpSize;
    using S = Slab<kC, 3>;
    const Tile t(W);
    stage(prm, sm + kSmDwW, kDwParams);
    if (next != nullptr) stage(nxt, next, kMlpSize);
    stage_slab<kC, 3, kLow>(slab, in + (size_t)t.b * kC * H * W, H, W, t.y0,
                            t.x0);
    __syncthreads();
    if (t.gy >= H || t.gx >= W) return;
    const float* dw = prm;                            // (16, 49)
    const float* dwb = prm + (kSmDwB - kSmDwW);
    float u[kC];
#pragma unroll
    for (int c = 0; c < kC; ++c) {
        float a = dwb[c];
        const float* sc = slab + (c * S::h + t.ty) * S::w + t.tx;
#pragma unroll
        for (int kh = 0; kh < 7; ++kh)
#pragma unroll
            for (int kw = 0; kw < 7; ++kw)
                a = fmaf(sc[kh * S::w + kw], dw[c * 49 + kh * 7 + kw], a);
        u[c] = a;
    }
    mlp_residual<kLow>(u, prm + (kSmPost - kSmDwW));
    if (next != nullptr) {
        mlp_residual<kLow>(u, nxt);
    } else {
        const size_t plane = (size_t)H * W;
        const float* r = residual + (size_t)t.b * kC * plane +
                         (size_t)t.gy * W + t.gx;
#pragma unroll
        for (int c = 0; c < kC; ++c) u[c] += r[c * plane];
    }
    store16(out, u, t.b, H, W, t.gy, t.gx);
}

// Launches 4 and 7. An FMBlock's tail on x2 (B, 16, H, W):
// v = project(silu(expand(x2))) + x2. Then either the next block's
// pre-norm MLP residual (next != nullptr: writes v and t), or the up
// conv + SiLU, stored pixel-shuffled into y (B, 16, 2H, 2W).
template <bool kLow, typename Tout>
__global__ void __launch_bounds__(kThreads)
mixer_expand_kernel(const float* __restrict__ in, const float* __restrict__ blk,
                    const float* __restrict__ next,
                    const float* __restrict__ up, float* __restrict__ v_out,
                    float* __restrict__ t_out, Tout* __restrict__ y, int H,
                    int W) {
    extern __shared__ float4 smem4[];
    float* prm = reinterpret_cast<float*>(smem4);   // expand, project
    float* tail = prm + kExpParams;                 // next MLP or up
    float* slab = tail + kUpSize;
    using S = Slab<kC, 1>;
    const Tile t(W);
    stage(prm, blk + kBlkExpW, kExpParams);
    if (next != nullptr)
        stage(tail, next, kMlpSize);
    else
        stage(tail, up, kUpSize);
    stage_slab<kC, 1>(slab, in + (size_t)t.b * kC * H * W, H, W, t.y0, t.x0);
    __syncthreads();
    if (t.gy >= H || t.gx >= W) return;
    const float* ew = prm;                                // (16, 9, 32)
    const float* eb = prm + (kBlkExpB - kBlkExpW);
    const float* pw = prm + (kBlkProjW - kBlkExpW);       // (16, 32)
    const float* pb = prm + (kBlkProjB - kBlkExpW);
    float z[2 * kC];
#pragma unroll
    for (int o = 0; o < 2 * kC; ++o) z[o] = eb[o];
    for (int ci = 0; ci < kC; ++ci) {
#pragma unroll
        for (int kh = 0; kh < 3; ++kh) {
#pragma unroll
            for (int kw = 0; kw < 3; ++kw) {
                // x2 stays fp32 in the slab: it is also the residual
                const float a = operand<kLow>(
                    slab[(ci * S::h + t.ty + kh) * S::w + t.tx + kw]);
                const float4* w4 = reinterpret_cast<const float4*>(
                    ew + (ci * 9 + kh * 3 + kw) * 2 * kC);
#pragma unroll
                for (int q = 0; q < 2 * kC / 4; ++q) {
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
    for (int o = 0; o < 2 * kC; ++o) z[o] = operand<kLow>(silu(z[o]));
    float v[kC];
#pragma unroll
    for (int o = 0; o < kC; ++o) {
        float a = pb[o];
#pragma unroll
        for (int i = 0; i < 2 * kC; ++i) a = fmaf(pw[o * 2 * kC + i], z[i], a);
        v[o] = a + slab[(o * S::h + t.ty + 1) * S::w + t.tx + 1];
    }
    if (next != nullptr) {
        store16(v_out, v, t.b, H, W, t.gy, t.gx);
        mlp_residual<kLow>(v, tail);
        store16(t_out, v, t.b, H, W, t.gy, t.gx);
        return;
    }
#pragma unroll
    for (int o = 0; o < kC; ++o) v[o] = operand<kLow>(v[o]);
    const float* uw = tail;                              // (64, 16)
    const float* ub = tail + (kUpB - kUpW);
    const size_t plane = (size_t)(2 * H) * (2 * W);
    Tout* yb = y + (size_t)t.b * kC * plane;
#pragma unroll
    for (int o = 0; o < 4 * kC; ++o) {
        float a = ub[o];
#pragma unroll
        for (int i = 0; i < kC; ++i) a = fmaf(uw[o * kC + i], v[i], a);
        const int c = o / 4, i = (o / 2) % 2, j = o % 2;
        put(yb + c * plane + (size_t)(2 * t.gy + i) * (2 * W) + 2 * t.gx + j,
            silu(a));
    }
}

int smem_limit(const void* fn, int floats) {
    return (int)cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
        floats * (int)sizeof(float));
}

// The seven launches in one form (Tin and Tout fp32 with kLow false, or
// bf16), the first `stop` of them: all seven in the model, fewer for a
// check that reads the workspace after each.
template <bool kLow, typename Tin, typename Tout>
int launch_mixer(const void* xv, const float* params, void* yv, float* ws,
                 int B, int H, int W, int stop, cudaStream_t stream) {
    auto head = mixer_head_kernel<kLow, Tin>;
    auto dwk = mixer_dw_kernel<kLow>;
    auto expk = mixer_expand_kernel<kLow, Tout>;
    int err = smem_limit((const void*)head, kHeadSmem);
    if (!err) err = smem_limit((const void*)dwk, kDwSmem);
    if (!err) err = smem_limit((const void*)expk, kExpSmem);
    if (err) return err;
    const Tin* x = static_cast<const Tin*>(xv);
    Tout* y = static_cast<Tout*>(yv);
    const size_t n = (size_t)B * kC * H * W;
    float* V = ws;
    float* T = ws + n;
    float* U = ws + 2 * n;
    const float* b0 = params + kBlock0;
    const float* b1 = params + kBlock1;
    const dim3 grid(((W + kTw - 1) / kTw) * ((H + kTh - 1) / kTh), B);
    const size_t hsm = kHeadSmem * sizeof(float);
    const size_t dsm = kDwSmem * sizeof(float);
    const size_t esm = kExpSmem * sizeof(float);
    int done = 0;
#define MIXER_CHECK()                              \
    do {                                           \
        const int e = (int)cudaGetLastError();     \
        if (e) return e;                           \
        if (++done == stop) return 0;              \
    } while (0)
    head<<<grid, kThreads, hsm, stream>>>(x, params, V, T, H, W);
    MIXER_CHECK();
    dwk<<<grid, kThreads, dsm, stream>>>(T, b0 + kBlkSm1, b0 + kBlkSm2,
                                         nullptr, U, H, W);
    MIXER_CHECK();
    dwk<<<grid, kThreads, dsm, stream>>>(U, b0 + kBlkSm2, nullptr, V, T, H,
                                         W);
    MIXER_CHECK();
    expk<<<grid, kThreads, esm, stream>>>(T, b0, b1 + kBlkSm1, nullptr, V, U,
                                          nullptr, H, W);
    MIXER_CHECK();
    dwk<<<grid, kThreads, dsm, stream>>>(U, b1 + kBlkSm1, b1 + kBlkSm2,
                                         nullptr, T, H, W);
    MIXER_CHECK();
    dwk<<<grid, kThreads, dsm, stream>>>(T, b1 + kBlkSm2, nullptr, V, U, H,
                                         W);
    MIXER_CHECK();
    expk<<<grid, kThreads, esm, stream>>>(U, b1, nullptr, params + kUpW,
                                          nullptr, nullptr, y, H, W);
    MIXER_CHECK();
#undef MIXER_CHECK
    return 0;
}

}  // namespace

extern "C" int mixer_params_size() { return kParams; }

extern "C" long long mixer_workspace_floats(int B, int H, int W) {
    return 3LL * B * kC * H * W;
}

// All tensors contiguous; returns a cudaError_t. x: (B, 32, H, W); params:
// the packed layout (kParams floats, fp32); y: (B, 16, 2H, 2W); ws:
// mixer_workspace_floats(B, H, W) floats. With low_precision 0, x and y are
// fp32; with 1 (the bf16 form, its packed weights rounded to bf16) they are
// bf16. stop: the launches to run, 7 (all) in the model, 1-6 to read the
// workspace after each (y is then not written).
extern "C" int fused_mixer(const void* x, const float* params, void* y,
                           float* ws, int B, int H, int W, int low_precision,
                           int stop, cudaStream_t stream) {
    if (B < 1 || H < 1 || W < 1 || stop < 1 || stop > 7)
        return (int)cudaErrorInvalidValue;
    using bf16 = __nv_bfloat16;
    return low_precision
        ? launch_mixer<true, bf16, bf16>(x, params, y, ws, B, H, W, stop,
                                         stream)
        : launch_mixer<false, float, float>(x, params, y, ws, B, H, W, stop,
                                            stream);
}
