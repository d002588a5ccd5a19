// Kernel A: backbone stem + stage 0, eval mode, fp32, in the two layouts
// of the JAX kernel (efficientnet_b2 and mobilenetv2_100), writing fp32 or
// bf16.
//
// Replaces esmstereo_tpu/ops/pallas/fused_head.py::fused_stage0_apply
// (pallas_call at :393). From an NCHW image (B, 3, Hi, Wi) it computes, on the
// (Hi/2, Wi/2) grid, for efficientnet_b2 (2 blocks with SqueezeExcite, SiLU):
//   x0 = relu6(conv3x3 s2 p1 (img) + b)                       32 ch (stem)
//   a0 = silu(dw3x3(x0) + b); g0 = SE(mean a0)                 block 0
//   y0 = pw(a0 * g0) + b                                      16 ch
//   a1 = silu(dw3x3(y0) + b); g1 = SE(mean a1)                 block 1
//   out = pw(a1 * g1) + b + y0                                16 ch
// and for mobilenetv2_100 (1 block, no SE, no residual since 32 != 16, ReLU6
// on the stem and on the dw, nothing after the pw; JAX fused_head.py:93-98,
// 217-221, and the stem's ReLU6 on both backbones, backbones/efficientnet.py
// :10-13):
//   x0 = relu6(conv3x3 s2 p1 (img) + b)                       32 ch (stem)
//   out = pw(relu6(dw3x3(x0) + b)) + b                        16 ch
// with every eval BatchNorm folded into the weights and biases by the
// wrapper; SE(m) = sigmoid(W2 silu(W1 m + b1) + b2).
//
// What bounds it on an H100: operations, narrowly. At 2 x 544 x 992 the image
// is read and the output written once (13.0 MB in, 17.3 MB out: 0.009 ms at
// 3.35 TB/s), against 2064 multiply-adds per output pixel (1.1 GFLOP: 0.017
// ms at the 67 TFLOP/s fp32 rate of the CUDA cores). So the design keeps
// issue slots and shared-memory cycles for the FMAs:
//
//   * The stem's and the 1x1 convs' weights are staged once a block in
//     shared memory (cp.async), [tap or input channel][output channel], and
//     read as broadcast float4s that each feed the FMAs of 2 or 3 pixels of
//     a thread. The dw 3x3 weights, the biases and the SE MLPs (1.2 KB
//     read a tile) are immediate constant-bank operands of their FFMAs
//     (c_eff, c_mob, copied device to device on the stream before each
//     launch; two calls with other weights must therefore be ordered on
//     one stream, as the port's are). On the H100 the 1x1 convs' 2 KB in
//     the constant bank were slower than in shared memory: the constant
//     cache holds a few KB.
//   * The image patch is staged by cp.async (a thread's copies all in
//     flight), each row's even columns first, so that the stem's stride-2
//     reads of a warp fall on distinct banks; y0 and the SE partials,
//     written by other blocks, are read through L2 (__ldcg) in batches.
//   * The dw 3x3 gives a thread a vertical pair of pixels: 12 reads feed
//     18 FMAs (9 for 9 one pixel a thread).
//   * Tiles of 12 x 32 output pixels, 192 threads, a vertical pair of
//     pixels a thread: the stem's 1-pixel halo costs 1.24 times the tile
//     (the old 4 x 32 tile 1.59); at 2 x 544 x 992, 736 tiles fill two
//     rounds of 396 blocks to 93%. The stem's 32 channels are staged in
//     shared memory 8 at a time, so that three blocks fit an SM.
//   * One launch for the efficientnet form: a cooperative, persistent grid
//     (cudaLaunchCooperativeKernel, all blocks resident; the plan sizes it
//     and the entry point refuses a grid the card cannot hold), whose blocks
//     walk the tiles in each phase and meet at grid barriers (an integer
//     counter; no float atomics) where SqueezeExcite needs a mean over the
//     image. The means are sums of per-tile partials, each summed in a
//     fixed order (a warp tree, then the warps in order), then over the
//     tiles by the block's threads in fixed strands and the strands in
//     order: every block computes the same gates, and every run the same
//     bits.
//   * The phases: 1 stem + dw0 on each tile -> a0 stored (32 ch, fp32),
//     tile sums of a0 | gate 0 | 2 per pixel: y0 = pw0(a0 * g0) stored |
//     barrier | 3 y0 with its halo, dw1 -> a1 stored, tile sums of a1 |
//     gate 1 | 4 per pixel: out = pw1(a1 * g1) + b + y0. a0, y0 and a1 make
//     a round trip through device memory (about 200 MB at 2 x 544 x 992).
//     Recomputing the stem and dw0 on a 2-pixel halo in phase 2 instead of
//     storing a0 (about 120 MB less, 1,500 more multiply-adds a pixel) took
//     0.262 ms at L on the H100 against this design's 0.171 (PERF.md).
//
// mobilenetv2_100's form needs no mean over the image, so it is one
// ordinary launch of a block a tile (stage0_single): phase 1's stem and dw
// (ReLU6), then the pw summed over the four channel chunks in registers,
// and only the 16-channel output leaves the block. At 2 x 544 x 992 it
// moves the same bytes as the efficientnet form for 1664 multiply-adds a
// pixel (0.013 ms at 67 TFLOP/s): operations bound it, narrowly.
//
// The bf16 form (the deploy numerics): everything inside stays fp32, as the
// JAX kernel's is, and the last phase rounds each output to bf16 as it
// stores it (round to nearest even): the JAX model casts the kernel's fp32
// output to the compute dtype (esmstereo_tpu/backbones/fused.py:174-175).
// No extra cast launch follows.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "activations.cuh"
#include "async_copy.cuh"

namespace {

// efficientnet_b2 stage 0: stem 3 -> 32, DS block 32 -> 16 (SE 8),
// DS block 16 -> 16 (SE 4) with a residual.
constexpr int C0 = 32, R0 = 8, C1 = 16, R1 = 4, C2 = 16;
constexpr int kTh = 12, kTw = 32, kThreads = 192;
constexpr int kPix = kTh * kTw / kThreads;   // tile pixels a thread
constexpr int kChunk = 8;                    // stem channels staged at once
constexpr int kChunks = 32 / kChunk;
constexpr int kWarps = kThreads / 32;
static_assert(kTw == 32 && kTh * kTw % kThreads == 0, "a warp a tile row");

// packed parameter layout (floats); the wrapper packs in this order
constexpr int OFF_STEM_W = 0;                      // [C0][3][3][3]
constexpr int OFF_STEM_B = OFF_STEM_W + C0 * 27;   // [C0]
constexpr int OFF_DW0_W = OFF_STEM_B + C0;         // [C0][9]
constexpr int OFF_DW0_B = OFF_DW0_W + C0 * 9;      // [C0]
constexpr int OFF_SE0_W1 = OFF_DW0_B + C0;         // [R0][C0]
constexpr int OFF_SE0_B1 = OFF_SE0_W1 + R0 * C0;   // [R0]
constexpr int OFF_SE0_W2 = OFF_SE0_B1 + R0;        // [C0][R0]
constexpr int OFF_SE0_B2 = OFF_SE0_W2 + C0 * R0;   // [C0]
constexpr int OFF_PW0_W = OFF_SE0_B2 + C0;         // [C1][C0]
constexpr int OFF_PW0_B = OFF_PW0_W + C1 * C0;     // [C1]
constexpr int OFF_DW1_W = OFF_PW0_B + C1;          // [C1][9]
constexpr int OFF_DW1_B = OFF_DW1_W + C1 * 9;      // [C1]
constexpr int OFF_SE1_W1 = OFF_DW1_B + C1;         // [R1][C1]
constexpr int OFF_SE1_B1 = OFF_SE1_W1 + R1 * C1;   // [R1]
constexpr int OFF_SE1_W2 = OFF_SE1_B1 + R1;        // [C1][R1]
constexpr int OFF_SE1_B2 = OFF_SE1_W2 + C1 * R1;   // [C1]
constexpr int OFF_PW1_W = OFF_SE1_B2 + C1;         // [C2][C1]
constexpr int OFF_PW1_B = OFF_PW1_W + C2 * C1;     // [C2]
constexpr int kParams = OFF_PW1_B + C2;

// mobilenetv2_100 stage 0: stem 3 -> 32 (as above), DS block 32 -> C1 = 16
// without SE or residual
constexpr int M_OFF_DW_W = OFF_STEM_B + C0;        // [C0][9]
constexpr int M_OFF_DW_B = M_OFF_DW_W + C0 * 9;    // [C0]
constexpr int M_OFF_PW_W = M_OFF_DW_B + C0;        // [C1][C0]
constexpr int M_OFF_PW_B = M_OFF_PW_W + C1 * C0;   // [C1]
constexpr int kParamsSingle = M_OFF_PW_B + C1;

__constant__ float c_eff[kParams];
__constant__ float c_mob[kParamsSingle];

// Weights staged in shared memory, each read as a broadcast float4 that
// feeds several pixels' FMAs: the stem [27 taps][C0] then its bias, and the
// pointwise convs [in][out] then their bias (pw0, or mobilenetv2's pw; pw1).
// The dw weights and the SE MLPs stay in the constant bank.
constexpr int kWPw0 = 28 * C0;
constexpr int kWPw1 = kWPw0 + (C0 + 1) * C1;
constexpr int kWeights = kWPw1 + (C1 + 1) * C2;
static_assert(kWPw0 % 4 == 0 && kWPw1 % 4 == 0 && kWeights % 4 == 0, "float4 rows");

// the packed layouts the wrapper may pass (fused_stage0's `form`)
enum Form { kEfficientNetB2 = 0, kMobileNetV2 = 1 };

template <int F>
__device__ __forceinline__ float prm(int i) {
    if constexpr (F == kEfficientNetB2) {
        return c_eff[i];
    } else {
        return c_mob[i];
    }
}

template <int F>
__device__ __forceinline__ float act(float x) {
    if constexpr (F == kEfficientNetB2) {
        return silu_fast(x);
    } else {
        return relu6(x);
    }
}

template <typename T>
__device__ __forceinline__ T store_as(float v);
template <>
__device__ __forceinline__ float store_as<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 store_as<__nv_bfloat16>(float v) {
    return __float2bfloat16_rn(v);
}

__host__ __device__ constexpr int patch_floats(int ny, int nx) {
    return 3 * (2 * ny + 1) * (2 * nx + 1);
}
// x0 (phase 1) and y0 (phase 3) on the tile and a 1-pixel halo
constexpr int kNy1 = kTh + 2, kNx1 = kTw + 2;
constexpr int kPhase1 = patch_floats(kNy1, kNx1) + kChunk * kNy1 * kNx1;
constexpr int kY0Halo = C1 * kNy1 * kNx1;
// dynamic shared floats a block: the staged weights, the largest phase,
// then the gates of every image (B * (C0 + C1));
// ops/kernels/fused_head.py::stage0_smem mirrors this
constexpr int smem_floats(int form, int B) {
    return kWeights + kPhase1 + (form == kMobileNetV2 ? 0 : B * (C0 + C1));
}
static_assert(kY0Halo <= kPhase1, "y0 fits in phase 1's space");

struct Tile {
    int b, y0, x0;
};

__device__ __forceinline__ Tile tile_at(int t, int tiles, int tx) {
    const int r = t % tiles;
    return {t / tiles, (r / tx) * kTh, (r % tx) * kTw};
}

// Image rows/cols feeding x0 rows [gy0, gy0+NY) and cols [gx0, gx0+NX):
// rows 2*gy0-1 .. 2*(gy0+NY)-1, zero outside the image (the conv's padding),
// by cp.async: a thread's copies are all in flight at once. The caller's
// __syncthreads after it makes the patch whole. Each patch row holds its
// even columns, then its odd ones (patch_col), so that the stride-2 stem
// reads of a warp fall in distinct banks.
template <int PW>
__device__ __forceinline__ int patch_col(int q) {
    return (q & 1) ? (PW + 1) / 2 + (q >> 1) : (q >> 1);
}

template <int NY, int NX>
__device__ void load_patch(const float* __restrict__ img, float* patch, int gy0, int gx0,
                           int Hi, int Wi) {
    constexpr int ph = 2 * NY + 1, pw = 2 * NX + 1;
    const size_t plane = (size_t)Hi * Wi;
    for (int i = threadIdx.x; i < 3 * ph * pw; i += kThreads) {
        const int c = i / (ph * pw);
        const int r = (i / pw) % ph;
        const int q = i % pw;
        const int iy = 2 * gy0 - 1 + r, ix = 2 * gx0 - 1 + q;
        const bool in = iy >= 0 && iy < Hi && ix >= 0 && ix < Wi;
        cp_async4(patch + (c * ph + r) * pw + patch_col<pw>(q),
                  in ? img + c * plane + (size_t)iy * Wi + ix : img, in);
    }
    cp_async_commit();
    cp_async_wait_all();
}

// f(std::integral_constant<int, K>) for the chunks K = 0 .. kChunks - 1,
// in order: a chunk's weight offsets are compile-time constants.
template <int K = 0, typename Fn>
__device__ __forceinline__ void for_chunks(Fn&& f) {
    if constexpr (K < kChunks) {
        f(std::integral_constant<int, K>{});
        for_chunks<K + 1>(f);
    }
}

// The weights of the shared-memory layout above, by cp.async (the caller's
// first wait and __syncthreads make them whole): [k][c] from the packed
// [c][k], each bias after its matrix.
template <int F>
__device__ void stage_weights(const float* __restrict__ params, float* wst) {
    constexpr int pw_w = F == kEfficientNetB2 ? OFF_PW0_W : M_OFF_PW_W;
    constexpr int pw_b = F == kEfficientNetB2 ? OFF_PW0_B : M_OFF_PW_B;
    for (int i = threadIdx.x; i < kWeights; i += kThreads) {
        int src = -1;
        if (i < kWPw0) {
            const int k = i / C0, c = i % C0;
            src = k < 27 ? OFF_STEM_W + c * 27 + k : OFF_STEM_B + c;
        } else if (i < kWPw1) {
            const int c = (i - kWPw0) / C1, o = (i - kWPw0) % C1;
            src = c < C0 ? pw_w + o * C0 + c : pw_b + o;
        } else if (F == kEfficientNetB2) {
            const int c = (i - kWPw1) / C2, o = (i - kWPw1) % C2;
            src = c < C1 ? OFF_PW1_W + o * C1 + c : OFF_PW1_B + o;
        }
        cp_async4(wst + i, params + (src < 0 ? 0 : src), src >= 0);
    }
    cp_async_commit();
}

// y[j][o] += w[c][o] * a[j][c] over the CI channels of a, in order, for P
// pixels: w is a [CI][CO] block of the shared-memory weights, each float4
// of it read once for the P pixels.
template <int P, int CI, int CO>
__device__ __forceinline__ void pw_acc(const float* w, const float (&a)[P][CI],
                                       float (&y)[P][CO]) {
#pragma unroll
    for (int c = 0; c < CI; ++c) {
        const float4* w4 = reinterpret_cast<const float4*>(w + c * CO);
#pragma unroll
        for (int q = 0; q < CO / 4; ++q) {
            const float4 wv = w4[q];
#pragma unroll
            for (int j = 0; j < P; ++j) {
                y[j][4 * q + 0] = fmaf(wv.x, a[j][c], y[j][4 * q + 0]);
                y[j][4 * q + 1] = fmaf(wv.y, a[j][c], y[j][4 * q + 1]);
                y[j][4 * q + 2] = fmaf(wv.z, a[j][c], y[j][4 * q + 2]);
                y[j][4 * q + 3] = fmaf(wv.w, a[j][c], y[j][4 * q + 3]);
            }
        }
    }
}

// y[j][o] = the bias of the [CI][CO] block at w, for P pixels.
template <int P, int CI, int CO>
__device__ __forceinline__ void pw_bias(const float* w, float (&y)[P][CO]) {
#pragma unroll
    for (int j = 0; j < P; ++j)
#pragma unroll
        for (int o = 0; o < CO; ++o) y[j][o] = w[CI * CO + o];
}

// x0 channels [K * kChunk, (K + 1) * kChunk) = relu6(stem conv) on the
// [ny][nx] region at grid origin (gy0, gx0), into x0[kChunk][ny][nx];
// zero outside the grid, which is the dw conv's zero padding. Each sum is
// the bias, then the 27 taps in order.
template <int F, int K, int ny, int nx>
__device__ void stem_chunk(const float* patch, const float* wst, float* x0, int gy0, int gx0,
                           int H, int W) {
    constexpr int ph = 2 * ny + 1, pw = 2 * nx + 1, n = ny * nx;
    for (int i0 = threadIdx.x; i0 < n; i0 += 3 * kThreads) {
        int base[3];
#pragma unroll
        for (int j = 0; j < 3; ++j) {
            const int i = i0 + j * kThreads < n ? i0 + j * kThreads : i0;
            base[j] = 2 * (i / nx) * pw + i % nx;  // column 2 (i % nx), split by parity
        }
        float acc[3][kChunk];
#pragma unroll
        for (int j = 0; j < 3; ++j)
#pragma unroll
            for (int c = 0; c < kChunk; ++c) acc[j][c] = wst[27 * C0 + K * kChunk + c];
#pragma unroll
        for (int ci = 0; ci < 3; ++ci)
#pragma unroll
            for (int kh = 0; kh < 3; ++kh)
#pragma unroll
                for (int kw = 0; kw < 3; ++kw) {
                    const int k = ci * 9 + kh * 3 + kw;
                    float v[3];
#pragma unroll
                    for (int j = 0; j < 3; ++j)
                        v[j] = patch[ci * ph * pw + kh * pw + patch_col<pw>(kw) + base[j]];
                    const float4* w4 =
                        reinterpret_cast<const float4*>(wst + k * C0 + K * kChunk);
#pragma unroll
                    for (int q = 0; q < kChunk / 4; ++q) {
                        const float4 w = w4[q];
#pragma unroll
                        for (int j = 0; j < 3; ++j) {
                            acc[j][4 * q + 0] = fmaf(w.x, v[j], acc[j][4 * q + 0]);
                            acc[j][4 * q + 1] = fmaf(w.y, v[j], acc[j][4 * q + 1]);
                            acc[j][4 * q + 2] = fmaf(w.z, v[j], acc[j][4 * q + 2]);
                            acc[j][4 * q + 3] = fmaf(w.w, v[j], acc[j][4 * q + 3]);
                        }
                    }
                }
#pragma unroll
        for (int j = 0; j < 3; ++j) {
            const int i = i0 + j * kThreads;
            if (i >= n) continue;
            const int gy = gy0 + i / nx, gx = gx0 + i % nx;
            const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
#pragma unroll
            for (int c = 0; c < kChunk; ++c) x0[c * n + i] = in ? relu6(acc[j][c]) : 0.0f;
        }
    }
}

// a[j][c] = act(dw3x3(t)[c] + b) for C channels of a [C][ny][nx] map at
// the vertical pair of positions (ly + j, lx), the weights of channels
// C0FF + c at OFFW/OFFB: each of the 4 rows read once for both; each sum
// the bias, then the taps in row-major order.
template <int F, int C, int OFFW, int OFFB, int C0FF>
__device__ __forceinline__ void dw_act_pair(const float* t, int ny, int nx, int ly, int lx,
                                            float (&a)[2][C]) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
        const float* tc = t + c * ny * nx + (ly - 1) * nx + lx - 1;
        float s0 = prm<F>(OFFB + C0FF + c), s1 = s0;
#pragma unroll
        for (int row = 0; row < 4; ++row) {
            float v[3];
#pragma unroll
            for (int kw = 0; kw < 3; ++kw) v[kw] = tc[row * nx + kw];
#pragma unroll
            for (int kw = 0; kw < 3; ++kw) {
                if (row < 3) s0 = fmaf(prm<F>(OFFW + (C0FF + c) * 9 + row * 3 + kw), v[kw], s0);
                if (row > 0)
                    s1 = fmaf(prm<F>(OFFW + (C0FF + c) * 9 + (row - 1) * 3 + kw), v[kw], s1);
            }
        }
        a[0][c] = act<F>(s0);
        a[1][c] = act<F>(s1);
    }
}

// A thread's two tile pixels: rows 2w and 2w + 1 of warp w, its lane's
// column.
__device__ __forceinline__ int pair_row() { return 2 * (threadIdx.x / kTw); }
__device__ __forceinline__ int pair_col() { return threadIdx.x % kTw; }
static_assert(kPix == 2 && kTh == 2 * kWarps, "a vertical pair a thread");

// Sum v[C] over the block's threads in a fixed order (a warp tree, then
// the warps in order); thread c < C writes the channel sum to out[c].
template <int C>
__device__ void block_sums(const float (&v)[C], float* red, float* __restrict__ out) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int c = 0; c < C; ++c) {
        float s = v[c];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
        if (lane == 0) red[warp * C + c] = s;
    }
    __syncthreads();
    if (threadIdx.x < C) {
        float s = 0.0f;
        for (int k = 0; k < kWarps; ++k) s += red[k * C + threadIdx.x];
        out[threadIdx.x] = s;
    }
}

// Wait until every block of the (cooperative, all-resident) grid has
// arrived at its n-th barrier: an integer counter zeroed before the launch.
// Data another block wrote before the barrier is read after it with
// __ldcg (L2), never from a stale L1 line.
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

// Phase 1 on one tile: the stem on its 1-pixel halo and the dw on the tile,
// kChunk channels at a time. The efficientnet form stores a0 (B, C0, H, W)
// and writes the tile's channel sums of a0 to partial[C0]; the mobilenet
// form sums the pw over the chunks in registers and writes out (B, C1, H,
// W).
template <int F, typename Tout>
__device__ void stage0_first(const float* __restrict__ img, const float* wst, float* sm,
                             float* red, Tile t, int Hi, int Wi, float* __restrict__ partial,
                             float* __restrict__ a0buf, Tout* __restrict__ out) {
    const int H = Hi / 2, W = Wi / 2;
    const size_t plane = (size_t)H * W;
    float* patch = sm;
    float* x0 = sm + patch_floats(kNy1, kNx1);
    int ly[kPix], lx[kPix];
    bool in[kPix];
#pragma unroll
    for (int j = 0; j < kPix; ++j) {
        ly[j] = pair_row() + j;
        lx[j] = pair_col();
        in[j] = t.y0 + ly[j] < H && t.x0 + lx[j] < W;
    }
    __syncthreads();  // the previous tile's or phase's shared memory is free
    load_patch<kNy1, kNx1>(img + (size_t)t.b * 3 * Hi * Wi, patch, t.y0 - 1, t.x0 - 1, Hi, Wi);
    float y[kPix][C1];
    if constexpr (F == kMobileNetV2) pw_bias<kPix, C0, C1>(wst + kWPw0, y);
    for_chunks([&](auto chunk) {
        constexpr int k = decltype(chunk)::value;
        __syncthreads();  // the patch is loaded; the last chunk's x0 is read
        stem_chunk<F, k, kNy1, kNx1>(patch, wst, x0, t.y0 - 1, t.x0 - 1, H, W);
        __syncthreads();
        float a[kPix][kChunk];
        dw_act_pair<F, kChunk, OFF_DW0_W, OFF_DW0_B, k * kChunk>(x0, kNy1, kNx1, ly[0] + 1,
                                                                lx[0] + 1, a);
        if constexpr (F == kEfficientNetB2) {
            float sums[kChunk];
#pragma unroll
            for (int c = 0; c < kChunk; ++c) {
                sums[c] = 0.0f;
#pragma unroll
                for (int j = 0; j < kPix; ++j) sums[c] += in[j] ? a[j][c] : 0.0f;
            }
#pragma unroll
            for (int j = 0; j < kPix; ++j) {
                if (!in[j]) continue;
                float* ab = a0buf + ((size_t)t.b * C0 + k * kChunk) * plane +
                            (size_t)(t.y0 + ly[j]) * W + t.x0 + lx[j];
#pragma unroll
                for (int c = 0; c < kChunk; ++c) ab[c * plane] = a[j][c];
            }
            block_sums<kChunk>(sums, red, partial + k * kChunk);
        } else {
            pw_acc<kPix, kChunk, C1>(wst + kWPw0 + k * kChunk * C1, a, y);
        }
    });
    if constexpr (F == kMobileNetV2) {
#pragma unroll
        for (int j = 0; j < kPix; ++j) {
            if (!in[j]) continue;
            Tout* ob = out + (size_t)t.b * C1 * plane + (size_t)(t.y0 + ly[j]) * W + t.x0 + lx[j];
#pragma unroll
            for (int o = 0; o < C1; ++o) ob[o * plane] = store_as<Tout>(y[j][o]);
        }
    }
}

// A SqueezeExcite gate of every image from the tile partials (B, tiles, C):
// the means summed over the tiles in fixed strands and the strands in
// order, then the MLP -> g[B][C] in shared memory. Every block computes the
// same bits.
template <int C, int R, int OW1, int OB1, int OW2, int OB2>
__device__ void se_gates(const float* __restrict__ partial, int B, int tiles, float inv_count,
                         float* g, float* red) {
    constexpr int S = kThreads / C;
    __shared__ float mean[C];
    __shared__ float hid[R];
    constexpr int kU = 32;  // loads in flight, summed in tile order
    const int c = threadIdx.x % C, s = threadIdx.x / C;
    for (int b = 0; b < B; ++b) {
        float sum = 0.0f;
        for (int k0 = s; k0 < tiles; k0 += kU * S) {
            float v[kU];
#pragma unroll
            for (int u = 0; u < kU; ++u) {
                const int k = k0 + u * S;
                v[u] = k < tiles ? __ldcg(partial + ((size_t)b * tiles + k) * C + c) : 0.0f;
            }
#pragma unroll
            for (int u = 0; u < kU; ++u) sum += v[u];
        }
        __syncthreads();  // red and mean are free
        red[s * C + c] = sum;
        __syncthreads();
        if (threadIdx.x < C) {
            float m = 0.0f;
            for (int q = 0; q < S; ++q) m += red[q * C + threadIdx.x];
            mean[threadIdx.x] = m * inv_count;
        }
        __syncthreads();
        if (threadIdx.x < R) {
            float h = c_eff[OB1 + threadIdx.x];
            for (int q = 0; q < C; ++q) h = fmaf(c_eff[OW1 + threadIdx.x * C + q], mean[q], h);
            hid[threadIdx.x] = silu(h);
        }
        __syncthreads();
        if (threadIdx.x < C) {
            float v = c_eff[OB2 + threadIdx.x];
            for (int r = 0; r < R; ++r) v = fmaf(c_eff[OW2 + threadIdx.x * R + r], hid[r], v);
            g[b * C + threadIdx.x] = sigmoid(v);
        }
    }
    __syncthreads();
}

// y0 of one tile and its 1-pixel halo (B, C1) from y0buf into
// y0s[C1][kNy1][kNx1], zero outside the grid: __ldcg (other blocks wrote
// it), twenty loads in flight a thread.
__device__ void load_y0(const float* __restrict__ y0buf, float* y0s, Tile t, int H, int W) {
    constexpr int n = C1 * kNy1 * kNx1, kU = 20;
    const size_t plane = (size_t)H * W;
    const float* yb = y0buf + (size_t)t.b * C1 * plane;
    for (int i0 = threadIdx.x; i0 < n; i0 += kU * kThreads) {
        float v[kU];
#pragma unroll
        for (int u = 0; u < kU; ++u) {
            const int i = i0 + u * kThreads;
            const int c = i / (kNy1 * kNx1);
            const int gy = t.y0 - 1 + (i / kNx1) % kNy1, gx = t.x0 - 1 + i % kNx1;
            v[u] = (i < n && gy >= 0 && gy < H && gx >= 0 && gx < W)
                       ? __ldcg(yb + c * plane + (size_t)gy * W + gx) : 0.0f;
        }
#pragma unroll
        for (int u = 0; u < kU; ++u)
            if (i0 + u * kThreads < n) y0s[i0 + u * kThreads] = v[u];
    }
}

// The tile's channel sums of a1 = silu(dw1(y0)) -> partial[C1], and a1
// (B, C1, H, W) stored, from y0 on the tile's 1-pixel halo in shared
// memory.
__device__ void dw1_sums(const float* y0s, float* red, Tile t, int H, int W,
                         float* __restrict__ partial, float* __restrict__ a1buf) {
    const int ly = pair_row(), lx = pair_col();
    float a[kPix][C1];
    dw_act_pair<kEfficientNetB2, C1, OFF_DW1_W, OFF_DW1_B, 0>(y0s, kNy1, kNx1, ly + 1, lx + 1, a);
    const size_t plane = (size_t)H * W;
#pragma unroll
    for (int j = 0; j < kPix; ++j) {
        const int gy = t.y0 + ly + j, gx = t.x0 + lx;
        if (gy >= H || gx >= W) continue;
        float* ab = a1buf + (size_t)t.b * C1 * plane + (size_t)gy * W + gx;
#pragma unroll
        for (int c = 0; c < C1; ++c) ab[c * plane] = a[j][c];
    }
    float sums[C1];
#pragma unroll
    for (int c = 0; c < C1; ++c) {
        sums[c] = 0.0f;
#pragma unroll
        for (int j = 0; j < kPix; ++j)
            sums[c] += t.y0 + ly + j < H && t.x0 + lx < W ? a[j][c] : 0.0f;
    }
    block_sums<C1>(sums, red, partial);
}

// Phase 2, per pixel over the grid: y0 = pw0(a0 * g0) + b.
__device__ void y0_pointwise(const float* __restrict__ a0buf, const float* wst, const float* g0,
                             int B, int H, int W, float* __restrict__ y0buf) {
    const size_t plane = (size_t)H * W;
    const size_t n = (size_t)B * plane;
    for (size_t p = (size_t)blockIdx.x * kThreads + threadIdx.x; p < n;
         p += (size_t)gridDim.x * kThreads) {
        const int b = (int)(p / plane);
        const size_t q = p % plane;
        const float* ab = a0buf + (size_t)b * C0 * plane + q;
        float a[1][C0];
#pragma unroll
        for (int c = 0; c < C0; ++c) a[0][c] = __ldcg(ab + c * plane) * g0[b * C0 + c];
        float y[1][C1];
        pw_bias<1, C0, C1>(wst + kWPw0, y);
        pw_acc<1, C0, C1>(wst + kWPw0, a, y);
        float* yb = y0buf + (size_t)b * C1 * plane + q;
#pragma unroll
        for (int o = 0; o < C1; ++o) yb[o * plane] = y[0][o];
    }
}

// Phase 4, per pixel over the grid: out = pw1(a1 * g1) + b + y0, rounded to
// Tout at the store.
template <typename Tout>
__device__ void out_pointwise(const float* __restrict__ a1buf, const float* __restrict__ y0buf,
                              const float* wst, const float* g1, int B, int H, int W,
                              Tout* __restrict__ out) {
    const size_t plane = (size_t)H * W;
    const size_t n = (size_t)B * plane;
    for (size_t p = (size_t)blockIdx.x * kThreads + threadIdx.x; p < n;
         p += (size_t)gridDim.x * kThreads) {
        const int b = (int)(p / plane);
        const size_t q = p % plane;
        const float* ab = a1buf + (size_t)b * C1 * plane + q;
        const float* yb = y0buf + (size_t)b * C1 * plane + q;
        float a[1][C1], r[C2];
#pragma unroll
        for (int c = 0; c < C1; ++c) a[0][c] = __ldcg(ab + c * plane) * g1[b * C1 + c];
#pragma unroll
        for (int o = 0; o < C2; ++o) r[o] = __ldcg(yb + o * plane);
        float y[1][C2];
        pw_bias<1, C1, C2>(wst + kWPw1, y);
        pw_acc<1, C1, C2>(wst + kWPw1, a, y);
        Tout* ob = out + (size_t)b * C2 * plane + q;
#pragma unroll
        for (int o = 0; o < C2; ++o) ob[o * plane] = store_as<Tout>(y[0][o] + r[o]);
    }
}

__host__ __device__ constexpr int tiles_x(int W) { return (W + kTw - 1) / kTw; }
__host__ __device__ constexpr int tiles_y(int H) { return (H + kTh - 1) / kTh; }

// Workspace floats of the efficientnet form: the barrier counter (4
// floats), partial0 (B, tiles, C0), partial1 (B, tiles, C1), y0 (B, C1, H,
// W), a0 (B, C0, H, W) and a1 (B, C1, H, W). The mobilenet form takes none.
long long workspace_floats(int form, int B, int Hi, int Wi) {
    if (form != kEfficientNetB2) return 0;
    const long long H = Hi / 2, W = Wi / 2;
    const long long nt = (long long)B * tiles_x(W) * tiles_y(H);
    return 4 + nt * (C0 + C1) + B * (C1 + C0 + C1) * H * W;
}

// The efficientnet form in one cooperative launch (see the header).
template <typename Tout>
__global__ void __launch_bounds__(kThreads, 3)
stage0_coop(const float* __restrict__ img, const float* __restrict__ params,
            Tout* __restrict__ out, float* __restrict__ ws, int B, int Hi, int Wi) {
    extern __shared__ float4 smem4[];
    float* wst = reinterpret_cast<float*>(smem4);
    float* sm = wst + kWeights;
    __shared__ float red[kThreads];
    const int H = Hi / 2, W = Wi / 2;
    const int tx = tiles_x(W), tiles = tx * tiles_y(H), nt = B * tiles;
    const size_t plane = (size_t)H * W;
    unsigned* count = reinterpret_cast<unsigned*>(ws);
    float* partial0 = ws + 4;
    float* partial1 = partial0 + (size_t)nt * C0;
    float* y0buf = partial1 + (size_t)nt * C1;
    float* a0buf = y0buf + (size_t)B * C1 * plane;
    float* a1buf = a0buf + (size_t)B * C0 * plane;
    float* g0 = sm + kPhase1;
    float* g1 = g0 + B * C0;
    const float inv_count = 1.0f / ((float)H * (float)W);

    stage_weights<kEfficientNetB2>(params, wst);
    for (int k = blockIdx.x; k < nt; k += gridDim.x)
        stage0_first<kEfficientNetB2, Tout>(img, wst, sm, red, tile_at(k, tiles, tx), Hi, Wi,
                                               partial0 + (size_t)k * C0, a0buf, nullptr);
    grid_barrier(count, 1);
    se_gates<C0, R0, OFF_SE0_W1, OFF_SE0_B1, OFF_SE0_W2, OFF_SE0_B2>(partial0, B, tiles,
                                                                     inv_count, g0, red);
    y0_pointwise(a0buf, wst, g0, B, H, W, y0buf);
    grid_barrier(count, 2);
    for (int k = blockIdx.x; k < nt; k += gridDim.x) {
        const Tile t = tile_at(k, tiles, tx);
        __syncthreads();
        load_y0(y0buf, sm, t, H, W);
        __syncthreads();
        dw1_sums(sm, red, t, H, W, partial1 + (size_t)k * C1, a1buf);
    }
    grid_barrier(count, 3);
    se_gates<C1, R1, OFF_SE1_W1, OFF_SE1_B1, OFF_SE1_W2, OFF_SE1_B2>(partial1, B, tiles,
                                                                     inv_count, g1, red);
    out_pointwise<Tout>(a1buf, y0buf, wst, g1, B, H, W, out);
}

// mobilenetv2_100's form: one block a tile.
template <typename Tout>
__global__ void __launch_bounds__(kThreads, 3)
stage0_single(const float* __restrict__ img, const float* __restrict__ params,
              Tout* __restrict__ out, int Hi, int Wi) {
    extern __shared__ float4 smem4[];
    float* wst = reinterpret_cast<float*>(smem4);
    const int W = Wi / 2;
    const int tx = tiles_x(W), tiles = tx * tiles_y(Hi / 2);
    stage_weights<kMobileNetV2>(params, wst);
    stage0_first<kMobileNetV2, Tout>(img, wst, wst + kWeights, nullptr,
                                                 tile_at(blockIdx.x, tiles, tx), Hi, Wi, nullptr,
                                                 nullptr, out);
}

// Per kernel, once a process: the dynamic shared memory it may take, and
// how many of its blocks an SM holds at that size (the cooperative grid must
// be resident at once); per form, the address of its constant bank. A call
// then costs its copy of the weights, the counter's zeroing and the launch.
struct Prepared {
    const void* fn = nullptr;
    int smem = -1, capacity = 0;  // blocks resident on the whole card
    cudaError_t err = cudaSuccess;
};

cudaError_t prepare(Prepared& p, const void* fn, int smem) {
    if (p.fn == fn && p.smem == smem) return p.err;
    p = Prepared{fn, smem, 0, cudaSuccess};
    int dev = 0, sms = 0, per_sm = 0;
    if ((p.err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) ||
        (p.err = cudaGetDevice(&dev)) ||
        (p.err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) ||
        (p.err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads, smem)))
        return p.err;
    p.capacity = per_sm * sms;
    return p.err;
}

template <typename Sym>
float* bank(const Sym& sym) {
    void* p = nullptr;
    return cudaGetSymbolAddress(&p, sym) == cudaSuccess ? static_cast<float*>(p) : nullptr;
}

template <typename Tout>
int launch_stage0(int form, const float* img, const float* params, Tout* out,
                  float* ws, int B, int Hi, int Wi, int grid, int smem, cudaStream_t stream) {
    const int H = Hi / 2, W = Wi / 2;
    const int nt = B * tiles_x(W) * tiles_y(H);
    static float* const eff = bank(c_eff);
    static float* const mob = bank(c_mob);
    if (eff == nullptr || mob == nullptr) return (int)cudaErrorInvalidSymbol;
    cudaError_t err;
    if (form == kMobileNetV2) {
        static Prepared single;
        if (grid != nt) return (int)cudaErrorInvalidConfiguration;
        if ((err = prepare(single, (const void*)stage0_single<Tout>, smem)) ||
            (err = cudaMemcpyAsync(mob, params, kParamsSingle * sizeof(float),
                                   cudaMemcpyDeviceToDevice, stream)))
            return (int)err;
        stage0_single<Tout><<<grid, kThreads, smem, stream>>>(img, params, out, Hi, Wi);
        return (int)cudaGetLastError();
    }
    if (grid < 1 || grid > nt) return (int)cudaErrorInvalidConfiguration;
    static Prepared coop;
    const void* fn = (const void*)stage0_coop<Tout>;
    if ((err = prepare(coop, fn, smem))) return (int)err;
    // every block must be resident at once: the barriers wait for all
    if (coop.capacity < grid) return (int)cudaErrorCooperativeLaunchTooLarge;
    if ((err = cudaMemcpyAsync(eff, params, kParams * sizeof(float), cudaMemcpyDeviceToDevice,
                               stream)) ||
        (err = cudaMemsetAsync(ws, 0, 4 * sizeof(float), stream)))
        return (int)err;
    void* args[] = {(void*)&img, (void*)&params, (void*)&out, (void*)&ws,
                    (void*)&B,   (void*)&Hi,     (void*)&Wi};
    err = cudaLaunchCooperativeKernel(fn, dim3(grid), dim3(kThreads), args, (size_t)smem, stream);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

}  // namespace

// form: kEfficientNetB2 (0) or kMobileNetV2 (1); -1 for another.
extern "C" int stage0_params_size(int form) {
    return form == kEfficientNetB2 ? kParams : form == kMobileNetV2 ? kParamsSingle : -1;
}

// The plan's counts as the source has them (ops/kernels/fused_head.py::
// stage0_plan mirrors them): dynamic shared bytes a block, and workspace
// floats.
extern "C" int stage0_smem_bytes(int form, int B) {
    return smem_floats(form, B) * (int)sizeof(float);
}

extern "C" long long stage0_workspace_floats(int form, int B, int Hi, int Wi) {
    return workspace_floats(form, B, Hi, Wi);
}

// img: (B, 3, Hi, Wi); params: stage0_params_size(form) floats in the
// form's packed order above; out: (B, 16, Hi/2, Wi/2), fp32 or, with
// out_bf16 set, bf16; ws: stage0_workspace_floats(form, ...) floats. Hi and
// Wi must be even. All contiguous; everything but out fp32. The plan (grid,
// threads, smem, ws_floats) must be the one stage0_plan gives: anything
// else is refused (cudaErrorInvalidValue or cudaErrorInvalidConfiguration),
// and so is a grid the card cannot hold resident
// (cudaErrorCooperativeLaunchTooLarge). Returns a cudaError_t.
extern "C" int fused_stage0(int form, const float* img, const float* params, void* out, float* ws,
                            int B, int Hi, int Wi, int out_bf16, int grid, int threads, int smem,
                            long long ws_floats, cudaStream_t stream) {
    if ((form != kEfficientNetB2 && form != kMobileNetV2) || B < 1 || Hi < 2 || Wi < 2 ||
        Hi % 2 || Wi % 2)
        return (int)cudaErrorInvalidValue;
    if (threads != kThreads || smem != stage0_smem_bytes(form, B) ||
        ws_floats != workspace_floats(form, B, Hi, Wi))
        return (int)cudaErrorInvalidConfiguration;
    return out_bf16
        ? launch_stage0(form, img, params, static_cast<__nv_bfloat16*>(out), ws, B, Hi, Wi, grid,
                        smem, stream)
        : launch_stage0(form, img, params, static_cast<float*>(out), ws, B, Hi, Wi, grid, smem,
                        stream);
}
