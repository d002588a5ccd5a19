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
// The deploy form (stem_mma_kernel, entry fused_stems_bf16) computes what
// the TPU kernel computes with its bf16 matmul operands (fused_stems.py:
// 74,200-280 there): the BN-folded weights in bf16, every conv's input
// rounded to bf16 (the fp32 image as it is staged, the GELU output of
// conv_down as it enters shared memory), fp32 sums, the shift added in
// fp32 and the outputs stored in bf16 (the model casts them so,
// esmstereo.py:563-567 there); stem_4 reads stem_2's bf16 map. What bounds
// it: bytes, 0.011 ms at L (the image read, both maps written) against
// 0.010 ms of bf16 operations; the fp32 loops it replaces ran at fp32 FMA
// speed, about 20 TFLOP/s. Both convs of a StemBlock are implicit GEMMs on
// the tensor cores, mma.sync.m16n8k16 with bf16 operands and fp32 sums,
// in one launch a StemBlock over a tile of TH x TW output pixels (8 warps):
//   1. conv_down over the tile's (TH + 2) x (TW + 2) halo pixels: M = the
//      halo pixels (flattened, each lane addressing its own A row, so the
//      16 rows of an m-tile may span two halo rows), N = all of C in
//      n-tiles of 8 (32 -> 4, 48 -> 6, 16 -> 2, 24 -> 3), K = (chunk, tap).
//      stem_2's 3 channels: K = (tap, channel), 27 values zero-padded to
//      32, staged as an im2col row a halo pixel (two chunks of 16), the fp32
//      image rounded to bf16 as it is staged. stem_4's 32 or 16 channels:
//      chunks of 16, each the tile's stride-2 window channel-innermost with
//      the even columns before the odd ones (as csrc/conv3d.cuh's slab at
//      stride 2), so that a tap's 16 A rows are 16 window positions
//      2 apart; the chunk's weights [tap][n][16 ci] beside it.
//   2. The map between the convs: the shift, GELU, zero outside the
//      StemBlock's output (the second conv's padding), rounded to bf16 and
//      written channel-innermost in chunks of 16 channels with
//      conv3d.cuh's swizzle, straight from the MMA accumulators; it never
//      leaves shared memory. Its channels past C (24 -> 32) are zero.
//   3. The stride-1 conv reads its A fragments from that map with ldmatrix
//      (16 output pixels of one row an m-tile) and B from all its chunks'
//      weights [chunk][tap][n][16 ci], staged with conv_down's first chunk
//      so that their loads share its wait.
//   4. Epilogue: the shift, ReLU, bf16, through a shared-memory transpose
//      [channel][pixel], then stored along W, 2 pixels a thread where the
//      output's width is even (1 where it is odd: stem_4 of an image
//      whose width is not a multiple of 8).
// Every conv sums in the order K = (chunk of 16 input channels, tap
// (kh, kw)), each (chunk, tap) product of the tensor core summed from zero
// and added to the running fp32 sum with one rounded add (__fadd_rn), as
// the shared 3-D conv of csrc/conv3d.cuh does; stem_2's conv_down sums its
// two chunks of (tap, channel) so. The TPU kernel's stride-1 convs add one
// dot a tap over all input channels, so where a conv has one chunk (S's
// stem_2 conv and stem_4's conv_down) the orders agree; its stride-2 convs
// add one dot a row of taps. The launch plan (tile, shared memory) comes
// from ops/kernels/fused_stems.py::stem_plan; the entry point checks it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "conv3d.cuh"

namespace {

// --- the fp32 form ----------------------------------------------------------

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

__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src,
                                      int n) {
    for (int i = threadIdx.x; i < n; i += kThreads) dst[i] = src[i];
}

// One StemBlock: x (B, CI, H, W) -> y (B, C, H/2, W/2); H and W even.
// wd: (CI, 3, 3, C), td: (C,) conv_down; wc: (C, 3, 3, C), tc: (C,) conv.
template <int CI, int C, int CC>
__global__ void __launch_bounds__(kThreads)
stem_block_kernel(const float* __restrict__ x, const float* __restrict__ wd,
                  const float* __restrict__ td, const float* __restrict__ wc,
                  const float* __restrict__ tc, float* __restrict__ y, int H,
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
    const float* xb = x + (size_t)b * CI * H * W;
    const int iy0 = 2 * oy0 - 3, ix0 = 2 * ox0 - 3;   // window origin
    for (int c0 = 0; c0 < CI; c0 += CC) {
        __syncthreads();   // the previous chunk fully consumed
        stage(wsh, wd + (size_t)c0 * 9 * C, S::kW1);
        for (int i = tid; i < CC * kSh * kSw; i += kThreads) {
            const int sx = i % kSw, sy = (i / kSw) % kSh, c = i / (kSw * kSh);
            const int gy = iy0 + sy, gx = ix0 + sx;
            float v = 0.0f;
            if (gy >= 0 && gy < H && gx >= 0 && gx < W)
                v = xb[((size_t)(c0 + c) * H + gy) * W + gx];
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
            for (int k = 0; k < K1; ++k)
                m[k * kMid] =
                    inside ? gelu(acc1[j][k] + td[g * K1 + k], approx) : 0.0f;
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
    float* yb = y + ((size_t)b * C + co0) * plane + ox;
#pragma unroll
    for (int p = 0; p < kP; ++p) {
        const int oy = oy0 + r0 + p;
        if (oy >= Ho) break;
#pragma unroll
        for (int k = 0; k < K; ++k)
            yb[(size_t)k * plane + (size_t)oy * Wo] =
                fmaxf(acc[p][k] + tc[co0 + k], 0.0f);
    }
}

template <int CI, int C, int CC>
int launch_stem(const float* x, const float* wd, const float* td,
                const float* wc, const float* tc, float* y, int B, int H,
                int W, int approximate, cudaStream_t stream) {
    using S = Stem<CI, C, CC>;
    auto kernel = stem_block_kernel<CI, C, CC>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::kSmem);
    if (err != cudaSuccess) return (int)err;
    const int Ho = H / 2, Wo = W / 2;
    const dim3 grid(((Wo + kTw - 1) / kTw) * ((Ho + kTh - 1) / kTh), B);
    kernel<<<grid, kThreads, S::kSmem, stream>>>(x, wd, td, wc, tc, y, H, W,
                                                 approximate);
    return (int)cudaGetLastError();
}

// Both StemBlocks of the fp32 form at widths (C2, C4).
template <int C2, int C4>
int launch_stems(const float* img, const float* wd2, const float* td2,
                 const float* wc2, const float* tc2, const float* wd4,
                 const float* td4, const float* wc4, const float* tc4,
                 float* s2, float* s4, int B, int H, int W, int approximate,
                 cudaStream_t stream) {
    const int err = launch_stem<3, C2, 3>(img, wd2, td2, wc2, tc2, s2, B, H,
                                          W, approximate, stream);
    if (err != 0) return err;
    return launch_stem<C2, C4, 4>(s2, wd4, td4, wc4, tc4, s4, B, H / 2,
                                  W / 2, approximate, stream);
}

// --- the deploy form: both convs on the tensor cores ------------------------

constexpr int kStemWarps = 8;
constexpr int kStemThreads = 32 * kStemWarps;

// A block's tile of TH x TW output pixels of one StemBlock CI -> C (TW a
// multiple of 16, TH x TW of 128): the shared memory it lays out, in bytes.
// [map | conv_down's window and its weights of a chunk, later the output
// tile | the conv's weights]. Rows of 16 bf16 channels, 32 bytes, swizzled
// (swz).
template <int CI, int C, int TH, int TW>
struct StemTile {
    static constexpr int NT = (C + 7) / 8;          // n-tiles
    static constexpr int NP = 8 * NT;
    static constexpr int CK = (C + 15) / 16;        // the map's chunks
    static constexpr int MW = TW + 2;               // the halo map's columns
    static constexpr int MP = (TH + 2) * MW;        // its pixels
    static constexpr int MT1 = (MP + 15) / 16;      // conv_down's m-tiles
    static constexpr int MT2 = TH * TW / 16;        // the conv's m-tiles
    static constexpr int I1 = (MT1 + kStemWarps - 1) / kStemWarps;
    static constexpr int I2 = MT2 / kStemWarps;
    static constexpr bool kImage = CI == 3;
    static constexpr int KD = kImage ? 2 : CI / 16; // conv_down's chunks
    static constexpr int SH = 2 * (TH + 2) + 1;     // window rows
    static constexpr int SE = MW + 1;               // its even columns
    static constexpr int SW = 2 * MW + 1;           // its columns
    static constexpr int map_bytes = CK * MP * 32;
    static constexpr int win_bytes = kImage ? KD * MP * 32 : SH * SW * 32;
    static constexpr int wd_bytes = (kImage ? KD : 9) * NP * 32;
    static constexpr int wc_bytes = CK * 9 * NP * 32;
    static constexpr int OS = TH * TW + 8;          // output tile row, bf16
    static constexpr int out_bytes = NP * OS * 2;
    static constexpr int a1 = win_bytes + wd_bytes;
    static constexpr int region = a1 > out_bytes ? a1 : out_bytes;
    static constexpr int smem = map_bytes + region + wc_bytes;
    static_assert(TW % 16 == 0 && MT2 % kStemWarps == 0, "the conv's m-tiles");
    static_assert(kImage || CI % 16 == 0, "conv_down's chunks of 16");
};

// Stages n_items items of 8 bf16 values (one 16-byte shared store each):
// item(i, v) fills v and returns its byte offset in base. kBatch items'
// loads are in flight before their stores.
template <int kBatch, typename Item>
__device__ __forceinline__ void stage_items(char* base, int n_items,
                                            const Item& item) {
    for (int i0 = threadIdx.x; i0 < n_items; i0 += kStemThreads * kBatch) {
        uint32_t v[kBatch][4];
        int dst[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
            const int i = i0 + u * kStemThreads;
#pragma unroll
            for (int q = 0; q < 4; ++q) v[u][q] = 0;
            dst[u] = i < n_items ? item(i, v[u]) : -1;
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u)
            if (dst[u] >= 0)
                *reinterpret_cast<uint4*>(base + dst[u]) =
                    make_uint4(v[u][0], v[u][1], v[u][2], v[u][3]);
    }
}

// One StemBlock's deploy form: x (B, CI, H, W), fp32 (the image, CI 3) or
// bf16 -> y (B, C, H/2, W/2) bf16; H and W even. wd: (CI, 3, 3, C), wc:
// (C, 3, 3, C) bf16, BN-folded; td, tc: (C,) fp32 shifts. Grid: (tiles of
// TH x TW, B).
template <int CI, int C, int TH, int TW, typename Tin>
__global__ void __launch_bounds__(kStemThreads, 2)
stem_mma_kernel(const Tin* __restrict__ x,
                const __nv_bfloat16* __restrict__ wd,
                const float* __restrict__ td,
                const __nv_bfloat16* __restrict__ wc,
                const float* __restrict__ tc, __nv_bfloat16* __restrict__ y,
                int H, int W, int approximate) {
    using T = StemTile<CI, C, TH, TW>;
    constexpr int NT = T::NT, NP = T::NP, MP = T::MP, MW = T::MW;
    extern __shared__ uint4 smem_u4[];
    char* smem = reinterpret_cast<char*>(smem_u4);
    char* map = smem;                              // [CK][MP][16] bf16
    char* win = smem + T::map_bytes;               // window / im2col
    char* wdsh = win + T::win_bytes;               // conv_down's weights
    char* wcsh = win + T::region;                  // the conv's weights
    const unsigned map_u = smem_u32(map), win_u = smem_u32(win);
    const unsigned wd_u = smem_u32(wdsh), wc_u = smem_u32(wcsh);

    const int Ho = H / 2, Wo = W / 2;
    const int tilesW = (Wo + TW - 1) / TW;
    const int ox0 = (blockIdx.x % tilesW) * TW;
    const int oy0 = (blockIdx.x / tilesW) * TH;
    const int b = blockIdx.y;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int iy0 = 2 * oy0 - 3, ix0 = 2 * ox0 - 3;   // the window's origin
    const Tin* xb = x + (size_t)b * CI * H * W;
    const bool approx = approximate != 0;
    // ldmatrix.x4 of A: lane l addresses row (l & 7) + 8 ((l >> 3) & 1) of
    // the m-tile, channel half l >> 4
    const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8;
    const int a_half = lane >> 4;
    const int g = lane >> 2, t = lane & 3;

    // 1. conv_down over the halo pixels: m-tile warp + 8 i
    float acc1[T::I1][NT][4];
    int arow[T::I1];
#pragma unroll
    for (int i = 0; i < T::I1; ++i) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc1[i][nt][j] = 0.0f;
        // rows past the halo read its last pixel; their sums are dropped
        const int p = min((warp + kStemWarps * i) * 16 + a_row, MP - 1);
        arow[i] = T::kImage ? p : 2 * (p / MW) * T::SW + p % MW;
    }
    // the conv's weights [chunk][tap][n][16 ci], staged with conv_down's
    // first chunk
    stage_items<2>(wcsh, T::CK * 9 * NP * 2, [&](int i, uint32_t(&v)[4]) {
        const int n = i % NP, tap = i / NP % 9, u = i / (9 * NP);
        const int ck = u >> 1, c = ck * 16 + 8 * (u & 1);
        if (n < C) {
            const __nv_bfloat16* p = wc + ((size_t)c * 9 + tap) * C + n;
#pragma unroll
            for (int j = 0; j < 8; ++j)
                if (c + j < C)
                    v[j / 2] |= bits16(p[j * 9 * C]) << (16 * (j & 1));
        }
        return swz((ck * 9 + tap) * NP + n, u & 1);
    });
    if constexpr (T::kImage) {
        // the im2col rows, k = 3 tap + channel < 27 (zero past it), one
        // halo pixel a thread: its 27 loads in flight, the index math
        // folded at compile time; and the weights [chunk][n][16 k]
        for (int p = tid; p < MP; p += kStemThreads) {
            const int my = p / MW, mx = p % MW;
            uint32_t v[4][4] = {};
#pragma unroll
            for (int kh = 0; kh < 3; ++kh) {
                const int gy = iy0 + 2 * my + kh;
#pragma unroll
                for (int kw = 0; kw < 3; ++kw) {
                    const int gx = ix0 + 2 * mx + kw;
                    if (gy < 0 || gy >= H || gx < 0 || gx >= W) continue;
                    const Tin* px = xb + (size_t)gy * W + gx;
#pragma unroll
                    for (int c = 0; c < 3; ++c) {
                        const int k = (kh * 3 + kw) * 3 + c;
                        v[k / 8][k % 8 / 2] |=
                            bits16(__float2bfloat16_rn(
                                widen(px[(size_t)c * H * W])))
                            << (16 * (k & 1));
                    }
                }
            }
#pragma unroll
            for (int u = 0; u < 4; ++u)
                *reinterpret_cast<uint4*>(win + (u >> 1) * MP * 32
                                          + swz(p, u & 1)) =
                    make_uint4(v[u][0], v[u][1], v[u][2], v[u][3]);
        }
        stage_items<2>(wdsh, T::KD * 2 * NP, [&](int i, uint32_t(&v)[4]) {
            const int n = i % NP, u = i / NP;
            if (n < C) {
#pragma unroll
                for (int j = 0; j < 8; ++j) {
                    const int k = 8 * u + j;
                    if (k < 27)
                        v[j / 2] |= bits16(wd[((k % 3) * 9 + k / 3) * C + n])
                                    << (16 * (j & 1));
                }
            }
            return (u >> 1) * NP * 32 + swz(n, u & 1);
        });
        __syncthreads();
#pragma unroll
        for (int kc = 0; kc < T::KD; ++kc) {
            uint32_t bf[NT][2];
            load_b_rows<NT>(wd_u, kc * NP, lane, bf);
#pragma unroll
            for (int i = 0; i < T::I1; ++i) {
                if (warp + kStemWarps * i >= T::MT1) break;
                uint32_t a[4];
                ldmatrix_x4(a, win_u + kc * MP * 32 + swz(arow[i], a_half));
                mma_add_rows<NT>(acc1[i], a, bf);
            }
        }
    } else {
        for (int c0 = 0; c0 < CI; c0 += 16) {
            if (c0) __syncthreads();   // the previous chunk consumed
            // the stride-2 window, channel-innermost, even columns first
            stage_items<4>(win, 2 * T::SH * T::SW,
                           [&](int i, uint32_t(&v)[4]) {
                const int sx = i % T::SW, sy = i / T::SW % T::SH;
                const int u = i / (T::SW * T::SH);
                const int gy = iy0 + sy, gx = ix0 + sx;
                if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
                    const Tin* p = xb + ((size_t)(c0 + 8 * u) * H + gy) * W
                                   + gx;
#pragma unroll
                    for (int j = 0; j < 8; ++j)
                        v[j / 2] |= bits16(p[(size_t)j * H * W])
                                    << (16 * (j & 1));
                }
                return swz(sy * T::SW + ((sx & 1) ? T::SE : 0) + (sx >> 1), u);
            });
            stage_items<2>(wdsh, 9 * NP * 2, [&](int i, uint32_t(&v)[4]) {
                const int n = i % NP, tap = i / NP % 9, u = i / (9 * NP);
                if (n < C) {
                    const __nv_bfloat16* p =
                        wd + ((size_t)(c0 + 8 * u) * 9 + tap) * C + n;
#pragma unroll
                    for (int j = 0; j < 8; ++j)
                        v[j / 2] |= bits16(p[j * 9 * C]) << (16 * (j & 1));
                }
                return swz(tap * NP + n, u);
            });
            __syncthreads();
#pragma unroll 1
            for (int kh = 0; kh < 3; ++kh) {
#pragma unroll
                for (int kw = 0; kw < 3; ++kw) {
                    uint32_t bf[NT][2];
                    load_b_rows<NT>(wd_u, (kh * 3 + kw) * NP, lane, bf);
                    const int toff = kh * T::SW + (kw == 1 ? T::SE : kw / 2);
#pragma unroll
                    for (int i = 0; i < T::I1; ++i) {
                        if (warp + kStemWarps * i >= T::MT1) break;
                        uint32_t a[4];
                        ldmatrix_x4(a, win_u + swz(arow[i] + toff, a_half));
                        mma_add_rows<NT>(acc1[i], a, bf);
                    }
                }
            }
        }
    }

    // 2. the map: shift, GELU, zero outside the output, bf16, from the sums
#pragma unroll
    for (int i = 0; i < T::I1; ++i) {
        const int mt = warp + kStemWarps * i;
        if (mt >= T::MT1) break;
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
            const int p = mt * 16 + g + 8 * hr;
            if (p >= MP) continue;
            const int gy = oy0 - 1 + p / MW, gx = ox0 - 1 + p % MW;
            const bool in = gy >= 0 && gy < Ho && gx >= 0 && gx < Wo;
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
                const int n = nt * 8 + 2 * t;
                float v[2];
#pragma unroll
                for (int e = 0; e < 2; ++e)
                    v[e] = in && n + e < C
                        ? gelu(acc1[i][nt][2 * hr + e] + td[n + e], approx)
                        : 0.0f;
                *reinterpret_cast<uint32_t*>(
                    map + (nt >> 1) * MP * 32 + swz(p, nt & 1) + 4 * t) =
                    pack_bf16(v[0], v[1]);
            }
            if (NT % 2)   // the last chunk's channels past 8 NT: zero
                *reinterpret_cast<uint32_t*>(
                    map + (NT >> 1) * MP * 32 + swz(p, 1) + 4 * t) = 0;
        }
    }
    __syncthreads();   // the map complete; the window and wd consumed

    // 3. the stride-1 conv from the map
    float acc[T::I2][NT][4];
    int mrow[T::I2];
#pragma unroll
    for (int i = 0; i < T::I2; ++i) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][nt][j] = 0.0f;
        const int q = (warp + kStemWarps * i) * 16 + a_row;
        mrow[i] = (q / TW) * MW + q % TW;
    }
#pragma unroll 1
    for (int ck = 0; ck < T::CK; ++ck) {
#pragma unroll 1
        for (int kh = 0; kh < 3; ++kh) {
#pragma unroll
            for (int kw = 0; kw < 3; ++kw) {
                uint32_t bf[NT][2];
                load_b_rows<NT>(wc_u, (ck * 9 + kh * 3 + kw) * NP, lane, bf);
#pragma unroll
                for (int i = 0; i < T::I2; ++i) {
                    uint32_t a[4];
                    ldmatrix_x4(a, map_u + ck * MP * 32
                                   + swz(mrow[i] + kh * MW + kw, a_half));
                    mma_add_rows<NT>(acc[i], a, bf);
                }
            }
        }
    }

    // 4. shift, ReLU, bf16 through a transpose [n][pixel] where the window
    // was, then along W
    __nv_bfloat16* out = reinterpret_cast<__nv_bfloat16*>(win);
#pragma unroll
    for (int i = 0; i < T::I2; ++i) {
        const int mt = warp + kStemWarps * i;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int n = nt * 8 + 2 * t + (j & 1);
                const int q = mt * 16 + g + 8 * (j >> 1);
                if (n < C)
                    out[n * T::OS + q] = __float2bfloat16_rn(
                        fmaxf(acc[i][nt][j] + tc[n], 0.0f));
            }
    }
    __syncthreads();
    if (Wo % 2 == 0) {   // 2 pixels a store, each pair inside or outside
        constexpr int kPairs = TW / 2;
        for (int e = tid; e < C * TH * kPairs; e += kStemThreads) {
            const int k = e % kPairs, oy = e / kPairs % TH;
            const int n = e / (kPairs * TH);
            const int gy = oy0 + oy, gx = ox0 + 2 * k;
            if (gy < Ho && gx < Wo)
                *reinterpret_cast<uint32_t*>(
                    y + (((size_t)b * C + n) * Ho + gy) * Wo + gx) =
                    *reinterpret_cast<const uint32_t*>(
                        out + n * T::OS + oy * TW + 2 * k);
        }
    } else {             // stem_4 of a width that is not a multiple of 8
        for (int e = tid; e < C * TH * TW; e += kStemThreads) {
            const int k = e % TW, oy = e / TW % TH, n = e / (TW * TH);
            const int gy = oy0 + oy, gx = ox0 + k;
            if (gy < Ho && gx < Wo)
                y[(((size_t)b * C + n) * Ho + gy) * Wo + gx] =
                    out[n * T::OS + oy * TW + k];
        }
    }
}

}  // namespace

// All tensors contiguous; returns a cudaError_t (cudaErrorInvalidValue for
// H or W not a positive multiple of 4, or widths (C2, C4) other than
// (32, 48) and (16, 24)).
// img: (B, 3, H, W) fp32; s2: (B, C2, H/2, W/2); s4: (B, C4, H/4, W/4),
// fp32. wd2: (3, 3, 3, C2), wc2: (C2, 3, 3, C2), wd4: (C2, 3, 3, C4),
// wc4: (C4, 3, 3, C4), each (CI, kh, kw, CO) with the BN scale folded in,
// fp32; td*, tc*: the BN shifts, fp32.
extern "C" int fused_stems(const float* img, const float* wd2,
                           const float* td2, const float* wc2,
                           const float* tc2, const float* wd4,
                           const float* td4, const float* wc4,
                           const float* tc4, float* s2, float* s4, int B,
                           int H, int W, int C2, int C4, int approximate,
                           cudaStream_t stream) {
    if (B < 1 || H < 4 || W < 4 || H % 4 || W % 4)
        return (int)cudaErrorInvalidValue;
#define STEMS_ARGS img, wd2, td2, wc2, tc2, wd4, td4, wc4, tc4, s2, s4, B, \
                   H, W, approximate, stream
    if (C2 == 32 && C4 == 48) return launch_stems<32, 48>(STEMS_ARGS);
    if (C2 == 16 && C4 == 24) return launch_stems<16, 24>(STEMS_ARGS);
#undef STEMS_ARGS
    return (int)cudaErrorInvalidValue;
}

namespace {

// The deploy form's instances, X(CI, C, TH, TW): the StemBlocks of
// ESMStereo-L and -M (3 -> 32, 32 -> 48) and -S (3 -> 16, 16 -> 24), each
// at the tile fused_stems.py::STEM_TILES gives it. The same list as
// fused_stems.py::STEM_INSTANCES (tests/test_torch_stem_up_plans.py holds
// the two to each other and to the plans).
#define STEM_INSTANCES(X) \
    X(3, 32, 8, 32)       \
    X(32, 48, 8, 16)      \
    X(3, 16, 8, 16)       \
    X(16, 24, 8, 16)

// One StemBlock's launch: plan = (tile_h, tile_w, smem) for CI -> C on a
// (B, CI, H, W) input.
template <int CI, int C, int TH, int TW, typename Tin>
int launch_stem_mma(const void* x, const void* wd, const float* td,
                    const void* wc, const float* tc, void* y, int B, int H,
                    int W, int smem, int approximate, cudaStream_t stream) {
    using T = StemTile<CI, C, TH, TW>;
    if (smem != T::smem) return (int)cudaErrorInvalidValue;
    const int Ho = H / 2, Wo = W / 2;
    const dim3 grid(((Wo + TW - 1) / TW) * ((Ho + TH - 1) / TH), B);
    return launch(stem_mma_kernel<CI, C, TH, TW, Tin>, grid,
                  dim3(kStemThreads), smem, 1, stream,
                  static_cast<const Tin*>(x),
                  static_cast<const __nv_bfloat16*>(wd), td,
                  static_cast<const __nv_bfloat16*>(wc), tc,
                  static_cast<__nv_bfloat16*>(y), H, W, approximate);
}

// A StemBlock's input: the fp32 image (stem_2), or stem_2's bf16 map.
template <int CI>
using StemIn = std::conditional_t<CI == 3, float, __nv_bfloat16>;

int dispatch_stem_mma(int CI, int C, const int* tile, const void* x,
                      const void* wd, const float* td, const void* wc,
                      const float* tc, void* y, int B, int H, int W,
                      int approximate, cudaStream_t stream) {
#define STEM_DISPATCH(ci, c, th, tw)                                        \
    if (CI == ci && C == c && tile[0] == th && tile[1] == tw)               \
        return launch_stem_mma<ci, c, th, tw, StemIn<ci>>(                  \
            x, wd, td, wc, tc, y, B, H, W, tile[2], approximate, stream);
    STEM_INSTANCES(STEM_DISPATCH)
#undef STEM_DISPATCH
    return (int)cudaErrorInvalidValue;
}

}  // namespace

// The deploy form: img (B, 3, H, W) fp32 -> s2 (B, C2, H/2, W/2) and s4
// (B, C4, H/4, W/4) bf16; weights as fused_stems's in bf16 (BN-folded),
// shifts fp32. plan: 6 ints, stem_2's (tile_h, tile_w, smem) then stem_4's
// (fused_stems.py::stem_plan); any plan or width not in STEM_INSTANCES, or
// a shared-memory count other than the kernel's own, is refused.
extern "C" int fused_stems_bf16(const float* img, const void* wd2,
                                const float* td2, const void* wc2,
                                const float* tc2, const void* wd4,
                                const float* td4, const void* wc4,
                                const float* tc4, void* s2, void* s4, int B,
                                int H, int W, int C2, int C4,
                                const int* plan, int approximate,
                                cudaStream_t stream) {
    if (B < 1 || H < 4 || W < 4 || H % 4 || W % 4)
        return (int)cudaErrorInvalidValue;
    const int err = dispatch_stem_mma(3, C2, plan, img, wd2, td2, wc2, tc2,
                                      s2, B, H, W, approximate, stream);
    if (err != 0) return err;
    return dispatch_stem_mma(C2, C4, plan + 3, s2, wd4, td4, wc4, tc4, s4, B,
                             H / 2, W / 2, approximate, stream);
}
