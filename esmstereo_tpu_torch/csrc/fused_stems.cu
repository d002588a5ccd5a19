// Kernel F: the stem_2 + stem_4 matching towers. Each StemBlock is
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
// Two forms share one kernel, stem_mma_kernel, on the tensor cores
// (mma.sync), with the operand type Op:
//   * fp32 (Op float): fp32 in and out, each product computed in 3xTF32:
//     every operand x is split as hi = cvt.rna.tf32(x), lo = cvt.rna.tf32(x -
//     hi), and each m16n8k8 tile of products is lo.hi + hi.lo + hi.hi with
//     fp32 sums (the lo.lo term, about 2^-22 of a product, is dropped). What
//     bounds it on an H100: operations. Both eyes at 544x992 are 5.05 G
//     multiply-adds (10.1 GFLOP) against 13 MB read and 47.5 MB written:
//     3 x 10.1 GFLOP at 495 TF32 TFLOP/s is 0.061 ms, the bytes 0.018 ms
//     (at S's widths 3 x 2.66 GFLOP, 0.016 ms, against 0.011 ms of bytes).
//     The fp32 FMA loops it replaced ran at about 19 TFLOP/s, 28% of the
//     fp32 FMA rate.
//   * the deploy form (Op bf16) computes what the TPU kernel computes with
//     its bf16 matmul operands (fused_stems.py:74,200-280 there): the
//     BN-folded weights in bf16, every conv's input rounded to bf16 (the fp32
//     image as it is staged, the GELU output of conv_down as it enters
//     shared memory), fp32 sums, the shift added in fp32 and the outputs
//     stored in bf16 (the model casts them so, esmstereo.py:563-567 there);
//     stem_4 reads stem_2's bf16 map. mma.sync.m16n8k16 with bf16 operands.
//     What bounds it: bytes, 0.011 ms at L (the image read, both maps
//     written) against 0.010 ms of bf16 operations.
// Shared memory holds rows of 32 bytes, KC channels each (16 bf16 or 8
// fp32), with conv3d.cuh's swizzle, so that one ldmatrix.x4 (16-bit rows:
// lane l gets the 32-bit word of row l / 4, word l % 4) gives the A fragment
// of an m16n8k16 bf16 tile or of an m16n8k8 tf32 tile alike, and ldmatrix
// of the weight rows their B fragments. Both convs of a StemBlock are
// implicit GEMMs over a tile of TH x TW output pixels (8 warps):
//   1. conv_down over the tile's (TH + 2) x (TW + 2) halo pixels: M = the
//      halo pixels (flattened, each lane addressing its own A row, so the
//      16 rows of an m-tile may span two halo rows), N = all of C in
//      n-tiles of 8 (32 -> 4, 48 -> 6, 16 -> 2, 24 -> 3), K = (chunk, tap).
//      stem_2's 3 channels: K = (tap, channel), 27 values zero-padded to
//      32, staged as an im2col row a halo pixel (2 chunks of 16, or 4 of 8),
//      the fp32 image rounded to the operand type as it is staged. stem_4's
//      32 or 16 channels: chunks of KC, each the tile's stride-2 window
//      channel-innermost with the even columns before the odd ones (as
//      csrc/conv3d.cuh's slab at stride 2), so that a tap's 16 A rows are 16
//      window positions 2 apart; the chunk's weights [tap][n][KC ci] beside
//      it.
//   2. The map between the convs: the shift, GELU, zero outside the
//      StemBlock's output (the second conv's padding), in the operand type
//      (bf16 rounded, or fp32), written channel-innermost in chunks of KC
//      channels straight from the MMA accumulators; it never leaves shared
//      memory. Its channels past C (bf16: 24 -> 32) are zero.
//   3. The stride-1 conv reads its A fragments from that map (16 output
//      pixels of one row an m-tile) and B from its weights [chunk][tap][n]
//      [KC ci]: in the deploy form all of them, staged with conv_down's
//      first chunk so that their loads share its wait; in the fp32 form,
//      whose weights are twice the bytes, as many chunks at a time as the
//      region of the window holds (so that two or three blocks share an SM).
//   4. Epilogue: the shift, ReLU, through a shared-memory transpose
//      [channel][pixel], then stored along W, 2 pixels a thread where the
//      output's width is even (1 where it is odd: stem_4 of an image
//      whose width is not a multiple of 8).
// Every conv sums in the order K = (chunk of KC input channels, tap
// (kh, kw)), each (chunk, tap) product of the tensor core (in the fp32 form
// its three) summed from zero and added to the running fp32 sum with one
// rounded add (__fadd_rn), as the shared 3-D conv of csrc/conv3d.cuh does;
// stem_2's conv_down sums its chunks of (tap, channel) so. The TPU kernel's
// stride-1 convs add one dot a tap over all input channels, so where a conv
// has one chunk (the deploy form's S stem_2 conv and stem_4 conv_down) the
// orders agree; its stride-2 convs add one dot a row of taps. The launch
// plan (tile, shared memory) comes from ops/kernels/fused_stems.py::
// stem_plan; the entry point checks it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "conv3d.cuh"

namespace {

constexpr int kStemWarps = 8;
constexpr int kStemThreads = 32 * kStemWarps;

// A block's tile of TH x TW output pixels of one StemBlock CI -> C (TW a
// multiple of 16, TH x TW of 128) in operand type Op: the shared memory it
// lays out, in bytes. [map | conv_down's window and its weights of a chunk,
// later the output tile (and in the fp32 form the conv's weights, WP chunks
// at a time) | in the deploy form the conv's weights]. Rows of KC channels,
// 32 bytes, swizzled (swz).
template <int CI, int C, int TH, int TW, typename Op>
struct StemTile {
    static constexpr bool kLow = std::is_same_v<Op, __nv_bfloat16>;
    static constexpr int KC = 32 / (int)sizeof(Op); // channels a row
    static constexpr int HV = KC / 2;               // values a 16-byte half
    static constexpr int NT = (C + 7) / 8;          // n-tiles
    static constexpr int NP = 8 * NT;
    static constexpr int CK = (C + KC - 1) / KC;    // the map's chunks
    static constexpr int MW = TW + 2;               // the halo map's columns
    static constexpr int MP = (TH + 2) * MW;        // its pixels
    static constexpr int MT1 = (MP + 15) / 16;      // conv_down's m-tiles
    static constexpr int MT2 = TH * TW / 16;        // the conv's m-tiles
    static constexpr int I1 = (MT1 + kStemWarps - 1) / kStemWarps;
    static constexpr int I2 = MT2 / kStemWarps;
    static constexpr bool kImage = CI == 3;
    // conv_down's chunks: the image's 32 (tap, channel) values, or CI
    static constexpr int KD = kImage ? 32 / KC : CI / KC;
    static constexpr int SH = 2 * (TH + 2) + 1;     // window rows
    static constexpr int SE = MW + 1;               // its even columns
    static constexpr int SW = 2 * MW + 1;           // its columns
    // weight planes: the deploy form's bf16, or the fp32 form's high and
    // low TF32 parts (split once, as they are staged)
    static constexpr int WB = kLow ? 1 : 2;
    static constexpr int map_bytes = CK * MP * 32;
    static constexpr int win_bytes = kImage ? KD * MP * 32 : SH * SW * 32;
    static constexpr int wd_plane = (kImage ? KD : 9) * NP * 32;
    static constexpr int wd_bytes = WB * wd_plane;
    static constexpr int wc_plane = 9 * NP * 32;    // a chunk's conv weights
    static constexpr int wc_chunk = WB * wc_plane;
    static constexpr int wc_bytes = CK * wc_chunk;
    static constexpr int OS = TH * TW + 8;          // output tile row
    static constexpr int out_bytes = NP * OS * (int)sizeof(Op);
    static constexpr int a1 = win_bytes + wd_bytes;
    static constexpr int a2 = a1 > out_bytes ? a1 : out_bytes;
    static constexpr int region = kLow || a2 > wc_chunk ? a2 : wc_chunk;
    static constexpr int WP =                       // conv chunks a pass
        kLow || region / wc_chunk > CK ? CK : region / wc_chunk;
    static constexpr int smem = map_bytes + region + (kLow ? wc_bytes : 0);
    static_assert(TW % 16 == 0 && MT2 % kStemWarps == 0, "the conv's m-tiles");
    static_assert(kImage || CI % KC == 0, "conv_down's chunks");
    static_assert(kLow || NP == CK * KC, "fp32: one n-tile a chunk");
};

// x's leading TF32 part (cvt.rna: 10 explicit mantissa bits, rounded to
// nearest, ties away from zero), its low 13 bits zero.
__device__ __forceinline__ uint32_t tf32_hi(uint32_t x) {
    uint32_t r;
    asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(__uint_as_float(x)));
    return r & 0xffffe000u;
}

// The 3xTF32 split of n fp32 words: x -> hi (in place), lo.
template <int N>
__device__ __forceinline__ void split_tf32(uint32_t* x, uint32_t* lo) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
        const uint32_t hi = tf32_hi(x[i]);
        lo[i] = tf32_hi(__float_as_uint(__uint_as_float(x[i])
                                        - __uint_as_float(hi)));
        x[i] = hi;
    }
}

// Stages n_items items of 16 bytes (8 bf16 or 4 fp32 values, one shared
// store each): item(i, v) fills v and returns its byte offset in base.
// kBatch items' loads are in flight before their stores. With lo_off, the
// items are fp32 weights: their high TF32 parts are stored at the offset
// and their low parts lo_off bytes after it.
template <int kBatch, typename Item>
__device__ __forceinline__ void stage_items(char* base, int n_items,
                                            const Item& item,
                                            int lo_off = 0) {
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
        for (int u = 0; u < kBatch; ++u) {
            if (dst[u] < 0) continue;
            if (lo_off) {
                uint32_t lo[4];
                split_tf32<4>(v[u], lo);
                *reinterpret_cast<uint4*>(base + dst[u] + lo_off) =
                    make_uint4(lo[0], lo[1], lo[2], lo[3]);
            }
            *reinterpret_cast<uint4*>(base + dst[u]) =
                make_uint4(v[u][0], v[u][1], v[u][2], v[u][3]);
        }
    }
}

__device__ __forceinline__ __nv_bfloat16 to_bf16(float x) {
    return __float2bfloat16_rn(x);
}
__device__ __forceinline__ __nv_bfloat16 to_bf16(__nv_bfloat16 x) {
    return x;
}

// Value j of a 16-byte unit v in the operand type Op: x rounded to bf16
// (a bf16 x as it is), or fp32.
template <typename Op, typename T>
__device__ __forceinline__ void put(uint32_t (&v)[4], int j, T x) {
    if constexpr (std::is_same_v<Op, float>)
        v[j] = __float_as_uint(widen(x));
    else
        v[j >> 1] |= bits16(to_bf16(x)) << (16 * (j & 1));
}

// d += a * b on one m16n8k8 tile: tf32 operands, fp32 sums.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The B fragments of one (chunk, tap) of NT n-tiles (ldmatrix, load_b_rows):
// the bf16 weights, or in the fp32 form bh the high TF32 parts and bl the
// low ones, lo_off bytes further.
template <typename Op, int NT>
__device__ __forceinline__ void load_b(unsigned base, int row0, int lane,
                                       int lo_off, uint32_t (&bh)[NT][2],
                                       uint32_t (&bl)[NT][2]) {
    load_b_rows<NT>(base, row0, lane, bh);
    if constexpr (std::is_same_v<Op, float>)
        load_b_rows<NT>(base + lo_off, row0, lane, bl);
}

// acc[nt] += a x b[nt] over one (chunk, tap), each n-tile's product summed
// from zero and added with one rounded add: in bf16 one m16n8k16 (as
// mma_add_rows); in fp32 the 3xTF32 products lo.hi + hi.lo + hi.hi of
// m16n8k8 tiles, A split at this load.
template <typename Op, int NT>
__device__ __forceinline__ void mma_rows(float (&acc)[NT][4], uint32_t (&a)[4],
                                         const uint32_t (&bh)[NT][2],
                                         const uint32_t (&bl)[NT][2]) {
    if constexpr (std::is_same_v<Op, __nv_bfloat16>) {
        mma_add_rows<NT>(acc, a, bh);
    } else {
        uint32_t al[4];
        split_tf32<4>(a, al);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
            float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
            mma_tf32(part, al, bh[nt]);
            mma_tf32(part, a, bl[nt]);
            mma_tf32(part, a, bh[nt]);
#pragma unroll
            for (int j = 0; j < 4; ++j)
                acc[nt][j] = __fadd_rn(acc[nt][j], part[j]);
        }
    }
}

// A StemBlock's input: the fp32 image (stem_2), or stem_2's map in the
// operand type.
template <int CI, typename Op>
using StemIn = std::conditional_t<CI == 3, float, Op>;

// One StemBlock: x (B, CI, H, W) -> y (B, C, H/2, W/2) in the operand type
// Op; H and W even. wd: (CI, 3, 3, C), wc: (C, 3, 3, C) in Op, BN-folded;
// td, tc: (C,) fp32 shifts. Grid: (tiles of TH x TW, B).
template <int CI, int C, int TH, int TW, typename Op>
__global__ void __launch_bounds__(kStemThreads, 2)
stem_mma_kernel(const StemIn<CI, Op>* __restrict__ x,
                const Op* __restrict__ wd, const float* __restrict__ td,
                const Op* __restrict__ wc, const float* __restrict__ tc,
                Op* __restrict__ y, int H, int W, int approximate) {
    using T = StemTile<CI, C, TH, TW, Op>;
    using Tin = StemIn<CI, Op>;
    constexpr int NT = T::NT, NP = T::NP, MP = T::MP, MW = T::MW;
    constexpr int KC = T::KC, HV = T::HV;
    extern __shared__ uint4 smem_u4[];
    char* smem = reinterpret_cast<char*>(smem_u4);
    char* map = smem;                              // [CK][MP][KC]
    char* win = smem + T::map_bytes;               // window / im2col
    char* wdsh = win + T::win_bytes;               // conv_down's weights
    char* wcsh = T::kLow ? win + T::region : win;  // the conv's weights
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
    // the m-tile, half l >> 4 of its row
    const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8;
    const int a_half = lane >> 4;
    const int g = lane >> 2, t = lane & 3;

    // the conv's weights [chunk][tap][n][KC ci] from chunk ck0 on, n_ck
    // chunks
    auto stage_wc = [&](int ck0, int n_ck) {
        stage_items<2>(wcsh, n_ck * 9 * NP * 2, [&](int i, uint32_t(&v)[4]) {
            const int n = i % NP, tap = i / NP % 9, u = i / (9 * NP);
            const int ck = u >> 1, c = (ck0 + ck) * KC + HV * (u & 1);
            if (n < C) {
                const Op* p = wc + ((size_t)c * 9 + tap) * C + n;
#pragma unroll
                for (int j = 0; j < HV; ++j)
                    if (c + j < C) put<Op>(v, j, p[j * 9 * C]);
            }
            return swz((ck * T::WB * 9 + tap) * NP + n, u & 1);
        }, T::kLow ? 0 : T::wc_plane);
    };

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
    // the deploy form's conv weights, staged with conv_down's first chunk
    if constexpr (T::kLow) stage_wc(0, T::CK);
    if constexpr (T::kImage) {
        // the im2col rows, k = 3 tap + channel < 27 (zero past it), one
        // halo pixel a thread: its 27 loads in flight, the index math
        // folded at compile time; and the weights [chunk][n][KC k]
        constexpr int kUnits = 32 / HV;
        for (int p = tid; p < MP; p += kStemThreads) {
            const int my = p / MW, mx = p % MW;
            uint32_t v[kUnits][4] = {};
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
                        put<Op>(v[k / HV], k % HV, px[(size_t)c * H * W]);
                    }
                }
            }
#pragma unroll
            for (int u = 0; u < kUnits; ++u)
                *reinterpret_cast<uint4*>(win + (u >> 1) * MP * 32
                                          + swz(p, u & 1)) =
                    make_uint4(v[u][0], v[u][1], v[u][2], v[u][3]);
        }
        stage_items<2>(wdsh, T::KD * 2 * NP, [&](int i, uint32_t(&v)[4]) {
            const int n = i % NP, u = i / NP;
            if (n < C) {
#pragma unroll
                for (int j = 0; j < HV; ++j) {
                    const int k = HV * u + j;
                    if (k < 27)
                        put<Op>(v, j, wd[((k % 3) * 9 + k / 3) * C + n]);
                }
            }
            return (u >> 1) * NP * 32 + swz(n, u & 1);
        }, T::kLow ? 0 : T::wd_plane);
        __syncthreads();
#pragma unroll
        for (int kc = 0; kc < T::KD; ++kc) {
            uint32_t bh[NT][2], bl[NT][2];
            load_b<Op, NT>(wd_u, kc * NP, lane, T::wd_plane, bh, bl);
#pragma unroll
            for (int i = 0; i < T::I1; ++i) {
                if (warp + kStemWarps * i >= T::MT1) break;
                uint32_t a[4];
                ldmatrix_x4(a, win_u + kc * MP * 32 + swz(arow[i], a_half));
                mma_rows<Op, NT>(acc1[i], a, bh, bl);
            }
        }
    } else {
        for (int c0 = 0; c0 < CI; c0 += KC) {
            if (c0) __syncthreads();   // the previous chunk consumed
            // the stride-2 window, channel-innermost, even columns first
            stage_items<4>(win, 2 * T::SH * T::SW,
                           [&](int i, uint32_t(&v)[4]) {
                const int sx = i % T::SW, sy = i / T::SW % T::SH;
                const int u = i / (T::SW * T::SH);
                const int gy = iy0 + sy, gx = ix0 + sx;
                if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
                    const Tin* p = xb + ((size_t)(c0 + HV * u) * H + gy) * W
                                   + gx;
#pragma unroll
                    for (int j = 0; j < HV; ++j)
                        put<Op>(v, j, p[(size_t)j * H * W]);
                }
                return swz(sy * T::SW + ((sx & 1) ? T::SE : 0) + (sx >> 1), u);
            });
            stage_items<2>(wdsh, 9 * NP * 2, [&](int i, uint32_t(&v)[4]) {
                const int n = i % NP, tap = i / NP % 9, u = i / (9 * NP);
                if (n < C) {
                    const Op* p = wd + ((size_t)(c0 + HV * u) * 9 + tap) * C
                                  + n;
#pragma unroll
                    for (int j = 0; j < HV; ++j) put<Op>(v, j, p[j * 9 * C]);
                }
                return swz(tap * NP + n, u);
            }, T::kLow ? 0 : T::wd_plane);
            __syncthreads();
#pragma unroll 1
            for (int kh = 0; kh < 3; ++kh) {
#pragma unroll
                for (int kw = 0; kw < 3; ++kw) {
                    uint32_t bh[NT][2], bl[NT][2];
                    load_b<Op, NT>(wd_u, (kh * 3 + kw) * NP, lane,
                                   T::wd_plane, bh, bl);
                    const int toff = kh * T::SW + (kw == 1 ? T::SE : kw / 2);
#pragma unroll
                    for (int i = 0; i < T::I1; ++i) {
                        if (warp + kStemWarps * i >= T::MT1) break;
                        uint32_t a[4];
                        ldmatrix_x4(a, win_u + swz(arow[i] + toff, a_half));
                        mma_rows<Op, NT>(acc1[i], a, bh, bl);
                    }
                }
            }
        }
    }

    // 2. the map: shift, GELU, zero outside the output, from the sums
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
                if constexpr (T::kLow)
                    *reinterpret_cast<uint32_t*>(
                        map + (nt >> 1) * MP * 32 + swz(p, nt & 1) + 4 * t) =
                        pack_bf16(v[0], v[1]);
                else    // n-tile nt is chunk nt; channels 2t, 2t + 1
                    *reinterpret_cast<float2*>(
                        map + nt * MP * 32 + swz(p, t >> 1) + 8 * (t & 1)) =
                        make_float2(v[0], v[1]);
            }
            if (T::kLow && NT % 2)   // the last chunk's channels past 8 NT
                *reinterpret_cast<uint32_t*>(
                    map + (NT >> 1) * MP * 32 + swz(p, 1) + 4 * t) = 0;
        }
    }
    __syncthreads();   // the map complete; the window and wd consumed

    // 3. the stride-1 conv from the map, the fp32 form's weights WP chunks
    // a pass
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
    for (int ck0 = 0; ck0 < T::CK; ck0 += T::WP) {
        const int n_ck = min(T::WP, T::CK - ck0);
        if constexpr (!T::kLow) {
            if (ck0) __syncthreads();   // the previous pass consumed
            stage_wc(ck0, n_ck);
            __syncthreads();
        }
#pragma unroll 1
        for (int ck = 0; ck < n_ck; ++ck) {
#pragma unroll 1
            for (int kh = 0; kh < 3; ++kh) {
#pragma unroll
                for (int kw = 0; kw < 3; ++kw) {
                    uint32_t bh[NT][2], bl[NT][2];
                    load_b<Op, NT>(wc_u,
                                   (ck * T::WB * 9 + kh * 3 + kw) * NP, lane,
                                   T::wc_plane, bh, bl);
#pragma unroll
                    for (int i = 0; i < T::I2; ++i) {
                        uint32_t a[4];
                        ldmatrix_x4(a, map_u + (ck0 + ck) * MP * 32
                                       + swz(mrow[i] + kh * MW + kw, a_half));
                        mma_rows<Op, NT>(acc[i], a, bh, bl);
                    }
                }
            }
        }
    }

    // 4. shift, ReLU through a transpose [n][pixel] where the window was
    // (in the fp32 form the conv's last weights: after they are consumed),
    // then along W
    if constexpr (!T::kLow) __syncthreads();
    Op* out = reinterpret_cast<Op*>(win);
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
                    out[n * T::OS + q] =
                        narrow<Op>(fmaxf(acc[i][nt][j] + tc[n], 0.0f));
            }
    }
    __syncthreads();
    if (Wo % 2 == 0) {   // 2 pixels a store, each pair inside or outside
        using Pair = std::conditional_t<T::kLow, uint32_t, float2>;
        constexpr int kPairs = TW / 2;
        for (int e = tid; e < C * TH * kPairs; e += kStemThreads) {
            const int k = e % kPairs, oy = e / kPairs % TH;
            const int n = e / (kPairs * TH);
            const int gy = oy0 + oy, gx = ox0 + 2 * k;
            if (gy < Ho && gx < Wo)
                *reinterpret_cast<Pair*>(
                    y + (((size_t)b * C + n) * Ho + gy) * Wo + gx) =
                    *reinterpret_cast<const Pair*>(
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

namespace {

// The instances, X(form, CI, C, TH, TW): the StemBlocks of ESMStereo-L and
// -M (3 -> 32, 32 -> 48) and -S (3 -> 16, 16 -> 24) in each form (fp32:
// Op float, 3xTF32; bf16: the deploy form), each at the tile
// fused_stems.py::STEM_TILES gives it. The same list as
// fused_stems.py::STEM_INSTANCES (tests/test_torch_stem_up_plans.py holds
// the two to each other and to the plans).
#define STEM_INSTANCES(X)   \
    X(fp32, 3, 32, 8, 32)   \
    X(fp32, 32, 48, 8, 16)  \
    X(fp32, 3, 16, 8, 32)   \
    X(fp32, 16, 24, 8, 16)  \
    X(bf16, 3, 32, 8, 32)   \
    X(bf16, 32, 48, 8, 16)  \
    X(bf16, 3, 16, 8, 16)   \
    X(bf16, 16, 24, 8, 16)

using Op_fp32 = float;
using Op_bf16 = __nv_bfloat16;
constexpr int kLow_fp32 = 0, kLow_bf16 = 1;

// One StemBlock's launch: plan = (tile_h, tile_w, smem) for CI -> C on a
// (B, CI, H, W) input.
template <int CI, int C, int TH, int TW, typename Op>
int launch_stem_mma(const void* x, const void* wd, const float* td,
                    const void* wc, const float* tc, void* y, int B, int H,
                    int W, int smem, int approximate, cudaStream_t stream) {
    if (smem != StemTile<CI, C, TH, TW, Op>::smem)
        return (int)cudaErrorInvalidValue;
    const int Ho = H / 2, Wo = W / 2;
    const dim3 grid(((Wo + TW - 1) / TW) * ((Ho + TH - 1) / TH), B);
    return launch(stem_mma_kernel<CI, C, TH, TW, Op>, grid,
                  dim3(kStemThreads), smem, 1, stream,
                  static_cast<const StemIn<CI, Op>*>(x),
                  static_cast<const Op*>(wd), td, static_cast<const Op*>(wc),
                  tc, static_cast<Op*>(y), H, W, approximate);
}

int dispatch_stem_mma(int low, int CI, int C, const int* tile, const void* x,
                      const void* wd, const float* td, const void* wc,
                      const float* tc, void* y, int B, int H, int W,
                      int approximate, cudaStream_t stream) {
#define STEM_DISPATCH(form, ci, c, th, tw)                                  \
    if (low == kLow_##form && CI == ci && C == c && tile[0] == th           \
        && tile[1] == tw)                                                   \
        return launch_stem_mma<ci, c, th, tw, Op_##form>(                   \
            x, wd, td, wc, tc, y, B, H, W, tile[2], approximate, stream);
    STEM_INSTANCES(STEM_DISPATCH)
#undef STEM_DISPATCH
    return (int)cudaErrorInvalidValue;
}

}  // namespace

// img (B, 3, H, W) fp32 -> s2 (B, C2, H/2, W/2) and s4 (B, C4, H/4, W/4),
// fp32 or, with low (the deploy form), bf16. wd2: (3, 3, 3, C2), wc2: (C2,
// 3, 3, C2), wd4: (C2, 3, 3, C4), wc4: (C4, 3, 3, C4), each (CI, kh, kw, CO)
// with the BN scale folded in, fp32 or with low bf16; td*, tc*: the BN
// shifts, fp32. All contiguous. plan: 6 ints, stem_2's (tile_h, tile_w,
// smem) then stem_4's (fused_stems.py::stem_plan). Returns a cudaError_t:
// cudaErrorInvalidValue for H or W not a positive multiple of 4, and for
// any plan, form or width not in STEM_INSTANCES or a shared-memory count
// other than the kernel's own.
extern "C" int fused_stems(const float* img, const void* wd2,
                           const float* td2, const void* wc2,
                           const float* tc2, const void* wd4,
                           const float* td4, const void* wc4,
                           const float* tc4, void* s2, void* s4, int B, int H,
                           int W, int C2, int C4, int low, const int* plan,
                           int approximate, cudaStream_t stream) {
    if (B < 1 || H < 4 || W < 4 || H % 4 || W % 4)
        return (int)cudaErrorInvalidValue;
    const int err = dispatch_stem_mma(low, 3, C2, plan, img, wd2, td2, wc2,
                                      tc2, s2, B, H, W, approximate, stream);
    if (err != 0) return err;
    return dispatch_stem_mma(low, C2, C4, plan + 3, s2, wd4, td4, wc4, tc4, s4,
                             B, H / 2, W / 2, approximate, stream);
}
