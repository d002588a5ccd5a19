// The conv3d k3 p1 kernels' shared device code: csrc/fused_hourglass.cu
// runs them on a stored input (kernels C, E's agg, G and H's k3), and
// csrc/fused_volume_agg.cu on a correlation volume built from the
// descriptors (kernel E's group_stem). Each kernel's design is described in
// the header of csrc/fused_hourglass.cu. Both sources use the helpers here
// (the tiles, the swizzle, ldmatrix and mma fragments, mma_chunk, the
// cluster launch), and so do kernels F's and H's deploy forms
// (csrc/fused_stems.cu, csrc/fused_hourglass.cu: pack_bf16, load_b_rows,
// mma_add_rows). Kernel E's bodies are here too: conv3d_mma_body, the
// MMA kernel's body line for line over a slab producer (BuildVolume in
// fused_volume_agg.cu), and fp32_channel / fp32_epilogue, the fp32
// kernel's channel loop and epilogue. The hourglass's own kernels keep
// their text (through these, C's bf16 group_stem ran 6-21% longer on the
// H100). A conv computed either way with the same chunks and cluster split
// sums the same products in the same order: the same bits.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <unordered_map>

#include "activations.cuh"
#include "async_copy.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxCluster = 8;

__device__ __forceinline__ bool inside(int d, int h, int w, int D, int H,
                                       int W) {
    return d >= 0 && d < D && h >= 0 && h < H && w >= 0 && w < W;
}

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
    return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T narrow(float v);
template <>
__device__ __forceinline__ float narrow<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v) {
    return __float2bfloat16_rn(v);
}

// The BN and GELU of one sum: the folded shift, or with kScaled the scale
// then the shift, each rounded, as the plain version's two ops.
template <bool kScaled, typename Tout>
__device__ __forceinline__ Tout finish(float acc,
                                       const float* __restrict__ scale,
                                       const float* __restrict__ shift,
                                       int co, bool approx) {
    const float v = kScaled ? __fadd_rn(__fmul_rn(acc, scale[co]), shift[co])
                            : acc + shift[co];
    return narrow<Tout>(gelu(v, approx));
}

// --- tensor-core fragments (the asynchronous copies: async_copy.cuh) ----------

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], unsigned a) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a)
        : "memory");
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t& r0, uint32_t& r1,
                                            unsigned a) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
                 : "=r"(r0), "=r"(r1) : "r"(a) : "memory");
}

__device__ __forceinline__ void ldmatrix_x1(uint32_t& r0, unsigned a) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x1.shared.b16 {%0}, [%1];\n"
                 : "=r"(r0) : "r"(a) : "memory");
}

// d += a * b on one m16n8k8 tile: bf16 operands, fp32 sums.
__device__ __forceinline__ void mma_bf16_k8(float (&d)[4], uint32_t a0,
                                            uint32_t a1, uint32_t b0) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a0), "r"(a1), "r"(b0));
}

// d += a * b on one m16n8k16 tile: bf16 operands, fp32 sums.
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Byte offset of the 16-byte half `half` (channels 8 half .. 8 half + 7) of
// 32-byte row `row` (a slab voxel, or a (tap, n) weight row): the halves
// swap on every other group of 4 rows, so any 8 consecutive rows' same
// half fall in 8 distinct 16-byte bank groups (ldmatrix reads 8 rows a
// phase).
__device__ __host__ __forceinline__ int swz(int row, int half) {
    return row * 32 + ((half ^ ((row >> 2) & 1)) << 4);
}

__device__ __forceinline__ uint32_t bits16(__nv_bfloat16 v) {
    return __bfloat16_as_ushort(v);
}
__device__ __forceinline__ uint32_t bits16(int8_t v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn((float)v));
}

// Two values rounded to bf16, the first in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    return bits16(__float2bfloat16_rn(lo))
           | (bits16(__float2bfloat16_rn(hi)) << 16);
}

// The B fragments (KC 16) of NT n-tiles from rows row0 + n of a swizzled
// [row][16] layout: ldmatrix.x4 a pair of n-tiles, .x2 the last of an odd
// NT (kernels F's and H's deploy forms).
template <int NT>
__device__ __forceinline__ void load_b_rows(unsigned base, int row0,
                                            int lane, uint32_t (&bf)[NT][2]) {
    const int b_n = (lane & 7) + ((lane >> 4) << 3);
    const int b_half = (lane >> 3) & 1;
#pragma unroll
    for (int j = 0; j + 1 < NT; j += 2) {
        uint32_t r[4];
        ldmatrix_x4(r, base + swz(row0 + j * 8 + b_n, b_half));
        bf[j][0] = r[0];
        bf[j][1] = r[1];
        bf[j + 1][0] = r[2];
        bf[j + 1][1] = r[3];
    }
    if (NT % 2)
        ldmatrix_x2(bf[NT - 1][0], bf[NT - 1][1],
                    base + swz(row0 + (NT - 1) * 8 + (lane & 7), b_half));
}

// acc[nt] += a x b[nt] on m16n8k16 tiles, each product summed from zero and
// added to the running sum with one rounded fp32 add, as mma_chunk does.
template <int NT>
__device__ __forceinline__ void mma_add_rows(float (&acc)[NT][4],
                                             const uint32_t (&a)[4],
                                             const uint32_t (&bf)[NT][2]) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
        float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        mma_bf16(part, a, bf[nt][0], bf[nt][1]);
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[nt][j] = __fadd_rn(acc[nt][j], part[j]);
    }
}

// --- the deploy form: implicit GEMM on the tensor cores ---------------------

constexpr int kMmaWarps = 4;   // consumer warps, the MMAs

// Producer warps: 4, or 8 where 5 or more n-tiles make the weights of a
// chunk (27 x NP x KC values) the larger part of its copies; and the items
// (8 loads each) a producer keeps in flight: 2 at one n-tile, where the
// registers bound the blocks an SM holds, else 4 (the faster of 2, 4 and 8
// on the H100 at each).
__host__ __device__ constexpr int load_warps(int NT) {
    return NT >= 5 ? 8 : 4;
}
__host__ __device__ constexpr int load_batch(int NT) {
    return NT == 1 ? 2 : 4;
}
__host__ __device__ constexpr int mma_threads(int NT) {
    return 32 * (kMmaWarps + load_warps(NT));
}

// A block's tile of 16 x TH x TD output voxels (w, h, d) at stride S with
// input channels in chunks of KC (16, or 8 where CI <= 8): the input slab
// it reads, in shared memory [sd][sh][column][KC ci], beside a chunk's
// weights [tap][NP + 1][KC ci] (a tap's rows padded by one, so that a
// producer's 8 consecutive taps hit 8 distinct bank groups).
template <int S, int TH, int TD, int NT, int KC>
struct MmaTile {
    static constexpr int sd = S * (TD - 1) + 3;
    static constexpr int sh = S * (TH - 1) + 3;
    static constexpr int sw = S * 15 + 3;            // 18 or 33 columns
    static constexpr int row = 2 * KC;     // bytes a voxel or (tap, n)
    static constexpr int halves = KC / 8;            // 16-byte units a row
    static constexpr int voxels = 16 * TH * TD;
    static constexpr int slab_bytes = sd * sh * sw * row;
    static constexpr int mtiles = TH * TD;           // one per (d, h) row
    static constexpr int wrow = 8 * NT + 1;          // weight rows a tap
    static constexpr int stage = slab_bytes + 27 * wrow * row;
};

// Byte offset of 16-byte unit `half` of row `row` in a layout of KC
// channels a row: swz at 16; at 8 the rows are single units, and any 8
// consecutive ones are 8 distinct bank groups as they stand.
template <int KC>
__device__ __forceinline__ int unit(int row, int half) {
    return KC == 16 ? swz(row, half) : row * 16;
}

// Shared-memory column of slab column sw: itself at stride 1; at stride 2
// the 17 even columns first, then the 16 odd ones, so that output column
// ww at tap kw reads column wcol<S>(kw) + ww at either stride.
template <int S>
__device__ __forceinline__ int wcol(int sw) {
    return S == 1 ? sw : ((sw & 1) ? 17 : 0) + (sw >> 1);
}

// Waits for nthr threads (a multiple of 32) on named barrier 1: a barrier
// among a kernel's producer warps, or among all its warps when they all
// stage.
__device__ __forceinline__ void bar_sync_1(int nthr) {
    asm volatile("bar.sync 1, %0;\n" :: "r"(nthr) : "memory");
}

// One chunk's 27 taps for one consumer warp: MT m-tiles x NT n-tiles, each
// tap an m16n8k16 (KC 16) or m16n8k8 (KC 8) from zero, added to the sums.
template <int S, int NT, int TH, int TD, int KC, int MT>
__device__ __forceinline__ void mma_chunk(const char* buf,
                                          float (&acc)[MT][NT][4], int warp,
                                          int lane) {
    using T = MmaTile<S, TH, TD, NT, KC>;
    const unsigned slab = smem_u32(buf);
    const unsigned wsh = slab + T::slab_bytes;
    // KC 16, ldmatrix.x4 of A: lane l addresses row (l & 7) + 8 ((l >> 3)
    // & 1) of the 16 voxels, channel half l >> 4 (a0..a3 of the fragment);
    // of B (two n-tiles): n (l & 7) + 8 (l >> 4), half (l >> 3) & 1. KC 8,
    // ldmatrix.x2 of A: row l & 15 (a0, a1); of B (two n-tiles): n l & 15.
    const int a_row = KC == 16 ? (lane & 7) + ((lane >> 3) & 1) * 8
                               : lane & 15;
    const int a_half = KC == 16 ? lane >> 4 : 0;
    const int b_n = KC == 16 ? (lane & 7) + ((lane >> 4) << 3) : lane & 15;
    const int b_half = KC == 16 ? (lane >> 3) & 1 : 0;
    int row0[MT];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
        const int mg = warp * MT + mt;
        const int td = mg / TH, th = mg % TH;
        row0[mt] = (S * td * T::sh + S * th) * T::sw + a_row;
    }
#pragma unroll 1
    for (int kd = 0; kd < 3; ++kd) {
#pragma unroll
        for (int kh = 0; kh < 3; ++kh) {
#pragma unroll
            for (int kw = 0; kw < 3; ++kw) {
                const int tap = (kd * 3 + kh) * 3 + kw;
                uint32_t bf[NT][2];
#pragma unroll
                for (int j = 0; j + 1 < NT; j += 2) {
                    const unsigned at = wsh + unit<KC>(tap * T::wrow + j * 8
                                                       + b_n, b_half);
                    if constexpr (KC == 16) {
                        uint32_t r[4];
                        ldmatrix_x4(r, at);
                        bf[j][0] = r[0];
                        bf[j][1] = r[1];
                        bf[j + 1][0] = r[2];
                        bf[j + 1][1] = r[3];
                    } else {
                        ldmatrix_x2(bf[j][0], bf[j + 1][0], at);
                    }
                }
                if (NT % 2) {
                    const unsigned at = wsh + unit<KC>(
                        tap * T::wrow + (NT - 1) * 8 + (lane & 7), b_half);
                    if constexpr (KC == 16)
                        ldmatrix_x2(bf[NT - 1][0], bf[NT - 1][1], at);
                    else
                        ldmatrix_x1(bf[NT - 1][0], at);
                }
                const int toff = (kd * T::sh + kh) * T::sw + wcol<S>(kw);
#pragma unroll
                for (int mt = 0; mt < MT; ++mt) {
                    uint32_t a[4];
                    const unsigned at = slab + unit<KC>(row0[mt] + toff,
                                                        a_half);
                    if constexpr (KC == 16)
                        ldmatrix_x4(a, at);
                    else
                        ldmatrix_x2(a[0], a[1], at);
#pragma unroll
                    for (int nt = 0; nt < NT; ++nt) {
                        // the tap's products summed from 0, then added to
                        // the running sum with one rounded fp32 add
                        float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
                        if constexpr (KC == 16)
                            mma_bf16(part, a, bf[nt][0], bf[nt][1]);
                        else
                            mma_bf16_k8(part, a[0], a[1], bf[nt][0]);
#pragma unroll
                        for (int j = 0; j < 4; ++j)
                            acc[mt][nt][j] = __fadd_rn(acc[mt][nt][j],
                                                       part[j]);
                    }
                }
            }
        }
    }
}

// The MMA conv over a slab producer, for the x of one block: a tile of 16 x
// TH x TD output voxels of (B, CO, Do, Ho, Wo) at stride S, all of CO's
// NT n-tiles; grid (output tiles x R, CO blocks of 8 NT channels, B),
// blocks R c .. R c + R - 1 one cluster over tile c, rank r summing chunks
// [r nch / R, (r + 1) nch / R) of KC input channels. prod.stage(smem, buf,
// c0, co0, b, di0, hi0, wi0, ptid, nthr) fills buf with the chunk from
// input channel c0 (the slab [sd][sh][column][KC ci] bf16, then the
// chunk's weights [tap][8 NT + 1][KC ci]) with threads ptid of nthr; smem
// is the block's dynamic shared memory, for a producer's own buffers past
// the stages. Every warp stages the rank's first chunk; then kLoad
// producer warps stage chunk k + 1 while the kMmaWarps consumer warps
// multiply chunk k; one barrier a chunk. y = GELU(sum * scale + shift)
// (the eval BN after the fp32 sum), through a shared-memory transpose and
// the cluster's rank-ordered sum.
template <int S, int NT, int TH, int TD, int KC, int kLoad, typename Tout,
          typename Producer>
__device__ __forceinline__ void conv3d_mma_body(
        const Producer& prod, const float* __restrict__ scale,
        const float* __restrict__ shift, Tout* __restrict__ y, int CI,
        int CO, int Do, int Ho, int Wo, int R, int approximate) {
    using T = MmaTile<S, TH, TD, NT, KC>;
    constexpr int NP = 8 * NT;
    constexpr int MT = T::mtiles / kMmaWarps;
    constexpr int kThreads = 32 * (kMmaWarps + kLoad);
    constexpr int PS = T::voxels + 4;                 // partial row stride
    extern __shared__ uint4 smem_u4[];
    char* smem = reinterpret_cast<char*>(smem_u4);

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int rank = blockIdx.x % R, tile = blockIdx.x / R;
    const int tilesW = (Wo + 15) / 16, tilesH = (Ho + TH - 1) / TH;
    const int wo0 = (tile % tilesW) * 16;
    const int ho0 = (tile / tilesW % tilesH) * TH;
    const int do0 = tile / (tilesW * tilesH) * TD;
    const int co0 = blockIdx.y * NP, b = blockIdx.z;
    const int nch = (CI + KC - 1) / KC;
    const int c_begin = rank * nch / R, c_end = (rank + 1) * nch / R;
    const int di0 = S * do0 - 1, hi0 = S * ho0 - 1, wi0 = S * wo0 - 1;

    float acc[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[mt][nt][j] = 0.0f;

    const int n_local = c_end - c_begin;
    if (n_local > 0)
        prod.stage(smem, smem, KC * c_begin, co0, b, di0, hi0, wi0, tid,
                   kThreads);
    __syncthreads();
    for (int it = 1; it <= n_local; ++it) {
        if (warp >= kMmaWarps) {
            if (it < n_local)
                prod.stage(smem, smem + (it & 1) * T::stage,
                           KC * (c_begin + it), co0, b, di0, hi0, wi0,
                           tid - 32 * kMmaWarps, kThreads - 32 * kMmaWarps);
        } else {
            mma_chunk<S, NT, TH, TD, KC, MT>(
                smem + ((it - 1) & 1) * T::stage, acc, warp, lane);
        }
        __syncthreads();
    }

    // partial sums [n][voxel] in this block's shared memory
    float* P = reinterpret_cast<float*>(smem);
    if (warp < kMmaWarps) {
        const int g = lane >> 2, t = lane & 3;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
            const int m0 = (warp * MT + mt) * 16 + g;
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    P[(nt * 8 + 2 * t + (j & 1)) * PS + m0 + 8 * (j >> 1)] =
                        acc[mt][nt][j];
        }
    }
    cg::cluster_group cluster = cg::this_cluster();
    if (R > 1)
        cluster.sync();
    else
        __syncthreads();
    const bool approx = approximate != 0;
    const int total = min(NP, CO - co0) * T::voxels;
    const size_t plane = (size_t)Ho * Wo;
    for (int e = tid + rank * kThreads; e < total; e += R * kThreads) {
        const int n = e / T::voxels, m = e % T::voxels;
        const int pe = n * PS + m;
        float s = R > 1 ? *cluster.map_shared_rank(P + pe, 0) : P[pe];
        for (int q = 1; q < R; ++q) s += *cluster.map_shared_rank(P + pe, q);
        const int w = wo0 + m % 16, h = ho0 + m / 16 % TH;
        const int d = do0 + m / (16 * TH);
        if (d < Do && h < Ho && w < Wo)
            y[((size_t)b * CO + co0 + n) * Do * plane + (size_t)d * plane
              + (size_t)h * Wo + w] =
                finish<true, Tout>(s, scale, shift, co0 + n, approx);
    }
    if (R > 1) cluster.sync();   // no block leaves while others read it
}

// --- the fp32 form: direct FMA, channels double-buffered with cp.async ------

constexpr int kFp32MaxThreads = 512;

// A block's tile of 32 x TH x KDC output voxels (w, h, d) at stride S and
// the input slab of one channel, in floats (padded to 16 bytes).
template <int S, int TH, int KDC>
struct Fp32Tile {
    static constexpr int sd = S * (KDC - 1) + 3;
    static constexpr int sh = S * (TH - 1) + 3;
    static constexpr int sw = S * 31 + 3;
    static constexpr int slab = (sd * sh * sw + 3) / 4 * 4;
    static constexpr int voxels = 32 * TH * KDC;
};

// One input channel of the fp32 conv: its slab xsh (Fp32Tile's) times its
// weights wsh ([tap][NP], this thread's 8 output channels first) into the
// KDC x 8 sums of the thread at column tx, row ty. For each (kh, kw) tap
// the column's depth values are loaded once and reused for three kd taps
// and 8 outputs.
template <int S, int TH, int KDC>
__device__ __forceinline__ void fp32_channel(const float* xsh,
                                             const float* wsh, int NP,
                                             float (&acc)[KDC][8], int tx,
                                             int ty) {
    using T = Fp32Tile<S, TH, KDC>;
#pragma unroll
    for (int kh = 0; kh < 3; ++kh) {
#pragma unroll
        for (int kw = 0; kw < 3; ++kw) {
            float col[T::sd];
#pragma unroll
            for (int sd = 0; sd < T::sd; ++sd)
                col[sd] = xsh[(sd * T::sh + S * ty + kh) * T::sw + S * tx
                              + kw];
#pragma unroll
            for (int kd = 0; kd < 3; ++kd) {
                const float4* wk = reinterpret_cast<const float4*>(
                    wsh + ((kd * 3 + kh) * 3 + kw) * NP);
                const float4 w0 = wk[0], w1 = wk[1];
                const float wr[8] = {w0.x, w0.y, w0.z, w0.w,
                                     w1.x, w1.y, w1.z, w1.w};
#pragma unroll
                for (int dd = 0; dd < KDC; ++dd)
#pragma unroll
                    for (int o = 0; o < 8; ++o)
                        acc[dd][o] = fmaf(col[S * dd + kd], wr[o],
                                          acc[dd][o]);
            }
        }
    }
}

// The fp32 conv's epilogue: a thread's sums (row ty, column tx, channel
// group g of the block's NP) through the folded BN's shift and GELU into y
// (B, CO, Do, Ho, Wo); with R > 1 through the partial sums in smem, summed
// over the cluster in rank order. kMasked skips the channels past CO.
template <int TH, int KDC, bool kMasked>
__device__ __forceinline__ void fp32_epilogue(
        const float (&acc)[KDC][8], float* smem,
        const float* __restrict__ shift, float* __restrict__ y, int b,
        int CO, int co0, int NP, int g, int wo0, int ho0, int do0, int Do,
        int Ho, int Wo, int R, int rank, int tx, int ty, int approximate) {
    constexpr int voxels = 32 * TH * KDC;
    const bool approx = approximate != 0;
    const size_t oplane = (size_t)Ho * Wo;
    const size_t ovol = (size_t)Do * oplane;
    const int nthr = blockDim.x, tid = threadIdx.x;
    if (R == 1) {
        const int h = ho0 + ty, w = wo0 + tx;
        if (h >= Ho || w >= Wo) return;
        float* yb = y + ((size_t)b * CO + co0 + 8 * g) * ovol
                    + (size_t)h * Wo + w;
#pragma unroll
        for (int dd = 0; dd < KDC; ++dd) {
            const int d = do0 + dd;
            if (d >= Do) break;
#pragma unroll
            for (int o = 0; o < 8; ++o)
                if (!kMasked || co0 + 8 * g + o < CO)
                    yb[(size_t)o * ovol + (size_t)d * oplane] =
                        finish<false, float>(acc[dd][o], nullptr, shift,
                                             co0 + 8 * g + o, approx);
        }
        return;
    }
    // partial sums [channel][voxel], reduced over the cluster in rank order
    __syncthreads();
    float* P = smem;
#pragma unroll
    for (int dd = 0; dd < KDC; ++dd)
#pragma unroll
        for (int o = 0; o < 8; ++o)
            P[(8 * g + o) * voxels + (dd * TH + ty) * 32 + tx] = acc[dd][o];
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    const int total = min(NP, CO - co0) * voxels;
    for (int e = tid + rank * nthr; e < total; e += R * nthr) {
        float s = *cluster.map_shared_rank(P + e, 0);
        for (int q = 1; q < R; ++q) s += *cluster.map_shared_rank(P + e, q);
        const int n = e / voxels, m = e % voxels;
        const int w = wo0 + m % 32, h = ho0 + m / 32 % TH;
        const int d = do0 + m / (32 * TH);
        if (d < Do && h < Ho && w < Wo)
            y[((size_t)b * CO + co0 + n) * ovol + (size_t)d * oplane
              + (size_t)h * Wo + w] =
                finish<false, float>(s, nullptr, shift, co0 + n, approx);
    }
    cluster.sync();
}

// Launches kernel on grid x block with smem bytes of dynamic shared memory,
// as a cluster of R blocks along x when R > 1.
template <typename... Params, typename... Args>
int launch(void (*kernel)(Params...), dim3 grid, dim3 block, int smem, int R,
           cudaStream_t stream, Args... args) {
    if (smem > 48 * 1024) {
        // the most each kernel was allowed so far (one card a process)
        static std::unordered_map<const void*, int> allowed;
        int& most = allowed[reinterpret_cast<const void*>(kernel)];
        if (smem > most) {
            const cudaError_t err = cudaFuncSetAttribute(
                reinterpret_cast<const void*>(kernel),
                cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
            if (err != cudaSuccess) return (int)err;
            most = smem;
        }
    }
    cudaLaunchConfig_t config = {};
    config.gridDim = grid;
    config.blockDim = block;
    config.dynamicSmemBytes = smem;
    config.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = R;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    config.attrs = attr;
    config.numAttrs = R > 1 ? 1 : 0;
    const cudaError_t err = cudaLaunchKernelEx(&config, kernel, args...);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

}  // namespace
