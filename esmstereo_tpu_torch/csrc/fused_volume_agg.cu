// Kernel E: the correlation volume built inside group_stem (corr_stem for
// norm-correlation). The (B, G, D, H, W) volume is never written to device
// memory.
//
// Replaces esmstereo_tpu/ops/pallas/fused_agg_stem.py::
// folded_volume_stem_agg_apply (pallas_call at :486), in its gwc form (G = 32)
// and its norm-correlation form (G = 1, normalised), in the unfolded layout.
// The wrapper (ops/kernels/fused_agg_stem.py::volume_stem_agg) launches, for
// the normalised form, kernel B's l2_normalize_groups (csrc/correlation.cu)
// into scratch, as JAX E normalises outside its pallas_call
// (fused_agg_stem.py:359-364); then this kernel, which applies group_stem
// (G -> 8 channels, 3x3x3, BN, GELU) to a volume it builds from the
// descriptors, writing the 8-channel intermediate; then kernel C's 8 -> 8
// conv (csrc/fused_hourglass.cu) for agg. The volume is, as in kernel B
// (csrc/correlation.cu),
//     V[b, g, d, h, w] = mean_{c in group g} ref[b, c, h, w] * tgt[b, c, h, w - d]
// with 0 where w < d, and the conv's zero padding outside the volume.
//
// What bounds it on an H100: at L (D = 48 at 136 x 248, G = 32) it reads
// 2 x 8.6 MB of descriptors and writes 52 MB (fp32; 26 MB bf16) for about
// 22 GFLOP of group_stem and 0.2 GFLOP of volume: operations in fp32
// (0.33 ms at 67 TFLOP/s), bytes on the tensor cores (0.010 ms, against
// 0.022 ms of bf16 operations). Kernels B + C move the 207 MB (bf16:
// 104 MB) volume twice for the same result. At G = 1 group_stem is 27 x 8
// multiply-adds a voxel and the volume 64 a bin.
//
// Design: one conv, two slab producers. group_stem is kernel C's conv3d
// k3 s1 p1 (csrc/conv3d.cuh: C's helpers and mma_chunk shared, its kernel
// body copied line for line over a slab producer, since C's own kernel
// ran slower through the producer template), run with the chunks and
// cluster split of kernel C's group_stem
// plan for the same shape (fused_agg_stem.py::volume_plan, from
// fused_hourglass.py::conv_plan); only where its slab comes from differs:
// kernel C loads the stored volume, E computes it from the descriptors in
// shared memory. With the same chunk order, tap order and cluster split,
// E's intermediate equals kernels B then C bit for bit, in every form. The
// tile is C's too, but for the bf16 forms without a cluster split, which
// take the largest MMA tile that fills the card ((4, 4), where C takes
// (4, 2) at G = 32): each MMA row is one output voxel, so the tile does
// not enter the sums, and a deeper tile builds fewer halo entries an
// output.
//
// The bf16 forms (the deploy numerics; form 1 on bf16 descriptors, form 2
// on the fp32 normalised maps of bf16 descriptors): conv3d_mma_body, the
// implicit GEMM on mma.sync (bf16 operands, fp32 sums), over BuildVolume:
// for each chunk of KC groups (16 at G = 32, two chunks; 8 at G = 1, of
// which one is real, as kernel C's corr_stem), the producer warps stage the
// chunk's descriptor channels (2 a group in gwc, 64 at G = 1) over the
// tile's rows, the reference over the slab's columns and the target over
// the shifted window w - d, then compute each slab entry straight into the
// MMA kernel's channel-innermost, swizzled [d][h][w][KC] bf16 layout with
// kernel B's bf16 arithmetic: each fp32 product rounded to bf16, summed in
// fp32 in channel order, times 1/(C/G), rounded to bf16. The consumer warps
// run one chunk's 27 taps while the producers build the next; every warp
// builds the first. At G = 1 (one chunk of 64-channel dots) the building,
// not the MMAs, is the work, so that form has 8 producer warps against 4.
// The epilogue is C's: GELU(__fadd_rn(__fmul_rn(sum, scale), shift)), bf16.
//
// The fp32 form (form 0): the fp32 FMA conv's loop and epilogue
// (fp32_channel, fp32_epilogue) over a per-group slab built from the
// descriptors by fmaf in channel order, times 1/(C/G) (kernel B's fp32
// entry). The block stages its rank's group_stem weights once; the
// descriptor channels of the next unit (a group in gwc, 16 channels of
// the one group at G = 1) fly by cp.async while the block builds this
// unit's slab and runs the previous group's FMAs: one wait and one
// barrier a unit, the slab and the descriptors each double-buffered.
// Small grids split the groups over a thread-block cluster of up to 8 with
// the partial sums reduced in rank order through distributed shared
// memory, as kernel C's fp32 conv.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "conv3d.cuh"

namespace {

constexpr int kCo = 8;           // group_stem's output channels
constexpr int kChannels = 64;    // the descriptors' channels
constexpr int kFp32Build = 2;    // the fp32 form's build threads at G = 1,
                                 // in multiples of its conv threads

__device__ __forceinline__ float round_bf16(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
}

// --- the bf16 forms: the MMA conv over a slab built from the descriptors ---

// The slab producer of E's bf16 forms (conv3d_mma_body's Producer) for a
// tile of 16 x TH x TD voxels, chunks of KC groups of kCpg descriptor
// channels each: ref, tgt (B, G kCpg, H, W) of type Tin (bf16, or the fp32
// normalised maps); wgt (8, G, 3, 3, 3) bf16, raw. Its descriptor buffer
// starts desc_off bytes into the block's shared memory.
template <int TH, int TD, int KC, int kCpg, typename Tin>
struct BuildVolume {
    using T = MmaTile<1, TH, TD, 1, KC>;
    static constexpr int kTgtW = T::sw + T::sd - 1;   // target columns a row
    // descriptor channels of a chunk: its groups' (KC, or all G = 1)
    static constexpr int kChan =
        (KC < kChannels / kCpg ? KC : kChannels / kCpg) * kCpg;
    static constexpr int kRef = kChan * T::sh * T::sw;
    static constexpr int kTgt = kChan * T::sh * kTgtW;
    // a staged (row, column)'s channels: kUnits 16-byte units of kPer
    // values
    static constexpr int kPer = 16 / (int)sizeof(Tin);
    static constexpr int kUnits = kChan / kPer;
    static constexpr int kDescBytes =
        ((kRef + kTgt) * (int)sizeof(Tin) + 15) / 16 * 16;

    const Tin* ref;
    const Tin* tgt;
    const __nv_bfloat16* wgt;
    int G, D, H, W, desc_off;

    // Element offset of 16-byte unit u of staged row `row` (a (row,
    // column) of the window): the units XOR-swizzled so that the same unit
    // of 8 consecutive rows falls in 8 distinct 16-byte bank groups.
    __device__ __forceinline__ static int at(int row, int u) {
        constexpr int kStep = kUnits >= 8 ? 1 : 8 / kUnits;
        constexpr int kMask = (kUnits >= 8 ? 8 : kUnits) - 1;
        return row * kChan + (u ^ (row / kStep & kMask)) * kPer;
    }

    // channels c .. c + 7 (c a multiple of 8) of staged row `row`, widened
    __device__ __forceinline__ static void load8(const Tin* base, int row,
                                                 int c, float* f) {
        alignas(16) Tin v[8];
#pragma unroll
        for (int k = 0; k < 8 / kPer; ++k)
            reinterpret_cast<uint4*>(v)[k] = *reinterpret_cast<const uint4*>(
                base + at(row, c / kPer + k));
#pragma unroll
        for (int j = 0; j < 8; ++j) f[j] = widen(v[j]);
    }

    // The entries of groups 8 half .. 8 half + 7 (those below ng) at one
    // voxel of a G = 32 chunk (stage computes G = 1's one group inline),
    // from its staged reference row rrow and target row trow, packed as
    // bf16 pairs into v: kernel B's bf16 arithmetic,
    // each fp32 product rounded to bf16, summed in fp32 in channel order
    // from +0, times 1/(C/G), rounded to bf16.
    __device__ __forceinline__ static void entries(const Tin* rd, int rrow,
                                                   const Tin* td, int trow,
                                                   int half, int ng,
                                                   uint32_t (&v)[4]) {
        static_assert(kCpg == 2, "groups of 2 channels");
        // 16 channels: 8 groups of 2
        float rf[16], tf[16];
        load8(rd, rrow, 16 * half, rf);
        load8(rd, rrow, 16 * half + 8, rf + 8);
        load8(td, trow, 16 * half, tf);
        load8(td, trow, 16 * half + 8, tf + 8);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            if (8 * half + j >= ng) break;
            float s = __fadd_rn(0.0f, round_bf16(__fmul_rn(rf[2 * j],
                                                           tf[2 * j])));
            s = __fadd_rn(s, round_bf16(__fmul_rn(rf[2 * j + 1],
                                                  tf[2 * j + 1])));
            v[j / 2] |= bits16(__float2bfloat16_rn(__fmul_rn(s, 0.5f)))
                        << (16 * (j & 1));
        }
    }

    // channels [0, nd) of x (the chunk's first channel of batch b) over
    // rows hi0 .. hi0 + sh and ncol columns from col0 into dst, channel
    // innermost [sh][col][kChan] (its units swizzled by at), zero outside
    // the image. An item is 8 channels of one (row, column): 8 loads,
    // consecutive threads on consecutive columns, then one 16-byte (bf16)
    // or two (fp32) stores.
    __device__ __forceinline__ void window(const Tin* __restrict__ x,
                                           Tin* dst, int nd, int ncol,
                                           int col0, int hi0, int ptid,
                                           int nthr) const {
        const int n = (nd / 8) * T::sh * ncol;
        const size_t plane = (size_t)H * W;
        for (int i = ptid; i < n; i += nthr) {
            const int col = i % ncol, sh = i / ncol % T::sh;
            const int u = i / (ncol * T::sh);
            const int gh = hi0 + sh, gw = col0 + col;
            alignas(16) Tin v[8];
            const bool ok = gh >= 0 && gh < H && gw >= 0 && gw < W;
            const Tin* p = x + (size_t)8 * u * plane + (size_t)gh * W + gw;
#pragma unroll
            for (int j = 0; j < 8; ++j)
                v[j] = ok ? p[(size_t)j * plane] : Tin(0.0f);
#pragma unroll
            for (int k = 0; k < 8 / kPer; ++k)
                *reinterpret_cast<uint4*>(dst + at(sh * ncol + col,
                                                   8 / kPer * u + k)) =
                    reinterpret_cast<uint4*>(v)[k];
        }
    }

    // the chunk of groups [c0, c0 + KC) into buf, by threads ptid of nthr
    __device__ __forceinline__ void stage(char* smem, char* buf, int c0,
                                          int co0, int b, int di0, int hi0,
                                          int wi0, int ptid, int nthr) const {
        Tin* rd = reinterpret_cast<Tin*>(smem + desc_off);
        Tin* td = rd + kRef;
        const int ng = min(KC, G - c0);
        const size_t cbase = ((size_t)b * G + c0) * kCpg * H * W;
        // least target column of the slab: w = wi0, d = di0 + sd - 1;
        // columns left of the image are the zeros that make w < d vanish
        const int tw0 = wi0 - di0 - (T::sd - 1);
        window(ref + cbase, rd, ng * kCpg, T::sw, wi0, hi0, ptid, nthr);
        window(tgt + cbase, td, ng * kCpg, kTgtW, tw0, hi0, ptid, nthr);
        bar_sync_1(nthr);
        // slab items (voxel, 8-group unit): B's bf16 entries, zero outside
        // the volume and past G; consecutive threads on consecutive w
        constexpr int kVox = T::sd * T::sh * T::sw;
        if constexpr (kCpg == 2) {
            for (int i = ptid; i < T::halves * kVox; i += nthr) {
                const int half = i / kVox, vox = i % kVox;
                const int sw = vox % T::sw, sh = vox / T::sw % T::sh;
                const int sd = vox / (T::sw * T::sh);
                uint32_t v[4] = {0u, 0u, 0u, 0u};
                if (inside(di0 + sd, hi0 + sh, wi0 + sw, D, H, W))
                    entries(rd, sh * T::sw + sw, td,
                            sh * kTgtW + sw - sd + T::sd - 1, half, ng, v);
                *reinterpret_cast<uint4*>(buf + unit<KC>(vox, half)) =
                    make_uint4(v[0], v[1], v[2], v[3]);
            }
        } else {
            // one group of kCpg channels: each entry a kCpg-long chain of
            // dependent adds, so a thread runs two voxels' chains at once
            for (int i = ptid; i < kVox; i += 2 * nthr) {
                const int vox[2] = {i, i + nthr < kVox ? i + nthr : i};
                float s[2] = {0.0f, 0.0f};
                int rrow[2], trow[2];
                bool in[2];
#pragma unroll
                for (int q = 0; q < 2; ++q) {
                    const int sw = vox[q] % T::sw;
                    const int sh = vox[q] / T::sw % T::sh;
                    const int sd = vox[q] / (T::sw * T::sh);
                    in[q] = inside(di0 + sd, hi0 + sh, wi0 + sw, D, H, W);
                    rrow[q] = sh * T::sw + sw;
                    trow[q] = sh * kTgtW + sw - sd + T::sd - 1;
                }
#pragma unroll 2
                for (int c = 0; c < kCpg; c += 8) {
                    float rf[2][8], tf[2][8];
#pragma unroll
                    for (int q = 0; q < 2; ++q) {
                        load8(rd, rrow[q], c, rf[q]);
                        load8(td, trow[q], c, tf[q]);
                    }
#pragma unroll
                    for (int k = 0; k < 8; ++k)
#pragma unroll
                        for (int q = 0; q < 2; ++q)
                            s[q] = __fadd_rn(s[q], round_bf16(__fmul_rn(
                                rf[q][k], tf[q][k])));
                }
#pragma unroll
                for (int q = 0; q < 2; ++q) {
                    if (q == 1 && i + nthr >= kVox) break;
                    const uint32_t v = in[q]
                        ? bits16(__float2bfloat16_rn(__fmul_rn(s[q], 1.0f
                                                                / kCpg)))
                        : 0u;
                    *reinterpret_cast<uint4*>(buf + unit<KC>(vox[q], 0)) =
                        make_uint4(v, 0u, 0u, 0u);
                }
            }
        }
        // the chunk's weights [tap][n][KC ci], as stage_chunk stages them
        for (int k = ptid; k < 27 * T::halves * kCo; k += nthr) {
            const int tap = k % 27, half = k / 27 % T::halves;
            const int n = k / (27 * T::halves);
            const int c = c0 + 8 * half;
            uint32_t v[4] = {0u, 0u, 0u, 0u};
            if (co0 + n < kCo) {
                const __nv_bfloat16* p =
                    wgt + ((size_t)(co0 + n) * G + c) * 27 + tap;
#pragma unroll
                for (int j = 0; j < 8; ++j)
                    if (c + j < G)
                        v[j / 2] |= bits16(p[j * 27]) << (16 * (j & 1));
            }
            *reinterpret_cast<uint4*>(
                buf + T::slab_bytes + unit<KC>(tap * T::wrow + n, half)) =
                make_uint4(v[0], v[1], v[2], v[3]);
        }
    }
};

// ref, tgt (B, G kCpg, H, W) -> y (B, 8, D, H, W) bf16: group_stem on the
// volume, conv3d_mma_body over BuildVolume with kLoad producer warps. The
// register budget asks for 3 blocks an SM at G = 32 and 2 at G = 1, as
// many as the shared memory holds: with the budget the compiler picks
// alone, E's G = 32 group_stem at L ran about a third longer on the H100.
template <int TH, int TD, int KC, int kCpg, int kLoad, typename Tin>
__global__ void __launch_bounds__(32 * (kMmaWarps + kLoad),
                                  kCpg == 2 ? 3 : 2)
volume_stem_mma_kernel(const Tin* __restrict__ ref,
                       const Tin* __restrict__ tgt,
                       const __nv_bfloat16* __restrict__ wgt,
                       const float* __restrict__ scale,
                       const float* __restrict__ shift,
                       __nv_bfloat16* __restrict__ y, int G, int D, int H,
                       int W, int R, int desc_off, int approximate) {
    const BuildVolume<TH, TD, KC, kCpg, Tin> prod{ref, tgt, wgt, G, D, H, W,
                                                  desc_off};
    conv3d_mma_body<1, 1, TH, TD, KC, kLoad>(prod, scale, shift, y, G, kCo, D,
                                            H, W, R, approximate);
}

// --- the fp32 form: the FMA conv over per-group slabs built by fmaf --------

// The fp32 form's shared memory, in floats: the rank's weights [group][27]
// [8], two slabs, two descriptor units (kSub channels of the reference over
// the slab's columns and of the target over its shifted window).
template <int TH, int KDC, int kSub>
struct Fp32Volume {
    using T = Fp32Tile<1, TH, KDC>;
    static constexpr int kTgtW = T::sw + T::sd - 1;
    static constexpr int kRef = kSub * T::sh * T::sw;
    static constexpr int kDesc = (kRef + kSub * T::sh * kTgtW + 3) / 4 * 4;
    static constexpr int kWgt = 27 * kCo;                 // a group's
    __host__ __device__ static int floats(int groups) {
        return groups * kWgt + 2 * T::slab + 2 * kDesc;
    }
};

// ref, tgt (B, G kCpg, H, W) fp32 -> y (B, 8, D, H, W) fp32. wgt: (8, G,
// 3, 3, 3) with the BN scale folded in, shift (8,). 32 TH kBuild threads:
// all build the slabs, thread (tx, ty) < 32 TH keeps one column's KDC x 8
// sums (kBuild > 1 only without a cluster split: at G = 1 the build of
// 64-channel dots is the work). Grid: (output tiles x R, 1, B); cluster
// rank r sums groups [r G / R, (r + 1) G / R), each in kCpg / kSub units
// of kSub channels.
template <int TH, int KDC, int kCpg, int kSub, int kBuild>
__global__ void __launch_bounds__(kFp32MaxThreads)
volume_stem_fp32_kernel(const float* __restrict__ ref,
                        const float* __restrict__ tgt,
                        const float* __restrict__ wgt,
                        const float* __restrict__ shift,
                        float* __restrict__ y, int G, int D, int H, int W,
                        int R, int approximate) {
    using V = Fp32Volume<TH, KDC, kSub>;
    using T = typename V::T;
    constexpr int kUnits = kCpg / kSub;
    static_assert(kCpg % kSub == 0, "a group splits into whole units");
    extern __shared__ float4 smem_f4[];
    float* smem = reinterpret_cast<float*>(smem_f4);
    const int nthr = blockDim.x, tid = threadIdx.x;
    const int tx = tid & 31, ty = tid >> 5;
    const bool convs = tid < 32 * TH;   // the threads that keep sums
    const int rank = blockIdx.x % R, tile = blockIdx.x / R;
    const int tilesW = (W + 31) / 32, tilesH = (H + TH - 1) / TH;
    const int wo0 = (tile % tilesW) * 32;
    const int ho0 = (tile / tilesW % tilesH) * TH;
    const int do0 = tile / (tilesW * tilesH) * KDC;
    const int b = blockIdx.z;
    const int di0 = do0 - 1, hi0 = ho0 - 1, wi0 = wo0 - 1;
    const int tw0 = wi0 - di0 - (T::sd - 1);
    const size_t plane = (size_t)H * W;
    const int c_begin = rank * G / R, c_end = (rank + 1) * G / R;
    const int ng = c_end - c_begin;
    float* wsh = smem;
    float* slabs = wsh + ((G + R - 1) / R) * V::kWgt;
    float* desc = slabs + 2 * T::slab;
    const float* rb = ref + (size_t)b * G * kCpg * plane;
    const float* tb = tgt + (size_t)b * G * kCpg * plane;

    // unit u's descriptor channels into buf, zero outside the image
    auto copy_unit = [&](int u, float* buf) {
        const int c0 = (c_begin + u / kUnits) * kCpg + (u % kUnits) * kSub;
        for (int i = tid; i < V::kRef; i += nthr) {
            const int sw = i % T::sw, sh = i / T::sw % T::sh;
            const int c = i / (T::sw * T::sh);
            const int gh = hi0 + sh, gw = wi0 + sw;
            const bool ok = gh >= 0 && gh < H && gw >= 0 && gw < W;
            cp_async4(buf + i,
                      ok ? rb + (c0 + c) * plane + (size_t)gh * W + gw : ref,
                      ok);
        }
        for (int i = tid; i < kSub * T::sh * V::kTgtW; i += nthr) {
            const int tw = i % V::kTgtW, sh = i / V::kTgtW % T::sh;
            const int c = i / (V::kTgtW * T::sh);
            const int gh = hi0 + sh, gw = tw0 + tw;
            const bool ok = gh >= 0 && gh < H && gw >= 0 && gw < W;
            cp_async4(buf + V::kRef + i,
                      ok ? tb + (c0 + c) * plane + (size_t)gh * W + gw : tgt,
                      ok);
        }
    };

    // the rank's weights [group][tap][8], then unit 0
    for (int i = tid; i < ng * V::kWgt; i += nthr) {
        const int o = i % kCo, k = i / kCo % 27, gl = i / V::kWgt;
        cp_async4(wsh + i, wgt + ((size_t)o * G + c_begin + gl) * 27 + k,
                  true);
    }
    if (ng > 0) copy_unit(0, desc);
    cp_async_commit();

    float acc[KDC][8];
#pragma unroll
    for (int dd = 0; dd < KDC; ++dd)
#pragma unroll
        for (int o = 0; o < 8; ++o) acc[dd][o] = 0.0f;

    constexpr float inv = 1.0f / kCpg;
    const int units = ng * kUnits;
    for (int u = 0; u < units; ++u) {
        // unit u's copies landed everywhere; every thread is past the
        // build of unit u - 1 (whose buffer the next copies overwrite) and
        // past the FMAs of the group before the last
        cp_async_wait_all();
        __syncthreads();
        if (u + 1 < units) {
            copy_unit(u + 1, desc + ((u + 1) & 1) * V::kDesc);
            cp_async_commit();
        }
        const int gl = u / kUnits, sub = u % kUnits;
        const float* dbuf = desc + (u & 1) * V::kDesc;
        float* sbuf = slabs + (gl & 1) * T::slab;
        // B's fp32 entries, each thread on the same entries every unit,
        // two at a time (two independent chains of fmaf); zero outside the
        // volume (the conv's padding)
        constexpr int kN = T::sd * T::sh * T::sw;
        for (int i = tid; i < kN; i += 2 * nthr) {
            const int e[2] = {i, i + nthr < kN ? i + nthr : i};
            const float* rr[2];
            const float* tt[2];
            bool in[2];
            float sum[2];
#pragma unroll
            for (int q = 0; q < 2; ++q) {
                const int sw = e[q] % T::sw, sh = e[q] / T::sw % T::sh;
                const int sd = e[q] / (T::sw * T::sh);
                in[q] = inside(di0 + sd, hi0 + sh, wi0 + sw, D, H, W);
                rr[q] = dbuf + sh * T::sw + sw;
                tt[q] = dbuf + V::kRef + sh * V::kTgtW + sw - sd + T::sd - 1;
                sum[q] = sub == 0 ? 0.0f : sbuf[e[q]];
            }
#pragma unroll
            for (int k = 0; k < kSub; ++k)
#pragma unroll
                for (int q = 0; q < 2; ++q)
                    sum[q] = fmaf(rr[q][k * T::sh * T::sw],
                                  tt[q][k * T::sh * V::kTgtW], sum[q]);
#pragma unroll
            for (int q = 0; q < 2; ++q) {
                if (q == 1 && i + nthr >= kN) break;
                sbuf[e[q]] = !in[q] ? 0.0f
                    : sub == kUnits - 1 ? __fmul_rn(sum[q], inv) : sum[q];
            }
        }
        // the previous group's slab, complete since this unit's barrier
        if (sub == 0 && gl > 0 && convs)
            fp32_channel<1, TH, KDC>(slabs + ((gl - 1) & 1) * T::slab,
                                     wsh + (gl - 1) * V::kWgt, kCo, acc, tx,
                                     ty);
    }
    if (ng > 0) {
        __syncthreads();
        if (convs)
            fp32_channel<1, TH, KDC>(slabs + ((ng - 1) & 1) * T::slab,
                                     wsh + (ng - 1) * V::kWgt, kCo, acc, tx,
                                     ty);
    }
    if constexpr (kBuild > 1) {
        if (!convs) return;   // no cluster: the epilogue has no barrier
    }
    fp32_epilogue<TH, KDC, false>(acc, smem, shift, y, b, kCo, 0, kCo, 0,
                                  wo0, ho0, do0, D, H, W, R, rank, tx, ty,
                                  approximate);
}

// --- launch plans -----------------------------------------------------------

// The plan's ints, as fused_agg_stem.py::volume_plan lays them out: the
// shape, the form, the tile's rows and depths, the cluster size, the
// dynamic shared memory, the GELU form, the MMA kernel's groups a chunk,
// its producer warps (the fp32 form's warps), and the fp32 form's
// descriptor channels a unit.
struct VolumePlan {
    int B, C, G, D, H, W, form, tile_h, tile_d, cluster, smem, approximate;
    int k_chunk, load_warps, sub;
};

VolumePlan read_plan(const int* p) {
    return {p[0], p[1], p[2], p[3], p[4], p[5], p[6], p[7], p[8], p[9], p[10],
            p[11], p[12], p[13], p[14]};
}

struct Call {
    const void* ref;
    const void* tgt;
    const void* wgt;
    const float* scale;
    const float* shift;
    void* y;
    VolumePlan c;
    cudaStream_t stream;
};

template <int TH, int TD, int KC, int kCpg, int kLoad, typename Tin>
int launch_mma(const Call& m) {
    using P = BuildVolume<TH, TD, KC, kCpg, Tin>;
    using T = typename P::T;
    const VolumePlan& c = m.c;
    const int nch = (c.G + KC - 1) / KC;
    const int nbuf = (nch + c.cluster - 1) / c.cluster > 1 ? 2 : 1;
    const int desc_off = nbuf * T::stage;
    const int partial = kCo * (T::voxels + 4) * 4;
    const int loop = desc_off + P::kDescBytes;
    const int want = loop > partial ? loop : partial;
    if (c.cluster > nch || c.smem != want || c.load_warps != kLoad)
        return (int)cudaErrorInvalidValue;
    const int tiles = ((c.W + 15) / 16) * ((c.H + TH - 1) / TH)
                      * ((c.D + TD - 1) / TD);
    const dim3 grid(tiles * c.cluster, 1, c.B);
    return launch(volume_stem_mma_kernel<TH, TD, KC, kCpg, kLoad, Tin>, grid,
                  dim3(32 * (kMmaWarps + kLoad)), want, c.cluster, m.stream,
                  static_cast<const Tin*>(m.ref),
                  static_cast<const Tin*>(m.tgt),
                  static_cast<const __nv_bfloat16*>(m.wgt), m.scale, m.shift,
                  static_cast<__nv_bfloat16*>(m.y), c.G, c.D, c.H, c.W,
                  c.cluster, desc_off, c.approximate);
}

// The bf16 instances of one (KC, kCpg, kLoad, Tin): the MMA tiles (4, 4),
// (4, 2) and (2, 2).
template <int KC, int kCpg, int kLoad, typename Tin>
int dispatch_mma(const Call& m) {
    const int th = m.c.tile_h, td = m.c.tile_d;
    if (th == 4 && td == 4) return launch_mma<4, 4, KC, kCpg, kLoad, Tin>(m);
    if (th == 4 && td == 2) return launch_mma<4, 2, KC, kCpg, kLoad, Tin>(m);
    if (th == 2 && td == 2) return launch_mma<2, 2, KC, kCpg, kLoad, Tin>(m);
    return (int)cudaErrorInvalidValue;
}

template <int TH, int KDC, int kCpg, int kSub, int kBuild>
int launch_fp32(const Call& m) {
    using V = Fp32Volume<TH, KDC, kSub>;
    const VolumePlan& c = m.c;
    const int loop = 4 * V::floats((c.G + c.cluster - 1) / c.cluster);
    const int partial = c.cluster > 1 ? 4 * kCo * V::T::voxels : 0;
    const int want = loop > partial ? loop : partial;
    if (c.cluster > c.G || c.smem != want || c.sub != kSub
            || c.load_warps != TH * kBuild || (kBuild > 1 && c.cluster > 1))
        return (int)cudaErrorInvalidValue;
    const int tiles = ((c.W + 31) / 32) * ((c.H + TH - 1) / TH)
                      * ((c.D + KDC - 1) / KDC);
    const dim3 grid(tiles * c.cluster, 1, c.B);
    return launch(volume_stem_fp32_kernel<TH, KDC, kCpg, kSub, kBuild>, grid,
                  dim3(32 * TH * kBuild), want, c.cluster, m.stream,
                  static_cast<const float*>(m.ref),
                  static_cast<const float*>(m.tgt),
                  static_cast<const float*>(m.wgt), m.shift,
                  static_cast<float*>(m.y), c.G, c.D, c.H, c.W, c.cluster,
                  c.approximate);
}

// The fp32 instances of one (kCpg, kSub, kBuild): kernel C's fp32 tiles.
template <int kCpg, int kSub, int kBuild>
int dispatch_fp32(const Call& m) {
    const int th = m.c.tile_h, td = m.c.tile_d;
    if (th == 4 && td == 8) return launch_fp32<4, 8, kCpg, kSub, kBuild>(m);
    if (th == 2 && td == 4) return launch_fp32<2, 4, kCpg, kSub, kBuild>(m);
    if (th == 1 && td == 4) return launch_fp32<1, 4, kCpg, kSub, kBuild>(m);
    return (int)cudaErrorInvalidValue;
}

}  // namespace

// ref, tgt: (B, C, H, W), normalised beforehand for norm-correlation (fp32
// maps); y: (B, 8, D, H, W); all contiguous. plan: 15 ints
// (fused_agg_stem.py::volume_plan): B, C, G, D, H, W, form, tile_h,
// tile_d, cluster, smem, approximate, k_chunk, load_warps, sub; the entry
// point checks the shared memory against its own count. form 0: fp32
// descriptors, wgt (8, G, 3, 3, 3) fp32 with the BN scale folded in, scale
// unused, shift (8,), fp32 y; form 1: bf16 descriptors, form 2: the fp32
// normalised maps of bf16 descriptors, both with wgt bf16 raw, the BN's
// scale and shift (8,) fp32, and bf16 y. C = 64 with G = 32 or 1. Returns
// a cudaError_t; cudaErrorInvalidValue for a shape, form or plan it does
// not take.
extern "C" int volume_group_stem(const void* ref, const void* tgt,
                                 const void* wgt, const float* scale,
                                 const float* shift, void* y, const int* plan,
                                 cudaStream_t stream) {
    const Call m = {ref, tgt, wgt, scale, shift, y, read_plan(plan), stream};
    const VolumePlan& c = m.c;
    if (c.B < 1 || c.D < 1 || c.H < 1 || c.W < 1 || c.C != kChannels
            || (c.G != 32 && c.G != 1) || c.cluster < 1
            || c.cluster > kMaxCluster)
        return (int)cudaErrorInvalidValue;
    using bf16 = __nv_bfloat16;
    const bool gwc = c.G == 32;
    switch (c.form) {
        case 0:
            return gwc ? dispatch_fp32<2, 2, 1>(m)
                       : dispatch_fp32<64, 16, kFp32Build>(m);
        case 1:
            if (c.k_chunk != (gwc ? 16 : 8)) return (int)cudaErrorInvalidValue;
            return gwc ? dispatch_mma<16, 2, 4, bf16>(m)
                       : dispatch_mma<8, 64, 8, bf16>(m);
        case 2:
            if (c.k_chunk != (gwc ? 16 : 8)) return (int)cudaErrorInvalidValue;
            return gwc ? dispatch_mma<16, 2, 4, float>(m)
                       : dispatch_mma<8, 64, 8, float>(m);
    }
    return (int)cudaErrorInvalidValue;
}
