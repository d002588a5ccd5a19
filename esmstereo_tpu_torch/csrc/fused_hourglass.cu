// The 3-D convolutions of the cost-volume section, each with its eval
// BatchNorm and a GELU epilogue: kernels C and G, E's agg conv and H.
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
//             exists (in the deploy form both in one launch); then conv3d
//             k3 s1 p1 (CO -> CO).
//
// What bounds them on an H100: operations in fp32 (C at L is about 28
// GFLOP against 207 MB read and 52 MB written); bytes for the deploy forms
// on the tensor cores (G's three levels at L move about 52 MB for 13
// GFLOP, 0.0156 ms of HBM time against 0.0135 ms of bf16 operations). At
// M's and S's levels neither: a conv there is a few MFLOP on a grid of a
// few dozen output tiles, so the time is the latency of its chain of
// loads and barriers, and what counts is how many SMs share it.
//
// The conv3d k3 p1 (stride 1 or 2) has two kernels, each over a launch
// plan that the wrapper computes (fused_hourglass.py::conv_plan) and
// passes in as ints: the tile, the channel tiling, the cluster size and
// the shared memory, which the entry point checks against its own count.
//
// conv3d_mma_kernel, the deploy form (conv3d_k3_bn_gelu_bf16): an implicit
// GEMM on the tensor cores, as the TPU kernel's per-tap dot_general of bf16
// operands with fp32 sums (fused_agg_stem.py:142-146 there). M is a block's
// tile of 16 (w) x TH (h) x TD (d) output voxels, one 16-row m-tile per
// (d, h) row; N is all of CO in one block (n-tiles of 8, NT of them, the
// padded channels zero weights that are never stored), so the input is
// read once and not once per 8 channels; K is (input-channel chunk, tap),
// the chunks of KC = 16 channels (8 where CI <= 8: C's agg, corr_stem, G's
// first level), each zero-padded past CI. The instruction is
// mma.sync.m16n8k16 (m16n8k8 at KC 8) .row.col.f32.bf16.bf16.f32: each
// product of two bf16 values is exact in fp32; each tap's products are
// summed by the tensor core from zero and added to the running fp32 sum
// with one rounded add, as the TPU kernel adds each (kh, kw) dot to its
// accumulator (summing inside the MMA instead, whose adds do not round to
// nearest, moved up to 0.76% of a chained level's bf16 outputs against
// cuDNN's fp32 on the H100, the rounded adds up to 0.41%). The slab of one
// chunk lives in shared memory channel-innermost, [d][h][w][KC ci] bf16
// (at KC 16, 32 bytes a voxel with the two 16-byte halves swapped on every
// other group of 4 voxels, so that any 8 consecutive voxels hit 8 distinct
// bank groups), and at stride 2 with the even input columns before the odd
// ones, so that one ldmatrix reads the A fragment (16 voxels x KC
// channels) of any tap at either stride from 16 consecutive slab rows.
// int8 input is widened to bf16 as it is staged (every int8 is exact in
// bf16). A chunk's weights, the B operand, sit beside the slab as
// [tap][n][KC ci] bf16. Every warp stages a rank's first chunk; then 4
// consumer warps run chunk k's MMAs while 4 producer warps (8 where 5 or
// more n-tiles make the weights the larger copy) stage chunk k+1's slab
// and weights into the other buffer through registers: each item is 8
// coalesced 2-byte loads, 8 channels apart, packed into one 16-byte shared
// store, which is the transpose to channel-innermost (cp.async copies 4
// bytes at least and cannot do it). One barrier a chunk. The epilogue is
// GELU(__fadd_rn(__fmul_rn(sum, scale), shift)), in fp32, stored in bf16
// or fp32, through a shared-memory transpose so that the stores run along
// w. When a grid has fewer output tiles than the card has SMs, the plan
// splits the chunks over a cluster of up to 8 blocks (below).
//
// conv3d_fp32_kernel, the fp32 form (conv3d_k3_bn_gelu): fp32 FMA (TF32
// is off in every fp32 run of the port). A block owns 32 (w) x TH (h) x KDC
// (d) output voxels and NG groups of 8 output channels, a warp one (h,
// group) pair and a thread one column's KDC x 8 sums, so all of CO is in
// one block and the input slab is read once. Input channels stream through
// shared memory as the tile's halo slab beside that channel's weights,
// double-buffered with cp.async (4-byte copies, zero-filled outside the
// input): the next channel's copies fly while this channel's FMAs run, one
// wait and one barrier a channel. For each (kh, kw) tap a thread loads its
// column's depth values once and reuses each for three kd taps and 8
// outputs. Smaller tiles (fewer rows, 4 depths) fill the card where the
// large one would not.
//
// Both kernels split K where the plan asks: the blocks of a thread-block
// cluster of R <= 8 (cudaLaunchAttributeClusterDimension) share one output
// tile and each sums a contiguous share of the input channels (of the
// 16-channel chunks for the MMA kernel). Each writes its partial sums to
// its own shared memory; after a cluster barrier each block reduces a
// stripe of the tile through distributed shared memory, in rank order
// (rank 0's sum, plus rank 1's, ...), and runs the epilogue on it. One
// launch, deterministic, no scratch and no atomics. With R = 1 the fp32
// kernel stores from its registers.
//
// G's and H's deploy forms (bf16 in, bf16 out) round as
// esmstereo_tpu/attic/fused_hourglass.py's bf16 operands do (:160,264,
// 289-293 for G, :472,585,616-622,656 for H): raw bf16 weights, fp32 sums,
// the BN scale then the shift in fp32 after each sum, GELU, and every
// intermediate stored in bf16, which is the rounding the TPU kernel applies
// when that intermediate becomes the next matmul's operand; C's
// (esmstereo_tpu/ops/pallas/fused_agg_stem.py:141-155,189-192) take a bf16
// or int8 volume and write bf16, or fp32 after an int8 volume.
//
// The conv kernels' helpers (the tiles, the swizzle, the fragments,
// mma_chunk, the cluster launch) live in csrc/conv3d.cuh, which kernel E
// (csrc/fused_volume_agg.cu) shares. Its kernel bodies there follow these
// two line for line over a slab producer; these keep their own text: run
// through the producer template, C's bf16 group_stem took 6-21% longer on
// the H100 (eval/conv_repeat.py at L: 0.5596-0.5630 ms against
// 0.5207-0.5228 in one call).
//
// H's transposed conv is written in gather form (each output sums the
// 2 x 2 x 2 input taps that reach it), so it needs no atomics and repeats
// bit for bit. In fp32 it and the 1x1x1 conv are direct FMA kernels (a
// 32 x 4 (w, h) tile, kDc depths and kCot output channels a block), with
// up in device memory between them.
//
// up_cat_mma_kernel, H's deploy form of both (hourglass_up_cat_bf16), one
// launch on the tensor cores (mma.sync.m16n8k16, bf16 operands, fp32
// sums). Each of the 8 output parity classes (pd, ph, pw) is a 2 x 2 x 2
// conv of src, an implicit GEMM with M = that class's voxels of the
// block's tile, N = all of CO (n-tiles of 8: 40 -> 5, 24 -> 3, 16 and
// 12 -> 2) and K = (chunk of 16 input channels, zero-padded past CI; the
// class's 8 taps). A block owns a tile of 16 x TH x TD voxels of the
// half-resolution grid in all 8 classes (32 x 2 TH x 2 TD output voxels,
// cropped to skip's grid), one warp a class, so one staged slab of src
// (the tile plus a 1-voxel halo, channel-innermost, swizzled as the k3
// conv's) feeds all 8; a chunk's weights sit beside it as [64 taps][n][16
// ci], 8 taps of one (ci, n) loaded 16 bytes at a time and transposed in
// registers. What bounds it at L: bytes (src, skip and z, 21 MB at the
// second level, against 3.6 GFLOP), and the weights every block stages
// (123-369 KB a level). Epilogue 1: the BN scale then shift in fp32
// (__fmul_rn, __fadd_rn), GELU, rounded to bf16, straight from the
// accumulators into the A fragments of the 1x1x1 conv (the m16n8k16 C
// layout of n-tiles 2 k and 2 k + 1 is the A layout of K chunk k): up
// never leaves the registers, as the TPU kernel keeps it on chip
// (attic/fused_hourglass.py:585,616-622 there). The 1x1x1 conv over
// [up | skip] then takes skip's chunks from a staged tile [chunk][voxel]
// [16 co] with ldmatrix; BN, GELU, z stored in bf16 from the registers,
// every other column of a row a parity class (staging z through shared
// memory to store along w made L's second level no faster on the H100).
// Its sums: up's chunks then skip's, each summed from zero and added with
// one rounded add, as every (chunk, tap) of the transposed conv. The plan
// (tile, shared memory) comes from fused_hourglass.py::up_plan; the entry
// point checks it. The k3 conv runs after it on conv3d_mma_kernel.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "conv3d.cuh"

namespace {

constexpr int kTw = 32;    // output columns per block, one per thread
constexpr int kTh = 4;     // output rows per block
constexpr int kDc = 8;     // output depths per thread
constexpr int kCot = 8;    // output channels per block
constexpr int kThreads = kTw * kTh;
constexpr int kMaxCat = 256;   // input channels of the 1x1x1 conv, at most

// Writes a thread's kDc x kCot sums through the folded BN's shift and GELU
// (finish); kMasked skips the channels past CO.
template <bool kMasked>
__device__ __forceinline__ void store_tile(
        const float (&acc)[kDc][kCot], const float* __restrict__ shift,
        float* __restrict__ y, int b, int CO, int co0, int d0, int h, int w,
        int D, int H, int W, int approximate) {
    if (h >= H || w >= W) return;
    const bool approx = approximate != 0;
    const size_t plane = (size_t)H * W;
    const size_t vol = (size_t)D * plane;
    float* yb = y + ((size_t)b * CO + co0) * vol + (size_t)h * W + w;
#pragma unroll
    for (int dd = 0; dd < kDc; ++dd) {
        const int d = d0 + dd;
        if (d >= D) break;
#pragma unroll
        for (int o = 0; o < kCot; ++o)
            if (!kMasked || co0 + o < CO)
                yb[(size_t)o * vol + (size_t)d * plane] =
                    finish<false, float>(acc[dd][o], nullptr, shift, co0 + o,
                                         approx);
    }
}

// --- the deploy form: implicit GEMM on the tensor cores ---------------------

// One chunk of KC input channels (from c0) into buf: the tile's slab,
// widened to bf16 and zero outside the input or past CI, and the chunk's
// weights for output channels co0 .. co0 + 8 NT - 1, zero past CO. Items
// are (voxel, 8-channel unit) and (n, unit, tap); consecutive threads
// (ptid of nthr) take consecutive w or taps, so each of an item's 8 loads
// (8 channels, vol or 27 values apart) is coalesced over the warp, and its
// 16-byte store lands in a distinct bank group. kBatch items' loads are in
// flight before their stores.
template <int S, int TH, int TD, int NT, int KC, typename Tin>
__device__ __forceinline__ void stage_chunk(
        const Tin* __restrict__ xb, const __nv_bfloat16* __restrict__ wgt,
        char* buf, int c0, int CI, int CO, int co0, int D, int H, int W,
        int di0, int hi0, int wi0, int ptid, int nthr) {
    using T = MmaTile<S, TH, TD, NT, KC>;
    constexpr int kBatch = load_batch(NT);
    constexpr int kVox = T::sd * T::sh * T::sw;
    constexpr int kSlabItems = T::halves * kVox;
    constexpr int kItems = kSlabItems + 27 * T::halves * 8 * NT;
    const size_t plane = (size_t)H * W;
    const size_t vol = (size_t)D * plane;
    for (int i0 = ptid; i0 < kItems; i0 += nthr * kBatch) {
        uint32_t v[kBatch][4];
        int dst[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
            const int i = i0 + u * nthr;
            dst[u] = -1;
#pragma unroll
            for (int q = 0; q < 4; ++q) v[u][q] = 0;
            if (i < kSlabItems) {
                const int half = i / kVox, vox = i % kVox;
                const int sw = vox % T::sw, sh = vox / T::sw % T::sh;
                const int sd = vox / (T::sw * T::sh);
                const int gd = di0 + sd, gh = hi0 + sh, gw = wi0 + sw;
                dst[u] = unit<KC>((sd * T::sh + sh) * T::sw + wcol<S>(sw),
                                  half);
                if (inside(gd, gh, gw, D, H, W)) {
                    const int c = c0 + 8 * half;
                    const Tin* p = xb + (size_t)c * vol + (size_t)gd * plane
                                   + (size_t)gh * W + gw;
#pragma unroll
                    for (int j = 0; j < 8; ++j)
                        if (c + j < CI)
                            v[u][j / 2] |= bits16(p[(size_t)j * vol])
                                           << (16 * (j & 1));
                }
            } else if (i < kItems) {
                const int k = i - kSlabItems;
                const int tap = k % 27, half = k / 27 % T::halves;
                const int n = k / (27 * T::halves);
                dst[u] = T::slab_bytes + unit<KC>(tap * T::wrow + n, half);
                const int c = c0 + 8 * half;
                if (co0 + n < CO) {
                    const __nv_bfloat16* p =
                        wgt + ((size_t)(co0 + n) * CI + c) * 27 + tap;
#pragma unroll
                    for (int j = 0; j < 8; ++j)
                        if (c + j < CI)
                            v[u][j / 2] |= bits16(p[j * 27]) << (16 * (j & 1));
                }
            }
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u)
            if (dst[u] >= 0)
                *reinterpret_cast<uint4*>(buf + dst[u]) =
                    make_uint4(v[u][0], v[u][1], v[u][2], v[u][3]);
    }
}

// x (B, CI, D, H, W) bf16 or int8 -> y (B, CO, Do, Ho, Wo) bf16 or fp32.
// wgt: (CO, CI, 3, 3, 3) bf16, raw; scale, shift: (CO,) fp32, the eval BN.
// Grid: (output tiles x R, CO blocks of 8 NT channels, B); blocks
// R c .. R c + R - 1 form one cluster over tile c, rank r summing chunks
// [r nch / R, (r + 1) nch / R). Every warp stages the rank's first chunk;
// then the producers stage chunk k + 1 while the consumers multiply k.
template <int S, int NT, int TH, int TD, int KC, typename Tin, typename Tout>
__global__ void __launch_bounds__(mma_threads(NT))
conv3d_mma_kernel(const Tin* __restrict__ x,
                  const __nv_bfloat16* __restrict__ wgt,
                  const float* __restrict__ scale,
                  const float* __restrict__ shift, Tout* __restrict__ y,
                  int CI, int CO, int D, int H, int W, int Do, int Ho, int Wo,
                  int R, int approximate) {
    using T = MmaTile<S, TH, TD, NT, KC>;
    constexpr int NP = 8 * NT;
    constexpr int MT = T::mtiles / kMmaWarps;
    constexpr int kThreads = mma_threads(NT);
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
    const Tin* xb = x + (size_t)b * CI * D * H * W;

    float acc[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[mt][nt][j] = 0.0f;

    const int n_local = c_end - c_begin;
    if (n_local > 0)
        stage_chunk<S, TH, TD, NT, KC>(xb, wgt, smem, KC * c_begin, CI, CO,
                                       co0, D, H, W, di0, hi0, wi0, tid,
                                       kThreads);
    __syncthreads();
    for (int it = 1; it <= n_local; ++it) {
        if (warp >= kMmaWarps) {
            if (it < n_local)
                stage_chunk<S, TH, TD, NT, KC>(
                    xb, wgt, smem + (it & 1) * T::stage,
                    KC * (c_begin + it), CI, CO, co0, D, H, W, di0, hi0,
                    wi0, tid - 32 * kMmaWarps, kThreads - 32 * kMmaWarps);
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

// x (B, CI, D, H, W) -> y (B, CO, Do, Ho, Wo), fp32. wgt: (CO, CI, 3, 3, 3)
// with the BN scale folded in, shift (CO,). 32 TH NG threads: warp
// (ty, g) = (warp % TH, warp / TH) owns row ty and channels co0 + 8 g ..
// co0 + 8 g + 7. Grid: (output tiles x R, CO blocks of 8 NG, B); cluster
// rank r sums channels [r CI / R, (r + 1) CI / R). kMasked: CO is not a
// multiple of 8 NG, and the stores skip the channels past it.
template <int S, int TH, int KDC, bool kMasked>
__global__ void __launch_bounds__(kFp32MaxThreads)
conv3d_fp32_kernel(const float* __restrict__ x, const float* __restrict__ wgt,
                   const float* __restrict__ shift, float* __restrict__ y,
                   int CI, int CO, int D, int H, int W, int Do, int Ho,
                   int Wo, int NG, int R, int approximate) {
    using T = Fp32Tile<S, TH, KDC>;
    extern __shared__ float4 smem_f4[];
    float* smem = reinterpret_cast<float*>(smem_f4);
    const int NP = 8 * NG;
    const int stage = T::slab + 27 * NP;
    const int nthr = blockDim.x, tid = threadIdx.x;
    const int tx = tid & 31, ty = (tid >> 5) % TH, g = tid / (32 * TH);
    const int rank = blockIdx.x % R, tile = blockIdx.x / R;
    const int tilesW = (Wo + 31) / 32, tilesH = (Ho + TH - 1) / TH;
    const int wo0 = (tile % tilesW) * 32;
    const int ho0 = (tile / tilesW % tilesH) * TH;
    const int do0 = tile / (tilesW * tilesH) * KDC;
    const int co0 = blockIdx.y * NP, b = blockIdx.z;
    const int di0 = S * do0 - 1, hi0 = S * ho0 - 1, wi0 = S * wo0 - 1;
    const size_t plane = (size_t)H * W;
    const size_t vol = (size_t)D * plane;
    const float* xb = x + (size_t)b * CI * vol;
    const int c_begin = rank * CI / R, c_end = (rank + 1) * CI / R;

    // channel ci's slab and weights [tap][NP] into buf, zero outside
    auto stage_channel = [&](int ci, float* buf) {
        const float* xc = xb + (size_t)ci * vol;
        for (int i = tid; i < T::sd * T::sh * T::sw; i += nthr) {
            const int sw = i % T::sw, sh = i / T::sw % T::sh;
            const int sd = i / (T::sw * T::sh);
            const int gd = di0 + sd, gh = hi0 + sh, gw = wi0 + sw;
            const bool ok = inside(gd, gh, gw, D, H, W);
            cp_async4(buf + i,
                      ok ? xc + gd * plane + (size_t)gh * W + gw : x, ok);
        }
        float* wsh = buf + T::slab;
        for (int i = tid; i < 27 * NP; i += nthr) {
            const int k = i % 27, o = i / 27;
            const bool ok = co0 + o < CO;
            cp_async4(wsh + k * NP + o,
                      ok ? wgt + ((size_t)(co0 + o) * CI + ci) * 27 + k : wgt,
                      ok);
        }
        cp_async_commit();
    };

    float acc[KDC][8];
#pragma unroll
    for (int dd = 0; dd < KDC; ++dd)
#pragma unroll
        for (int o = 0; o < 8; ++o) acc[dd][o] = 0.0f;

    if (c_begin < c_end) stage_channel(c_begin, smem);
    for (int ci = c_begin; ci < c_end; ++ci) {
        const int it = ci - c_begin;
        // this channel's copies landed everywhere, and every thread is past
        // the previous channel, whose buffer the next copies overwrite
        cp_async_wait_all();
        __syncthreads();
        if (ci + 1 < c_end)
            stage_channel(ci + 1, smem + ((it + 1) & 1) * stage);
        const float* xsh = smem + (it & 1) * stage;
        const float* wsh = xsh + T::slab + 8 * g;
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

    const bool approx = approximate != 0;
    const size_t oplane = (size_t)Ho * Wo;
    const size_t ovol = (size_t)Do * oplane;
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
            P[(8 * g + o) * T::voxels + (dd * TH + ty) * 32 + tx] =
                acc[dd][o];
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    const int total = min(NP, CO - co0) * T::voxels;
    for (int e = tid + rank * nthr; e < total; e += R * nthr) {
        float s = *cluster.map_shared_rank(P + e, 0);
        for (int q = 1; q < R; ++q) s += *cluster.map_shared_rank(P + e, q);
        const int n = e / T::voxels, m = e % T::voxels;
        const int w = wo0 + m % 32, h = ho0 + m / 32 % TH;
        const int d = do0 + m / (32 * TH);
        if (d < Do && h < Ho && w < Wo)
            y[((size_t)b * CO + co0 + n) * ovol + (size_t)d * oplane
              + (size_t)h * Wo + w] =
                finish<false, float>(s, nullptr, shift, co0 + n, approx);
    }
    cluster.sync();
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
template <bool kMasked>
__global__ void __launch_bounds__(kThreads)
deconv3d_k4s2_kernel(const float* __restrict__ x, const float* __restrict__ wgt,
                     const float* __restrict__ shift, float* __restrict__ y,
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
    const float* xb = x + (size_t)b * CI * vol;

    for (int ci = 0; ci < CI; ++ci) {
        __syncthreads();
        const float* xc = xb + (size_t)ci * vol;
        for (int i = tid; i < kUd * kUh * kUw; i += kThreads) {
            const int sw = i % kUw;
            const int sh = (i / kUw) % kUh;
            const int sd = i / (kUw * kUh);
            const int gd = di0 + sd, gh = hi0 + sh, gw = wi0 + sw;
            xsh[i] = inside(gd, gh, gw, Ds, Hs, Ws)
                ? xc[(size_t)gd * plane + (size_t)gh * Ws + gw] : 0.0f;
        }
        for (int i = tid; i < 64 * kCot; i += kThreads) {
            const int k = i % 64, o = i / 64;
            wsh[k * kCot + o] = !kMasked || co0 + o < CO
                ? wgt[((size_t)ci * CO + co0 + o) * 64 + k] : 0.0f;
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
    store_tile<kMasked>(acc, shift, y, b, CO, co0, do0, ho0 + ty, wo0 + tx,
                        D2, H2, W2, approximate);
}

// 1x1x1 conv over the channel concat [up | skip], each (B, CO, N) with N
// voxels: y = GELU(wgt[:, :CO] up + wgt[:, CO:] skip + shift). wgt: (CO, 2 CO)
// with the BN scale folded in. One thread per voxel and kCot outputs; the
// loads of a warp are 32 neighbouring voxels of one channel.
template <bool kMasked>
__global__ void __launch_bounds__(256)
conv1x1_cat_kernel(const float* __restrict__ up, const float* __restrict__ skip,
                   const float* __restrict__ wgt,
                   const float* __restrict__ shift, float* __restrict__ y,
                   int CO, int N, int approximate) {
    __shared__ float wsh[kMaxCat * kCot];   // [input channel][o]
    const int co0 = blockIdx.y * kCot;
    const int b = blockIdx.z;
    const int cin = 2 * CO;
    for (int i = threadIdx.x; i < cin * kCot; i += blockDim.x) {
        const int c = i % cin, o = i / cin;
        wsh[c * kCot + o] = !kMasked || co0 + o < CO
            ? wgt[(size_t)(co0 + o) * cin + c] : 0.0f;
    }
    __syncthreads();
    const int v = blockIdx.x * blockDim.x + threadIdx.x;
    if (v >= N) return;

    float acc[kCot];
#pragma unroll
    for (int o = 0; o < kCot; ++o) acc[o] = 0.0f;
    const float* halves[2] = {up + (size_t)b * CO * N + v,
                              skip + (size_t)b * CO * N + v};
#pragma unroll
    for (int half = 0; half < 2; ++half) {
        const float* src = halves[half];
        const float* wh = wsh + half * CO * kCot;
        for (int c = 0; c < CO; ++c) {
            const float a = src[(size_t)c * N];
#pragma unroll
            for (int o = 0; o < kCot; ++o)
                acc[o] = fmaf(a, wh[c * kCot + o], acc[o]);
        }
    }
    const bool approx = approximate != 0;
    float* yb = y + ((size_t)b * CO + co0) * N + v;
#pragma unroll
    for (int o = 0; o < kCot; ++o)
        if (!kMasked || co0 + o < CO)
            yb[(size_t)o * N] = gelu(acc[o] + shift[co0 + o], approx);
}

// --- H's deploy form: the transposed conv and the 1x1x1 conv in one launch -

constexpr int kUpThreads = 256;   // 8 warps, one an output parity class

// A block's tile: 16 x TH x TD voxels (w, h, d) of the half-resolution grid
// t (output voxel q = 2 t + parity on each axis), of all 8 parity classes,
// so 32 x 2 TH x 2 TD output voxels; NT n-tiles of output channels. The
// shared memory: the loop's [slab | a chunk's weights], then the
// epilogue's [skip tile | the 1x1x1 conv's weights] in the same bytes.
template <int NT, int TH, int TD>
struct UpTile {
    static constexpr int NP = 8 * NT;
    static constexpr int CK = (NT + 1) / 2;      // chunks of 16 of CO
    static constexpr int MT = TH * TD;           // m-tiles a warp (parity)
    static constexpr int sd = TD + 2, sh = TH + 2, sw = 18;
    static constexpr int slab_bytes = sd * sh * sw * 32;
    static constexpr int w_bytes = 64 * NP * 32;  // [tap][n][16 ci]
    static constexpr int voxels = 8 * MT * 16;
    static constexpr int skip_bytes = CK * voxels * 32;
    static constexpr int wc_bytes = 2 * CK * NP * 32;
    static constexpr int a1 = slab_bytes + w_bytes;
    static constexpr int a2 = skip_bytes + wc_bytes;
    static constexpr int smem = a1 > a2 ? a1 : a2;
};

// 16-bit element e of the 8 in q.
__device__ __forceinline__ uint32_t half_of(const uint4& q, int e) {
    const uint32_t w = e < 2 ? q.x : e < 4 ? q.y : e < 6 ? q.z : q.w;
    return (e & 1) ? w >> 16 : w & 0xffffu;
}

// src (B, CI, Ds, Hs, Ws) bf16 -> z (B, CO, D2, H2, W2) bf16:
//   up = GELU(BN_u(ConvTranspose3d k4 s2 p1 (src)))  cropped, bf16,
//   z  = GELU(BN_c(wc [up | skip])).
// Gather form: output parity class (pd, ph, pw) (warp 4 pd + 2 ph + pw)
// is a 2 x 2 x 2 conv of src, tap (jd, jh, jw) reading src at t + par - j
// with kernel tap k = 2 j + 1 - par on each axis. K = (chunk of 16 input
// channels, tap), each (chunk, tap) product summed from zero and added to
// the running fp32 sum with one rounded add. up stays in registers: the
// accumulators of n-tiles 2 k and 2 k + 1, BN'd, GELU'd and rounded, are
// the A fragment of the 1x1x1 conv's chunk k (the m16n8k16 C and A
// layouts share their rows and pair their columns). That conv's K is up's
// chunks, then skip's (staged from the tile's voxels), each chunk summed
// from zero and added with one rounded add. Grid: (tiles, 1, B).
template <int NT, int TH, int TD>
__global__ void __launch_bounds__(kUpThreads, 2)
up_cat_mma_kernel(const __nv_bfloat16* __restrict__ src,
                  const __nv_bfloat16* __restrict__ skip,
                  const __nv_bfloat16* __restrict__ wu,
                  const float* __restrict__ su, const float* __restrict__ tu,
                  const __nv_bfloat16* __restrict__ wc,
                  const float* __restrict__ sc, const float* __restrict__ tc,
                  __nv_bfloat16* __restrict__ z, int CI, int CO, int Ds,
                  int Hs, int Ws, int D2, int H2, int W2, int approximate) {
    using T = UpTile<NT, TH, TD>;
    constexpr int NP = T::NP, MT = T::MT, CK = T::CK;
    extern __shared__ uint4 smem_u4[];
    char* smem = reinterpret_cast<char*>(smem_u4);
    char* slab = smem;                          // [sd][sh][sw][16 ci]
    char* wsh = smem + T::slab_bytes;           // [64 taps][NP][16 ci]
    char* ssh = smem;                           // [CK][voxel][16 co]
    char* csh = smem + T::skip_bytes;           // [2 CK][NP][16 ci]
    const unsigned slab_u = smem_u32(slab), w_u = smem_u32(wsh);
    const unsigned s_u = smem_u32(ssh), c_u = smem_u32(csh);

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int pd = warp >> 2, ph = (warp >> 1) & 1, pw = warp & 1;
    const int tilesW = (W2 + 31) / 32, tilesH = (H2 + 2 * TH - 1) / (2 * TH);
    const int tw0 = (blockIdx.x % tilesW) * 16;
    const int th0 = (blockIdx.x / tilesW % tilesH) * TH;
    const int td0 = blockIdx.x / (tilesW * tilesH) * TD;
    const int b = blockIdx.z;
    const bool approx = approximate != 0;
    const size_t splane = (size_t)Hs * Ws, svol = (size_t)Ds * splane;
    const size_t plane = (size_t)H2 * W2, vol = (size_t)D2 * plane;
    const __nv_bfloat16* xb = src + (size_t)b * CI * svol;
    const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8;
    const int a_half = lane >> 4;
    const int g = lane >> 2, t = lane & 3;

    // this lane's A row of each m-tile (td, th), tap (0, 0, 0): slab
    // (td + 1 + pd, th + 1 + ph, a_row + 1 + pw); tap j steps back j
    int arow[MT];
#pragma unroll
    for (int m = 0; m < MT; ++m)
        arow[m] = ((m / TH + 1 + pd) * T::sh + m % TH + 1 + ph) * T::sw
                  + a_row + 1 + pw;
    float acc[MT][NT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[m][nt][j] = 0.0f;

    const int nch = (CI + 15) / 16;
    for (int c = 0; c < nch; ++c) {
        const int c0 = 16 * c;
        if (c) __syncthreads();   // the previous chunk consumed
        // the slab of channels c0 .. c0 + 15, channel-innermost: items
        // (column, row, depth, half); 8 loads a volume apart each
        constexpr int kVox = T::sd * T::sh * T::sw;
        for (int i0 = tid; i0 < 2 * kVox; i0 += 4 * kUpThreads) {
            uint32_t v[4][4];
            int dst[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
                const int i = i0 + u * kUpThreads;
#pragma unroll
                for (int q = 0; q < 4; ++q) v[u][q] = 0;
                dst[u] = -1;
                if (i < 2 * kVox) {
                    const int half = i / kVox, vox = i % kVox;
                    const int sw = vox % T::sw, sh = vox / T::sw % T::sh;
                    const int sd = vox / (T::sw * T::sh);
                    const int gd = td0 - 1 + sd, gh = th0 - 1 + sh;
                    const int gw = tw0 - 1 + sw;
                    dst[u] = swz(vox, half);
                    if (inside(gd, gh, gw, Ds, Hs, Ws)) {
                        const int ci = c0 + 8 * half;
                        const __nv_bfloat16* p = xb + (size_t)ci * svol
                            + (size_t)gd * splane + (size_t)gh * Ws + gw;
#pragma unroll
                        for (int j = 0; j < 8; ++j)
                            if (ci + j < CI)
                                v[u][j / 2] |= bits16(p[(size_t)j * svol])
                                               << (16 * (j & 1));
                    }
                }
            }
#pragma unroll
            for (int u = 0; u < 4; ++u)
                if (dst[u] >= 0)
                    *reinterpret_cast<uint4*>(slab + dst[u]) =
                        make_uint4(v[u][0], v[u][1], v[u][2], v[u][3]);
        }
        // the chunk's weights [tap][n][16 ci]: items (tap group of 8, n,
        // half), 8 16-byte loads of 8 taps (one an input channel),
        // transposed in registers to 8 stores of 8 channels (one a tap)
        for (int i = tid; i < 8 * NP * 2; i += kUpThreads) {
            const int grp = i % 8, n = i / 8 % NP, half = i / (8 * NP);
            const int ci = c0 + 8 * half;
            uint4 in[8];
#pragma unroll
            for (int j = 0; j < 8; ++j)
                in[j] = ci + j < CI && n < CO
                    ? *reinterpret_cast<const uint4*>(
                          wu + ((size_t)(ci + j) * CO + n) * 64 + 8 * grp)
                    : make_uint4(0, 0, 0, 0);
#pragma unroll
            for (int e = 0; e < 8; ++e) {
                uint32_t o[4];
#pragma unroll
                for (int w = 0; w < 4; ++w)
                    o[w] = half_of(in[2 * w], e)
                           | (half_of(in[2 * w + 1], e) << 16);
                *reinterpret_cast<uint4*>(
                    wsh + swz((8 * grp + e) * NP + n, half)) =
                    make_uint4(o[0], o[1], o[2], o[3]);
            }
        }
        __syncthreads();
#pragma unroll
        for (int jd = 0; jd < 2; ++jd) {
#pragma unroll
            for (int jh = 0; jh < 2; ++jh) {
#pragma unroll
                for (int jw = 0; jw < 2; ++jw) {
                    const int tap = ((2 * jd + 1 - pd) * 4 + 2 * jh + 1 - ph)
                                    * 4 + 2 * jw + 1 - pw;
                    uint32_t bf[NT][2];
                    load_b_rows<NT>(w_u, tap * NP, lane, bf);
                    const int back = (jd * T::sh + jh) * T::sw + jw;
#pragma unroll
                    for (int m = 0; m < MT; ++m) {
                        uint32_t a[4];
                        ldmatrix_x4(a, slab_u + swz(arow[m] - back, a_half));
                        mma_add_rows<NT>(acc[m], a, bf);
                    }
                }
            }
        }
    }
    __syncthreads();   // the slab and the weights consumed

    // skip's tile [chunk][voxel][16 co], voxel = (parity, td, th, tw) as
    // the m-tiles; items (w, h, d, unit) so that a warp reads along w
    constexpr int kTile = 32 * 2 * TH * 2 * TD;
    for (int i0 = tid; i0 < 2 * CK * kTile; i0 += 4 * kUpThreads) {
        uint32_t v[4][4];
        int dst[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
            const int i = i0 + u * kUpThreads;
#pragma unroll
            for (int q = 0; q < 4; ++q) v[u][q] = 0;
            dst[u] = -1;
            if (i < 2 * CK * kTile) {
                const int ww = i % 32, hh = i / 32 % (2 * TH);
                const int dd = i / (64 * TH) % (2 * TD);
                const int unit = i / kTile;
                const int par = (dd & 1) * 4 + (hh & 1) * 2 + (ww & 1);
                const int row = (par * MT + (dd >> 1) * TH + (hh >> 1)) * 16
                                + (ww >> 1);
                dst[u] = (unit >> 1) * T::voxels * 32 + swz(row, unit & 1);
                const int gd = 2 * td0 + dd, gh = 2 * th0 + hh;
                const int gw = 2 * tw0 + ww;
                if (gd < D2 && gh < H2 && gw < W2) {
                    const int co = 8 * unit;
                    const __nv_bfloat16* p = skip + ((size_t)b * CO + co) * vol
                        + (size_t)gd * plane + (size_t)gh * W2 + gw;
#pragma unroll
                    for (int j = 0; j < 8; ++j)
                        if (co + j < CO)
                            v[u][j / 2] |= bits16(p[(size_t)j * vol])
                                           << (16 * (j & 1));
                }
            }
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
            if (dst[u] >= 0)
                *reinterpret_cast<uint4*>(ssh + dst[u]) =
                    make_uint4(v[u][0], v[u][1], v[u][2], v[u][3]);
    }
    // the 1x1x1 conv's weights [chunk: up's CK, then skip's CK][n][16]
    for (int i = tid; i < 4 * CK * NP; i += kUpThreads) {
        const int n = i % NP, unit = i / NP;
        const int k = unit >> 1, half = unit & 1;
        const int c = (k < CK ? 16 * k : 16 * (k - CK)) + 8 * half;
        const int off = k < CK ? 0 : CO;
        uint32_t v[4] = {0, 0, 0, 0};
        if (n < CO) {
#pragma unroll
            for (int j = 0; j < 8; ++j)
                if (c + j < CO)
                    v[j / 2] |= bits16(wc[(size_t)n * 2 * CO + off + c + j])
                                << (16 * (j & 1));
        }
        *reinterpret_cast<uint4*>(csh + swz(k * NP + n, half)) =
            make_uint4(v[0], v[1], v[2], v[3]);
    }
    __syncthreads();

#pragma unroll
    for (int m = 0; m < MT; ++m) {
        float zs[NT][4];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int j = 0; j < 4; ++j) zs[nt][j] = 0.0f;
        // up's chunks from the accumulators
#pragma unroll
        for (int k = 0; k < CK; ++k) {
            uint32_t a[4] = {0, 0, 0, 0};
#pragma unroll
            for (int s = 0; s < 2; ++s) {
                const int nt = 2 * k + s;
                if (nt >= NT) break;
                const int n = nt * 8 + 2 * t;
                float u[4];
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    const int co = n + (j & 1);
                    u[j] = co < CO
                        ? gelu(__fadd_rn(__fmul_rn(acc[m][nt][j], su[co]),
                                         tu[co]), approx)
                        : 0.0f;
                }
                a[2 * s] = pack_bf16(u[0], u[1]);        // row g
                a[2 * s + 1] = pack_bf16(u[2], u[3]);    // row g + 8
            }
            uint32_t bf[NT][2];
            load_b_rows<NT>(c_u, k * NP, lane, bf);
            mma_add_rows<NT>(zs, a, bf);
        }
        // skip's chunks from shared memory
        const int row = (warp * MT + m) * 16 + a_row;
#pragma unroll
        for (int k = 0; k < CK; ++k) {
            uint32_t a[4];
            ldmatrix_x4(a, s_u + k * T::voxels * 32 + swz(row, a_half));
            uint32_t bf[NT][2];
            load_b_rows<NT>(c_u, (CK + k) * NP, lane, bf);
            mma_add_rows<NT>(zs, a, bf);
        }
        const int d = 2 * (td0 + m / TH) + pd, h = 2 * (th0 + m % TH) + ph;
        if (d >= D2 || h >= H2) continue;
        __nv_bfloat16* zb = z + (size_t)b * CO * vol + (size_t)d * plane
                            + (size_t)h * W2;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int co = nt * 8 + 2 * t + (j & 1);
                const int w = 2 * (tw0 + g + 8 * (j >> 1)) + pw;
                if (co < CO && w < W2)
                    zb[(size_t)co * vol + w] = __float2bfloat16_rn(gelu(
                        __fadd_rn(__fmul_rn(zs[nt][j], sc[co]), tc[co]),
                        approx));
            }
    }
}

}  // namespace

// All tensors contiguous. Each entry point returns a cudaError_t:
// cudaErrorInvalidValue for shapes or plans it does not take.

namespace {

int channel_tiles(int CO) { return (CO + kCot - 1) / kCot; }

// The plan's ints, as conv_plan lays them out (fused_hourglass.py::
// _launch_ints): the shape, the stride, the deploy forms' dtype codes, the
// tile's rows and depths, the channel tiles of 8 a block, the cluster size,
// the dynamic shared memory, the GELU form and the MMA kernel's channels a
// chunk.
struct ConvPlan {
    int B, CI, CO, D, H, W, stride, in_type, out_type;
    int tile_h, tile_d, groups, cluster, smem, approximate, k_chunk;
    int Do, Ho, Wo;
};

ConvPlan read_plan(const int* p) {
    ConvPlan c = {p[0], p[1], p[2], p[3], p[4], p[5], p[6], p[7], p[8],
                  p[9], p[10], p[11], p[12], p[13], p[14], p[15], 0, 0, 0};
    const int S = c.stride > 0 ? c.stride : 1;
    c.Do = (c.D - 1) / S + 1;
    c.Ho = (c.H - 1) / S + 1;
    c.Wo = (c.W - 1) / S + 1;
    return c;
}

template <int S, int TH, int KDC>
int launch_fp32(const float* x, const float* wgt, const float* shift,
                float* y, const ConvPlan& c, cudaStream_t stream) {
    using T = Fp32Tile<S, TH, KDC>;
    const int NP = 8 * c.groups;
    const int loop = 2 * (T::slab + 27 * NP) * 4;
    const int partial = c.cluster > 1 ? NP * T::voxels * 4 : 0;
    const int threads = 32 * TH * c.groups;
    if (threads > kFp32MaxThreads || c.cluster > c.CI
            || c.smem != (loop > partial ? loop : partial))
        return (int)cudaErrorInvalidValue;
    const int tiles = ((c.Wo + 31) / 32) * ((c.Ho + TH - 1) / TH)
                      * ((c.Do + KDC - 1) / KDC);
    const dim3 grid(tiles * c.cluster, (c.CO + NP - 1) / NP, c.B);
    auto kernel = c.CO % NP ? conv3d_fp32_kernel<S, TH, KDC, true>
                            : conv3d_fp32_kernel<S, TH, KDC, false>;
    return launch(kernel, grid, dim3(threads), c.smem, c.cluster, stream, x,
                  wgt, shift, y, c.CI, c.CO, c.D, c.H, c.W, c.Do, c.Ho, c.Wo,
                  c.groups, c.cluster, c.approximate);
}

template <int S>
int dispatch_fp32(const float* x, const float* wgt, const float* shift,
                  float* y, const ConvPlan& c, cudaStream_t stream) {
    if (c.tile_h == 4 && c.tile_d == 8)
        return launch_fp32<S, 4, 8>(x, wgt, shift, y, c, stream);
    if (c.tile_h == 2 && c.tile_d == 4)
        return launch_fp32<S, 2, 4>(x, wgt, shift, y, c, stream);
    if (c.tile_h == 1 && c.tile_d == 4)
        return launch_fp32<S, 1, 4>(x, wgt, shift, y, c, stream);
    return (int)cudaErrorInvalidValue;
}

struct MmaCall {
    const void* x;
    const void* wgt;
    const float* scale;
    const float* shift;
    void* y;
    ConvPlan c;
    cudaStream_t stream;
};

template <int S, int NT, int TH, int TD, int KC, typename Tin, typename Tout>
int launch_mma(const MmaCall& m) {
    using T = MmaTile<S, TH, TD, NT, KC>;
    constexpr int NP = 8 * NT;
    const ConvPlan& c = m.c;
    const int nch = (c.CI + KC - 1) / KC;
    const int nbuf = (nch + c.cluster - 1) / c.cluster > 1 ? 2 : 1;
    const int partial = NP * (T::voxels + 4) * 4;
    const int want = nbuf * T::stage > partial ? nbuf * T::stage : partial;
    if (c.cluster > nch || c.smem != want) return (int)cudaErrorInvalidValue;
    const int tiles = ((c.Wo + 15) / 16) * ((c.Ho + TH - 1) / TH)
                      * ((c.Do + TD - 1) / TD);
    const dim3 grid(tiles * c.cluster, (c.CO + NP - 1) / NP, c.B);
    return launch(conv3d_mma_kernel<S, NT, TH, TD, KC, Tin, Tout>, grid,
                  dim3(mma_threads(NT)), want, c.cluster, m.stream,
                  static_cast<const Tin*>(m.x),
                  static_cast<const __nv_bfloat16*>(m.wgt), m.scale, m.shift,
                  static_cast<Tout*>(m.y), c.CI, c.CO, c.D, c.H, c.W, c.Do,
                  c.Ho, c.Wo, c.cluster, c.approximate);
}

// The tiles an instance (S, NT, KC) has: (4, 4) at stride 1, up to 3
// n-tiles (4 m-tiles a warp) and in chunks of 8 channels; (4, 2) and
// (2, 2) at any NT. Chunks of 8 channels (CI <= 8) go up to 3 n-tiles.
template <int S, int NT, int KC, typename Tin, typename Tout>
int dispatch_tile(const MmaCall& m) {
    static_assert(KC == 16 || NT <= 3, "chunks of 8 take up to 3 n-tiles");
    const int th = m.c.tile_h, td = m.c.tile_d;
    if (th == 4 && td == 4) {
        if constexpr (S == 1 && NT <= 3 && KC == 8)
            return launch_mma<S, NT, 4, 4, KC, Tin, Tout>(m);
        return (int)cudaErrorInvalidValue;
    }
    if (th == 4 && td == 2) return launch_mma<S, NT, 4, 2, KC, Tin, Tout>(m);
    if (th == 2 && td == 2) return launch_mma<S, NT, 2, 2, KC, Tin, Tout>(m);
    return (int)cudaErrorInvalidValue;
}

// The MMA kernel's instances, X(stride, n-tiles, channels a chunk, input
// type, output type), each with the tiles dispatch_tile gives it: the
// (stride, CO, CI) of every conv3d k3 p1 of ESMStereo-L, -M and -S in the
// forms their callers launch, and int8 -> fp32 on kernel C's first convs.
// Types: input 0 bf16, 1 int8; output 0 bf16, 1 fp32. The same list as
// fused_hourglass.py::MMA_INSTANCES (tests/test_torch_conv_plan.py holds
// the two and the plan of every conv shape to it).
#define MMA_INSTANCES(X) \
    X(1, 1, 8, 0, 0)     \
    X(1, 1, 16, 0, 0)    \
    X(1, 2, 16, 0, 0)    \
    X(1, 3, 16, 0, 0)    \
    X(1, 5, 16, 0, 0)    \
    X(1, 9, 16, 0, 0)    \
    X(2, 2, 8, 0, 0)     \
    X(2, 3, 8, 0, 0)     \
    X(2, 2, 16, 0, 0)    \
    X(2, 3, 16, 0, 0)    \
    X(2, 5, 16, 0, 0)    \
    X(2, 9, 16, 0, 0)    \
    X(1, 1, 8, 0, 1)     \
    X(1, 1, 8, 1, 0)     \
    X(1, 1, 16, 1, 0)    \
    X(1, 1, 8, 1, 1)     \
    X(1, 1, 16, 1, 1)

template <int C>
using InType = std::conditional_t<C == 0, __nv_bfloat16, int8_t>;
template <int C>
using OutType = std::conditional_t<C == 0, __nv_bfloat16, float>;

int dispatch_mma(const MmaCall& m) {
    const ConvPlan& c = m.c;
#define MMA_DISPATCH(S, NT, KC, IN, OUT)                                   \
    if (c.stride == S && c.groups == NT && c.k_chunk == KC                 \
            && c.in_type == IN && c.out_type == OUT)                       \
        return dispatch_tile<S, NT, KC, InType<IN>, OutType<OUT>>(m);
    MMA_INSTANCES(MMA_DISPATCH)
#undef MMA_DISPATCH
    return (int)cudaErrorInvalidValue;
}

bool plan_ok(const ConvPlan& c) {
    return c.B >= 1 && c.CI >= 1 && c.CO >= 1 && c.D >= 1 && c.H >= 1
           && c.W >= 1 && c.groups >= 1 && c.cluster >= 1
           && c.cluster <= kMaxCluster;
}

}  // namespace

// The conv3d k3 p1 of kernels C, E's agg, G and H. plan: 16 ints, B, CI,
// CO, D, H, W, stride (1 or 2), in_type, out_type, tile_h, tile_d, groups,
// cluster, smem, approximate, k_chunk (fused_hourglass.py::conv_plan: a
// tile of 32 or 16 x tile_h x tile_d output voxels, groups x 8 output
// channels a block, cluster blocks splitting CI, smem bytes of dynamic
// shared memory; the MMA kernel's chunks of k_chunk input channels).
//
// The fp32 form (in_type and out_type 2). x: (B, CI, D, H, W); wgt: (CO,
// CI, 3, 3, 3) with the BN scale folded in; shift: (CO,); y: (B, CO,
// (D-1)/stride+1, (H-1)/stride+1, (W-1)/stride+1).
extern "C" int conv3d_k3_bn_gelu(const float* x, const float* wgt,
                                 const float* shift, float* y,
                                 const int* plan, cudaStream_t stream) {
    const ConvPlan c = read_plan(plan);
    if (!plan_ok(c) || c.in_type != 2 || c.out_type != 2)
        return (int)cudaErrorInvalidValue;
    if (c.stride == 1) return dispatch_fp32<1>(x, wgt, shift, y, c, stream);
    if (c.stride == 2) return dispatch_fp32<2>(x, wgt, shift, y, c, stream);
    return (int)cudaErrorInvalidValue;
}

// The deploy forms. x: (B, CI, D, H, W) bf16 (in_type 0) or int8
// (in_type 1); wgt: (CO, CI, 3, 3, 3) bf16, raw; scale, shift: (CO,) fp32,
// the eval BN; y: (B, CO, Do, Ho, Wo) bf16 (out_type 0) or fp32 (out_type
// 1); groups: n-tiles. The instances of MMA_INSTANCES: bf16 -> bf16 at
// stride 1 and 2 (kernels C, E's agg, G and H), bf16 -> fp32 and int8 ->
// either at stride 1 with 1 n-tile (kernel C's other forms); any other
// plan is refused.
extern "C" int conv3d_k3_bn_gelu_bf16(const void* x, const void* wgt,
                                      const float* scale, const float* shift,
                                      void* y, const int* plan,
                                      cudaStream_t stream) {
    const MmaCall m = {x, wgt, scale, shift, y, read_plan(plan), stream};
    if (!plan_ok(m.c)) return (int)cudaErrorInvalidValue;
    return dispatch_mma(m);
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
    kernel<<<grid, block, 0, stream>>>(x, wgt, shift, y, CI, CO, Ds, Hs, Ws,
                                       D2, H2, W2, approximate);
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
    kernel<<<grid, 256, 0, stream>>>(up, skip, wgt, shift, y, CO, N,
                                     approximate);
    return (int)cudaGetLastError();
}

namespace {

// The instances of H's fused deploy kernel, X(n-tiles, tile_h, tile_d):
// CO 12 and 16 (2 n-tiles), 24 (3) and 40 (5), at every tile whose sums
// fit a warp (m-tiles x n-tiles <= 12). The same list as
// fused_hourglass.py::UP_INSTANCES (tests/test_torch_stem_up_plans.py
// holds the two to each other and to the plans of L's, M's and S's up
// levels).
#define UP_INSTANCES(X) \
    X(2, 2, 2)          \
    X(2, 2, 1)          \
    X(2, 1, 1)          \
    X(3, 2, 2)          \
    X(3, 2, 1)          \
    X(3, 1, 1)          \
    X(5, 2, 1)          \
    X(5, 1, 1)

struct UpCall {
    const void *src, *skip, *wu, *wc;
    const float *su, *tu, *sc, *tc;
    void* z;
    int B, CI, CO, Ds, Hs, Ws, D2, H2, W2, n_tiles, tile_h, tile_d, smem,
        approximate;
    cudaStream_t stream;
};

template <int NT, int TH, int TD>
int launch_up(const UpCall& u) {
    using T = UpTile<NT, TH, TD>;
    if (u.smem != T::smem || u.CO > 8 * NT || u.CO <= 8 * (NT - 1))
        return (int)cudaErrorInvalidValue;
    const int tiles = ((u.W2 + 31) / 32) * ((u.H2 + 2 * TH - 1) / (2 * TH))
                      * ((u.D2 + 2 * TD - 1) / (2 * TD));
    using bf16 = __nv_bfloat16;
    return launch(up_cat_mma_kernel<NT, TH, TD>, dim3(tiles, 1, u.B),
                  dim3(kUpThreads), u.smem, 1, u.stream,
                  static_cast<const bf16*>(u.src),
                  static_cast<const bf16*>(u.skip),
                  static_cast<const bf16*>(u.wu), u.su, u.tu,
                  static_cast<const bf16*>(u.wc), u.sc, u.tc,
                  static_cast<bf16*>(u.z), u.CI, u.CO, u.Ds, u.Hs, u.Ws,
                  u.D2, u.H2, u.W2, u.approximate);
}

}  // namespace

// H's deploy form of the transposed conv and the 1x1x1 conv, one launch:
// src (B, CI, Ds, Hs, Ws), skip and z (B, CO, D2, H2, W2), bf16, with
// D2 <= 2 Ds, H2 <= 2 Hs, W2 <= 2 Ws; wu (CI, CO, 4, 4, 4) and wc (CO,
// 2 CO) bf16, raw; su, tu, sc, tc (CO,) fp32, the two eval BNs. plan: 14
// ints, B, CI, CO, Ds, Hs, Ws, D2, H2, W2, n_tiles, tile_h, tile_d, smem,
// approximate (fused_hourglass.py::up_plan); any plan not in UP_INSTANCES,
// or a shared-memory count other than the kernel's own, is refused.
extern "C" int hourglass_up_cat_bf16(const void* src, const void* skip,
                                     const void* wu, const float* su,
                                     const float* tu, const void* wc,
                                     const float* sc, const float* tc,
                                     void* z, const int* plan,
                                     cudaStream_t stream) {
    const UpCall u = {src, skip, wu, wc, su, tu, sc, tc, z, plan[0],
                      plan[1], plan[2], plan[3], plan[4], plan[5], plan[6],
                      plan[7], plan[8], plan[9], plan[10], plan[11],
                      plan[12], plan[13], stream};
    if (u.B < 1 || u.CI < 1 || u.CO < 1 || u.D2 < 1 || u.H2 < 1 || u.W2 < 1
            || u.D2 > 2 * u.Ds || u.H2 > 2 * u.Hs || u.W2 > 2 * u.Ws)
        return (int)cudaErrorInvalidValue;
#define UP_DISPATCH(NT, TH, TD)                                             \
    if (u.n_tiles == NT && u.tile_h == TH && u.tile_d == TD)                \
        return launch_up<NT, TH, TD>(u);
    UP_INSTANCES(UP_DISPATCH)
#undef UP_DISPATCH
    return (int)cudaErrorInvalidValue;
}
