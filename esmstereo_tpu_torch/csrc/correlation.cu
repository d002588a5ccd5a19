// Kernels B and D: the correlation cost volume in its three forms, group-wise
// (gwc, G = 32), group-wise on L2-normalised groups (gwc_norm, G = 32) and
// channel-normalised (norm-correlation, G = 1): in fp32, and each in bf16
// with B's rounding or with D's (the deploy numerics).
//
// Replaces esmstereo_tpu/ops/pallas/correlation.py::correlation_volume_folded
// (kernel B, pallas_call at :218) and ::correlation_volume (kernel D, :298).
// Computes
//     out[b, g, d, h, w] = mean_{c in group g} ref[b, c, h, w] * tgt[b, c, h, w - d]
// and 0 where w < d, from NCHW features (B, C, H, W) into the (B, G, D, H, W)
// layout the 3-D convs read. That is D's unfolded (B, D, H, W, G) volume with
// the G axis moved ahead, and B's depth-folded one unfolded (the TPU kernels'
// lane layouts are not ported). With normalize, each pixel's channel groups
// are first scaled to x / (||x_g|| + 1e-5), as both JAX kernels do outside
// their pallas_call (correlation.py:159-164,268-273); here inside the volume
// kernel, in one launch.
//
// What bounds it on an H100: bytes. On the L gwc path (C=64, G=32, D=48,
// 136 x 248 at /4) it reads 17 MB and writes 207 MB against 0.2 GFLOP of
// products; on the M paths (D=24, 68 x 124) the gwc volume is 26 MB and the
// norm-correlation one 0.8 MB (bound_ms in chip_smoke.py).
//
// Design for that (the launch plan comes from ops/kernels/correlation.py::
// corr_plan, picked by device time with eval/conv_repeat.py --bf-plans; the
// entry point checks it):
//   * A block owns one (b, h), TX columns (64 or 32, a thread a column) and
//     all D shifts, which its ROWS thread rows split.
//   * The block stages the target window of all C channels, the TX + D - 1
//     columns its shifts reach (zero outside the image, which also makes
//     w < d vanish), in fp32 in shared memory, 8 loads of a thread in
//     flight. A thread holds its reference pixel's C channels in registers
//     and walks its shifts, all G groups a shift; every store of a warp is
//     32 neighbouring values of one (g, d, h) row, so the volume is written
//     once, coalesced, and never read back. Where a row of the volume is
//     not a whole number of 32-byte sectors (bf16 at W = 248, fp32 at 124),
//     row h's tiles are shifted to start on its sector boundaries (its head
//     in a tile of its own), so that a warp's stores fill whole sectors
//     wherever a (g, d) plane is a whole number of them (L, M, C).
//   * The normalised forms normalise in the kernel, one launch with no
//     scratch maps: the block stages its reference columns beside the
//     window and normalises both in shared memory with the arithmetic of
//     l2_normalize_groups_kernel (fmaf of the squares in channel order,
//     sqrtf, + 1e-5, a true division), in two phases: a thread a (group,
//     column) sums the squares, then every thread divides. Each column is
//     normalised once and the divisions run in parallel; the bits are those
//     of the two launches this replaced.
//   * Not taken, measured slower on the H100: 2 or 4 columns a thread
//     stored as one vector, with the loop over groups outside the shifts
//     and a thread's reference values reloaded a group; and D split over
//     blocks, which no served shape gained from (PERF.md, section 6).
// Every entry sums its group's products in channel order from zero; the
// group mean multiplies the fp32 sum by 1/(C/G) (exact for the power-of-two
// group sizes the model uses).
//
// The bf16 forms (the deploy numerics) write a bf16 volume from bf16
// descriptors, widened to fp32 as they are read (both JAX kernels upcast
// the descriptors and normalise in fp32, correlation.py:150-164,262-273).
// They round where the two Pallas kernels round:
//   * B's (kRound, esmstereo_tpu/ops/pallas/correlation.py:114-122): each
//     fp32 product is rounded to bf16 (round to nearest even), the group's
//     rounded products are summed in fp32 and scaled by 1/(C/G), and the
//     result is rounded to bf16. A product of two bf16 values is exact in
//     fp32, and scaling by a power of two is exact, so on the gwc form this
//     equals the Pallas kernel's bf16 dot against the 1/(C/G) group matrix
//     with fp32 accumulation bit for bit; on the normalised forms the fp32
//     sum of 64 rounded products runs in another order than the matrix
//     unit's, which can move the final rounding by one ulp. A tensor-core
//     product does not round its products, so this form stays on the CUDA
//     cores.
//   * D's (!kRound, correlation.py:45-65): the fp32 products are summed
//     unrounded, as its fp32 HIGHEST dot does, and only the store rounds.
// On the L deploy path B reads 8.6 MB and writes 103.6 MB: bytes bound it.
//
// l2_normalize_groups stays as an entry point of its own: kernel E's
// normalised form (csrc/fused_volume_agg.cu) reads the normalised maps.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kEps = 1e-5f;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
    return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
    return __float2bfloat16_rn(v);
}

// A block's shared memory, fp32: its target window, C rows of TX + D - 1
// columns; in the normalised forms also its TX reference columns beside it
// and the G norms of each column (the same count as correlation.py::
// corr_smem).
__host__ __device__ constexpr int corr_smem(int C, int G, bool norm, int TX,
                                            int D) {
    return norm ? 4 * (C + G) * (TX + D - 1 + TX) : 4 * C * (TX + D - 1);
}

constexpr int kSmemOptIn = 48 * 1024;   // more needs the instance to opt in
constexpr int kSmemMax = 232448;        // a block's most on an H100 (227 KB)

// n values into shared memory at sh[i] (C rows of m columns), 8 loads of a
// thread in flight before their stores: row c, column j is src[c * hw + x0
// + j], 0 outside [0, W).
template <typename Tin>
__device__ __forceinline__ void stage_rows(float* sh, const Tin* src,
                                           int rows, int m, size_t hw,
                                           int x0, int W, int tid, int nthr) {
    constexpr int kBatch = 8;
    const int n = rows * m;
    for (int i0 = tid; i0 < n; i0 += nthr * kBatch) {
        float v[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
            const int i = i0 + u * nthr;
            const int c = i / m, x = x0 + i - c * m;
            v[u] = i < n && x >= 0 && x < W ? to_float(src[(size_t)c * hw + x])
                                            : 0.0f;
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
            const int i = i0 + u * nthr;
            if (i < n) sh[i] = v[u];
        }
    }
}

// The m columns of sh ([C][m]) scaled to x / (||x_g|| + 1e-5) per group of
// C / G channels, with the arithmetic of l2_normalize_groups_kernel: a
// thread a (group, column) sums the squares in channel order into den
// ([G][m]); after a barrier every thread divides. Ends with a barrier.
template <int C, int G>
__device__ __forceinline__ void normalize_columns(float* sh, float* den,
                                                  int m, int tid, int nthr) {
    constexpr int kCpg = C / G;
    for (int i = tid; i < G * m; i += nthr) {
        const float* x = sh + (i / m) * kCpg * m + i % m;
        float s = 0.0f;
#pragma unroll 8
        for (int k = 0; k < kCpg; ++k) s = fmaf(x[k * m], x[k * m], s);
        den[i] = sqrtf(s) + kEps;
    }
    __syncthreads();
    for (int i = tid; i < C * m; i += nthr)
        sh[i] = sh[i] / den[i / (kCpg * m) * m + i % m];
    __syncthreads();
}

// Output values of a 32-byte sector: 8 fp32, 16 bf16.
template <typename Tout>
constexpr int kSector = 32 / (int)sizeof(Tout);

// Columns by which row h's column tiles start early, so that every tile but
// the row's first starts a sector of the volume: where W is a multiple of a
// sector, none; else the row's first sector boundary, less TX (its first
// tile, the row's head, then starts before column 0).
template <typename Tout, int TX>
__device__ __forceinline__ int row_skew(int h, int W) {
    constexpr int S = kSector<Tout>;
    if (W % S == 0) return 0;
    return TX - (S - (int)((long long)h * W % S)) % S;
}

// Tin: the descriptors' type (fp32, or bf16 widened as read); Tout: the
// volume's; kRound: each product rounded to bf16 before the sum (B's bf16
// forms), else fp32 FMA (the fp32 forms, and D's bf16 forms); kNorm: the
// groups L2-normalised first. Block: (TX columns, ROWS); grid: (column
// tiles of TX, one more where W is not a multiple of a sector, H, B).
template <int C, int G, typename Tin, typename Tout, bool kRound, bool kNorm,
          int TX, int ROWS>
__global__ void __launch_bounds__(TX * ROWS)
corr_volume_kernel(const Tin* __restrict__ ref, const Tin* __restrict__ tgt,
                   Tout* __restrict__ out, int H, int W, int D) {
    constexpr int kCpg = C / G;
    constexpr int kThreads = TX * ROWS;
    extern __shared__ float tsh[];             // [C][span] window
    const int span = TX + D - 1;               // window columns
    const int w0 = blockIdx.x * TX - row_skew<Tout, TX>(blockIdx.y, W);
    const int h = blockIdx.y;
    const int b = blockIdx.z;
    const size_t hw = (size_t)H * W;
    const size_t base = (size_t)b * C * hw + (size_t)h * W;
    const int tid = threadIdx.y * TX + threadIdx.x;
    const int w = w0 + threadIdx.x;

    // window column j: image column w0 - (D - 1) + j
    stage_rows(tsh, tgt + base, C, span, hw, w0 - (D - 1), W, tid, kThreads);
    // the thread's reference pixel, all C channels in registers: in the
    // normalised forms staged beside the window and normalised with it,
    // once a column
    float r[C];
    if constexpr (kNorm) {
        float* rsh = tsh + C * span;           // [C][TX]
        float* den = rsh + C * TX;             // [G][span], then [G][TX]
        stage_rows(rsh, ref + base, C, TX, hw, w0, W, tid, kThreads);
        __syncthreads();
        normalize_columns<C, G>(tsh, den, span, tid, kThreads);
        normalize_columns<C, G>(rsh, den + G * span, TX, tid, kThreads);
#pragma unroll
        for (int c = 0; c < C; ++c) r[c] = rsh[c * TX + threadIdx.x];
    } else {
        const Tin* rw = ref + base + w;
        const bool in = w >= 0 && w < W;
#pragma unroll
        for (int c = 0; c < C; ++c)
            r[c] = in ? to_float(rw[(size_t)c * hw]) : 0.0f;
        __syncthreads();
    }
    if (w < 0 || w >= W) return;

    Tout* ob = out + (size_t)b * G * D * hw + (size_t)h * W + w;
    const float inv = 1.0f / kCpg;
    for (int d = threadIdx.y; d < D; d += ROWS) {
        const int j = threadIdx.x + (D - 1) - d;  // column w - d
        Tout* od = ob + (size_t)d * hw;
#pragma unroll
        for (int g = 0; g < G; ++g) {
            float s = 0.0f;
#pragma unroll
            for (int k = 0; k < kCpg; ++k) {
                const int c = g * kCpg + k;
                if (kRound)
                    s = __fadd_rn(s, __bfloat162float(__float2bfloat16_rn(
                                         __fmul_rn(r[c], tsh[c * span + j]))));
                else
                    s = fmaf(r[c], tsh[c * span + j], s);
            }
            od[(size_t)g * D * hw] = from_float<Tout>(__fmul_rn(s, inv));
        }
    }
}

// x0, x1 -> y0, y1 (blockIdx.y picks the map), each (B, G, cpg, HW); the
// input fp32 or bf16 (widened), the output fp32.
template <typename Tin>
__global__ void __launch_bounds__(256)
l2_normalize_groups_kernel(const Tin* __restrict__ x0,
                           const Tin* __restrict__ x1,
                           float* __restrict__ y0, float* __restrict__ y1,
                           int cpg, int HW, int n) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;  // (b, g, pixel)
    if (i >= n) return;
    const Tin* x = blockIdx.y ? x1 : x0;
    float* y = blockIdx.y ? y1 : y0;
    const size_t base = (size_t)(i / HW) * cpg * HW + i % HW;
    float s = 0.0f;
    for (int k = 0; k < cpg; ++k) {
        const float v = to_float(x[base + (size_t)k * HW]);
        s = fmaf(v, v, s);
    }
    const float den = sqrtf(s) + kEps;
    for (int k = 0; k < cpg; ++k)
        y[base + (size_t)k * HW] = to_float(x[base + (size_t)k * HW]) / den;
}

// The block shapes, X(TX, ROWS): columns (one a thread) and thread rows a
// block. The same list as correlation.py::BLOCKS
// (tests/test_torch_corr_plan.py holds the two to each other and to the
// plans).
#define CORR_BLOCKS(X) \
    X(64, 4)           \
    X(32, 8)           \
    X(32, 4)

template <int C, int G, typename Tin, typename Tout, bool kRound, bool kNorm>
int launch_volume(const void* ref, const void* tgt, void* out, int B, int H,
                  int W, int D, const int* plan, cudaStream_t stream) {
    const int TX = plan[0], rows = plan[1], smem = plan[2];
    if (smem != corr_smem(C, G, kNorm, TX, D) || smem > kSmemMax)
        return (int)cudaErrorInvalidValue;
    const dim3 grid((W + TX - 1) / TX + (W % kSector<Tout> ? 1 : 0), H, B);
#define CORR_LAUNCH(tx, ry)                                                  \
    if (TX == tx && rows == ry) {                                            \
        auto fn = corr_volume_kernel<C, G, Tin, Tout, kRound, kNorm, tx, ry>; \
        if (smem > kSmemOptIn) {                                             \
            const cudaError_t err = cudaFuncSetAttribute(                    \
                fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);      \
            if (err != cudaSuccess) return (int)err;                         \
        }                                                                    \
        fn<<<grid, dim3(tx, ry), smem, stream>>>(                            \
            static_cast<const Tin*>(ref), static_cast<const Tin*>(tgt),      \
            static_cast<Tout*>(out), H, W, D);                               \
        return (int)cudaGetLastError();                                      \
    }
    CORR_BLOCKS(CORR_LAUNCH)
#undef CORR_LAUNCH
    return (int)cudaErrorInvalidValue;
}

// The instances of one (C, G, normalize): `form` as correlation_volume
// takes it.
template <int C, int G, bool kNorm>
int launch_form(int form, const void* ref, const void* tgt, void* out, int B,
                int H, int W, int D, const int* plan, cudaStream_t stream) {
    using bf16 = __nv_bfloat16;
#define CORR_ARGS ref, tgt, out, B, H, W, D, plan, stream
    if (form == 0)
        return launch_volume<C, G, float, float, false, kNorm>(CORR_ARGS);
    if constexpr (kNorm) {
        if (form == 2)
            return launch_volume<C, G, bf16, bf16, true, true>(CORR_ARGS);
        if (form == 4)
            return launch_volume<C, G, bf16, bf16, false, true>(CORR_ARGS);
    } else {
        if (form == 1)
            return launch_volume<C, G, bf16, bf16, true, false>(CORR_ARGS);
        if (form == 3)
            return launch_volume<C, G, bf16, bf16, false, false>(CORR_ARGS);
    }
#undef CORR_ARGS
    return (int)cudaErrorInvalidValue;
}

}  // namespace

// x0, x1: (B, C, H, W) fp32 or, with in_bf16 set, bf16; y0, y1: (B, C, H,
// W) fp32; y = x / (||x_g|| + 1e-5) per pixel and group of C / G channels.
// All contiguous. Returns a cudaError_t.
extern "C" int l2_normalize_groups(const void* x0, const void* x1, float* y0,
                                   float* y1, int B, int C, int G, int H,
                                   int W, int in_bf16, cudaStream_t stream) {
    if (G < 1 || C % G) return (int)cudaErrorInvalidValue;
    const int n = B * G * H * W;
    const dim3 grid((n + 255) / 256, 2);
    if (in_bf16)
        l2_normalize_groups_kernel<__nv_bfloat16><<<grid, 256, 0, stream>>>(
            static_cast<const __nv_bfloat16*>(x0),
            static_cast<const __nv_bfloat16*>(x1), y0, y1, C / G, H * W, n);
    else
        l2_normalize_groups_kernel<float><<<grid, 256, 0, stream>>>(
            static_cast<const float*>(x0), static_cast<const float*>(x1), y0,
            y1, C / G, H * W, n);
    return (int)cudaGetLastError();
}

// ref, tgt: (B, C, H, W) contiguous; out: (B, G, D, H, W) contiguous. form:
//   0  fp32 descriptors, fp32 out;
//   1  B's bf16 gwc form: bf16 descriptors, products rounded, bf16 out;
//   2  B's bf16 normalised forms: bf16 descriptors normalised in fp32,
//      products rounded, bf16 out;
//   3  D's bf16 gwc form: bf16 descriptors, one rounding at the store;
//   4  D's bf16 normalised forms: as 2, one rounding at the store.
// normalize: the groups L2-normalised first (forms 0, 2, 4; G = 1 only
// so). plan: 3 ints, (columns a block, thread rows a block, shared memory
// bytes) from correlation.py::corr_plan. Returns a
// cudaError_t; 1 (cudaErrorInvalidValue) for an unsupported (C, G,
// normalize, form), or a plan outside CORR_BLOCKS or inconsistent with the
// shapes.
extern "C" int correlation_volume(const void* ref, const void* tgt, void* out,
                                  int B, int C, int G, int H, int W, int D,
                                  int form, int normalize, const int* plan,
                                  cudaStream_t stream) {
    if (B < 1 || H < 1 || W < 1 || D < 1) return (int)cudaErrorInvalidValue;
    if (C == 64 && G == 32 && !normalize)
        return launch_form<64, 32, false>(form, ref, tgt, out, B, H, W, D,
                                          plan, stream);
    if (C == 64 && G == 32 && normalize)
        return launch_form<64, 32, true>(form, ref, tgt, out, B, H, W, D,
                                         plan, stream);
    if (C == 64 && G == 1 && normalize)
        return launch_form<64, 1, true>(form, ref, tgt, out, B, H, W, D, plan,
                                        stream);
    return (int)cudaErrorInvalidValue;
}
