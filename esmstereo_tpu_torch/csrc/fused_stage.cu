// Kernel J: one backbone stage >= 1 (a chain of inverted-residual or
// depthwise-separable blocks), eval mode, fp32.
//
// Replaces esmstereo_tpu/attic/fused_stage.py::fused_stage_apply (pallas_call
// at :517). Per block, from an NCHW input x (B, Cin, Hin, Win), with every
// eval BatchNorm folded into the weights and biases by the wrapper:
//   e   = act(We x + be)                  1x1 expand, Cmid = 6 Cin ('ir');
//                                         e = x for a 'ds' block
//   d   = act(dw_kxk,stride s (e) + bd)   k in {3, 5}, padding k/2, s = 2
//                                         only at the entry block
//   g   = sigmoid(W2 act(W1 mean_hw(d) + b1) + b2)        with SqueezeExcite
//   y   = Wp (g * d) + bp [+ x]           1x1 project; the residual where
//                                         s = 1 and Cin = Cout
// act is SiLU (efficientnet_b2) or ReLU6 (mobilenetv2_100).
//
// What bounds it on an H100: operations. At 544 x 992 (both eyes) a stage
// of efficientnet_b2 does 1.6-2.9 G multiply-adds (3.2-5.9 GFLOP; the expand
// and the project dominate) and reads its input and weights and writes its
// output once (6-24 MB): 0.048-0.088 ms at the 67 TFLOP/s fp32 rate of the
// CUDA cores against at most 0.007 ms at 3.35 TB/s (mobilenetv2_100's
// stages: 0.024-0.037 ms).
//
// Design for that. SqueezeExcite needs a mean over the whole image before
// the project can run, and blocks of a grid cannot wait for each other, so
// a block runs as up to three launches:
//   stage_mid      expand + act + depthwise + bias + act on an 8 x 32 tile
//                  of the output grid for 8 mid channels: the input tile
//                  and its halo are staged 8 channels at a time, the expand
//                  sums kept in registers, the expanded tile (zero outside
//                  the image: the dw's padding) written to shared memory,
//                  then the dw taps read straight from it at the block's
//                  stride (no decimation step). It writes the mid tensor d
//                  once, at the output grid, and with SE the tile's
//                  per-channel sums of d (a fixed-order block reduction).
//   stage_gate     with SE, one block per image: the channel means from the
//                  tile sums in tile order (deterministic, no atomics), then
//                  FC -> act -> FC -> sigmoid.
//   stage_project  a 32 x 128 (Cout x pixels) register-tiled product over
//                  Cmid in steps of 16, the gate multiplied into the staged
//                  weights, bias and residual in the epilogue.
// The expanded tensor e never reaches device memory; d makes one round
// trip. Nothing is computed twice except the expand on the halo of each
// tile (1.2x-1.7x of the expand's work at 8 x 32 tiles). Without SE a
// block is two launches (no gate).
#include <cuda_runtime.h>

#include "activations.cuh"

namespace {

enum Act { kSilu = 0, kRelu6 = 1 };

template <int A>
__device__ __forceinline__ float act(float x) {
    return A == kSilu ? silu(x) : relu6(x);
}

constexpr int kThreads = 256;
constexpr int kTh = 8, kTw = 32;   // stage_mid's output tile (one pixel a thread)
constexpr int kMc = 8;             // mid channels a stage_mid block computes
constexpr int kCk = 8;             // input channels staged per expand step
static_assert(kTh * kTw == kThreads, "one output pixel per thread");
static_assert(kCk == kMc, "the staged input and the expanded tile share a buffer");

// input rows (or columns) under a tile of t outputs at stride s, kernel k
__host__ __device__ constexpr int halo(int t, int s, int k) { return (t - 1) * s + k; }
__host__ __device__ constexpr int halo_pixels(int s, int k) {
    return halo(kTh, s, k) * halo(kTw, s, k);
}

int tiles_x(int W) { return (W + kTw - 1) / kTw; }
int tiles_y(int H) { return (H + kTh - 1) / kTh; }

// shared floats of stage_mid<K, S>: the halo tile for kMc channels, and the
// expand weights of one step
int mid_smem_bytes(int k, int s) {
    return (kMc * halo_pixels(s, k) + kCk * kMc) * (int)sizeof(float);
}

template <int K, int S, bool EXPAND, int A>
__global__ void __launch_bounds__(kThreads)
stage_mid(const float* __restrict__ x, const float* __restrict__ we_t,
          const float* __restrict__ be, const float* __restrict__ wd,
          const float* __restrict__ bd, float* __restrict__ mid,
          float* __restrict__ partial, int Cin, int Cmid, int Hin, int Win, int H,
          int W, int chunks) {
    constexpr int HH = halo(kTh, S, K), HW = halo(kTw, S, K), NP = HH * HW;
    constexpr int PPT = (NP + kThreads - 1) / kThreads;
    constexpr int P = K / 2;
    extern __shared__ float sm[];
    float* buf = sm;                 // [kCk][NP] staged input, then [kMc][NP] e
    float* ws = sm + kMc * NP;       // [kCk][kMc] expand weights of a step
    __shared__ float red[(kThreads / 32) * kMc];

    const int tid = threadIdx.x;
    const int b = blockIdx.z / chunks, m0 = (blockIdx.z % chunks) * kMc;
    const int oy0 = blockIdx.y * kTh, ox0 = blockIdx.x * kTw;
    const int iy0 = oy0 * S - P, ix0 = ox0 * S - P;
    const size_t in_plane = (size_t)Hin * Win;
    const float* xb = x + (size_t)b * Cin * in_plane;

    if (EXPAND) {
        float acc[PPT][kMc];
#pragma unroll
        for (int i = 0; i < PPT; ++i)
#pragma unroll
            for (int m = 0; m < kMc; ++m) acc[i][m] = 0.0f;
        for (int c0 = 0; c0 < Cin; c0 += kCk) {
            for (int i = tid; i < kCk * NP; i += kThreads) {
                const int j = i / NP, p = i % NP;
                const int iy = iy0 + p / HW, ix = ix0 + p % HW, c = c0 + j;
                buf[i] = (c < Cin && iy >= 0 && iy < Hin && ix >= 0 && ix < Win)
                             ? xb[c * in_plane + (size_t)iy * Win + ix] : 0.0f;
            }
            if (tid < kCk * kMc) {
                const int j = tid / kMc, m = tid % kMc;
                ws[tid] = (c0 + j < Cin && m0 + m < Cmid)
                              ? we_t[(size_t)(c0 + j) * Cmid + m0 + m] : 0.0f;
            }
            __syncthreads();
#pragma unroll
            for (int j = 0; j < kCk; ++j) {
                float w[kMc];
#pragma unroll
                for (int m = 0; m < kMc; ++m) w[m] = ws[j * kMc + m];
#pragma unroll
                for (int i = 0; i < PPT; ++i) {
                    const int p = tid + i * kThreads;
                    const float v = p < NP ? buf[j * NP + p] : 0.0f;
#pragma unroll
                    for (int m = 0; m < kMc; ++m) acc[i][m] = fmaf(w[m], v, acc[i][m]);
                }
            }
            __syncthreads();
        }
        // e = act(expand + bias) inside the image, 0 outside (the dw's padding)
#pragma unroll
        for (int i = 0; i < PPT; ++i) {
            const int p = tid + i * kThreads;
            if (p >= NP) continue;
            const int iy = iy0 + p / HW, ix = ix0 + p % HW;
            const bool in = iy >= 0 && iy < Hin && ix >= 0 && ix < Win;
#pragma unroll
            for (int m = 0; m < kMc; ++m)
                buf[m * NP + p] = (in && m0 + m < Cmid) ? act<A>(acc[i][m] + be[m0 + m]) : 0.0f;
        }
    } else {
        // a depthwise-separable block: the dw reads the input itself (Cmid = Cin)
        for (int i = tid; i < kMc * NP; i += kThreads) {
            const int m = i / NP, p = i % NP;
            const int iy = iy0 + p / HW, ix = ix0 + p % HW, c = m0 + m;
            buf[i] = (c < Cmid && iy >= 0 && iy < Hin && ix >= 0 && ix < Win)
                         ? xb[c * in_plane + (size_t)iy * Win + ix] : 0.0f;
        }
    }
    __syncthreads();

    const int ty = tid / kTw, tx = tid % kTw;
    const int oy = oy0 + ty, ox = ox0 + tx;
    const bool valid = oy < H && ox < W;
    const size_t plane = (size_t)H * W;
    float a[kMc];
#pragma unroll
    for (int m = 0; m < kMc; ++m) {
        const int c = m0 + m;
        float s = 0.0f;
        if (valid && c < Cmid) {
            const float* e = buf + m * NP + ty * S * HW + tx * S;
            const float* w = wd + (size_t)c * K * K;
            s = __ldg(bd + c);
#pragma unroll
            for (int kh = 0; kh < K; ++kh)
#pragma unroll
                for (int kw = 0; kw < K; ++kw) s = fmaf(__ldg(w + kh * K + kw), e[kh * HW + kw], s);
            s = act<A>(s);
            mid[((size_t)b * Cmid + c) * plane + (size_t)oy * W + ox] = s;
        }
        a[m] = s;
    }
    if (partial == nullptr) return;
    // the tile's channel sums of d, in a fixed order
    const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
    for (int m = 0; m < kMc; ++m) {
        float v = a[m];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
        if (lane == 0) red[warp * kMc + m] = v;
    }
    __syncthreads();
    if (tid < kMc && m0 + tid < Cmid) {
        float s = 0.0f;
        for (int k = 0; k < kThreads / 32; ++k) s += red[k * kMc + tid];
        const int tiles = gridDim.x * gridDim.y;
        const int tile = blockIdx.y * gridDim.x + blockIdx.x;
        partial[((size_t)b * tiles + tile) * Cmid + m0 + tid] = s;
    }
}

// One block per image: mean[c] from the tile sums (in tile order), then the
// SE MLP -> gates[b][c]. Shared: mean[C], hid[R].
template <int A>
__global__ void __launch_bounds__(kThreads)
stage_gate(const float* __restrict__ partial, const float* __restrict__ w1,
           const float* __restrict__ b1, const float* __restrict__ w2,
           const float* __restrict__ b2, float* __restrict__ gates, int tiles, int C,
           int R, float inv_count) {
    extern __shared__ float sm[];
    float* mean = sm;
    float* hid = sm + C;
    const int b = blockIdx.x, tid = threadIdx.x;
    for (int c = tid; c < C; c += kThreads) {
        float s = 0.0f;
        for (int t = 0; t < tiles; ++t) s += partial[((size_t)b * tiles + t) * C + c];
        mean[c] = s * inv_count;
    }
    __syncthreads();
    const int lane = tid & 31, warp = tid >> 5;
    for (int r = warp; r < R; r += kThreads / 32) {
        float s = 0.0f;
        for (int c = lane; c < C; c += 32) s = fmaf(w1[(size_t)r * C + c], mean[c], s);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
        if (lane == 0) hid[r] = act<A>(s + b1[r]);
    }
    __syncthreads();
    for (int c = tid; c < C; c += kThreads) {
        float s = b2[c];
        for (int r = 0; r < R; ++r) s = fmaf(w2[(size_t)c * R + r], hid[r], s);
        gates[(size_t)b * C + c] = sigmoid(s);
    }
}

constexpr int kBm = 32, kBn = 128, kBk = 16;   // stage_project's tile and step
static_assert((kBm / 4) * (kBn / 4) == kThreads, "a 4 x 4 sub-tile a thread");

// y[b][o][n] = sum_k wp_t[k][o] g[b][k] d[b][k][n] + bp[o] (+ res[b][o][n])
__global__ void __launch_bounds__(kThreads)
stage_project(const float* __restrict__ d, const float* __restrict__ wp_t,
              const float* __restrict__ bp, const float* __restrict__ gates,
              const float* __restrict__ res, float* __restrict__ y, int Cmid, int Cout,
              int N) {
    __shared__ __align__(16) float As[kBk][kBm];
    __shared__ __align__(16) float Bs[kBk][kBn];
    const int tid = threadIdx.x, b = blockIdx.z;
    const int n0 = blockIdx.x * kBn, o0 = blockIdx.y * kBm;
    const int tm = tid / (kBn / 4), tn = tid % (kBn / 4);
    const float* db = d + (size_t)b * Cmid * N;
    const float* g = gates ? gates + (size_t)b * Cmid : nullptr;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

    for (int k0 = 0; k0 < Cmid; k0 += kBk) {
        for (int i = tid; i < kBk * kBm; i += kThreads) {
            const int k = i / kBm, o = i % kBm, kk = k0 + k, oo = o0 + o;
            float v = 0.0f;
            if (kk < Cmid && oo < Cout) {
                v = wp_t[(size_t)kk * Cout + oo];
                if (g) v *= g[kk];
            }
            As[k][o] = v;
        }
        for (int i = tid; i < kBk * kBn; i += kThreads) {
            const int k = i / kBn, n = i % kBn, kk = k0 + k, nn = n0 + n;
            Bs[k][n] = (kk < Cmid && nn < N) ? db[(size_t)kk * N + nn] : 0.0f;
        }
        __syncthreads();
#pragma unroll
        for (int k = 0; k < kBk; ++k) {
            const float4 av = *reinterpret_cast<const float4*>(&As[k][tm * 4]);
            const float4 bv = *reinterpret_cast<const float4*>(&Bs[k][tn * 4]);
            const float ar[4] = {av.x, av.y, av.z, av.w};
            const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
        }
        __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int o = o0 + tm * 4 + i;
        if (o >= Cout) continue;
        const float bias = bp[o];
        const size_t row = ((size_t)b * Cout + o) * N;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int n = n0 + tn * 4 + j;
            if (n >= N) continue;
            float v = acc[i][j] + bias;
            if (res) v += res[row + n];
            y[row + n] = v;
        }
    }
}

template <int K, int S, bool E, int A>
int launch_mid(const float* x, const float* we_t, const float* be, const float* wd,
               const float* bd, float* mid, float* partial, int B, int Cin, int Cmid,
               int Hin, int Win, int H, int W, cudaStream_t stream) {
    const int chunks = (Cmid + kMc - 1) / kMc;
    const int smem = mid_smem_bytes(K, S);
    cudaError_t err = cudaFuncSetAttribute(stage_mid<K, S, E, A>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(tiles_x(W), tiles_y(H), B * chunks);
    stage_mid<K, S, E, A><<<grid, kThreads, smem, stream>>>(x, we_t, be, wd, bd, mid, partial,
                                                            Cin, Cmid, Hin, Win, H, W, chunks);
    return (int)cudaGetLastError();
}

template <int K, int S>
int launch_mid_ks(bool expand, int a, const float* x, const float* we_t, const float* be,
                  const float* wd, const float* bd, float* mid, float* partial, int B, int Cin,
                  int Cmid, int Hin, int Win, int H, int W, cudaStream_t stream) {
    if (expand)
        return a == kSilu
            ? launch_mid<K, S, true, kSilu>(x, we_t, be, wd, bd, mid, partial, B, Cin, Cmid,
                                            Hin, Win, H, W, stream)
            : launch_mid<K, S, true, kRelu6>(x, we_t, be, wd, bd, mid, partial, B, Cin, Cmid,
                                             Hin, Win, H, W, stream);
    return a == kSilu
        ? launch_mid<K, S, false, kSilu>(x, we_t, be, wd, bd, mid, partial, B, Cin, Cmid, Hin,
                                         Win, H, W, stream)
        : launch_mid<K, S, false, kRelu6>(x, we_t, be, wd, bd, mid, partial, B, Cin, Cmid,
                                          Hin, Win, H, W, stream);
}

}  // namespace

// Scratch floats one block needs beside its mid tensor (B, Cmid, H, W): the
// tile sums (B, tiles, Cmid) and the gates (B, Cmid), H x W the block's
// output grid.
extern "C" long long stage_workspace_floats(int B, int Cmid, int H, int W) {
    return (long long)B * tiles_x(W) * tiles_y(H) * Cmid + (long long)B * Cmid;
}

// One block of a stage. x: (B, Cin, Hin, Win); y: (B, Cout, H, W) with H, W
// = Hin, Win (stride 1) or Hin / 2, Win / 2 (stride 2; Hin, Win even); mid:
// (B, Cmid, H, W); ws: stage_workspace_floats(B, Cmid, H, W). Weights, BN
// folded: we_t (Cin, Cmid) and be (Cmid) when expand is set (else Cmid =
// Cin), wd (Cmid, k, k), bd (Cmid), with se set w1 (R, Cmid), b1 (R), w2
// (Cmid, R), b2 (Cmid), and wp_t (Cmid, Cout), bp (Cout). k is 3 or 5,
// stride 1 or 2, act 0 (SiLU) or 1 (ReLU6); residual adds x (stride 1, Cin
// = Cout). All fp32 and contiguous. Returns a cudaError_t
// (cudaErrorInvalidValue for arguments the kernels do not take).
extern "C" int fused_stage_block(const float* x, float* y, float* mid, float* ws,
                                 const float* we_t, const float* be, const float* wd,
                                 const float* bd, const float* w1, const float* b1,
                                 const float* w2, const float* b2, const float* wp_t,
                                 const float* bp, int B, int Cin, int Cmid, int Cout, int R,
                                 int Hin, int Win, int k, int stride, int expand, int se,
                                 int residual, int a, cudaStream_t stream) {
    if ((k != 3 && k != 5) || (stride != 1 && stride != 2) || (a != kSilu && a != kRelu6) ||
        (stride == 2 && (Hin % 2 || Win % 2)) || (!expand && Cmid != Cin) ||
        (residual && (stride != 1 || Cin != Cout)) || (se && R < 1) || B < 1 || Hin < 1 ||
        Win < 1 || (long long)B * ((Cmid + kMc - 1) / kMc) > 65535)  // gridDim.z
        return (int)cudaErrorInvalidValue;
    const int H = stride == 2 ? Hin / 2 : Hin, W = stride == 2 ? Win / 2 : Win;
    const int tiles = tiles_x(W) * tiles_y(H);
    float* partial = se ? ws : nullptr;
    float* gates = ws + (size_t)B * tiles * Cmid;
    int err;
    if (k == 3)
        err = stride == 1 ? launch_mid_ks<3, 1>(expand, a, x, we_t, be, wd, bd, mid, partial, B,
                                                Cin, Cmid, Hin, Win, H, W, stream)
                          : launch_mid_ks<3, 2>(expand, a, x, we_t, be, wd, bd, mid, partial, B,
                                                Cin, Cmid, Hin, Win, H, W, stream);
    else
        err = stride == 1 ? launch_mid_ks<5, 1>(expand, a, x, we_t, be, wd, bd, mid, partial, B,
                                                Cin, Cmid, Hin, Win, H, W, stream)
                          : launch_mid_ks<5, 2>(expand, a, x, we_t, be, wd, bd, mid, partial, B,
                                                Cin, Cmid, Hin, Win, H, W, stream);
    if (err != cudaSuccess) return err;
    if (se) {
        auto gate = a == kSilu ? &stage_gate<kSilu> : &stage_gate<kRelu6>;
        const int smem = (Cmid + R) * (int)sizeof(float);
        cudaError_t e =
            cudaFuncSetAttribute(gate, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return (int)e;
        const float inv_count = 1.0f / ((float)H * (float)W);
        gate<<<B, kThreads, smem, stream>>>(partial, w1, b1, w2, b2, gates, tiles, Cmid, R,
                                            inv_count);
        if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    }
    const int N = H * W;
    const dim3 grid((N + kBn - 1) / kBn, (Cout + kBm - 1) / kBm, B);
    stage_project<<<grid, kThreads, 0, stream>>>(mid, wp_t, bp, se ? gates : nullptr,
                                                 residual ? x : nullptr, y, Cmid, Cout, N);
    return (int)cudaGetLastError();
}
