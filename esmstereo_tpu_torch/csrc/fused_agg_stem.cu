// Kernel C: group_stem + agg, the two 3x3x3 convs at the cost volume's entry,
// each with its eval BatchNorm folded in and a GELU epilogue, fp32.
//
// Replaces esmstereo_tpu/ops/pallas/fused_agg_stem.py::folded_stem_agg_apply
// (pallas_call at :295). The wrapper launches this direct convolution twice:
// group_stem 32 -> 8 channels, writing an 8-channel intermediate, then
// agg 8 -> 8. Input and output are (B, C, D, H, W) fp32; padding 1 on every
// axis (zeros outside the volume).
//
// What bounds it on an H100: operations. On the L main path (D=48 at
// 136 x 248) the pair is 27 * (32*8 + 8*8) multiply-adds per voxel, about
// 28 GFLOP on the fp32 CUDA cores, against 207 MB read and 52 MB written.
//
// Design for that: each block owns a 32 x 4 (w, h) tile of output pixels and
// a chunk of kDc output depths, for all CO output channels; each thread owns
// one (h, w) column and keeps kDc * CO accumulators in registers. Input
// channels stream through shared memory one at a time as a (kDc+2) x 6 x 34
// halo slab, and the weights (BN scale folded in), transposed on the way
// in to CI x 27 x CO, sit in shared memory for the block's lifetime. For
// each input channel and (kh, kw) tap a thread loads its kDc+2 depth values
// once and reuses each for three kd taps and CO outputs: about 12 FMAs per
// shared load. No tensor cores: fp32 parity first; a bf16 wgmma version is
// later work.
#include <cuda_runtime.h>

#include "activations.cuh"

namespace {

constexpr int kTw = 32;
constexpr int kTh = 4;
constexpr int kDc = 8;
constexpr int kSw = kTw + 2;
constexpr int kSh = kTh + 2;
constexpr int kSd = kDc + 2;

template <int CI, int CO>
__global__ void __launch_bounds__(kTw * kTh)
conv3d_bn_gelu_kernel(const float* __restrict__ x, const float* __restrict__ wgt,
                      const float* __restrict__ shift, float* __restrict__ y,
                      int D, int H, int W, int approximate) {
    // wgt: [CO][CI][27] (BN scale folded); shift: [CO]; wsh: [CI][27][CO]
    __shared__ float wsh[CI * 27 * CO];
    __shared__ float xsh[kSd * kSh * kSw];

    const int tilesW = (W + kTw - 1) / kTw;
    const int w0 = (blockIdx.x % tilesW) * kTw;
    const int h0 = (blockIdx.x / tilesW) * kTh;
    const int d0 = blockIdx.y * kDc;
    const int b = blockIdx.z;
    const int tx = threadIdx.x, ty = threadIdx.y;
    const int tid = ty * kTw + tx;
    constexpr int kThreads = kTw * kTh;

    for (int i = tid; i < CI * 27 * CO; i += kThreads)
        wsh[i] = wgt[(i % CO) * (CI * 27) + i / CO];

    float acc[kDc][CO];
#pragma unroll
    for (int dd = 0; dd < kDc; ++dd)
#pragma unroll
        for (int o = 0; o < CO; ++o) acc[dd][o] = 0.0f;

    const size_t plane = (size_t)H * W;
    const size_t vol = (size_t)D * plane;
    const float* xb = x + (size_t)b * CI * vol;

    for (int ci = 0; ci < CI; ++ci) {
        __syncthreads();  // previous slab fully consumed (and weights loaded)
        const float* xc = xb + (size_t)ci * vol;
        for (int i = tid; i < kSd * kSh * kSw; i += kThreads) {
            const int sw = i % kSw;
            const int sh = (i / kSw) % kSh;
            const int sd = i / (kSw * kSh);
            const int gd = d0 - 1 + sd, gh = h0 - 1 + sh, gw = w0 - 1 + sw;
            float v = 0.0f;
            if (gd >= 0 && gd < D && gh >= 0 && gh < H && gw >= 0 && gw < W)
                v = xc[(size_t)gd * plane + (size_t)gh * W + gw];
            xsh[i] = v;
        }
        __syncthreads();
        const float* wc = wsh + ci * 27 * CO;
#pragma unroll
        for (int kh = 0; kh < 3; ++kh) {
#pragma unroll
            for (int kw = 0; kw < 3; ++kw) {
                float col[kSd];
#pragma unroll
                for (int sd = 0; sd < kSd; ++sd)
                    col[sd] = xsh[(sd * kSh + ty + kh) * kSw + tx + kw];
#pragma unroll
                for (int kd = 0; kd < 3; ++kd) {
                    const float* wk = wc + ((kd * 3 + kh) * 3 + kw) * CO;
                    float wr[CO];
#pragma unroll
                    for (int o = 0; o < CO; ++o) wr[o] = wk[o];
#pragma unroll
                    for (int dd = 0; dd < kDc; ++dd)
#pragma unroll
                        for (int o = 0; o < CO; ++o)
                            acc[dd][o] = fmaf(col[dd + kd], wr[o], acc[dd][o]);
                }
            }
        }
    }

    const int h = h0 + ty, w = w0 + tx;
    if (h >= H || w >= W) return;
    const bool approx = approximate != 0;
    float* yb = y + (size_t)b * CO * vol + (size_t)h * W + w;
#pragma unroll
    for (int dd = 0; dd < kDc; ++dd) {
        const int d = d0 + dd;
        if (d >= D) break;
#pragma unroll
        for (int o = 0; o < CO; ++o)
            yb[(size_t)o * vol + (size_t)d * plane] =
                gelu(acc[dd][o] + shift[o], approx);
    }
}

template <int CI, int CO>
int launch(const float* x, const float* wgt, const float* shift, float* y,
           int B, int D, int H, int W, int approximate, cudaStream_t stream) {
    const int tiles = ((W + kTw - 1) / kTw) * ((H + kTh - 1) / kTh);
    const dim3 grid(tiles, (D + kDc - 1) / kDc, B);
    const dim3 block(kTw, kTh);
    conv3d_bn_gelu_kernel<CI, CO><<<grid, block, 0, stream>>>(
        x, wgt, shift, y, D, H, W, approximate);
    return (int)cudaGetLastError();
}

}  // namespace

// x: (B, CI, D, H, W); wgt: (CO, CI, 3, 3, 3) with the BN scale folded in;
// shift: (CO,); y: (B, CO, D, H, W). All fp32, contiguous.
// Returns a cudaError_t; cudaErrorInvalidValue for an unsupported (CI, CO).
extern "C" int conv3d_bn_gelu(const float* x, const float* wgt,
                              const float* shift, float* y, int B, int CI,
                              int CO, int D, int H, int W, int approximate,
                              cudaStream_t stream) {
    if (CI == 32 && CO == 8)
        return launch<32, 8>(x, wgt, shift, y, B, D, H, W, approximate, stream);
    if (CI == 8 && CO == 8)
        return launch<8, 8>(x, wgt, shift, y, B, D, H, W, approximate, stream);
    return (int)cudaErrorInvalidValue;
}
