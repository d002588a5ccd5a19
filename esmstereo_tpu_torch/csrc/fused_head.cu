// Kernel A: backbone stem + stage 0 of efficientnet_b2, eval mode, fp32.
//
// Replaces esmstereo_tpu/ops/pallas/fused_head.py::fused_stage0_apply
// (pallas_call at :393). From an NCHW image (B, 3, Hi, Wi) it computes, on the
// (Hi/2, Wi/2) grid:
//   x0 = relu6(conv3x3 s2 p1 (img) + b)                       32 ch (stem)
//   a0 = silu(dw3x3(x0) + b); g0 = SE(mean a0)                 block 0
//   y0 = pw(a0 * g0) + b                                      16 ch
//   a1 = silu(dw3x3(y0) + b); g1 = SE(mean a1)                 block 1
//   out = pw(a1 * g1) + b + y0                                16 ch
// with every eval BatchNorm folded into the weights and biases by the
// wrapper; SE(m) = sigmoid(W2 silu(W1 m + b1) + b2).
//
// What bounds it on an H100: operations, narrowly. At 2 x 544 x 992 the image
// is read and the output written once (13.0 MB in, 17.3 MB out: 0.009 ms at
// 3.35 TB/s), against 2064 multiply-adds per output pixel (1.1 GFLOP: 0.017
// ms at the 67 TFLOP/s fp32 rate of the CUDA cores).
//
// Design for that: SqueezeExcite needs a mean over the whole image before
// each block's gate, and blocks of a grid cannot wait for each other, so the
// work runs as three passes over 32 x 4 pixel tiles with two small gate
// kernels between them:
//   pass 1  stem + dw0 on the tile (x0 recomputed with a 1-pixel halo in
//           shared memory), per-tile channel sums of a0 -> partial0;
//   gate 0  one block per image sums partial0 in a fixed order -> g0;
//   pass 2  stem + dw0 again (2-pixel halo), gate 0 and pw0 -> y0 with a
//           1-pixel halo in shared memory; stores y0 (the tile only) and the
//           per-tile sums of a1 = silu(dw1(y0)) -> partial1;
//   gate 1  -> g1;
//   pass 3  reads y0 with its halo, dw1, gate 1, pw1, residual -> out.
// Recomputing the stem is cheaper than storing the 32-channel x0 (35 MB);
// y0 (17 MB) makes one round trip. The partial sums are reduced in a fixed
// order, so results are the same from run to run (no atomics).
#include <cuda_runtime.h>

#include "activations.cuh"

namespace {

// efficientnet_b2 stage 0: stem 3 -> 32, DS block 32 -> 16 (SE 8),
// DS block 16 -> 16 (SE 4) with a residual.
constexpr int C0 = 32, R0 = 8, C1 = 16, R1 = 4, C2 = 16;
constexpr int kTw = 32, kTh = 4, kThreads = kTw * kTh;

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

__host__ __device__ constexpr int patch_floats(int ny, int nx) { return 3 * (2 * ny + 1) * (2 * nx + 1); }
constexpr int kSmem1 = kParams + patch_floats(kTh + 2, kTw + 2) + C0 * (kTh + 2) * (kTw + 2);
constexpr int kSmem2 = kParams + patch_floats(kTh + 4, kTw + 4) + C0 * (kTh + 4) * (kTw + 4) +
                       C1 * (kTh + 2) * (kTw + 2);
constexpr int kSmem3 = kParams + C1 * (kTh + 2) * (kTw + 2);

__device__ void load_params(const float* __restrict__ prm, float* p, int tid) {
    for (int i = tid; i < kParams; i += kThreads) p[i] = prm[i];
}

// Image rows/cols feeding x0 rows [gy0, gy0+ny) and cols [gx0, gx0+nx):
// rows 2*gy0-1 .. 2*(gy0+ny)-1, zero outside the image (the conv's padding).
__device__ void load_patch(const float* __restrict__ img, float* patch, int gy0, int gx0,
                           int ny, int nx, int Hi, int Wi, int tid) {
    const int ph = 2 * ny + 1, pw = 2 * nx + 1;
    const size_t plane = (size_t)Hi * Wi;
    for (int i = tid; i < 3 * ph * pw; i += kThreads) {
        const int c = i / (ph * pw);
        const int r = (i / pw) % ph;
        const int q = i % pw;
        const int iy = 2 * gy0 - 1 + r, ix = 2 * gx0 - 1 + q;
        patch[i] = (iy >= 0 && iy < Hi && ix >= 0 && ix < Wi)
                       ? img[c * plane + (size_t)iy * Wi + ix] : 0.0f;
    }
}

// x0 = relu6(stem conv) on the tile [C0][ny][nx] at grid origin (gy0, gx0);
// zero outside the grid, which is the dw conv's zero padding.
__device__ void stem_tile(const float* patch, const float* p, float* x0, int gy0, int gx0,
                          int ny, int nx, int H, int W, int tid) {
    const int ph = 2 * ny + 1, pw = 2 * nx + 1;
    for (int i = tid; i < ny * nx; i += kThreads) {
        const int ly = i / nx, lx = i % nx;
        const int gy = gy0 + ly, gx = gx0 + lx;
        const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
        float v[27];
#pragma unroll
        for (int ci = 0; ci < 3; ++ci)
#pragma unroll
            for (int kh = 0; kh < 3; ++kh)
#pragma unroll
                for (int kw = 0; kw < 3; ++kw)
                    v[ci * 9 + kh * 3 + kw] =
                        patch[ci * ph * pw + (2 * ly + kh) * pw + 2 * lx + kw];
        for (int c = 0; c < C0; ++c) {
            float s = p[OFF_STEM_B + c];
#pragma unroll
            for (int k = 0; k < 27; ++k) s = fmaf(p[OFF_STEM_W + c * 27 + k], v[k], s);
            x0[c * ny * nx + i] = in ? relu6(s) : 0.0f;
        }
    }
}

// a[c] = silu(dw3x3(t)[c] + b[c]) at tile position (ly, lx) of a [C][ny][nx] tile.
template <int C>
__device__ __forceinline__ void dw_silu(const float* t, int ny, int nx, int ly, int lx,
                                        const float* w, const float* bias, float* a) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
        const float* tc = t + c * ny * nx;
        float s = bias[c];
#pragma unroll
        for (int kh = 0; kh < 3; ++kh)
#pragma unroll
            for (int kw = 0; kw < 3; ++kw)
                s = fmaf(w[c * 9 + kh * 3 + kw], tc[(ly - 1 + kh) * nx + lx - 1 + kw], s);
        a[c] = silu(s);
    }
}

// Sum a[C] over the block's threads in a fixed order; thread c < C writes
// the channel sum to out[c].
template <int C>
__device__ void block_channel_sums(const float* a, float* red, float* out, int tid) {
    const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
    for (int c = 0; c < C; ++c) {
        float v = a[c];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
        if (lane == 0) red[warp * C + c] = v;
    }
    __syncthreads();
    if (tid < C) {
        float s = 0.0f;
        for (int k = 0; k < kThreads / 32; ++k) s += red[k * C + tid];
        out[tid] = s;
    }
}

__global__ void __launch_bounds__(kThreads)
stage0_pass1(const float* __restrict__ img, const float* __restrict__ prm,
             float* __restrict__ partial0, int Hi, int Wi) {
    extern __shared__ float sm[];
    float* p = sm;
    float* patch = p + kParams;
    float* x0 = patch + patch_floats(kTh + 2, kTw + 2);
    __shared__ float red[(kThreads / 32) * C0];
    const int H = Hi / 2, W = Wi / 2;
    const int b = blockIdx.z;
    const int tid = threadIdx.y * kTw + threadIdx.x;
    const int gy0 = blockIdx.y * kTh - 1, gx0 = blockIdx.x * kTw - 1;
    const int ny = kTh + 2, nx = kTw + 2;

    load_params(prm, p, tid);
    load_patch(img + (size_t)b * 3 * Hi * Wi, patch, gy0, gx0, ny, nx, Hi, Wi, tid);
    __syncthreads();
    stem_tile(patch, p, x0, gy0, gx0, ny, nx, H, W, tid);
    __syncthreads();

    const int gy = blockIdx.y * kTh + threadIdx.y, gx = blockIdx.x * kTw + threadIdx.x;
    float a[C0];
    if (gy < H && gx < W) {
        dw_silu<C0>(x0, ny, nx, threadIdx.y + 1, threadIdx.x + 1, p + OFF_DW0_W, p + OFF_DW0_B, a);
    } else {
#pragma unroll
        for (int c = 0; c < C0; ++c) a[c] = 0.0f;
    }
    const int tiles = gridDim.x * gridDim.y;
    const int tile = blockIdx.y * gridDim.x + blockIdx.x;
    block_channel_sums<C0>(a, red, partial0 + ((size_t)b * tiles + tile) * C0, tid);
}

// One block of 32 threads per image: channel means from the tile partials
// (summed in tile order), then the SE MLP -> gates[b][C].
template <int C, int R>
__global__ void se_gate(const float* __restrict__ partial, const float* __restrict__ prm,
                        int off_w1, int off_b1, int off_w2, int off_b2, int tiles,
                        float inv_count, float* __restrict__ gates) {
    __shared__ float mean[C];
    __shared__ float hid[R];
    const int b = blockIdx.x, t = threadIdx.x;
    if (t < C) {
        float s = 0.0f;
        for (int k = 0; k < tiles; ++k) s += partial[((size_t)b * tiles + k) * C + t];
        mean[t] = s * inv_count;
    }
    __syncthreads();
    if (t < R) {
        float s = prm[off_b1 + t];
        for (int c = 0; c < C; ++c) s = fmaf(prm[off_w1 + t * C + c], mean[c], s);
        hid[t] = silu(s);
    }
    __syncthreads();
    if (t < C) {
        float s = prm[off_b2 + t];
        for (int r = 0; r < R; ++r) s = fmaf(prm[off_w2 + t * R + r], hid[r], s);
        gates[(size_t)b * C + t] = sigmoid(s);
    }
}

__global__ void __launch_bounds__(kThreads)
stage0_pass2(const float* __restrict__ img, const float* __restrict__ prm,
             const float* __restrict__ gates0, float* __restrict__ y0buf,
             float* __restrict__ partial1, int Hi, int Wi) {
    extern __shared__ float sm[];
    float* p = sm;
    float* patch = p + kParams;
    float* x0 = patch + patch_floats(kTh + 4, kTw + 4);
    float* y0 = x0 + C0 * (kTh + 4) * (kTw + 4);
    __shared__ float red[(kThreads / 32) * C1];
    const int H = Hi / 2, W = Wi / 2;
    const int b = blockIdx.z;
    const int tid = threadIdx.y * kTw + threadIdx.x;
    const int nyx = kTh + 4, nxx = kTw + 4;  // x0 tile, 2-pixel halo
    const int nyy = kTh + 2, nxy = kTw + 2;  // y0 tile, 1-pixel halo
    const int gy0 = blockIdx.y * kTh - 2, gx0 = blockIdx.x * kTw - 2;

    load_params(prm, p, tid);
    load_patch(img + (size_t)b * 3 * Hi * Wi, patch, gy0, gx0, nyx, nxx, Hi, Wi, tid);
    __syncthreads();
    stem_tile(patch, p, x0, gy0, gx0, nyx, nxx, H, W, tid);
    __syncthreads();

    const float* g0 = gates0 + (size_t)b * C0;
    for (int i = tid; i < nyy * nxy; i += kThreads) {
        const int ly = i / nxy, lx = i % nxy;
        const int gy = gy0 + 1 + ly, gx = gx0 + 1 + lx;
        if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
            float a[C0];
            dw_silu<C0>(x0, nyx, nxx, ly + 1, lx + 1, p + OFF_DW0_W, p + OFF_DW0_B, a);
#pragma unroll
            for (int c = 0; c < C0; ++c) a[c] *= g0[c];
#pragma unroll 4
            for (int o = 0; o < C1; ++o) {
                float s = p[OFF_PW0_B + o];
#pragma unroll
                for (int c = 0; c < C0; ++c) s = fmaf(p[OFF_PW0_W + o * C0 + c], a[c], s);
                y0[o * nyy * nxy + i] = s;
            }
        } else {
            for (int o = 0; o < C1; ++o) y0[o * nyy * nxy + i] = 0.0f;
        }
    }
    __syncthreads();

    const int gy = blockIdx.y * kTh + threadIdx.y, gx = blockIdx.x * kTw + threadIdx.x;
    float a[C1];
    if (gy < H && gx < W) {
        const int ly = threadIdx.y + 1, lx = threadIdx.x + 1;
        const size_t plane = (size_t)H * W;
        float* yb = y0buf + (size_t)b * C1 * plane + (size_t)gy * W + gx;
#pragma unroll
        for (int o = 0; o < C1; ++o) yb[o * plane] = y0[o * nyy * nxy + ly * nxy + lx];
        dw_silu<C1>(y0, nyy, nxy, ly, lx, p + OFF_DW1_W, p + OFF_DW1_B, a);
    } else {
#pragma unroll
        for (int c = 0; c < C1; ++c) a[c] = 0.0f;
    }
    const int tiles = gridDim.x * gridDim.y;
    const int tile = blockIdx.y * gridDim.x + blockIdx.x;
    block_channel_sums<C1>(a, red, partial1 + ((size_t)b * tiles + tile) * C1, tid);
}

__global__ void __launch_bounds__(kThreads)
stage0_pass3(const float* __restrict__ y0buf, const float* __restrict__ prm,
             const float* __restrict__ gates1, float* __restrict__ out, int H, int W) {
    extern __shared__ float sm[];
    float* p = sm;
    float* y0 = p + kParams;
    const int b = blockIdx.z;
    const int tid = threadIdx.y * kTw + threadIdx.x;
    const int ny = kTh + 2, nx = kTw + 2;
    const int gy0 = blockIdx.y * kTh - 1, gx0 = blockIdx.x * kTw - 1;
    const size_t plane = (size_t)H * W;
    const float* yb = y0buf + (size_t)b * C1 * plane;

    load_params(prm, p, tid);
    for (int i = tid; i < C1 * ny * nx; i += kThreads) {
        const int c = i / (ny * nx);
        const int ly = (i / nx) % ny, lx = i % nx;
        const int gy = gy0 + ly, gx = gx0 + lx;
        y0[i] = (gy >= 0 && gy < H && gx >= 0 && gx < W)
                    ? yb[c * plane + (size_t)gy * W + gx] : 0.0f;
    }
    __syncthreads();

    const int gy = blockIdx.y * kTh + threadIdx.y, gx = blockIdx.x * kTw + threadIdx.x;
    if (gy >= H || gx >= W) return;
    const int ly = threadIdx.y + 1, lx = threadIdx.x + 1;
    float a[C1];
    dw_silu<C1>(y0, ny, nx, ly, lx, p + OFF_DW1_W, p + OFF_DW1_B, a);
    const float* g1 = gates1 + (size_t)b * C1;
#pragma unroll
    for (int c = 0; c < C1; ++c) a[c] *= g1[c];
    float* ob = out + (size_t)b * C2 * plane + (size_t)gy * W + gx;
#pragma unroll 4
    for (int o = 0; o < C2; ++o) {
        float s = p[OFF_PW1_B + o];
#pragma unroll
        for (int c = 0; c < C1; ++c) s = fmaf(p[OFF_PW1_W + o * C1 + c], a[c], s);
        ob[o * plane] = s + y0[o * ny * nx + ly * nx + lx];
    }
}

int tiles_x(int W) { return (W + kTw - 1) / kTw; }
int tiles_y(int H) { return (H + kTh - 1) / kTh; }

}  // namespace

extern "C" int stage0_params_size() { return kParams; }

// Scratch the wrapper allocates: partial0, gates0, partial1, gates1, y0.
extern "C" long long stage0_workspace_floats(int B, int Hi, int Wi) {
    const int H = Hi / 2, W = Wi / 2;
    const long long tiles = (long long)tiles_x(W) * tiles_y(H);
    return B * tiles * (C0 + C1) + (long long)B * (C0 + C1) + (long long)B * C1 * H * W;
}

// img: (B, 3, Hi, Wi); params: stage0_params_size() floats in the packed
// order above; out: (B, 16, Hi/2, Wi/2); ws: stage0_workspace_floats().
// Hi and Wi must be even. All fp32, contiguous. Returns a cudaError_t.
extern "C" int fused_stage0(const float* img, const float* params, float* out, float* ws,
                            int B, int Hi, int Wi, cudaStream_t stream) {
    const int H = Hi / 2, W = Wi / 2;
    const int tx = tiles_x(W), ty = tiles_y(H), tiles = tx * ty;
    float* partial0 = ws;
    float* gates0 = partial0 + (size_t)B * tiles * C0;
    float* partial1 = gates0 + (size_t)B * C0;
    float* gates1 = partial1 + (size_t)B * tiles * C1;
    float* y0 = gates1 + (size_t)B * C1;

    const dim3 grid(tx, ty, B), block(kTw, kTh);
    const float inv_count = 1.0f / ((float)H * (float)W);
    cudaError_t err;
    err = cudaFuncSetAttribute(stage0_pass1, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmem1 * (int)sizeof(float));
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(stage0_pass2, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmem2 * (int)sizeof(float));
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(stage0_pass3, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmem3 * (int)sizeof(float));
    if (err != cudaSuccess) return (int)err;

    stage0_pass1<<<grid, block, kSmem1 * sizeof(float), stream>>>(img, params, partial0, Hi, Wi);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    se_gate<C0, R0><<<B, 32, 0, stream>>>(partial0, params, OFF_SE0_W1, OFF_SE0_B1, OFF_SE0_W2,
                                         OFF_SE0_B2, tiles, inv_count, gates0);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    stage0_pass2<<<grid, block, kSmem2 * sizeof(float), stream>>>(img, params, gates0, y0,
                                                                  partial1, Hi, Wi);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    se_gate<C1, R1><<<B, 32, 0, stream>>>(partial1, params, OFF_SE1_W1, OFF_SE1_B1, OFF_SE1_W2,
                                         OFF_SE1_B2, tiles, inv_count, gates1);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    stage0_pass3<<<grid, block, kSmem3 * sizeof(float), stream>>>(y0, params, gates1, out, H, W);
    return (int)cudaGetLastError();
}
