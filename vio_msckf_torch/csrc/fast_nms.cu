// FAST-9 corner score + threshold + border mask + 3x3 non-max suppression.
//
// Replaces the Pallas TPU kernel _fast_nms_kernel
// (vio_msckf_tpu/ops/fast_pallas.py:71, launched by fast_score_map_pallas).
// The plain PyTorch twin is vio_msckf_torch/ops/fast.py:fast_score_map.
//
// What bounds it on an H100: memory traffic. One 480x752 f32 frame is read
// once (1.4 MB) and the score map written once (1.4 MB); the arithmetic is
// ~100 min/max/sub per pixel. The design keeps every intermediate (the 16
// circle differences, both polarity scores, the pre-NMS score ring) in
// shared memory and registers: each block loads a (TILE_H+8) x (TILE_W+8)
// tile (3-px halo for the Bresenham circle + 1 px for NMS), scores the tile
// plus a 1-px ring, then suppresses. Global memory sees one read and one
// write per pixel, the same budget as the TPU kernel's VMEM strip.
//
// Bit-exact against the twin: only subtractions (neighbour - centre, in
// that order), min and max are involved, NMS keeps ">=", and pixels
// outside the image read 0 (the Pallas canvas's zero padding); the border
// mask zeroes every pixel whose circle or NMS window touches them.

#include <cuda_runtime.h>

namespace {

constexpr int TILE_W = 32;
constexpr int TILE_H = 16;
constexpr int HALO = 4;                    // 3 (circle) + 1 (NMS)
constexpr int SW = TILE_W + 2 * HALO;
constexpr int SH = TILE_H + 2 * HALO;
constexpr int RW = TILE_W + 2;             // score ring width
constexpr int RH = TILE_H + 2;
constexpr int BORDER = 3;

// Bresenham circle of radius 3, clockwise from 12 o'clock (ops/fast.py).
__device__ __forceinline__ int circle_dy(int k) {
    constexpr int dy[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};
    return dy[k];
}
__device__ __forceinline__ int circle_dx(int k) {
    constexpr int dx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
    return dx[k];
}

// Max over the 16 cyclic 9-arcs of the arc minimum, split 9 = 3 + 3 + 3.
__device__ __forceinline__ float arc9(const float d[16]) {
    float m3[16];
#pragma unroll
    for (int i = 0; i < 16; ++i)
        m3[i] = fminf(fminf(d[i], d[(i + 1) & 15]), d[(i + 2) & 15]);
    float best = fminf(fminf(m3[0], m3[3]), m3[6]);
#pragma unroll
    for (int i = 1; i < 16; ++i)
        best = fmaxf(best, fminf(fminf(m3[i], m3[(i + 3) & 15]), m3[(i + 6) & 15]));
    return best;
}

__global__ void fast_nms_kernel(const float* __restrict__ img,
                                float* __restrict__ out,
                                int H, int W, float threshold) {
    __shared__ float s_img[SH][SW];
    __shared__ float s_score[RH][RW];

    const int bx = blockIdx.x * TILE_W;
    const int by = blockIdx.y * TILE_H;
    const int tid = threadIdx.y * TILE_W + threadIdx.x;
    const int nthreads = TILE_W * TILE_H;

    for (int i = tid; i < SH * SW; i += nthreads) {
        const int ly = i / SW, lx = i % SW;
        const int gy = by - HALO + ly, gx = bx - HALO + lx;
        s_img[ly][lx] = (gy >= 0 && gy < H && gx >= 0 && gx < W)
                            ? img[(size_t)gy * W + gx] : 0.0f;
    }
    __syncthreads();

    // Score the tile plus a 1-px ring: ring (sy, sx) is pixel
    // (by - 1 + sy, bx - 1 + sx), stored at s_img[sy + 3][sx + 3].
    for (int i = tid; i < RH * RW; i += nthreads) {
        const int sy = i / RW, sx = i % RW;
        const int gy = by - 1 + sy, gx = bx - 1 + sx;
        const int ly = sy + HALO - 1, lx = sx + HALO - 1;
        const float c = s_img[ly][lx];
        float dpos[16], dneg[16];
#pragma unroll
        for (int k = 0; k < 16; ++k) {
            const float d = s_img[ly + circle_dy(k)][lx + circle_dx(k)] - c;
            dpos[k] = d;
            dneg[k] = -d;
        }
        const float score = fmaxf(arc9(dpos), arc9(dneg));
        const bool inside = gy >= BORDER && gy < H - BORDER &&
                            gx >= BORDER && gx < W - BORDER;
        s_score[sy][sx] = (score > threshold && inside) ? score : 0.0f;
    }
    __syncthreads();

    const int gy = by + threadIdx.y, gx = bx + threadIdx.x;
    if (gy >= H || gx >= W) return;
    const int sy = threadIdx.y + 1, sx = threadIdx.x + 1;
    const float mid = s_score[sy][sx];
    float nmax = s_score[sy - 1][sx - 1];
    nmax = fmaxf(nmax, s_score[sy - 1][sx]);
    nmax = fmaxf(nmax, s_score[sy - 1][sx + 1]);
    nmax = fmaxf(nmax, s_score[sy][sx - 1]);
    nmax = fmaxf(nmax, s_score[sy][sx + 1]);
    nmax = fmaxf(nmax, s_score[sy + 1][sx - 1]);
    nmax = fmaxf(nmax, s_score[sy + 1][sx]);
    nmax = fmaxf(nmax, s_score[sy + 1][sx + 1]);
    out[(size_t)gy * W + gx] = (mid >= nmax) ? mid : 0.0f;
}

}  // namespace

extern "C" int vio_fast_nms(const float* img, float* out, int H, int W,
                            float threshold, void* stream) {
    const dim3 block(TILE_W, TILE_H);
    const dim3 grid((W + TILE_W - 1) / TILE_W, (H + TILE_H - 1) / TILE_H);
    fast_nms_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(img, out, H, W,
                                                              threshold);
    return (int)cudaGetLastError();
}
