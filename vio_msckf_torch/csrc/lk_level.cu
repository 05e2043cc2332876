// One pyramid level of Lucas-Kanade tracking for P features.
//
// Replaces the Pallas TPU kernel _lk_level_kernel
// (vio_msckf_tpu/ops/klt_pallas.py:63, launched by _track_level_pallas_flat)
// with the semantics of the XLA level (vio_msckf_tpu/ops/klt.py:
// _track_level, backend "xla"). The plain PyTorch twin is
// vio_msckf_torch/ops/klt.py:track_level_plain.
//
// What bounds it on an H100: sequential depth per feature. Each feature
// runs up to 30 dependent Newton iterations, each a 15x15 bilinear resample
// and two reductions; the whole level is ~P * 30 * 225 * 10 flops, tiny
// next to the card. The TPU kernel blocked 16 features per program with a
// shared early exit; here each feature gets one warp and leaves its own
// loop the moment it converges, so a straggler holds up nobody. Per-lane
// pixel values (I, Ix, Iy for ~7 pixels) stay in registers, the 17x17
// template in shared memory, and the moving image is sampled straight from
// the level image in global memory (L1/L2 resident: a level is at most
// 1.4 MB).
//
// Window semantics kept from the XLA path: that path samples only from a
// gathered patch -- template rows [y0t, y0t+18) x columns [128*b0t,
// 128*b0t+256) of the edge-padded (pad 16) image, moving rows [y0n, y0n+48)
// x columns [128*b0n+nx0, +48) -- and a bilinear tap outside its patch gets
// zero weight. The kernel computes the same window origins and drops the
// same taps; edge padding is a clamped read of the unpadded image.
// Built with --fmad=false so products and sums round as the twin's do.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int PAD = 16;
constexpr int NY = 48;
constexpr float MAX_MOVE = 12.0f;
constexpr int WARPS = 4;           // features per CTA
constexpr int MAX_GWIN = 17;       // win <= 15
constexpr int MAX_SLOTS = 8;       // ceil(15 * 15 / 32)

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

// Python-style floor division by a positive divisor.
__device__ __forceinline__ int floordiv(int a, int b) {
    const int q = a / b;
    return (a % b != 0 && a < 0) ? q - 1 : q;
}

__device__ __forceinline__ int float_floor_to_int(float v) {
    // floor then convert; non-finite or huge values saturate like a clamp.
    const float f = floorf(v);
    if (!(f > -1.0e9f)) return -1000000000;
    if (f > 1.0e9f) return 1000000000;
    return (int)f;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

// Bilinear sample of the window (rows [wy, wy+wh), cols [wx, wx+ww) in
// padded coordinates) at window position (py, px). Taps outside the window
// get zero weight. The padded image is the unpadded one read with clamping.
__device__ __forceinline__ float sample(const float* __restrict__ img, int H,
                                        int W, int wy, int wx, int wh, int ww,
                                        float py, float px) {
    const float fy = floorf(py), fx = floorf(px);
    const int iy = (int)fy, ix = (int)fx;
    const float wy0 = 1.0f - fabsf(py - fy), wy1 = 1.0f - fabsf(py - (fy + 1.0f));
    const float wx0 = 1.0f - fabsf(px - fx), wx1 = 1.0f - fabsf(px - (fx + 1.0f));
    const bool vy0 = iy >= 0 && iy < wh, vy1 = iy + 1 >= 0 && iy + 1 < wh;
    const int r0 = clampi(wy + iy - PAD, 0, H - 1) * W;
    const int r1 = clampi(wy + iy + 1 - PAD, 0, H - 1) * W;
    float t[2] = {0.0f, 0.0f};
#pragma unroll
    for (int d = 0; d < 2; ++d) {
        const int x = ix + d;
        if (x < 0 || x >= ww) continue;
        const int c = clampi(wx + x - PAD, 0, W - 1);
        const float a = vy0 ? wy0 * img[r0 + c] : 0.0f;
        const float b = vy1 ? wy1 * img[r1 + c] : 0.0f;
        t[d] = a + b;
    }
    return wx0 * t[0] + wx1 * t[1];
}

__global__ void lk_level_kernel(
    const float* __restrict__ prev_a, const float* __restrict__ prev_b,
    const float* __restrict__ next_a, const float* __restrict__ next_b,
    const int32_t* __restrict__ img_idx,
    const float* __restrict__ pts_prev, const float* __restrict__ guess_in,
    float* __restrict__ guess_out, uint8_t* __restrict__ ok_out,
    uint8_t* __restrict__ lost_out, float* __restrict__ err_out,
    int P, int H, int W, int nb, int win, int iters, float eps2,
    float min_eig_threshold) {
    __shared__ float s_tpl[WARPS][MAX_GWIN * MAX_GWIN];

    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int p = blockIdx.x * WARPS + warp;
    if (p >= P) return;  // whole warp leaves; no block barrier follows

    const bool second = img_idx != nullptr && img_idx[p] != 0;
    const float* prev = second ? prev_b : prev_a;
    const float* next = second ? next_b : next_a;

    const int r = win / 2;
    const int gwin = win + 2;
    const int Hp = H + 2 * PAD;
    const int npix = win * win;
    float* T = s_tpl[warp];

    // --- template: resample the (gwin x gwin) window once -----------------
    const float ptpx = pts_prev[2 * p] + PAD;
    const float ptpy = pts_prev[2 * p + 1] + PAD;
    const int ty = gwin + 1;
    const int y0t = clampi(float_floor_to_int(ptpy) - gwin / 2, 0, Hp - ty);
    const int b0t = clampi(floordiv(float_floor_to_int(ptpx) - gwin / 2, 128), 0, nb - 2);
    const float offtx = ptpx - (float)(128 * b0t) - (float)(r + 1);
    const float offty = ptpy - (float)y0t - (float)(r + 1);
    for (int e = lane; e < gwin * gwin; e += 32) {
        const int i = e / gwin, j = e % gwin;
        T[e] = sample(prev, H, W, y0t, 128 * b0t, ty, 256, offty + (float)i,
                      offtx + (float)j);
    }
    __syncwarp();

    float I[MAX_SLOTS], Ix[MAX_SLOTS], Iy[MAX_SLOTS];
    float gxx = 0.0f, gxy = 0.0f, gyy = 0.0f;
#pragma unroll
    for (int s = 0; s < MAX_SLOTS; ++s) {
        const int q = lane + 32 * s;
        I[s] = Ix[s] = Iy[s] = 0.0f;
        if (q < npix) {
            const int i = q / win + 1, j = q % win + 1;
            I[s] = T[i * gwin + j];
            Ix[s] = (T[i * gwin + j + 1] - T[i * gwin + j - 1]) * 0.5f;
            Iy[s] = (T[(i + 1) * gwin + j] - T[(i - 1) * gwin + j]) * 0.5f;
            gxx += Ix[s] * Ix[s];
            gxy += Ix[s] * Iy[s];
            gyy += Iy[s] * Iy[s];
        }
    }
    gxx = warp_sum(gxx);
    gxy = warp_sum(gxy);
    gyy = warp_sum(gyy);
    const float det = gxx * gyy - gxy * gxy;
    const float half_tr = 0.5f * (gxx + gyy);
    const float disc = sqrtf(fmaxf(half_tr * half_tr - det, 0.0f));
    const float min_eig = (half_tr - disc) / (float)(win * win);
    const bool ok = min_eig > min_eig_threshold;
    const float det_safe = fabsf(det) > 1e-12f ? det : 1.0f;

    // --- moving window origin (fixed for the level) -----------------------
    const float g0x = guess_in[2 * p], g0y = guess_in[2 * p + 1];
    const float gpx = g0x + PAD, gpy = g0y + PAD;
    const int y0n = clampi(float_floor_to_int(gpy) - (NY / 2 - 1), 0, Hp - NY);
    const int b0n = clampi(floordiv(float_floor_to_int(gpx) - (NY / 2 - 5), 128), 0, nb - 2);
    const float offx0 = gpx - (float)(128 * b0n) - (float)r;
    const int nx0 = clampi(float_floor_to_int(offx0) - (NY / 2 - 8), 0, 256 - NY);
    const int wx = 128 * b0n + nx0;
    const float base_x = (float)wx, base_y = (float)y0n;

    // --- Newton loop: this feature's own early exit -----------------------
    float gx = g0x, gy = g0y;
    bool lost = false;
    bool converged = !ok;
    for (int it = 0; it < iters && !converged; ++it) {
        const float offx = (gx + PAD) - base_x - (float)r;
        const float offy = (gy + PAD) - base_y - (float)r;
        const bool in_marg = fabsf(gx - g0x) <= MAX_MOVE && fabsf(gy - g0y) <= MAX_MOVE;
        float bx = 0.0f, by = 0.0f;
#pragma unroll
        for (int s = 0; s < MAX_SLOTS; ++s) {
            const int q = lane + 32 * s;
            if (q < npix) {
                const float J = sample(next, H, W, y0n, wx, NY, NY,
                                       offy + (float)(q / win), offx + (float)(q % win));
                const float dI = I[s] - J;
                bx += dI * Ix[s];
                by += dI * Iy[s];
            }
        }
        bx = warp_sum(bx);
        by = warp_sum(by);
        const float nux = (gyy * bx - gxy * by) / det_safe;
        const float nuy = (gxx * by - gxy * bx) / det_safe;
        if (!in_marg) lost = true;
        if (in_marg) {
            gx = gx + nux;
            gy = gy + nuy;
        }
        converged = (nux * nux + nuy * nuy < eps2) || !in_marg;
    }

    // --- final residual: mean |I - J| over the window ---------------------
    const float offx = (gx + PAD) - base_x - (float)r;
    const float offy = (gy + PAD) - base_y - (float)r;
    float e = 0.0f;
#pragma unroll
    for (int s = 0; s < MAX_SLOTS; ++s) {
        const int q = lane + 32 * s;
        if (q < npix) {
            const float J = sample(next, H, W, y0n, wx, NY, NY,
                                   offy + (float)(q / win), offx + (float)(q % win));
            e += fabsf(I[s] - J);
        }
    }
    e = warp_sum(e);
    if (lane == 0) {
        guess_out[2 * p] = gx;
        guess_out[2 * p + 1] = gy;
        ok_out[p] = ok ? 1 : 0;
        lost_out[p] = lost ? 1 : 0;
        err_out[p] = e / (float)npix;
    }
}

}  // namespace

extern "C" int vio_lk_level(const float* prev_a, const float* prev_b,
                            const float* next_a, const float* next_b,
                            const int32_t* img_idx, const float* pts_prev,
                            const float* guess_in, float* guess_out,
                            uint8_t* ok_out, uint8_t* lost_out, float* err_out,
                            int P, int H, int W, int nb, int win, int iters,
                            float eps2, float min_eig_threshold, void* stream) {
    const int blocks = (P + WARPS - 1) / WARPS;
    lk_level_kernel<<<blocks, WARPS * 32, 0, (cudaStream_t)stream>>>(
        prev_a, prev_b, next_a, next_b, img_idx, pts_prev, guess_in, guess_out,
        ok_out, lost_out, err_out, P, H, W, nb, win, iters, eps2,
        min_eig_threshold);
    return (int)cudaGetLastError();
}

extern "C" const char* vio_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
