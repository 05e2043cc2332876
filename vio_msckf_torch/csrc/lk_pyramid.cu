// Pyramidal Lucas-Kanade tracking: the whole level walk of P features in
// one launch.
//
// Replaces the Pallas TPU kernel _lk_level_kernel
// (vio_msckf_tpu/ops/klt_pallas.py:63, launched by _track_level_pallas_flat
// once per level) together with the level loop around it
// (vio_msckf_tpu/ops/klt.py:pyramidal_lk), with the semantics of the XLA
// level (vio_msckf_tpu/ops/klt.py:_track_level, backend "xla"). The plain
// PyTorch twin is vio_msckf_torch/ops/klt.py:track_pyramid_plain.
//
// What bounds it on an H100: latency. A level moves ~1 us worth of bytes
// and far fewer flops; what costs is each feature's chain of up to 30
// dependent Newton iterations per level, each a 15x15 bilinear resample and
// two warp reductions. The design shortens that chain and drops the
// launches between levels:
//   - one warp per feature and one feature per CTA, so P = 128..356
//     features spread over as many of the 132 SMs as there are features;
//   - B sequences share the launch: the level images are (B, H_l, W_l)
//     stacks, feature p belongs to sequence p / P_seq and reads its plane
//     at + (p / P_seq) * H_l * W_l, so a batch only adds CTAs;
//   - levels L..0 run inside the kernel, the guess carried in registers,
//     doubled between levels, each feature with its own early exit;
//   - at each level the feature's moving window (48x48, fixed for the
//     level) and its template patch (18x18) are staged in shared memory
//     once, with cp.async from clamped (edge-padded) addresses, and every
//     Newton iteration reads shared memory only;
//   - every tap of one resample shares one fractional offset, so the
//     bilinear weights are computed once per iteration, not per tap.
//
// Window semantics kept from the XLA path: that path samples only from a
// gathered patch -- template rows [y0t, y0t+18) x columns [128*b0t,
// 128*b0t+256) of the edge-padded (pad 16) image, moving rows [y0n, y0n+48)
// x columns [128*b0n+nx0, +48) -- and a bilinear tap outside its patch gets
// zero weight. A zero-weight tap adds exactly what a zero value adds
// (w * 0 = +0 for the finite weights in [0, 1]), so the staged tiles hold 0
// there: the template patch where its tap leaves the template window, and a
// one-pixel zero ring around the moving window, onto which every tap
// outside the window is clamped. Products and sums keep the order of the
// twin's _bilinear; built with --fmad=false so they round as the twin's do.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int PAD = 16;
constexpr int NY = 48;
constexpr int TW = NY + 2;         // staged moving window with its zero ring
constexpr float MAX_MOVE = 12.0f;
constexpr int MAX_WIN = 15;
constexpr int MAX_GWIN = MAX_WIN + 2;
constexpr int MAX_PATCH = MAX_GWIN + 1;
constexpr int MAX_SLOTS = (MAX_WIN * MAX_WIN + 31) / 32;
constexpr int MAX_LEVELS = 8;

}  // namespace

// Level images of one call, passed by value: each pointer is a (B, H, W)
// stack, plane b for sequence b. Within each sequence's block of P_seq
// features, pair 0 tracks features [0, n_first), pair 1 the rest
// (lk_verify's two image pairs).
struct LKPyramid {
    const float* prev[2][MAX_LEVELS];
    const float* next[2][MAX_LEVELS];
    int H[MAX_LEVELS];
    int W[MAX_LEVELS];
    int run[MAX_LEVELS];  // 1: track this level; 0: only rescale the guess
    int levels;           // levels - 1 is the coarsest
};

namespace {

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

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Bilinear weights of one sampling offset: all taps of a resample share
// them. Same expressions as the twin's per-tap weights.
struct Taps {
    int i0;
    float w0, w1;
};

__device__ __forceinline__ Taps taps(float pos) {
    const float f = floorf(pos);
    return Taps{float_floor_to_int(pos), 1.0f - fabsf(pos - f),
                1.0f - fabsf(pos - (f + 1.0f))};
}

// One bilinear sample from a staged tile, given the flat indices of its
// four taps (row y, column x: a_yx).
__device__ __forceinline__ float bilerp(const float* t, int a00, int a10,
                                        int a01, int a11, const Taps& ty,
                                        const Taps& tx) {
    const float t0 = ty.w0 * t[a00] + ty.w1 * t[a10];
    const float t1 = ty.w0 * t[a01] + ty.w1 * t[a11];
    return tx.w0 * t0 + tx.w1 * t1;
}

// Bilinear resample of the staged moving window at window offset (ox, oy),
// one sample per slot. A staged index is the window index + 1, clamped
// onto the zero ring.
__device__ __forceinline__ void resample(const float* s_win,
                                         const int (&qi)[MAX_SLOTS],
                                         const int (&qj)[MAX_SLOTS], float ox,
                                         float oy, float (&J)[MAX_SLOTS]) {
    const Taps ty = taps(oy), tx = taps(ox);
#pragma unroll
    for (int s = 0; s < MAX_SLOTS; ++s) {
        const int r0 = clampi(ty.i0 + qi[s], -1, NY) + 1;
        const int r1 = clampi(ty.i0 + qi[s] + 1, -1, NY) + 1;
        const int c0 = clampi(tx.i0 + qj[s], -1, NY) + 1;
        const int c1 = clampi(tx.i0 + qj[s] + 1, -1, NY) + 1;
        J[s] = bilerp(s_win, r0 * TW + c0, r1 * TW + c0, r0 * TW + c1,
                      r1 * TW + c1, ty, tx);
    }
}

__global__ void __launch_bounds__(32) lk_pyramid_kernel(
    const LKPyramid pyr, const float* __restrict__ pts_prev,
    const float* __restrict__ pts_init, float* __restrict__ pts_out,
    uint8_t* __restrict__ status_out, float* __restrict__ err_out,
    int32_t* __restrict__ iters_out, int P, int P_seq, int n_first, int win,
    int iters, float eps2, float min_eig_threshold) {
    __shared__ float s_win[TW * TW];
    __shared__ float s_patch[MAX_PATCH * MAX_PATCH];
    __shared__ float s_tpl[MAX_GWIN * MAX_GWIN];

    const int p = blockIdx.x;
    const int lane = threadIdx.x;
    if (p >= P) return;
    const int seq = p / P_seq;
    const int pair = p - seq * P_seq >= n_first ? 1 : 0;

    const int r = win / 2;
    const int gwin = win + 2;
    const int np = gwin + 1;  // template patch side
    const int npix = win * win;

    // The zero ring of the moving window; staging never writes it.
    for (int e = lane; e < TW; e += 32) {
        s_win[e] = 0.0f;
        s_win[(TW - 1) * TW + e] = 0.0f;
        s_win[e * TW] = 0.0f;
        s_win[e * TW + TW - 1] = 0.0f;
    }

    // Each slot's pixel (row, column) in the win x win resample, fixed for
    // the call; a slot past the last pixel reads pixel 0 and is masked out
    // of every sum.
    int qi[MAX_SLOTS], qj[MAX_SLOTS];
#pragma unroll
    for (int s = 0; s < MAX_SLOTS; ++s) {
        const int q = lane + 32 * s < npix ? lane + 32 * s : 0;
        qi[s] = q / win;
        qj[s] = q % win;
    }

    const float px0 = pts_prev[2 * p], py0 = pts_prev[2 * p + 1];
    float scale = 1.0f;
    for (int l = 0; l < pyr.levels - 1; ++l) scale *= 0.5f;
    float gx = pts_init[2 * p] * scale, gy = pts_init[2 * p + 1] * scale;
    bool status = true;
    float err = 0.0f;
    int total_iters = 0;

    for (int lvl = pyr.levels - 1; lvl >= 0; --lvl) {
        if (pyr.run[lvl]) {
            const int H = pyr.H[lvl], W = pyr.W[lvl];
            const int Hp = H + 2 * PAD;
            const int nb = max(2, (W + 2 * PAD + 127) / 128);
            const size_t plane = (size_t)seq * H * W;
            const float* prev = pyr.prev[pair][lvl] + plane;
            const float* next = pyr.next[pair][lvl] + plane;
            float lscale = 1.0f;
            for (int l = 0; l < lvl; ++l) lscale *= 0.5f;

            // --- window origins (padded coordinates), as the twin's _windows
            const float ptpx = px0 * lscale + PAD, ptpy = py0 * lscale + PAD;
            const int y0t = clampi(float_floor_to_int(ptpy) - gwin / 2, 0, Hp - (gwin + 1));
            const int x0t = 128 * clampi(floordiv(float_floor_to_int(ptpx) - gwin / 2, 128),
                                         0, nb - 2);
            const float offtx = ptpx - (float)x0t - (float)(r + 1);
            const float offty = ptpy - (float)y0t - (float)(r + 1);
            const float g0x = gx, g0y = gy;
            const float gpx = g0x + PAD, gpy = g0y + PAD;
            const int y0n = clampi(float_floor_to_int(gpy) - (NY / 2 - 1), 0, Hp - NY);
            const int b0n = clampi(floordiv(float_floor_to_int(gpx) - (NY / 2 - 5), 128),
                                   0, nb - 2);
            const float offx0 = gpx - (float)(128 * b0n) - (float)r;
            const int nx0 = clampi(float_floor_to_int(offx0) - (NY / 2 - 8), 0, 256 - NY);
            const int wx = 128 * b0n + nx0;

            __syncwarp();  // the previous level is done with the tiles

            // --- stage the template patch (group 0), then the window (1) ---
            const Taps tty = taps(offty), ttx = taps(offtx);
            for (int e = lane; e < np * np; e += 32) {
                const int i = e / np, j = e % np;
                const int wy_ = tty.i0 + i, wx_ = ttx.i0 + j;  // template-window coords
                if (wy_ >= 0 && wy_ < gwin + 1 && wx_ >= 0 && wx_ < 256) {
                    const int y = clampi(y0t + wy_ - PAD, 0, H - 1);
                    const int x = clampi(x0t + wx_ - PAD, 0, W - 1);
                    cp_async4(&s_patch[e], prev + (size_t)y * W + x);
                } else {
                    s_patch[e] = 0.0f;
                }
            }
            cp_async_commit();
            const int xa = clampi(wx + lane - PAD, 0, W - 1);
            const int xb = clampi(wx + lane + 32 - PAD, 0, W - 1);
            for (int i = 0; i < NY; ++i) {
                const float* row = next + (size_t)clampi(y0n + i - PAD, 0, H - 1) * W;
                float* dst = s_win + (i + 1) * TW + 1;
                cp_async4(dst + lane, row + xa);
                if (lane < NY - 32) cp_async4(dst + lane + 32, row + xb);
            }
            cp_async_commit();

            // --- template and its gradients, while the window streams in --
            cp_async_wait<1>();
            __syncwarp();
            for (int e = lane; e < gwin * gwin; e += 32) {
                const int i = e / gwin, j = e % gwin;
                const int a = i * np + j;
                s_tpl[e] = bilerp(s_patch, a, a + np, a + 1, a + np + 1, tty, ttx);
            }
            __syncwarp();

            float I[MAX_SLOTS], Ix[MAX_SLOTS], Iy[MAX_SLOTS];
            float gxx = 0.0f, gxy = 0.0f, gyy = 0.0f;
#pragma unroll
            for (int s = 0; s < MAX_SLOTS; ++s) {
                I[s] = Ix[s] = Iy[s] = 0.0f;
                if (lane + 32 * s < npix) {
                    const int c = (qi[s] + 1) * gwin + qj[s] + 1;
                    I[s] = s_tpl[c];
                    Ix[s] = (s_tpl[c + 1] - s_tpl[c - 1]) * 0.5f;
                    Iy[s] = (s_tpl[c + gwin] - s_tpl[c - gwin]) * 0.5f;
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

            cp_async_wait<0>();
            __syncwarp();

            const float base_x = (float)wx, base_y = (float)y0n;

            // --- Newton loop: this feature's own early exit ---------------
            bool lost = false;
            bool converged = !ok;
            int it = 0;
            for (; it < iters && !converged; ++it) {
                const bool in_marg = fabsf(gx - g0x) <= MAX_MOVE && fabsf(gy - g0y) <= MAX_MOVE;
                float J[MAX_SLOTS];
                resample(s_win, qi, qj, (gx + PAD) - base_x - (float)r,
                         (gy + PAD) - base_y - (float)r, J);
                float bx = 0.0f, by = 0.0f;
#pragma unroll
                for (int s = 0; s < MAX_SLOTS; ++s) {
                    if (lane + 32 * s < npix) {
                        const float dI = I[s] - J[s];
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
            total_iters += it;

            // --- final residual: mean |I - J| over the window -------------
            float J[MAX_SLOTS];
            resample(s_win, qi, qj, (gx + PAD) - base_x - (float)r,
                     (gy + PAD) - base_y - (float)r, J);
            float e = 0.0f;
#pragma unroll
            for (int s = 0; s < MAX_SLOTS; ++s)
                if (lane + 32 * s < npix) e += fabsf(I[s] - J[s]);
            err = warp_sum(e) / (float)npix;

            status = status && !lost;
            if (lvl == 0) status = status && ok;
        }
        if (lvl != 0) {
            gx = gx * 2.0f;
            gy = gy * 2.0f;
        }
    }

    if (lane == 0) {
        const float Wm = (float)(pyr.W[0] - 1), Hm = (float)(pyr.H[0] - 1);
        const bool inside = gx >= 0.0f && gx <= Wm && gy >= 0.0f && gy <= Hm;
        pts_out[2 * p] = gx;
        pts_out[2 * p + 1] = gy;
        status_out[p] = (status && inside) ? 1 : 0;
        err_out[p] = err;
        iters_out[p] = total_iters;
    }
}

}  // namespace

// pts_prev, pts_init, pts_out (P, 2) f32; status_out (P,) bool; err_out
// (P,) f32; iters_out (P,) int32 (Newton iterations summed over levels).
// P = B * P_seq features, sequence-major.
extern "C" int vio_lk_pyramid(const LKPyramid* pyr, const float* pts_prev,
                              const float* pts_init, float* pts_out,
                              uint8_t* status_out, float* err_out,
                              int32_t* iters_out, int P, int P_seq, int n_first,
                              int win, int iters, float eps2,
                              float min_eig_threshold, void* stream) {
    if (win % 2 != 1 || win > MAX_WIN || pyr->levels < 1 || pyr->levels > MAX_LEVELS ||
        P_seq < 1 || P % P_seq != 0)
        return (int)cudaErrorInvalidValue;
    lk_pyramid_kernel<<<P, 32, 0, (cudaStream_t)stream>>>(
        *pyr, pts_prev, pts_init, pts_out, status_out, err_out, iters_out, P,
        P_seq, n_first, win, iters, eps2, min_eig_threshold);
    return (int)cudaGetLastError();
}

extern "C" const char* vio_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
