// FAST-9 corner score + threshold + border mask + 3x3 non-max suppression.
//
// Replaces the Pallas TPU kernel _fast_nms_kernel
// (vio_msckf_tpu/ops/fast_pallas.py:71, launched by fast_score_map_pallas).
// The plain PyTorch twin is vio_msckf_torch/ops/fast.py:fast_score_map.
//
// What bounds it on an H100: issued instructions. A 480x752 f32 frame is
// read once and the score map written once (2.9 MB, 0.86 us at 3.35 TB/s),
// but the full score costs ~190 subtractions, minima and maxima a pixel
// (1.0 us at 67 TFLOP/s, twice that at the min/max issue rate), and a
// kernel that scores every pixel spends most of its time there. The design
// scores fully only the pixels that can be corners:
//   - Compass reject. Every 9-arc of the 16-point circle holds two
//     neighbouring compass points k and k+4 (k = 0, 4, 8, 12). A pixel
//     whose four compass differences hold no such pair above the
//     threshold, in one polarity, scores <= threshold, and the twin writes
//     0 there; so skipping it is exact (ops/fast.py:fast_candidates is
//     the same rule in PyTorch). On a rendered frame at threshold 15 about
//     18 % of the pixels pass, but most 32-pixel row runs hold one, so
//     lanes branching on their own pixel would save little. Hence:
//   - Compaction. Each thread tests a vertical strip of 6 ring pixels,
//     reading its column once; one block-wide prefix sum places the
//     candidates in a list in shared memory, and the block then scores the
//     list densely. A candidate that passed in one polarity only needs
//     that polarity's arc score (the other is <= threshold, so the max is
//     the passing one whenever it is above it); candidates that passed in
//     both sit in a second list and get both.
//   - Staging. One block owns a 16 x 64 output tile and stages its
//     (16 + 8) x (64 + 8) image tile (3-px circle + 1-px NMS halo, 4 px in
//     x so that every row segment starts on a 16-byte boundary) with one
//     16-byte load a thread and step where the row pitch allows it, and
//     writes its outputs the same way. Out-of-image pixels read 0, the
//     Pallas canvas's zero padding.
//   - Grid. 12 x 30 = 360 blocks of 256 threads for one 480x752 image:
//     one wave of at most 3 blocks an SM on 132 SMs. A stack of B images
//     (one per sequence) is the grid's third dimension: block (x, y, b)
//     reads and writes plane b, at img + b*H*W.
// Bit-exact against the twin: only subtractions (neighbour - centre, in
// that order), negation, min and max are involved, NMS keeps ">=", and
// the border mask zeroes every pixel whose circle or NMS window leaves the
// image.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int TW = 64;                     // output tile width
constexpr int TH = 16;                     // output tile height
constexpr int HALO = 4;                    // 3 (circle) + 1 (NMS)
constexpr int SW = TW + 2 * HALO;          // staged image tile
constexpr int SH = TH + 2 * HALO;
constexpr int RW = TW + 2;                 // score ring: tile + 1 px
constexpr int RH = TH + 2;
constexpr int RN = RW * RH;
constexpr int NT = 256;                    // threads a block
constexpr int BORDER = 3;
constexpr int POS = 1 << 12;               // list entry: ring index | POS
constexpr int SR = 6;                      // rows of a compass-test strip
constexpr int NSTRIP = RH / SR;

static_assert(RN < POS, "ring index must fit below the polarity bit");
static_assert(TH * TW == 4 * NT, "one float4 of outputs a thread");
static_assert(RH % SR == 0 && RW * NSTRIP <= NT, "one strip a thread");

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

// Two neighbouring compass points both above t.
__device__ __forceinline__ bool pair_above(float n, float e, float s, float w, float t) {
    return (n > t && e > t) || (e > t && s > t) || (s > t && w > t) || (w > t && n > t);
}

// VEC: every row of every plane starts on a 16-byte boundary (W % 4 == 0,
// aligned pointers), so the staging and the output use float4.
template <bool VEC>
__global__ void __launch_bounds__(NT) fast_nms_kernel(const float* __restrict__ img,
                                                      float* __restrict__ out,
                                                      int H, int W, float threshold) {
    const size_t plane = (size_t)blockIdx.z * H * W;
    img += plane;
    out += plane;
    __shared__ __align__(16) float s_img[SH][SW];
    __shared__ float s_score[RN];
    __shared__ uint16_t s_list[RN];
    __shared__ int s_warp[NT / 32];

    const int x0 = blockIdx.x * TW;
    const int y0 = blockIdx.y * TH;
    const int tid = threadIdx.x;
    const int lane = tid & 31;

    if (VEC) {
        constexpr int Q = SW / 4;
        for (int i = tid; i < SH * Q; i += NT) {
            const int ly = i / Q, lq = i - ly * Q;
            const int gy = y0 - HALO + ly, gx = x0 - HALO + 4 * lq;
            float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
            if (gy >= 0 && gy < H && gx >= 0 && gx < W)
                v = __ldg(reinterpret_cast<const float4*>(img + (size_t)gy * W + gx));
            *reinterpret_cast<float4*>(&s_img[ly][4 * lq]) = v;
        }
    } else {
        for (int i = tid; i < SH * SW; i += NT) {
            const int ly = i / SW, lx = i - ly * SW;
            const int gy = y0 - HALO + ly, gx = x0 - HALO + lx;
            s_img[ly][lx] = (gy >= 0 && gy < H && gx >= 0 && gx < W)
                                ? __ldg(img + (size_t)gy * W + gx) : 0.0f;
        }
    }
    __syncthreads();

    // Compass test over the ring by vertical strips: thread t < RW * NSTRIP
    // owns ring column c = t % RW, rows SR * (t / RW) .. + SR - 1. Ring
    // pixel (sy, sx) is image pixel (y0 - 1 + sy, x0 - 1 + sx), staged at
    // s_img[sy + 3][sx + 3]. Rejected pixels score 0 now; candidates go to
    // s_list: one-polarity ones from the front (with their polarity),
    // two-polarity ones from the back.
    unsigned pos_bits = 0, neg_bits = 0;
    const int c = tid % RW, r0 = SR * (tid / RW);
    if (tid < RW * NSTRIP) {
        const int gx = x0 - 1 + c;
        const bool in_x = gx >= BORDER && gx < W - BORDER;
        float v[SR + 6];
#pragma unroll
        for (int k = 0; k < SR + 6; ++k) v[k] = s_img[r0 + k][c + 3];
#pragma unroll
        for (int j = 0; j < SR; ++j) {
            const int sy = r0 + j, gy = y0 - 1 + sy;
            bool pos = false, neg = false;
            if (in_x && gy >= BORDER && gy < H - BORDER) {
                const float cc = v[j + 3];
                const float n = v[j] - cc, s = v[j + 6] - cc;
                const float e = s_img[sy + 3][c + 6] - cc, w = s_img[sy + 3][c] - cc;
                pos = pair_above(n, e, s, w, threshold);
                neg = pair_above(-n, -e, -s, -w, threshold);
            }
            pos_bits |= (unsigned)pos << j;
            neg_bits |= (unsigned)neg << j;
            if (!pos && !neg) s_score[sy * RW + c] = 0.0f;
        }
    }
    // Block-wide exclusive scan of one-polarity | two-polarity << 16 counts.
    const unsigned one_bits = pos_bits ^ neg_bits, both_bits = pos_bits & neg_bits;
    const int mine = __popc(one_bits) | (__popc(both_bits) << 16);
    int incl = mine;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += t;
    }
    if (lane == 31) s_warp[tid >> 5] = incl;
    __syncthreads();
    int before = incl - mine, total = 0;
#pragma unroll
    for (int w = 0; w < NT / 32; ++w) {
        const int t = s_warp[w];
        before += w < (tid >> 5) ? t : 0;
        total += t;
    }
    int at_one = before & 0xffff, at_both = before >> 16;
#pragma unroll
    for (int j = 0; j < SR; ++j) {
        const int i = (r0 + j) * RW + c;
        if ((one_bits >> j) & 1) s_list[at_one++] = (uint16_t)(i | (((pos_bits >> j) & 1) ? POS : 0));
        if ((both_bits >> j) & 1) s_list[RN - 1 - at_both++] = (uint16_t)i;
    }
    __syncthreads();

    // Full score of the candidates, densely.
    const int n_one = total & 0xffff, n_cand = n_one + (total >> 16);
    for (int j = tid; j < n_cand; j += NT) {
        const bool both = j >= n_one;
        const int entry = both ? s_list[RN - 1 - (j - n_one)] : s_list[j];
        const int i = entry & (POS - 1);
        const bool pos = both || (entry & POS);
        const int sy = i / RW, sx = i - sy * RW;
        const float* p = &s_img[sy + 3][sx + 3];
        const float c = p[0];
        float d[16];
#pragma unroll
        for (int k = 0; k < 16; ++k) {
            const float v = p[circle_dy(k) * SW + circle_dx(k)] - c;
            d[k] = pos ? v : -v;
        }
        float score = arc9(d);
        if (both) {
#pragma unroll
            for (int k = 0; k < 16; ++k) d[k] = -d[k];
            score = fmaxf(score, arc9(d));
        }
        s_score[i] = score > threshold ? score : 0.0f;
    }
    __syncthreads();

    // 3x3 NMS: thread t owns the 4 pixels (ty, 4 qx .. 4 qx + 3).
    const int ty = tid / (TW / 4), qx = tid - ty * (TW / 4);
    const int gy = y0 + ty, gx = x0 + 4 * qx;
    if (gy >= H || gx >= W) return;
    float r[4] = {0.f, 0.f, 0.f, 0.f};
    if (n_cand > 0) {
        // Ring rows ty .. ty + 2, ring columns 4 qx .. 4 qx + 5.
        float up[6], mid[6], down[6], col[6];
#pragma unroll
        for (int c = 0; c < 6; ++c) {
            const float* q = &s_score[ty * RW + 4 * qx + c];
            up[c] = q[0];
            mid[c] = q[RW];
            down[c] = q[2 * RW];
            col[c] = fmaxf(fmaxf(up[c], mid[c]), down[c]);
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            const float nmax = fmaxf(fmaxf(col[k], col[k + 2]), fmaxf(up[k + 1], down[k + 1]));
            r[k] = mid[k + 1] >= nmax ? mid[k + 1] : 0.0f;
        }
    }
    float* o = out + (size_t)gy * W + gx;
    if (VEC) {
        *reinterpret_cast<float4*>(o) = make_float4(r[0], r[1], r[2], r[3]);
    } else {
#pragma unroll
        for (int k = 0; k < 4; ++k)
            if (gx + k < W) o[k] = r[k];
    }
}

}  // namespace

// img, out: (B, H, W) f32, contiguous.
extern "C" int vio_fast_nms(const float* img, float* out, int B, int H, int W,
                            float threshold, void* stream) {
    if (B < 1 || B > 65535) return (int)cudaErrorInvalidValue;
    const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
    // Plane b starts at b*H*W floats: aligned for every b iff plane 0 is
    // and H*W is a multiple of 4 (always so when W is).
    const bool vec = W % 4 == 0 && ((size_t)H * W) % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(img) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(out) % 16 == 0;
    cudaStream_t s = (cudaStream_t)stream;
    if (vec)
        fast_nms_kernel<true><<<grid, NT, 0, s>>>(img, out, H, W, threshold);
    else
        fast_nms_kernel<false><<<grid, NT, 0, s>>>(img, out, H, W, threshold);
    return (int)cudaGetLastError();
}
