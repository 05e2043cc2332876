// Batched SPD solve X = B^-1 R by unpivoted Gauss-Jordan on [B | R].
//
// Replaces the Pallas TPU kernel _gj_kernel
// (vio_msckf_tpu/ops/spd_pallas.py:47, launched by _spd_solve_flat). The
// plain PyTorch twin is vio_msckf_torch/ops/spd.py:spd_solve_plain (a
// Cholesky solve, what the JAX package runs off-TPU).
//
// What bounds it on an H100: latency, not FLOPs or bytes. The chi-square
// gate solves F=128 systems of m=80 with k=4 right-hand sides (lost path)
// and F=160 systems of m=8 (prune path) per frame: ~1 us of bytes and
// less of flops, while each solve is a chain of m dependent rank-1
// updates. So the design cuts the time of one pivot step:
//   - m > 8 (gj_block): one CTA of 16 x 16 threads per system. Thread
//     (tr, tc) owns rows tr + 16a and columns tc + 16b of [B | R] in
//     registers, a layout fixed at compile time, so the loop has no index
//     division and no shared-memory read-modify-write. In a pivot step the
//     owners of column i and of row i publish them to shared memory, one
//     barrier follows, and every thread updates its trailing columns. The
//     column/row buffers are double-buffered, so the next step's writes
//     cannot race this step's reads.
//   - m <= 8 (gj_warp): one warp per system, the 8 x 12 augmented system in
//     registers (3 entries a lane); pivots, pivot rows and pivot columns
//     travel by __shfl_sync. No shared memory, no block barrier.
//   - A pivot whose row and column of B are zero off the diagonal (the
//     s*I padding rows of the gate's systems) is skipped: such a step
//     changes nothing but its own row's scale, which is applied at the end
//     as the step would have (x * (1 / b_ii)). Exact for any B whose
//     pivots are finite and nonzero, as an SPD B's are.
// Columns left of the pivot never feed the right-hand block again, so
// they are not updated. Every product and difference rounds on its own
// (built with --fmad=false).
//
// No pivoting: B = H P H^T + s I is symmetric positive definite, where
// elimination without pivoting is backward stable. On an indefinite B the
// result is finite but wrong, where the Cholesky twin returns NaN; the
// filter only ever builds SPD systems.

#include <cuda_runtime.h>

#include <utility>

namespace {

constexpr int T = 16;  // gj_block: a T x T thread grid per system

// Pivot steps i = T * b + c, c = 0..T-1, of column group b. b is a
// template parameter so that every register index below is a constant.
template <int RA, int CB, int b>
__device__ __forceinline__ void pivot_group(float (&A)[RA][CB], float (*s_col)[RA * T],
                                            float (*s_row)[CB * T], const int* s_live,
                                            int m, int tr, int tc, int& step) {
#pragma unroll 1
    for (int c = 0; c < T; ++c) {
        const int i = T * b + c;
        if (i >= m) break;
        if (!s_live[i]) continue;
        float* col = s_col[step & 1];
        float* row = s_row[step & 1];
        if (tc == c) {
#pragma unroll
            for (int a = 0; a < RA; ++a) col[tr + T * a] = A[a][b];
        }
        if (tr == c) {
#pragma unroll
            for (int bb = 0; bb < CB; ++bb) row[tc + T * bb] = A[b][bb];
        }
        __syncthreads();
        const float inv = 1.0f / col[i];
        float cr[RA];
#pragma unroll
        for (int a = 0; a < RA; ++a) cr[a] = col[tr + T * a];
#pragma unroll
        for (int bb = b; bb < CB; ++bb) {
            if (bb == b && tc <= c) continue;  // columns <= i
            const float rs = row[tc + T * bb] * inv;
#pragma unroll
            for (int a = 0; a < RA; ++a) {
                if (a == b)  // row group of the pivot: row i itself takes rs
                    A[a][bb] = tr == c ? rs : A[a][bb] - cr[a] * rs;
                else
                    A[a][bb] = A[a][bb] - cr[a] * rs;
            }
        }
        ++step;
    }
}

template <int RA, int CB, int... Bs>
__device__ __forceinline__ void pivot_groups(float (&A)[RA][CB], float (*s_col)[RA * T],
                                             float (*s_row)[CB * T], const int* s_live,
                                             int m, int tr, int tc, int& step,
                                             std::integer_sequence<int, Bs...>) {
    (pivot_group<RA, CB, Bs>(A, s_col, s_row, s_live, m, tr, tc, step), ...);
}

template <int RA, int CB>
__global__ void __launch_bounds__(T * T, 1) gj_block(const float* __restrict__ B,
                                                 const float* __restrict__ R,
                                                 float* __restrict__ X, int m,
                                                 int k) {
    __shared__ float s_col[2][RA * T];
    __shared__ float s_row[2][CB * T];
    __shared__ float s_diag[RA * T];
    __shared__ int s_live[RA * T];  // pivot i has an off-diagonal nonzero

    const int f = blockIdx.x;
    const int tc = threadIdx.x % T, tr = threadIdx.x / T;
    const int w = m + k;
    const float* Bf = B + (size_t)f * m * m;
    const float* Rf = R + (size_t)f * m * k;

    if (threadIdx.x < RA * T) s_live[threadIdx.x] = 0;
    float A[RA][CB];
#pragma unroll
    for (int a = 0; a < RA; ++a) {
        const int row = tr + T * a;
#pragma unroll
        for (int b = 0; b < CB; ++b) {
            const int col = tc + T * b;
            float v = 0.0f;
            if (row < m && col < m) v = Bf[row * m + col];
            else if (row < m && col < w) v = Rf[row * k + (col - m)];
            A[a][b] = v;
        }
    }
    __syncthreads();
#pragma unroll
    for (int a = 0; a < RA; ++a) {
        const int row = tr + T * a;
#pragma unroll
        for (int b = 0; b < CB; ++b) {
            const int col = tc + T * b;
            if (row == col) s_diag[row] = A[a][b];
            else if (col < m && A[a][b] != 0.0f) s_live[row] = s_live[col] = 1;
        }
    }
    __syncthreads();

    int step = 0;
    pivot_groups<RA, CB>(A, s_col, s_row, s_live, m, tr, tc, step,
                         std::make_integer_sequence<int, RA>{});

    float* Xf = X + (size_t)f * m * k;
#pragma unroll
    for (int a = 0; a < RA; ++a) {
        const int r = tr + T * a;
#pragma unroll
        for (int b = 0; b < CB; ++b) {
            const int col = tc + T * b;
            if (r < m && col >= m && col < w)
                Xf[r * k + (col - m)] = s_live[r] ? A[a][b] : A[a][b] * (1.0f / s_diag[r]);
        }
    }
}

constexpr int WM = 8;       // gj_warp: rows
constexpr int WC = 12;      // gj_warp: columns of [B | R]
constexpr int WARPS = 4;    // gj_warp: systems per CTA

__global__ void __launch_bounds__(32 * WARPS) gj_warp(const float* __restrict__ B,
                                                    const float* __restrict__ R,
                                                    float* __restrict__ X, int F,
                                                    int m, int k) {
    const int f = blockIdx.x * WARPS + threadIdx.x / 32;
    if (f >= F) return;  // whole warp leaves; no block barrier follows
    const int lane = threadIdx.x % 32;
    const int r = lane / 4;     // this lane's row
    const int c0 = lane % 4;    // its columns: c0, c0 + 4, c0 + 8
    const int w = m + k;
    const float* Bf = B + (size_t)f * m * m;
    const float* Rf = R + (size_t)f * m * k;

    float A[WC / 4];
#pragma unroll
    for (int j = 0; j < WC / 4; ++j) {
        const int col = c0 + 4 * j;
        float v = 0.0f;
        if (r < m && col < m) v = Bf[r * m + col];
        else if (r < m && col < w) v = Rf[r * k + (col - m)];
        A[j] = v;
    }

#pragma unroll
    for (int i = 0; i < WM; ++i) {
        if (i >= m) break;
        // Element (row, col) lives in lane 4 * row + col % 4, register col / 4.
        const float piv = __shfl_sync(0xffffffffu, A[i / 4], 4 * i + i % 4);
        const float cr = __shfl_sync(0xffffffffu, A[i / 4], 4 * r + i % 4);
        float rv[WC / 4];
#pragma unroll
        for (int j = 0; j < WC / 4; ++j) rv[j] = __shfl_sync(0xffffffffu, A[j], 4 * i + c0);
        const float inv = 1.0f / piv;
#pragma unroll
        for (int j = 0; j < WC / 4; ++j) {
            if (c0 + 4 * j <= i) continue;  // columns <= i
            const float rs = rv[j] * inv;
            A[j] = (r == i) ? rs : A[j] - cr * rs;
        }
    }

    float* Xf = X + (size_t)f * m * k;
#pragma unroll
    for (int j = 0; j < WC / 4; ++j) {
        const int col = c0 + 4 * j;
        if (r < m && col >= m && col < w) Xf[r * k + (col - m)] = A[j];
    }
}

}  // namespace

// B (F, m, m), R (F, m, k), X (F, m, k), all contiguous f32. Takes m + k
// <= 12 with m <= 8 (one warp a system), or m <= 80 with m + k <= 96, or
// m <= 128 with m + k <= 144 (one CTA a system); other shapes return
// cudaErrorInvalidValue.
extern "C" int vio_spd_gj(const float* B, const float* R, float* X, int F,
                          int m, int k, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (m <= WM && m + k <= WC) {
        gj_warp<<<(F + WARPS - 1) / WARPS, 32 * WARPS, 0, s>>>(B, R, X, F, m, k);
    } else if (m <= 5 * T && m + k <= 6 * T) {
        gj_block<5, 6><<<F, T * T, 0, s>>>(B, R, X, m, k);
    } else if (m <= 8 * T && m + k <= 9 * T) {
        gj_block<8, 9><<<F, T * T, 0, s>>>(B, R, X, m, k);
    } else {
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}
