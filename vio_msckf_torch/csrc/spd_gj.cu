// Batched SPD solve X = B^-1 R by unpivoted Gauss-Jordan on [B | R].
//
// Replaces the Pallas TPU kernel _gj_kernel
// (vio_msckf_tpu/ops/spd_pallas.py:47, launched by _spd_solve_flat). The
// plain PyTorch twin is vio_msckf_torch/ops/spd.py:spd_solve_plain (a
// Cholesky solve, what the JAX package runs off-TPU).
//
// What bounds it on an H100: latency, not FLOPs or bytes. The chi-square
// gate solves F=128 systems of m=80 with k=4 right-hand sides (lost path,
// ~0.3 MFLOP each) and F=160 systems of m=8 (prune path) per frame: far
// too little work to fill 132 SMs for long, and each solve is a chain of m
// dependent rank-1 updates. The design keeps a whole system resident in
// shared memory (80 x 84 x 4 B = 27 KB), gives one CTA to each m=80 system
// so all of them run concurrently, and packs several small systems into
// one CTA (one 32-thread group each) so the m=8 launch is a handful of
// CTAs. Each pivot step is two barriers: stage the pivot column and the
// scaled pivot row, then update the trailing columns. Columns left of the
// pivot never feed the right-hand block again, so they are not updated.
//
// No pivoting: B = H P H^T + s I is symmetric positive definite, where
// elimination without pivoting is backward stable. On an indefinite B the
// result is finite but wrong, where the Cholesky twin returns NaN; the
// filter only ever builds SPD systems.

#include <cuda_runtime.h>

namespace {

__global__ void spd_gj_kernel(const float* __restrict__ B,
                              const float* __restrict__ R,
                              float* __restrict__ X,
                              int F, int m, int k, int spb) {
    extern __shared__ float smem[];
    const int w = m + k;
    const int tps = blockDim.x / spb;            // threads per system
    const int sys = threadIdx.x / tps;
    const int lt = threadIdx.x % tps;
    const int f = blockIdx.x * spb + sys;
    const bool live = f < F;

    float* aug = smem + (size_t)sys * (m * w + m + w);
    float* col = aug + m * w;
    float* row = col + m;

    if (live) {
        const float* Bf = B + (size_t)f * m * m;
        const float* Rf = R + (size_t)f * m * k;
        for (int e = lt; e < m * w; e += tps) {
            const int r = e / w, c = e % w;
            aug[e] = c < m ? Bf[r * m + c] : Rf[r * k + (c - m)];
        }
    }
    __syncthreads();

    for (int i = 0; i < m; ++i) {
        if (live) {
            const float inv = 1.0f / aug[i * w + i];
            for (int r = lt; r < m; r += tps) col[r] = aug[r * w + i];
            for (int c = i + 1 + lt; c < w; c += tps) row[c] = aug[i * w + c] * inv;
        }
        __syncthreads();
        if (live) {
            const int nc = w - (i + 1);
            for (int e = lt; e < m * nc; e += tps) {
                const int r = e / nc, c = i + 1 + e % nc;
                aug[r * w + c] = (r == i) ? row[c] : aug[r * w + c] - col[r] * row[c];
            }
        }
        __syncthreads();
    }

    if (live) {
        float* Xf = X + (size_t)f * m * k;
        for (int e = lt; e < m * k; e += tps) {
            const int r = e / k, c = e % k;
            Xf[e] = aug[r * w + m + c];
        }
    }
}

}  // namespace

// B (F, m, m), R (F, m, k), X (F, m, k), all contiguous f32. `spb` systems
// share one CTA of `threads` threads (threads % spb == 0).
extern "C" int vio_spd_gj(const float* B, const float* R, float* X, int F,
                          int m, int k, int spb, int threads, void* stream) {
    const size_t smem = (size_t)spb * (m * (m + k) + m + (m + k)) * sizeof(float);
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            spd_gj_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    const int blocks = (F + spb - 1) / spb;
    spd_gj_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(B, R, X, F, m,
                                                                  k, spb);
    return (int)cudaGetLastError();
}
