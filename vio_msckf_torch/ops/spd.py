"""Batched SPD solve for the chi-square gate: X = B^-1 R for F systems.

Port of vio_msckf_tpu/ops/spd_pallas.py. `spd_solve` is the kernel
wrapper: a CUDA tensor launches csrc/spd_gj.cu (unpivoted Gauss-Jordan,
counted in `spd_solve.launches`), a CPU tensor runs `spd_solve_plain`, a
Cholesky solve, which is what the JAX package runs off-TPU.

The two agree to f32 roundoff on the symmetric positive definite systems
the filter builds (B = H P H^T + s I). They split on an indefinite B:
Cholesky returns NaN there (the gate then rejects the feature), while
Gauss-Jordan returns a finite, wrong X — the same split as between the
reference's two solvers.
"""

import torch

from vio_msckf_torch import kernels

_THREADS = 256


def spd_solve_plain(B, R):
    """Cholesky solve of (F, m, m) SPD systems with (F, m, k) right-hand
    sides. A system that is not positive definite yields NaN."""
    L, info = torch.linalg.cholesky_ex(B)
    X = torch.cholesky_solve(R, L)
    bad = (info != 0)[:, None, None]
    return torch.where(bad, torch.full_like(X, float("nan")), X)


def spd_solve(B, R):
    """X = B^-1 R for B (F, m, m) SPD, R (F, m, k), f32."""
    if not B.is_cuda:
        return spd_solve_plain(B, R)
    F, m, _ = B.shape
    k = R.shape[2]
    B = B.contiguous()
    R = R.contiguous()
    kernels.require(B, "spd_solve B", torch.float32, (F, m, m))
    kernels.require(R, "spd_solve R", torch.float32, (F, m, k))
    X = torch.empty_like(R)
    if F == 0:
        return X
    # One CTA per large system; small systems share a CTA, one 32-thread
    # group each.
    tps = _THREADS if m > 16 else 32
    spb = _THREADS // tps
    code = kernels.lib().vio_spd_gj(
        kernels.ptr(B), kernels.ptr(R), kernels.ptr(X), F, m, k, spb,
        _THREADS, kernels.stream_ptr(B))
    kernels.check(code, "vio_spd_gj")
    spd_solve.launches += 1
    return X


spd_solve.launches = 0
