"""Batched SPD solve for the chi-square gate: X = B^-1 R for F systems.

Port of vio_msckf_tpu/ops/spd_pallas.py. `spd_solve` is the kernel
wrapper: a CUDA tensor launches csrc/spd_gj.cu (unpivoted Gauss-Jordan:
one warp per system for m <= 8, one CTA per system up to m = 128; counted
per call shape in `spd_solve.by_shape`), a CPU tensor runs `spd_solve_plain`, a Cholesky
solve, which is what the JAX package runs off-TPU.

The two agree to f32 roundoff on the symmetric positive definite systems
the filter builds (B = H P H^T + s I). They split on an indefinite B:
Cholesky returns NaN there (the gate then rejects the feature), while
Gauss-Jordan returns a finite, wrong X — the same split as between the
reference's two solvers.
"""

import collections

import torch

from vio_msckf_torch import kernels


def spd_solve_plain(B, R):
    """Cholesky solve of (..., m, m) SPD systems with (..., m, k)
    right-hand sides. A system that is not positive definite yields NaN."""
    L, info = torch.linalg.cholesky_ex(B)
    X = torch.cholesky_solve(R, L)
    bad = (info != 0)[..., None, None]
    return torch.where(bad, torch.full_like(X, float("nan")), X)


def spd_solve(B, R):
    """X = B^-1 R for B (..., m, m) SPD, R (..., m, k), f32. On CUDA the
    leading axes (sequences, features) fold into the kernel's one flat
    axis of F systems: one launch whatever the batch."""
    if not B.is_cuda:
        return spd_solve_plain(B, R)
    lead, (m, k) = B.shape[:-2], R.shape[-2:]
    F = 1
    for d in lead:
        F *= d
    if m > 128 or m + k > 144:
        raise ValueError(f"spd_gj kernel takes m <= 128 with m + k <= 144, got m={m}, k={k}")
    B = B.reshape(F, m, m).contiguous()
    R = R.reshape(F, m, k).contiguous()
    kernels.require(B, "spd_solve B", torch.float32, (F, m, m))
    kernels.require(R, "spd_solve R", torch.float32, (F, m, k))
    X = torch.empty_like(R)
    if F == 0:
        return X.reshape(lead + (m, k))
    code = kernels.lib().vio_spd_gj(
        kernels.ptr(B), kernels.ptr(R), kernels.ptr(X), F, m, k, kernels.stream_ptr(B))
    kernels.check(code, "vio_spd_gj")
    spd_solve.by_shape[(F, m, k)] += 1
    return X.reshape(lead + (m, k))


spd_solve.by_shape = collections.Counter()  # launches per call shape
