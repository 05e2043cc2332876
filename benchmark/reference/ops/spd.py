"""Batched SPD solve for the chi-square gate: X = B^-1 R for F systems.

Port of vio_msckf_tpu/ops/spd_pallas.py. `spd_solve` runs
`spd_solve_plain`, a Cholesky solve, the twin of the port's Gauss-Jordan
kernel and what the JAX package runs off-TPU.

The two agree to f32 roundoff on the symmetric positive definite systems
the filter builds (B = H P H^T + s I). They split on an indefinite B:
Cholesky returns NaN there (the gate then rejects the feature), while
Gauss-Jordan returns a finite, wrong X — the same split as between the
reference's two solvers.
"""

import torch


def spd_solve_plain(B, R):
    """Cholesky solve of (..., m, m) SPD systems with (..., m, k)
    right-hand sides. A system that is not positive definite yields NaN."""
    L, info = torch.linalg.cholesky_ex(B)
    X = torch.cholesky_solve(R, L)
    bad = (info != 0)[..., None, None]
    return torch.where(bad, torch.full_like(X, float("nan")), X)


def spd_solve(B, R):
    """X = B^-1 R for B (..., m, m) SPD, R (..., m, k): `spd_solve_plain`
    on any device."""
    return spd_solve_plain(B, R)
