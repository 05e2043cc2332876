"""MSCKF measurement model and EKF update on fixed shapes.

Port of vio_msckf_tpu/filter/update.py: per-(feature, clone) stereo
measurement Jacobians with the observability-constrained correction,
nullspace projection of H_f through an orthonormal basis U of col(H_f)
(H~ = (I - U U^T) H), the exact chi-square statistic by the block-inverse
identity, compaction of the gated systems into one fixed row buffer, and a
QR-compressed update with the Joseph-form covariance.

All functions take a leading batch axis B (sequences) and, for the
per-feature systems, a feature axis C after it. The gate's SPD solve goes
through ops/spd.py (a Cholesky solve here; the port's Gauss-Jordan kernel
on CUDA).
"""

import torch

from benchmark.reference.math import quat_mul, quat_to_rot, skew, small_angle_quat
from benchmark.reference.filter.state import FilterState, MsckfParams
from benchmark.reference.ops.spd import spd_solve
from benchmark.reference.tensors import gather_rows

_SAFE = 1e-12


def _safe(x):
    return torch.where(torch.abs(x) > _SAFE, x, torch.full_like(x, _SAFE))


def _clone_jacobian(p_w, z, clone_q, clone_p, clone_q_null, clone_p_null,
                    gravity, R_c0c1, t_c0c1):
    """H_x (..., 4, 6) and r (..., 4) of stereo observations z (..., 4) of
    world points p_w (..., 3) from clones (..., 4) / (..., 3); gravity
    (..., 3) broadcasts against them."""
    R_w_c0 = quat_to_rot(clone_q)
    t_c0_w = clone_p
    R_w_c1 = R_c0c1 @ R_w_c0
    t_c1_w = t_c0_w - (R_w_c1.transpose(-1, -2) @ t_c0c1)

    p_c0 = (R_w_c0 @ (p_w - t_c0_w)[..., None])[..., 0]
    p_c1 = (R_w_c1 @ (p_w - t_c1_w)[..., None])[..., 0]
    z0 = _safe(p_c0[..., 2])
    z1 = _safe(p_c1[..., 2])

    shape = z0.shape
    zero = torch.zeros_like(z0)
    dz_dpc0 = torch.stack([
        torch.stack([1.0 / z0, zero, -p_c0[..., 0] / (z0 * z0)], dim=-1),
        torch.stack([zero, 1.0 / z0, -p_c0[..., 1] / (z0 * z0)], dim=-1),
        torch.zeros(shape + (3,), dtype=z0.dtype, device=z0.device),
        torch.zeros(shape + (3,), dtype=z0.dtype, device=z0.device),
    ], dim=-2)
    dz_dpc1 = torch.stack([
        torch.zeros(shape + (3,), dtype=z0.dtype, device=z0.device),
        torch.zeros(shape + (3,), dtype=z0.dtype, device=z0.device),
        torch.stack([1.0 / z1, zero, -p_c1[..., 0] / (z1 * z1)], dim=-1),
        torch.stack([zero, 1.0 / z1, -p_c1[..., 1] / (z1 * z1)], dim=-1),
    ], dim=-2)

    dpc0_dxc = torch.cat([skew(p_c0), -R_w_c0], dim=-1)             # (...,3,6)
    dpc1_dxc = torch.cat([R_c0c1 @ skew(p_c0), -R_w_c1], dim=-1)
    H_x = dz_dpc0 @ dpc0_dxc + dz_dpc1 @ dpc1_dxc                    # (...,4,6)

    # Observability constraint.
    u = torch.cat([
        (quat_to_rot(clone_q_null) @ gravity[..., None])[..., 0],
        (skew(p_w - clone_p_null) @ gravity[..., None])[..., 0],
    ], dim=-1)                                                       # (...,6)
    Hu = (H_x @ u[..., None])[..., 0]
    uu = torch.clamp(torch.sum(u * u, dim=-1), min=_SAFE)
    H_x = H_x - Hu[..., :, None] * u[..., None, :] / uu[..., None, None]

    r = z - torch.cat([p_c0[..., 0:2] / z0[..., None], p_c1[..., 0:2] / z1[..., None]],
                      dim=-1)
    return H_x, r


def feature_system(p_w, obs_k, use_k, slots_k, state: FilterState,
                   params: MsckfParams):
    """Each feature's stacked, nullspace-projected system over a subset of
    clone slots, per sequence.

    p_w (B, C, 3), obs_k (B, C, K, 4), use_k (B, C, K) bool, slots_k
    (B, C, K) int64. Returns (H (B, C, 4K, D), Hp, r (B, C, 4K), rp,
    U (B, C, 4K, 3)) with Hp / rp projected by (I - U U^T); rows of unused
    slots are exactly zero."""
    B, C, K = use_k.shape
    N = state.clone_q.shape[1]
    D = state.P.shape[-1]
    dtype, dev = state.P.dtype, state.P.device
    bi = torch.arange(B, device=dev)[:, None, None]

    Hx, r = _clone_jacobian(
        p_w[:, :, None, :], obs_k,
        gather_rows(state.clone_q, slots_k), gather_rows(state.clone_p, slots_k),
        gather_rows(state.clone_q_null, slots_k), gather_rows(state.clone_p_null, slots_k),
        state.gravity[:, None, None, :], params.R_cam0_cam1, params.t_cam0_cam1,
    )                                                   # (B,C,K,4,6), (B,C,K,4)
    zero = torch.zeros((), dtype=dtype, device=dev)
    Hx = torch.where(use_k[..., None, None], Hx, zero)
    r = torch.where(use_k[..., None], r, zero)
    Hf = -Hx[..., 3:6]                                  # (B,C,K,4,3)

    # Place each (4, 6) block at its clone columns 21 + 6*slot.
    H6 = torch.zeros((B, C, K, N, 4, 6), dtype=dtype, device=dev)
    ci = torch.arange(C, device=dev)[None, :, None]
    ki = torch.arange(K, device=dev)[None, None, :]
    H6[bi, ci, ki, slots_k] = Hx
    H6 = H6.permute(0, 1, 2, 4, 3, 5).reshape(B, C, 4 * K, 6 * N)
    H = torch.cat([torch.zeros((B, C, 4 * K, 21), dtype=dtype, device=dev), H6], dim=-1)
    Hf_full = Hf.reshape(B, C, 4 * K, 3)
    r_full = r.reshape(B, C, 4 * K)

    U, _ = torch.linalg.qr(Hf_full)                     # (B, C, 4K, 3)
    # Rows of unused slots stay exactly zero even for degenerate geometry;
    # the row compaction in stack_update relies on it.
    row_mask = torch.repeat_interleave(use_k, 4, dim=-1)[..., None]
    U = torch.where(row_mask, U, zero)
    Ut = U.mT
    Hp = H - U @ (Ut @ H)
    rp = r_full - (U @ (Ut @ r_full[..., None]))[..., 0]
    return H, Hp, r_full, rp, U


def _eigh3_jacobi(G, sweeps=4):
    """Eigen-decomposition of symmetric 3x3 matrices (..., 3, 3) by cyclic
    Jacobi rotations. Returns (w (..., 3), V (..., 3, 3)), eigenvalues not
    sorted.

    Kept from the reference on purpose: tau uses sign(0) = 0, so a pair
    with exactly equal diagonal entries is never rotated (for
    G = [[2,1,0],[1,2,0],[0,0,5]] this returns w = [2, 2, 5], where the
    true eigenvalues are [1, 3, 5])."""
    dtype, dev = G.dtype, G.device
    A = (G + G.transpose(-1, -2)) / 2.0
    V = torch.eye(3, dtype=dtype, device=dev).expand_as(A)
    # Rotation J = (I - D) + c D + s S with constant masks
    # D = e_p e_p^T + e_q e_q^T and S = e_p e_q^T - e_q e_p^T.
    # Built from rows of the identity by device ops: writing a Python
    # number into a CUDA tensor would copy it from the host and synchronise.
    eye = torch.eye(3, dtype=dtype, device=dev)
    masks = {}
    for (p, q) in ((0, 1), (0, 2), (1, 2)):
        I_D = torch.outer(eye[3 - p - q], eye[3 - p - q])
        S = torch.outer(eye[p], eye[q]) - torch.outer(eye[q], eye[p])
        masks[p, q] = (I_D, eye - I_D, S)
    for _ in range(sweeps):
        for (p, q) in ((0, 1), (0, 2), (1, 2)):
            apq = A[..., p, q]
            big = torch.abs(apq) > _SAFE
            tau = (A[..., q, q] - A[..., p, p]) / (
                2.0 * torch.where(big, apq, torch.ones_like(apq)))
            t = torch.sign(tau) / (torch.abs(tau) + torch.sqrt(1.0 + tau * tau))
            t = torch.where(big, t, torch.zeros_like(t))
            c = 1.0 / torch.sqrt(1.0 + t * t)
            s = t * c
            I_D, D, S = masks[p, q]
            J = I_D + c[..., None, None] * D + s[..., None, None] * S
            A = J.transpose(-1, -2) @ A @ J
            V = V @ J
    return torch.diagonal(A, dim1=-2, dim2=-1), V


def feature_gamma(H, rp, U, P, obs_noise):
    """Exact chi-square statistic of each projected system without forming
    the nullspace complement: B = H P H^T + s I (SPD), one solve for
    [rp | U], then the rank-guarded 3x3 correction in G's eigenbasis.
    H (B, C, m, D), rp (B, C, m), U (B, C, m, 3), P (B, D, D) -> (B, C).
    A non-finite gamma fails every gate comparison: the feature is
    rejected."""
    m = H.shape[-2]
    Bm = H @ P[:, None] @ H.mT + obs_noise * torch.eye(m, dtype=H.dtype, device=H.device)
    rhs = torch.cat([rp[..., None], U], dim=-1)
    X = spd_solve(((Bm + Bm.mT) / 2.0).contiguous(), rhs.contiguous())
    Binv_rp = X[..., 0]
    Binv_U = X[..., 1:]
    Ut = U.mT
    G = Ut @ Binv_U                                     # (B,C,3,3)
    gu = (Ut @ Binv_rp[..., None])[..., 0]              # (B,C,3)
    w, V = _eigh3_jacobi(G)
    wmax = torch.clamp(torch.amax(w, dim=-1, keepdim=True), min=_SAFE)
    keep = w > 1e-6 * wmax
    winv = torch.where(keep, 1.0 / torch.where(keep, w, torch.ones_like(w)),
                       torch.zeros_like(w))
    c = (V.mT @ gu[..., None])[..., 0]
    correction = torch.sum(c * (winv * c), dim=-1)
    return torch.clamp(torch.sum(rp * Binv_rp, dim=-1) - correction, min=0.0)


def apply_correction(state: FilterState, dx) -> FilterState:
    """Inject the error-state correction dx (B, D)."""
    q = quat_mul(small_angle_quat(dx[:, 0:3]), state.q)
    R_imu_cam0 = quat_to_rot(small_angle_quat(dx[:, 15:18])) @ state.R_imu_cam0
    B, N = state.clone_q.shape[:2]
    dxc = dx[:, 21:].reshape(B, N, 6)
    clone_q = quat_mul(small_angle_quat(dxc[..., 0:3]), state.clone_q)
    cv = state.clone_valid[..., None]
    return state.replace(
        q=q, p=state.p + dx[:, 12:15], v=state.v + dx[:, 6:9],
        bg=state.bg + dx[:, 3:6], ba=state.ba + dx[:, 9:12],
        R_imu_cam0=R_imu_cam0, t_cam0_imu=state.t_cam0_imu + dx[:, 18:21],
        clone_q=torch.where(cv, clone_q, state.clone_q),
        clone_p=torch.where(cv, state.clone_p + dxc[..., 3:6], state.clone_p),
    )


def qr_update(state: FilterState, Hc, rc, params: MsckfParams) -> FilterState:
    """EKF update from each sequence's compacted stack (Hc (B, R, D), rc
    (B, R)): QR-compress it to a (D, D) triangle Th with z = Q^T r (exact
    for any rank), then K = P Th^T (Th P Th^T + s I)^-1 and the
    Joseph-form covariance, which stays PSD in f32."""
    D = state.P.shape[-1]
    dtype, dev = state.P.dtype, state.P.device
    s = params.observation_noise
    P = state.P
    Q, Th = torch.linalg.qr(Hc)
    z = (Q.mT @ rc[..., None])[..., 0]
    eye = torch.eye(D, dtype=dtype, device=dev)
    S = Th @ P @ Th.mT + s * eye
    S = (S + S.mT) / 2.0
    K = torch.linalg.solve_ex(S, Th @ P)[0].mT
    dx = (K @ z[..., None])[..., 0]
    I_KH = eye - K @ Th
    P_new = I_KH @ P @ I_KH.mT + s * (K @ K.mT)
    P_new = (P_new + P_new.mT) / 2.0
    return apply_correction(state, dx).replace(P=P_new)


def budget_blocks(params: MsckfParams) -> int:
    """4-row blocks in the fixed stacking buffer: the 1500-row budget on
    projected rows, plus the 3/4 block per admitted feature that raw
    blocks can exceed it by, plus one more feature's window."""
    fc = params.config.filter
    return (fc.max_update_rows + 3 * fc.max_lost_candidates + 3) // 4 + fc.max_cam_state_size


def stack_update(state: FilterState, params: MsckfParams, positions, obs,
                 use_masks, clone_slots, process_mask, dofs, max_blocks=None):
    """Per-feature systems -> gating -> row budget -> compacted (Hc, rc),
    each sequence on its own.

    positions (B, C, 3), obs (B, C, K, 4), use_masks (B, C, K),
    clone_slots (B, C, K), process_mask (B, C), dofs (B, C). Feature j of
    a sequence contributes iff that sequence's gated rows before it total
    <= max_update_rows; its used 4-row blocks go, in feature-major order,
    to the next rows of the sequence's (4 * budget_blocks, D) buffer.
    Returns (Hc (B, 4 NB, D), rc (B, 4 NB), include (B, C))."""
    P = state.P
    B, C, K = use_masks.shape
    D = P.shape[-1]
    dtype, dev = P.dtype, P.device
    H, Hp, _, rp, U = feature_system(positions, obs, use_masks, clone_slots, state, params)
    gammas = feature_gamma(H, rp, U, P, params.observation_noise)

    thresholds = params.chi2_table[torch.clamp(dofs, 1, 99)]
    gate = process_mask & (gammas < thresholds)
    n_used = torch.sum(use_masks, dim=-1)
    rows = (4 * n_used - 3) * gate
    cum_before = torch.cumsum(rows, dim=1) - rows
    include = gate & (cum_before <= params.config.filter.max_update_rows)

    NB = budget_blocks(params)
    if max_blocks is not None:
        NB = min(NB, max_blocks)
    flat_used = (use_masks & include[:, :, None]).reshape(B, C * K)
    dest = torch.cumsum(flat_used.to(torch.int64), dim=1) - 1
    dest = torch.where(flat_used & (dest < NB), dest, NB)   # NB = dropped
    bi = torch.arange(B, device=dev)[:, None]
    Hc = torch.zeros((B, NB + 1, 4, D), dtype=dtype, device=dev)
    rc = torch.zeros((B, NB + 1, 4), dtype=dtype, device=dev)
    Hc[bi, dest] = Hp.reshape(B, C * K, 4, D)
    rc[bi, dest] = rp.reshape(B, C * K, 4)
    return Hc[:, :NB].reshape(B, NB * 4, D), rc[:, :NB].reshape(B, NB * 4), include
