"""Camera-clone state augmentation as a block write into the fixed-size
covariance at the next free clone slot. Port of
vio_msckf_tpu/filter/augmentation.py."""

import torch

from benchmark.reference.math import quat_to_rot, rot_to_quat, skew
from benchmark.reference.filter.state import FilterState


def augment(state: FilterState) -> FilterState:
    """Append the camera clone of the current IMU pose, in each sequence
    at its own clone count.

    Clone pose: R_w_c = R_i_c R_w_i, t_c_w = p + R_w_i^T t_c_i. Covariance
    rows: J (6x21) with J[:3,:3]=R_i_c, J[:3,15:18]=I,
    J[3:6,:3]=skew(R_w_i^T t_c_i), J[3:6,12:15]=I, J[3:6,18:21]=I; the new
    strip is J P[:21,:], the new diagonal block J P11 J^T; then symmetrize.
    """
    dtype, dev = state.P.dtype, state.P.device
    B, N = state.clone_q.shape[:2]
    R_i_c = state.R_imu_cam0
    t_c_i = state.t_cam0_imu
    R_w_i = quat_to_rot(state.q)
    R_w_c = R_i_c @ R_w_i
    R_i_w_t = (R_w_i.mT @ t_c_i[..., None])[..., 0]
    t_c_w = state.p + R_i_w_t
    q_c = rot_to_quat(R_w_c)

    # The window is never full here (the previous frame pruned it), so k is
    # a free slot; the clamp only keeps the index in range.
    k = torch.clamp(state.n_clones, max=N - 1)              # (B,)
    at_k = (torch.arange(N, device=dev)[None, :] == k[:, None])[..., None]
    clone_q = torch.where(at_k, q_c[:, None], state.clone_q)
    clone_p = torch.where(at_k, t_c_w[:, None], state.clone_p)
    clone_q_null = torch.where(at_k, q_c[:, None], state.clone_q_null)
    clone_p_null = torch.where(at_k, t_c_w[:, None], state.clone_p_null)
    clone_valid = state.clone_valid | at_k[..., 0]

    eye3 = torch.eye(3, dtype=dtype, device=dev)
    J = torch.zeros((B, 6, 21), dtype=dtype, device=dev)
    J[:, 0:3, 0:3] = R_i_c
    J[:, 0:3, 15:18] = eye3
    J[:, 3:6, 0:3] = skew(R_i_w_t)
    J[:, 3:6, 12:15] = eye3
    J[:, 3:6, 18:21] = eye3

    P = state.P
    row = J @ P[:, :21, :]           # (B, 6, D); zero on inactive columns
    diag = J @ P[:, :21, :21] @ J.mT  # (B, 6, 6)
    idx = 21 + 6 * k[:, None] + torch.arange(6, device=dev)  # (B, 6)
    bi = torch.arange(B, device=dev)[:, None]
    # Strip, its transpose, then the diagonal block (which overrides the
    # zero columns the strips carry at the new slot).
    P = P.clone()
    P[bi, idx] = row
    P[bi, :, idx] = row
    P[bi[:, :, None], idx[:, :, None], idx[:, None, :]] = diag
    P = (P + P.mT) / 2.0

    return state.replace(
        clone_q=clone_q, clone_p=clone_p,
        clone_q_null=clone_q_null, clone_p_null=clone_p_null,
        clone_valid=clone_valid, n_clones=state.n_clones + 1, P=P,
    )
