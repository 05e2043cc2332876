"""Camera-clone state augmentation as a block write into the fixed-size
covariance at the next free clone slot. Port of
vio_msckf_tpu/filter/augmentation.py."""

import torch

from vio_msckf_torch.math import quat_to_rot, rot_to_quat, skew
from vio_msckf_torch.filter.state import FilterState


def augment(state: FilterState) -> FilterState:
    """Append the camera clone of the current IMU pose.

    Clone pose: R_w_c = R_i_c R_w_i, t_c_w = p + R_w_i^T t_c_i. Covariance
    rows: J (6x21) with J[:3,:3]=R_i_c, J[:3,15:18]=I,
    J[3:6,:3]=skew(R_w_i^T t_c_i), J[3:6,12:15]=I, J[3:6,18:21]=I; the new
    strip is J P[:21,:], the new diagonal block J P11 J^T; then symmetrize.
    """
    dtype, dev = state.P.dtype, state.P.device
    N = state.clone_q.shape[0]
    R_i_c = state.R_imu_cam0
    t_c_i = state.t_cam0_imu
    R_w_i = quat_to_rot(state.q)
    R_w_c = R_i_c @ R_w_i
    t_c_w = state.p + R_w_i.T @ t_c_i
    q_c = rot_to_quat(R_w_c)

    # The window is never full here (the previous frame pruned it), so k is
    # a free slot; the clamp only keeps the index in range.
    k = torch.clamp(state.n_clones, max=N - 1).reshape(1)
    clone_q = state.clone_q.index_copy(0, k, q_c[None])
    clone_p = state.clone_p.index_copy(0, k, t_c_w[None])
    clone_q_null = state.clone_q_null.index_copy(0, k, q_c[None])
    clone_p_null = state.clone_p_null.index_copy(0, k, t_c_w[None])
    clone_valid = state.clone_valid.index_fill(0, k, True)

    eye3 = torch.eye(3, dtype=dtype, device=dev)
    J = torch.zeros((6, 21), dtype=dtype, device=dev)
    J[0:3, 0:3] = R_i_c
    J[0:3, 15:18] = eye3
    J[3:6, 0:3] = skew(R_w_i.T @ t_c_i)
    J[3:6, 12:15] = eye3
    J[3:6, 18:21] = eye3

    P = state.P
    row = J @ P[:21, :]             # (6, D); zero on inactive columns
    diag = J @ P[:21, :21] @ J.T    # (6, 6)
    idx = 21 + 6 * k + torch.arange(6, device=dev)
    # Strip, its transpose, then the diagonal block (which overrides the
    # zero columns the strips carry at the new slot).
    P = P.index_copy(0, idx, row)
    P = P.index_copy(1, idx, row.T)
    P[idx[:, None], idx[None, :]] = diag
    P = (P + P.T) / 2.0

    return state.replace(
        clone_q=clone_q, clone_p=clone_p,
        clone_q_null=clone_q_null, clone_p_null=clone_p_null,
        clone_valid=clone_valid, n_clones=state.n_clones + 1, P=P,
    )
