"""SE(3) rigid transforms as (R, t) tensor pairs, ``x_out = R @ x + t``,
batched over leading axes. Port of vio_msckf_tpu/math/se3.py."""

import torch


def pose_compose(R1, t1, R2, t2):
    return R1 @ R2, torch.einsum("...ij,...j->...i", R1, t2) + t1


def pose_inverse(R, t):
    Rt = R.transpose(-1, -2)
    return Rt, -torch.einsum("...ij,...j->...i", Rt, t)


def pose_apply(R, t, x):
    return torch.einsum("...ij,...j->...i", R, x) + t


def pose_matrix(R, t):
    """Pack (R, t) into a 4x4 homogeneous matrix."""
    top = torch.cat([R, t[..., :, None]], dim=-1)
    bottom = torch.zeros_like(top[..., :1, :])
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def pose_from_matrix(T):
    return T[..., :3, :3], T[..., :3, 3]
