from vio_msckf_torch.math.quaternion import (
    skew,
    quat_normalize,
    quat_conjugate,
    quat_to_rot,
    rot_to_quat,
    quat_mul,
    small_angle_quat,
    from_two_vectors,
    axis_angle_to_rot,
)
from vio_msckf_torch.math.se3 import (
    pose_compose,
    pose_inverse,
    pose_apply,
    pose_matrix,
    pose_from_matrix,
)

__all__ = [
    "skew",
    "quat_normalize",
    "quat_conjugate",
    "quat_to_rot",
    "rot_to_quat",
    "quat_mul",
    "small_angle_quat",
    "from_two_vectors",
    "axis_angle_to_rot",
    "pose_compose",
    "pose_inverse",
    "pose_apply",
    "pose_matrix",
    "pose_from_matrix",
]
