"""JPL-convention quaternion algebra on torch tensors.

Port of vio_msckf_tpu/math/quaternion.py. Quaternions are scalar-last,
``q = [x, y, z, w]``, in the JPL convention of Trawny & Roumeliotis:
``quat_to_rot(q)`` takes a vector from the world frame to the body frame
when ``q`` is the world-to-body attitude. Every function is branch-free
(``torch.where`` selections) and batched over leading axes, so nothing
here synchronises with the device.
"""

import torch

_EPS = 1e-12


def skew(v):
    """Skew-symmetric cross-product matrix: (..., 3) -> (..., 3, 3)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


def quat_normalize(q):
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def quat_conjugate(q):
    """JPL conjugate: negate the vector part."""
    return torch.cat([-q[..., :3], q[..., 3:4]], dim=-1)


def quat_to_rot(q):
    """R = (2w^2 - 1) I - 2 w [v]x + 2 v v^T (Trawny Eq. 78), q normalized
    first."""
    q = quat_normalize(q)
    v = q[..., :3]
    w = q[..., 3]
    eye = torch.eye(3, dtype=q.dtype, device=q.device)
    eye = eye.expand(v.shape[:-1] + (3, 3))
    w_ = w[..., None, None]
    vvT = v[..., :, None] * v[..., None, :]
    return (2.0 * w_ * w_ - 1.0) * eye - 2.0 * w_ * skew(v) + 2.0 * vvT


def rot_to_quat(R):
    """Rotation matrix -> JPL quaternion by Shepperd's method, with the
    reference's decision tree (R22 sign, then R00 vs +/-R11)."""
    r00, r01, r02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    r10, r11, r12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    r20, r21, r22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]

    t0 = 1.0 + r00 - r11 - r22
    q0 = torch.stack([t0, r01 + r10, r20 + r02, r12 - r21], dim=-1)
    t1 = 1.0 - r00 + r11 - r22
    q1 = torch.stack([r01 + r10, t1, r21 + r12, r20 - r02], dim=-1)
    t2 = 1.0 - r00 - r11 + r22
    q2 = torch.stack([r02 + r20, r21 + r12, t2, r01 - r10], dim=-1)
    t3 = 1.0 + r00 + r11 + r22
    q3 = torch.stack([r12 - r21, r20 - r02, r01 - r10, t3], dim=-1)

    neg_z = (r22 < 0)[..., None]
    q_negz = torch.where((r00 > r11)[..., None], q0, q1)
    q_posz = torch.where((r00 < -r11)[..., None], q2, q3)
    return quat_normalize(torch.where(neg_z, q_negz, q_posz))


def quat_mul(q1, q2):
    """JPL product q1 * q2; inputs and output normalized, as the reference."""
    q1 = quat_normalize(q1)
    q2 = quat_normalize(q2)
    x1, y1, z1, w1 = q1.unbind(-1)
    x2, y2, z2, w2 = q2.unbind(-1)
    q = torch.stack(
        [
            w1 * x2 + z1 * y2 - y1 * z2 + x1 * w2,
            -z1 * x2 + w1 * y2 + x1 * z2 + y1 * w2,
            y1 * x2 - x1 * y2 + w1 * z2 + z1 * w2,
            -x1 * x2 - y1 * y2 - z1 * z2 + w1 * w2,
        ],
        dim=-1,
    )
    return quat_normalize(q)


def small_angle_quat(dtheta):
    """Error-angle 3-vector -> unit quaternion (Trawny Eqs. 238-239)."""
    dq = dtheta / 2.0
    n2 = torch.sum(dq * dq, dim=-1, keepdim=True)
    w_small = torch.sqrt(torch.clamp(1.0 - n2, min=0.0))
    q_small = torch.cat([dq, w_small], dim=-1)
    q_big = torch.cat([dq, torch.ones_like(n2)], dim=-1) / torch.sqrt(1.0 + n2)
    return torch.where(n2 <= 1.0, q_small, q_big)


def from_two_vectors(v0, v1):
    """JPL quaternion rotating v0 onto v1: the Hamilton rotation quaternion
    (antiparallel, parallel or generic case), conjugated to JPL."""
    v0 = v0 / torch.clamp(torch.linalg.vector_norm(v0, dim=-1, keepdim=True), min=_EPS)
    v1 = v1 / torch.clamp(torch.linalg.vector_norm(v1, dim=-1, keepdim=True), min=_EPS)
    d = torch.sum(v0 * v1, dim=-1)

    s = torch.sqrt(torch.clamp((1.0 + d) * 2.0, min=_EPS))
    q_gen = torch.cat(
        [torch.linalg.cross(v0, v1) / s[..., None], 0.5 * s[..., None]], dim=-1
    )

    ex = torch.zeros_like(v0)
    ex[..., 0] = 1.0
    ey = torch.zeros_like(v0)
    ey[..., 1] = 1.0
    ax = torch.linalg.cross(ex, v0)
    ax = torch.where(
        torch.linalg.vector_norm(ax, dim=-1, keepdim=True) < 1e-6,
        torch.linalg.cross(ey, v0),
        ax,
    )
    q_anti = torch.cat([ax, torch.zeros_like(d)[..., None]], dim=-1)

    q_id = torch.zeros_like(q_gen)
    q_id[..., 3] = 1.0

    q = torch.where(
        (d < -0.999999)[..., None],
        q_anti,
        torch.where((d > 0.999999)[..., None], q_id, q_gen),
    )
    return quat_conjugate(quat_normalize(q))


def axis_angle_to_rot(rvec):
    """Rodrigues with Taylor fallbacks near zero angle."""
    theta2 = torch.sum(rvec * rvec, dim=-1)
    theta = torch.sqrt(torch.clamp(theta2, min=0.0))
    small = theta < 1e-8
    safe_t = torch.where(small, torch.ones_like(theta), theta)
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(safe_t) / safe_t)
    b = torch.where(
        small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(safe_t)) / (safe_t * safe_t)
    )
    K = skew(rvec)
    eye = torch.eye(3, dtype=rvec.dtype, device=rvec.device).expand(K.shape)
    return eye + a[..., None, None] * K + b[..., None, None] * (K @ K)
