"""Camera distortion models in closed form: radtan (plumb-bob) and
equidistant forward models, inverses by fixed-point iteration (OpenCV's
undistortPoints scheme). Port of vio_msckf_tpu/ops/distortion.py; points
are (..., 2) tensors.
"""

import torch

_ITERS = 10


def _radtan_forward(xy, coeffs):
    k1, k2, p1, p2 = coeffs
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + k1 * r2 + k2 * r2 * r2
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return torch.stack([xd, yd], dim=-1)


def _equidistant_forward(xy, coeffs):
    k1, k2, k3, k4 = coeffs
    x, y = xy[..., 0], xy[..., 1]
    r = torch.sqrt(x * x + y * y)
    r_safe = torch.clamp(r, min=1e-12)
    theta = torch.arctan(r)
    t2 = theta * theta
    theta_d = theta * (1 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4))))
    scale = torch.where(r > 1e-8, theta_d / r_safe, torch.ones_like(r))
    return xy * scale[..., None]


def _forward(xy, coeffs, model):
    if model == "equidistant":
        return _equidistant_forward(xy, coeffs)
    return _radtan_forward(xy, coeffs)


def _inverse(xyd, coeffs, model):
    xy = xyd
    for _ in range(_ITERS):
        xy = xyd - (_forward(xy, coeffs, model) - xy)
    return xy


def undistort_points(pts, intrinsics, distortion_model, distortion_coeffs,
                     rectification_matrix=None,
                     new_intrinsics=(1.0, 1.0, 0.0, 0.0)):
    """Pixel points -> (optionally rectified) normalized or re-projected
    points; the default new intrinsics give normalized coordinates."""
    fx, fy, cx, cy = intrinsics
    xy_d = torch.stack([(pts[..., 0] - cx) / fx, (pts[..., 1] - cy) / fy], dim=-1)
    xy = _inverse(xy_d, distortion_coeffs, distortion_model)
    if rectification_matrix is not None:
        R = torch.as_tensor(rectification_matrix, dtype=pts.dtype, device=pts.device)
        h = torch.cat([xy, torch.ones_like(xy[..., :1])], dim=-1) @ R.T
        xy = h[..., 0:2] / torch.clamp(h[..., 2:3], min=1e-12)
    nfx, nfy, ncx, ncy = new_intrinsics
    return torch.stack([xy[..., 0] * nfx + ncx, xy[..., 1] * nfy + ncy], dim=-1)


def distort_points(pts_normalized, intrinsics, distortion_model, distortion_coeffs):
    """Normalized points -> distorted pixel points."""
    xy_d = _forward(pts_normalized, distortion_coeffs, distortion_model)
    fx, fy, cx, cy = intrinsics
    return torch.stack([xy_d[..., 0] * fx + cx, xy_d[..., 1] * fy + cy], dim=-1)

