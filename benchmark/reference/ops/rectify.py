"""Stereo rectification: Bouguet-style rotation split + a bilinear warp.
Port of vio_msckf_tpu/ops/rectify.py.

It replaces the reference ESKF pipeline's cv2.stereoRectify /
cv2.initUndistortRectifyMap / cv2.remap (ESKF/stereo.py:96-153, 240-250).
The rectifying rotations and the new common projection are computed once
on the host in float64 (`stereo_rectify`, the JAX package's numpy code
as it is); the inverse map is one tensor computation and the per-frame
warp one gather over the whole image, zeros outside the source.

Geometry. Given x_c1 = R @ x_c0 + t (cam0 -> cam1), we pick rotations
R_rect0 (cam0 -> rect) and R_rect1 (cam1 -> rect) such that

  * both rectified frames share one orientation:  R_rect1 @ R = R_rect0;
  * the baseline lies on the rectified x-axis:    R_rect1 @ t = (-b, 0, 0).

As in Bouguet's method, the relative rotation is split in half (each camera
rotates by ~R^(1/2)) before aligning the baseline, so neither image is
warped much more than the other.
"""

import numpy as np
import torch

from benchmark.reference.ops.distortion import distort_points


def _rotvec_to_mat(r):
    angle = np.linalg.norm(r)
    if angle < 1e-12:
        return np.eye(3)
    a = r / angle
    K = np.array(
        [[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]]
    )
    return np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * (K @ K)


def _mat_to_rotvec(R):
    cos = np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)
    angle = np.arccos(cos)
    if angle < 1e-12:
        return np.zeros(3)
    axis = np.array(
        [R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]]
    ) / (2.0 * np.sin(angle))
    return axis * angle


def stereo_rectify(cam0, cam1, T_cn_cnm1, zoom=1.0):
    """Host-side (numpy, float64) rectification setup.

    cam0/cam1: CameraConfig; T_cn_cnm1: 4x4, vec_cam0 -> vec_cam1.

    Returns a dict with R_rect0, R_rect1 (3x3), K_new (fx, fy, cx, cy),
    baseline (meters), and T_rect_cam0 (the rect frame expressed relative
    to cam0, = R_rect0).
    """
    T = np.asarray(T_cn_cnm1, np.float64)
    R, t = T[:3, :3], T[:3, 3]

    # Half-rotation split (Bouguet): rotate cam1 back by half the relative
    # rotation, cam0 forward by the other half.
    om = _mat_to_rotvec(R)
    R_half1 = _rotvec_to_mat(-om / 2.0)  # applied to cam1
    t_half = R_half1 @ t

    # Align the (half-rotated) baseline with the x-axis: the rectified
    # x-axis must satisfy x_rect . t_half = -|t| (so cam0's origin sits at
    # (-b, 0, 0) in the rectified cam1 frame, i.e. rect x points from cam0
    # toward cam1 — positive disparity u_l - u_r).
    e1 = -t_half / np.linalg.norm(t_half)
    # e2 orthogonal to e1 with no z-component (keeps image rows ~level).
    e2 = np.array([-e1[1], e1[0], 0.0])
    n2 = np.linalg.norm(e2)
    if n2 < 1e-9:  # degenerate: baseline along z
        e2 = np.array([0.0, 1.0, 0.0])
    else:
        e2 = e2 / n2
    e3 = np.cross(e1, e2)
    A = np.stack([e1, e2, e3])  # rows = rect axes in half-rotated frame

    R_rect1 = A @ R_half1
    R_rect0 = R_rect1 @ R
    baseline = float(np.linalg.norm(t))

    W, H = cam0.resolution
    fx, fy = cam0.intrinsics[0], cam0.intrinsics[1]
    f_new = zoom * (fx + fy) / 2.0
    K_new = (f_new, f_new, W / 2.0, H / 2.0)

    # Invariants (cheap, catch convention bugs at setup time).
    t_new = R_rect1 @ t
    assert abs(t_new[0] + baseline) < 1e-9, t_new
    assert np.allclose(t_new[1:], 0.0, atol=1e-9), t_new
    assert np.allclose(R_rect1 @ R, R_rect0, atol=1e-12)

    return dict(
        R_rect0=R_rect0,
        R_rect1=R_rect1,
        K_new=K_new,
        baseline=baseline,
    )


def rectify_map(cam, R_rect, K_new, device="cuda"):
    """Inverse map for the rectified image: for every output pixel, the
    source pixel in the original (distorted) image.

    Returns an (H, W, 2) float32 tensor of (x, y) source coordinates."""
    W, H = cam.resolution
    fxn, fyn, cxn, cyn = K_new
    u = (torch.arange(W, dtype=torch.float32, device=device) - cxn) / fxn
    v = (torch.arange(H, dtype=torch.float32, device=device) - cyn) / fyn
    yn, xn = torch.meshgrid(v, u, indexing="ij")  # (H, W)
    rays = torch.stack([xn, yn, torch.ones_like(xn)], dim=-1)  # rect frame
    rays = rays @ torch.as_tensor(R_rect, dtype=torch.float32, device=device)  # R_rect.T @ ray
    xy = rays[..., 0:2] / torch.clamp(rays[..., 2:3], min=1e-9)
    return distort_points(xy, cam.intrinsics, cam.distortion_model,
                          torch.as_tensor(cam.distortion_coeffs, dtype=torch.float32,
                                          device=device))


def warp_bilinear(img, map_xy):
    """Sample images (..., H, W) at map_xy (..., H', W', 2), one map per
    image; zeros outside the source. Returns (..., H', W')."""
    H, W = img.shape[-2:]
    lead = img.shape[:-2]
    flat = img.reshape(-1, H * W)
    x = map_xy[..., 0].reshape(flat.shape[0], -1)
    y = map_xy[..., 1].reshape(flat.shape[0], -1)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)
    zero = torch.zeros((), dtype=img.dtype, device=img.device)

    def at(yi, xi):
        inb = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        idx = torch.clamp(yi, 0, H - 1) * W + torch.clamp(xi, 0, W - 1)
        return torch.where(inb, torch.gather(flat, 1, idx), zero)

    v00 = at(y0i, x0i)
    v01 = at(y0i, x0i + 1)
    v10 = at(y0i + 1, x0i)
    v11 = at(y0i + 1, x0i + 1)
    out = (v00 * (1 - fx) * (1 - fy)
           + v01 * fx * (1 - fy)
           + v10 * (1 - fx) * fy
           + v11 * fx * fy)
    return out.reshape(lead + map_xy.shape[-3:-1])
