"""Synthetic stereo image rendering for full-pipeline runs.

Port of the default (ideal-world, `augs=None`) path of
vio_msckf_tpu/data/render.py: each pixel's ray, through the camera's
inverse distortion, is intersected with a sphere of radius `radius`
textured by a band-limited sum of 3-D sinusoids, so translation gives real
parallax and the images exercise the whole front-end. The texture basis
comes from numpy's generator with the reference's seed, so both packages
render the same world.
"""

import numpy as np
import torch

from vio_msckf_torch.config import VIOConfig
from vio_msckf_torch import full_precision
from vio_msckf_torch.ops.distortion import undistort_points


def make_texture_basis(n_waves=24, radius=14.0, seed=0, min_wavelength_px=7.0,
                       fx=458.0, device="cuda"):
    """Random sinusoid basis (omegas (n, 3), phases (n,), amps (n,)) with
    the projected wavelength kept >= min_wavelength_px at ~radius."""
    rng = np.random.default_rng(seed)
    dirs = rng.normal(size=(n_waves, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    w_max = 2 * np.pi * fx / (min_wavelength_px * radius)
    mags = rng.uniform(0.15 * w_max, w_max, size=n_waves)
    phases = rng.uniform(0, 2 * np.pi, size=n_waves)
    amps = rng.uniform(0.5, 1.0, size=n_waves)
    amps = amps / amps.sum() * 110.0
    return tuple(torch.as_tensor(a, dtype=torch.float32, device=device)
                 for a in (dirs * mags[:, None], phases, amps))


def pixel_ray_lut(cam, device="cuda"):
    """(H, W, 3) unit camera-frame rays of every pixel."""
    W, H = cam.resolution
    u, v = np.meshgrid(np.arange(W), np.arange(H))
    pix = torch.as_tensor(np.stack([u, v], axis=-1).reshape(-1, 2),
                          dtype=torch.float32, device=device)
    xy = undistort_points(pix, cam.intrinsics, cam.distortion_model,
                          cam.distortion_coeffs)
    rays = torch.cat([xy, torch.ones_like(xy[:, :1])], dim=1)
    rays = rays / torch.linalg.vector_norm(rays, dim=1, keepdim=True)
    return rays.reshape(H, W, 3)


def render_view(rays_lut, R_c_w, p_cam_w, texture, radius=14.0):
    """Render views: rays_lut (H, W, 3), R_c_w (B, 3, 3) cam->world,
    p_cam_w (B, 3). Returns (B, H, W) f32 in [0, 255]."""
    omegas, phases, amps = texture
    d = torch.einsum("bij,hwj->bhwi", R_c_w, rays_lut)
    pd = torch.einsum("bhwi,bi->bhw", d, p_cam_w)
    pp = torch.sum(p_cam_w * p_cam_w, dim=1)[:, None, None]
    t = -pd + torch.sqrt(torch.clamp(pd * pd - (pp - radius * radius), min=0.0))
    s = p_cam_w[:, None, None, :] + t[..., None] * d
    phase = torch.einsum("bhwi,ki->bhwk", s, omegas) + phases
    return 128.0 + torch.einsum("bhwk,k->bhw", torch.sin(phase), amps)


def render_sequence(config: VIOConfig, R_w_i_stack, p_stack, radius=14.0, seed=0,
                    chunk=16, device="cuda"):
    """Render a pose sequence (R_w_i (N, 3, 3) world->IMU, p (N, 3) IMU
    position) in chunks of frames. Returns (cam0 (N,H,W), cam1 (N,H,W))
    f32 tensors on `device`."""
    full_precision()
    tex = make_texture_basis(radius=radius, seed=seed, fx=config.cam0.intrinsics[0],
                             device=device)
    luts = [pixel_ray_lut(c, device) for c in (config.cam0, config.cam1)]
    T_i_c = [torch.as_tensor(c.T_imu_cam_np, dtype=torch.float32, device=device)
             for c in (config.cam0, config.cam1)]
    R = torch.as_tensor(np.asarray(R_w_i_stack), dtype=torch.float32, device=device)
    p = torch.as_tensor(np.asarray(p_stack), dtype=torch.float32, device=device)
    out = ([], [])
    for s in range(0, R.shape[0], chunk):
        R_w_i, p_imu_w = R[s:s + chunk], p[s:s + chunk]
        for cam, (lut, T) in enumerate(zip(luts, T_i_c)):
            R_i_c, t_i_c = T[:3, :3], T[:3, 3]
            R_c_w = R_w_i.transpose(1, 2) @ R_i_c.T                # cam -> world
            p_cam_w = p_imu_w + R_w_i.transpose(1, 2) @ (-R_i_c.T @ t_i_c)
            out[cam].append(render_view(lut, R_c_w, p_cam_w, tex, radius))
    return torch.cat(out[0]), torch.cat(out[1])
