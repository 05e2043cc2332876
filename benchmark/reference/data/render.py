"""Synthetic stereo image rendering for full-pipeline runs.

Port of vio_msckf_tpu/data/render.py: each pixel's ray, through the
camera's inverse distortion, is intersected with a sphere of radius
`radius` textured by a band-limited sum of 3-D sinusoids, so translation
gives real parallax and the images exercise the whole front-end. The
texture basis comes from numpy's generator with the reference's seed, so
both packages render the same world.

`RenderAugs` adds the hostile world (bench.py --suite): orbiting textured
occluder spheres, vignetting, per-frame exposure flicker, Gaussian sensor
noise and the clip to [0, 255]. The noise reproduces the reference's bits:
`jax.random.normal(fold_in(key(seed), 2k [+1]), (H, W))` under
threefry2x32 with `jax_threefry_partitionable` (the JAX 0.9 default), here
computed by `_threefry2x32` in PyTorch; so the hostile frames match the
JAX renderer's to float rounding, and frame k's noise depends on k only,
not on chunking or batching. `augs=None` is the ideal world.
"""

from dataclasses import dataclass

import numpy as np
import torch

from benchmark.reference.config import VIOConfig
from benchmark.reference import full_precision
from benchmark.reference.ops.distortion import undistort_points


@dataclass(frozen=True)
class RenderAugs:
    """Hostility knobs for the rendered world (all off by default)."""

    gain_amp: float = 0.0        # per-frame multiplicative flicker (+-)
    bias_amp: float = 0.0        # per-frame additive offset, DN
    noise_std: float = 0.0       # per-pixel Gaussian sensor noise, DN
    vignette: float = 0.0        # radial falloff fraction at the corners
    n_occluders: int = 0         # independently orbiting textured spheres
    occluder_radius: float = 0.8     # m
    occluder_orbit: float = 5.0      # mean orbit radius around origin, m
    occluder_speed: float = 0.5      # rad/s orbital angular speed
    frame_rate: float = 20.0         # frame index -> seconds
    seed: int = 99


# The world the bench sequences (vio_msckf_torch/bench.py) and the scale-out
# ranks render: sphere radius and texture seed.
BENCH_WORLD = dict(radius=14.0, seed=7)

# The hostile suite cell (bench.py --suite).
HOSTILE_AUGS = RenderAugs(
    gain_amp=0.10, bias_amp=8.0, noise_std=2.5, vignette=0.3,
    n_occluders=3,
)

_M32 = 0xFFFFFFFF


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & _M32


def _threefry2x32(k1, k2, x1, x2):
    """Threefry-2x32 (20 rounds), the hash of JAX's default PRNG. Unsigned
    32-bit words are held in int64 tensors and masked after every add;
    k1, k2 Python ints, x1, x2 int64 tensors. Returns (y1, y2)."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    rot = ((13, 15, 26, 6), (17, 29, 16, 24))
    x1 = (x1 + ks[0]) & _M32
    x2 = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in rot[i % 2]:
            x1 = (x1 + x2) & _M32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _M32
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & _M32
    return x1, x2


def _fold_in(key, data):
    """jax.random.fold_in on a raw threefry key (k1, k2): the hash of the
    counter pair (0, data)."""
    y1, y2 = _threefry2x32(key[0], key[1], torch.zeros(1, dtype=torch.int64),
                           torch.full((1,), data & _M32, dtype=torch.int64))
    return int(y1[0]), int(y2[0])


def _normal(key, shape, device):
    """jax.random.normal(key, shape, float32) for a raw threefry key under
    jax_threefry_partitionable: counter i (flat index) hashes to the bits
    y1 ^ y2, whose top 23 bits make a uniform in (-1, 1), mapped through
    sqrt(2) erfinv."""
    n = int(np.prod(shape))
    y1, y2 = _threefry2x32(key[0], key[1], torch.zeros(n, dtype=torch.int64, device=device),
                           torch.arange(n, dtype=torch.int64, device=device))
    bits = ((y1 ^ y2) >> 9) | 0x3F800000                   # f32 in [1, 2)
    f = bits.to(torch.int32).view(torch.float32) - 1.0
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    hi_minus_lo = float(np.float32(1.0) - np.float32(lo))
    u = torch.clamp(f * hi_minus_lo + lo, min=lo)
    return (float(np.float32(np.sqrt(2))) * torch.erfinv(u)).reshape(shape)


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


def render_view(rays_lut, R_c_w, p_cam_w, texture, radius=14.0, occ_centers=None,
                occ_radius=0.8):
    """Render views: rays_lut (H, W, 3), R_c_w (B, 3, 3) cam->world,
    p_cam_w (B, 3). occ_centers (B, Noc, 3), when given, are opaque
    textured spheres of radius occ_radius that hide the background wherever
    a ray hits one first. Returns (B, H, W) f32 in [0, 255]."""
    omegas, phases, amps = texture
    d = torch.einsum("bij,hwj->bhwi", R_c_w, rays_lut)
    pd = torch.einsum("bhwi,bi->bhw", d, p_cam_w)
    pp = torch.sum(p_cam_w * p_cam_w, dim=1)[:, None, None]
    t = -pd + torch.sqrt(torch.clamp(pd * pd - (pp - radius * radius), min=0.0))
    s = p_cam_w[:, None, None, :] + t[..., None] * d
    phase = torch.einsum("bhwi,ki->bhwk", s, omegas) + phases
    val = 128.0 + torch.einsum("bhwk,k->bhw", torch.sin(phase), amps)
    if occ_centers is None:
        return val
    # Nearest occluder hit per pixel: the smaller positive root of
    # |p + t d - c| = r (the camera is outside the small spheres).
    rel = p_cam_w[:, None, :] - occ_centers                         # (B, Noc, 3)
    b = torch.einsum("bhwi,bni->bhwn", d, rel)
    q = torch.sum(rel * rel, dim=-1) - occ_radius ** 2              # (B, Noc)
    disc = b * b - q[:, None, None, :]
    t_occ = -b - torch.sqrt(torch.clamp(disc, min=0.0))
    hit = (disc > 0.0) & (t_occ > 1e-3)
    t_occ = torch.where(hit, t_occ, torch.full_like(t_occ, float("inf")))
    t_near, j_near = torch.min(t_occ, dim=-1)
    occluded = t_near < t
    # The occluder's texture rides with it (local coordinates) at 3x the
    # frequency: dense texture whose motion disagrees with the ego-motion.
    c_near = occ_centers[torch.arange(d.shape[0], device=d.device)[:, None, None], j_near]
    s_occ = p_cam_w[:, None, None, :] + t_near[..., None] * d - c_near
    phase_occ = torch.einsum("bhwi,ki->bhwk", s_occ, 3.0 * omegas) + phases
    val_occ = 128.0 + torch.einsum("bhwk,k->bhw", torch.sin(phase_occ), amps)
    return torch.where(occluded, val_occ, val)


def _vignette_map(cam, strength, device):
    """(H, W) radial gain: 1 at the principal point, 1 - strength at the
    farthest corner."""
    W, H = cam.resolution
    fx, fy, cx, cy = cam.intrinsics
    u, v = np.meshgrid(np.arange(W, dtype=np.float32), np.arange(H, dtype=np.float32))
    r2 = (u - cx) ** 2 + (v - cy) ** 2
    r2max = max((c[0] - cx) ** 2 + (c[1] - cy) ** 2
                for c in ((0, 0), (W - 1, 0), (0, H - 1), (W - 1, H - 1)))
    return torch.as_tensor(1.0 - strength * r2 / r2max, dtype=torch.float32, device=device)


def _occluder_orbits(augs: RenderAugs, device):
    """Per-occluder orbit: orthonormal plane (a, b), radius, phase, speed."""
    rng = np.random.default_rng(augs.seed)
    n = augs.n_occluders
    a = rng.normal(size=(n, 3))
    a /= np.linalg.norm(a, axis=1, keepdims=True)
    b = rng.normal(size=(n, 3))
    b -= np.sum(a * b, axis=1, keepdims=True) * a
    b /= np.linalg.norm(b, axis=1, keepdims=True)
    orbit = augs.occluder_orbit * (0.8 + 0.4 * rng.random(n))
    phase = rng.uniform(0, 2 * np.pi, size=n)
    speed = augs.occluder_speed * (0.7 + 0.6 * rng.random(n))
    return tuple(torch.as_tensor(x, dtype=torch.float32, device=device)
                 for x in (a, b, orbit, phase, speed))


def _hostile(imgs, ks, augs, vig, noise_offset):
    """Vignette, flicker, noise and clip for frames ks (a list of B frame
    indices) of one camera; noise_offset 0 for cam0, 1 for cam1 (the
    reference's key 2k + o)."""
    device = imgs.device
    if augs.vignette > 0:
        imgs = imgs * vig
    kf = torch.as_tensor(ks, dtype=torch.float32, device=device)[:, None, None]
    if augs.gain_amp > 0 or augs.bias_amp > 0:
        ph = (0.0, 0.3) if noise_offset == 0 else (0.7, 1.1)
        gain = 1.0 + augs.gain_amp * torch.sin(2.39996 * kf + ph[0])
        bias = augs.bias_amp * torch.sin(1.61803 * kf + ph[1])
        imgs = imgs * gain + bias
    if augs.noise_std > 0:
        base = (0, augs.seed & _M32)
        noise = torch.stack([
            _normal(_fold_in(base, 2 * k + noise_offset), imgs.shape[1:], device)
            for k in ks])
        imgs = imgs + augs.noise_std * noise
    return torch.clamp(imgs, 0.0, 255.0)


def render_sequence(config: VIOConfig, R_w_i_stack, p_stack, radius=14.0, seed=0,
                    chunk=16, device="cuda", augs=None):
    """Render a pose sequence (R_w_i (N, 3, 3) world->IMU, p (N, 3) IMU
    position) in chunks of frames; frame k's flicker, noise and occluder
    positions (with `augs`) depend on k alone. Returns (cam0 (N,H,W), cam1
    (N,H,W)) f32 tensors on `device`."""
    full_precision()
    tex = make_texture_basis(radius=radius, seed=seed, fx=config.cam0.intrinsics[0],
                             device=device)
    cams = (config.cam0, config.cam1)
    luts = [pixel_ray_lut(c, device) for c in cams]
    T_i_c = [torch.as_tensor(c.T_imu_cam_np, dtype=torch.float32, device=device)
             for c in cams]
    R = torch.as_tensor(np.asarray(R_w_i_stack), dtype=torch.float32, device=device)
    p = torch.as_tensor(np.asarray(p_stack), dtype=torch.float32, device=device)
    if augs is not None:
        vigs = [_vignette_map(c, augs.vignette, device) if augs.vignette > 0 else None
                for c in cams]
        orbits = _occluder_orbits(augs, device) if augs.n_occluders > 0 else None
    out = ([], [])
    for s in range(0, R.shape[0], chunk):
        R_w_i, p_imu_w = R[s:s + chunk], p[s:s + chunk]
        ks = list(range(s, s + R_w_i.shape[0]))
        occ = {}
        if augs is not None and orbits is not None:
            a, b, orbit, phase, speed = orbits
            kf = torch.as_tensor(ks, dtype=torch.float32, device=device)
            ang = speed * (kf[:, None] / augs.frame_rate) + phase
            occ = dict(occ_centers=orbit[:, None] * (torch.cos(ang)[..., None] * a
                                                     + torch.sin(ang)[..., None] * b),
                       occ_radius=augs.occluder_radius)
        for cam, (lut, T) in enumerate(zip(luts, T_i_c)):
            R_i_c, t_i_c = T[:3, :3], T[:3, 3]
            R_c_w = R_w_i.transpose(1, 2) @ R_i_c.T                # cam -> world
            p_cam_w = p_imu_w + R_w_i.transpose(1, 2) @ (-R_i_c.T @ t_i_c)
            img = render_view(lut, R_c_w, p_cam_w, tex, radius, **occ)
            if augs is not None:
                img = _hostile(img, ks, augs, vigs[cam], cam)
            out[cam].append(img)
    return torch.cat(out[0]), torch.cat(out[1])
