"""Synthetic stereo+IMU trajectory simulator (numpy), and the per-frame
bundling of its IMU stream.

The port's copy of vio_msckf_tpu/data/simulator.py, so the port runs
without the JAX package: an analytic smooth trajectory with exact
derivatives gives perfect (or noise-corrupted) IMU samples, projected
stereo feature tracks and ground truth. The same SimConfig and seed give
the same arrays as the JAX package's simulator.

Conventions match the filter: JPL world->IMU attitude quaternions; the IMU
measures ``gyro = omega_body``, ``acc = R_w_i (a_world - g_world)``;
features are normalized (undistorted) stereo coordinates [u0, v0, u1, v1].
"""

from dataclasses import dataclass

import numpy as np

from benchmark.reference.config import VIOConfig
from benchmark.reference.data.bundling import bundle_imu_stream
from benchmark.reference.filter.msckf import initialize_gravity_and_bias


@dataclass(frozen=True)
class SimConfig:
    duration: float = 30.0
    imu_rate: float = 200.0
    frame_rate: float = 20.0
    # Trajectory: lissajous translation + sinusoidal yaw/roll wobble.
    amp: tuple = (3.0, 2.0, 0.8)
    freq: tuple = (0.25, 0.17, 0.31)   # Hz per axis
    yaw_rate: float = 0.25             # rad/s mean yaw drift
    wobble_amp: float = 0.15           # rad roll/pitch wobble
    wobble_freq: float = 0.4
    n_landmarks: int = 600
    landmark_radius: float = 12.0
    max_features_per_frame: int = 96
    fov_margin: float = 0.81           # |u|,|v| bound in normalized coords
    min_depth: float = 0.5
    max_depth: float = 40.0
    gyro_noise_std: float = 0.0        # rad/s
    acc_noise_std: float = 0.0         # m/s^2
    pixel_noise_std: float = 0.0       # in normalized units
    gyro_bias: tuple = (0.0, 0.0, 0.0)
    acc_bias: tuple = (0.0, 0.0, 0.0)
    static_init_time: float = 1.5      # standstill head for gravity init
    seed: int = 0


def _rotmat_zyx(yaw, pitch, roll):
    cy, sy = np.cos(yaw), np.sin(yaw)
    cp, sp = np.cos(pitch), np.sin(pitch)
    cr, sr = np.cos(roll), np.sin(roll)
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    return Rz @ Ry @ Rx


class _Trajectory:
    """Analytic body trajectory with exact velocity/acceleration/omega."""

    def __init__(self, cfg: SimConfig):
        self.cfg = cfg
        self.t0 = cfg.static_init_time

    def _ramp(self, t):
        """Smoothstep from 0 to 1 over [t0, t0+2] so motion starts at rest."""
        s = np.clip((t - self.t0) / 2.0, 0.0, 1.0)
        return s * s * (3.0 - 2.0 * s), np.where(
            (t > self.t0) & (t < self.t0 + 2.0), 6.0 * s * (1.0 - s) / 2.0, 0.0
        )

    def pva(self, t):
        """Position, velocity, acceleration in the world frame (central
        differences of the ramped analytic position)."""
        h = 1e-4
        p = self._pos(t)
        v = (self._pos(t + h) - self._pos(t - h)) / (2 * h)
        a = (self._pos(t + h) - 2 * p + self._pos(t - h)) / (h * h)
        return p, v, a

    def _pos(self, t):
        cfg = self.cfg
        s, _ = self._ramp(np.asarray(t))
        w = 2 * np.pi * np.asarray(cfg.freq)
        base = np.stack(
            [
                cfg.amp[0] * np.sin(w[0] * (t - self.t0)),
                cfg.amp[1] * np.sin(w[1] * (t - self.t0)),
                cfg.amp[2] * np.sin(w[2] * (t - self.t0)),
            ],
            axis=-1,
        )
        return s[..., None] * base if np.ndim(s) else s * base

    def _angles(self, t):
        cfg = self.cfg
        s, _ = self._ramp(np.asarray(t))
        yaw = s * cfg.yaw_rate * (t - self.t0)
        pitch = s * cfg.wobble_amp * np.sin(2 * np.pi * cfg.wobble_freq * (t - self.t0))
        roll = s * cfg.wobble_amp * np.cos(2 * np.pi * cfg.wobble_freq * (t - self.t0) + 0.5)
        return yaw, pitch, roll

    def attitude(self, t):
        """R_i_w: body->world rotation (transpose is the JPL world->body)."""
        return _rotmat_zyx(*self._angles(t))

    def omega_body(self, t):
        """Angular velocity in the body frame from finite differences of R."""
        h = 1e-4
        R0 = self.attitude(t - h)
        R1 = self.attitude(t + h)
        W = R0.T @ (R1 - R0) / (2 * h)  # approx skew(omega_body)
        W = (W - W.T) / 2.0
        return np.array([W[2, 1], W[0, 2], W[1, 0]])


def simulate_sequence(config: VIOConfig, sim: SimConfig):
    """Generate a full synthetic sequence.

    Returns a dict of numpy arrays:
      imu_t (Mi,), imu_gyro (Mi,3), imu_acc (Mi,3)           raw IMU stream
      frame_t (Nf,)                                          camera stamps
      feat_ids (Nf,K) int32, feat_obs (Nf,K,4), feat_valid (Nf,K)
      gt_p (Nf,3), gt_R_i_w (Nf,3,3), gt_v (Nf,3)            ground truth
      landmarks (L,3)
    """
    rng = np.random.default_rng(sim.seed)
    traj = _Trajectory(sim)
    g_w = config.gravity  # (0,0,-9.81)

    # --- IMU stream -------------------------------------------------------
    imu_t = np.arange(0.0, sim.duration, 1.0 / sim.imu_rate)
    gyro = np.zeros((len(imu_t), 3))
    acc = np.zeros((len(imu_t), 3))
    for i, t in enumerate(imu_t):
        R_i_w = traj.attitude(t)
        _, _, a_w = traj.pva(t)
        gyro[i] = traj.omega_body(t)
        acc[i] = R_i_w.T @ (a_w - g_w)
    gyro += np.asarray(sim.gyro_bias) + sim.gyro_noise_std * rng.standard_normal(gyro.shape)
    acc += np.asarray(sim.acc_bias) + sim.acc_noise_std * rng.standard_normal(acc.shape)

    # --- Landmarks: shell around the trajectory volume --------------------
    pts = rng.normal(size=(sim.n_landmarks, 3))
    pts /= np.linalg.norm(pts, axis=1, keepdims=True)
    radii = sim.landmark_radius * (0.5 + 0.5 * rng.random(sim.n_landmarks))
    landmarks = pts * radii[:, None]

    # --- Stereo frames ----------------------------------------------------
    T_i_c0 = config.cam0.T_imu_cam_np
    T_c0_c1 = config.T_cn_cnm1_np
    R_i_c0, t_i_c0 = T_i_c0[:3, :3], T_i_c0[:3, 3]
    R_01, t_01 = T_c0_c1[:3, :3], T_c0_c1[:3, 3]

    frame_t = np.arange(0.0, sim.duration, 1.0 / sim.frame_rate)
    K = sim.max_features_per_frame
    Nf = len(frame_t)
    feat_ids = np.full((Nf, K), -1, np.int32)
    feat_obs = np.zeros((Nf, K, 4))
    feat_valid = np.zeros((Nf, K), bool)
    gt_p = np.zeros((Nf, 3))
    gt_v = np.zeros((Nf, 3))
    gt_R = np.zeros((Nf, 3, 3))

    for k, t in enumerate(frame_t):
        R_i_w = traj.attitude(t)
        p_w, v_w, _ = traj.pva(t)
        gt_p[k], gt_v[k], gt_R[k] = p_w, v_w, R_i_w

        # world -> cam0 / cam1
        R_w_i = R_i_w.T
        p_c0 = (R_i_c0 @ R_w_i @ (landmarks - p_w).T).T + t_i_c0
        p_c1 = (R_01 @ p_c0.T).T + t_01

        ok = (p_c0[:, 2] > sim.min_depth) & (p_c0[:, 2] < sim.max_depth)
        ok &= (p_c1[:, 2] > sim.min_depth)
        u0 = p_c0[:, 0] / np.maximum(p_c0[:, 2], 1e-9)
        v0 = p_c0[:, 1] / np.maximum(p_c0[:, 2], 1e-9)
        u1 = p_c1[:, 0] / np.maximum(p_c1[:, 2], 1e-9)
        v1 = p_c1[:, 1] / np.maximum(p_c1[:, 2], 1e-9)
        ok &= (np.abs(u0) < sim.fov_margin) & (np.abs(v0) < sim.fov_margin)
        ok &= (np.abs(u1) < sim.fov_margin) & (np.abs(v1) < sim.fov_margin)

        vis = np.flatnonzero(ok)[:K]
        n = len(vis)
        feat_ids[k, :n] = vis
        obs = np.stack([u0[vis], v0[vis], u1[vis], v1[vis]], axis=1)
        if sim.pixel_noise_std > 0:
            obs += sim.pixel_noise_std * rng.standard_normal(obs.shape)
        feat_obs[k, :n] = obs
        feat_valid[k, :n] = True

    return dict(
        imu_t=imu_t, imu_gyro=gyro, imu_acc=acc,
        frame_t=frame_t,
        feat_ids=feat_ids, feat_obs=feat_obs, feat_valid=feat_valid,
        gt_p=gt_p, gt_v=gt_v, gt_R_i_w=gt_R,
        landmarks=landmarks,
    )


def bundle_frames(seq, config: VIOConfig, start_after_init=True):
    """Slice the IMU stream into per-frame padded bundles; returns (frames
    dict of stacked numpy arrays, init dict for the filter, first frame
    index). Same result as the JAX package's bundle_frames, whose static
    initialization lives in a module that imports jax; this one uses the
    port's copy of it."""
    imu_t = seq["imu_t"]
    n_init = config.filter.init_imu_samples
    q0, bg, gravity = initialize_gravity_and_bias(
        seq["imu_gyro"][:n_init], seq["imu_acc"][:n_init])
    t_ready = imu_t[min(n_init, len(imu_t) - 1)]
    frame_t = seq["frame_t"]
    first = int(np.searchsorted(frame_t, t_ready)) if start_after_init else 0
    frames_t = frame_t[first:]
    gyro, acc, dts, valid = bundle_imu_stream(
        imu_t, seq["imu_gyro"], seq["imu_acc"], frames_t, config.filter.imu_per_frame)
    frames = dict(
        imu_gyro=gyro, imu_acc=acc, imu_dt=dts, imu_valid=valid,
        feat_ids=seq["feat_ids"][first:].astype(np.int64),
        feat_obs=seq["feat_obs"][first:].astype(np.float32),
        feat_valid=seq["feat_valid"][first:],
        timestamp=frames_t.astype(np.float64),
    )
    return frames, dict(q0=q0, bg0=bg, gravity=gravity), first
