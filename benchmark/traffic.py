"""The traffic generator: B stereo + IMU sequences made from `--seed` by
the parameters of a traffic file (benchmark/traffic/<name>.json).

Each sequence is simulated on the host from the analytic trajectory of
the benchmark's copy of the port's simulator (benchmark/reference/data/
simulator.py), evaluated for all samples at once (`trajectory`: the IMU
stream and the ground truth; the simulator's landmark tracks are not made,
since the renderer ignores them), bundled per frame as its bundle_frames
does, and rendered on the device by the copy of the renderer, in the
configuration's world: `python -m vio_msckf_torch.bench`'s recipe
(simulate, bundle, render). Sequence b draws one factor u in [0, 1) from (seed, b) and takes
its motion (`amp`, `yaw_rate`, `wobble_amp`) at u between the file's
`motion.from` and `motion.to`, so the sequences of a batch differ in
motion while every seed gives the same number of sequences and frames.
Frames come at the configuration's `filter.frame_rate`.
"""

import numpy as np
import torch

from benchmark.reference.data.bundling import bundle_imu_stream
from benchmark.reference.data.render import render_sequence
from benchmark.reference.data.simulator import SimConfig, _Trajectory
from benchmark.reference.filter.msckf import initialize_gravity_and_bias

IMU_KEYS = ("imu_gyro", "imu_acc", "imu_dt", "imu_valid")
MOTION_KEYS = ("amp", "yaw_rate", "wobble_amp")


def seed_entropy(seed):
    """Any whole number (negative, or past 64 bits) as a seed sequence's
    non-negative entropy."""
    return int(seed) % (1 << 64)


def motion_factor(seed, b):
    """Sequence b's motion factor u in [0, 1), fixed by (seed, b)."""
    return float(np.random.default_rng([seed_entropy(seed), b]).random())


def motion(traffic, u):
    """SimConfig's motion keys at u between the file's two motions."""
    lo, hi = traffic["motion"]["from"], traffic["motion"]["to"]
    out = {}
    for k in MOTION_KEYS:
        a, b = np.asarray(lo[k], float), np.asarray(hi[k], float)
        v = a + u * (b - a)
        out[k] = tuple(float(x) for x in v) if v.ndim else float(v)
    return out


def sim_config(cfg, traffic, seed, b, frames):
    """Sequence b's SimConfig at the configuration's frame rate: long
    enough for `frames` frames after the static initialisation (the filter
    starts after init_imu_samples)."""
    rate = cfg.filter.frame_rate
    # One second of static IMU precedes the first frame at the default
    # 200 init samples and 200 Hz; a second more covers any rounding.
    duration = frames / rate + 2.0
    entropy = np.random.default_rng([seed_entropy(seed), b, 1]).integers(1 << 31)
    return SimConfig(duration=duration, seed=int(entropy), frame_rate=rate,
                     **motion(traffic, motion_factor(seed, b)))


def _rotmats(yaw, pitch, roll):
    """simulator._rotmat_zyx for arrays of angles: (n, 3, 3)."""
    cy, sy, cp, sp = np.cos(yaw), np.sin(yaw), np.cos(pitch), np.sin(pitch)
    cr, sr = np.cos(roll), np.sin(roll)
    one, zero = np.ones_like(yaw), np.zeros_like(yaw)
    Rz = np.stack([cy, -sy, zero, sy, cy, zero, zero, zero, one], -1).reshape(-1, 3, 3)
    Ry = np.stack([cp, zero, sp, zero, one, zero, -sp, zero, cp], -1).reshape(-1, 3, 3)
    Rx = np.stack([one, zero, zero, zero, cr, -sr, zero, sr, cr], -1).reshape(-1, 3, 3)
    return Rz @ Ry @ Rx


def trajectory(config, sim):
    """The simulator's IMU stream and ground truth (simulate_sequence's
    imu_t, imu_gyro, imu_acc, frame_t, gt_p, gt_R_i_w), every sample of
    the analytic trajectory at once, with the same finite differences."""
    traj = _Trajectory(sim)
    h = 1e-4

    def attitude(t):
        return _rotmats(*traj._angles(t))

    def pva(t):
        p = traj._pos(t)
        v = (traj._pos(t + h) - traj._pos(t - h)) / (2 * h)
        a = (traj._pos(t + h) - 2 * p + traj._pos(t - h)) / (h * h)
        return p, v, a

    imu_t = np.arange(0.0, sim.duration, 1.0 / sim.imu_rate)
    R0, R1 = attitude(imu_t - h), attitude(imu_t + h)
    W = R0.transpose(0, 2, 1) @ (R1 - R0) / (2 * h)
    W = (W - W.transpose(0, 2, 1)) / 2.0
    gyro = np.stack([W[:, 2, 1], W[:, 0, 2], W[:, 1, 0]], -1)
    _, _, a_w = pva(imu_t)
    acc = np.einsum("nji,nj->ni", attitude(imu_t), a_w - config.gravity)
    rng = np.random.default_rng(sim.seed)
    gyro = gyro + np.asarray(sim.gyro_bias) + sim.gyro_noise_std * rng.standard_normal(gyro.shape)
    acc = acc + np.asarray(sim.acc_bias) + sim.acc_noise_std * rng.standard_normal(acc.shape)
    frame_t = np.arange(0.0, sim.duration, 1.0 / sim.frame_rate)
    gt_p, _, _ = pva(frame_t)
    return dict(imu_t=imu_t, imu_gyro=gyro, imu_acc=acc, frame_t=frame_t, gt_p=gt_p,
                gt_R_i_w=attitude(frame_t))


def simulate(cfg, traffic, seed, n_seq, frames):
    """n_seq sequences of `frames` frames each: a list of dicts with the
    IMU bundles (numpy, (frames, M, ...)), the filter's static init
    (q0, bg0, gravity), ground truth (gt_p (frames, 3), gt_R_w_i
    (frames, 3, 3)) and the motion factor u. The bundling is
    simulator.bundle_frames': the first frame after init_imu_samples."""
    out = []
    n_init = cfg.filter.init_imu_samples
    for b in range(n_seq):
        seq = trajectory(cfg, sim_config(cfg, traffic, seed, b, frames))
        q0, bg, gravity = initialize_gravity_and_bias(seq["imu_gyro"][:n_init],
                                                      seq["imu_acc"][:n_init])
        imu_t = seq["imu_t"]
        first = int(np.searchsorted(seq["frame_t"], imu_t[min(n_init, len(imu_t) - 1)]))
        frames_t = seq["frame_t"][first:first + frames]
        if len(frames_t) < frames:
            raise ValueError(f"sequence {b}: {len(frames_t)} frames, need {frames}")
        gyro, acc, dts, valid = bundle_imu_stream(imu_t, seq["imu_gyro"], seq["imu_acc"],
                                                  frames_t, cfg.filter.imu_per_frame)
        out.append(dict(
            imu=dict(imu_gyro=gyro, imu_acc=acc, imu_dt=dts, imu_valid=valid),
            init=dict(q0=q0, bg0=bg, gravity=gravity),
            gt_p=seq["gt_p"][first:first + frames],
            gt_R_w_i=seq["gt_R_i_w"][first:first + frames].transpose(0, 2, 1),
            u=motion_factor(seed, b)))
    return out


def render(cfg, world, seqs, device):
    """Both cameras of every sequence rendered on `device`: (cam0, cam1),
    each (B, T, H, W) f32 in [0, 255]."""
    cams = [render_sequence(cfg, s["gt_R_w_i"], s["gt_p"], device=device, **world)
            for s in seqs]
    return (torch.stack([c[0] for c in cams]), torch.stack([c[1] for c in cams]))


def quantise(img):
    """f32 renders in [0, 255] as a camera delivers them: uint8."""
    return torch.round(img).clamp_(0, 255).to(torch.uint8)


def imu_tensors(seqs, device):
    """The IMU bundles of every sequence, stacked (B, T, ...) on `device`."""
    return {k: torch.as_tensor(np.stack([s["imu"][k] for s in seqs]), device=device)
            for k in IMU_KEYS}
