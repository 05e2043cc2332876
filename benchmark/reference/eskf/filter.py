"""18-state error-state Kalman filter core (Sola-style ESKF). Port of
vio_msckf_tpu/eskf/filter.py, after the reference's loosely-coupled
filter (ESKF/vio.py:11-162, driven by ESKF/eskf_vio.py:94-166):

  * error state x = (dp, dv, dtheta, da_b, dw_b, dg) in R^18;
  * the nominal state carries the rotation as a 3x3 matrix (camera ->
    world);
  * IMU propagation is a masked loop over the padded per-frame IMU slice:
    a padded sample has dt = 0, which makes both steps the identity;
  * the per-feature measurement updates are the reference's SEQUENTIAL
    relinearized EKF steps (eskf_vio.py:136-153): each reads the state the
    last one wrote, so they stay a loop over the padded feature axis with
    masked writes and cannot be batched without changing the result.

Every branch of the reference is a select on the device: a step never
synchronises the host. All dynamics and measurement equations follow
ESKF/vio.py:40-162.
"""

from dataclasses import dataclass

import numpy as np
import torch

from benchmark.reference.math import axis_angle_to_rot, skew
from benchmark.reference.tensors import TensorRecord


@dataclass
class EskfParams:
    gyro_noise: float           # gyroscope_noise_density
    acc_noise: float            # accelerometer_noise_density
    gyro_walk: float            # gyroscope_random_walk
    acc_walk: float             # accelerometer_random_walk
    meas_cov: torch.Tensor      # (2, 2) image measurement covariance Q
    error_threshold: float      # innovation gate (normalized units)


@dataclass
class EskfState(TensorRecord):
    """Nominal state; rotation R maps camera -> world (ESKF/vio.py:25-27)."""

    p: torch.Tensor    # (3,)
    v: torch.Tensor    # (3,)
    R: torch.Tensor    # (3, 3)
    a_b: torch.Tensor  # (3,)
    w_b: torch.Tensor  # (3,)
    g: torch.Tensor    # (3,)


def init_state(g0, device="cuda", dtype=torch.float32):
    """Zero pose/velocity/biases; gravity from the first accelerometer
    sample scaled to -9.8 (eskf_vio.py:77-79)."""
    z = torch.zeros(3, dtype=dtype, device=device)
    return EskfState(p=z, v=z.clone(), R=torch.eye(3, dtype=dtype, device=device),
                     a_b=z.clone(), w_b=z.clone(),
                     g=torch.as_tensor(np.asarray(g0), dtype=dtype, device=device))


def init_covariance(device="cuda", dtype=torch.float32):
    """Reference initial sigma diag (eskf_vio.py:84)."""
    diag = np.array([
        0, 0, 0, 0.2, 0.2, 0.2, 0.1, 0.1, 0.1,
        0.25, 0.25, 0.25, 0.02, 0.02, 0.02, 0, 0, 0,
    ])
    return torch.as_tensor(np.diag(diag), dtype=dtype, device=device)


def _nominal_step(s: EskfState, w_m, a_m, dt):
    """Nominal-state integration (ESKF/vio.py:11-37)."""
    acc_w = s.R @ (a_m - s.a_b) + s.g
    p = s.p + s.v * dt + 0.5 * dt * dt * acc_w
    v = s.v + acc_w * dt
    dR = axis_angle_to_rot((w_m - s.w_b) * dt)
    return s.replace(p=p, v=v, R=s.R @ dR)


def _covariance_step(s: EskfState, P, w_m, a_m, dt, params: EskfParams, eye18):
    """Error covariance propagation P <- Fx P Fx^T + Fi Qi Fi^T
    (ESKF/vio.py:40-105), Fx built densely (18x18)."""
    I3 = eye18[:3, :3]
    R = s.R
    a_hat = skew(a_m - s.a_b)
    Rw = axis_angle_to_rot((w_m - s.w_b) * dt)

    Fx = eye18.clone()
    Fx[0:3, 3:6] = dt * I3
    Fx[3:6, 6:9] = -(R @ a_hat) * dt
    Fx[3:6, 9:12] = -R * dt
    Fx[3:6, 15:18] = dt * I3
    Fx[6:9, 6:9] = Rw.T
    Fx[6:9, 12:15] = -dt * I3

    P = Fx @ P @ Fx.T
    # Fi Qi Fi^T is block-diagonal on (v, theta, a_b, w_b).
    dt2 = dt * dt
    noise = torch.cat([
        torch.zeros(3, dtype=P.dtype, device=P.device),
        (params.acc_noise ** 2 * dt2).expand(3),
        (params.gyro_noise ** 2 * dt2).expand(3),
        (params.acc_walk ** 2 * dt).expand(3),
        (params.gyro_walk ** 2 * dt).expand(3),
        torch.zeros(3, dtype=P.dtype, device=P.device)])
    return P + torch.diag(noise)


def propagate(state: EskfState, P, gyro, acc, dt, valid, params: EskfParams):
    """Step the nominal state and covariance over a padded IMU slice.

    gyro/acc: (M, 3) already expressed in the camera frame (the reference
    rotates IMU samples by R_LB up front, eskf_vio.py:106-107); dt (M,);
    valid (M,) masks padding."""
    eye18 = torch.eye(18, dtype=P.dtype, device=P.device)
    dt = torch.where(valid, dt, torch.zeros_like(dt))
    for i in range(gyro.shape[0]):
        # dt == 0 makes both updates the identity; masking keeps shapes static.
        P2 = _covariance_step(state, P, gyro[i], acc[i], dt[i], params, eye18)
        state = _nominal_step(state, gyro[i], acc[i], dt[i])
        P = P2
    return state, P


def _inv2(S):
    """Inverse of a 2x2 matrix in closed form. The determinant comes from
    f64 products, which are exact for f32 entries: S is nearly singular
    when the two image rows of H are nearly parallel, and an f32 a*d - b*c
    then loses the digits the gain needs (a single update moved 1e-5
    relative against the reference's LU inverse)."""
    S64 = S.to(torch.float64)
    det = (S64[0, 0] * S64[1, 1] - S64[0, 1] * S64[1, 0]).to(S.dtype)
    a, b, c, d = S[0, 0], S[0, 1], S[1, 0], S[1, 1]
    return torch.stack([torch.stack([d, -b]), torch.stack([-c, a])]) / det


def _one_update(s: EskfState, P, uv, Pw, params: EskfParams, eye18):
    """Single-feature relinearized EKF update (ESKF/vio.py:108-162).

    Returns (candidate state, candidate P, innovation, accept): the update
    applies only when the innovation passes the gate, like the reference's
    if-branch; the caller selects."""
    R = s.R
    Pc = R.T @ (Pw - s.p)
    z = Pc[2]
    safe_z = torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    uv_pred = Pc[:2] / safe_z
    innovation = uv - uv_pred

    accept = (torch.linalg.vector_norm(innovation) < params.error_threshold) & (z > 1e-6)

    # d(uv)/d(Pc) = 1/z * [[1,0,-u],[0,1,-v]]
    d_zt_d_Pc = (eye18[:2, :3] - eye18[2, :3] * uv_pred[:, None]) / safe_z

    H = torch.cat([d_zt_d_Pc @ (-R.T), torch.zeros_like(d_zt_d_Pc),
                   d_zt_d_Pc @ skew(Pc), torch.zeros((2, 9), dtype=P.dtype,
                                                      device=P.device)], dim=1)

    S = H @ P @ H.T + params.meas_cov
    K = P @ H.T @ _inv2(S)
    dx = K @ innovation

    IKH = eye18 - K @ H
    P_new = IKH @ P @ IKH.T + K @ params.meas_cov @ K.T  # Joseph form

    s_new = s.replace(
        p=s.p + dx[0:3],
        v=s.v + dx[3:6],
        R=R @ axis_angle_to_rot(dx[6:9]),
        a_b=s.a_b + dx[9:12],
        w_b=s.w_b + dx[12:15],
        g=s.g + dx[15:18],
    )
    return s_new, P_new, innovation, accept


def _where(pred, a, b):
    return type(a)(**{k: torch.where(pred, getattr(a, k), getattr(b, k))
                      for k in a.__dataclass_fields__})


def update_features(state: EskfState, P, uvd1, uvd2, valid, last_R, last_t,
                    params: EskfParams):
    """Sequential per-feature updates over the padded match table.

    uvd1/uvd2: (K, 3) normalized (u, v, d) at the previous/current frame
    (d = disparity / (f * baseline), so depth = 1/d — stereo.py:338-373);
    the world point is back-projected through the LAST stereo pose
    (eskf_vio.py:137-146), which no update changes, so all K points are
    computed up front. Returns (state, P, innovations (K, 2))."""
    eye18 = torch.eye(18, dtype=P.dtype, device=P.device)
    d1 = uvd1[:, 2]
    ok = valid & (d1 > 0)  # eskf_vio.py:140
    safe_d = torch.where(ok, d1, torch.ones_like(d1))
    P1 = torch.stack([uvd1[:, 0] / safe_d, uvd1[:, 1] / safe_d, 1.0 / safe_d], dim=-1)
    Pw = (last_R @ P1[..., None])[..., 0] + last_t
    zero = torch.zeros((), dtype=P.dtype, device=P.device)
    innovations = []
    for i in range(uvd1.shape[0]):
        s2, P2, inno, accept = _one_update(state, P, uvd2[i, :2], Pw[i], params, eye18)
        take = ok[i] & accept
        state = _where(take, s2, state)
        P = torch.where(take, P2, P)
        innovations.append(torch.where(ok[i], inno, zero))
    return state, P, torch.stack(innovations)


def eskf_frame_step(state: EskfState, P, frame, params: EskfParams):
    """One image-clocked ESKF step: the IMU loop, then the stereo feature
    updates.

    frame: dict with imu_gyro/imu_acc (M,3) in camera frame, imu_dt (M,),
    imu_valid (M,), uvd1/uvd2 (K,3), match_valid (K,), last_R (3,3),
    last_t (3,)."""
    state, P = propagate(state, P, frame["imu_gyro"], frame["imu_acc"], frame["imu_dt"],
                         frame["imu_valid"], params)
    return update_features(state, P, frame["uvd1"], frame["uvd2"], frame["match_valid"],
                           frame["last_R"], frame["last_t"], params)
