"""Host-side IMU bundling: slice a raw IMU stream into per-frame padded
bundles. The port's copy of vio_msckf_tpu/data/bundling.py (numpy).

Each frame consumes the samples in (state_ts, frame_ts]; dt chains from
the previous consumed sample; the first frame consumes nothing.
"""

import warnings

import numpy as np


def bundle_imu_stream(imu_t, gyro_s, acc_s, frames_t, max_per_frame):
    """Pad per-frame IMU slices into fixed (Nf, M, ...) arrays.

    imu_t: (S,) sample timestamps. gyro_s/acc_s: (S, 3). frames_t: (Nf,)
    frame timestamps. Returns (gyro (Nf,M,3), acc (Nf,M,3), dt (Nf,M),
    valid (Nf,M)) float32/bool.

    A frame with more than M pending samples (e.g. after a dropped camera
    frame) consumes the first M; the rest are integrated by the next
    frame, so no sample is lost, and the overflow is surfaced as a
    warning.
    """
    M = max_per_frame
    Nf = len(frames_t)
    gyro = np.zeros((Nf, M, 3), np.float32)
    acc = np.zeros((Nf, M, 3), np.float32)
    dts = np.zeros((Nf, M), np.float32)
    valid = np.zeros((Nf, M), bool)

    if Nf == 0:
        return gyro, acc, dts, valid

    overflow_frames = 0
    imu_t = np.asarray(imu_t)
    state_ts = frames_t[0]
    ptr = int(np.searchsorted(imu_t, state_ts, side="left"))
    for k in range(1, Nf):  # the first frame processes no IMU
        end = int(np.searchsorted(imu_t, frames_t[k], side="right"))
        take = end - ptr
        if take > M:
            overflow_frames += 1
            take = M
        if take > 0:
            a, b = ptr, ptr + take
            ts = imu_t[a:b]
            gyro[k, :take] = gyro_s[a:b]
            acc[k, :take] = acc_s[a:b]
            dts[k, 0] = ts[0] - state_ts
            dts[k, 1:take] = np.diff(ts)
            valid[k, :take] = True
            state_ts = ts[-1] + 1e-9
            ptr = b
    if overflow_frames:
        warnings.warn(
            f"{overflow_frames}/{Nf} frames had more than {M} pending IMU "
            "samples (dropped camera frames?); extras were deferred to the "
            "next frame. Raise FilterConfig.imu_per_frame for headroom.",
            stacklevel=2,
        )
    return gyro, acc, dts, valid
