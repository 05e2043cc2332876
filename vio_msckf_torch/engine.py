"""The full VIO engine: stereo front-end + MSCKF back-end, one frame per
`step`. Port of vio_msckf_tpu/engine.py.

A step issues no host synchronisation: every data-dependent loop and
branch of the reference is a fixed-cap masked loop, a select, or runs
inside a kernel, so the host can queue frames ahead of the device.
"""

import torch

from vio_msckf_torch.config import VIOConfig
from vio_msckf_torch.filter.msckf import MSCKF, stack_outputs
from vio_msckf_torch.frontend.tracker import StereoTracker


class VIOEngine:
    def __init__(self, config: VIOConfig, device="cpu", dtype=torch.float32):
        self.config = config
        self.device = torch.device(device)
        self.tracker = StereoTracker(config, self.device)
        self.kf = MSCKF(config, self.device, dtype)

    def init(self, q0=None, bg0=None, gravity=None):
        """Fresh (tracker, filter, feature-map) carry."""
        state, fmap = self.kf.init(q0, bg0, gravity)
        return (self.tracker.init(), state, fmap)

    def reset(self, carry):
        """Full system reset: fresh tracker state and a fresh filter that
        keeps the current extrinsics estimate."""
        _, state, fmap = carry
        state, fmap = self.kf.reset(state, fmap)
        return (self.tracker.init(), state, fmap)

    def step(self, carry, frame):
        """One stereo frame end to end. frame keys: cam0_img (H,W),
        cam1_img (H,W), imu_gyro (M,3), imu_acc (M,3), imu_dt (M,),
        imu_valid (M,)."""
        ts, state, fmap = carry
        ts, msg = self.tracker.step(ts, frame["cam0_img"], frame["cam1_img"],
                                    frame["imu_gyro"], frame["imu_dt"],
                                    frame["imu_valid"])
        kf_frame = dict(imu_gyro=frame["imu_gyro"], imu_acc=frame["imu_acc"],
                        imu_dt=frame["imu_dt"], imu_valid=frame["imu_valid"],
                        feat_ids=msg["feat_ids"], feat_obs=msg["feat_obs"],
                        feat_valid=msg["feat_valid"])
        (state, fmap), out = self.kf.step((state, fmap), kf_frame)
        return (ts, state, fmap), out

    def run_sequence(self, carry, frames):
        """Step over frames stacked on axis 0; returns (carry, outputs
        stacked on axis 0)."""
        n = frames["cam0_img"].shape[0]
        outs = []
        for k in range(n):
            carry, out = self.step(carry, {key: v[k] for key, v in frames.items()})
            outs.append(out)
        return carry, stack_outputs(outs)
