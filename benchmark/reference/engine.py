"""The full VIO engine: stereo front-end + MSCKF back-end, one frame per
step. The benchmark's frozen copy of vio_msckf_torch/engine.py, eager only.

`step_batch` advances B independent sequences by one frame (B is the
frames' leading axis), as the port's step does before it is captured as a
CUDA graph; `run_batch` steps it frame by frame. There is no graph, no
block group and no hand kernel here: the plain twins run on any device.
"""

import dataclasses

import torch

from benchmark.reference import capturable_linalg
from benchmark.reference.config import VIOConfig
from benchmark.reference.filter.msckf import MSCKF
from benchmark.reference.frontend.tracker import StereoTracker


class VIOEngine:
    def __init__(self, config: VIOConfig, device="cuda", dtype=torch.float32):
        self.config = config
        self.device = torch.device(device)
        self.tracker = StereoTracker(config, self.device)
        self.kf = MSCKF(config, self.device, dtype)

    def init_batch(self, inits):
        """Fresh batched (tracker, filter, feature-map) carry for len(inits)
        sequences; each entry is a dict whose q0 / bg0 / gravity (each
        optional) come from the static gravity-and-bias initialization."""
        state, fmap = self.kf.init_batch(inits)
        return (self.tracker.init(len(inits)), state, fmap)

    @capturable_linalg()
    def step_batch(self, carry, frame):
        """One stereo frame of every sequence. frame keys: cam0_img
        (B,H,W), cam1_img (B,H,W), imu_gyro (B,M,3), imu_acc (B,M,3), imu_dt
        (B,M), imu_valid (B,M). Returns (carry, FilterOutput with leading
        B)."""
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

    def run_batch(self, carry, frames):
        """Step B sequences over frames stacked (B, T, ...); returns (carry,
        outputs (B, T, ...))."""
        outs = []
        for k in range(frames["imu_dt"].shape[1]):
            carry, out = self.step_batch(carry, {key: v[:, k] for key, v in frames.items()})
            outs.append(out)
        return carry, _stack(outs)


def _stack(outs):
    """Records of one frame each -> one record stacked on axis 1."""
    return dataclasses.replace(outs[0], **{
        f.name: torch.stack([getattr(o, f.name) for o in outs], dim=1)
        for f in dataclasses.fields(outs[0])})
