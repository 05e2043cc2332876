"""End-to-end ESKF VIO pipeline: rectified ORB stereo front-end + 18-state
error-state filter, one frame per `step`. Port of
vio_msckf_tpu/eskf/pipeline.py, after the reference's script pipeline
(ESKF/eskf_vio.py:94-166 with ESKF/stereo.py:156-373):

  * cv2 stereoRectify/remap     -> ops/rectify.py (setup on the host once,
                                   both views warped in one gather);
  * cv2 ORB_create + BFMatcher  -> ops/orb.py (oriented FAST on the FAST
                                   kernel, both views in one launch;
                                   steered BRIEF; Hamming matching as one
                                   matrix product; crossCheck = mutual
                                   argmin);
  * the per-frame Python loop interleaving IMU and image events
                                -> frame bundles carrying a padded IMU
                                   slice;
  * the per-feature Python EKF loop -> a masked loop (eskf/filter.py).

Fixed shapes throughout: K keypoints per image (grid top-k), K stereo
matches, K temporal matches, with validity masks instead of dynamic
lists. The benchmark's frozen copy of vio_msckf_torch/eskf/pipeline.py:
`run_sequence` steps eagerly, frame by frame, with the plain twins.
"""

from dataclasses import dataclass

import numpy as np
import torch

from benchmark.reference import capturable_linalg
from benchmark.reference.config import VIOConfig, euroc_config
from benchmark.reference.eskf.filter import (
    EskfParams,
    eskf_frame_step,
    init_covariance,
    init_state,
)
from benchmark.reference.ops.orb import detect_and_describe, match_crosscheck
from benchmark.reference.ops.rectify import rectify_map, stereo_rectify, warp_bilinear
from benchmark.reference.tensors import TensorRecord


@dataclass(frozen=True)
class EskfConfig:
    """Front-end + filter knobs (reference values where they exist)."""

    fast_threshold: float = 20.0
    grid_row: int = 8
    grid_col: int = 8
    per_cell: int = 8                 # K = row*col*per_cell keypoints
    match_max_hamming: float = 64.0
    stereo_row_gate_px: float = 2.0   # |v_l - v_r| < 2 (stereo.py:283)
    pixel_sigma: float = 0.5          # image noise sigma in px (eskf_vio.py:67)
    error_threshold_px: float = 10.0  # innovation gate in px (eskf_vio.py:68)
    imu_per_frame: int = 16           # padded IMU samples per frame

    @property
    def n_keypoints(self):
        return self.grid_row * self.grid_col * self.per_cell


@dataclass
class FrontendFrame(TensorRecord):
    """Per-frame front-end product kept in the carry for temporal matching:
    the previous frame's left-image descriptors and stereo-matched
    normalized uvd coordinates."""

    bits: torch.Tensor    # (K, 256) bool — left-image descriptors
    uvd: torch.Tensor     # (K, 3) normalized (u, v, d)
    valid: torch.Tensor   # (K,) bool — survived the stereo gates


class EskfVio:
    """The full secondary pipeline.

        vio = EskfVio(vio_config)                  # device="cuda"
        carry = vio.init(first_acc_sample_imu_frame)
        carry, out = vio.step(carry, frame)         # images + IMU slice

    frame keys: cam0_img, cam1_img (H, W) (any dtype; cast to f32);
    imu_gyro, imu_acc (M, 3) in the IMU/body frame; imu_dt (M,);
    imu_valid (M,).
    """

    def __init__(self, config: VIOConfig = None, eskf: EskfConfig = None, device="cuda",
                 dtype=torch.float32):
        self.config = config or euroc_config()
        self.eskf = eskf or EskfConfig()
        self.device = torch.device(device)
        self.dtype = dtype

        cfg = self.config
        rect = stereo_rectify(cfg.cam0, cfg.cam1, cfg.T_cn_cnm1)
        self.K_new = rect["K_new"]
        self.baseline = rect["baseline"]
        # Both views' inverse maps as one (2, H, W, 2) stack.
        self._maps = torch.stack([
            rectify_map(cfg.cam0, rect["R_rect0"], self.K_new, self.device),
            rectify_map(cfg.cam1, rect["R_rect1"], self.K_new, self.device)])

        # IMU samples are rotated into the RECTIFIED left camera frame up
        # front, like the reference's R_LB (eskf_vio.py:44,106-107).
        T_imu_cam0 = cfg.cam0.T_imu_cam_np
        self.R_imu_rect = np.asarray(rect["R_rect0"] @ T_imu_cam0[:3, :3], np.float64)
        self._R_ic = torch.as_tensor(self.R_imu_rect, dtype=dtype, device=self.device)

        f = self.K_new[0]
        self.params = EskfParams(
            gyro_noise=cfg.noise.gyro_noise ** 0.5,
            acc_noise=cfg.noise.acc_noise ** 0.5,
            gyro_walk=cfg.noise.gyro_bias_noise ** 0.5,
            acc_walk=cfg.noise.acc_bias_noise ** 0.5,
            meas_cov=torch.eye(2, dtype=dtype, device=self.device)
            * (self.eskf.pixel_sigma / f) ** 2,
            error_threshold=self.eskf.error_threshold_px / f,
        )

    # ---------------------------------------------------------------- #

    def init(self, first_acc_imu):
        """carry = (state, P, prev_frontend, last_R, last_t).

        first_acc_imu: one accelerometer sample in the IMU frame; gravity
        is initialized from it like eskf_vio.py:77-79."""
        g = self.R_imu_rect @ np.asarray(first_acc_imu, np.float64)
        gn = np.linalg.norm(g)
        if not gn > 1e-6:
            raise ValueError(
                "first accelerometer sample is ~zero; pass a real static-phase "
                "IMU sample (the reference seeds gravity from it, eskf_vio.py:77-79)")
        g = g * (-9.8 / gn)
        dev, dt = self.device, self.dtype
        state = init_state(g.astype(np.float32), dev, dt)
        P = init_covariance(dev, dt)
        K = self.eskf.n_keypoints
        prev = FrontendFrame(
            bits=torch.zeros((K, 256), dtype=torch.bool, device=dev),
            uvd=torch.zeros((K, 3), dtype=dt, device=dev),
            valid=torch.zeros((K,), dtype=torch.bool, device=dev),
        )
        return (state, P, prev, torch.eye(3, dtype=dt, device=dev),
                torch.zeros(3, dtype=dt, device=dev))

    # ---------------------------------------------------------------- #

    def rectify(self, img0, img1):
        """Both views rectified, as one (2, H, W) f32 stack."""
        return warp_bilinear(torch.stack([img0, img1]).to(torch.float32), self._maps)

    def _stereo_frontend(self, img0, img1):
        """Rectify, detect+describe both views, stereo-gate matches.

        Returns a FrontendFrame of the left keypoints that found a valid
        stereo partner (normalized uvd per stereo.py:338-373)."""
        e = self.eskf
        rect = self.rectify(img0, img1)
        xy, _, bits, _, v = detect_and_describe(rect, e.fast_threshold, e.grid_row,
                                                e.grid_col, e.per_cell)
        xy0, xy1 = xy[0], xy[1]
        idx1, _, matched = match_crosscheck(bits[0], v[0], bits[1], v[1],
                                            e.match_max_hamming)
        xy1m = xy1[idx1]
        # Stereo gates: same row (<2 px) and positive disparity u_l >= u_r
        # (stereo.py:282-284).
        row_ok = torch.abs(xy0[:, 1] - xy1m[:, 1]) < e.stereo_row_gate_px
        disp = xy0[:, 0] - xy1m[:, 0]
        ok = matched & row_ok & (disp >= 0.0)

        fxn, fyn, cxn, cyn = self.K_new
        uvd = torch.stack([
            (xy0[:, 0] - cxn) / fxn,
            (xy0[:, 1] - cyn) / fyn,
            disp / (fxn * self.baseline),
        ], dim=-1)
        return FrontendFrame(bits=bits[0], uvd=uvd, valid=ok)

    @capturable_linalg()
    def step(self, carry, frame):
        """One stereo frame end to end. Returns (carry, out): out holds the
        nominal state (p, v, R, a_b, w_b, g), cov_trace, n_matches and
        n_inliers as the JAX package's does, and n_stereo (left keypoints
        with a gated stereo partner), as tensors on the device. Its linear
        algebra is the captured step's (graph.py: capturable_linalg)."""
        state, P, prev, last_R, last_t = carry

        cur = self._stereo_frontend(frame["cam0_img"], frame["cam1_img"])

        # Temporal left-left descriptor matching (stereo.py:317-330).
        idx2, _, tmatched = match_crosscheck(prev.bits, prev.valid, cur.bits, cur.valid,
                                             self.eskf.match_max_hamming)
        uvd1 = prev.uvd
        uvd2 = cur.uvd[idx2]
        match_valid = tmatched & cur.valid[idx2]

        R_ic = self._R_ic
        kf_frame = dict(
            imu_gyro=frame["imu_gyro"] @ R_ic.T,
            imu_acc=frame["imu_acc"] @ R_ic.T,
            imu_dt=frame["imu_dt"],
            imu_valid=frame["imu_valid"],
            uvd1=uvd1,
            uvd2=uvd2,
            match_valid=match_valid,
            last_R=last_R,
            last_t=last_t,
        )
        state, P, innovations = eskf_frame_step(state, P, kf_frame, self.params)

        # "These variables encode last stereo pose" (eskf_vio.py:164-166).
        carry = (state, P, cur, state.R, state.p)

        inno_norm = torch.linalg.vector_norm(innovations, dim=-1)
        n_matches = torch.sum(match_valid)
        inliers = torch.sum(match_valid & (inno_norm < self.params.error_threshold))
        out = dict(
            p=state.p,
            v=state.v,
            R=state.R,
            a_b=state.a_b,
            w_b=state.w_b,
            g=state.g,
            cov_trace=torch.trace(P),
            n_matches=n_matches,
            n_inliers=inliers,
            n_stereo=torch.sum(cur.valid),
        )
        return carry, out

    def run_sequence(self, carry, frames):
        """Step over frames stacked on axis 0; returns (carry, outputs
        stacked on axis 0)."""
        outs = []
        for k in range(frames["imu_dt"].shape[0]):
            carry, out = self.step(carry, {key: v[k] for key, v in frames.items()})
            outs.append(out)
        return carry, {key: torch.stack([o[key] for o in outs]) for key in outs[0]}
