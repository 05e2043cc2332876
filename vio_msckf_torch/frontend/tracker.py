"""Stereo feature tracking front-end on a fixed-size track table.

Port of vio_msckf_tpu/frontend/tracker.py. Per frame:

  temporal KLT (gyro-predicted) -> stereo match (LK + gates)
  -> FAST detection under an occupancy mask -> per-cell top-k birth
  -> per-cell lifetime cap -> publish normalized stereo measurements.

Three hand kernels run here on a CUDA device: FAST + NMS once per frame
(ops/fast.py:fast_nms), and the LK level kernel (ops/klt.py:track_level)
for the temporal and stereo pyramids and the merged backward check.
Pyramids are plain lists of (H, W) tensors. Unlike the JAX package the
candidate block is not padded to a multiple of 8 (a TPU layout need);
the padded entries there were invalid and changed no result.
"""

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from vio_msckf_torch.config import VIOConfig
from vio_msckf_torch import full_precision
from vio_msckf_torch.math import axis_angle_to_rot, skew
from vio_msckf_torch.ops.distortion import distort_points, undistort_points
from vio_msckf_torch.ops.fast import detect_grid_features, fast_nms
from vio_msckf_torch.ops.klt import lk_verify, pyramidal_lk
from vio_msckf_torch.ops.pyramid import build_pyramid
from vio_msckf_torch.tensors import TensorRecord, drop_scatter


@dataclass
class TrackerState(TensorRecord):
    ids: torch.Tensor        # (T,) int64, -1 empty
    lifetime: torch.Tensor   # (T,) int64
    cam0_pts: torch.Tensor   # (T, 2) pixels
    cam1_pts: torch.Tensor   # (T, 2) pixels
    valid: torch.Tensor      # (T,) bool
    next_id: torch.Tensor    # () int64
    pyr_prev: list           # previous cam0 pyramid, (H/2^l, W/2^l) each
    has_prev: torch.Tensor   # () bool

    def to(self, device):
        out = super().to(device)
        return out.replace(pyr_prev=[x.to(device) for x in self.pyr_prev])


class StereoTracker:
    """Functional front-end: `step(state, images, imu) -> (state, msg)`."""

    def __init__(self, config: VIOConfig, device="cpu"):
        full_precision()
        self.config = config
        self.device = torch.device(device)
        fe = config.frontend
        cam0, cam1 = config.cam0, config.cam1
        T0 = np.linalg.inv(cam0.T_imu_cam_np)
        T1 = np.linalg.inv(cam1.T_imu_cam_np)
        R_cam0_imu, t_cam0_imu = T0[:3, :3], T0[:3, 3]
        R_cam1_imu, t_cam1_imu = T1[:3, :3], T1[:3, 3]
        R_cam0_cam1 = R_cam1_imu.T @ R_cam0_imu
        t_cam0_cam1 = R_cam1_imu.T @ (t_cam0_imu - t_cam1_imu)

        def t(a):
            return torch.as_tensor(np.asarray(a), dtype=torch.float32, device=self.device)

        self.R_cam0_imu = t(R_cam0_imu)
        self.R_cam0_cam1 = t(R_cam0_cam1)
        self.E = skew(t(t_cam0_cam1)) @ self.R_cam0_cam1
        fx0, fy0, cx0, cy0 = cam0.intrinsics
        fx1, fy1, _, _ = cam1.intrinsics
        self.norm_pixel_unit = 4.0 / (fx0 + fy0 + fx1 + fy1)
        self.K0 = t([[fx0, 0.0, cx0], [0.0, fy0, cy0], [0.0, 0.0, 1.0]])
        self.K0inv = t([[1.0 / fx0, 0.0, -cx0 / fx0], [0.0, 1.0 / fy0, -cy0 / fy0],
                        [0.0, 0.0, 1.0]])
        self.width, self.height = cam0.resolution
        self.grid_row, self.grid_col = fe.grid_row, fe.grid_col
        self.cell_h = -(-self.height // fe.grid_row)
        self.cell_w = -(-self.width // fe.grid_col)

    def init(self):
        T = self.config.frontend.max_tracks
        lv = self.config.frontend.lk_pyramid_levels
        dev = self.device
        h, w = self.height, self.width
        return TrackerState(
            ids=torch.full((T,), -1, dtype=torch.int64, device=dev),
            lifetime=torch.zeros(T, dtype=torch.int64, device=dev),
            cam0_pts=torch.zeros((T, 2), dtype=torch.float32, device=dev),
            cam1_pts=torch.zeros((T, 2), dtype=torch.float32, device=dev),
            valid=torch.zeros(T, dtype=torch.bool, device=dev),
            next_id=torch.zeros((), dtype=torch.int64, device=dev),
            pyr_prev=[torch.zeros((h // 2 ** l, w // 2 ** l), dtype=torch.float32,
                                  device=dev) for l in range(lv + 1)],
            has_prev=torch.zeros((), dtype=torch.bool, device=dev),
        )

    # -- helpers ------------------------------------------------------------

    def _in_bounds(self, pts):
        return ((pts[:, 0] >= 0) & (pts[:, 0] <= self.width - 1)
                & (pts[:, 1] >= 0) & (pts[:, 1] <= self.height - 1))

    def _cell_code(self, pts):
        row = torch.clamp(torch.div(pts[:, 1], self.cell_h, rounding_mode="floor").to(torch.int64),
                          0, self.grid_row - 1)
        col = torch.clamp(torch.div(pts[:, 0], self.cell_w, rounding_mode="floor").to(torch.int64),
                          0, self.grid_col - 1)
        return row * self.grid_col + col

    def _predict_tracking(self, pts, R_p_c):
        """H = K R_p_c K^-1 rotation compensation."""
        Hm = self.K0 @ R_p_c @ self.K0inv
        h = torch.cat([pts, torch.ones_like(pts[:, :1])], dim=1) @ Hm.T
        return h[:, 0:2] / torch.clamp(h[:, 2:3], min=1e-9)

    def _stereo_predict(self, cam0_pts):
        """Rotation-only prediction into cam1."""
        cam0, cam1 = self.config.cam0, self.config.cam1
        und = undistort_points(cam0_pts, cam0.intrinsics, cam0.distortion_model,
                               cam0.distortion_coeffs,
                               rectification_matrix=self.R_cam0_cam1)
        return distort_points(und, cam1.intrinsics, cam1.distortion_model,
                              cam1.distortion_coeffs)

    def _stereo_gates(self, cam0_pts, cam1_pts, cam1_init, back_err, active):
        """Backward consistency, vertical disparity, bounds and the
        essential-matrix epipolar gate. Returns (inliers, per-gate masks)."""
        fe = self.config.frontend
        cam0, cam1 = self.config.cam0, self.config.cam1
        ok_back = back_err < fe.stereo_backward_err_px
        ok_disp = torch.abs(cam1_init[:, 1] - cam1_pts[:, 1]) < fe.stereo_disparity_max_px
        ok_bounds = self._in_bounds(cam1_pts)
        p0n = undistort_points(cam0_pts, cam0.intrinsics, cam0.distortion_model,
                               cam0.distortion_coeffs)
        p1n = undistort_points(cam1_pts, cam1.intrinsics, cam1.distortion_model,
                               cam1.distortion_coeffs)
        ones = torch.ones_like(p0n[:, :1])
        line = torch.cat([p0n, ones], dim=1) @ self.E.T
        dot = torch.sum(torch.cat([p1n, ones], dim=1) * line, dim=1)
        line_norm = torch.linalg.vector_norm(line[:, 0:2], dim=1)
        epi_err = torch.abs(dot) / torch.clamp(line_norm, min=1e-9)
        ok_epi = epi_err <= fe.stereo_threshold * self.norm_pixel_unit
        gates = dict(back=ok_back, disparity=ok_disp, bounds=ok_bounds, epipolar=ok_epi)
        return active & ok_back & ok_disp & ok_bounds & ok_epi, gates

    @staticmethod
    def _rank_in_cell(codes, priority, entry_valid, n_cells):
        """rank[i] = number of entries in the same cell with higher
        priority (ties by index): two stable argsorts (priority desc, then
        cell) and a running max of the cell-run starts."""
        n = codes.shape[0]
        cell = torch.where(entry_valid, codes, n_cells)
        order = torch.argsort(-priority, stable=True)
        order = order[torch.argsort(cell[order], stable=True)]
        sorted_cell = cell[order]
        pos = torch.arange(n, device=codes.device)
        is_start = torch.ones(n, dtype=torch.bool, device=codes.device)
        is_start[1:] = sorted_cell[1:] != sorted_cell[:-1]
        run_start = torch.cummax(torch.where(is_start, pos, 0), dim=0).values
        return torch.zeros(n, dtype=torch.int64, device=codes.device).scatter(
            0, order, pos - run_start)

    # -- the per-frame step -------------------------------------------------

    def step(self, ts: TrackerState, cam0_img, cam1_img, imu_gyro, imu_dt, imu_valid):
        """One stereo frame. Images (H, W) uint8 or float; imu_* the
        frame's IMU bundle. Returns (state, msg) with msg feat_ids (T,),
        feat_obs (T, 4) normalized, feat_valid (T,) and diag counters."""
        cfg = self.config
        fe = cfg.frontend
        T = fe.max_tracks
        cam0, cam1 = cfg.cam0, cfg.cam1
        lk_args = (fe.lk_patch_size, fe.lk_max_iteration, fe.lk_track_precision)

        pyr0 = build_pyramid(cam0_img.to(torch.float32), fe.lk_pyramid_levels)
        pyr1 = build_pyramid(cam1_img.to(torch.float32), fe.lk_pyramid_levels)

        # --- gyro-integrated rotation prediction ---
        vmask = imu_valid[:, None]
        nvalid = torch.clamp(torch.sum(imu_valid), min=1)
        mean_w = torch.sum(torch.where(vmask, imu_gyro, torch.zeros_like(imu_gyro)),
                           dim=0) / nvalid
        dt_total = torch.sum(torch.where(imu_valid, imu_dt, torch.zeros_like(imu_dt)))
        cam0_R_p_c = axis_angle_to_rot((self.R_cam0_imu.T @ mean_w) * dt_total).T

        # --- temporal tracking ---
        pred = self._predict_tracking(ts.cam0_pts, cam0_R_p_c)
        tracked_pts, st, _ = pyramidal_lk(ts.pyr_prev, pyr0, ts.cam0_pts, pred, *lk_args)
        survived0 = ts.valid & ts.has_prev & st & self._in_bounds(tracked_pts)

        # --- detection under the occupancy mask ---
        score = fast_nms(pyr0[0], fe.fast_threshold)
        Hh, Ww = score.shape
        ix = torch.clamp(tracked_pts[:, 0].to(torch.int64), 0, Ww - 1)
        iy = torch.clamp(tracked_pts[:, 1].to(torch.int64), 0, Hh - 1)
        iy = torch.where(survived0, iy, Hh)   # row Hh is a spare, cut below
        occ = torch.zeros((Hh + 1, Ww), dtype=torch.float32, device=score.device)
        occ.index_put_((iy, ix), torch.ones_like(ix, dtype=torch.float32))
        k = 2 * fe.mask_radius + 1
        occ = F.max_pool2d(occ[None, None, :Hh], k, stride=1, padding=fe.mask_radius)[0, 0]
        mask = occ == 0.0

        cand_xy, cand_resp, cand_valid = detect_grid_features(
            score, mask, self.grid_row, self.grid_col, fe.grid_max_feature_num)
        C = self.grid_row * self.grid_col * fe.grid_max_feature_num
        cand_xy = cand_xy.reshape(C, 2)
        cand_resp = cand_resp.reshape(C)
        cand_valid = cand_valid.reshape(C)

        # --- stereo matching: survivors + candidates in one pass ---
        sm_pts = torch.cat([tracked_pts, cand_xy], dim=0)
        sm_active = torch.cat([survived0, cand_valid], dim=0)
        cam1_init = self._stereo_predict(sm_pts)
        sm_cam1, st_fwd, _ = pyramidal_lk(pyr0, pyr1, sm_pts, cam1_init, *lk_args)

        # --- one finest-level pass for both backward checks ---
        (tb_pts, tb_st, _), (sb_pts, sb_st, _) = lk_verify(
            pyr0, ts.pyr_prev,           # pair A: curr0 -> prev0
            pyr1, pyr0,                  # pair B: curr1 -> curr0
            tracked_pts, ts.cam0_pts, sm_cam1, sm_pts, *lk_args)
        fb_err = torch.linalg.vector_norm(tb_pts - ts.cam0_pts, dim=1)
        fb_ok = tb_st & (fb_err < fe.temporal_backward_err_px)
        survived = survived0 & fb_ok

        sm_back_err = torch.linalg.vector_norm(sb_pts - sm_pts, dim=1)
        sm_back_err = torch.where(sb_st, sm_back_err, torch.full_like(sm_back_err, float("inf")))
        sm_match, sm_gates = self._stereo_gates(sm_pts, sm_cam1, cam1_init, sm_back_err,
                                                sm_active & st_fwd)
        cam1_pts, cand_cam1 = sm_cam1[:T], sm_cam1[T:]
        match, cand_match = sm_match[:T], sm_match[T:]
        survived = survived & match
        lifetime = torch.where(survived, ts.lifetime + 1, torch.zeros_like(ts.lifetime))
        n_cells = self.grid_row * self.grid_col
        cand_rank = self._rank_in_cell(self._cell_code(cand_xy), cand_resp, cand_match, n_cells)
        birth = cand_match & (cand_rank < fe.grid_min_feature_num)

        # --- per-cell lifetime cap over survivors + births ---
        all_pts = torch.cat([tracked_pts, cand_xy], dim=0)
        all_valid = torch.cat([survived, birth], dim=0)
        all_life = torch.cat([lifetime, torch.ones_like(cand_rank)], dim=0)
        rank = self._rank_in_cell(self._cell_code(all_pts), all_life.to(torch.float32),
                                  all_valid, n_cells)
        keep = all_valid & (rank < fe.grid_max_feature_num)

        # --- rebuild the table: survivors keep ids, births get new ids ---
        keep_t, keep_c = keep[:T], keep[T:]
        n_keep_t = torch.sum(keep_t)
        birth_order = torch.cumsum(keep_c.to(torch.int64), dim=0) - 1
        new_ids = ts.next_id + birth_order
        slot_t = torch.where(keep_t, torch.cumsum(keep_t.to(torch.int64), dim=0) - 1, T)
        slot_c = torch.where(keep_c, n_keep_t + birth_order, T)

        dev = ts.ids.device
        ids = torch.full((T,), -1, dtype=torch.int64, device=dev)
        ids = drop_scatter(drop_scatter(ids, slot_t, ts.ids), slot_c, new_ids)
        life_new = torch.zeros(T, dtype=torch.int64, device=dev)
        life_new = drop_scatter(drop_scatter(life_new, slot_t, lifetime), slot_c, 1)
        p0 = torch.zeros((T, 2), dtype=torch.float32, device=dev)
        p0 = drop_scatter(drop_scatter(p0, slot_t, tracked_pts), slot_c, cand_xy)
        p1 = torch.zeros((T, 2), dtype=torch.float32, device=dev)
        p1 = drop_scatter(drop_scatter(p1, slot_t, cam1_pts), slot_c, cand_cam1)
        n_births = torch.sum(keep_c)
        valid_new = torch.arange(T, device=dev) < n_keep_t + n_births

        new_state = TrackerState(
            ids=ids, lifetime=life_new, cam0_pts=p0, cam1_pts=p1, valid=valid_new,
            next_id=ts.next_id + n_births, pyr_prev=pyr0,
            has_prev=torch.ones_like(ts.has_prev),
        )

        # --- publish normalized measurements ---
        und0 = undistort_points(p0, cam0.intrinsics, cam0.distortion_model,
                                cam0.distortion_coeffs)
        und1 = undistort_points(p1, cam1.intrinsics, cam1.distortion_model,
                                cam1.distortion_coeffs)
        obs = torch.cat([und0, und1], dim=1)

        # --- per-gate kill attribution, in cascade order ---
        reached = sm_active
        alive = reached & st_fwd
        diag = {"kill_lk": torch.sum(reached & ~st_fwd)}
        for name in ("back", "disparity", "bounds", "epipolar"):
            ok = sm_gates[name]
            diag[f"kill_{name}"] = torch.sum(alive & ~ok)
            alive = alive & ok
        diag.update(
            n_prev=torch.sum(ts.valid & ts.has_prev),
            kill_fwdbwd=torch.sum(survived0 & ~fb_ok),
            n_survived=torch.sum(survived),
            n_births=n_births,
        )
        return new_state, dict(feat_ids=ids, feat_obs=obs, feat_valid=valid_new, diag=diag)
