"""Fixed-shape filter state: tensor dataclasses for the estimator.

Port of vio_msckf_tpu/filter/state.py. One constant-size covariance of
dimension ``D = 21 + 6 * N_MAX`` with an active-clone count; augmentation
writes a block, pruning permutes, nothing reallocates. The feature map is a
table of ``F_MAX`` slots whose observations are indexed by clone slot.

Error-state layout:
  [0:3]   dtheta (IMU attitude)      [3:6]   gyro bias
  [6:9]   velocity                   [9:12]  acc bias
  [12:15] position                   [15:18] extrinsic rotation
  [18:21] extrinsic translation      [21+6k : 27+6k] clone k (dtheta, dp)
"""

from dataclasses import dataclass

import numpy as np
import torch

from vio_msckf_torch.config import VIOConfig
from vio_msckf_torch.tensors import TensorRecord


@dataclass
class FilterState(TensorRecord):
    """IMU + extrinsics + clone window + covariance."""

    q: torch.Tensor            # (4,)  JPL world->IMU
    p: torch.Tensor            # (3,)  IMU position in world
    v: torch.Tensor            # (3,)  IMU velocity in world
    bg: torch.Tensor           # (3,)  gyro bias
    ba: torch.Tensor           # (3,)  acc bias
    R_imu_cam0: torch.Tensor   # (3,3) vec_imu -> vec_cam0
    t_cam0_imu: torch.Tensor   # (3,)  cam0 origin in IMU frame
    q_null: torch.Tensor       # (4,)  OC-EKF nullspace anchors
    p_null: torch.Tensor       # (3,)
    v_null: torch.Tensor       # (3,)
    gravity: torch.Tensor      # (3,)  gravity in world
    clone_q: torch.Tensor      # (N, 4) world->cam0
    clone_p: torch.Tensor      # (N, 3) cam0 position in world
    clone_q_null: torch.Tensor  # (N, 4)
    clone_p_null: torch.Tensor  # (N, 3)
    clone_valid: torch.Tensor  # (N,) bool
    n_clones: torch.Tensor     # () int64 active count; slot order = age order
    P: torch.Tensor            # (D, D), inactive rows/cols zero
    tracking_rate: torch.Tensor  # () f32


@dataclass
class FeatureMap(TensorRecord):
    """Fixed-slot feature map."""

    fid: torch.Tensor          # (F,) int64 external feature id, -1 empty
    valid: torch.Tensor        # (F,) bool slot occupied
    obs: torch.Tensor          # (F, N, 4) normalized stereo obs per clone slot
    obs_valid: torch.Tensor    # (F, N) bool
    position: torch.Tensor     # (F, 3) triangulated world position
    initialized: torch.Tensor  # (F,) bool


@dataclass
class MsckfParams(TensorRecord):
    """Device constants derived from the config."""

    R_cam0_cam1: torch.Tensor     # (3,3) vec_cam0 -> vec_cam1
    t_cam0_cam1: torch.Tensor     # (3,)
    continuous_noise: torch.Tensor  # (12,) diagonal of Q_c
    observation_noise: float
    chi2_table: torch.Tensor      # (100,) chi2.ppf(0.05, dof), dof = index
    init_cov_diag: torch.Tensor   # (21,)
    calib_R_imu_cam0: torch.Tensor  # (3,3) calibrated extrinsics, the
    calib_t_cam0_imu: torch.Tensor  # (3,)  online reset's fallback
    config: VIOConfig


def chi2_table(size=100):
    """chi2.ppf(0.05, dof) for dof = 0..size-1 (entry 0 unused): the
    reference's lenient 0.05-quantile gate."""
    from scipy.stats import chi2

    table = np.zeros(size)
    table[1:] = chi2.ppf(0.05, np.arange(1, size))
    return table


def make_params(config: VIOConfig, device="cpu", dtype=torch.float32) -> MsckfParams:
    """Build the filter's numeric constants from a config."""
    T01 = config.T_cn_cnm1_np
    n = config.noise
    cont = np.concatenate([
        np.full(3, n.gyro_noise), np.full(3, n.gyro_bias_noise),
        np.full(3, n.acc_noise), np.full(3, n.acc_bias_noise),
    ])
    diag = np.zeros(21)
    diag[3:6] = n.gyro_bias_cov
    diag[6:9] = n.velocity_cov
    diag[9:12] = n.acc_bias_cov
    diag[15:18] = n.extrinsic_rotation_cov
    diag[18:21] = n.extrinsic_translation_cov

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    R_ic, t_ci = calib_extrinsics(config)
    return MsckfParams(
        R_cam0_cam1=t(T01[:3, :3]),
        t_cam0_cam1=t(T01[:3, 3]),
        continuous_noise=t(cont),
        observation_noise=float(n.observation_noise),
        chi2_table=t(chi2_table()),
        init_cov_diag=t(diag),
        calib_R_imu_cam0=t(R_ic),
        calib_t_cam0_imu=t(t_ci),
        config=config,
    )


def reset_cov(params: MsckfParams, velocity_cov=None) -> torch.Tensor:
    """Initial/reset covariance: the 21x21 IMU/extrinsic diagonal pattern,
    zero elsewhere. `velocity_cov` overrides the velocity variance (the
    online reset keeps a possibly wrong nominal velocity and must let the
    next updates pull it back)."""
    D = params.config.state_dim
    diag = params.init_cov_diag
    if velocity_cov is not None:
        i = torch.arange(21, device=diag.device)
        diag = torch.where((i >= 6) & (i < 9), velocity_cov, diag)
    return torch.nn.functional.pad(torch.diag(diag), (0, D - 21, 0, D - 21))


def calib_extrinsics(config):
    """(R_imu_cam0, t_cam0_imu) from the calibration."""
    T_c0_i = np.linalg.inv(np.asarray(config.cam0.T_imu_cam, np.float64))
    return T_c0_i[:3, :3].T, T_c0_i[:3, 3]


def init_filter_state(config: VIOConfig, params: MsckfParams, q0=None, bg0=None,
                      gravity=None) -> FilterState:
    """Fresh filter state. q0 / bg0 / gravity come from the static
    gravity-and-bias initialization."""
    dev = params.init_cov_diag.device
    dtype = params.init_cov_diag.dtype
    N = config.filter.max_cam_state_size

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev).clone()

    ident = [0.0, 0.0, 0.0, 1.0]
    return FilterState(
        q=t(ident if q0 is None else q0),
        p=t(np.zeros(3)),
        v=t(np.zeros(3)),
        bg=t(np.zeros(3) if bg0 is None else bg0),
        ba=t(np.zeros(3)),
        R_imu_cam0=params.calib_R_imu_cam0.clone(),
        t_cam0_imu=params.calib_t_cam0_imu.clone(),
        q_null=t(ident if q0 is None else q0),
        p_null=t(np.zeros(3)),
        v_null=t(np.zeros(3)),
        gravity=t(config.gravity if gravity is None else gravity),
        clone_q=t(np.tile(ident, (N, 1))),
        clone_p=t(np.zeros((N, 3))),
        clone_q_null=t(np.tile(ident, (N, 1))),
        clone_p_null=t(np.zeros((N, 3))),
        clone_valid=torch.zeros(N, dtype=torch.bool, device=dev),
        n_clones=torch.zeros((), dtype=torch.int64, device=dev),
        P=reset_cov(params),
        tracking_rate=torch.ones((), dtype=dtype, device=dev),
    )


def init_feature_map(config: VIOConfig, device="cpu", dtype=torch.float32) -> FeatureMap:
    F = config.filter.max_features
    N = config.filter.max_cam_state_size
    return FeatureMap(
        fid=torch.full((F,), -1, dtype=torch.int64, device=device),
        valid=torch.zeros(F, dtype=torch.bool, device=device),
        obs=torch.zeros((F, N, 4), dtype=dtype, device=device),
        obs_valid=torch.zeros((F, N), dtype=torch.bool, device=device),
        position=torch.zeros((F, 3), dtype=dtype, device=device),
        initialized=torch.zeros(F, dtype=torch.bool, device=device),
    )
