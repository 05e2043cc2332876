"""Fixed-shape filter state: tensor dataclasses for the estimator.

Port of vio_msckf_tpu/filter/state.py. One constant-size covariance of
dimension ``D = 21 + 6 * N_MAX`` with an active-clone count; augmentation
writes a block, pruning permutes, nothing reallocates. The feature map is a
table of ``F_MAX`` slots whose observations are indexed by clone slot.

Both records carry a leading batch axis B: B independent sequences, each
with its own clone count, covariance and feature table (what `jax.vmap`
gives the JAX package). The shapes below are per sequence.

Error-state layout:
  [0:3]   dtheta (IMU attitude)      [3:6]   gyro bias
  [6:9]   velocity                   [9:12]  acc bias
  [12:15] position                   [15:18] extrinsic rotation
  [18:21] extrinsic translation      [21+6k : 27+6k] clone k (dtheta, dp)
"""

from dataclasses import dataclass

import numpy as np
import torch

from benchmark.reference.config import VIOConfig
from benchmark.reference.tensors import TensorRecord


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


def make_params(config: VIOConfig, device="cuda", dtype=torch.float32) -> MsckfParams:
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


def init_filter_state(config: VIOConfig, params: MsckfParams, inits) -> FilterState:
    """Fresh filter states, one per entry of `inits` (B dicts whose q0 /
    bg0 / gravity, each optional, come from the static gravity-and-bias
    initialization). Returns a FilterState with a leading axis B."""
    dev = params.init_cov_diag.device
    dtype = params.init_cov_diag.dtype
    N = config.filter.max_cam_state_size
    B = len(inits)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float64), dtype=dtype, device=dev)

    def per_seq(key, default):
        return t(np.stack([default if i.get(key) is None else np.asarray(i[key])
                           for i in inits]))

    def tile(a, *shape):
        return t(np.broadcast_to(np.asarray(a, np.float64), (B,) + shape).copy())

    ident = [0.0, 0.0, 0.0, 1.0]
    q0 = per_seq("q0", ident)
    return FilterState(
        q=q0,
        p=tile(np.zeros(3), 3),
        v=tile(np.zeros(3), 3),
        bg=per_seq("bg0", np.zeros(3)),
        ba=tile(np.zeros(3), 3),
        R_imu_cam0=params.calib_R_imu_cam0.expand(B, 3, 3).clone(),
        t_cam0_imu=params.calib_t_cam0_imu.expand(B, 3).clone(),
        q_null=q0.clone(),
        p_null=tile(np.zeros(3), 3),
        v_null=tile(np.zeros(3), 3),
        gravity=per_seq("gravity", np.asarray(config.gravity, np.float64)),
        clone_q=tile(np.tile(ident, (N, 1)), N, 4),
        clone_p=tile(np.zeros((N, 3)), N, 3),
        clone_q_null=tile(np.tile(ident, (N, 1)), N, 4),
        clone_p_null=tile(np.zeros((N, 3)), N, 3),
        clone_valid=torch.zeros((B, N), dtype=torch.bool, device=dev),
        n_clones=torch.zeros(B, dtype=torch.int64, device=dev),
        P=reset_cov(params).expand(B, -1, -1).clone(),
        tracking_rate=torch.ones(B, dtype=dtype, device=dev),
    )


def init_feature_map(config: VIOConfig, batch=1, device="cuda",
                     dtype=torch.float32) -> FeatureMap:
    """Empty feature maps for `batch` sequences."""
    F = config.filter.max_features
    N = config.filter.max_cam_state_size
    B = batch
    return FeatureMap(
        fid=torch.full((B, F), -1, dtype=torch.int64, device=device),
        valid=torch.zeros((B, F), dtype=torch.bool, device=device),
        obs=torch.zeros((B, F, N, 4), dtype=dtype, device=device),
        obs_valid=torch.zeros((B, F, N), dtype=torch.bool, device=device),
        position=torch.zeros((B, F, 3), dtype=dtype, device=device),
        initialized=torch.zeros((B, F), dtype=torch.bool, device=device),
    )
