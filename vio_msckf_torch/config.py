"""Configuration of the PyTorch engine.

The port's copy of vio_msckf_tpu/config.py: the same frozen dataclasses,
fields, defaults and EuRoC MAV calibration, so a configuration means the
same thing in both packages. It drops the JAX package's backend switches
(`fast_backend`, `lk_backend`, `gamma_solver`): here every kernel wrapper
dispatches on the device of its input (hand kernel on CUDA, PyTorch twin
on CPU).

Sizes are static: they fix the shapes of the state tensors and of every
kernel launch.
"""

import dataclasses
from dataclasses import dataclass, field

import numpy as np


@dataclass(frozen=True)
class TriangulationConfig:
    """Inverse-depth LM solver settings."""

    translation_threshold: float = -1.0  # <0 disables check_motion
    huber_epsilon: float = 0.01
    estimation_precision: float = 5e-7
    initial_damping: float = 1e-3
    outer_loop_max_iteration: int = 5
    inner_loop_max_iteration: int = 5


@dataclass(frozen=True)
class FrontendConfig:
    """Feature detection and tracking settings."""

    grid_row: int = 4
    grid_col: int = 5
    grid_min_feature_num: int = 3
    grid_max_feature_num: int = 5
    fast_threshold: float = 15.0
    stereo_threshold: float = 5.0  # epipolar gate in norm-pixel units
    # Pyramidal LK: 15x15 window, levels 0..3, 30 iterations, eps 0.01 px,
    # starting from the given initial flow.
    lk_patch_size: int = 15
    lk_pyramid_levels: int = 3  # coarsest level index; 4 levels total
    lk_max_iteration: int = 30
    lk_track_precision: float = 0.01
    # Stereo-match gates.
    stereo_backward_err_px: float = 3.0
    stereo_disparity_max_px: float = 20.0
    # Forward-backward gate on the temporal track: the round trip
    # prev->curr->prev must land within this many pixels.
    temporal_backward_err_px: float = 3.0
    # Half-width of the box that suppresses re-detection near a track.
    mask_radius: int = 3
    # Fixed-shape capacities.
    max_tracks: int = 128        # track-table slots; >= grid_num * grid_max
    max_detections_per_cell: int = 8  # FAST candidates kept per grid cell


@dataclass(frozen=True)
class NoiseConfig:
    """Process and measurement noise variances."""

    gyro_noise: float = 0.005 ** 2
    acc_noise: float = 0.05 ** 2
    gyro_bias_noise: float = 0.001 ** 2
    acc_bias_noise: float = 0.01 ** 2
    observation_noise: float = 0.035 ** 2
    velocity_cov: float = 0.25
    gyro_bias_cov: float = 0.01
    acc_bias_cov: float = 0.01
    extrinsic_rotation_cov: float = 3.0462e-4
    extrinsic_translation_cov: float = 2.5e-5


@dataclass(frozen=True)
class FilterConfig:
    """Estimator settings and state sizes."""

    gravity_acc: float = 9.81
    frame_rate: float = 20.0
    max_cam_state_size: int = 20           # clone window
    position_std_threshold: float = 8.0    # online-reset gate
    # Velocity variance (m^2/s^2) after an online reset: 5 m/s std lets
    # later updates pull a wrong nominal velocity back.
    online_reset_velocity_cov: float = 25.0
    # Keyframe redundancy thresholds.
    rotation_threshold: float = 0.2618
    translation_threshold: float = 0.4
    tracking_rate_threshold: float = 0.5
    # Measurement-row budget per update.
    max_update_rows: int = 1500
    # IMU samples of the static initialization window.
    init_imu_samples: int = 200
    # Fixed-shape capacities.
    max_features: int = 160        # feature-map slots
    # Lost-feature candidates triangulated and gated per frame; the rest
    # are dropped from the update (still cleared from the map).
    max_lost_candidates: int = 128
    # Padded IMU samples per frame bundle: ~10 real at 200 Hz IMU / 20 Hz
    # camera, with headroom for a dropped camera frame.
    imu_per_frame: int = 32


@dataclass(frozen=True)
class CameraConfig:
    """Single-camera calibration."""

    intrinsics: tuple  # (fx, fy, cx, cy)
    distortion_model: str
    distortion_coeffs: tuple  # (k1, k2, p1, p2)
    resolution: tuple  # (width, height)
    T_imu_cam: tuple  # 4x4 row-major nested tuple, vec_imu -> vec_cam

    @property
    def T_imu_cam_np(self):
        return np.asarray(self.T_imu_cam, dtype=np.float64)

    @property
    def K(self):
        fx, fy, cx, cy = self.intrinsics
        return np.array(
            [[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]], dtype=np.float64
        )


def _t(a):
    return tuple(map(tuple, a))


# EuRoC MAV calibration.
EUROC_CAM0 = CameraConfig(
    intrinsics=(458.654, 457.296, 367.215, 248.375),
    distortion_model="radtan",
    distortion_coeffs=(-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05),
    resolution=(752, 480),
    T_imu_cam=_t(
        [
            [0.014865542981794, 0.999557249008346, -0.025774436697440, 0.065222909535531],
            [-0.999880929698575, 0.014967213324719, 0.003756188357967, -0.020706385492719],
            [0.004140296794224, 0.025715529947966, 0.999660727177902, -0.008054602460030],
            [0.0, 0.0, 0.0, 1.0],
        ]
    ),
)

EUROC_CAM1 = CameraConfig(
    intrinsics=(457.587, 456.134, 379.999, 255.238),
    distortion_model="radtan",
    distortion_coeffs=(-0.28368365, 0.07451284, -0.00010473, -3.55590700e-05),
    resolution=(752, 480),
    T_imu_cam=_t(
        [
            [0.012555267089103, 0.999598781151433, -0.025389800891747, -0.044901980682509],
            [-0.999755099723116, 0.013011905181504, 0.017900583825251, -0.020569771258915],
            [0.018223771455443, 0.025158836311552, 0.999517347077547, -0.008638135126028],
            [0.0, 0.0, 0.0, 1.0],
        ]
    ),
)

# cam0 -> cam1 transform.
EUROC_T_CN_CNM1 = _t(
    [
        [0.999997256477881, 0.002312067192424, 0.000376008102415, -0.110073808127187],
        [-0.002317135723281, 0.999898048506644, 0.014089835846648, 0.000399121547014],
        [-0.000343393120525, -0.014090668452714, 0.999900662637729, -0.000853702503357],
        [0.0, 0.0, 0.0, 1.0],
    ]
)


@dataclass(frozen=True)
class VIOConfig:
    """Top-level engine configuration."""

    cam0: CameraConfig = EUROC_CAM0
    cam1: CameraConfig = EUROC_CAM1
    T_cn_cnm1: tuple = EUROC_T_CN_CNM1  # vec_cam0 -> vec_cam1
    T_imu_body: tuple = _t(np.eye(4))
    triangulation: TriangulationConfig = field(default_factory=TriangulationConfig)
    frontend: FrontendConfig = field(default_factory=FrontendConfig)
    noise: NoiseConfig = field(default_factory=NoiseConfig)
    filter: FilterConfig = field(default_factory=FilterConfig)

    @property
    def grid_num(self):
        return self.frontend.grid_row * self.frontend.grid_col

    @property
    def gravity(self):
        return np.array([0.0, 0.0, -self.filter.gravity_acc])

    @property
    def T_cn_cnm1_np(self):
        return np.asarray(self.T_cn_cnm1, dtype=np.float64)

    @property
    def state_dim(self):
        """Error-state dimension: 21 IMU/extrinsic + 6 per clone slot."""
        return 21 + 6 * self.filter.max_cam_state_size

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def euroc_config(**overrides):
    """The default EuRoC configuration, with optional field overrides."""
    cfg = VIOConfig()
    return cfg.replace(**overrides) if overrides else cfg
