"""Loosely-coupled 18-state error-state Kalman filter VIO: the secondary
pipeline (after the reference's ESKF/vio.py, ESKF/eskf_vio.py,
ESKF/stereo.py). Port of vio_msckf_tpu/eskf."""

from benchmark.reference.eskf.filter import (
    EskfParams,
    EskfState,
    eskf_frame_step,
    init_covariance,
    init_state,
    propagate,
    update_features,
)
from benchmark.reference.eskf.pipeline import EskfConfig, EskfVio, FrontendFrame

__all__ = [
    "EskfParams",
    "EskfState",
    "init_state",
    "init_covariance",
    "propagate",
    "update_features",
    "eskf_frame_step",
    "EskfVio",
    "EskfConfig",
    "FrontendFrame",
]
