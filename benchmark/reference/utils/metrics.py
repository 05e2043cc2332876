"""Trajectory error metrics (ATE / RPE), numpy. The port's copy of
vio_msckf_tpu/utils/metrics.py: Umeyama SE(3) alignment, RMSE of the
translational residuals, and relative pose error over a frame delta."""

import numpy as np


def umeyama_alignment(est: np.ndarray, gt: np.ndarray, with_scale=False):
    """Least-squares similarity/SE(3) alignment est -> gt.

    est, gt: (N, 3). Returns (s, R, t) with gt ~ s * R @ est + t.
    """
    est = np.asarray(est, float)
    gt = np.asarray(gt, float)
    mu_e = est.mean(axis=0)
    mu_g = gt.mean(axis=0)
    E = est - mu_e
    G = gt - mu_g
    C = G.T @ E / len(est)
    U, d, Vt = np.linalg.svd(C)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    if with_scale:
        var_e = (E ** 2).sum() / len(est)
        s = float(np.trace(np.diag(d) @ S) / var_e)
    else:
        s = 1.0
    t = mu_g - s * R @ mu_e
    return s, R, t


def ate_rmse(est: np.ndarray, gt: np.ndarray, align=True):
    """Absolute trajectory error RMSE in meters."""
    est = np.asarray(est, float)
    gt = np.asarray(gt, float)
    if align:
        s, R, t = umeyama_alignment(est, gt)
        est = (s * (R @ est.T)).T + t
    err = np.linalg.norm(est - gt, axis=1)
    return float(np.sqrt((err ** 2).mean()))


def rpe_rmse(est: np.ndarray, gt: np.ndarray, delta: int = 20):
    """Relative pose (translation) error RMSE over `delta` frames."""
    est = np.asarray(est, float)
    gt = np.asarray(gt, float)
    d_est = est[delta:] - est[:-delta]
    d_gt = gt[delta:] - gt[:-delta]
    err = np.linalg.norm(d_est - d_gt, axis=1)
    return float(np.sqrt((err ** 2).mean()))
