"""The frame-clocked MSCKF step.

Port of vio_msckf_tpu/filter/msckf.py. Per frame:
  propagate -> augment -> add observations -> remove lost features
  -> prune clone window -> publish -> online reset.
Branches of the reference (`lax.cond` for prune and reset) are computed
and selected, so a step issues no host synchronisation.
"""

from dataclasses import dataclass

import numpy as np
import torch

from vio_msckf_torch.config import VIOConfig
from vio_msckf_torch import full_precision
from vio_msckf_torch.math import quat_to_rot
from vio_msckf_torch.filter.state import (
    init_filter_state,
    init_feature_map,
    make_params,
    reset_cov,
)
from vio_msckf_torch.filter.propagation import propagate
from vio_msckf_torch.filter.augmentation import augment
from vio_msckf_torch.filter.features import add_observations, clear_features
from vio_msckf_torch.filter.update import stack_update, tsqr_reduce_update
from vio_msckf_torch.filter.triangulation import triangulate_all, check_motion_all
from vio_msckf_torch.filter.pruning import compact_lanes, maybe_prune
from vio_msckf_torch.tensors import TensorRecord, select


@dataclass
class FilterOutput(TensorRecord):
    """Per-frame odometry output."""

    q: torch.Tensor             # (4,) world->IMU attitude (JPL)
    p: torch.Tensor             # (3,) IMU position in world
    v: torch.Tensor             # (3,) velocity in world
    cam0_R_w_c: torch.Tensor    # (3,3) world->cam0
    cam0_p: torch.Tensor        # (3,) cam0 position in world
    position_std: torch.Tensor  # (3,) sqrt of the position covariance diagonal
    did_reset: torch.Tensor     # () bool online reset fired this frame
    lost_overflow: torch.Tensor  # () lost candidates beyond the budget


def initialize_gravity_and_bias(imu_gyro, imu_acc, gravity_acc=9.81):
    """Static initialization from the first IMU samples, in numpy:
    returns (q0, bg, gravity). Same logic as the JAX package's function of
    the same name, whose module imports jax."""
    imu_gyro = np.asarray(imu_gyro, np.float64)
    imu_acc = np.asarray(imu_acc, np.float64)
    bg = imu_gyro.mean(axis=0)
    gravity_imu = imu_acc.mean(axis=0)
    gravity = np.array([0.0, 0.0, -np.linalg.norm(gravity_imu)])
    q0 = _from_two_vectors_np(-gravity, gravity_imu)
    return q0, bg, gravity


def _from_two_vectors_np(v0, v1):
    """JPL quaternion rotating v0 onto v1, in numpy."""
    v0 = v0 / np.linalg.norm(v0)
    v1 = v1 / np.linalg.norm(v1)
    d = float(v0 @ v1)
    if d < -0.999999:
        axis = np.cross([1.0, 0.0, 0.0], v0)
        if np.linalg.norm(axis) < 1e-6:
            axis = np.cross([0.0, 1.0, 0.0], v0)
        q = np.array([*axis, 0.0])
    elif d > 0.999999:
        q = np.array([0.0, 0.0, 0.0, 1.0])
    else:
        s = np.sqrt((1.0 + d) * 2.0)
        q = np.array([*(np.cross(v0, v1) / s), 0.5 * s])
    q = q / np.linalg.norm(q)
    return np.concatenate([-q[:3], q[3:]])  # Hamilton -> JPL conjugate


def remove_lost_features(state, fmap, params):
    """Triangulate and update with the features that lost track this
    frame, then drop them from the map. Candidates are compacted into
    C = max_lost_candidates lanes; overflow beyond C loses its update
    information (it is still cleared) and is counted."""
    cfg = params.config
    F = fmap.valid.shape[0]
    N = state.clone_q.shape[0]
    dev = state.P.device
    cur_slot = state.n_clones - 1
    observed_now = (fmap.obs_valid.index_select(1, torch.clamp(cur_slot, min=0).reshape(1))[:, 0]
                    & (cur_slot >= 0))
    lost = fmap.valid & ~observed_now
    n_obs_full = torch.sum(fmap.obs_valid, dim=1)
    candidates = lost & ~(n_obs_full < 3)

    C = min(cfg.filter.max_lost_candidates, F)
    overflow = torch.clamp(torch.sum(candidates) - C, min=0)
    idx, sel_valid = compact_lanes(candidates, C)
    obs_c = fmap.obs[idx]
    ov_c = fmap.obs_valid[idx] & sel_valid[:, None]
    init_c = fmap.initialized[idx] & sel_valid
    pos_c = fmap.position[idx]
    n_obs_c = torch.sum(ov_c, dim=1)

    positions, tri_ok = triangulate_all(
        obs_c, ov_c, state.clone_q, state.clone_p,
        params.R_cam0_cam1, params.t_cam0_cam1, cfg.triangulation)
    motion_ok = check_motion_all(obs_c, ov_c, state.clone_q, state.clone_p,
                                 cfg.triangulation.translation_threshold)
    newly_ok = ~init_c & motion_ok & tri_ok
    process = sel_valid & (init_c | newly_ok)
    # Initialized features keep their stored estimate.
    use_pos = torch.where(init_c[:, None], pos_c, positions)

    slots = torch.arange(N, device=dev)[None, :].expand(C, N)
    Hc, rc, _ = stack_update(
        state, params, positions=use_pos, obs=obs_c, use_masks=ov_c,
        clone_slots=slots, process_mask=process,
        dofs=n_obs_c - 1)              # dof = #observing clones - 1
    state = tsqr_reduce_update(state, Hc, rc, params)
    return state, clear_features(fmap, lost), overflow


def online_reset(state, fmap, params):
    """Drop clones and map and reset the covariance when the position
    sigma explodes, or when the state is no longer finite (a NaN never
    recovers on its own); non-finite nominal values restart from identity
    attitude, zero kinematics and the calibrated extrinsics."""
    fc = params.config.filter
    pos_var = torch.diagonal(state.P)[12:15]
    trigger = torch.sqrt(torch.amax(pos_var)) >= fc.position_std_threshold
    if not fc.position_std_threshold > 0:
        trigger = torch.zeros_like(trigger)
    finite = (torch.all(torch.isfinite(torch.diagonal(state.P)))
              & torch.all(torch.isfinite(state.p))
              & torch.all(torch.isfinite(state.v))
              & torch.all(torch.isfinite(state.q)))
    trigger = trigger | ~finite

    def scrub(x, default):
        return torch.where(torch.all(torch.isfinite(x)), x, default)

    zero3 = torch.zeros_like(state.p)
    s = state.replace(
        clone_valid=torch.zeros_like(state.clone_valid),
        n_clones=torch.zeros_like(state.n_clones),
        P=reset_cov(params, velocity_cov=fc.online_reset_velocity_cov),
        q=scrub(state.q, torch.eye(4, dtype=state.q.dtype, device=state.q.device)[3]),
        p=scrub(state.p, zero3),
        v=scrub(state.v, zero3),
        bg=scrub(state.bg, zero3),
        ba=scrub(state.ba, zero3),
        R_imu_cam0=scrub(state.R_imu_cam0, params.calib_R_imu_cam0),
        t_cam0_imu=scrub(state.t_cam0_imu, params.calib_t_cam0_imu),
    )
    f = clear_features(fmap, torch.ones_like(fmap.valid))
    return select(trigger, s, state), select(trigger, f, fmap), trigger


def publish(state):
    """Odometry output (T_imu_body = I)."""
    R_w_i = quat_to_rot(state.q)
    pos_var = torch.diagonal(state.P)[12:15]
    return FilterOutput(
        q=state.q, p=state.p, v=state.v,
        cam0_R_w_c=state.R_imu_cam0 @ R_w_i,
        cam0_p=state.p + R_w_i.T @ state.t_cam0_imu,
        position_std=torch.sqrt(torch.clamp(pos_var, min=0.0)),
        did_reset=torch.zeros((), dtype=torch.bool, device=state.p.device),
        lost_overflow=torch.zeros((), dtype=torch.int64, device=state.p.device),
    )


class MSCKF:
    """Config-derived constants plus the filter's functions.

        kf = MSCKF(config, device)
        state, fmap = kf.init(q0, bg0, gravity)
        (state, fmap), out = kf.step((state, fmap), frame)
    """

    def __init__(self, config: VIOConfig, device="cpu", dtype=torch.float32):
        full_precision()
        self.config = config
        self.device = torch.device(device)
        self.dtype = dtype
        self.params = make_params(config, self.device, dtype)

    def init(self, q0=None, bg0=None, gravity=None):
        state = init_filter_state(self.config, self.params, q0, bg0, gravity)
        return state, init_feature_map(self.config, self.device, self.dtype)

    def reset(self, state, fmap):
        """Full reset to the initial status, keeping the current extrinsics
        and gravity."""
        new_state, new_fmap = self.init()
        return new_state.replace(
            R_imu_cam0=state.R_imu_cam0, t_cam0_imu=state.t_cam0_imu,
            gravity=state.gravity), new_fmap

    def step(self, carry, frame):
        """One frame. `frame` holds imu_gyro (M,3), imu_acc (M,3), imu_dt
        (M,), imu_valid (M,), feat_ids (K,), feat_obs (K,4), feat_valid (K,)."""
        state, fmap = carry
        params = self.params
        state = propagate(state, params, frame["imu_gyro"], frame["imu_acc"],
                          frame["imu_dt"], frame["imu_valid"])
        state = augment(state)
        fmap, tracking_rate = add_observations(
            fmap, frame["feat_ids"], frame["feat_obs"], frame["feat_valid"],
            cur_slot=state.n_clones - 1)
        state = state.replace(tracking_rate=tracking_rate.to(state.P.dtype))
        state, fmap, lost_overflow = remove_lost_features(state, fmap, params)
        state, fmap = maybe_prune(state, fmap, params)
        out = publish(state)
        state, fmap, did_reset = online_reset(state, fmap, params)
        out = out.replace(did_reset=did_reset, lost_overflow=lost_overflow)
        return (state, fmap), out

    def run_sequence(self, carry, frames):
        """Step over frames stacked on axis 0; returns (carry, outputs
        stacked on axis 0)."""
        n = next(iter(frames.values())).shape[0]
        outs = []
        for k in range(n):
            carry, out = self.step(carry, {key: v[k] for key, v in frames.items()})
            outs.append(out)
        return carry, stack_outputs(outs)


def stack_outputs(outs):
    """A list of per-frame FilterOutputs -> one with a leading frame axis."""
    return FilterOutput(**{
        name: torch.stack([getattr(o, name) for o in outs])
        for name in FilterOutput.__dataclass_fields__
    })
