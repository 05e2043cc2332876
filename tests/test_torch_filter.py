"""Parity of the PyTorch port's filter (vio_msckf_torch/math, filter/,
convert.py) with the JAX package on the CPU, at a reduced config (6-clone
window so the prune path runs, 32 feature slots, 16 lost candidates).

The JAX MSCKF runs once over ~40 simulator frames (one scan compile); its
final state feeds the unit comparisons.

The checks form one test item on purpose: under `pytest -n N --dist
loadfile`, pytest-xdist hands out files in order of their item count,
most first, so a one-item file is handed out after the long end-to-end
files have started and does not hold one of them back.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vio_msckf_tpu import config as jconfig
from vio_msckf_tpu.data.simulator import SimConfig, simulate_sequence, bundle_frames
from vio_msckf_tpu import math as jm
from vio_msckf_tpu.filter import augmentation as jaug
from vio_msckf_tpu.filter import propagation as jprop
from vio_msckf_tpu.filter import state as jstate
from vio_msckf_tpu.filter import triangulation as jtri
from vio_msckf_tpu.filter import update as jupd
from vio_msckf_tpu.filter.msckf import MSCKF as JMSCKF
from vio_msckf_tpu.utils import metrics as jmetrics
from vio_msckf_torch import config as tconfig
from vio_msckf_torch import convert
from vio_msckf_torch import math as tm
from vio_msckf_torch.data import simulator as tsim
from vio_msckf_torch.utils import metrics as tmetrics
from vio_msckf_torch.filter import augmentation as taug
from vio_msckf_torch.filter import propagation as tprop
from vio_msckf_torch.filter import state as tstate
from vio_msckf_torch.filter import triangulation as ttri
from vio_msckf_torch.filter import update as tupd
from vio_msckf_torch.filter.msckf import MSCKF as TMSCKF

SIZES = dict(max_cam_state_size=6, max_features=32, max_lost_candidates=16)
CFG = jconfig.euroc_config(filter=jconfig.FilterConfig(**SIZES))
TCFG = tconfig.euroc_config(filter=tconfig.FilterConfig(**SIZES))
SIM = SimConfig(duration=3.0, seed=1, max_features_per_frame=24)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Tiny CPU ops: one thread avoids oversubscribing parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.as_tensor(np.asarray(a))


@pytest.fixture(scope="module")
def sim():
    """JAX and port MSCKF over the same ~40 simulator frames."""
    seq = simulate_sequence(CFG, SIM)
    frames, init, first = bundle_frames(seq, CFG)
    fr = {k: v for k, v in frames.items() if k != "timestamp"}
    jk = JMSCKF(CFG)
    carry, jouts = jax.jit(jk.run_sequence)(
        jk.init(init["q0"], init["bg0"], init["gravity"]),
        {k: jnp.asarray(v) for k, v in fr.items()})
    tk = TMSCKF(TCFG)
    _, touts = tk.run_sequence(tk.init(init["q0"], init["bg0"], init["gravity"]),
                               {k: torch.as_tensor(v) for k, v in fr.items()})
    return dict(seq=seq, frames=frames, init=init, first=first, jouts=_np(jouts),
                touts=touts, state=_np(carry[0]), fmap=_np(carry[1]),
                params=jk.params, tparams=tk.params)


def _check_quaternion_and_se3():
    # Elementwise f32 formulas: agreement to a few ulp.
    rng = np.random.default_rng(0)
    q = rng.normal(size=(16, 4)).astype(np.float32)
    q2 = rng.normal(size=(16, 4)).astype(np.float32)
    v = rng.normal(size=(16, 3)).astype(np.float32)
    # from_two_vectors: generic, parallel and antiparallel cases.
    u = np.concatenate([v[:1], v[:1], v[2:3]])
    w = np.concatenate([v[:1] * 2.0, -v[:1], v[1:2]])

    def cases(m, q, q2, v, u, w):
        R = m.quat_to_rot(q)
        Rs, t = R[:4], v[:4]
        return [
            m.skew(v), R, m.rot_to_quat(R), m.quat_mul(q, q2),
            m.small_angle_quat(v * 0.1), m.small_angle_quat(v * 3),
            m.axis_angle_to_rot(v), m.axis_angle_to_rot(v * 1e-9),
            m.quat_conjugate(q), m.from_two_vectors(u, w),
            m.pose_compose(Rs, t, Rs, t)[1], m.pose_inverse(Rs, t)[1],
            m.pose_apply(Rs, t, v[4:8]), m.pose_matrix(Rs, t),
        ]

    args = (q, q2, v, u, w)
    want = jax.jit(lambda *a: cases(jm, *a))(*args)
    got = cases(tm, *map(_t, args))
    for wnt, gt in zip(want, got):
        np.testing.assert_allclose(gt.numpy(), np.asarray(wnt), atol=2e-6)


def _check_make_params_and_convert_roundtrip(sim):
    # The constants are built from the config in f64 then cast: identical.
    tp = sim["tparams"]
    jp = sim["params"]
    for name in ("R_cam0_cam1", "t_cam0_cam1", "continuous_noise", "chi2_table",
                 "init_cov_diag"):
        np.testing.assert_array_equal(getattr(tp, name).numpy(), np.asarray(getattr(jp, name)))
    assert tp.observation_noise == jp.observation_noise
    np.testing.assert_array_equal(
        tstate.reset_cov(tp, velocity_cov=25.0).numpy(),
        np.asarray(jstate.reset_cov(jp, velocity_cov=25.0)))
    # Fresh states agree, and a converted JAX state round-trips exactly.
    jk = JMSCKF(CFG)
    fresh = _np(jk.init())
    ours = TMSCKF(TCFG).init()
    for j, t in zip(fresh, ours):
        for name, a in convert.to_numpy_tree(t).items():
            np.testing.assert_array_equal(a, np.asarray(getattr(j, name)), err_msg=name)
    for tree in (sim["state"], sim["fmap"]):
        back = convert.to_numpy_tree(convert.from_numpy_tree(tree))
        for name, a in back.items():
            np.testing.assert_array_equal(a, np.asarray(getattr(tree, name)), err_msg=name)


def _check_propagate_and_augment(sim):
    # Propagation reassociates the 32-sample prefix products (doubling
    # loop vs associative_scan): f32 roundoff, ~1e-6 relative.
    fr = sim["frames"]
    k = 5
    imu = [fr[n][k] for n in ("imu_gyro", "imu_acc", "imu_dt", "imu_valid")]
    jstate_ = jax.tree_util.tree_map(jnp.asarray, sim["state"])
    jp, ja = jax.jit(lambda s, *a: (lambda p: (p, jaug.augment(p)))(
        jprop.propagate(s, sim["params"], *a)))(jstate_, *map(jnp.asarray, imu))
    ts = convert.from_numpy_tree(sim["state"])
    tp = tprop.propagate(ts, sim["tparams"], *map(_t, imu))
    ta = taug.augment(tp)
    for j, t in ((jp, tp), (ja, ta)):
        got = convert.to_numpy_tree(t)
        for name in ("q", "p", "v", "q_null", "p_null", "v_null", "clone_q", "clone_p"):
            np.testing.assert_allclose(got[name], np.asarray(getattr(j, name)), atol=2e-5,
                                       err_msg=name)
        P = np.asarray(j.P)
        np.testing.assert_allclose(got["P"], P, atol=1e-5 * np.abs(P).max())
    assert int(ta.n_clones) == int(ja.n_clones)
    np.testing.assert_array_equal(ta.clone_valid.numpy(), np.asarray(ja.clone_valid))


@pytest.fixture(scope="module")
def lost(sim):
    """Every valid feature of the final map as a lost-path candidate, and
    the JAX references for it from one compiled program: triangulation,
    the parallax gate, each feature's system and gamma, and the stacked
    update buffer."""
    st = jax.tree_util.tree_map(jnp.asarray, sim["state"])
    fm = sim["fmap"]
    params = sim["params"]
    N = CFG.filter.max_cam_state_size
    ov = fm.obs_valid & fm.valid[:, None]
    slots = np.tile(np.arange(N, dtype=np.int32), (ov.shape[0], 1))
    dofs = ov.sum(axis=1) - 1
    process = ov.sum(axis=1) >= 3

    def refs(obs, ov, slots, process, dofs):
        pos, ok = jtri.triangulate_all(obs, ov, st.clone_q, st.clone_p,
                                       params.R_cam0_cam1, params.t_cam0_cam1,
                                       CFG.triangulation)
        motion = jax.vmap(lambda o, v: jtri.check_motion_one(
            o, v, st.clone_q, st.clone_p, 0.05))(obs, ov)

        def one(p, o, u, sl):
            H, _, _, rp, U = jupd.feature_system(p, o, u, sl, st, params)
            return H, rp, U, jupd.feature_gamma(H, rp, U, st.P, params.observation_noise,
                                                solver="cholesky")

        sysm = jax.vmap(one)(pos, obs, ov, slots)
        stack = jupd.stack_update(st, params, pos, obs, ov, slots, process, dofs)
        return pos, ok, motion, sysm, stack

    out = jax.jit(refs)(*map(jnp.asarray, (fm.obs, ov, slots, process, dofs)))
    out = jax.tree_util.tree_map(np.asarray, out)
    return dict(obs=fm.obs, ov=ov, slots=slots, dofs=dofs, process=process, pos=out[0],
                ok=out[1], motion=out[2], sys=out[3], stack=out[4])


def _check_triangulation(sim, lost):
    # Same LM schedule with per-feature masks in place of the while-loops;
    # f32 roundoff through up to 25 LM steps.
    st = sim["state"]
    obs, ov, okj = lost["obs"], lost["ov"], lost["ok"]
    assert okj.sum() >= 4
    pt, okt = ttri.triangulate_all(_t(obs), _t(ov), _t(st.clone_q), _t(st.clone_p),
                                   sim["tparams"].R_cam0_cam1, sim["tparams"].t_cam0_cam1,
                                   TCFG.triangulation)
    np.testing.assert_array_equal(okt.numpy(), okj)
    np.testing.assert_allclose(pt.numpy()[okj], lost["pos"][okj], rtol=1e-4, atol=1e-4)
    motion = ttri.check_motion_all(_t(obs), _t(ov), _t(st.clone_q), _t(st.clone_p), 0.05)
    np.testing.assert_array_equal(motion.numpy(), lost["motion"])


def _check_eigh3_jacobi_tie_kept():
    # Kept divergence from the true spectrum, on both sides: equal diagonal
    # entries give tau = 0, sign(0) = 0, no rotation -> w = [2, 2, 5].
    rng = np.random.default_rng(3)
    A = rng.normal(size=(8, 3, 3)).astype(np.float32)
    A = A @ A.transpose(0, 2, 1)
    A[0] = [[2.0, 1.0, 0.0], [1.0, 2.0, 0.0], [0.0, 0.0, 5.0]]
    wj = np.asarray(jax.jit(jax.vmap(jupd._eigh3_jacobi))(jnp.asarray(A))[0])
    wt = tupd._eigh3_jacobi(_t(A))[0].numpy()
    np.testing.assert_array_equal(wj[0], [2.0, 2.0, 5.0])
    np.testing.assert_array_equal(wt[0], [2.0, 2.0, 5.0])
    np.testing.assert_allclose(wt, wj, rtol=1e-4, atol=1e-5)


def _check_feature_gamma(sim, lost):
    # Cholesky on both sides (the CPU twin of the kernel); the statistic is
    # a difference of quadratic forms, compared relative to its size.
    H, rp, U, gj = lost["sys"]
    s = sim["params"].observation_noise
    gt = tupd.feature_gamma(_t(H), _t(rp), _t(U), _t(sim["state"].P), s).numpy()
    use = lost["ov"].sum(axis=1) >= 3
    assert use.sum() >= 4
    np.testing.assert_allclose(gt[use], gj[use], rtol=2e-3, atol=1e-3)
    # The port's own system builder agrees with the JAX one.
    Ht, _, _, rpt, _ = tupd.feature_system(
        _t(lost["pos"]), _t(lost["obs"]), _t(lost["ov"]), _t(lost["slots"]).long(),
        convert.from_numpy_tree(sim["state"]), sim["tparams"])
    np.testing.assert_allclose(Ht.numpy(), H, atol=1e-4 * np.abs(H).max())
    np.testing.assert_allclose(rpt.numpy(), rp, atol=1e-5)


def _check_stack_update_row_order(sim, lost):
    # Same gate decisions and the same rows in the same order; values to
    # f32 roundoff of the projection.
    Hj, rj, ij = lost["stack"]
    Ht, rt, it = tupd.stack_update(
        convert.from_numpy_tree(sim["state"]), sim["tparams"], _t(lost["pos"]),
        _t(lost["obs"]), _t(lost["ov"]), _t(lost["slots"]).long(), _t(lost["process"]),
        _t(lost["dofs"]).long())
    np.testing.assert_array_equal(it.numpy(), ij)
    assert ij.sum() >= 2
    assert Ht.shape == Hj.shape
    used = np.abs(Hj).sum(axis=1) > 0
    np.testing.assert_array_equal(np.abs(Ht.numpy()).sum(axis=1) > 0, used)
    np.testing.assert_allclose(Ht.numpy(), Hj, atol=1e-4 * np.abs(Hj).max())
    np.testing.assert_allclose(rt.numpy(), rj, atol=1e-5)


def _check_msckf_sequence_matches_jax(sim):
    # ~40 frames through propagate/augment/update/prune: the poses agree to
    # f32 roundoff accumulated over the run (measured ~4e-6 m).
    n = len(sim["frames"]["timestamp"])
    assert n >= 38
    jp = sim["jouts"].p
    tp = sim["touts"].p.numpy()
    assert np.isfinite(tp).all()
    np.testing.assert_allclose(tp, jp, atol=1e-4)
    np.testing.assert_allclose(sim["touts"].q.numpy(), sim["jouts"].q, atol=1e-4)
    np.testing.assert_array_equal(sim["touts"].did_reset.numpy(), sim["jouts"].did_reset)
    gt = sim["seq"]["gt_p"][sim["first"]:]
    assert np.sqrt(np.mean(np.sum((tp - gt) ** 2, axis=1))) < 0.05


def _check_numpy_copies_match_jax(sim):
    # The port's own copies of the JAX package's numpy modules (config,
    # simulator, bundling, metrics): equal configuration and bit-identical
    # arrays from the same inputs.
    jc, tc = dataclasses.asdict(CFG), dataclasses.asdict(TCFG)
    for section, name in (("frontend", "fast_backend"), ("frontend", "lk_backend"),
                          ("filter", "gamma_solver")):
        del jc[section][name]          # the port has no backend switches
    assert tc == jc
    seq = tsim.simulate_sequence(TCFG, tsim.SimConfig(**dataclasses.asdict(SIM)))
    assert seq.keys() == sim["seq"].keys()
    for k, v in seq.items():
        np.testing.assert_array_equal(v, sim["seq"][k], err_msg=k)
    frames, init, first = tsim.bundle_frames(sim["seq"], TCFG)
    assert first == sim["first"]
    for k in ("imu_gyro", "imu_acc", "imu_dt", "imu_valid", "feat_obs", "feat_valid"):
        np.testing.assert_array_equal(frames[k], sim["frames"][k])
    for k in ("q0", "bg0", "gravity"):
        np.testing.assert_allclose(init[k], sim["init"][k], atol=1e-12)
    est = sim["touts"].p.numpy()
    gt = sim["seq"]["gt_p"][first:]
    assert tmetrics.ate_rmse(est, gt) == jmetrics.ate_rmse(est, gt)
    assert tmetrics.rpe_rmse(est, gt, 10) == jmetrics.rpe_rmse(est, gt, 10)


def _check_online_reset_matches_jax(sim, fault):
    # The reset branch (selected, not taken by a host branch): exact on
    # the reset fields, the untouched fields passed through.
    from vio_msckf_tpu.filter.msckf import online_reset as j_online_reset
    from vio_msckf_torch.filter.msckf import online_reset as t_online_reset

    st = jax.tree_util.tree_map(np.array, sim["state"])
    if fault == "sigma":
        st.P[12, 12] = 100.0
    else:
        st.p[1] = np.nan
    js, jf, jt = jax.jit(lambda s, f: j_online_reset(s, f, sim["params"]))(
        jax.tree_util.tree_map(jnp.asarray, st),
        jax.tree_util.tree_map(jnp.asarray, sim["fmap"]))
    ts, tf, tt = t_online_reset(convert.from_numpy_tree(st),
                                convert.from_numpy_tree(sim["fmap"]), sim["tparams"])
    assert bool(tt) and bool(jt)
    for j, t in ((js, ts), (jf, tf)):
        for name, a in convert.to_numpy_tree(t).items():
            np.testing.assert_array_equal(a, np.asarray(getattr(j, name)), err_msg=name)


def test_filter_matches_jax(sim, lost):
    _check_quaternion_and_se3()
    _check_eigh3_jacobi_tie_kept()
    _check_make_params_and_convert_roundtrip(sim)
    _check_propagate_and_augment(sim)
    _check_triangulation(sim, lost)
    _check_feature_gamma(sim, lost)
    _check_stack_update_row_order(sim, lost)
    for fault in ("sigma", "nan"):
        _check_online_reset_matches_jax(sim, fault)
    _check_msckf_sequence_matches_jax(sim)
    _check_numpy_copies_match_jax(sim)
