"""The port's ESKF pipeline against the JAX package's on the CPU, at the
reduced configuration of tests/test_torch_slice.py (188x120 stereo) with
K = 2 x 2 x 4 keypoints: rectification, the bilinear warp, ORB keypoints
and descriptors, Hamming matching and cross-check, the filter's
propagation and sequential feature updates, and EskfVio.step over a few
rendered frames. The same numpy inputs go through both.

One test item (see tests/test_torch_slice.py on xdist's file order)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_slice import _small_config
from vio_msckf_tpu import config as jconfig
from vio_msckf_tpu.data.render import render_sequence as jrender
from vio_msckf_tpu.data.simulator import SimConfig, bundle_frames, simulate_sequence
from vio_msckf_tpu.eskf import EskfConfig as JEskfConfig
from vio_msckf_tpu.eskf import EskfVio as JEskfVio
from vio_msckf_tpu.eskf import filter as jfilter
from vio_msckf_tpu.ops import orb as jorb
from vio_msckf_tpu.ops import rectify as jrect
from vio_msckf_torch import config as tconfig
from vio_msckf_torch.eskf import EskfConfig as TEskfConfig
from vio_msckf_torch.eskf import EskfVio as TEskfVio
from vio_msckf_torch.eskf import filter as tfilter
from vio_msckf_torch.ops import orb as torb
from vio_msckf_torch.ops import rectify as trect

GRID = dict(grid_row=2, grid_col=2, per_cell=4)   # K = 16
# Threshold 20 (the default) finds almost no corners on 188x120 frames.
THRESHOLD = 12.0
N_FRAMES = 6
IMU_KEYS = ("imu_gyro", "imu_acc", "imu_dt", "imu_valid")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def workload():
    """N_FRAMES moving stereo frames of a slow trajectory, rendered by the
    JAX renderer at the reduced configuration."""
    jcfg, tcfg = _small_config(jconfig), _small_config(tconfig)
    sim = SimConfig(duration=1.0 + N_FRAMES / 20, seed=11, amp=(0.4, 0.3, 0.15),
                    yaw_rate=0.05, wobble_amp=0.02, static_init_time=1.0)
    seq = simulate_sequence(jcfg, sim)
    frames, _, first = bundle_frames(seq, jcfg)
    n = min(N_FRAMES, len(frames["timestamp"]))
    R = seq["gt_R_i_w"][first:first + n].transpose(0, 2, 1)
    cam0, cam1 = jrender(jcfg, R, seq["gt_p"][first:first + n], radius=14.0, seed=7, chunk=n)
    return dict(jcfg=jcfg, tcfg=tcfg, n=n, cam=(np.asarray(cam0), np.asarray(cam1)),
                imu={k: frames[k][:n] for k in IMU_KEYS})


def _t(a):
    return torch.as_tensor(np.array(a))


def _check_rectify(jcfg, tcfg, img):
    jr = jrect.stereo_rectify(jcfg.cam0, jcfg.cam1, jcfg.T_cn_cnm1)
    tr = trect.stereo_rectify(tcfg.cam0, tcfg.cam1, tcfg.T_cn_cnm1)
    assert jr.keys() == tr.keys()
    for k in jr:
        np.testing.assert_array_equal(np.asarray(tr[k]), np.asarray(jr[k]))
    maps = []
    for jc, tc, Rr in ((jcfg.cam0, tcfg.cam0, jr["R_rect0"]), (jcfg.cam1, tcfg.cam1, jr["R_rect1"])):
        jm = np.asarray(jrect.rectify_map(jc, Rr, jr["K_new"]))
        tm = trect.rectify_map(tc, Rr, tr["K_new"], device="cpu")
        np.testing.assert_allclose(tm.numpy(), jm, atol=1e-4)
        maps.append(jm)
    # The warp on the same maps, both views in one call: within 1e-3 DN;
    # then on maps shifted half off the image (zeros outside the source).
    out = []
    for shift in (0.0, 60.5):
        want = np.stack([np.asarray(jrect.warp_bilinear(jnp.asarray(x), jnp.asarray(m + shift)))
                         for x, m in zip(img, maps)])
        got = trect.warp_bilinear(_t(np.stack(img)), _t(np.stack(maps) + shift))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-3)
        out.append(want)
    assert (out[1] == 0).mean() > 0.2
    return out[0]


def _jax_pair_intensities(img, xy):
    """JAX's steered-BRIEF sample pairs (i1, i2) per keypoint and bit, from
    its own internals: where they are nearly equal, f32 roundoff may flip
    the bit."""
    img = jorb._blur_axis(jorb._blur_axis(jnp.asarray(img, jnp.float32), 0), 1)
    patches = jorb._gather_patches(img, jnp.asarray(xy))
    angles = jorb._orientations(patches)
    pairs = jnp.asarray(jorb._PAIRS, jnp.float32)

    def one(patch, ang):
        c, s = jnp.cos(ang), jnp.sin(ang)
        i1 = jorb._bilinear_patch(patch, c * pairs[:, 0] - s * pairs[:, 1],
                                  s * pairs[:, 0] + c * pairs[:, 1])
        i2 = jorb._bilinear_patch(patch, c * pairs[:, 2] - s * pairs[:, 3],
                                  s * pairs[:, 2] + c * pairs[:, 3])
        return i1, i2

    i1, i2 = jax.vmap(one)(patches, angles)
    return np.asarray(i1), np.asarray(i2)


def _check_orb(rect, threshold):
    # Both rectified views through the port in one (2, H, W) call.
    t_out = torb.detect_and_describe(_t(rect), threshold, **GRID)
    near = 0
    j_outs = []
    for b in range(2):
        jxy, jresp, jbits, jang, jv = (np.asarray(x) for x in jorb.detect_and_describe(
            jnp.asarray(rect[b]), threshold, **GRID))
        txy, tresp, tbits, tang, tv = (x[b].numpy() for x in t_out)
        np.testing.assert_array_equal(txy, jxy)
        np.testing.assert_array_equal(tresp, jresp)
        np.testing.assert_array_equal(tv, jv)
        assert jv.sum() >= 8
        np.testing.assert_allclose(tang[jv], jang[jv], atol=1e-5)
        i1, i2 = _jax_pair_intensities(rect[b], jxy)
        tie = (np.abs(i1 - i2) < 1e-4) & jv[:, None]
        near += int(tie.sum())
        differ = tbits != jbits
        assert not (differ & ~tie).any(), np.argwhere(differ & ~tie)[:5]
        j_outs.append((jbits, jv))
    assert near <= 0.01 * 2 * 16 * 256, near
    # Hamming matrix and cross-check on the port's bits through both.
    tb = t_out[2]
    jh = np.asarray(jorb.hamming_matrix(jnp.asarray(tb[0].numpy()), jnp.asarray(tb[1].numpy())))
    np.testing.assert_array_equal(torb.hamming_matrix(tb[0], tb[1]).numpy(), jh)
    jm = jorb.match_crosscheck(jnp.asarray(tb[0].numpy()), jnp.asarray(t_out[4][0].numpy()),
                               jnp.asarray(tb[1].numpy()), jnp.asarray(t_out[4][1].numpy()), 64.0)
    tm = torb.match_crosscheck(tb[0], t_out[4][0], tb[1], t_out[4][1], 64.0)
    for a, b in zip(tm, jm):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert tm[2].sum() >= 4
    # Ties: a row of equal distances takes the first index in both.
    eq = torch.zeros((3, 256), dtype=torch.bool)
    idx, _, ok = torb.match_crosscheck(eq, torch.ones(3, dtype=torch.bool), eq,
                                       torch.ones(3, dtype=torch.bool))
    assert idx.tolist() == [0, 0, 0] and ok.tolist() == [True, False, False]


def _params(vio):
    p = vio.params
    return (jfilter.EskfParams(gyro_noise=p.gyro_noise, acc_noise=p.acc_noise,
                               gyro_walk=p.gyro_walk, acc_walk=p.acc_walk,
                               meas_cov=jnp.asarray(p.meas_cov.numpy()),
                               error_threshold=p.error_threshold), p)


def _close(t, j, truth=None, rtol=1e-5):
    """Within 1e-5 relative to the array's own scale or, where the
    reference's own f32 result is further than that from the f64 result
    `truth`, within twice the reference's own error."""
    j = np.asarray(j)
    atol = rtol * max(float(np.abs(j).max()), 1e-30)
    if truth is not None:
        atol = max(atol, 2 * float(np.abs(j - truth.numpy()).max()))
    np.testing.assert_allclose(t.numpy(), j, rtol=0, atol=atol)


def _check_filter(vio):
    # Propagation over a padded IMU slice and the sequential updates, on
    # random numpy inputs: within 1e-5 relative, identical accept decisions.
    jp, tp = _params(vio)
    rng = np.random.default_rng(7)
    M, K = 16, 24
    g0 = np.array([0.1, -9.7, 0.3], np.float32)
    gyro = rng.normal(0, 0.3, (M, 3)).astype(np.float32)
    acc = (rng.normal(0, 0.5, (M, 3)) - g0).astype(np.float32)
    dt = np.full(M, 0.005, np.float32)
    valid = np.arange(M) < 11
    js, jP = jfilter.propagate(jfilter.init_state(g0), jfilter.init_covariance(), gyro, acc,
                               dt, valid, jp)
    ts, tP = tfilter.propagate(tfilter.init_state(g0, "cpu"), tfilter.init_covariance("cpu"),
                               _t(gyro), _t(acc), _t(dt), _t(valid), tp)
    for f in ("p", "v", "R", "a_b", "w_b", "g"):
        _close(getattr(ts, f), getattr(js, f))
    _close(tP, jP)

    # World points seen from the last pose (identity) at depths 2..6 m, and
    # seen again from the propagated pose with 0.5 px noise (the pixel
    # sigma); a few far outside the gate, one behind, two invalid. (On
    # features inconsistent with the state, whose updates move p by cm each,
    # the two f32 sequences drift 5e-5 relative apart by roundoff alone.)
    f = vio.K_new[0]
    uv = rng.uniform(-0.3, 0.3, (K, 2))
    d = 1.0 / rng.uniform(2.0, 6.0, K)
    uvd1 = np.concatenate([uv, d[:, None]], axis=1).astype(np.float32)
    Pw = np.concatenate([uv, np.ones((K, 1))], axis=1) / d[:, None]
    Pc = (Pw - np.asarray(js.p, np.float64)) @ np.asarray(js.R, np.float64)
    uvd2 = np.concatenate([Pc[:, :2] / Pc[:, 2:] + rng.normal(0, 0.5 / f, (K, 2)),
                           d[:, None]], axis=1).astype(np.float32)
    uvd2[::7, :2] += 30.0 / f                   # beyond the 10 px gate
    uvd1[5, 2] = -0.1                           # behind: skipped
    mvalid = np.ones(K, bool)
    mvalid[[3, 11]] = False
    last_R, last_t = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    js2, jP2, jinno = jfilter.update_features(js, jP, uvd1, uvd2, mvalid, last_R, last_t, jp)
    upd = lambda s, P, tp, dt: tfilter.update_features(  # noqa: E731
        s, P, *(_t(x).to(dt) for x in (uvd1, uvd2)), _t(mvalid),
        *(_t(x).to(dt) for x in (last_R, last_t)), tp)
    # The updates start from the same numpy state (the reference's
    # propagated one), in f32 and, as the referee of the reference's own
    # f32 error, in f64.
    state = {k: np.array(getattr(js, k)) for k in ("p", "v", "R", "a_b", "w_b", "g")}
    ts2, tP2, tinno = upd(tfilter.EskfState(**{k: _t(v) for k, v in state.items()}),
                          _t(np.array(jP)), tp, torch.float32)
    tp64 = dataclasses.replace(tp, meas_cov=tp.meas_cov.double())
    ts3, tP3, tinno3 = upd(tfilter.EskfState(**{k: _t(v).double() for k, v in state.items()}),
                           _t(np.array(jP)).double(), tp64, torch.float64)
    for name in ("p", "v", "R", "a_b", "w_b", "g"):
        _close(getattr(ts2, name), getattr(js2, name), getattr(ts3, name))
    _close(tP2, jP2, tP3)
    _close(tinno, jinno, tinno3)
    # Accept decisions: the innovation of each feature against the gate.
    jacc = np.linalg.norm(np.asarray(jinno), axis=1) < jp.error_threshold
    tacc = torch.linalg.vector_norm(tinno, dim=1).numpy() < tp.error_threshold
    np.testing.assert_array_equal(tacc, jacc)
    assert 8 <= int(jacc.sum()) < K - 3


def _check_pipeline(workload):
    jcfg, tcfg, n = workload["jcfg"], workload["tcfg"], workload["n"]
    jv = JEskfVio(jcfg, JEskfConfig(fast_threshold=THRESHOLD, **GRID))
    tv = TEskfVio(tcfg, TEskfConfig(fast_threshold=THRESHOLD, **GRID), device="cpu")
    imu = workload["imu"]
    acc0 = imu["imu_acc"][1][imu["imu_valid"][1]][0]
    jc = jv.init(acc0)
    jstep = jax.jit(jv.step)
    jouts = []
    for k in range(n):
        frame = dict(cam0_img=workload["cam"][0][k], cam1_img=workload["cam"][1][k],
                     **{key: v[k] for key, v in imu.items()})
        jc, jo = jstep(jc, {key: jnp.asarray(v) for key, v in frame.items()})
        jouts.append(jax.tree_util.tree_map(np.asarray, jo))
    # The port's side through its compiled-step runner (the eager step on
    # the CPU), over the same frames stacked.
    _, to = tv.run_sequence(tv.init(acc0), dict(
        cam0_img=_t(workload["cam"][0][:n]), cam1_img=_t(workload["cam"][1][:n]),
        **{key: _t(v[:n]) for key, v in imu.items()}))
    touts = [{key: v[k].numpy() for key, v in to.items()} for k in range(n)]
    for key in ("n_matches", "n_inliers"):
        np.testing.assert_array_equal([o[key] for o in touts], [o[key] for o in jouts])
    assert min(o["n_matches"] for o in jouts[1:]) >= 3
    jp = np.stack([o["p"] for o in jouts])
    tp = np.stack([o["p"] for o in touts])
    np.testing.assert_allclose(tp, jp, atol=1e-4)
    assert np.isfinite(tp).all() and np.abs(tp).max() > 1e-4
    return tv


def test_eskf_matches_jax(workload):
    rect = _check_rectify(workload["jcfg"], workload["tcfg"],
                          [workload["cam"][0][2], workload["cam"][1][2]])
    _check_orb(rect.astype(np.float32), THRESHOLD)
    tv = _check_pipeline(workload)
    _check_filter(tv)
