"""The port's VIOEngine against the JAX engine at full width, on the CPU.

The bench workload of bench.py (euroc_config(): 752x480 stereo, 4 pyramid
levels, 4x5 grid with 5 features a cell, 20 clones, 128 lost candidates),
its first 45 frames rendered by the JAX renderer, go through both engines;
once in the ideal world and once in the hostile world of bench.py --suite
(HOSTILE_AUGS: occluders, vignette, flicker, noise), each rendered by the
JAX renderer and by the port's.
45 frames run past the first clone prunes (frames ~20 on). Marked slow:
it takes minutes, so tier-1 (-m 'not slow') leaves it out. Run it with

    python -m pytest tests/test_torch_fullwidth.py -m slow -q -s

(-s shows the two numbers it measures for the record: how far the two
renderers are apart at full width, and how many FAST corners of frame 0
that changes)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vio_msckf_tpu.config import euroc_config as j_euroc_config
from vio_msckf_tpu.data.render import HOSTILE_AUGS as J_HOSTILE
from vio_msckf_tpu.data.render import render_sequence as jrender
from vio_msckf_tpu.data.simulator import SimConfig, bundle_frames, simulate_sequence
from vio_msckf_tpu.engine import VIOEngine as JEngine
from vio_msckf_torch.config import euroc_config as t_euroc_config
from vio_msckf_torch.data.render import HOSTILE_AUGS as T_HOSTILE
from vio_msckf_torch.data.render import render_sequence as trender
from vio_msckf_torch.engine import VIOEngine as TEngine
from vio_msckf_torch.ops.fast import fast_score_map

N_FRAMES = 45
IMU_KEYS = ("imu_gyro", "imu_acc", "imu_dt", "imu_valid")


@pytest.mark.slow
@pytest.mark.parametrize("world", ["ideal", "hostile"])
def test_engine_matches_jax_at_full_width(world):
    augs = dict(ideal=(None, None), hostile=(J_HOSTILE, T_HOSTILE))[world]
    cfg = j_euroc_config()
    sim = SimConfig(duration=12.0, seed=4, amp=(1.5, 1.0, 0.5), yaw_rate=0.2,
                    wobble_amp=0.1)
    seq = simulate_sequence(cfg, sim)
    frames, init, first = bundle_frames(seq, cfg)
    n = N_FRAMES
    R = seq["gt_R_i_w"][first:first + n].transpose(0, 2, 1)
    p = seq["gt_p"][first:first + n]
    j0, j1 = (np.array(x) for x in jrender(cfg, R, p, radius=14.0, seed=7, chunk=15,
                                           augs=augs[0]))
    imu = {k: frames[k][:n] for k in IMU_KEYS}

    # For the record: the port's renderer against the JAX renderer's frames.
    t0, t1 = trender(t_euroc_config(), R, p, radius=14.0, seed=7, chunk=5,
                     device="cpu", augs=augs[1])
    render_diff = max(float(np.abs(t0.numpy() - j0).max()),
                      float(np.abs(t1.numpy() - j1).max()))
    corners = [fast_score_map(torch.as_tensor(x), 15.0) > 0 for x in (t0[0], j0[0])]
    print(f"\n{world} world: renderers at full width: max |port - jax| {render_diff:.3g} DN over "
          f"{n} stereo frames; frame 0 FAST corners (threshold 15): "
          f"{int(corners[1].sum())} from the JAX frame, "
          f"{int((corners[0] != corners[1]).sum())} differ on the port's frame")

    # The same frames (the JAX renderer's) through both engines.
    je = JEngine(cfg)
    jf = dict(cam0_img=jnp.asarray(j0), cam1_img=jnp.asarray(j1),
              **{k: jnp.asarray(v) for k, v in imu.items()})
    jc, jo = jax.jit(je.run_sequence)(je.init(init["q0"], init["bg0"], init["gravity"]), jf)
    te = TEngine(t_euroc_config(), device="cpu")
    tf = dict(cam0_img=torch.from_numpy(j0), cam1_img=torch.from_numpy(j1),
              **{k: torch.as_tensor(v) for k, v in imu.items()})
    tc, to = te.run_sequence(te.init(init["q0"], init["bg0"], init["gravity"]), tf)

    jp, tp = np.asarray(jo.p), to.p.numpy()
    dp = np.abs(tp - jp).max(axis=1)
    bad = np.flatnonzero(dp > 1e-4)
    assert bad.size == 0, f"poses apart from frame {bad[0]} on (max {dp.max():.3g} m)"
    jts, tts = jax.tree_util.tree_map(np.asarray, jc[0]), tc[0]
    assert jts.valid.sum() >= 40
    np.testing.assert_array_equal(tts.ids.numpy(), jts.ids)
    np.testing.assert_array_equal(tts.valid.numpy(), jts.valid)
    np.testing.assert_allclose(tts.cam0_pts.numpy(), jts.cam0_pts, atol=1e-3)
    np.testing.assert_allclose(tts.cam1_pts.numpy(), jts.cam1_pts, atol=1e-3)
    print(f"poses: max |port - jax| {dp.max():.3g} m over {n} frames")


ESKF_FRAMES = 20


@pytest.mark.slow
def test_eskf_matches_jax_at_full_width():
    # The ESKF pipeline at euroc_config() with the default EskfConfig (8 x 8
    # x 8 = 512 keypoints, FAST threshold 20) on the JAX renderer's frames
    # of the bench workload: poses within 1e-4 m at every frame, identical
    # match and inlier counts.
    from vio_msckf_tpu.eskf import EskfVio as JEskfVio
    from vio_msckf_torch.eskf import EskfVio as TEskfVio

    cfg = j_euroc_config()
    seq = simulate_sequence(cfg, SimConfig(duration=12.0, seed=4, amp=(1.5, 1.0, 0.5),
                                           yaw_rate=0.2, wobble_amp=0.1))
    frames, _, first = bundle_frames(seq, cfg)
    n = ESKF_FRAMES
    R = seq["gt_R_i_w"][first:first + n].transpose(0, 2, 1)
    j0, j1 = (np.array(x) for x in jrender(cfg, R, seq["gt_p"][first:first + n], radius=14.0,
                                           seed=7, chunk=10))
    imu = {k: frames[k][:n] for k in IMU_KEYS}
    acc0 = imu["imu_acc"][1][imu["imu_valid"][1]][0]
    jv, tv = JEskfVio(cfg), TEskfVio(t_euroc_config(), device="cpu")
    jc, tc = jv.init(acc0), tv.init(acc0)
    jstep = jax.jit(jv.step)
    jp, tp, counts = [], [], []
    for k in range(n):
        frame = dict(cam0_img=j0[k], cam1_img=j1[k], **{key: v[k] for key, v in imu.items()})
        jc, jo = jstep(jc, {key: jnp.asarray(v) for key, v in frame.items()})
        tc, to = tv.step(tc, {key: torch.as_tensor(v) for key, v in frame.items()})
        jp.append(np.asarray(jo["p"]))
        tp.append(to["p"].numpy())
        counts.append(((int(jo["n_matches"]), int(jo["n_inliers"])),
                       (int(to["n_matches"]), int(to["n_inliers"]))))
    assert all(a == b for a, b in counts), counts
    assert min(a[0] for a, _ in counts[1:]) >= 50
    dp = np.abs(np.stack(tp) - np.stack(jp)).max(axis=1)
    bad = np.flatnonzero(dp > 1e-4)
    assert bad.size == 0, f"ESKF poses apart from frame {bad[0]} on (max {dp.max():.3g} m)"
    print(f"\nESKF at full width: poses max |port - jax| {dp.max():.3g} m over {n} frames; "
          f"matches/inliers per frame {[a for a, _ in counts]}")
