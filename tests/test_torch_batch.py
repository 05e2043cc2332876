"""The port's batched step (a leading axis of B sequences through one code
path) against the JAX package's `jax.vmap`, on the CPU, at the reduced
config of tests/test_torch_slice.py (188x120 stereo, 3 pyramid levels, 2x2
grid, 32 tracks, 6 clones):

  (a) jax.jit(jax.vmap(JAX VIOEngine.run_sequence)) against
      VIOEngine(cfg, device="cpu").run_batch on the same B = 2 sequences,
      one rendered in the ideal world and one in the hostile world
      (occluders, vignette, flicker, noise), both by the JAX renderer.
      Halfway, sequence 0's covariance is faulted on both sides, so the
      two sequences take different branches: sequence 0 resets online and
      sequence 1 does not, then sequence 1 prunes its full clone window
      and sequence 0 does not;
  (b) member b of the port's batch against that sequence run alone (with
      the same fault);
  (c) the port's hostile renderer against the JAX renderer;
  (d) the carry stacked by jax.vmap at the halfway point, converted by
      convert.from_numpy_tree and resumed by the port;
  (e) the batched LK twin with features on the last rows of sequence 0's
      images and the first rows of sequence 1's: each sequence reads its
      own plane.

The checks form one test item on purpose: under `pytest -n N --dist
loadfile`, pytest-xdist hands out files in order of their item count,
most first, so a one-item file is handed out after the long end-to-end
files have started and does not hold one of them back."""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import jax
import pytest
import torch
from scipy.ndimage import gaussian_filter

from test_torch_slice import _small_config
from vio_msckf_tpu import config as jconfig
from vio_msckf_tpu.data.render import HOSTILE_AUGS as J_HOSTILE
from vio_msckf_tpu.data.render import render_sequence as jrender
from vio_msckf_tpu.data.simulator import SimConfig, bundle_frames, simulate_sequence
from vio_msckf_tpu.engine import VIOEngine as JEngine
from vio_msckf_torch import config as tconfig
from vio_msckf_torch import convert
from vio_msckf_torch.data.render import HOSTILE_AUGS as T_HOSTILE
from vio_msckf_torch.data.render import render_sequence as trender
from vio_msckf_torch.engine import VIOEngine as TEngine
from vio_msckf_torch.ops import klt, pyramid
from vio_msckf_torch.tensors import index_record

IMU_KEYS = ("imu_gyro", "imu_acc", "imu_dt", "imu_valid")
N_FRAMES = 6


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Tiny CPU ops: one thread avoids oversubscribing parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def workload():
    """Two sequences of N_FRAMES moving frames (bench seeds 4 and 5; the
    second in the hostile world), rendered by the JAX renderer, and the
    hostile frames rendered by the port."""
    cfg, tcfg = _small_config(jconfig), _small_config(tconfig)
    seqs = []
    for seed, augs in ((4, None), (5, J_HOSTILE)):
        sim = SimConfig(duration=1.0 + 0.05 * (N_FRAMES + 0.5), seed=seed,
                        amp=(1.5, 1.0, 0.5), yaw_rate=0.2, wobble_amp=0.1,
                        static_init_time=1.0)
        seq = simulate_sequence(cfg, sim)
        frames, init, first = bundle_frames(seq, cfg)
        n = N_FRAMES
        assert len(frames["timestamp"]) >= n
        R = seq["gt_R_i_w"][first:first + n].transpose(0, 2, 1)
        p = seq["gt_p"][first:first + n]
        j0, j1 = jrender(cfg, R, p, radius=14.0, seed=7, chunk=n, augs=augs)
        seqs.append(dict(init=init, imu={k: frames[k][:n] for k in IMU_KEYS}, R=R, p=p,
                         img=(np.asarray(j0), np.asarray(j1))))
    t0, t1 = trender(tcfg, seqs[1]["R"], seqs[1]["p"], radius=14.0, seed=7, chunk=4,
                     device="cpu", augs=T_HOSTILE)
    return dict(cfg=cfg, tcfg=tcfg, seqs=seqs, port_hostile=(t0.numpy(), t1.numpy()))


def _frames(seq, lib):
    """One sequence's frames as a dict of lib arrays (numpy or torch)."""
    conv = np.asarray if lib == "numpy" else torch.as_tensor
    return dict(cam0_img=conv(seq["img"][0]), cam1_img=conv(seq["img"][1]),
                **{k: conv(v) for k, v in seq["imu"].items()})


def _check_hostile_renderer(workload):
    # Same threefry bits for the noise, the same occluder orbits, vignette
    # and flicker; f32 sin of phases ~1e2 rad and erfinv's last bits keep
    # them a few 1e-4 DN apart.
    ideal = workload["seqs"][0]["img"][0]
    for j, t in zip(workload["seqs"][1]["img"], workload["port_hostile"]):
        assert t.shape == j.shape == (N_FRAMES, 120, 188)
        assert np.abs(t - j).max() <= 1e-3
    assert np.abs(workload["seqs"][1]["img"][0] - ideal).mean() > 1.0   # hostile is on


def _stack(trees):
    """Trees of one structure, stacked leaf by leaf on a new axis 0."""
    return jax.tree_util.tree_map(lambda *xs: np.stack([np.asarray(x) for x in xs]), *trees)


def _halves(frames, axis):
    """Frames split in two halves on their time axis."""
    half = N_FRAMES // 2
    return [{k: v.narrow(axis, a, b - a) for k, v in frames.items()}
            for a, b in ((0, half), (half, N_FRAMES))]


def _fault(carry, b=None):
    """The carry with sequence b's position sigma at 10 m, above the 8 m
    online-reset gate (b None: a one-sequence carry)."""
    P = carry[1].P.clone()
    P[(12, 12) if b is None else (b, 12, 12)] = 100.0
    return carry[0], carry[1].replace(P=P), carry[2]


def _check_engines(workload):
    cfg, seqs = workload["cfg"], workload["seqs"]
    half = N_FRAMES // 2
    inits = [s["init"] for s in seqs]
    # (a) JAX, vmapped over the two sequences, in two halves: sequence 0 is
    # faulted at the halfway carry, which (d) also resumes from. XLA
    # compiles in a second thread while the port runs.
    je = JEngine(cfg)
    jcarry0 = _stack([je.init(i["q0"], i["bg0"], i["gravity"]) for i in inits])
    jf = _stack([_frames(s, "numpy") for s in seqs])
    jh = [jax.tree_util.tree_map(lambda x: x[:, a:b], jf)
          for a, b in ((0, half), (half, N_FRAMES))]
    lowered = jax.jit(jax.vmap(je.run_sequence)).lower(jcarry0, jh[0])
    with ThreadPoolExecutor(1) as pool:
        compiling = pool.submit(lowered.compile)

        te = TEngine(workload["tcfg"], device="cpu")
        th = _halves({k: torch.as_tensor(v) for k, v in jf.items()}, 1)
        tc1, to1 = te.run_batch(te.init_batch(inits), th[0])
        tc, to2 = te.run_batch(_fault(tc1, 0), th[1])
        tp = np.concatenate([to1.p.numpy(), to2.p.numpy()], axis=1)
        t_reset = np.concatenate([to1.did_reset.numpy(), to2.did_reset.numpy()], axis=1)
        assert tp.shape == (2, N_FRAMES, 3) and np.isfinite(tp).all()

        # (b) each member equals its sequence run alone, with the same fault.
        for b, s in enumerate(seqs):
            i = s["init"]
            h = _halves(_frames(s, "torch"), 0)
            c1, o1 = te.run_sequence(te.init(i["q0"], i["bg0"], i["gravity"]), h[0])
            c2, o2 = te.run_sequence(_fault(c1) if b == 0 else c1, h[1])
            np.testing.assert_allclose(np.concatenate([o1.p.numpy(), o2.p.numpy()]), tp[b],
                                       atol=1e-6)
            np.testing.assert_array_equal(c2[0].ids.numpy(), tc[0].ids[b].numpy())
            np.testing.assert_allclose(c2[1].P.numpy(), tc[1].P[b].numpy(), atol=1e-9)
        run = compiling.result()

    jc1, jo1 = run(jcarry0, jh[0])
    jc1 = jax.tree_util.tree_map(np.array, jc1)
    jc1[1].P[0, 12, 12] = 100.0
    jc2, jo2 = run(jc1, jh[1])          # dispatched: runs while (d) runs the port
    # (d) the vmapped JAX carry (lane-row pyramids with a leading B),
    # converted, resumes to the JAX second half.
    carry = convert.from_numpy_tree(jc1, device="cpu")
    assert carry[0].pyr_prev[0].shape == (2, 120, 188) and carry[1].P.shape[0] == 2
    tcd, tod = te.run_batch(carry, th[1])
    jc2 = jax.tree_util.tree_map(np.asarray, jc2)

    jp = np.concatenate([np.asarray(jo1.p), np.asarray(jo2.p)], axis=1)
    np.testing.assert_allclose(tp, jp, atol=1e-4)
    # Sequence 0 resets on the first faulted frame, sequence 1 never; with
    # 3 clones at the halfway point, sequence 1 fills its 6-clone window on
    # the last frame and prunes it to 4, while sequence 0 holds 2.
    j_reset = np.concatenate([np.asarray(jo1.did_reset), np.asarray(jo2.did_reset)], axis=1)
    want = np.zeros((2, N_FRAMES), bool)
    want[0, half] = True
    np.testing.assert_array_equal(j_reset, want)
    np.testing.assert_array_equal(t_reset, j_reset)
    np.testing.assert_array_equal(jc2[1].n_clones, [2, 4])
    for c in (tc, tcd):
        np.testing.assert_array_equal(c[1].n_clones.numpy(), jc2[1].n_clones)
        np.testing.assert_array_equal(c[1].clone_valid.numpy(), jc2[1].clone_valid)
        np.testing.assert_array_equal(c[2].valid.numpy(), jc2[2].valid)
    for b in range(2):
        assert jc2[0].valid[b].sum() >= 8
        for c in (tc, tcd):
            np.testing.assert_array_equal(c[0].ids[b].numpy(), jc2[0].ids[b])
            np.testing.assert_array_equal(c[0].valid[b].numpy(), jc2[0].valid[b])
            np.testing.assert_array_equal(c[0].next_id[b].numpy(), jc2[0].next_id[b])
    # The two sequences really differ (ideal and hostile world).
    assert not np.array_equal(tc[0].ids[0].numpy(), tc[0].ids[1].numpy()) \
        or np.abs(tp[0] - tp[1]).max() > 1e-6
    np.testing.assert_allclose(tod.p.numpy(), np.asarray(jo2.p), atol=1e-4)
    np.testing.assert_allclose(index_record(tod, 1).p.numpy(), jp[1, half:], atol=1e-4)
    np.testing.assert_allclose(tcd[1].P.numpy(), jc2[1].P, atol=1e-5 * np.abs(jc2[1].P).max())


def _check_lk_plane_border():
    # (e) Sequence 0's features sit on its last rows, sequence 1's on its
    # first rows, on different images: a sampler that clamps rows on the
    # flat (B * H, W) stack, not within each plane, would read the other
    # sequence's image there.
    H, W = 60, 94
    rng = np.random.default_rng(11)
    imgs = [(gaussian_filter(rng.uniform(0, 255, (H, W)), 1.5) * 3 - 200).astype(np.float32)
            for _ in range(4)]
    prev = torch.from_numpy(np.stack(imgs[:2]))
    nxt = torch.from_numpy(np.stack(imgs[2:]))
    x = rng.uniform(5, W - 5, (2, 12)).astype(np.float32)
    y = np.stack([H - 1 - rng.uniform(0, 2, 12), rng.uniform(0, 2, 12)]).astype(np.float32)
    pts = torch.from_numpy(np.stack([x, y], axis=-1))
    init = pts + torch.from_numpy(rng.uniform(-1, 1, pts.shape).astype(np.float32))
    args = dict(win=15, iters=30, eps=0.01, min_eig_threshold=1e-4)
    pb, pn = pyramid.build_pyramid(prev, 1), pyramid.build_pyramid(nxt, 1)
    got = klt.track_pyramid_plain(pb, pn, pts, init, **args)
    for b in range(2):
        alone = klt.track_pyramid_plain([x[b:b + 1] for x in pb], [x[b:b + 1] for x in pn],
                                        pts[b:b + 1], init[b:b + 1], **args)
        np.testing.assert_array_equal(got[1][b].numpy(), alone[1][0].numpy())
        np.testing.assert_allclose(got[0][b].numpy(), alone[0][0].numpy(), atol=1e-5)
        np.testing.assert_allclose(got[2][b].numpy(), alone[2][0].numpy(), atol=1e-5)
    # The swap test: sequence 1's points tracked on sequence 0's images
    # give other results, so the check above can tell the planes apart.
    swapped = klt.track_pyramid_plain([x[:1] for x in pb], [x[:1] for x in pn],
                                      pts[1:], init[1:], **args)
    assert not torch.allclose(swapped[0][0], got[0][1], atol=1e-3)


def test_batch_matches_jax_vmap(workload):
    _check_hostile_renderer(workload)
    _check_lk_plane_border()
    _check_engines(workload)
