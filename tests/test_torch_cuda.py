"""The hand-written CUDA kernels against their PyTorch twins, on the card,
and the compiled step (a CUDA graph of the engine step, and of the
sharded engine step with its NCCL collectives) against the eager step.

The kernels take the batch of sequences the port steps together: FAST a
(B, H, W) stack of images, LK (B, H_l, W_l) pyramid levels with points
(B, P, 2), SPD any leading axes folded into its flat axis of systems.

The test skips without a CUDA device (the kernels have no CPU mode).
This file imports no jax, so it also runs on a machine without it:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

(--noconftest: tests/conftest.py configures jax).
"""

import weakref

import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter, map_coordinates

from vio_msckf_torch import kernels
from vio_msckf_torch.config import euroc_config
from vio_msckf_torch.data.render import HOSTILE_AUGS, render_sequence
from vio_msckf_torch.data.simulator import SimConfig, bundle_frames, simulate_sequence
from vio_msckf_torch.engine import VIOEngine
from vio_msckf_torch.eskf import EskfVio
from vio_msckf_torch.ops import fast, klt, pyramid, spd
from vio_msckf_torch.parallel import tiny_config


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand kernels have no CPU mode")
    return torch.device("cuda")


def _textured_pair(H=240, W=376, seed=5):
    rng = np.random.default_rng(seed)
    img0 = (gaussian_filter(rng.uniform(0, 255, (H, W)), 2.0) * 3 - 200).astype(np.float32)
    yy, xx = np.mgrid[0:H, 0:W]
    img1 = map_coordinates(img0, [yy - 1.3, xx + 2.2], order=1,
                           mode="nearest").astype(np.float32)
    border = [[0, 0], [W - 1, H - 1], [1, H - 2], [W - 2, 3], [0.5, 60], [100, 0.5]]
    pts = np.concatenate([rng.uniform([2, 2], [W - 3, H - 3], (122, 2)), border])
    return img0, img1, pts.astype(np.float32)


def _fast_inputs(cuda):
    """Frames 0, 40, 110 and the last of the bench workload (rendered on
    the card), the integer blocky image (ties, dense in corners), frame
    40's coarser pyramid levels (240x376, 120x188, 60x94: the scalar path
    at W % 4 != 0) and a 97x131 crop, a multiple of no tile side."""
    cfg = euroc_config()
    seq = simulate_sequence(cfg, SimConfig(duration=12.0, seed=4, amp=(1.5, 1.0, 0.5),
                                           yaw_rate=0.2, wobble_amp=0.1))
    frames, _, first = bundle_frames(seq, cfg)
    n = len(frames["timestamp"])
    idx = [0, 40, 110, n - 1]
    R = seq["gt_R_i_w"][first:first + n].transpose(0, 2, 1)[idx]
    cam0, _ = render_sequence(cfg, R, seq["gt_p"][first:first + n][idx], radius=14.0,
                              seed=7, device=cuda)
    rng = np.random.default_rng(4)
    blocky = np.kron(rng.integers(0, 256, (121, 189)), np.ones((4, 4)))[:480, :752]
    imgs = [cam0[k] for k in range(len(idx))]
    imgs += [torch.as_tensor(blocky, dtype=torch.float32, device=cuda)]
    imgs += [x[0] for x in pyramid.build_pyramid(imgs[1][None], 3)[1:]]
    imgs += [imgs[1][200:297, 300:431]]
    return [x.contiguous() for x in imgs]


def _launches(wrapper):
    """Kernel launches a wrapper has counted, over all its call shapes."""
    return sum(wrapper.by_shape.values())


def _misaligned(x):
    """A contiguous copy of x whose data starts 4 bytes past a 16-byte
    boundary: no plane is 16-byte aligned (the kernel's scalar path)."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    out = buf[1:].view(x.shape)
    out.copy_(x)
    return out


def _check_fast(cuda):
    # Only subtract/min/max: the kernel must equal the twin bit for bit,
    # ties included, at every threshold, in every plane of a batch.
    imgs = _fast_inputs(cuda)
    full = torch.stack([x for x in imgs if x.shape == (480, 752)])   # 4 frames + blocky
    batches = [x[None] for x in imgs] + [
        full,                                          # B = 5 at the main path's width
        full[:4].contiguous(),
        torch.stack([pyramid.build_pyramid(x[None], 3)[3][0] for x in imgs[:4]]),  # W % 4 != 0
        torch.stack([x[200:297, 300:431] for x in imgs[:3]]).contiguous(),   # H*W odd
        _misaligned(full[:3]),                         # planes off 16-byte boundaries
    ]
    for batch in batches:
        for thr in (0.0, 15.0, 40.0):
            before = _launches(fast.fast_nms)
            out = fast.fast_nms(batch, thr)
            assert _launches(fast.fast_nms) == before + 1     # one launch per stack
            want = fast.fast_score_map(batch, thr)
            for b in range(batch.shape[0]):
                assert torch.equal(out[b], want[b]), (tuple(batch.shape), b, thr,
                                                      int((out[b] != want[b]).sum()))
                if thr == 15.0 and batch.shape[1:] == (480, 752):
                    assert int((out[b] > 0).sum()) > 100


def _check_fast_eskf(cuda):
    # The ESKF's call: both rectified views of a stereo frame (bilinear
    # warps) as one (2, 480, 752) stack at threshold 20, bit for bit, in
    # one launch.
    cfg = euroc_config()
    seq = simulate_sequence(cfg, SimConfig(duration=12.0, seed=4, amp=(1.5, 1.0, 0.5),
                                           yaw_rate=0.2, wobble_amp=0.1))
    _, _, first = bundle_frames(seq, cfg)
    k = first + 40
    cam0, cam1 = render_sequence(cfg, seq["gt_R_i_w"][k:k + 1].transpose(0, 2, 1),
                                 seq["gt_p"][k:k + 1], radius=14.0, seed=7, device=cuda)
    vio = EskfVio(cfg, device=cuda)
    rect = vio.rectify(cam0[0], cam1[0]).contiguous()
    before = _launches(fast.fast_nms)
    out = fast.fast_nms(rect, vio.eskf.fast_threshold)
    assert _launches(fast.fast_nms) == before + 1
    want = fast.fast_score_map(rect, vio.eskf.fast_threshold)
    assert torch.equal(out, want), int((out != want).sum())
    assert int((out > 0).sum()) > 200


def _lk_close(got, want, p95_max=2e-2, agree_min=0.99):
    """The reference's bound between its own LK backends: p95 < 2e-2 px
    over mutually tracked points, >= 99% status agreement."""
    (g, s), (g2, s2) = (got[0].cpu(), got[1].cpu()), (want[0].cpu(), want[1].cpu())
    assert (s == s2).float().mean() >= agree_min
    both = s & s2
    d = torch.linalg.vector_norm(g[both] - g2[both], dim=1).numpy()
    assert both.sum() > 0 and np.percentile(d, 95) < p95_max
    return s2


def _check_lk(cuda, B):
    # B sequences, each its own textured pair and points; one launch for
    # all B * P features, held against the twin per sequence.
    pairs = [_textured_pair(seed=5 + b) for b in range(B)]
    stack = lambda i: torch.from_numpy(np.stack([p[i] for p in pairs]))   # noqa: E731
    p0, p1, pts = pyramid.build_pyramid(stack(0), 3), pyramid.build_pyramid(stack(1), 3), stack(2)
    assert len(p0) == 4 and min(p0[-1].shape[1:]) >= 15 + 8   # every level tracked
    want = klt.pyramidal_lk(p0, p1, pts, pts)
    on = [[x.to(cuda) for x in p] for p in (p0, p1)]
    before = _launches(klt.track_pyramid)
    got = klt.pyramidal_lk(*on, pts.to(cuda), pts.to(cuda))
    assert _launches(klt.track_pyramid) == before + 1   # the 4-level walk in one launch
    for b in range(B):
        assert _lk_close([x[b] for x in got], [x[b] for x in want]).sum() > 60
    # lk_verify: both backward checks (pair A img1->img0 from the tracked
    # points, pair B img0->img1 from the seeds) in one launch.
    g_t = got[0].cpu()
    want_v = klt.lk_verify(p1, p0, p0, p1, g_t, pts, pts, g_t)
    before = _launches(klt.track_pyramid)
    got_v = klt.lk_verify(on[1], on[0], on[0], on[1], g_t.to(cuda), pts.to(cuda),
                          pts.to(cuda), g_t.to(cuda))
    assert _launches(klt.track_pyramid) == before + 1
    for gv, wv in zip(got_v, want_v):
        for b in range(B):
            assert _lk_close([x[b] for x in gv], [x[b] for x in wv]).sum() > 60


def _check_lk_plane_border(cuda):
    # Sequence 0's features on its last rows, sequence 1's on its first
    # rows, on different images: a kernel that clamps rows on the flat
    # (B * H, W) stack instead of within each plane, or reads plane 0 for
    # every sequence, gives other results than the twin.
    pairs = [_textured_pair(seed=s) for s in (8, 9, 10, 11)]
    H, W = pairs[0][0].shape
    rng = np.random.default_rng(12)
    x = rng.uniform(10, W - 10, (4, 40))
    y = np.stack([H - 1 - rng.uniform(0, 3, 40), rng.uniform(0, 3, 40),
                  rng.uniform(5, H - 5, 40), H - 1 - rng.uniform(0, 3, 40)])
    pts = torch.as_tensor(np.stack([x, y], axis=-1), dtype=torch.float32)
    init = pts + torch.as_tensor(rng.uniform(-2, 2, pts.shape), dtype=torch.float32)
    stack = lambda i: torch.from_numpy(np.stack([p[i] for p in pairs]))   # noqa: E731
    p0, p1 = pyramid.build_pyramid(stack(0), 3), pyramid.build_pyramid(stack(1), 3)
    g2, s2, e2 = klt.pyramidal_lk(p0, p1, pts, init)
    g, s, e = (t.cpu() for t in klt.pyramidal_lk(
        [t.to(cuda) for t in p0], [t.to(cuda) for t in p1], pts.to(cuda), init.to(cuda)))
    assert 0 < int(s2.sum()) < s2.numel()
    torch.testing.assert_close(s, s2, rtol=0, atol=0)
    torch.testing.assert_close(g[s2], g2[s2], rtol=0, atol=1e-3)
    torch.testing.assert_close(e[s2], e2[s2], rtol=0, atol=1e-3)


def _check_lk_border(cuda):
    # Points on and near the image border at every level of the 4-level
    # pyramid (d * 2^l px from an edge is d px at level l), tracked from
    # guesses that push some of them out: clipped windows, zero-weight
    # taps and lost tracks. Kernel and twin share every window and tap.
    img0, img1, _ = _textured_pair(seed=6)
    H, W = img0.shape
    rng = np.random.default_rng(7)
    pts = []
    for lvl in range(4):
        for d in (0.0, 0.5, 1.5, 3.0):
            e = d * 2 ** lvl
            x, y = rng.uniform(20, W - 20), rng.uniform(20, H - 20)
            pts += [[e, y], [W - 1 - e, y], [x, e], [x, H - 1 - e]]
    pts = np.asarray(pts, np.float32)
    init = pts + rng.uniform(-3, 3, pts.shape).astype(np.float32)
    p0 = pyramid.build_pyramid(torch.from_numpy(img0)[None], 3)
    p1 = pyramid.build_pyramid(torch.from_numpy(img1)[None], 3)
    pts, init = torch.from_numpy(pts)[None], torch.from_numpy(init)[None]
    g2, s2, e2 = klt.pyramidal_lk(p0, p1, pts, init)
    g, s, e = (x.cpu() for x in klt.pyramidal_lk(
        [x.to(cuda) for x in p0], [x.to(cuda) for x in p1], pts.to(cuda), init.to(cuda)))
    assert 0 < int(s2.sum()) < pts.shape[1]
    torch.testing.assert_close(s, s2, rtol=0, atol=0)
    torch.testing.assert_close(g[s2], g2[s2], rtol=0, atol=1e-3)
    torch.testing.assert_close(e[s2], e2[s2], rtol=0, atol=1e-3)


def _check_spd(cuda, F, m, atol, rtol, n_active=None, lead=None):
    # The reference's bounds between Gauss-Jordan and LAPACK
    # (tests/test_spd_pallas.py): SPD systems H P H^T + s I, whose rows past
    # each system's active count are s * I padding (skipped pivots).
    rng = np.random.default_rng(m + F)
    D = 141
    A = rng.normal(size=(D, D)) * 0.05
    Hm = rng.normal(size=(F, m, D)) * 0.5
    if n_active is None:
        n_active = rng.integers(4, m + 1, size=F)
    Hm *= (np.arange(m)[None, :] < np.asarray(n_active).reshape(-1, 1))[..., None]
    B = Hm @ (A @ A.T) @ Hm.transpose(0, 2, 1) + 0.035 ** 2 * np.eye(m)
    B = torch.as_tensor((B + B.transpose(0, 2, 1)) / 2.0, dtype=torch.float32, device=cuda)
    R = torch.as_tensor(rng.normal(size=(F, m, 4)), dtype=torch.float32, device=cuda)
    if lead is not None:          # leading axes (sequences, features)
        B, R = B.reshape(lead + (m, m)), R.reshape(lead + (m, 4))
    before = _launches(spd.spd_solve)
    got, want = spd.spd_solve(B, R), spd.spd_solve_plain(B, R)
    assert _launches(spd.spd_solve) == before + 1   # one launch for all systems
    assert got.shape == R.shape
    # Each row against its own magnitude: a padding row's X = R / s is ~1e3
    # times a live row's, so one scale for the batch would let any live
    # value pass.
    scale = want.abs().amax(dim=-1, keepdim=True).clamp_min(1.0)
    assert torch.all((got - want).abs() <= atol * scale + rtol * want.abs())


def _launch_shapes():
    return {k: dict(w.by_shape) for k, w in kernels.counters().items()}


def _tiny_sequences(cuda, cfg, n):
    """Two sequences of n frames at tiny_config rendered on the card (the
    second in the hostile world): [(frames (T, ...), init), ...]."""
    seqs = []
    for augs in (None, HOSTILE_AUGS):
        sim = SimConfig(duration=1.0 + 0.05 * (n + 0.5), seed=4, amp=(1.5, 1.0, 0.5),
                        yaw_rate=0.2, wobble_amp=0.1, static_init_time=1.0)
        seq = simulate_sequence(cfg, sim)
        frames, init, first = bundle_frames(seq, cfg)
        R = seq["gt_R_i_w"][first:first + n].transpose(0, 2, 1)
        cam0, cam1 = render_sequence(cfg, R, seq["gt_p"][first:first + n], radius=14.0,
                                     seed=7, device=cuda, augs=augs)
        seqs.append((dict(cam0_img=cam0, cam1_img=cam1,
                          **{k: torch.as_tensor(frames[k][:n], device=cuda)
                             for k in ("imu_gyro", "imu_acc", "imu_dt", "imu_valid")}), init))
    return seqs


def _eager_run(eng, inits, frames, n):
    """The eager step_batch over n frames (each contiguous, as the graph's
    static frame buffers hold it): (carry, positions (B, n, 3))."""
    carry, ps = eng.init_batch(inits), []
    for k in range(n):
        carry, out = eng.step_batch(carry, {key: v[:, k].contiguous()
                                            for key, v in frames.items()})
        ps.append(out.p)
    return carry, torch.stack(ps, dim=1)


def _check_graph(cuda, n=10):
    # The compiled step (vio_msckf_torch/graph.py) against the eager step
    # at tiny_config, at B = 1 (run_sequence) and B = 2 (run_batch; the
    # second sequence in the hostile world): the same bits and the same
    # launches per call shape.
    cfg = tiny_config()
    seqs = _tiny_sequences(cuda, cfg, n)
    for B in (1, 2):
        frames = {k: torch.stack([f[k] for f, _ in seqs[:B]]) for k in seqs[0][0]}
        inits = [i for _, i in seqs[:B]]
        eng = VIOEngine(cfg, cuda)
        for w in kernels.counters().values():
            w.by_shape.clear()
        carry, p = _eager_run(eng, inits, frames, n)
        eager = _launch_shapes()
        for w in kernels.counters().values():
            w.by_shape.clear()
        carry_g, outs = eng.run_batch(eng.init_batch(inits), frames)
        assert _launch_shapes() == eager
        assert len(eng.compiled.graphs) == 1
        assert torch.equal(outs.p, p), B
        for a, b in zip(carry_g[1].__dict__.values(), carry[1].__dict__.values()):
            assert torch.equal(a, b)
        # A second run replays every frame: the same bits again.
        assert torch.equal(eng.run_batch(eng.init_batch(inits), frames)[1].p, outs.p)

    # The runner holds its engine's step weakly: a dropped engine goes at
    # once with its graphs and their memory pools, and another engine
    # captures after it.
    ref = weakref.ref(eng)
    del eng
    assert ref() is None
    eng = VIOEngine(cfg, cuda)
    assert torch.equal(eng.run_batch(eng.init_batch(inits), frames)[1].p, outs.p)


def _check_nccl_graph(cuda, n=6):
    # The sharded engine step under NCCL at world size 1, a block group of
    # one (its collectives are all-gathers over that group), at
    # tiny_config: captured with the collectives inside and replayed, bit
    # for bit against the eager sharded step; then the engine is dropped
    # (its weak reference dies at once) and another captures on the same
    # group.
    import torch.distributed as dist
    from vio_msckf_torch.parallel import make_mesh
    from vio_msckf_torch.parallel.distributed import free_port

    cfg = tiny_config()
    frames, init = _tiny_sequences(cuda, cfg, n)[0]
    frames = {k: v[None] for k, v in frames.items()}
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}",
                            world_size=1, rank=0)
    try:
        group = make_mesh(1, 1).block_group
        eng = VIOEngine(cfg, cuda, block_group=group)
        assert eng.compiled.capture
        carry, p = _eager_run(eng, [init], frames, n)
        carry_g, outs = eng.run_batch(eng.init_batch([init]), frames)
        assert len(eng.compiled.graphs) == 1
        assert torch.equal(outs.p, p)
        for a, b in zip(carry_g[1].__dict__.values(), carry[1].__dict__.values()):
            assert torch.equal(a, b)
        ref = weakref.ref(eng)
        del eng
        assert ref() is None
        eng = VIOEngine(cfg, cuda, block_group=group)
        assert torch.equal(eng.run_batch(eng.init_batch([init]), frames)[1].p, p)
        eng.compiled.clear()            # before the group: NCCL's shutdown waits for it
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_kernels_match_twins(cuda):
    # One test item: see tests/test_torch_slice.py on xdist's file order.
    _check_fast(cuda)
    _check_fast_eskf(cuda)
    _check_lk(cuda, 1)
    _check_lk(cuda, 4)
    _check_lk_border(cuda)
    _check_lk_plane_border(cuda)
    # The main path's two shapes (lost path, prune path), then edge cases:
    # one system; an m that is not a multiple of the 16-wide thread tile;
    # the 30-clone lost path (m=120, the larger register tile); all pivots
    # padding (diagonal B) or all but one; no padding at all.
    _check_spd(cuda, 128, 80, 2e-3, 2e-3)
    _check_spd(cuda, 160, 8, 1e-4, 1e-3)
    # The batched step's shapes: 4 sequences x 128 lost candidates (m=80)
    # and x 160 prune features (m=8); the 30-clone lost path (m=120).
    _check_spd(cuda, 512, 80, 2e-3, 2e-3, lead=(4, 128))
    _check_spd(cuda, 640, 8, 1e-4, 1e-3, lead=(4, 160))
    _check_spd(cuda, 128, 120, 2e-3, 2e-3, lead=(1, 128))
    _check_spd(cuda, 1, 80, 2e-3, 2e-3)
    _check_spd(cuda, 3, 76, 2e-3, 2e-3)
    _check_spd(cuda, 8, 120, 2e-3, 2e-3)
    _check_spd(cuda, 4, 80, 2e-3, 2e-3, n_active=[0, 1, 80, 2])
    _check_spd(cuda, 5, 8, 1e-4, 1e-3, n_active=[0, 1, 8, 8, 3])
    _check_graph(cuda)
    _check_nccl_graph(cuda)
