"""The hand-written CUDA kernels against their PyTorch twins, on the card.

The test skips without a CUDA device (the kernels have no CPU mode).
This file imports no jax, so it also runs on a machine without it:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

(--noconftest: tests/conftest.py configures jax).
"""

import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter, map_coordinates

from vio_msckf_torch.ops import fast, klt, pyramid, spd


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


def _check_fast(cuda):
    # Only subtract/min/max: the kernel must equal the twin bit for bit,
    # ties included (integer-valued blocky image).
    rng = np.random.default_rng(4)
    img = np.kron(rng.integers(0, 256, (121, 189)), np.ones((4, 4)))[:480, :752]
    img = torch.as_tensor(img, dtype=torch.float32, device=cuda)
    before = fast.fast_nms.launches
    out = fast.fast_nms(img, 15.0)
    assert fast.fast_nms.launches == before + 1
    assert torch.equal(out, fast.fast_score_map(img, 15.0))
    assert int((out > 0).sum()) > 100


def _check_lk(cuda):
    # The reference's bound between its own LK backends: p95 < 2e-2 px over
    # mutually tracked points, >= 99% status agreement.
    img0, img1, pts = _textured_pair()
    p0 = pyramid.build_pyramid(torch.from_numpy(img0), 3)
    p1 = pyramid.build_pyramid(torch.from_numpy(img1), 3)
    want = klt.pyramidal_lk(p0, p1, torch.from_numpy(pts), torch.from_numpy(pts))
    on = [[x.to(cuda) for x in p] for p in (p0, p1)]
    got = klt.pyramidal_lk(*on, torch.from_numpy(pts).to(cuda), torch.from_numpy(pts).to(cuda))
    (g, s), (g2, s2) = (got[0].cpu(), got[1].cpu()), want[:2]
    assert s2.sum() > 60
    assert (s == s2).float().mean() >= 0.99
    both = s & s2
    d = torch.linalg.vector_norm(g[both] - g2[both], dim=1).numpy()
    assert np.percentile(d, 95) < 2e-2
    # lk_verify: both backward checks (pair A img1->img0 from the tracked
    # points, pair B img0->img1 from the seeds) in one launch.
    pts_t, g_t = torch.from_numpy(pts), got[0].cpu()
    want_v = klt.lk_verify(p1, p0, p0, p1, g_t, pts_t, pts_t, g_t)
    got_v = klt.lk_verify(on[1], on[0], on[0], on[1], g_t.to(cuda), pts_t.to(cuda),
                          pts_t.to(cuda), g_t.to(cuda))
    for (gv, sv, _), (wv, tv, _) in zip(got_v, want_v):
        sv = sv.cpu()
        assert (sv == tv).float().mean() >= 0.99
        both = sv & tv
        d = torch.linalg.vector_norm(gv.cpu()[both] - wv[both], dim=1).numpy()
        assert both.sum() > 60 and np.percentile(d, 95) < 2e-2


def _check_spd(cuda, F, m, atol, rtol):
    # The reference's bounds between Gauss-Jordan and LAPACK
    # (tests/test_spd_pallas.py): SPD systems H P H^T + s I.
    rng = np.random.default_rng(m)
    D = 141
    A = rng.normal(size=(D, D)) * 0.05
    Hm = rng.normal(size=(F, m, D)) * 0.5
    Hm *= (np.arange(m)[None, :] < rng.integers(4, m + 1, size=F)[:, None])[..., None]
    B = Hm @ (A @ A.T) @ Hm.transpose(0, 2, 1) + 0.035 ** 2 * np.eye(m)
    B = torch.as_tensor((B + B.transpose(0, 2, 1)) / 2.0, dtype=torch.float32, device=cuda)
    R = torch.as_tensor(rng.normal(size=(F, m, 4)), dtype=torch.float32, device=cuda)
    got, want = spd.spd_solve(B, R), spd.spd_solve_plain(B, R)
    scale = max(float(want.abs().max()), 1.0)
    torch.testing.assert_close(got, want, atol=atol * scale, rtol=rtol)


@pytest.mark.cuda
def test_kernels_match_twins(cuda):
    # One test item: see tests/test_torch_slice.py on xdist's file order.
    _check_fast(cuda)
    _check_lk(cuda)
    _check_spd(cuda, 128, 80, 2e-3, 2e-3)
    _check_spd(cuda, 160, 8, 1e-4, 1e-3)
