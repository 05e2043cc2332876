"""Parity of the PyTorch port's image ops and kernel twins
(vio_msckf_torch/ops) with the JAX package on the CPU. The kernels
themselves are held against these twins in tests/test_torch_cuda.py.

The JAX side runs as its own tests run it here: FAST through XLA and the
Pallas interpreter, LK through the XLA backend, the SPD solve through the
Pallas interpreter (spd_solve interprets off-TPU).

The checks form one test item on purpose: under `pytest -n N --dist
loadfile`, pytest-xdist hands out files in order of their item count,
most first, so a one-item file is handed out after the long end-to-end
files have started and does not hold one of them back.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from scipy.ndimage import gaussian_filter, map_coordinates

from vio_msckf_tpu.ops import distortion as jdist
from vio_msckf_tpu.ops import fast as jfast
from vio_msckf_tpu.ops import klt as jklt
from vio_msckf_tpu.ops import pyramid as jpyr
from vio_msckf_tpu.ops.fast_pallas import fast_score_map_pallas
from vio_msckf_tpu.ops.spd_pallas import spd_solve as jspd_solve
from vio_msckf_torch.ops import distortion as tdist
from vio_msckf_torch.ops import fast as tfast
from vio_msckf_torch.ops import klt as tklt
from vio_msckf_torch.ops import pyramid as tpyr
from vio_msckf_torch.ops import spd as tspd

H, W = 120, 188


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Tiny CPU ops: one thread avoids oversubscribing parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _blocky(rng, h=H, w=W):
    """Integer-valued blocky image: many equal FAST scores (ties)."""
    img = np.kron(rng.integers(0, 256, (h // 4 + 1, w // 4 + 1)), np.ones((4, 4)))
    return img[:h, :w].astype(np.float32)


def _lk_pair():
    """A smooth textured image and a copy shifted by (2.2, -1.3) px, plus
    points that include the image corners and edges."""
    rng = np.random.default_rng(5)
    img0 = (gaussian_filter(rng.uniform(0, 255, (H, W)), 2.0) * 3 - 200).astype(np.float32)
    yy, xx = np.mgrid[0:H, 0:W]
    img1 = map_coordinates(img0, [yy - 1.3, xx + 2.2], order=1,
                           mode="nearest").astype(np.float32)
    border = [[0, 0], [W - 1, H - 1], [1, H - 2], [W - 2, 3], [0.5, 60], [100, 0.5]]
    pts = np.concatenate([rng.uniform([2, 2], [W - 3, H - 3], (42, 2)), border])
    return img0, img1, pts.astype(np.float32)


def _check_fast_twin_bit_exact_vs_xla_and_pallas():
    # Exact: only subtractions, min and max; both JAX paths agree bit for bit.
    img = _blocky(np.random.default_rng(0), 48, 120)  # one Pallas row strip
    got = tfast.fast_score_map(torch.from_numpy(img), 15.0).numpy()
    assert (got > 0).sum() > 40
    np.testing.assert_array_equal(got, np.asarray(jfast.fast_score_map(jnp.asarray(img), 15.0)))
    np.testing.assert_array_equal(
        got, np.asarray(fast_score_map_pallas(jnp.asarray(img), 15.0, True)))
    # On a CPU tensor the wrapper is the twin.
    np.testing.assert_array_equal(tfast.fast_nms(torch.from_numpy(img), 15.0).numpy(), got)


def _check_detect_grid_features_ties():
    # Exact: the same integer scores, the lower flat index wins each tie.
    rng = np.random.default_rng(1)
    score = rng.integers(0, 4, (H, W)).astype(np.float32) * 10.0
    mask = rng.uniform(size=(H, W)) > 0.2
    want = jfast.detect_grid_features(jnp.asarray(score), jnp.asarray(mask), 2, 3, 5)
    got = tfast.detect_grid_features(torch.from_numpy(score), torch.from_numpy(mask), 2, 3, 5)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())


def _check_pyramid_parity():
    # The same five weighted adds in the same order; compiled, XLA may fuse
    # them (FMA), so f32 roundoff of values up to 255: 1e-4.
    img = _blocky(np.random.default_rng(2))
    want = jax.jit(jpyr.build_pyramid, static_argnums=1)(jnp.asarray(img), 3)
    got = tpyr.build_pyramid(torch.from_numpy(img), 3)
    assert [g.shape for g in got] == [w.shape for w in want]
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4)


def _check_distortion_parity(model, coeffs):
    # f32 elementwise formulas: agreement to a few ulp of pixel values.
    intr = (458.654, 457.296, 367.215, 248.375)
    rng = np.random.default_rng(3)
    pix = rng.uniform([0, 0], [752, 480], (64, 2)).astype(np.float32)
    R = np.array([[1.0, 0.002, 0.0], [-0.002, 1.0, 0.014], [0.0, -0.014, 1.0]], np.float32)

    def run(m, pix, R):
        und = m.undistort_points(pix, intr, model, coeffs, rectification_matrix=R)
        return (und, m.distort_points(und, intr, model, coeffs),
                m.undistort_points(pix, intr, model, coeffs))

    want = jax.jit(lambda *a: run(jdist, *a))(pix, R)
    got = run(tdist, *map(torch.from_numpy, (pix, R)))
    for wnt, gt, atol in zip(want, got, (1e-6, 1e-3, 1e-6)):
        np.testing.assert_allclose(gt.numpy(), np.asarray(wnt), atol=atol)


def _check_lk_twin_matches_xla(lk_pair):
    # Same windows and taps; only reduction order differs (f32 sums over
    # 225 pixels), so positions agree far inside the reference's own
    # cross-backend bound of 2e-2 px.
    img0, img1, pts = lk_pair
    pj0, pj1 = jpyr.build_pyramid(jnp.asarray(img0), 2), jpyr.build_pyramid(jnp.asarray(img1), 2)
    g, s, e = map(np.asarray, jklt.pyramidal_lk(
        pj0, pj1, jnp.asarray(pts), jnp.asarray(pts), 15, 30, 0.01, 1e-4, "xla"))
    pt0 = tpyr.build_pyramid(torch.from_numpy(img0), 2)
    pt1 = tpyr.build_pyramid(torch.from_numpy(img1), 2)
    g2, s2, e2 = tklt.pyramidal_lk(pt0, pt1, torch.from_numpy(pts), torch.from_numpy(pts))
    assert s.sum() > 30
    assert (s == s2.numpy()).mean() >= 0.99
    both = s & s2.numpy()
    d = np.linalg.norm(g[both] - g2.numpy()[both], axis=1)
    assert np.percentile(d, 95) < 1e-3 and d.max() < 2e-2, d.max()
    np.testing.assert_allclose(e2.numpy()[both], e[both], atol=1e-3)
    # Border points hit clipped windows and zero-weight taps on both sides.
    np.testing.assert_allclose(g2.numpy()[-6:], g[-6:], atol=1e-3)


def _check_lk_verify_twin_matches_xla(lk_pair):
    img0, img1, pts = lk_pair
    pj0, pj1 = jpyr.build_pyramid(jnp.asarray(img0), 2), jpyr.build_pyramid(jnp.asarray(img1), 2)
    fwd = pts + np.array([-2.2, 1.3], np.float32)
    fj = [jklt.prepare_pyramid(p) for p in (pj1, pj0)]
    (pa, sa, _), (pb, sb, _) = jklt.lk_verify(
        fj[0], fj[1], fj[1], fj[0], jnp.asarray(fwd), jnp.asarray(pts),
        jnp.asarray(pts[:20]), jnp.asarray(fwd[:20]), 15, 30, 0.01, 1e-4, "xla")
    pt0 = tpyr.build_pyramid(torch.from_numpy(img0), 2)
    pt1 = tpyr.build_pyramid(torch.from_numpy(img1), 2)
    (qa, ta, _), (qb, tb, _) = tklt.lk_verify(
        pt1, pt0, pt0, pt1, torch.from_numpy(fwd), torch.from_numpy(pts),
        torch.from_numpy(pts[:20]), torch.from_numpy(fwd[:20]))
    for want_p, want_s, got_p, got_s in ((pa, sa, qa, ta), (pb, sb, qb, tb)):
        want_s = np.asarray(want_s)
        assert (want_s == got_s.numpy()).mean() >= 0.99
        both = want_s & got_s.numpy()
        np.testing.assert_allclose(got_p.numpy()[both], np.asarray(want_p)[both], atol=1e-3)


def _gating_like(rng, F, m, D=141, s=0.035 ** 2):
    """H P H^T + s I with a random number of active rows per system."""
    A = rng.normal(size=(D, D)) * 0.05
    P = A @ A.T
    Bs = []
    for _ in range(F):
        Hm = np.zeros((m, D))
        n = rng.integers(4, m + 1)
        Hm[:n] = rng.normal(size=(n, D)) * 0.5
        B = Hm @ P @ Hm.T + s * np.eye(m)
        Bs.append((B + B.T) / 2.0)
    return np.stack(Bs).astype(np.float32), rng.normal(size=(F, m, 4)).astype(np.float32)


def _check_spd_twin_matches_jax(F, m, atol, rtol):
    # The reference's own bounds between Gauss-Jordan and LAPACK
    # (tests/test_spd_pallas.py): 2e-3 relative at m=80; 1e-4 scaled
    # absolute and 1e-3 relative at m=8.
    Bs, Rs = _gating_like(np.random.default_rng(m), F, m)
    want = np.stack([np.asarray(jspd_solve(jnp.asarray(b), jnp.asarray(r)))
                     for b, r in zip(Bs, Rs)])
    got = tspd.spd_solve(torch.from_numpy(Bs), torch.from_numpy(Rs)).numpy()
    scale = max(np.abs(want).max(), 1.0)
    np.testing.assert_allclose(got, want, atol=atol * scale, rtol=rtol)


def _check_spd_twin_rejects_indefinite():
    # Kept divergence: Cholesky gives NaN on an indefinite B (the gate then
    # rejects the feature); Gauss-Jordan would return a finite X.
    B = torch.tensor([[[1.0, 2.0], [2.0, 1.0]]])
    assert torch.isnan(tspd.spd_solve(B, torch.ones(1, 2, 1))).all()


def test_ops_match_jax():
    _check_fast_twin_bit_exact_vs_xla_and_pallas()
    _check_detect_grid_features_ties()
    _check_pyramid_parity()
    _check_distortion_parity("radtan", (-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05))
    _check_distortion_parity("equidistant", (0.01, -0.005, 0.002, -0.001))
    lk_pair = _lk_pair()
    _check_lk_twin_matches_xla(lk_pair)
    _check_lk_verify_twin_matches_xla(lk_pair)
    _check_spd_twin_matches_jax(4, 80, 2e-3, 2e-3)
    _check_spd_twin_matches_jax(6, 8, 1e-4, 1e-3)
    _check_spd_twin_rejects_indefinite()
