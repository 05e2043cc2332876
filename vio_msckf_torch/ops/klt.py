"""Pyramidal Lucas-Kanade feature tracking, batched over features.

Port of vio_msckf_tpu/ops/klt.py with the semantics of its XLA level
(`_track_level`, backend "xla"): 15x15 window, bilinear 17x17 template with
central-difference gradients, cv2's min-eigenvalue gate, a Newton loop of
at most `iters` steps that stops at eps px, and a track lost beyond +-12 px
from the level's start. Pyramids are plain lists of (H, W) tensors; the
TPU's lane-row layout is gone, but its sampling windows are kept: the
reference samples only inside a gathered patch of the edge-padded (pad 16)
image, and a bilinear tap outside that patch gets zero weight. Both the
twin and the kernel compute the same window origins and drop the same
taps.

`track_level` is the kernel wrapper: a CUDA tensor launches
csrc/lk_level.cu (counted in `track_level.launches`), a CPU tensor runs
`track_level_plain`, the PyTorch twin.
"""

import torch

from vio_msckf_torch import kernels

_PAD = 16          # edge padding on every side, in pixels
_NY = 48           # moving window rows and columns
_MAX_MOVE = 12.0   # per-level displacement margin (px)


def _lane_blocks(W):
    """Width of the reference's padded level in 128-column blocks; its
    window origins are clipped to it."""
    return max(2, -(-(W + 2 * _PAD) // 128))


def _floor_int(x):
    return torch.floor(x).to(torch.int64)


def _windows(pts_prev, guess, H, W, win):
    """Template and moving-window origins (padded coordinates) and the
    sampling offsets, exactly as the reference's XLA level computes them."""
    Hp = H + 2 * _PAD
    nb = _lane_blocks(W)
    r = win // 2
    gwin = win + 2
    ptp = pts_prev + _PAD
    y0t = torch.clamp(_floor_int(ptp[:, 1]) - gwin // 2, 0, Hp - (gwin + 1))
    b0t = torch.clamp(
        torch.div(_floor_int(ptp[:, 0]) - gwin // 2, 128, rounding_mode="floor"),
        0, nb - 2)
    offt_x = ptp[:, 0] - (128 * b0t).to(ptp.dtype) - (r + 1)
    offt_y = ptp[:, 1] - y0t.to(ptp.dtype) - (r + 1)

    gp = guess + _PAD
    y0n = torch.clamp(_floor_int(gp[:, 1]) - (_NY // 2 - 1), 0, Hp - _NY)
    b0n = torch.clamp(
        torch.div(_floor_int(gp[:, 0]) - (_NY // 2 - 5), 128, rounding_mode="floor"),
        0, nb - 2)
    offx0 = gp[:, 0] - (128 * b0n).to(gp.dtype) - r
    nx0 = torch.clamp(_floor_int(offx0) - (_NY // 2 - 8), 0, 256 - _NY)
    return dict(y0t=y0t, x0t=128 * b0t, offt_x=offt_x, offt_y=offt_y,
                y0n=y0n, x0n=128 * b0n + nx0)


def _bilinear(imgs, sel, wy, wx, wh, ww, py, px):
    """Bilinear samples (P, n, m) at window positions py (P, n) x px (P, m)
    of the window rows [wy, wy+wh) x cols [wx, wx+ww) (padded coordinates)
    of image imgs[sel]. Taps outside the window weigh zero; the padded
    image is the unpadded one read with clamped indices (edge padding)."""
    _, H, W = imgs.shape
    flat = imgs.reshape(-1)

    def taps(pos, origin, size, limit):
        f = torch.floor(pos)
        i = f.to(torch.int64)
        w0 = 1.0 - torch.abs(pos - f)
        w1 = 1.0 - torch.abs(pos - (f + 1.0))
        v0 = (i >= 0) & (i < size)
        v1 = (i + 1 >= 0) & (i + 1 < size)
        g0 = torch.clamp(origin[:, None] + i - _PAD, 0, limit - 1)
        g1 = torch.clamp(origin[:, None] + i + 1 - _PAD, 0, limit - 1)
        return w0, w1, v0, v1, g0, g1

    wy0, wy1, vy0, vy1, r0, r1 = taps(py, wy, wh, H)
    wx0, wx1, vx0, vx1, c0, c1 = taps(px, wx, ww, W)
    base = (sel * (H * W))[:, None, None]
    zero = torch.zeros((), dtype=imgs.dtype, device=imgs.device)

    def column(c, vx):
        a = torch.where(vy0[:, :, None],
                        wy0[:, :, None] * flat[base + r0[:, :, None] * W + c[:, None, :]],
                        zero)
        b = torch.where(vy1[:, :, None],
                        wy1[:, :, None] * flat[base + r1[:, :, None] * W + c[:, None, :]],
                        zero)
        return torch.where(vx[:, None, :], a + b, zero)

    return wx0[:, None, :] * column(c0, vx0) + wx1[:, None, :] * column(c1, vx1)


def track_level_plain(prev, nxt, sel, pts_prev, guess, win, iters, eps,
                      min_eig_threshold):
    """One pyramid level for P features, in PyTorch.

    prev / nxt: (B, H, W) stacks of level images; sel (P,) int64 picks each
    feature's image. pts_prev / guess: (P, 2) at this level's scale.
    Returns (guess (P, 2), ok (P,), lost (P,), err (P,)). The Newton loop
    is masked: a converged feature stops changing, so the result is the
    reference's per-feature early exit."""
    _, H, W = prev.shape
    dt = torch.float32
    pts_prev = pts_prev.to(dt)
    g0 = guess.to(dt)
    r = win // 2
    gwin = win + 2
    o = _windows(pts_prev, g0, H, W, win)
    ar_g = torch.arange(gwin, dtype=dt, device=prev.device)
    ar_w = torch.arange(win, dtype=dt, device=prev.device)

    T = _bilinear(prev, sel, o["y0t"], o["x0t"], gwin + 1, 256,
                  o["offt_y"][:, None] + ar_g, o["offt_x"][:, None] + ar_g)
    I = T[:, 1:-1, 1:-1]
    Ix = (T[:, 1:-1, 2:] - T[:, 1:-1, :-2]) * 0.5
    Iy = (T[:, 2:, 1:-1] - T[:, :-2, 1:-1]) * 0.5
    Gxx = torch.sum(Ix * Ix, dim=(1, 2))
    Gxy = torch.sum(Ix * Iy, dim=(1, 2))
    Gyy = torch.sum(Iy * Iy, dim=(1, 2))
    det = Gxx * Gyy - Gxy * Gxy
    half_tr = 0.5 * (Gxx + Gyy)
    disc = torch.sqrt(torch.clamp(half_tr * half_tr - det, min=0.0))
    min_eig = (half_tr - disc) / (win * win)
    ok = min_eig > min_eig_threshold
    det_safe = torch.where(torch.abs(det) > 1e-12, det, torch.ones_like(det))

    base = torch.stack([o["x0n"].to(dt), o["y0n"].to(dt)], dim=1)

    def window_j(g):
        off = (g + _PAD) - base - r
        return _bilinear(nxt, sel, o["y0n"], o["x0n"], _NY, _NY,
                         off[:, 1:2] + ar_w, off[:, 0:1] + ar_w)

    g = g0
    converged = ~ok
    lost = torch.zeros_like(ok)
    for _ in range(iters):
        if not bool(torch.any(~converged)):
            break
        in_marg = torch.all(torch.abs(g - g0) <= _MAX_MOVE, dim=1)
        dI = I - window_j(g)
        bx = torch.sum(dI * Ix, dim=(1, 2))
        by = torch.sum(dI * Iy, dim=(1, 2))
        nu = torch.stack([(Gyy * bx - Gxy * by) / det_safe,
                          (Gxx * by - Gxy * bx) / det_safe], dim=-1)
        lost = lost | (~converged & ~in_marg)
        g = torch.where((~converged & in_marg)[:, None], g + nu, g)
        converged = converged | (torch.sum(nu * nu, dim=-1) < eps * eps) | ~in_marg

    err = torch.mean(torch.abs(I - window_j(g)), dim=(1, 2))
    return g, ok, lost, err


def track_level(prev_a, next_a, pts_prev, guess, win, iters, eps,
                min_eig_threshold, prev_b=None, next_b=None, img_idx=None):
    """One LK level. Features with img_idx == 1 track prev_b -> next_b,
    the rest prev_a -> next_a (lk_verify's two image pairs).

    CUDA tensors launch the kernel; CPU tensors run `track_level_plain`."""
    if prev_b is None:
        prev_b, next_b = prev_a, next_a
    if not prev_a.is_cuda:
        if img_idx is None:
            sel = torch.zeros(pts_prev.shape[0], dtype=torch.int64)
            prev, nxt = prev_a[None], next_a[None]
        else:
            sel = img_idx.to(torch.int64)
            prev, nxt = torch.stack([prev_a, prev_b]), torch.stack([next_a, next_b])
        return track_level_plain(prev, nxt, sel, pts_prev, guess, win, iters,
                                 eps, min_eig_threshold)

    H, W = prev_a.shape
    P = pts_prev.shape[0]
    if win % 2 != 1 or win > 15:
        raise ValueError(f"lk_level kernel takes an odd window <= 15, got {win}")
    for name, t in (("prev_a", prev_a), ("prev_b", prev_b),
                    ("next_a", next_a), ("next_b", next_b)):
        kernels.require(t, f"track_level {name}", torch.float32, (H, W))
    pts_prev = pts_prev.to(torch.float32).contiguous()
    guess = guess.to(torch.float32).contiguous()
    kernels.require(pts_prev, "track_level pts_prev", torch.float32, (P, 2))
    kernels.require(guess, "track_level guess", torch.float32, (P, 2))
    if img_idx is not None:
        kernels.require(img_idx, "track_level img_idx", torch.int32, (P,))
    g_out = torch.empty_like(guess)
    ok = torch.empty(P, dtype=torch.bool, device=guess.device)
    lost = torch.empty(P, dtype=torch.bool, device=guess.device)
    err = torch.empty(P, dtype=torch.float32, device=guess.device)
    if P == 0:
        return g_out, ok, lost, err
    code = kernels.lib().vio_lk_level(
        kernels.ptr(prev_a), kernels.ptr(prev_b),
        kernels.ptr(next_a), kernels.ptr(next_b),
        None if img_idx is None else kernels.ptr(img_idx),
        kernels.ptr(pts_prev), kernels.ptr(guess), kernels.ptr(g_out),
        kernels.ptr(ok), kernels.ptr(lost), kernels.ptr(err),
        P, H, W, _lane_blocks(W), win, iters, float(eps * eps),
        float(min_eig_threshold), kernels.stream_ptr(guess))
    kernels.check(code, "vio_lk_level")
    track_level.launches += 1
    return g_out, ok, lost, err


track_level.launches = 0


def _in_image(guess, H, W):
    return ((guess[:, 0] >= 0) & (guess[:, 0] <= W - 1)
            & (guess[:, 1] >= 0) & (guess[:, 1] <= H - 1))


def pyramidal_lk(pyr_prev, pyr_next, pts_prev, pts_init, win=15, iters=30,
                 eps=0.01, min_eig_threshold=1e-4):
    """Track pts_prev (P, 2) from pyramid pyr_prev into pyr_next, from the
    initial guesses pts_init (full-resolution pixels).

    Returns (pts_next (P, 2), status (P,), err (P,)). Status fails when the
    point leaves the image, drifts past the margin at any level, or the
    finest level's gradient matrix is degenerate (cv2's semantics)."""
    levels = len(pyr_prev) - 1
    guess = pts_init / (2.0 ** levels)
    status = torch.ones(pts_prev.shape[0], dtype=torch.bool, device=pts_prev.device)
    err = torch.zeros(pts_prev.shape[0], dtype=torch.float32, device=pts_prev.device)
    for lvl in range(levels, -1, -1):
        H, W = pyr_prev[lvl].shape
        # Levels too small for the window plus a margin are skipped, as cv2
        # caps maxLevel by image size.
        if min(H, W) >= win + 8:
            guess, ok, lost, err = track_level(
                pyr_prev[lvl], pyr_next[lvl], pts_prev / (2.0 ** lvl), guess,
                win, iters, eps, min_eig_threshold)
            status = status & ~lost
            if lvl == 0:
                status = status & ok
        if lvl != 0:
            guess = guess * 2.0
    H, W = pyr_next[0].shape
    return guess, status & _in_image(guess, H, W), err


def lk_verify(pyr_prev_a, pyr_next_a, pyr_prev_b, pyr_next_b,
              pts_a, init_a, pts_b, init_b, win=15, iters=30, eps=0.01,
              min_eig_threshold=1e-4):
    """One finest-level LK pass over two image pairs at once (the
    backward-consistency checks both start at converged solutions, so the
    coarse levels add nothing). The kernel takes both pairs' image
    pointers and a per-point pair index.

    Returns ((pts (Pa, 2), status, err), (pts (Pb, 2), status, err))."""
    H, W = pyr_prev_a[0].shape
    Pa = pts_a.shape[0]
    pts = torch.cat([pts_a, pts_b], dim=0)
    init = torch.cat([init_a, init_b], dim=0)
    img_idx = torch.cat([
        torch.zeros(Pa, dtype=torch.int32, device=pts.device),
        torch.ones(pts_b.shape[0], dtype=torch.int32, device=pts.device)])
    guess, ok, lost, err = track_level(
        pyr_prev_a[0], pyr_next_a[0], pts, init, win, iters, eps,
        min_eig_threshold, prev_b=pyr_prev_b[0], next_b=pyr_next_b[0],
        img_idx=img_idx)
    status = ok & ~lost & _in_image(guess, H, W)
    return ((guess[:Pa], status[:Pa], err[:Pa]),
            (guess[Pa:], status[Pa:], err[Pa:]))
