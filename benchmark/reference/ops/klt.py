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

Pyramid levels are (B, H_l, W_l) stacks, one image per sequence, and
points come as (B, P, 2): feature p of sequence b reads plane b only.
`track_pyramid` runs `track_pyramid_plain`, the PyTorch twin of the port's
kernel, which walks the levels with `track_level_plain`. `pyramidal_lk`
and `lk_verify` are both one `track_pyramid` call.
"""

import torch


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
    Returns (guess (P, 2), ok (P,), lost (P,), err (P,), n_iter (P,) int32:
    the Newton iterations each feature ran). The Newton loop is masked: a
    converged feature stops changing, so the result is the reference's
    per-feature early exit."""
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
    n_iter = torch.zeros(ok.shape, dtype=torch.int32, device=ok.device)
    # Every iteration runs (no early exit on the host): a converged feature
    # no longer changes, so the result is the same, and the step makes no
    # host synchronisation.
    for _ in range(iters):
        in_marg = torch.all(torch.abs(g - g0) <= _MAX_MOVE, dim=1)
        dI = I - window_j(g)
        bx = torch.sum(dI * Ix, dim=(1, 2))
        by = torch.sum(dI * Iy, dim=(1, 2))
        nu = torch.stack([(Gyy * bx - Gxy * by) / det_safe,
                          (Gxx * by - Gxy * bx) / det_safe], dim=-1)
        n_iter = n_iter + (~converged).to(torch.int32)
        lost = lost | (~converged & ~in_marg)
        g = torch.where((~converged & in_marg)[:, None], g + nu, g)
        converged = converged | (torch.sum(nu * nu, dim=-1) < eps * eps) | ~in_marg

    err = torch.mean(torch.abs(I - window_j(g)), dim=(1, 2))
    return g, ok, lost, err, n_iter


def _flat_lanes(B, P, n_first, dev):
    """Per flat feature lane (B * P of them): its sequence, and its image
    pair (0, or 1 from index n_first on within its sequence)."""
    seq = torch.arange(B, device=dev).repeat_interleave(P)
    if n_first is None:
        return seq, torch.zeros_like(seq)
    return seq, (torch.arange(P, device=dev) >= n_first).to(torch.int64).repeat(B)


def track_pyramid_plain(pyr_prev, pyr_next, pts_prev, pts_init, win, iters, eps,
                        min_eig_threshold, pyr_prev_b=None, pyr_next_b=None,
                        n_first=None, min_size=None):
    """The pyramid walk in PyTorch, level by level with `track_level_plain`.

    Levels are (B, H, W) stacks, points (B, P, 2); sequence b's features
    read plane b. Within each sequence, features [0, n_first) track
    pyr_prev -> pyr_next, the rest pyr_prev_b -> pyr_next_b (all of them
    track pair A when n_first is None). Levels whose min(H, W) < min_size
    (default win + 8) are skipped, as cv2 caps maxLevel by image size.
    Returns (pts (B, P, 2), status (B, P), err (B, P), n_iter (B, P) int32:
    Newton iterations summed over the levels)."""
    B, P = pts_prev.shape[:2]
    dev = pts_prev.device
    if min_size is None:
        min_size = win + 8
    seq, pair = _flat_lanes(B, P, n_first, dev)
    sel = seq + B * pair
    flat_prev = pts_prev.reshape(B * P, 2)
    levels = len(pyr_prev) - 1
    guess = pts_init.reshape(B * P, 2) / (2.0 ** levels)
    status = torch.ones(B * P, dtype=torch.bool, device=dev)
    err = torch.zeros(B * P, dtype=torch.float32, device=dev)
    n_iter = torch.zeros(B * P, dtype=torch.int32, device=dev)
    for lvl in range(levels, -1, -1):
        H, W = pyr_prev[lvl].shape[-2:]
        if min(H, W) >= min_size:
            prev, nxt = pyr_prev[lvl], pyr_next[lvl]
            if n_first is not None:
                prev = torch.cat([prev, pyr_prev_b[lvl]])
                nxt = torch.cat([nxt, pyr_next_b[lvl]])
            guess, ok, lost, err, n = track_level_plain(
                prev, nxt, sel, flat_prev / (2.0 ** lvl), guess, win, iters, eps,
                min_eig_threshold)
            n_iter = n_iter + n
            status = status & ~lost
            if lvl == 0:
                status = status & ok
        if lvl != 0:
            guess = guess * 2.0
    H, W = pyr_next[0].shape[-2:]
    status = status & _in_image(guess, H, W)
    return (guess.reshape(B, P, 2), status.reshape(B, P), err.reshape(B, P),
            n_iter.reshape(B, P))


def track_pyramid(pyr_prev, pyr_next, pts_prev, pts_init, win, iters, eps,
                  min_eig_threshold, pyr_prev_b=None, pyr_next_b=None,
                  n_first=None, min_size=None):
    """`track_pyramid_plain` on any device (the port launches its kernel
    here on CUDA tensors)."""
    return track_pyramid_plain(pyr_prev, pyr_next, pts_prev, pts_init, win, iters,
                               eps, min_eig_threshold, pyr_prev_b, pyr_next_b,
                               n_first, min_size)


def _in_image(guess, H, W):
    return ((guess[..., 0] >= 0) & (guess[..., 0] <= W - 1)
            & (guess[..., 1] >= 0) & (guess[..., 1] <= H - 1))


def pyramidal_lk(pyr_prev, pyr_next, pts_prev, pts_init, win=15, iters=30,
                 eps=0.01, min_eig_threshold=1e-4):
    """Track pts_prev (B, P, 2) from pyramid pyr_prev into pyr_next (levels
    (B, H_l, W_l)), from the initial guesses pts_init (full-resolution
    pixels).

    Returns (pts_next (B, P, 2), status (B, P), err (B, P)). Status fails when the
    point leaves the image, drifts past the margin at any level, or the
    finest level's gradient matrix is degenerate (cv2's semantics)."""
    return track_pyramid(pyr_prev, pyr_next, pts_prev, pts_init, win, iters, eps,
                         min_eig_threshold)[:3]


def lk_verify(pyr_prev_a, pyr_next_a, pyr_prev_b, pyr_next_b,
              pts_a, init_a, pts_b, init_b, win=15, iters=30, eps=0.01,
              min_eig_threshold=1e-4):
    """One finest-level LK pass over two image pairs at once (the
    backward-consistency checks both start at converged solutions, so the
    coarse levels add nothing): one `track_pyramid` call over both pairs
    of every sequence, each sequence's points of pair A first.

    Returns ((pts (B, Pa, 2), status, err), (pts (B, Pb, 2), status, err))."""
    Pa = pts_a.shape[1]
    guess, status, err, _ = track_pyramid(
        pyr_prev_a[:1], pyr_next_a[:1], torch.cat([pts_a, pts_b], dim=1),
        torch.cat([init_a, init_b], dim=1), win, iters, eps, min_eig_threshold,
        pyr_prev_b=pyr_prev_b[:1], pyr_next_b=pyr_next_b[:1], n_first=Pa, min_size=0)
    return ((guess[:, :Pa], status[:, :Pa], err[:, :Pa]),
            (guess[:, Pa:], status[:, Pa:], err[:, Pa:]))
