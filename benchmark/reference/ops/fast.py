"""FAST-9 corner detection + grid-bucketed selection.

Port of vio_msckf_tpu/ops/fast.py and ops/fast_pallas.py. `fast_score_map`
is the plain PyTorch version; `fast_nms`, which the tracker calls, runs it
(the port's kernel computes the same map bit for bit). Images come as
(B, H, W) stacks, one per sequence.
"""

import torch


# Bresenham circle of radius 3: (row, col) offsets, clockwise from 12 o'clock.
_CIRCLE = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)
_BORDER = 3


def fast_score_map(img, threshold):
    """FAST-9 response with 3x3 non-max suppression: (..., H, W) -> the
    same shape, 0 where not a corner. The score is the max over the 16
    cyclic 9-arcs of the arc minimum of the circle differences, for both
    polarities."""
    img = img.to(torch.float32)
    H, W = img.shape[-2:]
    dims = (-2, -1)
    diffs = torch.stack(
        [torch.roll(img, (-dy, -dx), dims=dims) - img for dy, dx in _CIRCLE]
    )  # (16, ..., H, W)

    def arc_score(d):
        m3 = torch.minimum(
            torch.minimum(d, torch.roll(d, -1, dims=0)), torch.roll(d, -2, dims=0)
        )
        m9 = torch.minimum(
            torch.minimum(m3, torch.roll(m3, -3, dims=0)), torch.roll(m3, -6, dims=0)
        )
        return m9.amax(dim=0)

    score = torch.maximum(arc_score(diffs), arc_score(-diffs))
    corner = score > threshold
    zero = torch.zeros((), dtype=score.dtype, device=score.device)
    score = torch.where(corner, score, zero)

    row = torch.arange(H, device=img.device)[:, None]
    col = torch.arange(W, device=img.device)[None, :]
    inside = (
        (row >= _BORDER) & (row < H - _BORDER)
        & (col >= _BORDER) & (col < W - _BORDER)
    )
    score = torch.where(inside, score, zero)

    neigh = torch.stack([
        torch.roll(score, (dy, dx), dims=dims)
        for dy in (-1, 0, 1)
        for dx in (-1, 0, 1)
        if not (dy == 0 and dx == 0)
    ]).amax(dim=0)
    return torch.where((score >= neigh) & corner & inside, score, zero)


def fast_candidates(img, threshold):
    """Pixels that pass FAST-9's compass test: (..., H, W) -> bool of the
    same shape.

    Every 9-arc of the 16-point circle holds two neighbouring compass
    points k and k+4 (k in 0, 4, 8, 12), so a pixel can score above
    `threshold` only where such a pair is both brighter or both darker
    than the centre by more than `threshold`. Everywhere else
    fast_score_map is 0, which is what lets csrc/fast_nms.cu skip the full
    score. The main path does not call this: the tests hold the rule with
    it, and chip_smoke.py counts the candidates it times."""
    img = img.to(torch.float32)
    d = [torch.roll(img, (-dy, -dx), dims=(-2, -1)) - img
         for dy, dx in _CIRCLE[::4]]
    hit = torch.zeros(img.shape, dtype=torch.bool, device=img.device)
    for k in range(4):
        a, b = d[k], d[(k + 1) % 4]
        hit |= ((a > threshold) & (b > threshold)) | ((a < -threshold) & (b < -threshold))
    return hit


def fast_nms(img, threshold):
    """FAST-9 score + NMS maps of a (B, H, W) stack: `fast_score_map` on
    any device (the port's kernel computes the same map bit for bit)."""
    return fast_score_map(img, threshold)


def detect_grid_features(score, mask, grid_row, grid_col, per_cell):
    """Top-`per_cell` responses per grid cell, per sequence.

    score: (B, H, W) FAST maps; mask: (B, H, W) bool, False suppresses.
    Cell geometry: cell_h = ceil(H/grid_row), cell_w = ceil(W/grid_col).
    Ties keep the lower flat index, like the reference's iterative argmax:
    a stable descending sort, since FAST scores are integer-valued and tie
    often. Returns (xy (B, G, per_cell, 2) f32, resp (B, G, per_cell),
    valid).
    """
    B, H, W = score.shape
    cell_h = -(-H // grid_row)
    cell_w = -(-W // grid_col)
    score = torch.where(mask, score, torch.zeros_like(score))
    padded = score.new_zeros((B, grid_row * cell_h, grid_col * cell_w))
    padded[:, :H, :W] = score
    cells = padded.reshape(B, grid_row, cell_h, grid_col, cell_w)
    cells = cells.permute(0, 1, 3, 2, 4).reshape(B, grid_row * grid_col, cell_h * cell_w)
    resp, idx = torch.sort(cells, dim=-1, descending=True, stable=True)
    resp, idx = resp[..., :per_cell], idx[..., :per_cell]
    iy = idx // cell_w
    ix = idx % cell_w
    gr = torch.arange(grid_row * grid_col, device=score.device)
    base_y = (gr // grid_col) * cell_h
    base_x = (gr % grid_col) * cell_w
    x = (base_x[:, None] + ix).to(torch.float32)
    y = (base_y[:, None] + iy).to(torch.float32)
    return torch.stack([x, y], dim=-1), resp, resp > 0.0
