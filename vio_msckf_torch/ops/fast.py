"""FAST-9 corner detection + grid-bucketed selection.

Port of vio_msckf_tpu/ops/fast.py and ops/fast_pallas.py. `fast_score_map`
is the plain PyTorch version (the twin); `fast_nms` is the kernel wrapper
the tracker calls: on a CUDA tensor it launches csrc/fast_nms.cu, on a CPU
tensor it runs the twin. Both give bit-identical maps.
"""

import torch

from vio_msckf_torch import kernels

# Bresenham circle of radius 3: (row, col) offsets, clockwise from 12 o'clock.
_CIRCLE = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)
_BORDER = 3


def fast_score_map(img, threshold):
    """FAST-9 response with 3x3 non-max suppression: (H, W) -> (H, W),
    0 where not a corner. The score is the max over the 16 cyclic 9-arcs
    of the arc minimum of the circle differences, for both polarities."""
    img = img.to(torch.float32)
    H, W = img.shape
    diffs = torch.stack(
        [torch.roll(img, (-dy, -dx), dims=(0, 1)) - img for dy, dx in _CIRCLE]
    )  # (16, H, W)

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
        torch.roll(score, (dy, dx), dims=(0, 1))
        for dy in (-1, 0, 1)
        for dx in (-1, 0, 1)
        if not (dy == 0 and dx == 0)
    ]).amax(dim=0)
    return torch.where((score >= neigh) & corner & inside, score, zero)


def fast_nms(img, threshold):
    """FAST-9 score + NMS map of one (H, W) f32 image.

    CUDA tensor: the hand kernel (csrc/fast_nms.cu), counted in
    `fast_nms.launches`. CPU tensor: `fast_score_map`."""
    if not img.is_cuda:
        return fast_score_map(img, threshold)
    kernels.require(img, "fast_nms img", torch.float32)
    if img.dim() != 2:
        raise ValueError(f"fast_nms: expected (H, W), got {tuple(img.shape)}")
    H, W = img.shape
    out = torch.empty_like(img)
    code = kernels.lib().vio_fast_nms(
        kernels.ptr(img), kernels.ptr(out), H, W, float(threshold),
        kernels.stream_ptr(img))
    kernels.check(code, "vio_fast_nms")
    fast_nms.launches += 1
    return out


fast_nms.launches = 0


def detect_grid_features(score, mask, grid_row, grid_col, per_cell):
    """Top-`per_cell` responses per grid cell.

    score: (H, W) FAST map; mask: (H, W) bool, False suppresses. Cell
    geometry: cell_h = ceil(H/grid_row), cell_w = ceil(W/grid_col).
    Ties keep the lower flat index, like the reference's iterative argmax:
    a stable descending sort, since FAST scores are integer-valued and tie
    often. Returns (xy (G, per_cell, 2) f32, resp (G, per_cell), valid).
    """
    H, W = score.shape
    cell_h = -(-H // grid_row)
    cell_w = -(-W // grid_col)
    score = torch.where(mask, score, torch.zeros_like(score))
    padded = score.new_zeros((grid_row * cell_h, grid_col * cell_w))
    padded[:H, :W] = score
    cells = padded.reshape(grid_row, cell_h, grid_col, cell_w)
    cells = cells.permute(0, 2, 1, 3).reshape(grid_row * grid_col, cell_h * cell_w)
    resp, idx = torch.sort(cells, dim=1, descending=True, stable=True)
    resp, idx = resp[:, :per_cell], idx[:, :per_cell]
    iy = idx // cell_w
    ix = idx % cell_w
    gr = torch.arange(grid_row * grid_col, device=score.device)
    base_y = (gr // grid_col) * cell_h
    base_x = (gr % grid_col) * cell_w
    x = (base_x[:, None] + ix).to(torch.float32)
    y = (base_y[:, None] + iy).to(torch.float32)
    return torch.stack([x, y], dim=-1), resp, resp > 0.0
