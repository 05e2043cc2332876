"""Oriented-FAST + steered-BRIEF descriptors and a Hamming matcher. Port of
vio_msckf_tpu/ops/orb.py.

It replaces the reference ESKF front-end's cv2.ORB_create /
BFMatcher(NORM_HAMMING, crossCheck=True) (ESKF/stereo.py:269-284,
326-330):

  * keypoints come from the FAST-9 score map (ops/fast.py:fast_nms, the
    hand kernel on a CUDA tensor) and the grid top-k: a fixed count K per
    image, with a mask for empty slots;
  * orientation is the ORB intensity centroid over a circular patch of
    each keypoint's 33x33 patch, gathered with one index gather;
  * the descriptor is steered BRIEF-256: a fixed Gaussian test pattern
    (seeded as in the JAX package), rotated by the keypoint angle and
    sampled bilinearly from the blurred patch;
  * Hamming distance between bit vectors a, b is (256 - s_a . s_b) / 2
    with s = 1 - 2 * bits in {-1, +1}, so the K x K distance matrix is one
    matrix product; cross-check is the mutual argmin (first index on
    ties, as torch.argmin and jnp.argmin both return).

Images come as (B, H, W) stacks (the ESKF passes its two rectified views
as B = 2): every function keeps the leading axis.
"""

import functools

import numpy as np
import torch

from benchmark.reference.ops.fast import detect_grid_features, fast_nms
from benchmark.reference.ops.pyramid import _blur_axis

PATCH = 33          # gathered patch edge (center +/- 16)
_R = PATCH // 2
N_BITS = 256

# Fixed BRIEF test pattern: 256 coordinate pairs ~ N(0, (patch/5)^2),
# clipped so bilinear sampling after any rotation stays inside the patch.
_rng = np.random.RandomState(20260818)
_PAIRS = np.clip(_rng.normal(0.0, PATCH / 5.0, (N_BITS, 4)), -_R + 2, _R - 2)

# Circular mask for the intensity centroid (ORB uses radius ~15).
_yy, _xx = np.mgrid[-_R:_R + 1, -_R:_R + 1]
_CIRC = ((_xx ** 2 + _yy ** 2) <= (_R - 1) ** 2).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _consts(device):
    """The circular mask, the patch's x and y offsets and the BRIEF pairs
    as f32 tensors on `device`, copied from the host once per device: a
    host-to-device copy inside a step would synchronise it."""
    return tuple(torch.as_tensor(a, dtype=torch.float32, device=device)
                 for a in (_CIRC, _xx, _yy, _PAIRS))


def _gather_patches(img, xy):
    """(B, K, PATCH, PATCH) patches of images (B, H, W), centered on the
    integer-rounded keypoints xy (B, K, 2); zeros beyond the image."""
    B, H, W = img.shape
    pad = _R + 1
    padded = torch.nn.functional.pad(img, (pad, pad, pad, pad))
    ij = torch.round(xy).to(torch.int64)
    off = torch.arange(PATCH, device=img.device)
    rows = (ij[..., 1] + pad - _R)[..., None] + off        # (B, K, PATCH)
    cols = (ij[..., 0] + pad - _R)[..., None] + off
    bi = torch.arange(B, device=img.device)[:, None, None, None]
    return padded[bi, rows[..., :, None], cols[..., None, :]]


def _patch_sum(x):
    """Sum of each (PATCH, PATCH) patch of x (..., PATCH, PATCH) in the JAX
    package's order on the CPU: XLA splits the patch at row and column 17
    into four blocks, sums each block in row-major order and adds the
    blocks as (b00 + b01) + (b10 + b11). The moments then round as the
    reference's do, which keeps the angles (and with them the descriptor
    bits) equal to the reference's: another f32 order moves an angle by
    ~1e-5 rad, and a sample point by ~3e-4 px. One add per block element
    (289 launches) for the whole stack."""
    h = PATCH // 2 + 1
    blocks = torch.nn.functional.pad(x, (0, 2 * h - PATCH, 0, 2 * h - PATCH))
    blocks = blocks.unflatten(-2, (2, h)).unflatten(-1, (2, h))      # (..., 2, h, 2, h)
    blocks = blocks.movedim(-3, -2).flatten(-2)                       # (..., 2, 2, h*h)
    acc = blocks[..., 0]
    for i in range(1, h * h):
        acc = acc + blocks[..., i]
    return (acc[..., 0, 0] + acc[..., 0, 1]) + (acc[..., 1, 0] + acc[..., 1, 1])


def _orientations(patches):
    """ORB intensity-centroid angle per patch: atan2(m01, m10)."""
    circ, xx, yy, _ = _consts(patches.device)
    w = patches * circ
    m = _patch_sum(torch.stack([w * xx, w * yy]))
    return torch.atan2(m[1], m[0])


def _bilinear_patch(patches, x, y):
    """Sample patches (..., PATCH, PATCH) at continuous offsets x, y
    (..., N) from their centers."""
    px = x + _R
    py = y + _R
    x0 = torch.clamp(torch.floor(px).to(torch.int64), 0, PATCH - 2)
    y0 = torch.clamp(torch.floor(py).to(torch.int64), 0, PATCH - 2)
    fx = px - x0
    fy = py - y0
    flat = patches.flatten(-2)

    def at(yi, xi):
        return torch.gather(flat, -1, yi * PATCH + xi)

    v00 = at(y0, x0)
    v01 = at(y0, x0 + 1)
    v10 = at(y0 + 1, x0)
    v11 = at(y0 + 1, x0 + 1)
    return (v00 * (1 - fx) * (1 - fy) + v01 * fx * (1 - fy)
            + v10 * (1 - fx) * fy + v11 * fx * fy)


def describe(img, xy, valid):
    """Steered BRIEF-256 for K keypoints of each image.

    img: (B, H, W) float; xy: (B, K, 2) pixel coords; valid: (B, K) bool.
    Returns (bits (B, K, 256) bool, angle (B, K))."""
    # BRIEF compares on a smoothed image (reference: ORB's internal blur).
    img = _blur_axis(_blur_axis(img.to(torch.float32), 0), 1)
    patches = _gather_patches(img, xy)
    angles = _orientations(patches)

    pairs = _consts(img.device)[3]  # (256, 4) = x1 y1 x2 y2
    c, s = torch.cos(angles)[..., None], torch.sin(angles)[..., None]
    x1 = c * pairs[:, 0] - s * pairs[:, 1]
    y1 = s * pairs[:, 0] + c * pairs[:, 1]
    x2 = c * pairs[:, 2] - s * pairs[:, 3]
    y2 = s * pairs[:, 2] + c * pairs[:, 3]
    i1 = _bilinear_patch(patches, x1, y1)
    i2 = _bilinear_patch(patches, x2, y2)
    bits = (i1 < i2) & valid[..., None]
    return bits, angles


def hamming_matrix(bits_a, bits_b):
    """(..., Ka, Kb) Hamming distances as one matrix product."""
    sa = 1.0 - 2.0 * bits_a.to(torch.float32)
    sb = 1.0 - 2.0 * bits_b.to(torch.float32)
    return (N_BITS - sa @ sb.transpose(-1, -2)) * 0.5


def match_crosscheck(bits_a, valid_a, bits_b, valid_b, max_distance=80.0):
    """Mutual-nearest-neighbour Hamming matching (BFMatcher crossCheck).

    bits (Ka, 256) / (Kb, 256), valid (Ka,) / (Kb,). Returns (idx_b (Ka,)
    int64, dist (Ka,), matched (Ka,) bool): for each valid a, its mutual
    best b within max_distance."""
    D = hamming_matrix(bits_a, bits_b)
    big = torch.full((), 1e9, dtype=D.dtype, device=D.device)
    D = torch.where(valid_a[:, None] & valid_b[None, :], D, big)
    best_b = torch.argmin(D, dim=1)                 # (Ka,)
    best_a = torch.argmin(D, dim=0)                 # (Kb,)
    dist = torch.amin(D, dim=1)
    mutual = best_a[best_b] == torch.arange(D.shape[0], device=D.device)
    matched = mutual & (dist <= max_distance) & valid_a
    return best_b, dist, matched


def detect_and_describe(img, threshold, grid_row, grid_col, per_cell):
    """FAST keypoints (grid top-k) + steered BRIEF descriptors of each image
    of a (B, H, W) stack, in one FAST launch.

    Returns (xy (B, K, 2), resp (B, K), bits (B, K, 256), angle (B, K),
    valid (B, K)) with K = grid_row * grid_col * per_cell (fixed)."""
    img = img.to(torch.float32).contiguous()
    score = fast_nms(img, threshold)
    # Keep descriptors' support inside the frame.
    B, H, W = img.shape
    row = torch.arange(H, device=img.device)[:, None]
    col = torch.arange(W, device=img.device)[None, :]
    interior = (row >= _R) & (row < H - _R) & (col >= _R) & (col < W - _R)
    xy, resp, valid = detect_grid_features(score, interior.expand(B, H, W), grid_row,
                                           grid_col, per_cell)
    xy = xy.reshape(B, -1, 2)
    resp = resp.reshape(B, -1)
    valid = valid.reshape(B, -1)
    bits, angle = describe(img, xy, valid)
    return xy, resp, bits, angle, valid
