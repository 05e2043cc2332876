"""Gaussian image pyramid for pyramidal LK: the 5-tap [1 4 6 4 1]/16
binomial blur with edge padding, then 2x decimation (what cv2.pyrDown
does). Port of vio_msckf_tpu/ops/pyramid.py.

The blur is five weighted shifted adds in the reference's order, not a
convolution: no cuDNN, so no TF32, and the same rounding as the JAX sums.
"""

import torch
import torch.nn.functional as F

_KERNEL = tuple(v / 16.0 for v in (1.0, 4.0, 6.0, 4.0, 1.0))


def _blur_axis(img, axis):
    """Blur (B, H, W) images along axis 0 (rows) or 1 (columns) of each."""
    B, H, W = img.shape
    pad = (0, 0, 2, 2) if axis == 0 else (2, 2, 0, 0)
    x = F.pad(img[:, None], pad, mode="replicate")[:, 0]
    out = torch.zeros_like(img)
    for i, k in enumerate(_KERNEL):
        out = out + k * (x[:, i:i + H] if axis == 0 else x[:, :, i:i + W])
    return out


def pyr_down(img):
    """One pyramid level of (B, H, W) images: blur, then keep every second
    row and column (an odd trailing row or column is dropped first)."""
    blurred = _blur_axis(_blur_axis(img, 0), 1)
    _, H, W = blurred.shape
    return blurred[:, : H - H % 2: 2, : W - W % 2: 2]


def build_pyramid(img, levels):
    """`levels + 1` contiguous f32 (B, H_l, W_l) stacks of B images, level 0
    the full resolution."""
    pyr = [img.to(torch.float32).contiguous()]
    for _ in range(levels):
        pyr.append(pyr_down(pyr[-1]).contiguous())
    return pyr
