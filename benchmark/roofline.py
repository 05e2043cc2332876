"""The least time each hand kernel of the port could take at a call shape:
the larger of the bytes it must move (each input read once, each output
written once) at the card's memory bandwidth and the f32 operations its
inputs need at the card's f32 rate. The arithmetic is chip_smoke.py's
(FAST_OPS_PER_PX, LK_OPS_PER_LEVEL, its byte counts), the call shapes
those of vio_msckf_torch.tools.batch_sweep.call_shapes, so it counts the
same work whatever implements the kernel.

Operations that depend on the data are left out: LK's Newton iterations
and the SPD solve's active pivots. Both kernels are bound by bytes at
every shape chip_smoke.py timed, so the bound is theirs; where operations
would bind, the share read is a lower bound, never above the truth.
"""

# NVIDIA H100 SXM (data sheet, dense, at the 700 W limit).
PEAKS = {
    "NVIDIA H100": dict(hbm_bytes_per_s=3.35e12, f32_ops_per_s=67e12),
}
F32 = 4

# FAST-9 + NMS per pixel: 16 circle differences; per polarity 16 three-tap
# minima (32), 16 arc minima (32) and 15 maxima; the polarity max, the
# threshold test, 8 NMS maxima and the final test.
FAST_OPS_PER_PX = 16 + 2 * (32 + 32 + 15) + 1 + 1 + 8 + 1
# LK per level and feature: the 17x17 bilinear template (9 each), the
# gradients, the 2x2 normal matrix and the final mean |I - J| over the
# 15x15 window (the Newton iterations are not counted: module docstring).
LK_OPS_PER_LEVEL = 17 * 17 * 9 + 225 * (4 + 6 + 12) + 20
# The hand kernels' device function names (csrc/*.cu), by launch counter.
KERNEL_NAMES = {"fast_nms": ("fast_nms_kernel",), "lk_pyramid": ("lk_pyramid_kernel",),
                "spd_gj": ("gj_block", "gj_warp")}


def peaks(device_name):
    for k, v in PEAKS.items():
        if device_name.startswith(k):
            return v
    raise KeyError(f"no published peaks for {device_name!r} in benchmark/roofline.py")


def pyramid_levels(H, W, levels):
    """(H, W) of each level of a `levels`-deep pyramid (ops/pyramid.py
    halves each side, rounding down)."""
    out = [(H, W)]
    for _ in range(levels):
        H, W = H // 2, W // 2
        out.append((H, W))
    return out


def fast_nms(key, vio):
    """(bytes, operations) of one FAST launch, key (B, H, W, threshold)."""
    B, H, W, _ = key
    px = B * H * W
    return 2 * px * F32, px * FAST_OPS_PER_PX


def lk_pyramid(key, vio):
    """(bytes, operations) of one LK pyramid walk, key (B, P, n_first):
    n_first == P tracks one image pair through every level at least
    win + 8 on its short side; n_first < P is the verify call, level 0 of
    two pairs that share their second image (three images)."""
    B, P, n_first = key
    fe = vio["frontend"]
    W, H = vio["cam0"]["resolution"]
    win = fe["lk_patch_size"]
    levels = pyramid_levels(H, W, fe["lk_pyramid_levels"])
    if n_first == P:
        used = [(h, w) for h, w in levels if min(h, w) >= win + 8]
        images = 2 * sum(h * w for h, w in used)
        n_lv = len(used)
    else:
        images = 3 * H * W
        n_lv = 1
    nbytes = B * images * F32 + 2 * B * P * 2 * F32 + B * P * (8 + 1 + 4)
    return nbytes, B * P * n_lv * LK_OPS_PER_LEVEL


def spd_gj(key, vio):
    """(bytes, operations) of one SPD solve launch, key (F, m, k): the
    systems and right-hand sides read, the solutions written."""
    F, m, k = key
    return F * (m * m + 2 * m * k) * F32, 0


COUNTS = {"fast_nms": fast_nms, "lk_pyramid": lk_pyramid, "spd_gj": spd_gj}


def least_seconds(launches, vio, device_name):
    """Least seconds of the launches {kernel: {call shape key: count}}."""
    pk = peaks(device_name)
    total = 0.0
    for kernel, shapes in launches.items():
        for key, count in shapes.items():
            nbytes, ops = COUNTS[kernel](tuple(key), vio)
            total += count * max(nbytes / pk["hbm_bytes_per_s"], ops / pk["f32_ops_per_s"])
    return total
