"""Smoke run of the PyTorch port on one CUDA GPU.

    python3 chip_smoke.py

Phases, one line each; any failure raises and exits nonzero:
  1. device   - requires CUDA (no CPU fallback); prints the card's name and
                power limit as nvidia-smi reports them.
  2. build    - compiles the hand-written kernels (vio_msckf_torch/csrc)
                from source with nvcc and loads them.
  3. workload - simulates and renders the bench workload (12 s, 752x480
                stereo, ~220 frames) on the card with the port's renderer.
  4. kernels  - each kernel against its plain PyTorch twin at the shapes
                the main path gives it, with the stated tolerance; the
                device time of the kernel, its twin and (where one exists)
                the one PyTorch call that computes the same function; the
                roofline bound of the same work.
  5. slice    - VIOEngine over every frame at the full EuRoC config: ATE
                and RPE against ground truth (fails above the bench's
                0.5 m bound), launch counts of each kernel in that run
                (each must be > 0), host syncs in one warm step, and
                frames/s over a second pass.
The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.

Kernel times (`device_ms`): a spin kernel holds the stream while the host
enqueues n calls back to back between two CUDA events, so the events see
the device's time for the n calls and not the host's Python between them;
the time is divided by n, and the median of a few such runs is kept. Each
kernel entry reports per-frame sums over the calls the main path makes
(one line per call shape under "calls"). `bound_ms` is the larger of the
bytes the function must move (inputs read once, outputs written once) at
3.35 TB/s and the f32 operations these inputs need at 67 TFLOP/s (H100
SXM data sheet).
"""

import json
import math
import subprocess
import time
import warnings

import numpy as np

# The bench workload (bench.py:build_workload) and its bound.
SIM = dict(duration=12.0, seed=4, amp=(1.5, 1.0, 0.5), yaw_rate=0.2, wobble_amp=0.1)
RENDER = dict(radius=14.0, seed=7)
ATE_BOUND_M = 0.5

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
F32_OPS_PER_S = 67e12         # H100 SXM f32 outside the tensor cores


def log(msg):
    print(msg, flush=True)


def device_ms(fn, n, runs=5, warmup=2, sync_free=True):
    """Device ms of one fn() call: n calls between two CUDA events, divided
    by n; the median of `runs` runs.

    For a sync-free fn a spin kernel first holds the stream for about twice
    the host's enqueue time of n calls, so all n are queued before the
    first starts and the device runs them back to back. A fn that
    synchronises (sync_free=False) cannot be queued ahead: its time is the
    wall time between the events, host included."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    hold_cycles = int(min(2.0 * host_s, 2.0) * 2.0e9) + 2_000_000
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if sync_free:
            torch.cuda._sleep(hold_cycles)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / n)
    return float(np.median(times))


def bound(nbytes, ops):
    """Roofline bound (ms, "bytes" | "operations") of one call."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors):
    """Bytes of the distinct tensors given (one read or write each)."""
    seen = {}
    for t in tensors:
        seen[(t.data_ptr(), t.numel())] = t.numel() * t.element_size()
    return sum(seen.values())


def summed(calls):
    """Per-frame totals over the call shapes of one kernel."""
    tot = lambda k: sum(c[k] * c["per_frame"] for c in calls)  # noqa: E731
    libs = [c["library_ms"] for c in calls]
    b_ops = sum(c["ops"] * c["per_frame"] for c in calls)
    b_bytes = sum(c["bytes"] * c["per_frame"] for c in calls)
    bound_ms, bound_by = bound(b_bytes, b_ops)
    return dict(ms=tot("ms"), plain_ms=tot("plain_ms"),
                library_ms=None if None in libs else tot("library_ms"),
                bound_ms=bound_ms, bound_by=bound_by)


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; none is available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    log(f"[device] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
        f"torch {torch.__version__} cuda {torch.version.cuda}; {card}")
    return card


def phase_build():
    from vio_msckf_torch import kernels

    path, seconds, compile_log = kernels.build()
    kernels.lib()
    regs = [ln.strip() for ln in compile_log.splitlines()
            if "registers" in ln or "Compiling entry" in ln or "spill" in ln]
    log(f"[build] {path.relative_to(kernels.BUILD.parent.parent)} in {seconds:.2f} s; "
        + " | ".join(regs))


def phase_workload(cfg, dev):
    import torch
    from vio_msckf_torch.data.simulator import SimConfig, bundle_frames, simulate_sequence
    from vio_msckf_torch.data.render import render_sequence

    seq = simulate_sequence(cfg, SimConfig(**SIM))
    frames, init, first = bundle_frames(seq, cfg)
    n = len(frames["timestamp"])
    R = seq["gt_R_i_w"][first:first + n].transpose(0, 2, 1)
    gt = seq["gt_p"][first:first + n]
    t0 = time.perf_counter()
    cam0, cam1 = render_sequence(cfg, R, gt, device=dev, **RENDER)
    torch.cuda.synchronize()
    log(f"[workload] {n} stereo frames {tuple(cam0.shape[1:])} rendered on the card "
        f"in {time.perf_counter() - t0:.2f} s")
    dframes = dict(cam0_img=cam0, cam1_img=cam1)
    for k in ("imu_gyro", "imu_acc", "imu_dt", "imu_valid"):
        dframes[k] = torch.as_tensor(frames[k], device=dev)
    return dframes, init, gt, n


# FAST-9 + NMS per pixel: 16 circle differences; per polarity 16 three-tap
# minima (32), 16 arc minima (32) and 15 maxima; the polarity max, the
# threshold test, 8 NMS maxima and the final test.
FAST_OPS_PER_PX = 16 + 2 * (32 + 32 + 15) + 1 + 1 + 8 + 1


FAST_THRESHOLDS = (0.0, 15.0, 40.0)


def fast_inputs(frames, n, dev):
    """The FAST kernel's check inputs: rendered frames 0, 40, 110 and the
    last; the integer blocky image (ties, dense in corners); frame 40's
    coarser pyramid levels (60x94 takes the kernel's scalar path, W % 4 !=
    0); and a 97x131 crop, a multiple of no tile side."""
    import torch
    from vio_msckf_torch.ops.pyramid import build_pyramid

    cam0 = frames["cam0_img"]
    imgs = {f"frame {k}": cam0[k] for k in (0, 40, 110, n - 1)}
    rng = np.random.default_rng(4)
    blocky = np.kron(rng.integers(0, 256, (121, 189)), np.ones((4, 4)))[:480, :752]
    imgs["blocky"] = torch.as_tensor(blocky, dtype=torch.float32, device=dev)
    for lvl, x in enumerate(build_pyramid(cam0[40], 3)[1:], 1):
        imgs[f"frame 40 level {lvl}"] = x
    imgs["frame 40 crop"] = cam0[40][200:297, 300:431]
    return {k: v.contiguous() for k, v in imgs.items()}


def check_fast(frames, n, dev):
    import torch
    from vio_msckf_torch.ops import fast

    imgs = fast_inputs(frames, n, dev)
    err = 0.0
    for name, img in imgs.items():
        for thr in FAST_THRESHOLDS:
            out = fast.fast_nms(img, thr)
            ref = fast.fast_score_map(img, thr)
            torch.cuda.synchronize()
            err = max(err, float((out - ref).abs().max()))
            if not torch.equal(out, ref):
                bad = int((out != ref).sum())
                raise AssertionError(f"FAST kernel differs from its twin on {name} "
                                     f"{tuple(img.shape)} at threshold {thr}: {bad} pixels")

    def timed(img):
        out = fast.fast_nms(img, 15.0)
        c = dict(shape=list(img.shape), corners=int((out > 0).sum()),
                 candidates=int(fast.fast_candidates(img, 15.0).sum()),
                 ms=device_ms(lambda: fast.fast_nms(img, 15.0), 200),
                 plain_ms=device_ms(lambda: fast.fast_score_map(img, 15.0), 50),
                 library_ms=None, bytes=nbytes(img, out), ops=img.numel() * FAST_OPS_PER_PX)
        c["bound_ms"], c["bound_by"] = bound(c["bytes"], c["ops"])
        return c

    # The main path's call (cam0 level 0 at the tracker's threshold 15),
    # and the blocky image, whose corners are dense: the compass reject
    # makes the kernel's time depend on the data.
    call = dict(timed(imgs["frame 40"]), per_frame=1)
    dense = timed(imgs["blocky"])
    log(f"[kernel fast_nms] bit-exact on {len(imgs)} inputs x thresholds "
        f"{FAST_THRESHOLDS}; frame 40: {call['corners']} corners, {call['candidates']} "
        f"candidates, {call['ms']:.5f} ms vs twin {call['plain_ms']:.5f} ms; blocky: "
        f"{dense['corners']} corners, {dense['candidates']} candidates, {dense['ms']:.5f} ms "
        f"vs twin {dense['plain_ms']:.5f} ms; bound {call['bound_ms'] * 1e3:.3f} us "
        f"({call['bound_by']})")
    return dict(name="fast_nms", route="cuda", source="vio_msckf_torch/csrc/fast_nms.cu",
                replaces="vio_msckf_tpu/ops/fast_pallas.py:71", max_abs_err=err,
                library_note="no single PyTorch call computes FAST-9 + NMS",
                calls=[call], dense_input=dense, **summed([call]))


def _lk_points(img, n, W, H, rng):
    """n points: strong FAST corners, random interior points, and points
    on and near the image border."""
    import torch
    from vio_msckf_torch.ops.fast import fast_score_map

    score = fast_score_map(img, 15.0).flatten()
    top = torch.argsort(score, descending=True, stable=True)[: n // 2].cpu().numpy()
    corners = np.stack([top % W, top // W], axis=1).astype(np.float32)
    border = np.array([[0, 0], [W - 1, H - 1], [1.5, H / 2], [W - 2.5, H / 3],
                       [W / 2, 0.5], [W / 3, H - 1.5], [3, 4], [W - 4, H - 5]],
                      np.float32)
    rest = n - len(corners) - len(border)
    interior = rng.uniform([20, 20], [W - 20, H - 20], size=(rest, 2)).astype(np.float32)
    return np.concatenate([corners, border, interior])


# LK f32 operations. Per tracked level and feature: the 17x17 bilinear
# template (9 each), the gradients (4 per pixel), the 2x2 normal matrix
# (6 per pixel) and the final mean |I - J| (12 per pixel) over the 15x15
# window; per Newton iteration: 225 bilinear samples (9), I - J (1) and
# the two products and sums (4), plus the 2x2 solve.
LK_OPS_PER_LEVEL = 17 * 17 * 9 + 225 * (4 + 6 + 12) + 20
LK_OPS_PER_ITER = 225 * 14 + 20


def check_lk(cfg, frames, dev):
    import torch
    from vio_msckf_torch.frontend.tracker import StereoTracker
    from vio_msckf_torch.ops import klt
    from vio_msckf_torch.ops.pyramid import build_pyramid

    fe = cfg.frontend
    args = (fe.lk_patch_size, fe.lk_max_iteration, fe.lk_track_precision, 1e-4)
    win = fe.lk_patch_size
    lv = fe.lk_pyramid_levels
    H, W = frames["cam0_img"].shape[1:]
    k = 40                                   # a frame in motion
    pa = build_pyramid(frames["cam0_img"][k], lv)
    pb = build_pyramid(frames["cam0_img"][k + 1], lv)
    pc = build_pyramid(frames["cam1_img"][k], lv)
    rng = np.random.default_rng(0)
    T = fe.max_tracks
    C = fe.grid_row * fe.grid_col * fe.grid_max_feature_num
    pts_t = torch.as_tensor(_lk_points(pa[0], T, W, H, rng), device=dev)
    pts_s = torch.as_tensor(_lk_points(pa[0], T + C, W, H, rng), device=dev)
    init_s = StereoTracker(cfg, dev)._stereo_predict(pts_s)
    cpu = lambda pyr: [x.cpu() for x in pyr]          # noqa: E731

    g, s, _ = klt.pyramidal_lk(pa, pb, pts_t, pts_t, *args)
    gs, ss, _ = klt.pyramidal_lk(pa, pc, pts_s, init_s, *args)
    # The main path's three calls: (name, kernel call, twin arguments,
    # tracked levels). lk_verify runs level 0 of two image pairs.
    ver_pts = torch.cat([g, gs])
    ver_init = torch.cat([pts_t, pts_s])
    calls = [
        ("temporal", lambda: klt.pyramidal_lk(pa, pb, pts_t, pts_t, *args),
         dict(pyr_prev=pa, pyr_next=pb, pts_prev=pts_t, pts_init=pts_t), [pa, pb]),
        ("stereo", lambda: klt.pyramidal_lk(pa, pc, pts_s, init_s, *args),
         dict(pyr_prev=pa, pyr_next=pc, pts_prev=pts_s, pts_init=init_s), [pa, pc]),
        ("verify", lambda: klt.lk_verify(pb, pa, pc, pa, g, pts_t, gs, pts_s, *args),
         dict(pyr_prev=pb[:1], pyr_next=pa[:1], pts_prev=ver_pts, pts_init=ver_init,
              pyr_prev_b=pc[:1], pyr_next_b=pa[:1], n_first=T, min_size=0),
         [pb[:1], pa[:1], pc[:1]]),
    ]

    worst_err, lines, out = 0.0, [], []
    for name, call, tw, pyrs in calls:
        got = call()
        if name == "verify":
            got = tuple(torch.cat([a, b]) for a, b in zip(*got))
        g_k, s_k = got[0].cpu(), got[1].cpu()
        twin_args = {key: (cpu(v) if isinstance(v, list) else
                           v.cpu() if isinstance(v, torch.Tensor) else v)
                     for key, v in tw.items()}
        lk_args = dict(win=args[0], iters=args[1], eps=args[2], min_eig_threshold=args[3])
        g_t, s_t, _, it_t = klt.track_pyramid_plain(**twin_args, **lk_args)
        it_k = klt.track_pyramid(**tw, **lk_args)[3]
        both = s_k & s_t
        d = torch.linalg.vector_norm(g_k[both] - g_t[both], dim=1).numpy()
        p95 = float(np.percentile(d, 95)) if d.size else 0.0
        agree = float((s_k == s_t).float().mean())
        if not d.size or p95 >= 2e-2 or agree < 0.99:
            raise AssertionError(f"LK {name}: p95 {p95:.3g} px, status agreement "
                                 f"{agree:.4f} over {d.size} tracked points")
        worst_err = max(worst_err, float(d.max()))
        P = len(s_t)
        min_size = tw.get("min_size", win + 8)
        n_lv = sum(min(x.shape) >= min_size for x in pyrs[0])
        imgs = [x for pyr in pyrs for x in pyr if min(x.shape) >= min_size]
        # Newton iterations: the twin's count sets the bound; the slowest
        # feature's count sets the kernel's time.
        c = dict(name=name, P=P, levels=n_lv, per_frame=1, newton_iters=int(it_t.sum()),
                 kernel_newton_iters=int(it_k.sum()), max_feature_iters=int(it_t.max()),
                 bytes=nbytes(*imgs, tw["pts_prev"], tw["pts_init"]) + P * (8 + 1 + 4),
                 ops=P * n_lv * LK_OPS_PER_LEVEL + int(it_t.sum()) * LK_OPS_PER_ITER,
                 ms=device_ms(call, 50),
                 plain_ms=device_ms(lambda: klt.track_pyramid_plain(**tw, **lk_args), 3,
                                    runs=3, sync_free=False),
                 library_ms=None)
        c["bound_ms"], c["bound_by"] = bound(c["bytes"], c["ops"])
        out.append(c)
        lines.append(f"{name} P={P} x{n_lv} levels p95 {p95:.2e} px agree {agree:.4f} "
                     f"{c['newton_iters']} iterations ({c['kernel_newton_iters']} in the "
                     f"kernel, at most {c['max_feature_iters']} a feature): "
                     f"{c['ms']:.5f} ms vs twin {c['plain_ms']:.3f} ms, bound "
                     f"{c['bound_ms'] * 1e3:.3f} us "
                     f"({c['bound_by']})")
    tot = summed(out)
    log(f"[kernel lk] {'; '.join(lines)}; LK device ms per frame {tot['ms']:.5f}")
    return dict(name="lk_pyramid", route="cuda", source="vio_msckf_torch/csrc/lk_pyramid.cu",
                replaces="vio_msckf_tpu/ops/klt_pallas.py:63", max_abs_err=worst_err,
                library_note="no single PyTorch call computes an LK pyramid walk",
                calls=out, **tot)


def _spd_active_ops(B, k):
    """f32 operations the data needs: Gauss-Jordan over each system's
    pivots whose column has an off-diagonal nonzero (a pivot without one
    only scales its own row)."""
    import torch

    F, m, _ = B.shape
    off = B * (1 - torch.eye(m, device=B.device))
    a = ((off != 0).any(dim=1) | (off != 0).any(dim=2)).sum(dim=1).double()
    # sum_{i<a} (2a - 1)(a + k - i - 1) + (m - a) k
    ops = (2 * a - 1) * (a * (a + k) - a * (a + 1) / 2) + (m - a) * k
    return int(ops.sum()), float(a.mean())


def check_spd(dev):
    import torch
    from vio_msckf_torch.ops import spd

    rng = np.random.default_rng(1)
    D, s = 141, 0.035 ** 2
    A = torch.as_tensor(rng.normal(size=(D, D)) * 0.05, dtype=torch.float32, device=dev)
    P = A @ A.T
    lines, worst, calls = [], 0.0, []
    # (F, m, atol factor, rtol): the lost path and the prune path.
    for F, m, atol_f, rtol in ((128, 80, 2e-3, 2e-3), (160, 8, 1e-4, 1e-3)):
        Hm = torch.as_tensor(rng.normal(size=(F, m, D)) * 0.5, dtype=torch.float32, device=dev)
        n_active = torch.as_tensor(rng.integers(4, m + 1, size=F), device=dev)
        Hm = Hm * (torch.arange(m, device=dev)[None, :] < n_active[:, None])[..., None]
        B = Hm @ P @ Hm.transpose(1, 2) + s * torch.eye(m, device=dev)
        B = ((B + B.transpose(1, 2)) / 2.0).contiguous()
        R = torch.as_tensor(rng.normal(size=(F, m, 4)), dtype=torch.float32, device=dev)
        X = spd.spd_solve(B, R)
        Xp = spd.spd_solve_plain(B, R)
        torch.cuda.synchronize()
        # Each row is held to its own magnitude: the s*I padding rows
        # (X = R / s) are ~1e3 times the live rows and would otherwise set
        # an atol larger than every live value.
        scale = Xp.abs().amax(dim=-1, keepdim=True).clamp_min(1.0)
        err = float((X - Xp).abs().max())
        used = float(((X - Xp).abs() / (atol_f * scale + rtol * Xp.abs())).max())
        if not used <= 1.0:
            raise AssertionError(f"SPD m={m}: kernel vs twin max err {err:.3g}, "
                                 f"{used:.3g} of the per-row tolerance")
        worst = max(worst, err)
        ops, mean_active = _spd_active_ops(B, 4)
        c = dict(F=F, m=m, k=4, per_frame=1, mean_active_pivots=mean_active,
                 bytes=nbytes(B, R, X), ops=ops,
                 ms=device_ms(lambda: spd.spd_solve(B, R), 200),
                 plain_ms=device_ms(lambda: spd.spd_solve_plain(B, R), 50),
                 library_ms=device_ms(lambda: torch.linalg.solve_ex(B, R), 50))
        c["bound_ms"], c["bound_by"] = bound(c["bytes"], c["ops"])
        calls.append(c)
        lines.append(f"m={m} F={F} max err {err:.2e} ({used:.2e} of the per-row tolerance); "
                     f"{c['ms']:.5f} ms vs twin {c['plain_ms']:.5f} ms, solve_ex "
                     f"{c['library_ms']:.5f} ms, bound {c['bound_ms'] * 1e3:.3f} us "
                     f"({c['bound_by']}, {mean_active:.1f} active pivots)")
    log(f"[kernel spd_gj] {'; '.join(lines)}")
    return dict(name="spd_gj", route="cuda", source="vio_msckf_torch/csrc/spd_gj.cu",
                replaces="vio_msckf_tpu/ops/spd_pallas.py:47", max_abs_err=worst,
                calls=calls, **summed(calls))


def phase_slice(cfg, frames, init, gt, n, dev):
    import torch
    from vio_msckf_torch.utils.metrics import ate_rmse, rpe_rmse
    from vio_msckf_torch.engine import VIOEngine
    from vio_msckf_torch.ops import fast, klt, spd

    eng = VIOEngine(cfg, dev)

    def run():
        carry = eng.init(init["q0"], init["bg0"], init["gravity"])
        return eng.run_sequence(carry, frames)

    counters = (fast.fast_nms, klt.track_pyramid, spd.spd_solve)
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    carry, outs = run()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in counters}

    est = outs.p.cpu().numpy()
    if est.shape != (n, 3):
        raise AssertionError(f"trajectory shape {est.shape}, expected {(n, 3)}")
    ate = ate_rmse(est, gt, align=False)
    rpe = rpe_rmse(est, gt)
    resets = int(outs.did_reset.sum())
    log(f"[slice] {n} frames: ATE {ate:.4f} m, RPE {rpe:.4f} m (unaligned; bench bound "
        f"{ATE_BOUND_M} m), online resets {resets}, first pass {first_s:.2f} s")
    log(f"[slice] launches in that run: " + ", ".join(
        f"{k} {v} ({v / n:.2f}/frame)" for k, v in launches.items()))
    if not np.isfinite(est).all() or not math.isfinite(ate) or ate > ATE_BOUND_M:
        raise AssertionError(f"trajectory diverged: ATE {ate} m")
    for name, v in launches.items():
        if v <= 0:
            raise AssertionError(f"kernel {name} was never launched on the main path")

    # Host synchronisations issued by one warm step.
    frame = {k: v[n // 2] for k, v in frames.items()}
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            eng.step(carry, frame)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    syncs = [str(w.message).splitlines()[0] for w in caught
             if "called a synchronizing" in str(w.message)]
    log(f"[slice] host syncs in one warm step: {len(syncs)}"
        + (f" ({'; '.join(sorted(set(syncs)))})" if syncs else ""))

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    log(f"[slice] second pass {sec:.3f} s = {n / sec:.2f} frames/s (host clock, "
        f"ends in synchronize)")
    return launches


def main():
    card = phase_device()
    import torch
    from vio_msckf_torch.config import euroc_config

    dev = torch.device("cuda", 0)
    phase_build()
    cfg = euroc_config()
    frames, init, gt, n = phase_workload(cfg, dev)
    entries = [check_fast(frames, n, dev), check_lk(cfg, frames, dev), check_spd(dev)]
    launches = phase_slice(cfg, frames, init, gt, n, dev)
    by_counter = {"fast_nms": "fast_nms", "lk_pyramid": "track_pyramid", "spd_gj": "spd_solve"}
    for e in entries:
        e["launches"] = launches[by_counter[e["name"]]]
        e["launches_per_frame"] = e["launches"] / n
    print(json.dumps({"kernels": entries}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
