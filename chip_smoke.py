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
                the main path gives it, with the stated tolerance, and the
                median time of both on the card.
  5. slice    - VIOEngine over every frame at the full EuRoC config: ATE
                and RPE against ground truth (fails above the bench's
                0.5 m bound), launch counts of each kernel in that run
                (each must be > 0), host syncs in one warm step, and
                frames/s over a second pass.
The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.
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


def log(msg):
    print(msg, flush=True)


def median_ms(fn, reps=20, warmup=3):
    """Median device time of fn() in ms, by CUDA events around each call."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; none is available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    log(f"[device] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    return card


def phase_build():
    from vio_msckf_torch import kernels

    path, seconds, compile_log = kernels.build()
    kernels.lib()
    regs = [ln.strip() for ln in compile_log.splitlines() if "registers" in ln]
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


def check_fast(img):
    import torch
    from vio_msckf_torch.ops import fast

    out = fast.fast_nms(img, 15.0)
    ref = fast.fast_score_map(img, 15.0)
    torch.cuda.synchronize()
    if not torch.equal(out, ref):
        bad = int((out != ref).sum())
        raise AssertionError(f"FAST kernel differs from its twin at {bad} pixels")
    err = float((out - ref).abs().max())
    ms = median_ms(lambda: fast.fast_nms(img, 15.0))
    plain_ms = median_ms(lambda: fast.fast_score_map(img, 15.0))
    log(f"[kernel fast_nms] bit-exact on {tuple(img.shape)}, {int((ref > 0).sum())} "
        f"corners; {ms:.4f} ms vs twin {plain_ms:.4f} ms")
    return dict(name="fast_nms", route="cuda", source="vio_msckf_torch/csrc/fast_nms.cu",
                replaces="vio_msckf_tpu/ops/fast_pallas.py:71", max_abs_err=err,
                ms=ms, plain_ms=plain_ms)


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


def check_lk(cfg, frames, dev):
    import torch
    from vio_msckf_torch.frontend.tracker import StereoTracker
    from vio_msckf_torch.ops import klt
    from vio_msckf_torch.ops.pyramid import build_pyramid

    fe = cfg.frontend
    args = (fe.lk_patch_size, fe.lk_max_iteration, fe.lk_track_precision)
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

    worst_err = 0.0
    lines = []

    def compare(name, got, want):
        nonlocal worst_err
        (g, s), (g2, s2) = got, want
        g, s = g.cpu(), s.cpu()
        both = s & s2
        d = torch.linalg.vector_norm(g[both] - g2[both], dim=1).numpy()
        p95 = float(np.percentile(d, 95)) if d.size else 0.0
        agree = float((s == s2).float().mean())
        if not d.size or p95 >= 2e-2 or agree < 0.99:
            raise AssertionError(f"LK {name}: p95 {p95:.3g} px, status agreement "
                                 f"{agree:.4f} over {d.size} tracked points")
        worst_err = max(worst_err, float(d.max()))
        lines.append(f"{name} P={len(s)} p95 {p95:.2e} px agree {agree:.4f}")

    g, s, _ = klt.pyramidal_lk(pa, pb, pts_t, pts_t, *args)
    g2, s2, _ = klt.pyramidal_lk(cpu(pa), cpu(pb), pts_t.cpu(), pts_t.cpu(), *args)
    compare("temporal", (g, s), (g2, s2))
    gs, ss, _ = klt.pyramidal_lk(pa, pc, pts_s, init_s, *args)
    gs2, ss2, _ = klt.pyramidal_lk(cpu(pa), cpu(pc), pts_s.cpu(), init_s.cpu(), *args)
    compare("stereo", (gs, ss), (gs2, ss2))
    (va, sa, _), (vb, sb, _) = klt.lk_verify(pb, pa, pc, pa, g, pts_t, gs, pts_s, *args)
    (va2, sa2, _), (vb2, sb2, _) = klt.lk_verify(
        cpu(pb), cpu(pa), cpu(pc), cpu(pa), g.cpu(), pts_t.cpu(), gs.cpu(),
        pts_s.cpu(), *args)
    compare("verify", (torch.cat([va, vb]), torch.cat([sa, sb])),
            (torch.cat([va2, vb2]), torch.cat([sa2, sb2])))

    # Time one level-0 call at the stereo shape, kernel vs twin on the card.
    lvl_args = (pa[0], pc[0], pts_s, init_s, *args, 1e-4)
    ms = median_ms(lambda: klt.track_level(*lvl_args))
    sel = torch.zeros(len(pts_s), dtype=torch.int64, device=dev)
    plain_ms = median_ms(lambda: klt.track_level_plain(
        pa[0][None], pc[0][None], sel, pts_s, init_s, *args, 1e-4), reps=5)
    log(f"[kernel lk_level] {'; '.join(lines)}; level 0 P={len(pts_s)}: "
        f"{ms:.4f} ms vs twin {plain_ms:.4f} ms")
    return dict(name="lk_level", route="cuda", source="vio_msckf_torch/csrc/lk_level.cu",
                replaces="vio_msckf_tpu/ops/klt_pallas.py:63", max_abs_err=worst_err,
                ms=ms, plain_ms=plain_ms)


def check_spd(dev):
    import torch
    from vio_msckf_torch.ops import spd

    rng = np.random.default_rng(1)
    D, s = 141, 0.035 ** 2
    A = torch.as_tensor(rng.normal(size=(D, D)) * 0.05, dtype=torch.float32, device=dev)
    P = A @ A.T
    lines, worst, timing = [], 0.0, {}
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
        scale = max(float(Xp.abs().max()), 1.0)
        err = float((X - Xp).abs().max())
        if not bool(torch.all((X - Xp).abs() <= atol_f * scale + rtol * Xp.abs())):
            raise AssertionError(f"SPD m={m}: kernel vs twin max err {err:.3g} "
                                 f"(atol {atol_f * scale:.3g}, rtol {rtol})")
        worst = max(worst, err)
        ms = median_ms(lambda: spd.spd_solve(B, R))
        plain_ms = median_ms(lambda: spd.spd_solve_plain(B, R))
        timing[m] = (ms, plain_ms)
        lines.append(f"m={m} F={F} max err {err:.2e} (scale {scale:.2g}); "
                     f"{ms:.4f} ms vs twin {plain_ms:.4f} ms")
    log(f"[kernel spd_gj] {'; '.join(lines)}")
    ms, plain_ms = timing[80]
    return dict(name="spd_gj", route="cuda", source="vio_msckf_torch/csrc/spd_gj.cu",
                replaces="vio_msckf_tpu/ops/spd_pallas.py:47", max_abs_err=worst,
                ms=ms, plain_ms=plain_ms)


def phase_slice(cfg, frames, init, gt, n, dev):
    import torch
    from vio_msckf_torch.utils.metrics import ate_rmse, rpe_rmse
    from vio_msckf_torch.engine import VIOEngine
    from vio_msckf_torch.ops import fast, klt, spd

    eng = VIOEngine(cfg, dev)

    def run():
        carry = eng.init(init["q0"], init["bg0"], init["gravity"])
        return eng.run_sequence(carry, frames)

    counters = (fast.fast_nms, klt.track_level, spd.spd_solve)
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
    img = frames["cam0_img"][40].contiguous()
    entries = [check_fast(img), check_lk(cfg, frames, dev), check_spd(dev)]
    launches = phase_slice(cfg, frames, init, gt, n, dev)
    by_counter = {"fast_nms": "fast_nms", "lk_level": "track_level", "spd_gj": "spd_solve"}
    for e in entries:
        e["launches"] = launches[by_counter[e["name"]]]
    print(json.dumps({"kernels": entries}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
