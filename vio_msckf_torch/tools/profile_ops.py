"""Kernel-level device profile of the engine step on one GPU.

    python -m vio_msckf_torch.tools.profile_ops [--batch 1] [--duration 12]
        [--top 25] [--json out.json] [--tracker-only | --filter-only]
        [--reps 3]

The counterpart of scripts/profile_ops.py (the JAX package's op profile on
its TPU). B bench sequences (seeds 4..4+B-1, `--duration` s each) run
through the engine (or the tracker alone, or the filter alone on the
simulator's feature tracks) as one batch of B; then:

  * the best of `--reps` whole passes, untimed first pass excluded: ms a
    step and aggregate frames/s (host clock, ending in synchronize);
  * a window of WINDOW_STEPS (5) warm steps from the middle of the sequence,
    timed without the profiler (best of `--reps`) and then run once under
    torch.profiler (CPU + CUDA activities): per device kernel its name,
    calls, self device time and share of the device time; the device-busy
    fraction of the window's wall clock (device time under the profiler
    over the window's time without it); kernel launches a step
    (cudaLaunchKernel + cuLaunchKernel); and the rows of the three hand
    kernels (csrc/) by name.

The JAX script's MFU line has no counterpart: the step runs no model, and
each hand kernel's share of its roofline bound is chip_smoke.py's. Without
a CUDA device the tool raises: its numbers are device numbers.
"""

import argparse
import json
import sys
import time

import numpy as np
import torch

from vio_msckf_torch import bench
from vio_msckf_torch.config import euroc_config
from vio_msckf_torch.data.simulator import SimConfig, bundle_frames, simulate_sequence
from vio_msckf_torch.engine import VIOEngine
from vio_msckf_torch.filter.msckf import MSCKF
from vio_msckf_torch.frontend.tracker import StereoTracker

# The hand kernels' device function names (csrc/*.cu), by wrapper.
HAND_KERNELS = {"fast_nms": ("fast_nms_kernel",), "lk_pyramid": ("lk_pyramid_kernel",),
                "spd_gj": ("gj_block", "gj_warp")}
IMU_KEYS = ("imu_gyro", "imu_acc", "imu_dt", "imu_valid")
WINDOW_STEPS = 5               # a few steps: ~12,300 launches each at B = 1


def _self_device_us(e):
    return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))


def launch_profile(step):
    """One call of step() under torch.profiler: ({launch API: calls}, the
    device time in ms, {device kernel: {"calls", "self_ms"}})."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    events = prof.key_averages()
    launches = {e.key: e.count for e in events if "LaunchKernel" in e.key}
    kernels = {e.key: dict(calls=e.count, self_ms=_self_device_us(e) / 1e3) for e in events
               if str(getattr(e, "device_type", "")).endswith("CUDA")}
    return launches, sum(k["self_ms"] for k in kernels.values()), kernels


def hand_rows(kernels):
    """The hand kernels' rows of a launch_profile kernel table."""
    return {name: dict(calls=sum(v["calls"] for k, v in kernels.items()
                                 if any(s in k for s in syms)),
                       self_ms=sum(v["self_ms"] for k, v in kernels.items()
                                   if any(s in k for s in syms)))
            for name, syms in HAND_KERNELS.items()}


def build_parser():
    ap = argparse.ArgumentParser(prog="python -m vio_msckf_torch.tools.profile_ops",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--duration", type=float, default=12.0)
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--json", default=None)
    only = ap.add_mutually_exclusive_group()
    only.add_argument("--tracker-only", action="store_true")
    only.add_argument("--filter-only", action="store_true")
    ap.add_argument("--reps", type=int, default=3)
    return ap


def build_model(cfg, mode, B, duration, device):
    """What a profiled step runs, for B bench sequences of `duration` s:
    mode "engine" (VIOEngine.step_batch), "tracker" (the stereo front-end
    alone on the rendered frames) or "filter" (the MSCKF alone on the
    simulator's feature tracks). Returns (fresh() -> carry,
    step(carry, frame) -> carry, frames (B, T, ...))."""
    if mode == "filter":
        seqs = [bundle_frames(simulate_sequence(cfg, SimConfig(**{
            **bench.SIM, "duration": duration, "seed": 4 + b})), cfg) for b in range(B)]
        keys = IMU_KEYS + ("feat_ids", "feat_obs", "feat_valid")
        frames = {k: torch.as_tensor(np.stack([f[k] for f, _, _ in seqs]), device=device)
                  for k in keys}
        kf = MSCKF(cfg, device)
        inits = [init for _, init, _ in seqs]
        return lambda: kf.init_batch(inits), lambda c, f: kf.step(c, f)[0], frames
    frames, inits, _, _ = bench.stack_workloads(
        [bench.build_workload(cfg, dict(seed=4 + b), duration=duration, device=device)
         for b in range(B)])
    if mode == "tracker":
        tracker = StereoTracker(cfg, device)

        def step(ts, f):
            return tracker.step(ts, f["cam0_img"], f["cam1_img"], f["imu_gyro"],
                                f["imu_dt"], f["imu_valid"])[0]

        return lambda: tracker.init(B), step, frames
    eng = VIOEngine(cfg, device)
    return lambda: eng.init_batch(inits), lambda c, f: eng.step_batch(c, f)[0], frames


def main(argv=None):
    args = build_parser().parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_ops measures the device: it needs a CUDA device")
    from vio_msckf_torch.tools import card

    device = bench.setup("cuda")
    cfg = euroc_config()
    mode = "filter" if args.filter_only else "tracker" if args.tracker_only else "engine"
    fresh, step, frames = build_model(cfg, mode, args.batch, args.duration, device)
    B, n = frames["imu_dt"].shape[:2]
    at = lambda k: {key: v[:, k] for key, v in frames.items()}  # noqa: E731

    def run(carry, lo=0, hi=n):
        for k in range(lo, hi):
            carry = step(carry, at(k))
        return carry

    t0 = time.perf_counter()
    run(fresh())
    torch.cuda.synchronize()
    print(f"{mode} B={B}: {n} frames, first pass {time.perf_counter() - t0:.1f}s", flush=True)
    best = min(bench.timed_passes(fresh, run, args.reps, device))

    # The window: WINDOW_STEPS warm steps from the middle, from one carry.
    lo = max(0, min(n // 2, n - WINDOW_STEPS))
    hi = min(n, lo + WINDOW_STEPS)
    mid = run(fresh(), 0, lo)
    window = lambda c=mid: run(c, lo, hi)  # noqa: E731
    window()
    win_ms = min(bench.timed_passes(lambda: mid, window, args.reps, device)) * 1e3
    launches, device_ms, kernels = launch_profile(window)
    if not device_ms > 0:
        raise RuntimeError("torch.profiler recorded no device time on this machine")
    steps = hi - lo
    busy = device_ms / win_ms
    per_step = sum(launches.values()) / steps
    rows = sorted(kernels.items(), key=lambda kv: -kv[1]["self_ms"])
    hand = hand_rows(kernels)
    smi = card()

    print(f"\n=== {mode} B={B}: {n} frames; {smi} ===")
    print(f"warm pass {best * 1e3:.1f} ms ({best * 1e3 / n:.2f} ms/step, "
          f"{B * n / best:.1f} agg fps; best of {args.reps})")
    print(f"window: frames {lo}..{hi - 1}, {win_ms / steps:.2f} ms a step without the profiler; "
          f"device time {device_ms / steps:.3f} ms a step = {busy * 100:.1f}% busy")
    print(f"kernel launches a step: {per_step:.0f} ("
          + ", ".join(f"{k} {v / steps:.0f}" for k, v in sorted(launches.items())) + ")")
    hdr = f"{'device kernel':70s} {'calls':>7s} {'self ms':>9s} {'%':>6s}"
    print(hdr + "\n" + "-" * len(hdr))
    for name, v in rows[: args.top]:
        print(f"{name[:70]:70s} {v['calls']:7d} {v['self_ms']:9.3f} "
              f"{v['self_ms'] / max(device_ms, 1e-12) * 100:6.2f}")
    print("\nhand kernels (csrc/):")
    for name, v in hand.items():
        print(f"  {name:12s} {v['calls'] / steps:5.1f} calls a step, {v['self_ms'] / steps:.4f} ms "
              f"a step, {v['self_ms'] / max(device_ms, 1e-12) * 100:.2f}% of the device time")

    if args.json:
        with open(args.json, "w") as f:
            json.dump(dict(label=mode, batch=B, frames=n, card=smi,
                           ms_per_step=best * 1e3 / n, agg_fps=B * n / best,
                           window=[lo, hi], window_ms_per_step=win_ms / steps,
                           device_ms_per_step=device_ms / steps, busy_fraction=busy,
                           launches_per_step=per_step,
                           launch_calls={k: v / steps for k, v in launches.items()},
                           hand_kernels=hand,
                           top_kernels=[dict(name=k, **v) for k, v in rows[: args.top]]),
                      f, indent=1)
        print("json ->", args.json)
    return 0


if __name__ == "__main__":
    sys.exit(main())
