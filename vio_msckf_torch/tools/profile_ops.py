"""Kernel-level device profile of the engine step on one GPU.

    python -m vio_msckf_torch.tools.profile_ops [--batch 1] [--duration 12]
        [--top 25] [--json out.json] [--tracker-only | --filter-only]
        [--reps 3]

The counterpart of scripts/profile_ops.py (the JAX package's op profile on
its TPU). B bench sequences (seeds 4..4+B-1, `--duration` s each) run
through the engine (or the tracker alone, or the filter alone on the
simulator's feature tracks) as one batch of B; then:

  * the best of `--reps` whole passes, untimed first pass excluded: ms a
    step and aggregate frames/s (host clock, ending in synchronize). The
    engine's and the filter's passes are what their users run,
    VIOEngine.run_batch and MSCKF.run_sequence, which replay the step's
    CUDA graph (captured in the first pass); the tracker alone steps
    eagerly;
  * a window of WINDOW_STEPS (5) warm steps from the middle of the sequence,
    timed without the profiler (best of `--reps`) and then run once under
    torch.profiler (CPU + CUDA activities): per device kernel its name,
    calls, self device time and share of the device time; the device-busy
    fraction of that profiled run (its device time over its span between
    two CUDA events around it; the profiler slows the host and stretches a
    graph's replay, so the share is the profiled run's, lower than an
    unprofiled run's, whose time a step is printed beside it); the host's
    launch calls a step
    (cudaLaunchKernel, cuLaunchKernel, cudaGraphLaunch, cudaMemcpyAsync)
    and the rows of the three hand kernels (csrc/) by name, whose launches
    must equal their launch counters' over the profiled run. For the
    engine and the filter the window runs twice: graphed (run_batch or
    run_sequence over the window: a few copies and one graph launch a
    step) and eager (the step per frame: the kernels the graph holds, one
    launch each).

The JAX script's MFU line has no counterpart: the step runs no model, and
each hand kernel's share of its roofline bound is chip_smoke.py's. Without
a CUDA device the tool raises: its numbers are device numbers.
"""

import argparse
import json
import sys
import time
import warnings

import numpy as np
import torch

from vio_msckf_torch import bench, kernels as hand
from vio_msckf_torch.config import euroc_config
from vio_msckf_torch.data.simulator import SimConfig, bundle_frames, simulate_sequence
from vio_msckf_torch.engine import VIOEngine
from vio_msckf_torch.filter.msckf import MSCKF
from vio_msckf_torch.frontend.tracker import StereoTracker

# The hand kernels' device function names (csrc/*.cu), by wrapper.
HAND_KERNELS = {"fast_nms": ("fast_nms_kernel",), "lk_pyramid": ("lk_pyramid_kernel",),
                "spd_gj": ("gj_block", "gj_warp")}
IMU_KEYS = ("imu_gyro", "imu_acc", "imu_dt", "imu_valid")
WINDOW_STEPS = 5               # a few steps: ~12,300 launches each at B = 1, eager
# The host's calls that put work on the device: kernels, graphs, copies
# (CUDA runtime and driver API names; the device's own copy events, e.g.
# "Memcpy DtoD", are not host calls).
LAUNCH_APIS = ("LaunchKernel", "GraphLaunch", "Memcpy")


def _self_device_us(e):
    return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))


def launch_profile(step):
    """One call of step() under torch.profiler: ({launch API: calls}, the
    device time in ms, {device kernel or copy: {"calls", "self_ms"}}, the
    call's span on the device in ms). The span runs from a CUDA event
    recorded just before the call to one just after it, in the same
    profiled run, so device time over span is the share of that span in
    which the device ran a kernel or a copy."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        a.record()
        step()
        b.record()
        torch.cuda.synchronize()
    span_ms = a.elapsed_time(b)
    events = prof.key_averages()
    launches = {e.key: e.count for e in events
                if e.key.startswith("cu") and any(a in e.key for a in LAUNCH_APIS)}
    kernels = {e.key: dict(calls=e.count, self_ms=_self_device_us(e) / 1e3) for e in events
               if str(getattr(e, "device_type", "")).endswith("CUDA")}
    return launches, sum(k["self_ms"] for k in kernels.values()), kernels, span_ms


def hand_rows(kernels):
    """The hand kernels' rows of a launch_profile kernel table: each
    wrapper call launches one device kernel, so `calls` is the number of
    the wrapper's launches that the device ran."""
    return {name: dict(calls=sum(v["calls"] for k, v in kernels.items()
                                 if any(s in k for s in syms)),
                       self_ms=sum(v["self_ms"] for k, v in kernels.items()
                                   if any(s in k for s in syms)))
            for name, syms in HAND_KERNELS.items()}


def host_syncs(step):
    """Host synchronisations made by one call of step()."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            step()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return [str(w.message).splitlines()[0] for w in caught
            if "called a synchronizing" in str(w.message)]


def replay_profile(graph, frame, replays, before=None):
    """One replay of a captured step (graph.StepGraph) on `frame`: host
    syncs (fails unless 0); under torch.profiler the host's launch calls,
    the device kernels and their time, the replay's span between CUDA
    events, NCCL's kernels among them and their device time (a step
    sharded over NCCL holds its collectives in the graph), and the hand
    kernels' launches in the trace, which must equal what the runner adds
    to their counters per replay; then, without the profiler, `replays`
    replays back to back between two CUDA events and on the host clock
    (ending in synchronize). `before()` runs just before those (a barrier
    where the ranks of a group replay together). Every call replays the
    graph replays + 2 times."""
    syncs = host_syncs(lambda: graph.replay(frame))
    if syncs:
        raise AssertionError(f"{len(syncs)} host syncs in one replay: {sorted(set(syncs))}")
    for w in hand.counters().values():
        w.by_shape.clear()
    calls, dev_ms, table, span_ms = launch_profile(lambda: graph.replay(frame))
    traced = traced_counts(table)
    per_replay = {k: sum(graph.launches[k].values()) for k in traced}
    if traced != per_replay:
        raise AssertionError(f"a replay ran {traced} hand-kernel launches, the runner counts "
                             f"{per_replay}")
    nccl = {k: v for k, v in table.items() if "nccl" in k.lower()}
    if before is not None:
        before()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    a.record()
    for _ in range(replays):
        graph.replay(frame)
    b.record()
    torch.cuda.synchronize()
    return dict(launch_calls=calls, host_calls=sum(calls.values()),
                device_kernels=sum(v["calls"] for v in table.values()), device_ms=dev_ms,
                span_ms=span_ms, traced=traced,
                nccl_kernels=sum(v["calls"] for v in nccl.values()),
                nccl_ms=sum(v["self_ms"] for v in nccl.values()), nccl_names=sorted(nccl),
                replay_ms=a.elapsed_time(b) / replays,
                wall_ms=(time.perf_counter() - t0) / replays * 1e3)


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
    mode "engine" (VIOEngine), "tracker" (the stereo front-end alone on
    the rendered frames) or "filter" (the MSCKF alone on the simulator's
    feature tracks). Returns (fresh() -> carry, step(carry, frame) ->
    carry, run(carry, lo, hi) -> carry over frames lo..hi-1, frames
    (B, T, ...)): step is the eager step; run is the engine's run_batch
    or the filter's run_sequence (the replayed graph) and, for the
    tracker, a loop of step."""
    if mode == "filter":
        seqs = [bundle_frames(simulate_sequence(cfg, SimConfig(**{
            **bench.SIM, "duration": duration, "seed": 4 + b})), cfg) for b in range(B)]
        keys = IMU_KEYS + ("feat_ids", "feat_obs", "feat_valid")
        frames = {k: torch.as_tensor(np.stack([f[k] for f, _, _ in seqs]), device=device)
                  for k in keys}
        kf = MSCKF(cfg, device)
        inits = [init for _, init, _ in seqs]
        fresh, step = lambda: kf.init_batch(inits), lambda c, f: kf.step(c, f)[0]

        def run(carry, lo, hi):
            return kf.run_sequence(carry, {k: v[:, lo:hi] for k, v in frames.items()})[0]

        return fresh, step, run, frames
    else:
        frames, inits, _, _ = bench.stack_workloads(
            [bench.build_workload(cfg, dict(seed=4 + b), duration=duration, device=device)
             for b in range(B)])
        if mode == "tracker":
            tracker = StereoTracker(cfg, device)

            def step(ts, f):
                return tracker.step(ts, f["cam0_img"], f["cam1_img"], f["imu_gyro"],
                                    f["imu_dt"], f["imu_valid"])[0]

            fresh = lambda: tracker.init(B)  # noqa: E731
        else:
            eng = VIOEngine(cfg, device)
            fresh, step = lambda: eng.init_batch(inits), lambda c, f: eng.step_batch(c, f)[0]

            def run(carry, lo, hi):
                return eng.run_batch(carry, {k: v[:, lo:hi] for k, v in frames.items()})[0]

            return fresh, step, run, frames

    def run(carry, lo, hi):
        for k in range(lo, hi):
            carry = step(carry, {key: v[:, k] for key, v in frames.items()})
        return carry

    return fresh, step, run, frames


def traced_counts(kernels):
    """Fails unless each hand kernel's launch counter, set to 0 before the
    profiled run, counted the launches the device ran in it (the kernel
    table of launch_profile). A replayed graph calls no wrapper: its
    counts are the runner's (graph.py), and this holds them to the trace."""
    counted = {k: sum(w.by_shape.values()) for k, w in hand.counters().items()}
    traced = {k: v["calls"] for k, v in hand_rows(kernels).items()}
    if counted != traced:
        raise RuntimeError(f"launch counters {counted}, device launches in the trace {traced}")
    return counted


def window_profile(run, mid, lo, hi, reps, device):
    """run(mid, lo, hi) timed without the profiler (best of reps), then
    once under it: per-step numbers, and the kernel table and the hand
    kernels' rows as totals over the window's steps."""
    steps = hi - lo
    run(mid, lo, hi)
    win_ms = min(bench.timed_passes(lambda: mid, lambda c: run(c, lo, hi), reps, device)) * 1e3
    for w in hand.counters().values():
        w.by_shape.clear()
    launches, device_ms, kernels, span_ms = launch_profile(lambda: run(mid, lo, hi))
    if not device_ms > 0:
        raise RuntimeError("torch.profiler recorded no device time on this machine")
    traced_counts(kernels)
    rows = sorted(kernels.items(), key=lambda kv: -kv[1]["self_ms"])
    return dict(steps=steps, window_ms_per_step=win_ms / steps,
                device_ms_per_step=device_ms / steps,
                span_ms_per_step=span_ms / steps,
                busy_fraction=device_ms / span_ms,
                launches_per_step=sum(launches.values()) / steps,
                launch_calls={k: v / steps for k, v in launches.items()},
                device_kernels_per_step=sum(v["calls"] for v in kernels.values()) / steps,
                hand_kernels=hand_rows(kernels),
                top_kernels=[dict(name=k, **v) for k, v in rows])


def report(name, w, top):
    """Print one window_profile."""
    dev_ms = w["device_ms_per_step"]
    print(f"{name}: {w['window_ms_per_step']:.2f} ms a step without the profiler; under it, "
          f"device time {dev_ms:.3f} ms in a {w['span_ms_per_step']:.3f} ms span a step = "
          f"{w['busy_fraction'] * 100:.1f}% busy; "
          f"{w['device_kernels_per_step']:.0f} device kernels and copies a step")
    print(f"host launch calls a step: {w['launches_per_step']:.0f} ("
          + ", ".join(f"{k} {v:.0f}" for k, v in sorted(w["launch_calls"].items())) + ")")
    hdr = f"{'device kernel':70s} {'calls/step':>10s} {'ms/step':>9s} {'%':>6s}"
    print(hdr + "\n" + "-" * len(hdr))
    steps = w["steps"]            # the kernel rows hold the window's totals
    for r in w["top_kernels"][:top]:
        print(f"{r['name'][:70]:70s} {r['calls'] / steps:10.1f} {r['self_ms'] / steps:9.4f} "
              f"{r['self_ms'] / steps / max(dev_ms, 1e-12) * 100:6.2f}")
    print("hand kernels (csrc/):")
    for k, v in w["hand_kernels"].items():
        print(f"  {k:12s} {v['calls'] / steps:5.1f} calls a step, {v['self_ms'] / steps:.4f} ms "
              f"a step, {v['self_ms'] / steps / max(dev_ms, 1e-12) * 100:.2f}% of the device time")


def main(argv=None):
    args = build_parser().parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_ops measures the device: it needs a CUDA device")
    from vio_msckf_torch.tools import card

    device = bench.setup("cuda")
    cfg = euroc_config()
    mode = "filter" if args.filter_only else "tracker" if args.tracker_only else "engine"
    fresh, step, run, frames = build_model(cfg, mode, args.batch, args.duration, device)
    B, n = frames["imu_dt"].shape[:2]

    t0 = time.perf_counter()
    run(fresh(), 0, n)
    torch.cuda.synchronize()
    print(f"{mode} B={B}: {n} frames, first pass {time.perf_counter() - t0:.1f}s", flush=True)
    best = min(bench.timed_passes(fresh, lambda c: run(c, 0, n), args.reps, device))

    # The window: WINDOW_STEPS warm steps from the middle, from one carry.
    lo = max(0, min(n // 2, n - WINDOW_STEPS))
    hi = min(n, lo + WINDOW_STEPS)
    mid = run(fresh(), 0, lo)

    def eager(c, a, b):
        for k in range(a, b):
            c = step(c, {key: v[:, k] for key, v in frames.items()})
        return c

    windows = {}
    if mode != "tracker":
        windows["graphed"] = window_profile(run, mid, lo, hi, args.reps, device)
    windows["eager"] = window_profile(eager, mid, lo, hi, args.reps, device)
    smi = card()

    print(f"\n=== {mode} B={B}: {n} frames; {smi} ===")
    print(f"warm pass {best * 1e3:.1f} ms ({best * 1e3 / n:.2f} ms/step, "
          f"{B * n / best:.1f} agg fps; best of {args.reps}"
          + ("; graphed)" if mode != "tracker" else ")"))
    print(f"window: frames {lo}..{hi - 1}")
    for name, w in windows.items():
        print()
        report(name if name == "graphed" else "eager (the kernels the graph holds)"
               if mode != "tracker" else name, w, args.top)

    if args.json:
        with open(args.json, "w") as f:
            json.dump(dict(label=mode, batch=B, frames=n, card=smi,
                           ms_per_step=best * 1e3 / n, agg_fps=B * n / best,
                           window=[lo, hi],
                           **{k: dict(w, top_kernels=w["top_kernels"][: args.top])
                              for k, w in windows.items()}),
                      f, indent=1)
        print("json ->", args.json)
    return 0


if __name__ == "__main__":
    sys.exit(main())
