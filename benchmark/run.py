"""Run one cell of the port's benchmark once, on the machine it starts on.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

(`python3 -m benchmark.run ...` from the checkout's root is the same.)
The cell's configuration, traffic mix, limits and per-layer readers are
found by name (benchmark/spec.py). The run makes its inputs from the seed
(benchmark/traffic.py), builds the program (vio_msckf_torch) and warms up
every shape the cell uses, measures one window (benchmark/loops.py), with
`--trace 1` traces a few steps after it (benchmark/trace.py), then frees
the program and checks a sample of the window's answers against the plain
reference (benchmark/check.py).

stdout: a line of the card's readings, a line of ground-truth accuracy
(ATE, RPE), and last one JSON line: correct, attempted, failed, metrics,
device, (with --trace 1) breakdown, and `checks`, each number compared
beside its limit. stderr ends with the same checks. Without the CUDA
devices the cell asks for, or with jax, jaxlib, flax or vio_msckf_tpu
loaded once the window has closed, the run prints no result and exits
nonzero.

`--control 1` puts the reference, computed in TF32, in the program's
place: the control that the limits are set against (PERF.md). The
benchmark's own runs never pass it.
"""

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# Every build and kernel cache at a fixed path inside the checkout.
CACHE = ROOT / ".bench_cache"
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "nv")):
    os.environ[var] = str(CACHE / sub)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark import check, device as dev_mod, loops, roofline, spec, systems, trace  # noqa: E402
from benchmark import traffic as gen  # noqa: E402
from benchmark.reference import config as ref_config, set_precision  # noqa: E402
from benchmark.reference.utils.metrics import ate_rmse, rpe_rmse  # noqa: E402


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def p95(values):
    return float(np.percentile(np.asarray(values, np.float64), 95))


def build_system(cell, device, control):
    """The system under test: the program, or with `control` the
    reference in TF32 in its place."""
    if control:
        set_precision(True)
        return systems.build(cell.config, device, systems.REFERENCE)
    system = systems.build(cell.config, device, systems.PROGRAM)
    if torch.device(device).type == "cuda":
        from vio_msckf_torch import kernels

        path, seconds, _ = kernels.build()
        kernels.lib()
        log(f"kernels {path.parent.name} ({seconds:.1f} s to build)")
    return system


def launch_counters(control):
    """The program's hand-kernel launch counters (kernels.counters()), or
    {} for the control."""
    if control:
        return {}
    from vio_msckf_torch import kernels

    return kernels.counters()


def frame_rate(cell):
    """The configuration's frame rate: the live streams' schedule."""
    return float(cell.config["vio"]["filter"]["frame_rate"])


def make_inputs(cell, seed, frames, device):
    """The cell's sequences (host) and their frames rendered on the device."""
    tr = cell.traffic
    n_seq = tr.get("sequences", tr.get("streams"))
    cfg = spec.vio_config(ref_config, cell.config)
    t0 = time.perf_counter()
    seqs = gen.simulate(cfg, tr, seed, n_seq, frames)
    t1 = time.perf_counter()
    set_precision(False)
    cam0, cam1 = gen.render(cfg, cell.config["world"], seqs, device)
    imu = gen.imu_tensors(seqs, device)
    loops.sync(device)
    log(f"inputs: {n_seq} sequences x {frames} frames, motion factors "
        + ", ".join(f"{s['u']:.3f}" for s in seqs)
        + f"; simulated in {t1 - t0:.2f} s, rendered in {time.perf_counter() - t1:.2f} s")
    return seqs, dict(cam0_img=cam0, cam1_img=cam1, **imu)


def to_host(frames, device):
    """Live streams: frames quantised as a camera delivers them, time-major
    (T, B, ...) in pinned host memory, so that one tick's upload is one
    contiguous copy per key."""
    out = {}
    for k, v in frames.items():
        if k.endswith("_img"):
            v = gen.quantise(v)
        v = v.transpose(0, 1).contiguous().cpu()
        out[k] = v.pin_memory() if torch.device(device).type == "cuda" else v
    return out


def accuracy(seqs, positions, k0s, aligned):
    """Ground-truth ATE (SE(3)-aligned where `aligned`) and RPE per
    sequence over the posed frames: positions (B, n, 3) numpy of frames
    k0s."""
    gt = np.stack([s["gt_p"] for s in seqs])[:, k0s]
    return dict(ate_m=[float(ate_rmse(positions[b], gt[b], align=aligned))
                       for b in range(len(seqs))],
                rpe_m=[float(rpe_rmse(positions[b], gt[b])) for b in range(len(seqs))])


def _timed(fn, device):
    loops.sync(device)
    t0 = time.perf_counter()
    fn()
    loops.sync(device)
    return time.perf_counter() - t0


def trace_offline(system, cell, frames, window, counters, device):
    """The traced window of an offline cell: N steps from a carry of the
    window, timed without the profiler, then the same N steps profiled;
    one eager step under the layer spans. Returns the readers' context."""
    N = cell.traffic["trace_steps"]
    T = frames["imu_dt"].shape[1]
    rec = [r for r in window["records"] if r["k0"] + N <= T][-1]
    carry, k0 = rec["carry_in"], rec["k0"]
    chunk = {key: v[:, k0:k0 + N] for key, v in frames.items()}

    def steps():
        with loops.span("replay"):
            system.run(carry, chunk)

    wall = _timed(steps, device)
    for c in counters.values():
        c.by_shape.clear()
    steady = trace.summary(trace.profiled(steps))
    launches = {k: dict(c.by_shape) for k, c in counters.items()}
    frame = {key: v[:, k0] for key, v in frames.items()}
    eager, eager_s = _eager_spans(system, carry, frame)
    return dict(steps=N, wall_s=wall, steady=steady, launches=launches, eager=eager,
                eager_device_s=eager_s)


def trace_live(system, seqs, cell, host, window, n_ticks, counters, device):
    """The same for a live cell: N ticks on the schedule after the window,
    from its last carry, without and then with the profiler."""
    N = cell.traffic["trace_steps"]
    rate = frame_rate(cell)

    def ticks():
        return loops.live(system, seqs, host, device, N, rate, first=n_ticks,
                          carry=window["carry"])

    wall = ticks()["seconds"]
    for c in counters.values():
        c.by_shape.clear()
    steady = trace.summary(trace.profiled(ticks))
    launches = {k: dict(c.by_shape) for k, c in counters.items()}
    frame = {key: v[n_ticks].to(device) for key, v in host.items()}
    eager, eager_s = _eager_spans(system, window["carry"], frame)
    return dict(steps=N, wall_s=wall, steady=steady, launches=launches, eager=eager,
                eager_device_s=eager_s)


def _eager_spans(system, carry, frame):
    """One eager step under the profiler, each layer in its span: ({layer:
    device seconds}, the step's device seconds)."""
    with loops.spans_around(system):
        ev = trace.profiled(lambda: system.step(carry, frame))
    s = trace.summary(ev, span_names=tuple(system.spans))
    return s["span_device_s"], s["device_s"]


def per_layer(cell, ctx):
    """{metric: {"value", "unit"}} of the cell's per-layer metrics whose
    readers found something to read."""
    out = {}
    for m in cell.per_layer:
        v = spec.metric_reader(m["name"])(dict(ctx, moves=m["moves"]))
        if v is not None:
            out[m["name"]] = dict(value=float(v), unit=m["unit"])
    return out


def run_cell(cell, seed, seconds, trace_on, device, control=False, fault=None):
    """One run of a cell. Returns the result line's dict, or None where a
    forbidden module was found loaded. `fault(system) -> system` wraps the
    system under test (the tests plant faults with it)."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    tr = cell.traffic
    chk = tr["check"]
    if cuda:
        log(f"device: {torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}; "
            f"torch {torch.__version__} cuda {torch.version.cuda}")

    live = tr["loop"] == "live"
    rate = frame_rate(cell)
    if live:
        n_ticks = int(round(seconds * rate))
        n_frames = max(n_ticks + tr["trace_steps"] + 1, tr["warmup_frames"])
    else:
        n_frames = tr["frames"]
    seqs, frames = make_inputs(cell, seed, n_frames, device)
    t_inputs = time.monotonic()
    system = build_system(cell, device, control)
    if fault is not None:
        system = fault(system)
    counters = launch_counters(control) if cuda else {}

    # Warm-up: every shape the window uses (the capture of the step), in
    # the offline loop's calls; the control steps eagerly and has no graph
    # to settle: one call warms it.
    warm = tr["chunk"] if control else tr["warmup_frames"]
    if live:
        host = to_host(frames, device)
        frames = {k: v[:warm].transpose(0, 1).to(device) for k, v in host.items()}
    warm_ms = loops.warm_up(system, seqs, frames, warm, tr["chunk"], device)
    if live:
        del frames
    setup_s = time.monotonic() - T_START
    smi_before = dev_mod.smi() if cuda else []
    log(f"set-up {setup_s:.2f} s: {t_inputs - T_START:.2f} s to the inputs, "
        f"{time.monotonic() - t_inputs:.2f} s building the system and warming up")
    log(f"warm-up: {warm} frames in {len(warm_ms)} calls of {tr['chunk']}, ms a step "
        + ", ".join(f"{v:.2f}" for v in warm_ms) + f"; speed at the window's start "
        f"{warm_ms[-1]:.3f} ms a step")

    # The measured window.
    if live:
        keep = check.live_keep(seed, chk, n_ticks)
        window = loops.live(system, seqs, host, device, n_ticks, rate, keep=keep)
        poses = window["poses"].double().numpy()               # (n_ticks, B, k)
        attempted = poses.shape[0] * poses.shape[1]
        failed = int((~np.isfinite(poses).all(axis=-1)).sum())
        lat = window["latency_s"]
        e2e = dict(pose_latency_p95_ms=p95(lat) * 1e3)
        log(f"window: {n_ticks} ticks x {poses.shape[1]} streams at {rate} Hz in "
            f"{window['seconds']:.3f} s; latency p50 {np.median(lat) * 1e3:.3f} ms, p95 "
            f"{p95(lat) * 1e3:.3f} ms, max {max(lat) * 1e3:.3f} ms; late p95 "
            f"{p95(window['late_s']) * 1e3:.3f} ms, last tick {window['late_s'][-1] * 1e3:.3f} ms")
        acc = accuracy(seqs, poses[:, :, :3].transpose(1, 0, 2), np.arange(n_ticks),
                       system.ate_aligned)
    else:
        window = loops.offline(system, seqs, frames, seconds, tr["chunk"], device)
        pos = [system.positions(r["outs"]).double().cpu().numpy() for r in window["records"]]
        attempted = window["frames"]
        failed = int(sum((~np.isfinite(p).all(axis=-1)).sum() for p in pos))
        e2e = dict(agg_fps=window["frames"] / window["seconds"])
        n_pass = window["records"][-1]["pass_"] + 1
        log(f"window: {window['frames']} sequence-frames in {window['seconds']:.3f} s "
            f"({len(window['records'])} calls, {n_pass} pass(es)): "
            f"{e2e['agg_fps']:.3f} frames/s; whole passes "
            + (", ".join(f"{v:.3f}" for v in window["pass_fps"]) or "none")
            + " frames/s")
        first = [(p, r) for p, r in zip(pos, window["records"]) if r["pass_"] == 0]
        acc = accuracy(seqs, np.concatenate([p for p, _ in first], axis=1),
                       np.concatenate([np.arange(r["k0"], r["k0"] + r["n"]) for _, r in first]),
                       system.ate_aligned)
    e2e["setup_s"] = setup_s
    mem_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    smi_after = dev_mod.smi() if cuda else []
    print(json.dumps(dict(card_before=smi_before, card_after=smi_after,
                          warmup_ms_per_step=warm_ms,
                          pass_fps=window.get("pass_fps"))), flush=True)
    print(json.dumps(dict(ground_truth=acc, motion_factors=[s["u"] for s in seqs])), flush=True)

    result_metrics = {m["name"]: dict(value=float(e2e[m["name"]]), unit=m["unit"])
                      for m in cell.end_to_end}
    breakdown = None
    dev_info = dev_mod.describe(cell.chips) if cuda else dict(platform="cpu", kind="cpu",
                                                              count=0)
    dev_info["memory_peak_bytes"] = int(mem_peak)
    if trace_on:
        if not cuda:
            raise RuntimeError("--trace 1 reads the device's trace: it needs a CUDA device")
        if live:
            ctx = trace_live(system, seqs, cell, host, window, n_ticks, counters, device)
            ctx["late_s"] = window["late_s"]
        else:
            ctx = trace_offline(system, cell, frames, window, counters, device)
        ctx["least_s"] = (roofline.least_seconds(ctx["launches"], cell.config["vio"],
                                                 torch.cuda.get_device_name(0))
                          if ctx["launches"] else 0.0)
        ctx["hand_s"] = sum(s for name, s in ctx["steady"]["ops"].items()
                            if any(k in name for ks in roofline.KERNEL_NAMES.values()
                                   for k in ks))
        result_metrics = per_layer(cell, ctx)
        dev_info["busy_s"] = ctx["steady"]["busy_s"]
        dev_info["window_s"] = ctx["steady"]["window_s"]
        breakdown = dict(device_ops=trace.top(ctx["steady"]["ops"]),
                         idle_gaps=trace.top(ctx["steady"]["gaps"]))
        log(f"traced: {ctx['steps']} steps, {ctx['wall_s']:.4f} s unprofiled, "
            f"busy {ctx['steady']['busy_s']:.4f} s in {ctx['steady']['window_s']:.4f} s; "
            f"host calls {ctx['steady']['host_calls']}; eager step: spans "
            f"{json.dumps(ctx['eager'])} of {ctx['eager_device_s']:.4f} s device time; "
            f"launches {json.dumps({k: {str(s): n for s, n in v.items()} for k, v in ctx['launches'].items()})}")

    # The evidence, then the program's state goes before the reference runs.
    if live:
        evidence = check.live_evidence(window, keep, chk)

        def frames_at(k0, n):
            return {k: v[k0:k0 + n].transpose(0, 1).to(device) for k, v in host.items()}
    else:
        evidence = check.offline_evidence(system, window["records"], seed, chk)

        def frames_at(k0, n):
            return {k: v[:, k0:k0 + n] for k, v in frames.items()}
    del system, window
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    numbers = check.run_reference(cell.config, seqs, evidence, frames_at, device)
    checks, ok = check.judge(numbers, cell.limits)
    log(f"reference: {len(evidence['spans'])} spans, "
        f"{sum(s['n'] for s in evidence['spans'])} frames in {time.perf_counter() - t0:.1f} s")

    found = dev_mod.forbidden_modules()
    if found:
        log(f"FAIL: modules that no run may load are loaded: {found}")
        return None
    result = dict(correct=bool(ok and failed == 0), attempted=int(attempted),
                  failed=int(failed), metrics=result_metrics, device=dev_info)
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    for name, c in checks.items():
        log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    return result


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    cell = spec.cell(args.workload)
    try:
        dev_mod.require_cuda(cell.chips)
    except dev_mod.NoDevice as e:
        log(f"FAIL: {e}")
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                      control=bool(args.control))
    if result is None:
        return 1
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
