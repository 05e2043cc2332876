"""The port's timed entry: full image->pose VIO throughput on one GPU.

    python -m vio_msckf_torch.bench [--suite | --scaling] [--device cuda|cpu]

The counterpart of the repository's bench.py, which times the JAX package
and stays its own; this module imports neither. Workload: the complete
per-frame pipeline (pyramids, FAST-9, pyramidal-LK stereo tracking, IMU
propagation, triangulation, the gated QR-compressed EKF update, clone
pruning) on EuRoC-sized stereo frames (752x480 x2, 20 Hz nominal, ~10 IMU
samples a frame) rendered on the device from the synthetic textured world
before the clock starts. On a CUDA device the hand kernels
(vio_msckf_torch/csrc) are built at the start and carry every step.

Baseline: the reference ships at 0.4x real time on a CPU, ~8 stereo
frames/s end to end; `vs_baseline` is frames/s over 8.

Default mode prints exactly one JSON line
  {"metric": ..., "value": fps, "unit": "frames/s", "vs_baseline": x,
   "ate_rmse_m": y, "rpe_rmse_m": z}
with unrounded numbers, and exits nonzero if the trajectory diverged (ATE
above 0.5 m or not finite). fps is frames over the best of 3 passes, each
from a fresh carry and ending in torch.cuda.synchronize(), after a first
untimed pass. On a CUDA device the engine replays its step as a CUDA
graph (vio_msckf_torch/graph.py), captured in the first pass, as the JAX
bench times `jax.jit(eng.run_sequence)` after its compile.

`--suite` prints five such lines: the default window, V1_02-style fast
motion, the 30-clone window (MH_04/05-style), the hostile world, and the
4-sequence batch (aggregate frames/s); each over the full sequence, each
alone at B = 1 except the batch.

`--scaling` runs the filter step at euroc_config() over 8 simulated
sequences (no renderer) in ranks of vio_msckf_torch.parallel.worker,
replicas only (strong scaling), and prints one JSON line with the table:
on a host with several cards 1, 2, 4 and 8 ranks up to one rank a card
(NCCL); on one card 1 rank (NCCL) and 2, 4 and 8 ranks sharing it over
gloo, rows that measure no scaling. A replica-only step issues no
collective, so on a card every rank replays the step's CUDA graph
whatever the backend (graph.py's rule keys on the block group, and there
is none). `--device cpu` runs 1, 2, 4 and 8 ranks on the CPU (gloo,
eager), as bench.py's virtual CPU mesh does.

Logs go to stderr, JSON lines to stdout.
"""

import argparse
import json
import math
import os
import sys
import tempfile
import time

import numpy as np
import torch

from vio_msckf_torch import full_precision, kernels
from vio_msckf_torch.config import FilterConfig, euroc_config
from vio_msckf_torch.data.render import BENCH_WORLD, HOSTILE_AUGS, render_sequence
from vio_msckf_torch.data.simulator import SimConfig, bundle_frames, simulate_sequence
from vio_msckf_torch.engine import VIOEngine
from vio_msckf_torch.utils.metrics import ate_rmse, rpe_rmse

BASELINE_FPS = 8.0  # the reference: 0.4x real time at 20 Hz
ATE_BOUND_M = 0.5
# The bench sequence (bench.py:build_workload); it is rendered in BENCH_WORLD.
SIM = dict(duration=12.0, seed=4, amp=(1.5, 1.0, 0.5), yaw_rate=0.2, wobble_amp=0.1)
FAST_MOTION = dict(amp=(2.5, 1.8, 0.9), yaw_rate=0.6, wobble_amp=0.25, seed=11)
SUITE_BATCH = 4
SCALING_RANKS = (1, 2, 4, 8)
SCALING_SEQUENCES = 8          # seeds 4..11, fixed over the rank counts
SCALING_TIMEOUT_S = 1800


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def setup(device):
    """The run's device. On a CUDA device the hand kernels are built (or
    found built) and loaded now, so no pass pays for it; without a card
    "cuda" raises rather than fall back to the CPU."""
    device = torch.device(device)
    full_precision()
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda needs a CUDA device; none is available")
        path, seconds, _ = kernels.build()
        kernels.lib()
        log(f"devices: {torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}; "
            f"kernels {path.parent.name} ({seconds:.1f} s to build)")
    else:
        log(f"devices: {device}")
    return device


def _where(device):
    return "1 GPU" if torch.device(device).type == "cuda" else "CPU"


def build_workload(cfg, sim_overrides=None, duration=12.0, render_augs=None, device="cuda"):
    """Simulate and render one bench sequence on `device`: (frames dict
    of tensors (n, ...), init dict, ground-truth positions (n, 3), n)."""
    seq = simulate_sequence(cfg, SimConfig(**{**SIM, "duration": duration,
                                              **(sim_overrides or {})}))
    frames, init, first = bundle_frames(seq, cfg)
    n = len(frames["timestamp"])
    t0 = time.perf_counter()
    R = seq["gt_R_i_w"][first:first + n].transpose(0, 2, 1)
    gt = seq["gt_p"][first:first + n]
    cam0, cam1 = render_sequence(cfg, R, gt, device=device, augs=render_augs,
                                  **BENCH_WORLD)
    _sync(device)
    log(f"rendered {n} stereo frames in {time.perf_counter() - t0:.1f}s")
    dframes = dict(cam0_img=cam0, cam1_img=cam1)
    for k in ("imu_gyro", "imu_acc", "imu_dt", "imu_valid"):
        dframes[k] = torch.as_tensor(frames[k], device=device)
    return dframes, init, gt, n


def stack_workloads(workloads):
    """Sequences of one length -> frames (B, T, ...), inits, gts, n."""
    n = workloads[0][3]
    if any(w[3] != n for w in workloads):
        raise ValueError(f"sequence lengths differ: {[w[3] for w in workloads]}")
    frames = {k: torch.stack([w[0][k] for w in workloads]) for k in workloads[0][0]}
    return frames, [w[1] for w in workloads], [w[2] for w in workloads], n


def timed_passes(fresh, run, reps, device):
    """Seconds of `reps` calls of run(fresh()), each on a fresh carry made
    before the clock starts and ending on the device."""
    times = []
    for _ in range(reps):
        carry = fresh()
        _sync(device)
        t0 = time.perf_counter()
        run(carry)
        _sync(device)
        times.append(time.perf_counter() - t0)
    return times


def fail_if_diverged(what, ate, rpe):
    if not (math.isfinite(ate) and math.isfinite(rpe)) or ate > ATE_BOUND_M:
        log(f"FAIL: {what}: ATE {ate:.4f} m, RPE {rpe:.4f} m; the bound is "
            f"{ATE_BOUND_M} m - filter diverged; not reporting throughput.")
        sys.exit(1)


def run_single(cfg, name, sim_overrides=None, reps=3, render_augs=None, device="cuda"):
    """One sequence through VIOEngine.run_sequence; returns the result
    dict (bench.py's keys, unrounded)."""
    frames, init, gt, n = build_workload(cfg, sim_overrides, render_augs=render_augs,
                                         device=device)
    eng = VIOEngine(cfg, device)

    def fresh():
        return eng.init(init["q0"], init["bg0"], init["gravity"])

    def run(carry):
        return eng.run_sequence(carry, frames)

    t0 = time.perf_counter()
    _, outs = run(fresh())
    est = outs.p.cpu().numpy()
    log(f"[{name}] first run (kernels loaded, caches cold): {time.perf_counter() - t0:.1f}s")
    ate = ate_rmse(est, gt, align=False)
    rpe = rpe_rmse(est, gt)
    log(f"[{name}] ATE RMSE (unaligned, synthetic): {ate:.4f} m  "
        f"RPE RMSE (20-frame delta): {rpe:.4f} m")
    fail_if_diverged(name, ate, rpe)

    times = timed_passes(fresh, run, reps, device)
    for r, t in enumerate(times):
        log(f"[{name}] pass {r}: {t:.3f}s ({n / t:.1f} fps)")
    fps = n / min(times)
    return {"metric": name, "value": fps, "unit": "frames/s",
            "vs_baseline": fps / BASELINE_FPS, "ate_rmse_m": float(ate),
            "rpe_rmse_m": float(rpe)}


def measure_batch(eng, frames, inits, gts, reps, device, name):
    """The bench's rule for B sequences (frames (B, T, ...)) in lockstep
    through eng.run_batch: a first, untimed pass, each sequence's ATE and
    RPE (the run exits above the bound, as run_single does), then `reps`
    passes from a fresh carry. Returns (seconds of the best pass, ATEs,
    RPEs, seconds of the first pass)."""
    B, n = frames["imu_dt"].shape[:2]

    def fresh():
        return eng.init_batch(inits)

    def run(carry):
        return eng.run_batch(carry, frames)

    t0 = time.perf_counter()
    _, outs = run(fresh())
    est = outs.p.cpu().numpy()
    first_s = time.perf_counter() - t0
    log(f"[{name}] first run (kernels loaded, caches cold): {first_s:.1f}s")
    ates = [ate_rmse(est[b], gts[b], align=False) for b in range(B)]
    rpes = [rpe_rmse(est[b], gts[b]) for b in range(B)]
    log(f"[{name}] per-sequence ATE: " + ", ".join(f"{a:.4f}" for a in ates))
    # A NaN never compares above the bound: take the worst with NaN kept.
    fail_if_diverged(name, float(np.max(ates)), float(np.max(rpes)))

    times = timed_passes(fresh, run, reps, device)
    for r, t in enumerate(times):
        log(f"[{name}] pass {r}: {t:.3f}s ({B * n / t:.1f} agg fps)")
    return min(times), ates, rpes, first_s


def run_batched(cfg, name, batch, reps=3, device="cuda"):
    """B sequences (seeds 4..4+B-1) advanced in lockstep by
    VIOEngine.run_batch, one launch per kernel for all of them; value is
    aggregate frames/s, ATE and RPE the worst sequence's."""
    frames, inits, gts, n = stack_workloads(
        [build_workload(cfg, dict(seed=4 + b), device=device) for b in range(batch)])
    best, ates, rpes, _ = measure_batch(VIOEngine(cfg, device), frames, inits, gts, reps,
                                        device, name)
    fps = batch * n / best
    return {"metric": name, "value": fps, "unit": "frames/s (aggregate)",
            "vs_baseline": fps / BASELINE_FPS, "ate_rmse_m": float(np.max(ates)),
            "rpe_rmse_m": float(np.max(rpes))}


def run_scaling(reps=2, duration=12.0, device="cuda", config="euroc", frames=0,
                ranks=SCALING_RANKS, out_dir=None):
    """Strong-scaling table of the replica-sharded filter step: 8
    simulated sequences (feature tracks, no renderer) over `ranks` ranks
    of parallel/worker.py, one sequence block per replica, no block axis;
    with more than one card, only the rank counts up to one rank a card.
    Ranks with a card each run NCCL, ranks sharing one card run gloo
    (`backend`, `ranks_per_card`). No block group means no collective in
    the step, so on a card every rank replays the filter step's CUDA graph
    (MSCKF.run_sequence) under either backend, and on the CPU every rank
    steps eagerly: a row whose `captured` breaks that rule raises.
    Each rank count runs a first pass and `reps` timed ones;
    a pass takes the slowest rank's time, agg_fps = sequences x frames /
    the best pass. `config` "tiny" and `frames` > 0 cut the run for tests;
    with `out_dir` each rank count's rank files (positions, reports) stay
    in out_dir/ranks<n>. Prints the JSON line and returns the table."""
    from vio_msckf_torch.parallel.distributed import Ranks

    device = torch.device(device)
    cards = torch.cuda.device_count() if device.type == "cuda" else 0
    if device.type == "cuda":
        kernels.build()                 # once, before the ranks load it
    specs = [dict(sim=dict(SIM, duration=duration, seed=4 + b))
             for b in range(SCALING_SEQUENCES)]
    if cards > 1:
        ranks = [n for n in ranks if n <= cards]
    rows = []
    for n in ranks:
        backend = "nccl" if n <= cards else "gloo"
        with tempfile.TemporaryDirectory(prefix="vio_scaling_") as tmp:
            d = os.path.join(out_dir, f"ranks{n}") if out_dir else tmp
            t0 = time.perf_counter()
            Ranks("vio_msckf_torch.parallel.worker", n, [
                "--out", d, "--device", device.type, "--backend", backend,
                "--replica", n, "--block", 1, "--mode", "filter", "--config", config,
                "--frames", frames, "--reps", reps, "--sequences", json.dumps(specs),
            ]).wait(SCALING_TIMEOUT_S)
            reports = []
            for r in range(n):
                with open(os.path.join(d, f"rank{r}.json")) as f:
                    reports.append(json.load(f))
        captured = [rep["captured"] for rep in reports]
        if captured != [device.type == "cuda"] * n:
            raise RuntimeError(f"{n} ranks without a block group on {device.type}: "
                               f"captured {captured}")
        steps = reports[0]["steps"]
        best = min(max(rep["pass_s"][i] for rep in reports) for i in range(reps))
        per_card = math.ceil(n / cards) if cards else None
        rows.append(dict(devices=n, agg_fps=SCALING_SEQUENCES * steps / best,
                         backend=reports[0]["backend"], ranks_per_card=per_card,
                         captured=captured[0],
                         step_ms=max(rep["step_ms"] for rep in reports),
                         capture_s=max(rep["capture_s"] or 0.0 for rep in reports)))
        shared = (f"{per_card} ranks share each card: not a scaling number"
                  if per_card and per_card > 1 else
                  "ranks share the host's cores" if not cards else "one rank per card")
        r = rows[-1]
        log(f"[scaling] {n} ranks ({r['backend']}; {shared}; "
            f"{'graphed' if r['captured'] else 'eager'}): {r['agg_fps']:.1f} agg fps over "
            f"{steps} frames, {r['step_ms']:.2f} ms a step on the slowest rank (first pass), "
            f"capture {r['capture_s']:.2f} s ({time.perf_counter() - t0:.0f}s with start-up)")

    base = rows[0]["agg_fps"]
    table = [dict(r, speedup=r["agg_fps"] / base, efficiency=r["agg_fps"] / (base * r["devices"]))
             for r in rows]
    where = f"{cards} GPU(s)" if cards else "the CPU"
    print(json.dumps({"metric": f"replica scaling over torch.distributed ranks on {where}, "
                                "PyTorch port (filter step)", "table": table}), flush=True)
    return table


def build_parser():
    ap = argparse.ArgumentParser(prog="python -m vio_msckf_torch.bench",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--suite", action="store_true", help="the five suite cells")
    ap.add_argument("--scaling", action="store_true", help="the replica scaling table")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = setup(args.device)
    if args.scaling:
        run_scaling(device=device)
        return 0

    cfg = euroc_config()
    port = f"PyTorch port, {_where(device)}"
    if not args.suite:
        result = run_single(
            cfg, f"euroc-sized stereo VIO frames/s, {_where(device)}, PyTorch port "
                 "(full image->pose pipeline)", device=device)
        log("ate_rmse_m:", result["ate_rmse_m"])
        print(json.dumps(result), flush=True)
        return 0

    big = cfg.replace(filter=FilterConfig(max_cam_state_size=30))
    results = [
        run_single(cfg, f"suite: MH_01-style default window, {port}", device=device),
        run_single(cfg, f"suite: V1_02-style fast motion, {port}", sim_overrides=FAST_MOTION,
                   device=device),
        run_single(big, f"suite: MH_04/05-style enlarged window (30 clones), {port}",
                   device=device),
        run_single(cfg, f"suite: hostile world (flicker+noise+vignette+occluders), {port}",
                   render_augs=HOSTILE_AUGS, device=device),
        run_batched(cfg, f"suite: {SUITE_BATCH}-sequence batched throughput, {port}",
                    batch=SUITE_BATCH, device=device),
    ]
    for r in results:
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
