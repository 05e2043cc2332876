"""One rank of a multi-process run of the sharded filter or engine.

    python -m vio_msckf_torch.parallel.worker --rank r --nprocs n \
        --coordinator host:port --out DIR --replica R --block NB \
        [--block-across-processes] [--mode filter|engine] [--config tiny|euroc] \
        [--filter-config JSON] \
        [--device cuda|cpu] [--backend gloo|nccl] [--frames T] [--reps N] \
        [--eager] [--profile] --sequences JSON

The port's multi-process entry point, in the role the JAX package gives
tests/distributed_worker.py. Every rank joins the process group through
the VIO_* protocol (distributed.py), lays the ranks out as an R x NB mesh
and steps its replica's rows of the batch, T frames. The batch is one
sequence per entry of --sequences, a JSON list of {"sim": SimConfig
fields, "hostile": bool}, simulated by data/simulator.py:

  filter  its feature tracks, through the sharded MSCKF (T = 0: every
          frame of the shortest sequence);
  engine  its stereo frames rendered on the rank's device (the bench's
          textured world, BENCH_WORLD; the hostile one where "hostile"),
          through the sharded engine.

The frames go through the model's runner (`compiled.run`, graph.py): on
a card under NCCL the step is captured as a CUDA graph at the first frame
(the eager warm-up frame, which also makes the group's communicator,
then the capture) and replayed per frame, its collectives inside; under
gloo, and on the CPU, it steps eagerly.

It writes DIR/rank<r>.npz (rows: the batch rows it holds, p: their
positions (rows, T, 3); with --eager also p_eager, the same frames
through the eager step from a fresh carry) and DIR/rank<r>.json: its
place in the mesh, the backend, whether the step was captured and the
capture's seconds, ms a step after the first (and eager_step_ms with
--eager), host copies staged for gloo per step (comm.STAGED) and, on a
CUDA device, the launches of each hand kernel per call shape in the first
pass, so that a parent can merge them. With --reps N the rank then steps
the T frames N more times, each pass from a fresh carry, after a barrier
that starts every rank's pass together, and ending on the device;
`pass_s` holds each pass's seconds (bench.py --scaling takes the slowest
rank's). With --profile (a captured step on a card) every rank profiles
one replay of its graph together (`replay`: tools.profile_ops.
replay_profile, with host syncs, host launch calls, device kernels and
time, NCCL's kernels and their device time, the hand kernels' launches
in the trace held to the runner's counts, and a replay's ms without the
profiler). A mesh of one block column (NB = 1) gives the filter no
block group: replicas only, no collective in the step. Build the kernels
once (kernels.build) before starting ranks on a card.
"""

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from vio_msckf_torch import comm, kernels
from vio_msckf_torch.config import euroc_config
from vio_msckf_torch.data.simulator import SimConfig, bundle_frames, simulate_sequence
from vio_msckf_torch.parallel.distributed import (
    collect_local_outputs, in_group, local_rows, make_global_batch, make_global_mesh, start_rank)
from vio_msckf_torch.parallel.multichip import (
    make_multichip_engine_step, make_multichip_filter_step, tiny_config)
from vio_msckf_torch.tools.profile_ops import replay_profile

IMU_KEYS = ("imu_gyro", "imu_acc", "imu_dt", "imu_valid")
REPLAYS = 10                   # --profile: replays timed without the profiler


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--nprocs", type=int, required=True)
    ap.add_argument("--coordinator", required=True, help="host:port of rank 0")
    ap.add_argument("--out", required=True)
    ap.add_argument("--replica", type=int, required=True)
    ap.add_argument("--block", type=int, required=True)
    ap.add_argument("--block-across-processes", action="store_true")
    ap.add_argument("--mode", choices=("filter", "engine"), default="filter")
    ap.add_argument("--config", choices=("tiny", "euroc"), default="euroc")
    ap.add_argument("--filter-config", default="{}",
                    help="JSON of FilterConfig fields to replace in the config")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default=None, help="gloo or nccl (default: by device)")
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--reps", type=int, default=0,
                    help="timed passes over the frames after the first")
    ap.add_argument("--eager", action="store_true",
                    help="also step the frames through the eager step (p_eager)")
    ap.add_argument("--profile", action="store_true",
                    help="profile one replay of the captured step on every rank")
    ap.add_argument("--sequences", required=True,
                    help='JSON list of {"sim": {SimConfig fields}, "hostile": bool}')
    return ap


def config(args):
    """The run's VIOConfig: --config with the --filter-config fields."""
    cfg = tiny_config() if args.config == "tiny" else euroc_config()
    return cfg.replace(filter=dataclasses.replace(cfg.filter, **json.loads(args.filter_config)))


def filter_batch(cfg, args):
    """The filter's frames (B, T, ...) as numpy arrays and the inits of
    every simulated sequence, T = --frames (at most the shortest's)."""
    seqs = [bundle_frames(simulate_sequence(cfg, SimConfig(**spec["sim"])), cfg)
            for spec in json.loads(args.sequences)]
    lengths = [len(f["imu_dt"]) for f, _, _ in seqs]
    T = min(lengths) if args.frames <= 0 else min(args.frames, *lengths)
    keys = IMU_KEYS + ("feat_ids", "feat_obs", "feat_valid")
    frames = {k: np.stack([f[k][:T] for f, _, _ in seqs]) for k in keys}
    return frames, [init for _, init, _ in seqs], T


def engine_batch(cfg, args, rows, device):
    """Rendered stereo frames (rows, T, ...) on `device` and the inits of
    the sequences this rank holds; the others are not rendered."""
    from vio_msckf_torch.data.render import BENCH_WORLD, HOSTILE_AUGS, render_sequence

    specs = json.loads(args.sequences)
    T = args.frames
    frames, inits = {k: [] for k in ("cam0_img", "cam1_img") + IMU_KEYS}, []
    for b in rows:
        seq = simulate_sequence(cfg, SimConfig(**specs[b]["sim"]))
        f, init, first = bundle_frames(seq, cfg)
        R = seq["gt_R_i_w"][first:first + T].transpose(0, 2, 1)
        cam0, cam1 = render_sequence(
            cfg, R, seq["gt_p"][first:first + T], device=device,
            augs=HOSTILE_AUGS if specs[b].get("hostile") else None, **BENCH_WORLD)
        frames["cam0_img"].append(cam0)
        frames["cam1_img"].append(cam1)
        for k in IMU_KEYS:
            frames[k].append(torch.as_tensor(f[k][:T], device=device))
        inits.append(init)
    return {k: torch.stack(v) for k, v in frames.items()}, inits, T


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def barrier(device, group=None):
    """dist.barrier over `group` (None: every rank), on this rank's card
    under NCCL."""
    on_card = device.type == "cuda" and dist.get_backend(group) == "nccl"
    dist.barrier(group=group, device_ids=[device.index] if on_card else None)


def timed_pass(run, carry, T, device):
    """Seconds of one pass of run(carry, 0, T), started with every rank
    after a barrier and ended on the device."""
    barrier(device)
    _sync(device)
    t0 = time.perf_counter()
    run(carry, 0, T)
    _sync(device)
    return time.perf_counter() - t0


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = start_rank(args.rank, args.nprocs, args.coordinator, args.device,
                        args.backend or None)
    with in_group():
        cfg = config(args)
        mesh = make_global_mesh(args.replica, args.block, args.block_across_processes)
        n_rows = len(json.loads(args.sequences))
        rows = local_rows(mesh, n_rows)
        if args.mode == "filter":
            frames_np, inits, T = filter_batch(cfg, args)
            frames = make_global_batch(mesh, frames_np, device)
            inits = [inits[b] for b in rows]
            _, model = make_multichip_filter_step(cfg, mesh, args.block > 1, device)
        else:
            frames, inits, T = engine_batch(cfg, args, rows, device)
            _, model = make_multichip_engine_step(cfg, mesh, args.block > 1, device)
        eager = model.compiled.fn          # MSCKF.step or VIOEngine.step_batch

        def run(carry, lo, hi):
            return model.compiled.run(carry, {k: v[:, lo:hi] for k, v in frames.items()},
                                      axis=1)

        for fn in kernels.counters().values():
            fn.by_shape.clear()
        comm.STAGED.clear()
        # The first frame alone (warm-up and capture, or an eager step),
        # then the others: a step's ms is the rest's.
        carry, out0 = run(model.init_batch(inits), 0, 1)
        _sync(device)
        t1 = time.perf_counter()
        carry, outs = run(carry, 1, T)
        p = torch.cat([out0.p, outs.p], dim=1)
        _sync(device)
        seconds = time.perf_counter() - t1
        staged = {k: v / T for k, v in comm.STAGED.items()}
        launches = kernels.launch_counts() if device.type == "cuda" else None
        held = collect_local_outputs(mesh, p, n_rows)
        graphs = list(model.compiled.graphs.values())
        report = dict(captured=bool(graphs), capture_s=graphs[0].capture_s if graphs else None)
        if args.eager:
            carry, ps = model.init_batch(inits), []
            _sync(device)
            t0 = time.perf_counter()
            for k in range(T):
                carry, out = eager(carry, {key: v[:, k] for key, v in frames.items()})
                ps.append(out.p)
            _sync(device)
            report["eager_step_ms"] = (time.perf_counter() - t0) / T * 1e3
            held_eager = collect_local_outputs(mesh, torch.stack(ps, dim=1), n_rows)
        passes = [timed_pass(run, model.init_batch(inits), T, device) for _ in range(args.reps)]
        if args.profile:
            if not graphs:
                raise SystemExit("--profile needs a captured step (a card, no gloo group)")
            # The ranks that replay together (a block group) start the timed
            # replays together.
            group = model.compiled.group
            report["replay"] = replay_profile(
                graphs[0], {k: v[:, T // 2] for k, v in frames.items()}, REPLAYS,
                None if group is None else lambda: barrier(device, group))
        backend = dist.get_backend()
        # NCCL's shutdown waits for the graphs that hold its collectives:
        # free them first.
        del graphs
        model.compiled.clear()
    os.makedirs(args.out, exist_ok=True)
    np.savez(os.path.join(args.out, f"rank{args.rank}.npz"),
             rows=np.asarray([b for b, _ in held]), p=np.stack([p for _, p in held]),
             **(dict(p_eager=np.stack([p for _, p in held_eager])) if args.eager else {}))
    report.update(rank=args.rank, replica=mesh.replica, block=mesh.block, backend=backend,
                  device=str(device), steps=T, step_ms=seconds / max(T - 1, 1) * 1e3,
                  pass_s=passes, staged_per_step=staged, launches=launches)
    with open(os.path.join(args.out, f"rank{args.rank}.json"), "w") as f:
        json.dump(report, f)
    print(f"rank {args.rank}: replica {mesh.replica} block {mesh.block}, rows {rows}, "
          f"{T} frames", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
