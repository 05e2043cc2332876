"""Aggregate throughput over the batch: B bench sequences a step, one GPU.

    python -m vio_msckf_torch.tools.batch_sweep [--batches 1,2,4,8,16]
        [--reps 3] [--json out.json]

The counterpart of scripts/batch_sweep.py. B sequences (seeds 4..4+B-1,
the bench's motion, a 6 s workload each to keep the frames of B = 16 in a
few GB) advance in lockstep through VIOEngine.run_batch, which replays
one CUDA graph of the step (captured in the first pass; one graph at a
time, dropped before the next B), one launch of each hand kernel a step
for all of them. Per B, by the bench's rule (bench.measure_batch): a
first, untimed pass and its worst ATE (the run fails above bench.py's
0.5 m), then the best of `--reps` passes, each from a fresh carry and
ending in synchronize: ms a step, aggregate and per-sequence frames/s,
the aggregate over B = 1's, the capture's seconds, and each hand
kernel's launches by call shape over the B's passes; the run fails unless
those call shapes are call_shapes(cfg, B), the shapes chip_smoke.py holds
against the twins. Without a CUDA device it raises: its numbers are device
numbers. One JSON line per B on stdout, then one line with the card and
every row.
"""

import argparse
import json
import sys

import numpy as np

from vio_msckf_torch import bench, kernels
from vio_msckf_torch.config import euroc_config
from vio_msckf_torch.engine import VIOEngine
from vio_msckf_torch.tools import card

DURATION = 6.0


def call_shapes(cfg, B):
    """{kernel: set of call-shape keys} that a step of B sequences launches
    (the wrappers' by_shape keys): FAST on cam0 at the tracker's threshold;
    LK temporal (P = the track slots), stereo (the slots and the new
    detections) and verify (both, level 0); the SPD gate on the lost
    candidates (4 rows a clone) and on the prune's 2-clone systems."""
    fe, fc = cfg.frontend, cfg.filter
    W, H = cfg.cam0.resolution
    T, S = fe.max_tracks, fe.max_tracks + cfg.grid_num * fe.grid_max_feature_num
    return {"fast_nms": {(B, H, W, fe.fast_threshold)},
            "lk_pyramid": {(B, T, T), (B, S, S), (B, T + S, T)},
            "spd_gj": {(B * min(fc.max_lost_candidates, fc.max_features),
                        4 * fc.max_cam_state_size, 4), (B * fc.max_features, 8, 4)}}


def build_parser():
    ap = argparse.ArgumentParser(prog="python -m vio_msckf_torch.tools.batch_sweep",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--json", default=None)
    ap.add_argument("--batches", default="1,2,4,8,16")
    ap.add_argument("--reps", type=int, default=3)
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = bench.setup("cuda")
    where = card()
    cfg = euroc_config()
    eng = VIOEngine(cfg, device)
    batches = [int(b) for b in args.batches.split(",")]
    workloads = [bench.build_workload(cfg, dict(seed=4 + b), duration=DURATION, device=device)
                 for b in range(max(batches))]

    rows = []
    for B in batches:
        frames, inits, gts, n = bench.stack_workloads(workloads[:B])
        for c in kernels.counters().values():
            c.by_shape.clear()
        best, ates, _, first_s = bench.measure_batch(eng, frames, inits, gts, args.reps,
                                                     device, f"B={B}")
        launches = kernels.launch_counts()
        for name, want in call_shapes(cfg, B).items():
            got = {tuple(k) for k, _ in launches[name]}
            if got != want:
                raise RuntimeError(f"{name} at B={B} launched call shapes {sorted(got)}, "
                                   f"not call_shapes' {sorted(want)}")
        row = dict(batch=B, frames=n, ms_per_step=best / n * 1e3, agg_fps=B * n / best,
                   per_seq_fps=n / best, first_s=first_s, worst_ate_m=float(np.max(ates)),
                   capture_s=next(iter(eng.compiled.graphs.values())).capture_s,
                   launches=launches)
        rows.append(row)
        print(json.dumps(row), flush=True)
        # This B's graph and its memory pool go before the next B captures.
        eng.compiled.clear()
        del frames

    for r in rows:
        r["agg_vs_B1"] = r["agg_fps"] / rows[0]["agg_fps"]
    print(json.dumps(dict(card=where, rows=rows)), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(dict(card=where, rows=rows), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
