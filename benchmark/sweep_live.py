"""One-off sweep for the live cell's stream count (not run by the benchmark).

    python3 benchmark/sweep_live.py [--traffic live_20hz] [--config msckf_euroc]
        [--streams 2,3,4,5,6] [--seconds 10] [--seed 1]

Runs the live loop of the traffic file at the configuration's frame rate
for each stream count N, on N distinct sequences from the seed (the first
N of the largest count), each N after its own warm-up (the cell's), and
prints one JSON line per N:
the p50 / p95 / max latency, the generator's lateness (p95, and its
mean over the first and the last fifth of the ticks: a backlog that
grows shows as the last above the first), and whether the backlog grew.
The knee is the most streams with no growing backlog; the cell runs four
fifths of it, rounded down.
"""

import argparse
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import device as dev_mod, loops, spec  # noqa: E402
from benchmark.run import build_system, frame_rate, log, make_inputs, p95, to_host  # noqa: E402


def backlog_grows(late_s, period):
    """A backlog grows when the last fifth of the ticks starts later than
    the first fifth by more than a tenth of a period."""
    n = max(1, len(late_s) // 5)
    return float(np.mean(late_s[-n:]) - np.mean(late_s[:n])) > 0.1 * period


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--traffic", default="live_20hz")
    ap.add_argument("--config", default="msckf_euroc")
    ap.add_argument("--streams", default="2,3,4,5,6")
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    dev_mod.require_cuda(1)
    counts = [int(n) for n in args.streams.split(",")]
    doc = spec.benchmark_doc()
    conf = [c for c in doc["configs"] if c["name"] == args.config][0]
    tr = spec.load_json(spec.HERE / "traffic" / f"{args.traffic}.json")
    cell = spec.Cell(name="sweep", chips=1, config=spec.load_json(ROOT / conf["file"]),
                     traffic=dict(tr, streams=max(counts)), limits={}, end_to_end=[],
                     per_layer=[])
    rate = frame_rate(cell)
    n_ticks = int(round(args.seconds * rate))
    seqs, frames = make_inputs(cell, args.seed, max(n_ticks, tr["warmup_frames"]), "cuda")
    host = to_host(frames, "cuda")
    del frames
    print(json.dumps(dict(card=dev_mod.smi())), flush=True)
    for n in counts:
        system = build_system(cell, "cuda", control=False)
        sub = {k: v[:, :n] for k, v in host.items()}
        sub = {k: v.contiguous().pin_memory() for k, v in sub.items()}
        warm = {k: v[:tr["warmup_frames"]].transpose(0, 1).to("cuda") for k, v in sub.items()}
        loops.warm_up(system, seqs[:n], warm, tr["warmup_frames"], tr["chunk"], "cuda")
        w = loops.live(system, seqs[:n], sub, "cuda", n_ticks, rate)
        lat, late = np.asarray(w["latency_s"]), np.asarray(w["late_s"])
        k = max(1, n_ticks // 5)
        row = dict(streams=n, ticks=n_ticks, rate_hz=rate,
                   latency_p50_ms=float(np.median(lat)) * 1e3, latency_p95_ms=p95(lat) * 1e3,
                   latency_max_ms=float(lat.max()) * 1e3, late_p95_ms=p95(late) * 1e3,
                   late_first_ms=float(late[:k].mean()) * 1e3,
                   late_last_ms=float(late[-k:].mean()) * 1e3,
                   backlog_grows=backlog_grows(late, 1.0 / rate))
        print(json.dumps(row), flush=True)
        log(f"[sweep] {row}")
        del system, w, warm
    return 0


if __name__ == "__main__":
    sys.exit(main())
