"""One-off probe of a process's first replays (not run by the benchmark).

    python3 benchmark/probe_warmup.py --workload <cell> --seed <n> --calls <k> [--every 0.25]

Makes the cell's inputs and program as a run does, then queues k calls of
the traffic's chunk back to back (one call ahead, as the offline window
does) from a fresh carry, a new pass wherever the sequences end, and
prints one JSON line: each call's milliseconds a step (CUDA events), and
nvidia-smi's readings (SM and memory clocks, P-state, power, temperature,
clock event reasons, PCIe link generation and width) sampled every
`--every` seconds meanwhile (0: none), each with its seconds since the
first call was queued. It shows how long a process's
slow start (PERF.md) lasts, and what the card reported during it.
"""

import argparse
import json
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import device as dev_mod, loops, spec  # noqa: E402
from benchmark.run import build_system, make_inputs  # noqa: E402

FIELDS = ("clocks.sm", "clocks.mem", "pstate", "power.draw", "temperature.gpu",
          "pcie.link.gen.current", "pcie.link.width.current", "clocks_event_reasons.active")


def smi_sampler(every, t0, out, stop):
    """Append (seconds since t0, {field: value}) to `out` until `stop`;
    fields this nvidia-smi does not know are dropped from the end."""
    fields = list(FIELDS)
    while not stop.is_set() and fields:
        t = time.perf_counter() - t0
        r = subprocess.run(["nvidia-smi", f"--query-gpu={','.join(fields)}",
                            "--format=csv,noheader"], capture_output=True, text=True)
        if r.returncode != 0:
            fields.pop()
            continue
        line = r.stdout.strip().splitlines()[0] if r.stdout.strip() else ""
        out.append((round(t, 3), dict(zip(fields, (v.strip() for v in line.split(","))))))
        stop.wait(every)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--calls", type=int, required=True)
    ap.add_argument("--every", type=float, default=0.25)
    args = ap.parse_args(argv)
    cell = spec.cell(args.workload)
    dev_mod.require_cuda(cell.chips)
    tr = cell.traffic
    chunk = tr["chunk"]
    T = tr.get("frames", args.calls * chunk)
    seqs, frames = make_inputs(cell, args.seed, T, "cuda")
    system = build_system(cell, "cuda", control=False)
    samples, stop = [], threading.Event()
    queue, stamps = loops._Queue("cuda", 1), loops.Stamps("cuda")
    t0 = time.perf_counter()
    sampler = threading.Thread(target=smi_sampler, args=(args.every, t0, samples, stop))
    if args.every > 0:
        sampler.start()
    marks, k, carry = [stamps.stamp()], T, None
    for _ in range(args.calls):
        if k >= T:
            carry, k = system.fresh(seqs), 0
        n = min(chunk, T - k)
        carry, _ = system.run(carry, {key: v[:, k:k + n] for key, v in frames.items()})
        k += n
        marks.append(stamps.stamp())
        queue.push()
    loops.sync("cuda")
    stop.set()
    if args.every > 0:
        sampler.join()
    ends = [round(stamps.seconds(marks[0], m), 4) for m in marks[1:]]
    ms = [stamps.seconds(a, b) * 1e3 / chunk for a, b in zip(marks, marks[1:])]
    print(json.dumps(dict(workload=args.workload, seed=args.seed, chunk=chunk,
                          ms_per_step=[round(v, 3) for v in ms], call_end_s=ends,
                          smi=samples)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
