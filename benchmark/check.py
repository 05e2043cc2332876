"""How `correct` is decided: the program's poses from the measured window
against the plain reference (benchmark/reference) on the same inputs.

The reference steps eagerly with the plain twins, some 10-100 times
slower than the program's replayed graph, so it cannot re-run a whole
window in a run's time. It checks a sample of the window's answers, drawn
from the seed, in spans of consecutive frames of every sequence:

  * the start: the program's fresh carry against the reference's own,
    leaf by leaf (`start_gap`, exact);
  * the first span: frames 0.. of the first pass (live: the first ticks),
    the reference from its own fresh carry, so no state of the program
    enters it;
  * `spans` more spans at calls (live: ticks) drawn from the seed, the
    reference following the program from the carry the program started
    that call from (systems.to_reference), as far as `span_frames`.

`pos_gap_m` is the largest distance, over every frame of every span and
every sequence, between the program's position and the reference's. Each
number is held to its limit in benchmark/limits/<cell>.json; a number
that is not finite fails.
"""

import numpy as np
import torch

from benchmark import systems, traffic as gen
from benchmark.reference import set_precision


def _rng(seed, salt):
    return np.random.default_rng([gen.seed_entropy(seed), salt])


def live_keep(seed, chk, n_ticks):
    """The ticks whose starting carry the live window keeps: 0 and the
    sampled spans' first ticks."""
    L0, L = chk["first_frames"], chk["span_frames"]
    pool = np.arange(L0, max(L0, n_ticks - L + 1))
    n = min(chk["spans"], len(pool))
    starts = sorted(int(t) for t in _rng(seed, 11).choice(pool, size=n, replace=False))
    return [0] + starts


def offline_spans(records, seed, chk):
    """(record index, own?, frames) of the spans an offline window is
    checked on: the first call's first frames, then `spans` calls drawn
    from the rest."""
    out = [(0, True, min(chk["first_frames"], records[0]["n"]))]
    pool = np.arange(1, len(records))
    n = min(chk["spans"], len(pool))
    for i in sorted(int(i) for i in _rng(seed, 13).choice(pool, size=n, replace=False)):
        out.append((i, False, min(chk["span_frames"], records[i]["n"])))
    return out


def offline_evidence(system, records, seed, chk):
    """What the check needs of an offline window, taken before the
    program's state is freed: the start carry and, per span, the
    reference's starting carry (None: its own), the frames and the
    program's positions (B, L, 3) on the host."""
    spans = []
    for i, own, L in offline_spans(records, seed, chk):
        r = records[i]
        spans.append(dict(
            carry=None if own else systems.to_reference(r["carry_in"]),
            k0=r["k0"], n=L,
            positions=system.positions(r["outs"])[:, :L].double().cpu().numpy()))
    return dict(start=systems.to_reference(records[0]["carry_in"]), spans=spans)


def live_evidence(window, keep, chk):
    """The same for a live window (keep: live_keep's ticks)."""
    L0, L = chk["first_frames"], chk["span_frames"]
    poses = window["poses"].double().numpy()                 # (n_ticks, B, k)
    spans = [dict(carry=None, k0=0, n=L0, positions=poses[:L0, :, :3].transpose(1, 0, 2))]
    for t in keep[1:]:
        spans.append(dict(carry=systems.to_reference(window["carries"][t]), k0=t, n=L,
                          positions=poses[t:t + L, :, :3].transpose(1, 0, 2)))
    return dict(start=systems.to_reference(window["carries"][0]), spans=spans)


def gap(a, b):
    """Largest Euclidean distance between two (B, L, 3) position arrays;
    inf where either is not finite."""
    d = np.linalg.norm(np.asarray(a, np.float64) - np.asarray(b, np.float64), axis=-1)
    return float(np.nan_to_num(d.max(), nan=np.inf)) if d.size else float("inf")


def run_reference(doc, seqs, evidence, frames_at, device):
    """The reference over every span of the evidence. frames_at(k0, n) ->
    {key: (B, n, ...)} on `device`: the inputs the program was given.
    Returns {number: value}."""
    set_precision(False)
    ref = systems.build(doc, device, systems.REFERENCE)
    own = ref.fresh(seqs)
    start_gap = systems.max_abs_gap(evidence["start"], own)
    worst = 0.0
    for s in evidence["spans"]:
        carry = own if s["carry"] is None else s["carry"]
        _, outs = ref.run(carry, frames_at(s["k0"], s["n"]))
        got = ref.positions(outs).double().cpu().numpy()
        worst = max(worst, gap(s["positions"], got))
    del ref
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    return dict(start_gap=start_gap, pos_gap_m=worst)


def judge(numbers, limits):
    """{number: {"value", "limit"}} and whether every value is within its
    limit (a value that is not finite never is)."""
    checks = {k: dict(value=float(v), limit=float(limits[k])) for k, v in numbers.items()}
    ok = all(np.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    return checks, ok
