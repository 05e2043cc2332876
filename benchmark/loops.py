"""The two loops that drive a pipeline (systems.py) through a measured
window, and what they record for the metrics and the check.

offline: a closed loop. B sequences sit on the device; they advance in
  lockstep, `chunk` frames a call of the timed entry, through passes of
  the whole sequence, each pass from a fresh carry built inside the
  window. The host keeps one call queued ahead of the device and stops
  queueing once the clock passes the window's length; the window ends
  when the device has finished what was queued. agg_fps = every frame
  of every sequence posed / the window's seconds. Each whole pass's
  rate is recorded beside it (device events at the pass's ends).

live: an open loop at the configuration's frame rate per stream. Each stream's camera frames
  (uint8) and IMU bundles sit in pinned host memory, time-major. Tick k
  is due at t0 + k / rate; at its due time (or at once, if the previous
  tick ran late) the loop uploads that tick's frames of every stream,
  calls the timed entry on one frame and fetches the poses to the host.
  A frame's latency runs from its due time to its pose being on the host.
"""

import collections
import contextlib
import time

import torch

# Host spans the loops record (torch.profiler ranges; the traced run
# names the device's idle gaps by them).
SPAN = "bench::"


def span(name):
    return torch.profiler.record_function(SPAN + name)


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Stamps:
    """Points in time on the device's stream (CUDA events; the host's clock
    on the CPU, where every call is synchronous), read once it is synced."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.marks = []

    def stamp(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())
        return len(self.marks) - 1

    def seconds(self, i, j):
        a, b = self.marks[i], self.marks[j]
        return a.elapsed_time(b) / 1e3 if self.cuda else b - a


class _Queue:
    """At most `depth` calls in flight: a CUDA event per call (nothing on
    the CPU)."""

    def __init__(self, device, depth):
        self.cuda = torch.device(device).type == "cuda"
        self.depth = depth
        self.events = collections.deque()

    def push(self):
        if not self.cuda:
            return
        ev = torch.cuda.Event()
        ev.record()
        self.events.append(ev)
        while len(self.events) > self.depth:
            with span("wait"):
                self.events.popleft().synchronize()


def offline(system, seqs, frames, seconds, chunk, device):
    """The offline window. frames: {key: (B, T, ...)} on the device.
    Returns dict(seconds, frames (sequence-frames posed), records,
    pass_fps): one record per call, with its pass, first frame k0, frame
    count n, the carry it started from and its outputs; pass_fps, the
    sequence-frames a second of each pass the window holds whole."""
    B, T = frames["imu_dt"].shape[:2]
    queue = _Queue(device, 1)
    stamps = Stamps(device)
    records, passes = [], []
    carry, k, n_pass = None, T, -1
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while True:
        if k >= T:
            start = stamps.stamp()
            with span("carry_init"):
                carry = system.fresh(seqs)
            k, n_pass = 0, n_pass + 1
        n = min(chunk, T - k)
        with span("replay"):
            new, outs = system.run(carry, {key: v[:, k:k + n] for key, v in frames.items()})
        records.append(dict(pass_=n_pass, k0=k, n=n, outs=outs, carry_in=carry))
        carry, k = new, k + n
        if k >= T:
            passes.append((start, stamps.stamp()))
        queue.push()
        if time.perf_counter() >= deadline:
            break
    sync(device)
    elapsed = time.perf_counter() - t0
    return dict(seconds=elapsed, frames=B * sum(r["n"] for r in records), records=records,
                pass_fps=[B * T / stamps.seconds(a, b) for a, b in passes])


def warm_up(system, seqs, frames, n, chunk, device):
    """n frames of frames ({key: (B, T, ...)} on the device) in calls of
    `chunk`, queued back to back, from a fresh carry. The first call
    captures the step; the rest settle it: a process's first seconds of
    replays can run ~20 % slower than what follows (PERF.md). Returns each
    call's milliseconds a step, the first with its capture; the last
    shows which speed the window starts at."""
    stamps = Stamps(device)
    carry = system.fresh(seqs)
    marks = [stamps.stamp()]
    for k in range(0, n, chunk):
        carry, _ = system.run(carry, {key: v[:, k:k + chunk] for key, v in frames.items()})
        marks.append(stamps.stamp())
    sync(device)
    steps = [min(chunk, n - k) for k in range(0, n, chunk)]
    return [stamps.seconds(a, b) * 1e3 / s for a, b, s in zip(marks, marks[1:], steps)]


def wait_until(t):
    """Sleep to about a millisecond before t, then spin to it."""
    while True:
        left = t - time.perf_counter()
        if left <= 0:
            return
        if left > 2e-3:
            time.sleep(left - 1e-3)


def live(system, seqs, host, device, n_ticks, rate_hz, first=0, carry=None,
         keep=(), lead_s=0.05):
    """n_ticks ticks of the open loop, on frames first.. of `host` ({key:
    (T, B, ...)} pinned), from `carry` (a fresh one if None). Ticks in
    `keep` record the carry they start from. Returns dict(latency_s,
    late_s, poses (n_ticks, B, k) on the host, carries {tick: carry},
    carry (the last), seconds: first due time to the last pose)."""
    period = 1.0 / rate_hz
    if carry is None:
        with span("carry_init"):
            carry = system.fresh(seqs)
    keep = set(keep)
    lat, late, poses, carries = [], [], [], {}
    t0 = time.perf_counter() + lead_s
    for k in range(n_ticks):
        due = t0 + k * period
        with span("idle"):
            wait_until(due)
        start = time.perf_counter()
        with span("upload"):
            frame = {key: v[first + k].to(device, non_blocking=True).unsqueeze(1)
                     for key, v in host.items()}
        if k in keep:
            carries[k] = carry
        with span("replay"):
            carry, outs = system.run(carry, frame)
        with span("fetch"):
            pose = system.pose(outs)[:, 0].cpu()
        done = time.perf_counter()
        lat.append(done - due)
        late.append(start - due)
        poses.append(pose)
    return dict(latency_s=lat, late_s=late, poses=torch.stack(poses), carries=carries,
                carry=carry, seconds=time.perf_counter() - t0)


@contextlib.contextmanager
def spans_around(system):
    """Wrap each of the system's layer entries (systems.py `spans`) in a
    host span `bench::<layer>` for the duration of the block."""
    saved = []
    for name, (obj, attr) in system.spans.items():
        orig = getattr(obj, attr)
        had = attr in getattr(obj, "__dict__", {})

        def wrapped(*a, _orig=orig, _name=name, **kw):
            with span(_name):
                return _orig(*a, **kw)

        setattr(obj, attr, wrapped)
        saved.append((obj, attr, orig, had))
    try:
        yield
    finally:
        for obj, attr, orig, had in reversed(saved):
            if had:
                setattr(obj, attr, orig)
            else:
                delattr(obj, attr)
