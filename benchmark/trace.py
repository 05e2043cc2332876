"""Reading torch.profiler's trace of a short traced window: device time,
the host's launch calls, device time under the benchmark's own host spans,
the hand kernels' time, and the idle gaps named by what the host was
doing. Used only by `--trace 1` runs, after the measured window.
"""

import bisect
import collections

import torch

from benchmark.loops import SPAN

# The host's calls that put work on the device: kernels, graphs, copies
# (runtime and driver API names; the device's own copy records, e.g.
# "Memcpy DtoD", are not host calls). tools/profile_ops.py's rule.
LAUNCH_APIS = ("LaunchKernel", "GraphLaunch", "Memcpy")
TRACED = SPAN + "traced"


def profiled(fn):
    """Run fn() under torch.profiler (CPU and CUDA activities) inside the
    host span bench::traced; returns the profiler's event list."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function(TRACED):
            fn()
        torch.cuda.synchronize()
    return prof.events()


def _on_device(e):
    return (str(getattr(e, "device_type", "")).endswith("CUDA")
            and not e.name.startswith(SPAN)
            and not getattr(e, "is_user_annotation", False))


def _host_span(e):
    """A benchmark span on the host (record_function also leaves a copy of
    each span on the device's timeline, which is not a host span)."""
    return e.name.startswith(SPAN) and str(getattr(e, "device_type", "")).endswith("CPU")


def _interval(e):
    return e.time_range.start, e.time_range.end


def _union(intervals):
    """Sorted, merged intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def summary(events, span_names=()):
    """What the metric readers take from one traced window's events:

      window_s       the bench::traced span's length
      busy_s         union of the device operations' intervals in it
      device_s       sum of the device operations' durations
      ops            {device operation name: seconds}
      host_calls     host API calls that put work on the device
      span_device_s  {span: device seconds of the operations launched
                     while its host span was open}
      gaps           {host span at the gap: seconds the device was idle}
    """
    traced = [e for e in events if e.name == TRACED and _host_span(e)]
    if not traced:
        raise RuntimeError("the traced window's span is missing from the trace")
    w0, w1 = _interval(traced[0])
    dev = [e for e in events if _on_device(e)]
    ops = collections.Counter()
    for e in dev:
        ops[e.name] += (e.time_range.end - e.time_range.start) / 1e6
    merged = _union([[max(a, w0), min(b, w1)] for a, b in map(_interval, dev) if b > w0 and a < w1])
    busy_us = sum(b - a for a, b in merged)
    host_calls = sum(1 for e in events if not _on_device(e) and e.name.startswith("cu")
                     and any(a in e.name for a in LAUNCH_APIS))

    # A span's device time: the device operations whose launch (a runtime
    # or driver API call, matched by CUPTI correlation id) started inside
    # the span on the host, graph launches included.
    by_corr = collections.Counter()
    for e in dev:
        by_corr[e.id] += (e.time_range.end - e.time_range.start) / 1e6
    # One launch time per correlation id (a launch may show as a runtime
    # and a driver call: each id counts once).
    first = {}
    for e in events:
        if not _on_device(e) and e.name.startswith("cu") and e.id in by_corr:
            first[e.id] = min(first.get(e.id, e.time_range.start), e.time_range.start)
    launches = sorted((t, c) for c, t in first.items())
    starts = [t for t, _ in launches]
    spans = {}
    for e in events:
        name = e.name[len(SPAN):]
        if _host_span(e) and name in span_names:
            a, b = _interval(e)
            lo, hi = bisect.bisect_left(starts, a), bisect.bisect_right(starts, b)
            spans[name] = spans.get(name, 0.0) + sum(by_corr[c] for _, c in launches[lo:hi])

    host = sorted((_interval(e) + (e.name[len(SPAN):],) for e in events
                   if _host_span(e) and e.name != TRACED),
                  key=lambda x: x[0])
    gaps = collections.Counter()
    edges = [w0] + [x for ab in merged for x in ab] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        inner = [h for h in host if h[0] <= mid <= h[1]]
        # the innermost span: the one that started last
        gaps[inner[-1][2] if inner else "other"] += (b - a) / 1e6
    return dict(window_s=(w1 - w0) / 1e6, busy_s=busy_us / 1e6,
                device_s=sum(ops.values()), ops=dict(ops), host_calls=host_calls,
                span_device_s=spans, gaps=dict(gaps))


def top(d, n=10):
    """[[name, value], ...] of the n largest values of d."""
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]
