"""Logging and profiling helpers. The port's counterpart of
vio_msckf_tpu/utils/logging.py; `maybe_profile` traces with
torch.profiler instead of jax.profiler."""

import contextlib
import logging
import sys
import time


def get_logger(name="vio"):
    logger = logging.getLogger(name)
    if not logger.handlers:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(logging.Formatter(
            "%(asctime)s %(name)s %(levelname)s %(message)s", "%H:%M:%S"
        ))
        logger.addHandler(h)
        logger.setLevel(logging.INFO)
    return logger


@contextlib.contextmanager
def maybe_profile(trace_dir=None):
    """A torch.profiler trace of the block (CPU, and the GPU where there is
    one) written as a Chrome trace into `trace_dir`; a no-op without a
    directory."""
    if not trace_dir:
        yield
        return
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, f"trace_{os.getpid()}.json"))


class StageTimer:
    """Wall-clock per-stage accumulator."""

    def __init__(self):
        self.totals = {}
        self.counts = {}

    @contextlib.contextmanager
    def stage(self, name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self):
        lines = []
        for name, tot in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(
                f"{name:>24s}: total {tot:8.3f}s  n={n:<6d} "
                f"avg {1e3 * tot / max(n, 1):8.3f}ms"
            )
        return "\n".join(lines)
