"""The metric arithmetic on synthetic inputs: a rate over the whole
window, a p95 over every tick (a stall delays the ticks after it), the
idle share, the trace's busy time, host calls and named idle gaps, and
the roofline counts from call shapes."""

import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark import loops, roofline, spec, trace
from benchmark.run import p95


class Sleepy:
    """A system whose timed entry sleeps a fixed time per call (or per
    frame), ignoring the device; poses are the frame index."""

    def __init__(self, per_call=0.0, stall=None):
        self.per_call, self.stall, self.calls, self.inits = per_call, stall or {}, 0, 0

    def fresh(self, seqs):
        self.inits += 1
        return torch.zeros(len(seqs))

    def run(self, carry, frames):
        time.sleep(self.per_call + self.stall.get(self.calls, 0.0))
        self.calls += 1
        B, T = frames["imu_dt"].shape[:2]
        return carry + T, dict(p=torch.zeros(B, T, 3))

    @staticmethod
    def pose(outs):
        return outs["p"]


def test_offline_rate_is_all_the_work_over_all_the_time():
    B, T = 3, 10
    frames = {"imu_dt": torch.zeros(B, T)}
    sys_ = Sleepy(per_call=0.02)
    w = loops.offline(sys_, [{}] * B, frames, 0.15, 4, "cpu")
    calls = len(w["records"])
    assert calls == sys_.calls and calls >= 7
    assert w["frames"] == B * sum(r["n"] for r in w["records"])
    assert w["seconds"] >= 0.15 and w["seconds"] >= calls * 0.02
    # passes restart from a fresh carry: 10 frames = calls of 4, 4, 2
    assert [r["n"] for r in w["records"][:4]] == [4, 4, 2, 4]
    assert [r["k0"] for r in w["records"][:4]] == [0, 4, 8, 0]
    assert sys_.inits == w["records"][-1]["pass_"] + 1


def test_live_latency_counts_from_the_due_time():
    B = 2
    host = {"imu_dt": torch.zeros(40, B)}
    # tick 5 takes 3 periods: ticks 6.. start late, and their latency counts it
    sys_ = Sleepy(per_call=0.001, stall={5: 0.15})
    w = loops.live(sys_, [{}] * B, host, "cpu", 20, 20.0)
    lat, late = np.asarray(w["latency_s"]), np.asarray(w["late_s"])
    assert len(lat) == 20 and w["poses"].shape == (20, B, 3)
    assert lat[5] >= 0.15 and late[6] >= 0.09 and late[7] >= 0.04
    assert (late[:5] < 0.02).all() and (late[15:] < 0.02).all()
    assert p95(lat) == pytest.approx(float(np.percentile(lat, 95)))


def test_readers_on_a_synthetic_context():
    def read(name, ctx):
        return spec.metric_reader(name)(ctx)

    ctx = dict(steps=5, wall_s=0.5, steady=dict(busy_s=0.4, host_calls=150),
               eager=dict(frontend=0.003, filter=0.012), least_s=1e-4, hand_s=4e-4,
               late_s=[0.001] * 19 + [0.021])
    assert read("device_idle_share.fps", ctx) == pytest.approx(20.0)
    assert read("host_calls_per_step.fps", ctx) == pytest.approx(30.0)
    assert read("frontend_device_ms.fps", ctx) == pytest.approx(3.0)
    assert read("filter_device_ms.latency", ctx) == pytest.approx(12.0)
    assert read("hand_kernels_roofline.fps", ctx) == pytest.approx(25.0)
    assert read("submit_late_ms_p95.latency", ctx) == pytest.approx(
        float(np.percentile(ctx["late_s"], 95)) * 1e3)
    # nothing to read: no value, never a 0
    assert read("eskf_filter_device_ms.fps", ctx) is None
    assert read("hand_kernels_roofline.fps", dict(ctx, hand_s=0.0)) is None
    assert read("submit_late_ms_p95.latency", dict(ctx, late_s=[])) is None


def _ev(name, a, b, device=False, corr=0):
    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=a, end=b), id=corr,
                           device_type="DeviceType.CUDA" if device else "DeviceType.CPU",
                           is_user_annotation=False)


def test_trace_summary_union_calls_and_gaps():
    us = 1e6
    events = [
        _ev("bench::traced", 0, 100),
        _ev("bench::replay", 0, 60), _ev("bench::fetch", 60, 100),
        _ev("cudaGraphLaunch", 1, 2, corr=5), _ev("cudaMemcpyAsync", 61, 62, corr=6),
        _ev("cudaStreamSynchronize", 62, 99, corr=7),
        _ev("k1", 10, 30, device=True, corr=5), _ev("k2", 20, 40, device=True, corr=5),
        _ev("k1", 70, 80, device=True, corr=6),
        _ev("bench::replay", 10, 30, device=True),          # the span's device copy
        _ev("bench::frontend", 60, 100, device=True),       # not a host span
        _ev("bench::frontend", 0, 5),
    ]
    s = trace.summary(events, span_names=("frontend", "fetch"))
    assert s["window_s"] == pytest.approx(100 / us)
    assert s["busy_s"] == pytest.approx(40 / us)             # [10, 40] and [70, 80]
    assert s["device_s"] == pytest.approx(50 / us)
    assert s["ops"] == pytest.approx({"k1": 30 / us, "k2": 20 / us})
    assert s["host_calls"] == 2
    # the graph launched at 1 (in frontend) ran k1 and k2; the copy at 61 k1
    assert s["span_device_s"] == pytest.approx({"frontend": 40 / us, "fetch": 10 / us})
    # idle: [0, 10] in frontend (the innermost span), [40, 70] in replay
    # (at its middle), [80, 100] in fetch
    assert s["gaps"] == pytest.approx({"frontend": 10 / us, "replay": 30 / us,
                                       "fetch": 20 / us})
    assert trace.top({"a": 1.0, "b": 3.0, "c": 2.0}, 2) == [["b", 3.0], ["c", 2.0]]


def test_roofline_counts_from_shapes():
    vio = spec.load_json(spec.ROOT / "benchmark/configs/msckf_euroc.json")["vio"]
    px = 16 * 480 * 752
    assert roofline.fast_nms((16, 480, 752, 15.0), vio) == (2 * px * 4, px * 185)
    levels = [(480, 752), (240, 376), (120, 188), (60, 94)]
    img = sum(h * w for h, w in levels)
    nb, ops = roofline.lk_pyramid((16, 128, 128), vio)
    assert nb == 16 * 2 * img * 4 + 2 * 16 * 128 * 2 * 4 + 16 * 128 * 13
    assert ops == 16 * 128 * 4 * roofline.LK_OPS_PER_LEVEL
    nb, ops = roofline.lk_pyramid((16, 356, 128), vio)     # verify: level 0, 3 images
    assert nb == 16 * 3 * 480 * 752 * 4 + 2 * 16 * 356 * 2 * 4 + 16 * 356 * 13
    assert ops == 16 * 356 * roofline.LK_OPS_PER_LEVEL
    assert roofline.spd_gj((2048, 80, 4), vio) == (2048 * (80 * 80 + 2 * 80 * 4) * 4, 0)
    least = roofline.least_seconds({"fast_nms": {(16, 480, 752, 15.0): 2}}, vio,
                                   "NVIDIA H100 80GB HBM3")
    assert least == pytest.approx(2 * px * 185 / 67e12)      # bound by operations
    with pytest.raises(KeyError):
        roofline.peaks("NVIDIA A100")
