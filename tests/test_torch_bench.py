"""The port's timed entry (vio_msckf_torch/bench.py) against the repository's
bench.py on the CPU, at the reduced config of tests/test_torch_slice.py
(188x120 stereo, 2 pyramid levels, 6 clones) over a ~2 s sequence: the
workload both build, the result keys and metric values of run_single, its
exit on a diverged trajectory, the partial models tools/profile_ops.py
profiles, and that the bench and its tools import no JAX. One tier-1 item
(see tests/test_torch_slice.py on why one item); the scaling table over
gloo ranks is `slow`.
"""

import importlib.util
import json
import math
import types

import numpy as np
import pytest
import torch

from test_torch_slice import FORBIDDEN, PKG, REPO, _imports, _small_config
from vio_msckf_tpu import config as jconfig
from vio_msckf_tpu.utils import metrics as jmetrics
from vio_msckf_torch import bench as tbench
from vio_msckf_torch import config as tconfig
from vio_msckf_torch.tools import profile_ops

# Both bench sequences start after a 1 s standstill; 2.05 s gives 21 moving
# frames, the fewest over which RPE's 20-frame delta is defined.
SIM = dict(duration=2.05, static_init_time=1.0)
KEYS = {"metric", "value", "unit", "vs_baseline", "ate_rmse_m", "rpe_rmse_m"}
SCALING_KEYS = {"devices", "agg_fps", "speedup", "efficiency", "backend"}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_bench():
    """The repository's bench.py, loaded from its file."""
    spec = importlib.util.spec_from_file_location("bench", REPO / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _check_workload(tcfg):
    jframes, jinit, jgt, jn = _jax_bench().build_workload(
        _small_config(jconfig), dict(SIM), duration=SIM["duration"])
    tframes, tinit, tgt, tn = tbench.build_workload(tcfg, dict(SIM), duration=SIM["duration"],
                                                    device="cpu")
    assert tn == jn >= 21
    np.testing.assert_array_equal(tgt, jgt)
    for k in ("imu_gyro", "imu_acc", "imu_dt", "imu_valid"):
        np.testing.assert_array_equal(tframes[k].numpy(), np.asarray(jframes[k]), err_msg=k)
    for k in ("q0", "bg0", "gravity"):
        np.testing.assert_array_equal(np.asarray(tinit[k]), np.asarray(jinit[k]), err_msg=k)
    # The renderer's tolerance (tests/test_torch_slice.py: f32 sin of
    # phases ~1e2 rad, a few 1e-4 DN apart).
    for k in ("cam0_img", "cam1_img"):
        assert tframes[k].shape == (tn, 120, 188)
        np.testing.assert_allclose(tframes[k].numpy(), np.asarray(jframes[k]), atol=1e-2)


def _check_run_single(tcfg, monkeypatch):
    seen, ate_rmse = [], tbench.ate_rmse

    def spy(est, gt, align=True):
        seen.append((np.array(est), np.array(gt), align))
        return ate_rmse(est, gt, align=align)

    monkeypatch.setattr(tbench, "ate_rmse", spy)
    result = tbench.run_single(tcfg, "small", dict(SIM), reps=1, device="cpu")
    assert set(result) == KEYS
    assert result["metric"] == "small" and result["unit"] == "frames/s"
    assert result["value"] > 0 and result["vs_baseline"] == result["value"] / tbench.BASELINE_FPS
    (est, gt, align), = seen
    assert not align and est.shape == gt.shape and np.isfinite(est).all()
    want_ate = jmetrics.ate_rmse(est, gt, align=False)
    want_rpe = jmetrics.rpe_rmse(est, gt)
    assert math.isclose(result["ate_rmse_m"], want_ate, rel_tol=1e-9)
    assert math.isclose(result["rpe_rmse_m"], want_rpe, rel_tol=1e-9)
    assert result["ate_rmse_m"] <= tbench.ATE_BOUND_M
    return est


class _Replay:
    """An engine that hands back a trajectory already run, so the exit
    path costs no second pass of the filter."""

    def __init__(self, est):
        self.est = torch.as_tensor(est)

    def init(self, *args):
        return None

    def run_sequence(self, carry, frames):
        return carry, types.SimpleNamespace(p=self.est)


def _check_exit_on_divergence(tcfg, monkeypatch, est):
    monkeypatch.setattr(tbench, "VIOEngine", lambda cfg, device: _Replay(est))
    monkeypatch.setattr(tbench, "ATE_BOUND_M", 0.0)
    with pytest.raises(SystemExit) as exc:
        tbench.run_single(tcfg, "small", dict(SIM), reps=1, device="cpu")
    assert exc.value.code not in (0, None)


def _check_profile_models(tcfg):
    """profile_ops.build_model's --tracker-only and --filter-only models
    (its default, the engine, is VIOEngine.step_batch and run_batch as
    run_single drives them) on two sequences of the bench's motion, 2
    steps (a step, then a run over one frame): the tracker alone
    holds finite tracks inside the image, and the filter alone, on the
    simulator's tracks, a finite state."""
    carries = {}
    for mode in ("tracker", "filter"):
        fresh, step, run, frames = profile_ops.build_model(tcfg, mode, 2, 1.25, "cpu")
        assert all(v.shape[:2] == (2, frames["imu_dt"].shape[1]) for v in frames.values())
        carry = step(fresh(), {key: v[:, 0] for key, v in frames.items()})
        carries[mode] = run(carry, 1, 2)
    ts = carries["tracker"]
    assert ts.valid.sum(dim=1).min() > 0
    pts = ts.cam0_pts[ts.valid]
    assert torch.isfinite(pts).all()
    W, H = tcfg.cam0.resolution
    assert (pts >= 0).all() and (pts[:, 0] < W).all() and (pts[:, 1] < H).all()
    state, _ = carries["filter"]
    assert state.p.shape == (2, 3) and torch.isfinite(state.p).all()
    assert torch.isfinite(state.P).all()


def _check_no_jax():
    files = [PKG / "bench.py", *sorted((PKG / "tools").glob("*.py"))]
    assert len(files) == 4
    for f in files:
        for mod in _imports(f):
            assert mod.split(".")[0] not in FORBIDDEN, f"{f.name} imports {mod}"


def test_bench_matches_reference(monkeypatch):
    tcfg = _small_config(tconfig)
    _check_no_jax()
    _check_workload(tcfg)
    est = _check_run_single(tcfg, monkeypatch)
    _check_exit_on_divergence(tcfg, monkeypatch, est)
    _check_profile_models(tcfg)


@pytest.mark.slow
def test_scaling_table_over_gloo_ranks(tmp_path, capsys):
    table = tbench.run_scaling(reps=1, duration=2.0, device="cpu", config="tiny", frames=5,
                               ranks=(1, 2, 4), out_dir=str(tmp_path))
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed["table"] == table
    assert [r["devices"] for r in table] == [1, 2, 4]
    for row in table:
        assert SCALING_KEYS <= set(row) and row["backend"] == "gloo"
        assert row["agg_fps"] > 0 and math.isfinite(row["efficiency"])

    def positions(n):
        held = {}
        for r in range(n):
            z = np.load(tmp_path / f"ranks{n}" / f"rank{r}.npz")
            held.update({int(b): p for b, p in zip(z["rows"], z["p"])})
        return held

    one = positions(1)
    assert sorted(one) == list(range(tbench.SCALING_SEQUENCES))
    assert all(p.shape == (5, 3) and np.isfinite(p).all() for p in one.values())
    for n in (2, 4):
        held = positions(n)
        assert sorted(held) == sorted(one)
        gap = max(float(np.abs(held[b] - one[b]).max()) for b in one)
        assert gap <= 1e-5, f"{n} ranks: {gap} m from the 1-rank run"
