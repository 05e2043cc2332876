"""The port's scale-out (vio_msckf_torch/parallel/) on the CPU: sharded
filter steps in gloo rank processes against the unsharded filter, and
against the JAX package's shard_map step.

The tier-1 item runs 4 ranks of `python -m vio_msckf_torch.parallel.worker`
(replica = 2 x block = 2, the block groups spanning processes, so the
butterfly TSQR exchange crosses the process boundary) on `tiny_config`,
the simulated tracks of seeds 1 and 2, 20 frames, as the JAX package's
tests/test_distributed.py does. Its row budget is scaled to the tiny
feature table, 1500 rows x (32 x 6) / (160 x 20) = 90: the reference's
1500 never binds there, and then a rank that budgets without the other
ranks' gammas gives the same state. The merged rows must equal the port's
unsharded MSCKF within 1e-5 m (the reference's own bound is 5e-3 m,
tests/test_parallel.py:77; the two differ by f32 roundoff, ~1e-7 m here,
and a rank gating on its local gammas alone moves them ~3e-4 m), and block
peers must be bit-identical, as the lower-index-first TSQR stack order
keeps them. The same item checks that the parallel modules import nothing
of JAX, the PNG readers' fallback order (the native loader, else PIL,
else data/png.py), that the tracker drops births past its table as the
reference's does (the engine at `tiny_config` overflows it), and the
capture rule of a sharded step (graph.py): captured without a block group
and over NCCL, eager over gloo, checked without starting NCCL. The ranks
step through the worker's runner (`compiled.run`), which over gloo is
the eager loop.
"""

import dataclasses
import json
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from PIL import Image

from test_torch_slice import FORBIDDEN, PKG, REPO, _imports
from vio_msckf_torch import comm
from vio_msckf_torch.data import euroc as teuroc
from vio_msckf_torch.data.png import encode_png_gray
from vio_msckf_torch.data.render import BENCH_WORLD, render_sequence
from vio_msckf_torch.data.simulator import SimConfig, bundle_frames, simulate_sequence
from vio_msckf_torch.filter.msckf import MSCKF
from vio_msckf_torch.engine import VIOEngine
from vio_msckf_torch.frontend.tracker import StereoTracker
from vio_msckf_torch.graph import CompiledStep
from vio_msckf_torch.parallel import tiny_config
from vio_msckf_torch.parallel.distributed import Ranks
from vio_msckf_torch.runtime import native_loader

SEEDS = (1, 2)
SEQUENCES = json.dumps([dict(sim=dict(duration=6.0, seed=s)) for s in SEEDS])
# The port against the JAX shard_map at euroc_config(): f32 roundoff apart
# (1.76e-6 m measured on a CPU), held far inside the reference's own bound of 5e-3 m
# (tests/test_parallel.py:77, tests/test_distributed.py:100).
JAX_BOUND_M = 1e-4
TINY_BUDGET = dict(max_update_rows=90)
FEED = ("imu_gyro", "imu_acc", "imu_dt", "imu_valid", "feat_ids", "feat_obs", "feat_valid")


def _start(tmp_path, config, n_replica, n_block, frames, filter_config=None):
    return Ranks("vio_msckf_torch.parallel.worker", n_replica * n_block, [
        "--out", tmp_path, "--replica", n_replica, "--block", n_block,
        "--block-across-processes", "--config", config, "--device", "cpu",
        "--backend", "gloo", "--frames", frames, "--sequences", SEQUENCES,
        "--filter-config", json.dumps(filter_config or {})])


def _merged(tmp_path, ranks):
    """(B, T, 3) positions merged over the ranks, and the largest gap
    between block peers holding the same row."""
    held = {}
    for r in range(ranks):
        z = np.load(tmp_path / f"rank{r}.npz")
        for b, p in zip(z["rows"], z["p"]):
            held.setdefault(int(b), []).append(p)
    assert sorted(held) == list(range(len(SEEDS))), sorted(held)
    peer_gap = max(float(np.abs(p - ps[0]).max()) for ps in held.values() for p in ps)
    return np.stack([held[b][0] for b in sorted(held)]), peer_gap


def _simulated(cfg, n_frames):
    """The seeds' simulated sequences: frames (B, T, ...) and inits."""
    seqs = [bundle_frames(simulate_sequence(cfg, SimConfig(duration=6.0, seed=s)), cfg)
            for s in SEEDS]
    T = min(n_frames, *(len(f["imu_dt"]) for f, _, _ in seqs))
    frames = {k: np.stack([f[k][:T] for f, _, _ in seqs]) for k in FEED}
    return frames, [init for _, init, _ in seqs], T


def _unsharded(cfg, n_frames):
    frames, inits, T = _simulated(cfg, n_frames)
    kf = MSCKF(cfg, device="cpu")
    carry = kf.init_batch(inits)
    ps = []
    for k in range(T):
        carry, out = kf.step(carry, {key: torch.as_tensor(v[:, k]) for key, v in frames.items()})
        ps.append(out.p)
    return torch.stack(ps, dim=1).numpy()


def _check_parallel_never_imports_jax():
    files = sorted((PKG / "parallel").glob("*.py")) + [PKG / "comm.py"]
    assert len(files) == 6
    for f in files:
        for mod in _imports(f):
            assert mod.split(".")[0] not in FORBIDDEN, f"{f.name} imports {mod}"
    mods = [".".join(f.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
            for f in files]
    code = ("import sys\n" + "".join(f"sys.modules[{m!r}] = None\n" for m in FORBIDDEN)
            + "".join(f"import {m}\n" for m in mods))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]


def _check_tiny_config_is_the_reference():
    from vio_msckf_tpu.parallel import tiny_config as jtiny_config

    jc, tc = dataclasses.asdict(jtiny_config()), dataclasses.asdict(tiny_config())
    for section, name in (("frontend", "fast_backend"), ("frontend", "lk_backend"),
                          ("filter", "gamma_solver")):
        del jc[section][name]          # the port has no backend switches
    assert tc == jc


def _check_png_fallback_order(tmp_path, monkeypatch):
    # Without the native loader the readers decode with PIL, as the
    # reference does; without PIL too, with data/png.py. Both on a PNG
    # written by PIL's adaptive encoder (Paeth and Average rows) and on one
    # written by the port's encoder.
    rng = np.random.default_rng(5)
    img = (np.add.outer(np.arange(48) * 3, np.arange(64) * 2) + rng.integers(0, 9, (48, 64))
           ).astype(np.uint8)
    pil_file, own_file = tmp_path / "pil.png", tmp_path / "own.png"
    Image.fromarray(img).save(pil_file)
    own_file.write_bytes(encode_png_gray(img))
    monkeypatch.setitem(native_loader._state, "lib", None)
    monkeypatch.setitem(native_loader._state, "error", "switched off by the test")
    for name in ("PIL ", "numpy+zlib"):
        assert native_loader.decoder_name().startswith(name), native_loader.decoder_name()
        for f in (pil_file, own_file):
            np.testing.assert_array_equal(teuroc.load_png_gray(f), img)
        loader = native_loader.open_loader([pil_file, own_file], 64, 48, ring=1, threads=2)
        assert isinstance(loader, native_loader.PoolLoader)
        for (_, got) in loader:
            np.testing.assert_array_equal(got, img)
        loader.close()
        monkeypatch.setitem(sys.modules, "PIL", None)


def _check_tracker_drops_births_past_table():
    # With an 8-slot track table every frame at tiny_config has more births
    # than free slots (11 on the first): the births past the table are
    # dropped, as the reference's scatter (mode="drop") drops them, and the
    # table and next_id equal the JAX StereoTracker's on the same frames.
    import jax
    import jax.numpy as jnp
    from vio_msckf_tpu.frontend.tracker import StereoTracker as JStereoTracker
    from vio_msckf_tpu.parallel import tiny_config as jtiny_config

    def narrow(cfg):
        return cfg.replace(frontend=dataclasses.replace(cfg.frontend, max_tracks=8))

    cfg, n = narrow(tiny_config()), 4
    seq = simulate_sequence(cfg, SimConfig(duration=6.0, seed=SEEDS[0]))
    f, _, first = bundle_frames(seq, cfg)
    R = seq["gt_R_i_w"][first:first + n].transpose(0, 2, 1)
    cam0, cam1 = render_sequence(cfg, R, seq["gt_p"][first:first + n], device="cpu",
                                 **BENCH_WORLD)
    jt, tt = JStereoTracker(narrow(jtiny_config())), StereoTracker(cfg, device="cpu")
    js, ts, jstep = jt.init(), tt.init(1), jax.jit(jt.step)
    for k in range(n):
        args = (cam0[k].numpy(), cam1[k].numpy(), f["imu_gyro"][k], f["imu_dt"][k],
                f["imu_valid"][k])
        js, jmsg = jstep(js, *map(jnp.asarray, args))
        ts, _ = tt.step(ts, *(torch.as_tensor(a)[None] for a in args))
        jids, next_id = np.asarray(js.ids), int(js.next_id)
        assert int(jmsg["diag"]["n_births"]) > 0 and next_id - 1 not in jids, k
        assert int(ts.next_id[0]) == next_id
        np.testing.assert_array_equal(ts.ids[0].numpy(), jids)
        np.testing.assert_array_equal(ts.valid[0].numpy(), np.asarray(js.valid))
        np.testing.assert_allclose(ts.cam0_pts[0].numpy(), np.asarray(js.cam0_pts), atol=1e-3)
        np.testing.assert_allclose(ts.cam1_pts[0].numpy(), np.asarray(js.cam1_pts), atol=1e-3)


def _check_capture_rule():
    # Stand-in groups answer get_backend, so NCCL need not start: no group
    # and NCCL capture, gloo steps eagerly, another backend has no rule;
    # the engine and the filter pass their block group to their runners.
    nccl, gloo = SimpleNamespace(backend="nccl"), SimpleNamespace(backend="gloo")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.distributed, "get_backend", lambda group: group.backend)
        step = lambda carry, frame: (carry, frame)  # noqa: E731
        runners = [CompiledStep(step, g) for g in (None, nccl, gloo)]
        assert [r.capture for r in runners] == [True, True, False]
        with pytest.raises(ValueError, match="mpi"):
            comm.capturable(SimpleNamespace(backend="mpi"))
        cfg = tiny_config()
        assert MSCKF(cfg, "cpu", block_group=nccl).compiled.capture
        assert not MSCKF(cfg, "cpu", block_group=gloo).compiled.capture
        assert VIOEngine(cfg, "cpu", block_group=nccl).compiled.capture
        assert not VIOEngine(cfg, "cpu", block_group=gloo).compiled.capture


def test_sharded_filter_matches_unsharded(tmp_path, monkeypatch):
    ranks = _start(tmp_path, "tiny", 2, 2, 20, TINY_BUDGET)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cfg = tiny_config()
        ref = _unsharded(cfg.replace(filter=dataclasses.replace(cfg.filter, **TINY_BUDGET)), 20)
        _check_parallel_never_imports_jax()
        _check_tiny_config_is_the_reference()
        _check_png_fallback_order(tmp_path, monkeypatch)
        _check_tracker_drops_births_past_table()
        _check_capture_rule()
    finally:
        torch.set_num_threads(threads)
        ranks.wait(300)
    merged, peer_gap = _merged(tmp_path, 4)
    assert merged.shape == ref.shape == (len(SEEDS), 20, 3)
    assert np.isfinite(merged).all()
    assert peer_gap == 0.0, peer_gap
    np.testing.assert_allclose(merged, ref, atol=1e-5)


@pytest.mark.slow
def test_sharded_filter_matches_jax_shard_map(tmp_path):
    """replica = 2 x block = 4 (two butterfly rounds) at euroc_config(),
    30 frames: 8 gloo ranks of the port against the JAX package's
    make_multichip_filter_step over the 8 virtual CPU devices of
    tests/conftest.py."""
    import jax
    import jax.numpy as jnp
    from vio_msckf_tpu.config import euroc_config as jeuroc_config
    from vio_msckf_tpu.data.simulator import (
        SimConfig as JSimConfig, bundle_frames as jbundle, simulate_sequence as jsimulate)
    from vio_msckf_tpu.filter.msckf import MSCKF as JMSCKF
    from vio_msckf_tpu.parallel import make_mesh, make_multichip_filter_step, shard_batch

    ranks = _start(tmp_path, "euroc", 2, 4, 30)
    try:
        cfg = jeuroc_config()
        mesh = make_mesh(n_replica=2, n_block=4)
        step, _ = make_multichip_filter_step(cfg, mesh)
        kf = JMSCKF(cfg)
        seqs = [jbundle(jsimulate(cfg, JSimConfig(duration=6.0, seed=s)), cfg) for s in SEEDS]
        T = min(30, *(len(f["imu_dt"]) for f, _, _ in seqs))
        carry = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *[
            kf.init(i["q0"], i["bg0"], i["gravity"]) for _, i, _ in seqs])
        carry = shard_batch(mesh, carry)
        ps = []
        for k in range(T):
            frame = {key: jnp.stack([jnp.asarray(f[key][k]) for f, _, _ in seqs])
                     for key in FEED}
            carry, out = step(carry, shard_batch(mesh, frame))
            ps.append(np.asarray(out.p))
        ref = np.stack(ps, axis=1)
    finally:
        ranks.wait(1200)
    merged, peer_gap = _merged(tmp_path, 8)
    print(f"port (8 gloo ranks) vs JAX shard_map: max gap {np.abs(merged - ref).max():.3g} m, "
          f"block peers {peer_gap:.3g} m")
    assert merged.shape == ref.shape == (len(SEEDS), T, 3)
    assert peer_gap == 0.0, peer_gap
    np.testing.assert_allclose(merged, ref, atol=JAX_BOUND_M)
