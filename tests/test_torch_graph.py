"""The compiled step (vio_msckf_torch/graph.py) on the CPU, at tiny_config
with a 4-clone window.

The CPU has no CUDA graphs, so a stand-in takes their place here: its
"capture" runs the captured body once for its outputs and then puts the
static carry back as it was (a real capture runs nothing), and its replay
runs the body again on the same static buffers, writes the results into
the captured outputs and, like a real replay that calls no Python, leaves
the launch counters alone. Everything else (static buffers, the eager warm-up frame, the
cache, carries copied in and cloned out, the counts added per replay) is
the runner's own code. Checked, with identical bits against the eager
`step` loop:

  (a) VIOEngine.run_sequence over 4 frames, across a prune of the
      clone window, then over 2 from a faulted carry, across an online
      reset;
  (b) the returned carry aliases no static buffer: two runs from one
      fresh carry agree, and writing into one run's carry changes
      neither the next run nor the cached graph;
  (c) the launch counts: a capture counts nothing, each replay adds what
      one step launches;
  (c') a step that swaps its carry's leaves and outputs one of them: the
      copies into the static carry read the values from before them;
  (d) EskfVio.run_sequence against its eager step loop;
  (e) an engine, an ESKF or a filter and its runner form no reference
      cycle: with Python's cyclic collector off, dropping the owner frees
      it (on a card, with its graphs and their memory pools);
  (f) the filter alone, MSCKF.run_sequence on the simulator's feature
      tracks over 4 frames, against its eager `step` loop (the 4-clone
      window pruned).

The eager step is held against the JAX package by test_torch_slice.py,
test_torch_batch.py and test_torch_eskf.py; this file compiles no JAX.
One test item, as in the other port files (test_torch_slice.py)."""

import collections
import contextlib
import dataclasses
import gc
import weakref

import numpy as np
import pytest
import torch

from vio_msckf_torch import graph as graph_mod
from vio_msckf_torch import kernels
from vio_msckf_torch.data.render import render_sequence
from vio_msckf_torch.data.simulator import SimConfig, bundle_frames, simulate_sequence
from vio_msckf_torch.engine import VIOEngine
from vio_msckf_torch.eskf import EskfConfig, EskfVio
from vio_msckf_torch.filter.msckf import MSCKF
from vio_msckf_torch.graph import CompiledStep
from vio_msckf_torch.parallel import tiny_config
from vio_msckf_torch.tensors import tree_leaves, tree_map

N_FRAMES = 6
HALF = 4
IMU_KEYS = ("imu_gyro", "imu_acc", "imu_dt", "imu_valid")
FEED = IMU_KEYS + ("feat_ids", "feat_obs", "feat_valid")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _CpuGraph:
    """The stand-in for a captured CUDA graph (module docstring)."""

    def __init__(self, body, out):
        # Held weakly: a real graph holds no Python object, so neither may
        # the stand-in (its StepGraph holds it).
        self.body, self.out = weakref.WeakMethod(body), out

    def replay(self):
        saved = {k: collections.Counter(w.by_shape) for k, w in kernels.counters().items()}
        for d, s in zip(tree_leaves(self.out), tree_leaves(self.body()())):
            d.copy_(s)
        for k, w in kernels.counters().items():
            w.by_shape.clear()
            w.by_shape.update(saved[k])


def _cpu_capture(body, stream):
    static = body.__self__.carry                # body is StepGraph._body
    before = tree_map(torch.clone, static)
    out = body()
    for d, s in zip(tree_leaves(static), tree_leaves(before)):
        d.copy_(s)
    return _CpuGraph(body, out), out


@contextlib.contextmanager
def _no_stream(device):
    yield None, []


@pytest.fixture
def cpu_graphs(monkeypatch):
    monkeypatch.setattr(graph_mod, "_captures", lambda frame: True)
    monkeypatch.setattr(graph_mod, "_capture", _cpu_capture)
    monkeypatch.setattr(graph_mod, "_capture_stream", _no_stream)


def _workload(cfg):
    sim = SimConfig(duration=1.0 + 0.05 * (N_FRAMES + 0.5), seed=4, amp=(1.5, 1.0, 0.5),
                    yaw_rate=0.2, wobble_amp=0.1, static_init_time=1.0)
    seq = simulate_sequence(cfg, sim)
    frames, init, first = bundle_frames(seq, cfg)
    n = N_FRAMES
    R = seq["gt_R_i_w"][first:first + n].transpose(0, 2, 1)
    cam0, cam1 = render_sequence(cfg, R, seq["gt_p"][first:first + n], radius=14.0, seed=7,
                                 chunk=n, device="cpu")
    images = dict(cam0_img=cam0, cam1_img=cam1,
                  **{k: torch.as_tensor(frames[k][:n]) for k in IMU_KEYS})
    return images, {k: torch.as_tensor(frames[k][:n]) for k in FEED}, init


def _eager(step, carry, frames, lo, hi):
    outs = []
    for k in range(lo, hi):
        carry, out = step(carry, {key: v[k] for key, v in frames.items()})
        outs.append(out)
    return carry, outs


def _fault(carry):
    """A position variance past the online-reset gate."""
    P = carry[1].P.clone()
    P[12, 12] = 100.0
    return carry[0], carry[1].replace(P=P), carry[2]


def _assert_equal_trees(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert torch.equal(x, y)


def _config():
    cfg = tiny_config()
    return cfg.replace(filter=dataclasses.replace(cfg.filter, max_cam_state_size=4))


def _check_engine(eng, frames, init):
    half = HALF
    fresh = lambda: eng.init(init["q0"], init["bg0"], init["gravity"])  # noqa: E731
    # (a) the eager loop: 4 frames (the window of 4 clones fills and is
    # pruned), then 2 from a faulted carry (an online reset).
    c_e, o_e = _eager(eng.step, fresh(), frames, 0, half)
    c_e, o_e2 = _eager(eng.step, _fault(c_e), frames, half, N_FRAMES)
    p_e = torch.stack([o.p for o in o_e + o_e2])
    resets = torch.stack([o.did_reset for o in o_e + o_e2])
    assert resets.tolist() == [False] * half + [True] + [False] * (N_FRAMES - half - 1)

    first = {k: v[:half] for k, v in frames.items()}
    c1, o1 = eng.run_sequence(fresh(), first)           # warm-up frame + capture
    assert len(eng.compiled.graphs) == 1
    (g,) = eng.compiled.graphs.values()
    assert int(c1[1].n_clones) < eng.config.filter.max_cam_state_size   # pruned
    c2, o2 = eng.run_sequence(_fault(c1), {k: v[half:] for k, v in frames.items()})
    assert len(eng.compiled.graphs) == 1                 # T is not part of the key
    assert torch.equal(torch.cat([o1.p, o2.p]), p_e)
    assert torch.equal(torch.cat([o1.did_reset, o2.did_reset]), resets)
    _assert_equal_trees(c2, c_e)

    # (b) no aliasing: the carry is a clone, another run from the same
    # fresh carry agrees, and writing into a returned carry changes nothing.
    static = {t.untyped_storage().data_ptr() for t in tree_leaves((g.carry, g.frame, g.out))}
    assert not static & {t.untyped_storage().data_ptr() for t in tree_leaves(c1)}
    three = {k: v[:3] for k, v in frames.items()}
    c3, o3 = eng.run_sequence(fresh(), three)
    assert torch.equal(o3.p, o1.p[:3])
    kept = tree_map(torch.clone, (c3, o3))
    for t in tree_leaves(c3):
        t.zero_() if t.dtype != torch.bool else t.fill_(True)
    _assert_equal_trees(eng.run_sequence(fresh(), three), kept)


def _check_counts(eng, frames, init):
    # (c) a step that "launches" each hand kernel once, at a shape of its
    # own: a capture counts nothing, the warm-up frame and every replay
    # count one.
    wrappers = kernels.counters()

    def step(carry, frame):
        for w in wrappers.values():
            w.by_shape[("graph test",)] += 1
        return eng.step_batch(carry, frame)

    for w in wrappers.values():
        w.by_shape.clear()
    compiled = CompiledStep(step)
    carry = eng.init_batch([init])
    batch = {k: v[None, :3] for k, v in frames.items()}
    compiled.run(carry, batch, axis=1)
    assert {k: dict(w.by_shape) for k, w in wrappers.items()} == {
        k: {("graph test",): 3} for k in wrappers}
    (g,) = compiled.graphs.values()
    assert g.launches == {k: collections.Counter({("graph test",): 1}) for k in wrappers}
    compiled.run(carry, batch, axis=1)
    assert all(dict(w.by_shape) == {("graph test",): 6} for w in wrappers.values())
    for w in wrappers.values():
        w.by_shape.clear()


def _check_static_aliases():
    # (c') the new carry is the old one swapped, the output its old first
    # leaf: without the body's clones the second copy would read what the
    # first wrote, and the output would show the new carry.
    def step(carry, frame):
        return (carry[1], carry[0] + frame), carry[0]

    carry = (torch.zeros(2), torch.ones(2))
    frames = torch.arange(8.0).reshape(4, 2)
    c_e, o_e = _eager(lambda c, f: step(c, f["x"]), carry, {"x": frames}, 0, 4)
    c_g, o_g = CompiledStep(step).run(carry, frames)
    assert torch.equal(o_g, torch.stack(o_e))
    _assert_equal_trees(c_g, c_e)


def _check_eskf(cfg, frames):
    # (d) the ESKF at K = 16.
    vio = EskfVio(cfg, EskfConfig(fast_threshold=12.0, grid_row=2, grid_col=2, per_cell=4),
                  device="cpu")
    acc0 = frames["imu_acc"][1][frames["imu_valid"][1]][0].numpy()
    c_e, o_e = _eager(vio.step, vio.init(acc0), frames, 0, 4)
    c_g, o_g = vio.run_sequence(vio.init(acc0), {k: v[:4] for k, v in frames.items()})
    for key in o_g:
        assert torch.equal(o_g[key], torch.stack([o[key] for o in o_e])), key
    _assert_equal_trees(c_g, c_e)
    assert int(o_g["n_stereo"].min()) > 0 and np.isfinite(o_g["p"].numpy()).all()
    assert len(vio.compiled.graphs) == 1
    return vio


def _check_filter(cfg, tracks, init):
    # (f) one sequence (B = 1) over 4 frames: the window of 4 clones
    # fills and is pruned.
    kf = MSCKF(cfg, device="cpu")
    frames = {k: v[None, :HALF] for k, v in tracks.items()}
    carry, outs = kf.init_batch([init]), []
    for k in range(HALF):
        carry, out = kf.step(carry, {key: v[:, k] for key, v in frames.items()})
        outs.append(out)
    c_g, o_g = kf.run_sequence(kf.init_batch([init]), frames)
    assert len(kf.compiled.graphs) == 1
    for name in o_g.__dataclass_fields__:
        assert torch.equal(getattr(o_g, name),
                           torch.stack([getattr(o, name) for o in outs], dim=1)), name
    _assert_equal_trees(c_g, carry)
    assert int(c_g[0].n_clones[0]) < cfg.filter.max_cam_state_size      # pruned
    return kf


def test_compiled_step_matches_eager_loop(cpu_graphs):
    cfg = _config()
    frames, tracks, init = _workload(cfg)
    eng = VIOEngine(cfg, device="cpu")
    _check_engine(eng, frames, init)
    _check_counts(eng, frames, init)
    _check_static_aliases()
    # (d) and (f), then (e): the runner holds its owner's step weakly.
    enabled = gc.isenabled()
    gc.disable()
    try:
        refs = [weakref.ref(eng), weakref.ref(_check_eskf(cfg, frames)),
                weakref.ref(_check_filter(cfg, tracks, init))]
        del eng
        assert [r() for r in refs] == [None, None, None]
    finally:
        if enabled:
            gc.enable()
