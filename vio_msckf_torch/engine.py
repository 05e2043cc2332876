"""The full VIO engine: stereo front-end + MSCKF back-end, one frame per
`step`. Port of vio_msckf_tpu/engine.py.

The front-end and the filter take a leading batch axis B: `step_batch`
advances B independent sequences by one frame in the same kernel launches
as one sequence (the JAX package gets the same from `jax.vmap`, see
bench.py:run_batched). `step` and `run_sequence` are the one-sequence API:
they add a B = 1 axis to the carry and the frame and take it off again.

`run_batch` and `run_sequence` replay the step as a CUDA graph on a CUDA
device (graph.CompiledStep, the counterpart of the JAX package's
`jax.jit` over `lax.scan`): captured at a run's first frame of a new
shape, replayed per frame. An engine with a `block_group` (parallel/) is
captured with its collectives when the group is NCCL's and steps eagerly
when it is gloo's (comm.capturable). `step` and `step_batch` stay eager, like the
JAX package's unjitted `eng.step`; the graph is held against them.
`entry()` hands out the captured step at the EuRoC config, as the
repository's __graft_entry__.py:entry() hands out the jittable one.

A step issues no host synchronisation: every data-dependent loop and
branch of the reference is a fixed-cap masked loop, a per-sequence select,
or runs inside a kernel, so the host can queue frames ahead of the device.
"""

import numpy as np
import torch

from vio_msckf_torch.config import VIOConfig, euroc_config
from vio_msckf_torch.filter.msckf import MSCKF
from vio_msckf_torch.frontend.tracker import StereoTracker
from vio_msckf_torch.graph import CompiledStep, capturable_linalg
from vio_msckf_torch.tensors import index_record, unsqueeze_record


def _one(carry):
    """A one-sequence carry -> a batched carry of B = 1 (views)."""
    return tuple(unsqueeze_record(c) for c in carry)


def _first(carry):
    """Sequence 0 of a batched carry (views)."""
    return tuple(index_record(c, 0) for c in carry)


class VIOEngine:
    def __init__(self, config: VIOConfig, device="cuda", dtype=torch.float32,
                 block_group=None):
        """`block_group`: the filter's feature-block process group
        (MSCKF); the tracker runs whole on every rank of it. The runs
        replay a CUDA graph without a group and with an NCCL group, its
        collectives captured inside; with a gloo group they step eagerly,
        since gloo stages through the host (graph.py)."""
        self.config = config
        self.device = torch.device(device)
        self.tracker = StereoTracker(config, self.device)
        self.kf = MSCKF(config, self.device, dtype, block_group)
        self.compiled = CompiledStep(self.step_batch, block_group)

    # -- B sequences ---------------------------------------------------------

    def init_batch(self, inits):
        """Fresh batched (tracker, filter, feature-map) carry for len(inits)
        sequences; each entry is a dict whose q0 / bg0 / gravity (each
        optional) come from the static gravity-and-bias initialization (the
        `init` dict of data.bundling.bundle_frames)."""
        state, fmap = self.kf.init_batch(inits)
        return (self.tracker.init(len(inits)), state, fmap)

    @capturable_linalg()
    def step_batch(self, carry, frame):
        """One stereo frame of every sequence. frame keys: cam0_img
        (B,H,W), cam1_img (B,H,W), imu_gyro (B,M,3), imu_acc (B,M,3), imu_dt
        (B,M), imu_valid (B,M). Returns (carry, FilterOutput with leading
        B). Its linear algebra is the captured step's (graph.py:
        capturable_linalg), so the graph and this step agree bit for bit."""
        ts, state, fmap = carry
        ts, msg = self.tracker.step(ts, frame["cam0_img"], frame["cam1_img"],
                                    frame["imu_gyro"], frame["imu_dt"],
                                    frame["imu_valid"])
        kf_frame = dict(imu_gyro=frame["imu_gyro"], imu_acc=frame["imu_acc"],
                        imu_dt=frame["imu_dt"], imu_valid=frame["imu_valid"],
                        feat_ids=msg["feat_ids"], feat_obs=msg["feat_obs"],
                        feat_valid=msg["feat_valid"])
        (state, fmap), out = self.kf.step((state, fmap), kf_frame)
        return (ts, state, fmap), out

    def run_batch(self, carry, frames):
        """Step B sequences over frames stacked (B, T, ...), as bench.py
        stacks them; returns (carry, outputs (B, T, ...)). On CUDA the
        step replays its CUDA graph (module docstring); the carry comes
        back as new tensors."""
        return self.compiled.run(carry, frames, axis=1)

    # -- one sequence ----------------------------------------------------------

    def init(self, q0=None, bg0=None, gravity=None):
        """Fresh one-sequence (tracker, filter, feature-map) carry."""
        return _first(self.init_batch([dict(q0=q0, bg0=bg0, gravity=gravity)]))

    def reset(self, carry):
        """Full system reset: fresh tracker state and a fresh filter that
        keeps the current extrinsics estimate."""
        _, state, fmap = _one(carry)
        state, fmap = self.kf.reset(state, fmap)
        return _first((self.tracker.init(1), state, fmap))

    def step(self, carry, frame):
        """One stereo frame end to end. frame keys: cam0_img (H,W),
        cam1_img (H,W), imu_gyro (M,3), imu_acc (M,3), imu_dt (M,),
        imu_valid (M,)."""
        carry, out = self.step_batch(_one(carry), {k: v[None] for k, v in frame.items()})
        return _first(carry), index_record(out, 0)

    def run_sequence(self, carry, frames):
        """Step over frames stacked on axis 0; returns (carry, outputs
        stacked on axis 0)."""
        carry, outs = self.run_batch(_one(carry), {k: v[None] for k, v in frames.items()})
        return _first(carry), index_record(outs, 0)


def entry(device="cuda"):
    """(fn, example_args) for the captured engine step, the counterpart of
    the repository's __graft_entry__.py:entry(): the full EuRoC-sized VIO
    engine step (stereo images + IMU bundle -> filter state + pose) at
    euroc_config(), on random 752x480 images and a static IMU frame.
    fn(carry, frame) replays one captured step (the first call runs it
    eagerly and captures it) and returns (carry, FilterOutput)."""
    cfg = euroc_config()
    eng = VIOEngine(cfg, device)
    carry = eng.init()
    rng = np.random.default_rng(0)
    W, H = cfg.cam0.resolution
    M = cfg.filter.imu_per_frame

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    frame = dict(
        cam0_img=t(rng.uniform(0, 255, (H, W))),
        cam1_img=t(rng.uniform(0, 255, (H, W))),
        imu_gyro=t(np.zeros((M, 3))),
        imu_acc=t(np.tile([0.0, 0.0, 9.81], (M, 1))),
        imu_dt=t(np.full(M, 0.005)),
        imu_valid=t(np.ones(M), torch.bool),
    )

    def fn(carry, frame):
        carry, outs = eng.run_sequence(carry, {k: v[None] for k, v in frame.items()})
        return carry, index_record(outs, 0)

    return fn, (carry, frame)
