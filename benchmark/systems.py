"""The two pipelines a configuration can name ("pipeline" in its file), each
as the program (vio_msckf_torch, imported only here and only when built)
and as the plain reference (benchmark/reference), behind one interface:

    sys.fresh(seqs) -> carry             a fresh carry for the sequences
    sys.run(carry, frames) -> (carry, outs)   frames (B, T, ...), the
                                         pipeline's timed entry
    sys.positions(outs) -> (B, T, 3)     the pose's position per frame
    sys.pose(outs) -> (B, T, k)          position and attitude per frame
    sys.step(carry, frame)               one eager step, frame (B, ...)
    sys.spans                            {span name: (object, attribute)}
                                         the layers a traced eager step
                                         times (benchmark's own spans)

The program's timed entries are VIOEngine.run_batch (the replayed CUDA
graph of step_batch) and EskfVio.run_sequence (the replayed graph of its
step); the reference runs the same steps eagerly with the plain twins.
"""

import dataclasses
import importlib

import numpy as np
import torch

from benchmark import spec

PROGRAM = "vio_msckf_torch"
REFERENCE = "benchmark.reference"


def _module(package, name):
    return importlib.import_module(f"{package}.{name}")


class Msckf:
    """Stereo front-end + MSCKF (the configuration's `vio` group)."""

    ate_aligned = False      # the filter estimates in the world frame

    def __init__(self, doc, device, package):
        self.cfg = spec.vio_config(_module(package, "config"), doc)
        if package == PROGRAM:
            importlib.import_module(package).full_precision()
        self.eng = _module(package, "engine").VIOEngine(self.cfg, device)
        self.spans = {"frontend": (self.eng.tracker, "step"), "filter": (self.eng.kf, "step")}

    def fresh(self, seqs):
        return self.eng.init_batch([s["init"] for s in seqs])

    def run(self, carry, frames):
        return self.eng.run_batch(carry, frames)

    def step(self, carry, frame):
        return self.eng.step_batch(carry, frame)

    @staticmethod
    def positions(outs):
        return outs.p

    @staticmethod
    def pose(outs):
        return torch.cat([outs.p, outs.q], dim=-1)


class Eskf:
    """Rectified ORB stereo + the 18-state ESKF; one sequence (B = 1)."""

    ate_aligned = True       # it estimates in the rectified camera's frame

    def __init__(self, doc, device, package):
        self.cfg = spec.vio_config(_module(package, "config"), doc)
        pipeline = _module(package, "eskf.pipeline")
        eskf = spec.build_dataclass(pipeline.EskfConfig, doc["eskf"])
        if package == PROGRAM:
            importlib.import_module(package).full_precision()
        self.vio = pipeline.EskfVio(self.cfg, eskf, device=device)
        self.spans = {"eskf_frontend": (self.vio, "_stereo_frontend"),
                      "eskf_filter": (_module(package, "eskf.pipeline"), "eskf_frame_step")}

    @staticmethod
    def first_acc(seq):
        """The first valid accelerometer sample after the first frame, as
        the port's CLI seeds gravity from it."""
        acc, valid = seq["imu"]["imu_acc"][1], seq["imu"]["imu_valid"][1]
        return acc[valid][0]

    def fresh(self, seqs):
        if len(seqs) != 1:
            raise ValueError(f"the ESKF runs one sequence, got {len(seqs)}")
        return self.vio.init(self.first_acc(seqs[0]))

    def run(self, carry, frames):
        carry, outs = self.vio.run_sequence(carry, {k: v[0] for k, v in frames.items()})
        return carry, {k: v[None] for k, v in outs.items()}

    def step(self, carry, frame):
        return self.vio.step(carry, {k: v[0] for k, v in frame.items()})

    @staticmethod
    def positions(outs):
        return outs["p"]

    @staticmethod
    def pose(outs):
        return torch.cat([outs["p"], outs["R"].flatten(-2)], dim=-1)


PIPELINES = {"msckf": Msckf, "eskf": Eskf}


def build(doc, device, package):
    """The configuration's pipeline as the program or the reference."""
    return PIPELINES[doc["pipeline"]](doc, device, package)


def to_reference(x):
    """A carry of the program as the reference's records: each dataclass
    becomes the reference's class of the same module path and name, each
    tensor a clone. Used only where the check follows the program from its
    own state (check.py)."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        mod = type(x).__module__
        if mod.split(".")[0] == PROGRAM:
            mod = REFERENCE + mod[len(PROGRAM):]
        cls = getattr(importlib.import_module(mod), type(x).__name__)
        return cls(**{f.name: to_reference(getattr(x, f.name)) for f in dataclasses.fields(x)})
    if isinstance(x, (list, tuple)):
        return type(x)(to_reference(v) for v in x)
    if isinstance(x, dict):
        return {k: to_reference(v) for k, v in x.items()}
    if isinstance(x, torch.Tensor):
        return x.clone()
    return x


def leaves(x):
    """The tensors of a carry, in a fixed order."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return [t for f in dataclasses.fields(x) for t in leaves(getattr(x, f.name))]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in leaves(v)]
    if isinstance(x, dict):
        return [t for k in sorted(x) for t in leaves(x[k])]
    if isinstance(x, torch.Tensor):
        return [x]
    return []


def max_abs_gap(a, b):
    """The largest absolute difference between two carries, leaf by leaf
    (inf where their layouts differ)."""
    la, lb = leaves(a), leaves(b)
    if len(la) != len(lb):
        return float("inf")
    gap = 0.0
    for x, y in zip(la, lb):
        if x.shape != y.shape:
            return float("inf")
        d = (x.double() - y.double().to(x.device)).abs()
        both_nan = torch.isnan(x.double()) & torch.isnan(y.double().to(x.device))
        d = torch.where(both_nan, torch.zeros_like(d), d)
        if d.numel():
            gap = max(gap, float(np.nan_to_num(d.max().item(), nan=np.inf)))
    return gap
