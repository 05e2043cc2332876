"""The check that decides `correct` passes a sound run and fails each
fault a cell can have, with the timed path broken underneath: a step that
returns its state unchanged, half of the batch left out (its outputs
copied from the other half), an answer altered where it is produced.
The whole run is driven on the CPU at a small size (bench_tiny.py),
past the harness's look for a card; the program's kernels run as their
PyTorch twins there, and the limits are the cells' own."""

import dataclasses

import pytest
import torch

from bench_tiny import move_from_the_first_frame, tiny_cell
from benchmark import run

SEED = 2_147_483_777
CELLS = ("msckf.offline.b16", "msckf.live.20hz", "eskf.offline")
SECONDS = {"msckf.offline.b16": 1.0, "msckf.live.20hz": 0.6, "eskf.offline": 0.6}


@pytest.fixture(autouse=True)
def _moving(monkeypatch):
    move_from_the_first_frame(monkeypatch)


def _map(fn, *xs):
    x = xs[0]
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{f.name: _map(fn, *(getattr(y, f.name) for y in xs))
                                         for f in dataclasses.fields(x)})
    if isinstance(x, (list, tuple)):
        return type(x)(_map(fn, *ys) for ys in zip(*xs))
    if isinstance(x, dict):
        return {k: _map(fn, *(y[k] for y in xs)) for k in x}
    if isinstance(x, torch.Tensor):
        return fn(*xs)
    return x


def _with_p(outs, fn):
    if isinstance(outs, dict):
        return dict(outs, p=fn(outs["p"]))
    return outs.replace(p=fn(outs.p))


class Faulty:
    """The system under test, stepped one frame a call, with one fault."""

    def __init__(self, system, kind):
        self.system, self.kind = system, kind

    def __getattr__(self, name):
        return getattr(self.system, name)

    def _frame(self, carry, frame):
        s = self.system
        if self.kind == "state_unchanged":
            return carry, s.run(carry, frame)[1]
        if self.kind == "answer_altered":
            new, outs = s.run(carry, frame)
            return new, _with_p(outs, lambda p: p + 0.01)
        if self.kind == "half_batch":
            B = frame["imu_dt"].shape[0]
            h = B // 2
            new, outs = s.run(_map(lambda t: t[:h], carry), {k: v[:h] for k, v in frame.items()})
            new = _map(lambda a, b: torch.cat([a, b[h:]]), new, carry)
            return new, _map(lambda t: torch.cat([t, t[: B - h]]), outs)
        raise ValueError(self.kind)

    def run(self, carry, frames):
        outs = []
        for k in range(frames["imu_dt"].shape[1]):
            carry, o = self._frame(carry, {key: v[:, k:k + 1] for key, v in frames.items()})
            outs.append(o)
        return carry, _map(lambda *ts: torch.cat(ts, dim=1), *outs)


def _run(name, kind=None):
    fault = None if kind is None else (lambda s: Faulty(s, kind))
    return run.run_cell(tiny_cell(name), SEED, SECONDS[name], False, "cpu", fault=fault)


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name):
    res = _run(name)
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"
    assert res["attempted"] > 0 and res["failed"] == 0


@pytest.mark.parametrize("name,kind", [
    (n, k) for n in CELLS for k in ("state_unchanged", "half_batch", "answer_altered")
    if not (k == "half_batch" and n.startswith("eskf"))])
def test_a_fault_is_not_correct(name, kind):
    res = _run(name, kind)
    assert not res["correct"], res["checks"]
