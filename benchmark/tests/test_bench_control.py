"""The control fails the check: the plain reference, computed in TF32 (the
precision below the f32 the configurations state), in the program's place
at each cell's own size, comes out not correct. Needs the card; on it:

    python -m pytest benchmark/tests/test_bench_control.py -q -m cuda

(a few minutes a cell: the control steps eagerly)."""

import pytest

from bench_tiny import full_cell
from benchmark import run

SEED = 3_000_000_019
# A window long enough for the control to reach the spans a run checks.
SECONDS = {"msckf.offline.b16": 45.0, "msckf.live.20hz": 1.5, "eskf.offline": 28.0}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SECONDS))
def test_the_control_is_not_correct(name, cuda_device):
    res = run.run_cell(full_cell(name), SEED, SECONDS[name], False, cuda_device, control=True)
    assert not res["correct"], res["checks"]
