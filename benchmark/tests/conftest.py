"""The benchmark's own tests (run from the checkout's root):

    python -m pytest benchmark/tests -q -p no:cacheprovider

Tests marked `cuda` need the card and skip here; on a machine with one,
`python -m pytest benchmark/tests -q -m cuda` runs them. Whether there is
a card is decided inside the `cuda_device` fixture, never at import."""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA device; skipped without one")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
