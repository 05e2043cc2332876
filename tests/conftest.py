"""Test harness config: run all tests on a virtual 8-device CPU mesh.

The driver benches on the real TPU chip; tests validate numerics and
sharding logic on CPU (XLA_FLAGS host-platform device count, per SURVEY.md
section 4's multi-device simulation strategy).
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

# jax may be pre-imported at interpreter startup in this image, so env vars
# alone are too late — force the platform through the live config object.
import jax

jax.config.update("jax_platforms", "cpu")

# Persistent compilation cache: the suite is dominated by XLA compiles of
# the full engine; cache them across runs (first run warms, reruns are fast).
_cache_dir = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    ".jax_cache",
)
jax.config.update("jax_compilation_cache_dir", _cache_dir)
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (the hand kernels); skipped without one")
    config.addinivalue_line("markers", "slow: minutes on the CPU; tier-1 deselects it")
