"""The card a run measures, and the guards around a measured run."""

import subprocess
import sys

import torch

# Modules that no run may hold once its window has closed, compared by
# whole top-level name (the port's own name begins with the JAX package's).
FORBIDDEN = ("jax", "jaxlib", "flax", "vio_msckf_tpu")
SMI_FIELDS = "name,clocks.sm,clocks.mem,pstate,power.draw,power.limit,temperature.gpu"


class NoDevice(RuntimeError):
    """The cell needs more CUDA devices than this machine shows."""


def require_cuda(chips):
    """Fail unless `chips` CUDA devices are visible: a measurement never
    falls back to the CPU."""
    if not torch.cuda.is_available():
        raise NoDevice("no CUDA device: this benchmark measures the GPU and does not "
                       "run on the CPU")
    if torch.cuda.device_count() < chips:
        raise NoDevice(f"the cell needs {chips} CUDA devices, "
                       f"{torch.cuda.device_count()} are visible")


def smi():
    """nvidia-smi's reading of every card: [{name, clocks.sm, clocks.mem,
    pstate, power.draw, power.limit, temperature.gpu}], or [] where
    nvidia-smi is missing."""
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={SMI_FIELDS}",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return []
    keys = SMI_FIELDS.split(",")
    return [dict(zip(keys, (v.strip() for v in line.split(","))))
            for line in out.strip().splitlines() if line.strip()]


def forbidden_modules(modules=None):
    """The loaded modules whose top-level name is one of FORBIDDEN."""
    modules = sys.modules if modules is None else modules
    return sorted({m for m in modules if m.split(".")[0] in FORBIDDEN})


def describe(chips):
    """The `device` block of the result line, less the readings added
    after the window."""
    return dict(platform="gpu", kind=torch.cuda.get_device_name(0), count=chips)
