"""Measurement tools of the port, each run as a module:

  profile_ops  python -m vio_msckf_torch.tools.profile_ops: the device
               profile of warm engine steps (torch.profiler), kernel by
               kernel; scripts/profile_ops.py's counterpart
  batch_sweep  python -m vio_msckf_torch.tools.batch_sweep: aggregate
               frames/s over B sequences a step; scripts/batch_sweep.py's
               counterpart

The timed entry itself is vio_msckf_torch/bench.py."""

import subprocess


def card():
    """The card's name and power limit as nvidia-smi prints them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return smi.stdout.strip().splitlines()[0]
