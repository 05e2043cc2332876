"""The plain reference that decides each cell's `correct`.

A frozen copy of the PyTorch port's eager path (vio_msckf_torch at the
commit that added this benchmark): the same frozen configuration, state
records, front-end, MSCKF and ESKF, with every hand kernel replaced by its
PyTorch twin (FAST-9 + NMS as `fast_score_map`, the LK pyramid walk as
`track_pyramid_plain`, the gate's SPD solve as a Cholesky solve), no CUDA
graph and no process group. It imports nothing of vio_msckf_torch and
takes no tensor the program made, except where the check follows the
program from its own state (benchmark/check.py says where).

Precision is the caller's: `set_precision` before building or stepping.
"""

import contextlib

import torch


def set_precision(tf32):
    """f32 products in full f32 (tf32=False: what the configurations
    state), or in TF32 (the control, one precision below)."""
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    torch.set_float32_matmul_precision("high" if tf32 else "highest")


def full_precision():
    """Full f32 products (the renderer's inputs are always made so)."""
    set_precision(False)


@contextlib.contextmanager
def capturable_linalg():
    """Dense linear algebra on cuSOLVER and cuBLAS inside the block, as the
    port's step runs it (MAGMA's batched LU would round otherwise)."""
    if not torch.backends.cuda.is_built():
        yield
        return
    before = torch.backends.cuda.preferred_linalg_library()
    torch.backends.cuda.preferred_linalg_library("cusolver")
    try:
        yield
    finally:
        torch.backends.cuda.preferred_linalg_library(before)
