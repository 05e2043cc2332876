"""vio_msckf_torch — the stereo MSCKF visual-inertial odometry engine in
PyTorch, with hand-written CUDA kernels for an NVIDIA Hopper GPU.

A port of vio_msckf_tpu (JAX), which stays in the repository as the
reference the port is tested against. The layout mirrors it:

  config.py  the engine configuration (the JAX package's, minus its
             backend switches)
  math/      JPL quaternion + SE(3) primitives
  ops/       image ops (pyramid, distortion, FAST, LK) and the gate solve;
             the three hand kernels live behind ops/fast.py, ops/klt.py and
             ops/spd.py, their CUDA sources under csrc/
  filter/    the MSCKF estimator core
  frontend/  the stereo feature tracker
  engine.py  front-end + filter, one frame per `step`
  data/      the trajectory simulator, IMU bundling and the renderer
  utils/     trajectory metrics (ATE, RPE)
  convert.py state conversion from and to the JAX package's pytrees

Every kernel wrapper dispatches on the device of its input: a CUDA tensor
launches the kernel (or raises), a CPU tensor takes the plain PyTorch twin
beside it. No module imports jax or the JAX package.
"""

import torch

__version__ = "0.1.0"


def full_precision():
    """Keep every f32 matmul and convolution in full f32.

    The filter cannot survive reduced-precision products: the reference
    diverged to km-scale ATE with them (vio_msckf_tpu/filter/msckf.py
    pins HIGHEST for that reason). cuDNN defaults to TF32 on Ampere and
    later, so both switches are set explicitly."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
