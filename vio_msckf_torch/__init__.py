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
  graph.py   the compiled step: a CUDA graph of one step, captured per
             shape and replayed per frame (the JAX package's jax.jit)
  eskf/      the second pipeline: rectified ORB stereo + an 18-state ESKF
             (ops/rectify.py, ops/orb.py)
  data/      the trajectory simulator, IMU bundling, the renderer, the
             EuRoC reader and writer, a numpy + zlib PNG codec
  runtime/   the native PNG prefetch ring (C++, built at first use)
  parallel/  scale-out over torch.distributed ranks: sequence replicas x
             feature blocks, the butterfly TSQR update (comm.py: the
             collectives), the rank entry point and the multi-rank dry run
  utils/     trajectory metrics (ATE, RPE), logging, checkpoints
  cli.py     `python -m vio_msckf_torch`: EuRoC --path, --demo, --pipeline
             eskf, TUM output, checkpoints (viewer.py: the live viewer)
  convert.py state conversion from and to the JAX package's pytrees
  bench.py   `python -m vio_msckf_torch.bench`: the timed entry (default,
             --suite, --scaling), the repository bench.py's counterpart
  tools/     measurement tools: profile_ops (the device profile of the
             step), batch_sweep (aggregate frames/s over B)

Every kernel wrapper dispatches on the device of its input: a CUDA tensor
launches the kernel (or raises), a CPU tensor takes the plain PyTorch twin
beside it. The entry points that build state (VIOEngine, StereoTracker,
MSCKF, make_params, init_feature_map, the renderer, from_numpy_tree,
EskfVio, the CLI's --device) put it on "cuda" unless the caller passes
another device; without a CUDA device they raise PyTorch's own error
rather than fall back to the CPU.
No module imports jax or the JAX package.
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
