"""The port's image->pose slice against the JAX package on the CPU: the
renderer, a few frames of VIOEngine.step at a reduced config (188x120
stereo, 3 pyramid levels, 2x2 grid, 32 tracks, 6 clones), and a check that
vio_msckf_torch never imports jax.

The checks form one test item on purpose: under `pytest -n N --dist
loadfile`, pytest-xdist hands out files in order of their item count,
most first, so a one-item file is handed out after the long end-to-end
files have started and does not hold one of them back."""

import ast
import inspect
import pathlib
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vio_msckf_tpu import config as jconfig
from vio_msckf_tpu.data.render import render_sequence as jrender
from vio_msckf_tpu.data.simulator import SimConfig, simulate_sequence, bundle_frames
from vio_msckf_tpu.engine import VIOEngine as JEngine
from vio_msckf_torch import cli as tcli
from vio_msckf_torch import config as tconfig
from vio_msckf_torch import convert
from vio_msckf_torch.data import render as trender_mod
from vio_msckf_torch.data.render import render_sequence as trender
from vio_msckf_torch.data import synth_euroc as tsynth
from vio_msckf_torch.engine import VIOEngine as TEngine
from vio_msckf_torch.eskf import EskfVio as TEskfVio
from vio_msckf_torch.eskf import filter as teskf_filter
from vio_msckf_torch.filter import state as tstate
from vio_msckf_torch.filter.msckf import MSCKF as TMSCKF
from vio_msckf_torch.frontend.tracker import StereoTracker
from vio_msckf_torch.ops import rectify as trectify

REPO = pathlib.Path(__file__).resolve().parent.parent
PKG = REPO / "vio_msckf_torch"
# Neither the port nor its smoke run may import these: the machine with the
# GPU has no jax, and the port stands without the JAX package.
FORBIDDEN = ("jax", "jaxlib", "flax", "vio_msckf_tpu")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Tiny CPU ops: one thread avoids oversubscribing parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _small_config(m):
    """The reduced configuration, built by config module m (the JAX
    package's or the port's)."""
    cfg = m.euroc_config()

    def quarter(cam):
        fx, fy, cx, cy = cam.intrinsics
        return m.CameraConfig(intrinsics=(fx / 4, fy / 4, cx / 4, cy / 4),
                              distortion_model=cam.distortion_model,
                              distortion_coeffs=cam.distortion_coeffs,
                              resolution=(188, 120), T_imu_cam=cam.T_imu_cam)

    return cfg.replace(
        cam0=quarter(cfg.cam0), cam1=quarter(cfg.cam1),
        frontend=m.FrontendConfig(grid_row=2, grid_col=2, max_tracks=32, lk_pyramid_levels=2),
        filter=m.FilterConfig(max_cam_state_size=6, max_features=32, max_lost_candidates=16))


@pytest.fixture(scope="module")
def workload():
    """4 moving frames of the bench trajectory, rendered by both packages."""
    cfg, tcfg = _small_config(jconfig), _small_config(tconfig)
    sim = SimConfig(duration=1.16, seed=4, amp=(1.5, 1.0, 0.5), yaw_rate=0.2,
                    wobble_amp=0.1, static_init_time=1.0)
    seq = simulate_sequence(cfg, sim)
    frames, init, first = bundle_frames(seq, cfg)
    n = len(frames["timestamp"])
    R = seq["gt_R_i_w"][first:first + n].transpose(0, 2, 1)
    p = seq["gt_p"][first:first + n]
    j0, j1 = jrender(cfg, R, p, radius=14.0, seed=7, chunk=n)
    t0, t1 = trender(tcfg, R, p, radius=14.0, seed=7, device="cpu")
    return dict(cfg=cfg, tcfg=tcfg, frames=frames, init=init, n=n,
                jimg=(np.asarray(j0), np.asarray(j1)), timg=(t0.numpy(), t1.numpy()))


def _check_renderer(workload):
    # f32 sin of phases ~1e2 rad: a few 1e-4 DN apart (measured 5e-4).
    for j, t in zip(workload["jimg"], workload["timg"]):
        assert t.shape == j.shape == (workload["n"], 120, 188)
        np.testing.assert_allclose(t, j, atol=1e-2)


def _check_engine(workload):
    # Same frames (the JAX renderer's) through both engines: identical
    # track tables and poses to f32 roundoff (measured 1.4e-7 m).
    cfg, init, n = workload["cfg"], workload["init"], workload["n"]
    assert n >= 4
    imu = {k: workload["frames"][k] for k in ("imu_gyro", "imu_acc", "imu_dt", "imu_valid")}
    half = n // 2
    je = JEngine(cfg)
    jf = dict(cam0_img=jnp.asarray(workload["jimg"][0]),
              cam1_img=jnp.asarray(workload["jimg"][1]),
              **{k: jnp.asarray(v) for k, v in imu.items()})
    first_half = jax.tree_util.tree_map(lambda x: x[:half], jf)
    second_half = jax.tree_util.tree_map(lambda x: x[half:2 * half], jf)
    carry0 = je.init(init["q0"], init["bg0"], init["gravity"])
    # Compiled once ahead of time: the returned carry differs from the
    # initial one in weak types only, which would make jit recompile.
    run = jax.jit(je.run_sequence).lower(carry0, first_half).compile()
    jc1, jo1 = run(carry0, first_half)
    jc2, jo2 = run(jc1, second_half)
    jp = np.concatenate([np.asarray(jo1.p), np.asarray(jo2.p)])

    te = TEngine(workload["tcfg"], device="cpu")
    tf = dict(cam0_img=torch.from_numpy(workload["jimg"][0]),
              cam1_img=torch.from_numpy(workload["jimg"][1]),
              **{k: torch.as_tensor(v) for k, v in imu.items()})
    tc, to = te.run_sequence(te.init(init["q0"], init["bg0"], init["gravity"]),
                             {k: v[:2 * half] for k, v in tf.items()})
    np.testing.assert_allclose(to.p.numpy(), jp, atol=1e-4)
    jts, tts = jax.tree_util.tree_map(np.asarray, jc2[0]), tc[0]
    assert jts.valid.sum() >= 8
    np.testing.assert_array_equal(tts.ids.numpy(), jts.ids)
    np.testing.assert_array_equal(tts.valid.numpy(), jts.valid)
    np.testing.assert_allclose(tts.cam0_pts.numpy(), jts.cam0_pts, atol=1e-3)
    np.testing.assert_allclose(tts.cam1_pts.numpy(), jts.cam1_pts, atol=1e-3)

    # Resuming from the JAX carry (lane-row pyramid included) converted by
    # convert.from_numpy_tree gives the same second half.
    carry = convert.from_numpy_tree(jax.tree_util.tree_map(np.asarray, jc1), device="cpu")
    _, to2 = te.run_sequence(carry, {k: v[half:2 * half] for k, v in tf.items()})
    np.testing.assert_allclose(to2.p.numpy(), np.asarray(jo2.p), atol=1e-4)


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def _check_port_never_imports_jax():
    files = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) >= 20
    for f in files:
        for mod in _imports(f):
            assert mod.split(".")[0] not in FORBIDDEN, f"{f.name} imports {mod}"
    # Every module imports in a process where none of them can be imported
    # (__main__ is read above but not imported: importing it runs the CLI).
    mods = [".".join(f.relative_to(REPO).with_suffix("").parts) for f in files
            if f.name != "__main__.py"]
    for m in ("cli", "viewer", "eskf.pipeline", "eskf.filter", "ops.orb", "ops.rectify",
              "runtime.native_loader", "data.euroc", "data.png", "data.synth_euroc",
              "utils.checkpoint", "utils.logging"):
        assert f"vio_msckf_torch.{m}" in mods, m
    code = ("import sys\n"
            + "".join(f"sys.modules[{m!r}] = None\n" for m in FORBIDDEN)
            + "".join(f"import {m.removesuffix('.__init__')}\n" for m in mods)
            + f"assert not any(k.split('.')[0] in {FORBIDDEN!r} and sys.modules[k] "
              "is not None for k in sys.modules)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]


def _check_entry_points_default_to_cuda():
    # The port runs on the card unless the caller asks for the CPU; with no
    # CUDA device, building the engine raises PyTorch's own error instead of
    # quietly making CPU tensors.
    entry_points = (TEngine.__init__, TMSCKF.__init__, StereoTracker.__init__,
                    tstate.make_params, tstate.init_feature_map,
                    trender_mod.make_texture_basis, trender_mod.pixel_ray_lut,
                    trender_mod.render_sequence, convert.from_numpy_tree,
                    TEskfVio.__init__, teskf_filter.init_state, teskf_filter.init_covariance,
                    trectify.rectify_map, tsynth.write_synthetic_euroc)
    for fn in entry_points:
        default = inspect.signature(fn).parameters["device"].default
        assert default == "cuda", f"{fn.__qualname__} defaults to {default!r}"
    assert tcli.build_parser().parse_args(["--demo"]).device == "cuda"
    if not torch.cuda.is_available():
        for build in (lambda: TEngine(tconfig.euroc_config()),
                      lambda: TEskfVio(tconfig.euroc_config()),
                      lambda: tcli.main(["--demo"]),
                      lambda: tcli.main(["--path", "no-such-dir", "--pipeline", "eskf"])):
            with pytest.raises((AssertionError, RuntimeError), match="CUDA|cuda|NVIDIA"):
                build()


def test_slice_matches_jax(workload):
    _check_entry_points_default_to_cuda()
    _check_renderer(workload)
    _check_engine(workload)
    _check_port_never_imports_jax()
