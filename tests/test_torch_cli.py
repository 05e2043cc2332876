"""The port's user entry point on the CPU: the EuRoC reader, the PNG codec,
the loader rings, the TUM writer, the parser, checkpoints, the viewer and
`python -m vio_msckf_torch --path` end to end, held against the JAX
package (or PIL) on the same files.

The EuRoC tree is written by the port's writer (data/synth_euroc.py) at the
reduced configuration of tests/test_torch_slice.py (188x120 stereo);
`cli.euroc_config` is monkeypatched to that configuration. The JAX CLI
itself is not run here (its EuRoC test takes minutes).

One test item (see tests/test_torch_slice.py on xdist's file order)."""

import dataclasses
import io
import struct
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from test_torch_slice import _small_config
from vio_msckf_tpu import cli as jcli
from vio_msckf_tpu import config as jconfig
from vio_msckf_tpu.data import euroc as jeuroc
from vio_msckf_torch import cli as tcli
from vio_msckf_torch import config as tconfig
from vio_msckf_torch.data import euroc as teuroc
from vio_msckf_torch.data import png
from vio_msckf_torch.data.simulator import SimConfig
from vio_msckf_torch.data.synth_euroc import write_synthetic_euroc
from vio_msckf_torch.engine import VIOEngine
from vio_msckf_torch.runtime import native_loader
from vio_msckf_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from vio_msckf_torch.viewer import Viewer

# 9 frames after the 1 s gravity initialization: two chunks of 4 and 1
# tail frame.
SIM = SimConfig(duration=1.45, seed=4, amp=(1.5, 1.0, 0.5), yaw_rate=0.2, wobble_amp=0.1,
                static_init_time=1.0)
CHUNK = 4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("euroc")
    write_synthetic_euroc(str(root), _small_config(tconfig), SIM, device="cpu")
    return str(root)


def _check_reader(root):
    # The port's reader and bundling equal the JAX package's exactly.
    jseq, tseq = jeuroc.EuRoCSequence(root, 0.0), teuroc.EuRoCSequence(root, 0.0)
    for k in ("t", "gyro", "acc"):
        np.testing.assert_array_equal(tseq.imu[k], jseq.imu[k])
    for k in jseq.groundtruth:
        np.testing.assert_array_equal(tseq.groundtruth[k], jseq.groundtruth[k])
    assert tseq.cam0_files == jseq.cam0_files and tseq.cam1_files == jseq.cam1_files
    np.testing.assert_array_equal(tseq.frame_times, jseq.frame_times)
    jb = jeuroc.bundle_euroc_frames(jseq, _small_config(jconfig))
    tb = teuroc.bundle_euroc_frames(tseq, _small_config(tconfig))
    for k in jb[0]:
        np.testing.assert_array_equal(tb[0][k], jb[0][k])
    for k in jb[1]:
        np.testing.assert_array_equal(tb[1][k], jb[1][k])
    assert tb[2] == jb[2]
    np.testing.assert_array_equal(tb[3], jb[3])
    np.testing.assert_array_equal(tseq.gt_aligned_positions(tb[3]),
                                  jseq.gt_aligned_positions(jb[3]))
    for k in (0, len(tb[3]) - 1):
        for cam in (0, 1):
            np.testing.assert_array_equal(tseq.load_image(tb[2] + k, cam),
                                          jseq.load_image(jb[2] + k, cam))
    n = len(tb[3])
    assert n % CHUNK and n > 2 * CHUNK, n
    return tseq, tb


def _filtered_png(img, kinds):
    """A PNG of img whose row r uses filter kinds[r % len(kinds)], filtered
    by a per-pixel reference of the PNG specification."""
    H, W = img.shape
    x = img.astype(np.int64)
    rows = []
    for r in range(H):
        kind = kinds[r % len(kinds)]
        up = x[r - 1] if r else np.zeros(W, np.int64)
        out = []
        for c in range(W):
            a = x[r, c - 1] if c else 0
            b = up[c]
            cc = up[c - 1] if c else 0
            if kind == 0:
                pred = 0
            elif kind == 1:
                pred = a
            elif kind == 2:
                pred = b
            elif kind == 3:
                pred = (a + b) // 2
            else:
                p = a + b - cc
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - cc)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else cc)
            out.append((x[r, c] - pred) % 256)
        rows.append(bytes([kind] + out))

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data)))

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, 0, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(rows))) + chunk(b"IEND", b""))


def _check_png(tseq):
    # The numpy+zlib decoder equals PIL bit for bit: on PIL-written PNGs
    # (adaptive filters), on PNGs of every filter type, and on the port's.
    frame = teuroc.load_png_gray(tseq.cam0_files[3])
    rng = np.random.default_rng(2)
    noise = rng.integers(0, 256, (37, 53), dtype=np.uint8)
    for img in (frame, noise, np.zeros((5, 7), np.uint8)):
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, format="PNG")
        np.testing.assert_array_equal(png.decode_png_gray(buf.getvalue()), img)
        own = png.encode_png_gray(img)
        np.testing.assert_array_equal(png.decode_png_gray(own), img)
        np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(own))), img)
    for kinds in ((0, 1, 2, 3, 4), (4,), (3,)):
        data = _filtered_png(frame[:20, :40], kinds)
        np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data))), frame[:20, :40])
        np.testing.assert_array_equal(png.decode_png_gray(data), frame[:20, :40])
    for name in tseq.cam1_files[:2]:
        np.testing.assert_array_equal(png.decode_png_gray(name),
                                      np.asarray(Image.open(name).convert("L")))
    with pytest.raises(ValueError, match="grayscale"):
        buf = io.BytesIO()
        Image.fromarray(np.zeros((4, 4, 3), np.uint8)).save(buf, format="PNG")
        png.decode_png_gray(buf.getvalue())


def _check_loaders(tseq):
    # Both rings hand frames over in path order, at ring sizes below and
    # above the number of frames.
    paths = tseq.cam0_files
    want = [png.decode_png_gray(p) for p in paths]
    W, H = want[0].shape[::-1]
    assert native_loader.available(), native_loader.decoder_name()
    for cls in (native_loader.PrefetchingLoader, native_loader.PoolLoader):
        for ring, threads in ((2, 3), (64, 4)):
            loader = cls(paths, W, H, ring=ring, threads=threads)
            got = list(loader)
            loader.close()
            assert [i for i, _ in got] == list(range(len(paths)))
            for (_, a), b in zip(got, want):
                np.testing.assert_array_equal(a, b)


def _check_tum(tmp_path):
    # Byte-identical TUM files from the same rotations, every branch of the
    # matrix -> quaternion conversion included.
    rng = np.random.default_rng(3)
    Rs = [np.eye(3), np.diag([1.0, -1.0, -1.0]), np.diag([-1.0, 1.0, -1.0]),
          np.diag([-1.0, -1.0, 1.0])]
    for _ in range(12):
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        Rs.append(q * np.sign(np.linalg.det(q)))
    for R in Rs:
        np.testing.assert_array_equal(tcli._rot_to_hamilton_xyzw(R),
                                      jcli._rot_to_hamilton_xyzw(R))
    times = 1403636579.0 + 0.05 * np.arange(len(Rs))
    pos = rng.normal(size=(len(Rs), 3))
    tcli.write_tum(tmp_path / "t.txt", times, pos, Rs)
    jcli.write_tum(tmp_path / "j.txt", times, pos, Rs)
    assert (tmp_path / "t.txt").read_bytes() == (tmp_path / "j.txt").read_bytes()


def _check_parser():
    def flags(parser):
        return {a.dest: (tuple(a.option_strings), a.default, a.type, a.choices, a.nargs,
                         type(a).__name__) for a in parser._actions if a.dest != "help"}

    j, t = flags(jcli.build_parser()), flags(tcli.build_parser())
    assert j.pop("platform") and j.pop("compile_cache")
    assert t.pop("device") == (("--device",), "cuda", None, None, None, "_StoreAction")
    assert t == j


def _tum_positions(path):
    return np.loadtxt(path, ndmin=2)[:, 1:4]


def _check_cli(root, tseq, tb, tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(tcli, "euroc_config", lambda: _small_config(tconfig))
    common = ["--path", root, "--offset", "0", "--device", "cpu", "--chunk", str(CHUNK)]

    def run(name, *extra):
        out = tmp_path / f"{name}.txt"
        ckpt = tmp_path / f"{name}.ckpt"
        assert tcli.main(common + ["--out", str(out), "--checkpoint", str(ckpt), *extra]) == 0
        printed = capsys.readouterr().out
        assert "dataset_fps" in printed and "ate_rmse_m" in printed, printed
        return out, ckpt

    modes = {"chunked": run("chunked"), "preload": run("preload", "--preload"),
             "per-frame": run("per_frame", "--ratio", "1000")}
    ref = _tum_positions(modes["chunked"][0])
    n = len(tb[3])
    assert ref.shape == (n, 3) and np.isfinite(ref).all()
    for name, (out, _) in modes.items():
        assert out.read_text() == modes["chunked"][0].read_text(), name

    # The same decoded frames through VIOEngine.run_sequence at once.
    frames, init, first, _ = tb
    eng = VIOEngine(_small_config(tconfig), device="cpu")
    imgs = [np.stack([tseq.load_image(first + k, cam) for k in range(n)]) for cam in (0, 1)]
    carry, outs = eng.run_sequence(
        eng.init(init["q0"], init["bg0"], init["gravity"]),
        dict(cam0_img=torch.from_numpy(imgs[0]), cam1_img=torch.from_numpy(imgs[1]),
             **{k: torch.as_tensor(frames[k]) for k in ("imu_gyro", "imu_acc", "imu_dt",
                                                         "imu_valid")}))
    np.testing.assert_allclose(ref, outs.p.numpy(), atol=1e-6)
    final = []
    for name, (_, ckpt) in modes.items():
        c, step, _ = load_checkpoint(ckpt, carry)
        assert step == n
        final.append(c[1].p)
        assert torch.equal(c[1].p, carry[1].p), name

    # Checkpoint after the first 2 chunks, resume from it: the same final
    # pose as the run that was not interrupted.
    k_ck = 2 * CHUNK
    run("first_part", "--max-frames", str(k_ck), "--checkpoint-every", str(k_ck))
    part = tmp_path / "first_part.ckpt"
    assert load_checkpoint(part, carry)[1] == k_ck
    out, ckpt = run("resumed", "--resume", str(part))
    np.testing.assert_array_equal(_tum_positions(out), ref[k_ck:])
    c, step, _ = load_checkpoint(ckpt, carry)
    assert step == n and torch.equal(c[1].p, carry[1].p)
    return carry


def _check_checkpoint_rules(carry, tmp_path):
    path = tmp_path / "rt.ckpt"
    save_checkpoint(path, carry, step=42, extra={"note": "x"})
    back, step, extra = load_checkpoint(path, carry)
    assert step == 42 and extra == {"note": "x"}
    for rec, rec2 in zip(carry, back):
        for f in dataclasses.fields(rec):
            a, b = getattr(rec, f.name), getattr(rec2, f.name)
            for x, y in zip(*((a, b) if isinstance(a, list) else ([a], [b]))):
                assert torch.equal(x, y) and x.dtype == y.dtype, f.name
    save_checkpoint(path, (torch.zeros(3),))
    with pytest.raises(ValueError, match="saved"):
        load_checkpoint(path, (torch.zeros(4),))
    with pytest.raises(ValueError, match="saved"):
        load_checkpoint(path, (torch.zeros(3, dtype=torch.float64),))
    with pytest.raises(ValueError, match="tensors"):
        load_checkpoint(path, (torch.zeros(3), torch.zeros(3)))


def _check_viewer(tmp_path):
    out = tmp_path / "live.png"
    viewer = Viewer(str(out), interval=0.0)
    for k in range(5):
        viewer.update_pose([0.1 * k, 0.0, 0.05 * k])
    viewer.update_image(np.zeros((120, 188), np.uint8))
    viewer.close(timeout=60.0)
    assert out.exists() and out.stat().st_size > 1000


def test_cli_matches_jax(tree, tmp_path, monkeypatch, capsys):
    tseq, tb = _check_reader(tree)
    _check_png(tseq)
    _check_loaders(tseq)
    _check_tum(tmp_path)
    _check_parser()
    carry = _check_cli(tree, tseq, tb, tmp_path, monkeypatch, capsys)
    _check_checkpoint_rules(carry, tmp_path)
    _check_viewer(tmp_path)
