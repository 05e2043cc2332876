"""Command-line entry point. The port's counterpart of vio_msckf_tpu/cli.py.

    python -m vio_msckf_torch --path /data/MH_01_easy            # EuRoC run
    python -m vio_msckf_torch --demo                             # synthetic
    python -m vio_msckf_torch --path ... --pipeline eskf         # 2nd pipeline
    python -m vio_msckf_torch --path ... --view                  # live viewer

Runs on the GPU unless `--device cpu` is given; without a CUDA device and
without that flag it raises. The flags are the JAX CLI's, with two
differences: `--device` replaces `--platform`, and there is no
`--compile-cache` (nothing is compiled ahead of a run but the hand kernels,
which build once into vio_msckf_torch/build/).

The EuRoC path has three modes, as the JAX CLI does:
  * chunked (the default): CHUNK uint8 frames per camera are staged in one
    of two pinned host buffers and copied on a copy stream while the
    previous chunk computes; the compute stream waits on the copy. A step
    never synchronises the host, so the host queues chunks ahead, and
    the outputs stay on the device until one fetch at the end;
  * --preload: decode everything, one host-to-device copy, one pass, then
    a second (warm) pass that prints the compute rate alone;
  * per frame (--ratio > 0 or --view): real-time pacing and the viewer.

Every mode, and the ESKF, replays one captured CUDA graph of the step per
frame on a CUDA device (graph.CompiledStep: the JAX CLI jits the step).
"""

import argparse
import sys
import time

import numpy as np
import torch

from vio_msckf_torch.config import euroc_config


def _rot_to_hamilton_xyzw(R):
    """Rotation MATRIX (body->world) -> Hamilton xyzw quaternion (TUM)."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        w = 0.25 * s
        x = (R[2, 1] - R[1, 2]) / s
        y = (R[0, 2] - R[2, 0]) / s
        z = (R[1, 0] - R[0, 1]) / s
    elif R[0, 0] > R[1, 1] and R[0, 0] > R[2, 2]:
        s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
        w = (R[2, 1] - R[1, 2]) / s
        x = 0.25 * s
        y = (R[0, 1] + R[1, 0]) / s
        z = (R[0, 2] + R[2, 0]) / s
    elif R[1, 1] > R[2, 2]:
        s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2
        w = (R[0, 2] - R[2, 0]) / s
        x = (R[0, 1] + R[1, 0]) / s
        y = 0.25 * s
        z = (R[1, 2] + R[2, 1]) / s
    else:
        s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2
        w = (R[1, 0] - R[0, 1]) / s
        x = (R[0, 2] + R[2, 0]) / s
        y = (R[1, 2] + R[2, 1]) / s
        z = 0.25 * s
    return np.array([x, y, z, w])


def write_tum(path, times, positions, rotations_w_b):
    """TUM trajectory: t x y z qx qy qz qw (body->world)."""
    with open(path, "w") as f:
        for t, p, R in zip(times, positions, rotations_w_b):
            q = _rot_to_hamilton_xyzw(R)
            f.write(
                f"{t:.9f} {p[0]:.6f} {p[1]:.6f} {p[2]:.6f} "
                f"{q[0]:.9f} {q[1]:.9f} {q[2]:.9f} {q[3]:.9f}\n"
            )


def build_parser():
    ap = argparse.ArgumentParser(
        "vio_msckf_torch", description="Stereo MSCKF / ESKF VIO on a CUDA GPU (PyTorch)"
    )
    ap.add_argument("--path", help="EuRoC sequence dir (contains mav0/)")
    ap.add_argument("--demo", action="store_true",
                    help="run on the synthetic rendered world (no dataset)")
    ap.add_argument("--pipeline", choices=["msckf", "eskf"], default="msckf")
    ap.add_argument("--offset", type=float, default=40.0,
                    help="start offset seconds (reference vio.py:88)")
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--ratio", type=float, default=0.0,
                    help="real-time replay rate (0 = as fast as possible; "
                         "the reference ships 0.4, vio.py:100)")
    ap.add_argument("--chunk", type=int, default=32,
                    help="frames per staged host-to-device copy on the dataset "
                         "path (headless as-fast-as-possible mode only)")
    ap.add_argument("--preload", action="store_true",
                    help="stage the whole decoded sequence on the device, then "
                         "run it in one pass (steady-state throughput; reports "
                         "load and compute separately)")
    ap.add_argument("--view", action="store_true",
                    help="live viewer process -> vio_live.png")
    ap.add_argument("--out", default=None,
                    help="write estimated trajectory (TUM format)")
    ap.add_argument("--checkpoint", default=None, help="checkpoint file to write")
    ap.add_argument("--checkpoint-every", type=int, default=500)
    ap.add_argument("--resume", default=None, help="checkpoint file to resume from")
    ap.add_argument("--profile", default=None,
                    help="torch.profiler trace directory")
    ap.add_argument("--demo-duration", type=float, default=12.0)
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda; cpu only when asked)")
    return ap


class ChunkStager:
    """Double-buffered host-to-device staging of uint8 stereo chunks.

    Slot j holds a pinned host buffer and a device buffer of shape
    (2, chunk, H, W). `stage` fills the host buffer, copies it on the copy
    stream and makes the compute stream wait for that copy. Two events per
    slot guard the two hazards: the host does not refill a pinned buffer
    before its last copy has finished (`copied`), and a copy does not
    overwrite a device buffer before the chunk that read it has finished
    (`consumed`, recorded by `release` after that chunk's work is queued).
    On the CPU the copy is a plain one."""

    def __init__(self, chunk, height, width, device):
        self.device = device
        self.cuda = device.type == "cuda"
        shape = (2, chunk, height, width)
        self.host = [torch.empty(shape, dtype=torch.uint8, pin_memory=self.cuda)
                     for _ in range(2)]
        self.dev = [torch.empty(shape, dtype=torch.uint8, device=device) for _ in range(2)]
        if self.cuda:
            self.copy_stream = torch.cuda.Stream(device)
            self.copied = [torch.cuda.Event() for _ in range(2)]
            self.consumed = [torch.cuda.Event() for _ in range(2)]

    def stage(self, slot, m, fill):
        """fill(host (2, m, H, W) numpy view) writes the frames; returns the
        device view (2, m, H, W) the compute stream may read."""
        if self.cuda:
            self.copied[slot].synchronize()
        fill(self.host[slot].numpy()[:, :m])
        src, dst = self.host[slot][:, :m], self.dev[slot][:, :m]
        if not self.cuda:
            dst.copy_(src)
            return dst
        self.copy_stream.wait_event(self.consumed[slot])
        with torch.cuda.stream(self.copy_stream):
            dst.copy_(src, non_blocking=True)
            self.copied[slot].record(self.copy_stream)
        torch.cuda.current_stream(self.device).wait_event(self.copied[slot])
        return dst

    def release(self, slot):
        """Mark the work queued so far as the last reader of slot's buffer."""
        if self.cuda:
            self.consumed[slot].record(torch.cuda.current_stream(self.device))


def _to_device(img, device):
    """A decoded (H, W) uint8 frame on the device: through pinned memory
    and a copy that does not make the host wait for the queued work."""
    t = torch.from_numpy(img)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _imu_frames(frames, device):
    return {k: torch.as_tensor(frames[k], device=device)
            for k in ("imu_gyro", "imu_acc", "imu_dt", "imu_valid")}


def _tum_rotations(qs):
    """JPL world->IMU quaternions (n, 4) -> body->world matrices (n, 3, 3)."""
    from vio_msckf_torch.math import quat_to_rot

    return quat_to_rot(torch.as_tensor(np.asarray(qs, np.float32))).transpose(-1, -2).numpy()


def _report(args, seq, log, times, positions, quats):
    """TUM file and ATE / RPE against ground truth, as the JAX CLI prints."""
    from vio_msckf_torch.utils.metrics import ate_rmse, rpe_rmse

    if args.out:
        write_tum(args.out, times, positions, _tum_rotations(quats))
        log.info("trajectory -> %s", args.out)
    gt = seq.gt_aligned_positions(times)
    if gt is not None:
        ate = ate_rmse(positions, gt, align=True)
        rpe = rpe_rmse(positions, gt)
        log.info("ATE RMSE (SE3-aligned): %.4f m  RPE RMSE (20-frame "
                 "delta): %.4f m", ate, rpe)
        print(f"ate_rmse_m {ate:.4f}")
        print(f"rpe_rmse_m {rpe:.4f}")


def _warn_overflow(log, n_overflow):
    if n_overflow:
        log.warning("lost-candidate overflow: %d feature updates discarded "
                    "(raise FilterConfig.max_lost_candidates)", n_overflow)


def run_msckf_euroc(args, log):
    from vio_msckf_torch.data.euroc import EuRoCSequence, bundle_euroc_frames
    from vio_msckf_torch.engine import VIOEngine
    from vio_msckf_torch.runtime import native_loader
    from vio_msckf_torch.tensors import index_record
    from vio_msckf_torch.utils.checkpoint import load_checkpoint, save_checkpoint
    from vio_msckf_torch.utils.logging import StageTimer, maybe_profile

    device = torch.device(args.device)
    cfg = euroc_config()
    seq = EuRoCSequence(args.path, start_offset=args.offset)
    frames, init, first, frame_times = bundle_euroc_frames(seq, cfg, max_frames=args.max_frames)
    n = len(frame_times)
    log.info("sequence: %d frames after offset", n)

    eng = VIOEngine(cfg, device)
    carry = eng.init(init["q0"], init["bg0"], init["gravity"])
    start_k = 0
    if args.resume:
        carry, start_k, _ = load_checkpoint(args.resume, carry)
        log.info("resumed from %s at frame %d", args.resume, start_k)
    imu = _imu_frames(frames, device)

    W, H = cfg.cam0.resolution
    log.info("PNG decoder: %s", native_loader.decoder_name())
    rings = [native_loader.open_loader(seq.image_paths(first + start_k, n - start_k, cam), W, H)
             for cam in (0, 1)]
    streams = [iter(r) for r in rings]

    def load():
        """The next stereo pair, in order."""
        return next(streams[0])[1], next(streams[1])[1]

    viewer = None
    if args.view:
        from vio_msckf_torch.viewer import Viewer
        viewer = Viewer()

    chunked = args.ratio <= 0 and viewer is None
    if args.preload and not chunked:
        log.warning("--preload is ignored with --ratio > 0 or --view (those modes "
                    "step per frame by their nature)")
    try:
        if chunked and args.preload:
            return _run_preload(args, log, seq, eng, carry, imu, load, start_k, n, frame_times)

        timer = StageTimer()
        p_out, q_out = [], []
        wall0 = time.time()
        t0 = frame_times[start_k] if n else 0.0
        with maybe_profile(args.profile):
            if chunked:
                CHUNK = max(1, min(args.chunk, max(n - start_k, 1)))
                stager = ChunkStager(CHUNK, H, W, device)
                overflow = []
                # Full chunks, then the tail frames (< CHUNK) as one shorter
                # chunk: run_sequence replays one captured step per frame,
                # keyed without the chunk's length, so the last chunk
                # replays the same graph.
                bounds = list(range(start_k, n, CHUNK))

                def fill(m):
                    def write(host):
                        for j in range(m):
                            host[0, j], host[1, j] = load()
                    return write

                def stage(ci):
                    k0 = bounds[ci]
                    m = min(CHUNK, n - k0)
                    with timer.stage("load"):
                        return stager.stage(ci % 2, m, fill(m)), k0, m

                staged = stage(0) if bounds else None
                for ci in range(len(bounds)):
                    imgs, k0, m = staged
                    with timer.stage("dispatch"):
                        chunk = dict(cam0_img=imgs[0], cam1_img=imgs[1],
                                     **{k: v[k0:k0 + m] for k, v in imu.items()})
                        carry, outs = eng.run_sequence(carry, chunk)
                        stager.release(ci % 2)
                    overflow.append(outs.lost_overflow)
                    p_out.append(outs.p)
                    q_out.append(outs.q)
                    # Decode + stage the NEXT chunk while this one computes;
                    # the outputs stay on the device.
                    if ci + 1 < len(bounds):
                        staged = stage(ci + 1)
                    k = k0 + m
                    if args.checkpoint and m == CHUNK and (
                        (k - start_k) // CHUNK
                    ) % max(args.checkpoint_every // CHUNK, 1) == 0:
                        save_checkpoint(args.checkpoint, carry, step=k)
                        log.info("checkpoint @ frame %d -> %s", k, args.checkpoint)
                    if ci % 8 == 0:
                        log.info("dispatched frames %d/%d", k, n)
                with timer.stage("fetch"):
                    positions = torch.cat(p_out).cpu().numpy() if p_out else np.zeros((0, 3))
                    quats = torch.cat(q_out).cpu().numpy() if q_out else np.zeros((0, 4))
                    n_overflow = int(torch.cat(overflow).sum()) if overflow else 0
                _warn_overflow(log, n_overflow)
            else:
                for k in range(start_k, n):
                    with timer.stage("load"):
                        img0, img1 = load()
                    if args.ratio > 0:
                        # DataPublisher pacing (dataset.py:262-263)
                        lag = (frame_times[k] - t0) / args.ratio - (time.time() - wall0)
                        if lag > 0:
                            time.sleep(lag)
                    with timer.stage("step"):
                        frame = dict(cam0_img=_to_device(img0, device),
                                     cam1_img=_to_device(img1, device),
                                     **{key: v[k] for key, v in imu.items()})
                        # One frame through the captured step (jax.jit(eng.step)).
                        carry, outs = eng.run_sequence(
                            carry, {key: v[None] for key, v in frame.items()})
                        out = index_record(outs, 0)
                        p = out.p.cpu().numpy()
                    p_out.append(p)
                    q_out.append(out.q.cpu().numpy())
                    if viewer is not None:
                        viewer.update_pose(p)
                        if k % 5 == 0:
                            viewer.update_image(img0)
                    if args.checkpoint and (k + 1) % args.checkpoint_every == 0:
                        save_checkpoint(args.checkpoint, carry, step=k + 1)
                        log.info("checkpoint @ frame %d -> %s", k + 1, args.checkpoint)
                    if k % 100 == 0:
                        log.info("frame %d/%d p=%s", k, n, np.round(p, 3))
                positions = np.stack(p_out) if p_out else np.zeros((0, 3))
                quats = np.stack(q_out) if q_out else np.zeros((0, 4))
    finally:
        for r in rings:
            r.close()

    wall = time.time() - wall0
    n_done = n - start_k
    log.info("done: %d frames in %.1fs (%.1f fps)", n_done, wall, n_done / max(wall, 1e-9))
    log.info("stage timing:\n%s", timer.report())
    print(f"dataset_fps {n_done / max(wall, 1e-9):.2f}")

    if viewer is not None:
        viewer.close()
    if args.checkpoint:
        save_checkpoint(args.checkpoint, carry, step=n)
    _report(args, seq, log, frame_times[start_k:n], positions, quats)
    return 0


def _run_preload(args, log, seq, eng, carry, imu, load, start_k, n, frame_times):
    """Whole-sequence staging: decode everything, one host-to-device copy,
    one pass, one fetch; then the same pass again from the same carry,
    timed alone (`dataset_fps_compute`)."""
    from vio_msckf_torch.utils.checkpoint import save_checkpoint

    device = eng.device
    t0 = time.time()
    m = n - start_k
    W, H = eng.config.cam0.resolution
    host = np.empty((2, m, H, W), np.uint8)
    for j in range(m):
        host[0, j], host[1, j] = load()
    imgs = torch.from_numpy(host).to(device)
    dev_frames = dict(cam0_img=imgs[0], cam1_img=imgs[1],
                      **{k: v[start_k:n] for k, v in imu.items()})
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t_load = time.time() - t0
    carry0 = carry              # run_sequence leaves the carry it is given as it was

    def run(c):
        t = time.time()
        c, outs = eng.run_sequence(c, dev_frames)
        p = outs.p.cpu().numpy()              # one fetch; ends the pass
        return c, outs, p, time.time() - t

    carry, outs, positions, t_first = run(carry)
    log.info("preload first run: %.1fs", t_first)
    _, _, _, t_compute = run(carry0)
    quats = outs.q.cpu().numpy()
    _warn_overflow(log, int(outs.lost_overflow.sum()))
    log.info("preload: decode+H2D %.1fs, compute %.1fs (%.1f fps)",
             t_load, t_compute, m / t_compute)
    print(f"dataset_fps_compute {m / t_compute:.2f}")
    print(f"dataset_fps {m / max(t_load + t_compute, 1e-9):.2f}")
    if args.checkpoint:
        save_checkpoint(args.checkpoint, carry, step=n)
    _report(args, seq, log, frame_times[start_k:n], positions, quats)
    return 0


def run_msckf_demo(args, log):
    from vio_msckf_torch.data.render import render_sequence
    from vio_msckf_torch.data.simulator import SimConfig, bundle_frames, simulate_sequence
    from vio_msckf_torch.engine import VIOEngine
    from vio_msckf_torch.utils.metrics import ate_rmse

    device = torch.device(args.device)
    cfg = euroc_config()
    sim = SimConfig(duration=args.demo_duration, seed=4, amp=(1.5, 1.0, 0.5), yaw_rate=0.2,
                    wobble_amp=0.1)
    seq = simulate_sequence(cfg, sim)
    frames, init, first = bundle_frames(seq, cfg)
    n = len(frames["timestamp"])
    R_stack = seq["gt_R_i_w"][first:first + n].transpose(0, 2, 1)
    p_stack = seq["gt_p"][first:first + n]
    cam0, cam1 = render_sequence(cfg, R_stack, p_stack, radius=14.0, seed=7, device=device)
    log.info("rendered %d synthetic frames", n)

    eng = VIOEngine(cfg, device)
    carry = eng.init(init["q0"], init["bg0"], init["gravity"])
    t0 = time.time()
    carry, outs = eng.run_sequence(carry, dict(cam0_img=cam0, cam1_img=cam1,
                                               **_imu_frames(frames, device)))
    est = outs.p.cpu().numpy()
    wall = time.time() - t0
    ate = ate_rmse(est, p_stack, align=False)
    log.info("demo: %d frames in %.1fs, ATE %.4f m", n, wall, ate)
    print(f"ate_rmse_m {ate:.4f}")
    return 0


def write_eskf_plots(prefix, times, outs, log):
    """State/covariance trace plots matching the reference's ESKF output
    (ESKF/eskf_vio.py:187-259: position, velocity, biases, gravity traces
    + covariance trace). `outs` holds numpy arrays stacked over frames."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    t = np.asarray(times) - times[0]
    panels = [
        ("position [m]", outs["p"], ("x", "y", "z")),
        ("velocity [m/s]", outs["v"], ("x", "y", "z")),
        ("acc bias", outs["a_b"], ("x", "y", "z")),
        ("gyro bias", outs["w_b"], ("x", "y", "z")),
        ("gravity [m/s^2]", outs["g"], ("x", "y", "z")),
    ]
    fig, axes = plt.subplots(len(panels), 1, figsize=(9, 3 * len(panels)), sharex=True)
    for ax, (name, data, labels) in zip(axes, panels):
        for i, lab in enumerate(labels):
            ax.plot(t, data[:, i], label=lab)
        ax.set_ylabel(name)
        ax.legend(loc="upper right", fontsize=8)
        ax.grid(alpha=0.3)
    axes[-1].set_xlabel("time [s]")
    fig.tight_layout()
    state_png = f"{prefix}_states.png"
    fig.savefig(state_png, dpi=110)
    plt.close(fig)

    fig, ax = plt.subplots(figsize=(9, 3))
    ax.plot(t, outs["cov_trace"])
    ax.set_ylabel("trace(P)")
    ax.set_xlabel("time [s]")
    ax.grid(alpha=0.3)
    fig.tight_layout()
    cov_png = f"{prefix}_cov_trace.png"
    fig.savefig(cov_png, dpi=110)
    plt.close(fig)
    log.info("ESKF trace plots -> %s, %s", state_png, cov_png)


def _eskf_loop(vio, carry, n, frame_at):
    """Step the ESKF over n frames, each through the captured step
    (EskfVio.run_sequence over one frame); outputs stay on the device
    until one fetch at the end. Returns (carry, {key: numpy (n, ...)})."""
    outs = []
    for k in range(n):
        carry, out = vio.run_sequence(carry, {key: v[None] for key, v in frame_at(k).items()})
        outs.append(out)
    return carry, {key: torch.cat([o[key] for o in outs]).cpu().numpy() for key in outs[0]}


def eskf_euroc(args, log):
    """The ESKF over an EuRoC sequence (the `--path` flow of run_eskf
    without the plots). Returns (frame times, outputs, ATE or None)."""
    from vio_msckf_torch.data.euroc import EuRoCSequence, bundle_euroc_frames
    from vio_msckf_torch.eskf import EskfVio
    from vio_msckf_torch.runtime import native_loader
    from vio_msckf_torch.utils.metrics import ate_rmse

    device = torch.device(args.device)
    cfg = euroc_config()
    vio = EskfVio(cfg, device=device)
    seq = EuRoCSequence(args.path, start_offset=args.offset)
    frames, _, first, frame_times = bundle_euroc_frames(seq, cfg, max_frames=args.max_frames)
    n = len(frame_times)
    acc0 = frames["imu_acc"][1][frames["imu_valid"][1]][0]
    carry = vio.init(acc0)
    imu = _imu_frames(frames, device)
    W, H = cfg.cam0.resolution
    log.info("PNG decoder: %s", native_loader.decoder_name())
    rings = [native_loader.open_loader(seq.image_paths(first, n, cam), W, H) for cam in (0, 1)]
    streams = [iter(r) for r in rings]

    def frame_at(k):
        return dict(cam0_img=_to_device(next(streams[0])[1], device),
                    cam1_img=_to_device(next(streams[1])[1], device),
                    **{key: v[k] for key, v in imu.items()})

    try:
        carry, outs = _eskf_loop(vio, carry, n, frame_at)
    finally:
        for r in rings:
            r.close()
    # per-frame inlier line, mirroring eskf_vio.py:159-162
    for k in range(n):
        log.info("%d/%d inliers, |v|=%.4f", int(outs["n_inliers"][k]),
                 int(outs["n_matches"][k]), float(np.linalg.norm(outs["v"][k])))
    gt = seq.gt_aligned_positions(frame_times)
    ate = None
    if gt is not None:
        ate = ate_rmse(outs["p"], gt, align=True)
        log.info("ESKF ATE RMSE (SE3-aligned): %.4f m", ate)
        print(f"eskf_ate_rmse_m {ate:.4f}")
    return frame_times, outs, ate


def run_eskf(args, log):
    from vio_msckf_torch.utils.metrics import ate_rmse

    if not args.demo:
        frame_times, outs, _ = eskf_euroc(args, log)
        write_eskf_plots(args.out or "eskf", frame_times, outs, log)
        return 0

    from vio_msckf_torch.data.render import render_sequence
    from vio_msckf_torch.data.simulator import SimConfig, bundle_frames, simulate_sequence
    from vio_msckf_torch.eskf import EskfVio

    device = torch.device(args.device)
    cfg = euroc_config()
    vio = EskfVio(cfg, device=device)
    sim = SimConfig(duration=min(args.demo_duration, 6.0), seed=4, amp=(0.5, 0.4, 0.2),
                    yaw_rate=0.05, wobble_amp=0.03)
    seq = simulate_sequence(cfg, sim)
    frames, _, first = bundle_frames(seq, cfg)
    n = len(frames["timestamp"])
    R_stack = seq["gt_R_i_w"][first:first + n].transpose(0, 2, 1)
    p_stack = seq["gt_p"][first:first + n]
    cam0, cam1 = render_sequence(cfg, R_stack, p_stack, radius=14.0, seed=7, device=device)
    acc0 = frames["imu_acc"][1][frames["imu_valid"][1]][0]
    imu = _imu_frames(frames, device)
    carry, outs = _eskf_loop(vio, vio.init(acc0), n, lambda k: dict(
        cam0_img=cam0[k], cam1_img=cam1[k], **{key: v[k] for key, v in imu.items()}))
    for k in range(0, n, 10):
        log.info("frame %d: inliers %d/%d |p|=%.3f", k, int(outs["n_inliers"][k]),
                 int(outs["n_matches"][k]), float(np.linalg.norm(outs["p"][k])))
    # The ESKF estimates in the rectified-cam frame starting at the first
    # frame; compare SE3-aligned (Umeyama) like the reference's qualitative
    # plots (eskf_vio.py:187-216) but quantified.
    ate = ate_rmse(outs["p"], seq["gt_p"][first:first + n], align=True)
    log.info("ESKF ATE RMSE (SE3-aligned, synthetic): %.4f m", ate)
    print(f"eskf_ate_rmse_m {ate:.4f}")
    write_eskf_plots(args.out or "eskf", frames["timestamp"], outs, log)
    return 0


def main(argv=None):
    args = build_parser().parse_args(argv)
    from vio_msckf_torch.utils.logging import get_logger

    log = get_logger("vio.cli")
    if not args.demo and not args.path:
        print("need --path <euroc dir> or --demo", file=sys.stderr)
        return 2
    # Fail before any work when the device is missing: no fallback to the CPU.
    torch.zeros((), device=args.device)
    if args.pipeline == "eskf":
        return run_eskf(args, log)
    if args.demo:
        return run_msckf_demo(args, log)
    return run_msckf_euroc(args, log)


if __name__ == "__main__":
    raise SystemExit(main())
