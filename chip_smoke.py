"""Smoke run of the PyTorch port on one CUDA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --four-cards     # [parallel] (c) alone, on 4 GPUs

Phases, one line each; any failure raises and exits nonzero:
  1. device   - requires CUDA (no CPU fallback); prints the card's name and
                power limit as nvidia-smi reports them.
  2. build    - compiles the hand-written kernels (vio_msckf_torch/csrc)
                from source with nvcc and loads them.
  3. workload - simulates and renders the bench workload (12 s, 752x480
                stereo, ~220 frames) on the card with the port's renderer
                (vio_msckf_torch.bench.build_workload).
  4. kernels  - each kernel against its plain PyTorch twin at the shapes
                the paths below give it (one sequence, and the batch of 4),
                with the stated tolerance; the device time of the kernel,
                its twin and (where one exists) the one PyTorch call that
                computes the same function; the roofline bound of the same
                work. Also, timed the same way, at the shapes B = 8 and 16
                of `python -m vio_msckf_torch.tools.batch_sweep`, which
                the smoke does not run.
  5. slice    - VIOEngine.run_sequence over every frame at the full EuRoC
                config (the step captured as a CUDA graph at the first
                frame and replayed, vio_msckf_torch/graph.py): ATE and RPE
                against ground truth (fails above the bench's 0.5 m
                bound), launch counts of each kernel in that run (each
                must be > 0) and host syncs in one warm eager step.
  6. bench    - the port's timed entry, `python -m vio_msckf_torch.bench`
                (bench.main([]) in this process): its one JSON line with
                bench.py's keys, ATE within 0.5 m and finite; frames/s is
                the best of its 3 timed passes over the 220 frames. Every
                kernel must launch in it.
  7. batch    - the bench's 4-sequence batch (bench.py:run_batched: seeds
                4..7), their first 110 frames (cut from 220),
                through VIOEngine.run_batch at B = 4, twice: ATE/RPE
                per sequence (0.5 m bound), member 0 against the slice's
                trajectory (same workload; 1e-4 m bound), host syncs in one
                warm eager batched step (0), hand-kernel launches per
                batched step (3 LK / 1 FAST / 2 SPD), aggregate frames/s of
                the second (graphed) pass, and the host's launch calls of
                one warm eager step at B = 1 and B = 4, the kernels the
                graph holds (torch.profiler; tools/profile_ops.py:
                launch_profile).
  8. suite    - the other cells of bench.py --suite: fast motion and the
                hostile world (rendered by the port) as one B = 2 batch,
                each member held against its sequence run alone (1e-4 m
                bound), then the 30-clone window (D = 201) as one sequence,
                each over the first 64 frames (cut from 220);
                ATE/RPE each (0.5 m bound), beside the JAX package's TPU v5e
                numbers from SUITE_r05.json (the reference's, not the
                port's).
  9. parallel - scale-out (vio_msckf_torch/parallel/): NCCL's answer to two
                ranks on the one card (it refuses them; on two or more cards
                both must run); the engine in 4 gloo
                ranks sharing the card as replica 2 x block 2 (the suite's
                pair, one sequence per replica, its 64 frames) against the
                suite's unsharded trajectories (5e-3 m, the reference's
                bound), block peers against each other, ATE per sequence;
                the filter alone in 8 gloo ranks as 2 x 4 (two butterfly
                rounds; simulated tracks, seeds 1 and 2, 30 frames) against
                the unsharded filter on the card (1e-4 m); (b) the filter
                alone, MSCKF.run_sequence replayed, against that eager
                kf.step loop (1e-6 m) and one replay profiled; (a) one
                NCCL rank at world size 1 with a block group of one,
                the sharded engine step captured with its all-gathers and
                replayed through make_multichip_engine_step's step over
                the slice's first 16 frames, against the same step eager
                (1e-6 m) and the slice (1e-4 m), one replay profiled (0
                host syncs, trace = counts, NCCL kernels counted: at one
                rank NCCL copies without a kernel); (c) with four or more
                cards, NCCL one rank per card, graphed: the engine 2 x 2
                on the suite's pair against the unsharded pair (5e-3 m)
                and the same mesh eager (1e-6 m), the filter 1 x 4 against
                the unsharded filter (1e-4 m), each rank's replay
                profiled (NCCL kernels > 0), dryrun_multichip(4) under
                NCCL ("not run" on one card; `--four-cards` runs only
                this, where every shape it may launch is one the one-card
                run holds against the twins: four_card_shapes);
                dryrun_multichip(4) under gloo. Backend, staged host
                copies and ms per step of each run; ranks sharing one
                card give no scaling number. The ranks' launches are
                merged per call shape.
 10. cli      - the user's entry point, `python -m vio_msckf_torch --path`
                (vio_msckf_torch.cli.main): the bench sequence written as
                an EuRoC mav0/ tree by the port's writer, then run chunked
                over every frame (dataset_fps, aligned ATE as the CLI
                computes it, RPE), with --preload and per frame over the
                first 110 frames (their TUM trajectories must equal the
                chunked run's), and checkpointed at frame 64 and resumed
                (the final pose must equal the uninterrupted run's); the
                PNG decoder that ran; the first 32 frames re-encoded by PIL
                (adaptive filters, as the JAX package writes its trees):
                chunked dataset_fps, the same TUM lines.
 11. eskf     - the ESKF pipeline (cli.eskf_euroc, the --pipeline eskf
                --path flow below its plots: the card's machine has no
                matplotlib) at euroc_config() with the default EskfConfig
                (K = 512) on the first 110 frames of the same tree: aligned
                ATE (1.0 m bound, the JAX package's own for this flow),
                stereo and temporal matches and inliers per frame, frames/s,
                kernel launches and host syncs of one warm step, and the
                FAST kernel held against its twin bit for bit on the ESKF's
                rectified stereo pair at threshold 20.
 12. graph    - the compiled step (vio_msckf_torch/graph.py, the port's
                jax.jit(step) under lax.scan) against the eager step: the
                eager `step` loop over the slice's frames against the
                slice's graphed run (B = 1), the eager `step_batch` loop
                over the batch's 110 frames against its graphed run, per
                member (B = 4), and the ESKF's eager `step` over the first
                ESKF_GRAPH_FRAMES (16) frames of the CLI's tree against
                EskfVio.run_sequence: the largest position gap (bound
                1e-6 m), launch counts equal per call shape, capture time,
                ms a step eager and graphed; for one replay: host syncs
                (0), the host's launch calls, device kernels (torch.profiler;
                the hand kernels' launches in that trace must equal what
                the runner counts per replay) and the busy share of that
                profiled replay (their device time over its span between
                CUDA events; the profiler stretches the span, so this is
                not an unprofiled replay's share), and a replay's device
                and host time without the profiler; a graphed run of TRACED_FRAMES
                (8) frames from a fresh engine traced whole, whose launch
                counts must equal the trace's; two calls of engine.entry()'s
                captured step (pose finite).
Every path above that runs a sequence replays a captured step; the sync
checks and the profiles of one warm step stay on the eager step, whose
kernels the graph holds.
Launches are counted per path and per call shape: every counter is set to 0
just before a path runs and read just after; every kernel of a path must
launch in it (the ESKF path has one, FAST), and every call shape a path
launches must be one that a check held against the twin.
The line before the last is a JSON object with one entry per kernel
(`launches`: the bench path's; `launches_by_path`: every path's;
`sweep_calls`: the sweep's call shapes, timed, with their bounds); the
last line is {"ok": true, "device": {...}}. The sweep's shapes are
tools.batch_sweep.call_shapes(cfg, B), which the sweep holds its own
launches to; the run fails unless that function gives the shapes the
slice, bench and batch paths launched (B = 1, 1, 4).

Kernel times (`device_ms`): a spin kernel holds the stream while the host
enqueues n calls back to back between two CUDA events, so the events see
the device's time for the n calls and not the host's Python between them;
the time is divided by n, and the median of a few such runs is kept. Each
kernel entry reports per-frame sums over the calls the one-sequence path
makes, and under "calls" one entry per call shape with the path that makes
it and its launches there; "batch" sums the B = 4 path's calls per
sequence-frame. `bound_ms` is the larger of the
bytes the function must move (inputs read once, outputs written once) at
3.35 TB/s and the f32 operations these inputs need at 67 TFLOP/s (H100
SXM data sheet).
"""

import contextlib
import io
import json
import logging
import math
import os
import shutil
import struct
import sys
import tempfile
import time
import zlib

import numpy as np

# The bench workload, its bound and the suite's cells are the port's timed
# entry's (vio_msckf_torch/bench.py, the counterpart of bench.py).
from vio_msckf_torch.bench import (ATE_BOUND_M, FAST_MOTION, SIM, build_workload,
                                   stack_workloads)
from vio_msckf_torch.bench import SUITE_BATCH as BATCH
from vio_msckf_torch.data.render import BENCH_WORLD
from vio_msckf_torch.tools.batch_sweep import call_shapes
from vio_msckf_torch.tools.profile_ops import (host_syncs, launch_profile, replay_profile,
                                              traced_counts)

CLI_CHUNK = 32                 # the CLI's default --chunk
CLI_PARTIAL = 110              # frames of the --preload and per-frame runs
CKPT_FRAME = 64                # where the interrupted CLI run checkpoints
CLI_PIL = 32                   # frames of the run on PIL-encoded PNGs
# The ESKF's bound is the JAX package's own for its --path flow
# (tests/test_euroc_pipeline.py:112); the loosely coupled filter drifts more
# than the MSCKF: over all 220 frames the JAX package's ESKF reaches
# 0.7902 m (SE3-aligned; its CLI on a CPU, on the same tree written by the
# port's writer on a CPU); over the ESKF_FRAMES (110) frames run here,
# 0.4419 m, printed beside the port's as an anchor.
ESKF_ATE_BOUND_M = 1.0
ESKF_CPU_ANCHOR_ATE = 0.4419
CLONES_30 = 30                 # bench.py --suite's enlarged window
# Depth cuts, to keep the smoke well inside its time limit with the cli
# and eskf phases on a slow host: the batch phase covers the first
# BATCH_DEPTH frames of its four sequences, the suite's cells (the
# fast-motion + hostile B = 2 batch, each member alone, the 30-clone
# window) the first SUITE_DEPTH frames, the ESKF the first ESKF_FRAMES
# frames of the CLI's tree (`--max-frames`); the slice and the CLI's
# chunked run cover all 220.
BATCH_DEPTH = 110
SUITE_DEPTH = 64
ESKF_FRAMES = 110
# The JAX package's ATE in SUITE_r05.json (a TPU v5e run of the reference;
# printed beside the port's numbers as an anchor, not as the port's).
TPU_ANCHOR_ATE = {"fast motion": 0.1015, "hostile": 0.1767, "30 clones": 0.0535,
                  "4-sequence batch": 0.0489}

# [parallel]: the engine over a replica x block mesh of gloo ranks on the
# one card (the suite's B = 2 pair, one sequence per replica, SUITE_DEPTH
# frames), the filter alone over 2 x 4 ranks (two butterfly rounds; the
# simulated tracks of seeds 1 and 2, tests/test_parallel.py:46-77), and one
# NCCL rank at world size 1 over the slice's first NCCL_FRAMES frames. The
# sharded engine's bound is the reference's own (tests/test_parallel.py:77,142).
PAR_ENGINE_MESH = (2, 2)
PAR_FILTER_MESH = (2, 4)
PAR_FOUR_FILTER_MESH = (1, 4)      # (c): both sequences on one replica of 4 cards
PAR_FILTER_FRAMES = 30
PAR_SEEDS = (1, 2)
NCCL_FRAMES = 16
PAR_BOUND_M = 5e-3
# The filter alone against the unsharded filter on the card: f32 roundoff
# apart (1.1e-6 m on an NVIDIA H100 80GB HBM3 at 700 W), so held far
# tighter than the reference's bound.
PAR_FILTER_BOUND_M = 1e-4
PAR_TIMEOUT_S = 240

# [graph]: graphed against eager. The bound asks for f32 roundoff at most;
# the graph launches the eager step's kernels on the same inputs, so 0 is
# expected.
GRAPH_BOUND_M = 1e-6
ESKF_GRAPH_FRAMES = 16
GRAPH_REPLAYS = 20
TRACED_FRAMES = 8              # frames of the graphed run traced whole

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
F32_OPS_PER_S = 67e12         # H100 SXM f32 outside the tensor cores


T_START = time.perf_counter()


def log(msg):
    """One line of the run, after the seconds since the script started."""
    print(f"{time.perf_counter() - T_START:7.1f}s {msg}", flush=True)


def device_ms(fn, n, runs=5, warmup=2, sync_free=True):
    """Device ms of one fn() call: n calls between two CUDA events, divided
    by n; the median of `runs` runs.

    For a sync-free fn a spin kernel first holds the stream for about twice
    the host's enqueue time of n calls, so all n are queued before the
    first starts and the device runs them back to back. A fn that
    synchronises (sync_free=False) cannot be queued ahead: its time is the
    wall time between the events, host included."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    hold_cycles = int(min(2.0 * host_s, 2.0) * 2.0e9) + 2_000_000
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if sync_free:
            torch.cuda._sleep(hold_cycles)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / n)
    return float(np.median(times))


def bound(nbytes, ops):
    """Roofline bound (ms, "bytes" | "operations") of one call."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors):
    """Bytes of the distinct tensors given (one read or write each)."""
    seen = {}
    for t in tensors:
        seen[(t.data_ptr(), t.numel())] = t.numel() * t.element_size()
    return sum(seen.values())


def summed(calls):
    """Per-frame totals over the call shapes of one kernel."""
    tot = lambda k: sum(c[k] * c["per_frame"] for c in calls)  # noqa: E731
    libs = [c["library_ms"] for c in calls]
    b_ops = sum(c["ops"] * c["per_frame"] for c in calls)
    b_bytes = sum(c["bytes"] * c["per_frame"] for c in calls)
    bound_ms, bound_by = bound(b_bytes, b_ops)
    return dict(ms=tot("ms"), plain_ms=tot("plain_ms"),
                library_ms=None if None in libs else tot("library_ms"),
                bound_ms=bound_ms, bound_by=bound_by)


def phase_device():
    import torch

    from vio_msckf_torch.tools import card as nvidia_smi_card

    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; none is available")
    card = nvidia_smi_card()
    log(f"[device] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
        f"torch {torch.__version__} cuda {torch.version.cuda}; {card}")
    return card


def phase_build():
    from vio_msckf_torch import kernels

    path, seconds, compile_log = kernels.build()
    kernels.lib()
    regs = [ln.strip() for ln in compile_log.splitlines()
            if "registers" in ln or "Compiling entry" in ln or "spill" in ln]
    log(f"[build] {path.relative_to(kernels.BUILD.parent.parent)} in {seconds:.2f} s; "
        + " | ".join(regs))


def phase_workload(cfg, dev):
    import torch

    t0 = time.perf_counter()
    dframes, init, gt, n = build_workload(cfg, device=dev)
    torch.cuda.synchronize()
    log(f"[workload] {n} stereo frames {tuple(dframes['cam0_img'].shape[1:])} rendered on "
        f"the card in {time.perf_counter() - t0:.2f} s")
    return dframes, init, gt, n


# FAST-9 + NMS per pixel: 16 circle differences; per polarity 16 three-tap
# minima (32), 16 arc minima (32) and 15 maxima; the polarity max, the
# threshold test, 8 NMS maxima and the final test.
FAST_OPS_PER_PX = 16 + 2 * (32 + 32 + 15) + 1 + 1 + 8 + 1


FAST_THRESHOLDS = (0.0, 15.0, 40.0)
# Frames of the 220-frame workload stacked as a batch of B distinct images.
BATCH_FRAMES = (0, 40, 110, 219)
SUITE_B = 2                    # the suite's fast motion + hostile batch
SUITE_FRAMES = (70, 150)
# The batch sizes of `python -m vio_msckf_torch.tools.batch_sweep` beyond the
# batch's 4 (its B = 1, 2, 4 are the slice's, the suite's and the batch's
# shapes). The smoke does not run the sweep; it holds each kernel against
# its twin at call_shapes(cfg, B) for these B and times it there.
SWEEP_BATCHES = (8, 16)


def sweep_frames(n, B):
    """B distinct frames of the workload, spread over it."""
    return [int(k) for k in np.linspace(0, n - 2, B)]


def fast_inputs(frames, n, dev):
    """The FAST kernel's check inputs, each a (B, H, W) stack: rendered
    frames 0, 40, 110 and the last alone and as one B = 4 stack; frames
    70 and 150 as one B = 2 stack (the suite's batch); the
    integer blocky image (ties, dense in corners); frame 40's coarser
    pyramid levels (60x94 takes the kernel's scalar path, W % 4 != 0); a
    97x131 crop, a multiple of no tile side, alone and as a stack whose
    planes leave 16-byte boundaries."""
    import torch
    from vio_msckf_torch.ops.pyramid import build_pyramid

    cam0 = frames["cam0_img"]
    imgs = {f"frame {k}": cam0[k][None] for k in (0, 40, 110, n - 1)}
    imgs["batch of 4"] = cam0[[k if k < n else n - 1 for k in BATCH_FRAMES]]
    imgs["batch of 2"] = cam0[[min(k, n - 1) for k in SUITE_FRAMES]]
    rng = np.random.default_rng(4)
    blocky = np.kron(rng.integers(0, 256, (121, 189)), np.ones((4, 4)))[:480, :752]
    imgs["blocky"] = torch.as_tensor(blocky, dtype=torch.float32, device=dev)[None]
    for lvl, x in enumerate(build_pyramid(cam0[40][None], 3)[1:], 1):
        imgs[f"frame 40 level {lvl}"] = x
    imgs["frame 40 crop"] = cam0[40][200:297, 300:431][None]
    imgs["batch of 3 crops"] = cam0[[0, 40, 110], 200:297, 300:431]
    return {k: v.contiguous() for k, v in imgs.items()}


def fast_call(img, thr, path):
    """One FAST call shape timed: kernel, twin, bound."""
    from vio_msckf_torch.ops import fast

    out = fast.fast_nms(img, thr)
    c = dict(path=path, shape=list(img.shape), threshold=float(thr),
             corners=int((out > 0).sum()), candidates=int(fast.fast_candidates(img, thr).sum()),
             ms=device_ms(lambda: fast.fast_nms(img, thr), 200),
             plain_ms=device_ms(lambda: fast.fast_score_map(img, thr), 50),
             library_ms=None, bytes=nbytes(img, out), ops=img.numel() * FAST_OPS_PER_PX)
    c["bound_ms"], c["bound_by"] = bound(c["bytes"], c["ops"])
    return c


def check_fast(cfg, frames, n, dev):
    import torch
    from vio_msckf_torch.ops import fast

    imgs = fast_inputs(frames, n, dev)
    err = 0.0
    for name, img in imgs.items():
        for thr in FAST_THRESHOLDS:
            out = fast.fast_nms(img, thr)
            ref = fast.fast_score_map(img, thr)
            torch.cuda.synchronize()
            err = max(err, float((out - ref).abs().max()))
            if not torch.equal(out, ref):
                bad = int((out != ref).sum())
                raise AssertionError(f"FAST kernel differs from its twin on {name} "
                                     f"{tuple(img.shape)} at threshold {thr}: {bad} pixels")

    # The sweep's calls: (B, 480, 752) at the tracker's threshold, bit for bit.
    sweep = []
    for B in SWEEP_BATCHES:
        (key,) = call_shapes(cfg, B)["fast_nms"]
        img = frames["cam0_img"][sweep_frames(n, B)].contiguous()
        if tuple(img.shape) != key[:3]:
            raise AssertionError(f"the sweep's FAST call is {key}, the frames {tuple(img.shape)}")
        out, ref = fast.fast_nms(img, key[3]), fast.fast_score_map(img, key[3])
        torch.cuda.synchronize()
        if not torch.equal(out, ref):
            raise AssertionError(f"FAST kernel differs from its twin on the sweep's "
                                 f"{tuple(img.shape)}: {int((out != ref).sum())} pixels")
        sweep.append(dict(fast_call(img, key[3], f"sweep B={B}"), key=list(key)))

    def timed(img, path):
        return fast_call(img, 15.0, path)

    # The one-sequence path's call (cam0 level 0 at the tracker's threshold
    # 15); the batch path's call, one (4, 480, 752) launch; the suite's
    # B = 2 call; and the blocky image, whose corners are dense: the
    # compass reject makes the kernel's time depend on the data.
    call = dict(timed(imgs["frame 40"], "slice"), per_frame=1)
    batch = dict(timed(imgs["batch of 4"], "batch"), per_frame=1 / BATCH)
    pair = dict(timed(imgs["batch of 2"], "suite B=2"), per_frame=1 / SUITE_B)
    dense = timed(imgs["blocky"], "slice")
    log(f"[kernel fast_nms] bit-exact on {len(imgs)} inputs x thresholds "
        f"{FAST_THRESHOLDS}; frame 40: {call['corners']} corners, {call['candidates']} "
        f"candidates, {call['ms']:.5f} ms vs twin {call['plain_ms']:.5f} ms; batch of 4 "
        f"frames {BATCH_FRAMES}: {batch['ms']:.5f} ms vs twin {batch['plain_ms']:.5f} ms, "
        f"bound {batch['bound_ms'] * 1e3:.3f} us; batch of 2 frames {SUITE_FRAMES}: "
        f"{pair['ms']:.5f} ms vs twin {pair['plain_ms']:.5f} ms; blocky: "
        f"{dense['corners']} corners, {dense['candidates']} candidates, {dense['ms']:.5f} ms "
        f"vs twin {dense['plain_ms']:.5f} ms; bound {call['bound_ms'] * 1e3:.3f} us "
        f"({call['bound_by']}); bit-exact at the sweep's B = {SWEEP_BATCHES}: " + ", ".join(
            f"{c['ms']:.5f} ms vs twin {c['plain_ms']:.5f} ms, bound "
            f"{c['bound_ms'] * 1e3:.3f} us" for c in sweep))
    return dict(name="fast_nms", route="cuda", source="vio_msckf_torch/csrc/fast_nms.cu",
                replaces="vio_msckf_tpu/ops/fast_pallas.py:71", max_abs_err=err,
                library_note="no single PyTorch call computes FAST-9 + NMS",
                calls=[call, batch, pair], dense_input=dense, batch=summed([batch]),
                sweep_calls=sweep, **summed([call]))


def _lk_points(img, n, W, H, rng):
    """n points: strong FAST corners, random interior points, and points
    on and near the image border."""
    import torch
    from vio_msckf_torch.ops.fast import fast_score_map

    score = fast_score_map(img, 15.0).flatten()
    top = torch.argsort(score, descending=True, stable=True)[: n // 2].cpu().numpy()
    corners = np.stack([top % W, top // W], axis=1).astype(np.float32)
    border = np.array([[0, 0], [W - 1, H - 1], [1.5, H / 2], [W - 2.5, H / 3],
                       [W / 2, 0.5], [W / 3, H - 1.5], [3, 4], [W - 4, H - 5]],
                      np.float32)
    rest = n - len(corners) - len(border)
    interior = rng.uniform([20, 20], [W - 20, H - 20], size=(rest, 2)).astype(np.float32)
    return np.concatenate([corners, border, interior])


# LK f32 operations. Per tracked level and feature: the 17x17 bilinear
# template (9 each), the gradients (4 per pixel), the 2x2 normal matrix
# (6 per pixel) and the final mean |I - J| (12 per pixel) over the 15x15
# window; per Newton iteration: 225 bilinear samples (9), I - J (1) and
# the two products and sums (4), plus the 2x2 solve.
LK_OPS_PER_LEVEL = 17 * 17 * 9 + 225 * (4 + 6 + 12) + 20
LK_OPS_PER_ITER = 225 * 14 + 20


def lk_calls(cfg, frames, dev, ks, path):
    """The three LK calls of the tracker for sequences that track frame k
    -> k + 1 (one sequence per k in ks): temporal P = 128, stereo P = 228,
    verify P = 356 per sequence; each sequence its own planes and points."""
    import torch
    from vio_msckf_torch.frontend.tracker import StereoTracker
    from vio_msckf_torch.ops import klt
    from vio_msckf_torch.ops.pyramid import build_pyramid

    fe = cfg.frontend
    args = (fe.lk_patch_size, fe.lk_max_iteration, fe.lk_track_precision, 1e-4)
    lv = fe.lk_pyramid_levels
    H, W = frames["cam0_img"].shape[1:]
    ks = list(ks)
    pa = build_pyramid(frames["cam0_img"][ks], lv)
    pb = build_pyramid(frames["cam0_img"][[k + 1 for k in ks]], lv)
    pc = build_pyramid(frames["cam1_img"][ks], lv)
    rng = np.random.default_rng(0)
    T = fe.max_tracks
    C = fe.grid_row * fe.grid_col * fe.grid_max_feature_num
    pts_t = torch.as_tensor(np.stack([_lk_points(pa[0][b], T, W, H, rng)
                                      for b in range(len(ks))]), device=dev)
    pts_s = torch.as_tensor(np.stack([_lk_points(pa[0][b], T + C, W, H, rng)
                                      for b in range(len(ks))]), device=dev)
    init_s = StereoTracker(cfg, dev)._stereo_predict(pts_s)
    g, s, _ = klt.pyramidal_lk(pa, pb, pts_t, pts_t, *args)
    gs, ss, _ = klt.pyramidal_lk(pa, pc, pts_s, init_s, *args)
    # (name, kernel call, twin arguments, pyramids read). lk_verify runs
    # level 0 of two image pairs.
    ver_pts = torch.cat([g, gs], dim=1)
    ver_init = torch.cat([pts_t, pts_s], dim=1)
    return [
        (name, path, call, tw, pyrs) for name, call, tw, pyrs in (
            ("temporal", lambda: klt.pyramidal_lk(pa, pb, pts_t, pts_t, *args),
             dict(pyr_prev=pa, pyr_next=pb, pts_prev=pts_t, pts_init=pts_t), [pa, pb]),
            ("stereo", lambda: klt.pyramidal_lk(pa, pc, pts_s, init_s, *args),
             dict(pyr_prev=pa, pyr_next=pc, pts_prev=pts_s, pts_init=init_s), [pa, pc]),
            ("verify", lambda: klt.lk_verify(pb, pa, pc, pa, g, pts_t, gs, pts_s, *args),
             dict(pyr_prev=pb[:1], pyr_next=pa[:1], pts_prev=ver_pts, pts_init=ver_init,
                  pyr_prev_b=pc[:1], pyr_next_b=pa[:1], n_first=T, min_size=0),
             [pb[:1], pa[:1], pc[:1]]),
        )]


def check_lk(cfg, frames, dev):
    import torch
    from vio_msckf_torch.ops import klt

    fe = cfg.frontend
    win = fe.lk_patch_size
    lk_args = dict(win=win, iters=fe.lk_max_iteration, eps=fe.lk_track_precision,
                   min_eig_threshold=1e-4)
    n = frames["cam0_img"].shape[0]
    # One sequence tracking frame 40 (in motion), four sequences tracking
    # frames 40, 70, 100, 130 and the suite's two tracking frames 40 and
    # 70: distinct planes, so a kernel that reads the wrong sequence's
    # plane disagrees with the twin. The sweep's B = 8 and 16 too.
    calls = (lk_calls(cfg, frames, dev, [40], "slice")
             + lk_calls(cfg, frames, dev, [min(40 + 30 * b, n - 2) for b in range(BATCH)],
                        "batch")
             + lk_calls(cfg, frames, dev, [40, 70], "suite B=2")
             + [c for B in SWEEP_BATCHES
                for c in lk_calls(cfg, frames, dev, sweep_frames(n, B), f"sweep B={B}")])
    cpu = lambda pyr: [x.cpu() for x in pyr]          # noqa: E731

    worst_err, lines, out, sweep = 0.0, [], [], []
    for name, path, call, tw, pyrs in calls:
        got = call()
        if name == "verify":
            got = tuple(torch.cat([a, b], dim=1) for a, b in zip(*got))
        g_k, s_k = got[0].cpu(), got[1].cpu()
        twin_args = {key: (cpu(v) if isinstance(v, list) else
                           v.cpu() if isinstance(v, torch.Tensor) else v)
                     for key, v in tw.items()}
        g_t, s_t, _, it_t = klt.track_pyramid_plain(**twin_args, **lk_args)
        it_k = klt.track_pyramid(**tw, **lk_args)[3]
        B, P = s_t.shape
        for b in range(B):
            both = s_k[b] & s_t[b]
            d = torch.linalg.vector_norm(g_k[b][both] - g_t[b][both], dim=1).numpy()
            p95 = float(np.percentile(d, 95)) if d.size else 0.0
            agree = float((s_k[b] == s_t[b]).float().mean())
            if not d.size or p95 >= 2e-2 or agree < 0.99:
                raise AssertionError(f"LK {name} ({path}) sequence {b}: p95 {p95:.3g} px, "
                                     f"status agreement {agree:.4f} over {d.size} points")
            worst_err = max(worst_err, float(d.max()))
        min_size = tw.get("min_size", win + 8)
        n_lv = sum(min(x.shape[1:]) >= min_size for x in pyrs[0])
        imgs = [x for pyr in pyrs for x in pyr if min(x.shape[1:]) >= min_size]
        lk_bytes = nbytes(*imgs, tw["pts_prev"], tw["pts_init"]) + B * P * (8 + 1 + 4)
        lk_ops = B * P * n_lv * LK_OPS_PER_LEVEL + int(it_t.sum()) * LK_OPS_PER_ITER
        # Newton iterations: the twin's count sets the bound; the slowest
        # feature's count sets the kernel's time.
        c = dict(name=name, path=path, B=B, P=P, n_first=tw.get("n_first", P), levels=n_lv,
                 per_frame=1 / B,
                 newton_iters=int(it_t.sum()), kernel_newton_iters=int(it_k.sum()),
                 max_feature_iters=int(it_t.max()),
                 bytes=lk_bytes, ops=lk_ops,
                 ms=device_ms(call, 50),
                 plain_ms=device_ms(lambda: klt.track_pyramid_plain(**tw, **lk_args), 3,
                                    runs=3, sync_free=False),
                 library_ms=None)
        c["bound_ms"], c["bound_by"] = bound(c["bytes"], c["ops"])
        if path.startswith("sweep"):
            sweep.append(dict(c, key=[B, P, c["n_first"]]))
        else:
            out.append(c)
        lines.append(f"{name} ({path}) B={B} P={B}x{P} x{n_lv} levels agree, "
                     f"{c['newton_iters']} iterations ({c['kernel_newton_iters']} in the "
                     f"kernel, at most {c['max_feature_iters']} a feature): "
                     f"{c['ms']:.5f} ms vs twin {c['plain_ms']:.3f} ms, bound "
                     f"{c['bound_ms'] * 1e3:.3f} us ({c['bound_by']})")
    for B in SWEEP_BATCHES:
        keys = {tuple(c["key"]) for c in sweep if c["path"] == f"sweep B={B}"}
        want = call_shapes(cfg, B)["lk_pyramid"]
        if keys != want:
            raise AssertionError(f"the sweep's LK calls at B={B} are {sorted(want)}, "
                                 f"checked {sorted(keys)}")
    tot = summed([c for c in out if c["path"] == "slice"])
    tot_b = summed([c for c in out if c["path"] == "batch"])
    tot_s = summed([c for c in out if c["path"] == "suite B=2"])
    log(f"[kernel lk] {'; '.join(lines)}; worst gap {worst_err:.2e} px; LK device ms per "
        f"frame {tot['ms']:.5f} (B=1), per sequence-frame {tot_b['ms']:.5f} (B={BATCH}) "
        f"and {tot_s['ms']:.5f} (B={SUITE_B})")
    return dict(name="lk_pyramid", route="cuda", source="vio_msckf_torch/csrc/lk_pyramid.cu",
                replaces="vio_msckf_tpu/ops/klt_pallas.py:63", max_abs_err=worst_err,
                library_note="no single PyTorch call computes an LK pyramid walk",
                calls=out, batch=tot_b, sweep_calls=sweep, **tot)


def _spd_active_ops(B, k):
    """f32 operations the data needs: Gauss-Jordan over each system's
    pivots whose column has an off-diagonal nonzero (a pivot without one
    only scales its own row)."""
    import torch

    F, m, _ = B.shape
    off = B * (1 - torch.eye(m, device=B.device))
    a = ((off != 0).any(dim=1) | (off != 0).any(dim=2)).sum(dim=1).double()
    # sum_{i<a} (2a - 1)(a + k - i - 1) + (m - a) k
    ops = (2 * a - 1) * (a * (a + k) - a * (a + 1) / 2) + (m - a) * k
    return int(ops.sum()), float(a.mean())


# SPD call shapes: (path, sequences, systems per sequence, m, state dim D,
# atol factor, rtol). The lost path (m = 4 x clones) and the prune path
# (m = 8) of the one-sequence, the 4-sequence and the suite's 2-sequence
# runs, and the 30-clone lost path (D = 201), the only caller of the
# kernel's m > 80 variant.
SPD_CALLS = (("slice", 1, 128, 80, 141, 2e-3, 2e-3), ("slice", 1, 160, 8, 141, 1e-4, 1e-3),
             ("batch", BATCH, 128, 80, 141, 2e-3, 2e-3),
             ("batch", BATCH, 160, 8, 141, 1e-4, 1e-3),
             ("suite B=2", SUITE_B, 128, 80, 141, 2e-3, 2e-3),
             ("suite B=2", SUITE_B, 160, 8, 141, 1e-4, 1e-3),
             ("30 clones", 1, 128, 120, 201, 2e-3, 2e-3),
             # One sequence per rank with the features split over block
             # ranks: the lost and prune paths at F = 128/nb and 160/nb,
             # block = 2 (the sharded engine) and block = 4 (the filter).
             ("parallel", 1, 64, 80, 141, 2e-3, 2e-3), ("parallel", 1, 80, 8, 141, 1e-4, 1e-3),
             ("parallel", 1, 32, 80, 141, 2e-3, 2e-3), ("parallel", 1, 40, 8, 141, 1e-4, 1e-3))


def sweep_spd_calls(cfg):
    """SPD_CALLS rows of the sweep's B = 8 and 16 (call_shapes), held against
    the twin at the tolerances of the same m above."""
    tol = {m: (atol, rtol) for _, _, _, m, _, atol, rtol in SPD_CALLS}
    return tuple((f"sweep B={B}", B, F // B, m, cfg.state_dim, *tol[m])
                 for B in SWEEP_BATCHES
                 for F, m, _ in sorted(call_shapes(cfg, B)["spd_gj"]))


def check_spd(cfg, dev):
    import torch
    from vio_msckf_torch.ops import spd

    rng = np.random.default_rng(1)
    s = 0.035 ** 2
    lines, worst, calls, sweep = [], 0.0, [], []
    for path, nseq, F, m, D, atol_f, rtol in SPD_CALLS + sweep_spd_calls(cfg):
        A = torch.as_tensor(rng.normal(size=(D, D)) * 0.05, dtype=torch.float32, device=dev)
        P = A @ A.T
        Hm = torch.as_tensor(rng.normal(size=(nseq * F, m, D)) * 0.5, dtype=torch.float32,
                             device=dev)
        n_active = torch.as_tensor(rng.integers(4, m + 1, size=nseq * F), device=dev)
        Hm = Hm * (torch.arange(m, device=dev)[None, :] < n_active[:, None])[..., None]
        B = Hm @ P @ Hm.transpose(1, 2) + s * torch.eye(m, device=dev)
        B = ((B + B.transpose(1, 2)) / 2.0).reshape(nseq, F, m, m).contiguous()
        R = torch.as_tensor(rng.normal(size=(nseq, F, m, 4)), dtype=torch.float32, device=dev)
        X = spd.spd_solve(B, R)
        Xp = spd.spd_solve_plain(B, R)
        torch.cuda.synchronize()
        # Each row is held to its own magnitude: the s*I padding rows
        # (X = R / s) are ~1e3 times the live rows and would otherwise set
        # an atol larger than every live value.
        scale = Xp.abs().amax(dim=-1, keepdim=True).clamp_min(1.0)
        err = float((X - Xp).abs().max())
        used = float(((X - Xp).abs() / (atol_f * scale + rtol * Xp.abs())).max())
        if not used <= 1.0:
            raise AssertionError(f"SPD {path} m={m} F={nseq * F}: kernel vs twin max err "
                                 f"{err:.3g}, {used:.3g} of the per-row tolerance")
        worst = max(worst, err)
        ops, mean_active = _spd_active_ops(B.reshape(-1, m, m), 4)
        c = dict(path=path, F=nseq * F, m=m, k=4,
                 per_frame=1 / nseq, mean_active_pivots=mean_active,
                 bytes=nbytes(B, R, X), ops=ops,
                 ms=device_ms(lambda: spd.spd_solve(B, R), 200),
                 plain_ms=device_ms(lambda: spd.spd_solve_plain(B, R), 50),
                 library_ms=device_ms(lambda: torch.linalg.solve_ex(B, R), 50))
        c["bound_ms"], c["bound_by"] = bound(c["bytes"], c["ops"])
        if path.startswith("sweep"):
            sweep.append(dict(c, key=[nseq * F, m, 4]))
        else:
            calls.append(c)
        lines.append(f"{path} m={m} F={nseq * F} max err {err:.2e} ({used:.2e} of the per-row "
                     f"tolerance); {c['ms']:.5f} ms vs twin {c['plain_ms']:.5f} ms, solve_ex "
                     f"{c['library_ms']:.5f} ms, bound {c['bound_ms'] * 1e3:.3f} us "
                     f"({c['bound_by']}, {mean_active:.1f} active pivots)")
    log(f"[kernel spd_gj] {'; '.join(lines)}")
    return dict(name="spd_gj", route="cuda", source="vio_msckf_torch/csrc/spd_gj.cu",
                replaces="vio_msckf_tpu/ops/spd_pallas.py:47", max_abs_err=worst,
                calls=calls, batch=summed([c for c in calls if c["path"] == "batch"]),
                sweep_calls=sweep, **summed([c for c in calls if c["path"] == "slice"]))


KERNELS = ("fast_nms", "lk_pyramid", "spd_gj")


def _counters():
    from vio_msckf_torch import kernels

    return kernels.counters()


def counted(path, run, kernels=KERNELS):
    """Run one path with every kernel counter set to 0 just before and read
    just after; fails unless every kernel of the path (`kernels`) launched
    in it. Returns (run's result, {kernel: launches}, {kernel: {call shape:
    launches}})."""
    import torch

    counters = _counters()
    for c in counters.values():
        c.by_shape.clear()
    result = run()
    torch.cuda.synchronize()
    shapes = {k: dict(c.by_shape) for k, c in counters.items()}
    launches = {k: sum(s.values()) for k, s in shapes.items()}
    for k in kernels:
        if launches[k] <= 0:
            raise AssertionError(f"kernel {k} was never launched on the {path} path")
    return result, launches, shapes


def trajectory_metrics(name, est, gt, n):
    """ATE/RPE of one trajectory; fails on a wrong shape, a non-finite
    value or an ATE above the bench's bound."""
    from vio_msckf_torch.utils.metrics import ate_rmse, rpe_rmse

    if est.shape != (n, 3):
        raise AssertionError(f"{name}: trajectory shape {est.shape}, expected {(n, 3)}")
    ate = ate_rmse(est, gt, align=False)
    rpe = rpe_rmse(est, gt)
    if (not np.isfinite(est).all() or not math.isfinite(ate) or not math.isfinite(rpe)
            or ate > ATE_BOUND_M):
        raise AssertionError(f"{name}: trajectory diverged: ATE {ate} m, RPE {rpe} m")
    return ate, rpe


def phase_slice(cfg, frames, init, gt, n, dev):
    import torch
    from vio_msckf_torch.engine import VIOEngine

    eng = VIOEngine(cfg, dev)

    def run():
        carry = eng.init(init["q0"], init["bg0"], init["gravity"])
        return eng.run_sequence(carry, frames)

    t0 = time.perf_counter()
    (carry, outs), launches, shapes = counted("slice", run)
    first_s = time.perf_counter() - t0

    est = outs.p.cpu().numpy()
    ate, rpe = trajectory_metrics("slice", est, gt, n)
    resets = int(outs.did_reset.sum())
    log(f"[slice] {n} frames: ATE {ate:.4f} m, RPE {rpe:.4f} m (unaligned; bench bound "
        f"{ATE_BOUND_M} m), online resets {resets}, first pass {first_s:.2f} s")
    log(f"[slice] launches in that run: " + ", ".join(
        f"{k} {v} ({v / n:.2f}/frame)" for k, v in launches.items()))

    # Host synchronisations issued by one warm step.
    frame = {k: v[n // 2] for k, v in frames.items()}
    syncs = host_syncs(lambda: eng.step(carry, frame))
    log(f"[slice] host syncs in one warm step: {len(syncs)}"
        + (f" ({'; '.join(sorted(set(syncs)))})" if syncs else ""))
    if syncs:
        raise AssertionError(f"{len(syncs)} host syncs in one step")
    return dict(launches=launches, shapes=shapes, est=est, eng=eng, carry=carry, frame=frame,
                first_s=first_s)


BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "ate_rmse_m", "rpe_rmse_m"}


def phase_bench():
    """`python -m vio_msckf_torch.bench` in this process: its one JSON line
    (bench.py's keys), held to the bench's bound, and its launches."""
    from vio_msckf_torch import bench

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc, launches, shapes = counted("bench", lambda: bench.main([]))
    sec = time.perf_counter() - t0
    lines = buf.getvalue().splitlines()
    if rc != 0 or len(lines) != 1:
        raise AssertionError(f"bench.main([]) returned {rc} and printed {len(lines)} lines")
    result = json.loads(lines[0])
    nums = [result.get(k) for k in ("value", "vs_baseline", "ate_rmse_m", "rpe_rmse_m")]
    if (set(result) != BENCH_KEYS or result["unit"] != "frames/s"
            or not all(isinstance(x, float) and math.isfinite(x) for x in nums)
            or not result["value"] > 0 or result["ate_rmse_m"] > ATE_BOUND_M):
        raise AssertionError(f"bench line out of bounds: {lines[0]}")
    log(f"[bench] {lines[0]}")
    log(f"[bench] {sec:.1f} s in main() (workload, first pass, 3 timed passes); launches "
        + ", ".join(f"{k} {v}" for k, v in launches.items()))
    return dict(result=result, launches=launches, shapes=shapes)


def phase_batch(cfg, dev, single, bench_fps):
    import torch
    from vio_msckf_torch.engine import VIOEngine

    t0 = time.perf_counter()
    n = BATCH_DEPTH
    frames, inits, gts, _ = stack_workloads(
        [({k: v[:n] for k, v in w[0].items()}, w[1], w[2][:n], n)
         for w in (build_workload(cfg, dict(seed=4 + b), device=dev) for b in range(BATCH))])
    torch.cuda.synchronize()
    log(f"[batch] {BATCH} sequences (seeds 4..{3 + BATCH}) x {n} frames rendered in "
        f"{time.perf_counter() - t0:.2f} s")
    eng = VIOEngine(cfg, dev)

    def run():
        return eng.run_batch(eng.init_batch(inits), frames)

    t0 = time.perf_counter()
    (carry, outs), launches, shapes = counted("batch", run)
    first_s = time.perf_counter() - t0
    est = outs.p.cpu().numpy()
    metrics = [trajectory_metrics(f"batch sequence {b}", est[b], gts[b], n)
               for b in range(BATCH)]
    log(f"[batch] B={BATCH}, {n} frames, first pass {first_s:.2f} s: ATE " + ", ".join(
        f"{a:.4f}" for a, _ in metrics) + " m; RPE " + ", ".join(
        f"{r:.4f}" for _, r in metrics) + f" m (bound {ATE_BOUND_M} m; TPU v5e anchor "
        f"{TPU_ANCHOR_ATE['4-sequence batch']} m, the JAX package's)")
    gap = float(np.abs(est[0] - single["est"][:n]).max())
    log(f"[batch] member 0 against the one-sequence run of the same workload: max "
        f"per-frame position gap {gap:.3g} m (bound 1e-4 m)")
    if not gap <= 1e-4:
        raise AssertionError(f"batch member 0 is {gap} m from the one-sequence run")
    per_step = {k: v / n for k, v in launches.items()}
    log(f"[batch] hand-kernel launches per batched step: " + ", ".join(
        f"{k} {v:g}" for k, v in per_step.items()))
    if per_step != {"fast_nms": 1, "lk_pyramid": 3, "spd_gj": 2}:
        raise AssertionError(f"launches per batched step {per_step}, expected 3/1/2")

    frame = {k: v[:, n // 2] for k, v in frames.items()}
    syncs = host_syncs(lambda: eng.step_batch(carry, frame))
    log(f"[batch] host syncs in one warm batched step: {len(syncs)}"
        + (f" ({'; '.join(sorted(set(syncs)))})" if syncs else ""))
    if syncs:
        raise AssertionError(f"{len(syncs)} host syncs in one batched step")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    log(f"[batch] second pass {sec:.3f} s = {BATCH * n / sec:.2f} aggregate frames/s "
        f"({n / sec:.2f} steps/s; one sequence in this call, the bench's best of 3: "
        f"{bench_fps:.2f} frames/s)")

    prof = {}
    for name, step in (("B=1", lambda: single["eng"].step(single["carry"], single["frame"])),
                       (f"B={BATCH}", lambda: eng.step_batch(carry, frame))):
        step()                                       # warm the profiler's path
        kl, dev_ms, kernels, _ = launch_profile(step)
        prof[name] = dict(launch_calls=kl, device_ms=dev_ms, kernels=kernels)
        log(f"[batch] one warm step at {name}: {sum(kl.values())} kernel launches ("
            + ", ".join(f"{k} {v}" for k, v in sorted(kl.items())) + f"), device kernel "
            f"time {dev_ms:.3f} ms (torch.profiler)")
    # Where the batch adds launches: the device kernels whose count grows
    # from B = 1 to B = 4 (one code path, so a growth is a library call
    # issuing work per matrix or per sequence).
    k1, k4 = prof["B=1"]["kernels"], prof[f"B={BATCH}"]["kernels"]
    c1, c4 = ({k: v["calls"] for k, v in ks.items()} for ks in (k1, k4))
    grow = sorted(((c4.get(k, 0) - c1.get(k, 0), k) for k in set(c1) | set(c4)), reverse=True)
    log("[batch] kernels whose count grows from B=1 to B=%d: " % BATCH + "; ".join(
        f"{k[:70]} {c1.get(k, 0)} -> {c4.get(k, 0)}" for d, k in grow[:6] if d > 0))
    return dict(launches=launches, shapes=shapes, fps=BATCH * n / sec, profile=prof, eng=eng,
                frames=frames, inits=inits, est=est, n=n, step_ms=sec / n * 1e3,
                first_s=first_s)


def suite_pair(cfg, dev):
    """Fast motion and the hostile world (seed 4, rendered with
    HOSTILE_AUGS by the port) as one B = 2 batch over SUITE_DEPTH frames
    through VIOEngine.run_batch, counted as the "suite" path: (names,
    workloads, ground truths, n, engine, outputs, launches, shapes, s)."""
    from vio_msckf_torch.data.render import HOSTILE_AUGS
    from vio_msckf_torch.engine import VIOEngine

    names = ("fast motion", "hostile")
    workloads = [build_workload(cfg, FAST_MOTION, device=dev),
                 build_workload(cfg, render_augs=HOSTILE_AUGS, device=dev)]
    n = SUITE_DEPTH
    workloads = [({k: v[:n] for k, v in w[0].items()}, w[1], w[2][:n], n) for w in workloads]
    frames, inits, gts, _ = stack_workloads(workloads)
    eng = VIOEngine(cfg, dev)
    t0 = time.perf_counter()
    (_, outs), launches, shapes = counted(
        "suite", lambda: eng.run_batch(eng.init_batch(inits), frames))
    return names, workloads, gts, n, eng, outs, launches, shapes, time.perf_counter() - t0


def phase_suite(cfg, dev):
    from vio_msckf_torch.config import FilterConfig
    from vio_msckf_torch.engine import VIOEngine

    out = {}
    names, workloads, gts, n, eng, outs, launches, shapes, sec = suite_pair(cfg, dev)
    est = outs.p.cpu().numpy()
    for b, name in enumerate(names):
        ate, rpe = trajectory_metrics(name, est[b], gts[b], n)
        out[name] = dict(ate=ate, rpe=rpe, resets=int(outs.did_reset[b].sum()))
        log(f"[suite] {name}: ATE {ate:.4f} m, RPE {rpe:.4f} m, online resets "
            f"{out[name]['resets']} (TPU v5e anchor ATE {TPU_ANCHOR_ATE[name]} m, the JAX "
            f"package's)")
    log(f"[suite] fast motion + hostile as one B=2 batch: {n} frames in {sec:.2f} s, "
        f"launches " + ", ".join(f"{k} {v}" for k, v in launches.items()))
    out["pair"] = dict(names=names, est=est, gts=gts, n=n)
    suite_launches = {"suite B=2": (launches, shapes)}
    # Two different sequences in one batch: each member against the same
    # sequence run alone, so that a member reading the other's rows shows.
    for b, (name, (dframes, init, _, _)) in enumerate(zip(names, workloads)):
        _, alone = eng.run_sequence(eng.init(init["q0"], init["bg0"], init["gravity"]),
                                    dframes)
        gap = float(np.abs(est[b] - alone.p.cpu().numpy()).max())
        log(f"[suite] {name}: B=2 member {b} against the sequence run alone: max "
            f"per-frame position gap {gap:.3g} m (bound 1e-4 m)")
        if not gap <= 1e-4:
            raise AssertionError(f"suite member {b} ({name}) is {gap} m from its run alone")

    # The 30-clone window (bench.py: FilterConfig(max_cam_state_size=30)).
    big = cfg.replace(filter=FilterConfig(max_cam_state_size=CLONES_30))
    dframes, init, gt, _ = build_workload(big, device=dev)
    n = SUITE_DEPTH
    dframes, gt = {k: v[:n] for k, v in dframes.items()}, gt[:n]
    eng = VIOEngine(big, dev)
    t0 = time.perf_counter()
    (_, outs), launches, shapes = counted("30 clones", lambda: eng.run_sequence(
        eng.init(init["q0"], init["bg0"], init["gravity"]), dframes))
    sec = time.perf_counter() - t0
    ate, rpe = trajectory_metrics("30 clones", outs.p.cpu().numpy(), gt, n)
    out["30 clones"] = dict(ate=ate, rpe=rpe, resets=int(outs.did_reset.sum()))
    log(f"[suite] 30 clones (D={big.state_dim}): ATE {ate:.4f} m, RPE {rpe:.4f} m, online "
        f"resets {out['30 clones']['resets']}, {n} frames in {sec:.2f} s, launches "
        + ", ".join(f"{k} {v}" for k, v in launches.items())
        + f" (TPU v5e anchor ATE {TPU_ANCHOR_ATE['30 clones']} m, the JAX package's)")
    suite_launches["30 clones"] = (launches, shapes)
    return out, suite_launches


def rank_reports(out_dir, nprocs):
    """Each rank's positions by batch row ("p", and "p_eager" where the
    worker ran --eager) and its report (worker.py)."""
    held, reports = {}, []
    for r in range(nprocs):
        z = np.load(os.path.join(out_dir, f"rank{r}.npz"))
        for key in ("p", "p_eager"):
            for b, p in zip(z["rows"], z[key] if key in z.files else ()):
                held.setdefault(key, {}).setdefault(int(b), []).append(p)
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            reports.append(json.load(f))
    return held, reports


def merge_launches(reports, shapes):
    """Add the ranks' launches per kernel and call shape into `shapes`."""
    for rep in reports:
        for name, pairs in rep["launches"].items():
            for shape, n in pairs:
                shapes[name][tuple(shape)] = shapes[name].get(tuple(shape), 0) + n


def run_ranks(label, nprocs, args, backend="gloo"):
    """The worker on nprocs ranks (gloo: all sharing card 0; NCCL: rank r
    on card r): the rows merged over the ranks, those of the eager pass
    (None without --eager) and the reports. Fails when block peers
    disagree, and when a rank of an NCCL run did not capture its step or
    one of a gloo run did."""
    from vio_msckf_torch.parallel.distributed import Ranks

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="vio_ranks_") as d:
        Ranks("vio_msckf_torch.parallel.worker", nprocs,
              ["--out", d, "--device", "cuda", "--backend", backend, *args]).wait(PAR_TIMEOUT_S)
        held, reports = rank_reports(d, nprocs)
    sec = time.perf_counter() - t0
    rows = held["p"]
    peer_gap = max(float(np.abs(p - ps[0]).max()) for ps in rows.values() for p in ps)
    merged = np.stack([rows[b][0] for b in sorted(rows)])
    eager = (np.stack([held["p_eager"][b][0] for b in sorted(rows)]) if "p_eager" in held
             else None)
    staged = {k: max(r["staged_per_step"].get(k, 0) for r in reports)
              for k in ("to_host", "to_device")}
    ms = [r["step_ms"] for r in reports]
    captured = {r["captured"] for r in reports}
    where = sorted({r["device"] for r in reports})
    log(f"[parallel] {label}: {nprocs} ranks, backend {reports[0]['backend']} on "
        f"{', '.join(where)}, {'graphed' if True in captured else 'eager'}, {sec:.1f} s with "
        f"start-up; {min(ms):.1f}-{max(ms):.1f} ms a step per rank"
        + (f" (capture {max(r['capture_s'] for r in reports):.2f} s)" if True in captured else "")
        + (f", eager {min(r['eager_step_ms'] for r in reports):.1f}-"
           f"{max(r['eager_step_ms'] for r in reports):.1f} ms" if eager is not None else "")
        + (" (ranks sharing one H100: not a scaling number)" if len(where) < nprocs else "")
        + f"; host copies staged for gloo per step and rank: {staged['to_host']:g} to the host, "
        f"{staged['to_device']:g} back; block peers agree within {peer_gap:.3g} m")
    if not peer_gap <= 1e-6:
        raise AssertionError(f"{label}: block peers differ by {peer_gap} m")
    if captured != {backend == "nccl"}:
        raise AssertionError(f"{label}: {backend} ranks captured: {sorted(captured)}")
    return merged, eager, reports


def filter_reference(cfg, dev, seeds, frames):
    """The simulated tracks of `seeds` (6 s each) through the unsharded
    filter on the card, B = len(seeds): the eager kf.step loop over the
    first `frames` frames, then MSCKF.run_sequence (the filter alone,
    replayed; bound GRAPH_BOUND_M) over the same frames. Returns
    (eager positions (B, T, 3), the graphed run's record)."""
    import torch
    from vio_msckf_torch.data.simulator import SimConfig, bundle_frames, simulate_sequence
    from vio_msckf_torch.filter.msckf import MSCKF

    seqs = [bundle_frames(simulate_sequence(cfg, SimConfig(duration=6.0, seed=s)), cfg)
            for s in seeds]
    T = min(frames, *(len(f["imu_dt"]) for f, _, _ in seqs))
    feed = ("imu_gyro", "imu_acc", "imu_dt", "imu_valid", "feat_ids", "feat_obs", "feat_valid")
    tracks = {key: torch.as_tensor(np.stack([f[key][:T] for f, _, _ in seqs]), device=dev)
              for key in feed}
    kf = MSCKF(cfg, dev)
    inits = [init for _, init, _ in seqs]

    def eager():
        carry, ps = kf.init_batch(inits), []
        for k in range(T):
            carry, out = kf.step(carry, {key: v[:, k] for key, v in tracks.items()})
            ps.append(out.p)
        return torch.stack(ps, dim=1).cpu().numpy()

    t0 = time.perf_counter()
    ref, _, shapes_e = counted("filter eager", eager, kernels=("spd_gj",))
    eager_ms = (time.perf_counter() - t0) / T * 1e3
    t0 = time.perf_counter()
    p_g, launches, shapes_g = counted("filter alone", lambda: kf.run_sequence(
        kf.init_batch(inits), tracks)[1].p.cpu().numpy(), kernels=("spd_gj",))
    first_s = time.perf_counter() - t0
    gap = float(np.abs(p_g - ref).max())
    check_same("the filter alone", gap, shapes_e, shapes_g)
    (g,) = kf.compiled.graphs.values()
    m = replay_metrics(g, {k: v[:, T // 2] for k, v in tracks.items()})
    return ref, dict(gap=gap, eager_ms=eager_ms, first_s=first_s, launches=launches,
                     shapes=shapes_g, T=T, **m)


def four_card_shapes(cfg):
    """The call shapes the four-card runs may launch: the engine's at B =
    1 and 2 sequences a rank, and the gate's at those B with the features
    split over block 2 and 4 (tools.batch_sweep.call_shapes). The one-card
    run holds each against the twin."""
    want = {k: set() for k in KERNELS}
    for B in (1, 2):
        for k, keys in call_shapes(cfg, B).items():
            want[k] |= keys
        for nb in (2, 4):
            want["spd_gj"] |= {(F // nb, m, c) for F, m, c in call_shapes(cfg, B)["spd_gj"]}
    return want


def phase_four_cards(cfg, pair, shapes):
    """[parallel] (c): NCCL, one rank per card, every sharded step graphed
    (needs 4 cards): the engine as replica 2 x block 2 on the suite's pair
    against the suite's unsharded B = 2 run (PAR_BOUND_M) and against the
    same mesh stepped eagerly (GRAPH_BOUND_M); the filter alone as 1 x 4
    (two butterfly rounds across cards) against the unsharded filter
    (PAR_FILTER_BOUND_M); each rank's replay profiled (NCCL kernels in it
    must be > 0); dryrun_multichip(4) under NCCL. The ranks' launches are
    added into `shapes`."""
    import torch
    from vio_msckf_torch.parallel.dryrun import dryrun_multichip

    t_phase = time.perf_counter()

    def check(label, reports, graphed, eager, ref, bound):
        gap_eager = float(np.abs(graphed - eager).max())
        gap_ref = float(np.abs(graphed - ref).max())
        rep = [r["replay"] for r in reports]
        log(f"[parallel] (c) {label}: graphed against the same mesh stepped eagerly "
            f"{gap_eager:.3g} m (bound {GRAPH_BOUND_M} m), against the unsharded run "
            f"{gap_ref:.3g} m (bound {bound} m); one replay per rank: 0 host syncs, "
            + ", ".join(f"{x['host_calls']}" for x in rep) + " host launch calls, "
            + ", ".join(f"{x['device_kernels']}" for x in rep) + " device kernels, NCCL kernels "
            + ", ".join(f"{x['nccl_kernels']}" for x in rep) + " ("
            + "; ".join(sorted({n[:60] for x in rep for n in x["nccl_names"]})) + ") taking "
            + ", ".join(f"{x['nccl_ms']:.3f}" for x in rep) + " ms of "
            + ", ".join(f"{x['device_ms']:.3f}" for x in rep) + " ms device time (profiled), "
            "hand kernels in the trace " + ", ".join(
                f"{k} {v}" for k, v in rep[0]["traced"].items()) + " as counted; a replay "
            + ", ".join(f"{x['replay_ms']:.3f}" for x in rep) + " ms unprofiled (CUDA events)")
        if not (np.isfinite(graphed).all() and gap_eager <= GRAPH_BOUND_M and gap_ref <= bound):
            raise AssertionError(f"{label}: {gap_eager} m from eager, {gap_ref} m from unsharded")
        if not all(x["nccl_kernels"] > 0 for x in rep):
            raise AssertionError(f"{label}: a replay ran no NCCL kernel: the collectives are "
                                 f"not in the graph")

    nr, nb = PAR_ENGINE_MESH
    specs = [dict(sim=dict(SIM, **FAST_MOTION)), dict(sim=SIM, hostile=True)]
    merged, eager, reports = run_ranks(
        f"(c) engine {nr} x {nb} over NCCL", nr * nb,
        ["--replica", nr, "--block", nb, "--mode", "engine", "--frames", pair["n"], "--eager",
         "--profile", "--sequences", json.dumps(specs)], "nccl")
    merge_launches(reports, shapes)
    check(f"engine {nr} x {nb}", reports, merged, eager, np.stack(pair["est"]), PAR_BOUND_M)

    nr, nb = PAR_FOUR_FILTER_MESH
    seqs = [dict(sim=dict(duration=6.0, seed=s)) for s in PAR_SEEDS]
    merged, eager, reports = run_ranks(
        f"(c) filter {nr} x {nb} over NCCL", nr * nb,
        ["--replica", nr, "--block", nb, "--mode", "filter", "--frames", PAR_FILTER_FRAMES,
         "--eager", "--profile", "--sequences", json.dumps(seqs)], "nccl")
    merge_launches(reports, shapes)
    ref, _ = filter_reference(cfg, torch.device("cuda", 0), PAR_SEEDS, PAR_FILTER_FRAMES)
    check(f"filter {nr} x {nb}", reports, merged, eager, ref, PAR_FILTER_BOUND_M)

    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as said:
        dry = dryrun_multichip(4, device="cuda", backend="nccl", timeout=PAR_TIMEOUT_S)
    log(f"[parallel] (c) {said.getvalue().strip()}; {time.perf_counter() - t0:.1f} s")
    if "nccl, captured and replayed" not in said.getvalue():
        raise AssertionError(f"dryrun_multichip(4, nccl): {said.getvalue()}")
    for k in KERNELS:
        for shape, n in dry.get(k, {}).items():
            shapes[k][shape] = shapes[k].get(shape, 0) + n
    log(f"[parallel] (c) four cards took {time.perf_counter() - t_phase:.1f} s")


def phase_parallel(cfg, dev, suite, single, frames):
    """Scale-out: the sharded engine and filter in gloo ranks on the card;
    (a) one NCCL rank at world size 1, graphed; (b) the filter alone,
    graphed; (c) NCCL over four cards where the machine has them; the dry
    run."""
    import torch
    import torch.distributed as dist
    from vio_msckf_torch import comm
    from vio_msckf_torch.parallel import make_mesh, make_multichip_engine_step
    from vio_msckf_torch.parallel.distributed import free_port
    from vio_msckf_torch.parallel.dryrun import dryrun_multichip

    t_phase = time.perf_counter()
    shapes = {k: {} for k in KERNELS}
    pair = suite["pair"]
    n = pair["n"]

    # 0. Why the ranks below share the card through gloo: NCCL refuses two
    # ranks on one GPU. That refusal, on one card, is the only failure
    # accepted; with two or more cards each rank gets its own and both must
    # run, their block peers agreeing.
    filter_seqs = [dict(sim=dict(duration=6.0, seed=s)) for s in PAR_SEEDS]
    t0 = time.perf_counter()
    try:
        run_ranks("NCCL 1 x 2", 2, ["--replica", 1, "--block", 2, "--frames", 2,
                                    "--sequences", json.dumps(filter_seqs[:1])], "nccl")
        nccl_two = "both ranks ran"
    except RuntimeError as e:
        said = [ln.strip() for ln in str(e).splitlines() if "Duplicate GPU" in ln]
        if torch.cuda.device_count() > 1 or not said:
            raise
        nccl_two = "refused: " + said[0]
    log(f"[parallel] NCCL with 2 ranks on {torch.cuda.device_count()} card(s): {nccl_two} "
        f"({time.perf_counter() - t0:.1f} s)")

    # 1. The suite's B = 2 pair, one sequence per replica, block = 2, gloo
    # ranks sharing the card: the eager sharded step.
    nr, nb = PAR_ENGINE_MESH
    specs = [dict(sim=dict(SIM, **FAST_MOTION)), dict(sim=SIM, hostile=True)]
    merged, _, reports = run_ranks(
        f"engine {nr} x {nb}", nr * nb,
        ["--replica", nr, "--block", nb, "--mode", "engine", "--frames", n,
         "--sequences", json.dumps(specs)])
    merge_launches(reports, shapes)
    for b, name in enumerate(pair["names"]):
        gap = float(np.abs(merged[b] - pair["est"][b]).max())
        ate, rpe = trajectory_metrics(f"parallel {name}", merged[b], pair["gts"][b], n)
        log(f"[parallel] engine, {name}: ATE {ate:.4f} m, RPE {rpe:.4f} m over {n} frames; "
            f"max per-frame position gap to the suite's unsharded B=2 run {gap:.3g} m "
            f"(bound {PAR_BOUND_M} m)")
        if not gap <= PAR_BOUND_M:
            raise AssertionError(f"sharded engine, {name}: {gap} m from the unsharded run")

    # 2. The filter alone, block = 4: two butterfly rounds.
    nr, nb = PAR_FILTER_MESH
    merged, _, reports = run_ranks(
        f"filter {nr} x {nb}", nr * nb,
        ["--replica", nr, "--block", nb, "--mode", "filter", "--frames", PAR_FILTER_FRAMES,
         "--sequences", json.dumps(filter_seqs)])
    merge_launches(reports, shapes)
    ref, alone = filter_reference(cfg, dev, PAR_SEEDS, PAR_FILTER_FRAMES)
    gap = float(np.abs(merged - ref).max())
    log(f"[parallel] filter {nr} x {nb}, seeds {PAR_SEEDS}, {alone['T']} frames: max position "
        f"gap to the unsharded filter on the card {gap:.3g} m (bound {PAR_FILTER_BOUND_M} m)")
    if not (np.isfinite(merged).all() and gap <= PAR_FILTER_BOUND_M):
        raise AssertionError(f"sharded filter: {gap} m from the unsharded filter")
    for k in KERNELS:
        if not sum(shapes[k].values()) > 0:
            raise AssertionError(f"kernel {k} was never launched on the parallel path")

    # (b) The filter alone, graphed: MSCKF.run_sequence against the eager
    # kf.step loop that gave the reference above.
    log(f"[parallel] (b) the filter alone, B = {len(PAR_SEEDS)}, {alone['T']} frames: "
        f"MSCKF.run_sequence against the eager kf.step loop: max position gap "
        f"{alone['gap']:.3g} m (bound {GRAPH_BOUND_M} m); spd_gj launches "
        f"{alone['launches']['spd_gj']} both ways; a step {alone['eager_ms']:.2f} ms eager, "
        f"the graphed run {alone['first_s']:.2f} s with its capture; {replay_line(alone)}")

    # (a) One NCCL rank, a block group of one: the sharded engine step
    # graphed with its all-gathers inside, against the same step eager.
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh(1, 1)
        step, eng = make_multichip_engine_step(cfg, mesh, device=dev)
        sl = {k: v[:NCCL_FRAMES][None] for k, v in frames.items()}
        init = single["init"]

        def eager():
            carry, ps = eng.init_batch([init]), []
            for k in range(NCCL_FRAMES):
                carry, o = eng.step_batch(carry, {key: v[:, k] for key, v in sl.items()})
                ps.append(o.p)
            return torch.stack(ps, dim=1).cpu().numpy()

        def graphed():
            carry, ps = eng.init_batch([init]), []
            for k in range(NCCL_FRAMES):
                carry, o = step(carry, {key: v[:, k] for key, v in sl.items()})
                ps.append(o.p)
            return torch.stack(ps, dim=1).cpu().numpy()

        t0 = time.perf_counter()
        p_e, _, shapes_e = counted("parallel nccl eager", eager)
        eager_ms = (time.perf_counter() - t0) / NCCL_FRAMES * 1e3
        comm.STAGED.clear()
        t0 = time.perf_counter()
        p_g, launches, nccl_shapes = counted("parallel nccl", graphed)
        sec = time.perf_counter() - t0
        gap = float(np.abs(p_g - p_e).max())
        check_same("NCCL world 1", gap, shapes_e, nccl_shapes)
        gap_slice = float(np.abs(p_g[0] - single["est"][:NCCL_FRAMES]).max())
        (g,) = eng.compiled.graphs.values()
        m = replay_metrics(g, {key: v[:, NCCL_FRAMES // 2] for key, v in sl.items()})
        log(f"[parallel] (a) NCCL, world size 1, block group of one, {NCCL_FRAMES} frames through "
            f"the replaying step of make_multichip_engine_step: max gap to the same step eager "
            f"{gap:.3g} m (bound {GRAPH_BOUND_M} m), to the slice {gap_slice:.3g} m (bound 1e-4 "
            f"m); launches identical per call shape (" + ", ".join(
                f"{k} {v}" for k, v in launches.items()) + f"); a step {eager_ms:.1f} ms eager, "
            f"{sec / NCCL_FRAMES * 1e3:.1f} ms graphed with the first (capture and a carry "
            f"copy a call); host copies staged: {sum(comm.STAGED.values())}; NCCL kernels in "
            f"a replay {m['nccl_kernels']} (at one rank NCCL copies on the device: the gathers "
            f"feed every gate and update, so the equal bits show them replayed); "
            f"{replay_line(m)}")
        if not gap_slice <= 1e-4 or sum(comm.STAGED.values()):
            raise AssertionError(f"NCCL world 1: {gap_slice} m from the slice, "
                                 f"{sum(comm.STAGED.values())} staged copies")
        del g
        eng.compiled.clear()            # before the group: NCCL's shutdown waits for it
    finally:
        dist.destroy_process_group()

    # (c) Four cards, NCCL, one rank per card.
    if torch.cuda.device_count() >= 4:
        phase_four_cards(cfg, pair, shapes)
    else:
        log(f"[parallel] (c) NCCL over four cards, one rank per card: "
            f"{torch.cuda.device_count()} card: not run")

    # The dry run: one engine step at EuRoC shapes over 4 gloo ranks.
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        dry = dryrun_multichip(4, device="cuda", backend="gloo", timeout=PAR_TIMEOUT_S)
    log(f"[parallel] dryrun_multichip(4) under gloo: replica 2 x block 2, batch 4, pose "
        f"finite, {time.perf_counter() - t0:.1f} s")
    log(f"[parallel] phase took {time.perf_counter() - t_phase:.1f} s")
    return {"parallel": ({k: sum(v.values()) for k, v in shapes.items()}, shapes),
            "parallel nccl": (launches, nccl_shapes),
            "parallel filter alone": (alone["launches"], alone["shapes"]),
            "parallel dryrun": ({k: sum(dry.get(k, {}).values()) for k in KERNELS},
                                {k: dry.get(k, {}) for k in KERNELS})}


def run_cli(argv):
    """vio_msckf_torch.cli.main(argv), its standard output captured; returns
    the numbers it printed ({"dataset_fps": x, ...})."""
    from vio_msckf_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    if rc != 0:
        raise AssertionError(f"cli.main({argv}) returned {rc}")
    printed = {}
    for line in buf.getvalue().splitlines():
        key, _, val = line.partition(" ")
        with contextlib.suppress(ValueError):
            printed[key] = float(val)
    return printed


def tum_lines(path):
    with open(path) as f:
        return f.read().splitlines()


def tum_positions(lines):
    return np.array([[float(v) for v in ln.split()[1:4]] for ln in lines])


PNG_FILTERS = ("None", "Sub", "Up", "Average", "Paeth")


def png_row_filters(path):
    """How many rows of an 8-bit grayscale PNG use each row filter."""
    with open(path, "rb") as f:
        data = f.read()
    pos, idat, width = 8, b"", None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind, payload = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        if kind == b"IHDR":
            width = struct.unpack(">I", payload[:4])[0]
        elif kind == b"IDAT":
            idat += payload
        pos += 12 + length
    kinds = zlib.decompress(idat)[::width + 1]
    return {name: kinds.count(i) for i, name in enumerate(PNG_FILTERS) if kinds.count(i)}


def phase_cli(cfg, dev, root):
    """The EuRoC entry point, in its three modes and through a checkpoint,
    and on frames PIL encoded."""
    import PIL
    from PIL import Image
    import torch
    from vio_msckf_torch.data.euroc import EuRoCSequence, bundle_euroc_frames
    from vio_msckf_torch.data.simulator import SimConfig
    from vio_msckf_torch.data.synth_euroc import write_synthetic_euroc
    from vio_msckf_torch.engine import VIOEngine
    from vio_msckf_torch.runtime import native_loader
    from vio_msckf_torch.utils.checkpoint import load_checkpoint
    from vio_msckf_torch.utils.metrics import ate_rmse, rpe_rmse

    t0 = time.perf_counter()
    written = write_synthetic_euroc(root, cfg, SimConfig(**SIM), render_seed=BENCH_WORLD["seed"],
                                    device=dev)
    log(f"[cli] wrote the bench sequence as an EuRoC tree: {written} stereo PNG pairs "
        f"{cfg.cam0.resolution[0]}x{cfg.cam0.resolution[1]} in "
        f"{time.perf_counter() - t0:.2f} s (port renderer + numpy/zlib PNG encoder)")
    decoder = native_loader.decoder_name()
    log(f"[cli] PNG decoder: {decoder}")
    f = lambda name: os.path.join(root, name)  # noqa: E731
    base = ["--path", root, "--offset", "0", "--chunk", str(CLI_CHUNK)]
    runs = {}

    def mode(path, argv):
        t = time.perf_counter()
        printed, launches, shapes = counted(path, lambda: run_cli(base + argv))
        runs[path] = dict(printed=printed, launches=launches, shapes=shapes,
                          seconds=time.perf_counter() - t)
        return printed

    chunked = mode("cli", ["--out", f("chunked.txt"), "--checkpoint", f("chunked.ckpt")])
    lines = tum_lines(f("chunked.txt"))
    n = len(lines)
    est = tum_positions(lines)
    seq = EuRoCSequence(root, 0.0)
    times = np.array([float(ln.split()[0]) for ln in lines])
    gt = seq.gt_aligned_positions(times)
    ate, rpe = ate_rmse(est, gt, align=True), rpe_rmse(est, gt)
    l_cli = runs["cli"]["launches"]
    log(f"[cli] chunked (--chunk {CLI_CHUNK}), {n} frames: dataset_fps "
        f"{chunked['dataset_fps']:.2f}, ATE {ate:.4f} m (SE3-aligned, as the CLI prints: "
        f"{chunked['ate_rmse_m']}), RPE {rpe:.4f} m, {runs['cli']['seconds']:.2f} s in "
        f"main(); launches " + ", ".join(f"{k} {v} ({v / n:.2f}/frame)" for k, v in l_cli.items()))
    if not (np.isfinite(est).all() and math.isfinite(ate) and ate <= ATE_BOUND_M):
        raise AssertionError(f"cli: trajectory diverged: ATE {ate} m")

    pre = mode("cli --preload", ["--max-frames", str(CLI_PARTIAL), "--preload",
                                 "--out", f("preload.txt")])
    per = mode("cli per-frame", ["--max-frames", str(CLI_PARTIAL), "--ratio", "1000",
                                 "--out", f("per_frame.txt")])
    log(f"[cli] --preload, {CLI_PARTIAL} frames: dataset_fps_compute "
        f"{pre['dataset_fps_compute']:.2f}, dataset_fps {pre['dataset_fps']:.2f}; per frame "
        f"(--ratio 1000): dataset_fps {per['dataset_fps']:.2f}")
    gaps = {}
    for name in ("preload", "per_frame"):
        other = tum_lines(f(f"{name}.txt"))
        same = other == lines[:CLI_PARTIAL]
        gaps[name] = float(np.abs(tum_positions(other) - est[:CLI_PARTIAL]).max())
        log(f"[cli] {name} against chunked over {CLI_PARTIAL} frames: TUM lines "
            f"{'identical' if same else 'differ'}, max position gap {gaps[name]:.3g} m")
        if not gaps[name] <= 1e-6:
            raise AssertionError(f"cli {name} is {gaps[name]} m from the chunked run")

    mode("cli checkpoint", ["--max-frames", str(CKPT_FRAME), "--checkpoint", f("part.ckpt"),
                            "--checkpoint-every", str(CKPT_FRAME)])
    mode("cli resume", ["--resume", f("part.ckpt"), "--checkpoint", f("resumed.ckpt"),
                        "--out", f("resumed.txt")])
    like = VIOEngine(cfg, dev).init()
    (c_full, step_full, _), (c_res, step_res, _) = (load_checkpoint(f(x), like)
                                                  for x in ("chunked.ckpt", "resumed.ckpt"))
    gap = float((c_full[1].p - c_res[1].p).abs().max())
    resumed = tum_lines(f("resumed.txt"))
    log(f"[cli] checkpoint at frame {CKPT_FRAME}, resumed to frame {step_res}: final pose "
        f"{gap:.3g} m from the uninterrupted run's (bound 1e-6 m); resumed TUM lines "
        f"{'identical to' if resumed == lines[CKPT_FRAME:] else 'differ from'} the "
        f"uninterrupted run's")
    if step_full != n or step_res != n or not gap <= 1e-6:
        raise AssertionError(f"resume: steps {step_full}/{step_res}, final pose gap {gap} m")

    # The first CLI_PIL frames after the IMU initialization re-encoded by
    # PIL, as the JAX package's writer writes its trees
    # (vio_msckf_tpu/data/synth_euroc.py:68-71): PIL's adaptive row filters
    # put Paeth and Average rows in, which libpng's encoder writes too.
    pil_root = os.path.join(root, "pil")
    shutil.copytree(os.path.join(root, "mav0"), os.path.join(pil_root, "mav0"))
    _, _, first, _ = bundle_euroc_frames(seq, cfg)
    pil_seq = EuRoCSequence(pil_root, 0.0)
    for cam in (0, 1):
        for path in pil_seq.image_paths(0, first + CLI_PIL, cam):
            with Image.open(path) as im:
                pixels = np.asarray(im)
            Image.fromarray(pixels).save(path)
    filters = png_row_filters(pil_seq.image_paths(first + CLI_PIL // 2, 1, 0)[0])
    pil = mode("cli PIL", ["--path", pil_root, "--max-frames", str(CLI_PIL),
                           "--out", f("pil.txt")])
    same = tum_lines(f("pil.txt")) == lines[:CLI_PIL]
    log(f"[cli] {CLI_PIL} frames re-encoded by PIL {PIL.__version__} (the rows of frame "
        f"{CLI_PIL // 2} after the initialization: " + ", ".join(f"{v} {k}" for k, v in filters.items()) + f"), decoder "
        f"{native_loader.decoder_name().split(';')[0]}: chunked dataset_fps {pil['dataset_fps']:.2f}; "
        f"TUM lines {'identical to' if same else 'differ from'} the chunked run's")
    if not same:
        raise AssertionError("cli: the PIL-encoded frames gave another trajectory")
    torch.cuda.synchronize()
    return dict(runs=runs, n=n, ate=ate, rpe=rpe, fps=chunked["dataset_fps"], decoder=decoder,
                gaps=gaps, resume_gap=gap, pil_fps=pil["dataset_fps"])


def phase_eskf(cfg, dev, root, fast_entry):
    """The ESKF pipeline over the CLI phase's tree."""
    import torch
    from vio_msckf_torch import cli
    from vio_msckf_torch.data.euroc import EuRoCSequence, bundle_euroc_frames
    from vio_msckf_torch.eskf import EskfConfig, EskfVio
    from vio_msckf_torch.ops import fast

    args = cli.build_parser().parse_args(["--path", root, "--offset", "0", "--pipeline", "eskf",
                                          "--max-frames", str(ESKF_FRAMES)])
    quiet = logging.getLogger("chip_smoke.eskf")
    quiet.setLevel(logging.WARNING)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        (frame_times, outs, ate), launches, shapes = counted(
            "eskf", lambda: cli.eskf_euroc(args, quiet), kernels=("fast_nms",))
    sec = time.perf_counter() - t0
    n = len(frame_times)
    med = {k: float(np.median(outs[k][1:])) for k in ("n_stereo", "n_matches", "n_inliers")}
    log(f"[eskf] {n} frames, K = {EskfConfig().n_keypoints}: eskf_ate_rmse_m {ate:.4f} "
        f"(SE3-aligned, as the CLI prints; bound {ESKF_ATE_BOUND_M} m; the JAX package's "
        f"ESKF on a CPU: {ESKF_CPU_ANCHOR_ATE} m), median per frame: {med['n_stereo']:.0f} "
        f"stereo matches, "
        f"{med['n_matches']:.0f} temporal matches, {med['n_inliers']:.0f} inliers; "
        f"{n / sec:.2f} frames/s ({sec:.2f} s, decode included); launches "
        + ", ".join(f"{k} {v}" for k, v in launches.items() if v))
    if not (np.isfinite(outs["p"]).all() and ate is not None and math.isfinite(ate)
            and ate <= ESKF_ATE_BOUND_M):
        raise AssertionError(f"eskf: trajectory diverged: ATE {ate} m")

    # One warm step: kernel launches (torch.profiler) and host syncs.
    seq = EuRoCSequence(root, 0.0)
    frames, _, first, _ = bundle_euroc_frames(seq, cfg)
    vio = EskfVio(cfg, device=dev)

    def frame(k):
        return dict(cam0_img=torch.as_tensor(seq.load_image(first + k, 0), device=dev),
                    cam1_img=torch.as_tensor(seq.load_image(first + k, 1), device=dev),
                    **{key: torch.as_tensor(frames[key][k], device=dev)
                       for key in ("imu_gyro", "imu_acc", "imu_dt", "imu_valid")})

    carry = vio.init(frames["imu_acc"][1][frames["imu_valid"][1]][0])
    kw = min(2, n - 1)      # the step's launches do not depend on the frame
    for k in range(kw):
        carry, _ = vio.step(carry, frame(k))
    fw = frame(kw)
    step = lambda: vio.step(carry, fw)  # noqa: E731
    step()
    kl, dev_ms, _, _ = launch_profile(step)
    syncs = host_syncs(step)
    t1 = time.perf_counter()
    for _ in range(3):
        step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t1) / 3 * 1e3
    log(f"[eskf] one warm step: {sum(kl.values())} kernel launches ("
        + ", ".join(f"{k} {v}" for k, v in sorted(kl.items())) + f"), device kernel time "
        f"{dev_ms:.3f} ms in a {step_ms:.1f} ms step (torch.profiler; host clock over 3 "
        f"steps); host syncs {len(syncs)}"
        + (f" ({'; '.join(sorted(set(syncs)))})" if syncs else ""))
    if syncs:
        raise AssertionError(f"{len(syncs)} host syncs in one ESKF step")

    # FAST at the ESKF's call: both rectified views of the decoded frame
    # pair as one (2, H, W) stack at the ESKF's threshold, bit for bit.
    thr = vio.eskf.fast_threshold
    err, calls = 0.0, []
    kt = min(40, n - 1)                       # a frame in motion
    for k in (0, kt, n - 1):
        rect = vio.rectify(*(torch.as_tensor(seq.load_image(first + k, cam), device=dev)
                             for cam in (0, 1))).contiguous()
        out, want = fast.fast_nms(rect, thr), fast.fast_score_map(rect, thr)
        torch.cuda.synchronize()
        if not torch.equal(out, want):
            raise AssertionError(f"FAST kernel differs from its twin on the ESKF's rectified "
                                 f"frame {k} at threshold {thr}: {int((out != want).sum())} px")
        err = max(err, float((out - want).abs().max()))
        if k == kt:
            calls.append(dict(fast_call(rect, thr, "eskf"), per_frame=1))
    c = calls[0]
    fast_entry["calls"].append(c)
    fast_entry["eskf"] = summed(calls)
    fast_entry["max_abs_err"] = max(fast_entry["max_abs_err"], err)
    log(f"[kernel fast_nms] the ESKF's call {tuple(c['shape'])} at threshold {thr}: bit-exact "
        f"on the rectified pairs of frames 0, {kt}, {n - 1}; frame {kt}: {c['corners']} corners, "
        f"{c['candidates']} candidates, {c['ms']:.5f} ms vs twin {c['plain_ms']:.5f} ms, "
        f"bound {c['bound_ms'] * 1e3:.3f} us ({c['bound_by']})")
    return dict(launches=launches, shapes=shapes, n=n, ate=ate, fps=n / sec, medians=med,
                step_launches=sum(kl.values()), step_device_ms=dev_ms, step_ms=step_ms)


def replay_metrics(graph, frame):
    """One replay of a captured step (tools.profile_ops.replay_profile):
    host syncs (must be 0); under torch.profiler the host's launch calls,
    the device kernels and their device time, NCCL's kernels among them,
    and the replay's span on the device (CUDA events around it in the same
    profiled run); the hand kernels' launches in that trace, which must
    equal what the runner adds to their counters per replay; the busy
    share, device time over that span; and without the profiler, the span
    of a replay on the device (GRAPH_REPLAYS back to back between two CUDA
    events) and on the host clock (ending in synchronize)."""
    m = replay_profile(graph, frame, GRAPH_REPLAYS)
    return dict(m, busy=m["device_ms"] / m["span_ms"], capture_s=graph.capture_s)


def replay_line(m):
    return (f"capture {m['capture_s']:.2f} s; one replay: 0 host syncs, {m['host_calls']} host "
            f"launch calls (" + ", ".join(f"{k} {v}" for k, v in sorted(m["launch_calls"].items()))
            + f"), {m['device_kernels']} device kernels and copies ({m['nccl_kernels']} of "
            f"NCCL's; hand kernels in the trace "
            + ", ".join(f"{k} {v}" for k, v in m["traced"].items()) + ", as counted); under "
            f"torch.profiler {m['device_ms']:.3f} ms of device time in a {m['span_ms']:.3f} ms "
            f"span (CUDA events around the profiled replay: busy {m['busy'] * 100:.1f} % of "
            f"the profiled replay, which the profiler stretches); without it "
            f"{m['replay_ms']:.3f} ms a replay on the device (CUDA events) and "
            f"{m['wall_ms']:.3f} ms on the host clock, {GRAPH_REPLAYS} back to back")


def check_same(label, gap, shapes_eager, shapes_graph):
    if not gap <= GRAPH_BOUND_M:
        raise AssertionError(f"{label}: graphed run is {gap} m from the eager step")
    if shapes_eager != shapes_graph:
        raise AssertionError(f"{label}: launches eager {shapes_eager}, graphed {shapes_graph}")


def graph_engine(single, batch, frames, init, n):
    """B = 1 over the slice's frames and B = 4 over the batch's: the eager
    step loop against the graphed runs of [slice] and [batch]."""
    import torch

    out = {}
    eng = single["eng"]

    def eager1():
        carry, ps = eng.init(init["q0"], init["bg0"], init["gravity"]), []
        for k in range(n):
            carry, o = eng.step(carry, {key: v[k] for key, v in frames.items()})
            ps.append(o.p)
        return torch.stack(ps).cpu().numpy()

    t0 = time.perf_counter()
    p_e, launches, shapes = counted("graph eager B=1", eager1)
    eager_ms = (time.perf_counter() - t0) / n * 1e3
    gap = float(np.abs(p_e - single["est"]).max())
    check_same("B=1", gap, shapes, single["shapes"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run_sequence(eng.init(init["q0"], init["bg0"], init["gravity"]), frames)
    torch.cuda.synchronize()
    graphed_ms = (time.perf_counter() - t0) / n * 1e3
    (g,) = eng.compiled.graphs.values()
    m = replay_metrics(g, {k: v[n // 2][None] for k, v in frames.items()})
    log(f"[graph] B=1, {n} frames: graphed run_sequence against the eager step loop: max "
        f"position gap {gap:.3g} m (bound {GRAPH_BOUND_M} m); launches identical per call "
        f"shape (" + ", ".join(f"{k} {v}" for k, v in launches.items()) + f"); a step "
        f"{eager_ms:.2f} ms eager, {graphed_ms:.2f} ms graphed (host clock over the pass; "
        f"the first graphed pass, capture included, {single['first_s']:.2f} s)")
    log(f"[graph] B=1: {replay_line(m)}")
    out["B=1"] = dict(gap=gap, eager_ms=eager_ms, graphed_ms=graphed_ms, launches=launches,
                      shapes=shapes, **m)

    # A graphed run's counts are the runner's bookkeeping (a replay calls
    # no wrapper). One whole graphed run from a fresh engine (the eager
    # warm-up frame, the capture, the replays) under torch.profiler: the
    # device must run as many launches of each kernel as the counters say.
    from vio_msckf_torch.engine import VIOEngine

    teng, tn = VIOEngine(eng.config, eng.device), TRACED_FRAMES
    tframes = {k: v[:tn] for k, v in frames.items()}
    (_, dev_ms, table, span_ms), launches, shapes = counted("graph traced", lambda: launch_profile(
        lambda: teng.run_sequence(teng.init(init["q0"], init["bg0"], init["gravity"]), tframes)))
    traced_counts(table)
    log(f"[graph] a graphed run of {tn} frames from a fresh engine, traced whole: launches "
        f"counted = device launches in the trace (" + ", ".join(
            f"{k} {v}" for k, v in launches.items()) + f"); {dev_ms:.3f} ms of device time in a "
        f"{span_ms:.3f} ms span (torch.profiler; the first frame eager, capture included)")
    out["traced"] = dict(launches=launches, shapes=shapes)
    del teng

    beng, bframes, nb = batch["eng"], batch["frames"], batch["n"]

    def eager4():
        carry, ps = beng.init_batch(batch["inits"]), []
        for k in range(nb):
            carry, o = beng.step_batch(carry, {key: v[:, k] for key, v in bframes.items()})
            ps.append(o.p)
        return torch.stack(ps, dim=1).cpu().numpy()

    t0 = time.perf_counter()
    p_e, launches, shapes = counted(f"graph eager B={BATCH}", eager4)
    eager_ms = (time.perf_counter() - t0) / nb * 1e3
    gaps = [float(np.abs(p_e[b] - batch["est"][b]).max()) for b in range(BATCH)]
    check_same(f"B={BATCH}", max(gaps), shapes, batch["shapes"])
    (g,) = beng.compiled.graphs.values()
    m = replay_metrics(g, {k: v[:, nb // 2] for k, v in bframes.items()})
    log(f"[graph] B={BATCH}, {nb} frames: graphed run_batch against the eager step_batch "
        f"loop: max position gap per member " + ", ".join(f"{x:.3g}" for x in gaps)
        + f" m (bound {GRAPH_BOUND_M} m); launches identical per call shape; a step "
        f"{eager_ms:.2f} ms eager, {batch['step_ms']:.2f} ms graphed ([batch]'s second pass)")
    log(f"[graph] B={BATCH}: {replay_line(m)}")
    out[f"B={BATCH}"] = dict(gaps=gaps, eager_ms=eager_ms, graphed_ms=batch["step_ms"],
                             launches=launches, shapes=shapes, **m)

    # entry(), the counterpart of __graft_entry__.py:entry(): two calls
    # (the first captures) on its random frame.
    from vio_msckf_torch.engine import entry

    fn, (carry, frame) = entry()
    for _ in range(2):
        carry, o = fn(carry, frame)
    pose = o.p.cpu().numpy()
    if pose.shape != (3,) or not np.isfinite(pose).all():
        raise AssertionError(f"entry(): pose {pose}")
    log(f"[graph] entry(): two calls of the captured step at euroc_config() on random "
        f"752x480 frames, pose finite {pose}")
    return out


def graph_eskf(cfg, dev, root):
    """The ESKF's eager step against EskfVio.run_sequence over the first
    ESKF_GRAPH_FRAMES frames of the CLI's tree."""
    import torch
    from vio_msckf_torch.data.euroc import EuRoCSequence, bundle_euroc_frames
    from vio_msckf_torch.eskf import EskfVio

    seq = EuRoCSequence(root, 0.0)
    imu, _, first, _ = bundle_euroc_frames(seq, cfg)
    n = ESKF_GRAPH_FRAMES
    frames = dict(
        cam0_img=torch.as_tensor(np.stack([seq.load_image(first + k, 0) for k in range(n)]),
                                 device=dev),
        cam1_img=torch.as_tensor(np.stack([seq.load_image(first + k, 1) for k in range(n)]),
                                 device=dev),
        **{key: torch.as_tensor(imu[key][:n], device=dev)
           for key in ("imu_gyro", "imu_acc", "imu_dt", "imu_valid")})
    vio = EskfVio(cfg, device=dev)
    acc0 = imu["imu_acc"][1][imu["imu_valid"][1]][0]

    def eager():
        carry, ps = vio.init(acc0), []
        for k in range(n):
            carry, o = vio.step(carry, {key: v[k] for key, v in frames.items()})
            ps.append(o["p"])
        return torch.stack(ps).cpu().numpy()

    def graphed():
        return vio.run_sequence(vio.init(acc0), frames)[1]["p"].cpu().numpy()

    t0 = time.perf_counter()
    p_e, _, shapes_e = counted("graph eskf eager", eager, kernels=("fast_nms",))
    eager_ms = (time.perf_counter() - t0) / n * 1e3
    t0 = time.perf_counter()
    p_g, launches, shapes_g = counted("graph eskf", graphed, kernels=("fast_nms",))
    first_s = time.perf_counter() - t0
    gap = float(np.abs(p_e - p_g).max())
    check_same("eskf", gap, shapes_e, shapes_g)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    graphed()
    graphed_ms = (time.perf_counter() - t0) / n * 1e3
    (g,) = vio.compiled.graphs.values()
    m = replay_metrics(g, {k: v[n // 2] for k, v in frames.items()})
    log(f"[graph] ESKF, {n} frames: EskfVio.run_sequence against the eager step loop: max "
        f"position gap {gap:.3g} m (bound {GRAPH_BOUND_M} m); fast_nms launches "
        f"{launches['fast_nms']} both ways; a step {eager_ms:.1f} ms eager, {graphed_ms:.2f} ms "
        f"graphed (first graphed pass, capture included, {first_s:.2f} s)")
    log(f"[graph] ESKF: {replay_line(m)}")
    return dict(gap=gap, eager_ms=eager_ms, graphed_ms=graphed_ms, launches=launches,
                shapes=shapes_e, graphed_shapes=shapes_g, **m)


def _shape_key(name, call):
    """The wrapper's by_shape key of a timed call."""
    if name == "fast_nms":
        return tuple(call["shape"]) + (call["threshold"],)
    if name == "lk_pyramid":
        return (call["B"], call["P"], call["n_first"])
    return (call["F"], call["m"], call["k"])


def main():
    card = phase_device()
    import torch
    from vio_msckf_torch.config import euroc_config

    dev = torch.device("cuda", 0)
    phase_build()
    cfg = euroc_config()
    frames, init, gt, n = phase_workload(cfg, dev)
    entries = [check_fast(cfg, frames, n, dev), check_lk(cfg, frames, dev), check_spd(cfg, dev)]
    single = phase_slice(cfg, frames, init, gt, n, dev)
    bench_run = phase_bench()
    batch = phase_batch(cfg, dev, single, bench_run["result"]["value"])
    suite, suite_launches = phase_suite(cfg, dev)
    par_launches = phase_parallel(cfg, dev, suite, dict(single, init=init), frames)
    with tempfile.TemporaryDirectory(prefix="vio_euroc_") as root:
        cli_res = phase_cli(cfg, dev, root)
        eskf = phase_eskf(cfg, dev, root, entries[0])
        t0 = time.perf_counter()
        graphs = graph_engine(single, batch, frames, init, n)
        graphs["eskf"] = graph_eskf(cfg, dev, root)
        log(f"[graph] phase took {time.perf_counter() - t0:.1f} s")
    paths = {"slice": (single["launches"], single["shapes"]),
             "bench": (bench_run["launches"], bench_run["shapes"]),
             "batch": (batch["launches"], batch["shapes"]), **suite_launches, **par_launches,
             **{p: (r["launches"], r["shapes"]) for p, r in cli_res["runs"].items()},
             "eskf": (eskf["launches"], eskf["shapes"]),
             **{f"graph eager {k}": ({c: sum(v.values()) for c, v in g["shapes"].items()},
                                     g["shapes"]) for k, g in graphs.items() if k != "traced"},
             "graph traced": (graphs["traced"]["launches"], graphs["traced"]["shapes"]),
             "graph eskf": (graphs["eskf"]["launches"], graphs["eskf"]["graphed_shapes"])}
    for e in entries:
        name = e["name"]
        # The sweep's shapes (call_shapes) are the ones the engine launches.
        for p, B in (("slice", 1), ("bench", 1), ("batch", BATCH)):
            if set(paths[p][1][name]) != call_shapes(cfg, B)[name]:
                raise AssertionError(f"{name}: the {p} path launched {sorted(paths[p][1][name])}, "
                                     f"call_shapes(cfg, {B}) gives "
                                     f"{sorted(call_shapes(cfg, B)[name])}")
        e["launches"] = bench_run["launches"][name]
        e["launches_per_frame"] = single["launches"][name] / n
        e["launches_by_path"] = {p: l[name] for p, (l, _) in paths.items()}
        e["launches_by_shape"] = {p: {str(list(k)): v for k, v in s[name].items()}
                                  for p, (_, s) in paths.items()}
        for c in e["calls"]:
            c["launches"] = paths[c["path"]][1][name].get(_shape_key(name, c), 0)
            if c["launches"] <= 0:
                raise AssertionError(f"{name} call shape {_shape_key(name, c)} was not "
                                     f"launched on the {c['path']} path")
        # Every shape a path launched was held against the twin in phase 4,
        # and so is every shape the four-card run may launch.
        checked = ({_shape_key(name, c) for c in e["calls"]}
                   | {tuple(c["key"]) for c in e["sweep_calls"]})
        if not four_card_shapes(cfg)[name] <= checked:
            raise AssertionError(f"{name}: four-card shapes "
                                 f"{sorted(four_card_shapes(cfg)[name] - checked)} unchecked")
        for p, (_, s) in paths.items():
            unchecked = sorted(set(s[name]) - checked)
            if unchecked:
                raise AssertionError(f"{name}: the {p} path launched call shapes "
                                     f"{unchecked} that no check held against the twin")
    print(json.dumps({"kernels": entries}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def main_four_cards():
    """`python3 chip_smoke.py --four-cards`: [parallel] (c) alone, on a
    machine with four cards (the one-card run holds every call shape it
    may launch against the twin: four_card_shapes)."""
    card = phase_device()
    import torch
    from vio_msckf_torch.config import euroc_config

    if torch.cuda.device_count() < 4:
        raise RuntimeError(f"--four-cards needs 4 cards, this machine has "
                           f"{torch.cuda.device_count()}")
    phase_build()
    cfg = euroc_config()
    names, _, gts, n, _, outs, _, _, _ = suite_pair(cfg, torch.device("cuda", 0))
    shapes = {k: {} for k in KERNELS}
    phase_four_cards(cfg, dict(names=names, est=outs.p.cpu().numpy(), gts=gts, n=n), shapes)
    want = four_card_shapes(cfg)
    for k in KERNELS:
        if not set(shapes[k]) <= want[k] or not shapes[k]:
            raise AssertionError(f"{k}: four cards launched {sorted(shapes[k])}, expected a "
                                 f"subset of {sorted(want[k])}")
    log("[parallel] (c) launches: " + "; ".join(
        f"{k} " + ", ".join(f"{list(s_)} x{v}" for s_, v in sorted(shapes[k].items()))
        for k in KERNELS))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:] == ["--four-cards"]:
        main_four_cards()
    elif sys.argv[1:]:
        raise SystemExit(f"usage: python3 chip_smoke.py [--four-cards]; got {sys.argv[1:]}")
    else:
        main()
