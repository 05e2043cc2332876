"""Multi-rank dry run: one full engine step at EuRoC shapes over a
(replica, block) mesh.

    python -c "from vio_msckf_torch.parallel.dryrun import dryrun_multichip; \
               dryrun_multichip(4, backend='gloo')"

The port's counterpart of __graft_entry__.py:dryrun_multichip. There one
process compiles and runs the step over n devices; here one rank is one
process, so `dryrun_multichip(n)` called outside a process group starts n
rank processes of this module (which call it again inside their group)
and waits for them. Under NCCL (one rank per card) each rank captures the
sharded step as a CUDA graph with its collectives, the counterpart of the
compile, and replays it, the execute; under gloo it steps eagerly twice.

    python -c "from vio_msckf_torch.parallel.dryrun import dryrun_multichip; \
               dryrun_multichip(4, backend='nccl')"     # four cards
"""

import argparse
import json
import sys

import numpy as np
import torch
import torch.distributed as dist

from vio_msckf_torch import kernels
from vio_msckf_torch.config import euroc_config
from vio_msckf_torch.parallel.distributed import Ranks, in_group, make_global_batch, start_rank
from vio_msckf_torch.parallel.multichip import make_mesh, make_multichip_engine_step


def _rank_step(n_devices, device):
    """This rank's part: block = 2 where n is even, B = 2 sequences per
    replica on random images, two calls of the replaying step (the first
    runs the eager warm-up and captures, the second replays the graph
    from the same carry); every pose of the second must be finite."""
    n_block = 2 if n_devices % 2 == 0 else 1
    n_replica = n_devices // n_block
    mesh = make_mesh(n_replica, n_block)
    cfg = euroc_config()
    step, eng = make_multichip_engine_step(cfg, mesh, use_block=n_block > 1, device=device)
    B = 2 * n_replica
    rng = np.random.default_rng(0)
    W, H = cfg.cam0.resolution
    M = cfg.filter.imu_per_frame
    frame = make_global_batch(mesh, dict(
        cam0_img=rng.uniform(0, 255, (B, H, W)).astype(np.float32),
        cam1_img=rng.uniform(0, 255, (B, H, W)).astype(np.float32),
        imu_gyro=np.zeros((B, M, 3), np.float32),
        imu_acc=np.tile(np.asarray([0.0, 0.0, 9.81], np.float32), (B, M, 1)),
        imu_dt=np.full((B, M), 0.005, np.float32),
        imu_valid=np.ones((B, M), bool),
    ), device)
    carry = eng.init_batch([{}] * (B // n_replica))
    step(carry, frame)
    _, out = step(carry, frame)
    if not np.isfinite(out.p.cpu().numpy()).all():
        raise AssertionError(f"rank {mesh.rank}: a pose is not finite")
    captured = bool(eng.compiled.graphs)
    eng.compiled.clear()            # before the group's shutdown, which waits for it
    return dict(n_replica=n_replica, n_block=n_block, batch=B, backend=dist.get_backend(),
                captured=captured)


def dryrun_multichip(n_devices, device="cuda", backend=None, timeout=900):
    """One engine step over an n_devices mesh of ranks (sequence replicas
    x feature blocks, the update TSQR-reduced over each block group) at
    full EuRoC shapes (752x480 stereo, 20-clone window, 160 features).

    Inside a process group of n_devices ranks this is the rank's part.
    Outside one it starts n_devices ranks on `device` (for a device
    "cuda", rank r on card r % cards: one rank per card under "nccl",
    the default there; `backend` "gloo" lets ranks share a card) and
    returns {kernel: {call shape: launches}} summed over the ranks (empty
    on the CPU)."""
    if dist.is_initialized():
        if dist.get_world_size() != n_devices:
            raise ValueError(f"need {n_devices} ranks, the group has {dist.get_world_size()}")
        return _rank_step(n_devices, device)
    if torch.device(device).type == "cuda":
        kernels.build()                 # once, before the ranks load it
    outs = Ranks(__name__, n_devices, ["--device", device, "--backend", backend or ""]
                 ).wait(timeout)
    total = {}
    for out in outs:
        report = json.loads(out.strip().splitlines()[-1])
        for name, shapes in report["launches"].items():
            for shape, n in shapes:
                total.setdefault(name, {}).setdefault(tuple(shape), 0)
                total[name][tuple(shape)] += n
    info = json.loads(outs[0].strip().splitlines()[-1])
    print(f"dryrun_multichip ok: mesh replica={info['n_replica']} block={info['n_block']}, "
          f"batch={info['batch']}, {info['backend']}, "
          f"{'captured and replayed' if info['captured'] else 'eager'}, pose finite", flush=True)
    return total


def main(argv=None):
    ap = argparse.ArgumentParser(description="One rank of dryrun_multichip.")
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--nprocs", type=int, required=True)
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default="")
    args = ap.parse_args(argv)
    device = start_rank(args.rank, args.nprocs, args.coordinator, args.device,
                        args.backend or None)
    with in_group():
        for fn in kernels.counters().values():
            fn.by_shape.clear()
        info = dryrun_multichip(args.nprocs, device)
    info["launches"] = kernels.launch_counts()
    print(json.dumps(info), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
