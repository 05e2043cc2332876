"""Multi-process execution: the torch.distributed bootstrap, meshes over
every rank, host-local feeding, and the launcher of rank processes.

The port's counterpart of vio_msckf_tpu/parallel/distributed.py. There
one JAX process per host joins `jax.distributed` and a global mesh spans
every process's chips; here every rank is one process driving one device,
so the global mesh is a grid of all ranks (multichip.py) and each process
materializes only the batch rows its replica owns.

Environment protocol (a single-process no-op when unset), as the
reference's:
  VIO_NUM_PROCESSES   total process count
  VIO_PROCESS_ID      this process's rank (0-based)
  VIO_COORDINATOR     host:port of rank 0 (default localhost:12411)

The backend is the caller's: NCCL takes CUDA tensors as they are but will
not put two ranks on one GPU; gloo runs ranks on the CPU, or several ranks
on one GPU, its collectives staged through host memory (comm.py). A step
sharded over NCCL is captured as a CUDA graph, one over gloo steps eagerly
(graph.py); NCCL makes its communicators at their first collective, which
the captured step's eager warm-up frame issues.
"""

import contextlib
import faulthandler
import os
import signal
import socket
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from vio_msckf_torch.parallel.multichip import make_mesh, map_batch, replica_rows, shard_batch

_ROOT = Path(__file__).resolve().parents[2]


def initialize_from_env(backend=None, device="cuda"):
    """Join the process group the VIO_* variables describe, over tcp://.

    backend None picks "nccl" for a CUDA `device` and "gloo" for the CPU.
    Returns True if a multi-process group was initialized, False (doing
    nothing) for a process count of 1 or less."""
    n = int(os.environ.get("VIO_NUM_PROCESSES", "1"))
    if n <= 1:
        return False
    _join(backend, device, "tcp://" + os.environ.get("VIO_COORDINATOR", "localhost:12411"),
          n, int(os.environ["VIO_PROCESS_ID"]))
    return True


def _join(backend, device, init_method, world_size, rank):
    """init_process_group; backend None picks "nccl" for a CUDA `device`
    and "gloo" for the CPU."""
    if backend is None:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                            rank=rank)


def start_rank(rank, nprocs, coordinator, device="cuda", backend=None):
    """A rank process's bootstrap: the VIO_* variables from its arguments,
    its device (a CUDA device without an index: card rank % cards, so
    one rank per card where there are as many cards as ranks; one
    intra-op thread on the CPU, where ranks share the cores), then
    `initialize_from_env`. A run of one rank (the first row of a scaling
    table) joins a group of one, which `initialize_from_env` leaves alone.
    Returns the device."""
    if nprocs < 1:
        raise SystemExit(f"a rank process needs 1 or more ranks, got {nprocs}")
    faulthandler.register(signal.SIGUSR1, all_threads=True)   # Ranks.wait's stack dump
    os.environ.update(VIO_NUM_PROCESSES=str(nprocs), VIO_PROCESS_ID=str(rank),
                      VIO_COORDINATOR=coordinator)
    device = torch.device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    else:
        torch.set_num_threads(1)
    if not initialize_from_env(backend, device):
        _join(backend, device, "tcp://" + coordinator, 1, 0)
    return device


@contextlib.contextmanager
def in_group():
    """A rank's work inside its process group, which is shut down after
    it. The work must free the CUDA graphs that hold NCCL collectives
    first (CompiledStep.clear, or drop the model): NCCL's shutdown waits
    for them. On an exception the rank prints the traceback and leaves at
    once (os._exit): a shutdown would wait for peers that wait in a
    collective for this rank, and Ranks.wait stops them."""
    try:
        yield
    except BaseException:
        traceback.print_exc()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)
    dist.destroy_process_group()


def make_global_mesh(n_replica=None, n_block=1, block_across_processes=False):
    """(replica, block) mesh over all ranks.

    The default layout makes a replica's block peers consecutive ranks.
    With `block_across_processes` the grid is laid out block-major, as the
    reference lays devices out so that the block axis pairs devices of
    different processes: rank r's block peers are r +- n_replica. Here
    every rank is a process of its own, so the flag chooses which ranks
    pair up (with ranks numbered host by host, which hosts the TSQR
    exchange crosses)."""
    world = dist.get_world_size()
    if n_replica is None:
        n_replica = world // n_block
    ranks = np.arange(n_replica * n_block)
    if block_across_processes:
        ranks = ranks.reshape(n_block, n_replica).T.reshape(-1)
    return make_mesh(n_replica, n_block, ranks)


def local_rows(mesh, n_rows):
    """The leading-axis indices this rank owns (its replica's rows): what
    a host-local data loader should materialize."""
    return list(range(n_rows))[replica_rows(mesh, n_rows)]


def make_global_batch(mesh, tree_np, device="cuda"):
    """This rank's rows of a batched tree of numpy arrays, as tensors on
    `device`. Leaves may be full arrays or valid only at `local_rows`."""
    return map_batch(lambda x: torch.as_tensor(np.asarray(x), device=device),
                     shard_batch(mesh, tree_np))


def collect_local_outputs(mesh, x, n_rows):
    """(global row index, numpy value) pairs of this rank's rows of a
    step's output x (this replica's rows of a batch of n_rows)."""
    start = replica_rows(mesh, n_rows).start
    data = x.detach().cpu().numpy()
    return [(start + i, data[i]) for i in range(data.shape[0])]


def free_port():
    """A TCP port on localhost that was free a moment ago."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class Ranks:
    """`python -m module --rank r --nprocs n --coordinator localhost:<free
    port> *args`, one process for every rank r, started together; their
    output goes to temporary files. They run from the checkout's root."""

    def __init__(self, module, nprocs, args=()):
        coordinator = f"localhost:{free_port()}"
        self.logs = [(tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+"))
                     for _ in range(nprocs)]
        self.procs = [subprocess.Popen(
            [sys.executable, "-m", module, "--rank", str(r), "--nprocs", str(nprocs),
             "--coordinator", coordinator, *map(str, args)],
            cwd=_ROOT, stdout=out, stderr=err, text=True)
            for r, (out, err) in enumerate(self.logs)]

    def _read(self, r):
        texts = []
        for f in self.logs[r]:
            f.seek(0)
            texts.append(f.read())
        return texts

    def wait(self, timeout):
        """Wait for every rank; returns their standard outputs. When a rank
        fails, or at the timeout, kills the others (a rank whose peer died
        waits in a collective) and raises with the failed rank's output;
        at the timeout, with every rank's, after each rank still running
        has printed its threads' stacks (SIGUSR1, start_rank)."""
        deadline = time.monotonic() + timeout
        try:
            while True:
                codes = [p.poll() for p in self.procs]
                bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
                if bad:
                    out, err = self._read(bad[0])
                    raise RuntimeError(f"rank {bad[0]} exited {codes[bad[0]]}:\n"
                                       f"{out[-2000:]}\n{err[-4000:]}")
                if all(c == 0 for c in codes):
                    return [self._read(r)[0] for r in range(len(self.procs))]
                if time.monotonic() > deadline:
                    for p in self.procs:
                        if p.poll() is None:
                            p.send_signal(signal.SIGUSR1)
                    time.sleep(2.0)
                    raise RuntimeError(f"ranks still running after {timeout} s:\n" + "\n".join(
                        f"rank {r}: " + "\n".join(t[-3000:] for t in self._read(r))
                        for r in range(len(self.procs))))
                time.sleep(0.05)
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for f in (f for pair in self.logs for f in pair):
                f.close()
