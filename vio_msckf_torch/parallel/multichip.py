"""Scale-out: sequence replicas x feature-block sharding over ranks.

The port's counterpart of vio_msckf_tpu/parallel/multichip.py. There a
`jax.sharding.Mesh` of devices with axes ("replica", "block") carries a
`shard_map`; here one rank is one process driving one device, and the
mesh is a grid of global `torch.distributed` ranks:

  * replica (rows of the grid): data parallelism over sequences. Each
    replica owns contiguous rows of the batch axis B (what P("replica")
    gives) and advances them alone; no collective crosses this axis.
  * block (columns): feature-block parallelism inside each filter. The
    ranks of one row form a block process group; each solves its slice of
    the feature lanes (triangulation, Jacobians, the chi-square gate) and
    the update is reduced with a butterfly TSQR over the group
    (filter/update.py:tsqr_reduce_update). Every rank of a row steps the
    same sequences; the front-end runs replicated on each of them, as
    under `shard_map`.

`torch.distributed` must be initialized first (distributed.py:
initialize_from_env). Every rank calls `make_mesh`, which creates every
block group in the same order, as `dist.new_group` requires.
"""

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from vio_msckf_torch.config import CameraConfig, _t, euroc_config
from vio_msckf_torch.engine import VIOEngine
from vio_msckf_torch.filter.msckf import MSCKF


@dataclasses.dataclass
class Mesh:
    """A (replica, block) grid of global ranks and this rank's place in it."""

    grid: np.ndarray        # (n_replica, n_block) global ranks
    groups: list            # the block process group of each replica row
    rank: int               # this process's global rank

    @property
    def n_replica(self):
        return self.grid.shape[0]

    def _where(self):
        at = np.argwhere(self.grid == self.rank)
        if not len(at):
            raise ValueError(f"rank {self.rank} is not in the mesh {self.grid.tolist()}")
        return at[0]

    @property
    def replica(self):
        """This rank's replica (grid row)."""
        return int(self._where()[0])

    @property
    def block(self):
        """This rank's block index within its replica (grid column)."""
        return int(self._where()[1])

    @property
    def block_group(self):
        return self.groups[self.replica]


def make_mesh(n_replica, n_block=1, ranks=None):
    """Mesh over the first n_replica * n_block global ranks (or `ranks`, in
    that order), row by row: a replica's block peers are consecutive."""
    world = dist.get_world_size()
    ranks = np.arange(world) if ranks is None else np.asarray(ranks)
    if ranks.size < n_replica * n_block:
        raise ValueError(f"need {n_replica * n_block} ranks, have {ranks.size}")
    grid = ranks[: n_replica * n_block].reshape(n_replica, n_block)
    groups = [dist.new_group([int(r) for r in row]) for row in grid]
    return Mesh(grid=grid, groups=groups, rank=dist.get_rank())


def map_batch(fn, tree):
    """fn over every tensor or array of a batch: dicts, tuples, lists and
    dataclass records (the engine's carries) are walked."""
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_batch(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_batch(fn, v) for v in tree)
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: map_batch(fn, getattr(tree, f.name)) for f in dataclasses.fields(tree)})
    return tree


def replica_rows(mesh, n_rows):
    """The contiguous rows of a batch of n_rows that this rank's replica
    owns."""
    if n_rows % mesh.n_replica:
        raise ValueError(f"{n_rows} rows do not split over {mesh.n_replica} replicas")
    per = n_rows // mesh.n_replica
    return slice(mesh.replica * per, (mesh.replica + 1) * per)


def shard_batch(mesh, tree):
    """This replica's rows of a batched tree (leading axis = sequence),
    the same on every block rank of the replica."""
    def take(x):
        return x[replica_rows(mesh, x.shape[0])]

    return map_batch(take, tree)


def make_multichip_filter_step(config, mesh, use_block=True, device="cuda"):
    """Filter-only step over this replica's rows (feature measurements in,
    poses out), the update sharded over the replica's block group. Returns
    (step, MSCKF); step(carry, frame) -> (carry, out), every tensor with
    this replica's rows first. Like `jax.jit(shard_map(...))`, step
    replays the step's CUDA graph, its collectives inside (captured at the
    first call; eager over a gloo group, graph.py); every rank of the
    group must call it together. The eager step is `kf.step`."""
    kf = MSCKF(config, device, block_group=mesh.block_group if use_block else None)
    return lambda carry, frame: kf.compiled(carry, frame, axis=1), kf


def make_multichip_engine_step(config, mesh, use_block=True, device="cuda"):
    """Full-engine step (stereo images + IMU in, poses out) over this
    replica's rows; the tracker runs replicated on every block rank.
    Returns (step, VIOEngine); step replays the captured engine step as
    the filter's does, the eager step is `eng.step_batch`."""
    eng = VIOEngine(config, device, block_group=mesh.block_group if use_block else None)
    return lambda carry, frame: eng.compiled(carry, frame, axis=1), eng


def tiny_config():
    """A miniature config for multi-rank dry runs and tests: small images,
    a short window, few features; the same code paths at tiny shapes
    (vio_msckf_tpu/parallel/multichip.py:tiny_config)."""
    cam = dict(
        intrinsics=(80.0, 80.0, 48.0, 32.0),
        distortion_model="radtan",
        distortion_coeffs=(-0.05, 0.01, 0.0, 0.0),
        resolution=(96, 64),
    )
    T1 = np.eye(4)
    T1[0, 3] = -0.11
    cfg = euroc_config(
        cam0=CameraConfig(T_imu_cam=_t(np.eye(4)), **cam),
        cam1=CameraConfig(T_imu_cam=_t(T1), **cam),
        T_cn_cnm1=_t(T1),
    )
    return cfg.replace(
        filter=cfg.filter.__class__(
            max_cam_state_size=6,
            max_features=32,
            imu_per_frame=16,  # >= 10 real samples/frame at 200/20 Hz
        ),
        frontend=cfg.frontend.__class__(
            grid_row=2, grid_col=2, max_tracks=16,
            lk_pyramid_levels=2,
        ),
    )
