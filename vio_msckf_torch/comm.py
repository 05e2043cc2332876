"""Collectives of the feature-block sharded filter over a process group.

The JAX package shards the feature axis over a mesh axis under
`shard_map` and reduces with `all_gather` and `ppermute`
(vio_msckf_tpu/filter/update.py, triangulation.py). Here one rank is one
process, the block axis is a `torch.distributed` process group, and
these two helpers are its collectives. Every rank of a group must call
them in the same order: the callers make them unconditionally, never
behind a branch on data.

Both helpers are one `all_gather_into_tensor` into an output allocated
in the step: under NCCL (one rank per card) one NCCL kernel and one
buffer, which a CUDA graph captures (graph.py). `exchange`, the
butterfly's paired swap, takes the partner's slice of that all-gather,
so the TSQR's Householder order and the bit-identical block peers are
unchanged, and no per-pair communicator has to exist before a capture.
The cost: each rank receives every other block rank's tensor, nb - 1
times the partner's bytes (the same bytes as a send/receive pair at a
block of 2, three times them at 4). The form was chosen for its one
collective kind, not forced by the card (send/receive under capture was
never tried); it is the same eager and captured, under NCCL and gloo.

Gloo has no collectives for CUDA tensors, so with a gloo group a CUDA
tensor is staged through host memory and back; each staged copy (to the
host or back) adds one to `STAGED`. Such a step synchronises the host and
is never captured (`capturable`).
"""

import collections

import torch
import torch.distributed as dist

STAGED = collections.Counter()   # "to_host", "to_device": copies made for gloo


def capturable(group):
    """Whether a step whose collectives run over `group` can be captured
    as a CUDA graph: without a group, and over NCCL. Gloo stages through
    the host (eager); any other backend raises."""
    if group is None:
        return True
    backend = dist.get_backend(group)
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"no rule for collectives over a {backend} group")
    return backend == "nccl"


def lanes(group, n):
    """The lanes [bi n/nb, (bi + 1) n/nb) of an axis of n that block bi of
    nb solves; all n without a group."""
    if group is None:
        return slice(0, n)
    nb, bi = dist.get_world_size(group), dist.get_rank(group)
    if n % nb:
        raise ValueError(f"{n} lanes do not split over {nb} blocks")
    return slice(bi * (n // nb), (bi + 1) * (n // nb))


def _stage(x, group):
    """(tensor to hand to the backend, whether it was staged)."""
    staged = x.is_cuda and dist.get_backend(group) == "gloo"
    if staged:
        STAGED["to_host"] += 1
        return x.cpu(), True
    return x.contiguous(), False


def _unstage(y, like, staged):
    if staged:
        STAGED["to_device"] += 1
        return y.to(like.device)
    return y


def _stacked(x, group):
    """Every rank's x stacked in group rank order, (nb, *x.shape): one
    all_gather_into_tensor into an output made here."""
    w, staged = _stage(x, group)
    nb = dist.get_world_size(group)
    out = w.new_empty((nb * w.shape[0],) + tuple(w.shape[1:]))
    dist.all_gather_into_tensor(out, w, group=group)
    return _unstage(out.view((nb,) + tuple(w.shape)), x, staged)


def all_gather(x, group, dim):
    """Every rank's x, concatenated along `dim` in group rank order."""
    return _stacked(x, group).movedim(0, dim).flatten(dim, dim + 1)


def exchange(x, group, peer):
    """x of the group's rank `peer`, for a rank that sends it its own: the
    butterfly's paired swap, as the peer's slice of an all-gather (module
    docstring)."""
    return _stacked(x, group)[peer]
