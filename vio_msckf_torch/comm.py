"""Collectives of the feature-block sharded filter over a process group.

The JAX package shards the feature axis over a mesh axis under
`shard_map` and reduces with `all_gather` and `ppermute`
(vio_msckf_tpu/filter/update.py, triangulation.py). Here one rank is one
process, the block axis is a `torch.distributed` process group, and
these two helpers are its collectives. Every rank of a group must call
them in the same order: the callers make them unconditionally, never
behind a branch on data.

Gloo has no all-gather or send/receive for CUDA tensors, so with a gloo
group a CUDA tensor is staged through host memory and back; each staged
copy (to the host or back) adds one to `STAGED`. NCCL takes CUDA tensors
as they are and stages nothing.
"""

import collections

import torch
import torch.distributed as dist

STAGED = collections.Counter()   # "to_host", "to_device": copies made for gloo


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


def all_gather(x, group, dim):
    """Every rank's x, concatenated along `dim` in group rank order."""
    w, staged = _stage(x, group)
    parts = [torch.empty_like(w) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, w, group=group)
    return _unstage(torch.cat(parts, dim=dim), x, staged)


def exchange(x, group, peer):
    """Send x to the group's rank `peer` and receive its tensor of the same
    shape: one paired isend/irecv (batched, so that NCCL does not block
    two ranks that both send first)."""
    w, staged = _stage(x, group)
    got = torch.empty_like(w)
    to = dist.get_global_rank(group, peer)
    for req in dist.batch_isend_irecv([dist.P2POp(dist.isend, w, to, group),
                                       dist.P2POp(dist.irecv, got, to, group)]):
        req.wait()
    return _unstage(got, x, staged)
