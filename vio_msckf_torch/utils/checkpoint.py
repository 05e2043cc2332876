"""Filter-state checkpoint and resume. The port's counterpart of
vio_msckf_tpu/utils/checkpoint.py.

The engine carry is a tuple of tensor records (TrackerState, FilterState,
FeatureMap) of fixed shapes, so a checkpoint is the list of its tensors in
field order, a step counter and a dict of extras, written with torch.save;
resume restores them into a template carry of the same structure and
continues exactly from the saved frame.
"""

import dataclasses
import os

import torch


def _leaves(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            yield from _leaves(getattr(obj, f.name))
    elif isinstance(obj, (tuple, list)):
        for x in obj:
            yield from _leaves(x)
    elif isinstance(obj, dict):
        for x in obj.values():
            yield from _leaves(x)


def _rebuild(like, leaves):
    if isinstance(like, torch.Tensor):
        return next(leaves)
    if dataclasses.is_dataclass(like):
        return dataclasses.replace(like, **{
            f.name: _rebuild(getattr(like, f.name), leaves) for f in dataclasses.fields(like)})
    if isinstance(like, (tuple, list)):
        return type(like)(_rebuild(x, leaves) for x in like)
    if isinstance(like, dict):
        return {k: _rebuild(v, leaves) for k, v in like.items()}
    return like


def save_checkpoint(path, carry, step=0, extra=None):
    """Write the carry's tensors, the step counter and `extra` (a dict of
    plain values) to one file; the file is replaced only once complete."""
    data = dict(leaves=[t.detach().cpu() for t in _leaves(carry)], step=int(step),
                extra=dict(extra or {}))
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(data, tmp)
    os.replace(tmp, path)


def load_checkpoint(path, like):
    """Restore a carry saved by save_checkpoint into the structure of
    `like` (e.g. engine.init()), on the devices of like's tensors.

    Raises ValueError when the number, a shape or a dtype of the saved
    tensors differs from the template's. Returns (carry, step, extra)."""
    data = torch.load(path, map_location="cpu", weights_only=True)
    saved, tmpl = data["leaves"], list(_leaves(like))
    if len(saved) != len(tmpl):
        raise ValueError(f"checkpoint has {len(saved)} tensors, template has {len(tmpl)}")
    out = []
    for i, (a, t) in enumerate(zip(saved, tmpl)):
        if a.shape != t.shape or a.dtype != t.dtype:
            raise ValueError(f"tensor {i}: saved {a.dtype} {tuple(a.shape)} != template "
                             f"{t.dtype} {tuple(t.shape)}")
        out.append(a.to(t.device))
    return _rebuild(like, iter(out)), data["step"], data["extra"]
