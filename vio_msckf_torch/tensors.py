"""Small helpers for dataclasses of tensors and fixed-shape scatters."""

import dataclasses

import torch


class TensorRecord:
    """`.to(device)` and `.replace(**fields)` for a dataclass of tensors."""

    def to(self, device):
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)
        })

    def replace(self, **fields):
        return dataclasses.replace(self, **fields)


def select(pred, a, b):
    """Field-wise torch.where(pred, a, b) over two records of one type: the
    compute-and-select form of a branch, with no host synchronisation."""
    return dataclasses.replace(a, **{
        f.name: torch.where(pred, getattr(a, f.name), getattr(b, f.name))
        for f in dataclasses.fields(a)
        if isinstance(getattr(a, f.name), torch.Tensor)
    })


def drop_scatter(x, idx, values, col=None):
    """x[idx] = values (or x[idx, col] = values) on a copy of x, where
    idx == len(x) means "drop" (XLA's scatter mode="drop"): the write goes
    to one spare row that is cut off. A Python value is broadcast on the
    device; writing it from the host would synchronise."""
    spare = torch.cat([x, x[:1]], dim=0)
    if not isinstance(values, torch.Tensor):
        values = torch.full((), values, dtype=x.dtype, device=x.device)
    spare.index_put_((idx,) if col is None else (idx, col), values)
    return spare[:-1]
