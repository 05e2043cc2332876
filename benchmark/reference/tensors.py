"""Small helpers for dataclasses of tensors and fixed-shape scatters.

Every module under filter/, frontend/ and ops/ takes its state and frames
with a leading batch axis B (B independent sequences in the same
launches); `unsqueeze_record` / `index_record` move between one sequence's
record and a batch of them.
"""

import dataclasses

import torch


class TensorRecord:
    """`.to(device)` and `.replace(**fields)` for a dataclass of tensors
    (a field may also be a list of tensors, e.g. a pyramid)."""

    def to(self, device):
        return tree_map(lambda t: t.to(device), self)

    def replace(self, **fields):
        return dataclasses.replace(self, **fields)


def tree_map(fn, tree):
    """fn applied to every tensor of a tree of dataclasses, dicts, tuples
    and lists (the port's records, carries, frames and outputs); any other
    value is kept as it is."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: tree_map(fn, getattr(tree, f.name)) for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return tree


def tree_leaves(tree):
    """The tensors of a tree, in the order tree_map visits them."""
    leaves = []
    tree_map(leaves.append, tree)
    return leaves


def unsqueeze_record(rec):
    """One sequence's record as a batch of one (views, no copy)."""
    return tree_map(lambda t: t[None], rec)


def index_record(rec, b):
    """Sequence b of a batched record (views, no copy)."""
    return tree_map(lambda t: t[b], rec)


def _lead(pred, x):
    """pred (B,) shaped to broadcast against x (B, ...)."""
    return pred.reshape(pred.shape + (1,) * (x.dim() - pred.dim()))


def select(pred, a, b):
    """Field-wise torch.where(pred, a, b) over two batched records of one
    type, pred (B,) one decision per sequence: the compute-and-select form
    of a branch, with no host synchronisation."""
    return dataclasses.replace(a, **{
        f.name: torch.where(_lead(pred, getattr(a, f.name)), getattr(a, f.name),
                            getattr(b, f.name))
        for f in dataclasses.fields(a)
        if isinstance(getattr(a, f.name), torch.Tensor)
    })


def _batch_index(x, idx):
    """arange(B) shaped (B, 1, ..., 1) to index axis 0 of x alongside an
    index tensor idx of shape (B, ...)."""
    B = x.shape[0]
    return torch.arange(B, device=x.device).reshape((B,) + (1,) * (idx.dim() - 1))


def gather_rows(x, idx):
    """x[b, idx[b]] per sequence: x (B, N, ...), idx (B, ...) int64 ->
    idx.shape + x.shape[2:]. A device gather, no host round trip."""
    return x[_batch_index(x, idx), idx]


def drop_scatter(x, idx, values, col=None):
    """Per sequence b: x[b, idx[b]] = values[b] (or x[b, idx[b], col[b]])
    on a copy of x (B, T, ...), where idx == T means "drop" (XLA's scatter
    mode="drop"): the write goes to one spare row per sequence that is cut
    off. A Python value is broadcast on the device; writing it from the
    host would synchronise."""
    spare = torch.cat([x, x[:, :1]], dim=1)
    if not isinstance(values, torch.Tensor):
        values = torch.full((), values, dtype=x.dtype, device=x.device)
    bi = _batch_index(x, idx)
    spare.index_put_((bi, idx) if col is None else (bi, idx, col), values)
    return spare[:, :-1]
