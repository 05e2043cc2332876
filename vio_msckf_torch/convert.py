"""State conversion between the JAX package's pytrees and the port.

`from_numpy_tree` takes a FilterState, FeatureMap or TrackerState of the
JAX package whose leaves have been converted to numpy arrays
(`jax.tree_util.tree_map(np.asarray, state)`), or a tuple of them such as
the engine carry, and builds the port's dataclasses. `to_numpy_tree` is the
inverse, returning dicts of numpy arrays (the tests compare those). The
JAX tracker keeps its pyramid in a lane-row layout (an edge-padded
(Hp * nb, 128) array per level); it is cut back to the (H, W) level here.
Nothing in this module imports jax.
"""

import dataclasses

import numpy as np
import torch

from vio_msckf_torch.filter.state import FeatureMap, FilterState
from vio_msckf_torch.frontend.tracker import TrackerState

_PAD = 16  # the JAX pyramid's edge padding
_INT_FIELDS = {"fid", "ids", "lifetime", "next_id", "n_clones"}


def _tensor(a, name, device):
    a = np.asarray(a)
    if name in _INT_FIELDS:
        return torch.as_tensor(a.astype(np.int64), device=device)
    if a.dtype == np.bool_:
        return torch.as_tensor(a.copy(), device=device)
    return torch.as_tensor(a.astype(np.float32), device=device)


def _plain_pyramid(pyr, level_shapes, device):
    """Lane-row levels (or plain (H, W) levels) -> list of (H, W) tensors."""
    flats = getattr(pyr, "flats", pyr)
    out = []
    for flat, (H, W) in zip(flats, level_shapes):
        flat = np.asarray(flat, np.float32)
        if flat.shape != (H, W):
            Hp = H + 2 * _PAD
            flat = flat.reshape(Hp, -1)[_PAD:_PAD + H, _PAD:_PAD + W]
        out.append(torch.as_tensor(np.ascontiguousarray(flat), device=device))
    return out


def from_numpy_tree(tree, device="cpu", level_shapes=None):
    """Build the port's state from a numpy-leaved JAX state (see module
    docstring). `level_shapes` gives the (H, W) of each pyramid level and
    is needed for a TrackerState whose pyramid is in lane-row layout."""
    if isinstance(tree, (tuple, list)):
        return type(tree)(from_numpy_tree(t, device, level_shapes) for t in tree)
    if hasattr(tree, "pyr_prev"):
        cls = TrackerState
    elif hasattr(tree, "P"):
        cls = FilterState
    elif hasattr(tree, "obs"):
        cls = FeatureMap
    else:
        raise TypeError(f"not a filter, feature-map or tracker state: {type(tree)}")
    kw = {}
    for f in dataclasses.fields(cls):
        if f.name == "pyr_prev":
            if level_shapes is None:
                meta = getattr(tree.pyr_prev, "metas", None)
                if meta is None:
                    raise ValueError("level_shapes is required for this pyramid")
                level_shapes = [(H, W) for H, W, _ in meta]
            kw[f.name] = _plain_pyramid(tree.pyr_prev, level_shapes, device)
        else:
            kw[f.name] = _tensor(getattr(tree, f.name), f.name, device)
    return cls(**kw)


def to_numpy_tree(obj):
    """The port's state (or a tuple of states) -> dict(s) of numpy arrays;
    a pyramid becomes a list of (H, W) arrays."""
    if isinstance(obj, (tuple, list)):
        return type(obj)(to_numpy_tree(o) for o in obj)
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            out[f.name] = v.detach().cpu().numpy()
        elif isinstance(v, list):
            out[f.name] = [x.detach().cpu().numpy() for x in v]
        else:
            out[f.name] = v
    return out
