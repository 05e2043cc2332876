"""Feature-map bookkeeping as fixed-shape mask algebra: id matching and
free-slot allocation over a constant-size table, observations stored per
clone slot. Port of vio_msckf_tpu/filter/features.py.
"""

import torch

from benchmark.reference.filter.state import FeatureMap
from benchmark.reference.tensors import drop_scatter


def add_observations(fmap: FeatureMap, ids, zs, meas_valid, cur_slot):
    """Upsert each sequence's measurements at its clone slot `cur_slot`.

    ids (B, K), zs (B, K, 4) normalized [u0, v0, u1, v1], meas_valid
    (B, K), cur_slot (B,). Returns (fmap, tracking_rate (B,)) with
    tracking_rate = tracked / (previous map size + 1e-5)."""
    F = fmap.fid.shape[1]
    ids = ids.to(torch.int64)
    eq = (fmap.fid[:, :, None] == ids[:, None, :]) & fmap.valid[:, :, None] \
        & meas_valid[:, None, :]                                 # (B, F, K)
    existing = torch.any(eq, dim=1)
    slot_of = torch.argmax(eq.to(torch.uint8), dim=1)

    curr_num = torch.sum(fmap.valid, dim=1)
    tracking_rate = torch.sum(existing, dim=1) / (curr_num + 1e-5)

    new = meas_valid & ~existing
    free_order = torch.argsort(fmap.valid.to(torch.int32), dim=1, stable=True)  # free first
    num_free = F - curr_num
    nth_new = torch.cumsum(new.to(torch.int64), dim=1) - 1
    overflow = nth_new >= num_free[:, None]
    new_slot = torch.gather(free_order, 1, torch.clamp(nth_new, 0, F - 1))

    target = torch.where(existing, slot_of, new_slot)
    drop = ~meas_valid | (new & overflow)
    target = torch.where(drop, F, target)
    col = cur_slot[:, None].expand_as(target)

    obs = drop_scatter(fmap.obs, target, zs.to(fmap.obs.dtype), col)
    obs_valid = drop_scatter(fmap.obs_valid, target, True, col)
    new_target = torch.where(new & ~drop, target, F)
    fid = drop_scatter(fmap.fid, new_target, ids)
    valid = drop_scatter(fmap.valid, new_target, True)
    # Fresh slots start un-triangulated, with no stale observations.
    initialized = drop_scatter(fmap.initialized, new_target, False)
    obs_valid = drop_scatter(obs_valid, new_target, False)
    obs_valid = drop_scatter(obs_valid, new_target, True, col)

    fmap = fmap.replace(fid=fid, valid=valid, obs=obs, obs_valid=obs_valid,
                        initialized=initialized)
    return fmap, tracking_rate


def clear_features(fmap: FeatureMap, remove_mask) -> FeatureMap:
    """Drop the masked features: remove_mask (B, F)."""
    keep = ~remove_mask
    return fmap.replace(
        fid=torch.where(keep, fmap.fid, -1),
        valid=fmap.valid & keep,
        obs_valid=fmap.obs_valid & keep[..., None],
        initialized=fmap.initialized & keep,
    )
