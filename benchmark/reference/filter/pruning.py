"""Clone-window pruning as a block permutation of the fixed covariance.
Port of vio_msckf_tpu/filter/pruning.py: the redundant-clone choice, the
update from the removed clones' observations, and the compaction of the
clone window, the covariance and the per-feature observation columns.

`maybe_prune` computes the pruned state every frame and selects it with
`torch.where` in each sequence whose window is full, in place of the
reference's `lax.cond`: no host-side branch, so no synchronisation.
Everything is per sequence: the redundant slots, the feature lanes, the
update and the permutation.
"""

import torch

from benchmark.reference.math import quat_to_rot, rot_to_quat
from benchmark.reference.filter.state import FilterState, FeatureMap, MsckfParams
from benchmark.reference.filter.update import qr_update, stack_update
from benchmark.reference.filter.triangulation import triangulate_all, check_motion_all
from benchmark.reference.tensors import gather_rows, select


def _take(x, i):
    """x[b, i[b]] for each sequence b: x (B, N, ...), i (B,)."""
    return gather_rows(x, i[:, None])[:, 0]


def find_redundant_slots(state: FilterState, params: MsckfParams):
    """The two clone slots to remove per sequence (lo < hi, each (B,)):
    the two after the key state (4 from the end) if they moved little
    relative to it, else the oldest."""
    fc = params.config.filter
    N = state.clone_q.shape[1]
    n = state.n_clones
    # Indices are clamped into the window: when it is not full the result
    # is discarded by maybe_prune, it only has to be computable.
    key = torch.clamp(n - 4, 0, N - 1)
    R_key = quat_to_rot(_take(state.clone_q, key))
    p_key = _take(state.clone_p, key)

    def redundant(slot):
        slot = torch.clamp(slot, 0, N - 1)
        R = quat_to_rot(_take(state.clone_q, slot))
        dist = torch.linalg.vector_norm(_take(state.clone_p, slot) - p_key, dim=-1)
        w = rot_to_quat(R @ R_key.mT)[..., 3]
        angle = 2.0 * torch.arccos(torch.clamp(w, -1.0, 1.0))
        return ((angle < fc.rotation_threshold)
                & (dist < fc.translation_threshold)
                & (state.tracking_rate > fc.tracking_rate_threshold))

    c0 = redundant(n - 3)
    c1 = redundant(n - 2)
    zero = torch.zeros_like(n)
    r0 = torch.where(c0, n - 3, zero)
    r1 = torch.where(c1, n - 2, torch.where(c0, zero, zero + 1))
    return torch.minimum(r0, r1), torch.maximum(r0, r1)


def _permute_cov(P, perm, new_active_mask):
    """Permute the 6-dim clone blocks of P (B, D, D) by perm (B, N) and
    zero the freed tail."""
    B = P.shape[0]
    dev = P.device
    idx = torch.cat([
        torch.arange(21, device=dev).expand(B, 21),
        (21 + 6 * perm[:, :, None] + torch.arange(6, device=dev)).reshape(B, -1),
    ], dim=1)
    bi = torch.arange(B, device=dev)[:, None, None]
    P = P[bi, idx[:, :, None], idx[:, None, :]]
    mask = torch.cat([
        torch.ones((B, 21), dtype=torch.bool, device=dev),
        torch.repeat_interleave(new_active_mask, 6, dim=1),
    ], dim=1).to(P.dtype)
    return P * mask[:, :, None] * mask[:, None, :]


def compact_lanes(mask, C):
    """Per sequence: gather indices (B, C) of the first C True entries of
    mask (B, F), in order, and which of the C lanes are real (the rest
    point at entry 0)."""
    B, F = mask.shape
    dev = mask.device
    order = torch.cumsum(mask.to(torch.int64), dim=1) - 1
    dest = torch.where(mask & (order < C), order, C)
    idx = torch.zeros((B, C + 1), dtype=torch.int64, device=dev)
    idx[torch.arange(B, device=dev)[:, None], dest] = torch.arange(F, device=dev).expand(B, F)
    sel_valid = (torch.arange(C, device=dev)[None, :]
                 < torch.clamp(torch.sum(mask, dim=1), max=C)[:, None])
    return idx[:, :C], sel_valid


def prune_clones(state: FilterState, fmap: FeatureMap, params: MsckfParams):
    """One pruning pass; meaningful only where the window is full."""
    cfg = params.config
    N = cfg.filter.max_cam_state_size
    dev = state.P.device
    B, F = fmap.valid.shape
    bi = torch.arange(B, device=dev)[:, None]
    r0, r1 = find_redundant_slots(state, params)
    slots = torch.arange(N, device=dev)[None, :]
    rm_mask = ((slots == r0[:, None]) | (slots == r1[:, None])) & state.clone_valid

    involved = fmap.obs_valid & rm_mask[:, None, :]
    n_involved = torch.sum(involved, dim=2)

    # Triangulate only the not-yet-initialized features with >= 2 involved
    # observations, compacted to C lanes first.
    need_tri = fmap.valid & (n_involved >= 2) & ~fmap.initialized
    C = min(cfg.filter.max_lost_candidates, F)
    idx, sel_valid = compact_lanes(need_tri, C)
    obs_c = gather_rows(fmap.obs, idx)
    ov_c = gather_rows(fmap.obs_valid, idx) & sel_valid[..., None]
    pos_c, tri_ok_c = triangulate_all(
        obs_c, ov_c, state.clone_q, state.clone_p,
        params.R_cam0_cam1, params.t_cam0_cam1, cfg.triangulation)
    motion_ok_c = check_motion_all(obs_c, ov_c, state.clone_q, state.clone_p,
                                   cfg.triangulation.translation_threshold)

    # Scatter the compacted results back to feature slots (F = dropped).
    scatter_idx = torch.where(sel_valid, idx, F)
    ok_c = sel_valid & motion_ok_c & tri_ok_c
    newly_ok = torch.zeros((B, F + 1), dtype=torch.bool, device=dev)
    newly_ok[bi, scatter_idx] = ok_c
    newly_ok = newly_ok[:, :F] & need_tri
    positions = torch.cat([fmap.position, fmap.position[:, :1]], dim=1)
    positions[bi, scatter_idx] = torch.where(ok_c[..., None], pos_c,
                                             gather_rows(fmap.position, idx))
    positions = positions[:, :F]
    process = fmap.valid & (n_involved >= 2) & (fmap.initialized | newly_ok)

    # Only the <= 2 involved clones contribute rows: 8-row systems.
    slots2 = torch.argsort((~involved).to(torch.int8), dim=2, stable=True)[..., :2]
    m2 = torch.gather(involved, 2, slots2)
    obs2 = torch.gather(fmap.obs, 2, slots2[..., None].expand(B, F, 2, 4))

    Hc, rc, _ = stack_update(
        state, params, positions=positions, obs=obs2, use_masks=m2,
        clone_slots=slots2, process_mask=process,
        dofs=n_involved,               # dof = #involved clones
        max_blocks=2 * F,              # at most the 2 removed clones' blocks
    )
    state = qr_update(state, Hc, rc, params)

    fmap = fmap.replace(
        position=torch.where(newly_ok[..., None], positions, fmap.position),
        initialized=fmap.initialized | newly_ok,
        obs_valid=fmap.obs_valid & ~rm_mask[:, None, :],
    )

    keep = state.clone_valid & ~rm_mask
    perm = torch.argsort((~keep).to(torch.int8), dim=1, stable=True)   # (B, N)
    n_keep = torch.sum(keep, dim=1)
    new_valid = slots < n_keep[:, None]
    state = state.replace(
        clone_q=gather_rows(state.clone_q, perm),
        clone_p=gather_rows(state.clone_p, perm),
        clone_q_null=gather_rows(state.clone_q_null, perm),
        clone_p_null=gather_rows(state.clone_p_null, perm),
        clone_valid=new_valid,
        n_clones=n_keep,
        P=_permute_cov(state.P, perm, new_valid),
    )
    fmap = fmap.replace(
        obs=torch.gather(fmap.obs, 2, perm[:, None, :, None].expand(B, F, N, 4)),
        obs_valid=torch.gather(fmap.obs_valid, 2, perm[:, None, :].expand(B, F, N))
        & new_valid[:, None, :],
    )
    return state, fmap


def maybe_prune(state: FilterState, fmap: FeatureMap, params: MsckfParams):
    """Prune each sequence whose window is full (compute, then select)."""
    full = state.n_clones >= params.config.filter.max_cam_state_size
    s, f = prune_clones(state, fmap, params)
    return select(full, s, state), select(full, f, fmap)
