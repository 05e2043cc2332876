"""Multi-view inverse-depth triangulation, batched over the feature table.

Port of vio_msckf_tpu/filter/triangulation.py: views interleaved (cam0_i,
cam1_i) per observing clone relative to the first observing clone's cam0
frame, the better of two two-view linear seeds (first->last cam0 and the
first clone's stereo pair), Huber-weighted Levenberg-Marquardt with the
damping schedule of the reference, and cheirality over every view.

The reference's per-feature `lax.while_loop`s (outer: iteration cap and
step-size precision; inner: cap and "cost reduced") become fixed-cap loops
with per-feature masks: a feature whose own loop has stopped keeps every
value unchanged, so the result equals the reference's early exit, with no
host synchronisation. The B sequences of a batch and their C feature rows
run as B * C lanes of one loop, each lane with its own stopping rule.
"""

import torch

from benchmark.reference.config import TriangulationConfig
from benchmark.reference.math import quat_to_rot
from benchmark.reference.tensors import gather_rows

_SAFE = 1e-12


def _safe(x):
    return torch.where(torch.abs(x) > _SAFE, x, torch.full_like(x, _SAFE))


def _first_last(obs_valid):
    """Index of the first and last True along the last axis (0 / N-1 when
    none)."""
    N = obs_valid.shape[-1]
    ov = obs_valid.to(torch.int32)
    i0 = torch.argmax(ov, dim=-1)
    iN = N - 1 - torch.argmax(torch.flip(ov, dims=[-1]), dim=-1)
    return i0, iN


def _view_poses(clone_q, clone_p, i0, R_c0c1, t_c0c1):
    """Per-feature, per-view poses relative to the first observing clone's
    cam0 frame: R_rel (B, C, N, 2, 3, 3), t_rel (B, C, N, 2, 3), plus the
    anchor (R_a, t_a): first-cam0 -> world. clone_q (B, N, 4), i0 (B, C)."""
    R_c0_w = quat_to_rot(clone_q).transpose(-1, -2)      # (B, N, 3, 3)
    t_c0_w = clone_p
    R_10 = R_c0c1.T
    t_10 = -R_c0c1.T @ t_c0c1
    R_c1_w = R_c0_w @ R_10
    t_c1_w = (R_c0_w @ t_10) + t_c0_w

    R_a = gather_rows(R_c0_w, i0)              # (B, C, 3, 3)
    t_a = gather_rows(t_c0_w, i0)              # (B, C, 3)

    def rel(Rv, tv):
        Rr = torch.einsum("bnji,bcjk->bcnik", Rv, R_a)       # Rv^T @ R_a
        tr = torch.einsum("bnji,bcnj->bcni", Rv, t_a[:, :, None, :] - tv[:, None])
        return Rr, tr

    R0r, t0r = rel(R_c0_w, t_c0_w)
    R1r, t1r = rel(R_c1_w, t_c1_w)
    return (torch.stack([R0r, R1r], dim=3), torch.stack([t0r, t1r], dim=3),
            R_a, t_a)


def _two_view_depth(R, t, z1, z2):
    """Linear two-view depth along bearing z1: R (C,3,3), t (C,3)."""
    ones = torch.ones_like(z1[:, :1])
    m = (R @ torch.cat([z1, ones], dim=1)[:, :, None])[..., 0]
    a = m[:, 0:2] - z2 * m[:, 2:3]
    b = z2 * t[:, 2:3] - t[:, 0:2]
    return torch.sum(a * b, dim=1) / torch.clamp(torch.sum(a * a, dim=1), min=_SAFE)


def _to_inverse_depth(z1, depth):
    ones = torch.ones_like(z1[:, :1])
    p = torch.cat([z1, ones], dim=1) * depth[:, None]
    denom = _safe(p[:, 2])
    return torch.stack([p[:, 0] / denom, p[:, 1] / denom, 1.0 / denom], dim=1)


def _project(Rv, tv, x):
    """h (C, V, 3) of every view for inverse-depth points x (C, 3)."""
    g = torch.cat([x[:, 0:2], torch.ones_like(x[:, :1])], dim=1)
    return torch.einsum("cvij,cj->cvi", Rv, g) + x[:, 2, None, None] * tv


def _costs(Rv, tv, zv, x, view_valid):
    """Total reprojection cost over valid views, per feature."""
    h = _project(Rv, tv, x)
    z_hat = h[..., 0:2] / _safe(h[..., 2])[..., None]
    e = torch.sum((z_hat - zv) ** 2, dim=-1)
    return torch.sum(torch.where(view_valid, e, torch.zeros_like(e)), dim=1)


def _solve3_sym(A, b):
    """Closed-form solve of symmetric 3x3 systems by the adjugate:
    A (C, 3, 3), b (C, 3)."""
    a00, a01, a02 = A[:, 0, 0], A[:, 0, 1], A[:, 0, 2]
    a11, a12, a22 = A[:, 1, 1], A[:, 1, 2], A[:, 2, 2]
    c00 = a11 * a22 - a12 * a12
    c01 = a02 * a12 - a01 * a22
    c02 = a01 * a12 - a02 * a11
    c11 = a00 * a22 - a02 * a02
    c12 = a01 * a02 - a00 * a12
    c22 = a00 * a11 - a01 * a01
    det = _safe(a00 * c00 + a01 * c01 + a02 * c02)
    b0, b1, b2 = b[:, 0], b[:, 1], b[:, 2]
    return torch.stack([
        (c00 * b0 + c01 * b1 + c02 * b2) / det,
        (c01 * b0 + c11 * b1 + c12 * b2) / det,
        (c02 * b0 + c12 * b1 + c22 * b2) / det,
    ], dim=1)


def _normal_equations(Rv, tv, zv, x, view_valid, huber_eps):
    """Huber-weighted 3x3 normal equations per feature."""
    h = _project(Rv, tv, x)
    h3 = _safe(h[..., 2])
    Wm = torch.cat([Rv[..., 0:2], tv[..., None]], dim=-1)        # (C,V,3,3)
    J = (Wm[..., 0:2, :] / h3[..., None, None]
         - Wm[..., 2:3, :] * (h[..., 0:2] / (h3 * h3)[..., None])[..., None])
    r = h[..., 0:2] / h3[..., None] - zv
    e = torch.linalg.vector_norm(r, dim=-1)
    one = torch.ones_like(e)
    w = torch.where(e <= huber_eps, one, huber_eps / (2.0 * torch.clamp(e, min=_SAFE)))
    w2 = torch.where(e <= huber_eps, one, w * w)
    w2 = torch.where(view_valid, w2, torch.zeros_like(w2))
    A = torch.einsum("cv,cvki,cvkj->cij", w2, J, J)
    b = torch.einsum("cv,cvki,cvk->ci", w2, J, r)
    return A, b


def triangulate_all(obs, obs_valid, clone_q, clone_p, R_c0c1, t_c0c1,
                    cfg: TriangulationConfig):
    """LM inverse-depth solve for every feature row of every sequence.

    obs (B, C, N, 4), obs_valid (B, C, N), clone_q (B, N, 4), clone_p
    (B, N, 3). Returns (p_world (B, C, 3), ok (B, C))."""
    B, C0, N, _ = obs.shape
    dtype, dev = obs.dtype, obs.device
    i0, iN = _first_last(obs_valid)
    R_rel, t_rel, R_a, t_a = _view_poses(clone_q, clone_p, i0, R_c0c1, t_c0c1)
    # From here on the B * C feature rows are independent lanes.
    C = B * C0
    R_rel = R_rel.reshape(C, N, 2, 3, 3)
    t_rel = t_rel.reshape(C, N, 2, 3)
    R_a, t_a = R_a.reshape(C, 3, 3), t_a.reshape(C, 3)
    obs = obs.reshape(C, N, 4)
    obs_valid = obs_valid.reshape(C, N)
    i0, iN = i0.reshape(C), iN.reshape(C)
    Rv = R_rel.reshape(C, 2 * N, 3, 3)
    tv = t_rel.reshape(C, 2 * N, 3)
    zv = obs.reshape(C, 2 * N, 2)
    view_valid = torch.repeat_interleave(obs_valid, 2, dim=1)

    ar = torch.arange(C, device=dev)
    z1 = obs[ar, i0, 0:2]
    # Two seeds, the cheaper one wins: first->last cam0 (the reference's)
    # and the first clone's stereo pair (which always has a baseline).
    x_t = _to_inverse_depth(z1, _two_view_depth(
        R_rel[ar, iN, 0], t_rel[ar, iN, 0], z1, obs[ar, iN, 0:2]))
    x_s = _to_inverse_depth(z1, _two_view_depth(
        R_rel[ar, i0, 1], t_rel[ar, i0, 1], z1, obs[ar, i0, 2:4]))
    c_t = _costs(Rv, tv, zv, x_t, view_valid)
    c_s = _costs(Rv, tv, zv, x_s, view_valid)
    better_t = c_t < c_s
    x = torch.where(better_t[:, None], x_t, x_s)
    cost = torch.where(better_t, c_t, c_s)

    eye3 = torch.eye(3, dtype=dtype, device=dev)
    lam = torch.full((C,), cfg.initial_damping, dtype=dtype, device=dev)
    delta_norm = torch.full((C,), float("inf"), dtype=dtype, device=dev)
    for _ in range(cfg.outer_loop_max_iteration):
        outer = delta_norm > cfg.estimation_precision
        A, b = _normal_equations(Rv, tv, zv, x, view_valid, cfg.huber_epsilon)
        reduced = torch.zeros(C, dtype=torch.bool, device=dev)
        for _ in range(cfg.inner_loop_max_iteration):
            act = outer & ~reduced
            delta = _solve3_sym(A + lam[:, None, None] * eye3, b)
            x_new = x - delta
            new_cost = _costs(Rv, tv, zv, x_new, view_valid)
            accept = new_cost < cost
            take = act & accept
            x = torch.where(take[:, None], x_new, x)
            cost = torch.where(take, new_cost, cost)
            lam_new = torch.where(accept, torch.clamp(lam / 10.0, min=1e-10),
                                  torch.clamp(lam * 10.0, max=1e12))
            lam = torch.where(act, lam_new, lam)
            delta_norm = torch.where(act, torch.linalg.vector_norm(delta, dim=1),
                                     delta_norm)
            reduced = reduced | take

    rho = _safe(x[:, 2])
    p_anchor = torch.stack([x[:, 0] / rho, x[:, 1] / rho, 1.0 / rho], dim=1)
    depths = torch.einsum("cvij,cj->cvi", Rv, p_anchor)[..., 2] + tv[..., 2]
    ok = torch.all(torch.where(view_valid, depths > 0.0, torch.ones_like(view_valid)), dim=1)
    ok = ok & torch.any(obs_valid, dim=1)
    p_world = (R_a @ p_anchor[:, :, None])[..., 0] + t_a
    return p_world.reshape(B, C0, 3), ok.reshape(B, C0)


def check_motion_all(obs, obs_valid, clone_q, clone_p, threshold):
    """Parallax gate per feature row: orthogonal translation between the
    first and last observing clones vs the first bearing. Disabled when
    threshold < 0 (the shipped config). Shapes as triangulate_all's."""
    B, C = obs.shape[:2]
    if threshold < 0:
        return torch.ones((B, C), dtype=torch.bool, device=obs.device)
    i0, iN = _first_last(obs_valid)
    z1 = torch.gather(obs, 2, i0[:, :, None, None].expand(B, C, 1, 4))[:, :, 0, 0:2]
    R_c0_w = quat_to_rot(clone_q).transpose(-1, -2)
    bearing = torch.cat([z1, torch.ones_like(z1[..., :1])], dim=-1)
    bearing = bearing / torch.clamp(
        torch.linalg.vector_norm(bearing, dim=-1, keepdim=True), min=_SAFE)
    bearing_w = (gather_rows(R_c0_w, i0) @ bearing[..., None])[..., 0]
    translation = gather_rows(clone_p, iN) - gather_rows(clone_p, i0)
    parallel = torch.sum(translation * bearing_w, dim=-1, keepdim=True)
    orthogonal = translation - parallel * bearing_w
    return torch.linalg.vector_norm(orthogonal, dim=-1) > threshold
