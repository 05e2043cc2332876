"""IMU state + covariance propagation over one frame's padded IMU slice.

Port of vio_msckf_tpu/filter/propagation.py: error-state F, G and the
3rd-order Phi expansion, RK4 nominal integration with the zeroth-order
quaternion integrator, the observability-constrained (OC-EKF) Phi fix-up,
and one application of the accumulated transition to the big covariance.
Padding samples enter as exact identities.

The biases are constant within a frame, so every per-sample quantity is
computed batched over the M samples. The two prefix compositions — the
attitude increments and the (Phi, Q) pairs — are associative; the JAX
package reduces them with `lax.associative_scan`, this port with a
log-depth doubling loop (log2 M rounds of batched products). Both
reassociate the sequential product, so results agree with the reference to
f32 roundoff (~1e-6 relative), not bit for bit.
"""

import torch

from benchmark.reference.math import quat_mul, quat_to_rot, quat_normalize, skew
from benchmark.reference.filter.state import FilterState, MsckfParams


def _quat_increment(gyro, dt):
    """The JPL left-increment dq with q(t+dt) = dq (x) q(t), batched:
    gyro (..., 3), dt (...) -> (..., 4)."""
    norm = torch.linalg.vector_norm(gyro, dim=-1)
    h = 0.5 * dt
    big = norm > 1e-5
    safe = torch.where(big, norm, torch.ones_like(norm))
    vec = torch.where(big[..., None], gyro * (torch.sin(norm * h) / safe)[..., None],
                      gyro * h[..., None])
    w = torch.where(big, torch.cos(norm * h), torch.ones_like(norm))
    return quat_normalize(torch.cat([vec, w[..., None]], dim=-1))


def _prefix(x, combine):
    """Inclusive prefix of an associative `combine(earlier, later)` over
    axis 1 (the samples; axis 0 is the batch), by doubling."""
    n = x[0].shape[1] if isinstance(x, tuple) else x.shape[1]
    shift = 1
    while shift < n:
        if isinstance(x, tuple):
            new = combine(tuple(a[:, :-shift] for a in x), tuple(a[:, shift:] for a in x))
            x = tuple(torch.cat([a[:, :shift], b], dim=1) for a, b in zip(x, new))
        else:
            x = torch.cat([x[:, :shift], combine(x[:, :-shift], x[:, shift:])], dim=1)
        shift *= 2
    return x


def _error_state_jacobians(gyro, acc, R_w_i, dt):
    """Batched F, G, Phi of the 21-dim error state: gyro, acc (B, M, 3),
    R_w_i (B, M, 3, 3), dt (B, M) -> G (B, M, 21, 12), Phi (B, M, 21, 21)."""
    lead = gyro.shape[:-1]
    dtype, dev = gyro.dtype, gyro.device
    eye3 = torch.eye(3, dtype=dtype, device=dev).expand(lead + (3, 3))
    R_T = R_w_i.transpose(-1, -2)
    F = torch.zeros(lead + (21, 21), dtype=dtype, device=dev)
    F[..., 0:3, 0:3] = -skew(gyro)
    F[..., 0:3, 3:6] = -eye3
    F[..., 6:9, 0:3] = -R_T @ skew(acc)
    F[..., 6:9, 9:12] = -R_T
    F[..., 12:15, 6:9] = eye3

    G = torch.zeros(lead + (21, 12), dtype=dtype, device=dev)
    G[..., 0:3, 0:3] = -eye3
    G[..., 3:6, 3:6] = eye3
    G[..., 6:9, 6:9] = -R_T
    G[..., 9:12, 9:12] = eye3

    Fdt = F * dt[..., None, None]
    Fdt2 = Fdt @ Fdt
    Fdt3 = Fdt2 @ Fdt
    Phi = torch.eye(21, dtype=dtype, device=dev) + Fdt + Fdt2 / 2.0 + Fdt3 / 6.0
    return G, Phi


def _outer(a, b):
    return a[..., :, None] * b[..., None, :]


def _mv(A, x):
    """Batched matrix-vector product A (..., n, m) x (..., m)."""
    return (A @ x[..., None])[..., 0]


def _oc_ekf_fix(Phi, q_new, q_null, v_new, v_null, p_new, p_null, gravity, dt):
    """Observability-constrained Phi correction, batched over sequences
    and samples; gravity (B, 3)."""
    R_kk_1 = quat_to_rot(q_null)
    Phi = Phi.clone()
    Phi[..., 0:3, 0:3] = quat_to_rot(q_new) @ R_kk_1.transpose(-1, -2)

    g = gravity[:, None, :]
    u = _mv(R_kk_1, g.expand_as(q_null[..., :3]))                 # (B, M, 3)
    s = u / torch.clamp(torch.sum(u * u, dim=-1, keepdim=True), min=1e-20)

    A1 = Phi[..., 6:9, 0:3]
    w1 = _mv(skew(v_null - v_new), g.expand_as(v_new))
    Phi[..., 6:9, 0:3] = A1 - _outer(_mv(A1, u) - w1, s)

    A2 = Phi[..., 12:15, 0:3]
    w2 = _mv(skew(dt[..., None] * v_null + p_null - p_new), g.expand_as(p_new))
    Phi[..., 12:15, 0:3] = A2 - _outer(_mv(A2, u) - w2, s)
    return Phi


def propagate(state: FilterState, params: MsckfParams, imu_gyro, imu_acc,
              imu_dt, imu_valid) -> FilterState:
    """Run each sequence's IMU slice (B, M samples; `imu_valid` masks
    padding) through the process model."""
    dtype = state.P.dtype
    Qc = torch.diag(params.continuous_noise.to(dtype))
    g_w = state.gravity                                      # (B, 3)
    valid = imu_valid                                        # (B, M)
    vf = valid.to(dtype)[..., None]
    zero = torch.zeros((), dtype=dtype, device=valid.device)
    dt = torch.where(valid, imu_dt.to(dtype), zero)
    gyro = (imu_gyro.to(dtype) - state.bg[:, None]) * vf
    acc = torch.where(valid[..., None], imu_acc.to(dtype) - state.ba[:, None], zero)

    # --- attitude: batched increments, prefix products ---
    dq_full = _quat_increment(gyro, dt)
    dq_half = _quat_increment(gyro, dt * 0.5)
    ident_q = torch.eye(4, dtype=dtype, device=dt.device)[3]
    dq_full = torch.where(valid[..., None], dq_full, ident_q)
    pre = _prefix(dq_full, lambda a, b: quat_mul(b, a))     # dq_i ... dq_1
    q_next = quat_normalize(quat_mul(pre, state.q[:, None].expand_as(pre)))
    q_prev = torch.cat([state.q[:, None], q_next[:, :-1]], dim=1)
    q_half = quat_mul(dq_half, q_prev)

    R_prev_T = quat_to_rot(q_prev).transpose(-1, -2)
    R_half_T = quat_to_rot(q_half).transpose(-1, -2)
    R_next_T = quat_to_rot(q_next).transpose(-1, -2)

    # --- RK4 velocity / position increments ---
    gv = g_w[:, None] * vf
    k1_v = _mv(R_prev_T, acc) + gv
    k23_v = _mv(R_half_T, acc) + gv
    k4_v = _mv(R_next_T, acc) + gv
    dv = (k1_v + 4.0 * k23_v + k4_v) * (dt / 6.0)[..., None]
    v_next = state.v[:, None] + torch.cumsum(dv, dim=1)
    v_prev = torch.cat([state.v[:, None], v_next[:, :-1]], dim=1)
    dp = v_prev * dt[..., None] + (k1_v + 2.0 * k23_v) * (dt * dt / 6.0)[..., None]
    p_next = state.p[:, None] + torch.cumsum(dp, dim=1)

    # --- error-state transition + OC fix, batched over samples ---
    # OC anchors of sample i are the post-sample state of sample i-1; the
    # first come from the filter state.
    q_null_seq = torch.cat([state.q_null[:, None], q_next[:, :-1]], dim=1)
    v_null_seq = torch.cat([state.v_null[:, None], v_next[:, :-1]], dim=1)
    p_null_seq = torch.cat([state.p_null[:, None], p_next[:, :-1]], dim=1)
    G, Phi = _error_state_jacobians(gyro, acc, R_prev_T.transpose(-1, -2), dt)
    Phi = _oc_ekf_fix(Phi, q_next, q_null_seq, v_next, v_null_seq, p_next,
                      p_null_seq, g_w, dt)
    PG = Phi @ G
    Qi = PG @ Qc @ PG.transpose(-1, -2) * dt[..., None, None]
    eye = torch.eye(21, dtype=dtype, device=dt.device)
    Phi = torch.where(valid[..., None, None], Phi, eye)
    Qi = torch.where(valid[..., None, None], Qi, zero)

    def combine_pq(a, b):
        Pa, Qa = a
        Pb, Qb = b
        return Pb @ Pa, Pb @ Qa @ Pb.transpose(-1, -2) + Qb

    Phis, Qs = _prefix((Phi, Qi), combine_pq)
    Phi_acc, Q_acc = Phis[:, -1], Qs[:, -1]                 # (B, 21, 21)

    any_valid = torch.any(valid, dim=1)[:, None]            # (B, 1)
    q = torch.where(any_valid, q_next[:, -1], state.q)
    v = torch.where(any_valid, v_next[:, -1], state.v)
    p = torch.where(any_valid, p_next[:, -1], state.p)

    P = state.P
    P_new = P.clone()
    P_new[:, :21, :21] = Phi_acc @ P[:, :21, :21] @ Phi_acc.mT + Q_acc
    P_new[:, :21, 21:] = Phi_acc @ P[:, :21, 21:]
    P_new[:, 21:, :21] = P[:, 21:, :21] @ Phi_acc.mT
    P_new = (P_new + P_new.mT) / 2.0

    return state.replace(
        q=q, p=p, v=v,
        q_null=torch.where(any_valid, q, state.q_null),
        p_null=torch.where(any_valid, p, state.p_null),
        v_null=torch.where(any_valid, v, state.v_null),
        P=P_new,
    )
