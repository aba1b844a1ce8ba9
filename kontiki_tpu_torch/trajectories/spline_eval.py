"""Batched uniform cubic B-spline evaluation on torch tensors (counterpart
of ``kontiki_tpu.trajectories.spline_eval``, SE3 path).

- ``i0 = floor((t - t0) / dt)`` is taken on the primal value only (a
  detached floor), like the reference's ``PotentiallyUnsafeFloor`` on Jets
  (spline_base.h:155-163); ``u = (t - t0)/dt - i0`` stays differentiable.
- ``B(j) = sum_k u^k M[k, j]`` with the cumulative matrix of
  spline_base.h:24-28.
- Window functions take ``window [..., 4, D]`` and ``u [...]``: any leading
  batch shape, including none (for ``torch.func.vmap``).
"""
import torch

from ..math import quaternion as quat
from ..math import se3 as se3m

# Cumulative-form basis (reference spline_base.h:24-28)
M_CUMUL = (
    (6.0 / 6.0, 5.0 / 6.0, 1.0 / 6.0, 0.0),
    (0.0, 3.0 / 6.0, 3.0 / 6.0, 0.0),
    (0.0, -3.0 / 6.0, 3.0 / 6.0, 0.0),
    (0.0, 1.0 / 6.0, -2.0 / 6.0, 1.0 / 6.0),
)


def index_and_u(t, t0, dt, n_knots):
    """Segment index (int64, clamped to [0, n_knots-4]) and differentiable
    interpolation amount for times t."""
    s = (t - t0) / dt
    i0 = torch.clamp(torch.floor(s.detach()).long(), 0, n_knots - 4)
    return i0, s - i0.to(s.dtype)


def basis_vectors(u, dt):
    """Cumulative ``(B, dB, d2B)``, each ``[..., 4]``, for interpolation
    amount u (the JAX package's ``basis_vectors(u, dt, cumulative=True)``)."""
    Mm = torch.tensor(M_CUMUL, dtype=u.dtype, device=u.device)
    one = torch.ones_like(u)
    zero = torch.zeros_like(u)
    u2 = u * u
    dt_inv = 1.0 / dt
    U = torch.stack([one, u, u2, u2 * u], dim=-1)
    dU = dt_inv * torch.stack([zero, one, 2.0 * u, 3.0 * u2], dim=-1)
    d2U = (dt_inv * dt_inv) * torch.stack([zero, zero, 2.0 * one, 6.0 * u], dim=-1)
    return U @ Mm, dU @ Mm, d2U @ Mm


def gather_windows(knots, i0):
    """Gather 4-knot windows: knots [N, D], i0 [...] -> [..., 4, D]
    (indices clipped to the knot range)."""
    idx = i0[..., None] + torch.arange(4, device=i0.device)
    return knots[torch.clamp(idx, 0, knots.shape[0] - 1)]


def se3_window(window, u, dt):
    """SE3 cumulative spline on a packed window [..., 4, 7], amount u [...].

    Returns ``(p, v, a, q, omega)``; derivatives via the product rule on
    4x4 matrices (reference uniform_se3_spline_trajectory.h:101-194). The
    translational part of P'' is not body acceleration, as in the
    reference."""
    B, dB, d2B = basis_vectors(u, dt)
    q_k, t_k = se3m.se3_unpack(window)
    Pq, Pt = q_k[..., 0, :], t_k[..., 0, :]

    A, A_prim, A_bis = [], [], []
    for j in (1, 2, 3):
        qi, ti = se3m.se3_inv(q_k[..., j - 1, :], t_k[..., j - 1, :])
        q_rel, t_rel = se3m.se3_mul(qi, ti, q_k[..., j, :], t_k[..., j, :])
        omega6 = se3m.se3_log(q_rel, t_rel)
        omega_hat = se3m.se3_hat(omega6)
        Aq, At = se3m.se3_exp(B[..., j, None] * omega6)
        Pq, Pt = se3m.se3_mul(Pq, Pt, Aq, At)

        Amat = se3m.se3_matrix(Aq, At)
        Aj_prim = Amat @ omega_hat * dB[..., j, None, None]
        A.append(Amat)
        A_prim.append(Aj_prim)
        A_bis.append(
            Aj_prim @ omega_hat * dB[..., j, None, None]
            + Amat @ omega_hat * d2B[..., j, None, None]
        )

    P0 = se3m.se3_matrix(q_k[..., 0, :], t_k[..., 0, :])
    M1 = A_prim[0] @ A[1] @ A[2] + A[0] @ A_prim[1] @ A[2] + A[0] @ A[1] @ A_prim[2]
    P_prim = P0 @ M1
    M2 = (
        A_bis[0] @ A[1] @ A[2]
        + A[0] @ A_bis[1] @ A[2]
        + A[0] @ A[1] @ A_bis[2]
        + 2.0 * A_prim[0] @ A_prim[1] @ A[2]
        + 2.0 * A_prim[0] @ A[1] @ A_prim[2]
        + 2.0 * A[0] @ A_prim[1] @ A_prim[2]
    )
    P_bis = P0 @ M2

    v = P_prim[..., :3, 3]
    a = P_bis[..., :3, 3]
    omega_hat_w = P_prim[..., :3, :3] @ quat.quat_to_matrix(Pq).transpose(-1, -2)
    omega = 0.5 * torch.stack(
        [
            omega_hat_w[..., 2, 1] - omega_hat_w[..., 1, 2],
            omega_hat_w[..., 0, 2] - omega_hat_w[..., 2, 0],
            omega_hat_w[..., 1, 0] - omega_hat_w[..., 0, 1],
        ],
        dim=-1,
    )
    return Pt, v, a, Pq, omega


def se3_evaluate(knots, t0, dt, ts):
    """Batched SE3 evaluation: knots [N,7], ts [B] -> (p, v, a, q, omega)."""
    i0, u = index_and_u(ts, t0, dt, knots.shape[0])
    return se3_window(gather_windows(knots, i0), u, dt)
