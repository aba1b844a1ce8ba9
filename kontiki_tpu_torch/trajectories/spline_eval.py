"""Batched uniform cubic B-spline evaluation on torch tensors (counterpart
of ``kontiki_tpu.trajectories.spline_eval``: R3, SO3 and SE3 windows).

- ``i0 = floor((t - t0) / dt)`` is taken on the primal value only (a
  detached floor), like the reference's ``PotentiallyUnsafeFloor`` on Jets
  (spline_base.h:155-163); ``u = (t - t0)/dt - i0`` stays differentiable.
- ``B(j) = sum_k u^k M[k, j]`` with the standard matrix ``M_BASIS`` or the
  cumulative matrix ``M_CUMUL`` of spline_base.h:18-28.
- Window functions take ``window [..., 4, D]`` and ``u [...]``: any leading
  batch shape, including none (for ``torch.func.vmap``).
- The batched ``*_evaluate`` queries gather windows and run kernel B5 on a
  CUDA tensor, the window functions on a CPU tensor.
"""
import torch

from ..math import quaternion as quat
from ..math import se3 as se3m

# B(j) = sum_k u^k M[k][j]  (reference spline_base.h:18-22)
M_BASIS = (
    (1.0 / 6.0, 4.0 / 6.0, 1.0 / 6.0, 0.0),
    (-3.0 / 6.0, 0.0, 3.0 / 6.0, 0.0),
    (3.0 / 6.0, -6.0 / 6.0, 3.0 / 6.0, 0.0),
    (-1.0 / 6.0, 3.0 / 6.0, -3.0 / 6.0, 1.0 / 6.0),
)

# Cumulative-form basis (reference spline_base.h:24-28)
M_CUMUL = (
    (6.0 / 6.0, 5.0 / 6.0, 1.0 / 6.0, 0.0),
    (0.0, 3.0 / 6.0, 3.0 / 6.0, 0.0),
    (0.0, -3.0 / 6.0, 3.0 / 6.0, 0.0),
    (0.0, 1.0 / 6.0, -2.0 / 6.0, 1.0 / 6.0),
)


def index_and_u(t, t0, dt, n_knots):
    """Segment index (int64, clamped to [0, n_knots-4]) and differentiable
    interpolation amount for times t.

    ``dt`` divides as a tensor: PyTorch's CUDA division by a Python scalar
    multiplies by its reciprocal, which moves ``(t - t0) / dt`` by an ulp
    from the true quotient that the CPU, the kernels and the JAX package
    take (one float32 ulp of s at 334 s is 2.4e-4 of a knot interval)."""
    s = (t - t0) / torch.full((), dt, dtype=t.dtype, device=t.device)
    i0 = torch.clamp(torch.floor(s.detach()).long(), 0, n_knots - 4)
    return i0, s - i0.to(s.dtype)


def basis_vectors(u, dt, cumulative=False):
    """Position/velocity/acceleration basis rows ``(B, dB, d2B)``, each
    ``[..., 4]``, for interpolation amount u: ``B = [1,u,u^2,u^3] M``,
    ``dB = [0,1,2u,3u^2]/dt M``, ``d2B = [0,0,2,6u]/dt^2 M``."""
    Mm = torch.tensor(M_CUMUL if cumulative else M_BASIS, dtype=u.dtype,
                      device=u.device)
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


def r3_window(window, u, dt):
    """R3 spline on a window [..., 4, 3] -> (p, v, a), each [..., 3]
    (reference uniform_r3_spline_trajectory.h:62-92)."""
    B, dB, d2B = basis_vectors(u, dt)
    return ((B[..., :, None] * window).sum(-2), (dB[..., :, None] * window).sum(-2),
            (d2B[..., :, None] * window).sum(-2))


def so3_window(window, u, dt):
    """SO3 cumulative quaternion spline on a window [..., 4, 4] (wxyz).

    Returns ``(q, omega)``, world orientation and world angular velocity:
    ``q = q_0 prod_{j=1..3} exp(B~(j) log(q_{j-1}^-1 q_j))``, omega through
    the product rule over the three factors
    (reference uniform_so3_spline_trajectory.h:81-122)."""
    B, dB, _ = basis_vectors(u, dt, cumulative=True)
    q = window[..., 0, :]
    identity = torch.cat([torch.ones_like(q[..., :1]), torch.zeros_like(q[..., 1:])], -1)
    dq_parts = [identity, identity, identity]
    for i in (1, 2, 3):
        omega = quat.logq(quat.qmul(quat.qconj(window[..., i - 1, :]), window[..., i, :]))
        eomegab = quat.expq(omega * B[..., i, None])
        q = quat.qmul(q, eomegab)
        for j in (1, 2, 3):
            m = j - 1
            if i == j:
                dq_parts[m] = quat.qmul(dq_parts[m], omega * dB[..., i, None])
            dq_parts[m] = quat.qmul(dq_parts[m], eomegab)
    dq = quat.qmul(window[..., 0, :], dq_parts[0] + dq_parts[1] + dq_parts[2])
    return q, quat.angular_velocity(q, dq)


def _se3_chain(window, u, dt):
    """The SE3 window's pose and its first and second time derivatives:
    ``(Pq, Pt, P', P'')`` with P' and P'' as 4x4 matrices, by the product
    rule on 4x4 matrices (reference uniform_se3_spline_trajectory.h:
    101-194)."""
    B, dB, d2B = basis_vectors(u, dt, cumulative=True)
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
    M2 = (
        A_bis[0] @ A[1] @ A[2]
        + A[0] @ A_bis[1] @ A[2]
        + A[0] @ A[1] @ A_bis[2]
        + 2.0 * A_prim[0] @ A_prim[1] @ A[2]
        + 2.0 * A_prim[0] @ A[1] @ A_prim[2]
        + 2.0 * A[0] @ A_prim[1] @ A_prim[2]
    )
    return Pq, Pt, P0 @ M1, P0 @ M2


def se3_window(window, u, dt):
    """SE3 cumulative spline on a packed window [..., 4, 7], amount u [...].

    Returns ``(p, v, a, q, omega)`` from ``_se3_chain``. The translational
    part of P'' is not body acceleration, as in the reference."""
    Pq, Pt, P_prim, P_bis = _se3_chain(window, u, dt)
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


def se3_window_matrices(window, u, dt):
    """The SE3 window's ``(P, P', P'')`` as 4x4 matrices (the reference's
    ``evaluate`` binding, py_uniform_se3_spline_trajectory.cc)."""
    Pq, Pt, P_prim, P_bis = _se3_chain(window, u, dt)
    return se3m.se3_matrix(Pq, Pt), P_prim, P_bis


def _evaluate(kind, knots, t0, dt, ts):
    """Batched queries: windows gathered at ``index_and_u``'s segments, then
    kernel B5 (``ops.linearize_kernels.evaluate_windows``) for CUDA tensors,
    as the JAX package routes its TPU queries, or its plain version (this
    module's window functions) for CPU tensors."""
    from ..ops.linearize_kernels import evaluate_windows

    i0, u = index_and_u(ts, t0, dt, knots.shape[0])
    return evaluate_windows(kind, gather_windows(knots, i0).contiguous(), u.contiguous(), dt)


def r3_evaluate(knots, t0, dt, ts):
    """Batched R3 evaluation: knots [N,3], ts [B] -> (p, v, a) each [B,3]."""
    return _evaluate("r3", knots, t0, dt, ts)


def so3_evaluate(knots, t0, dt, ts):
    """Batched SO3 evaluation: knots [N,4], ts [B] -> (q [B,4], omega [B,3])."""
    return _evaluate("so3", knots, t0, dt, ts)


def se3_evaluate(knots, t0, dt, ts):
    """Batched SE3 evaluation: knots [N,7], ts [B] -> (p, v, a, q, omega)."""
    return _evaluate("se3", knots, t0, dt, ts)
