"""Camera-row linearization: the CUDA kernel ``csrc/linearize_rows.cu`` and
its plain PyTorch version (counterpart of
``kontiki_tpu.ops.linearize_kernels.linearize_rows``, kernel B1).

For each ``rs_static`` pinhole row on an SE3 spline it computes the residual
``r [M, 2]``, the compressed Jacobian ``J [M, 2, 61]`` over
[ref window (24) | obs window (24) | sensor (13)] and the split landmark
column ``J_rho [M, 2]``:

- stage 1 evaluates the ref and obs 4-knot cumulative SE3 windows at
  ``u + s/dt`` in forward mode over 25 seeds (24 knot tangents, right
  increments ``(q exp(w), t + R(q) V(w) v)``, plus the time shift ``s``);
- stage 2 linearizes the projection residual over 21 seeds
  (p, q of ref and obs, sensor rotation and translation, inverse depth);
- the chain rule through the (p, q) bottleneck gives the window blocks, and
  the sensor block is ``[q_ct(3), p_ct(3), d = t_ref + t_obs, biases = 0]``.

Inputs are the gathered, transposed ``[k, M]`` rows of
``solver.kernels._camera_inputs`` (the JAX package's names and layout).
A CPU tensor goes to the plain version; a CUDA tensor launches the kernel.
"""
import ctypes

import torch

from ..math.se3 import _EPS as _EPS3
from ..sensors.camera_models import pinhole_project

RDIM = 2
C = 61
#: input names, in the kernel's argument order, with their leading sizes
INPUTS = (
    ("win_ref", 28), ("u_ref", 1), ("win_obs", 28), ("u_obs", 1), ("dts", 1),
    ("q_ct", 4), ("p_ct", 3), ("rho", 1), ("yh_ref", 3), ("uv_obs", 2),
    ("weight", 1), ("K", 9),
)

# ---------------------------------------------------------------------------
# component math on tuples of [M] tensors (formulas and guards mirror
# kontiki_tpu_torch.math.{quaternion,se3})
# ---------------------------------------------------------------------------


def _qmul(a, b):
    w1, x1, y1, z1 = a
    w2, x2, y2, z2 = b
    return (
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    )


def _qconj(q):
    w, x, y, z = q
    return (w, -x, -y, -z)


def _cross(a, b):
    ax, ay, az = a
    bx, by, bz = b
    return (ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx)


def _qrotate(q, v):
    w = q[0]
    qv = (q[1], q[2], q[3])
    t = _cross(qv, v)
    t = (2.0 * t[0], 2.0 * t[1], 2.0 * t[2])
    c = _cross(qv, t)
    return (v[0] + w * t[0] + c[0], v[1] + w * t[1] + c[1], v[2] + w * t[2] + c[2])


def _so3_exp_quat(omega):
    ox, oy, oz = omega
    theta2 = ox * ox + oy * oy + oz * oz
    small = theta2 <= _EPS3
    theta = torch.sqrt(torch.where(small, 1.0, theta2))
    half = 0.5 * theta
    k = torch.where(small, 0.5 - theta2 / 48.0, torch.sin(half) / theta)
    w = torch.where(small, 1.0 - theta2 / 8.0, torch.cos(half))
    return (w, k * ox, k * oy, k * oz)


def _so3_log(q):
    w, x, y, z = q
    n2 = x * x + y * y + z * z
    small_n = n2 <= _EPS3
    n = torch.sqrt(torch.where(small_n, 1.0, n2))
    small_w = torch.abs(w) <= 1e-10
    w_safe = torch.where(torch.abs(w) <= _EPS3, 1.0, w)
    k_small = 2.0 / w_safe - (2.0 / 3.0) * n2 / (w_safe * w_safe * w_safe)
    pi = torch.full_like(w, torch.pi)
    k_pi = torch.where(w >= 0, pi, -pi) / n
    k_gen = 2.0 * torch.atan(n / torch.where(small_w, 1.0, w)) / n
    k = torch.where(small_n, k_small, torch.where(small_w, k_pi, k_gen))
    return (k * x, k * y, k * z)


def _V_apply(omega, u):
    """V(omega) @ u = u + a w x u + b w x (w x u)."""
    ox, oy, oz = omega
    theta2 = ox * ox + oy * oy + oz * oz
    small = theta2 <= _EPS3
    theta = torch.sqrt(torch.where(small, 1.0, theta2))
    a = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    b = torch.where(
        small, 1.0 / 6.0 - theta2 / 120.0,
        (theta - torch.sin(theta)) / (theta2 * theta),
    )
    c1 = _cross(omega, u)
    c2 = _cross(omega, c1)
    return (u[0] + a * c1[0] + b * c2[0],
            u[1] + a * c1[1] + b * c2[1],
            u[2] + a * c1[2] + b * c2[2])


def _Vinv_apply(omega, t):
    """V^{-1}(omega) @ t."""
    ox, oy, oz = omega
    theta2 = ox * ox + oy * oy + oz * oz
    small = theta2 <= _EPS3
    theta = torch.sqrt(torch.where(small, 1.0, theta2))
    sin_t = torch.sin(theta)
    safe = torch.where(small | (torch.abs(sin_t) <= _EPS3), 1.0, 2.0 * theta * sin_t)
    c = torch.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        1.0 / torch.where(small, 1.0, theta2) - (1.0 + torch.cos(theta)) / safe,
    )
    c1 = _cross(omega, t)
    c2 = _cross(omega, c1)
    return (t[0] - 0.5 * c1[0] + c * c2[0],
            t[1] - 0.5 * c1[1] + c * c2[1],
            t[2] - 0.5 * c1[2] + c * c2[2])


def _cumulative_basis(u):
    u2 = u * u
    u3 = u2 * u
    B1 = (5.0 + 3.0 * u - 3.0 * u2 + u3) / 6.0
    B2 = (1.0 + 3.0 * u + 3.0 * u2 - 2.0 * u3) / 6.0
    B3 = u3 / 6.0
    return B1, B2, B3


def _pq_se3(win, u, dt, delta, s):
    """Cumulative SE3 window at ``u + s/dt`` with tangent increments.

    win: [28, M] packed knots (w,x,y,z,tx,ty,tz per knot); delta [24, M]
    (rows 6j+0..2 translation, 6j+3..5 rotation of knot j); s [M].
    Returns the 7-tuple (p, q)."""
    kq, kt = [], []
    for j in range(4):
        q_j = tuple(win[7 * j + k] for k in range(4))
        t_j = tuple(win[7 * j + 4 + k] for k in range(3))
        dv = (delta[6 * j + 0], delta[6 * j + 1], delta[6 * j + 2])
        dw = (delta[6 * j + 3], delta[6 * j + 4], delta[6 * j + 5])
        dq = _so3_exp_quat(dw)
        dt_v = _V_apply(dw, dv)
        rt = _qrotate(q_j, dt_v)
        kq.append(_qmul(q_j, dq))
        kt.append((t_j[0] + rt[0], t_j[1] + rt[1], t_j[2] + rt[2]))

    Bs = _cumulative_basis(u + s / dt)
    Pq, Pt = kq[0], kt[0]
    for j in (1, 2, 3):
        qi = _qconj(kq[j - 1])
        ti = _qrotate(qi, kt[j - 1])
        ti = (-ti[0], -ti[1], -ti[2])
        q_rel = _qmul(qi, kq[j])
        rt = _qrotate(qi, kt[j])
        t_rel = (rt[0] + ti[0], rt[1] + ti[1], rt[2] + ti[2])
        omega = _so3_log(q_rel)
        ups = _Vinv_apply(omega, t_rel)
        b = Bs[j - 1]
        bo = (b * omega[0], b * omega[1], b * omega[2])
        bu = (b * ups[0], b * ups[1], b * ups[2])
        Aq = _so3_exp_quat(bo)
        At = _V_apply(bo, bu)
        rt2 = _qrotate(Pq, At)
        Pt = (Pt[0] + rt2[0], Pt[1] + rt2[1], Pt[2] + rt2[2])
        Pq = _qmul(Pq, Aq)
    return Pt + Pq


def _residual_G(ins, u_ref, u_obs, dsen, drho):
    """Projection residual through the (p, q) bottleneck: u_ref/u_obs are
    7-tuples (p, q), dsen [6, M] (sensor rotation(3), translation(3)),
    drho [M]. Returns r [2, M]."""
    p_ref, q_ref = u_ref[:3], u_ref[3:]
    p_obs, q_obs = u_obs[:3], u_obs[3:]
    q_ct = _qmul(_so3_exp_quat((dsen[0], dsen[1], dsen[2])), tuple(ins["q_ct"]))
    p_ct = tuple(ins["p_ct"][k] + dsen[3 + k] for k in range(3))
    rho = ins["rho"][0] + drho
    yh = ins["yh_ref"]
    a = (yh[0] - rho * p_ct[0], yh[1] - rho * p_ct[1], yh[2] - rho * p_ct[2])
    X_ref = _qrotate(_qconj(q_ct), a)
    Xw = _qrotate(q_ref, X_ref)
    X = (Xw[0] + rho * p_ref[0], Xw[1] + rho * p_ref[1], Xw[2] + rho * p_ref[2])
    b = (X[0] - rho * p_obs[0], X[1] - rho * p_obs[1], X[2] - rho * p_obs[2])
    Xc = _qrotate(q_ct, _qrotate(_qconj(q_obs), b))
    X_cam = torch.stack(
        [Xc[0] + rho * p_ct[0], Xc[1] + rho * p_ct[1], Xc[2] + rho * p_ct[2]], dim=-1
    )
    K = ins["K"].T.reshape(-1, 3, 3)
    y = pinhole_project(K, X_cam).T
    return ins["weight"] * (ins["uv_obs"] - y)


def _jvp_seeds(f, primals, seeds):
    """Forward-mode columns of ``f`` at ``primals``: one ``torch.func.jvp``
    per one-hot seed, batched over the seed dimension.

    ``seeds[i]`` has shape ``[S, k_i]``; each seed row is broadcast over the
    row dimension of ``primals[i]`` (``[k_i, M]`` or ``[M]``). Returns
    ``(f(primals), J [S, ...])``."""

    def one(*es):
        tangents = tuple(
            e[:, None].expand_as(p) if p.dim() == 2 else e[0].expand_as(p)
            for e, p in zip(es, primals)
        )
        return torch.func.jvp(f, primals, tangents)[1]

    return f(*primals), torch.func.vmap(one)(*seeds)


def linearize_rows_plain(ins):
    """Plain PyTorch B1: rows are the batch dimension, seeds an explicit
    (vmapped) dimension. Returns (r [M,2], J [M,2,61], J_rho [M,2])."""
    win_ref, win_obs = ins["win_ref"], ins["win_obs"]
    M = win_ref.shape[1]
    opts = dict(dtype=win_ref.dtype, device=win_ref.device)
    dt = ins["dts"][0]

    # ---- stage 1: window evaluation over 24 knot seeds + the time shift ----
    eye25 = torch.eye(25, **opts)
    seeds1 = (eye25[:, :24], eye25[:, 24:])
    zeros24 = torch.zeros(24, M, **opts)
    zerosM = torch.zeros(M, **opts)

    def stage1(win, u):
        return _jvp_seeds(
            lambda d, s: torch.stack(_pq_se3(win, u, dt, d, s)),
            (zeros24, zerosM), seeds1,
        )  # [7, M], [25, 7, M]

    pq_ref, Jw_ref = stage1(win_ref, ins["u_ref"][0])
    pq_obs, Jw_obs = stage1(win_obs, ins["u_obs"][0])

    # ---- stage 2: the projection residual over 21 seeds ----
    def G(du_ref, du_obs, dsen, drho):
        return _residual_G(ins, tuple(pq_ref + du_ref), tuple(pq_obs + du_obs),
                           dsen, drho)

    eye21 = torch.eye(21, **opts)
    zeros7 = torch.zeros(7, M, **opts)
    r, JG = _jvp_seeds(
        G, (zeros7, zeros7, torch.zeros(6, M, **opts), zerosM),
        (eye21[:, :7], eye21[:, 7:14], eye21[:, 14:20], eye21[:, 20:]),
    )  # [2, M], [21, 2, M]

    # ---- chain rule through the (p, q) bottleneck ----
    J_ref = torch.zeros(RDIM, 24, M, **opts)
    J_obs = torch.zeros(RDIM, 24, M, **opts)
    t_ref = torch.zeros(RDIM, M, **opts)
    t_obs = torch.zeros(RDIM, M, **opts)
    for k in range(7):
        J_ref = J_ref + JG[k][:, None, :] * Jw_ref[:24, k][None, :, :]
        J_obs = J_obs + JG[7 + k][:, None, :] * Jw_obs[:24, k][None, :, :]
        t_ref = t_ref + JG[k] * Jw_ref[24, k][None, :]
        t_obs = t_obs + JG[7 + k] * Jw_obs[24, k][None, :]
    J_sen = torch.cat(
        [JG[14:20].transpose(0, 1), (t_ref + t_obs)[:, None, :],
         torch.zeros(RDIM, 6, M, **opts)],
        dim=1,
    )
    J = torch.cat([J_ref, J_obs, J_sen], dim=1)  # [2, 61, M]
    return r.T.contiguous(), J.permute(2, 0, 1).contiguous(), JG[20].T.contiguous()


def _check_inputs(ins):
    x = ins["win_ref"]
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"linearize_rows: unsupported dtype {x.dtype}")
    M = x.shape[-1]
    for name, k in INPUTS:
        a = ins[name]
        if a.shape != (k, M) or a.dtype != x.dtype or a.device != x.device:
            raise ValueError(
                f"linearize_rows: {name} must be [{k}, {M}] {x.dtype} on "
                f"{x.device}, got {tuple(a.shape)} {a.dtype} on {a.device}"
            )
        if not a.is_contiguous():
            raise ValueError(f"linearize_rows: {name} must be contiguous")
    return M


def linearize_rows(ins):
    """B1: (r [M,2], J [M,2,61], J_rho [M,2]) from ``ins`` (dict of [k, M]
    tensors named as in ``INPUTS``). CPU tensors run the plain version,
    CUDA tensors the hand-written kernel."""
    M = _check_inputs(ins)
    x = ins["win_ref"]
    if x.device.type == "cpu":
        return linearize_rows_plain(ins)
    if x.device.type != "cuda":
        raise ValueError(f"linearize_rows: unsupported device {x.device}")
    from .build import load_library

    lib = load_library()
    fn = (lib.kontiki_linearize_rows_f64 if x.dtype == torch.float64
          else lib.kontiki_linearize_rows_f32)
    r = torch.empty(M, RDIM, dtype=x.dtype, device=x.device)
    J = torch.empty(M, RDIM, C, dtype=x.dtype, device=x.device)
    J_rho = torch.empty(M, RDIM, dtype=x.dtype, device=x.device)
    if M == 0:
        return r, J, J_rho
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*[ctypes.c_void_p(ins[n].data_ptr()) for n, _ in INPUTS],
                 ctypes.c_void_p(r.data_ptr()), ctypes.c_void_p(J.data_ptr()),
                 ctypes.c_void_p(J_rho.data_ptr()), ctypes.c_int(M),
                 ctypes.c_void_p(stream))
    if err:
        raise RuntimeError(f"linearize_rows: kernel launch failed (CUDA error {err})")
    linearize_rows.launches += 1
    return r, J, J_rho


#: kernel launches since the count was last reset (CUDA tensors only)
linearize_rows.launches = 0
