"""Row linearization kernels and their plain PyTorch versions (counterpart
of ``kontiki_tpu.ops.linearize_kernels``):

- B1 ``linearize_rows``: camera rows, CUDA kernel ``csrc/linearize_rows.cu``;
- B3 ``cost_rows``: camera-row residuals only (B1's primal chain, no
  seeds), in the same CUDA source;
- B4 ``imu_rows``: gyro/accel rows on SO3 or split R3 + SO3 splines, CUDA
  kernel ``csrc/imu_rows.cu`` (described at ``imu_rows_plain``);
- B5 ``evaluate_windows``: the trajectory queries' window evaluation
  (values and time derivatives), CUDA kernel ``csrc/eval_windows.cu``;
- B6 ``onehot_expand_rows``: compressed row Jacobians expanded to dense
  pair-window rows for the banded segment-BA assembly, CUDA kernel
  ``csrc/onehot_expand.cu``;
- B8 ``newton_rows``: Newton rolling-shutter rows, linearize and cost-only
  forms, CUDA kernels ``csrc/newton_rows.cuh`` (described at
  ``newton_rows_plain`` and there).

B1, camera rows:

For each camera row it computes the residual ``r [M, rdim]``, the
compressed Jacobian ``J [M, rdim, C]`` over
[ref window (24) | obs window (24) | sensor (13) | vt (lifting)] and the
split landmark column ``J_rho [M, rdim]``. ``cfg["camera"]`` names the
projection: ``'PinholeCamera'`` (``K X`` hnormalized) or ``'AtanCamera'``
(the Devernay-Faugeras FOV model about ``wc`` with ``gamma``, inputs ``wc``
and ``gamma``). ``cfg["lifting"]`` adds the rolling-shutter row time as a
parameter: the obs window is gathered at ``t0_obs + d + vt0 readout``, the
third residual is ``w rows (vt - vt_orig)`` and the last column is
``J_vt = dG/dvt + t_obs readout`` (inputs ``vt0``, ``vt_orig``, ``rows``,
``readout``); rdim is 2 and C 61 for static rows, 3 and 62 for lifting
rows (``camera_shape``):

- stage 1 evaluates the ref and obs windows at ``u + s/dt`` in forward mode
  over 25 seeds (24 knot tangents plus the time shift ``s``). ``cfg["kind"]``
  names the window: ``'se3'``, 4 cumulative SE3 knots with right increments
  ``(q exp(w), t + R(q) V(w) v)``; or ``'split'``, 4 R3 knots (additive) and
  4 cumulative SO3 knots (left ``exp``), each spline at its own ``u`` and
  ``dt``, whose 24 seeds are the first spline's 12, then the second's
  (``cfg["r3_first"]``);
- stage 2 linearizes the projection residual over 21 seeds
  (p, q of ref and obs, sensor rotation and translation, inverse depth)
  and, lifting, a 22nd, the row time ``vt``;
- the chain rule through the (p, q) bottleneck gives the window blocks, and
  the sensor block is ``[q_ct(3), p_ct(3), d = t_ref + t_obs, biases = 0]``.

Rows with ``valid = 0`` (an optional input) give zeros. Inputs are the
gathered, transposed ``[k, M]`` rows of ``solver.kernels._camera_inputs``
(the JAX package's names and layout). A CPU tensor goes to the plain
version; a CUDA tensor launches the kernel.
"""
import ctypes
import functools
import os
from concurrent.futures import ThreadPoolExecutor

import torch

from ..constants import GRAVITY
from ..math.quaternion import EPS as _EPS
from ..math.se3 import _EPS as _EPS3
from ..sensors.camera_models import (atan_evaluate, atan_project, pinhole_evaluate,
                                     pinhole_project)
from ..trajectories import spline_eval as ev

_WINDOWS = {
    "se3": (("win_ref", 28), None, ("u_ref", 1), None, ("win_obs", 28), None,
            ("u_obs", 1), None, ("dts", 1)),
    "split": (("win_ref_r3", 12), ("win_ref_so3", 16), ("u_ref", 1), ("u_ref_so3", 1),
              ("win_obs_r3", 12), ("win_obs_so3", 16), ("u_obs", 1), ("u_obs_so3", 1),
              ("dts", 2)),
}
_ROW = (("q_ct", 4), ("p_ct", 3), ("rho", 1), ("yh_ref", 3), ("uv_obs", 2),
        ("weight", 1), ("K", 9))
_ATAN = (("wc", 2), ("gamma", 1))
_LIFTING = (("vt0", 1), ("vt_orig", 1), ("rows", 1), ("readout", 1))
_CAMERAS = ("PinholeCamera", "AtanCamera")
#: the sensor block's columns: q_ct(3), p_ct(3), d, accel bias(3), gyro bias(3)
SENSOR_COLS = 13


def _atan(cfg):
    camera = cfg.get("camera", "PinholeCamera")
    if camera not in _CAMERAS:
        raise ValueError(f"camera rows: unsupported camera {camera!r}")
    return camera == "AtanCamera"


def camera_shape(cfg):
    """``(rdim, C)`` of ``cfg``'s rows: (2, 61) static, (3, 62) lifting."""
    return (3, 62) if cfg.get("lifting") else (2, 61)


def camera_branch(cfg):
    """The kernels' branch of ``cfg``, as the launch counts name it:
    window kind, camera and rows, e.g. ``'split atan lifting'``."""
    return " ".join((cfg["kind"], "atan" if _atan(cfg) else "pinhole",
                     "lifting" if cfg.get("lifting") else "static"))


def camera_inputs(cfg):
    """The camera kernels' input slots, in the C entry points' order:
    ``(name, leading size)``, or None where ``cfg``'s window kind, camera or
    rows have no such input. The last slot, ``valid``, is optional."""
    if cfg["kind"] not in _WINDOWS:
        raise ValueError(f"camera rows: unsupported window kind {cfg['kind']!r}")
    atan = _ATAN if _atan(cfg) else (None,) * len(_ATAN)
    lifting = _LIFTING if cfg.get("lifting") else (None,) * len(_LIFTING)
    return (*_WINDOWS[cfg["kind"]], *_ROW, *atan, *lifting, ("valid", 1))


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


def _logq_vec(q):
    """Unit-quaternion log vector part k v, k = atan2(|v|, w) / |v|
    (quaternion.logq)."""
    w, x, y, z = q
    v2 = x * x + y * y + z * z
    small = v2 <= _EPS
    vn = torch.sqrt(torch.where(small, 1.0, v2))
    k = torch.where(small, 1.0, torch.atan2(vn, w) / vn)
    return (k * x, k * y, k * z)


def _expq_pure(v):
    """exp of a pure quaternion (0, v): (cos|v|, sinc(|v|) v)."""
    x, y, z = v
    v2 = x * x + y * y + z * z
    small = v2 <= _EPS
    vn = torch.sqrt(torch.where(small, 1.0, v2))
    ka = torch.where(small, 1.0, torch.cos(vn))
    kv = torch.where(small, 1.0, torch.sin(vn) / vn)
    return (ka, kv * x, kv * y, kv * z)


def _standard_basis(u):
    """B(0..3) of the R3 spline (spline_eval.M_BASIS columns)."""
    u2 = u * u
    u3 = u2 * u
    return ((1.0 - 3.0 * u + 3.0 * u2 - u3) / 6.0,
            (4.0 - 6.0 * u2 + 3.0 * u3) / 6.0,
            (1.0 + 3.0 * u + 3.0 * u2 - 3.0 * u3) / 6.0,
            u3 / 6.0)


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


def _pq_split(win_r3, win_so3, u_r3, u_so3, dt_r3, dt_so3, delta, s, r3_first):
    """Split R3 + SO3 window at ``u + s/dt`` per spline with increments.

    win_r3 [12, M] (x,y,z per knot), win_so3 [16, M] (w,x,y,z per knot);
    delta [24, M]: the first spline's 12 rows, then the second's. R3 knots
    move additively, SO3 knots by left ``exp``; the cumulative SO3 window
    takes the relative knots' log in atan2 form. Returns the 7-tuple (p, q)."""
    off_r3 = 0 if r3_first else 12
    off_so3 = 12 if r3_first else 0
    B = _standard_basis(u_r3 + s / dt_r3)
    p = tuple(
        sum(B[j] * (win_r3[3 * j + k] + delta[off_r3 + 3 * j + k]) for j in range(4))
        for k in range(3)
    )
    kq = [
        _qmul(_so3_exp_quat(tuple(delta[off_so3 + 3 * j + k] for k in range(3))),
              tuple(win_so3[4 * j + k] for k in range(4)))
        for j in range(4)
    ]
    Bs = _cumulative_basis(u_so3 + s / dt_so3)
    q = kq[0]
    for j in (1, 2, 3):
        w = _logq_vec(_qmul(_qconj(kq[j - 1]), kq[j]))
        b = Bs[j - 1]
        q = _qmul(q, _expq_pure((b * w[0], b * w[1], b * w[2])))
    return p + q


def _window_fns(cfg, ins):
    """``(f_ref, f_obs)``: each ``f(delta [24, M], s [M]) -> (p, q) [7, M]``
    of one window of the rows (the TPU kernel's ``_tile_prelude``)."""
    def make(tag):
        if cfg["kind"] == "se3":
            win, u, dt = ins[f"win_{tag}"], ins[f"u_{tag}"][0], ins["dts"][0]
            return lambda d, s: torch.stack(_pq_se3(win, u, dt, d, s))
        wr, ws = ins[f"win_{tag}_r3"], ins[f"win_{tag}_so3"]
        ur, us = ins[f"u_{tag}"][0], ins[f"u_{tag}_so3"][0]
        dt_r3, dt_so3 = ins["dts"][0], ins["dts"][1]
        return lambda d, s: torch.stack(
            _pq_split(wr, ws, ur, us, dt_r3, dt_so3, d, s, cfg["r3_first"]))

    return make("ref"), make("obs")


def _residual_G(cfg, ins, u_ref, u_obs, dsen, drho, dvt):
    """Projection residual through the (p, q) bottleneck: u_ref/u_obs are
    7-tuples (p, q), dsen [6, M] (sensor rotation(3), translation(3)),
    drho and dvt [M]. Returns r [rdim, M]: the pixel residual of the
    pinhole or atan projection, and, lifting, ``w rows (vt - vt_orig)``."""
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
    if _atan(cfg):
        y = atan_project(K, ins["wc"].T, ins["gamma"][0], X_cam).T
    else:
        y = pinhole_project(K, X_cam).T
    r = ins["weight"] * (ins["uv_obs"] - y)
    if not cfg.get("lifting"):
        return r
    vt = ins["vt0"][0] + dvt
    r2 = ins["weight"][0] * ins["rows"][0] * (vt - ins["vt_orig"][0])
    return torch.cat([r, r2[None]])


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


def linearize_rows_plain(cfg, ins):
    """Plain PyTorch B1: rows are the batch dimension, seeds an explicit
    (vmapped) dimension. Returns (r [M, rdim], J [M, rdim, C],
    J_rho [M, rdim])."""
    M = ins["u_ref"].shape[1]
    rdim, _ = camera_shape(cfg)
    lifting = bool(cfg.get("lifting"))
    opts = dict(dtype=ins["u_ref"].dtype, device=ins["u_ref"].device)
    f_ref, f_obs = _window_fns(cfg, ins)

    # ---- stage 1: window evaluation over 24 knot seeds + the time shift ----
    eye25 = torch.eye(25, **opts)
    seeds1 = (eye25[:, :24], eye25[:, 24:])
    zeros24 = torch.zeros(24, M, **opts)
    zerosM = torch.zeros(M, **opts)

    def stage1(f):
        return _jvp_seeds(f, (zeros24, zerosM), seeds1)  # [7, M], [25, 7, M]

    pq_ref, Jw_ref = stage1(f_ref)
    pq_obs, Jw_obs = stage1(f_obs)

    # ---- stage 2: the projection residual over 21 seeds, and lifting dvt ----
    def G(du_ref, du_obs, dsen, drho, dvt=zerosM):
        return _residual_G(cfg, ins, tuple(pq_ref + du_ref), tuple(pq_obs + du_obs),
                           dsen, drho, dvt)

    NS = 22 if lifting else 21
    eye = torch.eye(NS, **opts)
    zeros7 = torch.zeros(7, M, **opts)
    r, JG = _jvp_seeds(
        G, (zeros7, zeros7, torch.zeros(6, M, **opts), zerosM, zerosM)[:NS - 17],
        (eye[:, :7], eye[:, 7:14], eye[:, 14:20], eye[:, 20:21], eye[:, 21:22])[:NS - 17],
    )  # [rdim, M], [NS, rdim, M]

    # ---- chain rule through the (p, q) bottleneck ----
    J_ref = torch.zeros(rdim, 24, M, **opts)
    J_obs = torch.zeros(rdim, 24, M, **opts)
    t_ref = torch.zeros(rdim, M, **opts)
    t_obs = torch.zeros(rdim, M, **opts)
    for k in range(7):
        J_ref = J_ref + JG[k][:, None, :] * Jw_ref[:24, k][None, :, :]
        J_obs = J_obs + JG[7 + k][:, None, :] * Jw_obs[:24, k][None, :, :]
        t_ref = t_ref + JG[k] * Jw_ref[24, k][None, :]
        t_obs = t_obs + JG[7 + k] * Jw_obs[24, k][None, :]
    J_sen = torch.cat(
        [JG[14:20].transpose(0, 1), (t_ref + t_obs)[:, None, :],
         torch.zeros(rdim, 6, M, **opts)],
        dim=1,
    )
    parts = [J_ref, J_obs, J_sen]
    if lifting:  # the row time moves the obs window: dW_obs/dvt = dW_obs/dt readout
        parts.append((JG[21] + t_obs * ins["readout"][0])[:, None, :])
    J = torch.cat(parts, dim=1)  # [rdim, C, M]
    J_rho = JG[20]
    if "valid" in ins:
        v = ins["valid"][0]
        r, J, J_rho = r * v, J * v, J_rho * v
    return r.T.contiguous(), J.permute(2, 0, 1).contiguous(), J_rho.T.contiguous()


def cost_rows_plain(cfg, ins):
    """Plain PyTorch B3 (the TPU kernel's ``_tile_cost``): the camera rows'
    residuals ``r [M, rdim]`` through B1's primal chain at zero increments,
    times ``valid``."""
    M = ins["u_ref"].shape[1]
    opts = dict(dtype=ins["u_ref"].dtype, device=ins["u_ref"].device)
    f_ref, f_obs = _window_fns(cfg, ins)
    zeros24, zerosM = torch.zeros(24, M, **opts), torch.zeros(M, **opts)
    r = _residual_G(cfg, ins, tuple(f_ref(zeros24, zerosM)),
                    tuple(f_obs(zeros24, zerosM)), torch.zeros(6, M, **opts), zerosM,
                    zerosM)
    if "valid" in ins:
        r = r * ins["valid"][0]
    return r.T.contiguous()


def _check_camera_inputs(who, cfg, ins):
    return _check_slots(who, cfg, camera_inputs(cfg), ins)


def _check_slots(who, cfg, slots, ins):
    """Check the [k, M] inputs of a camera or Newton kernel's ``slots``
    (``valid`` optional); returns M."""
    x = ins["u_ref"]
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{who}: unsupported dtype {x.dtype}")
    if cfg["kind"] == "split" and "r3_first" not in cfg:
        raise ValueError(f"{who}: a split cfg needs r3_first")
    M = x.shape[-1]
    for slot in slots:
        if slot is None:
            continue
        name, k = slot
        if name not in ins:
            if name == "valid":
                continue
            raise ValueError(f"{who}: missing input {name}")
        a = ins[name]
        if a.shape != (k, M) or a.dtype != x.dtype or a.device != x.device:
            raise ValueError(
                f"{who}: {name} must be [{k}, {M}] {x.dtype} on "
                f"{x.device}, got {tuple(a.shape)} {a.dtype} on {a.device}"
            )
        if not a.is_contiguous():
            raise ValueError(f"{who}: {name} must be contiguous")
    return M


def _camera_flags(cfg):
    """Flags of the C entry points (bits of ``csrc/camera_rows.cuh``):
    split windows, R3 spline first, atan camera, lifting rows."""
    return ((1 if cfg["kind"] == "split" else 0) | (2 if cfg.get("r3_first") else 0)
            | (4 if _atan(cfg) else 0) | (8 if cfg.get("lifting") else 0))


def _slot_ptrs(slots, ins):
    """C array of the inputs' data pointers in slot order (null where a
    slot or an optional input is absent)."""
    ptrs = [ins[s[0]].data_ptr() if s is not None and s[0] in ins else None for s in slots]
    return (ctypes.c_void_p * len(ptrs))(*ptrs)


def _launch_camera(who, cfg, ins, outs):
    """Launch B1 (``outs`` = r, J, J_rho) or B3 (``outs`` = r) on the
    inputs' card and stream."""
    from .build import load_library

    x = ins["u_ref"]
    lib = load_library()
    suffix = "_f64" if x.dtype == torch.float64 else "_f32"
    fn = getattr(lib, ("kontiki_linearize_rows" if len(outs) == 3 else "kontiki_cost_rows")
                 + suffix)
    ptrs = _slot_ptrs(camera_inputs(cfg), ins)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(ptrs, *[ctypes.c_void_p(o.data_ptr()) for o in outs],
                 ctypes.c_int(x.shape[-1]), ctypes.c_int(_camera_flags(cfg)),
                 ctypes.c_void_p(stream))
    if err:
        raise RuntimeError(f"{who}: kernel launch failed (CUDA error {err})")


def linearize_rows(cfg, ins):
    """B1: (r [M, rdim], J [M, rdim, C], J_rho [M, rdim]) from ``ins``
    (dict of [k, M] tensors named as in ``camera_inputs(cfg)``); ``cfg``:
    ``kind`` ('se3' | 'split'), split ``r3_first``, and optionally
    ``camera`` ('PinholeCamera', the default, | 'AtanCamera') and
    ``lifting`` (default False). CPU tensors run the plain version, CUDA
    tensors the hand-written kernel."""
    M = _check_camera_inputs("linearize_rows", cfg, ins)
    x = ins["u_ref"]
    if x.device.type == "cpu":
        return linearize_rows_plain(cfg, ins)
    if x.device.type != "cuda":
        raise ValueError(f"linearize_rows: unsupported device {x.device}")
    rdim, C = camera_shape(cfg)
    r = torch.empty(M, rdim, dtype=x.dtype, device=x.device)
    J = torch.empty(M, rdim, C, dtype=x.dtype, device=x.device)
    J_rho = torch.empty(M, rdim, dtype=x.dtype, device=x.device)
    if M == 0:
        return r, J, J_rho
    _launch_camera("linearize_rows", cfg, ins, (r, J, J_rho))
    _count(linearize_rows, cfg, x)
    linearize_rows.split_launches += int(cfg["kind"] == "split")
    return r, J, J_rho


def _count(wrapper, cfg, x):
    wrapper.launches += 1
    wrapper.f32_launches += int(x.dtype == torch.float32)
    branch = camera_branch(cfg)
    wrapper.branch_launches[branch] = wrapper.branch_launches.get(branch, 0) + 1


#: kernel launches since the count was last reset (CUDA tensors only), per
#: branch (``camera_branch``), and how many of them were in float32 and on
#: split windows
linearize_rows.launches = 0
linearize_rows.f32_launches = 0
linearize_rows.branch_launches = {}
linearize_rows.split_launches = 0


def cost_rows(cfg, ins):
    """B3: the camera rows' residuals ``r [M, rdim]`` only (see
    ``cost_rows_plain``), from the inputs of ``linearize_rows``. CPU
    tensors run the plain version, CUDA tensors the hand-written kernel
    (lane groups up to ``cost_rows_wave`` rows, one row per thread
    beyond)."""
    M = _check_camera_inputs("cost_rows", cfg, ins)
    x = ins["u_ref"]
    if x.device.type == "cpu":
        return cost_rows_plain(cfg, ins)
    if x.device.type != "cuda":
        raise ValueError(f"cost_rows: unsupported device {x.device}")
    r = torch.empty(M, camera_shape(cfg)[0], dtype=x.dtype, device=x.device)
    if M == 0:
        return r
    _launch_camera("cost_rows", cfg, ins, (r,))
    _count(cost_rows, cfg, x)
    return r


#: kernel launches since the count was last reset (CUDA tensors only), how
#: many of them were in float32, and per branch (``camera_branch``)
cost_rows.launches = 0
cost_rows.f32_launches = 0
cost_rows.branch_launches = {}


def cost_rows_wave(cfg, dtype=torch.float64):
    """The most rows B3 runs on its lane kernel on the current card (one
    wave of it), for ``cfg``'s branch; more rows take its one-row-per-thread
    kernel."""
    from .build import load_library

    fn = getattr(load_library(), "kontiki_cost_rows_wave"
                 + ("_f64" if dtype == torch.float64 else "_f32"))
    return fn(_camera_flags(cfg))


# ---------------------------------------------------------------------------
# B8: Newton rolling-shutter rows
# ---------------------------------------------------------------------------

def newton_shape(cfg):
    """``(Ct, C)`` of ``cfg``'s Newton rows: the window tangents of one side
    (ref or obs) and the Jacobian columns ``2 Ct + 13``."""
    td = 6 if cfg["kind"] == "se3" else 3
    Ct = td * sum(cfg["Ws"])
    return Ct, 2 * Ct + SENSOR_COLS


def _newton_windows(cfg):
    """``(W_r3, W_so3)`` of a split cfg (``Ws`` is in spline order)."""
    W0, W1 = cfg["Ws"]
    return (W0, W1) if cfg["r3_first"] else (W1, W0)


def newton_inputs(cfg):
    """B8's input slots, in the C entry points' order: ``(name, leading
    size)``, or None where ``cfg``'s window kind or camera has no such
    input. The windows are ``W``-knot readout-slack windows (``cfg["Ws"]``)
    and the obs side's ``u`` is at the frame start; the last slot,
    ``valid``, is optional."""
    if cfg["kind"] == "se3":
        (W,) = cfg["Ws"]
        windows = (("win_ref", 7 * W), None, ("u_ref", 1), None, ("win_obs", 7 * W), None,
                   ("u_obs", 1), None, ("dts", 1))
    elif cfg["kind"] == "split":
        Wr, Wq = _newton_windows(cfg)
        windows = (("win_ref_r3", 3 * Wr), ("win_ref_so3", 4 * Wq), ("u_ref", 1),
                   ("u_ref_so3", 1), ("win_obs_r3", 3 * Wr), ("win_obs_so3", 4 * Wq),
                   ("u_obs", 1), ("u_obs_so3", 1), ("dts", 2))
    else:
        raise ValueError(f"newton_rows: unsupported window kind {cfg['kind']!r}")
    atan = _ATAN if _atan(cfg) else (None,) * len(_ATAN)
    return (*windows, *_ROW, *atan, ("v_obs", 1), ("rows", 1), ("readout", 1), ("valid", 1))


def newton_branch(cfg):
    """B8's branch of ``cfg``, as its launch counts name it: window kind
    and camera, e.g. ``'split pinhole'``."""
    return f"{cfg['kind']} {'atan' if _atan(cfg) else 'pinhole'}"


def _blend_sub4(win, delta, u_in, s_over_dt, W, D, td):
    """The 4-knot sub-window of a ``W``-knot window at ``u_in + s/dt``: knots
    ``j .. j + 3`` and their increments, ``j = clip(floor(u_in + s/dt), 0,
    W - 4)`` held constant (``floor`` of the detached value), selected by
    0/1 masks as the JAX tile does. ``win``: W knots of D components;
    ``delta``: W * td increments. Returns (4 * D knot components, 4 * td
    increments, u of the sub-window)."""
    s_rel = u_in + s_over_dt
    j = torch.clamp(torch.floor(s_rel.detach()), 0.0, float(W - 4))
    u_loc = s_rel - j
    masks = [(j == float(jj)).to(s_rel.dtype) for jj in range(W - 3)]

    def pick(values, width, k, c):
        acc = masks[0] * values[k * width + c]
        for jj in range(1, W - 3):
            acc = acc + masks[jj] * values[(jj + k) * width + c]
        return acc

    sub = [pick(win, D, k, c) for k in range(4) for c in range(D)]
    sub_delta = [pick(delta, td, k, c) for k in range(4) for c in range(td)]
    return sub, sub_delta, u_loc


def _newton_window_fns(cfg, ins):
    """``(f_ref, f_obs)``: each ``f(delta [Ct, M], s [M]) -> (p, q) [7, M]``
    of one side's ``W``-knot window at ``u + s/dt`` through its masked
    4-knot sub-window (the JAX tile's ``_newton_prelude``)."""
    if cfg["kind"] == "se3":
        (W,) = cfg["Ws"]
        dt = ins["dts"][0]

        def make(tag):
            win, u = ins[f"win_{tag}"], ins[f"u_{tag}"][0]

            def f(delta, s):
                sub, sd, uu = _blend_sub4(win, delta, u, s / dt, W, 7, 6)
                return torch.stack(_pq_se3(sub, uu, dt, sd, torch.zeros_like(uu)))
            return f
        return make("ref"), make("obs")

    r3_first = cfg["r3_first"]
    Wr, Wq = _newton_windows(cfg)
    dt_r3, dt_so3 = ins["dts"][0], ins["dts"][1]
    off_r3 = 0 if r3_first else 3 * Wq
    off_so3 = 3 * Wr if r3_first else 0

    def make(tag):
        wr, wq = ins[f"win_{tag}_r3"], ins[f"win_{tag}_so3"]
        ur, uq = ins[f"u_{tag}"][0], ins[f"u_{tag}_so3"][0]

        def f(delta, s):
            sub_r3, sd_r3, u3 = _blend_sub4(wr, delta[off_r3:off_r3 + 3 * Wr], ur, s / dt_r3,
                                            Wr, 3, 3)
            sub_so3, sd_so3, u4 = _blend_sub4(wq, delta[off_so3:off_so3 + 3 * Wq], uq,
                                              s / dt_so3, Wq, 4, 3)
            d24 = (sd_r3 + sd_so3) if r3_first else (sd_so3 + sd_r3)
            return torch.stack(_pq_split(sub_r3, sub_so3, u3, u4, dt_r3, dt_so3, d24,
                                         torch.zeros_like(u3), r3_first))
        return f
    return make("ref"), make("obs")


def _newton_chain(cfg, ins, f_obs):
    """``chain(u_ref [7, M], delta_obs [Ct, M], dsen [6, M], drho, ds) -> r
    [2, M]``: the rows' residual from the ref side's (p, q), the JAX tile's
    ``_newton_chain``. Five Newton steps on ``f(t) = v(t) - rows t /
    readout`` in the row time ``t`` relative to the frame start, each
    evaluating the obs window at ``ds + t`` and its time derivative (a
    ``torch.func.jvp`` in time); ``dX_cam`` carries the reference's
    ``+ rho p_ct`` (newton_rscamera_measurement.h:91); the time is clamped
    to [0, readout] until a step passes ``dt^2 < (readout / (2 rows))^2``,
    and the projection of the first step that passes is kept (of the
    fifth if none does)."""
    rows, readout = ins["rows"][0], ins["readout"][0]
    K = ins["K"].T.reshape(-1, 3, 3)

    def evaluate(X, dX):
        """(y, dy) [2, M]: the projection of X and its time derivative."""
        X, dX = torch.stack(X, dim=-1), torch.stack(dX, dim=-1)
        if _atan(cfg):
            y, dy = atan_evaluate(K, ins["wc"].T, ins["gamma"][0], X, dX)
        else:
            y, dy = pinhole_evaluate(K, X, dX)
        return y.T, dy.T

    def chain(u_ref, delta_obs, dsen, drho, ds):
        p_ref, q_ref = u_ref[:3], u_ref[3:]
        q_ct = _qmul(_so3_exp_quat((dsen[0], dsen[1], dsen[2])), tuple(ins["q_ct"]))
        p_ct = tuple(ins["p_ct"][k] + dsen[3 + k] for k in range(3))
        rho = ins["rho"][0] + drho
        yh = ins["yh_ref"]
        a = (yh[0] - rho * p_ct[0], yh[1] - rho * p_ct[1], yh[2] - rho * p_ct[2])
        Xw = _qrotate(q_ref, _qrotate(_qconj(q_ct), a))
        X = (Xw[0] + rho * p_ref[0], Xw[1] + rho * p_ref[1], Xw[2] + rho * p_ref[2])
        row_delta = readout / rows
        max_dt2 = (0.5 * row_delta) * (0.5 * row_delta)

        def obs_X_cam(t_shift):
            pq = f_obs(delta_obs, t_shift)
            sv = (X[0] - rho * pq[0], X[1] - rho * pq[1], X[2] - rho * pq[2])
            Xc = _qrotate(q_ct, _qrotate(_qconj(tuple(pq[3:])), sv))
            return torch.stack((Xc[0] + rho * p_ct[0], Xc[1] + rho * p_ct[1],
                                Xc[2] + rho * p_ct[2]))

        t_rel = ins["v_obs"][0] * row_delta
        y0 = y1 = torch.zeros_like(t_rel)
        done = torch.zeros_like(t_rel, dtype=torch.bool)
        for _ in range(5):
            Xc, dX0 = torch.func.jvp(obs_X_cam, (ds + t_rel,), (torch.ones_like(t_rel),))
            dXc = (dX0[0] + rho * p_ct[0], dX0[1] + rho * p_ct[1], dX0[2] + rho * p_ct[2])
            y, dy = evaluate(tuple(Xc), dXc)
            dtn = (y[1] - rows * t_rel / readout) / (dy[1] - rows / readout)
            now_done = dtn * dtn < max_dt2
            new_t = t_rel - dtn
            new_t = torch.where(now_done, new_t,
                                torch.clamp(new_t, torch.zeros_like(new_t), readout))
            t_rel = torch.where(done, t_rel, new_t)
            y0 = torch.where(done, y0, y[0])
            y1 = torch.where(done, y1, y[1])
            done = done | now_done
        w = ins["weight"][0]
        uv = ins["uv_obs"]
        return torch.stack((w * (uv[0] - y0), w * (uv[1] - y1)))

    return chain


def newton_rows_plain(cfg, ins, cost_only=False):
    """Plain PyTorch B8 (the JAX tile's ``_tile_newton_linearize`` and
    ``_tile_newton_cost``): rows are the batch dimension, seeds a vmapped
    dimension of ``torch.func.jvp``.

    - stage 1: the ref window in forward mode over its Ct knot tangents and
      the time shift ``s`` (Ct + 1 seeds) -> (p, q) and their columns;
    - stage 2: the Newton chain over 7 + Ct + 8 seeds: the ref (p, q), the
      obs window's knot tangents, the sensor rotation and translation, the
      inverse depth and ``s``;
    - the chain rule through the ref (p, q) bottleneck gives the ref block;
      the sensor block is ``[q_ct(3), p_ct(3), d = s column + ref time
      chain, biases = 0]``.

    Returns ``(r [M, 2], J [M, 2, C], J_rho [M, 2])`` with C = 2 Ct + 13
    (columns: ref window, obs window, sensor), or ``r`` with ``cost_only``;
    rows with ``valid = 0`` give zeros."""
    M = ins["u_ref"].shape[1]
    opts = dict(dtype=ins["u_ref"].dtype, device=ins["u_ref"].device)
    Ct, _ = newton_shape(cfg)
    f_ref, f_obs = _newton_window_fns(cfg, ins)
    chain = _newton_chain(cfg, ins, f_obs)
    zerosC, zerosM = torch.zeros(Ct, M, **opts), torch.zeros(M, **opts)
    zeros6 = torch.zeros(6, M, **opts)
    valid = ins["valid"][0] if "valid" in ins else None
    if cost_only:
        r = chain(f_ref(zerosC, zerosM), zerosC, zeros6, zerosM, zerosM)
        if valid is not None:
            r = r * valid
        return r.T.contiguous()

    eye = torch.eye(Ct + 1, **opts)
    pq_ref, Jw_ref = _jvp_seeds(f_ref, (zerosC, zerosM), (eye[:, :Ct], eye[:, Ct:]))

    def chain7(du_ref, delta_obs, dsen, drho, ds):
        return chain(pq_ref + du_ref, delta_obs, dsen, drho, ds)

    NS = 7 + Ct + 8
    eye = torch.eye(NS, **opts)
    r, JG = _jvp_seeds(
        chain7, (torch.zeros(7, M, **opts), zerosC, zeros6, zerosM, zerosM),
        (eye[:, :7], eye[:, 7:7 + Ct], eye[:, 7 + Ct:13 + Ct], eye[:, 13 + Ct:14 + Ct],
         eye[:, 14 + Ct:]),
    )  # [2, M], [NS, 2, M]
    J_ref = torch.zeros(2, Ct, M, **opts)
    t_ref = torch.zeros(2, M, **opts)
    for k in range(7):
        J_ref = J_ref + JG[k][:, None, :] * Jw_ref[:Ct, k][None, :, :]
        t_ref = t_ref + JG[k] * Jw_ref[Ct, k][None, :]
    J_sen = torch.cat([JG[7 + Ct:13 + Ct].transpose(0, 1), (JG[14 + Ct] + t_ref)[:, None, :],
                       torch.zeros(2, 6, M, **opts)], dim=1)
    J = torch.cat([J_ref, JG[7:7 + Ct].transpose(0, 1), J_sen], dim=1)  # [2, C, M]
    J_rho = JG[13 + Ct]
    if valid is not None:
        r, J, J_rho = r * valid, J * valid, J_rho * valid
    return r.T.contiguous(), J.permute(2, 0, 1).contiguous(), J_rho.T.contiguous()


def _check_newton_inputs(cfg, ins):
    if len(cfg["Ws"]) != (1 if cfg["kind"] == "se3" else 2) or min(cfg["Ws"]) < 4:
        raise ValueError(f"newton_rows: bad window widths {cfg['Ws']!r}")
    return _check_slots("newton_rows", cfg, newton_inputs(cfg), ins)


def _newton_flags(cfg, cost_only=False):
    """Flags of the C entry points (bits of ``csrc/newton_rows.cuh``): split
    windows, R3 spline first, atan camera, cost only."""
    return ((1 if cfg["kind"] == "split" else 0) | (2 if cfg.get("r3_first") else 0)
            | (4 if _atan(cfg) else 0) | (8 if cost_only else 0))


def _newton_ws(cfg):
    """The C entry points' window widths: SE3 ``(W, W)``, split ``(W_r3,
    W_so3)``."""
    return (cfg["Ws"][0],) * 2 if cfg["kind"] == "se3" else _newton_windows(cfg)


def newton_rows(cfg, ins, cost_only=False):
    """B8: ``(r [M, 2], J [M, 2, C], J_rho [M, 2])``, or ``r`` with
    ``cost_only``, of Newton rolling-shutter rows (see
    ``newton_rows_plain``) from ``ins`` (dict of [k, M] tensors named as in
    ``newton_inputs(cfg)``); ``cfg``: ``kind`` ('se3' | 'split'), split
    ``r3_first``, ``camera`` ('PinholeCamera' | 'AtanCamera') and ``Ws``,
    the window widths in spline order. CPU tensors run the plain version,
    CUDA tensors the hand-written kernel, on windows whose block of rows
    fits the card's shared memory (``newton_rows_smem``)."""
    M = _check_newton_inputs(cfg, ins)
    x = ins["u_ref"]
    if x.device.type == "cpu":
        return newton_rows_plain(cfg, ins, cost_only=cost_only)
    if x.device.type != "cuda":
        raise ValueError(f"newton_rows: unsupported device {x.device}")
    from .build import load_library

    need, limit = newton_rows_smem(cfg, x.dtype, x.device)
    if need > limit:
        raise NotImplementedError(
            f"newton_rows: windows of {cfg['Ws']!r} knots need {need} bytes of shared memory "
            f"a block of the linearize kernel, more than the card's {limit}")
    _, C = newton_shape(cfg)
    r = torch.empty(M, 2, dtype=x.dtype, device=x.device)
    J = torch.empty(0 if cost_only else M, 2, C, dtype=x.dtype, device=x.device)
    J_rho = torch.empty(0 if cost_only else M, 2, dtype=x.dtype, device=x.device)
    if M == 0:
        return r if cost_only else (r, J, J_rho)
    lib = load_library()
    fn = lib.kontiki_newton_rows_f64 if x.dtype == torch.float64 else lib.kontiki_newton_rows_f32
    ptrs = _slot_ptrs(newton_inputs(cfg), ins)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(ptrs, ctypes.c_void_p(r.data_ptr()),
                 ctypes.c_void_p(None if cost_only else J.data_ptr()),
                 ctypes.c_void_p(None if cost_only else J_rho.data_ptr()), ctypes.c_int(M),
                 *(ctypes.c_int(w) for w in _newton_ws(cfg)),
                 ctypes.c_int(_newton_flags(cfg, cost_only)), ctypes.c_void_p(stream))
    if err:
        raise RuntimeError(f"newton_rows: kernel launch failed (CUDA error {err})")
    newton_rows.launches += 1
    newton_rows.cost_launches += int(cost_only)
    branch = newton_branch(cfg) + (" cost-only" if cost_only else "")
    newton_rows.branch_launches[branch] = newton_rows.branch_launches.get(branch, 0) + 1
    return r if cost_only else (r, J, J_rho)


def newton_rows_smem(cfg, dtype=torch.float64, device=None):
    """``(need, limit)``: the bytes of shared memory a block of B8's
    linearize kernel takes for ``cfg``'s window widths, and the most a block
    can have on the card (its opt-in limit, 232,448 bytes on an H100)."""
    from .build import load_library

    device = torch.device("cuda" if device is None else device)
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return _newton_smem(load_library(), _newton_ws(cfg), _newton_flags(cfg), dtype, device)


@functools.lru_cache(maxsize=None)
def _newton_smem(lib, ws, flags, dtype, device):
    fn = getattr(lib, "kontiki_newton_rows_smem" + ("_f64" if dtype == torch.float64 else "_f32"))
    return fn(*ws, flags), torch.cuda.get_device_properties(device).shared_memory_per_block_optin


def newton_rows_wave(cfg, dtype=torch.float64):
    """The rows B8's linearize kernel holds on the current card at once
    (one wave of its blocks), for ``cfg``'s branch and window widths."""
    from .build import load_library

    fn = getattr(load_library(), "kontiki_newton_rows_wave"
                 + ("_f64" if dtype == torch.float64 else "_f32"))
    return fn(*_newton_ws(cfg), _newton_flags(cfg))


#: kernel launches since the count was last reset (CUDA tensors only), how
#: many of them were the cost-only form, and per branch (``newton_branch``,
#: then `` cost-only`` for that form)
newton_rows.launches = 0
newton_rows.cost_launches = 0
newton_rows.branch_launches = {}


# ---------------------------------------------------------------------------
# B4: gyro / accel rows on SO3 or split R3 + SO3 splines
# ---------------------------------------------------------------------------

#: input names, in the kernel's argument order, with their leading sizes;
#: the r3 inputs are absent for SO3-only problems and ``valid`` is optional
IMU_INPUTS = (
    ("win_so3", 16), ("u_so3", 1), ("dts_so3", 1), ("win_r3", 12), ("u_r3", 1),
    ("dts_r3", 1), ("y", 3), ("weight", 1), ("bias", 3), ("valid", 1),
)
_IMU_OPTIONAL = ("win_r3", "u_r3", "dts_r3", "valid")


def imu_columns(cfg):
    """Jacobian width C: the window columns (12 SO3, or 12 R3 + 12 SO3),
    then the 13 sensor columns."""
    return (12 if cfg["so3_only"] else 24) + SENSOR_COLS


def _imu_body(cfg, ins):
    """``body(delta [nk, M], s [M]) -> [3, M]``: the modelled body-frame
    gyro rate or specific force at ``u + s/dt`` with window increments
    ``delta`` (SO3 knots left ``exp``, R3 knots additive); time derivatives
    are nested ``torch.func.jvp`` through ``s``, as ``_tile_imu`` does."""
    so3_only = cfg["so3_only"]
    r3_first = cfg.get("r3_first", True)
    ws = [tuple(ins["win_so3"][4 * j + k] for k in range(4)) for j in range(4)]
    u_so3, dt_so3 = ins["u_so3"][0], ins["dts_so3"][0]
    off_so3 = 0 if so3_only else (12 if r3_first else 0)
    off_r3 = 0 if r3_first else 12

    def qfun(delta, s):
        kq = [_qmul(_so3_exp_quat(tuple(delta[off_so3 + 3 * j + k] for k in range(3))),
                    ws[j]) for j in range(4)]
        Bs = _cumulative_basis(u_so3 + s / dt_so3)
        q = kq[0]
        for j in (1, 2, 3):
            w3 = _logq_vec(_qmul(_qconj(kq[j - 1]), kq[j]))
            b = Bs[j - 1]
            q = _qmul(q, _expq_pure((b * w3[0], b * w3[1], b * w3[2])))
        return torch.stack(q)

    def tangent_one(x):
        return torch.ones_like(x)

    if cfg["kind"] == "gyro":
        def body(delta, s):
            q, dq = torch.func.jvp(lambda ss: qfun(delta, ss), (s,), (tangent_one(s),))
            qt = tuple(q)
            wq = _qmul(tuple(dq), _qconj(qt))  # omega_world = 2 (dq q^-1).vec
            return torch.stack(_qrotate(_qconj(qt), (2.0 * wq[1], 2.0 * wq[2], 2.0 * wq[3])))
        return body

    wr = [tuple(ins["win_r3"][3 * j + k] for k in range(3)) for j in range(4)]
    u_r3, dt_r3 = ins["u_r3"][0], ins["dts_r3"][0]

    def pfun(delta, s):
        B = _standard_basis(u_r3 + s / dt_r3)
        return torch.stack([
            sum(B[j] * (wr[j][k] + delta[off_r3 + 3 * j + k]) for j in range(4))
            for k in range(3)
        ])

    def body(delta, s):
        def vel(ss):
            return torch.func.jvp(lambda s2: pfun(delta, s2), (ss,), (tangent_one(ss),))[1]

        a = torch.func.jvp(vel, (s,), (tangent_one(s),))[1]
        qt = tuple(qfun(delta, s))
        return torch.stack(_qrotate(_qconj(qt), (a[0], a[1], a[2] + float(GRAVITY[2]))))
    return body


def imu_rows_plain(cfg, ins, cost_only=False):
    """Plain PyTorch B4 (the TPU kernel's ``_tile_imu``).

    ``cfg``: ``kind`` ('gyro' | 'accel'), ``so3_only``, ``r3_first``.
    ``ins``: the gathered, transposed ``[k, M]`` rows named as in
    ``IMU_INPUTS``. The residual is ``w (y - body - bias)``:

    - gyro: ``body = R(q)^T omega_world``, ``omega_world = 2 (dq/dt q^-1).vec``;
    - accel: ``body = R(q)^T (d2p/dt2 + g)``, ``g = (0, 0, -9.80665)``.

    J holds ``-w d(body)/d(window increments)`` (window columns in the
    ``r3_first`` order; a gyro row's R3 columns are zero), the time shift in
    sensor column 6, and ``-w I`` in the bias columns (7-9 accel, 10-12
    gyro); the relative-pose columns stay zero (IMUs ignore it). Rows with
    ``valid = 0`` are zero. Returns ``(r [M, 3], J [M, 3, C])``, or ``r``
    with ``cost_only``."""
    u = ins["u_so3"]
    M = u.shape[1]
    opts = dict(dtype=u.dtype, device=u.device)
    nk = 12 if cfg["so3_only"] else 24
    body = _imu_body(cfg, ins)
    zerosK, zerosM = torch.zeros(nk, M, **opts), torch.zeros(M, **opts)
    w = ins["weight"][0]
    valid = ins["valid"][0] if "valid" in ins else None

    if cost_only:
        b0 = body(zerosK, zerosM)
    else:
        eye = torch.eye(nk + 1, **opts)
        b0, Jb = _jvp_seeds(body, (zerosK, zerosM), (eye[:, :nk], eye[:, nk:]))
    r = w * (ins["y"] - b0 - ins["bias"])
    if valid is not None:
        r = r * valid
    if cost_only:
        return r.T.contiguous()

    C = nk + SENSOR_COLS
    J = torch.zeros(3, C, M, **opts)
    J[:, :nk] = -(Jb[:nk] * w).transpose(0, 1)
    J[:, nk + 6] = -Jb[nk] * w
    bias_off = nk + (7 if cfg["kind"] == "accel" else 10)
    for k in range(3):
        J[k, bias_off + k] = -w
    if valid is not None:
        J = J * valid
    return r.T.contiguous(), J.permute(2, 0, 1).contiguous()


def _check_imu_inputs(cfg, ins):
    x = ins["u_so3"]
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"imu_rows: unsupported dtype {x.dtype}")
    if cfg["kind"] not in ("gyro", "accel"):
        raise ValueError(f"imu_rows: unsupported kind {cfg['kind']!r}")
    if cfg["kind"] == "accel" and cfg["so3_only"]:
        raise ValueError("imu_rows: accel rows need an R3 spline")
    M = x.shape[-1]
    for name, k in IMU_INPUTS:
        if name not in ins:
            if name == "valid" or (cfg["so3_only"] and name in _IMU_OPTIONAL):
                continue
            raise ValueError(f"imu_rows: missing input {name}")
        a = ins[name]
        if a.shape != (k, M) or a.dtype != x.dtype or a.device != x.device:
            raise ValueError(
                f"imu_rows: {name} must be [{k}, {M}] {x.dtype} on {x.device}, "
                f"got {tuple(a.shape)} {a.dtype} on {a.device}"
            )
        if not a.is_contiguous():
            raise ValueError(f"imu_rows: {name} must be contiguous")
    return M


def _imu_flags(cfg, cost_only):
    """Flags of the C entry points (bits of ``csrc/imu_rows.cu``)."""
    return ((1 if cfg["kind"] == "accel" else 0) | (0 if cfg["so3_only"] else 2)
            | (4 if cfg.get("r3_first", True) else 0) | (8 if cost_only else 0))


def imu_rows(cfg, ins, cost_only=False):
    """B4: ``(r [M, 3], J [M, 3, C])``, or ``r`` with ``cost_only``, of
    gyro/accel rows (see ``imu_rows_plain``). CPU tensors run the plain
    version, CUDA tensors the hand-written kernel."""
    M = _check_imu_inputs(cfg, ins)
    x = ins["u_so3"]
    if x.device.type == "cpu":
        return imu_rows_plain(cfg, ins, cost_only=cost_only)
    if x.device.type != "cuda":
        raise ValueError(f"imu_rows: unsupported device {x.device}")
    from .build import load_library

    lib = load_library()
    fn = lib.kontiki_imu_rows_f64 if x.dtype == torch.float64 else lib.kontiki_imu_rows_f32
    C = imu_columns(cfg)
    r = torch.empty(M, 3, dtype=x.dtype, device=x.device)
    J = torch.empty(0 if cost_only else M, 3, C, dtype=x.dtype, device=x.device)
    if M == 0:
        return r if cost_only else (r, J)
    flags = _imu_flags(cfg, cost_only)
    ptrs = [ctypes.c_void_p(ins[n].data_ptr() if n in ins else None) for n, _ in IMU_INPUTS]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*ptrs, ctypes.c_void_p(r.data_ptr()),
                 ctypes.c_void_p(J.data_ptr() if not cost_only else None),
                 ctypes.c_int(M), ctypes.c_int(flags), ctypes.c_void_p(stream))
    if err:
        raise RuntimeError(f"imu_rows: kernel launch failed (CUDA error {err})")
    imu_rows.launches += 1
    imu_rows.cost_launches += int(cost_only)
    imu_rows.f32_launches += int(x.dtype == torch.float32)
    return r if cost_only else (r, J)


#: kernel launches since the count was last reset (CUDA tensors only), how
#: many of them were the cost-only form and how many in float32
imu_rows.launches = 0
imu_rows.cost_launches = 0
imu_rows.f32_launches = 0


# ---------------------------------------------------------------------------
# B5: batched spline-window evaluation (the trajectory queries)
# ---------------------------------------------------------------------------

#: window knot width D and output widths per kind, in output order
EVAL_KNOT_DIM = {"r3": 3, "so3": 4, "se3": 7}
EVAL_OUTPUTS = {"r3": (3, 3, 3), "so3": (4, 3), "se3": (3, 3, 3, 4, 3)}
_EVAL_KIND = {"r3": 0, "so3": 1, "se3": 2}  # kEval* of csrc/eval_windows.cu
_WINDOW_FNS = {"r3": ev.r3_window, "so3": ev.so3_window, "se3": ev.se3_window}


def evaluate_windows_plain(kind, windows, u, dt):
    """Plain PyTorch B5: the window functions of ``trajectories.spline_eval``
    (``r3_window``, ``so3_window``, ``se3_window``) with the queries as the
    batch dimension. windows [M, 4, D], u [M] -> r3 ``(p, v, a)``, so3
    ``(q, w)``, se3 ``(p, v, a, q, w)``, each [M, k]."""
    return _WINDOW_FNS[kind](windows, u, dt)


def _check_eval_inputs(kind, windows, u):
    if kind not in EVAL_KNOT_DIM:
        raise ValueError(f"evaluate_windows: unsupported kind {kind!r}")
    if windows.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"evaluate_windows: unsupported dtype {windows.dtype}")
    M = windows.shape[0]
    if windows.shape != (M, 4, EVAL_KNOT_DIM[kind]):
        raise ValueError(f"evaluate_windows: {kind} windows must be [M, 4, "
                         f"{EVAL_KNOT_DIM[kind]}], got {tuple(windows.shape)}")
    if u.shape != (M,) or u.dtype != windows.dtype or u.device != windows.device:
        raise ValueError(f"evaluate_windows: u must be [{M}] {windows.dtype} on "
                         f"{windows.device}, got {tuple(u.shape)} {u.dtype} on {u.device}")
    if not (windows.is_contiguous() and u.is_contiguous()):
        raise ValueError("evaluate_windows: windows and u must be contiguous")
    return M


def evaluate_windows(kind, windows, u, dt):
    """B5 (the JAX package's ``evaluate_windows`` signature): spline windows
    [M, 4, D] (D = 3 r3, 4 so3 wxyz, 7 se3 packed q + t) at interpolation
    amounts u [M] with knot spacing ``dt`` -> r3 ``(p, v, a)``, so3
    ``(q, w)``, se3 ``(p, v, a, q, w)``, each [M, k]. v and a are the first
    and second time derivatives, w the world angular velocity; SE3's a is
    the translation of P'' as in the reference. CPU tensors run the plain
    version, CUDA tensors the hand-written kernel."""
    M = _check_eval_inputs(kind, windows, u)
    if windows.device.type == "cpu":
        return evaluate_windows_plain(kind, windows, u, dt)
    if windows.device.type != "cuda":
        raise ValueError(f"evaluate_windows: unsupported device {windows.device}")
    from .build import load_library

    outs = tuple(torch.empty(M, k, dtype=windows.dtype, device=windows.device)
                 for k in EVAL_OUTPUTS[kind])
    if M == 0:
        return outs
    lib = load_library()
    fn = (lib.kontiki_eval_windows_f64 if windows.dtype == torch.float64
          else lib.kontiki_eval_windows_f32)
    ptrs = (ctypes.c_void_p * len(outs))(*[o.data_ptr() for o in outs])
    with torch.cuda.device(windows.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(_EVAL_KIND[kind], windows.data_ptr(), u.data_ptr(), float(dt), ptrs, M,
                 ctypes.c_void_p(stream))
    if err:
        raise RuntimeError(f"evaluate_windows: kernel launch failed (CUDA error {err})")
    evaluate_windows.launches[kind] += 1
    return outs


#: kernel launches per kind since the counts were last reset (CUDA tensors only)
evaluate_windows.launches = {"r3": 0, "so3": 0, "se3": 0}


# ---------------------------------------------------------------------------
# B6: one-hot row expansion (the banded segment-BA assembly)
# ---------------------------------------------------------------------------

def onehot_expand_rows_plain(Jw, rel, WB, chunk=4096):
    """Plain PyTorch B6, the JAX package's non-TPU formula
    (``parallel/segments_ba.py`` ``_dense_rows``): per chunk of rows, a
    one-hot ``[chunk, C, WB]`` of ``rel`` against ``arange(WB)`` and one
    batched product with ``Jw``. Duplicate ids add; ids outside [0, WB)
    match no column."""
    M, rdim, C = Jw.shape
    iota = torch.arange(WB, dtype=rel.dtype, device=rel.device)
    out = torch.empty(M, rdim, WB, dtype=Jw.dtype, device=Jw.device)
    for i in range(0, M, chunk):
        oh = (rel[i:i + chunk, :, None] == iota).to(Jw.dtype)
        out[i:i + chunk] = torch.einsum("mrc,mcw->mrw", Jw[i:i + chunk], oh)
    return out


def onehot_expand_rows(Jw, rel, WB):
    """B6 (the JAX package's ``onehot_expand_rows``): ``Jd [M, rdim, WB]``
    with ``Jd[m, r, rel[m, c]] += Jw[m, r, c]`` from ``Jw [M, rdim, C]``
    (float32/float64) and ``rel [M, C]`` (int64); ids outside [0, WB) are
    dropped. CPU tensors run the plain version, CUDA tensors the
    hand-written kernel."""
    if Jw.dim() != 3 or Jw.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"onehot_expand_rows: Jw must be [M, rdim, C] float, "
                         f"got {tuple(Jw.shape)} {Jw.dtype}")
    M, rdim, C = Jw.shape
    if rel.shape != (M, C) or rel.dtype != torch.int64 or rel.device != Jw.device:
        raise ValueError(f"onehot_expand_rows: rel must be [{M}, {C}] int64 on "
                         f"{Jw.device}, got {tuple(rel.shape)} {rel.dtype} on {rel.device}")
    if Jw.device.type == "cpu":
        return onehot_expand_rows_plain(Jw, rel, WB)
    if Jw.device.type != "cuda":
        raise ValueError(f"onehot_expand_rows: unsupported device {Jw.device}")
    if not (Jw.is_contiguous() and rel.is_contiguous()):
        raise ValueError("onehot_expand_rows: Jw and rel must be contiguous")
    from .build import load_library

    out = torch.empty(M, rdim, WB, dtype=Jw.dtype, device=Jw.device)
    if M == 0:
        return out
    lib = load_library()
    fn = (lib.kontiki_onehot_expand_f64 if Jw.dtype == torch.float64
          else lib.kontiki_onehot_expand_f32)
    with torch.cuda.device(Jw.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(ctypes.c_void_p(Jw.data_ptr()), ctypes.c_void_p(rel.data_ptr()),
                 ctypes.c_void_p(out.data_ptr()), M, rdim, C, int(WB),
                 ctypes.c_void_p(stream))
    if err:
        raise RuntimeError(f"onehot_expand_rows: kernel launch failed (CUDA error {err})")
    onehot_expand_rows.launches += 1
    onehot_expand_rows.f32_launches += int(Jw.dtype == torch.float32)
    return out


#: kernel launches since the count was last reset (CUDA tensors only), and
#: how many of them were in float32
onehot_expand_rows.launches = 0
onehot_expand_rows.f32_launches = 0


# ---------------------------------------------------------------------------
# the kernels' per-row code on the host (csrc/host_rows.cpp): row checks
# without a card, and operation counts for the kernels' bounds
# ---------------------------------------------------------------------------

def _host_args(slots, ins):
    """float64 CPU copies of ``ins`` (absent names -> null) in slot order
    and the C array of their pointers."""
    keep = {s[0]: ins[s[0]].detach().to("cpu", torch.float64).contiguous()
            for s in slots if s is not None and s[0] in ins}
    return keep, _slot_ptrs(slots, keep)


def imu_rows_host(cfg, ins, cost_only=False, wide=False):
    """B4's CUDA row code compiled for the host, in float64: the same
    outputs as ``imu_rows`` (CPU tensors). Each row runs the kernel's lane
    group, one lane after another; ``wide`` runs its seeds in one
    full-width jet instead, as ``imu_rows_ops`` counts them."""
    from .build import load_host_library

    M = _check_imu_inputs(cfg, ins)
    keep, ptrs = _host_args(IMU_INPUTS, ins)
    r = torch.zeros(M, 3, dtype=torch.float64)
    J = torch.zeros(M, 3, imu_columns(cfg), dtype=torch.float64)
    load_host_library().kontiki_host_imu_rows_f64(
        ptrs, r.data_ptr(), J.data_ptr(), M, _imu_flags(cfg, cost_only), int(wide))
    return r if cost_only else (r, J)


def imu_rows_ops(cfg, ins, cost_only=False):
    """Floating-point operations B4's function needs on ``ins``, counted by
    running its row code on the host once per row in one full-width jet,
    with structural zeros and ones free (``csrc/host_rows.cpp``), in chunks
    of rows on parallel threads (``count_in_chunks``)."""
    from .build import load_host_library

    M = _check_imu_inputs(cfg, ins)
    fn = load_host_library().kontiki_count_imu_rows
    flags = _imu_flags(cfg, cost_only)
    host = {k: v.detach().to("cpu", torch.float64) for k, v in ins.items()}

    def count(a, b):
        keep, ptrs = _host_args(IMU_INPUTS, {k: v[:, a:b] for k, v in host.items()})
        return fn(ptrs, b - a, flags)

    return count_in_chunks(count, M, chunk=1 << 14)


def linearize_rows_host(cfg, ins, wide=False, lanes=False):
    """B1's CUDA row code compiled for the host, in float64; ``wide`` as
    for ``imu_rows_host``; ``lanes`` runs the kernel's schedule, each row's
    lane group one lane after another, stage by stage."""
    from .build import load_host_library

    M = _check_camera_inputs("linearize_rows", cfg, ins)
    keep, ptrs = _host_args(camera_inputs(cfg), ins)
    rdim, C = camera_shape(cfg)
    r = torch.zeros(M, rdim, dtype=torch.float64)
    J = torch.zeros(M, rdim, C, dtype=torch.float64)
    J_rho = torch.zeros(M, rdim, dtype=torch.float64)
    load_host_library().kontiki_host_linearize_rows_f64(
        ptrs, r.data_ptr(), J.data_ptr(), J_rho.data_ptr(), M, _camera_flags(cfg),
        2 if lanes else int(wide))
    return r, J, J_rho


def cost_rows_host(cfg, ins, lanes=False):
    """B3's CUDA row code compiled for the host, in float64, in the
    schedule of its one-row-per-thread kernel or, ``lanes``, of its lane
    kernel (each row's lane group one lane after another, stage by
    stage)."""
    from .build import load_host_library

    M = _check_camera_inputs("cost_rows", cfg, ins)
    keep, ptrs = _host_args(camera_inputs(cfg), ins)
    r = torch.zeros(M, camera_shape(cfg)[0], dtype=torch.float64)
    load_host_library().kontiki_host_cost_rows_f64(ptrs, r.data_ptr(), M, _camera_flags(cfg),
                                                   int(lanes))
    return r


def linearize_rows_ops(cfg, ins):
    """Floating-point operations B1's function needs on ``ins``, counted
    as ``imu_rows_ops`` counts B4's."""
    from .build import load_host_library

    M = _check_camera_inputs("linearize_rows", cfg, ins)
    keep, ptrs = _host_args(camera_inputs(cfg), ins)
    return load_host_library().kontiki_count_linearize_rows(ptrs, M, _camera_flags(cfg))


def cost_rows_ops(cfg, ins):
    """Floating-point operations B3's function needs on ``ins``: each row's
    chain once (knot pairs, tails, residual), counted as ``imu_rows_ops``
    counts B4's."""
    from .build import load_host_library

    M = _check_camera_inputs("cost_rows", cfg, ins)
    keep, ptrs = _host_args(camera_inputs(cfg), ins)
    return load_host_library().kontiki_count_cost_rows(ptrs, M, _camera_flags(cfg))


def newton_rows_host(cfg, ins, cost_only=False, wide=False, steps=False):
    """B8's CUDA row code compiled for the host, in float64: the same
    outputs as ``newton_rows`` (CPU tensors). Each row runs the kernel's
    lane group, one lane after another, stage by stage (any window width);
    ``wide`` runs one full-width jet a stage instead, as ``newton_rows_ops``
    counts it (windows of at most ``newton_wide_w()`` knots); ``cost_only``
    the cost-only kernel's chain. With ``steps``, the Newton
    steps each row took (int32 [M]) and the smallest margin of their
    convergence tests, ``|dt^2 - b| / b`` with ``b = (readout / (2
    rows))^2`` (float64 [M]), come last."""
    from .build import load_host_library

    M = _check_newton_inputs(cfg, ins)
    if wide and not cost_only:
        _check_newton_wide(cfg)
    keep, ptrs = _host_args(newton_inputs(cfg), ins)
    _, C = newton_shape(cfg)
    r = torch.zeros(M, 2, dtype=torch.float64)
    J = torch.zeros(M, 2, C, dtype=torch.float64)
    J_rho = torch.zeros(M, 2, dtype=torch.float64)
    n = torch.zeros(M, dtype=torch.int32)
    margin = torch.zeros(M, dtype=torch.float64)
    load_host_library().kontiki_host_newton_rows_f64(
        ptrs, r.data_ptr(), J.data_ptr(), J_rho.data_ptr(), n.data_ptr(), margin.data_ptr(), M,
        *_newton_ws(cfg), _newton_flags(cfg, cost_only), 1 if wide else 2)
    out = (r,) if cost_only else (r, J, J_rho)
    if steps:
        out += (n, margin)
    return out[0] if len(out) == 1 else out


def newton_rows_paths(cfg, ins):
    """Each row's Newton path as the linearize kernel's primal stage records
    it (its row code compiled for the host, float64): int32 [M, 4], the
    steps taken, the updates clamped at 0 and at the readout, and the steps
    whose obs sub-window bases differ from the step before."""
    from .build import load_host_library

    M = _check_newton_inputs(cfg, ins)
    keep, ptrs = _host_args(newton_inputs(cfg), ins)
    paths = torch.zeros(M, 4, dtype=torch.int32)
    load_host_library().kontiki_host_newton_paths_f64(ptrs, paths.data_ptr(), M,
                                                      *_newton_ws(cfg), _newton_flags(cfg))
    return paths


#: ``kontiki_count_newton_rows``' flag for the linearize kernel's own
#: schedule (host_rows.cpp kNewtonCountLanes)
_NEWTON_COUNT_SCHEDULE = 16


def newton_wide_w():
    """The widest window (knots a spline) whose chain the operation count and
    ``newton_rows_host(wide=True)`` run in one jet (newton_rows.cuh
    kNewtonLocalW, which the row-a-thread kernels' local windows share)."""
    from .build import load_host_library

    return load_host_library().kontiki_newton_local_w()


def _check_newton_wide(cfg):
    most = newton_wide_w()
    if max(cfg["Ws"]) > most:
        raise NotImplementedError(
            f"newton_rows: the one-jet chain takes windows of at most {most} knots, "
            f"got {cfg['Ws']!r}")


def newton_rows_ops(cfg, ins, cost_only=False, schedule=False):
    """Floating-point operations B8's function needs on ``ins``, counted by
    running its row code on the host once per row, one full-width jet a
    stage (the ref window's 25 seeds, the chain's NS), with structural
    zeros and ones free; ``cost_only``: its cost-only form's chain;
    ``schedule``: the linearize kernel's own schedule (its lane group's
    stages: the primal path, the local tiles' jets, the chain), the work
    the kernel does rather than the function's. The function needs no
    more than the smaller of the two full counts, which the bound takes.
    Rows are counted in chunks in parallel threads."""
    from .build import load_host_library

    M = _check_newton_inputs(cfg, ins)
    if not (cost_only or schedule):
        _check_newton_wide(cfg)
    slots = newton_inputs(cfg)
    keep, _ = _host_args(slots, ins)
    fn = load_host_library().kontiki_count_newton_rows
    flags = _newton_flags(cfg, cost_only) | (
        _NEWTON_COUNT_SCHEDULE if schedule and not cost_only else 0)

    def count(a, b):
        part = {k: v[:, a:b].contiguous() for k, v in keep.items()}
        return fn(_slot_ptrs(slots, part), b - a, *_newton_ws(cfg), flags)

    return count_in_chunks(count, M, 256)


def _host_f64(x):
    return x.detach().to("cpu", torch.float64).contiguous()


def evaluate_windows_host(kind, windows, u, dt):
    """B5's CUDA row code compiled for the host, in float64: the same
    outputs as ``evaluate_windows`` (CPU tensors)."""
    from .build import load_host_library

    M = _check_eval_inputs(kind, windows, u)
    w, uu = _host_f64(windows), _host_f64(u)
    outs = tuple(torch.zeros(M, k, dtype=torch.float64) for k in EVAL_OUTPUTS[kind])
    ptrs = (ctypes.c_void_p * len(outs))(*[o.data_ptr() for o in outs])
    load_host_library().kontiki_host_eval_windows_f64(
        _EVAL_KIND[kind], w.data_ptr(), uu.data_ptr(), float(dt), ptrs, M)
    return outs


def count_in_chunks(count, n, chunk=1 << 16):
    """Sum of ``count(start, stop)`` over chunks of ``range(n)``, run in
    parallel threads (the host library's counter is per thread and ctypes
    releases the GIL during the call)."""
    spans = [(i, min(i + chunk, n)) for i in range(0, n, chunk)]
    with ThreadPoolExecutor(max_workers=os.cpu_count() or 1) as pool:
        return sum(pool.map(lambda s: count(*s), spans))


def evaluate_windows_ops(kind, windows, u, dt):
    """Floating-point operations B5's function needs on these queries,
    counted by running its row code on the host once per query
    (``csrc/host_rows.cpp``)."""
    from .build import load_host_library

    _check_eval_inputs(kind, windows, u)
    w, uu = _host_f64(windows), _host_f64(u)
    fn = load_host_library().kontiki_count_eval_windows
    n = 4 * EVAL_KNOT_DIM[kind]
    return count_in_chunks(
        lambda a, b: fn(_EVAL_KIND[kind], w.data_ptr() + 8 * n * a, uu.data_ptr() + 8 * a,
                        float(dt), b - a), w.shape[0])
