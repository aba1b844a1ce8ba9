"""Batched residual / Jacobian terms, bounds, retraction and the dense
solver parts (counterpart of ``kontiki_tpu.solver.kernels``).

- Camera rows (``rs_static`` and ``rs_lifting``, on a pinhole or an atan
  camera, on an SE3 spline or a split R3 + SO3 trajectory) gather their
  4-knot windows and row constants into the transposed ``[k, M]`` layout
  and run kernel B1 (``ops.linearize_kernels.linearize_rows``); their cost
  alone runs kernel B3 (``cost_rows``) on the same inputs. A lifting row's
  observed window is evaluated at ``t0_obs + d + vt readout`` and its
  Jacobian carries the ``vt`` column last.
- Newton rolling-shutter rows (``rs_newton``, on a pinhole or an atan
  camera, on an SE3 spline or a split R3 + SO3 trajectory) gather their
  ``W``-knot readout-slack windows (the Newton time moves within the
  readout) with the obs side at the frame start, and run kernel B8
  (``ops.linearize_kernels.newton_rows``), whose cost-only form the re-cost
  runs.
- Gyro and accel rows on an SO3 spline or a split R3 + SO3 trajectory do
  the same for kernel B4 (``ops.linearize_kernels.imu_rows``), which also
  has the cost-only form the re-cost uses.
- Gyro and accel rows on the SE3 spline, and position and orientation rows
  on every spline kind, take the generic path: forward mode over the
  per-row tangent increments with ``torch.func.vmap(torch.func.jacfwd)``,
  as the JAX package keeps them on its generic path; their cost alone is
  the same residual function at zero increments under ``torch.func.vmap``.
  Each row's knot window is gathered before the differentiated function,
  so ``jacfwd`` sees only the deltas.
- Locks are masks over tangent columns, applied after assembly. R3 knots
  retract additively, SO3 knots by left-multiplied ``exp``, SE3 knots by
  right-multiplied ``exp`` (Sophus ``T * exp(x)``), sensor orientations by
  left-multiplied ``exp``. Bounds are kept by projection: rho >= 0,
  |d| <= max_time_offset, vt in [0, 1].
- Huber loss follows Ceres: cost ``0.5 * sum(rho(|r|^2))`` and IRLS weights
  ``rho'(s)`` on the normal equations.
"""
from typing import NamedTuple, Tuple

import torch

from ..constants import GRAVITY
from ..math import quaternion as quat
from ..math import se3 as se3m
from ..ops.linearize_kernels import cost_rows, imu_rows, linearize_rows, newton_rows
from ..trajectories import spline_eval as ev
from .problem import SENSOR_TANGENT_DIM, TANGENT_DIMS


class SplineSpec(NamedTuple):
    kind: str  # 'r3' | 'so3' | 'se3'
    n: int
    tangent_offset: int


class BucketSpec(NamedTuple):
    kind: str  # 'position' | 'orientation' | 'gyro' | 'accel' | 'rs_static' | 'rs_newton'
    # | 'rs_lifting'
    camera: str  # '' | 'PinholeCamera' | 'AtanCamera'
    M: int
    rdim: int
    windows: Tuple[int, ...]  # W per spline, aligned with ProblemSpec.splines


class ProblemSpec(NamedTuple):
    splines: Tuple[SplineSpec, ...]
    buckets: Tuple[BucketSpec, ...]
    num_tangent: int
    sensor_offset: int
    landmark_offset: int
    num_sensors: int
    num_landmarks: int
    vt_offset: int = 0
    num_vt: int = 0


def retract_window(kind, win, delta):
    """Apply tangent increments [..., td] to knots [..., D]: R3 additive,
    SO3 left ``exp(w) q``, SE3 right ``(q exp(w), t + R(q) V(w) v)``."""
    if kind == "r3":
        return win + delta
    if kind == "so3":
        return quat.qmul(se3m.so3_exp_quat(delta), win)
    if kind != "se3":
        raise ValueError(kind)
    q, t = se3m.se3_unpack(win)
    dq, dt = se3m.se3_exp(delta)
    return se3m.se3_pack(quat.qmul(q, dq), t + quat.qrotate(q, dt))


#: the camera-row bucket kinds of kernels B1 and B3
CAMERA_KINDS = ("rs_static", "rs_lifting")
#: the bucket kinds with a landmark column and the Huber loss: B1/B3's and
#: the Newton rows (kernel B8)
LANDMARK_KINDS = CAMERA_KINDS + ("rs_newton",)


def _spline_n_eval(runtime, si, sp):
    """Clamp bound of spline ``si``'s window bases: its knot count, except
    where the runtime names another (``spline_n_eval``): the segment-BA
    layout's local knot arrays run past the real spline end into pad knots,
    and out-of-range times must still take the real spline's last window."""
    ne = runtime.get("spline_n_eval")
    return ne[si] if ne is not None else sp.n


# ---------------------------------------------------------------------------
# camera rows: kernels B1 and B3
# ---------------------------------------------------------------------------

def _camera_inputs(spec, runtime, state, data):
    """Gather + transpose camera rows for B1 and B3. Returns ``(cfg, ins,
    i0s)``: the kernels' configuration (window ``kind``, ``r3_first``,
    ``camera``, ``lifting``, ``rdim``, ``C``, as the JAX package's), the
    [k, M] input dict and the window base indices ``{"ref": [per spline],
    "obs": [per spline]}``.

    SE3 windows are ``win_{tag}`` [28] with ``u_{tag}``; split windows are
    ``win_{tag}_r3`` [12] with ``u_{tag}`` and ``win_{tag}_so3`` [16] with
    ``u_{tag}_so3``, each on its own spline's ``t0``/``dt``; ``dts`` holds
    the SE3 spacing, or the (R3, SO3) spacings whatever the spline order.
    The bucket's data say its camera and rows: ``wc`` and ``gamma`` come
    with an atan camera, ``vt_idx`` and ``vt_orig`` with lifting rows,
    whose observed time is ``t0_obs + d + vt readout``."""
    atan = "wc" in data
    lifting = "vt_idx" in data
    d = state["d"][data["sid"]]
    row_delta = data["readout"] / data["rows"]
    if lifting:
        vt0 = state["vt"][data["vt_idx"]]
        t_obs = data["t0_obs"] + d + vt0 * data["readout"]
    else:
        t_obs = data["t0_obs"] + d + data["v_obs"] * row_delta
    times = {"ref": data["t0_ref"] + d + data["v_ref"] * row_delta, "obs": t_obs}
    kinds = tuple(sp.kind for sp in spec.splines)
    se3 = kinds == ("se3",)
    if not se3 and sorted(kinds) != ["r3", "so3"]:
        raise NotImplementedError(f"camera rows on splines {list(kinds)}")
    M = d.shape[0]
    ins, i0s = {}, {"ref": [], "obs": []}
    for si, sp in enumerate(spec.splines):
        t0, dt = runtime["spline_t0"][si], runtime["spline_dt"][si]
        for tag, t in times.items():
            # window base: floor on the primal, clamped to [0, n_eval - 4]
            i0, u = ev.index_and_u(t, t0, dt, _spline_n_eval(runtime, si, sp))
            suffix = "" if se3 else f"_{sp.kind}"
            win = ev.gather_windows(state[sp.kind], i0)
            ins[f"win_{tag}{suffix}"] = win.reshape(M, -1).T.contiguous()
            ins[f"u_{tag}" + ("_so3" if sp.kind == "so3" else "")] = u[None, :].contiguous()
            i0s[tag].append(i0)
    _row_constants(ins, spec, runtime, state, data)
    if lifting:
        ins["vt0"] = vt0[None, :].contiguous()
        for name in ("vt_orig", "rows", "readout"):
            ins[name] = data[name][None, :].contiguous()
    cfg = dict(kind="se3" if se3 else "split", r3_first=not se3 and kinds[0] == "r3",
               camera="AtanCamera" if atan else "PinholeCamera", lifting=lifting,
               rdim=3 if lifting else 2, C=62 if lifting else 61)
    return cfg, ins, i0s


def _row_constants(ins, spec, runtime, state, data):
    """Add the camera rows' [k, M] constants to ``ins`` (B1, B3 and B8): the
    knot spacings ``dts`` (SE3, or R3 then SO3), the sensor pose, inverse
    depth, reference ray, observation, weight and ``K``; ``wc`` and
    ``gamma`` of an atan camera; ``valid`` where the bucket has it."""
    kinds = tuple(sp.kind for sp in spec.splines)
    sid, M = data["sid"], data["sid"].shape[0]
    opts = dict(dtype=data["weight"].dtype, device=sid.device)
    dts = [runtime["spline_dt"][kinds.index(k)]
           for k in (("se3",) if kinds == ("se3",) else ("r3", "so3"))]
    ins["dts"] = torch.tensor(dts, **opts)[:, None].expand(len(dts), M).contiguous()
    ins["q_ct"] = state["q_ct"][sid].T.contiguous()
    ins["p_ct"] = state["p_ct"][sid].T.contiguous()
    ins["rho"] = state["rho"][data["lid"]][None, :].contiguous()
    ins["yh_ref"] = data["yh_ref"].T.contiguous()
    ins["uv_obs"] = data["uv_obs"].T.contiguous()
    ins["weight"] = data["weight"][None, :].contiguous()
    ins["K"] = data["K"].reshape(M, 9).T.contiguous()
    if "wc" in data:
        ins["wc"] = data["wc"].T.contiguous()
        ins["gamma"] = data["gamma"][None, :].contiguous()
    if "valid" in data:
        ins["valid"] = data["valid"][None, :].contiguous()


def _camera_rows(spec, runtime, state, data):
    """(r [M, rdim], J [M, rdim, C], cols [M, C], J_rho [M, rdim]) of the
    camera rows; columns are [ref windows, obs windows (each in spline
    order), sensor, vt (lifting rows)] as in the JAX package."""
    cfg, ins, i0s = _camera_inputs(spec, runtime, state, data)
    r, J, J_rho = linearize_rows(cfg, ins)
    sid = data["sid"]
    cols = [
        sp.tangent_offset + i0[:, None] * TANGENT_DIMS[sp.kind]
        + torch.arange(4 * TANGENT_DIMS[sp.kind], device=sid.device)
        for tag in ("ref", "obs") for sp, i0 in zip(spec.splines, i0s[tag])
    ]
    cols.append(spec.sensor_offset + sid[:, None] * SENSOR_TANGENT_DIM
                + torch.arange(SENSOR_TANGENT_DIM, device=sid.device))
    if cfg["lifting"]:
        cols.append((spec.vt_offset + data["vt_idx"])[:, None])
    return r, J, torch.cat(cols, dim=1), J_rho


# ---------------------------------------------------------------------------
# Newton rolling-shutter rows: kernel B8
# ---------------------------------------------------------------------------

def _newton_inputs(spec, bspec, runtime, state, data):
    """Gather + transpose Newton rows for B8 (the JAX package's
    ``_fused_newton_inputs``). Returns ``(cfg, ins, i0s)``: the kernel's
    configuration (``kind``, ``r3_first``, ``camera``, ``rdim``, ``Ct``,
    ``C = 2 Ct + 13``, ``Ws``), the [k, M] input dict and the window base
    indices ``{"ref": [per spline], "obs": [per spline]}``.

    Each side gathers its bucket's ``W``-knot windows at the frame start
    ``t0 + d`` (clamped to [0, n_eval - W]); the ref side's ``u`` is at its
    row time ``t0_ref + d + v_ref readout / rows``, the obs side's at the
    frame start (the kernel adds the Newton row time). Names as
    ``_camera_inputs``'s, plus ``v_obs``, ``rows`` and ``readout``."""
    d = state["d"][data["sid"]]
    row_delta = data["readout"] / data["rows"]
    t_base = {"ref": data["t0_ref"] + d, "obs": data["t0_obs"] + d}
    t_row = {"ref": t_base["ref"] + data["v_ref"] * row_delta, "obs": t_base["obs"]}
    kinds = tuple(sp.kind for sp in spec.splines)
    se3 = kinds == ("se3",)
    if not se3 and sorted(kinds) != ["r3", "so3"]:
        raise NotImplementedError(f"Newton rows on splines {list(kinds)}")
    M = d.shape[0]
    opts = dict(dtype=d.dtype, device=d.device)
    ins, i0s = {}, {"ref": [], "obs": []}
    Ct = 0
    for si, sp in enumerate(spec.splines):
        W = bspec.windows[si]
        Ct += W * TANGENT_DIMS[sp.kind]
        t0 = runtime["spline_t0"][si]
        dt = torch.full((), runtime["spline_dt"][si], **opts)
        knots = state[sp.kind]
        for tag in ("ref", "obs"):
            # window base: floor on the primal at the frame start
            i0 = torch.clamp(torch.floor((t_base[tag] - t0) / dt).long(), 0,
                             _spline_n_eval(runtime, si, sp) - W)
            u = (t_row[tag] - t0) / dt - i0.to(d.dtype)
            idx = torch.clamp(i0[:, None] + torch.arange(W, device=d.device), 0,
                              knots.shape[0] - 1)
            suffix = "" if se3 else f"_{sp.kind}"
            ins[f"win_{tag}{suffix}"] = knots[idx].reshape(M, -1).T.contiguous()
            ins[f"u_{tag}" + ("_so3" if sp.kind == "so3" else "")] = u[None, :].contiguous()
            i0s[tag].append(i0)
    _row_constants(ins, spec, runtime, state, data)
    for name in ("v_obs", "rows", "readout"):
        ins[name] = data[name][None, :].contiguous()
    cfg = dict(kind="se3" if se3 else "split", r3_first=not se3 and kinds[0] == "r3",
               camera="AtanCamera" if "wc" in data else "PinholeCamera", rdim=2, Ct=Ct,
               C=2 * Ct + SENSOR_TANGENT_DIM, Ws=tuple(bspec.windows))
    return cfg, ins, i0s


def _newton_rows(spec, bspec, runtime, state, data, cost_only=False):
    """(r [M, 2], J [M, 2, C], cols [M, C], J_rho [M, 2]) of Newton rows
    through B8, columns [ref windows, obs windows (each in spline order),
    sensor] as in the JAX package's ``_newton_rows_fused``; ``r`` alone
    with ``cost_only``."""
    cfg, ins, i0s = _newton_inputs(spec, bspec, runtime, state, data)
    if cost_only:
        return newton_rows(cfg, ins, cost_only=True)
    r, J, J_rho = newton_rows(cfg, ins)
    sid = data["sid"]
    cols = [
        sp.tangent_offset + i0[:, None] * TANGENT_DIMS[sp.kind]
        + torch.arange(W * TANGENT_DIMS[sp.kind], device=sid.device)
        for tag in ("ref", "obs")
        for sp, i0, W in zip(spec.splines, i0s[tag], bspec.windows)
    ]
    cols.append(spec.sensor_offset + sid[:, None] * SENSOR_TANGENT_DIM
                + torch.arange(SENSOR_TANGENT_DIM, device=sid.device))
    return r, J, torch.cat(cols, dim=1), J_rho


# ---------------------------------------------------------------------------
# IMU rows on SO3 / split splines: kernel B4
# ---------------------------------------------------------------------------

def _fused_imu_enabled(spec, bspec):
    """Whether kernel B4 covers this bucket: gyro/accel rows over ('so3',)
    or split ('r3', 'so3') splines with 4-knot windows. Accel rows need the
    R3 spline (the TPU kernel has no R3 window without one)."""
    if bspec.kind not in ("gyro", "accel"):
        return False
    kinds = tuple(sp.kind for sp in spec.splines)
    if kinds != ("so3",) and sorted(kinds) != ["r3", "so3"]:
        return False
    if bspec.kind == "accel" and kinds == ("so3",):
        return False
    return all(w == 4 for w in bspec.windows)


def _imu_inputs(spec, bspec, runtime, state, data):
    """Gather + transpose IMU rows for B4. Returns ``(cfg, ins, i0s)``: the
    kernel's configuration, the [k, M] input dict and the window base index
    per spline (windows re-center on the current time offset)."""
    M = data["t"].shape[0]
    te = data["t"] + state["d"][data["sid"]]
    kinds = tuple(sp.kind for sp in spec.splines)
    ins, i0s = {}, []
    for si, sp in enumerate(spec.splines):
        t0, dt = runtime["spline_t0"][si], runtime["spline_dt"][si]
        i0, u = ev.index_and_u(te, t0, dt, _spline_n_eval(runtime, si, sp))
        win = ev.gather_windows(state[sp.kind], i0)
        i0s.append(i0)
        ins[f"win_{sp.kind}"] = win.reshape(M, -1).T.contiguous()
        ins[f"u_{sp.kind}"] = u[None, :].contiguous()
        ins[f"dts_{sp.kind}"] = torch.full((1, M), dt, dtype=te.dtype, device=te.device)
    ins["y"] = data["y"].T.contiguous()
    ins["weight"] = data["weight"][None, :].contiguous()
    bias = state["gbias" if bspec.kind == "gyro" else "abias"]
    ins["bias"] = bias[data["sid"]].T.contiguous()
    if "valid" in data:
        ins["valid"] = data["valid"][None, :].contiguous()
    so3_only = kinds == ("so3",)
    cfg = dict(kind=bspec.kind, so3_only=so3_only,
               r3_first=not so3_only and kinds[0] == "r3")
    return cfg, ins, i0s


def _imu_rows_fused(spec, bspec, runtime, state, data, cost_only=False):
    """(r [M,3], J [M,3,C], cols [M,C]) of gyro/accel rows through B4 with
    columns [spline windows in spline order, sensor]; ``r`` alone with
    ``cost_only``."""
    cfg, ins, i0s = _imu_inputs(spec, bspec, runtime, state, data)
    if cost_only:
        return imu_rows(cfg, ins, cost_only=True)
    r, J = imu_rows(cfg, ins)
    sid = data["sid"]
    cols = [
        sp.tangent_offset + i0[:, None] * TANGENT_DIMS[sp.kind]
        + torch.arange(4 * TANGENT_DIMS[sp.kind], device=sid.device)
        for sp, i0 in zip(spec.splines, i0s)
    ]
    cols.append(spec.sensor_offset + sid[:, None] * SENSOR_TANGENT_DIM
                + torch.arange(SENSOR_TANGENT_DIM, device=sid.device))
    return r, J, torch.cat(cols, dim=1)


# ---------------------------------------------------------------------------
# IMU rows on the SE3 spline: generic forward mode
# ---------------------------------------------------------------------------

def _imu_residual(kind, t0, dt, gravity):
    """residual(delta [4*td + 13], win [1, 4, 7], i_base [1], t [1], y [1, 3],
    weight [1], d [1], ab [1, 3], gb [1, 3]) -> r [1, 3] for one gyro/accel
    row (``i_base`` as a float); the row's values keep a batch of one (see
    ``_vmap_rows``).

    ``delta`` holds the window knots' tangent increments, then the sensor
    slots; only the time offset and the biases reach an IMU residual."""

    def residual(delta, win, i_base, t, y, weight, d0, ab0, gb0):
        sens = delta[24:]
        sub = retract_window("se3", win, delta[:24].reshape(1, 4, 6))
        # a 4-knot window at the segment base: u = s - i_base
        u = (t + (d0 + sens[6:7]) - t0) / dt - i_base
        _, _, a, q, w = ev.se3_window(sub, u, dt)
        q_conj = quat.qconj(q)
        if kind == "gyro":
            body = quat.qrotate(q_conj, w) + (gb0 + sens[10:13])
        else:
            body = quat.qrotate(q_conj, a + gravity) + (ab0 + sens[7:10])
        return weight[:, None] * (y - body)

    return residual


def _vmap_rows(f, args, cost_only):
    """``f`` over the rows of ``args`` (the first the tangent increments
    ``[M, C]``, each other ``[M, ...]``): ``r [M, rdim]``, and with
    ``cost_only`` false ``J [M, rdim, C]`` by forward mode. Every argument
    but the first keeps a batch of one in ``f``: ``torch.func.jvp`` takes the
    tangent of a 0-dim float32 tensor times a Python float as float64, and
    the rows' scalars (their times, the interpolation amount) would be 0-dim
    under ``vmap``."""
    def batch_of_one(a):
        return tuple(map(batch_of_one, a)) if isinstance(a, tuple) else a[:, None]

    delta, rest = args[0], batch_of_one(args[1:])
    if cost_only:
        return torch.func.vmap(f)(delta, *rest)[:, 0]

    def row(d, *r):
        out = f(d, *r)[0]
        return out, out

    J, r = torch.func.vmap(torch.func.jacfwd(row, has_aux=True))(delta, *rest)
    return r, J


def _imu_rows(spec, bspec, runtime, state, data, cost_only=False):
    """(r [M,3], J [M,3,37], cols [M,37]) of gyro/accel rows over the SE3
    spline: window tangents (24), then the sensor block (13). With
    ``cost_only``, ``r`` alone: the residual function at zero increments,
    with no Jacobian (the JAX ``row_fn`` with ``with_jac=False``)."""
    (sp,) = spec.splines
    (W,) = bspec.windows
    if W != 4:
        raise NotImplementedError(f"IMU rows need 4-knot windows, got {W}")
    t0, dt = runtime["spline_t0"][0], runtime["spline_dt"][0]
    sid = data["sid"]
    d0 = state["d"][sid]
    # window base from the current time offset (windows re-center each
    # linearization), floor on the primal
    i_base = torch.clamp(torch.floor((data["t"] + d0 - t0) / dt).long(), 0,
                         _spline_n_eval(runtime, 0, sp) - W)
    knots = state[sp.kind]
    win = ev.gather_windows(knots, i_base)
    gravity = torch.as_tensor(GRAVITY, dtype=knots.dtype, device=knots.device)
    f = _imu_residual(bspec.kind, t0, dt, gravity)
    M = sid.shape[0]
    C = 4 * TANGENT_DIMS[sp.kind] + SENSOR_TANGENT_DIM
    zeros = torch.zeros(M, C, dtype=knots.dtype, device=knots.device)
    args = (zeros, win, i_base.to(knots.dtype), data["t"], data["y"], data["weight"], d0,
            state["abias"][sid], state["gbias"][sid])
    if cost_only:
        return _vmap_rows(f, args, True)
    r, J = _vmap_rows(f, args, False)
    td = TANGENT_DIMS[sp.kind]
    cols = torch.cat(
        [
            sp.tangent_offset + i_base[:, None] * td
            + torch.arange(4 * td, device=sid.device),
            spec.sensor_offset + sid[:, None] * SENSOR_TANGENT_DIM
            + torch.arange(SENSOR_TANGENT_DIM, device=sid.device),
        ],
        dim=1,
    )
    return r, J, cols


# ---------------------------------------------------------------------------
# position and orientation rows: generic forward mode
# ---------------------------------------------------------------------------

def _angular_distance(q_meas, q_hat):
    """Eigen's angularDistance of wxyz quaternions: 2 atan2(|vec d|, |w d|),
    d = q_meas^-1 q_hat, with |vec d| kept off 0 for its derivative."""
    d = quat.qmul(quat.qconj(q_meas), q_hat)
    v2 = torch.sum(d[..., 1:] * d[..., 1:], dim=-1)
    vn = torch.sqrt(torch.where(v2 < 1e-300, 1e-300, v2))
    return 2.0 * torch.atan2(vn, torch.abs(d[..., 0]))


def _pose_residual(kind, kinds, t0s, dts):
    """residual(delta, wins, i_bases, t, y) -> r [1, rdim] for one position
    (``y - p``) or orientation (``angular_distance(y, q)``) row, the row's
    values with a batch of one (``_vmap_rows``).

    ``delta`` holds each spline's window tangent increments in spline
    order; ``wins`` the 4-knot windows and ``i_bases`` their base indices
    (as floats). A trajectory without an R3 or SE3 spline has position 0,
    one without an SO3 or SE3 spline the identity orientation."""

    def residual(delta, wins, i_bases, t, y):
        p = torch.zeros(3, dtype=delta.dtype, device=delta.device)
        q = torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=delta.dtype, device=delta.device)
        off = 0
        for k, win, i_base, t0, dt in zip(kinds, wins, i_bases, t0s, dts):
            td = TANGENT_DIMS[k]
            sub = retract_window(k, win, delta[off:off + 4 * td].reshape(1, 4, td))
            off += 4 * td
            u = (t - t0) / dt - i_base
            if k == "r3":
                p = ev.r3_window(sub, u, dt)[0]
            elif k == "so3":
                q = ev.so3_window(sub, u, dt)[0]
            else:
                p, _, _, q, _ = ev.se3_window(sub, u, dt)
        if kind == "position":
            return y - p
        return _angular_distance(y, q)[..., None]

    return residual


def _pose_rows(spec, bspec, runtime, state, data, cost_only=False):
    """(r [M, rdim], J [M, rdim, C], cols [M, C]) of position (rdim 3) or
    orientation (rdim 1) rows: the window tangents of every spline in
    spline order (C = sum of 4 td); ``r`` alone with ``cost_only``."""
    t = data["t"]
    kinds = tuple(sp.kind for sp in spec.splines)
    wins, i_bases, cols = [], [], []
    for si, sp in enumerate(spec.splines):
        W = bspec.windows[si]
        if W != 4:
            raise NotImplementedError(f"pose rows need 4-knot windows, got {W}")
        t0, dt = runtime["spline_t0"][si], runtime["spline_dt"][si]
        td = TANGENT_DIMS[sp.kind]
        i_base = torch.clamp(torch.floor((t - t0) / dt).long(), 0,
                             _spline_n_eval(runtime, si, sp) - W)
        wins.append(ev.gather_windows(state[sp.kind], i_base))
        i_bases.append(i_base.to(t.dtype))
        cols.append(sp.tangent_offset + i_base[:, None] * td
                    + torch.arange(4 * td, device=t.device))
    f = _pose_residual(bspec.kind, kinds, runtime["spline_t0"], runtime["spline_dt"])
    C = sum(4 * TANGENT_DIMS[k] for k in kinds)
    args = (torch.zeros(t.shape[0], C, dtype=t.dtype, device=t.device), tuple(wins),
            tuple(i_bases), t, data["y"])
    if cost_only:
        return _vmap_rows(f, args, True)
    r, J = _vmap_rows(f, args, False)
    return r, J, torch.cat(cols, dim=1)


def bucket_terms(spec, bspec, runtime, state, data, cost_only=False):
    """``(r, J, cols, J_rho or None)`` of one bucket, landmark column split
    off (the Schur path's form); with ``cost_only``, ``r [M, rdim]`` alone
    and no Jacobian: camera rows through B3, SO3/split IMU rows through
    B4's cost-only form, SE3 IMU rows and pose rows through their residual
    function at zero increments; Newton rows through B8 and its cost-only
    form. Rows with ``valid`` 0 (the segment layout's padding) give zeros.
    """
    kinds = [sp.kind for sp in spec.splines]
    if bspec.kind in CAMERA_KINDS:
        if cost_only:
            return cost_rows(*_camera_inputs(spec, runtime, state, data)[:2])
        return _camera_rows(spec, runtime, state, data)
    if bspec.kind == "rs_newton":
        return _newton_rows(spec, bspec, runtime, state, data, cost_only=cost_only)
    if bspec.kind in ("position", "orientation"):
        out = _pose_rows(spec, bspec, runtime, state, data, cost_only=cost_only)
    elif _fused_imu_enabled(spec, bspec):
        out = _imu_rows_fused(spec, bspec, runtime, state, data, cost_only=cost_only)
    elif bspec.kind in ("gyro", "accel") and kinds == ["se3"]:
        out = _imu_rows(spec, bspec, runtime, state, data, cost_only=cost_only)
    else:
        raise NotImplementedError(f"bucket kind {bspec.kind!r} on splines {kinds}")
    if "valid" in data and not _fused_imu_enabled(spec, bspec):
        # padded rows of the segment layout (valid 0) contribute nothing, as
        # B1, B3, B4 and B8 do with their valid input
        v = data["valid"]
        out = out * v[:, None] if cost_only else (
            out[0] * v[:, None], out[1] * v[:, None, None], out[2])
    return out if cost_only else (*out, None)


# ---------------------------------------------------------------------------
# robust loss (Huber, Ceres semantics: sqrt(rho') whitening everywhere)
# ---------------------------------------------------------------------------

def _huber(s, c):
    b = c * c
    return torch.where(s <= b, s, 2.0 * c * torch.sqrt(torch.maximum(s, b)) - b)


def _huber_prime(s, c):
    b = c * c
    return torch.where(s <= b, 1.0, c / torch.sqrt(torch.maximum(s, b)))


def _bucket_cost(bspec, data, r):
    """``(cost, rho')`` of one bucket's residuals: 0.5 sum rho(|r|^2), Huber
    on camera rows, Newton rows included (Ceres semantics, over the whole
    residual block), plain squares elsewhere."""
    s = torch.sum(r * r, dim=-1)
    if bspec.kind in LANDMARK_KINDS:
        c = data["huber_c"]
        return 0.5 * torch.sum(_huber(s, c)), _huber_prime(s, c)
    return 0.5 * torch.sum(s), torch.ones_like(s)


def total_cost(spec, runtime, state):
    """The problem's cost at ``state`` from every bucket's residuals alone
    (``bucket_terms(..., cost_only=True)``): the re-cost of the dense and
    Schur strategies."""
    mask = runtime["mask"]
    cost = torch.zeros((), dtype=mask.dtype, device=mask.device)
    for bspec, data in zip(spec.buckets, runtime["data"]):
        r = bucket_terms(spec, bspec, runtime, state, data, cost_only=True)
        cost = cost + _bucket_cost(bspec, data, r)[0]
    return cost


# ---------------------------------------------------------------------------
# bounds, projection and retraction
# ---------------------------------------------------------------------------

def project_delta(spec, runtime, state, delta):
    """Clip bound-constrained tangent components (rho >= 0,
    |d| <= max_time_offset, vt in [0, 1]) to the increment the retraction
    will apply.

    LM's predicted reduction must come from this projected step: with a
    landmark at the rho = 0 bound and an outward gradient the raw step
    predicts a decrease the projection never realizes, and the trust region
    collapses."""
    delta = delta.clone()
    S, L = spec.num_sensors, spec.num_landmarks
    if S:
        off = spec.sensor_offset
        idx = off + torch.arange(S, device=delta.device) * SENSOR_TANGENT_DIM + 6
        d_new = torch.clamp(state["d"] + delta[idx], -runtime["d_max"], runtime["d_max"])
        delta[idx] = d_new - state["d"]
    if L:
        lo = spec.landmark_offset
        dl = delta[lo:lo + L]
        delta[lo:lo + L] = torch.clamp(state["rho"] + dl, min=0.0) - state["rho"]
    V = spec.num_vt
    if V:
        vo = spec.vt_offset
        dv = delta[vo:vo + V]
        delta[vo:vo + V] = torch.clamp(state["vt"] + dv, 0.0, 1.0) - state["vt"]
    return delta


def landmark_free_mask(state_rho, g_l, mask_l):
    """Bound active set: freeze landmarks at the rho = 0 bound whose
    gradient pushes outward (the projected-gradient treatment Ceres applies
    to the same bound, static_rscamera_measurement.h:180)."""
    at_bound = state_rho <= 0.0
    outward = g_l > 0.0  # descent direction -g_l points negative
    return mask_l * (1.0 - (at_bound & outward).to(mask_l.dtype))


def damped_solve(mask, H, g, lam):
    """LM-damped masked normal-equation solve (Ceres diagonal clamping)."""
    D = torch.clamp(torch.diagonal(H), 1e-6, 1e32)
    A = H + lam * torch.diag(D) + torch.diag(1.0 - mask)
    return -torch.linalg.solve(A, g) * mask


def _retract_state(spec, runtime, state, delta):
    """Apply a masked global tangent step to the state dict; bounds
    (rho >= 0, |d| <= max_time_offset, vt in [0, 1]; reference
    static_rscamera_measurement.h:180, sensors.h:158-160,
    lifting_rscamera_measurement.h:199-204) are enforced by projection."""
    delta = delta * runtime["mask"]
    new = dict(state)
    for sp in spec.splines:
        td = TANGENT_DIMS[sp.kind]
        blk = delta[sp.tangent_offset: sp.tangent_offset + sp.n * td]
        new[sp.kind] = retract_window(sp.kind, state[sp.kind], blk.reshape(sp.n, td))
    S = spec.num_sensors
    if S:
        off = spec.sensor_offset
        sens = delta[off: off + S * SENSOR_TANGENT_DIM].reshape(S, SENSOR_TANGENT_DIM)
        new["q_ct"] = quat.qmul(se3m.so3_exp_quat(sens[:, 0:3]), state["q_ct"])
        new["p_ct"] = state["p_ct"] + sens[:, 3:6]
        new["d"] = torch.clamp(
            state["d"] + sens[:, 6], -runtime["d_max"], runtime["d_max"]
        )
        new["abias"] = state["abias"] + sens[:, 7:10]
        new["gbias"] = state["gbias"] + sens[:, 10:13]
    L = spec.num_landmarks
    if L:
        lo = spec.landmark_offset
        new["rho"] = torch.clamp(state["rho"] + delta[lo:lo + L], min=0.0)
    V = spec.num_vt
    if V:
        vo = spec.vt_offset
        new["vt"] = torch.clamp(state["vt"] + delta[vo:vo + V], 0.0, 1.0)
    return new


# ---------------------------------------------------------------------------
# dense strategy (JAX ``build_parts`` with ASSEMBLY == "dense")
# ---------------------------------------------------------------------------

def build_parts(spec):
    """Dense solver functions: ``total_cost(runtime, state)``,
    ``linearize(runtime, state) -> (cost, H, g)``, ``retract``,
    ``solve_from_lin``, ``grad_max(state, g)`` and ``step(runtime, state,
    lam) -> (cost, new_state, new_cost, pred, delta, grad_max)`` (the
    classic LM step: linearize, damped solve, retract, re-cost)."""
    P = spec.num_tangent
    L, lo = spec.num_landmarks, spec.landmark_offset

    def linearize(runtime, state):
        mask = runtime["mask"]
        H = torch.zeros(P, P, dtype=mask.dtype, device=mask.device)
        g = torch.zeros(P, dtype=mask.dtype, device=mask.device)
        cost = torch.zeros((), dtype=mask.dtype, device=mask.device)
        for bspec, data in zip(spec.buckets, runtime["data"]):
            r, J, cols, J_rho = bucket_terms(spec, bspec, runtime, state, data)
            if J_rho is not None:  # the landmark column joins the row
                J = torch.cat([J, J_rho[..., None]], dim=-1)
                cols = torch.cat([cols, (lo + data["lid"])[:, None]], dim=1)
            c, rho_p = _bucket_cost(bspec, data, r)
            cost = cost + c
            # Scatter each row's whitened block into a dense [rdim, P] row
            # Jacobian (duplicate column ids add), then one GEMM for H, g.
            sq = torch.sqrt(rho_p)
            Jw = J * sq[:, None, None]
            rw = r * sq[:, None]
            M, rdim, C = Jw.shape
            Jd = torch.zeros(M, rdim, P, dtype=Jw.dtype, device=Jw.device)
            Jd.scatter_add_(2, cols[:, None, :].expand(M, rdim, C), Jw)
            Jd = Jd.reshape(M * rdim, P)
            H = H + Jd.T @ Jd
            g = g + Jd.T @ rw.reshape(-1)
        # lock masking after assembly: (J diag(m))^T (J diag(m)) = m m^T o J^T J
        H = H * (mask[:, None] * mask[None, :])
        g = g * mask
        return cost, H, g

    def retract(runtime, state, delta):
        return _retract_state(spec, runtime, state, delta)

    def free_landmarks(state, g):
        """1 where a column takes part in this step, 0 for the rho = 0
        landmarks whose gradient points outward (frozen for the step)."""
        free = torch.ones_like(g)
        free[lo:lo + L] = landmark_free_mask(state["rho"], g[lo:lo + L],
                                             torch.ones_like(g[lo:lo + L]))
        return free

    def solve_from_lin(runtime, state, H, g, lam):
        """(projected delta, predicted cost reduction) from ``(H, g)``."""
        mask = runtime["mask"]
        if L:
            free = free_landmarks(state, g)
            H = H * free[:, None] * free[None, :]
            g = g * free
            mask = mask * free
        delta = project_delta(spec, runtime, state, damped_solve(mask, H, g, lam))
        return delta, -(g @ delta + 0.5 * delta @ (H @ delta))

    def grad_max(state, g):
        """max |g| over the columns the step sees (frozen landmarks 0)."""
        if L:
            g = g * free_landmarks(state, g)
        return g.abs().max() if P else g.new_zeros(())

    def step(runtime, state, lam):
        cost, H, g = linearize(runtime, state)
        delta, pred = solve_from_lin(runtime, state, H, g, lam)
        new_state = retract(runtime, state, delta)
        return (cost, new_state, total_cost(spec, runtime, new_state), pred, delta,
                grad_max(state, g))

    return dict(total_cost=lambda runtime, state: total_cost(spec, runtime, state),
                linearize=linearize, retract=retract, solve_from_lin=solve_from_lin,
                grad_max=grad_max, step=step)


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------

def problem_spec(problem) -> ProblemSpec:
    """The problem's static structure (shapes, kinds, offsets)."""
    splines = tuple(
        SplineSpec(sp.kind, sp.n, sp.tangent_offset) for sp in problem.splines
    )
    buckets = []
    for key, b in problem.buckets.items():
        windows = tuple(b.window[sp.kind] for sp in problem.splines)
        camera = b.camera_cls.__name__ if b.camera_cls is not None else ""
        buckets.append(BucketSpec(key.split(":")[0], camera, b.M, b.rdim, windows))
    return ProblemSpec(
        splines=splines,
        buckets=tuple(buckets),
        num_tangent=problem.num_tangent,
        sensor_offset=problem.sensor_offset,
        landmark_offset=problem.landmark_offset,
        num_sensors=len(problem.sensors),
        num_landmarks=len(problem.landmarks),
        vt_offset=problem.vt_offset,
        num_vt=int(problem.state0["vt"].shape[0]),
    )


def problem_runtime(problem):
    """Everything numerical about the problem: masks, bounds, spline
    timing (host floats) and the bucket data tensors."""
    return {
        "mask": problem.mask,
        "d_max": problem.d_max,
        "spline_t0": [float(sp.t0) for sp in problem.splines],
        "spline_dt": [float(sp.dt) for sp in problem.splines],
        "data": [dict(b.data) for b in problem.buckets.values()],
    }


def bucket_residuals(problem, state=None):
    """Each bucket's residual rows through the solver's batched terms:
    ``{bucket_key: r [M, rdim]}`` as numpy, weights applied and the robust
    loss not (the raw residual the object API's ``measurement.error``
    returns), at ``state`` (default ``problem.state0``)."""
    spec, runtime = problem_spec(problem), problem_runtime(problem)
    state = problem.state0 if state is None else state
    return {key: bucket_terms(spec, bspec, runtime, state, data, cost_only=True).cpu().numpy()
            for key, bspec, data in zip(problem.buckets, spec.buckets, runtime["data"])}


def make_functions(problem):
    """``(cost_fn(state), linearize_fn(state) -> (cost, H, g))`` of the
    dense strategy, over ``problem``'s runtime."""
    spec, runtime = problem_spec(problem), problem_runtime(problem)
    parts = build_parts(spec)
    return (lambda state: parts["total_cost"](runtime, state),
            lambda state: parts["linearize"](runtime, state))


def make_step(problem):
    """``(step(state, lam) -> (cost, new_state, new_cost, pred, delta,
    grad_max), cost_fn(state))``: one dense LM step (linearize, damped
    solve, retract, re-cost) over ``problem``'s runtime; ``grad_max`` is
    max |g| over the columns the step sees."""
    spec, runtime = problem_spec(problem), problem_runtime(problem)
    parts = build_parts(spec)
    return (lambda state, lam: parts["step"](runtime, state, lam),
            lambda state: parts["total_cost"](runtime, state))


def retract_state(problem, state, delta):
    """``state`` moved by the masked tangent step ``delta`` [P], the bounds
    kept by projection."""
    return _retract_state(problem_spec(problem), problem_runtime(problem), state, delta)
