"""Batched residual / Jacobian terms, bounds and retraction (counterpart of
``kontiki_tpu.solver.kernels``, the subset BASELINE config 4 uses).

- Camera rows (``rs_static``, pinhole, SE3 spline) gather their 4-knot
  windows and row constants into the transposed ``[k, M]`` layout and run
  kernel B1 (``ops.linearize_kernels.linearize_rows``).
- Gyro and accel rows take the generic path: forward mode over the
  per-row tangent increments with ``torch.func.vmap(torch.func.jacfwd)``.
  Each row's knot window is gathered before the differentiated function,
  so ``jacfwd`` sees only the deltas.
- Locks are masks over tangent columns, applied after assembly; SE3 knots
  retract by right-multiplied ``exp`` (Sophus ``T * exp(x)``), sensor
  orientations by left-multiplied ``exp``.
- Huber loss follows Ceres: cost ``0.5 * sum(rho(|r|^2))`` and IRLS weights
  ``rho'(s)`` on the normal equations.
"""
from typing import NamedTuple, Tuple

import torch

from ..constants import GRAVITY
from ..math import quaternion as quat
from ..math import se3 as se3m
from ..ops.linearize_kernels import linearize_rows
from ..trajectories import spline_eval as ev
from .problem import SENSOR_TANGENT_DIM, TANGENT_DIMS


class SplineSpec(NamedTuple):
    kind: str  # 'se3'
    n: int
    tangent_offset: int


class BucketSpec(NamedTuple):
    kind: str  # 'gyro' | 'accel' | 'rs_static'
    camera: str  # '' | 'PinholeCamera'
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


def retract_window(kind, win, delta):
    """Apply tangent increments [..., td] to knots [..., D] (SE3: right
    increment ``(q exp(w), t + R(q) V(w) v)``)."""
    if kind != "se3":
        raise ValueError(kind)
    q, t = se3m.se3_unpack(win)
    dq, dt = se3m.se3_exp(delta)
    return se3m.se3_pack(quat.qmul(q, dq), t + quat.qrotate(q, dt))


# ---------------------------------------------------------------------------
# camera rows: kernel B1
# ---------------------------------------------------------------------------

def _camera_inputs(spec, runtime, state, data):
    """Gather + transpose camera rows for B1. Returns ``(ins, (i0_ref,
    i0_obs))``: the [k, M] input dict and the window base indices."""
    (sp,) = spec.splines
    d = state["d"][data["sid"]]
    row_delta = data["readout"] / data["rows"]
    times = {
        "ref": data["t0_ref"] + d + data["v_ref"] * row_delta,
        "obs": data["t0_obs"] + d + data["v_obs"] * row_delta,
    }
    t0, dt = runtime["spline_t0"][0], runtime["spline_dt"][0]
    knots = state[sp.kind]
    M = d.shape[0]
    ins, i0s = {}, []
    for tag, t in times.items():
        # window base: floor on the primal, clamped to [0, n - 4]
        i0, u = ev.index_and_u(t, t0, dt, sp.n)
        ins[f"win_{tag}"] = ev.gather_windows(knots, i0).reshape(M, -1).T.contiguous()
        ins[f"u_{tag}"] = u[None, :].contiguous()
        i0s.append(i0)
    ins["dts"] = torch.full((1, M), dt, dtype=knots.dtype, device=knots.device)
    ins["q_ct"] = state["q_ct"][data["sid"]].T.contiguous()
    ins["p_ct"] = state["p_ct"][data["sid"]].T.contiguous()
    ins["rho"] = state["rho"][data["lid"]][None, :].contiguous()
    ins["yh_ref"] = data["yh_ref"].T.contiguous()
    ins["uv_obs"] = data["uv_obs"].T.contiguous()
    ins["weight"] = data["weight"][None, :].contiguous()
    ins["K"] = data["K"].reshape(M, 9).T.contiguous()
    return ins, i0s


def _camera_rows(spec, runtime, state, data):
    """(r [M,2], J [M,2,61], cols [M,61], J_rho [M,2]) of the camera rows;
    columns are [ref window, obs window, sensor] as in the JAX package."""
    ins, (i0_ref, i0_obs) = _camera_inputs(spec, runtime, state, data)
    r, J, J_rho = linearize_rows(ins)
    (sp,) = spec.splines
    td = TANGENT_DIMS[sp.kind]
    ar_w = torch.arange(4 * td, device=i0_ref.device)
    ar_s = torch.arange(SENSOR_TANGENT_DIM, device=i0_ref.device)
    cols = torch.cat(
        [
            sp.tangent_offset + i0_ref[:, None] * td + ar_w,
            sp.tangent_offset + i0_obs[:, None] * td + ar_w,
            spec.sensor_offset + data["sid"][:, None] * SENSOR_TANGENT_DIM + ar_s,
        ],
        dim=1,
    )
    return r, J, cols, J_rho


# ---------------------------------------------------------------------------
# IMU rows: generic forward mode
# ---------------------------------------------------------------------------

def _imu_residual(kind, t0, dt, gravity):
    """residual(delta [4*td + 13], win [4, 7], i_base, t, y, weight, d, ab, gb)
    -> r [3] for one gyro/accel row (``i_base`` as a float).

    ``delta`` holds the window knots' tangent increments, then the sensor
    slots; only the time offset and the biases reach an IMU residual."""

    def residual(delta, win, i_base, t, y, weight, d0, ab0, gb0):
        sens = delta[24:]
        sub = retract_window("se3", win, delta[:24].reshape(4, 6))
        # a 4-knot window at the segment base: u = s - i_base
        u = (t + (d0 + sens[6]) - t0) / dt - i_base
        _, _, a, q, w = ev.se3_window(sub, u, dt)
        q_conj = quat.qconj(q)
        if kind == "gyro":
            body = quat.qrotate(q_conj, w) + (gb0 + sens[10:13])
        else:
            body = quat.qrotate(q_conj, a + gravity) + (ab0 + sens[7:10])
        return weight * (y - body)

    return residual


def _imu_rows(spec, bspec, runtime, state, data):
    """(r [M,3], J [M,3,37], cols [M,37]) of gyro/accel rows over the SE3
    spline: window tangents (24), then the sensor block (13)."""
    (sp,) = spec.splines
    (W,) = bspec.windows
    if W != 4:
        raise NotImplementedError(f"IMU rows need 4-knot windows, got {W}")
    t0, dt = runtime["spline_t0"][0], runtime["spline_dt"][0]
    sid = data["sid"]
    d0 = state["d"][sid]
    # window base from the current time offset (windows re-center each
    # linearization), floor on the primal
    i_base = torch.clamp(torch.floor((data["t"] + d0 - t0) / dt).long(), 0, sp.n - W)
    knots = state[sp.kind]
    win = ev.gather_windows(knots, i_base)
    gravity = torch.as_tensor(GRAVITY, dtype=knots.dtype, device=knots.device)
    f = _imu_residual(bspec.kind, t0, dt, gravity)

    def row(delta, *args):
        r = f(delta, *args)
        return r, r

    M = sid.shape[0]
    C = 4 * TANGENT_DIMS[sp.kind] + SENSOR_TANGENT_DIM
    zeros = torch.zeros(M, C, dtype=knots.dtype, device=knots.device)
    J, r = torch.func.vmap(torch.func.jacfwd(row, has_aux=True))(
        zeros, win, i_base.to(knots.dtype), data["t"], data["y"], data["weight"], d0,
        state["abias"][sid], state["gbias"][sid],
    )
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


def bucket_terms(spec, bspec, runtime, state, data):
    """``(r, J, cols, J_rho or None)`` of one bucket, landmark column split
    off (the Schur path's form)."""
    if bspec.kind == "rs_static":
        return _camera_rows(spec, runtime, state, data)
    if bspec.kind in ("gyro", "accel"):
        return (*_imu_rows(spec, bspec, runtime, state, data), None)
    raise NotImplementedError(f"bucket kind {bspec.kind!r}")


# ---------------------------------------------------------------------------
# robust loss (Huber, Ceres semantics: sqrt(rho') whitening everywhere)
# ---------------------------------------------------------------------------

def _huber(s, c):
    b = c * c
    return torch.where(s <= b, s, 2.0 * c * torch.sqrt(torch.maximum(s, b)) - b)


def _huber_prime(s, c):
    b = c * c
    return torch.where(s <= b, 1.0, c / torch.sqrt(torch.maximum(s, b)))


# ---------------------------------------------------------------------------
# bounds, projection and retraction
# ---------------------------------------------------------------------------

def project_delta(spec, runtime, state, delta):
    """Clip bound-constrained tangent components (rho >= 0,
    |d| <= max_time_offset) to the increment the retraction will apply.

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
    return delta


def landmark_free_mask(state_rho, g_l, mask_l):
    """Bound active set: freeze landmarks at the rho = 0 bound whose
    gradient pushes outward (the projected-gradient treatment Ceres applies
    to the same bound, static_rscamera_measurement.h:180)."""
    at_bound = state_rho <= 0.0
    outward = g_l > 0.0  # descent direction -g_l points negative
    return mask_l * (1.0 - (at_bound & outward).to(mask_l.dtype))


def _retract_state(spec, runtime, state, delta):
    """Apply a masked global tangent step to the state dict; bounds
    (rho >= 0, |d| <= max_time_offset) are enforced by projection."""
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
    return new


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
