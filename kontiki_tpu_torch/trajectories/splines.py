"""User-facing trajectory classes (counterpart of
``kontiki_tpu.trajectories.splines``): the R3, SO3 and SE3 splines and the
split R3 + SO3 trajectory.

Knots are stored on the host as a numpy array that grows by doubling.
Queries (``position`` ... ``angular_velocity``, ``from_world``,
``to_world``, SE3 ``evaluate``) place the knots and times on the
trajectory's ``device`` in float64 and evaluate there, through kernel B5
(``spline_eval``) on the CUDA card; they return numpy arrays. ``device``
is fixed at construction: ``None`` means the CUDA card, resolved at query
time (``config.resolve_device``, which raises without one); the CPU is
used only when named (``device="cpu"``). Every query accepts a scalar or
an array of times; the valid span is ``[t0, t0 + (n-3) dt)``.
"""
import copy
import numbers

import numpy as np
import torch

from ..config import host_dtype, resolve_device
from ..math import quaternion as quat
from . import spline_eval as ev

__all__ = [
    "UniformR3SplineTrajectory",
    "UniformSO3SplineTrajectory",
    "UniformSE3SplineTrajectory",
    "SplitTrajectory",
]


def _torch(a, device):
    return torch.as_tensor(np.asarray(a, dtype=host_dtype), device=device)


def _numpy(t):
    return t.detach().cpu().numpy()


class _TrajectoryBase:
    """Shared query interface: evaluation + world-frame transforms."""

    _device = None

    @property
    def device(self):
        """The device queries run on (None: the CUDA card)."""
        return self._device

    def _resolve(self, device):
        return resolve_device(self._device if device is None else device)

    def _eval_t(self, ts, device=None):
        """dict of position/velocity/acceleration [B,3], orientation [B,4]
        wxyz and angular_velocity [B,3] tensors on ``device`` (default: the
        trajectory's) for times ts [B]."""
        raise NotImplementedError

    def _eval(self, ts, device=None):
        """``_eval_t`` as numpy arrays."""
        return {k: _numpy(v) for k, v in self._eval_t(ts, device).items()}

    @property
    def min_time(self):
        raise NotImplementedError

    @property
    def max_time(self):
        raise NotImplementedError

    @property
    def valid_time(self):
        return (self.min_time, self.max_time)

    def _times(self, t):
        scalar = isinstance(t, numbers.Number) or np.ndim(t) == 0
        ts = np.atleast_1d(np.asarray(t, dtype=host_dtype))
        tmin, tmax = self.valid_time
        bad = (ts < tmin) | (ts >= tmax)
        if np.any(bad):
            raise ValueError(
                f"t={ts[bad][0]} is out of range [{tmin}, {tmax}) for this trajectory"
            )
        return ts, scalar

    def _query(self, t, key):
        ts, scalar = self._times(t)
        out = self._eval(ts)[key]
        return out[0] if scalar else out

    def _frame_query(self, t, X, to_world):
        ts, scalar = self._times(t)
        res = self._eval_t(ts)
        q, p = res["orientation"], res["position"]
        X = torch.as_tensor(np.asarray(X, dtype=host_dtype), device=p.device)
        if to_world:
            out = quat.qrotate(q, X.expand_as(p)) + p
        else:
            out = quat.qrotate(quat.qconj(q), X - p)
        out = _numpy(out)
        return out[0] if scalar else out

    def position(self, t):
        "Position in the world coordinate frame"
        return self._query(t, "position")

    def velocity(self, t):
        "Velocity in the world coordinate frame"
        return self._query(t, "velocity")

    def acceleration(self, t):
        "Acceleration in the world coordinate frame"
        return self._query(t, "acceleration")

    def orientation(self, t):
        "Orientation as wxyz unit quaternion (trajectory -> world rotation)"
        return self._query(t, "orientation")

    def angular_velocity(self, t):
        "Angular velocity in the world coordinate frame"
        return self._query(t, "angular_velocity")

    def from_world(self, Xw, t):
        "Move point from the world to the trajectory coordinate frame"
        return self._frame_query(t, Xw, to_world=False)

    def to_world(self, Xt, t):
        "Move point from the trajectory to the world coordinate frame"
        return self._frame_query(t, Xt, to_world=True)


class _UniformSplineTrajectory(_TrajectoryBase):
    """Uniform cubic B-spline knot container (reference spline_base.h):
    ``n >= 4`` knots for evaluation, negative indexing; ``extend_to``
    appends fill knots until ``max_time > t`` (spline_base.h:351-359)."""

    _KNOT_DIM = None

    def __init__(self, dt=1.0, t0=0.0, device=None):
        self._dt = float(dt)
        self._t0 = float(t0)
        self._n = 0
        self._knots = np.zeros((8, self._KNOT_DIM), dtype=host_dtype)
        self._locked = False
        self._device = device

    @property
    def dt(self):
        return self._dt

    @property
    def t0(self):
        return self._t0

    def __len__(self):
        return self._n

    def _index(self, i):
        if i < 0:
            i += self._n
        if not (0 <= i < self._n):
            raise IndexError("Invalid sequence index")
        return i

    def _validate_and_convert(self, cp):
        raise NotImplementedError

    def _convert_out(self, row):
        raise NotImplementedError

    def __getitem__(self, i):
        return self._convert_out(self._knots[self._index(i)])

    def __setitem__(self, i, cp):
        self._knots[self._index(i)] = self._validate_and_convert(cp)

    def append_knot(self, cp):
        row = self._validate_and_convert(cp)
        if self._n == self._knots.shape[0]:
            self._knots = np.concatenate([self._knots, np.zeros_like(self._knots)])
        self._knots[self._n] = row
        self._n += 1

    def extend_to(self, t, fill_value):
        while self._n < 4 or self.max_time < t:
            self.append_knot(fill_value)

    def _knots_on(self, device):
        self._validate_size()
        return _torch(self.knots, device)

    def _validate_size(self):
        if self._n < 4:
            raise ValueError("Spline had too few control points")

    @property
    def min_time(self):
        self._validate_size()
        return self._t0

    @property
    def max_time(self):
        self._validate_size()
        return self._t0 + (self._n - 3) * self._dt

    @property
    def locked(self):
        return self._locked

    @locked.setter
    def locked(self, flag):
        self._locked = bool(flag)

    def clone(self):
        return copy.deepcopy(self)

    @property
    def knots(self):
        """The valid knot rows as a writable [n, D] view (solver interface)."""
        return self._knots[: self._n]

    def set_knots(self, values):
        """Overwrite all knot rows from an [n, D] array (solver interface)."""
        values = np.asarray(values, dtype=host_dtype)
        if values.shape != (self._n, self._KNOT_DIM):
            raise ValueError(
                f"knots must be [{self._n}, {self._KNOT_DIM}], got {values.shape}"
            )
        self._knots[: self._n] = values


class UniformR3SplineTrajectory(_UniformSplineTrajectory):
    """Position spline with control points in R^3 (reference
    uniform_r3_spline_trajectory.h). Orientation queries return identity,
    angular velocity zero."""

    _KNOT_DIM = 3

    def _validate_and_convert(self, cp):
        cp = np.asarray(cp, dtype=host_dtype)
        if cp.shape != (3,):
            raise ValueError("R3 control point must be a 3-vector")
        return cp

    def _convert_out(self, row):
        return row.copy()

    def _eval_t(self, ts, device=None):
        device = self._resolve(device)
        p, v, a = ev.r3_evaluate(self._knots_on(device), self._t0, self._dt,
                                 _torch(ts, device))
        identity = torch.zeros(p.shape[0], 4, dtype=p.dtype, device=device)
        identity[:, 0] = 1.0
        return {
            "position": p,
            "velocity": v,
            "acceleration": a,
            "orientation": identity,
            "angular_velocity": torch.zeros_like(p),
        }


class UniformSO3SplineTrajectory(_UniformSplineTrajectory):
    """Cumulative orientation spline with unit-quaternion control points
    (wxyz; reference uniform_so3_spline_trajectory.h). Position, velocity and
    acceleration queries return zero. Control points must be unit norm to
    ``quat.EPS_UNIT_CHECK``."""

    _KNOT_DIM = 4

    def _validate_and_convert(self, cp):
        cp = np.asarray(cp, dtype=host_dtype)
        if cp.shape != (4,):
            raise ValueError("SO3 control point must be a wxyz 4-vector")
        if abs(np.linalg.norm(cp) - 1.0) >= quat.EPS_UNIT_CHECK:
            raise ValueError("Control point must be unit quaternion!")
        return cp

    def _convert_out(self, row):
        return row.copy()

    def _eval_t(self, ts, device=None):
        device = self._resolve(device)
        q, w = ev.so3_evaluate(self._knots_on(device), self._t0, self._dt,
                               _torch(ts, device))
        zeros = torch.zeros_like(w)
        return {
            "position": zeros,
            "velocity": zeros,
            "acceleration": zeros,
            "orientation": q,
            "angular_velocity": w,
        }


class UniformSE3SplineTrajectory(_UniformSplineTrajectory):
    """Cumulative SE(3) spline; control points are 4x4 rigid transforms,
    stored packed as (q wxyz, t) rows (reference
    uniform_se3_spline_trajectory.h)."""

    _KNOT_DIM = 7

    def _validate_and_convert(self, cp):
        cp = np.asarray(cp, dtype=host_dtype)
        if cp.shape != (4, 4):
            raise ValueError("SE3 control point must be a 4x4 matrix")
        R = cp[:3, :3]
        if abs(np.linalg.det(R) - 1.0) >= 1e-10:
            raise ValueError("Rotation matrix determinant is not 1!")
        if np.sum((cp[3] - np.array([0.0, 0.0, 0.0, 1.0])) ** 2) >= 1e-10:
            raise ValueError("Final row must be [0, 0, 0, 1]")
        q = quat.matrix_to_quat(torch.from_numpy(np.ascontiguousarray(R))).numpy()
        return np.concatenate([q, cp[:3, 3]])

    def _convert_out(self, row):
        T = np.eye(4, dtype=host_dtype)
        T[:3, :3] = quat.quat_to_matrix(torch.from_numpy(row[:4].copy())).numpy()
        T[:3, 3] = row[4:]
        return T

    def _eval_t(self, ts, device=None):
        device = self._resolve(device)
        p, v, a, q, w = ev.se3_evaluate(self._knots_on(device), self._t0, self._dt,
                                        _torch(ts, device))
        return {
            "position": p,
            "velocity": v,
            "acceleration": a,
            "orientation": q,
            "angular_velocity": w,
        }

    def evaluate(self, t):
        """Full spline evaluation: (P, P', P'') 4x4 matrices (the reference's
        extra SE3 binding, py_uniform_se3_spline_trajectory.cc ``evaluate``;
        plain torch on the trajectory's device, as the JAX package has no
        kernel for it)."""
        ts, scalar = self._times(t)
        device = self._resolve(None)
        knots, tt = self._knots_on(device), _torch(ts, device)
        i0, u = ev.index_and_u(tt, self._t0, self._dt, knots.shape[0])
        out = tuple(_numpy(m) for m in
                    ev.se3_window_matrices(ev.gather_windows(knots, i0), u, self._dt))
        return tuple(o[0] for o in out) if scalar else out


class SplitTrajectory(_TrajectoryBase):
    """Independent R3 and SO3 splines (reference split_trajectory.h): linear
    queries go to the R3 spline, rotational ones to the SO3 spline. The
    valid span is the intersection of both; both must share a lock state.
    Built from spacings, both splines take ``device``; built from two
    splines, queries run on ``device`` if one is named, else on each
    spline's own."""

    def __init__(self, r3_arg=1.0, so3_arg=1.0, r3_t0=0.0, so3_t0=0.0, device=None):
        self._device = device
        if isinstance(r3_arg, UniformR3SplineTrajectory):
            if not isinstance(so3_arg, UniformSO3SplineTrajectory):
                raise TypeError("Expected UniformSO3SplineTrajectory")
            self._r3, self._so3 = r3_arg, so3_arg
        else:
            self._r3 = UniformR3SplineTrajectory(float(r3_arg), float(r3_t0), device)
            self._so3 = UniformSO3SplineTrajectory(float(so3_arg), float(so3_t0), device)

    @property
    def R3_spline(self):
        return self._r3

    @property
    def SO3_spline(self):
        return self._so3

    @property
    def min_time(self):
        return max(self._r3.min_time, self._so3.min_time)

    @property
    def max_time(self):
        return min(self._r3.max_time, self._so3.max_time)

    @property
    def locked(self):
        if self._r3.locked != self._so3.locked:
            raise RuntimeError("R3 and SO3 trajectories have different lock status!")
        return self._r3.locked

    @locked.setter
    def locked(self, flag):
        self._r3.locked = flag
        self._so3.locked = flag

    def clone(self):
        return copy.deepcopy(self)

    def _eval_t(self, ts, device=None):
        device = self._device if device is None else device
        r3 = self._r3._eval_t(ts, device)
        so3 = self._so3._eval_t(ts, device)
        return {
            "position": r3["position"],
            "velocity": r3["velocity"],
            "acceleration": r3["acceleration"],
            "orientation": so3["orientation"],
            "angular_velocity": so3["angular_velocity"],
        }
