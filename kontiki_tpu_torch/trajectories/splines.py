"""User-facing trajectory classes (counterpart of
``kontiki_tpu.trajectories.splines``; the SE3 spline only).

Knots are stored on the host as a numpy array that grows by doubling;
queries evaluate through the batched torch kernels of ``spline_eval`` on
the CPU in float64 and return numpy arrays. Every query accepts a scalar or
an array of times; the valid span is ``[t0, t0 + (n-3) dt)``.
"""
import copy
import numbers

import numpy as np
import torch

from ..config import host_dtype
from ..math import quaternion as quat
from . import spline_eval as ev

__all__ = ["UniformSE3SplineTrajectory"]


class _TrajectoryBase:
    """Shared query interface: evaluation + world-frame transforms."""

    def _eval(self, ts):
        """dict of position/velocity/acceleration [B,3], orientation [B,4]
        wxyz and angular_velocity [B,3] for times ts [B]."""
        raise NotImplementedError

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

    def position(self, t):
        "Position in the world coordinate frame"
        return self._query(t, "position")

    def acceleration(self, t):
        "Acceleration in the world coordinate frame"
        return self._query(t, "acceleration")

    def orientation(self, t):
        "Orientation as wxyz unit quaternion (trajectory -> world rotation)"
        return self._query(t, "orientation")

    def angular_velocity(self, t):
        "Angular velocity in the world coordinate frame"
        return self._query(t, "angular_velocity")


class _UniformSplineTrajectory(_TrajectoryBase):
    """Uniform cubic B-spline knot container (reference spline_base.h):
    ``n >= 4`` knots for evaluation, negative indexing."""

    _KNOT_DIM = None

    def __init__(self, dt=1.0, t0=0.0):
        self._dt = float(dt)
        self._t0 = float(t0)
        self._n = 0
        self._knots = np.zeros((8, self._KNOT_DIM), dtype=host_dtype)
        self._locked = False

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

    def append_knot(self, cp):
        row = self._validate_and_convert(cp)
        if self._n == self._knots.shape[0]:
            self._knots = np.concatenate([self._knots, np.zeros_like(self._knots)])
        self._knots[self._n] = row
        self._n += 1

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

    def _eval(self, ts):
        self._validate_size()
        p, v, a, q, w = ev.se3_evaluate(
            torch.from_numpy(self.knots.copy()), self._t0, self._dt,
            torch.as_tensor(np.asarray(ts, dtype=host_dtype)),
        )
        return {
            "position": p.numpy(),
            "velocity": v.numpy(),
            "acceleration": a.numpy(),
            "orientation": q.numpy(),
            "angular_velocity": w.numpy(),
        }
