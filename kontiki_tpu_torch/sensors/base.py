"""Sensor base: relative pose + time offset with per-parameter locks.

Reference semantics (kontiki's cpplib/include/kontiki/sensors/sensors.h):
every sensor owns a relative orientation q_ct (wxyz), relative
position p_ct, and a time offset d box-bounded to |d| <= max_time_offset
(default 0.1). All three are individually lockable and **locked by
default**.
"""
import numbers

import numpy as np

from ..config import host_dtype


class Sensor:
    def __init__(self):
        self._q_ct = np.array([1.0, 0.0, 0.0, 0.0], dtype=host_dtype)
        self._p_ct = np.zeros(3, dtype=host_dtype)
        self._time_offset = 0.0
        self._max_time_offset = 0.1
        self.relative_orientation_locked = True
        self.relative_position_locked = True
        self.time_offset_locked = True

    # -- relative pose ------------------------------------------------------
    @property
    def relative_orientation(self):
        return self._q_ct.copy()

    @relative_orientation.setter
    def relative_orientation(self, q):
        q = np.asarray(q, dtype=host_dtype)
        if q.shape != (4,):
            raise TypeError("relative orientation must be a wxyz 4-vector")
        self._q_ct = q

    @property
    def relative_position(self):
        return self._p_ct.copy()

    @relative_position.setter
    def relative_position(self, p):
        p = np.asarray(p, dtype=host_dtype)
        if p.shape != (3,):
            raise TypeError("relative position must be a 3-vector")
        self._p_ct = p

    @property
    def relative_pose(self):
        return self.relative_orientation, self.relative_position

    @relative_pose.setter
    def relative_pose(self, value):
        q, p = value
        q = np.asarray(q, dtype=host_dtype)
        p = np.asarray(p, dtype=host_dtype)
        if q.shape != (4,) or p.shape != (3,):
            raise TypeError("relative_pose must be (wxyz quaternion, 3-vector)")
        self._q_ct = q
        self._p_ct = p

    # -- time offset --------------------------------------------------------
    @property
    def time_offset(self):
        return self._time_offset

    @time_offset.setter
    def time_offset(self, d):
        if not isinstance(d, numbers.Number):
            raise TypeError("time_offset must be a number")
        if abs(d) > self._max_time_offset:
            raise ValueError(f"Time offset |{d}| > {self._max_time_offset}")
        self._time_offset = float(d)

    @property
    def max_time_offset(self):
        return self._max_time_offset

    @max_time_offset.setter
    def max_time_offset(self, m):
        self._max_time_offset = float(m)
