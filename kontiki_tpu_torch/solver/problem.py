"""Problem compilation: object graph -> device tensors, masks, bookkeeping
(counterpart of ``kontiki_tpu.solver.problem.Problem``).

One pass over the measurements registers sensors and landmarks, checks and
activates knot spans (reference CheckTimeSpans, trajectory_estimator.h:
97-122, and knot activation, spline_base.h:361-404), and fills one
struct-of-arrays bucket per measurement kind. Arrays are built in numpy
and moved to ``device`` once, floats as ``dtype`` and indices as int64.

- **State** is a dict of tensors: knots per spline kind, stacked sensor
  parameters, landmark inverse depths.
- **Locks -> masks** over the global tangent vector reproduce
  ``SetParameterBlockConstant``; only knots inside some measurement's span
  are free.
"""
import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from ..config import default_dtype
from ..measurements import (
    AccelerometerMeasurement,
    GyroscopeMeasurement,
    StaticRsCameraMeasurement,
)
from ..sensors import PinholeCamera
from ..trajectories.splines import UniformSE3SplineTrajectory

#: tangent dimension per spline kind
TANGENT_DIMS = {"se3": 6}

#: sensor tangent slot layout: q_ct(3), p_ct(3), d(1), abias(3), gbias(3)
SENSOR_TANGENT_DIM = 13
SLOT_Q = slice(0, 3)
SLOT_P = slice(3, 6)
SLOT_D = slice(6, 7)

_SPAN_ERRORS = {
    1: "Time span out of range for trajectory",
    2: "At least one time span begins before it ends",
    3: "Time spans are not ordered",
}


@dataclass
class SplineInfo:
    kind: str
    obj: UniformSE3SplineTrajectory
    tangent_offset: int = 0
    active: Optional[np.ndarray] = None  # bool [n]

    @property
    def dt(self):
        return self.obj.dt

    @property
    def t0(self):
        return self.obj.t0

    @property
    def n(self):
        return len(self.obj)

    @property
    def tangent_dim(self):
        return TANGENT_DIMS[self.kind]


@dataclass
class Bucket:
    """One measurement-kind bucket: measurements + struct-of-arrays data."""

    kind: str
    measurements: list = field(default_factory=list)
    data: Dict[str, torch.Tensor] = field(default_factory=dict)
    #: static per-bucket window width per spline kind
    window: Dict[str, int] = field(default_factory=dict)
    camera_cls: Optional[type] = None
    rdim: int = 3

    @property
    def M(self):
        return len(self.measurements)


def _decompose_trajectory(trajectory) -> List[SplineInfo]:
    if isinstance(trajectory, UniformSE3SplineTrajectory):
        return [SplineInfo("se3", trajectory)]
    raise TypeError(f"Unsupported trajectory type {type(trajectory)}")


def _check_spans(spans, tmin, tmax):
    """Reference CheckTimeSpans (trajectory_estimator.h:97-122) for one
    measurement's spans."""
    prev = -math.inf
    for t1, t2 in spans:
        if t1 < tmin or t2 >= tmax:
            raise ValueError(_SPAN_ERRORS[1])
        if t1 > t2:
            raise ValueError(_SPAN_ERRORS[2])
        if t1 < prev:
            raise ValueError(_SPAN_ERRORS[3])
        prev = t1


def _activate_spans(t1, t2, t0, dt, nknots):
    """Knots in the 4-knot windows of the [t1, t2] spans, as a uint8 mask
    (spline_base.h:361-404; a difference array paints the intervals)."""
    i1 = np.clip(np.floor((t1 - t0) / dt).astype(np.int64), 0, None)
    i2 = np.minimum(np.floor((t2 - t0) / dt).astype(np.int64) + 4, nknots)
    diff = np.zeros(nknots + 1, dtype=np.int64)
    valid = i1 < i2
    np.add.at(diff, i1[valid], 1)
    np.add.at(diff, i2[valid], -1)
    return (np.cumsum(diff[:-1]) > 0).astype(np.uint8)


class Problem:
    """Compiled estimation problem on ``device`` in ``dtype``."""

    def __init__(self, trajectory, measurements, device=None,
                 dtype=default_dtype):
        self.device = torch.device(device if device is not None else "cpu")
        self.dtype = dtype
        self.trajectory = trajectory
        self.measurements = list(measurements)
        self.splines = _decompose_trajectory(trajectory)
        self.sensors: list = []
        self._sensor_index: dict = {}
        self.landmarks: list = []
        self._landmark_index: dict = {}
        self.buckets: Dict[str, Bucket] = {}

        self._spans = []
        for m in self.measurements:
            self._add(m)
        spans = np.asarray(self._spans, dtype=np.float64).reshape(-1, 2)
        for sp in self.splines:
            sp.active = _activate_spans(spans[:, 0], spans[:, 1], sp.t0, sp.dt, sp.n)
        del self._spans

        self._layout()
        self._finalize_buckets()

    # ------------------------------------------------------------------
    # registration
    # ------------------------------------------------------------------
    def _sensor_id(self, sensor):
        if id(sensor) not in self._sensor_index:
            self._sensor_index[id(sensor)] = len(self.sensors)
            self.sensors.append(sensor)
        return self._sensor_index[id(sensor)]

    def _landmark_id(self, lm):
        if id(lm) not in self._landmark_index:
            self._landmark_index[id(lm)] = len(self.landmarks)
            self.landmarks.append(lm)
        return self._landmark_index[id(lm)]

    def _activate(self, spans):
        _check_spans(spans, self.trajectory.min_time, self.trajectory.max_time)
        self._spans.extend(spans)

    def _bucket(self, key, rdim, camera_cls=None):
        if key not in self.buckets:
            self.buckets[key] = Bucket(kind=key, rdim=rdim, camera_cls=camera_cls)
        return self.buckets[key]

    def _camera_spans(self, m):
        """Spans for RS camera measurements
        (static_rscamera_measurement.h:137-174)."""
        cam = m.camera
        lm = m.observation.landmark
        t0_ref = lm.reference.view.t0
        t0_obs = m.observation.view.t0
        t1, t2 = (t0_ref, t0_obs) if t0_ref <= t0_obs else (t0_obs, t0_ref)
        if not cam.time_offset_locked:
            t1 -= cam.max_time_offset
            t2 += cam.max_time_offset
        margin = 1e-3
        return [
            (t1 - margin, t1 + cam.readout + margin),
            (t2 - margin, t2 + cam.readout + margin),
        ]

    def _add(self, m):
        if isinstance(m, (GyroscopeMeasurement, AccelerometerMeasurement)):
            imu = m.imu
            s = self._sensor_id(imu)
            if imu.time_offset_locked:
                spans = [(m.t, m.t)]
            else:
                spans = [(m.t - imu.max_time_offset, m.t + imu.max_time_offset)]
            self._activate(spans)
            key = "gyro" if isinstance(m, GyroscopeMeasurement) else "accel"
            self._bucket(key, 3).measurements.append((m, s))
        elif isinstance(m, StaticRsCameraMeasurement):
            if not isinstance(m.camera, PinholeCamera):
                raise TypeError(f"Unsupported camera type {type(m.camera)}")
            s = self._sensor_id(m.camera)
            li = self._landmark_id(m.observation.landmark)
            self._activate(self._camera_spans(m))
            bucket = self._bucket("rs_static:PinholeCamera", 2, camera_cls=PinholeCamera)
            bucket.measurements.append((m, s, li))
        else:
            raise TypeError(f"Unsupported measurement type {type(m)}")

    # ------------------------------------------------------------------
    # tangent layout + state
    # ------------------------------------------------------------------
    def _tensor(self, a):
        a = np.asarray(a)
        dtype = torch.int64 if np.issubdtype(a.dtype, np.integer) else self.dtype
        return torch.as_tensor(a, device=self.device).to(dtype)

    def _layout(self):
        offset = 0
        for sp in self.splines:
            sp.tangent_offset = offset
            offset += sp.n * sp.tangent_dim
        self.sensor_offset = offset
        offset += len(self.sensors) * SENSOR_TANGENT_DIM
        self.landmark_offset = offset
        offset += len(self.landmarks)
        self.num_tangent = offset

        state = {}
        for sp in self.splines:
            state[sp.kind] = np.array(sp.obj.knots, dtype=np.float64)
        S = max(len(self.sensors), 1)
        q_ct = np.tile(np.array([1.0, 0, 0, 0]), (S, 1))
        p_ct = np.zeros((S, 3))
        d = np.zeros(S)
        for i, sensor in enumerate(self.sensors):
            q_ct[i], p_ct[i] = sensor.relative_pose
            d[i] = sensor.time_offset
        state["q_ct"] = q_ct
        state["p_ct"] = p_ct
        state["d"] = d
        # constant-bias IMUs are not ported: biases stay zero
        state["abias"] = np.zeros((S, 3))
        state["gbias"] = np.zeros((S, 3))
        state["rho"] = np.array([lm.inverse_depth for lm in self.landmarks],
                                dtype=np.float64)
        self.state0 = {k: self._tensor(v) for k, v in state.items()}

        self.d_max = self._tensor(
            np.array([s.max_time_offset for s in self.sensors] or [0.0])
        )

        mask = np.zeros(self.num_tangent)
        for sp in self.splines:
            if not self.trajectory.locked and sp.n:
                mask[sp.tangent_offset: sp.tangent_offset + sp.n * sp.tangent_dim] = (
                    np.repeat(sp.active.astype(np.float64), sp.tangent_dim)
                )
        for i, sensor in enumerate(self.sensors):
            base = self.sensor_offset + i * SENSOR_TANGENT_DIM
            sm = np.zeros(SENSOR_TANGENT_DIM)
            if not sensor.relative_orientation_locked:
                sm[SLOT_Q] = 1.0
            if not sensor.relative_position_locked:
                sm[SLOT_P] = 1.0
            if not sensor.time_offset_locked:
                sm[SLOT_D] = 1.0
            mask[base: base + SENSOR_TANGENT_DIM] = sm
        for li, lm in enumerate(self.landmarks):
            mask[self.landmark_offset + li] = 0.0 if lm.locked else 1.0
        self.mask = self._tensor(mask)

    # ------------------------------------------------------------------
    # bucket data arrays
    # ------------------------------------------------------------------
    def _window_width(self, sp: SplineInfo, readout=0.0):
        extra = int(math.ceil(readout / sp.dt)) + (1 if readout else 0)
        return min(4 + extra, sp.n) if sp.n >= 4 else 4

    def _finalize_buckets(self):
        for key, b in self.buckets.items():
            kind = key.split(":")[0]
            data = {}
            if kind in ("gyro", "accel"):
                ms = [m for m, _ in b.measurements]
                val = "w" if kind == "gyro" else "a"
                data["t"] = np.array([m.t for m in ms])
                data["y"] = np.stack([getattr(m, val) for m in ms])
                data["weight"] = np.array([m.weight for m in ms])
                data["sid"] = np.array([s for _, s in b.measurements], dtype=np.int64)
                for sp in self.splines:
                    b.window[sp.kind] = self._window_width(sp)
            else:
                ms = [m for m, _, _ in b.measurements]
                cams = [m.camera for m in ms]
                refs = [m.observation.landmark.reference for m in ms]
                data["sid"] = np.array([s for _, s, _ in b.measurements], dtype=np.int64)
                data["lid"] = np.array([li for _, _, li in b.measurements], dtype=np.int64)
                data["uv_obs"] = np.stack([m.observation.uv for m in ms])
                data["v_obs"] = np.array([m.observation.v for m in ms])
                data["t0_obs"] = np.array([m.observation.view.t0 for m in ms])
                data["t0_ref"] = np.array([r.view.t0 for r in refs])
                data["v_ref"] = np.array([r.v for r in refs])
                # the reference unprojection is precomputed (intrinsics are static)
                data["yh_ref"] = np.stack([c.unproject(r.uv) for c, r in zip(cams, refs)])
                data["readout"] = np.array([c.readout for c in cams])
                data["rows"] = np.array([float(c.rows) for c in cams])
                data["K"] = np.stack([c.camera_matrix for c in cams])
                data["weight"] = np.array([m.weight for m in ms])
                data["huber_c"] = np.array([m.huber_loss for m in ms])
                readout = max((c.readout for c in cams), default=0.0)
                for sp in self.splines:
                    b.window[sp.kind] = self._window_width(sp, readout=readout)
            b.data = {k: self._tensor(v) for k, v in data.items()}
