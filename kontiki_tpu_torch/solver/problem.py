"""Problem compilation: object graph -> device tensors, masks, bookkeeping
(counterpart of ``kontiki_tpu.solver.problem.Problem``).

One pass over the measurements registers sensors and landmarks, checks and
activates knot spans (reference CheckTimeSpans, trajectory_estimator.h:
97-122, and knot activation, spline_base.h:361-404, through the native
helper ``kontiki_tpu_torch.native``), and fills one struct-of-arrays bucket
per measurement kind. The batch IMU containers (``GyroscopeMeasurements``,
``AccelerometerMeasurements``) are checked and activated in one native pass
each and their arrays spliced into the bucket after the per-object rows.
Arrays are built in numpy and moved to ``device`` once, floats as
``dtype`` and indices as int64.
``device`` defaults to the CUDA card (``config.resolve_device``); pass
``device="cpu"`` to build on the CPU.

- **State** is a dict of tensors: knots per spline kind (``r3``, ``so3``,
  ``se3``), stacked sensor parameters (IMU biases from ``ConstantBiasImu``),
  landmark inverse depths, and the lifted row times ``vt`` of
  ``LiftingRsCameraMeasurement`` rows (after the landmarks in the tangent
  vector, always free, bounded to [0, 1]).
- **Locks -> masks** over the global tangent vector reproduce
  ``SetParameterBlockConstant``; only knots inside some measurement's span
  are free.
- **Ceres-style counts** (``num_parameters``, ``num_residual_blocks``, ...)
  fill the solver's ``Summary``; ``write_back`` copies a state into the
  trajectory, sensor and landmark objects.

``RawProblem`` builds the same attributes straight from struct-of-arrays
(BASELINE config 5's scale, where one Python object per observation is
itself the bottleneck).
"""
import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import native
from ..config import default_dtype, resolve_device
from ..measurements import (
    AccelerometerMeasurement,
    AccelerometerMeasurements,
    GyroscopeMeasurement,
    GyroscopeMeasurements,
    LiftingRsCameraMeasurement,
    NewtonRsCameraMeasurement,
    OrientationMeasurement,
    PositionMeasurement,
    StaticRsCameraMeasurement,
)
from ..sensors import AtanCamera, ConstantBiasImu, PinholeCamera
from ..trajectories.splines import (
    SplitTrajectory,
    UniformR3SplineTrajectory,
    UniformSE3SplineTrajectory,
    UniformSO3SplineTrajectory,
)

#: tangent dimension per spline kind
TANGENT_DIMS = {"r3": 3, "so3": 3, "se3": 6}
#: ambient (stored) dimension of a knot per spline kind
KNOT_DIMS = {"r3": 3, "so3": 4, "se3": 7}

#: sensor tangent slot layout: q_ct(3), p_ct(3), d(1), abias(3), gbias(3)
SENSOR_TANGENT_DIM = 13
SLOT_Q = slice(0, 3)
SLOT_P = slice(3, 6)
SLOT_D = slice(6, 7)
SLOT_AB = slice(7, 10)
SLOT_GB = slice(10, 13)


@dataclass
class SplineInfo:
    kind: str
    obj: object  # the spline container
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

    @property
    def knot_dim(self):
        return KNOT_DIMS[self.kind]


@dataclass
class Bucket:
    """One measurement-kind bucket: measurements + struct-of-arrays data."""

    kind: str
    measurements: list = field(default_factory=list)
    #: batch containers, spliced in after the per-object rows: list of
    #: (container, sensor id)
    batches: list = field(default_factory=list)
    data: Dict[str, torch.Tensor] = field(default_factory=dict)
    #: static per-bucket window width per spline kind
    window: Dict[str, int] = field(default_factory=dict)
    camera_cls: Optional[type] = None
    rdim: int = 3

    @property
    def M(self):
        return len(self.measurements) + sum(len(m) for m, _ in self.batches)


def _decompose_trajectory(trajectory) -> List[SplineInfo]:
    if isinstance(trajectory, UniformR3SplineTrajectory):
        return [SplineInfo("r3", trajectory)]
    if isinstance(trajectory, UniformSO3SplineTrajectory):
        return [SplineInfo("so3", trajectory)]
    if isinstance(trajectory, UniformSE3SplineTrajectory):
        return [SplineInfo("se3", trajectory)]
    if isinstance(trajectory, SplitTrajectory):
        return [SplineInfo("r3", trajectory.R3_spline),
                SplineInfo("so3", trajectory.SO3_spline)]
    raise TypeError(f"Unsupported trajectory type {type(trajectory)}")


def as_tensor(a, device, dtype):
    """An array (numpy, or a tensor on any device) as a tensor on
    ``device``: integers as int64, floats as ``dtype``."""
    if torch.is_tensor(a):
        a = a.detach().cpu().numpy()
    a = np.array(a)  # a writable copy: numpy views of JAX arrays are read-only
    dtype = torch.int64 if np.issubdtype(a.dtype, np.integer) else dtype
    return torch.as_tensor(a, device=device).to(dtype)


class Problem:
    """Compiled estimation problem on ``device`` (the CUDA card unless
    another is named) in ``dtype``."""

    def __init__(self, trajectory, measurements, device=None,
                 dtype=default_dtype):
        self.device = resolve_device(device)
        self.dtype = dtype
        self.trajectory = trajectory
        self.measurements = list(measurements)
        self.splines = _decompose_trajectory(trajectory)
        self.sensors: list = []
        self._sensor_index: dict = {}
        self.landmarks: list = []
        self._landmark_index: dict = {}
        self.buckets: Dict[str, Bucket] = {}
        self._lifting: list = []  # lifting measurements, in vt order

        for sp in self.splines:
            sp.active = np.zeros(sp.n, dtype=np.uint8)
        # the per-object rows' spans, activated in one pass at the end
        self._spans = []
        for m in self.measurements:
            self._add(m)
        spans = np.asarray(self._spans, dtype=np.float64).reshape(-1, 2)
        for sp in self.splines:
            native.activate_spans(spans[:, 0], spans[:, 1], sp.t0, sp.dt, sp.n,
                                  active=sp.active)
        del self._spans

        self._layout()
        self._finalize_buckets()
        self._bookkeeping()

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
        """Check one measurement's spans (reference CheckTimeSpans) and keep
        them for the activation pass."""
        t1, t2 = np.array(spans, dtype=np.float64).T
        native.check_spans(t1, t2, self.trajectory.min_time, self.trajectory.max_time)
        self._spans.extend(spans)

    def _activate_points(self, t, slack):
        """Check and activate a sorted batch of point measurements at times
        ``t`` with symmetric ``slack``, in one native pass per spline."""
        tmin, tmax = self.trajectory.min_time, self.trajectory.max_time
        for sp in self.splines:
            native.activate_points(t, slack, tmin, tmax, sp.t0, sp.dt, sp.n, active=sp.active)

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
        if isinstance(m, (GyroscopeMeasurements, AccelerometerMeasurements)):
            imu = m.imu
            s = self._sensor_id(imu)
            self._activate_points(m.t, 0.0 if imu.time_offset_locked else imu.max_time_offset)
            key = "gyro" if isinstance(m, GyroscopeMeasurements) else "accel"
            self._bucket(key, 3).batches.append((m, s))
        elif isinstance(m, PositionMeasurement):
            self._activate([(m.t, m.t)])
            self._bucket("position", 3).measurements.append(m)
        elif isinstance(m, OrientationMeasurement):
            self._activate([(m.t, m.t)])
            self._bucket("orientation", 1).measurements.append(m)
        elif isinstance(m, (GyroscopeMeasurement, AccelerometerMeasurement)):
            imu = m.imu
            s = self._sensor_id(imu)
            if imu.time_offset_locked:
                spans = [(m.t, m.t)]
            else:
                spans = [(m.t - imu.max_time_offset, m.t + imu.max_time_offset)]
            self._activate(spans)
            key = "gyro" if isinstance(m, GyroscopeMeasurement) else "accel"
            self._bucket(key, 3).measurements.append((m, s))
        elif isinstance(m, (StaticRsCameraMeasurement, NewtonRsCameraMeasurement,
                            LiftingRsCameraMeasurement)):
            if not isinstance(m.camera, PinholeCamera):
                raise TypeError(f"Unsupported camera type {type(m.camera)}")
            s = self._sensor_id(m.camera)
            li = self._landmark_id(m.observation.landmark)
            self._activate(self._camera_spans(m))
            if isinstance(m, StaticRsCameraMeasurement):
                key, rdim = "rs_static", 2
            elif isinstance(m, NewtonRsCameraMeasurement):
                key, rdim = "rs_newton", 2
            else:
                key, rdim = "rs_lifting", 3
                self._lifting.append(m)
            cam_cls = AtanCamera if isinstance(m.camera, AtanCamera) else PinholeCamera
            bucket = self._bucket(f"{key}:{cam_cls.__name__}", rdim, camera_cls=cam_cls)
            bucket.measurements.append((m, s, li))
        else:
            raise TypeError(f"Unsupported measurement type {type(m)}")

    # ------------------------------------------------------------------
    # tangent layout + state
    # ------------------------------------------------------------------
    def _tensor(self, a):
        return as_tensor(a, self.device, self.dtype)

    def _layout(self):
        offset = 0
        for sp in self.splines:
            sp.tangent_offset = offset
            offset += sp.n * sp.tangent_dim
        self.sensor_offset = offset
        offset += len(self.sensors) * SENSOR_TANGENT_DIM
        self.landmark_offset = offset
        offset += len(self.landmarks)
        self.vt_offset = offset
        offset += len(self._lifting)
        self.num_tangent = offset

        state = {}
        for sp in self.splines:
            state[sp.kind] = np.array(sp.obj.knots, dtype=np.float64)
        S = max(len(self.sensors), 1)
        q_ct = np.tile(np.array([1.0, 0, 0, 0]), (S, 1))
        p_ct = np.zeros((S, 3))
        d = np.zeros(S)
        ab = np.zeros((S, 3))
        gb = np.zeros((S, 3))
        for i, sensor in enumerate(self.sensors):
            q_ct[i], p_ct[i] = sensor.relative_pose
            d[i] = sensor.time_offset
            if isinstance(sensor, ConstantBiasImu):
                ab[i] = sensor.accelerometer_bias
                gb[i] = sensor.gyroscope_bias
        state["q_ct"] = q_ct
        state["p_ct"] = p_ct
        state["d"] = d
        state["abias"] = ab
        state["gbias"] = gb
        state["rho"] = np.array([lm.inverse_depth for lm in self.landmarks],
                                dtype=np.float64)
        state["vt"] = np.array([m.vt for m in self._lifting], dtype=np.float64)
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
            if isinstance(sensor, ConstantBiasImu):
                if not sensor.accelerometer_bias_locked:
                    sm[SLOT_AB] = 1.0
                if not sensor.gyroscope_bias_locked:
                    sm[SLOT_GB] = 1.0
            mask[base: base + SENSOR_TANGENT_DIM] = sm
        for li, lm in enumerate(self.landmarks):
            mask[self.landmark_offset + li] = 0.0 if lm.locked else 1.0
        mask[self.vt_offset: self.vt_offset + len(self._lifting)] = 1.0
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
            if kind in ("position", "orientation"):
                ms = b.measurements
                data["t"] = np.array([m.t for m in ms])
                data["y"] = np.stack([m.p if kind == "position" else m.q for m in ms])
                for sp in self.splines:
                    b.window[sp.kind] = self._window_width(sp)
            elif kind in ("gyro", "accel"):
                # per-object rows first, then each batch's arrays
                ms = [m for m, _ in b.measurements]
                val = "w" if kind == "gyro" else "a"
                parts = [(np.array([m.t for m in ms], dtype=np.float64),
                          np.array([getattr(m, val) for m in ms],
                                   dtype=np.float64).reshape(-1, 3),
                          np.array([m.weight for m in ms], dtype=np.float64),
                          np.array([s for _, s in b.measurements], dtype=np.int64))]
                parts += [(batch.t, getattr(batch, val), batch.weight,
                           np.full(len(batch), s, dtype=np.int64))
                          for batch, s in b.batches]
                for key_, col in zip(("t", "y", "weight", "sid"), zip(*parts)):
                    data[key_] = np.concatenate(col)
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
                if b.camera_cls is AtanCamera:
                    data["wc"] = np.stack([c.wc for c in cams])
                    data["gamma"] = np.array([c.gamma for c in cams])
                data["weight"] = np.array([m.weight for m in ms])
                data["huber_c"] = np.array([m.huber_loss for m in ms])
                if kind == "rs_lifting":
                    vt_index = {id(m): i for i, m in enumerate(self._lifting)}
                    data["vt_idx"] = np.array([vt_index[id(m)] for m in ms], dtype=np.int64)
                    data["vt_orig"] = np.array([m.vt_orig for m in ms])
                readout = max((c.readout for c in cams), default=0.0)
                for sp in self.splines:
                    b.window[sp.kind] = self._window_width(sp, readout=readout)
            b.data = {k: self._tensor(v) for k, v in data.items()}

    # ------------------------------------------------------------------
    # Ceres-style program counts
    # ------------------------------------------------------------------
    def _bookkeeping(self):
        """Parameter and residual counts as Ceres reports them: a parameter
        block per active knot, sensor parameter, landmark and lifted row
        time; a residual block per measurement, reduced when one of its
        parameters is free (a lifting row's ``vt`` always is)."""
        locked_traj = self.trajectory.locked if self.splines else True
        blocks = []  # (ambient size, constant)
        for sp in self.splines:
            blocks += [(sp.knot_dim, locked_traj)] * int(np.count_nonzero(sp.active))
        for sensor in self.sensors:
            blocks.append((4, sensor.relative_orientation_locked))
            blocks.append((3, sensor.relative_position_locked))
            blocks.append((1, sensor.time_offset_locked))
            if isinstance(sensor, ConstantBiasImu):
                blocks.append((3, sensor.accelerometer_bias_locked))
                blocks.append((3, sensor.gyroscope_bias_locked))
        blocks += [(1, lm.locked) for lm in self.landmarks]
        blocks += [(1, False)] * len(self._lifting)

        self.num_parameters = sum(n for n, _ in blocks)
        self.num_parameter_blocks = len(blocks)
        self.num_parameters_reduced = sum(n for n, const in blocks if not const)
        self.num_parameter_blocks_reduced = sum(1 for _, const in blocks if not const)

        self.num_residual_blocks = sum(b.M for b in self.buckets.values())
        self.num_residuals = sum(b.rdim * b.M for b in self.buckets.values())
        # Trajectory knots enter every residual here, so a free trajectory
        # keeps every block; otherwise a block needs a free sensor parameter
        # or a free landmark (pose rows have neither).
        any_free_traj = not locked_traj and any(sp.active.any() for sp in self.splines)

        def sensor_free(s):
            sensor = self.sensors[s]
            free = not (sensor.relative_orientation_locked
                        and sensor.relative_position_locked
                        and sensor.time_offset_locked)
            if isinstance(sensor, ConstantBiasImu):
                free = free or not (sensor.accelerometer_bias_locked
                                    and sensor.gyroscope_bias_locked)
            return free

        self.num_residual_blocks_reduced = 0
        self.num_residuals_reduced = 0
        for b in self.buckets.values():
            lifting = b.kind.split(":")[0] == "rs_lifting"
            for entry in b.measurements:
                free = any_free_traj or lifting
                if isinstance(entry, tuple):
                    free = free or sensor_free(entry[1])
                    if len(entry) == 3:
                        free = free or not self.landmarks[entry[2]].locked
                if free:
                    self.num_residual_blocks_reduced += 1
                    self.num_residuals_reduced += b.rdim
            for batch, s in b.batches:
                if any_free_traj or sensor_free(s):
                    self.num_residual_blocks_reduced += len(batch)
                    self.num_residuals_reduced += b.rdim * len(batch)

    # ------------------------------------------------------------------
    # write-back
    # ------------------------------------------------------------------
    def write_back(self, state):
        """Copy ``state`` (a dict of tensors on any device, of any float
        dtype) into the float64 trajectory, sensor, landmark and
        lifting-measurement objects: knots with re-normalised quaternions
        (in float64), relative poses, time offsets clipped to their bounds,
        IMU biases, inverse depths and row times ``vt``."""
        state = {k: v.detach().cpu().double().numpy() for k, v in state.items()}
        for sp in self.splines:
            arr = state[sp.kind]
            if sp.kind == "so3":
                arr = arr / np.linalg.norm(arr, axis=-1, keepdims=True)
            elif sp.kind == "se3":
                q = arr[:, :4]
                arr = np.concatenate(
                    [q / np.linalg.norm(q, axis=-1, keepdims=True), arr[:, 4:]], axis=1)
            sp.obj.set_knots(arr)
        for i, sensor in enumerate(self.sensors):
            q = state["q_ct"][i]
            sensor.relative_pose = (q / np.linalg.norm(q), state["p_ct"][i])
            sensor.time_offset = float(
                np.clip(state["d"][i], -sensor.max_time_offset, sensor.max_time_offset))
            if isinstance(sensor, ConstantBiasImu):
                sensor.accelerometer_bias = state["abias"][i]
                sensor.gyroscope_bias = state["gbias"][i]
        for li, lm in enumerate(self.landmarks):
            lm.inverse_depth = float(state["rho"][li])
        for mi, m in enumerate(self._lifting):
            m.vt = float(state["vt"][mi])


# ---------------------------------------------------------------------------
# raw (array-level) problems
# ---------------------------------------------------------------------------

@dataclass
class RawSplineInfo:
    """Array-backed stand-in for ``SplineInfo`` (no trajectory object)."""

    kind: str
    n: int
    t0: float
    dt: float
    tangent_offset: int = 0

    @property
    def knot_dim(self):
        return KNOT_DIMS[self.kind]

    @property
    def tangent_dim(self):
        return TANGENT_DIMS[self.kind]


@dataclass
class RawBucket:
    """Array-backed stand-in for ``Bucket``: data arrays only, no objects."""

    kind: str
    M: int
    rdim: int
    data: Dict[str, object] = field(default_factory=dict)
    window: Dict[str, int] = field(default_factory=dict)
    camera_cls: Optional[type] = None


class RawProblem:
    """A compiled problem built directly from arrays (counterpart of
    ``kontiki_tpu.solver.problem.RawProblem``), with the attributes the
    solver layers read (``problem_spec``, ``problem_runtime``,
    ``parallel.segments_ba``), on ``device`` (the CUDA card unless another
    is named) in ``dtype``.

    ``splines``: list of ``(kind, knots [n, D], t0, dt)``; ``buckets``: dict
    key -> ``RawBucket`` (data complete, windows set; arrays or tensors,
    placed on ``device`` here, integers as int64); ``sensors``: state arrays
    ``{q_ct [S, 4], p_ct [S, 3], d [S], abias, gbias}`` plus ``mask [S, 13]``
    tangent mask rows and ``d_max [S]``; ``rho [L]`` initial inverse depths,
    ``landmark_mask [L]`` (default all free); ``vt [V]`` the lifted row
    times of array-level lifting rows (after the landmarks in the tangent
    vector, always free; None: none). Knots are all free."""

    def __init__(self, splines, buckets, sensors, rho, landmark_mask=None, vt=None,
                 device=None, dtype=default_dtype):
        self.device = resolve_device(device)
        self.dtype = dtype
        self.splines = []
        state = {}
        offset = 0
        for kind, knots, t0, dt in splines:
            knots = np.asarray(knots, dtype=np.float64)
            info = RawSplineInfo(kind, knots.shape[0], float(t0), float(dt), offset)
            offset += info.n * info.tangent_dim
            self.splines.append(info)
            state[kind] = knots
        self.sensor_offset = offset
        S = int(np.asarray(sensors["q_ct"]).shape[0])
        offset += S * SENSOR_TANGENT_DIM
        self.landmark_offset = offset
        L = int(np.asarray(rho).shape[0])
        offset += L
        self.vt_offset = offset
        vt = np.zeros(0) if vt is None else np.asarray(vt, dtype=np.float64)
        V = vt.shape[0]
        offset += V
        self.num_tangent = offset

        for k in ("q_ct", "p_ct", "d", "abias", "gbias"):
            state[k] = np.asarray(sensors.get(k, np.zeros((S, 3) if k != "d" else S)),
                                  dtype=np.float64)
        state["rho"] = np.asarray(rho, dtype=np.float64)
        state["vt"] = vt
        self.state0 = {k: self._tensor(v) for k, v in state.items()}
        self.d_max = self._tensor(np.asarray(sensors.get("d_max", np.zeros(max(S, 1))),
                                             dtype=np.float64))

        mask = np.zeros(self.num_tangent)
        for sp in self.splines:
            mask[sp.tangent_offset: sp.tangent_offset + sp.n * sp.tangent_dim] = 1.0
        smask = np.asarray(sensors.get("mask", np.zeros((S, SENSOR_TANGENT_DIM))),
                           dtype=np.float64)
        mask[self.sensor_offset: self.sensor_offset + S * SENSOR_TANGENT_DIM] = smask.reshape(-1)
        lmask = np.ones(L) if landmark_mask is None else np.asarray(landmark_mask, np.float64)
        mask[self.landmark_offset: self.landmark_offset + L] = lmask
        mask[self.vt_offset: self.vt_offset + V] = 1.0
        self.mask = self._tensor(mask)

        self.buckets = {}
        for key, b in buckets.items():
            data = {k: self._tensor(v) for k, v in b.data.items()}
            self.buckets[key] = RawBucket(b.kind, b.M, b.rdim, data, dict(b.window),
                                          b.camera_cls)
        # len()-able stand-ins for the object lists
        self.sensors = list(range(S))
        self.landmarks = list(range(L))
        self._lifting = list(range(V))

        self.num_residual_blocks = sum(b.M for b in self.buckets.values())
        self.num_residuals = sum(b.M * b.rdim for b in self.buckets.values())
        self.num_residual_blocks_reduced = self.num_residual_blocks
        self.num_residuals_reduced = self.num_residuals
        self.num_parameters = self.num_tangent
        self.num_parameter_blocks = sum(sp.n for sp in self.splines) + 3 * S + L + V
        self.num_parameters_reduced = int(np.count_nonzero(mask > 0))
        self.num_parameter_blocks_reduced = self.num_parameter_blocks

    def _tensor(self, a):
        return as_tensor(a, self.device, self.dtype)
