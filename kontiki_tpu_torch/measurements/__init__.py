"""Measurement (residual) definitions (counterpart of
``kontiki_tpu.measurements``): the pose kinds, the IMU kinds and the
static, Newton and lifting rolling-shutter camera kinds.

Each class carries its data and sensors and exposes ``measure(trajectory)``
/ ``error(trajectory)`` like the reference bindings
(measurement_helper.h:13-27), through the host object API. The solver-side
struct-of-arrays compilation lives in ``kontiki_tpu_torch.solver.problem``.

- PositionMeasurement: ``p - p_hat(t)`` (3,), unit weight
  (position_measurement.h:17-82).
- OrientationMeasurement: angular distance ``angle(q, q_hat(t))`` (1,)
  (orientation_measurement.h:119-137).
- Gyroscope/Accelerometer: ``w * (meas - imu.f(traj, t))`` (3,)
  (gyroscope_measurement.h / accelerometer_measurement.h).
- StaticRsCameraMeasurement: ``w * (uv - reproject(...))`` with Huber c=5
  and weight 1 defaults (static_rscamera_measurement.h:65-69). Row time is
  ``view.t0 + time_offset + v * readout / rows``.
- NewtonRsCameraMeasurement: ``w * (uv - y)`` where ``y`` is the
  reprojection at the observed row time found by at most five Newton steps
  on ``v(t) - rows (t - t0) / readout`` from the observation's row, each
  time clamped to the frame's readout until a step is under half a row
  (newton_rscamera_measurement.h:23-120).
- LiftingRsCameraMeasurement: the observed row time lifted to a parameter
  ``vt`` in [0, 1] (observed time ``view.t0 + time_offset + vt * readout``);
  ``w * (uv - reproject, rows (vt - vt_orig))`` (3,)
  (lifting_rscamera_measurement.h:98-113).
- GyroscopeMeasurements / AccelerometerMeasurements: batches of IMU rows as
  arrays (sorted times ``[M]``, values ``[M, 3]``, scalar or ``[M]``
  weights), the long-sequence path: ``Problem`` activates their knots in
  one native pass and splices the arrays into the bucket, and ``measure``
  evaluates all times in one trajectory query.
"""
import numpy as np
import torch

from ..config import host_dtype
from ..constants import GRAVITY
from ..math import quaternion as quat
from ..rotations import quat_conj, quat_mult, quat_to_rotation_matrix

__all__ = [
    "PositionMeasurement",
    "OrientationMeasurement",
    "GyroscopeMeasurement",
    "AccelerometerMeasurement",
    "StaticRsCameraMeasurement",
    "NewtonRsCameraMeasurement",
    "LiftingRsCameraMeasurement",
]


class PositionMeasurement:
    """World-position measurement at time t (reference position_measurement.h)."""

    def __init__(self, t, p):
        self.t = float(t)
        self.p = np.asarray(p, dtype=host_dtype).reshape(3)

    def measure(self, trajectory):
        return trajectory.position(self.t)

    def error(self, trajectory):
        return self.p - self.measure(trajectory)


class OrientationMeasurement:
    """Orientation measurement; scalar angular-distance residual
    (reference orientation_measurement.h)."""

    def __init__(self, t, q):
        self.t = float(t)
        self.q = np.asarray(q, dtype=host_dtype).reshape(4)

    def measure(self, trajectory):
        return trajectory.orientation(self.t)

    def error(self, trajectory):
        qhat = self.measure(trajectory)
        # Eigen angularDistance: 2 atan2(|vec(d)|, |w(d)|), d = q^-1 qhat
        d = quat_mult(quat_conj(self.q), qhat)
        return 2.0 * np.arctan2(np.linalg.norm(d[1:]), abs(d[0]))


class GyroscopeMeasurement:
    """Body-frame angular rate (reference gyroscope_measurement.h)."""

    def __init__(self, imu, t, w, weight=1.0):
        self.imu = imu
        self.t = float(t)
        self.w = np.asarray(w, dtype=host_dtype).reshape(3)
        self.weight = float(weight)

    def measure(self, trajectory):
        return self.imu.gyroscope(trajectory, self.t)

    def error(self, trajectory):
        return self.weight * (self.w - self.measure(trajectory))


class AccelerometerMeasurement:
    """Body-frame specific force incl. gravity (reference
    accelerometer_measurement.h)."""

    def __init__(self, imu, t, a, weight=1.0):
        self.imu = imu
        self.t = float(t)
        self.a = np.asarray(a, dtype=host_dtype).reshape(3)
        self.weight = float(weight)

    def measure(self, trajectory):
        return self.imu.accelerometer(trajectory, self.t)

    def error(self, trajectory):
        return self.weight * (self.a - self.measure(trajectory))


def _qrot(q, v):
    return quat_to_rotation_matrix(q) @ v


def _reproject_static(ref, obs, rho, trajectory, camera, t_obs=None):
    """Inverse-depth two-view reprojection (reference
    static_rscamera_measurement.h:21-55). ``t_obs``, where given, overrides
    the observation's row time (the lifting measurement's)."""
    d = camera.time_offset
    row_delta = camera.readout / camera.rows
    t_ref = ref.view.t0 + d + ref.v * row_delta
    if t_obs is None:
        t_obs = obs.view.t0 + d + obs.v * row_delta

    q_ct, p_ct = camera.relative_pose
    q_ct_conj = quat_conj(q_ct)

    yh = camera.unproject(ref.uv)
    X_ref = _qrot(q_ct_conj, yh - rho * p_ct)
    q_ref = trajectory.orientation(t_ref)
    p_ref = trajectory.position(t_ref)
    X = _qrot(q_ref, X_ref) + rho * p_ref
    q_obs = trajectory.orientation(t_obs)
    p_obs = trajectory.position(t_obs)
    X_obs = _qrot(quat_conj(q_obs), X - rho * p_obs)
    X_camera = _qrot(q_ct, X_obs) + rho * p_ct
    return camera.project(X_camera)


class StaticRsCameraMeasurement:
    """Rolling-shutter reprojection using the *observed* row time
    (reference static_rscamera_measurement.h)."""

    def __init__(self, camera, obs, huber_loss=5.0, weight=1.0):
        self.camera = camera
        self.observation = obs
        self.huber_loss = float(huber_loss)
        self.weight = float(weight)

    def project(self, trajectory):
        lm = self.observation.landmark
        return _reproject_static(
            lm.reference, self.observation, lm.inverse_depth, trajectory, self.camera
        )

    def measure(self, trajectory):
        return self.project(trajectory)

    def error(self, trajectory):
        return self.weight * (self.observation.uv - self.project(trajectory))


class NewtonRsCameraMeasurement:
    """Rolling-shutter reprojection solving the row-time constraint with a
    bounded Newton iteration inside the residual (reference
    newton_rscamera_measurement.h:23-120)."""

    def __init__(self, camera, obs, huber_loss=5.0, weight=1.0):
        self.camera = camera
        self.observation = obs
        self.huber_loss = float(huber_loss)
        self.weight = float(weight)
        self.max_iterations = 5

    def project(self, trajectory):
        cam = self.camera
        obs = self.observation
        lm = obs.landmark
        ref = lm.reference
        rho = lm.inverse_depth

        d = cam.time_offset
        row_delta = cam.readout / cam.rows
        t0_obs = obs.view.t0 + d
        t_ref = ref.view.t0 + d + ref.v * row_delta
        t_obs = t0_obs + obs.v * row_delta

        q_ct, p_ct = cam.relative_pose
        yh = cam.unproject(ref.uv)
        X_ref = _qrot(quat_conj(q_ct), yh - rho * p_ct)
        X = _qrot(trajectory.orientation(t_ref), X_ref) + rho * trajectory.position(t_ref)

        max_dt = 0.5 * cam.readout / cam.rows
        min_bound, max_bound = t0_obs, t0_obs + cam.readout
        R_ct = quat_to_rotation_matrix(q_ct)

        def sandwich(qa, x, qb):
            return quat_mult(qa, quat_mult(np.concatenate([[0.0], x]), qb))[1:]

        y_out = None
        for _ in range(self.max_iterations):
            p = trajectory.position(t_obs)
            dp = trajectory.velocity(t_obs)
            q = trajectory.orientation(t_obs)
            w = trajectory.angular_velocity(t_obs)
            dq = 0.5 * quat_mult(np.concatenate([[0.0], w]), q)

            s = X - rho * p
            ds = -rho * dp
            X_obs_cam = R_ct @ (quat_to_rotation_matrix(q).T @ s) + rho * p_ct
            dX_obs = (sandwich(quat_conj(dq), s, q) + sandwich(quat_conj(q), ds, q)
                      + sandwich(quat_conj(q), s, dq))
            # the reference adds the constant offset to the time derivative
            # too (newton_rscamera_measurement.h:91); kept for parity
            dX_obs_cam = R_ct @ dX_obs + rho * p_ct

            y_out, dy = cam.evaluate_projection(X_obs_cam, dX_obs_cam, True)
            f = y_out[1] - cam.rows * (t_obs - t0_obs) / cam.readout
            df = dy[1] - cam.rows / cam.readout
            dt = f / df
            t_obs = t_obs - dt
            if dt * dt < max_dt * max_dt:
                break
            t_obs = np.clip(t_obs, min_bound, max_bound)
        return y_out

    def measure(self, trajectory):
        return self.project(trajectory)

    def error(self, trajectory):
        return self.weight * (self.observation.uv - self.project(trajectory))


class LiftingRsCameraMeasurement:
    """Rolling-shutter reprojection with the normalized row time lifted to an
    optimization parameter ``vt`` in [0, 1]; the residual is the 2D
    reprojection plus a row-timing term (reference
    lifting_rscamera_measurement.h:98-113)."""

    def __init__(self, camera, obs, huber_loss=5.0, weight=1.0):
        self.camera = camera
        self.observation = obs
        self.huber_loss = float(huber_loss)
        self.weight = float(weight)
        self.vt_orig = obs.v / camera.rows
        self.vt = self.vt_orig

    def project(self, trajectory):
        lm = self.observation.landmark
        t_obs = (self.observation.view.t0 + self.camera.time_offset
                 + self.vt * self.camera.readout)
        return _reproject_static(lm.reference, self.observation, lm.inverse_depth,
                                 trajectory, self.camera, t_obs=t_obs)

    def measure(self, trajectory):
        return self.project(trajectory)

    def error(self, trajectory):
        e = np.empty(3, dtype=host_dtype)
        e[:2] = self.observation.uv - self.project(trajectory)
        e[2] = self.camera.rows * (self.vt - self.vt_orig)
        return self.weight * e


# ---------------------------------------------------------------------------
# Batch (struct-of-arrays) IMU containers: the long-sequence path. Adding
# 10^5 measurement objects one at a time makes problem compilation a Python
# loop; these carry dense arrays end to end.
# ---------------------------------------------------------------------------


class _ImuMeasurements:
    """Base batch IMU container: times [M] (sorted), values [M, 3],
    scalar or [M] weights."""

    _value_field = "y"

    def __init__(self, imu, t, y, weight=1.0):
        self.imu = imu
        self.t = np.ascontiguousarray(t, dtype=host_dtype)
        y = np.ascontiguousarray(y, dtype=host_dtype)
        if y.shape != (len(self.t), 3):
            raise ValueError(f"values must be [{len(self.t)}, 3], got {y.shape}")
        if len(self.t) > 1 and np.any(np.diff(self.t) < 0):
            raise ValueError("batch measurement times must be sorted")
        setattr(self, self._value_field, y)
        self.weight = np.broadcast_to(
            np.asarray(weight, dtype=host_dtype), (len(self.t),)
        ).copy()

    def __len__(self):
        return len(self.t)

    def _body(self, trajectory):
        """The trajectory at every ``t + time_offset`` in one query (its
        device), and the body-frame rotation of a world vector there."""
        res = trajectory._eval(self.t + self.imu.time_offset)
        q_conj = quat.qconj(torch.from_numpy(res["orientation"]))
        return res, lambda v: quat.qrotate(q_conj, torch.from_numpy(v)).numpy()

    def error(self, trajectory):
        return self.weight[:, None] * (
            getattr(self, self._value_field) - self.measure(trajectory)
        )


class GyroscopeMeasurements(_ImuMeasurements):
    """Batch of body-frame angular-rate measurements (the struct-of-arrays
    form of GyroscopeMeasurement, gyroscope_measurement.h:26-105)."""

    _value_field = "w"

    def measure(self, trajectory):
        res, to_body = self._body(trajectory)
        return to_body(res["angular_velocity"]) + getattr(
            self.imu, "gyroscope_bias", np.zeros(3))


class AccelerometerMeasurements(_ImuMeasurements):
    """Batch of body-frame specific-force measurements (the struct-of-arrays
    form of AccelerometerMeasurement, accelerometer_measurement.h:17-114)."""

    _value_field = "a"

    def measure(self, trajectory):
        res, to_body = self._body(trajectory)
        return to_body(res["acceleration"] + GRAVITY) + getattr(
            self.imu, "accelerometer_bias", np.zeros(3))


__all__ += ["GyroscopeMeasurements", "AccelerometerMeasurements"]
