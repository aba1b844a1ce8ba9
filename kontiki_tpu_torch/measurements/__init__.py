"""Measurement (residual) definitions (counterpart of
``kontiki_tpu.measurements``): the pose kinds, the IMU kinds and the
static and lifting rolling-shutter camera kinds.

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
- LiftingRsCameraMeasurement: the observed row time lifted to a parameter
  ``vt`` in [0, 1] (observed time ``view.t0 + time_offset + vt * readout``);
  ``w * (uv - reproject, rows (vt - vt_orig))`` (3,)
  (lifting_rscamera_measurement.h:98-113).
"""
import numpy as np

from ..config import host_dtype
from ..rotations import quat_conj, quat_mult, quat_to_rotation_matrix

__all__ = [
    "PositionMeasurement",
    "OrientationMeasurement",
    "GyroscopeMeasurement",
    "AccelerometerMeasurement",
    "StaticRsCameraMeasurement",
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
