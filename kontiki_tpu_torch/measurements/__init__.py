"""Measurement (residual) definitions (counterpart of
``kontiki_tpu.measurements``): the kinds BASELINE config 4 uses.

Each class carries its data and sensors and exposes ``measure(trajectory)``
/ ``error(trajectory)`` like the reference bindings
(measurement_helper.h:13-27), through the host object API. The solver-side
struct-of-arrays compilation lives in ``kontiki_tpu_torch.solver.problem``.

- Gyroscope/Accelerometer: ``w * (meas - imu.f(traj, t))`` (3,)
  (gyroscope_measurement.h / accelerometer_measurement.h).
- StaticRsCameraMeasurement: ``w * (uv - reproject(...))`` with Huber c=5
  and weight 1 defaults (static_rscamera_measurement.h:65-69). Row time is
  ``view.t0 + time_offset + v * readout / rows``.
"""
import numpy as np

from ..config import host_dtype
from ..rotations import quat_conj, quat_to_rotation_matrix

__all__ = [
    "GyroscopeMeasurement",
    "AccelerometerMeasurement",
    "StaticRsCameraMeasurement",
]


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


def _reproject_static(ref, obs, rho, trajectory, camera):
    """Inverse-depth two-view reprojection (reference
    static_rscamera_measurement.h:21-55)."""
    d = camera.time_offset
    row_delta = camera.readout / camera.rows
    t_ref = ref.view.t0 + d + ref.v * row_delta
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
