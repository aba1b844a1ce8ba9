"""IMU sensors (reference: sensors/imu.h, basic_imu.h).

Measurement functions (body frame, evaluated at ``t + time_offset``):

- gyroscope:      ``q(t+d)^* . omega_world(t+d)``            (imu.h:47-52)
- accelerometer:  ``q(t+d)^* . (a_world(t+d) + g)``, g = (0,0,-9.80665)
                                                             (imu.h:55-59)

Like the reference, the relative pose is NOT applied to IMU measurements
(known gap recorded in its TODO.md:6). ``ConstantBiasImu`` adds constant
additive biases (two extra 3-vector parameters, locked by default;
constant_bias_imu.h)."""
import numpy as np

from ..config import host_dtype
from ..constants import GRAVITY
from ..rotations import quat_to_rotation_matrix
from .base import Sensor


class BasicImu(Sensor):
    def gyroscope(self, trajectory, t):
        te = t + self.time_offset
        q = trajectory.orientation(te)
        w = trajectory.angular_velocity(te)
        return quat_to_rotation_matrix(q).T @ w

    def accelerometer(self, trajectory, t):
        te = t + self.time_offset
        q = trajectory.orientation(te)
        a = trajectory.acceleration(te)
        return quat_to_rotation_matrix(q).T @ (a + GRAVITY)


class ConstantBiasImu(BasicImu):
    def __init__(self, abias=None, gbias=None):
        super().__init__()
        self._abias = np.zeros(3, dtype=host_dtype)
        self._gbias = np.zeros(3, dtype=host_dtype)
        if abias is not None:
            self.accelerometer_bias = abias
        if gbias is not None:
            self.gyroscope_bias = gbias
        self.accelerometer_bias_locked = True
        self.gyroscope_bias_locked = True

    @property
    def accelerometer_bias(self):
        return self._abias.copy()

    @accelerometer_bias.setter
    def accelerometer_bias(self, b):
        self._abias = np.asarray(b, dtype=host_dtype).reshape(3)

    @property
    def gyroscope_bias(self):
        return self._gbias.copy()

    @gyroscope_bias.setter
    def gyroscope_bias(self, b):
        self._gbias = np.asarray(b, dtype=host_dtype).reshape(3)

    def gyroscope(self, trajectory, t):
        return super().gyroscope(trajectory, t) + self._gbias

    def accelerometer(self, trajectory, t):
        return super().accelerometer(trajectory, t) + self._abias
