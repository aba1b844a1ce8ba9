"""IMU sensors (reference: sensors/imu.h, basic_imu.h).

Measurement functions (body frame, evaluated at ``t + time_offset``):

- gyroscope:      ``q(t+d)^* . omega_world(t+d)``            (imu.h:47-52)
- accelerometer:  ``q(t+d)^* . (a_world(t+d) + g)``, g = (0,0,-9.80665)
                                                             (imu.h:55-59)

Like the reference, the relative pose is NOT applied to IMU measurements
(known gap recorded in its TODO.md:6)."""
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
