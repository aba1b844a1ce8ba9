"""NumPy quaternion/rotation helpers (wxyz), the subset of
``kontiki_tpu.rotations`` the port's object API and generators use."""
import numpy as np


def quat_to_rotation_matrix(q):
    """Unit wxyz quaternion -> 3x3 rotation matrix."""
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def axis_angle_to_quat(r_or_n, theta=None):
    """Axis-angle -> wxyz quaternion.

    Accepts either a rotation vector r (angle = |r|) or (unit axis, angle).
    """
    if theta is None:
        r = np.asarray(r_or_n, dtype=float)
        theta = np.linalg.norm(r)
        n = r / theta if theta > 0 else np.array([1.0, 0.0, 0.0])
    else:
        n = np.asarray(r_or_n, dtype=float)
    q = np.empty(4)
    q[0] = np.cos(theta / 2)
    q[1:] = np.sin(theta / 2) * n
    return q


def quat_mult(q1, q2):
    """Hamilton product of wxyz quaternions."""
    w1, x1, y1, z1 = q1
    w2, x2, y2, z2 = q2
    return np.array(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ]
    )


def quat_conj(q):
    """Quaternion conjugate."""
    return np.array([q[0], -q[1], -q[2], -q[3]])
