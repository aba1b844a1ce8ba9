"""NumPy quaternion/rotation helpers (wxyz), the counterpart of
``kontiki_tpu.rotations`` (the reference's pure-Python helpers):
conversions between quaternions, rotation matrices and axis-angle, random
and identity quaternions, Procrustes alignment and the rotation between two
vectors. These are host-side utilities, so plain NumPy serves."""
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


def rotation_matrix_to_quat(R):
    """Rotation matrix -> wxyz quaternion (Shepperd's method)."""
    tr = np.trace(R)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        q = np.array(
            [0.25 * s, (R[2, 1] - R[1, 2]) / s, (R[0, 2] - R[2, 0]) / s,
             (R[1, 0] - R[0, 1]) / s]
        )
    elif R[0, 0] > R[1, 1] and R[0, 0] > R[2, 2]:
        s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
        q = np.array(
            [(R[2, 1] - R[1, 2]) / s, 0.25 * s, (R[0, 1] + R[1, 0]) / s,
             (R[0, 2] + R[2, 0]) / s]
        )
    elif R[1, 1] > R[2, 2]:
        s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2
        q = np.array(
            [(R[0, 2] - R[2, 0]) / s, (R[0, 1] + R[1, 0]) / s, 0.25 * s,
             (R[1, 2] + R[2, 1]) / s]
        )
    else:
        s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2
        q = np.array(
            [(R[1, 0] - R[0, 1]) / s, (R[0, 2] + R[2, 0]) / s,
             (R[1, 2] + R[2, 1]) / s, 0.25 * s]
        )
    return q / np.linalg.norm(q)


def rotation_matrix_to_axis_angle(R):
    """Rotation matrix -> (unit axis, angle)."""
    q = rotation_matrix_to_quat(R)
    w = np.clip(q[0], -1.0, 1.0)
    theta = 2 * np.arccos(w)
    s = np.sqrt(max(1 - w * w, 0.0))
    if s < 1e-12:
        return np.array([1.0, 0.0, 0.0]), 0.0
    return q[1:] / s, theta


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


def random_quaternion(rng=None):
    """Uniform random unit quaternion (wxyz): a normalised draw of four
    standard normals from ``rng`` (a ``numpy.random.Generator``, or a seed
    for ``numpy.random.default_rng``; None draws fresh entropy)."""
    q = np.random.default_rng(rng).standard_normal(4)
    return q / np.linalg.norm(q)


def identity_quaternion():
    return np.array([1.0, 0.0, 0.0, 0.0])


def procrustes(X, Y, remove_mean=False):
    """Find rotation R (and optional translation) minimizing |R X - Y|.

    Returns R if remove_mean is False, else (R, t).
    """
    X = np.asarray(X, dtype=float)
    Y = np.asarray(Y, dtype=float)
    if remove_mean:
        mx = X.mean(axis=1, keepdims=True)
        my = Y.mean(axis=1, keepdims=True)
        Xc, Yc = X - mx, Y - my
    else:
        Xc, Yc = X, Y
    H = Yc @ Xc.T
    U, _, Vt = np.linalg.svd(H)
    D = np.diag([1.0, 1.0, np.linalg.det(U @ Vt)])
    R = U @ D @ Vt
    if remove_mean:
        t = my - R @ mx
        return R, t
    return R


def rotation_between_vectors(a, b):
    """Smallest rotation matrix R with R a ∝ b."""
    a = np.asarray(a, dtype=float)
    b = np.asarray(b, dtype=float)
    an = a / np.linalg.norm(a)
    bn = b / np.linalg.norm(b)
    v = np.cross(an, bn)
    c = np.dot(an, bn)
    if c < -1 + 1e-12:
        # 180 degrees: pick any orthogonal axis
        axis = np.cross(an, [1.0, 0.0, 0.0])
        if np.linalg.norm(axis) < 1e-8:
            axis = np.cross(an, [0.0, 1.0, 0.0])
        axis /= np.linalg.norm(axis)
        return quat_to_rotation_matrix(axis_angle_to_quat(axis, np.pi))
    vx = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
    return np.eye(3) + vx + vx @ vx / (1 + c)
