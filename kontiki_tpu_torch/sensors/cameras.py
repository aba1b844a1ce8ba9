"""Camera sensor classes (reference: sensors/camera.h, pinhole_camera.h +
bindings camera_help.h:25-49); the pinhole model only.

``project``/``unproject`` operate in the **camera coordinate frame** — the
relative pose is NOT applied (same as the reference, camera.h:59-67 and its
TODO.md:2-4). Intrinsics are not optimizable. These host-side methods are
plain numpy; the solver's batched projection lives in
:mod:`kontiki_tpu_torch.sensors.camera_models`."""
import numpy as np

from ..config import host_dtype
from .base import Sensor

class Camera(Sensor):
    def __init__(self, rows, cols, readout):
        super().__init__()
        self.rows = int(rows)
        self.cols = int(cols)
        self.readout = float(readout)


class PinholeCamera(Camera):
    def __init__(self, rows, cols, readout, camera_matrix=None):
        super().__init__(rows, cols, readout)
        if camera_matrix is None:
            camera_matrix = np.eye(3)
        self.camera_matrix = camera_matrix

    @property
    def camera_matrix(self):
        return self._K.copy()

    @camera_matrix.setter
    def camera_matrix(self, K):
        self._K = np.asarray(K, dtype=host_dtype).reshape(3, 3)
        self._K_inv = np.linalg.inv(self._K)

    def project(self, X):
        "Project a point in the camera coordinate frame to pixels (K X hnormalized)"
        p = np.asarray(X, dtype=host_dtype) @ self._K.T
        return p[..., :2] / p[..., 2:3]

    def unproject(self, y):
        "Image point -> (x, y, 1) ray in the camera coordinate frame"
        y = np.asarray(y, dtype=host_dtype)
        ones = np.ones(y.shape[:-1] + (1,), dtype=y.dtype)
        return np.concatenate([y, ones], axis=-1) @ self._K_inv.T
