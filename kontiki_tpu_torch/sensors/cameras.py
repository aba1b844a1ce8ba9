"""Camera sensor classes (reference: sensors/camera.h, pinhole_camera.h,
atan_camera.h + bindings camera_help.h:25-49).

``project``/``unproject``/``evaluate_projection`` operate in the **camera
coordinate frame** — the relative pose is NOT applied (same as the
reference, camera.h:59-67 and its TODO.md:2-4). Intrinsics are not
optimizable. These host-side methods are plain numpy; the solver's batched
projection lives in :mod:`kontiki_tpu_torch.sensors.camera_models` and in
the camera-row kernels."""
import numpy as np

from ..config import host_dtype
from .base import Sensor

_EPS = 1e-32


class Camera(Sensor):
    def __init__(self, rows, cols, readout):
        super().__init__()
        self.rows = int(rows)
        self.cols = int(cols)
        self.readout = float(readout)

    def evaluate_projection(self, X, dX, derive=True):
        """Project camera-frame point X with time derivative dX.

        Returns (y, dy); dy is zeros when derive=False."""
        raise NotImplementedError

    def project(self, X):
        "Project a point in the camera coordinate frame to pixels"
        return self.evaluate_projection(X, np.zeros(3), False)[0]

    def unproject(self, y):
        "Image point -> (x, y, 1) ray in the camera coordinate frame"
        raise NotImplementedError


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

    def evaluate_projection(self, X, dX, derive=True):
        # pinhole_camera.h:47-61: hnormalized projection + quotient-rule dy
        p = np.asarray(X, dtype=host_dtype) @ self._K.T
        y = p[..., :2] / p[..., 2:3]
        if not derive:
            return y, np.zeros(2)
        dp = np.asarray(dX, dtype=host_dtype) @ self._K.T
        den = p[..., 2] * p[..., 2] + _EPS
        dy = (dp[..., :2] * p[..., 2:3] - p[..., :2] * dp[..., 2:3]) / den[..., None]
        return y, dy

    def unproject(self, y):
        y = np.asarray(y, dtype=host_dtype)
        ones = np.ones(y.shape[:-1] + (1,), dtype=y.dtype)
        return np.concatenate([y, ones], axis=-1) @ self._K_inv.T


class AtanCamera(PinholeCamera):
    """Pinhole intrinsics with the Devernay-Faugeras FOV distortion about
    the centre ``wc`` (normalised image coordinates) with parameter
    ``gamma``."""

    def __init__(self, rows, cols, readout, camera_matrix=None, wc=None, gamma=1.0):
        super().__init__(rows, cols, readout, camera_matrix)
        self.wc = np.zeros(2) if wc is None else wc
        self.gamma = float(gamma)

    @property
    def wc(self):
        return self._wc.copy()

    @wc.setter
    def wc(self, value):
        self._wc = np.asarray(value, dtype=host_dtype).reshape(2)

    def evaluate_projection(self, X, dX, derive=True):
        # atan_camera.h:54-103, with analytic derivative propagation
        X = np.asarray(X, dtype=host_dtype)
        gamma, wc = self.gamma, self._wc
        A = X[..., :2] / (X[..., 2:3] + _EPS)
        L = A - wc
        r = np.sqrt(np.sum(L * L, axis=-1) + _EPS)
        f = np.arctan(r * gamma) / gamma
        g = L / r[..., None]
        Yxy = wc + f[..., None] * g
        ones = np.ones(Yxy.shape[:-1] + (1,), dtype=Yxy.dtype)
        y = (np.concatenate([Yxy, ones], axis=-1) @ self._K.T)[..., :2]
        if not derive:
            return y, np.zeros(2)
        dX = np.asarray(dX, dtype=host_dtype)
        z2 = X[..., 2] * X[..., 2] + _EPS
        dx = (dX[..., 0] * X[..., 2] - X[..., 0] * dX[..., 2]) / z2
        dyv = (dX[..., 1] * X[..., 2] - X[..., 1] * dX[..., 2]) / z2
        common = g[..., 0] * dx + g[..., 1] * dyv
        df = common / (1.0 + gamma * gamma * r * r)
        du = f * ((dx * r - L[..., 0] * common) / (r * r)) + df * g[..., 0]
        dv = f * ((dyv * r - L[..., 1] * common) / (r * r)) + df * g[..., 1]
        dvec = np.stack([du, dv, np.zeros_like(du)], axis=-1)
        return y, (dvec @ self._K.T)[..., :2]

    def unproject(self, y):
        y = np.asarray(y, dtype=host_dtype)
        ones = np.ones(y.shape[:-1] + (1,), dtype=y.dtype)
        phn = np.concatenate([y, ones], axis=-1) @ self._K_inv.T
        L = phn[..., :2] - self._wc
        r = np.sqrt(np.sum(L * L, axis=-1) + _EPS)
        f = np.tan(r * self.gamma) / self.gamma
        Yxy = self._wc + f[..., None] * L / r[..., None]
        return np.concatenate([Yxy, ones], axis=-1)
