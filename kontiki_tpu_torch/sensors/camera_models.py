"""Camera projection on torch tensors (counterpart of
``kontiki_tpu.sensors.camera_models``):

- pinhole (reference pinhole_camera.h:47-67): ``y = (K X).hnormalized()``;
  the time derivative ``dy`` by the quotient rule with an ``eps = 1e-32``
  denominator guard; ``unproject = K^-1 (u, v, 1)``;
- atan, the Devernay-Faugeras FOV model (atan_camera.h:54-103): with
  ``A = X.xy / X.z``, ``L = A - wc``, ``r = |L|``, ``f = atan(r gamma) /
  gamma``, the projection is ``K (wc + f L / r, 1)``; the derivative
  propagates analytically. The same ``eps`` sits in ``X.z``, under the norm
  and in the quotients, so the derivative at the distortion centre is 0.

``K`` is ``[3, 3]`` or batched ``[..., 3, 3]``; ``wc [..., 2]`` and
``gamma [...]`` broadcast against the points. Camera intrinsics are not
optimizable (the reference keeps them in the camera's meta)."""
import torch

_EPS = 1e-32


def _apply(K, v):
    """``K v`` for ``K [..., 3, 3]`` and ``v [..., 3]``."""
    return (K @ v[..., None])[..., 0]


def _with_one(xy):
    return torch.cat([xy, torch.ones_like(xy[..., :1])], dim=-1)


def pinhole_project(K, X):
    """[..., 3] camera-frame point -> [..., 2] pixel."""
    p = _apply(K, X)
    return p[..., :2] / p[..., 2:3]


def pinhole_evaluate(K, X, dX):
    """Projection and its time derivative given ``dX/dt``: ``(y, dy)``."""
    p = _apply(K, X)
    dp = _apply(K, dX)
    y = p[..., :2] / p[..., 2:3]
    den = p[..., 2] * p[..., 2] + _EPS
    dy = (dp[..., :2] * p[..., 2:3] - p[..., :2] * dp[..., 2:3]) / den[..., None]
    return y, dy


def pinhole_unproject(K_inv, y):
    """[..., 2] pixel -> [..., 3] camera ray on the z = 1 plane."""
    return _apply(K_inv, _with_one(y))


def _atan_parts(wc, gamma, X):
    A = X[..., :2] / (X[..., 2:3] + _EPS)
    L = A - wc
    r = torch.sqrt(torch.sum(L * L, dim=-1) + _EPS)
    f = torch.atan(r * gamma) / gamma
    g = L / r[..., None]
    return L, r, f, g


def atan_project(K, wc, gamma, X):
    """Devernay-Faugeras FOV projection: [..., 3] -> [..., 2] pixel."""
    _, _, f, g = _atan_parts(wc, gamma, X)
    return _apply(K, _with_one(wc + f[..., None] * g))[..., :2]


def atan_evaluate(K, wc, gamma, X, dX):
    """Atan projection and its time derivative given ``dX/dt``: ``(y, dy)``."""
    L, r, f, g = _atan_parts(wc, gamma, X)
    y = _apply(K, _with_one(wc + f[..., None] * g))[..., :2]
    z2 = X[..., 2] * X[..., 2] + _EPS
    dx = (dX[..., 0] * X[..., 2] - X[..., 0] * dX[..., 2]) / z2
    dyv = (dX[..., 1] * X[..., 2] - X[..., 1] * dX[..., 2]) / z2
    common = g[..., 0] * dx + g[..., 1] * dyv
    df = common / (1.0 + gamma * gamma * r * r)
    du = f * ((dx * r - L[..., 0] * common) / (r * r)) + df * g[..., 0]
    dv = f * ((dyv * r - L[..., 1] * common) / (r * r)) + df * g[..., 1]
    dvec = torch.stack([du, dv, torch.zeros_like(du)], dim=-1)
    return y, _apply(K, dvec)[..., :2]


def atan_unproject(K_inv, wc, gamma, y):
    """Inverse of ``atan_project`` onto the z = 1 plane."""
    phn = _apply(K_inv, _with_one(y))
    L = phn[..., :2] - wc
    r = torch.sqrt(torch.sum(L * L, dim=-1) + _EPS)
    f = torch.tan(r * gamma) / gamma
    return _with_one(wc + f[..., None] * L / r[..., None])
