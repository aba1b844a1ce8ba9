"""SE(3) math on torch tensors, Sophus conventions (counterpart of
``kontiki_tpu.math.se3``).

An element is ``(q, t)``: unit wxyz quaternion ``[..., 4]`` and translation
``[..., 3]``; packed ``[..., 7] = [w,x,y,z, tx,ty,tz]``. A tangent is
``xi = [upsilon(3), omega(3)]``, translation first.
"""
import math

import torch

from .quaternion import qconj, qmul, qrotate, quat_to_matrix

_EPS = 1e-10  # theta^2 guard for Taylor branches


def skew(v):
    """3-vector -> 3x3 skew-symmetric matrix, batched."""
    x, y, z = v.unbind(-1)
    zeros = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zeros, -z, y], -1),
            torch.stack([z, zeros, -x], -1),
            torch.stack([-y, x, zeros], -1),
        ],
        dim=-2,
    )


def so3_exp_quat(omega):
    """Rotation vector -> unit quaternion wxyz, Taylor-guarded."""
    theta2 = torch.sum(omega * omega, dim=-1)
    small = theta2 <= _EPS
    theta = torch.sqrt(torch.where(small, 1.0, theta2))
    half = 0.5 * theta
    k = torch.where(small, 0.5 - theta2 / 48.0, torch.sin(half) / theta)
    w = torch.where(small, 1.0 - theta2 / 8.0, torch.cos(half))
    return torch.cat([w[..., None], k[..., None] * omega], dim=-1)


def so3_log(q):
    """Unit quaternion wxyz -> minimal rotation vector (Sophus SO3::log
    branch structure: Taylor for small |v|, +/- pi for w ~ 0, else
    2 atan(|v|/w)/|v|)."""
    w = q[..., 0]
    v = q[..., 1:]
    n2 = torch.sum(v * v, dim=-1)
    small_n = n2 <= _EPS
    n = torch.sqrt(torch.where(small_n, 1.0, n2))
    small_w = torch.abs(w) <= 1e-10

    w_safe = torch.where(torch.abs(w) <= _EPS, 1.0, w)
    k_small = 2.0 / w_safe - (2.0 / 3.0) * n2 / (w_safe ** 3)
    pi = torch.full_like(w, math.pi)
    k_pi = torch.where(w >= 0, pi, -pi) / n
    k_gen = 2.0 * torch.atan(n / torch.where(small_w, 1.0, w)) / n

    k = torch.where(small_n, k_small, torch.where(small_w, k_pi, k_gen))
    return k[..., None] * v


def _so3_left_jacobian(omega):
    """V(omega) = I + (1-cos)/t^2 W + (t-sin)/t^3 W^2, Taylor-guarded."""
    theta2 = torch.sum(omega * omega, dim=-1)
    small = theta2 <= _EPS
    theta = torch.sqrt(torch.where(small, 1.0, theta2))
    a = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    b = torch.where(
        small, 1.0 / 6.0 - theta2 / 120.0,
        (theta - torch.sin(theta)) / (theta2 * theta),
    )
    W = skew(omega)
    eye = torch.eye(3, dtype=omega.dtype, device=omega.device).expand(W.shape)
    return eye + a[..., None, None] * W + b[..., None, None] * (W @ W)


def _so3_left_jacobian_inv(omega):
    """V^{-1}(omega) = I - W/2 + (1/t^2 - (1+cos)/(2 t sin)) W^2, guarded."""
    theta2 = torch.sum(omega * omega, dim=-1)
    small = theta2 <= _EPS
    theta = torch.sqrt(torch.where(small, 1.0, theta2))
    sin_t = torch.sin(theta)
    safe = torch.where(small | (torch.abs(sin_t) <= _EPS), 1.0, 2.0 * theta * sin_t)
    c = torch.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        1.0 / torch.where(small, 1.0, theta2) - (1.0 + torch.cos(theta)) / safe,
    )
    W = skew(omega)
    eye = torch.eye(3, dtype=omega.dtype, device=omega.device).expand(W.shape)
    return eye - 0.5 * W + c[..., None, None] * (W @ W)


def se3_hat(xi):
    """Tangent [upsilon, omega] -> 4x4 matrix [[skew(omega), upsilon],[0,0]]."""
    upsilon, omega = xi[..., :3], xi[..., 3:]
    top = torch.cat([skew(omega), upsilon[..., :, None]], dim=-1)
    bottom = torch.zeros(xi.shape[:-1] + (1, 4), dtype=xi.dtype, device=xi.device)
    return torch.cat([top, bottom], dim=-2)


def se3_exp(xi):
    """Tangent -> (q, t)."""
    upsilon, omega = xi[..., :3], xi[..., 3:]
    q = so3_exp_quat(omega)
    V = _so3_left_jacobian(omega)
    return q, (V @ upsilon[..., None])[..., 0]


def se3_log(q, t):
    """(q, t) -> tangent [upsilon, omega]."""
    omega = so3_log(q)
    Vinv = _so3_left_jacobian_inv(omega)
    upsilon = (Vinv @ t[..., None])[..., 0]
    return torch.cat([upsilon, omega], dim=-1)


def se3_mul(qa, ta, qb, tb):
    """Group composition (qa,ta) * (qb,tb)."""
    return qmul(qa, qb), qrotate(qa, tb) + ta


def se3_inv(q, t):
    """Group inverse."""
    qi = qconj(q)
    return qi, -qrotate(qi, t)


def se3_matrix(q, t):
    """(q, t) -> 4x4 homogeneous matrix."""
    R = quat_to_matrix(q)
    top = torch.cat([R, t[..., :, None]], dim=-1)
    bottom = torch.zeros(q.shape[:-1] + (1, 4), dtype=q.dtype, device=q.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def se3_pack(q, t):
    """(q, t) -> packed [..., 7]."""
    return torch.cat([q, t], dim=-1)


def se3_unpack(p):
    """Packed [..., 7] -> (q, t)."""
    return p[..., :4], p[..., 4:]
