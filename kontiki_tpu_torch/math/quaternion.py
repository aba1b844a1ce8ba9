"""Quaternion math on torch tensors (counterpart of
``kontiki_tpu.math.quaternion``).

Quaternions are ``[..., 4]`` tensors in wxyz order. Every function
broadcasts over leading axes and is differentiable under ``torch.func``
(Taylor guards use the safe-``where`` idiom, so no NaN or Inf tangent leaks
through forward mode).
"""
import torch

#: Guard below which Taylor fallbacks engage (reference ``math::eps``).
EPS = 1e-16
#: Unit-norm check tolerance (reference ``math::eps_unit_check``).
EPS_UNIT_CHECK = 1e-5


def cross(a, b):
    """Broadcasting 3-vector cross product over the last axis."""
    ax, ay, az = a.unbind(-1)
    bx, by, bz = b.unbind(-1)
    return torch.stack(
        [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1
    )


def qmul(q1, q2):
    """Hamilton product of wxyz quaternions (broadcasting)."""
    w1, x1, y1, z1 = q1.unbind(-1)
    w2, x2, y2, z2 = q2.unbind(-1)
    return torch.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        dim=-1,
    )


def qconj(q):
    """Quaternion conjugate."""
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def qvec(q):
    """Vector (imaginary) part."""
    return q[..., 1:]


def embed_vector(v):
    """Embed a 3-vector as a pure quaternion (0, v)."""
    return torch.cat([torch.zeros_like(v[..., :1]), v], dim=-1)


def qrotate(q, v):
    """Rotate vector(s) v by unit quaternion(s) q: (q (0,v) q*).vec, in the
    15-multiply form."""
    qv = q[..., 1:]
    w = q[..., 0:1]
    t = 2.0 * cross(qv, v)
    return v + w * t + cross(qv, t)


def logq(q):
    """Unit-quaternion logarithm as a pure quaternion (0, k v), with
    ``k = atan2(|v|, w) / |v|`` and the Taylor fallback ``k = 1`` when
    ``|v|^2 <= EPS`` (reference quaternion_math.h:44-52)."""
    v = q[..., 1:]
    w = q[..., 0]
    v2 = torch.sum(v * v, dim=-1)
    small = v2 <= EPS
    vn = torch.sqrt(torch.where(small, 1.0, v2))
    k = torch.where(small, 1.0, torch.atan2(vn, w) / vn)
    return torch.cat([torch.zeros_like(w)[..., None], v * k[..., None]], dim=-1)


def expq(q):
    """Quaternion exponential ``e^w (cos|v|, sinc(|v|) v)``, Taylor fallback
    ``cos -> 1, sinc -> 1`` when ``|v|^2 <= EPS`` (quaternion_math.h:74-83)."""
    v = q[..., 1:]
    w = q[..., 0]
    v2 = torch.sum(v * v, dim=-1)
    small = v2 <= EPS
    vn = torch.sqrt(torch.where(small, 1.0, v2))
    ea = torch.exp(w)
    ka = torch.where(small, ea, ea * torch.cos(vn))
    kv = torch.where(small, ea, ea * torch.sin(vn) / vn)
    return torch.cat([ka[..., None], kv[..., None] * v], dim=-1)


def angular_velocity(q, dq):
    """World-frame angular velocity ``2 (dq q^-1).vec``
    (reference quaternion_math.h:92-96)."""
    return 2.0 * qmul(dq, qconj(q))[..., 1:]


def dq_from_angular_velocity(w, q):
    """Orientation derivative from world angular velocity: 0.5 (0,w) q."""
    return 0.5 * qmul(embed_vector(w), q)


def vector_sandwich(qa, x, qb):
    """``(qa * (0,x) * qb).vec`` (reference quaternion_math.h:107-114)."""
    return qmul(qa, qmul(embed_vector(x), qb))[..., 1:]


def is_unit_quaternion(q, tol=EPS_UNIT_CHECK):
    """|‖q‖ − 1| < tol elementwise over the last axis (reference tol 1e-5)."""
    return torch.abs(torch.linalg.vector_norm(q, dim=-1) - 1.0) < tol


def qnormalize(q):
    """Normalize to unit norm."""
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def quat_to_matrix(q):
    """Rotation matrix from unit wxyz quaternion; shape [..., 3, 3]."""
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    row0 = torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], -1)
    row1 = torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], -1)
    row2 = torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], -1)
    return torch.stack([row0, row1, row2], dim=-2)


def matrix_to_quat(R):
    """Rotation matrix -> wxyz quaternion (Shepperd's method, branch chosen
    by ``where`` as in the JAX package)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(x):
        return torch.sqrt(torch.clamp(x, min=EPS))

    s0 = safe_sqrt(tr + 1.0) * 2.0
    q0 = torch.stack([0.25 * s0, (m21 - m12) / s0, (m02 - m20) / s0,
                      (m10 - m01) / s0], -1)
    s1 = safe_sqrt(1.0 + m00 - m11 - m22) * 2.0
    q1 = torch.stack([(m21 - m12) / s1, 0.25 * s1, (m01 + m10) / s1,
                      (m02 + m20) / s1], -1)
    s2 = safe_sqrt(1.0 + m11 - m00 - m22) * 2.0
    q2 = torch.stack([(m02 - m20) / s2, (m01 + m10) / s2, 0.25 * s2,
                      (m12 + m21) / s2], -1)
    s3 = safe_sqrt(1.0 + m22 - m00 - m11) * 2.0
    q3 = torch.stack([(m10 - m01) / s3, (m02 + m20) / s3, (m12 + m21) / s3,
                      0.25 * s3], -1)

    cond_tr = (tr > 0.0)[..., None]
    cond1 = ((m00 > m11) & (m00 > m22))[..., None]
    cond2 = (m11 > m22)[..., None]
    q = torch.where(cond_tr, q0, torch.where(cond1, q1, torch.where(cond2, q2, q3)))
    return qnormalize(q)
