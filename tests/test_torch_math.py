"""Port parity: quaternion / SE3 math and the pinhole model of
``kontiki_tpu_torch`` against ``kontiki_tpu`` in float64, on inputs that
hit every Taylor and branch guard (tolerance 1e-12)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kontiki_tpu.math import quaternion as jq
from kontiki_tpu.math import se3 as jse3
from kontiki_tpu.sensors import camera_models as jcm
from kontiki_tpu_torch.math import quaternion as tq
from kontiki_tpu_torch.math import se3 as tse3
from kontiki_tpu_torch.sensors import camera_models as tcm

torch.set_num_threads(1)
TOL = 1e-12


def _unit(v):
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _rotvecs():
    """Rotation vectors across the theta^2 <= 1e-10 guard, generic angles,
    and theta = pi (|sin| below the V^-1 guard)."""
    rng = np.random.default_rng(0)
    axes = _unit(rng.normal(size=(7, 3)))
    angles = np.array([0.0, 1e-7, 9e-6, 2e-5, 0.3, 2.5, np.pi])
    return axes * angles[:, None]


def _quats():
    """Unit quaternions: identity, |v|^2 <= 1e-10 (both signs of w),
    w ~ 0 (the +/- pi branch, both signs), generic, negative w."""
    rng = np.random.default_rng(1)
    v = _unit(rng.normal(size=(8, 3)))
    out = [
        [1.0, 0.0, 0.0, 0.0],
        np.r_[np.sqrt(1 - 1e-12), 1e-6 * v[0]],
        np.r_[-np.sqrt(1 - 1e-12), 1e-6 * v[1]],
        np.r_[1e-12, v[2] * np.sqrt(1 - 1e-24)],
        np.r_[-1e-12, v[3] * np.sqrt(1 - 1e-24)],
        np.r_[0.6, 0.8 * v[4]],
        np.r_[-0.3, np.sqrt(1 - 0.09) * v[5]],
    ]
    return np.array(out)


def _t(a):
    return torch.tensor(np.array(a), dtype=torch.float64)


def _close(got, want):
    got = [g.numpy() for g in (got if isinstance(got, tuple) else (got,))]
    want = [np.asarray(w) for w in (want if isinstance(want, tuple) else (want,))]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)


rng = np.random.default_rng(2)
Q = _quats()
Q2 = _unit(rng.normal(size=Q.shape))
W = _rotvecs()
V3 = rng.normal(size=(len(W), 3))
XI = np.concatenate([rng.normal(size=W.shape), W], axis=1)

CASES = {
    "qmul": ((Q, Q2), jq.qmul, tq.qmul),
    "qconj": ((Q,), jq.qconj, tq.qconj),
    "qrotate": ((Q, V3[: len(Q)]), jq.qrotate, tq.qrotate),
    "qnormalize": ((2.0 * Q,), jq.qnormalize, tq.qnormalize),
    "quat_to_matrix": ((Q,), jq.quat_to_matrix, tq.quat_to_matrix),
    "matrix_to_quat": ((np.asarray(jq.quat_to_matrix(jnp.asarray(Q2))),),
                       jq.matrix_to_quat, tq.matrix_to_quat),
    "skew": ((V3,), jse3.skew, tse3.skew),
    "so3_exp_quat": ((W,), jse3.so3_exp_quat, tse3.so3_exp_quat),
    "so3_log": ((Q,), jse3.so3_log, tse3.so3_log),
    "left_jacobian": ((W,), jse3._so3_left_jacobian, tse3._so3_left_jacobian),
    "left_jacobian_inv": ((W,), jse3._so3_left_jacobian_inv,
                          tse3._so3_left_jacobian_inv),
    "se3_hat": ((XI,), jse3.se3_hat, tse3.se3_hat),
    "se3_exp": ((XI,), jse3.se3_exp, tse3.se3_exp),
    "se3_log": ((Q, V3[: len(Q)]), jse3.se3_log, tse3.se3_log),
    "se3_mul": ((Q, V3[: len(Q)], Q2, V3[::-1][: len(Q)]), jse3.se3_mul, tse3.se3_mul),
    "se3_inv": ((Q, V3[: len(Q)]), jse3.se3_inv, tse3.se3_inv),
    "se3_matrix": ((Q, V3[: len(Q)]), jse3.se3_matrix, tse3.se3_matrix),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_math_matches_jax(name):
    args, jfn, tfn = CASES[name]
    _close(tfn(*[_t(a) for a in args]), jfn(*[jnp.asarray(a) for a in args]))


@pytest.mark.parametrize("name", ["so3_exp_quat", "so3_log", "se3_exp"])
def test_forward_mode_through_guards_matches_jax(name):
    """Per-input forward-mode Jacobians (the derivatives the solver seeds)
    agree on both sides of every guard."""
    args, jfn, tfn = CASES[name]
    x = args[0]

    def jflat(a):
        out = jfn(a)
        return jnp.concatenate(out) if isinstance(out, tuple) else out

    def tflat(a):
        out = tfn(a)
        return torch.cat(out) if isinstance(out, tuple) else out

    for row in x:
        want = jax.jacfwd(jflat)(jnp.asarray(row))
        got = torch.func.jacfwd(tflat)(_t(row))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10, atol=1e-10)


def test_pinhole_matches_jax():
    K = np.array([[500.0, 0.0, 320.0], [0.0, 480.0, 240.0], [0.0, 0.0, 1.0]])
    X = np.c_[rng.normal(size=(6, 2)), rng.uniform(1.0, 9.0, size=6)]
    _close(tcm.pinhole_project(_t(K), _t(X)), jcm.pinhole_project(jnp.asarray(K), jnp.asarray(X)))
