"""Port parity, the rotation helpers (``kontiki_tpu_torch.rotations``) and
the quaternion helpers on tensors (``kontiki_tpu_torch.math.quaternion``)
against ``kontiki_tpu`` on the same numpy-seeded inputs, in float64.

Tolerance 1e-14 absolute: both packages run the same formulas (numpy on
both sides for the rotations; the quaternion helpers on torch against jax
in float64). ``random_quaternion`` takes an explicit generator or seed
where the JAX package draws from numpy's global state, so its distribution
is held, not its draws."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kontiki_tpu import rotations as jr
from kontiki_tpu.math import quaternion as jq
from kontiki_tpu_torch import rotations as tr
from kontiki_tpu_torch.math import quaternion as tq

torch.set_num_threads(1)
TOL = 1e-14


def _unit(v):
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _rotations():
    """Rotation matrices on each branch of Shepperd's method (trace > 0,
    then each diagonal entry largest), at angle 0 and near pi."""
    rng = np.random.default_rng(0)
    axes = _unit(rng.normal(size=(6, 3)))
    out = [np.eye(3)]
    for axis, angle in zip(axes, (0.4, 2.9, np.pi - 1e-9, 1e-7, 3.1, 1.7)):
        out.append(jr.quat_to_rotation_matrix(jr.axis_angle_to_quat(axis, angle)))
    for i in range(3):  # 180 degrees about each axis: trace -1, branch i
        out.append(jr.quat_to_rotation_matrix(np.r_[0.0, np.eye(3)[i]]))
    return out


@pytest.mark.parametrize("i", range(10))
def test_rotation_matrix_conversions_match_jax(i):
    R = _rotations()[i]
    np.testing.assert_allclose(tr.rotation_matrix_to_quat(R), jr.rotation_matrix_to_quat(R),
                               atol=TOL, rtol=0)
    axis_t, angle_t = tr.rotation_matrix_to_axis_angle(R)
    axis_j, angle_j = jr.rotation_matrix_to_axis_angle(R)
    np.testing.assert_allclose(axis_t, axis_j, atol=TOL, rtol=0)
    assert angle_t == pytest.approx(angle_j, abs=TOL)


def test_identity_quaternion():
    np.testing.assert_array_equal(tr.identity_quaternion(), jr.identity_quaternion())


@pytest.mark.parametrize("remove_mean", [False, True])
def test_procrustes_matches_jax(remove_mean):
    rng = np.random.default_rng(2)
    X = rng.normal(size=(3, 20))
    R_true = jr.quat_to_rotation_matrix(_unit(rng.normal(size=4)))
    Y = R_true @ X + (np.array([[0.3], [-1.0], [2.0]]) if remove_mean else 0.0)
    Y = Y + 1e-3 * rng.normal(size=Y.shape)
    got, want = tr.procrustes(X, Y, remove_mean), jr.procrustes(X, Y, remove_mean)
    for g, w in zip(got if remove_mean else (got,), want if remove_mean else (want,)):
        np.testing.assert_allclose(g, w, atol=TOL, rtol=0)


@pytest.mark.parametrize("case", ["generic", "parallel", "antiparallel", "antiparallel x"])
def test_rotation_between_vectors_matches_jax(case):
    rng = np.random.default_rng(3)
    a = rng.normal(size=3)
    b = {"generic": rng.normal(size=3), "parallel": 2.0 * a, "antiparallel": -3.0 * a,
         "antiparallel x": np.array([-1.0, 0.0, 0.0])}[case]
    if case == "antiparallel x":
        a = np.array([2.0, 0.0, 0.0])
    got = tr.rotation_between_vectors(a, b)
    np.testing.assert_allclose(got, jr.rotation_between_vectors(a, b), atol=TOL, rtol=0)
    np.testing.assert_allclose(got @ got.T, np.eye(3), atol=1e-14)
    np.testing.assert_allclose(_unit(got @ a), _unit(b), atol=1e-12)


def test_random_quaternion_distribution():
    """Unit norm; the same draws from one seed and from an equal generator;
    uniform on SO3: each component's mean 0 and E[q_i^2] = 1/4, and
    E[|w|] = 4 / (3 pi) for the scalar part, whose density on the 3-sphere
    is (2 / pi) sqrt(1 - w^2) (8,000 draws, 5 sigma)."""
    n = 8000
    rng = np.random.default_rng(4)
    qs = np.stack([tr.random_quaternion(rng) for _ in range(n)])
    np.testing.assert_allclose(np.linalg.norm(qs, axis=1), 1.0, atol=1e-15)
    np.testing.assert_array_equal(tr.random_quaternion(7),
                                  tr.random_quaternion(np.random.default_rng(7)))
    assert not np.array_equal(tr.random_quaternion(7), tr.random_quaternion(8))
    sigma = np.sqrt(0.25 / n)
    assert np.all(np.abs(qs.mean(axis=0)) < 5 * sigma)
    second = (qs ** 2).mean(axis=0)
    assert np.all(np.abs(second - 0.25) < 5 * np.sqrt(0.0625 * 2 / 3 / n))
    mean_abs_w = 4 / (3 * np.pi)
    assert abs(np.abs(qs[:, 0]).mean() - mean_abs_w) < 5 * np.sqrt((0.25 - mean_abs_w**2) / n)


def _quats(n, seed):
    rng = np.random.default_rng(seed)
    q = _unit(rng.normal(size=(n, 4)))
    q[0] = [1.0, 0.0, 0.0, 0.0]
    q[1, 0] = -abs(q[1, 0])
    return q


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def test_qvec_and_embed_vector_match_jax():
    q = _quats(6, 5)
    v = np.random.default_rng(6).normal(size=(2, 3, 3))
    np.testing.assert_array_equal(tq.qvec(_t(q)).numpy(), np.asarray(jq.qvec(jnp.asarray(q))))
    np.testing.assert_array_equal(tq.embed_vector(_t(v)).numpy(),
                                  np.asarray(jq.embed_vector(jnp.asarray(v))))


def test_dq_from_angular_velocity_matches_jax():
    q = _quats(6, 7)
    w = np.random.default_rng(8).normal(size=(6, 3))
    got = tq.dq_from_angular_velocity(_t(w), _t(q)).numpy()
    np.testing.assert_allclose(got, np.asarray(jq.dq_from_angular_velocity(jnp.asarray(w),
                                                                           jnp.asarray(q))),
                               atol=TOL, rtol=0)
    # and its inverse: angular_velocity(q, dq) gives w back
    np.testing.assert_allclose(tq.angular_velocity(_t(q), _t(got)).numpy(), w, atol=1e-14)


def test_vector_sandwich_matches_jax():
    rng = np.random.default_rng(9)
    qa, qb = _quats(6, 10), _quats(6, 11)
    x = rng.normal(size=(6, 3))
    got = tq.vector_sandwich(_t(qa), _t(x), _t(qb)).numpy()
    want = np.asarray(jq.vector_sandwich(jnp.asarray(qa), jnp.asarray(x), jnp.asarray(qb)))
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    # qa = q, qb = q* is the rotation
    np.testing.assert_allclose(
        tq.vector_sandwich(_t(qa), _t(x), tq.qconj(_t(qa))).numpy(),
        tq.qrotate(_t(qa), _t(x)).numpy(), atol=1e-14)


def test_is_unit_quaternion_matches_jax():
    q = np.concatenate([_quats(3, 12), (1.0 + np.array([[0.0], [4e-6], [2e-5]])) * _quats(3, 13),
                        [[1.0 + 9e-6, 0, 0, 0], [1.0 + 1.1e-5, 0, 0, 0]]])
    got = tq.is_unit_quaternion(_t(q)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jq.is_unit_quaternion(jnp.asarray(q))))
    assert got.tolist() == [True, True, True, True, True, False, True, False]
    assert tq.is_unit_quaternion(_t(q), tol=1e-7).numpy().tolist()[:3] == [True] * 3
