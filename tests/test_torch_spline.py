"""Port parity: SE3 spline evaluation (``spline_eval.se3_window`` /
``se3_evaluate``, the window index rule and the SE3 trajectory container)
of ``kontiki_tpu_torch`` against ``kontiki_tpu`` in float64 (1e-12)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kontiki_tpu.trajectories import spline_eval as jev
from kontiki_tpu.trajectories import UniformSE3SplineTrajectory as JTraj
from kontiki_tpu_torch.trajectories import spline_eval as tev
from kontiki_tpu_torch.trajectories import UniformSE3SplineTrajectory as TTraj
from kontiki_tpu_torch.rotations import (
    axis_angle_to_quat,
    quat_mult,
    quat_to_rotation_matrix,
)

torch.set_num_threads(1)
TOL = 1e-12


def _knots(n, seed, wmag):
    """Packed SE3 knots: random translations, rotations composed from
    random increments of size ~wmag (0 gives identical rotations, which
    exercises the small-angle branches of the window chain)."""
    rng = np.random.default_rng(seed)
    q = np.array([1.0, 0.0, 0.0, 0.0])
    out = []
    for _ in range(n):
        axis = rng.normal(size=3)
        q = quat_mult(axis_angle_to_quat(axis / np.linalg.norm(axis), wmag * rng.normal()), q)
        q /= np.linalg.norm(q)
        out.append(np.r_[q, rng.normal(size=3)])
    return np.array(out)


@pytest.mark.parametrize("wmag", [0.0, 1e-7, 0.3, 1.5])
def test_se3_window_matches_jax(wmag):
    knots = _knots(4, seed=3, wmag=wmag)
    dt = 0.15
    us = np.array([0.0, 0.13, 0.5, 0.999])
    got = tev.se3_window(torch.tensor(np.broadcast_to(knots, (4, 4, 7)).copy()),
                         torch.tensor(us), dt)
    want = jax.vmap(jev.se3_window, in_axes=(None, 0, None))(
        jnp.asarray(knots), jnp.asarray(us), dt)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL, atol=TOL)


def test_se3_evaluate_and_index_rule_match_jax():
    knots = _knots(12, seed=5, wmag=0.2)
    t0, dt = 0.3, 0.15
    # inside, on knot boundaries, and outside the valid span (clamped)
    ts = np.r_[t0 + dt * np.array([0.0, 1.0, 3.5, 8.999]), t0 - 0.05, t0 + 20 * dt]
    i0, u = tev.index_and_u(torch.tensor(ts), t0, dt, 12)
    ji0, ju = jev.index_and_u(jnp.asarray(ts), t0, dt, 12)
    np.testing.assert_array_equal(i0.numpy(), np.asarray(ji0))
    np.testing.assert_allclose(u.numpy(), np.asarray(ju), rtol=TOL, atol=TOL)
    got = tev.se3_evaluate(torch.tensor(knots), t0, dt, torch.tensor(ts))
    want = jev.se3_evaluate(jnp.asarray(knots), t0, dt, jnp.asarray(ts))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL, atol=TOL)


def test_trajectory_container_matches_jax():
    rng = np.random.default_rng(7)
    jt, tt = JTraj(0.2, 0.1), TTraj(0.2, 0.1, device="cpu")
    for row in _knots(7, seed=9, wmag=0.4):
        T = np.eye(4)
        T[:3, :3] = quat_to_rotation_matrix(row[:4])
        T[:3, 3] = row[4:]
        jt.append_knot(T)
        tt.append_knot(T)
    np.testing.assert_allclose(tt.knots, jt.knots, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tt[-1], jt[-1], rtol=TOL, atol=TOL)
    assert tt.valid_time == jt.valid_time
    ts = rng.uniform(*tt.valid_time, size=9)
    for q in ("position", "acceleration", "orientation", "angular_velocity"):
        np.testing.assert_allclose(getattr(tt, q)(ts), getattr(jt, q)(ts),
                                   rtol=TOL, atol=TOL, err_msg=q)
    with pytest.raises(ValueError):
        tt.position(tt.max_time)
    with pytest.raises(IndexError):
        tt[7]
