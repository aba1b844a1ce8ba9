"""Port parity: R3 and SO3 spline evaluation (``spline_eval.basis_vectors``,
``r3_window``, ``so3_window``, ``r3_evaluate``, ``so3_evaluate``) and the
R3, SO3 and split trajectory containers of ``kontiki_tpu_torch`` against
``kontiki_tpu`` on the same knots, in float64 (1e-12)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kontiki_tpu import trajectories as jtr
from kontiki_tpu.trajectories import spline_eval as jev
from kontiki_tpu_torch import trajectories as ttr
from kontiki_tpu_torch.rotations import axis_angle_to_quat, quat_mult
from kontiki_tpu_torch.trajectories import spline_eval as tev

torch.set_num_threads(1)
TOL = 1e-12


def _quats(n, seed, wmag):
    """Unit quaternions composed from random increments of size ~wmag (0
    gives identical knots: the Taylor branches of log and exp)."""
    rng = np.random.default_rng(seed)
    q = np.array([1.0, 0.0, 0.0, 0.0])
    out = []
    for _ in range(n):
        axis = rng.normal(size=3)
        q = quat_mult(axis_angle_to_quat(axis / np.linalg.norm(axis), wmag * rng.normal()), q)
        q /= np.linalg.norm(q)
        out.append(q)
    return np.array(out)


def _close(got, want, name=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=TOL, atol=TOL,
                               err_msg=name)


@pytest.mark.parametrize("cumulative", [False, True])
def test_basis_vectors_match_jax(cumulative):
    u = np.array([0.0, 0.21, 0.5, 0.999])
    got = tev.basis_vectors(torch.tensor(u), 0.13, cumulative=cumulative)
    want = jev.basis_vectors(jnp.asarray(u), 0.13, cumulative=cumulative)
    for g, w in zip(got, want):
        _close(g.numpy(), w)


def test_r3_window_and_evaluate_match_jax():
    rng = np.random.default_rng(2)
    knots = rng.normal(size=(9, 3))
    us = np.array([0.0, 0.13, 0.5, 0.999])
    win = knots[:4]
    got = tev.r3_window(torch.tensor(np.broadcast_to(win, (4, 4, 3)).copy()),
                        torch.tensor(us), 0.2)
    want = jax.vmap(jev.r3_window, in_axes=(None, 0, None))(jnp.asarray(win), jnp.asarray(us), 0.2)
    for g, w in zip(got, want):
        _close(g.numpy(), w)
    t0, dt = 0.4, 0.2
    ts = np.r_[t0 + dt * np.array([0.0, 1.0, 2.7, 5.999]), t0 - 0.1, t0 + 9 * dt]
    for g, w in zip(tev.r3_evaluate(torch.tensor(knots), t0, dt, torch.tensor(ts)),
                    jev.r3_evaluate(jnp.asarray(knots), t0, dt, jnp.asarray(ts))):
        _close(g.numpy(), w)


@pytest.mark.parametrize("wmag", [0.0, 1e-9, 0.3, 2.0])
def test_so3_window_matches_jax(wmag):
    win = _quats(4, seed=3, wmag=wmag)
    us = np.array([0.0, 1e-6, 0.37, 0.999])
    got = tev.so3_window(torch.tensor(np.broadcast_to(win, (4, 4, 4)).copy()),
                         torch.tensor(us), 0.1)
    want = jax.vmap(jev.so3_window, in_axes=(None, 0, None))(jnp.asarray(win), jnp.asarray(us), 0.1)
    for g, w in zip(got, want):
        _close(g.numpy(), w)


def test_so3_evaluate_matches_jax():
    knots = _quats(10, seed=4, wmag=0.5)
    t0, dt = -0.3, 0.15
    ts = np.r_[t0 + dt * np.array([0.0, 1.0, 3.5, 6.999]), t0 - 0.05, t0 + 20 * dt]
    for g, w in zip(tev.so3_evaluate(torch.tensor(knots), t0, dt, torch.tensor(ts)),
                    jev.so3_evaluate(jnp.asarray(knots), t0, dt, jnp.asarray(ts))):
        _close(g.numpy(), w)


def _r3_pair(n=7):
    jt, tt = jtr.UniformR3SplineTrajectory(0.25, 0.3), ttr.UniformR3SplineTrajectory(0.25, 0.3, device="cpu")
    for p in np.random.default_rng(5).normal(size=(n, 3)):
        jt.append_knot(p)
        tt.append_knot(p)
    return jt, tt


def _so3_pair(n=7):
    jt, tt = jtr.UniformSO3SplineTrajectory(0.2, 0.1), ttr.UniformSO3SplineTrajectory(0.2, 0.1, device="cpu")
    for q in _quats(n, seed=6, wmag=0.4):
        jt.append_knot(q)
        tt.append_knot(q)
    return jt, tt


def _split_pair():
    (jr, tr), (jq, tq) = _r3_pair(9), _so3_pair(8)
    return jtr.SplitTrajectory(jr, jq), ttr.SplitTrajectory(tr, tq)


QUERIES = ("position", "velocity", "acceleration", "orientation", "angular_velocity")


@pytest.mark.parametrize("make", [_r3_pair, _so3_pair, _split_pair],
                         ids=["r3", "so3", "split"])
def test_trajectory_container_matches_jax(make):
    jt, tt = make()
    assert tt.valid_time == jt.valid_time
    ts = np.random.default_rng(7).uniform(*tt.valid_time, size=9)
    for q in QUERIES:
        _close(getattr(tt, q)(ts), getattr(jt, q)(ts), q)
        _close(getattr(tt, q)(ts[0]), getattr(jt, q)(ts[0]), q)
    with pytest.raises(ValueError):
        tt.position(tt.max_time)
    clone = tt.clone()
    for sp_t, sp_c in zip(_splines(tt), _splines(clone)):
        knots = sp_c.knots.copy()
        knots[0] = knots[1]
        sp_c.set_knots(knots)
        assert not np.array_equal(sp_t.knots, sp_c.knots)  # the clone is deep


def _splines(traj):
    return (traj.R3_spline, traj.SO3_spline) if hasattr(traj, "R3_spline") else (traj,)


def test_knot_access_and_validation():
    jt, tt = _so3_pair()
    _close(tt[-1], jt[-1])
    _close(tt.knots, jt.knots)
    with pytest.raises(IndexError):
        tt[7]
    with pytest.raises(ValueError):
        tt.append_knot(np.array([1.0, 0.1, 0.0, 0.0]))  # not unit
    with pytest.raises(ValueError):
        ttr.UniformR3SplineTrajectory().append_knot(np.zeros(4))
    short = ttr.UniformR3SplineTrajectory(0.1)
    for p in np.zeros((3, 3)):
        short.append_knot(p)
    with pytest.raises(ValueError):
        short.min_time


def test_split_lock_and_span():
    jt, tt = _split_pair()
    assert (tt.min_time, tt.max_time) == (jt.min_time, jt.max_time)
    tt.locked = True
    assert tt.locked and tt.R3_spline.locked and tt.SO3_spline.locked
    tt.SO3_spline.locked = False
    with pytest.raises(RuntimeError):
        tt.locked
    with pytest.raises(TypeError):
        ttr.SplitTrajectory(tt.R3_spline, tt.R3_spline)
