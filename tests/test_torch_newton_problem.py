"""Port parity, config 4-Newton's object and solver path on the JAX tests'
small Newton problem (``tests/test_torch_newton_rows.py``'s, pinhole
camera): ``NewtonRsCameraMeasurement``,
``make_rsvi_problem(rs="newton")``, ``Problem``'s ``rs_newton`` bucket, the
fused Schur solver and ``TrajectoryEstimator`` against ``kontiki_tpu`` on
the same objects, in float64 (``solver.kernels.bucket_terms`` on Newton rows:
``tests/test_torch_newton_terms.py``). Each problem has one JAX twin and
the solver tests share one JAX solve.

- the solves at 1e-9 relative against the JAX ``lm.solve`` costs (the
  fused speculative loop takes the phase-split loop's steps);
- the reference's ``+ rho p_ct`` in the Newton ``dX_cam``
  (newton_rscamera_measurement.h:91) is pinned: with a camera offset, the
  port's residuals equal the JAX package's, and differ from the same rows
  computed here without it wherever a row takes more than one step."""
import functools

import numpy as np
import pytest
import torch

from kontiki_tpu import measurements as jm
from kontiki_tpu import synthetic as jsyn
from kontiki_tpu.solver import lm as jax_lm
from kontiki_tpu_torch import TrajectoryEstimator, interop
from kontiki_tpu_torch.measurements import NewtonRsCameraMeasurement
from kontiki_tpu_torch.ops import linearize_kernels as tlk
from kontiki_tpu_torch.rotations import quat_conj, quat_mult, quat_to_rotation_matrix
from kontiki_tpu_torch.solver import kernels as tk
from kontiki_tpu_torch.solver import lm
from kontiki_tpu_torch.solver.problem import Problem
from kontiki_tpu_torch.synthetic import make_rsvi_problem
from test_torch_camera_host import host_library  # noqa: F401
from test_torch_newton_rows import SMALL
from test_torch_split_camera import twin_pair

torch.set_num_threads(1)
ITERATIONS = 5
P_CT = np.array([0.05, -0.03, 0.04])


def _unlock(cam):
    cam.relative_orientation_locked = False
    cam.relative_position_locked = False
    cam.max_time_offset = 0.01
    cam.time_offset_locked = False


@functools.lru_cache(maxsize=None)
def generated(trajectory="split", offset=False):
    """The small problem with the camera's pose and time offset free; with
    ``offset``, its camera offset is P_CT (else zero)."""
    gen = make_rsvi_problem(trajectory=trajectory, **SMALL)
    _unlock(gen["camera"])
    if offset:
        gen["camera"].relative_pose = (np.array([1.0, 0.0, 0.0, 0.0]), P_CT)
    return gen


@functools.lru_cache(maxsize=None)
def pair(trajectory="split", offset=False):
    gen = generated(trajectory, offset)
    return twin_pair(gen["trajectory"], gen["measurements"])


@functools.lru_cache(maxsize=None)
def errors():
    """Every row's ``NewtonRsCameraMeasurement.error`` on the port's and on
    the JAX package's objects, camera offset P_CT."""
    gen = generated(offset=True)
    traj = cpu_split(gen["trajectory"])
    J = pair(offset=True)["jax"]
    jms = [m for m, _, _ in J.buckets["rs_newton:PinholeCamera"].measurements]
    assert len(jms) == len(gen["measurements"])
    return (np.array([m.error(traj) for m in gen["measurements"]]),
            np.array([np.asarray(m.error(J.trajectory)) for m in jms]))


@functools.lru_cache(maxsize=None)
def jax_solve():
    """The JAX package's phase-split Schur solve of the split problem."""
    return jax_lm.solve(pair()["jax"], max_iterations=ITERATIONS, function_tolerance=0.0,
                        strategy="schur")[1]


def cpu_split(traj):
    """The port's split trajectory with its queries on the CPU."""
    r3, so3 = traj.R3_spline, traj.SO3_spline
    return interop.split_trajectory_from_numpy(r3.knots, so3.knots, r3.dt, so3.dt, r3.t0,
                                               so3.t0, device="cpu")


def test_generator_matches_jax():
    """``make_rsvi_problem(rs="newton")`` makes the JAX generator's Newton
    rows: the same observations, weights and Huber thresholds."""
    got = make_rsvi_problem(**SMALL)["measurements"]
    want = jsyn.make_rsvi_problem(**SMALL)["measurements"]
    assert len(got) == len(want) > 30
    assert all(isinstance(m, NewtonRsCameraMeasurement) for m in got)
    assert all(isinstance(m, jm.NewtonRsCameraMeasurement) for m in want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.observation.uv, w.observation.uv, rtol=1e-12)
        assert (g.weight, g.huber_loss, g.max_iterations) == (w.weight, w.huber_loss, 5)


def test_measurement_error_matches_jax():
    """``NewtonRsCameraMeasurement.error`` (and ``measure``) on every row of
    the small problem with a camera offset, on both packages' objects."""
    gen = generated(offset=True)
    traj = cpu_split(gen["trajectory"])
    port, jax_ = errors()
    np.testing.assert_allclose(port, jax_, rtol=1e-10, atol=1e-10)
    for m in gen["measurements"]:
        np.testing.assert_array_equal(m.measure(traj), m.project(traj))


def test_problem_matches_jax():
    """``Problem``'s ``rs_newton`` bucket: the key, rdim, readout-slack
    windows, every data array and the Ceres-style counts."""
    p = pair()
    T, J = p["torch"], p["jax"]
    assert list(T.buckets) == list(J.buckets) == ["rs_newton:PinholeCamera"]
    tb, jb = T.buckets["rs_newton:PinholeCamera"], J.buckets["rs_newton:PinholeCamera"]
    assert tb.rdim == jb.rdim == 2 and tb.M == len(jb.measurements)
    assert dict(tb.window) == dict(jb.window) == {"r3": 6, "so3": 6}
    assert set(tb.data) == set(jb.data)
    for k, v in jb.data.items():
        np.testing.assert_array_equal(tb.data[k].numpy(), np.asarray(v), err_msg=k)
    for name in ("num_parameters", "num_parameter_blocks", "num_parameters_reduced",
                 "num_parameter_blocks_reduced", "num_residuals", "num_residual_blocks",
                 "num_residuals_reduced", "num_residual_blocks_reduced", "num_tangent",
                 "landmark_offset"):
        assert getattr(T, name) == getattr(J, name), name
    assert p["tspec"].buckets[0].windows == (6, 6)


def test_problem_device_default():
    """Built through the entry points a Newton problem needs the CUDA card
    unless the CPU is named."""
    gen = generated()
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        Problem(gen["trajectory"], gen["measurements"])
    assert Problem(gen["trajectory"], gen["measurements"], device="cpu").device.type == "cpu"


@pytest.mark.parametrize("iterations", [1, ITERATIONS])
def test_fused_schur_solver_matches_jax(iterations):
    """``make_fused_solver(strategy="schur")`` on the Newton rows against the
    JAX ``lm.solve``'s iteration-n cost."""
    want = jax_solve()
    T = pair()["torch"]
    state, cost, it = lm.make_fused_solver(T, iterations, function_tolerance=0.0,
                                           strategy="schur")(T.state0)
    assert it == iterations
    assert cost.item() == pytest.approx(want.iterations[iterations].cost, rel=1e-9)
    assert want.iterations[iterations].cost < want.iterations[0].cost
    for k, v in state.items():
        assert v.shape == T.state0[k].shape and bool(torch.isfinite(v).all()), k


def test_estimator_takes_newton_rows():
    """``TrajectoryEstimator`` on Newton rows: 'auto' takes the Schur
    strategy, and its Summary follows the JAX ``lm.solve``."""
    gen = make_rsvi_problem(**SMALL)
    _unlock(gen["camera"])
    traj = cpu_split(gen["trajectory"])
    assert lm._resolve_strategy(Problem(traj, gen["measurements"], device="cpu"),
                                "auto") == "schur"
    est = TrajectoryEstimator(traj, device="cpu")
    for m in gen["measurements"]:
        est.add_measurement(m)
    got = est.solve(max_iterations=2, progress=False, function_tolerance=0.0)
    want = jax_solve()
    assert len(got.iterations) == 3
    for g, w in zip(got.iterations, want.iterations):
        assert g.step_is_successful == w.step_is_successful
        assert g.cost == pytest.approx(w.cost, rel=1e-9)
    assert got.num_residual_blocks == want.num_residual_blocks


def _project_without_quirk(m, trajectory):
    """``NewtonRsCameraMeasurement.project`` without the reference's
    ``+ rho p_ct`` in the time derivative of the camera point."""
    cam, obs = m.camera, m.observation
    lm_, ref = obs.landmark, obs.landmark.reference
    rho, d = lm_.inverse_depth, cam.time_offset
    row_delta = cam.readout / cam.rows
    t0_obs = obs.view.t0 + d
    t_ref = ref.view.t0 + d + ref.v * row_delta
    t_obs = t0_obs + obs.v * row_delta
    q_ct, p_ct = cam.relative_pose
    R_ct = quat_to_rotation_matrix(q_ct)
    X_ref = quat_to_rotation_matrix(quat_conj(q_ct)) @ (cam.unproject(ref.uv) - rho * p_ct)
    X = (quat_to_rotation_matrix(trajectory.orientation(t_ref)) @ X_ref
         + rho * trajectory.position(t_ref))
    def sandwich(qa, x, qb):
        return quat_mult(qa, quat_mult(np.concatenate([[0.0], x]), qb))[1:]

    for _ in range(m.max_iterations):
        p, dp = trajectory.position(t_obs), trajectory.velocity(t_obs)
        q, w = trajectory.orientation(t_obs), trajectory.angular_velocity(t_obs)
        dq = 0.5 * quat_mult(np.concatenate([[0.0], w]), q)
        s, ds = X - rho * p, -rho * dp
        dX_obs = (sandwich(quat_conj(dq), s, q) + sandwich(quat_conj(q), ds, q)
                  + sandwich(quat_conj(q), s, dq))
        y, dy = cam.evaluate_projection(R_ct @ (quat_to_rotation_matrix(q).T @ s) + rho * p_ct,
                                        R_ct @ dX_obs, True)
        dt = (y[1] - cam.rows * (t_obs - t0_obs) / cam.readout) / (dy[1] - cam.rows / cam.readout)
        t_obs = t_obs - dt
        if dt * dt < row_delta * row_delta / 4:
            break
        t_obs = np.clip(t_obs, t0_obs, t0_obs + cam.readout)
    return y


def test_rho_p_ct_quirk_is_kept(host_library):
    """With the camera offset p_ct != 0, the port's Newton rows (the
    measurement objects and kernel B8's bucket rows) equal the JAX
    package's, which keep the reference's ``+ rho p_ct`` in ``dX_cam``; the
    same rows computed without it agree on the rows that converge at the
    first step and differ on the others."""
    gen = generated(offset=True)
    traj = cpu_split(gen["trajectory"])
    ms = gen["measurements"]
    port, jax_ = errors()
    np.testing.assert_allclose(port, jax_, rtol=1e-10, atol=1e-10)
    free = np.array([m.weight * (m.observation.uv - _project_without_quirk(m, traj))
                     for m in ms])

    T = pair(offset=True)["torch"]
    spec, rt = pair(offset=True)["tspec"], tk.problem_runtime(T)
    cfg, ins, _ = tk._newton_inputs(spec, spec.buckets[0], rt, T.state0, rt["data"][0])
    r = tlk.newton_rows_plain(cfg, ins, cost_only=True).numpy()
    np.testing.assert_allclose(r, port, rtol=1e-9, atol=1e-9)
    _, steps, _ = tlk.newton_rows_host(cfg, ins, cost_only=True, steps=True)
    multi = steps.numpy() > 1
    assert multi.sum() > 10 and (~multi).sum() > 0
    np.testing.assert_allclose(free[~multi], port[~multi], rtol=1e-10, atol=1e-10)
    diff = np.abs(free - port).max(axis=1)[multi]
    assert diff.min() > 1e-9 and diff.max() > 1e-7, diff
