"""``TrajectoryEstimator`` and the phase-split ``solver.lm.solve`` of the
port, on the CPU (``device="cpu"``).

- Against the JAX package's ``lm.solve`` on a split camera problem (config
  3's model on distinct R3/SO3 grids, Schur) and a gyro + accel problem with
  free biases (config 2's, dense): the Summary counts, termination type and
  step counts are equal; per IterationSummary the success and validity
  flags are equal, the costs agree to 1e-9 relative, and the radii,
  gradient max norms and relative decreases to 1e-6 relative.
- The reference's estimator oracles (its tests/test_estimator.py, as the
  JAX package's tests/test_estimator.py keeps them), on measurements the
  port has: an empty solve, trajectory and IMU locks, the four callback
  cases and the callbacks' view of the state.
"""
import functools
import json

import numpy as np
import pytest
import torch

from kontiki_tpu.solver import lm as jax_lm
from kontiki_tpu_torch import (
    CallbackReturnType,
    IterationSummary,
    Summary,
    TerminationType,
    TrajectoryEstimator,
)
from kontiki_tpu_torch.solver import lm
from kontiki_tpu_torch.solver.problem import Problem
from kontiki_tpu_torch.synthetic import make_gyro_problem, make_imu_problem
from test_torch_split_camera import split_pair, twin_pair

torch.set_num_threads(1)

COUNTS = ("num_parameters", "num_parameter_blocks", "num_parameters_reduced",
          "num_parameter_blocks_reduced", "num_residuals", "num_residual_blocks",
          "num_residuals_reduced", "num_residual_blocks_reduced", "num_successful_steps",
          "num_unsuccessful_steps", "termination_type")


@functools.lru_cache(maxsize=None)
def _imu_pair():
    gen = make_imu_problem(duration=0.6, rate=40.0, seed=2, noise=0.05)
    return twin_pair(gen["trajectory"], gen["measurements"])


CASES = {"split camera": (lambda: split_pair(noise_px=1.0), 4),
         "imu": (_imu_pair, 3)}


@pytest.mark.parametrize("case", list(CASES))
def test_lm_solve_matches_jax(case):
    make, iterations = CASES[case]
    pair = make()
    _, want = jax_lm.solve(pair["jax"], max_iterations=iterations, function_tolerance=0.0)
    _, got = lm.solve(pair["torch"], max_iterations=iterations, function_tolerance=0.0)
    for name in COUNTS:
        g, w = getattr(got, name), getattr(want, name)
        if name == "termination_type":  # one enum per package
            g, w = g.name, w.name
        assert g == w, name
    assert got.termination_type == TerminationType.NoConvergence
    assert len(got.iterations) == len(want.iterations) == iterations + 1
    assert got.initial_cost == pytest.approx(want.initial_cost, rel=1e-9)
    assert got.final_cost == pytest.approx(want.final_cost, rel=1e-9)
    for g, w in zip(got.iterations, want.iterations):
        assert (g.iteration, g.step_is_successful, g.step_is_valid) == (
            w.iteration, w.step_is_successful, w.step_is_valid)
        assert g.cost == pytest.approx(w.cost, rel=1e-9)
        for name in ("trust_region_radius", "gradient_max_norm", "relative_decrease",
                     "step_norm"):
            assert getattr(g, name) == pytest.approx(getattr(w, name), rel=1e-6), name
    assert got.jacobian_evaluation_time_in_seconds > 0
    assert got.linear_solver_time_in_seconds > 0
    assert got.residual_evaluation_time_in_seconds > 0


# ---------------------------------------------------------------------------
# the reference's estimator oracles
# ---------------------------------------------------------------------------

GYRO = dict(duration=0.5, rate=20.0, seed=1, noise=0.05)


def _estimator(gen, **kwargs):
    estimator = TrajectoryEstimator(gen["trajectory"], device="cpu", **kwargs)
    for m in gen["measurements"]:
        estimator.add_measurement(m)
    return estimator


@pytest.fixture
def gyro():
    """A gyro-only SO3 fit with noise (10 rows; LM converges in 3
    iterations)."""
    return make_gyro_problem(**GYRO)


def test_same_trajectory(gyro):
    assert TrajectoryEstimator(gyro["trajectory"]).trajectory is gyro["trajectory"]


def test_exports_match_the_reference():
    assert Summary().termination_type == TerminationType.Failure
    assert IterationSummary().step_is_successful
    assert {e.name for e in CallbackReturnType} == {"Abort", "Continue",
                                                    "TerminateSuccessfully"}


def test_solve_empty(gyro):
    summary = TrajectoryEstimator(gyro["trajectory"], device="cpu").solve(progress=False)
    assert summary.num_parameters == 0
    assert summary.termination_type == TerminationType.Convergence
    assert "kontiki_tpu_torch Solver Report" in summary.FullReport()


def test_trajectory_lock(gyro):
    summary = _estimator(gyro).solve(progress=False, max_iterations=1)
    assert summary.num_parameters_reduced > 0
    knots = gyro["trajectory"].knots.copy()
    gyro["trajectory"].locked = True
    summary = _estimator(gyro).solve(progress=False)
    assert summary.num_parameters > 0
    assert summary.num_parameters_reduced == 0, "Not locked"
    # written back unchanged, up to the quaternions' re-normalisation
    np.testing.assert_allclose(gyro["trajectory"].knots, knots, rtol=0, atol=1e-15)


@pytest.mark.parametrize("what", ["relative_orientation", "relative_position", "time_offset"])
def test_imu_locks(gyro, what):
    imu = gyro["imu"]
    assert getattr(imu, f"{what}_locked")
    # an unlocked time offset widens each row's span by max_time_offset,
    # which would activate more knots; with 0 it adds its own block only
    imu.max_time_offset = 0.0
    locked = Problem(gyro["trajectory"], gyro["measurements"], device="cpu")
    setattr(imu, f"{what}_locked", False)
    unlocked = _estimator(gyro).solve(progress=False, max_iterations=1)
    assert unlocked.num_parameter_blocks_reduced == locked.num_parameter_blocks_reduced + 1


def test_callback_returntype_none(gyro):
    data = []
    estimator = _estimator(gyro)
    estimator.add_callback(lambda it: data.append("Foo"))
    summary = estimator.solve(max_iterations=10, progress=False)
    assert summary.termination_type == TerminationType.Convergence
    assert len(data) == len(summary.iterations) > 1


@pytest.mark.parametrize("ret,termination", [
    (CallbackReturnType.Abort, TerminationType.UserFailure),
    (CallbackReturnType.TerminateSuccessfully, TerminationType.UserSuccess),
])
def test_callback_ends_the_solve(gyro, ret, termination):
    estimator = _estimator(gyro)
    estimator.add_callback(lambda it: ret)
    summary = estimator.solve(max_iterations=4, progress=False)
    assert summary.termination_type == termination
    assert len(summary.iterations) == 1  # the iteration-0 summary's callback


def test_callback_multiple(gyro):
    from collections import Counter

    returned = []
    estimator = _estimator(gyro)
    for i in range(10):
        estimator.add_callback(lambda it, i=i: returned.append(i))
    estimator.solve(max_iterations=3, progress=False, function_tolerance=0.0)
    counter = Counter(returned)
    assert counter[0] == 4
    assert all(counter[i] == counter[0] for i in range(10))


@pytest.mark.parametrize("update", [True, False])
def test_callback_state_update(gyro, update):
    """With ``update_state`` the trajectory holds each iteration's state
    inside the callbacks; without it, the initial one until the solve
    ends."""
    trajectory = gyro["trajectory"]
    knots0 = trajectory.knots.copy()
    seen = []
    estimator = _estimator(gyro)
    estimator.add_callback(lambda it: seen.append(trajectory.knots.copy()), update_state=update)
    estimator.solve(max_iterations=3, progress=False, function_tolerance=0.0)
    if update:
        assert any(not np.allclose(a, b) for a, b in zip(seen, seen[1:]))
    else:
        for knots in seen:
            np.testing.assert_equal(knots, knots0)
    assert not np.allclose(trajectory.knots, knots0)  # written back at the end


def test_write_back_holds_the_final_state(gyro):
    problem = Problem(gyro["trajectory"], gyro["measurements"], device="cpu")
    state, summary = lm.solve(problem, max_iterations=2, function_tolerance=0.0)
    assert summary.final_cost < summary.initial_cost
    problem.write_back(state)
    q = state["so3"].numpy()
    np.testing.assert_allclose(gyro["trajectory"].knots,
                               q / np.linalg.norm(q, axis=1, keepdims=True), rtol=0, atol=1e-15)


def test_trace_dir_records_the_phases(gyro, tmp_path):
    problem = Problem(gyro["trajectory"], gyro["measurements"], device="cpu")
    lm.solve(problem, max_iterations=1, trace_dir=str(tmp_path))
    (trace,) = tmp_path.glob("*.json")
    names = {e.get("name") for e in json.loads(trace.read_text())["traceEvents"]}
    assert {"kontiki/jacobian", "kontiki/linear_solver", "kontiki/residual"} <= names


def test_unported_strategies_raise_in_solve(gyro):
    """The strategies ported since (iterative Schur, banded) run through
    ``TrajectoryEstimator.solve(strategy=...)`` and agree with the JAX
    package's ``lm.solve`` on the IMU problem: costs to 1e-9 relative or
    1e-10 of the initial cost (iterative Schur's CG stops at 1e-10
    relative), the same steps; the solution is written back. An unknown
    strategy still raises."""
    for strategy in ("iterative_schur", "banded"):
        gen = make_imu_problem(duration=0.6, rate=40.0, seed=2, noise=0.05)
        _, want = jax_lm.solve(twin_pair(gen["trajectory"], gen["measurements"])["jax"],
                               max_iterations=3, function_tolerance=0.0, strategy=strategy)
        knots0 = gen["trajectory"].SO3_spline.knots.copy()
        estimator = TrajectoryEstimator(gen["trajectory"], device="cpu")
        for m in gen["measurements"]:
            estimator.add_measurement(m)
        got = estimator.solve(max_iterations=3, progress=False, function_tolerance=0.0,
                              strategy=strategy)
        assert len(got.iterations) == len(want.iterations) == 4
        c0 = want.initial_cost
        for g, w in zip(got.iterations, want.iterations):
            assert g.step_is_successful == w.step_is_successful
            assert g.cost == pytest.approx(w.cost, rel=1e-9, abs=1e-10 * c0)
        assert got.final_cost < got.initial_cost
        assert not np.allclose(gen["trajectory"].SO3_spline.knots, knots0)
    with pytest.raises(ValueError, match="strategy"):
        lm.solve(Problem(gyro["trajectory"], gyro["measurements"], device="cpu"),
                 max_iterations=1, strategy="sparse_schur")
