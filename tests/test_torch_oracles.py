"""The JAX package's solver oracles on the port, in float64 on the CPU:

- the KKT gate of ``tests/test_ate.py`` (``solver.kkt.kkt_residual``: the
  bounds-projected gradient after the solve at most 1e-9 of the initial
  one) on BASELINE configs 1-3 at the JAX tests' own sizes, through the
  port's ``lm.solve``, with their accuracy gates (AOE, ATE, biases);
- the object-vs-batched residual parity of ``tests/test_residual_parity.py``
  for the position, orientation, IMU and camera kinds: each bucket's
  residual rows (``solver.kernels.bucket_terms``, cost-only) against the
  objects' ``error`` row for row, and the estimator's initial cost against
  0.5 sum huber(|error|^2) through the object API alone (1e-9 relative);
- the Huber/IRLS check of ``tests/test_lm_semantics.py``: rho'' <= 0
  everywhere, so sqrt(rho') whitening is Ceres's corrector, and rho' and
  rho'' are the derivatives of rho and rho'.
"""
import numpy as np
import pytest
import torch

from kontiki_tpu_torch import TrajectoryEstimator, interop
from kontiki_tpu_torch.measurements import (
    AccelerometerMeasurement,
    GyroscopeMeasurement,
    OrientationMeasurement,
    PositionMeasurement,
    StaticRsCameraMeasurement,
)
from kontiki_tpu_torch.rotations import random_quaternion
from kontiki_tpu_torch.sensors import BasicImu, ConstantBiasImu
from kontiki_tpu_torch.solver import kernels
from kontiki_tpu_torch.solver.kkt import kkt_residual
from kontiki_tpu_torch.solver.lm import solve
from kontiki_tpu_torch.solver.problem import Problem
from kontiki_tpu_torch.synthetic import (
    make_gyro_problem,
    make_imu_problem,
    make_rsvi_problem,
    make_se3_trajectory,
    make_so3_trajectory,
    make_split_trajectory,
    trajectory_aoe,
    trajectory_ate,
)
from kontiki_tpu_torch.trajectories import SplitTrajectory

torch.set_num_threads(1)


def on_cpu(traj):
    """``traj``'s splines (the same objects) with queries on the CPU, or a
    CPU copy of a single spline."""
    if isinstance(traj, SplitTrajectory):
        return SplitTrajectory(traj.R3_spline, traj.SO3_spline, device="cpu")
    kind = {3: "r3", 4: "so3", 7: "se3"}[traj.knots.shape[1]]
    return interop.trajectory_from_numpy(kind, traj.knots, traj.dt, traj.t0, device="cpu")


# ---------------------------------------------------------------------------
# KKT gates (tests/test_ate.py)
# ---------------------------------------------------------------------------

def _solve_and_write_back(traj, measurements, kkt_ratio=1e-9, **kwargs):
    problem = Problem(traj, measurements, device="cpu")
    kkt0 = kkt_residual(problem, problem.state0)
    state, summary = solve(problem, **kwargs)
    kkt = kkt_residual(problem, state)
    assert kkt <= kkt_ratio * kkt0 + 1e-12, (kkt, kkt0, kkt / kkt0)
    problem.write_back(state)
    return summary


def test_config1_gyro_only_so3_orientation_recovered():
    prob = make_gyro_problem(duration=3.0, rate=100.0, seed=1, sigma_q=0.05)
    traj, truth = on_cpu(prob["trajectory"]), on_cpu(prob["true_trajectory"])
    summary = _solve_and_write_back(traj, prob["measurements"], max_iterations=30)
    assert summary.final_cost < 1e-10 * summary.initial_cost
    assert trajectory_aoe(truth, traj, 0.5, 3.5) < 1e-6


def test_config2_imu_fusion_position_recovered():
    prob = make_imu_problem(duration=3.0, rate=100.0, seed=2, position_rate=5.0)
    traj, truth = on_cpu(prob["trajectory"]), on_cpu(prob["true_trajectory"])
    _solve_and_write_back(traj, prob["measurements"], max_iterations=40)
    assert trajectory_ate(truth, traj, 0.5, 3.5) < 1e-4
    rng = np.random.default_rng(2 + 7)
    true_ab = rng.normal(scale=0.05, size=3)
    true_gb = rng.normal(scale=0.01, size=3)
    np.testing.assert_allclose(prob["imu"].accelerometer_bias, true_ab, atol=1e-4)
    np.testing.assert_allclose(prob["imu"].gyroscope_bias, true_gb, atol=1e-5)


def test_config3_global_shutter_sfm_sim3_ate():
    prob = make_rsvi_problem(nviews=8, nlandmarks=20, imu_rate=0.0, seed=3, perturb_rho=0.1,
                             sigma_p=0.02, sigma_q=0.01)
    traj, truth = on_cpu(prob["trajectory"]), on_cpu(prob["true_trajectory"])
    t1, t2 = prob["views"][0].t0, prob["views"][-1].t0
    summary = _solve_and_write_back(traj, prob["measurements"], max_iterations=40)
    assert summary.final_cost < 1e-10 * summary.initial_cost
    assert trajectory_ate(truth, traj, t1, t2, align="sim3") < 1e-4


# ---------------------------------------------------------------------------
# object vs batched residual parity (tests/test_residual_parity.py)
# ---------------------------------------------------------------------------

def _huber(s2, c):
    b = c * c
    return s2 if s2 <= b else 2.0 * c * np.sqrt(s2) - b


def object_cost(measurements, trajectory):
    total = 0.0
    for m in measurements:
        r = np.atleast_1d(np.asarray(m.error(trajectory), dtype=float))
        s2 = float(r @ r)
        c = getattr(m, "huber_loss", None)
        total += 0.5 * (_huber(s2, c) if c is not None else s2)
    return total


def _assert_parity(measurements, trajectory, rtol=1e-9):
    problem = Problem(trajectory, list(measurements), device="cpu")
    spec, runtime = kernels.problem_spec(problem), kernels.problem_runtime(problem)
    assert len(spec.buckets) == 1
    r_kernel = kernels.bucket_terms(spec, spec.buckets[0], runtime, problem.state0,
                                    runtime["data"][0], cost_only=True).numpy()
    r_obj = np.stack([np.atleast_1d(np.asarray(m.error(trajectory), dtype=float))
                      for m in measurements])
    np.testing.assert_allclose(r_kernel, r_obj, rtol=rtol, atol=1e-12)
    expected = object_cost(measurements, trajectory)
    est = TrajectoryEstimator(trajectory, device="cpu")
    for m in measurements:
        est.add_measurement(m)
    summary = est.solve(max_iterations=1, progress=False)
    np.testing.assert_allclose(summary.initial_cost, expected, rtol=rtol)


def _trajectory(kind):
    if kind == "so3":
        return on_cpu(make_so3_trajectory(6.0, dt=0.6, seed=11))
    if kind == "se3":
        return on_cpu(make_se3_trajectory(6.0, dt=0.5, seed=12))
    split = make_split_trajectory(6.0, dt=0.4, seed=13)
    if kind == "r3":
        return on_cpu(split.R3_spline)
    return on_cpu(split)


def _times(traj, n=15, margin=0.2):
    return np.linspace(traj.min_time + margin, traj.max_time - margin, n)


@pytest.mark.parametrize("kind", ["r3", "so3", "se3", "split"])
def test_position_measurement_parity(kind):
    traj = _trajectory(kind)
    rng = np.random.default_rng(20)
    _assert_parity([PositionMeasurement(t, rng.uniform(-1, 1, 3)) for t in _times(traj)], traj)


@pytest.mark.parametrize("kind", ["r3", "so3", "se3", "split"])
def test_orientation_measurement_parity(kind):
    traj = _trajectory(kind)
    rng = np.random.default_rng(21)
    _assert_parity([OrientationMeasurement(t, random_quaternion(rng))
                    for t in _times(traj, 12)], traj)


@pytest.mark.parametrize("imu_kind", ["basic", "bias"])
@pytest.mark.parametrize("cls,kind", [(GyroscopeMeasurement, "so3"),
                                      (GyroscopeMeasurement, "split"),
                                      (AccelerometerMeasurement, "split"),
                                      (GyroscopeMeasurement, "se3"),
                                      (AccelerometerMeasurement, "se3")])
def test_imu_measurement_parity(cls, kind, imu_kind):
    traj = _trajectory(kind)
    rng = np.random.default_rng(22)
    imu = (BasicImu() if imu_kind == "basic"
           else ConstantBiasImu(rng.uniform(-0.1, 0.1, 3), rng.uniform(-0.1, 0.1, 3)))
    imu.time_offset = 0.01
    ts = _times(traj, margin=imu.max_time_offset + 0.05)
    _assert_parity([cls(imu, t, rng.uniform(-1, 1, 3), weight=rng.uniform(0.5, 2.0))
                    for t in ts], traj)


def _camera_problem(rs, trajectory):
    prob = make_rsvi_problem(nviews=4, nlandmarks=8, imu_rate=0.0, seed=23, rs=rs,
                             trajectory=trajectory)
    return prob, on_cpu(prob["trajectory"])


@pytest.mark.parametrize("trajectory", ["split", "se3"])
@pytest.mark.parametrize("rs", ["static", "lifting", "newton"])
def test_camera_measurement_parity(rs, trajectory):
    prob, traj = _camera_problem(rs, trajectory)
    for m in prob["measurements"]:  # non-trivial residuals and Newton paths
        m.observation.uv = m.observation.uv + np.array([0.5, -0.8])
    _assert_parity(prob["measurements"], traj)


@pytest.mark.parametrize("trajectory", ["split", "se3"])
def test_weighted_huber_parity(trajectory):
    """Non-default weights and Huber thresholds, residuals past them."""
    prob, traj = _camera_problem("static", trajectory)
    rng = np.random.default_rng(3)
    ms = []
    for m in prob["measurements"]:
        m.observation.uv = m.observation.uv + rng.uniform(-3, 3, size=2)
        ms.append(StaticRsCameraMeasurement(prob["camera"], m.observation,
                                            huber_loss=float(rng.uniform(0.5, 2.0)),
                                            weight=float(rng.uniform(0.5, 3.0))))
    _assert_parity(ms, traj)


# ---------------------------------------------------------------------------
# Huber / IRLS (tests/test_lm_semantics.py)
# ---------------------------------------------------------------------------

def test_huber_triggs_corrector_reduces_to_irls():
    """Ceres's Triggs corrector falls back to plain sqrt(rho') scaling of
    residual and Jacobian wherever rho''(s) <= 0; Huber's rho'' is 0 for
    inliers and negative for outliers, so the port's sqrt(rho') whitening
    is the corrector exactly. rho' and rho'' checked by central
    differences away from the kink at c^2."""
    c = 5.0
    t = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64))  # noqa: E731
    ct = t(c)  # per row, as the buckets hold it
    s = np.concatenate([np.linspace(0.0, 24.9, 50), np.linspace(25.1, 1e6, 50)])
    eps = 1e-4
    rho1 = kernels._huber_prime(t(s), ct).numpy()
    rho2 = (kernels._huber_prime(t(s + eps), ct) - kernels._huber_prime(t(s - eps), ct)).numpy()
    rho2 /= 2 * eps
    assert np.all(rho2 <= 1e-12)
    assert np.all(rho1[s < 25] == 1.0) and np.all(rho1[s > 25] < 1.0)
    s_mid = np.asarray([1.0, 10.0, 30.0, 100.0, 1e4])
    d1 = (kernels._huber(t(s_mid + eps), ct) - kernels._huber(t(s_mid - eps), ct)).numpy() / (
        2 * eps)
    np.testing.assert_allclose(d1, kernels._huber_prime(t(s_mid), ct).numpy(), rtol=1e-6)
    d2 = (kernels._huber_prime(t(s_mid + eps), ct)
          - kernels._huber_prime(t(s_mid - eps), ct)).numpy() / (2 * eps)
    want2 = np.where(s_mid <= c * c, 0.0, -0.5 * c * s_mid ** -1.5)
    np.testing.assert_allclose(d2, want2, rtol=1e-5, atol=1e-12)
