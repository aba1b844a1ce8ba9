"""The batch IMU containers (``GyroscopeMeasurements``,
``AccelerometerMeasurements``) and ``Problem``'s batch path, in float64 on
the CPU:

- the containers' checks, and ``measure``/``error`` in one trajectory query
  against the per-time loop of the per-object measurements (1e-13
  absolute);
- a ``Problem`` from containers against one from the same rows as
  per-object measurements in the port: bucket data, ``state0``, mask and
  every count equal exactly (the same arrays through the native helper's
  one pass and the per-object path);
- the same against the JAX package's batch ``Problem`` on the same objects:
  bucket data, ``state0``, mask and counts equal, ``total_cost`` within
  1e-12 relative (as ``tests/test_native.py``);
- the estimator on the containers (``device="cpu"``) against the estimator
  on the per-object rows: every iteration's cost within 1e-12 relative.
"""
import numpy as np
import pytest
import torch

from kontiki_tpu import measurements as jm
from kontiki_tpu import sensors as js
from kontiki_tpu import trajectories as jt
from kontiki_tpu.solver.kernels import make_functions
from kontiki_tpu.solver.problem import Problem as JProblem
from kontiki_tpu_torch import TrajectoryEstimator
from kontiki_tpu_torch.measurements import (
    AccelerometerMeasurement,
    AccelerometerMeasurements,
    GyroscopeMeasurement,
    GyroscopeMeasurements,
)
from kontiki_tpu_torch.sensors import BasicImu, ConstantBiasImu
from kontiki_tpu_torch.solver import kernels
from kontiki_tpu_torch.solver.problem import Problem
from kontiki_tpu_torch.synthetic import make_imu_problem
from kontiki_tpu_torch.trajectories import SplitTrajectory

torch.set_num_threads(1)
COUNTS = ("num_parameters", "num_parameter_blocks", "num_parameters_reduced",
          "num_parameter_blocks_reduced", "num_residuals", "num_residual_blocks",
          "num_residuals_reduced", "num_residual_blocks_reduced")


def _setup(offset=False, seed=2):
    """Config 2's generator cut to 3 s at 40 Hz, on the CPU; per-object gyro
    and accel rows with varied weights and the same rows as containers.
    ``offset`` frees the IMU's time offset (slack windows)."""
    gen = make_imu_problem(duration=3.0, rate=40.0, seed=seed)
    traj = SplitTrajectory(gen["trajectory"].R3_spline, gen["trajectory"].SO3_spline,
                           device="cpu")
    imu = gen["imu"]
    if offset:
        imu.time_offset = 0.004
        imu.max_time_offset = 0.02
        imu.time_offset_locked = False
    gy = [m for m in gen["measurements"] if isinstance(m, GyroscopeMeasurement)]
    ac = [m for m in gen["measurements"] if isinstance(m, AccelerometerMeasurement)]
    wg = np.random.default_rng(seed).uniform(0.5, 2.0, len(ac))
    for m, w in zip(ac, wg):
        m.weight = w
    for m in gy:
        m.weight = 3.0
    batches = [GyroscopeMeasurements(imu, [m.t for m in gy], np.stack([m.w for m in gy]),
                                     weight=3.0),
               AccelerometerMeasurements(imu, [m.t for m in ac], np.stack([m.a for m in ac]),
                                         weight=wg)]
    return dict(traj=traj, imu=imu, gy=gy, ac=ac, batches=batches)


def test_container_checks():
    imu = BasicImu()
    g = GyroscopeMeasurements(imu, [0.1, 0.2, 0.3], np.zeros((3, 3)), weight=2.0)
    assert len(g) == 3 and g.weight.tolist() == [2.0] * 3 and g.w.dtype == np.float64
    a = AccelerometerMeasurements(imu, [0.1, 0.2], np.ones((2, 3)), weight=[1.0, 4.0])
    assert a.weight.tolist() == [1.0, 4.0] and a.a.shape == (2, 3)
    with pytest.raises(ValueError, match=r"values must be \[3, 3\]"):
        GyroscopeMeasurements(imu, [0.1, 0.2, 0.3], np.zeros((3, 2)))
    with pytest.raises(ValueError, match="sorted"):
        AccelerometerMeasurements(imu, [0.2, 0.1], np.zeros((2, 3)))
    with pytest.raises(ValueError):
        GyroscopeMeasurements(imu, [0.1, 0.2], np.zeros((2, 3)), weight=[1.0, 2.0, 3.0])


@pytest.mark.parametrize("imu_kind", ["basic", "bias", "bias+offset"])
def test_measure_in_one_query_matches_per_time_loop(imu_kind):
    s = _setup()
    traj = s["traj"]
    imu = BasicImu() if imu_kind == "basic" else ConstantBiasImu([0.1, -0.2, 0.05],
                                                                [0.01, 0.02, -0.03])
    if imu_kind == "bias+offset":
        imu.time_offset = 0.013
    ts = np.linspace(traj.min_time + 0.05, traj.max_time - 0.05, 57)
    rng = np.random.default_rng(5)
    y, w = rng.normal(size=(57, 3)), rng.uniform(0.5, 2.0, 57)
    for batch_cls, obj_cls in ((GyroscopeMeasurements, GyroscopeMeasurement),
                               (AccelerometerMeasurements, AccelerometerMeasurement)):
        batch = batch_cls(imu, ts, y, weight=w)
        objs = [obj_cls(imu, t, yi, weight=wi) for t, yi, wi in zip(ts, y, w)]
        np.testing.assert_allclose(batch.measure(traj), np.stack([m.measure(traj) for m in objs]),
                                   atol=1e-13, rtol=0)
        np.testing.assert_allclose(batch.error(traj), np.stack([m.error(traj) for m in objs]),
                                   atol=1e-13, rtol=0)


def _assert_same_problem(a, b):
    assert list(a.buckets) == list(b.buckets)
    for key in a.buckets:
        assert a.buckets[key].M == b.buckets[key].M
        assert a.buckets[key].window == b.buckets[key].window
        assert a.buckets[key].data.keys() == b.buckets[key].data.keys()
        for k, v in a.buckets[key].data.items():
            assert torch.equal(v, b.buckets[key].data[k]), (key, k)
    assert a.state0.keys() == b.state0.keys()
    for k, v in a.state0.items():
        assert torch.equal(v, b.state0[k]), k
    assert torch.equal(a.mask, b.mask)
    for name in COUNTS:
        assert getattr(a, name) == getattr(b, name), name
    for sa, sb in zip(a.splines, b.splines):
        np.testing.assert_array_equal(sa.active, sb.active)


@pytest.mark.parametrize("offset", [False, True])
def test_batch_problem_equals_per_object(offset):
    s = _setup(offset)
    p_obj = Problem(s["traj"], s["gy"] + s["ac"], device="cpu")
    p_batch = Problem(s["traj"], s["batches"], device="cpu")
    _assert_same_problem(p_obj, p_batch)
    assert p_batch.buckets["gyro"].M == len(s["gy"]) and not p_batch.buckets["gyro"].measurements


def test_mixed_objects_and_batches_splice_in_order():
    """Per-object rows first, then each container in the order added, with
    its sensor id; the same as the per-object rows in that order."""
    s = _setup()
    imu2 = ConstantBiasImu([0.0, 0.1, 0.0], [0.0, 0.0, 0.01])
    gy, ac = s["gy"], s["ac"]
    extra = [GyroscopeMeasurement(imu2, m.t, m.w, weight=0.5) for m in gy[::3]]
    g2 = GyroscopeMeasurements(imu2, [m.t for m in extra], np.stack([m.w for m in extra]),
                               weight=0.5)
    p_batch = Problem(s["traj"], gy[:5] + [s["batches"][1], g2, GyroscopeMeasurements(
        s["imu"], [m.t for m in gy[5:]], np.stack([m.w for m in gy[5:]]), weight=3.0)],
        device="cpu")
    p_obj = Problem(s["traj"], gy[:5] + ac + extra + gy[5:], device="cpu")
    _assert_same_problem(p_obj, p_batch)
    assert p_batch.buckets["gyro"].data["sid"].unique().tolist() == [0, 1]


def test_locked_problem_reduces_to_nothing():
    s = _setup()
    s["traj"].locked = True
    s["imu"].accelerometer_bias_locked = True
    s["imu"].gyroscope_bias_locked = True
    p_obj = Problem(s["traj"], s["gy"] + s["ac"], device="cpu")
    p_batch = Problem(s["traj"], s["batches"], device="cpu")
    _assert_same_problem(p_obj, p_batch)
    assert p_batch.num_residual_blocks_reduced == 0 and p_batch.num_parameters_reduced == 0
    assert p_batch.num_residual_blocks == len(s["gy"]) + len(s["ac"])


def test_batch_spans_are_checked():
    s = _setup()
    imu, traj = s["imu"], s["traj"]
    bad = GyroscopeMeasurements(imu, [traj.min_time - 0.01, 1.0], np.zeros((2, 3)))
    with pytest.raises(ValueError, match="out of range"):
        Problem(traj, [bad], device="cpu")
    imu.time_offset_locked = False
    imu.max_time_offset = 0.05
    edge = GyroscopeMeasurements(imu, [traj.min_time + 0.01, 1.0], np.zeros((2, 3)))
    with pytest.raises(ValueError, match="out of range"):
        Problem(traj, [edge], device="cpu")


def _jax_twin(s):
    """The JAX package's batch Problem on copies of the same trajectory,
    IMU and container arrays."""
    traj, imu = s["traj"], s["imu"]
    jtraj = jt.SplitTrajectory(traj.R3_spline.dt, traj.SO3_spline.dt, traj.R3_spline.t0,
                               traj.SO3_spline.t0)
    for k in traj.R3_spline.knots:
        jtraj.R3_spline.append_knot(k)
    for k in traj.SO3_spline.knots:
        jtraj.SO3_spline.append_knot(k)
    jimu = js.ConstantBiasImu(imu.accelerometer_bias, imu.gyroscope_bias)
    for attr in ("accelerometer_bias_locked", "gyroscope_bias_locked", "time_offset",
                 "max_time_offset", "time_offset_locked"):
        setattr(jimu, attr, getattr(imu, attr))
    g, a = s["batches"]
    return JProblem(jtraj, [jm.GyroscopeMeasurements(jimu, g.t, g.w, weight=g.weight),
                            jm.AccelerometerMeasurements(jimu, a.t, a.a, weight=a.weight)])


@pytest.mark.parametrize("offset", [False, True])
def test_batch_problem_matches_jax(offset):
    s = _setup(offset)
    p = Problem(s["traj"], s["batches"], device="cpu")
    jp = _jax_twin(s)
    for key in p.buckets:
        for k, v in p.buckets[key].data.items():
            np.testing.assert_array_equal(v.numpy(), np.asarray(jp.buckets[key].data[k]),
                                          err_msg=f"{key} {k}")
    for k, v in p.state0.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(jp.state0[k]), err_msg=k)
    np.testing.assert_array_equal(p.mask.numpy(), np.asarray(jp.mask))
    for name in COUNTS:
        assert getattr(p, name) == getattr(jp, name), name
    cost = kernels.total_cost(kernels.problem_spec(p), kernels.problem_runtime(p),
                              p.state0).item()
    want = float(make_functions(jp)[0](jp.state0))
    assert abs(cost - want) <= 1e-12 * want


def test_estimator_on_batches_matches_per_object():
    costs = {}
    for how in ("objects", "batches"):
        s = _setup()
        est = TrajectoryEstimator(s["traj"], device="cpu")
        for m in (s["gy"] + s["ac"] if how == "objects" else s["batches"]):
            est.add_measurement(m)
        summary = est.solve(max_iterations=6, progress=False, function_tolerance=0.0)
        costs[how] = [it.cost for it in summary.iterations]
        biases = (s["imu"].accelerometer_bias, s["imu"].gyroscope_bias)
    assert summary.final_cost < 1e-2 * summary.initial_cost
    assert len(costs["batches"]) == len(costs["objects"]) == 7
    np.testing.assert_allclose(costs["batches"], costs["objects"], rtol=1e-12)
    assert np.all(np.isfinite(np.concatenate(biases)))


def test_long_imu_generator_matches_jax():
    """``make_long_imu_problem`` (cut to 20 s) against the JAX package's
    pieces on the same seeds: truth and start knots and biases exactly, the
    samples to 1e-13, SEW's spacings and variances to 1e-12 (numpy on both
    sides; the samples differ by roundoff) and the weights 1 / sqrt(var)."""
    from kontiki_tpu import sew as jsew
    from kontiki_tpu import synthetic as jsyn
    from kontiki_tpu_torch.synthetic import make_long_imu_problem

    gen = make_long_imu_problem(duration=20.0)
    truth = jsyn.make_split_trajectory(21.0, dt=0.1, seed=2)
    start = jsyn.perturb_trajectory(truth, sigma_p=0.05, sigma_q=0.02, seed=3)
    for ours, theirs in ((gen["true_trajectory"], truth), (gen["trajectory"], start)):
        np.testing.assert_array_equal(ours.R3_spline.knots, np.asarray(theirs.R3_spline.knots))
        np.testing.assert_array_equal(ours.SO3_spline.knots, np.asarray(theirs.SO3_spline.knots))
    rng = np.random.default_rng(9)
    ab, gb = rng.normal(scale=0.05, size=3), rng.normal(scale=0.01, size=3)
    imu = gen["imu"]
    np.testing.assert_array_equal(imu.accelerometer_bias, ab)
    np.testing.assert_array_equal(imu.gyroscope_bias, gb)
    assert not (imu.accelerometer_bias_locked or imu.gyroscope_bias_locked)
    g, a = gen["measurements"]
    ts = np.arange(0.5, 20.5, 1.0 / 200.0)
    np.testing.assert_array_equal(g.t, ts)
    w, acc = (np.asarray(x) for x in jsyn._body_imu(truth, ts))
    np.testing.assert_allclose(g.w, w + gb, atol=1e-13, rtol=0)
    np.testing.assert_allclose(a.a, acc + ab, atol=1e-13, rtol=0)
    for batch, y, kind in ((g, w + gb, "gyro"), (a, acc + ab, "accel")):
        dt, var = gen["sew"][kind]
        jdt, jvar = jsew.knot_spacing_and_variance(y.T, ts, 0.99)
        assert dt == pytest.approx(jdt, rel=1e-12) and var == pytest.approx(jvar, rel=1e-12)
        np.testing.assert_array_equal(batch.weight, np.full(len(ts), 1.0 / np.sqrt(var)))
        assert batch.imu is imu
