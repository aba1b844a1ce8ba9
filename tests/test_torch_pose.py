"""Port parity: position and orientation measurements and their solver
buckets in ``kontiki_tpu_torch`` against ``kontiki_tpu`` in float64.

- ``PositionMeasurement``/``OrientationMeasurement`` ``measure``/``error``
  on every trajectory kind (1e-12);
- the pose buckets' terms (``bucket_terms``) on every spline kind the JAX
  package accepts, ``total_cost`` on each against the JAX
  ``solver/kernels``, and the dense linearization (cost, H, g) on the
  split and SE3 kinds (1e-12 relative to each quantity's largest entry);
- ``Problem``'s Ceres-style counts against the JAX ``Problem``;
- a short ``TrajectoryEstimator`` pose fit's IterationSummary costs against
  the JAX ``lm.solve`` (1e-9 relative: the dense solves and the quaternion
  retractions round differently, and LM amplifies it a little per
  iteration) and equal counts;
- the reference's estimator callback oracles (tests/test_estimator.py) on
  a position fit, and the CUDA default of ``TrajectoryEstimator``.

Inputs come from numpy seeds; the port runs with ``device="cpu"``.
"""
from collections import Counter

import jax
import numpy as np
import pytest
import torch

from kontiki_tpu.measurements import OrientationMeasurement as JO
from kontiki_tpu.measurements import PositionMeasurement as JP
from kontiki_tpu.solver import kernels as JK
from kontiki_tpu.solver import lm as jlm
from kontiki_tpu.solver.problem import Problem as JProblem
from kontiki_tpu.trajectories import SplitTrajectory as JSplit
from kontiki_tpu_torch import CallbackReturnType, TerminationType, TrajectoryEstimator, interop
from kontiki_tpu_torch.measurements import OrientationMeasurement, PositionMeasurement
from kontiki_tpu_torch.trajectories import SplitTrajectory
from kontiki_tpu_torch.solver import kernels
from kontiki_tpu_torch.solver.problem import Problem
from kontiki_tpu_torch.synthetic import make_pose_measurements, make_split_trajectory
from test_torch_query import JR3, JSO3, _jax_spline, _pair

torch.set_num_threads(1)
TOL = 1e-12
KINDS = ["split", "se3", "r3", "so3"]
COUNTS = ("num_parameters", "num_parameter_blocks", "num_parameters_reduced",
          "num_parameter_blocks_reduced", "num_residuals", "num_residual_blocks",
          "num_residuals_reduced", "num_residual_blocks_reduced")


def _measurements(traj, n, seed):
    """Position and orientation rows at n times inside ``traj``'s span:
    noisy positions, random unit quaternions (port and JAX objects)."""
    rng = np.random.default_rng(seed)
    ts = np.sort(rng.uniform(traj.min_time, traj.max_time - 1e-6, n))
    ps = rng.normal(size=(n, 3))
    qs = rng.normal(size=(n, 4))
    qs /= np.linalg.norm(qs, axis=1, keepdims=True)
    port = [PositionMeasurement(t, p) for t, p in zip(ts, ps)]
    port += [OrientationMeasurement(t, q) for t, q in zip(ts, qs)]
    jax_ms = [JP(t, p) for t, p in zip(ts, ps)] + [JO(t, q) for t, q in zip(ts, qs)]
    return port, jax_ms


@pytest.mark.parametrize("kind", KINDS)
def test_measure_and_error_match_jax(kind):
    jt, tt = _pair(kind)
    port, jax_ms = _measurements(tt, 6, seed=1)
    for m, jm in zip(port, jax_ms):
        np.testing.assert_allclose(m.measure(tt), jm.measure(jt), rtol=TOL, atol=TOL)
        np.testing.assert_allclose(m.error(tt), jm.error(jt), rtol=TOL, atol=TOL)


def _close_rel(got, want, msg):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape, msg
    np.testing.assert_allclose(got, want, rtol=0.0,
                               atol=TOL * max(np.abs(want).max(), 1.0), err_msg=msg)


#: kinds whose dense linearization is held to the JAX package's (the other
#: kinds' residuals are held through total_cost); its cost is also the
#: total-cost reference there, which saves a JAX compile per kind
LINEARIZED = ("split", "se3")


@pytest.fixture(scope="module")
def problems():
    """Per trajectory kind: the port and JAX problems over the same pose
    rows, the JAX package's total cost and, for ``LINEARIZED`` kinds, its
    dense linearization (cost, H, g)."""
    out = {}
    for kind in KINDS:
        jt, tt = _pair(kind)
        port, jax_ms = _measurements(tt, 12, seed=2)
        tp, jp = Problem(tt, port, device="cpu"), JProblem(jt, jax_ms)
        jspec, jrt = JK.problem_spec(jp), JK.problem_runtime(jp)
        parts = JK.build_parts(jspec, True)
        if kind in LINEARIZED:
            jlin = jax.jit(parts["linearize"])(jrt, jp.state0)
            jcost = float(jlin[0])
        else:
            jlin, jcost = None, float(jax.jit(parts["total_cost"])(jrt, jp.state0))
        out[kind] = (tp, jp, jcost, jlin)
    return out


@pytest.mark.parametrize("kind", KINDS)
def test_bucket_terms_on_every_kind(problems, kind):
    tp = problems[kind][0]
    spec, rt = kernels.problem_spec(tp), kernels.problem_runtime(tp)
    assert [b.kind for b in spec.buckets] == ["position", "orientation"]
    C = sum(4 * {"r3": 3, "so3": 3, "se3": 6}[sp.kind] for sp in spec.splines)
    for bspec, data in zip(spec.buckets, rt["data"]):
        r, J, cols, J_rho = kernels.bucket_terms(spec, bspec, rt, tp.state0, data)
        assert J_rho is None
        assert r.shape == (bspec.M, bspec.rdim) and J.shape == (bspec.M, bspec.rdim, C)
        assert cols.shape == (bspec.M, C) and torch.isfinite(J).all()
        r_only = kernels.bucket_terms(spec, bspec, rt, tp.state0, data, cost_only=True)
        _close_rel(r_only, r.numpy(), f"{kind} {bspec.kind} cost-only r")
        # a position row has no orientation columns and vice versa
        blind = {"position": "so3", "orientation": "r3"}[bspec.kind]
        off = 0
        for sp in spec.splines:
            width = 4 * (6 if sp.kind == "se3" else 3)
            if sp.kind == blind:
                assert not J[:, :, off:off + width].any()
            off += width


@pytest.mark.parametrize("kind", KINDS)
def test_total_cost_matches_jax(problems, kind):
    tp, jp, jcost, _ = problems[kind]
    spec, rt = kernels.problem_spec(tp), kernels.problem_runtime(tp)
    assert kernels.total_cost(spec, rt, tp.state0).item() == pytest.approx(jcost, rel=TOL)
    for name in COUNTS:
        assert getattr(tp, name) == getattr(jp, name), name


@pytest.mark.parametrize("kind", LINEARIZED)
def test_linearization_matches_jax(problems, kind):
    tp, _, _, (jc, jH, jg) = problems[kind]
    spec, rt = kernels.problem_spec(tp), kernels.problem_runtime(tp)
    cost, H, g = kernels.build_parts(spec)["linearize"](rt, tp.state0)
    assert cost.item() == pytest.approx(float(jc), rel=TOL)
    _close_rel(H, jH, f"{kind} H")
    _close_rel(g, jg, f"{kind} g")


def test_locked_trajectory_counts_match_jax():
    jt, tt = _pair("split")
    jt.locked = tt.locked = True
    port, jax_ms = _measurements(tt, 12, seed=2)
    tp, jp = Problem(tt, port, device="cpu"), JProblem(jt, jax_ms)
    for name in COUNTS:
        assert getattr(tp, name) == getattr(jp, name), name
    assert tp.num_parameters_reduced == tp.num_residual_blocks_reduced == 0


def _fit(device="cpu"):
    """A short motion-capture fit: a perturbed split trajectory against
    noisy pose rows of the truth (port objects and their JAX twins)."""
    from kontiki_tpu_torch.synthetic import perturb_trajectory

    truth = make_split_trajectory(2.0, dt=0.1, seed=6)
    start = perturb_trajectory(truth, seed=7)
    ms = make_pose_measurements(truth, 0.0, 2.0, 50.0, 0.002, 0.002, seed=8)
    jt = JSplit(*(_pair_spline(sp) for sp in (start.R3_spline, start.SO3_spline)))
    jms = [JP(m.t, m.p) if isinstance(m, PositionMeasurement) else JO(m.t, m.q) for m in ms]
    return start, ms, jt, jms


def _pair_spline(sp):
    return _jax_spline(JR3 if sp.knots.shape[1] == 3 else JSO3, sp.knots, sp.dt, sp.t0)


def test_pose_fit_matches_jax_lm_solve():
    start, ms, jt, jms = _fit()
    start = start.clone()
    estimator = TrajectoryEstimator(start, device="cpu")
    for m in ms:
        estimator.add_measurement(m)
    got = estimator.solve(max_iterations=3, progress=False, function_tolerance=0.0)
    _, want = jlm.solve(JProblem(jt, jms), max_iterations=3, progress=False,
                        function_tolerance=0.0)
    assert len(got.iterations) == len(want.iterations) == 4
    for a, b in zip(got.iterations, want.iterations):
        assert a.cost == pytest.approx(b.cost, rel=1e-9)
        assert a.step_is_successful == b.step_is_successful
    for name in COUNTS[:6]:
        assert getattr(got, name) == getattr(want, name), name
    assert got.final_cost < 0.1 * got.initial_cost
    # the written-back trajectory holds the solution: its pose errors cost it
    on_cpu = SplitTrajectory(start.R3_spline, start.SO3_spline, device="cpu")
    cost = 0.5 * sum(float(np.sum(np.square(m.error(on_cpu)))) for m in ms)
    assert cost == pytest.approx(got.final_cost, rel=1e-6)


def test_sensor_frame_transforms_match_jax():
    from kontiki_tpu.sensors import BasicImu as JImu
    from kontiki_tpu_torch.sensors import BasicImu

    rng = np.random.default_rng(4)
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    pose = (q, rng.normal(size=3))
    sensor, jsensor = BasicImu(), JImu()
    sensor.relative_pose = jsensor.relative_pose = pose
    X, v = rng.normal(size=3), rng.normal(size=3)
    for name in ("from_trajectory", "to_trajectory"):
        np.testing.assert_allclose(getattr(sensor, name)(X), getattr(jsensor, name)(X),
                                   rtol=TOL, atol=TOL)
    np.testing.assert_allclose(sensor.to_trajectory(sensor.from_trajectory(X)), X,
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(sensor._rotate_to_sensor(q, v), jsensor._rotate_to_sensor(q, v),
                               rtol=TOL, atol=TOL)


def test_pose_measurement_generator():
    gen = make_split_trajectory(2.0, dt=0.1, seed=6)
    truth = SplitTrajectory(gen.R3_spline, gen.SO3_spline, device="cpu")
    ms = make_pose_measurements(truth, 0.0, 2.0, 50.0, seed=8)
    assert len(ms) == 200 and [type(m) for m in ms[::100]] == [PositionMeasurement,
                                                               OrientationMeasurement]
    assert max(np.abs(m.error(truth)).max() for m in ms) < 1e-12
    noisy = make_pose_measurements(truth, 0.0, 2.0, 50.0, 0.01, 0.01, seed=8)
    errs = np.array([np.linalg.norm(m.error(truth)) for m in noisy[:100]])
    assert 0.005 < errs.mean() < 0.03


def test_estimator_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    start, ms, _, _ = _fit()
    estimator = TrajectoryEstimator(start)
    estimator.add_measurement(ms[0])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        estimator.solve(progress=False)


# ---------------------------------------------------------------------------
# the reference's estimator callback oracles (tests/test_estimator.py) on a
# position fit of the handcrafted split trajectory
# ---------------------------------------------------------------------------

@pytest.fixture
def callback_estimator():
    from conftest import _make_trajectory

    jt = _make_trajectory(JSplit)
    r3, so3 = jt.R3_spline, jt.SO3_spline
    traj = interop.split_trajectory_from_numpy(
        np.asarray(r3.knots), np.asarray(so3.knots), r3.dt, so3.dt, r3.t0, so3.t0,
        device="cpu")
    estimator = TrajectoryEstimator(traj, device="cpu")
    rng = np.random.default_rng(3)
    for t in np.linspace(*traj.valid_time, endpoint=False, num=20):
        estimator.add_measurement(PositionMeasurement(t, rng.uniform(-2, 3, size=3)))
    return estimator


def test_callback_returntype_none(callback_estimator):
    data = []
    callback_estimator.add_callback(lambda it: data.append("Foo"))
    summary = callback_estimator.solve(max_iterations=10, progress=False)
    assert summary.termination_type == TerminationType.Convergence
    assert len(data) > 0


@pytest.mark.parametrize("ret,termination", [
    (CallbackReturnType.Abort, TerminationType.UserFailure),
    (CallbackReturnType.TerminateSuccessfully, TerminationType.UserSuccess),
])
def test_callback_ends_the_solve(callback_estimator, ret, termination):
    callback_estimator.add_callback(lambda it: ret)
    summary = callback_estimator.solve(max_iterations=4, progress=False)
    assert summary.termination_type == termination


def test_callback_multiple(callback_estimator):
    returned = []
    for i in range(10):
        callback_estimator.add_callback(lambda it, i=i: returned.append(i))
    callback_estimator.solve(max_iterations=5, progress=False)
    counter = Counter(returned)
    for i in range(1, 10):
        assert counter[i] > 1 and counter[i] == counter[0]


@pytest.mark.parametrize("update", [True, False])
def test_callback_state_update(callback_estimator, update):
    def get_knots():
        return np.vstack([knot for knot in callback_estimator.trajectory.R3_spline.knots])

    knots0 = get_knots()
    seen = []
    callback_estimator.add_callback(lambda it: seen.append(get_knots()), update_state=update)
    callback_estimator.solve(max_iterations=5, progress=False)
    if update:
        assert any(not np.allclose(a, b) for a, b in zip(seen, seen[1:]))
    else:
        for knots in seen:
            np.testing.assert_equal(knots0, knots)
