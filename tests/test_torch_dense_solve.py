"""Port parity, end to end, BASELINE config 2's path: ``make_imu_problem``
(split R3/SO3 trajectory, gyro + accel rows, unlocked constant biases) ->
``Problem`` -> ``make_fused_solver`` ('auto' -> dense, the classic loop with
B4's cost-only re-cost) in ``kontiki_tpu_torch`` against the JAX package's
``make_fused_solver``, cut to 1 s at 40 Hz with IMU noise so the final
cost is not at roundoff: 5 iterations, the same iteration count, the final
cost to rtol 1e-8 and the final state to 1e-7.

``jax_problem_from`` rebuilds the port's generated problem with the JAX
package's classes (cheaper than running its generator;
``tests/test_torch_dense.py`` holds the two generators to each other)."""
import numpy as np
import torch

from kontiki_tpu import measurements as jm
from kontiki_tpu import sensors as js
from kontiki_tpu import trajectories as jtr
from kontiki_tpu.solver.lm import make_fused_solver as jax_fused
from kontiki_tpu.solver.problem import Problem as JProblem
from kontiki_tpu_torch import trajectories as ttr
from kontiki_tpu_torch.sensors import ConstantBiasImu
from kontiki_tpu_torch.solver.lm import make_fused_solver as torch_fused
from kontiki_tpu_torch.solver.problem import Problem as TProblem
from kontiki_tpu_torch.synthetic import make_imu_problem

torch.set_num_threads(1)
SMALL = dict(duration=1.0, rate=40.0, seed=2, noise=0.05)


def _jax_spline(sp):
    out = getattr(jtr, type(sp).__name__)(sp.dt, sp.t0)
    for i in range(len(sp)):
        out.append_knot(sp[i])
    return out


def jax_problem_from(tgen):
    """The JAX package's Problem over the port's generated trajectory, IMU
    (biases, locks, time offset) and measurements."""
    tt = tgen["trajectory"]
    if isinstance(tt, ttr.SplitTrajectory):
        traj = jtr.SplitTrajectory(_jax_spline(tt.R3_spline), _jax_spline(tt.SO3_spline))
    else:
        traj = _jax_spline(tt)
    imu = tgen["imu"]
    if isinstance(imu, ConstantBiasImu):
        jimu = js.ConstantBiasImu(imu.accelerometer_bias, imu.gyroscope_bias)
        jimu.accelerometer_bias_locked = imu.accelerometer_bias_locked
        jimu.gyroscope_bias_locked = imu.gyroscope_bias_locked
    else:
        jimu = js.BasicImu()
    jimu.max_time_offset = imu.max_time_offset
    jimu.time_offset = imu.time_offset
    jimu.time_offset_locked = imu.time_offset_locked
    ms = [jm.GyroscopeMeasurement(jimu, m.t, m.w, m.weight) if hasattr(m, "w")
          else jm.AccelerometerMeasurement(jimu, m.t, m.a, m.weight)
          for m in tgen["measurements"]]
    return JProblem(traj, ms)


def check_solve_matches_jax(tgen, iterations=5):
    J = jax_problem_from(tgen)
    T = TProblem(tgen["trajectory"], tgen["measurements"], device="cpu")
    for k, v in T.state0.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(J.state0[k]), err_msg=k)
    jstate, jcost, jit = jax_fused(J, iterations, function_tolerance=0.0)(J.state0)
    state, cost, it = torch_fused(T, iterations, function_tolerance=0.0)(T.state0)
    assert it == int(jit) == iterations
    assert cost.item() < 0.1 * torch_fused(T, 0)(T.state0)[1].item()
    np.testing.assert_allclose(cost.item(), float(jcost), rtol=1e-8)
    for k, v in state.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(jstate[k]), rtol=0, atol=1e-7,
                                   err_msg=k)


def test_config2_path_matches_jax():
    check_solve_matches_jax(make_imu_problem(**SMALL))
