#!/usr/bin/env python3
"""The JAX package's float64 values that ``chip_smoke.py``'s query and
pose-fit phases hold the port to, computed on the CPU:

1. config 4's SE3 trajectory as ``make_rsvi_problem`` builds it (the
   perturbed start), queried at its 425 gyro times: per query the sum of
   |values| and rows 0, 212 and 424;
2. ``trajectory_ate(trajectory, truth, 0.5, 0.5 + 63/30)`` of the built
   trajectory (align False and "se3"); then
   ``TrajectoryEstimator(trajectory).solve(max_iterations=10,
   function_tolerance=0.0)`` on config 4's measurements and the same ATEs
   and ``trajectory_aoe`` (align False) of the written-back trajectory;
3. the motion-capture pose fit: ``make_split_trajectory(60.0, dt=0.1,
   seed=6)`` perturbed with ``perturb_trajectory(seed=7)``, position and
   orientation measurements at 100 Hz on [0, 60) with noise std 0.002 (m
   and rad) from numpy seed 8 (``kontiki_tpu_torch.synthetic.
   make_pose_measurements`` with the JAX package's classes), and
   ``lm.solve(problem, max_iterations=1, function_tolerance=0.0)``: the
   initial and iteration-1 costs and the Summary's counts.

Run from the repository root: ``JAX_PLATFORMS=cpu python3
tools/query_reference.py`` (a few minutes).
"""
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from kontiki_tpu import TrajectoryEstimator, synthetic  # noqa: E402
from kontiki_tpu.measurements import (  # noqa: E402
    GyroscopeMeasurement,
    OrientationMeasurement,
    PositionMeasurement,
)
from kontiki_tpu.rotations import quat_mult  # noqa: E402
from kontiki_tpu.solver import lm  # noqa: E402
from kontiki_tpu.solver.problem import Problem  # noqa: E402

QUERIES = ("position", "velocity", "acceleration", "orientation", "angular_velocity")
ROWS = (0, 212, 424)


def pose_measurements(traj, t1, t2, rate, noise_p, noise_q, seed):
    """``kontiki_tpu_torch.synthetic.make_pose_measurements``, step for
    step, with the JAX package's trajectory and measurement classes."""
    rng = np.random.default_rng(seed)
    ts = np.arange(t1, t2, 1.0 / rate)
    res = traj._eval(ts)
    p = np.asarray(res["position"]) + rng.normal(scale=noise_p, size=(len(ts), 3))
    r = rng.normal(scale=noise_q, size=(len(ts), 3))
    theta = np.linalg.norm(r, axis=1, keepdims=True)
    axis = r / np.where(theta > 0, theta, 1.0)
    dq = np.concatenate([np.cos(theta / 2), np.sin(theta / 2) * axis], axis=1)
    q = np.stack([quat_mult(a, b) for a, b in zip(dq, np.asarray(res["orientation"]))])
    return ([PositionMeasurement(t, pi) for t, pi in zip(ts, p)]
            + [OrientationMeasurement(t, qi) for t, qi in zip(ts, q)])


def main():
    prob = synthetic.make_rsvi_problem(nviews=64, nlandmarks=200, imu_rate=200.0, seed=4,
                                       trajectory="se3")
    traj = prob["trajectory"]
    ts = np.array([m.t for m in prob["measurements"] if isinstance(m, GyroscopeMeasurement)])
    print(f"config 4 built trajectory at {len(ts)} gyro times:")
    for q in QUERIES:
        v = np.asarray(getattr(traj, q)(ts))
        print(f"  {q}: sum|.| {float(np.abs(v).sum())!r}")
        for i in ROWS:
            print(f"    row {i}: {[float(x) for x in v[i]]!r}")

    truth, span = prob["true_trajectory"], (0.5, 0.5 + 63 / 30)

    def scores(what):
        ate = [synthetic.trajectory_ate(traj, truth, *span, align=a) for a in (False, "se3")]
        aoe = synthetic.trajectory_aoe(traj, truth, *span, align=False)
        print(f"config 4 {what} trajectory vs truth: ATE {ate[0]!r}, ATE(se3) {ate[1]!r}, "
              f"AOE {aoe!r}")

    scores("built")
    est = TrajectoryEstimator(traj)
    for m in prob["measurements"]:
        est.add_measurement(m)
    summary = est.solve(max_iterations=10, progress=False, function_tolerance=0.0)
    print(f"config 4 estimator: final cost {summary.final_cost!r}")
    scores("written-back")

    truth = synthetic.make_split_trajectory(60.0, dt=0.1, seed=6)
    start = synthetic.perturb_trajectory(truth, seed=7)
    ms = pose_measurements(truth, 0.0, 60.0, 100.0, 0.002, 0.002, seed=8)
    _, s = lm.solve(Problem(start, ms), max_iterations=1, progress=False,
                    function_tolerance=0.0)
    counts = (s.num_parameters, s.num_parameter_blocks, s.num_parameters_reduced,
              s.num_residuals, s.num_residual_blocks)
    print(f"pose fit ({len(ms)} rows): cost0 {s.iterations[0].cost!r} "
          f"cost1 {s.iterations[1].cost!r} counts {counts}")


if __name__ == "__main__":
    main()
