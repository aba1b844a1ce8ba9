#!/usr/bin/env python3
"""The JAX package's float64 values that ``chip_smoke.py``'s long-sequence
IMU phase holds the port to, computed on the CPU.

The problem is the port's ``synthetic.make_long_imu_problem`` built with the
JAX package's own functions: ``make_split_trajectory(duration + 1.0,
dt=0.1, seed=2)``, a ``ConstantBiasImu`` with config 2's biases (both
unlocked), ideal gyro and accel samples at 200 Hz on [0.5, 0.5 + duration)
with the biases added, SEW weights (``sew.knot_spacing_and_variance(...,
0.99)``, weight ``1 / sqrt(variance)``) into one ``GyroscopeMeasurements``
and one ``AccelerometerMeasurements``, and the truth perturbed as in config
2 (``sigma_p=0.05, sigma_q=0.02``, seed 3). Printed: SEW's spacings and
variances, the problem's counts and its initial cost (the cost-only path),
and, on the rows of the first ``--cut`` seconds of the same arrays (the
same trajectory, weights and start), the cost of every iteration of
``lm.solve(problem, max_iterations=N, strategy="banded",
function_tolerance=0.0)`` (the phase-split LM the port's
``TrajectoryEstimator.solve`` runs). The banded solve is cut because the
JAX package's band assembly holds about 80 kB per row at once (3.8 GB of
host memory at 100 s, 7.0 GB at 200 s: ~33 GB at 1,000 s).

Run from the repository root: ``JAX_PLATFORMS=cpu python3
tools/imu_long_reference.py`` (1,000 s, the solve on the first 100 s, 5
iterations: about a minute and 4 GB; ``--json PATH`` also writes the values
there).
"""
import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

from kontiki_tpu import sew, synthetic  # noqa: E402
from kontiki_tpu.measurements import (  # noqa: E402
    AccelerometerMeasurements,
    GyroscopeMeasurements,
)
from kontiki_tpu.sensors import ConstantBiasImu  # noqa: E402
from kontiki_tpu.solver.kernels import make_functions  # noqa: E402
from kontiki_tpu.solver.lm import solve  # noqa: E402
from kontiki_tpu.solver.problem import Problem  # noqa: E402

COUNTS = ("num_parameters", "num_parameter_blocks", "num_parameters_reduced",
          "num_parameter_blocks_reduced", "num_residuals", "num_residual_blocks",
          "num_residuals_reduced", "num_residual_blocks_reduced")


def long_imu_problem(duration, rate=200.0, knot_dt=0.1, seed=2, quality=0.99):
    true_traj = synthetic.make_split_trajectory(duration + 1.0, dt=knot_dt, seed=seed)
    rng = np.random.default_rng(seed + 7)
    imu = ConstantBiasImu(rng.normal(scale=0.05, size=3), rng.normal(scale=0.01, size=3))
    imu.accelerometer_bias_locked = False
    imu.gyroscope_bias_locked = False
    ts = np.arange(0.5, 0.5 + duration, 1.0 / rate)
    w, a = (np.asarray(x) for x in synthetic._body_imu(true_traj, ts))
    w = w + imu.gyroscope_bias
    a = a + imu.accelerometer_bias
    spacing = {"gyro": sew.knot_spacing_and_variance(w.T, ts, quality),
               "accel": sew.knot_spacing_and_variance(a.T, ts, quality)}
    ms = [GyroscopeMeasurements(imu, ts, w, weight=1.0 / np.sqrt(spacing["gyro"][1])),
          AccelerometerMeasurements(imu, ts, a, weight=1.0 / np.sqrt(spacing["accel"][1]))]
    traj = synthetic.perturb_trajectory(true_traj, sigma_p=0.05, sigma_q=0.02, seed=seed + 1)
    return traj, ms, spacing


def cut(ms, t_end):
    """The containers' rows at times before ``t_end`` (same weights)."""
    return [type(m)(m.imu, m.t[m.t < t_end], getattr(m, m._value_field)[m.t < t_end],
                    weight=m.weight[m.t < t_end]) for m in ms]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--duration", type=float, default=1000.0)
    ap.add_argument("--cut", type=float, default=100.0)
    ap.add_argument("--iterations", type=int, default=5)
    ap.add_argument("--json", default=None)
    args = ap.parse_args()

    t0 = time.time()
    traj, ms, spacing = long_imu_problem(args.duration)
    problem = Problem(traj, ms)
    out = {"duration": args.duration,
           "sew": {k: [float(v[0]), float(v[1])] for k, v in spacing.items()},
           "num_tangent": int(problem.num_tangent),
           "counts": {k: int(getattr(problem, k)) for k in COUNTS},
           "cost0": float(make_functions(problem)[0](problem.state0))}
    print(f"problem: {out} ({time.time() - t0:.1f} s)", flush=True)
    t0 = time.time()
    problem = Problem(traj, cut(ms, 0.5 + args.cut))
    out["cut"] = args.cut
    out["cut_rows"] = int(problem.num_residual_blocks)
    _, summary = solve(problem, max_iterations=args.iterations, strategy="banded",
                       function_tolerance=0.0)
    out["costs"] = [float(it.cost) for it in summary.iterations]
    out["successful"] = [bool(it.step_is_successful) for it in summary.iterations]
    print(f"first {args.cut} s, banded lm.solve: costs {out['costs']!r}, steps {out['successful']} "
          f"({time.time() - t0:.1f} s)", flush=True)
    print(json.dumps(out), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
