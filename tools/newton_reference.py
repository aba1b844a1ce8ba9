#!/usr/bin/env python3
"""The JAX package's float64 values that ``chip_smoke.py``'s config
4-Newton phase holds the port to, computed on the CPU.

Config 4-Newton is BASELINE config 4's generator on the split trajectory
with Newton rolling-shutter rows (``bench.py``),
``make_rsvi_problem(nviews=64, nlandmarks=200, imu_rate=200.0, seed=4,
rs="newton", trajectory="split")``. Printed:

1. the structure: rows per bucket, each bucket's window widths, the
   tangent size and the reduced (Schur) system's size;
2. the cost at ``state0`` (the Schur linearization's) and the final costs
   and iterations of ``make_fused_solver(problem, n, function_tolerance=0.0,
   strategy="schur")`` for each n of ``--iterations`` (1 and 25);
3. ``TrajectoryEstimator(trajectory).solve(max_iterations=10,
   progress=False, function_tolerance=0.0)`` (the phase-split
   ``lm.solve``): the initial, iteration-1 and final costs, the Summary's
   counts, the steps taken and the unaligned ATE (n = 200 on [0.5, 0.5 +
   63/30)) of the written-back trajectory and of the start against the
   truth;

and each part's seconds on the host.

On the CPU the JAX package runs its fused Newton tile only when
``KONTIKI_LINEARIZE`` is ``xla`` (its vmapped ``jacfwd`` path takes minutes
a solve at this size); this script sets it before importing the package.

Run from the repository root: ``JAX_PLATFORMS=cpu python3
tools/newton_reference.py`` (about 7 minutes on an 8-core x86 CPU: the
structure 9 s, the cost at ``state0`` 37 s, the 1-iteration solve 66 s,
the 25-iteration solve 222 s, the estimator 85 s, each with its
compile). ``--views`` and ``--landmarks`` shrink the problem for a
rehearsal; ``--iterations`` names the fused solves' lengths; ``--json
PATH`` also writes the values there.
"""
import argparse
import json
import os
import sys
import time

os.environ["KONTIKI_LINEARIZE"] = "xla"
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from kontiki_tpu import TrajectoryEstimator, synthetic  # noqa: E402
from kontiki_tpu.solver import kernels  # noqa: E402
from kontiki_tpu.solver.lm import make_fused_solver  # noqa: E402
from kontiki_tpu.solver.problem import Problem  # noqa: E402
from kontiki_tpu.solver.schur import build_schur_parts  # noqa: E402

COUNTS = ("num_parameters", "num_parameter_blocks", "num_parameters_reduced",
          "num_parameter_blocks_reduced", "num_residuals", "num_residual_blocks",
          "num_residuals_reduced", "num_residual_blocks_reduced")


def config(views, landmarks):
    return dict(nviews=views, nlandmarks=landmarks, imu_rate=200.0, seed=4, rs="newton",
                trajectory="split")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--views", type=int, default=64)
    ap.add_argument("--landmarks", type=int, default=200)
    ap.add_argument("--iterations", type=int, nargs="+", default=[1, 25])
    ap.add_argument("--json", default=None)
    args = ap.parse_args()

    t0 = time.time()
    prob = synthetic.make_rsvi_problem(**config(args.views, args.landmarks))
    problem = Problem(prob["trajectory"], prob["measurements"])
    spec = kernels.problem_spec(problem)
    runtime = kernels.problem_runtime(problem)
    shape = {b.kind: b.M for b in spec.buckets}
    shape.update(num_tangent=spec.num_tangent, Pc=spec.num_tangent - spec.num_landmarks,
                 windows={b.kind: list(b.windows) for b in spec.buckets})
    out = dict(shape=shape)
    print(f"config 4-Newton: structure {shape} ({time.time() - t0:.1f} s)", flush=True)

    t0 = time.time()
    lin = jax.jit(build_schur_parts(spec, True)["linearize"])
    out["cost0"] = float(lin(runtime, problem.state0)[0])
    print(f"config 4-Newton: cost0 {out['cost0']!r} ({time.time() - t0:.1f} s)", flush=True)
    for n in args.iterations:
        t0 = time.time()
        state, cost, it = make_fused_solver(problem, n, function_tolerance=0.0,
                                            strategy="schur")(problem.state0)
        out[f"cost{n}"] = float(cost)
        out[f"iterations{n}"] = int(it)
        print(f"config 4-Newton: {n} iterations: cost {float(cost)!r}, {int(it)} iterations "
              f"({time.time() - t0:.1f} s)", flush=True)

    t0 = time.time()
    prob = synthetic.make_rsvi_problem(**config(args.views, args.landmarks))
    truth, span = prob["true_trajectory"], (0.5, 0.5 + (args.views - 1) / 30)
    ate_start = synthetic.trajectory_ate(prob["trajectory"], truth, *span)
    est = TrajectoryEstimator(prob["trajectory"])
    for m in prob["measurements"]:
        est.add_measurement(m)
    s = est.solve(max_iterations=10, progress=False, function_tolerance=0.0)
    out["estimator"] = dict(
        cost0=s.initial_cost, cost1=s.iterations[1].cost, final=s.final_cost,
        counts=[getattr(s, k) for k in COUNTS],
        steps=[s.num_successful_steps, s.num_unsuccessful_steps],
        termination=s.termination_type.name, ate_start=ate_start,
        ate=synthetic.trajectory_ate(prob["trajectory"], truth, *span))
    print(f"config 4-Newton estimator: {out['estimator']} ({time.time() - t0:.1f} s)",
          flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
