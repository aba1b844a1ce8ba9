#!/usr/bin/env python3
"""The JAX package's float64 values that ``chip_smoke.py``'s atan-camera
and lifting phases hold the port to, computed on the CPU.

Config 3-atan and config 3-atan-lifting: BASELINE config 3's generator
with an atan camera, static or lifting rows,
``make_rsvi_problem(nviews=32, nlandmarks=200, imu_rate=0.0, seed=3,
camera_kind="atan", rs="static" | "lifting")``. Printed per problem:

1. the structure: rows per bucket, the tangent size, the lifted row times
   and the reduced (Schur) system's size;
2. the cost at ``state0`` (the Schur linearization's) and the final costs
   and iterations of ``make_fused_solver(problem, n, function_tolerance=0.0,
   strategy="schur")`` for n = 1 and 25;

and for both, ``TrajectoryEstimator(trajectory).solve(max_iterations=10,
progress=False, function_tolerance=0.0)`` (the phase-split ``lm.solve``):
the initial, iteration-1 and final costs, the Summary's counts, the steps
taken, the written-back row times' sum, min and max (lifting), and the
unaligned ATE (n = 200 on [0.5, 0.5 + 31/30)) of the written-back
trajectory and of the start against the truth.

Run from the repository root: ``JAX_PLATFORMS=cpu python3
tools/atan_lifting_reference.py`` (a few minutes). ``--views`` and
``--landmarks`` shrink the problems for a rehearsal; ``--json PATH`` also
writes the values there.
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

from kontiki_tpu import TrajectoryEstimator, synthetic  # noqa: E402
from kontiki_tpu.solver import kernels  # noqa: E402
from kontiki_tpu.solver.lm import make_fused_solver  # noqa: E402
from kontiki_tpu.solver.problem import Problem  # noqa: E402
from kontiki_tpu.solver.schur import build_schur_parts  # noqa: E402

COUNTS = ("num_parameters", "num_parameter_blocks", "num_parameters_reduced",
          "num_parameter_blocks_reduced", "num_residuals", "num_residual_blocks",
          "num_residuals_reduced", "num_residual_blocks_reduced")


def config(rs, views, landmarks):
    return dict(nviews=views, nlandmarks=landmarks, imu_rate=0.0, seed=3,
                camera_kind="atan", rs=rs)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--views", type=int, default=32)
    ap.add_argument("--landmarks", type=int, default=200)
    ap.add_argument("--json", default=None)
    args = ap.parse_args()

    out = {}
    for rs in ("static", "lifting"):
        name = f"config 3-atan{'-lifting' if rs == 'lifting' else ''}"
        t0 = time.time()
        prob = synthetic.make_rsvi_problem(**config(rs, args.views, args.landmarks))
        problem = Problem(prob["trajectory"], prob["measurements"])
        spec = kernels.problem_spec(problem)
        runtime = kernels.problem_runtime(problem)
        shape = {b.kind: b.M for b in spec.buckets}
        shape.update(num_tangent=spec.num_tangent, num_vt=spec.num_vt,
                     Pc=spec.num_tangent - spec.num_landmarks)
        rec = dict(shape=shape)
        lin = jax.jit(build_schur_parts(spec, True)["linearize"])
        rec["cost0"] = float(lin(runtime, problem.state0)[0])
        for n in (1, 25):
            state, cost, it = make_fused_solver(problem, n, function_tolerance=0.0,
                                                strategy="schur")(problem.state0)
            rec[f"cost{n}"] = float(cost)
            rec[f"iterations{n}"] = int(it)
        print(f"{name}: {rec} ({time.time() - t0:.1f} s)", flush=True)
        out[name] = rec

    for rs in ("static", "lifting"):
        name = f"config 3-atan{'-lifting' if rs == 'lifting' else ''}"
        t0 = time.time()
        prob = synthetic.make_rsvi_problem(**config(rs, args.views, args.landmarks))
        truth, span = prob["true_trajectory"], (0.5, 0.5 + (args.views - 1) / 30)
        ate_start = synthetic.trajectory_ate(prob["trajectory"], truth, *span)
        est = TrajectoryEstimator(prob["trajectory"])
        for m in prob["measurements"]:
            est.add_measurement(m)
        s = est.solve(max_iterations=10, progress=False, function_tolerance=0.0)
        rec = dict(cost0=s.initial_cost, cost1=s.iterations[1].cost, final=s.final_cost,
                   counts=[getattr(s, k) for k in COUNTS],
                   steps=[s.num_successful_steps, s.num_unsuccessful_steps],
                   termination=s.termination_type.name, ate_start=ate_start,
                   ate=synthetic.trajectory_ate(prob["trajectory"], truth, *span))
        if rs == "lifting":
            vt = np.array([m.vt for m in prob["measurements"]])
            rec["vt"] = [float(vt.sum()), float(vt.min()), float(vt.max())]
        print(f"{name} estimator: {rec} ({time.time() - t0:.1f} s)", flush=True)
        out[name]["estimator"] = rec
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
