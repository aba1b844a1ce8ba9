#!/usr/bin/env python3
"""The JAX package's float32 values that ``chip_smoke.py``'s f32-tier phase
holds the port to, computed on the CPU.

The JAX package's float32 tier is its ``KONTIKI_TPU_X64=0`` configuration
(``kontiki_tpu/config.py``): state, data, times and normal equations in
float32, no compensated accumulation. This script sets it before importing
the package, as ``tests/f32_check.py`` does, and runs the five BASELINE
configs as ``bench.py`` builds them:

- configs 1-4 through ``make_fused_solver(problem, 25,
  function_tolerance=0.0)`` ('auto': dense for 1-2, Schur for 3-4);
- config 5 through ``make_segment_ba_solver(problem, mesh of one device,
  max_iterations=6, function_tolerance=0.0, mode="banded")``.

For each it prints the initial cost (the same solver with
``max_iterations=0``), the final cost and iterations, and the score of the
start and of the solution against the truth, as ``tests/f32_check.py``
scores each config: config 1 the aligned AOE on [0.5, 5.5], config 2 the
ATE on [0.5, 5.5], config 3 the sim3-aligned ATE and config 4 the
se3-aligned ATE on the views' span, config 5 the se3-aligned ATE on
[t1, t2]. The last line is the values as JSON.

Run from the repository root: ``JAX_PLATFORMS=cpu python3
tools/f32_reference.py`` (config 5 takes a few minutes and a few GB of
memory); ``--only config1 config4`` runs some of them; ``--json PATH``
also writes the values there.
"""
import argparse
import json
import os
import sys
import time

os.environ["KONTIKI_TPU_X64"] = "0"
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", False)

import numpy as np  # noqa: E402

from kontiki_tpu import parallel  # noqa: E402
from kontiki_tpu.config import default_dtype  # noqa: E402
from kontiki_tpu.parallel.segments_ba import make_segment_ba_solver  # noqa: E402
from kontiki_tpu.solver.lm import make_fused_solver  # noqa: E402
from kontiki_tpu.solver.problem import Problem  # noqa: E402
from kontiki_tpu.synthetic import (  # noqa: E402
    make_big_ba_problem,
    make_gyro_problem,
    make_imu_problem,
    make_rsvi_problem,
    trajectory_aoe,
    trajectory_ate,
)

ITERATIONS = {"config1": 25, "config2": 25, "config3": 25, "config4": 25, "config5": 6}


def _objects(name):
    """(generator output, score(traj) -> float) of configs 1-4."""
    if name == "config1":
        prob = make_gyro_problem(duration=5.0, rate=200.0, seed=1)
        return prob, lambda tr: trajectory_aoe(prob["true_trajectory"], tr, 0.5, 5.5)
    if name == "config2":
        prob = make_imu_problem(duration=5.0, rate=200.0, seed=2)
        return prob, lambda tr: trajectory_ate(prob["true_trajectory"], tr, 0.5, 5.5)
    kwargs = (dict(nviews=32, nlandmarks=200, imu_rate=0.0, seed=3) if name == "config3" else
              dict(nviews=64, nlandmarks=200, imu_rate=200.0, seed=4, trajectory="se3"))
    prob = make_rsvi_problem(**kwargs)
    t1, t2 = prob["views"][0].t0, prob["views"][-1].t0
    align = "sim3" if name == "config3" else "se3"
    return prob, lambda tr: trajectory_ate(prob["true_trajectory"], tr, t1, t2, align=align)


def run_objects(name):
    prob, score = _objects(name)
    problem = Problem(prob["trajectory"], prob["measurements"])
    s0 = problem.state0
    assert next(iter(s0.values())).dtype == np.float32
    out = {"score0": score(prob["trajectory"])}
    _, cost0, _ = make_fused_solver(problem, 0, function_tolerance=0.0)(s0)
    out["cost0"] = float(cost0)
    state, cost, it = make_fused_solver(problem, ITERATIONS[name], function_tolerance=0.0)(s0)
    out["cost"], out["iterations"] = float(cost), int(it)
    problem.write_back(state)
    out["score"] = score(prob["trajectory"])
    return out


def run_config5():
    big = make_big_ba_problem(n_views=10_000, n_landmarks=100_000, obs_per_landmark=5, seed=5)
    problem = big["problem"]
    s0 = problem.state0
    assert s0["r3"].dtype == np.float32
    mesh = parallel.default_mesh(n_devices=1)
    truth, t1, t2 = big["true_trajectory"], big["t1"], big["t2"]
    out = {"score0": trajectory_ate(truth, big["trajectory"], t1, t2, align="se3")}
    _, cost0, _ = make_segment_ba_solver(problem, mesh, max_iterations=0, function_tolerance=0.0,
                                         mode="banded")(s0)
    out["cost0"] = float(cost0)
    state, cost, it = make_segment_ba_solver(problem, mesh, max_iterations=ITERATIONS["config5"],
                                             function_tolerance=0.0, mode="banded")(s0)
    out["cost"], out["iterations"] = float(cost), int(it)
    solved = big["trajectory"].clone()
    solved.R3_spline.set_knots(np.asarray(state["r3"], np.float64))
    solved.SO3_spline.set_knots(np.asarray(state["so3"], np.float64))
    out["score"] = trajectory_ate(truth, solved, t1, t2, align="se3")
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", nargs="*", default=sorted(ITERATIONS), choices=sorted(ITERATIONS))
    ap.add_argument("--json", default=None)
    args = ap.parse_args()
    assert default_dtype == np.float32, default_dtype

    values = {}
    for name in args.only:
        t0 = time.time()
        values[name] = run_config5() if name == "config5" else run_objects(name)
        print(f"{name}: {values[name]} ({time.time() - t0:.1f} s)", flush=True)
    print(json.dumps(values), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(values, f)


if __name__ == "__main__":
    main()
