#!/usr/bin/env python3
"""The JAX package's float64 values that ``chip_smoke.py``'s config-5 phase
holds the port to, computed on the CPU.

BASELINE config 5 as ``bench.py`` builds it:
``make_big_ba_problem(n_views=10_000, n_landmarks=100_000,
obs_per_landmark=5, seed=5)`` on a mesh of one device, banded mode. Printed:

1. the structure: camera rows and their weight sum, knots per spline, and
   the layout's ``seg``, ``G``, ``nbloc``, ``Lb``, ``LaMax`` and rows per
   anchor block ``Ma``;
2. the cost at ``state0``: ``make_segment_ba_solver(..., max_iterations=0)``
   (the speculative loop's first linearization) and ``total_cost`` of
   ``make_segment_ba_step`` (the residuals alone);
3. the final cost of ``make_segment_ba_solver(..., max_iterations=1,
   function_tolerance=0.0)``;
4. the final cost and iterations of the same solver with
   ``max_iterations=6``, and ``trajectory_ate`` (n = 200, unaligned) of its
   solution and of the perturbed start against the truth on [t1, t2].

Run from the repository root: ``JAX_PLATFORMS=cpu python3
tools/config5_reference.py`` (a few minutes, several GB of memory).
``--views``/``--landmarks`` shrink the problem for a rehearsal; ``--json
PATH`` also writes the values there.
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

from kontiki_tpu import parallel  # noqa: E402
from kontiki_tpu.parallel.segments_ba import (  # noqa: E402
    make_segment_ba_solver,
    make_segment_ba_step,
    segment_ba_layout,
)
from kontiki_tpu.synthetic import make_big_ba_problem, trajectory_ate  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--views", type=int, default=10_000)
    ap.add_argument("--landmarks", type=int, default=100_000)
    ap.add_argument("--json", default=None)
    args = ap.parse_args()

    t0 = time.time()
    big = make_big_ba_problem(n_views=args.views, n_landmarks=args.landmarks,
                              obs_per_landmark=5, seed=5)
    problem = big["problem"]
    print(f"generation {time.time() - t0:.1f} s", flush=True)
    t0 = time.time()
    _, _, _, lay = segment_ba_layout(problem, 1)
    cam = problem.buckets["rs_static:PinholeCamera"]
    out = dict(
        shape=dict(rows=int(cam.M), weight=float(np.asarray(cam.data["weight"]).sum()),
                   knots=int(problem.splines[0].n), seg=lay["seg"], G=lay["G"],
                   nbloc=lay["nbloc"], Lb=lay["Lb"], LaMax=lay["LaMax"],
                   Ma=[t["Ma"] for t in lay["banded_tables"]]),
    )
    print(f"layout {time.time() - t0:.1f} s: {out['shape']}", flush=True)

    mesh = parallel.default_mesh(n_devices=1)
    s0 = problem.state0
    for name, iters in (("cost0", 0), ("cost1", 1), ("cost6", 6)):
        t0 = time.time()
        solve = make_segment_ba_solver(problem, mesh, max_iterations=iters,
                                       function_tolerance=0.0, mode="banded")
        state, cost, it = solve(s0)
        out[name] = float(cost)
        print(f"{name}: {float(cost)!r} after {int(it)} iterations "
              f"({time.time() - t0:.1f} s)", flush=True)
    out["iterations6"] = int(it)
    t0 = time.time()
    _, total_cost = make_segment_ba_step(problem, mesh, mode="banded")
    out["total_cost0"] = float(total_cost(s0))
    print(f"total_cost0: {out['total_cost0']!r} ({time.time() - t0:.1f} s)", flush=True)

    solved = big["trajectory"].clone()
    solved.R3_spline.set_knots(np.asarray(state["r3"]))
    solved.SO3_spline.set_knots(np.asarray(state["so3"]))
    truth, t1, t2 = big["true_trajectory"], big["t1"], big["t2"]
    out["ate_start"] = trajectory_ate(big["trajectory"], truth, t1, t2)
    out["ate6"] = trajectory_ate(solved, truth, t1, t2)
    print(f"ATE vs truth on [{t1}, {t2}]: start {out['ate_start']!r}, after 6 iterations "
          f"{out['ate6']!r}", flush=True)
    print(json.dumps(out), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f)


if __name__ == "__main__":
    main()
