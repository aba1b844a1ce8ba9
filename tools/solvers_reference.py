#!/usr/bin/env python3
"""The JAX package's float64 values that ``chip_smoke.py``'s solver-family
phases (the iterative-Schur and banded strategies, segment BA's PCG mode)
hold the port to, computed on the CPU.

Printed per part (``--only`` picks some of them):

- ``config4``: BASELINE config 4 (``make_rsvi_problem(nviews=64,
  nlandmarks=200, imu_rate=200.0, seed=4, trajectory="se3")``): the final
  costs and iterations of ``make_fused_solver(problem, n,
  function_tolerance=0.0, strategy="iterative_schur")`` for n = 1 and 5;
- ``lifting``: config 3-atan-lifting (config 3's generator with
  ``camera_kind="atan", rs="lifting"``): the same two solves;
- ``gyro10k``: the 10,050-knot SO3 gyro ``RawProblem`` of
  ``tests/test_banded.py`` (20 Hz gyro rows, knots perturbed by 1e-3 from
  seed 1): one ``make_banded_step`` step at lam = 1e-2, its cost, new cost
  and predicted decrease;
- ``config5pcg``: BASELINE config 5 (``make_big_ba_problem(n_views=10_000,
  n_landmarks=100_000, obs_per_landmark=5, seed=5)``) on a mesh of one
  device: the final cost and iterations of ``make_segment_ba_solver(
  problem, mesh, max_iterations=n, function_tolerance=0.0, mode="pcg")``
  (its default ``cg_tol=1e-6``, ``cg_maxiter=200``) for n = 1 and 6;
- ``config5cut``: the same problem, one ``make_segment_ba_step(problem,
  mesh, mode="pcg", cg_tol=1e-14, cg_maxiter=5)`` step at lam = 1e-4, CG
  cut after 5 iterations (where the step depends on the preconditioner
  and not yet on roundoff): its cost, new cost, predicted decrease and
  max |gradient|.

Run from the repository root: ``JAX_PLATFORMS=cpu python3
tools/solvers_reference.py`` (``--only config4 lifting gyro10k`` takes a
few minutes; ``config5pcg`` and ``config5cut`` longer, and several GB of
memory). ``--json
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
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402

from kontiki_tpu import synthetic  # noqa: E402
from kontiki_tpu.solver.lm import make_fused_solver  # noqa: E402
from kontiki_tpu.solver.problem import Problem, RawBucket, RawProblem  # noqa: E402

CONFIG4 = dict(nviews=64, nlandmarks=200, imu_rate=200.0, seed=4, trajectory="se3")
LIFTING = dict(nviews=32, nlandmarks=200, imu_rate=0.0, seed=3, camera_kind="atan",
               rs="lifting")


def iterative(kwargs):
    prob = synthetic.make_rsvi_problem(**kwargs)
    problem = Problem(prob["trajectory"], prob["measurements"])
    out = {}
    for n in (1, 5):
        t0 = time.time()
        _, cost, it = make_fused_solver(problem, n, function_tolerance=0.0,
                                        strategy="iterative_schur")(problem.state0)
        out[f"cost{n}"] = float(cost)
        out[f"iterations{n}"] = int(it)
        print(f"  cost after {int(it)}: {float(cost)!r} ({time.time() - t0:.1f} s)", flush=True)
    return out


def gyro10k_problem():
    """The 10,050-knot SO3 gyro RawProblem of tests/test_banded.py."""
    n_knots, dt = 10_050, 0.1
    duration = (n_knots - 4) * dt
    traj = synthetic.make_so3_trajectory(duration, dt=dt, seed=3, wmag=0.3)
    ts = np.arange(0.5, duration - 0.5, 0.05)
    w, _ = synthetic._body_imu(traj, ts)
    data = {"t": jnp.asarray(ts), "y": jnp.asarray(w), "weight": jnp.asarray(np.ones(len(ts))),
            "sid": jnp.asarray(np.zeros(len(ts), np.int32))}
    bucket = RawBucket(kind="gyro", M=len(ts), rdim=3, data=data, window={"so3": 4})
    knots = np.asarray(traj.knots)
    pert = knots + np.random.default_rng(1).normal(scale=1e-3, size=knots.shape)
    pert /= np.linalg.norm(pert, axis=1, keepdims=True)
    return RawProblem(
        splines=[("so3", pert, traj.t0, dt)], buckets={"gyro": bucket},
        sensors={"q_ct": np.tile([1.0, 0, 0, 0], (1, 1)), "p_ct": np.zeros((1, 3)),
                 "d": np.zeros(1), "abias": np.zeros((1, 3)), "gbias": np.zeros((1, 3)),
                 "mask": np.zeros((1, 13)), "d_max": np.zeros(1)},
        rho=np.zeros(0))


def gyro10k():
    from kontiki_tpu.solver.banded import make_banded_step

    problem = gyro10k_problem()
    t0 = time.time()
    step, _ = make_banded_step(problem)
    c0, _, nc, pred, _, _ = step(problem.state0, 1e-2)
    out = dict(num_tangent=int(problem.num_tangent), cost0=float(c0), new_cost=float(nc),
               pred=float(pred))
    print(f"  {out} ({time.time() - t0:.1f} s)", flush=True)
    return out


def config5pcg():
    from kontiki_tpu import parallel
    from kontiki_tpu.parallel.segments_ba import make_segment_ba_solver

    big = synthetic.make_big_ba_problem(n_views=10_000, n_landmarks=100_000,
                                        obs_per_landmark=5, seed=5)
    problem = big["problem"]
    mesh = parallel.default_mesh(n_devices=1)
    out = {}
    for n in (1, 6):
        t0 = time.time()
        _, cost, it = make_segment_ba_solver(problem, mesh, max_iterations=n,
                                             function_tolerance=0.0,
                                             mode="pcg")(problem.state0)
        out[f"cost{n}"] = float(cost)
        out[f"iterations{n}"] = int(it)
        print(f"  cost after {int(it)}: {float(cost)!r} ({time.time() - t0:.1f} s)", flush=True)
    return out


def config5cut():
    from kontiki_tpu import parallel
    from kontiki_tpu.parallel.segments_ba import make_segment_ba_step

    big = synthetic.make_big_ba_problem(n_views=10_000, n_landmarks=100_000,
                                        obs_per_landmark=5, seed=5)
    problem = big["problem"]
    t0 = time.time()
    step, _ = make_segment_ba_step(problem, parallel.default_mesh(n_devices=1), mode="pcg",
                                   cg_tol=1e-14, cg_maxiter=5)
    cost, _, new_cost, pred, gmax = step(problem.state0, 1e-4)
    out = dict(cost=float(cost), new_cost=float(new_cost), pred=float(pred), gmax=float(gmax))
    print(f"  {out} ({time.time() - t0:.1f} s)", flush=True)
    return out


PARTS = dict(config4=lambda: iterative(CONFIG4), lifting=lambda: iterative(LIFTING),
             gyro10k=gyro10k, config5pcg=config5pcg, config5cut=config5cut)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", nargs="+", choices=sorted(PARTS), default=list(PARTS))
    ap.add_argument("--json", default=None)
    args = ap.parse_args()
    out = {}
    for name in args.only:
        print(f"{name}:", flush=True)
        out[name] = PARTS[name]()
    print(json.dumps(out), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f)


if __name__ == "__main__":
    main()
