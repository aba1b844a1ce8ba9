#!/usr/bin/env python3
"""Accuracy of the port's band solve and PCG against their references, in
float64 on the CPU (the figures behind the band solve's refinement step
and the PCG gates of ``chip_smoke.py``).

Printed per part (``--only`` picks some of them):

- ``band``: BASELINE config 2 (``make_imu_problem(duration=5.0,
  rate=200.0, seed=2)``): its damped band at lam = 1e-4 (the banded
  strategy's ``damped_system``), the band's condition number, and for the
  scan (``solver.banded._scan_solve``), one PCR reduction
  (``_pcr_factor`` + ``_pcr_apply``) and ``block_tridiag_solve`` (PCR and
  one refinement step) the residual ``|T x - b| / |b|``, the error against
  a dense solve and the banded strategy's 1-iteration cost's distance from
  the dense strategy's;
- ``f32band``: the same in float32 (the problem built with
  ``dtype=torch.float32``; the errors against the float64 dense solve of
  the float32 band), then the 1,000-knot gyro band
  (``make_gyro_band_problem(n_knots=1000)``) through the fused banded
  strategy in float64 and float32: the cost after 0, 1, 2, 5 and 10
  iterations;
- ``cg``: a lifting problem (``make_rsvi_problem(nviews=6, nlandmarks=12,
  imu_rate=40.0, seed=29, rs="lifting", trajectory="split")`` with a
  perturbed start and 0.5 px noise, the camera's pose and time offset and
  the IMU's orientation unlocked) and the JAX package's twin over the same
  objects: the iterative-Schur step at lam = 1e-4 with CG cut after 5, 10,
  20 and 40 iterations, the largest difference of the port's step from
  the JAX package's and from the port's own with CG's right-hand side
  changed by 1e-15 relative;
- ``config5``: BASELINE config 5 (``make_big_ba_problem(n_views=10_000,
  n_landmarks=100_000, obs_per_landmark=5, seed=5)``): the port's
  segment-BA PCG step with CG cut after 5 iterations (``chip_smoke.py``'s
  ``CONFIG5_PCG_CUT``) against the JAX package's values in
  ``chip_smoke.JAX_CONFIG5_PCG["cut"]`` (from ``tools/solvers_reference.py
  --only config5cut``); a minute and a few GB.

Run from the repository root: ``JAX_PLATFORMS=cpu python3
tools/solver_accuracy.py`` (``band`` and ``cg`` take about a minute).
"""
import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from kontiki_tpu_torch import synthetic  # noqa: E402
from kontiki_tpu_torch.solver import banded, kernels  # noqa: E402
from kontiki_tpu_torch.solver.lm import make_fused_solver  # noqa: E402
from kontiki_tpu_torch.solver.problem import Problem  # noqa: E402


def _norm(a):
    return torch.linalg.vector_norm(a).item()


def band(dtype=torch.float64):
    gen = synthetic.make_imu_problem(duration=5.0, rate=200.0, seed=2)
    problem = Problem(gen["trajectory"], gen["measurements"], device="cpu", dtype=dtype)
    parts = banded.build_banded_parts(kernels.problem_spec(problem))
    rt = kernels.problem_runtime(problem)
    _, blocks = parts["linearize"](rt, problem.state0)
    D, U, rhs, _ = parts["damped_system"](rt, blocks, parts["grad_and_diag"](blocks)[0], 1e-4)
    nb, d, R = rhs.shape
    T = torch.zeros(nb * d, nb * d, dtype=torch.float64)
    for k in range(nb):
        T[k * d:(k + 1) * d, k * d:(k + 1) * d] = D[k]
        if k + 1 < nb:
            T[k * d:(k + 1) * d, (k + 1) * d:(k + 2) * d] = U[k]
            T[(k + 1) * d:(k + 2) * d, k * d:(k + 1) * d] = U[k].T
    dense = torch.linalg.solve(T, rhs.double().reshape(nb * d, R)).reshape(nb, d, R)
    print(f"config 2 damped band in {dtype}: {nb} blocks of {d}, {R} right-hand sides, "
          f"condition {torch.linalg.cond(T).item():.3e}")
    cost1_dense = make_fused_solver(problem, 1, function_tolerance=0.0,
                                    strategy="dense")(problem.state0)[1].item()
    solves = {"scan": banded._scan_solve,
              "one PCR reduction": lambda D, U, b: banded._pcr_apply(banded._pcr_factor(D, U), b),
              "block_tridiag_solve": banded.block_tridiag_solve}
    for name, solve in solves.items():
        x = solve(D, U, rhs)
        banded.block_tridiag_solve, keep = solve, banded.block_tridiag_solve
        try:
            cost1 = make_fused_solver(problem, 1, function_tolerance=0.0,
                                      strategy="banded")(problem.state0)[1].item()
        finally:
            banded.block_tridiag_solve = keep
        res = _norm(banded._band_matvec(D, U, x) - rhs) / _norm(rhs)
        err = _norm(x.double() - dense) / _norm(dense)
        print(f"  {name}: residual {res:.2e}, error against dense {err:.2e}, banded "
              f"1-iteration cost {abs(cost1 - cost1_dense) / cost1_dense:.2e} from dense")


def f32band():
    band(torch.float32)
    for dtype in (torch.float64, torch.float32):
        problem = synthetic.make_gyro_band_problem(n_knots=1000, device="cpu", dtype=dtype)
        costs = [make_fused_solver(problem, k, function_tolerance=0.0, strategy="banded")(
            problem.state0)[1].item() for k in (0, 1, 2, 5, 10)]
        print(f"gyro band, 1,000 knots, {dtype}: cost after 0, 1, 2, 5, 10 banded iterations "
              + ", ".join(f"{c:.3e}" for c in costs))


def cg():
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from kontiki_tpu.solver import iterative as jit_
    from kontiki_tpu.solver import kernels as jk
    from kontiki_tpu_torch.solver import iterative as tit
    from test_torch_split_camera import twin_pair

    gen = synthetic.make_rsvi_problem(nviews=6, nlandmarks=12, imu_rate=40.0, seed=29,
                                      rs="lifting", perturb_rho=0.03, sigma_p=0.01,
                                      sigma_q=0.005, noise_px=0.5, trajectory="split")
    for lock in ("relative_orientation_locked", "relative_position_locked",
                 "time_offset_locked"):
        setattr(gen["camera"], lock, False)
    gen["imu"].relative_orientation_locked = False
    pair = twin_pair(gen["trajectory"], gen["measurements"])
    J, T = pair["jax"], pair["torch"]
    jparts = jit_.build_iterative_parts(jk.problem_spec(J), True)
    jrt = jk.problem_runtime(J)
    jblocks = jax.jit(jparts["linearize"])(jrt, J.state0)[1]
    tparts = tit.build_iterative_parts(kernels.problem_spec(T))
    trt = kernels.problem_runtime(T)
    tblocks = tparts["linearize"](trt, T.state0)[1]
    pcg = tit.pcg

    def nudged(matvec, precond, b, *args, **kw):
        sign = 1.0 - 2.0 * (torch.arange(b.numel(), dtype=b.dtype) % 2)
        return pcg(matvec, precond, b * (1.0 + 1e-15 * sign), *args, **kw)

    print("lifting problem, sensors free: the iterative-Schur step at lam 1e-4")
    for n in (5, 10, 20, 40):
        want = jax.jit(lambda rt, b, s: jparts["schur_solve"](
            rt, b, 1e-4, 1e-14, n, state=s)[0])(jrt, jblocks, J.state0)
        got = tparts["schur_solve"](trt, tblocks, 1e-4, 1e-14, n, state=T.state0)[0]
        tit.pcg = nudged
        try:
            moved = tparts["schur_solve"](trt, tblocks, 1e-4, 1e-14, n, state=T.state0)[0]
        finally:
            tit.pcg = pcg
        print(f"  CG cut after {n}: port against JAX "
              f"{(got - torch.from_numpy(np.array(want))).abs().max().item():.2e}, "
              f"against the nudged right-hand side {(got - moved).abs().max().item():.2e} "
              f"(largest entry {got.abs().max().item():.3f})")


def config5():
    import chip_smoke
    from kontiki_tpu_torch.parallel.segments_ba import make_segment_ba_step

    big = synthetic.make_big_ba_problem(n_views=10_000, n_landmarks=100_000,
                                        obs_per_landmark=5, seed=5, device="cpu")
    problem = big["problem"]
    out = make_segment_ba_step(problem, mode="pcg", **chip_smoke.CONFIG5_PCG_CUT)[0](
        problem.state0, 1e-4)
    want = chip_smoke.JAX_CONFIG5_PCG["cut"]
    print("config 5, segment-BA PCG step with CG cut after 5 iterations, against the JAX "
          "package's:")
    for i, name in ((0, "cost"), (2, "new_cost"), (3, "pred"), (4, "gmax")):
        print(f"  {name} {out[i].item()!r} ({want[name]!r}, rel "
              f"{abs(out[i].item() - want[name]) / abs(want[name]):.2e})")


PARTS = dict(band=band, f32band=f32band, cg=cg, config5=config5)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", nargs="+", choices=sorted(PARTS), default=["band", "cg"])
    args = ap.parse_args()
    for name in args.only:
        PARTS[name]()


if __name__ == "__main__":
    main()
