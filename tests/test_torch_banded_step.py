"""The banded strategy (``solver.banded.build_banded_parts`` /
``make_banded_step``) against the JAX package's ``make_banded_step``, in
float64 on the CPU:

- on ``make_gyro_problem`` and ``make_imu_problem(duration=2.5,
  rate=60.0, seed=7)`` at lam 1e-4 and 1e-1, with the tolerances of the
  JAX package's own banded-vs-dense test (``tests/test_banded.py``): cost
  1e-12, step 1e-7 relative / 1e-11 absolute, new cost and pred 1e-8,
  max |gradient| 1e-12; the band solve by PCR and, patched in, by the
  scan reference (``_scan_solve``);
- on a 2,000-knot gyro band (``synthetic.make_gyro_band_problem``; the
  JAX side built from the same arrays): cost, new cost and pred to 1e-8
  relative, the cost lowered;
- ``make_fused_solver(problem, 4, function_tolerance=0.0,
  strategy="banded")`` on the IMU problem, the band solve by PCR and by
  the scan: the same iterations, the final cost to 1e-9 relative or 1e-15
  of the initial cost (it falls to 4e-10 of it, where the two methods'
  roundoff shows);
- the ``ValueError``s: landmarks, lifted row times and splines on two knot
  grids;
- on BASELINE config 2 (``make_imu_problem(duration=5.0, rate=200.0,
  seed=2)``, whose damped band has condition 1.7e6): the band solve's
  residual within 1e-14 of the right-hand side's norm (PCR alone leaves
  8.9e-13) and the banded strategy's 1-iteration cost within 1e-9 of the
  dense strategy's (PCR alone 2.6e-9; ``tools/solver_accuracy.py``), as
  ``chip_smoke.py`` holds it.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kontiki_tpu.solver import banded as jb
from kontiki_tpu.solver import lm as jlm
from kontiki_tpu.solver.problem import RawBucket as JRawBucket
from kontiki_tpu.solver.problem import RawProblem as JRawProblem
from kontiki_tpu_torch import interop
from kontiki_tpu_torch.solver import banded as tb
from kontiki_tpu_torch.solver import kernels as tk
from kontiki_tpu_torch.solver import lm as tlm
from kontiki_tpu_torch.solver.problem import Problem
from kontiki_tpu_torch.synthetic import (
    make_gyro_band_problem,
    make_gyro_problem,
    make_imu_problem,
    make_pose_measurements,
    make_rsvi_problem,
    make_split_trajectory,
)
from test_torch_camera_host import regrid
from test_torch_dense_solve import jax_problem_from

torch.set_num_threads(1)
MAKERS = {"gyro": make_gyro_problem, "imu": make_imu_problem}


@functools.lru_cache(maxsize=None)
def pair(kind):
    gen = MAKERS[kind](duration=2.5, rate=60.0, seed=7)
    T = Problem(gen["trajectory"], gen["measurements"], device="cpu")
    return jax_problem_from(gen), T, jb.make_banded_step(jax_problem_from(gen))[0]


def band_solve(monkeypatch, method):
    """The banded step's band solve: PCR, or the scan reference patched in."""
    if method == "scan":
        monkeypatch.setattr(tb, "block_tridiag_solve", tb._scan_solve)


@pytest.mark.parametrize("method", ["scan", "pcr"])
@pytest.mark.parametrize("lam", [1e-4, 1e-1])
@pytest.mark.parametrize("kind", ["gyro", "imu"])
def test_banded_step_matches_jax(kind, lam, method, monkeypatch):
    band_solve(monkeypatch, method)
    J, T, jstep = pair(kind)
    want = jstep(J.state0, lam)
    got = tb.make_banded_step(T)[0](T.state0, lam)
    np.testing.assert_allclose(got[0].item(), float(want[0]), rtol=1e-12)
    np.testing.assert_allclose(got[4].numpy(), np.asarray(want[4]), rtol=1e-7, atol=1e-11)
    np.testing.assert_allclose(got[2].item(), float(want[2]), rtol=1e-8)
    np.testing.assert_allclose(got[3].item(), float(want[3]), rtol=1e-8)
    np.testing.assert_allclose(got[5].item(), float(want[5]), rtol=1e-12)
    for k, v in got[1].items():
        np.testing.assert_allclose(v.numpy(), np.asarray(want[1][k]), rtol=0, atol=1e-9,
                                   err_msg=k)


def _jax_raw(arrays):
    """The JAX package's RawProblem over ``interop.raw_problem_arrays``."""
    buckets = {k: JRawBucket(kind=k, M=len(b["data"]["t"]), rdim=b["rdim"],
                             data={n: jnp.asarray(v) for n, v in b["data"].items()},
                             window=b["window"])
               for k, b in arrays["buckets"].items()}
    return JRawProblem(splines=arrays["splines"], buckets=buckets, sensors=arrays["sensors"],
                       rho=arrays["rho"])


def test_long_band_matches_jax():
    T = make_gyro_band_problem(n_knots=2_000, device="cpu")
    J = _jax_raw(interop.raw_problem_arrays(T))
    assert T.num_tangent == J.num_tangent > 6_000
    want = jb.make_banded_step(J)[0](J.state0, 1e-2)
    got = tb.make_banded_step(T)[0](T.state0, 1e-2)
    assert got[2].item() < got[0].item()
    for i, name in ((0, "cost"), (2, "new cost"), (3, "pred")):
        np.testing.assert_allclose(got[i].item(), float(want[i]), rtol=1e-8, err_msg=name)


def test_banded_strategy_refuses_other_problems():
    gen = make_rsvi_problem(nviews=4, nlandmarks=8, imu_rate=0.0, seed=3)
    with pytest.raises(ValueError, match="knot\\+sensor problems only"):
        tb.make_banded_step(Problem(gen["trajectory"], gen["measurements"], device="cpu"))
    gen = make_rsvi_problem(nviews=4, nlandmarks=8, imu_rate=0.0, seed=3, rs="lifting")
    P = Problem(gen["trajectory"], gen["measurements"], device="cpu")
    assert P.state0["vt"].numel() and len(P.landmarks)
    with pytest.raises(ValueError, match="knot\\+sensor problems only"):
        tb.make_banded_step(P)
    truth = regrid(make_split_trajectory(2.0, seed=3))
    ms = make_pose_measurements(truth, 0.5, 1.5, 20.0, seed=3)
    with pytest.raises(ValueError, match="one knot grid"):
        tb.make_banded_step(Problem(truth, ms, device="cpu"))


@functools.lru_cache(maxsize=None)
def _jax_fused(kind):
    J, _, _ = pair(kind)
    out = jlm.make_fused_solver(J, 4, function_tolerance=0.0, strategy="banded")(J.state0)
    return float(out[1]), int(out[2])


@pytest.mark.parametrize("method", ["scan", "pcr"])
def test_fused_banded_solver_matches_jax(method, monkeypatch):
    band_solve(monkeypatch, method)
    J, T, _ = pair("imu")
    want, iters = _jax_fused("imu")
    got = tlm.make_fused_solver(T, 4, function_tolerance=0.0, strategy="banded")(T.state0)
    cost0 = tb.make_banded_step(T)[1](T.state0).item()
    assert got[2] == iters == 4
    np.testing.assert_allclose(got[1].item(), want, rtol=1e-9, atol=1e-15 * cost0)


def test_config2_band_solve_is_backward_stable():
    gen = make_imu_problem(duration=5.0, rate=200.0, seed=2)
    T = Problem(gen["trajectory"], gen["measurements"], device="cpu")
    parts = tb.build_banded_parts(tk.problem_spec(T))
    rt = tk.problem_runtime(T)
    _, blocks = parts["linearize"](rt, T.state0)
    D, U, rhs, _ = parts["damped_system"](rt, blocks, parts["grad_and_diag"](blocks)[0], 1e-4)
    x = tb.block_tridiag_solve(D, U, rhs)
    res = torch.linalg.vector_norm(tb._band_matvec(D, U, x) - rhs) / torch.linalg.vector_norm(rhs)
    assert res.item() <= 1e-14
    dense = tlm.make_fused_solver(T, 1, function_tolerance=0.0, strategy="dense")(T.state0)[1]
    band = tlm.make_fused_solver(T, 1, function_tolerance=0.0, strategy="banded")(T.state0)[1]
    np.testing.assert_allclose(band.item(), dense.item(), rtol=1e-9)
