"""The JAX package's float32 tier through the port, BASELINE configs 4-5
(``tests/f32_check.py``'s problems; ``test_torch_f32_tier.py`` has configs
1-3 and the helpers).

- config 4 (rolling-shutter visual-inertial BA on the split trajectory,
  f32_check's generator default) through ``solver.lm.solve``: the aligned
  ATE drops, below 2e-3 m, and the cost by more than 1e6;
- config 5 (``make_big_ba_problem(n_views=120, n_landmarks=600,
  obs_per_landmark=4, seed=13, imu_rate=50.0, dtype=torch.float32)``)
  through ``make_segment_ba_solver(max_iterations=20,
  function_tolerance=1e-12, cg_tol=1e-6, cg_maxiter=100)`` in banded mode
  on one shard (the JAX tier runs it on 4 devices; the port's 4-rank run is
  ``chip_smoke.py``'s): se3-aligned ATE < 2e-3 m. In float32 an accepted
  step changes the cost by at least one ulp (6e-8 of it), more than
  ``1e-12`` of it, so the loop runs its 20 iterations, as the JAX package's
  float32 loop does on this problem.

Every float tensor stays float32. The initial cost and the first step's
cost at ``lam = 1e-4`` (config 5: ``make_segment_ba_step``) are held to
the JAX package's float64 dense ``make_step`` on the same problem (config
5: the JAX package's ``RawProblem`` over the port's float64 arrays, which
the float32 problem holds rounded once): measured 3.6e-7 (both initial
costs) and 8.3e-5 / 1.8e-4 (the first steps), against 1e-5 and 5e-3."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kontiki_tpu import sensors as jsensors
from kontiki_tpu.solver.problem import RawBucket as JRawBucket
from kontiki_tpu.solver.problem import RawProblem as JRawProblem
from kontiki_tpu_torch import interop
from kontiki_tpu_torch import synthetic as tsyn
from kontiki_tpu_torch.parallel.segments_ba import make_segment_ba_solver, make_segment_ba_step
from kontiki_tpu_torch.trajectories import SplitTrajectory
from test_torch_f32_tier import (
    COST0_RTOL,
    COST1_RTOL,
    F32,
    LAM,
    check_costs,
    check_float32,
    check_gate,
    float_tensors,
    jax_first_step,
    run,
)

torch.set_num_threads(1)
CONFIG5 = dict(n_views=120, n_landmarks=600, obs_per_landmark=4, seed=13, imu_rate=50.0)
CONFIG5_SOLVER = dict(max_iterations=20, function_tolerance=1e-12, cg_tol=1e-6, cg_maxiter=100)


def jax_raw(arrays):
    """The JAX package's ``RawProblem`` over ``interop.raw_problem_arrays``."""
    buckets = {k: JRawBucket(kind=k, M=len(next(iter(b["data"].values()))), rdim=b["rdim"],
                             data={n: jnp.asarray(v) for n, v in b["data"].items()},
                             window=b["window"],
                             camera_cls=b["camera"] and getattr(jsensors, b["camera"]))
               for k, b in arrays["buckets"].items()}
    return JRawProblem(splines=arrays["splines"], buckets=buckets, sensors=arrays["sensors"],
                       rho=arrays["rho"], landmark_mask=arrays["landmark_mask"])


@functools.lru_cache(maxsize=None)
def run5():
    J = jax_raw(interop.raw_problem_arrays(
        tsyn.make_big_ba_problem(**CONFIG5, device="cpu")["problem"]))
    big = tsyn.make_big_ba_problem(**CONFIG5, device="cpu", dtype=F32)
    problem = big["problem"]
    step = make_segment_ba_step(problem)[0](problem.state0, torch.tensor(LAM, dtype=F32))
    state, cost, it = make_segment_ba_solver(problem, **CONFIG5_SOLVER)(problem.state0)
    solved = big["trajectory"].clone()
    solved.R3_spline.set_knots(state["r3"].numpy())
    solved.SO3_spline.set_knots(state["so3"].numpy())
    truth = big["true_trajectory"]
    ate = tsyn.trajectory_ate(SplitTrajectory(truth.R3_spline, truth.SO3_spline, device="cpu"),
                              SplitTrajectory(solved.R3_spline, solved.SO3_spline, device="cpu"),
                              big["t1"], big["t2"], align="se3")
    return dict(J=J, jax=jax_first_step(J), problem=problem, step=step, state=state,
                cost=cost, iterations=it, ate=ate, solved=solved)


def test_config4_f32_check_gate():
    check_gate("config 4", run("config 4"))


def test_config4_state_stays_float32():
    check_float32(run("config 4"))


@pytest.mark.parametrize("which", ("initial", "first step"))
def test_config4_costs_match_jax(which):
    check_costs("config 4", run("config 4"), which)


def test_config5_f32_check_gate():
    o = run5()
    assert o["ate"] < 2e-3, o["ate"]
    assert o["iterations"] == CONFIG5_SOLVER["max_iterations"]
    assert o["cost"].item() < o["step"][0].item()


def test_config5_state_stays_float32():
    o = run5()
    for k, v in float_tensors(o["problem"]):
        assert v.dtype == F32, (k, v.dtype)
    for k, v in list(o["state"].items()) + list(o["step"][1].items()):
        assert v.dtype == F32, (k, v.dtype)
    for x in (o["cost"], *o["step"][:1], *o["step"][2:]):
        assert x.dtype == F32
    assert o["solved"].R3_spline.knots.dtype == np.float64
    for k, v in o["problem"].state0.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(o["J"].state0[k]).astype(np.float32),
                                      err_msg=k)


@pytest.mark.parametrize("which", ("initial", "first step"))
def test_config5_costs_match_jax(which):
    o = run5()
    c0, c1 = o["jax"]
    if which == "initial":
        np.testing.assert_allclose(o["step"][0].item(), c0, rtol=COST0_RTOL)
    else:
        assert o["step"][2] < o["step"][0] and o["step"][3] > 0
        np.testing.assert_allclose(o["step"][2].item(), c1, rtol=COST1_RTOL["config 5"])
