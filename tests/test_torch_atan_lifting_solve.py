"""Port parity, LM solves with the atan camera, static and lifting rows
(config 3-atan's and config 3-atan-lifting's model cut to the JAX tests'
small problem, ``tests/test_torch_atan_lifting_rows.py``'s), against the
JAX package's ``lm.solve(problem, max_iterations=8, function_tolerance=0.0,
strategy="schur")`` in float64:

- the port's phase-split ``lm.solve``: the Summary counts, the steps taken
  and each IterationSummary's cost (1e-9 relative) and flags;
- the port's ``make_fused_solver(problem, n, function_tolerance=0.0,
  strategy="schur")`` for n = 1 and 8: the final cost against the JAX
  iteration-n cost (the fused speculative loop takes the phase-split loop's
  steps: the same linearizations, solves and accept policy), the row times
  in [0, 1] and moved.

The data are pinhole projections fitted with the atan model, so the first
five steps are rejected (the model's predicted decrease is not realised
until the damping has fallen) and the last three accepted, in both
packages.
"""
import numpy as np
import pytest
import torch

from kontiki_tpu.solver import lm as jax_lm
from kontiki_tpu_torch.solver import lm
from test_torch_atan_lifting_rows import atan_lifting_pair

torch.set_num_threads(1)
ITERATIONS = 8
COUNTS = ("num_parameters", "num_parameter_blocks", "num_parameters_reduced",
          "num_parameter_blocks_reduced", "num_residuals", "num_residual_blocks",
          "num_residuals_reduced", "num_residual_blocks_reduced", "num_successful_steps",
          "num_unsuccessful_steps")


@pytest.fixture(scope="module", params=["static", "lifting"])
def solved(request):
    p = atan_lifting_pair("split", rs=request.param)
    _, want = jax_lm.solve(p["jax"], max_iterations=ITERATIONS, function_tolerance=0.0,
                           strategy="schur")
    return request.param, p, want


def test_lm_solve_matches_jax(solved):
    _, p, want = solved
    _, got = lm.solve(p["torch"], max_iterations=ITERATIONS, function_tolerance=0.0,
                      strategy="schur", progress=False)
    for name in COUNTS:
        assert getattr(got, name) == getattr(want, name), name
    assert got.num_successful_steps >= 2
    assert len(got.iterations) == len(want.iterations) == ITERATIONS + 1
    for g, w in zip(got.iterations, want.iterations):
        assert (g.iteration, g.step_is_successful, g.step_is_valid) == (
            w.iteration, w.step_is_successful, w.step_is_valid)
        assert g.cost == pytest.approx(w.cost, rel=1e-9)
    assert got.final_cost == pytest.approx(want.final_cost, rel=1e-9)
    assert got.final_cost < got.initial_cost


@pytest.mark.parametrize("iterations", [1, ITERATIONS])
def test_fused_schur_solver_matches_jax(solved, iterations):
    rs, p, want = solved
    T = p["torch"]
    state, cost, it = lm.make_fused_solver(T, iterations, function_tolerance=0.0,
                                           strategy="schur")(T.state0)
    assert it == iterations
    assert cost.item() == pytest.approx(want.iterations[iterations].cost, rel=1e-9)
    if rs == "lifting":
        vt, vt0 = state["vt"], T.state0["vt"]
        assert 0.0 <= vt.min().item() and vt.max().item() <= 1.0
        assert torch.equal(vt, vt0) == (iterations == 1)  # the first step is rejected
    for k, v in state.items():
        assert v.shape == T.state0[k].shape and bool(torch.isfinite(v).all()), k
    assert np.isfinite(cost.item())
