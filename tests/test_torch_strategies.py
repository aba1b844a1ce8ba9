"""The iterative-Schur and banded strategies through the solver entry
points against the JAX package's, in float64 on the CPU:

- ``lm.solve(problem, 3, function_tolerance=0.0, strategy=...)``: every
  IterationSummary's cost and max |gradient| to 1e-9 relative or 1e-10 of
  the initial value (iterative Schur's CG stops at a residual of 1e-10
  relative, so the two packages' steps differ by ~1e-10 relative, and a
  cost that has fallen by 1e5 shows it at ~1e-8 of itself), the same
  accepted and rejected steps; iterative Schur on the
  split camera problem of ``tests/test_torch_iterative.py``, banded on
  ``make_imu_problem(duration=2.5, rate=60.0, seed=7)``;
- (``make_fused_solver`` with each strategy: ``tests/test_torch_iterative.py``
  and ``tests/test_torch_banded_step.py``);
- an unknown strategy raises ``ValueError``.
"""
import pytest
import torch

from kontiki_tpu.solver import lm as jlm
from kontiki_tpu_torch.solver import lm
from test_torch_banded_step import pair as band_pair
from test_torch_iterative import camera

torch.set_num_threads(1)


def _problems(strategy):
    if strategy == "iterative_schur":
        return camera()["jax"], camera()["torch"]
    J, T, _ = band_pair("imu")
    return J, T


@pytest.mark.parametrize("strategy", ["iterative_schur", "banded"])
def test_lm_solve_matches_jax(strategy):
    J, T = _problems(strategy)
    _, want = jlm.solve(J, max_iterations=3, progress=False, function_tolerance=0.0,
                        strategy=strategy)
    state, got = lm.solve(T, max_iterations=3, function_tolerance=0.0, strategy=strategy)
    assert len(got.iterations) == len(want.iterations) == 4
    c0, g0 = want.iterations[0].cost, want.iterations[0].gradient_max_norm
    for a, b in zip(got.iterations, want.iterations):
        assert a.cost == pytest.approx(b.cost, rel=1e-9, abs=1e-10 * c0)
        assert a.step_is_successful == b.step_is_successful
        assert a.gradient_max_norm == pytest.approx(b.gradient_max_norm, rel=1e-9,
                                                    abs=1e-10 * g0)
    assert got.final_cost < got.initial_cost
    assert all(torch.isfinite(v).all() for v in state.values())


def test_unknown_strategy_raises():
    _, T = _problems("banded")
    for make in (lambda: lm.make_fused_solver(T, 1, strategy="sparse"),
                 lambda: lm.solve(T, max_iterations=1, strategy="sparse")):
        with pytest.raises(ValueError, match="strategy"):
            make()
