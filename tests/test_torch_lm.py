"""The port's trust-region policy (``solver.lm.trust_region_update``, the
Ceres LevenbergMarquardtStrategy rules of ``kontiki_tpu.solver.lm``) and
the loop's function-tolerance exit."""
import pytest
import torch

from kontiki_tpu_torch.solver.lm import make_fused_solver, trust_region_update
from test_torch_problem import problem_pair

torch.set_num_threads(1)


def _t(x):
    return torch.tensor(x, dtype=torch.float64)


@pytest.mark.parametrize(
    "cost,new_cost,pred,ok,mu,dec",
    [
        # rho = 1: accept, radius x3, decrease factor reset
        (10.0, 9.0, 1.0, True, 3e4, 2.0),
        # rho = 0.5: accept, radius / max(1/3, 1) = unchanged
        (10.0, 9.5, 1.0, True, 1e4, 2.0),
        # rho below 1e-3: reject, radius / dec, dec doubles
        (10.0, 9.9999, 1.0, False, 5e3, 4.0),
        # non-positive prediction: reject
        (10.0, 9.0, -1.0, False, 5e3, 4.0),
        # non-finite candidate cost: reject
        (10.0, float("nan"), 1.0, False, 5e3, 4.0),
    ],
)
def test_trust_region_update(cost, new_cost, pred, ok, mu, dec):
    got = trust_region_update(_t(cost), _t(new_cost), _t(pred), _t(1e4), _t(2.0),
                              function_tolerance=0.0)
    assert bool(got[0]) == ok
    assert got[1].item() == pytest.approx(mu, rel=1e-12)
    assert got[2].item() == dec
    assert not bool(got[3])


def test_radius_is_capped():
    _, mu, _, _ = trust_region_update(_t(10.0), _t(9.0), _t(1.0), _t(1e16), _t(2.0),
                                      function_tolerance=0.0)
    assert mu.item() == 1e16


def test_function_tolerance_ends_the_solve():
    """An accepted step whose cost change is within the tolerance ends the
    solve early, like the JAX loop's ``done`` flag."""
    T = problem_pair(noise_px=1.0)["torch"]
    _, _, it = make_fused_solver(T, 30, function_tolerance=1e-2, strategy="schur")(T.state0)
    assert 1 <= it < 30


def test_unported_strategies_raise():
    T = problem_pair()["torch"]
    with pytest.raises(NotImplementedError):
        make_fused_solver(T, 1, strategy="dense")
