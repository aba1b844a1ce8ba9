"""Port parity, end to end: ``make_rsvi_problem`` -> ``Problem`` ->
``make_fused_solver(strategy="schur")`` in ``kontiki_tpu_torch`` against the
JAX package's fused LM loop on the same seed, with 1 px observation noise
and 5 iterations: the same iteration count, the final cost to rtol 1e-8
and the final state to 1e-7."""
import numpy as np
import torch

from kontiki_tpu.solver.lm import make_fused_solver as jax_fused
from kontiki_tpu_torch.solver.lm import make_fused_solver as torch_fused
from test_torch_problem import problem_pair

torch.set_num_threads(1)


def test_fused_solve_matches_jax():
    pair = problem_pair(noise_px=1.0)
    J, T = pair["jax"], pair["torch"]
    jstate, jcost, jit = jax_fused(J, 5, function_tolerance=0.0, strategy="schur")(J.state0)
    state, cost, it = torch_fused(T, 5, function_tolerance=0.0, strategy="schur")(T.state0)
    assert it == int(jit) == 5
    np.testing.assert_allclose(cost.item(), float(jcost), rtol=1e-8)
    for k, v in state.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(jstate[k]), rtol=0, atol=1e-7,
                                   err_msg=k)

