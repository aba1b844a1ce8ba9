"""Port parity: the Schur linearization blocks ``(cost, H_cc, g_c, E, D,
g_l)`` and one speculative LM step (``step_spec``: damped Schur solve,
bound projection, retraction, re-linearization) of ``kontiki_tpu_torch``
against ``kontiki_tpu.solver.schur.build_schur_parts`` on the same state
and the same carried linearization, in float64.

Blocks at one state agree to rtol 1e-9 (atol 1e-9 * max|jax| per block).
The step solves a reduced system whose condition number is ~7e11 on this
problem (gauge directions held only by damping), so two LU solves of the
same system agree to ~cond * eps: the step is pinned to 1e-6."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kontiki_tpu.solver.schur import build_schur_parts as jax_parts
from kontiki_tpu_torch import interop
from kontiki_tpu_torch.solver import kernels as tk
from kontiki_tpu_torch.solver.schur import build_schur_parts as torch_parts
from test_torch_problem import problem_pair

torch.set_num_threads(1)
NAMES = ("cost", "H_cc", "g_c", "E", "D", "g_l")


def _close(got, want, name, tol=1e-9):
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape, name
    if want.size:
        np.testing.assert_allclose(got, want, rtol=tol,
                                   atol=tol * np.abs(want).max(), err_msg=name)


@pytest.fixture(scope="module")
def step():
    """One step from the port's linearization at state0, on both sides, and
    the port's linearization at the JAX step's new state."""
    pair = problem_pair(noise_px=1.0)
    tparts = torch_parts(tk.problem_spec(pair["torch"]))
    lin0 = tparts["linearize"](pair["rt"], pair["state"])
    lam = 1e-4  # 1 / the initial trust-region radius
    got = tparts["step_spec"](pair["rt"], pair["state"], lin0, torch.tensor(lam))
    jstep = jax.jit(jax_parts(pair["jspec"], True)["step_spec"])
    want = jstep(pair["jrt"], pair["jax"].state0,
                 tuple(jnp.asarray(x.numpy()) for x in lin0), jnp.asarray(lam))
    jstate = interop.state_from_numpy({k: np.asarray(v) for k, v in want[0].items()})
    lin_at_jstate = tparts["linearize"](pair["rt"], jstate)
    return got, want, lin_at_jstate


def test_step_state_and_prediction_match(step):
    (state, lin, pred), (jstate, jlin, jpred), _ = step
    _close(pred, jpred, "pred", tol=1e-6)
    for k, v in state.items():
        _close(v, jstate[k], k, tol=1e-6)
    _close(lin[0], jlin[0], "candidate cost", tol=1e-6)


def test_linearization_blocks_match(step):
    """The port's linearize against the JAX one at the same state (the
    JAX step's candidate)."""
    _, (_, jlin, _), lin = step
    for name, g, w in zip(NAMES, lin, jlin):
        _close(g, w, name)
