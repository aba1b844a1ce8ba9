"""The solver's step-level public names in the port against the JAX
package's, in float64 on the CPU: ``solver.kernels.make_step``,
``make_functions``, ``retract_state`` and ``bucket_residuals``,
``solver.schur.make_schur_step`` and ``math.se3.se3_normalize``, and the
``solver`` package's exports.

The problems are small cuts of BASELINE config 1 (``make_gyro_problem``,
1 s of gyro rows at 40 Hz with noise on an SO3 spline; the JAX package's
generator makes the same problem from the same seed) and config 3
(``make_rsvi_problem``, 6 views and 10 landmarks on the split trajectory,
inverse depths perturbed; the JAX package's problem over the same objects,
``jax_twin``). Every value is held to the JAX package's at 1e-10 relative
(arrays: |port - jax| <= 1e-10 max|jax|), the residuals per bucket also to
the objects' ``error`` rows, as ``tests/test_residual_parity.py`` does,
and at the step's candidate to the cost they make.
Each JAX function compiles once per problem (``functools.lru_cache``)."""
import functools

import numpy as np
import pytest
import torch

from kontiki_tpu.math import se3 as jse3
from kontiki_tpu.solver import kernels as jk
from kontiki_tpu.solver import schur as jschur
from kontiki_tpu.solver.problem import Problem as JProblem
from kontiki_tpu.synthetic import make_gyro_problem as jax_gyro_problem
from kontiki_tpu_torch import solver as tsolver
from kontiki_tpu_torch.math import se3 as tse3
from kontiki_tpu_torch.solver import kernels as tk
from kontiki_tpu_torch.solver import schur as tschur
from kontiki_tpu_torch.solver.problem import Problem as TProblem
from kontiki_tpu_torch.synthetic import make_gyro_problem, make_rsvi_problem
from test_torch_oracles import on_cpu
from test_torch_split_camera import jax_twin

torch.set_num_threads(1)
RTOL = 1e-10
LAM = 1e-4
#: the damping values of the steps (1e-4 the first LM iteration's, 1e-1 a
#: rejected step's several halvings later); the JAX steps compile once
LAMS = (1e-4, 1e-1)
CONFIGS = {
    "config 1": dict(duration=1.0, rate=40.0, seed=1, noise=0.05),
    "config 3": dict(nviews=6, nlandmarks=10, imu_rate=0.0, seed=3, perturb_rho=0.1),
}


def _close(got, want, name):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * np.abs(want).max(initial=0.0),
                               err_msg=name)


@functools.lru_cache(maxsize=None)
def pair(name):
    """(generator output, the port's Problem, the JAX package's Problem)."""
    if name == "config 1":
        gen = make_gyro_problem(**CONFIGS[name])
        jgen = jax_gyro_problem(**CONFIGS[name])
        J = JProblem(jgen["trajectory"], jgen["measurements"])
    else:
        gen = make_rsvi_problem(**CONFIGS[name])
        J = jax_twin(gen["trajectory"], gen["measurements"])
    T = TProblem(gen["trajectory"], gen["measurements"], device="cpu")
    for k, v in T.state0.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(J.state0[k]), err_msg=k)
    return gen, T, J


@functools.lru_cache(maxsize=None)
def jax_steps(name, schur):
    """The JAX package's ``(step, cost_fn)`` of ``name``, compiled once."""
    return (jschur.make_schur_step if schur else jk.make_step)(pair(name)[2])


def jax_step(name, schur, lam=LAM, state=None):
    J = pair(name)[2]
    step, cost = jax_steps(name, schur)
    return step(J.state0 if state is None else state, lam), cost


def _check_step(got, want):
    for i, what in enumerate(("cost", "new_state", "new_cost", "pred", "delta", "grad_max")):
        if what == "new_state":
            assert set(got[i]) == set(want[i])
            for k, v in got[i].items():
                _close(v, want[i][k], k)
        else:
            _close(got[i], want[i], what)


@pytest.mark.parametrize("lam", LAMS)
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_make_step_matches_jax(name, lam):
    _, T, _ = pair(name)
    step, cost_fn = tk.make_step(T)
    got = step(T.state0, lam)
    want, jcost = jax_step(name, False, lam)
    assert len(got) == 6
    _check_step(got, want)
    _close(cost_fn(got[1]), jcost(want[1]), "cost_fn at the candidate")
    assert got[2] < got[0]


@pytest.mark.parametrize("lam", LAMS)
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_make_schur_step_matches_jax(name, lam):
    """Config 3 against the JAX package's Schur step; config 1, which has no
    landmark to eliminate, against the dense step (held to the JAX
    package's in ``test_make_step_matches_jax``), sparing a JAX compile."""
    _, T, _ = pair(name)
    step, cost_fn = tschur.make_schur_step(T)
    got = step(T.state0, lam)
    dense = tk.make_step(T)[0](T.state0, lam)
    if len(T.landmarks):
        want = jax_step(name, True, lam)[0]
        # the same damped step as the dense one, the landmarks eliminated
        np.testing.assert_allclose(got[4].numpy(), dense[4].numpy(), rtol=0,
                                   atol=1e-8 * dense[4].abs().max().item())
    else:
        want = dense
    _check_step(got, want)
    _close(cost_fn(T.state0), want[0], "cost_fn at state0")


@pytest.mark.parametrize("schur", [False, True])
def test_steps_freeze_landmarks_at_the_bound_like_jax(schur):
    """Config 3 with every inverse depth at the rho = 0 bound: the landmarks
    whose gradient points outward are frozen for the step, in both
    packages' dense and Schur steps alike (``grad_max`` as each package
    takes it: the dense step's over the free columns, the Schur step's over
    the whole gradient)."""
    _, T, J = pair("config 3")
    state = dict(T.state0, rho=torch.zeros_like(T.state0["rho"]))
    jstate = dict(J.state0, rho=np.zeros_like(np.asarray(J.state0["rho"])))
    got = (tschur.make_schur_step if schur else tk.make_step)(T)[0](state, LAM)
    want = jax_step("config 3", schur, LAM, jstate)[0]
    _check_step(got, want)
    assert got[1]["rho"].min() >= 0 and got[2] < got[0]


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_make_functions_matches_jax(name):
    _, T, J = pair(name)
    cost_fn, lin_fn = tk.make_functions(T)
    jcost_fn, jlin_fn = jk.make_functions(J)
    _close(cost_fn(T.state0), jcost_fn(J.state0), "cost")
    got, want = lin_fn(T.state0), jlin_fn(J.state0)
    for what, a, b in zip(("cost", "H", "g"), got, want):
        _close(a, b, what)
    # the step's grad_max is max |g| of this linearization (no landmark at its bound)
    _close(tk.make_step(T)[0](T.state0, LAM)[5], np.abs(np.asarray(want[2])).max(), "grad_max")


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_retract_state_matches_jax(name):
    _, T, J = pair(name)
    delta = np.random.default_rng(5).normal(scale=1e-2, size=T.num_tangent)
    if len(T.landmarks):  # some landmarks pushed past the rho = 0 bound
        lo = T.landmark_offset
        delta[lo:lo + 3] = -1.0
    got = tk.retract_state(T, T.state0, torch.from_numpy(delta))
    want = jk.retract_state(J, J.state0, delta)
    for k, v in got.items():
        _close(v, want[k], k)
    if len(T.landmarks):
        assert got["rho"][:3].eq(0).all()
    assert tsolver.retract_state is tk.retract_state


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_bucket_residuals_matches_jax(name):
    gen, T, J = pair(name)
    got, want = tk.bucket_residuals(T), jk.bucket_residuals(J)
    assert list(got) == list(want)
    assert len(got) == 1  # one bucket: the rows in the measurements' order
    (key, r), = got.items()
    assert isinstance(r, np.ndarray)
    _close(r, want[key], key)
    traj = on_cpu(gen["trajectory"])
    r_obj = np.stack([np.atleast_1d(m.error(traj)) for m in gen["measurements"]])
    np.testing.assert_allclose(r, r_obj, rtol=1e-9, atol=1e-12, err_msg=key)
    # at another state: the cost is 0.5 sum rho(|r|^2) of these rows
    step, cost_fn = tk.make_step(T)
    state = step(T.state0, LAM)[1]
    (key, r), = tk.bucket_residuals(T, state).items()
    s2 = np.sum(r * r, axis=1)
    if key.startswith("rs_static"):
        c = T.buckets[key].data["huber_c"].numpy()
        s2 = np.where(s2 <= c * c, s2, 2.0 * c * np.sqrt(s2) - c * c)
    np.testing.assert_allclose(0.5 * s2.sum(), cost_fn(state).item(), rtol=RTOL)


@pytest.mark.parametrize("shape", [(7,), (5, 7), (2, 3, 7)])
def test_se3_normalize_matches_jax(shape):
    p = np.random.default_rng(3).normal(size=shape)
    got = tse3.se3_normalize(torch.from_numpy(p))
    _close(got, jse3.se3_normalize(p), "se3_normalize")
    np.testing.assert_allclose(torch.linalg.vector_norm(got[..., :4], dim=-1).numpy(), 1.0,
                               rtol=1e-15)
    np.testing.assert_array_equal(got[..., 4:].numpy(), p[..., 4:])


def test_solver_exports_match_jax():
    from kontiki_tpu import solver as jsolver

    names = {"Problem", "make_functions", "retract_state", "make_fused_solver", "solve"}
    assert names <= set(dir(jsolver)) and names <= set(dir(tsolver))
    assert tsolver.make_functions is tk.make_functions
