"""``solver.kkt.kkt_residual`` against the JAX package's, in float64 on the
CPU, on a lifting problem (``make_rsvi_problem(nviews=4, nlandmarks=8,
imu_rate=0.0, seed=29, rs="lifting")`` with the camera's time offset free
within 0.01 s): at ``state0``, at a state with the time offset at its upper
and lower bound, three inverse depths at 0 and two row times at 0 and 1,
and after a 3-iteration ``lm.solve``. Tolerance 1e-10 relative (the dense
gradients of the two packages agree to roundoff)."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kontiki_tpu.solver.kkt import kkt_residual as jax_kkt
from kontiki_tpu_torch.solver import lm
from kontiki_tpu_torch.solver.kkt import kkt_residual
from kontiki_tpu_torch.synthetic import make_rsvi_problem
from test_torch_split_camera import twin_pair

torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def pair():
    gen = make_rsvi_problem(nviews=4, nlandmarks=8, imu_rate=0.0, seed=29, rs="lifting",
                            noise_px=0.5)
    cam = gen["camera"]
    cam.max_time_offset = 0.01
    cam.time_offset_locked = False
    return twin_pair(gen["trajectory"], gen["measurements"])


def _at_bounds(state, d_sign):
    st = {k: v.clone() for k, v in state.items()}
    st["d"][:] = d_sign * 0.01
    st["rho"][:3] = 0.0
    st["vt"][0], st["vt"][1] = 0.0, 1.0
    return st


def _solved():
    return lm.solve(pair()["torch"], max_iterations=3, function_tolerance=0.0)[0]


@pytest.mark.parametrize("which", ["state0", "upper bounds", "lower bounds", "solved"])
def test_kkt_residual_matches_jax(which):
    p = pair()
    T, J = p["torch"], p["jax"]
    assert T.state0["vt"].numel() > 2 and len(T.landmarks) > 3
    state = {"state0": lambda: T.state0, "upper bounds": lambda: _at_bounds(T.state0, 1.0),
             "lower bounds": lambda: _at_bounds(T.state0, -1.0), "solved": _solved}[which]()
    got = kkt_residual(T, state)
    want = jax_kkt(J, {k: jnp.asarray(v.numpy()) for k, v in state.items()})
    assert got > 0.0
    assert abs(got - want) <= 1e-10 * want
