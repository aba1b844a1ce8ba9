"""``solver.iterative`` on lifting rows (here) and Newton rolling-shutter
rows (``tests/test_torch_iterative_newton.py``, one JAX compile a file) against
the JAX package's ``make_iterative_step`` at ``cg_tol=1e-14``, in float64 on
the CPU: ``make_rsvi_problem(..., rs="lifting" | "newton",
trajectory="split")`` cut to 6 views, 12 landmarks and 40 Hz IMU rows, with
a perturbed start and 0.5 px noise (the JAX package's segment-BA tests'
problems, smaller).

A lifting row carries its row time ``vt`` as a column past the sensor
block (clipped to [0, 1] by the retraction, point-Jacobi preconditioned);
a Newton row's ref and obs windows are W knots wide (C = 2 Ct + 13) and
alias like the camera rows'. Cost, new cost, predicted decrease and max
|gradient| to 1e-9 relative, the new state to 1e-8 absolute.
"""
import functools

import numpy as np
import torch

from kontiki_tpu.solver import iterative as jit_
from kontiki_tpu_torch.solver import iterative as tit
from kontiki_tpu_torch.synthetic import make_rsvi_problem
from test_torch_split_camera import twin_pair

torch.set_num_threads(1)
CG = dict(cg_tol=1e-14, cg_maxiter=2000)
ROWS = dict(nviews=6, nlandmarks=12, imu_rate=40.0, perturb_rho=0.03, sigma_p=0.01,
            sigma_q=0.005, noise_px=0.5, trajectory="split")


@functools.lru_cache(maxsize=None)
def pair(rs):
    gen = make_rsvi_problem(rs=rs, seed=29 if rs == "lifting" else 21, **ROWS)
    return twin_pair(gen["trajectory"], gen["measurements"])


def check_step(rs):
    """One iterative step of the port against the JAX package's."""
    p = pair(rs)
    J, T = p["jax"], p["torch"]
    assert any(k.startswith(f"rs_{rs}") for k in T.buckets)
    want = jit_.make_iterative_step(J, **CG)[0](J.state0, 1e-4)
    got = tit.make_iterative_step(T, **CG)[0](T.state0, 1e-4)
    assert all(torch.isfinite(v).all() for v in got[1].values())
    for i, name in ((0, "cost"), (2, "new cost"), (3, "pred"), (5, "grad_max")):
        assert abs(got[i].item() - float(want[i])) <= 1e-9 * abs(float(want[i])), name
    for k, v in got[1].items():
        np.testing.assert_allclose(v.numpy(), np.asarray(want[1][k]), rtol=0, atol=1e-8,
                                   err_msg=k)
    if rs == "lifting":
        vt = got[1]["vt"]
        assert vt.numel() and (vt >= 0).all() and (vt <= 1).all()


def test_iterative_step_matches_jax():
    check_step("lifting")
