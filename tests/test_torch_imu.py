"""Port parity: gyro and accel rows on the SE3 spline (the generic
forward-mode path, ``torch.func.vmap(torch.func.jacfwd)``) against the JAX
package's vmapped ``jacfwd`` path, ``solver.kernels._bucket_terms``, on the
same state in float64: residuals and Jacobians to 1e-10 * max|jax|,
column ids exactly."""
import jax
import numpy as np
import pytest
import torch

from kontiki_tpu.solver import kernels as jk
from kontiki_tpu_torch.solver import kernels as tk
from test_torch_problem import problem_pair

torch.set_num_threads(1)


@pytest.mark.parametrize("kind", ["gyro", "accel"])
def test_imu_rows_match_jax(kind):
    pair = problem_pair()
    spec, jrt = pair["jspec"], pair["jrt"]
    (i,) = [i for i, b in enumerate(spec.buckets) if b.kind == kind]
    bspec = spec.buckets[i]
    res, flags = jk._make_residual(spec, bspec)
    want = jax.jit(
        lambda rt, st: jk._bucket_terms(spec, bspec, res, flags, rt, st,
                                        rt["data"][i], True)
    )(jrt, pair["jax"].state0)
    tspec = tk.problem_spec(pair["torch"])
    got = tk.bucket_terms(tspec, tspec.buckets[i], pair["rt"], pair["state"],
                          pair["rt"]["data"][i])
    assert got[3] is None
    for name, g, w in zip(("r", "J", "cols"), got[:3], want):
        w = np.asarray(w)
        assert g.shape == w.shape, name
        if name == "cols":
            np.testing.assert_array_equal(g.numpy(), w)
        else:
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-10,
                                       atol=1e-10 * np.abs(w).max(), err_msg=name)
