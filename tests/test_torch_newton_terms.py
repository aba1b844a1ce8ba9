"""Port parity, ``solver.kernels.bucket_terms`` on config 4-Newton's rows
(kernel B8's plain version) on SE3 rows of the small Newton problem of
``tests/test_torch_newton_problem.py`` (pinhole camera, camera offset p_ct
!= 0, whose helpers build it), against the JAX package's
``K._bucket_terms`` on its vmapped ``jacfwd`` path (``LINEARIZE`` set to
``"off"`` on the JAX module through ``monkeypatch``, as its own tests do),
in float64: r and J at the JAX package's tile-against-``jacfwd``
tolerances (r rtol 1e-10 / atol 1e-12, J rtol 1e-8 / atol 1e-11), column ids
exact. The JAX side's compile takes most of this module's time."""
import numpy as np
import torch

from kontiki_tpu.ops import linearize_kernels as jlk
from kontiki_tpu.solver import kernels as jk
from kontiki_tpu_torch.solver import kernels as tk
from test_torch_newton_problem import pair

torch.set_num_threads(1)


def test_bucket_terms_match_jax_jacfwd(monkeypatch):
    """The port's ``bucket_terms`` (kernel B8's plain version) on SE3 Newton
    rows against the JAX package's vmapped ``jacfwd`` path: r, J [M, 2,
    85], the column ids, the split landmark column, and the cost-only form."""
    p = pair("se3")
    spec, jrt, J = p["jspec"], p["jrt"], p["jax"]
    bspec = spec.buckets[0]
    assert bspec.kind == "rs_newton" and max(bspec.windows) > 4
    res, flags = jk._make_residual(spec, bspec)
    monkeypatch.setattr(jlk, "LINEARIZE", "off")
    want = jk._bucket_terms(spec, bspec, res, flags, jrt, J.state0, jrt["data"][0], True,
                            split_rho=True)
    want_cost = jk._bucket_terms(spec, bspec, res, flags, jrt, J.state0, jrt["data"][0], False)
    tspec, rt = p["tspec"], p["rt"]
    r, Jt, cols, J_rho = tk.bucket_terms(tspec, tspec.buckets[0], rt, p["state"], rt["data"][0])
    np.testing.assert_array_equal(cols.numpy(), np.asarray(want[2]))
    for name, g, w, (rtol, atol) in (("r", r, want[0], (1e-10, 1e-12)),
                                     ("J", Jt, want[1], (1e-8, 1e-11)),
                                     ("J_rho", J_rho, want[3], (1e-8, 1e-11))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=rtol, atol=atol, err_msg=name)
    cost = tk.bucket_terms(tspec, tspec.buckets[0], rt, p["state"], rt["data"][0],
                           cost_only=True)
    np.testing.assert_allclose(cost.numpy(), np.asarray(want_cost), rtol=1e-10, atol=1e-12)
