"""Port parity, kernel B8's linearize form on the split branches (config
4-Newton's): the plain version (``newton_rows_plain``) and the CUDA row code
built for the host (``newton_rows_host``, the kernel's lane schedule)
against the JAX package's fused Newton tile (``lk.newton_rows(cfg, ins,
backend="xla")``, jitted), pinhole and atan, on the small Newton problem of
``tests/test_torch_newton_rows.py`` (whose helpers build it), in float64.

Tolerances: the JAX package's own (``tests/test_linearize_kernel.py``): r
rtol 1e-10 / atol 1e-12, J and J_rho rtol 1e-8 / atol 1e-11, on every row
whose Newton convergence tests are clear of their bounds (all of them at
these inputs, as ``test_newton_steps_and_margins`` pins)."""
import pytest
import torch

from kontiki_tpu_torch.ops import linearize_kernels as tlk
from test_torch_camera_host import host_library  # noqa: F401
from test_torch_newton_rows import CAMERAS, _jax_close, jax_tile, kept_rows, rows

torch.set_num_threads(1)


@pytest.mark.parametrize("camera", CAMERAS)
def test_split_rows_match_jax_tile(host_library, camera):
    """B8's plain version and host row code (the kernel's lane schedule) on
    the split branches against the JAX tile: r, J [M, 2, 85], J_rho."""
    _, _, tcfg, tins = rows("split")[2][camera]
    kept, near, steps = kept_rows("split", camera)
    want = jax_tile("split", camera, False)
    assert int(steps.max()) > 1  # the Jacobians chain through earlier steps
    for who, got in (("plain", tlk.newton_rows_plain(tcfg, tins)),
                     ("host", tlk.newton_rows_host(tcfg, tins))):
        for name, g, w, (rtol, atol) in zip(("r", "J", "J_rho"), got, want,
                                            ((1e-10, 1e-12), (1e-8, 1e-11), (1e-8, 1e-11))):
            _jax_close(g, w, kept, f"{camera} {who} {name} (rows near the test: {near})",
                       rtol, atol)
