"""Port parity, kernel B8's linearize form on the split branches (config
4-Newton's): the plain version (``newton_rows_plain``) and the CUDA row code
built for the host (``newton_rows_host``, the kernel's lane schedule)
against the JAX package's fused Newton tile (``lk.newton_rows(cfg, ins,
backend="xla")``, jitted), pinhole and atan, on the small Newton problem of
``tests/test_torch_newton_rows.py`` (whose helpers build it), in float64:
its gathered rows, and the same rows with some moved to the edges of the
Newton path (clamps at 0 and at the readout, five steps).

Tolerances: the JAX package's own (``tests/test_linearize_kernel.py``): r
rtol 1e-10 / atol 1e-12, J and J_rho rtol 1e-8 / atol 1e-11, on every row
whose Newton convergence tests are clear of their bounds (all of them at
these inputs, as ``test_newton_steps_and_margins`` pins)."""
import pytest
import torch

from kontiki_tpu_torch.ops import linearize_kernels as tlk
from test_torch_camera_host import host_library  # noqa: F401
from test_torch_newton_rows import (CAMERAS, TILE_ROWS, _jax_close, edge_rows_kept, jax_tile,
                                    tile_cases, tile_rows)

torch.set_num_threads(1)


@pytest.mark.parametrize("camera, which", tile_cases(CAMERAS, TILE_ROWS[:2]))
def test_split_rows_match_jax_tile(host_library, camera, which):
    """B8's plain version and host row code (the kernel's lane schedule) on
    the split branches against the JAX tile: r, J [M, 2, 85], J_rho, on the
    gather's rows and on its edge rows (one compile a branch); the 10-knot
    windows' rows are in ``tests/test_torch_newton_tile_w10.py``."""
    check_split_tile(camera, which)


def check_split_tile(camera, which):
    """The plain version and the host row code of one split branch's rows
    ``which`` against the JAX tile, at the JAX package's tolerances."""
    tcfg, tins = tile_rows("split", camera, which)
    kept, near, steps = edge_rows_kept("split", camera, which)
    want = jax_tile("split", camera, False, which)
    assert int(steps.max()) > 1  # the Jacobians chain through earlier steps
    for who, got in (("plain", tlk.newton_rows_plain(tcfg, tins)),
                     ("host", tlk.newton_rows_host(tcfg, tins))):
        for name, g, w, (rtol, atol) in zip(("r", "J", "J_rho"), got, want,
                                            ((1e-10, 1e-12), (1e-8, 1e-11), (1e-8, 1e-11))):
            _jax_close(g, w, kept, f"{camera} {who} {name} (rows near the test: {near})",
                       rtol, atol)
