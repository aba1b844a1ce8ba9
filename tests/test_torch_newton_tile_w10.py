"""Port parity, kernel B8's linearize form on 10-knot windows: the plain
version and the CUDA row code built for the host (the kernel's lane
schedule) against the JAX package's fused Newton tile (jitted), on the
split branches (pinhole and atan) of the small Newton problem of
``tests/test_torch_newton_rows.py`` with knots readout / 4.5 apart (closer
than readout / 3, so each Newton row spans 10 knots a spline), its first
rows moved to the edges of the Newton path: every update clamped at 0 or at
the readout, five steps, steps that cross a knot so that the obs
sub-window moves. A file of its own, beside ``tests/test_torch_newton_tile.py``:
each branch's tile compiles anew at this width.

Tolerances: the JAX package's own, as in ``tests/test_torch_newton_tile.py``."""
import pytest
import torch

from test_torch_camera_host import host_library  # noqa: F401
from test_torch_newton_rows import CAMERAS
from test_torch_newton_tile import check_split_tile

torch.set_num_threads(1)


@pytest.mark.parametrize("camera", CAMERAS)
def test_split_rows_match_jax_tile_w10(host_library, camera):
    """B8's plain version and host row code on a split branch's 10-knot edge
    rows against the JAX tile: r, J [M, 2, 133], J_rho."""
    check_split_tile(camera, "edges W10")
