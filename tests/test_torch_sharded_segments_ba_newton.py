"""Segment BA on two gloo ranks (``parallel.segments_ba``) on Newton rows
(kernel B8's windows), in banded and PCG mode, against the JAX package's
``make_segment_ba_step`` on a mesh of 2 devices: the checks of
``tests/test_torch_sharded_segments_ba_rows.py`` (the tolerances of
``tests/test_segments_ba.py``, a converged CG), on its camera problem with
Newton rows (``torch_spmd_ranks.rows_objects("rs_newton")``: 64 views, 32
landmarks local in time, 40 Hz IMU rows, seed 21)."""
import pytest

import torch_spmd_ranks as ranks
from test_torch_sharded_segments_ba_rows import check_case, rows_world

NEWTON = tuple((c, m) for c, m in ranks.ROWS_CASES if c == "rs_newton")


@pytest.fixture(scope="module")
def world():
    return rows_world(NEWTON)


@pytest.mark.parametrize("case", [f"{c} {m}" for c, m in NEWTON])
def test_two_shard_newton_step(world, case):
    check_case(world, case)
