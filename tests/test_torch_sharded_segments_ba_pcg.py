"""Segment BA's PCG mode on several shards (``parallel.segments_ba``,
``mode="pcg"``, a converged CG: 1e-12, at most 400 iterations) on 2 and 4
gloo ranks on the CPU, against the JAX package's PCG
``make_segment_ba_step`` at the same shard count: the checks of
``tests/test_torch_sharded_segments_ba.py`` (the tolerances of
``tests/test_segments_ba.py``), with the CG's dots and matvec sums over the
shards."""
import pytest

from test_torch_sharded_segments_ba import (
    QUANTITIES,
    check_quantity,
    check_same_bits,
    check_solve,
    sharded_world,
)


@pytest.fixture(scope="module")
def world():
    return sharded_world("pcg")


@pytest.mark.parametrize("what", QUANTITIES)
@pytest.mark.parametrize("n", [2, 4])
def test_pcg_step_matches_jax(world, n, what):
    check_quantity(world, n, what)


@pytest.mark.parametrize("n", [2, 4])
def test_pcg_ranks_return_the_same_bits(world, n):
    check_same_bits(world, n)


def test_pcg_solve_on_four_ranks_matches_one_shard(world):
    check_solve(world)
