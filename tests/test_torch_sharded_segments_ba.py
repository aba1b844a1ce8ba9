"""BASELINE config 5's solve on several shards: ``parallel.segments_ba``
in banded mode on 2 and 4 gloo ranks on the CPU, against the JAX package's
``make_segment_ba_step`` at the same shard count on its CPU mesh, on
``tests/test_segments_ba.py``'s problem (``make_big_ba_problem(n_views=60,
n_landmarks=300, obs_per_landmark=4, seed=11, imu_rate=50.0)``; the
knot halos, the landmark blocks, the sensor-border and scalar ``psum``s and
the SPIKE band solve all run). That test's tolerances: the cost to 1e-9
relative, the new cost and the predicted decrease to 1e-6, the state to
1e-9 absolute; max |gradient| and ``total_cost`` to 1e-9. Every rank of a
group, and both 2-rank groups, return the same bits; a 2-iteration solve
on 4 ranks (the whole trust-region loop on every rank) against the port's
one-shard solve. ``tests/test_torch_sharded_segments_ba_pcg.py`` runs the
PCG mode the same way."""
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import torch_spmd_ranks as ranks
from kontiki_tpu import parallel as jax_parallel
from kontiki_tpu.parallel import segments_ba as jax_sba
from kontiki_tpu.synthetic import make_big_ba_problem as jax_make
from kontiki_tpu_torch import interop
from kontiki_tpu_torch.parallel import launch, make_segment_ba_solver
from kontiki_tpu_torch.synthetic import make_big_ba_problem

MODE = "banded"
QUANTITIES = ("cost", "new cost", "pred", "max |g|", "state", "total_cost")


def sharded_world(mode):
    """The ranks' outputs (one 4-rank world, in a thread), the JAX
    package's steps at 2 and 4 shards and the port's one-shard
    2-iteration solve."""
    tp = make_big_ba_problem(device="cpu", **ranks.SEGMENT_BA)["problem"]
    cg = ranks.SBA_CG if mode == "pcg" else {}
    with ThreadPoolExecutor(1) as pool:
        run = pool.submit(launch.run_spmd, ranks.segment_ba_world, 4, "cpu",
                          interop.raw_problem_arrays(tp), mode)
        jp = jax_make(**ranks.SEGMENT_BA)["problem"]
        want = {n: jax_sba.make_segment_ba_step(jp, jax_parallel.default_mesh(n_devices=n),
                                                mode=mode, **cg)[0](jp.state0, 1e-4)
                for n in (2, 4)}
        solve1 = make_segment_ba_solver(tp, max_iterations=2, function_tolerance=0.0,
                                        mode=mode, **cg)(tp.state0)
        return dict(outs=run.result(), want=want, solve1=solve1)


@pytest.fixture(scope="module")
def world():
    return sharded_world(MODE)


def check_quantity(world, n, what):
    (got, total), want = world["outs"][0][n], world["want"][n]
    index = {"cost": (0, 1e-9), "new cost": (2, 1e-6), "pred": (3, 1e-6),
             "max |g|": (4, 1e-9)}
    if what == "state":
        assert set(got[1]) == set(want[1])
        for k, v in got[1].items():
            assert v.shape == tuple(np.shape(want[1][k])), k
            np.testing.assert_allclose(v.numpy(), np.asarray(want[1][k]), rtol=0, atol=1e-9,
                                       err_msg=k)
    elif what == "total_cost":
        np.testing.assert_allclose(total.item(), float(want[0]), rtol=1e-9)
    else:
        i, rtol = index[what]
        np.testing.assert_allclose(got[i].item(), float(want[i]), rtol=rtol)


def check_same_bits(world, n):
    outs = world["outs"]
    ref = outs[0][n][0]
    for o in outs[1:]:
        got = o[n][0]
        for i in (0, 2, 3, 4):
            assert torch.equal(got[i], ref[i])
        for k, v in ref[1].items():
            assert torch.equal(got[1][k], v), k


def check_solve(world):
    got, want = world["outs"][0]["solve 4"], world["solve1"]
    assert got[2] == want[2] == 2
    np.testing.assert_allclose(got[1].item(), want[1].item(), rtol=1e-8)
    for k, v in want[0].items():
        np.testing.assert_allclose(got[0][k].numpy(), v.numpy(), rtol=0, atol=1e-8, err_msg=k)
    for o in world["outs"][1:]:
        assert all(torch.equal(o["solve 4"][0][k], got[0][k]) for k in got[0])


@pytest.mark.parametrize("what", QUANTITIES)
@pytest.mark.parametrize("n", [2, 4])
def test_step_matches_jax(world, n, what):
    check_quantity(world, n, what)


@pytest.mark.parametrize("n", [2, 4])
def test_ranks_return_the_same_bits(world, n):
    check_same_bits(world, n)


def test_solve_on_four_ranks_matches_one_shard(world):
    check_solve(world)
