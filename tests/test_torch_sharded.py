"""The port's measurement sharding (``parallel.make_sharded_functions`` /
``_step``), landmark-block Schur sharding (``parallel.schur``),
measurement-sharded iterative Schur (``parallel.iterative``) and
knot-segment sharding (``parallel.segments``) on gloo ranks on the CPU,
against the JAX package's counterparts at the same shard count on its CPU
mesh (the problems of ``tests/test_parallel.py`` and
``tests/test_segments.py``):

- at n = 2: the sharded cost and linearization ``(cost, H, g)`` and one
  dense step; the Schur step at lam 1e-4 and 1e-1 (cost, delta, new cost,
  pred, max |g|, state) and its ``total_cost``; the iterative step with a
  converged CG; the knot-segment step on the gyro and the IMU problems at
  both damping values (the SPIKE band solve, two superblocks a shard);
- at n = 3: the cost and linearization with every bucket padded to a
  multiple of 3 rows (``valid`` 0 rows repeating row 0), against the JAX
  package's 2-shard values (padding is inert: one JAX compile less);
- every rank of a group returns the same bits.

One 3-rank world (``torch_spmd_ranks.sharded_world``) runs in a thread
beside the JAX package's compiles."""
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import torch_spmd_ranks as ranks
from kontiki_tpu import parallel as jax_parallel
from kontiki_tpu import synthetic as jax_synthetic
from kontiki_tpu.solver.problem import Problem as JProblem
from kontiki_tpu_torch.parallel import launch

MAKERS = ("make_gyro_problem", "make_imu_problem")


def _jax_values():
    from test_torch_split_camera import jax_twin

    gen, _ = ranks.rsvi_problem()
    J = jax_twin(gen["trajectory"], gen["measurements"])
    m2 = jax_parallel.default_mesh(n_devices=2)
    s0 = J.state0
    want = {}
    cost_fn, lin_fn, _, _ = jax_parallel.make_sharded_functions(J, m2)
    want["cost 2"], want["lin 2"] = cost_fn(s0), lin_fn(s0)
    want["step 2"] = jax_parallel.make_sharded_step(J, m2)[0](s0, 1e-4)
    step, cost = jax_parallel.make_sharded_schur_step(J, m2)
    want["schur 2"] = [step(s0, lam) for lam in ranks.LAMS]
    want["schur cost 2"] = cost(s0)
    want["iterative 2"] = jax_parallel.make_sharded_iterative_step(J, m2, **ranks.CG)[0](s0, 1e-4)
    # padding is inert: the 3-shard values are the 2-shard ones (the JAX
    # package's test_padding_is_inert holds its own to the one-device ones)
    want["cost 3"], want["lin 3"] = want["cost 2"], want["lin 2"]
    for maker in MAKERS:
        gen = getattr(jax_synthetic, maker)(**ranks.SEGMENTS)
        JP = JProblem(gen["trajectory"], gen["measurements"])
        step, cost = jax_parallel.make_segment_sharded_step(JP, m2)
        want[f"segments {maker}"] = [step(JP.state0, lam) for lam in ranks.LAMS]
        want[f"segments cost {maker}"] = cost(JP.state0)
    return want


@pytest.fixture(scope="module")
def world():
    with ThreadPoolExecutor(1) as pool:
        run = pool.submit(launch.run_spmd, ranks.sharded_world, 3, "cpu")
        want = _jax_values()
        return run.result(), want


def _close(got, want, rtol, atol=0.0, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=what)


def _same_on_the_pair(outs, key):
    a, b = outs[0][key], outs[1][key]
    flat = lambda x: (x if isinstance(x, (list, tuple)) else [x])  # noqa: E731
    for x, y in zip(flat(a), flat(b)):
        if isinstance(x, dict):
            assert all(torch.equal(x[k], y[k]) for k in x)
        elif isinstance(x, (list, tuple)):
            _same = [torch.equal(u, v) if torch.is_tensor(u) else
                     all(torch.equal(u[k], v[k]) for k in u) for u, v in zip(x, y)]
            assert all(_same)
        else:
            assert torch.equal(x, y)


@pytest.mark.parametrize("n", [2, 3])
def test_sharded_linearization_matches_jax(world, n):
    outs, want = world
    for o in outs[:n]:
        _close(o[f"cost {n}"], want[f"cost {n}"], 1e-10, what="cost")
        c, H, g = o[f"lin {n}"]
        jc, jH, jg = want[f"lin {n}"]
        _close(c, jc, 1e-10, what="lin cost")
        _close(g, jg, 1e-8, 1e-10, "g")
        _close(H, jH, 1e-8, 1e-10, "H")
    for o in outs[1:n]:
        assert all(torch.equal(a, b) for a, b in zip(o[f"lin {n}"], outs[0][f"lin {n}"]))


def _check_step(got, want, state_atol=1e-9):
    """(cost, new_state, new_cost, pred, delta, grad_max) of two steps."""
    _close(got[0], want[0], 1e-10, what="cost")
    _close(got[2], want[2], 1e-8, what="new cost")
    _close(got[3], want[3], 1e-8, what="pred")
    _close(got[4], want[4], 1e-6, 1e-10, "delta")
    _close(got[5], want[5], 1e-10, what="grad_max")
    for k, v in got[1].items():
        _close(v, want[1][k], 1e-7, state_atol, k)


def test_sharded_step_matches_jax(world):
    outs, want = world
    _check_step(outs[0]["step 2"], want["step 2"])
    _same_on_the_pair(outs, "step 2")


@pytest.mark.parametrize("i", range(len(ranks.LAMS)))
def test_sharded_schur_step_matches_jax(world, i):
    outs, want = world
    _check_step(outs[0]["schur 2"][i], want["schur 2"][i])
    _close(outs[0]["schur cost 2"], want["schur cost 2"], 1e-10)
    _same_on_the_pair(outs, "schur 2")


def test_sharded_iterative_step_matches_jax(world):
    outs, want = world
    _check_step(outs[0]["iterative 2"], want["iterative 2"])
    _same_on_the_pair(outs, "iterative 2")


@pytest.mark.parametrize("maker", MAKERS)
@pytest.mark.parametrize("i", range(len(ranks.LAMS)))
def test_segment_sharded_step_matches_jax(world, maker, i):
    outs, want = world
    got, w = outs[0][f"segments {maker}"][i], want[f"segments {maker}"][i]
    _check_step(got, w)
    _close(outs[0][f"segments cost {maker}"], want[f"segments cost {maker}"], 1e-10)
    _same_on_the_pair(outs, f"segments {maker}")


def test_segment_sharding_rejects_camera_problems():
    from kontiki_tpu_torch.parallel import Mesh, make_segment_sharded_step

    _, p = ranks.rsvi_problem()
    with pytest.raises(ValueError, match="camera problems shard by landmark"):
        make_segment_sharded_step(p, Mesh())
