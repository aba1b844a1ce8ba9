"""Segment BA on two gloo ranks (``parallel.segments_ba``) on the rows
beyond config 5's: camera and IMU rows with both sensors' time offsets
free (windows move over t -+ max_time_offset; the offset columns ride the
summed sensor border), Newton rows (kernel B8's windows), lifting rows
(PCG mode: each row's ``vt`` a shard-local column past the sensor border)
and pose rows, in banded and PCG mode as each allows;
``tests/test_torch_sharded_segments_ba_newton.py`` runs the Newton rows
the same way (the two files split the JAX package's compiles).

The camera problems (``torch_spmd_ranks.rows_objects``) have landmarks
local in time, so that at n = 2 both shards hold camera rows, landmarks
and vt slots and the knot halos carry rows' sums (on the JAX package's
test problems every camera row lands on shard 0). Their steps are held to
the JAX package's ``make_segment_ba_step`` on a mesh of 2 devices, on the
same objects, with ``tests/test_segments_ba.py``'s config-5 tolerances:
the cost, max |gradient| and ``total_cost`` to 1e-9 relative, the new cost
and the predicted decrease to 1e-6, the state to 1e-9 absolute. The PCG
steps run a converged CG (``torch_spmd_ranks.ROWS_CG``: to 1e-14). Pose
rows are held to the port's one-shard step (the JAX package's segment-BA
step is wrong on pose rows), which ``test_torch_pose.py`` holds to the
port's dense step: the
cost and ``total_cost`` to 1e-10 relative, the new cost and the predicted
decrease to 1e-6, max |gradient| to 1e-9, the state to 1e-9. Both ranks
return the same bits.

The JAX package's sharded full-solve gate (``tests/test_segments_ba.py``'s
``test_full_solve_reaches_ground_truth``: 120 views, 600 landmarks, seed
13, IMU rows at 50 Hz, 20 banded iterations) on the two ranks: the final
cost under 1e-8, the port's ``kkt_residual`` of the solution at most 1e-7
of the start's, the trajectory's SE3-aligned ATE against the truth under
1e-6. One 2-rank world (``torch_spmd_ranks.rows_world``) runs every case,
beside the JAX package's steps in this process."""
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import torch_spmd_ranks as ranks
from kontiki_tpu import parallel as jax_parallel
from kontiki_tpu.parallel import segments_ba as jax_sba
from kontiki_tpu_torch import interop
from kontiki_tpu_torch.parallel import Mesh, launch
from kontiki_tpu_torch.solver.kkt import kkt_residual
from kontiki_tpu_torch.synthetic import make_big_ba_problem, trajectory_ate
from test_torch_split_camera import jax_twin

#: this file's cases (the Newton rows' are in ..._newton.py)
ROWS = tuple((c, m) for c, m in ranks.ROWS_CASES if c != "rs_newton")
#: the state's absolute tolerance
STATE_ATOL = 1e-9


def _jax_steps(cases):
    """The JAX package's 2-device step of each of ``cases`` but pose rows:
    its cost, new state, new cost, pred and max |gradient|."""
    mesh = jax_parallel.default_mesh(n_devices=2)
    twins, out = {}, {}
    for case, mode in cases:
        if case == "pose rows":
            continue
        if case not in twins:
            gen = ranks.rows_objects(case)
            twins[case] = jax_twin(gen["trajectory"], gen["measurements"])
        jp = twins[case]
        out[f"{case} {mode}"] = jax_sba.make_segment_ba_step(
            jp, mesh, mode=mode, **(ranks.ROWS_CG if mode == "pcg" else {}))[0](jp.state0, 1e-4)
    return out


def rows_world(cases, solve_arrays=None):
    """The ranks' outputs for ``cases`` (one 2-rank world, in a thread) and
    the references: the JAX package's steps, the port's one-shard steps of
    pose rows."""
    with ThreadPoolExecutor(1) as pool:
        run = pool.submit(launch.run_spmd, ranks.rows_world, 2, "cpu", cases, solve_arrays)
        want = _jax_steps(cases)
        for case, mode in cases:
            if case == "pose rows":
                want[f"{case} {mode}"] = ranks.rows_step(Mesh(), case, mode)
        return run.result(), want


@pytest.fixture(scope="module")
def big():
    return make_big_ba_problem(device="cpu", **ranks.FULL_SOLVE)


@pytest.fixture(scope="module")
def world(big):
    return rows_world(ROWS, interop.raw_problem_arrays(big["problem"]))


def _check_jax(got, total, want):
    for i, rtol in ((0, 1e-9), (2, 1e-6), (3, 1e-6), (4, 1e-9)):
        np.testing.assert_allclose(got[i].item(), float(want[i]), rtol=rtol, err_msg=str(i))
    np.testing.assert_allclose(total.item(), float(want[0]), rtol=1e-9)
    assert set(got[1]) == set(want[1])
    for k, v in got[1].items():
        assert v.shape == tuple(np.shape(want[1][k])), k
        np.testing.assert_allclose(v.numpy(), np.asarray(want[1][k]), rtol=0,
                                   atol=STATE_ATOL, err_msg=k)


def _check_one_shard(got, total, want):
    ref, ref_total = want
    for i, rtol in ((0, 1e-10), (2, 1e-6), (3, 1e-6), (4, 1e-9)):
        np.testing.assert_allclose(got[i].item(), ref[i].item(), rtol=rtol, err_msg=str(i))
    np.testing.assert_allclose(total.item(), ref_total.item(), rtol=1e-10)
    for k, v in ref[1].items():
        assert got[1][k].shape == v.shape, k
        np.testing.assert_allclose(got[1][k].numpy(), v.numpy(), rtol=0,
                                   atol=STATE_ATOL, err_msg=k)


def check_case(world, case):
    outs, want = world
    got, total = outs[0][case]
    if case.startswith("pose rows"):
        _check_one_shard(got, total, want[case])
    else:
        _check_jax(got, total, want[case])
    if case.startswith("unlocked"):
        assert torch.all(got[1]["d"] != ranks.rows_problem("unlocked offsets").state0["d"])
    for i in (0, 2, 3, 4):
        assert torch.equal(outs[1][case][0][i], got[i])
    for k, v in got[1].items():
        assert torch.equal(outs[1][case][0][1][k], v), k


@pytest.mark.parametrize("case", [f"{c} {m}" for c, m in ROWS])
def test_two_shard_rows_step(world, case):
    check_case(world, case)


def test_full_solve_on_two_ranks_reaches_ground_truth(world, big):
    outs, _ = world
    state, cost, iterations = outs[0]["full solve"]
    assert cost.item() < 1e-8, cost.item()
    problem = big["problem"]
    kkt0 = kkt_residual(problem, problem.state0)
    kkt = kkt_residual(problem, state)
    assert kkt <= 1e-7 * kkt0, (kkt0, kkt)
    sp_r3, sp_so3 = problem.splines
    solved, truth = (interop.split_trajectory_from_numpy(
        r3.numpy(), so3.numpy(), sp_r3.dt, sp_so3.dt, sp_r3.t0, sp_so3.t0, device="cpu")
        for r3, so3 in ((state["r3"], state["so3"]),
                        (torch.as_tensor(big["true_trajectory"].R3_spline.knots),
                         torch.as_tensor(big["true_trajectory"].SO3_spline.knots))))
    assert trajectory_ate(truth, solved, big["t1"], big["t2"], align="se3") < 1e-6
    assert all(torch.equal(outs[1]["full solve"][0][k], v) for k, v in state.items())
