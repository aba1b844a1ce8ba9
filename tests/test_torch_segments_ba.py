"""BASELINE config 5's solve, ``parallel.segments_ba`` (banded mode, one
shard), against the JAX package's at the JAX tests' size (60 views, 300
landmarks, 4 observations each, seed 11; ``tests/test_segments_ba.py``):

- the layout (``segment_ba_layout``) at 1 and 4 shards, with and without
  IMU rows: every scalar, the anchors, the row permutations, the landmark
  slot tables and the masks exactly, the reordered rows' floats to 1e-12;
- one step of ``make_segment_ba_step`` at lam = 1e-4 against the JAX
  package's on a mesh of one device: cost and new cost to 1e-10 relative,
  the predicted decrease to 1e-8 relative (a difference of two costs of
  ~1e3), max |gradient| to 1e-10 relative, the new state to 1e-9 absolute;
  ``total_cost`` to 1e-10 relative;
- a 3-iteration ``make_segment_ba_solver``: the same iterations, the final
  cost to 1e-8 relative (it falls by ~1e-10 of the initial cost, so the
  linearizations' roundoff shows there), the final state to 1e-8;
- two shards (two gloo ranks) against the port's one-shard step and
  solve; lifting rows in banded mode raise the reference's ``ValueError``;
  the PCG mode, Newton rows and pose rows are held to the JAX package's
  steps there;
- the loop's nested linearization, the window clamp at the real knot
  count and the ``valid`` input of the camera kernels.

``tests/test_torch_segments_ba_imu.py`` repeats the step and the solve with
gyro and accel rows at 50 Hz.
"""
import functools
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from kontiki_tpu import parallel as jax_parallel
from kontiki_tpu.parallel import segments_ba as jax_sba
from kontiki_tpu.solver.problem import Problem as JProblem
from kontiki_tpu.synthetic import make_big_ba_problem as jax_make
from kontiki_tpu_torch import interop
from kontiki_tpu_torch.parallel import segments_ba as sba
from kontiki_tpu_torch.solver import iterative, kernels
from kontiki_tpu_torch.solver.lm import trust_region_loop_spec
from kontiki_tpu_torch.solver.problem import Problem
from kontiki_tpu_torch.synthetic import (
    make_big_ba_problem,
    make_rsvi_problem,
)

SIZE = dict(n_views=60, n_landmarks=300, obs_per_landmark=4, seed=11)
LAY_SCALARS = ("nk", "nk_pad", "seg", "Hl", "Hr", "n", "Lb", "L", "t0", "dt", "Pk_loc", "ns",
               "nloc", "W_max", "G", "sbG", "hl_b", "hr_b", "nbloc", "LaMax")
LAY_ARRAYS = ("lid_to_padded", "mask_l", "mask_sen", "lid_of_slot", "smask")


@functools.lru_cache(maxsize=None)
def _pair(imu_rate):
    """Both packages' problems at SIZE, built once per rate (the tests only
    read them)."""
    kw = dict(SIZE, imu_rate=imu_rate)
    return jax_make(**kw)["problem"], make_big_ba_problem(device="cpu", **kw)["problem"]


def _check_step(jp, tp):
    """One step and total_cost at lam = 1e-4 against the JAX package's."""
    jstep, jcost = jax_sba.make_segment_ba_step(jp, jax_parallel.default_mesh(n_devices=1),
                                                mode="banded")
    step, cost = sba.make_segment_ba_step(tp)
    want = jstep(jp.state0, 1e-4)
    got = step(tp.state0, 1e-4)
    for i, rtol in ((0, 1e-10), (2, 1e-10), (3, 1e-8), (4, 1e-10)):
        np.testing.assert_allclose(got[i].item(), float(want[i]), rtol=rtol, err_msg=str(i))
    assert set(got[1]) == set(want[1])
    for k, v in got[1].items():
        assert v.shape == tp.state0[k].shape
        np.testing.assert_allclose(v.numpy(), np.asarray(want[1][k]), rtol=0, atol=1e-9,
                                   err_msg=k)
    np.testing.assert_allclose(cost(tp.state0).item(), float(jcost(jp.state0)), rtol=1e-10)
    np.testing.assert_allclose(cost(tp.state0).item(), got[0].item(), rtol=1e-12)


def _check_solve(jp, tp, iters=3):
    want = jax_sba.make_segment_ba_solver(jp, jax_parallel.default_mesh(n_devices=1),
                                          max_iterations=iters, function_tolerance=0.0)(jp.state0)
    got = sba.make_segment_ba_solver(tp, max_iterations=iters,
                                     function_tolerance=0.0)(tp.state0)
    assert got[2] == int(want[2]) == iters
    np.testing.assert_allclose(got[1].item(), float(want[1]), rtol=1e-8)
    for k in ("r3", "so3", "rho", "q_ct"):
        np.testing.assert_allclose(got[0][k].numpy(), np.asarray(want[0][k]), rtol=0,
                                   atol=1e-8, err_msg=k)


@functools.lru_cache(maxsize=None)
def _two_shard_world():
    """The 2-rank gloo world of ``test_unported_parts_raise[two shards]``
    (``torch_spmd_ranks.two_shards`` on the camera problem), started in a
    thread when the camera problem is first used, so that it runs beside
    the JAX package's compiles; returns its future."""
    import torch_spmd_ranks
    from kontiki_tpu_torch.parallel import launch

    tp = _pair(0.0)[1]
    return ThreadPoolExecutor(1).submit(launch.run_spmd, torch_spmd_ranks.two_shards, 2, "cpu",
                                        interop.raw_problem_arrays(tp))


@pytest.fixture(scope="module")
def camera():
    _two_shard_world()
    return _pair(0.0)


@pytest.mark.parametrize("n_shards", [1, 4])
@pytest.mark.parametrize("imu_rate", [0.0, 50.0])
def test_layout_matches_jax(imu_rate, n_shards):
    jp, tp = _pair(imu_rate)
    jspec, jloc, jrt, jlay = jax_sba.segment_ba_layout(jp, n_shards)
    spec, loc, rt, lay = sba.segment_ba_layout(tp, n_shards)
    for k in LAY_SCALARS:
        assert lay[k] == jlay[k], k
    for k in LAY_ARRAYS:
        np.testing.assert_array_equal(np.asarray(lay[k]), np.asarray(jlay[k]), err_msg=k)
    for a, b in zip(lay["kmask"], jlay["kmask"]):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert len(lay["banded_tables"]) == len(jlay["banded_tables"])
    for t, jt in zip(lay["banded_tables"], jlay["banded_tables"]):
        assert t["Ma"] == jt["Ma"]
        np.testing.assert_array_equal(t["perm"], np.asarray(jt["perm"]))
        np.testing.assert_array_equal(t["pmask"], np.asarray(jt["pmask"]))
    assert [(s.kind, s.n, s.tangent_offset) for s in loc.splines] == [
        (s.kind, s.n, s.tangent_offset) for s in jloc.splines]
    assert [(b.kind, b.M) for b in loc.buckets] == [(b.kind, b.M) for b in jloc.buckets]
    assert (loc.num_landmarks, loc.sensor_offset) == (jloc.num_landmarks, jloc.sensor_offset)
    for data, jdata in zip(rt["data"], jrt["data"]):
        assert set(data) == set(jdata)
        for k, v in data.items():
            want = np.asarray(jdata[k])
            if v.dtype == torch.int64 or k in ("valid", "weight"):
                np.testing.assert_array_equal(v.numpy(), want, err_msg=k)
            else:  # the generators' floats agree to ~1e-13 (tests/test_torch_big_ba.py)
                np.testing.assert_allclose(v.numpy(), want, rtol=0, atol=1e-12, err_msg=k)


def test_step_matches_jax(camera):
    _check_step(*camera)


def test_solver_matches_jax(camera):
    _check_solve(*camera)


def test_zero_iterations_return_the_linearization_cost(camera):
    _, tp = camera
    state, cost, it = sba.make_segment_ba_solver(tp, max_iterations=0)(tp.state0)
    assert it == 0
    _, total_cost = sba.make_segment_ba_step(tp)
    np.testing.assert_allclose(cost.item(), total_cost(tp.state0).item(), rtol=1e-12)
    for k, v in state.items():
        np.testing.assert_array_equal(v.numpy(), tp.state0[k].numpy())


def _renamed(tp, kind):
    arrays = interop.raw_problem_arrays(tp)
    arrays["buckets"] = {f"{kind}:PinholeCamera": b for b in arrays["buckets"].values()}
    return interop.raw_problem_from_numpy(**arrays, device="cpu")


#: a converged CG, so that the PCG step is the exact damped step of either
#: package (CG at its iteration cap is roundoff-chaotic: a 1e-15 change of
#: its right-hand side moves the new cost by ~5e-5 relative here)
CG = dict(cg_tol=1e-12, cg_maxiter=400)


def _check_against(got, want, state_atol, state_rtol=0.0):
    """Cost, new cost, pred and max |gradient| of two steps (the JAX
    iterative step has its max |gradient| last), and their new states."""
    for i, j, rtol in ((0, 0, 1e-10), (2, 2, 1e-9), (3, 3, 1e-8), (4, len(want) - 1, 1e-10)):
        np.testing.assert_allclose(got[i].item(), float(want[j]), rtol=rtol, err_msg=str(i))
    for k, v in got[1].items():
        if v.numel():
            np.testing.assert_allclose(v.numpy(), np.asarray(want[1][k]), rtol=state_rtol,
                                       atol=state_atol, err_msg=k)


@functools.lru_cache(maxsize=None)
def _rows_pair(rs, free_sensors=False):
    """The JAX package's segment-BA test problem with Newton or lifting rows
    (``tests/test_segments_ba.py``), generated by the port, with its JAX
    twin; with ``free_sensors`` the camera's pose and time offset and the
    IMU's orientation are unlocked (the test problem locks them), so the
    sensor columns move."""
    from test_torch_split_camera import twin_pair

    gen = make_rsvi_problem(nviews=8, nlandmarks=12, imu_rate=40.0,
                            seed=21 if rs == "newton" else 29, rs=rs, perturb_rho=0.03,
                            sigma_p=0.01, sigma_q=0.005, noise_px=0.5, trajectory="split")
    if free_sensors:
        for lock in ("relative_orientation_locked", "relative_position_locked",
                     "time_offset_locked"):
            setattr(gen["camera"], lock, False)
        gen["imu"].relative_orientation_locked = False
    p = twin_pair(gen["trajectory"], gen["measurements"])
    return p["jax"], p["torch"]


@pytest.mark.parametrize("case", ["two shards", "pcg", "rs_newton", "rs_lifting", "pose rows"])
def test_unported_parts_raise(camera, case):
    """Lifting rows in banded mode (the JAX package's ``ValueError``) still
    raise, as does a shard count without a mesh of that many ranks. Two
    shards run on a 2-rank gloo world: the step (cost, new cost and max
    |gradient| to 1e-10 relative, pred 1e-8, state 1e-9) and a 3-iteration
    solve (the same iterations, the final cost to 1e-8, the state to 1e-8)
    against the port's one-shard ones, every rank the same bits. The other
    parts ported since are held to the JAX package: the PCG mode's step against the JAX
    package's one-shard PCG step (converged CG); Newton rows' banded step
    against the JAX package's one-shard banded step (and the port's
    iterative step), the state to 1e-7 (the problem's terminal knot is
    weakly determined, as the JAX test notes); pose rows' steps in both
    modes against the JAX package's iterative step on the same problem (its
    segment-BA step returns a zero step on pose rows in banded mode and a
    cost-raising one in PCG mode there; ROADMAP.md Queue C)."""
    jp, tp = camera
    mesh = jax_parallel.default_mesh(n_devices=1)
    if case == "two shards":
        for make in (sba.make_segment_ba_step, sba.make_segment_ba_solver):
            with pytest.raises(ValueError, match="mesh of 2 ranks"):
                make(tp, n_shards=2)
        outs = _two_shard_world().result()
        got = outs[0]
        want = sba.make_segment_ba_step(tp)[0](tp.state0, 1e-4)
        for i, rtol in ((0, 1e-10), (2, 1e-10), (3, 1e-8), (4, 1e-10)):
            np.testing.assert_allclose(got["step"][i].item(), want[i].item(), rtol=rtol)
        for k, v in want[1].items():
            np.testing.assert_allclose(got["step"][1][k].numpy(), v.numpy(), rtol=0, atol=1e-9)
        np.testing.assert_allclose(got["cost"].item(), want[0].item(), rtol=1e-10)
        solve = sba.make_segment_ba_solver(tp, max_iterations=3,
                                           function_tolerance=0.0)(tp.state0)
        assert got["solve"][2] == solve[2] == 3
        np.testing.assert_allclose(got["solve"][1].item(), solve[1].item(), rtol=1e-8)
        for k, v in solve[0].items():
            np.testing.assert_allclose(got["solve"][0][k].numpy(), v.numpy(), rtol=0, atol=1e-8)
        for k, v in got["solve"][0].items():
            assert torch.equal(outs[1]["solve"][0][k], v), k
    elif case == "rs_lifting":
        for make in (sba.make_segment_ba_step, sba.make_segment_ba_solver):
            with pytest.raises(ValueError, match="mode='pcg'"):
                make(_renamed(tp, case))
    elif case == "pcg":
        want = jax_sba.make_segment_ba_step(jp, mesh, mode="pcg", **CG)[0](jp.state0, 1e-4)
        step, cost = sba.make_segment_ba_step(tp, mode="pcg", **CG)
        _check_against(step(tp.state0, 1e-4), want, 1e-9)
        np.testing.assert_allclose(cost(tp.state0).item(), float(want[0]), rtol=1e-10)
        # converged PCG solves the banded mode's damped system
        pcg = sba.make_segment_ba_solver(tp, max_iterations=2, function_tolerance=0.0,
                                         mode="pcg", **CG)(tp.state0)
        band = sba.make_segment_ba_solver(tp, max_iterations=2,
                                          function_tolerance=0.0)(tp.state0)
        assert pcg[2] == band[2] == 2
        np.testing.assert_allclose(pcg[1].item(), band[1].item(), rtol=1e-6)
    elif case == "rs_newton":
        jn, tn = _rows_pair("newton")
        want = jax_sba.make_segment_ba_step(jn, mesh, mode="banded")[0](jn.state0, 1e-4)
        got = sba.make_segment_ba_step(tn)[0](tn.state0, 1e-4)
        _check_against(got, want, 1e-7)
        ref = iterative.make_iterative_step(tn, **CG)[0](tn.state0, 1e-4)
        for i in (2, 3):
            np.testing.assert_allclose(got[i].item(), ref[i].item(), rtol=1e-6)
    else:
        from kontiki_tpu.solver.iterative import make_iterative_step
        from test_torch_pose import _fit

        start, ms, jt, jms = _fit()
        tpose = Problem(start, ms, device="cpu")
        want = make_iterative_step(JProblem(jt, jms), **CG)[0](JProblem(jt, jms).state0, 1e-4)
        for mode in ("banded", "pcg"):
            got = sba.make_segment_ba_step(tpose, mode=mode, **CG)[0](tpose.state0, 1e-4)
            assert got[2].item() < got[0].item()
            _check_against(got, want, 1e-8)


def test_unknown_mode_is_an_error(camera):
    with pytest.raises(ValueError):
        sba.make_segment_ba_solver(camera[1], mode="dense")


def _gn_problem(nested):
    """Gauss-Newton on f(x) = (x^2 - 2)^2 / 2 with the linearization carried
    as ``(cost, {"H": ., "g": (.,)}, mask)`` or flat as ``(cost, H, g,
    mask)``."""
    def lin_at(x):
        r, J = x["x"] ** 2 - 2.0, 2.0 * x["x"]
        parts = (J * J, J * r)
        if nested:
            return 0.5 * r * r, {"H": parts[0], "g": (parts[1],)}, torch.ones(())
        return (0.5 * r * r, *parts, torch.ones(()))

    def step_spec(state, lin, lam):
        H, g = (lin[1]["H"], lin[1]["g"][0]) if nested else lin[1:3]
        dx = -g / (H + lam * H)
        new = {"x": state["x"] + dx}
        return new, lin_at(new), -(g * dx + 0.5 * H * dx * dx)

    return lin_at, step_spec


def test_speculative_loop_selects_nested_linearizations():
    """``trust_region_loop_spec`` carries a nested linearization (the banded
    step's ``(cost, assembly dict, mask_l)``) through the same iterate
    sequence as a flat one."""
    x0 = {"x": torch.tensor(3.0, dtype=torch.float64)}
    out = {}
    for nested in (True, False):
        lin_at, step_spec = _gn_problem(nested)
        out[nested] = trust_region_loop_spec(step_spec, lin_at(x0), x0, max_iterations=8,
                                             function_tolerance=1e-14)
    assert out[True][2] == out[False][2] > 2
    assert out[True][0]["x"].item() == out[False][0]["x"].item()
    assert out[True][1].item() == out[False][1].item()
    assert abs(out[True][0]["x"].item() - 2.0 ** 0.5) < 1e-6


def test_speculative_loop_keeps_the_nested_linearization_on_reject():
    """A rejected candidate leaves every leaf of the carried linearization
    and the state as they were."""
    lin_at, _ = _gn_problem(True)
    x0 = {"x": torch.tensor(3.0, dtype=torch.float64)}
    seen = []

    def worse(state, lin, lam):
        seen.append((lin[1]["H"].item(), lin[1]["g"][0].item(), lin[0].item()))
        new = {"x": state["x"] + 1.0}
        return new, lin_at(new), torch.tensor(1.0, dtype=torch.float64)

    state, cost, it = trust_region_loop_spec(worse, lin_at(x0), x0, max_iterations=3,
                                             function_tolerance=0.0)
    lin0 = lin_at(x0)
    assert it == 3 and state["x"].item() == 3.0 and cost.item() == lin0[0].item()
    assert seen == [(lin0[1]["H"].item(), lin0[1]["g"][0].item(), lin0[0].item())] * 3


def test_camera_inputs_clamp_at_n_eval_and_pass_valid(camera):
    """Window bases clamp at the runtime's ``spline_n_eval`` (the real
    spline's knot count inside the padded segment layout), and the rows'
    ``valid`` reaches the kernels' inputs."""
    _, tp = camera
    spec = kernels.problem_spec(tp)
    rt = kernels.problem_runtime(tp)
    data = dict(rt["data"][0])
    _, ins, i0s = kernels._camera_inputs(spec, rt, tp.state0, data)
    assert "valid" not in ins and max(i.max().item() for i in i0s["obs"]) > 10
    rt["spline_n_eval"] = [10, 10]
    data["valid"] = torch.ones(spec.buckets[0].M, dtype=torch.float64)
    _, ins, i0s = kernels._camera_inputs(spec, rt, tp.state0, data)
    assert max(i.max().item() for tag in i0s.values() for i in tag) == 6
    assert ins["valid"].shape == (1, spec.buckets[0].M)
