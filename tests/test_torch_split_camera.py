"""Port parity, camera rows on a split R3 + SO3 trajectory (BASELINE config
3's spline model): the gather stage, kernel B1's split branch (plain
version) and kernel B3 (``cost_rows``, plain version) against
``kontiki_tpu`` on the same inputs, in float64.

The problem is ``make_rsvi_problem(trajectory="split")`` cut to 6 views and
10 landmarks, re-knotted onto R3 and SO3 splines that differ in ``dt`` and
in ``t0`` (config 3's two splines share one grid, which would hide a
swapped ``u`` or ``dts``). ``twin_pair`` builds the JAX package's
``Problem`` over the same objects for the other port test files.

Tolerance: |port - jax| <= 1e-10 * max|jax| per output (the same formulas
in another order; the JAX component path uses a Newton arctangent)."""
import functools

import numpy as np
import pytest
import torch

from kontiki_tpu import measurements as jm
from kontiki_tpu import sensors as js
from kontiki_tpu import sfm as jsfm
from kontiki_tpu import trajectories as jt
from kontiki_tpu.ops import linearize_kernels as jlk
from kontiki_tpu.solver import kernels as jk
from kontiki_tpu.solver.problem import Problem as JProblem
from kontiki_tpu_torch import interop
from kontiki_tpu_torch.ops import linearize_kernels as tlk
from kontiki_tpu_torch.solver import kernels as tk
from kontiki_tpu_torch.solver.problem import Problem as TProblem
from kontiki_tpu_torch.synthetic import make_rsvi_problem
from kontiki_tpu_torch.trajectories import SplitTrajectory
from test_torch_camera_host import regrid

torch.set_num_threads(1)
RTOL = 1e-10
SMALL = dict(nviews=6, nlandmarks=10, imu_rate=0.0, seed=3)


def _close(got, want, name):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, name
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=RTOL * np.abs(want).max(), err_msg=name)


def jax_twin(traj, measurements):
    """The JAX package's Problem over the same trajectory (split or SE3),
    sensors (pinhole or atan cameras, IMUs: poses, offsets, offset bounds
    and locks), landmarks and measurements (static, Newton or lifting camera
    rows, the lifting ones with their ``vt``; gyro and accel rows) as the
    port's objects."""
    if isinstance(traj, SplitTrajectory):
        r3, so3 = traj.R3_spline, traj.SO3_spline
        jtraj = jt.SplitTrajectory(r3.dt, so3.dt, r3.t0, so3.t0)
        for src, dst in ((r3, jtraj.R3_spline), (so3, jtraj.SO3_spline)):
            for i in range(len(src)):
                dst.append_knot(src[i])
    else:
        jtraj = jt.UniformSE3SplineTrajectory(traj.dt, traj.t0)
        for i in range(len(traj)):
            jtraj.append_knot(traj[i])
        jtraj.set_knots(traj.knots)
    jtraj.locked = traj.locked
    sensors, views, lms, ms = {}, {}, {}, []

    def sensor(s):
        if id(s) not in sensors:
            if hasattr(s, "gamma"):
                j = js.AtanCamera(s.rows, s.cols, s.readout, s.camera_matrix, wc=s.wc,
                                  gamma=s.gamma)
            elif hasattr(s, "camera_matrix"):
                j = js.PinholeCamera(s.rows, s.cols, s.readout, s.camera_matrix)
            elif hasattr(s, "gyroscope_bias"):
                j = js.ConstantBiasImu(s.accelerometer_bias, s.gyroscope_bias)
                j.accelerometer_bias_locked = s.accelerometer_bias_locked
                j.gyroscope_bias_locked = s.gyroscope_bias_locked
            else:
                j = js.BasicImu()
            j.relative_pose = s.relative_pose
            j.max_time_offset = s.max_time_offset  # before the offset it bounds
            j.time_offset = s.time_offset
            for lock in ("relative_orientation_locked", "relative_position_locked",
                         "time_offset_locked"):
                setattr(j, lock, getattr(s, lock))
            sensors[id(s)] = j
        return sensors[id(s)]

    def view(v):
        if v.frame_nr not in views:
            views[v.frame_nr] = jsfm.View(v.frame_nr, v.t0)
        return views[v.frame_nr]

    for m in measurements:
        if hasattr(m, "observation"):
            lm = m.observation.landmark
            if id(lm) not in lms:
                jlm = jsfm.Landmark()
                jlm.inverse_depth = lm.inverse_depth
                jlm.locked = lm.locked
                jlm.reference = view(lm.reference.view).create_observation(
                    jlm, lm.reference.uv)
                lms[id(lm)] = jlm
            obs = view(m.observation.view).create_observation(lms[id(lm)], m.observation.uv)
            if hasattr(m, "vt"):
                jm_ = jm.LiftingRsCameraMeasurement(sensor(m.camera), obs, m.huber_loss,
                                                    m.weight)
                jm_.vt = m.vt
            elif hasattr(m, "max_iterations"):
                jm_ = jm.NewtonRsCameraMeasurement(sensor(m.camera), obs, m.huber_loss,
                                                   m.weight)
            else:
                jm_ = jm.StaticRsCameraMeasurement(sensor(m.camera), obs, m.huber_loss,
                                                   m.weight)
            ms.append(jm_)
        elif hasattr(m, "w"):
            ms.append(jm.GyroscopeMeasurement(sensor(m.imu), m.t, m.w, m.weight))
        else:
            ms.append(jm.AccelerometerMeasurement(sensor(m.imu), m.t, m.a, m.weight))
    problem = JProblem(jtraj, ms)
    problem.twin_views = views  # they hold the observations the landmarks reference weakly
    return problem


def twin_pair(traj, measurements):
    """Both packages' problems over the same objects, with the JAX
    package's spec, runtime and state0 moved into the port (``rt``,
    ``state``)."""
    import jax

    J = jax_twin(traj, measurements)
    T = TProblem(traj, measurements, device="cpu")
    jrt = jk.problem_runtime(J)
    return dict(
        jax=J, jspec=jk.problem_spec(J), jrt=jrt, torch=T, tspec=tk.problem_spec(T),
        rt=interop.runtime_from_numpy(jax.tree_util.tree_map(np.asarray, jrt), device="cpu"),
        state=interop.state_from_numpy({k: np.asarray(v) for k, v in J.state0.items()},
                                       device="cpu"),
    )


@functools.lru_cache(maxsize=None)
def split_pair(noise_px=0.0):
    """The split camera problem on distinct R3/SO3 grids, in both packages."""
    gen = make_rsvi_problem(noise_px=noise_px, **SMALL)
    return twin_pair(regrid(gen["trajectory"]), gen["measurements"])


@pytest.fixture(scope="module")
def camera():
    """Both packages' gathered camera rows, and the JAX package's fused
    camera terms (r, J, cols, J_rho; B1 on its XLA path, compiled once)."""
    import jax

    pair = split_pair()
    spec, jrt, J = pair["jspec"], pair["jrt"], pair["jax"]
    ins, cfg, i0s, _ = jk._fused_camera_inputs(spec, spec.buckets[0], jrt, J.state0,
                                               jrt["data"][0])
    tcfg, tins, _ = tk._camera_inputs(pair["tspec"], pair["rt"], pair["state"],
                                      pair["rt"]["data"][0])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jlk, "LINEARIZE", "xla")
        terms = jax.jit(lambda rt, st: jk._camera_rows_fused(
            spec, spec.buckets[0], rt, st, rt["data"][0], True))(jrt, J.state0)
    return dict(pair=pair, ins=ins, cfg=cfg, tcfg=tcfg, tins=tins,
                terms=[np.asarray(a) for a in terms])


def test_grids_differ(camera):
    """The R3 and SO3 splines differ in dt and t0, and the rows' u differ."""
    rt, tins = camera["pair"]["rt"], camera["tins"]
    assert rt["spline_dt"][0] != rt["spline_dt"][1]
    assert rt["spline_t0"][0] != rt["spline_t0"][1]
    assert not torch.allclose(tins["u_ref"], tins["u_ref_so3"])
    assert torch.equal(tins["dts"][:, 0], torch.tensor(rt["spline_dt"], dtype=torch.float64))


def test_gather_matches_jax(camera):
    pair, tins = camera["pair"], camera["tins"]
    T = pair["torch"]
    trt = tk.problem_runtime(T)
    tcfg, own, _ = tk._camera_inputs(pair["tspec"], trt, T.state0, trt["data"][0])
    assert tcfg == camera["cfg"] == dict(kind="split", r3_first=True,
                                         camera="PinholeCamera", lifting=False, rdim=2,
                                         C=61)
    assert sorted(tins) == sorted(camera["ins"]) == sorted(own)
    for k, v in tins.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(camera["ins"][k]), err_msg=k)
        # the port's own Problem gathers the same rows (its observations come
        # from the same generator, state0 from the same objects)
        np.testing.assert_allclose(own[k].numpy(), v.numpy(), rtol=1e-12, atol=1e-12,
                                   err_msg=k)


def test_b1_split_plain_matches_jax(camera):
    r, J, _, J_rho = camera["terms"]
    got = tlk.linearize_rows_plain(camera["tcfg"], camera["tins"])
    for name, g, w in zip(("r", "J", "J_rho"), got, (r, J, J_rho)):
        _close(g.numpy(), w, name)


@pytest.mark.parametrize("with_valid", [False, True])
def test_b3_split_plain_matches_jax(camera, with_valid):
    ins, tins = dict(camera["ins"]), dict(camera["tins"])
    if with_valid:
        valid = (np.arange(tins["u_ref"].shape[1]) % 3 != 0).astype(np.float64)[None, :]
        ins["valid"], tins["valid"] = valid, torch.tensor(valid)
    want = jlk.cost_rows(camera["cfg"], ins, backend="xla")
    got = tlk.cost_rows_plain(camera["tcfg"], tins)
    _close(got.numpy(), want, "r")
    # B3's r is B1's r on the same inputs
    _close(got.numpy(), tlk.linearize_rows_plain(camera["tcfg"], tins)[0].numpy(), "r vs B1")


def test_r3_second_order(camera):
    """Splines in (SO3, R3) order: the window seeds swap halves, the
    residual stays, and ``dts`` keeps its (R3, SO3) order."""
    tcfg, tins = camera["tcfg"], camera["tins"]
    r, J, J_rho = tlk.linearize_rows_plain(tcfg, tins)
    r2, J2, J_rho2 = tlk.linearize_rows_plain(dict(tcfg, r3_first=False), tins)
    torch.testing.assert_close(r2, r, rtol=0, atol=0)
    torch.testing.assert_close(J_rho2, J_rho, rtol=0, atol=0)
    for base in (0, 24):
        torch.testing.assert_close(J2[..., base:base + 12], J[..., base + 12:base + 24])
        torch.testing.assert_close(J2[..., base + 12:base + 24], J[..., base:base + 12])
    torch.testing.assert_close(J2[..., 48:], J[..., 48:])


def test_camera_terms_match_jax(camera):
    """The port's bucket terms (gather, B1, column ids per spline) against
    the JAX package's fused camera rows."""
    pair = camera["pair"]
    got = tk.bucket_terms(pair["tspec"], pair["tspec"].buckets[0], pair["rt"], pair["state"],
                          pair["rt"]["data"][0])
    for name, g, w in zip(("r", "J", "cols", "J_rho"), got, camera["terms"]):
        if name == "cols":
            np.testing.assert_array_equal(g.numpy(), w)
        else:
            _close(g.numpy(), w, name)


def test_wrappers_on_cpu_run_plain_and_check_inputs(camera):
    tcfg, tins = camera["tcfg"], camera["tins"]
    torch.testing.assert_close(tlk.cost_rows(tcfg, tins), tlk.cost_rows_plain(tcfg, tins),
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="dts"):
        tlk.cost_rows(tcfg, dict(tins, dts=tins["dts"][:1].contiguous()))
    with pytest.raises(ValueError, match="win_obs_so3"):
        tlk.linearize_rows(tcfg, {k: v for k, v in tins.items() if k != "win_obs_so3"})
    with pytest.raises(ValueError, match="r3_first"):
        tlk.cost_rows(dict(kind="split"), tins)
    with pytest.raises(ValueError, match="kind"):
        tlk.cost_rows(dict(kind="so3"), tins)
