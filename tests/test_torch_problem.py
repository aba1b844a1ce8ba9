"""Port parity: ``synthetic.make_rsvi_problem`` -> ``Problem`` ->
``problem_spec`` / ``problem_runtime`` / ``state0`` of ``kontiki_tpu_torch``
against ``kontiki_tpu`` on one seed (the config-4 generator, cut to 8 views
and 24 landmarks). ``problem_pair`` builds the problems of the other port
test files."""
import functools

import jax
import numpy as np
import pytest
import torch

from kontiki_tpu.solver import kernels as jk
from kontiki_tpu.solver.problem import Problem as JProblem
from kontiki_tpu.synthetic import make_rsvi_problem as jax_make_rsvi_problem
from kontiki_tpu_torch import interop
from kontiki_tpu_torch.solver import kernels as tk
from kontiki_tpu_torch.solver.problem import Problem as TProblem
from kontiki_tpu_torch.synthetic import make_rsvi_problem as torch_make_rsvi_problem

torch.set_num_threads(1)

SMALL = dict(nviews=8, nlandmarks=24, imu_rate=200.0, seed=4)


def _jax_problem_from(tgen):
    """The JAX package's Problem over the same objects: the port's
    generated trajectory, camera, IMU, views, landmarks and measurements,
    rebuilt with the JAX package's classes (cheaper than regenerating)."""
    from kontiki_tpu import measurements as jm
    from kontiki_tpu import sensors as js
    from kontiki_tpu import sfm as jsfm
    from kontiki_tpu.trajectories import UniformSE3SplineTrajectory

    tt = tgen["trajectory"]
    traj = UniformSE3SplineTrajectory(tt.dt, tt.t0)
    for i in range(len(tt)):
        traj.append_knot(tt[i])
    traj.set_knots(tt.knots)
    cam = tgen["camera"]
    jcam = js.PinholeCamera(cam.rows, cam.cols, cam.readout, cam.camera_matrix)
    jimu = js.BasicImu()
    views = [jsfm.View(v.frame_nr, v.t0) for v in tgen["views"]]
    lms, ms = {}, []
    for m in tgen["measurements"]:
        if hasattr(m, "observation"):
            lm = m.observation.landmark
            if id(lm) not in lms:
                jlm = jsfm.Landmark()
                jlm.inverse_depth = lm.inverse_depth
                ref = lm.reference
                jlm.reference = views[ref.view.frame_nr].create_observation(jlm, ref.uv)
                lms[id(lm)] = jlm
            obs = views[m.observation.view.frame_nr].create_observation(
                lms[id(lm)], m.observation.uv)
            ms.append(jm.StaticRsCameraMeasurement(jcam, obs, m.huber_loss, m.weight))
        elif hasattr(m, "w"):
            ms.append(jm.GyroscopeMeasurement(jimu, m.t, m.w, m.weight))
        else:
            ms.append(jm.AccelerometerMeasurement(jimu, m.t, m.a, m.weight))
    return JProblem(traj, ms), views


def _pair(J, T, keep):
    jrt = jk.problem_runtime(J)
    np_rt = jax.tree_util.tree_map(np.asarray, jrt)
    np_state = {k: np.asarray(v) for k, v in J.state0.items()}
    return dict(
        jax=J, jspec=jk.problem_spec(J), jrt=jrt, torch=T,
        rt=interop.runtime_from_numpy(np_rt),
        state=interop.state_from_numpy(np_state),
        keep=keep,
    )


@functools.lru_cache(maxsize=None)
def problem_pair(noise_px=0.0):
    """Both packages' problems over the same inputs: the port's generator
    and ``Problem`` (``torch``), and the JAX package's ``Problem`` over the
    same objects (``jax``) with its spec, runtime and state0 moved into the
    port (``rt``, ``state``)."""
    tgen = torch_make_rsvi_problem(trajectory="se3", noise_px=noise_px, **SMALL)
    T = TProblem(tgen["trajectory"], tgen["measurements"])
    J, views = _jax_problem_from(tgen)
    return _pair(J, T, keep=(tgen, views))


@pytest.fixture(scope="module")
def pair():
    """Each package's own generator from one seed."""
    jgen = jax_make_rsvi_problem(trajectory="se3", **SMALL)
    tgen = torch_make_rsvi_problem(trajectory="se3", **SMALL)
    J = JProblem(jgen["trajectory"], jgen["measurements"])
    T = TProblem(tgen["trajectory"], tgen["measurements"])
    return _pair(J, T, keep=(jgen, tgen))


def test_spec_matches(pair):
    js, ts = pair["jspec"], tk.problem_spec(pair["torch"])
    assert ts.splines == js.splines
    assert [(b.kind, b.camera, b.M, b.rdim, b.windows) for b in ts.buckets] == [
        (b.kind, b.camera, b.M, b.rdim, b.windows) for b in js.buckets
    ]
    for f in ("num_tangent", "sensor_offset", "landmark_offset", "num_sensors",
              "num_landmarks"):
        assert getattr(ts, f) == getattr(js, f), f


def test_runtime_matches(pair):
    jrt, trt = pair["jrt"], tk.problem_runtime(pair["torch"])
    np.testing.assert_array_equal(trt["mask"].numpy(), np.asarray(jrt["mask"]))
    np.testing.assert_array_equal(trt["d_max"].numpy(), np.asarray(jrt["d_max"]))
    assert trt["spline_t0"] == [float(t) for t in jrt["spline_t0"]]
    assert trt["spline_dt"] == [float(t) for t in jrt["spline_dt"]]
    assert len(trt["data"]) == len(jrt["data"])
    for td, jd in zip(trt["data"], jrt["data"]):
        assert sorted(td) == sorted(jd)
        for k in td:
            # observations come out of the rolling-shutter fixed point, which
            # both packages iterate in float64 with their own trig
            np.testing.assert_allclose(td[k].numpy(), np.asarray(jd[k]),
                                       rtol=1e-12, atol=1e-9, err_msg=k)


def test_state0_matches(pair):
    J, T = pair["jax"], pair["torch"]
    for k, v in T.state0.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(J.state0[k]), err_msg=k)
    assert set(J.state0) - set(T.state0) == {"vt"}  # no lifted rows in the port


def test_interop_round_trip(pair):
    J = pair["jax"]
    for k, v in pair["state"].items():
        assert v.dtype == torch.float64
        np.testing.assert_array_equal(v.numpy(), np.asarray(J.state0[k]))
    assert pair["rt"]["data"][0]["lid"].dtype == torch.int64


def test_jax_problem_over_port_objects_matches(pair):
    """``problem_pair`` (used by the other port test files): the JAX Problem over
    the port's objects equals the one from the JAX generator."""
    J, J2 = pair["jax"], problem_pair()["jax"]
    for k, v in J.state0.items():
        np.testing.assert_array_equal(np.asarray(J2.state0[k]), np.asarray(v), err_msg=k)
    for b, b2 in zip(J.buckets.values(), J2.buckets.values()):
        for k in b.data:
            np.testing.assert_allclose(np.asarray(b2.data[k]), np.asarray(b.data[k]),
                                       rtol=1e-12, atol=1e-9, err_msg=k)


def test_problem_rejects_unsupported_measurements(pair):
    T = pair["torch"]
    with pytest.raises(TypeError):
        TProblem(T.trajectory, [object()])
