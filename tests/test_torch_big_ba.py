"""BASELINE config 5's generator and the array-level problem:
``synthetic.make_big_ba_problem`` and ``solver.problem.RawProblem`` against
the JAX package's at the JAX tests' size (60 views, 300 landmarks, 4
observations each, seed 11), with and without IMU rows at 50 Hz, and
``interop.raw_problem_from_numpy``.

Tolerances: weights, integer data, knots, state0, masks and offsets
exactly (the same numpy draws in the same order); the other floats to
1e-12 absolute (the rolling-shutter fixed point runs in torch here and in
JAX there: pixels of ~10^2 agree to ~1e-13).
"""
import numpy as np
import pytest
import torch

from kontiki_tpu.synthetic import make_big_ba_problem as jax_make
from kontiki_tpu_torch import interop
from kontiki_tpu_torch.solver.kernels import problem_spec
from kontiki_tpu_torch.synthetic import make_big_ba_problem

SIZE = dict(n_views=60, n_landmarks=300, obs_per_landmark=4, seed=11)
EXACT = ("sid", "lid", "weight", "t0_obs", "t0_ref", "readout", "rows", "K", "huber_c", "t")
COUNTS = ("num_tangent", "sensor_offset", "landmark_offset", "vt_offset", "num_parameters",
          "num_parameter_blocks", "num_parameters_reduced", "num_residuals",
          "num_residual_blocks", "num_residuals_reduced", "num_residual_blocks_reduced")


@pytest.fixture(scope="module", params=[0.0, 50.0], ids=["camera", "imu"])
def pair(request):
    kw = dict(SIZE, imu_rate=request.param)
    return jax_make(**kw), make_big_ba_problem(device="cpu", **kw)


def test_structure_and_counts_equal(pair):
    jb, tb = pair
    jp, tp = jb["problem"], tb["problem"]
    for name in COUNTS:
        assert getattr(tp, name) == getattr(jp, name), name
    assert (len(tp.sensors), len(tp.landmarks)) == (len(jp.sensors), len(jp.landmarks))
    assert [(s.kind, s.n, s.t0, s.dt, s.tangent_offset) for s in tp.splines] == [
        (s.kind, s.n, s.t0, s.dt, s.tangent_offset) for s in jp.splines]
    assert list(tp.buckets) == list(jp.buckets)
    for key, b in tp.buckets.items():
        jbk = jp.buckets[key]
        assert (b.kind, b.M, b.rdim, b.window) == (jbk.kind, jbk.M, jbk.rdim, jbk.window)
        assert (b.camera_cls.__name__ if b.camera_cls else None) == (
            jbk.camera_cls.__name__ if jbk.camera_cls else None)
    assert (tb["t1"], tb["t2"], tb["n_obs"]) == (jb["t1"], jb["t2"], jb["n_obs"])
    assert problem_spec(tp).num_landmarks == SIZE["n_landmarks"]


def test_state_mask_and_data_equal(pair):
    jb, tb = pair
    jp, tp = jb["problem"], tb["problem"]
    assert set(tp.state0) == set(jp.state0)
    for k, v in tp.state0.items():
        assert v.device.type == "cpu" and v.dtype == torch.float64
        np.testing.assert_array_equal(v.numpy(), np.asarray(jp.state0[k]), err_msg=k)
    np.testing.assert_array_equal(tp.mask.numpy(), np.asarray(jp.mask))
    np.testing.assert_array_equal(tp.d_max.numpy(), np.asarray(jp.d_max))
    for key, b in tp.buckets.items():
        assert set(b.data) == set(jp.buckets[key].data)
        for k, v in b.data.items():
            want = np.asarray(jp.buckets[key].data[k])
            assert v.shape == want.shape, (key, k)
            if k in EXACT:
                np.testing.assert_array_equal(v.numpy(), want, err_msg=f"{key} {k}")
            else:
                np.testing.assert_allclose(v.numpy(), want, rtol=0, atol=1e-12,
                                           err_msg=f"{key} {k}")


def test_trajectories_equal(pair):
    jb, tb = pair
    for which in ("true_trajectory", "trajectory"):
        for sp in ("R3_spline", "SO3_spline"):
            a, b = getattr(tb[which], sp), getattr(jb[which], sp)
            np.testing.assert_array_equal(a.knots, np.asarray(b.knots))
            assert (a.dt, a.t0) == (b.dt, b.t0)


def test_weights_mark_unconverged_or_hidden_rows():
    tb = make_big_ba_problem(device="cpu", **SIZE)
    w = tb["problem"].buckets["rs_static:PinholeCamera"].data["weight"]
    assert set(w.unique().tolist()) <= {0.0, 1.0} and w.sum() > 0.95 * w.numel()


def test_raw_problem_from_numpy_round_trips(pair):
    jb, tb = pair
    tp = tb["problem"]
    for src in (tp, jb["problem"]):  # the port's own arrays, and the JAX package's
        back = interop.raw_problem_from_numpy(**interop.raw_problem_arrays(src), device="cpu")
        for name in COUNTS:
            assert getattr(back, name) == getattr(src, name), name
        for k, v in back.state0.items():
            np.testing.assert_array_equal(v.numpy(), np.asarray(src.state0[k]), err_msg=k)
        np.testing.assert_array_equal(back.mask.numpy(), np.asarray(src.mask))
        for key, b in back.buckets.items():
            s = src.buckets[key]
            assert (b.M, b.rdim, b.window, b.camera_cls.__name__ if b.camera_cls else None) \
                == (s.M, s.rdim, s.window, s.camera_cls.__name__ if s.camera_cls else None)
            for k, v in b.data.items():
                np.testing.assert_array_equal(v.numpy(), np.asarray(s.data[k]))
                assert v.dtype == (torch.int64 if k == "sid" or k == "lid" else torch.float64)


def test_raw_problem_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_big_ba_problem(n_views=20, n_landmarks=10, obs_per_landmark=2, seed=1)
