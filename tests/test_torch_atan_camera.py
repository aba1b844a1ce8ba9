"""Port parity: the atan camera and the lifting measurement's object API
against ``kontiki_tpu``, in float64.

- ``sensors.camera_models``: ``atan_project``, ``atan_evaluate``,
  ``atan_unproject``, ``pinhole_project``, ``pinhole_evaluate`` and
  ``pinhole_unproject`` against the JAX package's on the same points (one
  ``K`` and batched ``K``), with points at the distortion centre, and
  unproject(project(X)) round trips back to the z = 1 ray;
- ``AtanCamera`` and ``PinholeCamera``: ``project``,
  ``evaluate_projection`` and ``unproject`` against the JAX package's
  classes; ``synthetic.make_camera``;
- ``LiftingRsCameraMeasurement``: ``vt_orig``, ``vt`` and ``error`` (the
  3-vector) against the JAX package's on the same objects.

Tolerance: 1e-14 relative to max |JAX| per output (the same formulas on the
same numbers); round trips 1e-12.
"""
import numpy as np
import pytest
import torch

from kontiki_tpu import measurements as jm
from kontiki_tpu import sensors as js
from kontiki_tpu import sfm as jsfm
from kontiki_tpu import trajectories as jt
from kontiki_tpu.sensors import camera_models as jcm
from kontiki_tpu_torch import interop
from kontiki_tpu_torch import sfm as tsfm
from kontiki_tpu_torch.measurements import LiftingRsCameraMeasurement
from kontiki_tpu_torch.sensors import AtanCamera, PinholeCamera
from kontiki_tpu_torch.sensors import camera_models as tcm
from kontiki_tpu_torch.synthetic import make_camera, make_split_trajectory

torch.set_num_threads(1)
RTOL = 1e-14
K = np.array([[500.0, 0.0, 320.0], [0.0, 510.0, 240.0], [0.0, 0.0, 1.0]])
WC = np.array([0.64, 0.48])
GAMMA = 0.9


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * np.abs(want).max())


@pytest.fixture(scope="module")
def points():
    """Camera-frame points and their time derivatives; the first point
    projects onto the distortion centre."""
    rng = np.random.default_rng(7)
    X = np.concatenate([rng.normal(size=(40, 2)), rng.uniform(2.0, 20.0, (40, 1))], axis=1)
    X[0, :2] = WC * X[0, 2]
    return X, rng.normal(size=(40, 3))


@pytest.mark.parametrize("batched", [False, True])
def test_camera_models_match_jax(points, batched):
    X, dX = points
    Kt = torch.tensor(K)
    if batched:  # per-point K, wc and gamma
        Kt = Kt.expand(len(X), 3, 3)
    wc, gamma = torch.tensor(WC), torch.tensor(GAMMA, dtype=torch.float64)
    if batched:
        wc, gamma = wc.expand(len(X), 2), gamma.expand(len(X))
    Xt, dXt = torch.tensor(X), torch.tensor(dX)
    _close(tcm.pinhole_project(Kt, Xt), jcm.pinhole_project(K, X))
    for g, w in zip(tcm.pinhole_evaluate(Kt, Xt, dXt), jcm.pinhole_evaluate(K, X, dX)):
        _close(g, w)
    _close(tcm.atan_project(Kt, wc, gamma, Xt), jcm.atan_project(K, WC, GAMMA, X))
    got = tcm.atan_evaluate(Kt, wc, gamma, Xt, dXt)
    for g, w in zip(got, jcm.atan_evaluate(K, WC, GAMMA, X, dX)):
        _close(g, w)
    assert torch.isfinite(got[1]).all()  # the distortion centre's derivative
    y = got[0]
    Kinv = torch.linalg.inv(Kt)
    _close(tcm.pinhole_unproject(Kinv, y), jcm.pinhole_unproject(np.linalg.inv(K), y.numpy()))
    _close(tcm.atan_unproject(Kinv, wc, gamma, y),
           jcm.atan_unproject(np.linalg.inv(K), WC, GAMMA, y.numpy()))


def test_unproject_project_round_trips(points):
    X, _ = points
    Xt, Kt = torch.tensor(X), torch.tensor(K)
    Kinv = torch.linalg.inv(Kt)
    ray = Xt / Xt[:, 2:3]
    back = tcm.atan_unproject(Kinv, torch.tensor(WC), GAMMA,
                              tcm.atan_project(Kt, torch.tensor(WC), GAMMA, Xt))
    _close(back, ray, rtol=1e-12)
    _close(tcm.pinhole_unproject(Kinv, tcm.pinhole_project(Kt, Xt)), ray, rtol=1e-12)


def test_camera_classes_match_jax(points):
    X, dX = points
    cams = {
        "atan": (AtanCamera(480, 640, 0.025, K, wc=WC, gamma=GAMMA),
                 js.AtanCamera(480, 640, 0.025, K, wc=WC, gamma=GAMMA)),
        "pinhole": (PinholeCamera(480, 640, 0.025, K), js.PinholeCamera(480, 640, 0.025, K)),
    }
    for name, (tc, jc) in cams.items():
        for derive in (True, False):
            for g, w in zip(tc.evaluate_projection(X, dX, derive),
                            jc.evaluate_projection(X, dX, derive)):
                _close(g, w)
        y = tc.project(X)
        _close(y, jc.project(X))
        _close(tc.unproject(y), jc.unproject(y))
        _close(tc.unproject(y), X / X[:, 2:3], rtol=1e-12)
    atan = cams["atan"][0]
    np.testing.assert_array_equal(atan.wc, WC)
    assert atan.gamma == GAMMA and isinstance(atan, PinholeCamera)


def test_make_camera_matches_jax():
    from kontiki_tpu.synthetic import make_camera as jax_make_camera

    for kind, cls in (("pinhole", PinholeCamera), ("atan", AtanCamera)):
        got, want = make_camera(kind), jax_make_camera(kind)
        assert type(got) is cls and type(want).__name__ == cls.__name__
        np.testing.assert_array_equal(got.camera_matrix, want.camera_matrix)
        assert (got.rows, got.cols, got.readout) == (want.rows, want.cols, want.readout)
        if kind == "atan":
            np.testing.assert_array_equal(got.wc, want.wc)
            assert got.gamma == want.gamma == 0.9


def test_lifting_measurement_matches_jax():
    """``error`` of lifting measurements (two observations of one landmark,
    a row time moved off its observed value) on both packages' objects."""
    truth = make_split_trajectory(2.0, dt=0.1, seed=5)
    r3, so3 = truth.R3_spline, truth.SO3_spline
    traj = interop.split_trajectory_from_numpy(r3.knots, so3.knots, r3.dt, so3.dt, r3.t0,
                                               so3.t0, device="cpu")
    jtraj = jt.SplitTrajectory(r3.dt, so3.dt, r3.t0, so3.t0)
    for src, dst in ((r3, jtraj.R3_spline), (so3, jtraj.SO3_spline)):
        for i in range(len(src)):
            dst.append_knot(src[i])
    out = []
    for sfm, cam_cls, meas, tr in ((tsfm, AtanCamera, LiftingRsCameraMeasurement, traj),
                                   (jsfm, js.AtanCamera, jm.LiftingRsCameraMeasurement, jtraj)):
        cam = cam_cls(480, 640, 0.025, K, wc=WC, gamma=GAMMA)
        cam.time_offset = 0.004
        views = [sfm.View(i, 0.5 + i / 30) for i in range(2)]
        lm = sfm.Landmark()
        lm.inverse_depth = 0.2
        lm.reference = views[0].create_observation(lm, [300.0, 200.0])
        m = meas(cam, views[1].create_observation(lm, [310.0, 215.0]), weight=2.0)
        assert m.vt_orig == m.vt == 215.0 / 480
        e0 = m.error(tr)
        m.vt = 0.3
        out.append((e0, m.error(tr)))
    for got, want in zip(out[0], out[1]):
        assert got.shape == (3,)
        _close(got, want, rtol=1e-12)
    assert out[0][1][2] == 2.0 * (480 * (0.3 - 215.0 / 480))
