"""``kontiki_tpu_torch.io`` (HDF5, the reference's schema): round trips of
all four trajectory kinds, structure with and without colours, the atan
camera's calibration file and solver-state checkpoints with a resumed
solve; and files exchanged both ways with ``kontiki_tpu.io``: what either
package writes loads in the other with equal arrays (knots exactly, SE3
4x4 knots to 1e-12 through the quaternion round trip)."""
import h5py
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kontiki_tpu import io as jio
from kontiki_tpu import sfm as jsfm
from kontiki_tpu import trajectories as jt
from kontiki_tpu_torch import interop
from kontiki_tpu_torch import io as tio
from kontiki_tpu_torch import sfm as tsfm
from kontiki_tpu_torch import synthetic
from kontiki_tpu_torch import trajectories as tt
from kontiki_tpu_torch.solver.lm import solve
from kontiki_tpu_torch.solver.problem import Problem

torch.set_num_threads(1)
KINDS = ["UniformR3SplineTrajectory", "UniformSO3SplineTrajectory",
         "UniformSE3SplineTrajectory", "SplitTrajectory"]


def _port_trajectory(kind):
    """A 3 s trajectory of ``kind`` from the port's generators (knots from
    seeds), querying on the CPU; the R3 kind is the split one's R3 spline
    with another t0."""
    if kind == "UniformSO3SplineTrajectory":
        traj = synthetic.make_so3_trajectory(3.0, dt=0.2, seed=1)
    elif kind == "UniformSE3SplineTrajectory":
        traj = synthetic.make_se3_trajectory(3.0, dt=0.25, seed=2)
    else:
        split = synthetic.make_split_trajectory(3.0, dt=0.15, seed=3)
        if kind == "SplitTrajectory":
            return tt.SplitTrajectory(split.R3_spline, split.SO3_spline, device="cpu")
        traj = tt.UniformR3SplineTrajectory(0.15, 0.4, device="cpu")
        for k in split.R3_spline.knots:
            traj.append_knot(k)
        return traj
    kind = "so3" if kind == "UniformSO3SplineTrajectory" else "se3"
    return interop.trajectory_from_numpy(kind, traj.knots, traj.dt, traj.t0, device="cpu")


def _splines(traj):
    if hasattr(traj, "R3_spline"):
        return [traj.R3_spline, traj.SO3_spline]
    return [traj]


def _jax_copy(traj):
    """The same knots, spacings and start times as JAX package objects."""
    if hasattr(traj, "R3_spline"):
        return jt.SplitTrajectory(*(_jax_copy(sp) for sp in _splines(traj)))
    out = getattr(jt, type(traj).__name__)(traj.dt, traj.t0)
    for i in range(len(traj)):
        out.append_knot(traj[i])
    return out


def _assert_same_knots(a, b, se3):
    assert type(a).__name__ == type(b).__name__
    for sa, sb in zip(_splines(a), _splines(b)):
        assert sa.dt == sb.dt and sa.t0 == sb.t0 and len(sa) == len(sb)
        for i in range(len(sa)):
            np.testing.assert_allclose(np.asarray(sa[i]), np.asarray(sb[i]),
                                       atol=1e-12 if se3 else 0, rtol=0)


@pytest.mark.parametrize("kind", KINDS)
def test_trajectory_roundtrip(kind, tmp_path):
    traj = _port_trajectory(kind)
    path = tmp_path / "traj.h5"
    tio.save_trajectory(path, traj)
    loaded = tio.load_trajectory(path, device="cpu")
    assert type(loaded) is type(traj)
    _assert_same_knots(loaded, traj, kind == "UniformSE3SplineTrajectory")
    for sa, sb in zip(_splines(loaded), _splines(traj)):
        if kind != "UniformSE3SplineTrajectory":
            np.testing.assert_array_equal(sa.knots, sb.knots)
    t = np.linspace(traj.min_time, traj.max_time - 1e-9, 7)
    np.testing.assert_allclose(loaded.position(t), traj.position(t), atol=1e-12)
    np.testing.assert_allclose(loaded.orientation(t), traj.orientation(t), atol=1e-12)
    assert tio.load_trajectory(path).device is None  # the card, at query time


@pytest.mark.parametrize("kind", KINDS)
def test_trajectory_exchange_with_jax(kind, tmp_path):
    se3 = kind == "UniformSE3SplineTrajectory"
    traj = _port_trajectory(kind)
    jtraj = _jax_copy(traj)
    tio.save_trajectory(tmp_path / "port.h5", traj)
    jio.save_trajectory(tmp_path / "jax.h5", jtraj)
    _assert_same_knots(jio.load_trajectory(tmp_path / "port.h5"), jtraj, se3)
    _assert_same_knots(tio.load_trajectory(tmp_path / "jax.h5", device="cpu"), traj, se3)
    with h5py.File(tmp_path / "port.h5") as a, h5py.File(tmp_path / "jax.h5") as b:
        names = _visit(a)
        assert set(names) == set(_visit(b))
        for n in names:
            if isinstance(a[n], h5py.Dataset) and not n.endswith("type"):
                np.testing.assert_allclose(a[n][()], b[n][()], atol=1e-12 if se3 else 0,
                                           rtol=0, err_msg=n)
            elif isinstance(a[n], h5py.Dataset):
                assert a[n][()] == b[n][()]


def _visit(f):
    out = []
    f.visit(out.append)
    return out


def _structure(mod, seed, n_views=4, n_landmarks=6):
    rng = np.random.default_rng(seed)
    views = [mod.View(i, i / 30) for i in range(n_views)]
    landmarks = []
    for k in range(n_landmarks):
        lm = mod.Landmark()
        lm.inverse_depth = rng.uniform(0.01, 2)
        obs = [v.create_observation(lm, rng.uniform(0, 1000, size=2)) for v in views[k % 2:]]
        lm.reference = obs[-1] if k % 3 == 0 else obs[0]
        landmarks.append(lm)
    colors = {lm: rng.integers(0, 255, size=3) for lm in landmarks}
    return views, landmarks, colors


def _assert_same_structure(a_landmarks, b_landmarks):
    assert len(a_landmarks) == len(b_landmarks)
    for old, new in zip(a_landmarks, b_landmarks):
        assert new.inverse_depth == old.inverse_depth
        assert len(new.observations) == len(old.observations)
        for o1, o2 in zip(old.observations, new.observations):
            np.testing.assert_array_equal(o1.uv, o2.uv)
            assert o1.view.frame_nr == o2.view.frame_nr and o1.view.t0 == o2.view.t0
        np.testing.assert_array_equal(new.reference.uv, old.reference.uv)
        assert new.reference.view.frame_nr == old.reference.view.frame_nr


@pytest.mark.parametrize("with_colors", [False, True])
def test_structure_roundtrip_and_exchange(with_colors, tmp_path):
    views, landmarks, colors = _structure(tsfm, 0)
    jviews, jlandmarks, jcolors = _structure(jsfm, 0)
    tio.save_structure(tmp_path / "port.h5", landmarks,
                       landmark_colors=colors if with_colors else None)
    jio.save_structure(tmp_path / "jax.h5", jlandmarks,
                       landmark_colors=jcolors if with_colors else None)
    for load, path, want in ((tio.load_structure, "port.h5", landmarks),
                             (tio.load_structure, "jax.h5", landmarks),
                             (jio.load_structure, "port.h5", jlandmarks)):
        new_views, new_landmarks, new_colors = load(tmp_path / path)
        assert [v.frame_nr for v in new_views] == [v.frame_nr for v in views]
        _assert_same_structure(want, new_landmarks)
        if with_colors:
            for old, new in zip(landmarks, new_landmarks):
                np.testing.assert_array_equal(new_colors[new], colors[old])
        else:
            assert new_colors is None


def test_structure_color_count_mismatch_raises(tmp_path):
    views, landmarks, _ = _structure(tsfm, 1)  # the views own the observations
    tio.save_structure(tmp_path / "s.h5", landmarks)
    with h5py.File(tmp_path / "s.h5", "a") as f:
        del f["structure/landmarks/color"]
        f["structure/landmarks/color"] = np.zeros((2, 3))
    with pytest.raises(IOError, match="colors"):
        tio.load_structure(tmp_path / "s.h5")


def test_load_atan_camera_matches_jax(tmp_path):
    path = tmp_path / "camera.h5"
    K = np.array([[480.0, 0.0, 330.0], [0.0, 485.0, 242.0], [0.0, 0.0, 1.0]])
    with h5py.File(path, "w") as f:
        f["size"] = np.array([640, 480])
        f["readout"] = 0.0316
        f["K"] = K
        f["wc"] = np.array([0.51, 0.49])
        f["lgamma"] = 0.87
    cam, jcam = tio.load_atan_camera(path), jio.load_atan_camera(path)
    assert (cam.rows, cam.cols) == (jcam.rows, jcam.cols) == (480, 640)
    assert cam.readout == jcam.readout == 0.0316 and cam.gamma == jcam.gamma == 0.87
    np.testing.assert_array_equal(cam.camera_matrix, jcam.camera_matrix)
    np.testing.assert_array_equal(cam.wc, jcam.wc)
    X = np.array([0.3, -0.2, 2.0])
    np.testing.assert_allclose(cam.project(X), jcam.project(X), rtol=1e-14)


def test_solver_state_checkpoint_and_resume(tmp_path):
    """Checkpoint a 3-iteration solve, resume from the loaded state and
    trust-region radius; the resumed solve ends no higher. The file loads in
    the JAX package's io with equal arrays, and the JAX package's
    checkpoint of the same state loads here."""
    prob = synthetic.make_gyro_problem(duration=2.0, rate=50.0, seed=4)
    traj = interop.trajectory_from_numpy("so3", prob["trajectory"].knots,
                                         prob["trajectory"].dt, prob["trajectory"].t0,
                                         device="cpu")
    problem = Problem(traj, prob["measurements"], device="cpu")
    state, summary = solve(problem, max_iterations=3, function_tolerance=0.0)
    tr = summary.iterations[-1].trust_region_radius

    path = str(tmp_path / "ckpt.h5")
    tio.save_solver_state(path, state, trust_region_radius=tr, iteration=3)
    loaded, meta = tio.load_solver_state(path, device="cpu")
    assert meta == {"iteration": 3, "trust_region_radius": tr}
    assert list(loaded) == list(state)
    for k in state:
        assert loaded[k].dtype == state[k].dtype and loaded[k].device.type == "cpu"
        assert torch.equal(loaded[k], state[k]), k
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tio.load_solver_state(path)  # the card by default, and this machine has none

    jstate, jmeta = jio.load_solver_state(path)
    assert jmeta == meta
    for k in state:
        np.testing.assert_array_equal(np.asarray(jstate[k]), state[k].numpy())
    jio.save_solver_state(str(tmp_path / "jax.h5"),
                          {k: jnp.asarray(v.numpy()) for k, v in state.items()},
                          trust_region_radius=tr, iteration=3)
    back, back_meta = tio.load_solver_state(str(tmp_path / "jax.h5"), device="cpu")
    assert back_meta == meta
    for k in state:
        assert torch.equal(back[k], state[k]), k

    problem.write_back(loaded)
    problem2 = Problem(traj, prob["measurements"], device="cpu")
    _, summary2 = solve(problem2, max_iterations=10, initial_trust_region_radius=tr,
                        function_tolerance=0.0)
    assert summary2.initial_cost == pytest.approx(summary.final_cost, rel=1e-12)
    assert summary2.final_cost <= summary.final_cost * (1 + 1e-9)
