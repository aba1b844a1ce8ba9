"""Port parity, problem compilation and bounds with the atan camera and
lifting rows, against ``kontiki_tpu`` in float64, on config 3-atan's and
config 3-atan-lifting's model cut to the JAX tests' small problem
(``tests/test_torch_atan_lifting_rows.py``'s, camera pose and offset free,
offset bound 0.01):

- ``Problem``: bucket keys and kinds, the tangent layout (``vt_offset``
  after the landmarks), ``state0`` with ``vt``, the mask (vt always free),
  ``d_max``, the bucket data (``wc``, ``gamma``, ``vt_idx``, ``vt_orig``)
  and the Ceres counts; ``problem_spec``'s ``vt_offset`` and ``num_vt``;
- the test twin carries the camera's offset bound (0.01, not the default
  0.1): the JAX problem's ``d_max`` and its clamp of the offset;
- ``project_delta`` and ``_retract_state`` on a step that pushes ``vt``
  below 0 and above 1, an offset past its bound and an inverse depth below
  0: equal to the JAX package's, vt in [0, 1];
- ``TrajectoryEstimator`` writes the solved ``vt`` back into the lifting
  measurements;
- ``parallel.make_segment_ba_step`` rejects lifting rows in banded mode, as
  the JAX package's does.

Tolerance: exact where the arrays are copied; 1e-12 on floats."""
import numpy as np
import pytest
import torch

from kontiki_tpu.solver import kernels as jk
from kontiki_tpu_torch import TrajectoryEstimator
from kontiki_tpu_torch.parallel import make_segment_ba_step
from kontiki_tpu_torch.solver import kernels as tk
from kontiki_tpu_torch.solver.problem import Problem
from kontiki_tpu_torch.synthetic import make_rsvi_problem
from test_torch_atan_lifting_rows import atan_lifting_pair

torch.set_num_threads(1)
COUNTS = ("num_parameters", "num_parameter_blocks", "num_parameters_reduced",
          "num_parameter_blocks_reduced", "num_residuals", "num_residual_blocks",
          "num_residuals_reduced", "num_residual_blocks_reduced")
OFFSETS = ("sensor_offset", "landmark_offset", "vt_offset", "num_tangent")


@pytest.fixture(scope="module", params=["static", "lifting"])
def pair(request):
    return request.param, atan_lifting_pair("split", rs=request.param)


def test_problem_matches_jax(pair):
    rs, p = pair
    J, T = p["jax"], p["torch"]
    key = f"rs_{rs}:AtanCamera"
    assert list(T.buckets) == list(J.buckets) == [key]
    assert T.buckets[key].rdim == J.buckets[key].rdim == (3 if rs == "lifting" else 2)
    for name in OFFSETS:
        assert getattr(T, name) == getattr(J, name), name
    assert T.vt_offset == T.landmark_offset + len(T.landmarks)
    V = len(T.measurements) if rs == "lifting" else 0
    assert T.num_tangent - T.vt_offset == V
    assert set(T.state0) == set(J.state0)
    for k, v in T.state0.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(J.state0[k]), rtol=0, atol=1e-12,
                                   err_msg=k)
    assert T.state0["vt"].shape == (V,)
    np.testing.assert_array_equal(T.mask.numpy(), np.asarray(J.mask))
    assert torch.all(T.mask[T.vt_offset:] == 1.0)
    np.testing.assert_array_equal(T.d_max.numpy(), np.asarray(J.d_max))
    for name in COUNTS:
        assert getattr(T, name) == getattr(J, name), name
    tdata, jdata = T.buckets[key].data, J.buckets[key].data
    assert set(tdata) == set(jdata)
    assert {"wc", "gamma"} <= set(tdata)
    assert ({"vt_idx", "vt_orig"} <= set(tdata)) == (rs == "lifting")
    for k, v in tdata.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(jdata[k]), rtol=0, atol=1e-12,
                                   err_msg=k)
    spec, jspec = p["tspec"], p["jspec"]
    assert (spec.vt_offset, spec.num_vt) == (jspec.vt_offset, jspec.num_vt)
    assert [(b.kind, b.camera, b.M, b.rdim) for b in spec.buckets] == [
        (b.kind, b.camera, b.M, b.rdim) for b in jspec.buckets]


def test_twin_carries_the_offset_bound(pair):
    """The port's camera bounds its offset at 0.01; the JAX twin must too,
    or the two problems clamp the offset in different boxes."""
    _, p = pair
    assert p["torch"].d_max.tolist() == [0.01]
    assert np.asarray(p["jax"].d_max).tolist() == [0.01]
    spec, jspec = p["tspec"], p["jspec"]
    delta = torch.zeros(spec.num_tangent, dtype=torch.float64)
    delta[spec.sensor_offset + 6] = 0.5
    got = tk.project_delta(spec, p["rt"], p["state"], delta)
    want = jk.project_delta(jspec, p["jrt"], p["jax"].state0, delta.numpy())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-15)
    assert got[spec.sensor_offset + 6].item() == pytest.approx(0.01 - p["state"]["d"][0].item())


def _wild_step(spec, state, seed):
    """A step that moves every tangent a little, pushes half the row times
    below 0 and half above 1, the offset past its bound and every inverse
    depth below 0."""
    rng = np.random.default_rng(seed)
    delta = 1e-3 * rng.normal(size=spec.num_tangent)
    delta[spec.sensor_offset + 6] = 0.3
    lo, L = spec.landmark_offset, spec.num_landmarks
    delta[lo:lo + L] = -2.0 * state["rho"].numpy() - 0.1
    vo, V = spec.vt_offset, spec.num_vt
    vt = state["vt"].numpy()
    delta[vo:vo + V] = np.where(np.arange(V) % 2 == 0, -vt - 0.2, 1.2 - vt)
    return delta


def test_bounds_match_jax(pair):
    rs, p = pair
    spec, jspec, state = p["tspec"], p["jspec"], p["state"]
    delta = _wild_step(spec, state, seed=5)
    got = tk.project_delta(spec, p["rt"], state, torch.tensor(delta))
    want = np.asarray(jk.project_delta(jspec, p["jrt"], p["jax"].state0, delta))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-15)
    new = tk._retract_state(spec, p["rt"], state, torch.tensor(delta))
    jnew = jk._retract_state(jspec, p["jrt"], p["jax"].state0, delta)
    for k, v in new.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(jnew[k]), rtol=0, atol=1e-12,
                                   err_msg=k)
    if rs == "lifting":
        vt = new["vt"]
        assert vt.min().item() == 0.0 and vt.max().item() == 1.0
        assert torch.all((vt == 0.0) | (vt == 1.0))
        projected = state["vt"] + got[spec.vt_offset:]
        torch.testing.assert_close(projected, vt, rtol=0, atol=1e-15)
    assert new["rho"].min().item() == 0.0
    assert abs(new["d"][0].item()) == pytest.approx(0.01)


def test_estimator_writes_vt_back():
    """The solved row times land in the lifting measurements; a problem
    rebuilt from them starts at the solution."""
    gen = make_rsvi_problem(nviews=6, nlandmarks=9, imu_rate=0.0, seed=41, perturb_rho=0.1,
                            camera_kind="atan", rs="lifting")
    ms = gen["measurements"]
    before = np.array([m.vt for m in ms])
    np.testing.assert_array_equal(before, [m.vt_orig for m in ms])
    estimator = TrajectoryEstimator(gen["trajectory"], device="cpu")
    for m in ms:
        estimator.add_measurement(m)
    summary = estimator.solve(max_iterations=8, progress=False, function_tolerance=0.0)
    assert summary.num_successful_steps > 1
    after = np.array([m.vt for m in ms])
    assert not np.array_equal(after, before)
    assert after.min() >= 0.0 and after.max() <= 1.0
    rebuilt = Problem(gen["trajectory"], ms, device="cpu")
    np.testing.assert_array_equal(rebuilt.state0["vt"].numpy(), after)
    cost = tk.total_cost(tk.problem_spec(rebuilt), tk.problem_runtime(rebuilt), rebuilt.state0)
    assert cost.item() == pytest.approx(summary.final_cost, rel=1e-12)


def test_segment_ba_rejects_lifting_rows():
    with pytest.raises(ValueError, match="mode='pcg'"):
        make_segment_ba_step(atan_lifting_pair("split")["torch"])
