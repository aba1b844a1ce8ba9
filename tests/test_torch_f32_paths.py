"""The float32 tier's plumbing in the port, on the CPU at small sizes (the
solves of ``tests/f32_check.py``'s problems are in
``test_torch_f32_tier.py`` and ``test_torch_f32_tier_ba.py``):

- the generators that build a ``RawProblem`` take ``dtype``: every float
  they place is float32 and equals the float64 problem's value rounded once;
- every entry point that places tensors raises without a card when no
  device is named, whatever the dtype;
- ``interop`` carries the JAX package's arrays into float32 states and raw
  problems; the batch IMU containers and the native helper's activation
  place float32 data; ``TrajectoryEstimator(dtype=torch.float32)`` solves
  in float32 and writes the solution into the float64 host objects;
- the plain versions of B1 (split), B3, B4 (gyro, accel), B2 and B6 in
  float32 on float32 inputs agree with their float64 results to 1e-4
  relative (normwise; the CPU counterpart of ``chip_smoke.py``'s float32
  kernel checks), and return float32;
- the 200-knot gyro band converges through the banded strategy in float32;
- the dense step's ``grad_max`` leaves out a landmark frozen at the rho = 0
  bound, as the JAX package's step does."""
import functools

import numpy as np
import pytest
import torch

from kontiki_tpu_torch import TrajectoryEstimator, interop
from kontiki_tpu_torch.ops import assembly_kernels as ak
from kontiki_tpu_torch.ops import linearize_kernels as lk
from kontiki_tpu_torch.solver import kernels as tk
from kontiki_tpu_torch.solver import schur as tschur
from kontiki_tpu_torch.solver.lm import make_fused_solver
from kontiki_tpu_torch.solver.problem import Problem
from kontiki_tpu_torch.synthetic import (
    make_big_ba_problem,
    make_gyro_band_problem,
    make_gyro_problem,
    make_imu_problem,
    make_long_imu_problem,
    make_rsvi_problem,
)
from test_torch_f32_tier import float_tensors
from test_torch_oracles import on_cpu

torch.set_num_threads(1)
F32, F64 = torch.float32, torch.float64
SMALL5 = dict(n_views=20, n_landmarks=60, obs_per_landmark=3, seed=13, imu_rate=20.0)
KERNEL_RTOL = 1e-4


def _generated(name, dtype, device="cpu"):
    if name == "make_big_ba_problem":
        return make_big_ba_problem(**SMALL5, device=device, dtype=dtype)["problem"]
    return make_gyro_band_problem(n_knots=60, device=device, dtype=dtype)


@pytest.mark.parametrize("name", ["make_big_ba_problem", "make_gyro_band_problem"])
def test_generators_take_dtype(name):
    p32, p64 = _generated(name, F32), _generated(name, F64)
    assert p32.dtype == F32
    got, want = dict(float_tensors(p32)), dict(float_tensors(p64))
    assert set(got) == set(want)
    for k, v in got.items():
        assert v.dtype == F32, k
        np.testing.assert_array_equal(v.numpy(), want[k].numpy().astype(np.float32), err_msg=k)


def _entry_points():
    gen = make_gyro_problem(duration=1.0, rate=20.0, seed=1)
    arrays = interop.raw_problem_arrays(_generated("make_gyro_band_problem", F64))
    return {
        "make_big_ba_problem": lambda: make_big_ba_problem(**SMALL5, dtype=F32),
        "make_gyro_band_problem": lambda: make_gyro_band_problem(n_knots=60, dtype=F32),
        "Problem": lambda: Problem(gen["trajectory"], gen["measurements"], dtype=F32),
        "raw_problem_from_numpy": lambda: interop.raw_problem_from_numpy(**arrays, dtype=F32),
        "state_from_numpy": lambda: interop.state_from_numpy({"so3": arrays["splines"][0][1]},
                                                             dtype=F32),
        "TrajectoryEstimator": lambda: TrajectoryEstimator(gen["trajectory"], dtype=F32).solve(
            max_iterations=1, progress=False),
    }


@pytest.mark.parametrize("name", ["make_big_ba_problem", "make_gyro_band_problem", "Problem",
                                  "raw_problem_from_numpy", "state_from_numpy",
                                  "TrajectoryEstimator"])
def test_entry_points_raise_without_a_card(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the entry points place tensors on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _entry_points()[name]()


def test_interop_carries_jax_arrays_into_float32():
    from kontiki_tpu.synthetic import make_big_ba_problem as jax_make

    J = jax_make(**SMALL5)["problem"]
    state = interop.state_from_numpy({k: np.asarray(v) for k, v in J.state0.items()},
                                     device="cpu", dtype=F32)
    for k, v in state.items():
        assert v.dtype == F32, k
        np.testing.assert_array_equal(v.numpy(), np.asarray(J.state0[k]).astype(np.float32))
    raw = interop.raw_problem_from_numpy(**interop.raw_problem_arrays(J), device="cpu", dtype=F32)
    for k, v in float_tensors(raw):
        assert v.dtype == F32, k
    ours = _generated("make_big_ba_problem", F32)
    np.testing.assert_allclose(tk.total_cost(tk.problem_spec(raw), tk.problem_runtime(raw),
                                             raw.state0).item(),
                               tk.total_cost(tk.problem_spec(ours), tk.problem_runtime(ours),
                                             ours.state0).item(), rtol=1e-5)


def test_batch_containers_place_float32():
    gen = make_long_imu_problem(duration=4.0)
    p32 = Problem(on_cpu(gen["trajectory"]), gen["measurements"], device="cpu", dtype=F32)
    p64 = Problem(on_cpu(gen["trajectory"]), gen["measurements"], device="cpu")
    got, want = dict(float_tensors(p32)), dict(float_tensors(p64))
    assert set(got) == set(want) and len(p32.buckets) == 2
    for k, v in got.items():
        assert v.dtype == F32, k
        np.testing.assert_array_equal(v.numpy(), want[k].numpy().astype(np.float32), err_msg=k)
    assert p32.num_residual_blocks == p64.num_residual_blocks == 1600


def test_estimator_solves_in_float32_and_writes_float64():
    gen = make_imu_problem(duration=1.0, rate=40.0, seed=2, position_rate=5.0)
    traj = on_cpu(gen["trajectory"])
    start = traj.R3_spline.knots.copy()
    est = TrajectoryEstimator(traj, device="cpu", dtype=F32)
    for m in gen["measurements"]:
        est.add_measurement(m)
    summary = est.solve(max_iterations=5, progress=False)
    assert summary.final_cost < 1e-3 * summary.initial_cost
    for sp in (traj.R3_spline, traj.SO3_spline):
        assert sp.knots.dtype == np.float64
    assert not np.array_equal(traj.R3_spline.knots, start)
    assert gen["imu"].accelerometer_bias.dtype == np.float64
    q = traj.SO3_spline.knots
    np.testing.assert_allclose(np.linalg.norm(q, axis=1), 1.0, rtol=1e-15)


@functools.lru_cache(maxsize=None)
def _kernel_inputs():
    """Each plain version's arguments in float64, from a small config-4-like
    problem on the split trajectory (its objects kept: landmarks hold their
    reference observations weakly)."""
    gen = make_rsvi_problem(nviews=6, nlandmarks=10, imu_rate=40.0, seed=3)
    cam = Problem(on_cpu(gen["trajectory"]), gen["measurements"], device="cpu")
    spec, rt = tk.problem_spec(cam), tk.problem_runtime(cam)
    cfg, ins, _ = tk._camera_inputs(spec, rt, cam.state0, rt["data"][0])
    out = {"linearize_rows": (lk.linearize_rows_plain, (cfg, ins)),
           "cost_rows": (lk.cost_rows_plain, (cfg, ins))}
    for b, data in zip(spec.buckets[1:], rt["data"][1:]):
        icfg, iins, _ = tk._imu_inputs(spec, b, rt, cam.state0, data)
        out[f"imu_rows {b.kind}"] = (lk.imu_rows_plain, (icfg, iins))
    _, (Jw, cols, rw, J_rho, lid) = tschur.whitened_rows(
        spec, spec.buckets[0], rt, cam.state0, rt["data"][0],
        torch.ones(spec.num_landmarks, dtype=F64))
    Pc = spec.num_tangent - spec.num_landmarks
    out["assemble_schur_blocks"] = (
        lambda *a: ak.assemble_schur_blocks_plain(*a, P=Pc, L=spec.num_landmarks, with_rho=True),
        (Jw, cols, rw, J_rho, lid))
    rel = torch.randint(-2, 40, cols.shape, generator=torch.Generator().manual_seed(0))
    out["onehot_expand_rows"] = (lambda J, r: lk.onehot_expand_rows_plain(J, r, 38), (Jw, rel))
    out["objects"] = gen
    return out


def _cast(x, dtype):
    if isinstance(x, dict):
        return {k: _cast(v, dtype) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(_cast(v, dtype) for v in x)
    if torch.is_tensor(x) and x.is_floating_point():
        return x.to(dtype)
    return x


def _flat(x):
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _flat(v)]
    return [x] if torch.is_tensor(x) else []


@pytest.mark.parametrize("kernel", ["linearize_rows", "cost_rows", "imu_rows gyro",
                                    "imu_rows accel", "assemble_schur_blocks",
                                    "onehot_expand_rows"])
def test_plain_kernels_in_float32(kernel):
    fn, args = _kernel_inputs()[kernel]
    want = _flat(fn(*args))
    got = _flat(fn(*_cast(args, F32)))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.dtype == F32 and g.shape == w.shape
        scale = w.abs().max().item()
        err = (g.double() - w).abs().max().item()
        assert err <= KERNEL_RTOL * scale, (kernel, err, scale)


def test_gyro_band_converges_in_float32():
    p = make_gyro_band_problem(n_knots=200, device="cpu", dtype=F32)
    state, cost, it = make_fused_solver(p, 5, function_tolerance=0.0, strategy="banded")(
        p.state0)
    cost0 = make_fused_solver(p, 0, strategy="banded")(p.state0)[1]
    assert it == 5 and cost.dtype == F32
    assert cost.item() < 1e-6 * cost0.item()
    assert all(v.dtype == F32 for v in state.values())


def test_grad_max_leaves_out_frozen_landmarks():
    """Every landmark put at rho = 0: those whose gradient points outward
    (g > 0) are frozen for the step, and ``grad_max`` is max |g| over the
    other columns."""
    gen = make_rsvi_problem(nviews=6, nlandmarks=10, imu_rate=0.0, seed=3, perturb_rho=0.1)
    p = Problem(on_cpu(gen["trajectory"]), gen["measurements"], device="cpu")
    spec, rt = tk.problem_spec(p), tk.problem_runtime(p)
    parts = tk.build_parts(spec)
    state = dict(p.state0, rho=torch.zeros_like(p.state0["rho"]))
    _, _, g = parts["linearize"](rt, state)
    lo, L = spec.landmark_offset, spec.num_landmarks
    frozen = g[lo:lo + L] > 0
    assert 0 < int(frozen.sum()) < L
    free = torch.ones_like(g)
    free[lo:lo + L] = (~frozen).to(g.dtype)
    want = (g * free).abs().max()
    assert parts["grad_max"](state, g) == want
    assert parts["step"](rt, state, 1e-4)[5] == want
