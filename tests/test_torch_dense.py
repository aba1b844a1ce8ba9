"""Port parity: the dense strategy (``solver.kernels.build_parts``:
``total_cost``, ``linearize`` -> (cost, H, g), ``damped_solve`` and the
classic ``step``) of ``kontiki_tpu_torch`` against
``kontiki_tpu.solver.kernels.build_parts`` in float64, on a config-2-shaped
problem (``make_imu_problem``: split R3/SO3 trajectory, gyro + accel rows,
unlocked nonzero biases) cut to 1 s at 40 Hz, with its IMU's time offset
unlocked and nonzero. The JAX side is the port's generated problem
rebuilt with the JAX package's classes; the two generators' knot and bias
draws are held to each other on the seed.

On the CPU the JAX package takes its generic vmapped ``jacfwd`` path for
these rows, and the port runs B4's plain version, so H and g also pin the
port's gather, window bases and column ids. Costs, H and g agree to 1e-9
(relative to max |jax| per block); the step solves a system damped by
1e-4 whose two LU solves agree to 1e-7. The JAX step is JAX ``step``'s
own sequence (``linearize``, ``damped_solve``, ``project_delta``,
``_retract_state``, ``total_cost``) in three compiled pieces, so that
``linearize`` and ``total_cost`` also serve the tests of their own."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kontiki_tpu.ops import linearize_kernels as jlk
from kontiki_tpu.solver import kernels as jk
from kontiki_tpu.synthetic import make_split_trajectory as jax_split_trajectory
from kontiki_tpu.synthetic import perturb_trajectory as jax_perturb
from kontiki_tpu_torch import interop
from kontiki_tpu_torch.solver import kernels as tk
from kontiki_tpu_torch.solver.problem import Problem as TProblem
from kontiki_tpu_torch.synthetic import make_gyro_problem, make_imu_problem
from test_torch_dense_solve import jax_problem_from

torch.set_num_threads(1)
SMALL = dict(duration=1.0, rate=40.0, seed=2, noise=0.01)
LAM = 1e-4  # 1 / the initial trust-region radius


def _close(got, want, name, tol=1e-9):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, name
    if not want.size:
        return
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * np.abs(want).max(),
                               err_msg=name)


@functools.lru_cache(maxsize=None)
def _pair():
    gen = make_imu_problem(**SMALL)
    gen["imu"].max_time_offset = 0.01
    gen["imu"].time_offset = 0.004
    gen["imu"].time_offset_locked = False
    J = jax_problem_from(gen)
    T = TProblem(gen["trajectory"], gen["measurements"], device="cpu")
    jspec = jk.problem_spec(J)
    jparts = jk.build_parts(jspec, True)
    jrt = jk.problem_runtime(J)
    lin = jax.jit(jparts["linearize"])(jrt, J.state0)
    cost, H, g = lin

    @jax.jit
    def damped_step(rt, state, H, g):
        delta = jk.project_delta(jspec, rt, state,
                                 jk.damped_solve(rt["mask"], H, g, jnp.asarray(LAM)))
        pred = -(g @ delta + 0.5 * delta @ (H @ delta))
        return delta, pred, jk._retract_state(jspec, rt, state, delta)

    delta, pred, new_state = damped_step(jrt, J.state0, H, g)
    new_cost = jax.jit(jparts["total_cost"])(jrt, new_state)
    return dict(gen=gen, J=J, T=T, lin=lin, step=(cost, new_state, new_cost, pred, delta),
                parts=tk.build_parts(tk.problem_spec(T)), rt=tk.problem_runtime(T))


@pytest.fixture(scope="module")
def pair():
    return _pair()


def test_generator_matches_jax(pair):
    gen = pair["gen"]
    true = jax_split_trajectory(2.0, seed=2)
    start = jax_perturb(true, sigma_p=0.05, sigma_q=0.02, seed=3)
    for ours, theirs in ((gen["true_trajectory"], true), (gen["trajectory"], start)):
        np.testing.assert_array_equal(ours.R3_spline.knots, theirs.R3_spline.knots)
        np.testing.assert_array_equal(ours.SO3_spline.knots, theirs.SO3_spline.knots)
    rng = np.random.default_rng(2 + 7)  # make_imu_problem's bias draws
    np.testing.assert_array_equal(gen["imu"].accelerometer_bias, rng.normal(scale=0.05, size=3))
    np.testing.assert_array_equal(gen["imu"].gyroscope_bias, rng.normal(scale=0.01, size=3))


def test_structure_and_state0_match(pair):
    J, T = pair["J"], pair["T"]
    js, ts = jk.problem_spec(J), tk.problem_spec(T)
    assert ts.splines == js.splines
    assert [(b.kind, b.M, b.windows) for b in ts.buckets] == [
        (b.kind, b.M, b.windows) for b in js.buckets]
    assert ts.num_tangent == js.num_tangent
    np.testing.assert_array_equal(pair["rt"]["mask"].numpy(), np.asarray(jk.problem_runtime(J)["mask"]))
    for k, v in T.state0.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(J.state0[k]), err_msg=k)
    assert T.state0["d"].item() == 0.004 and T.state0["abias"].abs().min() > 0


def test_linearize_matches_jax(pair):
    got = pair["parts"]["linearize"](pair["rt"], pair["T"].state0)
    for name, g, w in zip(("cost", "H", "g"), got, pair["lin"]):
        _close(g, w, name)


def test_total_cost_matches_jax(pair):
    parts, rt = pair["parts"], pair["rt"]
    _close(parts["total_cost"](rt, pair["T"].state0), pair["lin"][0], "cost at state0")
    jstate = {k: torch.tensor(np.asarray(v)) for k, v in pair["step"][1].items()}
    _close(parts["total_cost"](rt, jstate), pair["step"][2], "cost at the JAX candidate")
    assert pair["step"][2] < pair["lin"][0]


def test_damped_solve_matches_jax(pair):
    _, H, g = (np.asarray(a) for a in pair["lin"])
    mask = np.asarray(jk.problem_runtime(pair["J"])["mask"])
    want = jk.damped_solve(jnp.asarray(mask), jnp.asarray(H), jnp.asarray(g), LAM)
    got = tk.damped_solve(torch.tensor(mask), torch.tensor(H), torch.tensor(g), LAM)
    _close(got, want, "delta", tol=1e-7)


def test_step_matches_jax(pair):
    cost, state, new_cost, pred, delta, grad_max = pair["parts"]["step"](
        pair["rt"], pair["T"].state0, torch.tensor(LAM))
    jcost, jstate, jnew_cost, jpred, jdelta = pair["step"]
    _close(cost, jcost, "cost")
    _close(grad_max, np.abs(np.asarray(pair["lin"][2])).max(), "grad_max")
    _close(delta, jdelta, "delta", tol=1e-7)
    _close(pred, jpred, "pred", tol=1e-7)
    _close(new_cost, jnew_cost, "new cost", tol=1e-7)
    for k, v in state.items():
        _close(v, jstate[k], k, tol=1e-7)


def test_interop_carries_split_state_biases_and_runtime(pair):
    """The JAX package's R3/SO3 knots, biases and IMU runtime, carried into
    the port as numpy, equal the port's own and linearize alike."""
    J, T = pair["J"], pair["T"]
    state = interop.state_from_numpy({k: np.asarray(v) for k, v in J.state0.items()},
                                     device="cpu")
    for k in ("r3", "so3", "abias", "gbias", "d"):
        assert torch.equal(state[k], T.state0[k]), k
    rt = interop.runtime_from_numpy(jax.tree_util.tree_map(np.asarray, jk.problem_runtime(J)),
                                    device="cpu")
    assert rt["data"][0]["sid"].dtype == torch.int64
    got = pair["parts"]["linearize"](rt, state)
    for name, g, w in zip(("cost", "H", "g"), got, pair["lin"]):
        _close(g, w, name)


@pytest.mark.parametrize("which,kind", [("split", "gyro"), ("split", "accel"), ("so3", "gyro")])
def test_imu_gather_and_column_ids_match_jax(pair, monkeypatch, which, kind):
    """B4's inputs (windows, interpolation amounts, dts, y, weights, biases)
    and column ids from the port's gather against the JAX package's own
    ``_imu_rows_fused``, with its row function replaced by a recorder (the
    JAX gather and column code run; ``_tile_imu`` does not)."""
    if which == "split":
        J, T = pair["J"], pair["T"]  # unlocked time offset 0.004, biases
    else:
        gen = make_gyro_problem(duration=1.0, rate=40.0, seed=1)
        J, T = jax_problem_from(gen), TProblem(gen["trajectory"], gen["measurements"],
                                                device="cpu")
    seen = {}

    def record(cfg, ins, backend="auto", cost_only=False):
        seen.update(cfg=cfg, ins=ins)
        M = ins["y"].shape[1]
        return jnp.zeros((M, 3)), jnp.zeros((M, 3, (12 if cfg["so3_only"] else 24) + 13))

    monkeypatch.setattr(jlk, "imu_rows", record)
    jspec, jrt = jk.problem_spec(J), jk.problem_runtime(J)
    (i,) = [i for i, b in enumerate(jspec.buckets) if b.kind == kind]
    _, _, jcols = jk._imu_rows_fused(jspec, jspec.buckets[i], jrt, J.state0, jrt["data"][i],
                                     cost_only=False)
    tspec, trt = tk.problem_spec(T), tk.problem_runtime(T)
    cfg, ins, _ = tk._imu_inputs(tspec, tspec.buckets[i], trt, T.state0, trt["data"][i])
    _, _, cols = tk._imu_rows_fused(tspec, tspec.buckets[i], trt, T.state0, trt["data"][i])
    assert cfg == seen["cfg"]
    assert sorted(ins) == sorted(seen["ins"])
    for k, v in ins.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(seen["ins"][k]), rtol=1e-15,
                                   atol=1e-15, err_msg=k)
    np.testing.assert_array_equal(cols.numpy(), np.asarray(jcols))
