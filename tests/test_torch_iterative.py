"""``solver.iterative`` (matrix-free iterative Schur) against the JAX
package's, in float64 on the CPU:

- one ``make_iterative_step`` step at ``cg_tol=1e-14`` on
  ``make_rsvi_problem(nviews=6, nlandmarks=12, imu_rate=60.0, seed=9)``
  (split trajectory, camera, gyro and accel rows; the JAX package's
  ``tests/test_iterative.py`` problem) at lam 1e-4 and 1e-1: cost, new
  cost, predicted decrease and max |gradient| to 1e-9 relative, the new
  state and the step to 1e-8 absolute (converged CG on both sides; the
  dense solves inside differ only by roundoff);
- ``_bucket_layout`` kind by kind against the JAX package's on the same
  problems (camera, lifting, Newton, gyro, accel, position, orientation
  rows), and ``duplicate_cross_diag`` against the JAX function on the
  camera rows, on rows whose ref and obs windows alias at every shift and
  on rows with ``valid = 0``, and against the diagonal of each row's
  ``J^T J`` with duplicate columns summed (1e-12);
- on an IMU problem without landmarks the port's dense step (delta to
  1e-5 relative / 1e-9 absolute, pred to 1e-6, as the JAX test holds its
  two steps);
- PCG's chunked loop: the iterates and the count do not depend on the
  chunk length;
- CG cut short, by its cap after 5 iterations or by a loose tolerance
  (1e-2, 7 iterations), on a lifting problem with the sensors unlocked (6
  views, 12 landmarks, 40 Hz IMU rows, seed 29): the step then depends on
  the per-knot and per-sensor blocks and the vt columns' point Jacobi, so
  the count (exactly), cost, new cost, pred and max |gradient| (1e-9
  relative) and the step and the state (1e-9 absolute) pin the
  preconditioner to the JAX package's. Past ~10 iterations CG is
  roundoff-chaotic on this problem: a 1e-15 change of its right-hand side
  moves the step 3e-11 at 10 iterations, 7e-7 at 20 and 3e-3 at 40
  (``tools/solver_accuracy.py``).
"""
import functools

import jax
import numpy as np
import pytest
import torch

from kontiki_tpu.solver import iterative as jit_
from kontiki_tpu.solver import kernels as jk
from kontiki_tpu_torch.solver import iterative as tit
from kontiki_tpu_torch.solver import kernels as tk
from kontiki_tpu_torch.solver.problem import Problem
from kontiki_tpu_torch.synthetic import make_imu_problem, make_rsvi_problem
from test_torch_iterative_rows import ROWS
from test_torch_pose import _fit
from test_torch_split_camera import twin_pair

torch.set_num_threads(1)
CG = dict(cg_tol=1e-14, cg_maxiter=2000)


@functools.lru_cache(maxsize=None)
def pair(**kw):
    gen = make_rsvi_problem(**kw)
    return twin_pair(gen["trajectory"], gen["measurements"])


def camera():
    return pair(nviews=6, nlandmarks=12, imu_rate=60.0, seed=9)


@functools.lru_cache(maxsize=None)
def steps():
    J, T = camera()["jax"], camera()["torch"]
    return jit_.make_iterative_step(J, **CG), tit.make_iterative_step(T, **CG)


def _rel(got, want):
    return abs(got - want) / abs(want)


@pytest.mark.parametrize("lam", [1e-4, 1e-1])
def test_step_matches_jax(lam):
    (jstep, jcost), (tstep, tcost) = steps()
    J, T = camera()["jax"], camera()["torch"]
    want, got = jstep(J.state0, lam), tstep(T.state0, lam)
    for i, name in ((0, "cost"), (2, "new cost"), (3, "pred"), (5, "grad_max")):
        assert _rel(got[i].item(), float(want[i])) <= 1e-9, name
    np.testing.assert_allclose(got[4].numpy(), np.asarray(want[4]), rtol=0, atol=1e-8)
    assert set(got[1]) == set(want[1])
    for k, v in got[1].items():
        np.testing.assert_allclose(v.numpy(), np.asarray(want[1][k]), rtol=0, atol=1e-8,
                                   err_msg=k)
    assert _rel(tcost(T.state0).item(), float(jcost(J.state0))) <= 1e-12


def _layout_problems():
    """Per kind: the (port, JAX) problems that hold such a bucket."""
    start, ms, jt, jms = _fit()
    from kontiki_tpu.solver.problem import Problem as JProblem

    pose = dict(torch=Problem(start, ms, device="cpu"), jax=JProblem(jt, jms))
    lifting = pair(nviews=4, nlandmarks=8, imu_rate=0.0, seed=29, rs="lifting")
    newton = pair(nviews=4, nlandmarks=8, imu_rate=0.0, seed=21, rs="newton")
    se3 = pair(nviews=4, nlandmarks=8, imu_rate=40.0, seed=9, trajectory="se3")
    return {"rs_static": camera(), "gyro": camera(), "accel": camera(),
            "rs_lifting": lifting, "rs_newton": newton, "position": pose,
            "orientation": pose, "se3": se3}


@pytest.mark.parametrize("kind", ["rs_static", "gyro", "accel", "rs_lifting", "rs_newton",
                                  "position", "orientation", "se3"])
def test_bucket_layout_matches_jax(kind):
    p = _layout_problems()[kind]
    tspec, jspec = tk.problem_spec(p["torch"]), jk.problem_spec(p["jax"])
    seen = 0
    for tb, jb in zip(tspec.buckets, jspec.buckets):
        assert tb.kind == jb.kind
        if kind != "se3" and tb.kind != kind:
            continue
        want = jit_._bucket_layout(jspec, jb, jk._make_residual(jspec, jb)[1])
        got = tit._bucket_layout(tspec, tb)
        assert tuple(got) == tuple(want), tb.kind
        seen += 1
    assert seen


def _brute_diag(Jw, cols, n):
    """diag(sum_rows J_row^T J_row) with duplicate column ids summed per row."""
    out = np.zeros(n)
    for J, c in zip(Jw, cols):
        dense = np.zeros((J.shape[0], n))
        np.add.at(dense, (slice(None), c), J)
        out += np.sum(dense * dense, axis=0)
    return out


def _aliasing_rows(seed=0):
    """Rows with a ref and an obs 4-knot window on one R3 spline (td 3) and
    a sensor block, the obs window shifted by -5..5 knots (aliasing by 0 to
    3 knots, or not at all), every fourth row at valid = 0 (zero Jacobian)."""
    rng = np.random.default_rng(seed)
    shifts = np.arange(-5, 6)
    M, rdim, C = len(shifts) * 4, 2, 2 * 12 + 13
    base = rng.integers(5, 20, size=M)
    obs = base + np.repeat(shifts, 4)
    cols = np.concatenate([base[:, None] * 3 + np.arange(12), obs[:, None] * 3 + np.arange(12),
                           100 + np.zeros((M, 1), np.int64) + np.arange(13)], axis=1)
    Jw = rng.normal(size=(M, rdim, C))
    Jw[::4] = 0.0
    layout = tit._BucketLayout(((0, 0, 4, 3), (12, 0, 4, 3)), 24, C)
    return Jw, cols, layout


@pytest.mark.parametrize("rows", ["aliasing", "camera"])
def test_duplicate_cross_diag_matches_jax(rows):
    if rows == "aliasing":
        Jw, cols, layout = _aliasing_rows()
        n = 113
    else:
        T = camera()["torch"]
        spec = tk.problem_spec(T)
        _, blocks = tit.build_iterative_parts(spec)["linearize"](tk.problem_runtime(T),
                                                                 T.state0)
        blk, b = blocks[0], spec.buckets[0]
        assert b.kind == "rs_static"
        Jw, cols, layout = blk["Jw"].numpy(), blk["cols"].numpy(), tit._bucket_layout(spec, b)
        n = spec.num_tangent - spec.num_landmarks
        shift = (cols[:, 12 * 0 + 24] - cols[:, 0]) // 3  # obs - ref base on the R3 spline
        assert (np.abs(shift) < 4).any()  # some rows alias
    got = tit.duplicate_cross_diag({"Jw": torch.from_numpy(Jw), "cols": torch.from_numpy(cols)},
                                   layout).numpy()
    want = np.asarray(jit_.duplicate_cross_diag(
        {"Jw": jax.numpy.asarray(Jw), "cols": jax.numpy.asarray(cols)}, layout, np.float64))
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * scale)
    diag = np.zeros(n)
    np.add.at(diag, cols.reshape(-1), (np.sum(Jw ** 2, axis=1) + got).reshape(-1))
    brute = _brute_diag(Jw, cols, n)
    np.testing.assert_allclose(diag, brute, rtol=0, atol=1e-12 * np.abs(brute).max())
    if rows == "aliasing":
        assert not got[::4].any()  # valid = 0 rows add nothing


def test_step_matches_dense_without_landmarks():
    gen = make_imu_problem(duration=2.5, rate=60.0, seed=4)
    T = Problem(gen["trajectory"], gen["measurements"], device="cpu")
    spec, rt = tk.problem_spec(T), tk.problem_runtime(T)
    dense = tk.build_parts(spec)["step"](rt, T.state0, 1e-3)
    it = tit.make_iterative_step(T, **CG)[0](T.state0, 1e-3)
    assert _rel(it[0].item(), dense[0].item()) <= 1e-12
    np.testing.assert_allclose(it[4].numpy(), dense[4].numpy(), rtol=1e-5, atol=1e-9)
    assert _rel(it[3].item(), dense[3].item()) <= 1e-6


def test_pcg_chunks_are_invisible():
    """PCG's iterates and count equal those of a loop that tests its
    condition every iteration (chunk 1), whatever the chunk length."""
    rng = np.random.default_rng(3)
    A = rng.normal(size=(40, 40))
    A = torch.from_numpy(A @ A.T + 0.5 * np.eye(40))
    b = torch.from_numpy(rng.normal(size=40))
    d = torch.diagonal(A)
    for tol, maxiter in ((1e-8, 500), (1e-30, 17)):
        runs = [tit.pcg(lambda x: A @ x, lambda r: r / d, b, tol, maxiter, chunk=c)
                for c in (1, 3, 10)]
        for x, k in runs[1:]:
            assert int(k) == int(runs[0][1])
            assert torch.equal(x, runs[0][0])
    assert int(runs[0][1]) == 17  # stopped by maxiter



@functools.lru_cache(maxsize=None)
def free_sensor_lifting():
    """A lifting problem whose camera pose and time offset and IMU
    orientation are free (the generator locks them)."""
    gen = make_rsvi_problem(rs="lifting", seed=29, **ROWS)
    for lock in ("relative_orientation_locked", "relative_position_locked",
                 "time_offset_locked"):
        setattr(gen["camera"], lock, False)
    gen["imu"].relative_orientation_locked = False
    return twin_pair(gen["trajectory"], gen["measurements"])


@pytest.mark.parametrize("cg", [dict(cg_tol=1e-14, cg_maxiter=5),
                                dict(cg_tol=1e-2, cg_maxiter=500)], ids=["cap", "tolerance"])
def test_truncated_pcg_matches_jax(cg):
    p = free_sensor_lifting()
    J, T = p["jax"], p["torch"]
    want = jit_.make_iterative_step(J, **cg)[0](J.state0, 1e-4)
    got = tit.make_iterative_step(T, **cg)[0](T.state0, 1e-4)
    for i, name in ((0, "cost"), (2, "new cost"), (3, "pred"), (5, "grad_max")):
        assert _rel(got[i].item(), float(want[i])) <= 1e-9, name
    np.testing.assert_allclose(got[4].numpy(), np.asarray(want[4]), rtol=0, atol=1e-9)
    for k, v in got[1].items():
        np.testing.assert_allclose(v.numpy(), np.asarray(want[1][k]), rtol=0, atol=1e-9,
                                   err_msg=k)
    for k in ("q_ct", "p_ct", "d", "vt"):
        assert not torch.equal(got[1][k], T.state0[k]), k
    jparts = jit_.build_iterative_parts(jk.problem_spec(J), True)
    jrt = jk.problem_runtime(J)
    jcount = jax.jit(lambda rt, s: jparts["schur_solve"](
        rt, jparts["linearize"](rt, s)[1], 1e-4, cg["cg_tol"], cg["cg_maxiter"], state=s)[1])
    tparts = tit.build_iterative_parts(tk.problem_spec(T))
    trt = tk.problem_runtime(T)
    tcount = tparts["schur_solve"](trt, tparts["linearize"](trt, T.state0)[1], 1e-4, cg["cg_tol"],
                                   cg["cg_maxiter"], state=T.state0)[1]
    assert int(tcount) == int(jcount(jrt, J.state0))
    assert int(tcount) == 5 if cg["cg_maxiter"] == 5 else 5 < int(tcount) < 500
