"""Port parity: the trajectory queries of ``kontiki_tpu_torch`` against
``kontiki_tpu`` in float64.

- B5's plain version (``evaluate_windows_plain``, the window functions
  batched) against the JAX ``evaluate_windows(..., backend="xla")`` at the
  JAX test's own tolerances (tests/test_linearize_kernel.py), and B5's row
  code built for the host against the plain version at 1e-12;
- B7's plain version against the JAX ``r3_evaluate_pallas`` in interpret
  mode on one 256-time chunk (1e-12) and against scipy's ``BSpline`` in
  unsorted order (the JAX test's 1e-9 / 1e-8 / 1e-7), B7's host row code at
  1e-12 on shuffled times and on a span wider than the TPU kernel's
  512-knot slice, and against the JAX ``spline_eval.r3_evaluate`` at 1e-12
  about its kernel's blocks (sorted, shuffled, clamped ends, one window);
- every trajectory kind's queries, ``from_world``/``to_world``, SE3
  ``evaluate``, ``extend_to``, ``__setitem__`` and the range errors against
  JAX objects holding the same knots (``interop.trajectory_from_numpy``),
  at 1e-12;
- ``utils.safe_time``/``safe_time_span`` and ``synthetic.trajectory_ate``/
  ``trajectory_aoe`` against the JAX package's (1e-12 relative);
- a trajectory with the default device raises without a CUDA card.

Inputs come from numpy seeds. Queries name ``device="cpu"``.
"""
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.interpolate import BSpline

from kontiki_tpu import synthetic as jsyn
from kontiki_tpu import utils as jutils
from kontiki_tpu.ops import r3_evaluate_pallas
from kontiki_tpu.ops.linearize_kernels import evaluate_windows as jax_evaluate_windows
from kontiki_tpu.trajectories import spline_eval as jax_spline_eval
from kontiki_tpu.trajectories import (
    SplitTrajectory as JSplit,
    UniformR3SplineTrajectory as JR3,
    UniformSE3SplineTrajectory as JSE3,
    UniformSO3SplineTrajectory as JSO3,
)
from kontiki_tpu_torch import interop, synthetic, utils
from kontiki_tpu_torch.ops import linearize_kernels as lk
from kontiki_tpu_torch.ops import spline_kernels as sk
from kontiki_tpu_torch.rotations import axis_angle_to_quat, quat_mult

torch.set_num_threads(1)
TOL = 1e-12
QUERIES = ("position", "velocity", "acceleration", "orientation", "angular_velocity")
#: times per batched query everywhere, so each JAX query compiles once per kind
B = 8
#: the JAX test's (rtol, atol) per output, tests/test_linearize_kernel.py
JAX_TOLS = {
    "r3": ((1e-12, 0.0), (1e-10, 1e-12), (1e-9, 1e-11)),
    "so3": ((1e-9, 1e-11), (1e-8, 1e-10)),
    "se3": ((1e-9, 1e-11), (1e-8, 1e-10), (1e-7, 1e-9), (1e-9, 1e-11), (1e-8, 1e-10)),
}


def _quats(n, rng, wmag):
    q = np.array([1.0, 0.0, 0.0, 0.0])
    out = []
    for _ in range(n):
        axis = rng.normal(size=3)
        q = quat_mult(axis_angle_to_quat(axis / np.linalg.norm(axis), wmag * rng.normal()), q)
        out.append(q / np.linalg.norm(q))
    return np.array(out)


def _windows(kind, M, seed):
    """Random windows of the JAX test's kinds: normal R3 knots, unit
    quaternions, near-identity SE3 rotations with normal translations."""
    rng = np.random.default_rng(seed)
    if kind == "r3":
        return rng.normal(size=(M, 4, 3))
    if kind == "so3":
        qs = rng.normal(size=(M, 4, 4))
        return qs / np.linalg.norm(qs, axis=-1, keepdims=True)
    qs = rng.normal(size=(M, 4, 4)) * 0.3 + np.array([1.0, 0, 0, 0])
    qs /= np.linalg.norm(qs, axis=-1, keepdims=True)
    return np.concatenate([qs, rng.normal(size=(M, 4, 3))], axis=-1)


@pytest.fixture(scope="module")
def host_library():
    if not (shutil.which("c++") or shutil.which("g++")):
        pytest.skip("needs a host C++ compiler")
    from kontiki_tpu_torch.ops.build import load_host_library

    return load_host_library()


# ---------------------------------------------------------------------------
# B5
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["r3", "so3", "se3"])
def test_evaluate_windows_plain_matches_jax(kind):
    M, dt = 57, 0.13
    u = np.random.default_rng(3).uniform(0.0, 1.0, M)
    win = _windows(kind, M, seed=4)
    got = lk.evaluate_windows(kind, torch.tensor(win), torch.tensor(u), dt)  # CPU: plain
    want = jax_evaluate_windows(kind, jnp.asarray(win), jnp.asarray(u), dt, backend="xla")
    assert len(got) == len(want) == len(JAX_TOLS[kind])
    for g, w, (rtol, atol) in zip(got, want, JAX_TOLS[kind]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=rtol, atol=atol)


@pytest.mark.parametrize("kind", ["r3", "so3", "se3"])
def test_evaluate_windows_host_matches_plain(host_library, kind):
    M, dt = 300, 0.07
    u = torch.tensor(np.random.default_rng(5).uniform(0.0, 1.0, M))
    win = torch.tensor(_windows(kind, M, seed=6))
    if kind != "r3":  # a window of equal knots: the log/exp Taylor branches
        win[0] = win[0, :1]
    u[1:3] = torch.tensor([0.0, 1.0])  # the window's ends
    got = lk.evaluate_windows_host(kind, win, u, dt)
    want = lk.evaluate_windows_plain(kind, win, u, dt)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=TOL, atol=TOL)
    assert lk.evaluate_windows_ops(kind, win, u, dt) > 0


def test_evaluate_windows_checks_inputs():
    win, u = torch.zeros(5, 4, 3, dtype=torch.float64), torch.zeros(5, dtype=torch.float64)
    with pytest.raises(ValueError):
        lk.evaluate_windows("so3", win, u, 0.1)
    with pytest.raises(ValueError):
        lk.evaluate_windows("r3", win, u[:4], 0.1)
    with pytest.raises(ValueError):
        lk.evaluate_windows("r4", win, u, 0.1)
    with pytest.raises(TypeError):
        lk.evaluate_windows("r3", win.long(), u, 0.1)


# ---------------------------------------------------------------------------
# B7
# ---------------------------------------------------------------------------

def test_r3_evaluate_plain_matches_pallas_interpret():
    rng = np.random.default_rng(12)
    knots = rng.normal(size=(40, 3))
    t0, dt = -0.8, 0.31
    ts = rng.uniform(t0, t0 + 37 * dt - 1e-6, 200)  # one 256-time chunk
    got = sk.r3_evaluate_kernel(torch.tensor(knots), t0, dt, torch.tensor(ts))
    want = r3_evaluate_pallas(knots, t0, dt, ts, interpret=True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL, atol=TOL)


def test_r3_evaluate_plain_matches_scipy_unsorted():
    rng = np.random.default_rng(7)
    n, dt, t0 = 25, 0.5, 1.25
    knots = rng.normal(size=(n, 3))
    spl = BSpline(dt * (np.arange(n + 4) - 3) + t0, knots, 3)
    ts = rng.uniform(t0, t0 + (n - 3) * dt - 1e-9, 300)
    p, v, a = sk.r3_evaluate_kernel(torch.tensor(knots), t0, dt, torch.tensor(ts))
    np.testing.assert_allclose(p.numpy(), spl(ts), atol=1e-9)
    np.testing.assert_allclose(v.numpy(), spl.derivative(1)(ts), atol=1e-8)
    np.testing.assert_allclose(a.numpy(), spl.derivative(2)(ts), atol=1e-7)


@pytest.mark.parametrize("order", ["shuffled", "wide span"])
def test_r3_evaluate_host_matches_plain(host_library, order):
    rng = np.random.default_rng(11)
    n = 2000
    knots = torch.tensor(rng.normal(size=(n, 3)))
    if order == "shuffled":
        ts = rng.permutation(np.linspace(-0.5, n - 3 + 0.5, 3000))  # and outside the span
    else:  # 256 times over the whole spline, as the JAX test's fallback case
        ts = np.linspace(0.0, (n - 3) - 1e-6, 256)
    ts = torch.tensor(ts)
    got = sk.r3_evaluate_host(knots, 0.0, 1.0, ts)
    want = sk.r3_evaluate_plain(knots, 0.0, 1.0, ts)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=TOL, atol=TOL)
    assert sk.r3_evaluate_ops(knots, 0.0, 1.0, ts) > 0


@pytest.mark.parametrize("case,B", [("sorted", 1025), ("shuffled", 1025), ("ends", 1023),
                                    ("one window", 257)])
def test_r3_evaluate_host_matches_jax(host_library, case, B):
    """B7's host row code in its kernel's block schedule (1,024 times a
    block: knots staged when a block's times span few, outputs through a
    staged copy) against the JAX package's ``spline_eval.r3_evaluate``
    (1e-12): sorted times (each block's knots staged), the same shuffled
    (read in place), times before t0 and past the last window (the clamp),
    a spline of one window (N = 4); batches one past a block and one
    short of it."""
    rng = np.random.default_rng(B)
    n = 4 if case == "one window" else 300
    t0, dt = -0.4, 0.05
    knots = rng.normal(size=(n, 3))
    if case == "ends":
        ts = np.sort(rng.uniform(t0 - 3 * dt, t0 + (n + 2) * dt, B))
    else:
        ts = np.sort(rng.uniform(t0, t0 + (n - 3) * dt - 1e-9, B))
    if case == "shuffled":
        ts = rng.permutation(ts)
    got = sk.r3_evaluate_host(torch.tensor(knots), t0, dt, torch.tensor(ts))
    want = jax_spline_eval.r3_evaluate(jnp.asarray(knots), t0, dt, jnp.asarray(ts))
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=TOL, atol=TOL * np.abs(w).max())


def test_r3_evaluate_kernel_edges():
    knots = torch.zeros(6, 3, dtype=torch.float64)
    p, v, a = sk.r3_evaluate_kernel(knots, 0.0, 1.0, torch.zeros(0, dtype=torch.float64))
    assert p.shape == v.shape == a.shape == (0, 3)
    with pytest.raises(ValueError, match="too few"):
        sk.r3_evaluate_kernel(knots[:3], 0.0, 1.0, torch.zeros(2, dtype=torch.float64))
    with pytest.raises(ValueError):
        sk.r3_evaluate_kernel(knots, 0.0, 1.0, torch.zeros(2, dtype=torch.float32))


# ---------------------------------------------------------------------------
# trajectories through interop
# ---------------------------------------------------------------------------

def _se3_rows(n, rng):
    return np.concatenate([_quats(n, rng, 0.4), rng.normal(size=(n, 3))], axis=1)


def _jax_spline(cls, knots, dt, t0):
    traj = cls(dt, t0)
    for _ in range(len(knots)):
        traj.append_knot(np.eye(4) if cls is JSE3 else
                         np.array([1.0, 0, 0, 0]) if cls is JSO3 else np.zeros(3))
    traj.set_knots(knots)
    return traj


def _pair(kind, device="cpu"):
    rng = np.random.default_rng({"r3": 1, "so3": 2, "se3": 3, "split": 4}[kind])
    if kind == "split":
        r3, so3 = rng.normal(size=(11, 3)), _quats(9, rng, 0.4)
        jt = JSplit(_jax_spline(JR3, r3, 0.25, 0.3), _jax_spline(JSO3, so3, 0.3, 0.1))
        tt = interop.split_trajectory_from_numpy(r3, so3, 0.25, 0.3, 0.3, 0.1, device=device)
        return jt, tt
    knots = {"r3": lambda: rng.normal(size=(9, 3)), "so3": lambda: _quats(9, rng, 0.4),
             "se3": lambda: _se3_rows(9, rng)}[kind]()
    cls = {"r3": JR3, "so3": JSO3, "se3": JSE3}[kind]
    return (_jax_spline(cls, knots, 0.2, 0.15),
            interop.trajectory_from_numpy(kind, knots, 0.2, 0.15, device=device))


def _close(got, want, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=TOL, atol=TOL,
                               err_msg=msg)


KINDS = ["r3", "so3", "se3", "split"]


@pytest.mark.parametrize("kind", KINDS)
def test_queries_match_jax(kind):
    jt, tt = _pair(kind)
    assert tt.valid_time == jt.valid_time
    ts = np.random.default_rng(9).uniform(*tt.valid_time, size=B)
    for q in QUERIES:
        _close(getattr(tt, q)(ts), getattr(jt, q)(ts), q)
        _close(getattr(tt, q)(ts[3]), getattr(jt, q)(ts[3]), q)
    with pytest.raises(ValueError):
        tt.position(tt.max_time)
    with pytest.raises(ValueError):
        tt.orientation(tt.min_time - 1e-9)


@pytest.mark.parametrize("kind", KINDS)
def test_frame_transforms_match_jax(kind):
    jt, tt = _pair(kind)
    rng = np.random.default_rng(10)
    ts = rng.uniform(*tt.valid_time, size=B)
    X = rng.normal(size=(B, 3))
    _close(tt.from_world(X, ts), jt.from_world(X, ts), "from_world")
    _close(tt.to_world(X, ts), jt.to_world(X, ts), "to_world")
    _close(tt.to_world(X[0], ts), jt.to_world(X[0], ts), "to_world, one point")
    _close(tt.from_world(X[1], ts[2]), jt.from_world(X[1], ts[2]), "from_world, scalar")
    _close(tt.to_world(tt.from_world(X, ts), ts), X, "round trip")


def test_se3_evaluate_matches_jax():
    jt, tt = _pair("se3")
    ts = np.random.default_rng(11).uniform(*tt.valid_time, size=B)
    for g, w in zip(tt.evaluate(ts), jt.evaluate(ts)):
        _close(g, w)
    for g, w in zip(tt.evaluate(ts[1]), jt.evaluate(ts[1])):
        assert g.shape == (4, 4)
        _close(g, w)


@pytest.mark.parametrize("kind", ["r3", "so3", "se3"])
def test_extend_to_and_setitem_match_jax(kind):
    jt, tt = _pair(kind)
    fill = tt[-1]
    jt.extend_to(jt.max_time + 0.45, fill)
    tt.extend_to(tt.max_time + 0.45, fill)
    assert len(tt) == len(jt) == 12
    _close(tt.knots, jt.knots)
    tt[2], jt[2] = tt[4], jt[4]
    _close(tt.knots, jt.knots)
    ts = np.linspace(*tt.valid_time, B, endpoint=False)
    _close(tt.position(ts), jt.position(ts))
    _close(tt.orientation(ts), jt.orientation(ts))


def test_too_few_knots_and_empty_extend():
    for kind, fill in (("r3", np.zeros(3)), ("so3", np.array([1.0, 0, 0, 0])),
                       ("se3", np.eye(4))):
        jt = {"r3": JR3, "so3": JSO3, "se3": JSE3}[kind](0.1, 0.0)
        tt = interop.trajectory_from_numpy(kind, np.zeros((0, 0)), 0.1, 0.0, device="cpu")
        with pytest.raises(ValueError, match="too few"):
            tt.position(0.0)
        jt.extend_to(0.35, fill)
        tt.extend_to(0.35, fill)
        assert len(tt) == len(jt) and tt.valid_time == jt.valid_time
        _close(tt.position(0.3), jt.position(0.3))


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, tt = _pair("split", device=None)
    assert tt.device is None and tt.clone().device is None
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tt.position(tt.min_time)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tt.from_world(np.zeros(3), tt.min_time)
    _, se3 = _pair("se3", device=None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        se3.evaluate(se3.min_time)
    assert tt._eval(np.array([tt.min_time]), device="cpu")["position"].shape == (1, 3)


def test_cpu_queries_launch_nothing():
    jt, tt = _pair("split")
    before = (dict(lk.evaluate_windows.launches), sk.r3_evaluate_kernel.launches)
    tt.position(np.linspace(*tt.valid_time, 5, endpoint=False))
    assert (lk.evaluate_windows.launches, sk.r3_evaluate_kernel.launches) == before


# ---------------------------------------------------------------------------
# utils and trajectory scores
# ---------------------------------------------------------------------------

class _Span:
    def __init__(self, tmin, tmax):
        self.valid_time = (tmin, tmax)


@pytest.mark.parametrize("span", [(1.0, 4.0), (-np.inf, 2.0), (3.0, np.inf),
                                  (-np.inf, np.inf), (1.0, 1.5)])
def test_safe_time_matches_jax(span):
    t = _Span(*span)
    assert utils.safe_time(t) == jutils.safe_time(t)
    for length, short in ((2.0, False), (2.0, True), (0.25, False)):
        try:
            want = jutils.safe_time_span(t, length, allow_shorter=short)
        except ValueError:
            with pytest.raises(ValueError):
                utils.safe_time_span(t, length, allow_shorter=short)
            continue
        assert utils.safe_time_span(t, length, allow_shorter=short) == want


def test_safe_time_rejects_inverted_ranges():
    for span in ((2.0, -np.inf), (np.inf, 1.0)):
        with pytest.raises(ValueError):
            utils.safe_time(_Span(*span))
        with pytest.raises(ValueError):
            jutils.safe_time(_Span(*span))


@pytest.mark.parametrize("kind", ["se3", "split"])
def test_trajectory_scores_match_jax(kind):
    ja, ta = _pair(kind)
    rng = np.random.default_rng(13)
    if kind == "se3":
        knots = ta.knots.copy()
        knots[:, 4:] += rng.normal(scale=0.05, size=knots[:, 4:].shape)
        tb = interop.trajectory_from_numpy("se3", knots, ta.dt, ta.t0, device="cpu")
        jb = _jax_spline(JSE3, knots, ta.dt, ta.t0)
    else:
        tb = synthetic.perturb_trajectory(ta, seed=5)
        jb = JSplit(_jax_spline(JR3, tb.R3_spline.knots, tb.R3_spline.dt, tb.R3_spline.t0),
                    _jax_spline(JSO3, tb.SO3_spline.knots, tb.SO3_spline.dt, tb.SO3_spline.t0))
    t1, t2 = ta.min_time, ta.max_time
    for align in (False, "se3", "sim3"):
        got = synthetic.trajectory_ate(ta, tb, t1, t2, n=B, align=align)
        want = jsyn.trajectory_ate(ja, jb, t1, t2, n=B, align=align)
        assert got == pytest.approx(want, rel=TOL, abs=TOL), align
    for align in (True, False):
        got = synthetic.trajectory_aoe(ta, tb, t1, t2, n=B, align=align)
        want = jsyn.trajectory_aoe(ja, jb, t1, t2, n=B, align=align)
        assert got == pytest.approx(want, rel=TOL, abs=TOL), align
