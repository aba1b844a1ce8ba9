"""Port parity, Newton rolling-shutter rows (config 4-Newton's model cut to
the JAX tests' small problem): the gather stage, the plain version of kernel
B8 (``newton_rows_plain``) and its CUDA row code built for the host
(``newton_rows_host``) against ``kontiki_tpu`` on the same inputs, in
float64. The split branches' linearize form against the JAX tile is in
``tests/test_torch_newton_tile.py`` (its two compiles take half a minute),
on this module's problem and helpers.

The problem is the JAX package's own (``tests/test_linearize_kernel.py``:
``make_rsvi_problem(nviews=6, nlandmarks=9, imu_rate=0.0, seed=43,
rs="newton", perturb_rho=0.05, noise_px=1.0)`` with the camera's pose and
time offset free, bound 0.01) with the atan camera, on the split and on the
SE3 trajectory; the pinhole branches run on the same rows with the atan
inputs dropped, on both sides.

The JAX side is its fused tile (``lk.newton_rows(cfg, ins,
backend="xla")``, jitted): every branch's cost-only form here, the split
branches' linearize form in ``tests/test_torch_newton_tile.py``. Its SE3 linearize tile takes 8-9 minutes to
compile on a CPU (its scan under ``jax.linearize``), so the SE3 Jacobians
are held to the JAX package's vmapped ``jacfwd`` path instead, which its
own test holds to the tile at rtol 1e-8
(``tests/test_torch_newton_terms.py``, SE3 pinhole rows); here the host
row code is held to the plain version on all four branches.

Tolerances: the JAX package's own (``tests/test_linearize_kernel.py``): r
rtol 1e-10 / atol 1e-12, J and J_rho rtol 1e-8 / atol 1e-11; the gather and
the column ids exact; host row code against the plain version 1e-12
normwise. A row whose Newton convergence test lies within rounding of its
bound (margin under 1e-9) could take another step on either side; such rows
would be named by their margin and left out, and none is at these inputs
(the smallest margin is pinned)."""
import functools

import jax
import numpy as np
import pytest
import torch

from kontiki_tpu.ops import linearize_kernels as jlk
from kontiki_tpu.solver import kernels as jk
from kontiki_tpu_torch.ops import linearize_kernels as tlk
from kontiki_tpu_torch.solver import kernels as tk
from kontiki_tpu_torch.synthetic import make_rsvi_problem
from test_torch_camera_host import host_library  # noqa: F401
from test_torch_split_camera import twin_pair

torch.set_num_threads(1)
SMALL = dict(nviews=6, nlandmarks=9, imu_rate=0.0, seed=43, rs="newton", perturb_rho=0.05,
             noise_px=1.0)
CAMERAS = ("PinholeCamera", "AtanCamera")
#: a convergence test this close to its bound may flip with rounding
MARGIN = 1e-9


@functools.lru_cache(maxsize=None)
def newton_pair(trajectory, camera_kind="atan"):
    """Both packages' problems over the small Newton problem, camera pose and
    time offset free."""
    gen = make_rsvi_problem(trajectory=trajectory, camera_kind=camera_kind, **SMALL)
    cam = gen["camera"]
    cam.relative_orientation_locked = False
    cam.relative_position_locked = False
    cam.max_time_offset = 0.01
    cam.time_offset_locked = False
    return twin_pair(gen["trajectory"], gen["measurements"])


@functools.lru_cache(maxsize=None)
def rows(trajectory):
    """The JAX package's and the port's gather of the atan problem's Newton
    rows, and per camera both sides' (cfg, ins) with the inputs the branch
    lacks dropped."""
    pair = newton_pair(trajectory)
    spec, jrt, J = pair["jspec"], pair["jrt"], pair["jax"]
    (b,) = [i for i, bs in enumerate(spec.buckets) if bs.kind == "rs_newton"]
    jins, jcfg, ji0 = jk._fused_newton_inputs(spec, spec.buckets[b], jrt, J.state0,
                                              jrt["data"][b])
    tcfg, tins, ti0 = tk._newton_inputs(pair["tspec"], pair["tspec"].buckets[b], pair["rt"],
                                        pair["state"], pair["rt"]["data"][b])
    branches = {}
    for camera in CAMERAS:
        c, tc = dict(jcfg, camera=camera), dict(tcfg, camera=camera)
        names = {s[0] for s in tlk.newton_inputs(tc) if s is not None}
        branches[camera] = (c, {k: v for k, v in jins.items() if k in names},
                            tc, {k: v for k, v in tins.items() if k in names})
    return (jcfg, jins, ji0), (tcfg, tins, ti0), branches


#: the rows held to the JAX tile: the small problem's gather, the same rows
#: with some moved to the edges of the Newton path
#: (``synthetic.newton_edge_rows``: every update clamped at 0 or at the
#: readout, five steps), and such rows of the problem on knots closer than
#: readout / 3 (``W10_DT``: 10-knot windows, steps that cross a knot); each
#: a case of the tile comparisons, named after the gather's
TILE_ROWS = ("gather", "edges W6", "edges W10")
#: knot spacing readout / 4.5 (10-knot windows)
W10_DT = 0.025 / 4.5


def tile_cases(names, which=TILE_ROWS):
    """``(name, which)`` parameters over ``which`` (of ``TILE_ROWS``), the
    gather's cases keeping their plain names."""
    return [pytest.param(n, w, id=n if w == "gather" else f"{n} {w}")
            for n in names for w in which]


@functools.lru_cache(maxsize=None)
def tile_rows(trajectory, camera, which="gather"):
    """The port's ``(cfg, ins)`` of one branch's rows ``which``
    (``TILE_ROWS``)."""
    from kontiki_tpu_torch.synthetic import newton_edge_rows

    if which == "edges W10":
        return port_rows(trajectory, camera[:-6].lower(), W10_DT)
    _, _, tcfg, tins = rows(trajectory)[2][camera]
    return tcfg, (tins if which == "gather" else newton_edge_rows(tins))


@functools.lru_cache(maxsize=None)
def _jax_tile_fn(trajectory, camera, cost_only, W10):
    """The JAX package's fused Newton tile on one branch, jitted once a
    window width (the edge rows of a width share its compile)."""
    cfg = tile_rows(trajectory, camera, "edges W10" if W10 else "gather")[0]
    return jax.jit(functools.partial(jlk.newton_rows, cfg, cost_only=cost_only, backend="xla"))


@functools.lru_cache(maxsize=None)
def jax_tile(trajectory, camera, cost_only, which="gather"):
    """The JAX tile on one branch's rows ``which``: the JAX package's own
    gather for the gather's, else the port's inputs (which equal its
    gather's, ``test_gather_matches_jax``) in the JAX gather's dtypes."""
    fn = _jax_tile_fn(trajectory, camera, cost_only, which == "edges W10")
    jins = rows(trajectory)[2][camera][1]
    if which == "gather":
        ins = jins
    else:
        ins = {k: jax.numpy.asarray(v.numpy(), dtype=jins[k].dtype)
               for k, v in tile_rows(trajectory, camera, which)[1].items()}
    out = fn(ins)
    return np.asarray(out) if cost_only else tuple(np.asarray(a) for a in out)


@functools.lru_cache(maxsize=None)
def kept_rows(trajectory, camera, which="gather"):
    """Rows whose every convergence test is clear of its bound (``MARGIN``),
    from the host row code's primal path; the others, named by margin."""
    tcfg, tins = tile_rows(trajectory, camera, which)
    _, steps, margin = tlk.newton_rows_host(tcfg, tins, cost_only=True, steps=True)
    near = {int(m): float(margin[m]) for m in torch.nonzero(margin < MARGIN).flatten()}
    return margin >= MARGIN, near, steps


def _jax_close(got, want, kept, name, rtol, atol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, name
    keep = kept.numpy()
    np.testing.assert_allclose(got[keep], want[keep], rtol=rtol, atol=atol, err_msg=name)


def _close(got, want, name, tol=1e-12):
    got, want = torch.as_tensor(got), torch.as_tensor(want)
    assert got.shape == want.shape, name
    err = (got - want).abs().max().item()
    assert err <= tol * max(want.abs().max().item(), 1e-300), (name, err)


@pytest.mark.parametrize("trajectory", ["split", "se3"])
def test_gather_matches_jax(trajectory):
    """The port's gather equals the JAX package's: the cfg, every input (W-knot
    readout-slack windows at the frame start, the obs side's u there, the
    ref side's at its row time) and the window bases."""
    (jcfg, jins, ji0), (tcfg, tins, ti0), _ = rows(trajectory)
    assert tcfg == jcfg and max(tcfg["Ws"]) > 4
    assert tcfg["C"] == tlk.newton_shape(tcfg)[1] == 85
    assert set(tins) == set(jins)
    for k in jins:
        np.testing.assert_array_equal(tins[k].numpy(), np.asarray(jins[k]), err_msg=k)
    for tag in ("ref", "obs"):
        for a, b in zip(ti0[tag], ji0[tag]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=tag)


def edge_rows_kept(trajectory, camera, which):
    """``kept_rows`` of rows ``which``; on edge rows, asserts that every
    row moved to an edge of the Newton path is held to the JAX tile, and
    that at W = 10 rows 4 and 5 step onto another sub-window."""
    kept, near, steps = kept_rows(trajectory, camera, which)
    if which != "gather":
        assert bool(kept[:6].all()) and bool((steps[:4] == 5).all()), near
    if which == "edges W10":
        moved = tlk.newton_rows_paths(*tile_rows(trajectory, camera, which))[:, 3]
        assert bool((moved[4:6] > 0).all())
    return kept, near, steps


@pytest.mark.parametrize("camera", CAMERAS)
@pytest.mark.parametrize("trajectory, which", tile_cases(["split", "se3"]))
def test_cost_rows_match_jax_tile(host_library, trajectory, which, camera):
    """B8's cost-only form, plain and host, against the JAX tile's, on each
    of ``TILE_ROWS``."""
    tcfg, tins = tile_rows(trajectory, camera, which)
    kept, near, _ = edge_rows_kept(trajectory, camera, which)
    want = jax_tile(trajectory, camera, True, which)
    for who, got in (("plain", tlk.newton_rows_plain(tcfg, tins, cost_only=True)),
                     ("host", tlk.newton_rows_host(tcfg, tins, cost_only=True))):
        _jax_close(got, want, kept, f"{camera} {who} r (rows near the test: {near})", 1e-10,
                   1e-12)


@pytest.mark.parametrize("camera", CAMERAS)
@pytest.mark.parametrize("trajectory", ["split", "se3"])
def test_host_rows_match_plain(host_library, trajectory, camera):
    """The kernel's row code on the host, in its lane schedule and in one
    full-width jet a stage, against the plain version, with every third row
    at valid = 0 (exact zeros there); the cost-only chain against the
    linearize form's residual."""
    _, _, tcfg, tins = rows(trajectory)[2][camera]
    M = tins["u_ref"].shape[1]
    x = dict(tins, valid=(torch.arange(M) % 3 != 1).to(torch.float64)[None, :])
    want = tlk.newton_rows_plain(tcfg, x)
    for wide in (False, True):
        got = tlk.newton_rows_host(tcfg, x, wide=wide)
        for name, g, w in zip(("r", "J", "J_rho"), got, want):
            _close(g, w, f"{camera} wide={wide} {name}")
            assert torch.all(g[x["valid"][0] == 0] == 0)
    cost = tlk.newton_rows_host(tcfg, x, cost_only=True)
    _close(cost, tlk.newton_rows_plain(tcfg, x, cost_only=True), f"{camera} cost-only")
    _close(cost, want[0], f"{camera} cost-only vs linearize")


@pytest.mark.parametrize("trajectory", ["split", "se3"])
def test_newton_steps_and_margins(host_library, trajectory):
    """Rows take 1 to 5 Newton steps, most more than one here; no row's
    convergence test lies within rounding of its bound (so every row is
    held to the JAX package above)."""
    for camera in CAMERAS:
        kept, near, steps = kept_rows(trajectory, camera)
        assert near == {} and bool(kept.all())
        assert int(steps.min()) >= 1 and int(steps.max()) <= 5
        assert int((steps > 1).sum()) > len(steps) // 2
    _, steps, margin = tlk.newton_rows_host(*rows(trajectory)[2]["PinholeCamera"][2:],
                                            cost_only=True, steps=True)
    assert float(margin.min()) > 1e-3


@functools.lru_cache(maxsize=None)
def port_rows(trajectory, camera_kind, knot_dt):
    """(cfg, ins) of the port's own gather of a small Newton problem
    (``SMALL`` on ``knot_dt``, camera pose and time offset free), its edge
    rows moved by ``synthetic.newton_edge_rows``."""
    from kontiki_tpu_torch.solver.problem import Problem
    from kontiki_tpu_torch.synthetic import newton_edge_rows

    gen = make_rsvi_problem(trajectory=trajectory, camera_kind=camera_kind,
                            **dict(SMALL, knot_dt=knot_dt))
    cam = gen["camera"]
    cam.relative_orientation_locked = cam.relative_position_locked = False
    cam.max_time_offset, cam.time_offset_locked = 0.01, False
    problem = Problem(gen["trajectory"], gen["measurements"], device="cpu")
    spec, rt = tk.problem_spec(problem), tk.problem_runtime(problem)
    (b,) = [i for i, bs in enumerate(spec.buckets) if bs.kind == "rs_newton"]
    cfg, ins = tk._newton_inputs(spec, spec.buckets[b], rt, problem.state0, rt["data"][b])[:2]
    return cfg, newton_edge_rows(ins)


#: (trajectory, camera, knot spacing): config 4-Newton's 0.15 s (6-knot
#: windows) and readout / 4.5, knots closer than readout / 3 (10-knot windows)
EDGE_CASES = {"split pinhole W6": ("split", "pinhole", 0.15),
              "se3 atan W6": ("se3", "atan", 0.15),
              "split atan W10": ("split", "atan", W10_DT),
              "se3 pinhole W10": ("se3", "pinhole", W10_DT)}


@pytest.mark.parametrize("case", EDGE_CASES)
def test_host_schedule_edge_paths(host_library, case):
    """The kernel's lane schedule on the host against the plain version at
    the edges of the Newton path (``synthetic.newton_edge_rows``): rows
    whose every update clamps at 0 or at the readout and that stop at step
    5, and, at W = 10 (knots closer than readout / 3, which the kernel once
    refused), rows whose steps cross a knot so that the obs sub-window base
    changes between steps; every third row at valid = 0 (exact zeros
    there), the cost-only chain against the linearize form's residual."""
    cfg, ins = port_rows(*EDGE_CASES[case])
    W = int(case[-2:].strip("W"))
    assert max(cfg["Ws"]) == W
    paths = tlk.newton_rows_paths(cfg, ins)
    steps, low, high, moved = paths.T
    assert bool((steps[:4] == 5).all()) and bool((low[:2] == 4).all())
    assert bool((high[2:4] == 4).all())
    assert int((steps == 2).sum()) > 0
    if W == 10:
        assert bool((moved[4:6] > 0).all()) and int((steps == 3).sum()) > 0
    M = ins["u_ref"].shape[1]
    x = dict(ins, valid=(torch.arange(M) % 3 != 1).to(torch.float64)[None, :])
    want = tlk.newton_rows_plain(cfg, x)
    got = tlk.newton_rows_host(cfg, x)
    for name, g, w in zip(("r", "J", "J_rho"), got, want):
        _close(g, w, f"{case} {name}")
        assert torch.all(g[x["valid"][0] == 0] == 0)
    _close(tlk.newton_rows_host(cfg, x, cost_only=True), want[0], f"{case} cost-only")


def test_wrapper_routes_and_checks(host_library):
    """The wrapper runs the plain version for CPU tensors and checks its
    inputs; the kernel's operation count adds over rows."""
    _, _, tcfg, tins = rows("split")[2]["PinholeCamera"]
    before = tlk.newton_rows.launches
    for a, b in zip(tlk.newton_rows(tcfg, tins), tlk.newton_rows_plain(tcfg, tins)):
        assert torch.equal(a, b)
    assert torch.equal(tlk.newton_rows(tcfg, tins, cost_only=True),
                       tlk.newton_rows_plain(tcfg, tins, cost_only=True))
    assert tlk.newton_rows.launches == before  # no kernel ran
    with pytest.raises(ValueError, match="missing input rows"):
        tlk.newton_rows(tcfg, {k: v for k, v in tins.items() if k != "rows"})
    with pytest.raises(ValueError, match="win_ref_r3 must be"):
        tlk.newton_rows(dict(tcfg, Ws=(7, 6)), tins)
    with pytest.raises(ValueError, match="unsupported device"):
        tlk.newton_rows(tcfg, {k: v.to("meta") for k, v in tins.items()})
    M = tins["u_ref"].shape[1]
    half = {k: v[:, :M // 2].contiguous() for k, v in tins.items()}
    rest = {k: v[:, M // 2:].contiguous() for k, v in tins.items()}
    for opts in ({}, {"cost_only": True}, {"schedule": True}):
        n = tlk.newton_rows_ops(tcfg, tins, **opts)
        assert n == (tlk.newton_rows_ops(tcfg, half, **opts)
                     + tlk.newton_rows_ops(tcfg, rest, **opts)) > 0
    assert tlk.newton_rows_ops(tcfg, tins) > 10 * tlk.newton_rows_ops(tcfg, tins, cost_only=True)
    # the one-jet chain (the function's count) stops at 8 knots, the lane
    # schedule and the cost-only chain do not
    wide, wins = port_rows("split", "pinhole", W10_DT)
    with pytest.raises(NotImplementedError, match="at most 8 knots"):
        tlk.newton_rows_ops(wide, wins)
    with pytest.raises(NotImplementedError, match="at most 8 knots"):
        tlk.newton_rows_host(wide, wins, wide=True)
    assert tlk.newton_rows_ops(wide, wins, schedule=True) > 0
