"""The camera kernels' own row code on the atan camera and on lifting rows
(``csrc/camera_rows.cuh``, B1 and B3), compiled for the host
(``csrc/host_rows.cpp``), against the plain PyTorch versions in float64 at
1e-12 relative to max |plain| per output, on every window x camera x rows
branch: the seed chunks (a lifting row's 22nd seed in a fourth chunk),
the one full-width jet per row that B1's operation count runs (``wide``),
B1's kernel schedule lane after lane (``lanes``), B3's chain in both its
kernels' schedules, with and without ``valid``; and the
operation counts the bounds use. The rows are those of a small atan
lifting problem on each window kind (split on distinct R3/SO3 grids), with
the atan or lifting inputs dropped for the other branches."""
import pytest
import torch

from kontiki_tpu_torch.ops import linearize_kernels as tlk
from kontiki_tpu_torch.solver import kernels as tk
from kontiki_tpu_torch.solver.problem import Problem
from kontiki_tpu_torch.synthetic import make_rsvi_problem
from test_torch_camera_host import _assert_close, _valid, host_library, regrid  # noqa: F401

torch.set_num_threads(1)
BRANCHES = [f"{kind} {camera} {rows}" for kind in ("se3", "split")
            for camera in ("pinhole", "atan") for rows in ("static", "lifting")]


@pytest.fixture(scope="module")
def rows():
    out = {}
    for kind in ("se3", "split"):
        gen = make_rsvi_problem(nviews=3, nlandmarks=6, imu_rate=0.0, seed=4, trajectory=kind,
                                camera_kind="atan", rs="lifting", noise_px=1.0)
        traj = regrid(gen["trajectory"]) if kind == "split" else gen["trajectory"]
        problem = Problem(traj, gen["measurements"], device="cpu")
        spec, rt = tk.problem_spec(problem), tk.problem_runtime(problem)
        cfg, ins, _ = tk._camera_inputs(spec, rt, problem.state0, rt["data"][0])
        for camera in ("PinholeCamera", "AtanCamera"):
            for lifting in (False, True):
                c = dict(cfg, camera=camera, lifting=lifting, rdim=2 + lifting,
                         C=61 + lifting)
                names = {s[0] for s in tlk.camera_inputs(c) if s is not None}
                out[tlk.camera_branch(c)] = (c, {k: v for k, v in ins.items() if k in names})
    return out


@pytest.mark.parametrize("branch", BRANCHES)
def test_row_code_matches_plain(host_library, rows, branch):
    cfg, ins = rows[branch]
    want = tlk.linearize_rows_plain(cfg, ins)
    for wide in (False, True):
        _assert_close(tlk.linearize_rows_host(cfg, ins, wide=wide), want)
    for inputs in (ins, _valid(ins)):
        _assert_close([tlk.cost_rows_host(cfg, inputs)], [tlk.cost_rows_plain(cfg, inputs)])
    vin = _valid(ins)
    got = tlk.linearize_rows_host(cfg, vin)
    _assert_close(got, tlk.linearize_rows_plain(cfg, vin))
    off = vin["valid"][0] == 0
    assert all(torch.all(a[off] == 0) for a in got)


@pytest.mark.parametrize("branch", BRANCHES)
def test_lane_schedule_matches_plain(host_library, rows, branch):
    """B1's kernel schedule, one row on a group of lanes stage by stage
    (``linearize_row_lanes``), run lane after lane: with and without
    ``valid``."""
    cfg, ins = rows[branch]
    for inputs in (ins, _valid(ins)):
        _assert_close(tlk.linearize_rows_host(cfg, inputs, lanes=True),
                      tlk.linearize_rows_plain(cfg, inputs))


@pytest.mark.parametrize("branch", BRANCHES)
def test_b3_lane_schedule_matches_plain(host_library, rows, branch):
    """B3's lane kernel schedule (a row's knot pairs on six lanes, the two
    windows' products on two, the residual on one), run lane after lane:
    with and without ``valid``."""
    cfg, ins = rows[branch]
    for inputs in (ins, _valid(ins)):
        _assert_close([tlk.cost_rows_host(cfg, inputs, lanes=True)],
                      [tlk.cost_rows_plain(cfg, inputs)])


@pytest.mark.parametrize("kind", ["se3", "split"])
def test_operation_counts(host_library, rows, kind):
    """The atan projection and the lifting residual add operations to
    each row; B3 stays far below B1."""
    ops = {}
    for camera in ("pinhole", "atan"):
        for rs in ("static", "lifting"):
            cfg, ins = rows[f"{kind} {camera} {rs}"]
            ops[camera, rs] = (tlk.linearize_rows_ops(cfg, ins), tlk.cost_rows_ops(cfg, ins))
            assert 0 < 10 * ops[camera, rs][1] < ops[camera, rs][0]
    for i in (0, 1):
        assert ops["pinhole", "static"][i] < ops["atan", "static"][i] < ops["atan", "lifting"][i]
        assert ops["pinhole", "static"][i] < ops["pinhole", "lifting"][i]
