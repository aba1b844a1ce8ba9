"""The camera kernels' own row code (``csrc/linearize_rows.cu``: B1's SE3
and split branches and B3), compiled for the host with a plain C++ compiler
(``csrc/host_rows.cpp``), against the plain PyTorch versions in float64, at
1e-12 relative to max |plain| per output: the seed chunks, the one
full-width jet per row that B1's operation count runs, and B3's chain in
both its kernels' schedules, with and without ``valid``. The split rows come from R3 and SO3
splines on distinct grids, in both spline orders.

Also B2's block accumulation (``csrc/assemble_schur.cu``, shared by its
kernel) against ``assemble_schur_blocks_plain``: heads narrower than P,
repeated ids, landmark runs, ids out of range."""
import shutil

import numpy as np
import pytest
import torch

from kontiki_tpu_torch.ops import assembly_kernels as tak
from kontiki_tpu_torch.ops import linearize_kernels as tlk
from kontiki_tpu_torch.solver import kernels as tk
from kontiki_tpu_torch.solver.problem import Problem
from kontiki_tpu_torch.synthetic import make_rsvi_problem
from kontiki_tpu_torch.trajectories import SplitTrajectory

torch.set_num_threads(1)
KINDS = ["se3", "split", "split-so3-first"]
#: (dt, t0) of the re-knotted R3 and SO3 splines
GRIDS = {"r3": (0.11, 0.03), "so3": (0.13, -0.02)}


def regrid(traj, grids=GRIDS):
    """A port SplitTrajectory on the given (dt, t0) grids whose knots are
    ``traj``'s positions and orientations at the knot times (clipped to its
    valid span)."""
    (dr, tr), (dq, tq) = grids["r3"], grids["so3"]
    tmin, tmax = traj.valid_time
    out = SplitTrajectory(dr, dq, tr, tq)
    for dt, t0, key, sp in ((dr, tr, "position", out.R3_spline),
                            (dq, tq, "orientation", out.SO3_spline)):
        n = int(np.ceil((tmax - t0) / dt)) + 3
        ts = np.clip(t0 + (np.arange(n) - 1) * dt, tmin, tmax - 1e-9)
        for row in traj._eval(ts, device="cpu")[key]:
            sp.append_knot(row / np.linalg.norm(row) if key == "orientation" else row)
    return out


@pytest.fixture(scope="module")
def host_library():
    if not (shutil.which("c++") or shutil.which("g++")):
        pytest.skip("needs a host C++ compiler")
    from kontiki_tpu_torch.ops.build import load_host_library

    return load_host_library()


@pytest.fixture(scope="module")
def rows():
    """Gathered camera rows per kind, with a ``valid`` mask for B3."""
    out = {}
    for kind in ("se3", "split"):
        gen = make_rsvi_problem(nviews=3, nlandmarks=6, imu_rate=0.0, seed=4, trajectory=kind)
        traj = regrid(gen["trajectory"]) if kind == "split" else gen["trajectory"]
        problem = Problem(traj, gen["measurements"], device="cpu")
        spec, rt = tk.problem_spec(problem), tk.problem_runtime(problem)
        cfg, ins, _ = tk._camera_inputs(spec, rt, problem.state0, rt["data"][0])
        out[kind] = (cfg, ins)
    cfg, ins = out["split"]
    out["split-so3-first"] = (dict(cfg, r3_first=False), ins)
    return out


def _assert_close(got, want):
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-12, atol=1e-12 * w.abs().max().item())


def _valid(ins):
    M = ins["u_ref"].shape[1]
    return dict(ins, valid=(torch.arange(M) % 4 != 1).to(torch.float64)[None, :])


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("wide", [False, True])
def test_b1_row_code_matches_plain(host_library, rows, kind, wide):
    cfg, ins = rows[kind]
    _assert_close(tlk.linearize_rows_host(cfg, ins, wide=wide),
                  tlk.linearize_rows_plain(cfg, ins))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("with_valid", [False, True])
def test_b3_row_code_matches_plain(host_library, rows, kind, with_valid):
    cfg, ins = rows[kind]
    if with_valid:
        ins = _valid(ins)
    want = tlk.cost_rows_plain(cfg, ins)
    _assert_close([tlk.cost_rows_host(cfg, ins)], [want])
    if with_valid:
        assert torch.all(want[ins["valid"][0] == 0] == 0)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("with_valid", [False, True])
def test_b3_lane_schedule_matches_plain(host_library, rows, kind, with_valid):
    """B3's row code in its lane kernel's schedule (a row's knot pairs on
    six lanes, its windows' products on two, the residual on one), lane
    after lane."""
    cfg, ins = rows[kind]
    if with_valid:
        ins = _valid(ins)
    _assert_close([tlk.cost_rows_host(cfg, ins, lanes=True)], [tlk.cost_rows_plain(cfg, ins)])


def test_b1_valid_zeroes_rows(host_library, rows):
    cfg, ins = rows["split"]
    ins = _valid(ins)
    got = tlk.linearize_rows_host(cfg, ins)
    _assert_close(got, tlk.linearize_rows_plain(cfg, ins))
    off = ins["valid"][0] == 0
    assert all(torch.all(a[off] == 0) for a in got)


@pytest.mark.parametrize("kind", KINDS)
def test_operation_counts(host_library, rows, kind):
    """B3 counts the primal chain once per row, far below B1; both scale
    with the rows."""
    cfg, ins = rows[kind]
    b1, b3 = tlk.linearize_rows_ops(cfg, ins), tlk.cost_rows_ops(cfg, ins)
    assert 0 < 10 * b3 < b1
    half = {k: v[:, ::2].contiguous() for k, v in ins.items()}
    assert tlk.cost_rows_ops(cfg, half) < b3


def schur_rows(M, P, L, rdim=2, C=61, seed=0, dtype=torch.float64, device="cpu"):
    """Random B2 inputs shaped like a camera bucket: rows grouped by
    landmark (runs of one lid) whose first 20 ids after two are shared,
    one id repeated within each row, ids and lids out of range here and
    there (dropped)."""
    rng = np.random.default_rng(seed)
    lid = np.sort(rng.integers(0, L, size=M))
    cols = rng.integers(0, P, size=(M, C))
    cols[:, 2:22] = rng.integers(0, P, size=(L, 20))[lid]
    cols[:, 1] = cols[:, 0]
    cols[rng.random((M, C)) < 0.02] = -1
    cols[rng.random((M, C)) < 0.02] = P + 3
    lid[rng.random(M) < 0.05] = L
    as_t = lambda a: torch.tensor(a, dtype=dtype, device=device)  # noqa: E731
    return (as_t(rng.normal(size=(M, rdim, C))),
            torch.tensor(cols.astype(np.int32), device=device),
            as_t(rng.normal(size=(M, rdim))), as_t(rng.normal(size=(M, rdim))),
            torch.tensor(lid.astype(np.int32), device=device))


def schur_reference(Jw, cols, rw, J_rho, lid, *, P, L, with_rho):
    """The plain B2 with the entries the kernel drops taken out: ids out of
    range (their Jacobian entries zeroed) and the landmark outputs of rows
    whose lid is out of range."""
    drop = (cols < 0) | (cols >= P)
    off = (lid < 0) | (lid >= L)
    return tak.assemble_schur_blocks_plain(
        Jw * ~drop[:, None, :], torch.where(drop, 0, cols), rw, J_rho * ~off[:, None],
        torch.where(off, 0, lid), P=P, L=L, with_rho=with_rho)


@pytest.mark.parametrize("with_rho", [True, False])
@pytest.mark.parametrize("M,blocks,warps,head", [(0, 1, 1, 16), (1, 1, 4, 16),
                                                 (300, 3, 4, 16), (300, 2, 16, 40)])
def test_b2_block_accumulation_matches_plain(host_library, M, blocks, warps, head, with_rho):
    """B2's kernel accumulation on the host: rows cut over blocks and
    warps, products of ids below ``head`` in each block's upper triangle
    (mirrored when the blocks' heads are summed), the rest straight into
    H, the landmark outputs in runs."""
    P, L = 40, 9
    rows = schur_rows(M, P, L, seed=M + head)
    kw = dict(P=P, L=L, with_rho=with_rho)
    got = tak.assemble_schur_blocks_host(*rows, **kw, head=head, blocks=blocks, warps=warps)
    want = schur_reference(*rows, **kw)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
        else:
            torch.testing.assert_close(g, w, rtol=1e-12, atol=1e-12 * max(w.abs().max().item(), 1))
    assert torch.equal(got[0], got[0].T)
