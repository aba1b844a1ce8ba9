"""The port's CUDA kernels against their plain PyTorch versions on the card.

Needs a CUDA device (marked ``gpu``; skipped elsewhere). Imports neither jax
nor the JAX package, so it runs where only the port is installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_cuda.py

Tolerances are normwise (max |kernel - plain| / max |plain|): 1e-10 in
float64; in float32 1e-3 for the camera-row linearization (cancellation in
the SE3 log / V^-1 coefficients), 1e-4 for the camera-row cost, 1e-4 for
the assembly (~1e4-term sums whose order the atomics change from run to
run) and 1e-4 for the IMU rows (each side is ~1e-6 from float64 at
config-1/2 inputs; the residual y - body cancels). B3's residual equals
B1's on the card to 1e-12 in float64. The query kernels B5 and B7 take
1e-12 in float64 for R3 values (the same basis sums in another order) and
1e-10 for the SO3/SE3 chains (forward mode in the time shift against the
plain closed forms), 1e-4 in float32 (each side rounds at ~1e-6 along a
chain of ~10^2 operations; the derivatives scale by 1/dt^2). B6 (one-hot
row expansion) adds at most two entries per output and equals its plain
version exactly; the segment-BA step on the card equals the port's on the
CPU to 1e-9 relative (B1's and the band solve's float64 roundoff through a
reduced system of condition ~1e6). B1 and B3 on the atan camera and on
lifting rows (every window x camera x rows branch) take the camera rows'
tolerances, and so does B8 (Newton rows) on its four window x camera
branches, linearize and cost-only, on 6- and 10-knot windows. The solver
family on the card against the CPU path: the band solve by the scan and by
PCR (1e-10 of the solution's largest entry), one iterative-Schur step and
one segment-BA step in PCG mode (converged CG; 1e-9 relative, the states
to 1e-8) and one banded-strategy step (1e-9), with their launches. B4 at
the long-sequence path's 200,000 rows of each kind takes 1e-10; its batch
containers compile to the same tensors on the card as on the CPU, and one
banded estimator iteration on their first 20 s agrees to 1e-9."""
import copy

import numpy as np
import pytest
import torch

from kontiki_tpu_torch import TrajectoryEstimator, synthetic
from kontiki_tpu_torch.ops import assembly_kernels as ak
from kontiki_tpu_torch.ops import linearize_kernels as lk
from kontiki_tpu_torch.ops import spline_kernels as sk
from kontiki_tpu_torch.parallel.segments_ba import make_segment_ba_step
from kontiki_tpu_torch.trajectories import SplitTrajectory, spline_eval
from kontiki_tpu_torch.solver import kernels
from kontiki_tpu_torch.solver.lm import make_fused_solver
from kontiki_tpu_torch.solver.problem import Problem
from kontiki_tpu_torch.synthetic import make_gyro_problem, make_imu_problem, make_rsvi_problem
from test_torch_camera_host import regrid, schur_reference, schur_rows

torch.set_num_threads(1)
pytestmark = pytest.mark.gpu
SMALL = dict(nviews=8, nlandmarks=24, imu_rate=200.0, seed=4, noise_px=1.0,
             trajectory="se3")


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(scope="module")
def problems(cuda):
    gen = make_rsvi_problem(**SMALL)
    return (gen, Problem(gen["trajectory"], gen["measurements"], device="cpu"),
            Problem(gen["trajectory"], gen["measurements"], device=cuda))


def _assert_close(got, want, tol):
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert (g - w).abs().max().item() <= tol * w.abs().max().item()


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10), (torch.float32, 1e-3)])
def test_linearize_rows_kernel_matches_plain(problems, dtype, tol):
    problem = problems[2]
    spec, rt = kernels.problem_spec(problem), kernels.problem_runtime(problem)
    cfg, ins, _ = kernels._camera_inputs(spec, rt, problem.state0, rt["data"][0])
    x = {k: v.to(dtype).contiguous() for k, v in ins.items()}
    before = lk.linearize_rows.launches
    got = lk.linearize_rows(cfg, x)
    assert lk.linearize_rows.launches == before + 1
    _assert_close(got, lk.linearize_rows_plain(cfg, x), tol)


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10), (torch.float32, 1e-4)])
def test_assemble_kernel_matches_plain(cuda, dtype, tol):
    rng = np.random.default_rng(3)
    M, rdim, C, P, L = 300, 2, 61, 40, 12
    cols = rng.integers(0, P, size=(M, C)).astype(np.int32)
    cols[:, 1] = cols[:, 0]  # duplicate columns within a row accumulate
    rows = (
        torch.tensor(rng.normal(size=(M, rdim, C)), dtype=dtype, device=cuda),
        torch.tensor(cols, device=cuda),
        torch.tensor(rng.normal(size=(M, rdim)), dtype=dtype, device=cuda),
        torch.tensor(rng.normal(size=(M, rdim)), dtype=dtype, device=cuda),
        torch.tensor(rng.integers(0, L, size=M).astype(np.int32), device=cuda),
    )
    before = ak.assemble_schur_blocks.launches
    shape_before = ak.assemble_schur_blocks.shape_launches.get("rdim 2 C 61", 0)
    got = ak.assemble_schur_blocks(*rows, P=P, L=L, with_rho=True)
    assert ak.assemble_schur_blocks.launches == before + 1
    assert ak.assemble_schur_blocks.shape_launches["rdim 2 C 61"] == shape_before + 1
    _assert_close(got, ak.assemble_schur_blocks_plain(*rows, P=P, L=L, with_rho=True), tol)


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10), (torch.float32, 1e-4)])
@pytest.mark.parametrize("M,P,rdim,C,with_rho", [(600, 600, 2, 61, True), (300, 600, 3, 62, True),
                                                 (300, 194, 2, 61, False), (1, 600, 2, 61, True),
                                                 (0, 600, 2, 61, True)])
def test_assemble_kernel_edge_cases(cuda, M, P, rdim, C, with_rho, dtype, tol):
    """B2 past the head triangle its shared memory holds (P = 600: the
    launch sets the head width below P and adds the rest into H directly),
    with repeated, shared and out-of-range ids and landmarks, without
    landmarks, and on one and no rows."""
    L = 9
    rows = schur_rows(M, P, L, rdim=rdim, C=C, seed=M + rdim, dtype=dtype, device=cuda)
    kw = dict(P=P, L=L, with_rho=with_rho)
    got = ak.assemble_schur_blocks(*rows, **kw)
    want = schur_reference(*rows, **kw)
    if not with_rho:
        assert got[2:] == (None, None, None)
    _assert_close([g for g in got if g is not None], [w for w in want if w is not None], tol)


def test_solve_on_cuda_matches_cpu(problems):
    """The whole slice through the kernels equals the plain CPU path."""
    _, cpu, gpu = problems
    s0, c0, it0 = make_fused_solver(cpu, 5, function_tolerance=0.0)(cpu.state0)
    s1, c1, it1 = make_fused_solver(gpu, 5, function_tolerance=0.0)(gpu.state0)
    assert it1 == it0
    np.testing.assert_allclose(c1.item(), c0.item(), rtol=1e-8)
    for k, v in s1.items():
        np.testing.assert_allclose(v.cpu().numpy(), s0[k].numpy(), rtol=0, atol=1e-7)


@pytest.fixture(scope="module")
def imu_problems(cuda):
    """Config-1 and config-2 shaped problems (1 s at 40 Hz, IMU noise) on
    the CPU and on the card."""
    gens = {"so3": make_gyro_problem(duration=1.0, rate=40.0, seed=1, noise=0.05),
            "split": make_imu_problem(duration=1.0, rate=40.0, seed=2, noise=0.05)}
    return {k: (Problem(g["trajectory"], g["measurements"], device="cpu"),
                Problem(g["trajectory"], g["measurements"], device=cuda))
            for k, g in gens.items()}


def imu_rows_cut(ins, M):
    """The first M of a bucket's [k, n] IMU inputs, its rows repeated as
    needed, every third row with valid = 0 (the ragged-M cases)."""
    n = ins["u_so3"].shape[1]
    x = {k: v.repeat(1, -(-M // n))[:, :M].contiguous() for k, v in ins.items()}
    valid = x.get("valid", torch.ones_like(x["u_so3"])).clone()
    valid[:, ::3] = 0.0
    x["valid"] = valid
    return x


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10), (torch.float32, 1e-4)])
@pytest.mark.parametrize("rows", [None, 1, 127, 129], ids=["bucket", "M1", "M127", "M129"])
@pytest.mark.parametrize("which,kind", [("so3", "gyro"), ("split", "gyro"), ("split", "accel")])
def test_imu_rows_kernel_matches_plain(imu_problems, which, kind, rows, dtype, tol):
    """B4 on a bucket's rows and on ragged M (1, 127, 129 rows: partial
    blocks of the lane kernel and of the cost-only kernel) with rows of
    valid = 0, which give exact zeros."""
    problem = imu_problems[which][1]
    spec, rt = kernels.problem_spec(problem), kernels.problem_runtime(problem)
    (i,) = [i for i, b in enumerate(spec.buckets) if b.kind == kind]
    cfg, ins, _ = kernels._imu_inputs(spec, spec.buckets[i], rt, problem.state0, rt["data"][i])
    if rows is not None:
        ins = imu_rows_cut(ins, rows)
    x = {k: v.to(dtype).contiguous() for k, v in ins.items()}
    for cost_only in (False, True):
        before = lk.imu_rows.launches
        got = lk.imu_rows(cfg, x, cost_only=cost_only)
        assert lk.imu_rows.launches == before + 1
        want = lk.imu_rows_plain(cfg, x, cost_only=cost_only)
        _assert_close((got,) if cost_only else got, (want,) if cost_only else want, tol)
        if rows is not None:
            dead = x["valid"][0] == 0
            for g in ((got,) if cost_only else got):
                assert torch.count_nonzero(g[dead]) == 0


@pytest.mark.parametrize("which", ["so3", "split"])
def test_dense_solve_on_cuda_matches_cpu(imu_problems, which):
    """Configs 1 and 2's path ('auto' -> dense) through B4 equals the plain
    CPU path."""
    cpu, gpu = imu_problems[which]
    s0, c0, it0 = make_fused_solver(cpu, 5, function_tolerance=0.0)(cpu.state0)
    before = lk.imu_rows.launches
    s1, c1, it1 = make_fused_solver(gpu, 5, function_tolerance=0.0)(gpu.state0)
    assert lk.imu_rows.launches > before
    assert it1 == it0
    np.testing.assert_allclose(c1.item(), c0.item(), rtol=1e-8)
    for k, v in s1.items():
        np.testing.assert_allclose(v.cpu().numpy(), s0[k].numpy(), rtol=0, atol=1e-7)


@pytest.fixture(scope="module")
def camera_rows(cuda, problems):
    """Gathered camera rows on the card: SE3 (the config-4-shaped problem)
    and split (config 3's model on distinct R3/SO3 grids)."""
    gen = make_rsvi_problem(nviews=8, nlandmarks=24, imu_rate=0.0, seed=3, noise_px=1.0)
    out = {"split": Problem(regrid(gen["trajectory"]), gen["measurements"], device=cuda),
           "se3": problems[2]}
    rows = {}
    for kind, problem in out.items():
        spec, rt = kernels.problem_spec(problem), kernels.problem_runtime(problem)
        (i,) = [i for i, b in enumerate(spec.buckets) if b.kind == "rs_static"]
        rows[kind] = kernels._camera_inputs(spec, rt, problem.state0, rt["data"][i])[:2]
    return rows


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10), (torch.float32, 1e-3)])
def test_linearize_rows_split_kernel_matches_plain(camera_rows, dtype, tol):
    cfg, ins = camera_rows["split"]
    x = {k: v.to(dtype).contiguous() for k, v in ins.items()}
    before = lk.linearize_rows.launches
    got = lk.linearize_rows(cfg, x)
    assert lk.linearize_rows.launches == before + 1
    _assert_close(got, lk.linearize_rows_plain(cfg, x), tol)


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10), (torch.float32, 1e-4)])
@pytest.mark.parametrize("kind", ["se3", "split"])
def test_cost_rows_kernel_matches_plain(camera_rows, kind, dtype, tol):
    cfg, ins = camera_rows[kind]
    x = {k: v.to(dtype).contiguous() for k, v in ins.items()}
    M = x["u_ref"].shape[1]
    xv = dict(x, valid=(torch.arange(M, device=x["u_ref"].device) % 5 != 2).to(dtype)[None, :])
    for inputs in (x, xv):
        before = lk.cost_rows.launches
        got = lk.cost_rows(cfg, inputs)
        assert lk.cost_rows.launches == before + 1
        _assert_close((got,), (lk.cost_rows_plain(cfg, inputs),), tol)
    if dtype == torch.float64:
        _assert_close((lk.cost_rows(cfg, x),), (lk.linearize_rows(cfg, x)[0],), 1e-12)


def test_estimator_on_cuda_matches_cpu(cuda):
    """``TrajectoryEstimator.solve`` on the card (its default device)
    equals the CPU run; B3 re-costs each iteration's candidate once."""
    summaries, launches = {}, {}
    for device in (None, "cpu"):
        gen = make_rsvi_problem(nviews=8, nlandmarks=24, imu_rate=0.0, seed=3, noise_px=1.0)
        estimator = TrajectoryEstimator(gen["trajectory"], device=device)
        for m in gen["measurements"]:
            estimator.add_measurement(m)
        before = lk.cost_rows.launches
        summaries[device] = estimator.solve(max_iterations=4, progress=False,
                                            function_tolerance=0.0)
        launches[device] = lk.cost_rows.launches - before
    gpu, cpu = summaries[None], summaries["cpu"]
    assert launches == {None: 4, "cpu": 0}  # one camera bucket, 4 iterations
    assert [it.step_is_successful for it in gpu.iterations] == [
        it.step_is_successful for it in cpu.iterations]
    for g, c in zip(gpu.iterations, cpu.iterations):
        np.testing.assert_allclose(g.cost, c.cost, rtol=1e-8)
    assert gpu.num_residual_blocks == cpu.num_residual_blocks


def _query_windows(kind, cuda, M=5000, seed=0, order="random"):
    """Windows and u of M row times on a generated trajectory, on the card:
    uniform random times, or the same sorted ("frame order")."""
    rng = np.random.default_rng(seed)
    if kind == "se3":
        knots = synthetic.make_se3_trajectory(20.0, seed=5).knots
    else:
        traj = synthetic.make_split_trajectory(20.0, seed=5)
        knots = (traj.R3_spline if kind == "r3" else traj.SO3_spline).knots
    k = torch.tensor(knots, device=cuda)
    ts = rng.uniform(0.0, 20.0, M)
    ts = torch.tensor(np.sort(ts) if order == "frame order" else ts, device=cuda)
    i0, u = spline_eval.index_and_u(ts, 0.0, 0.1, k.shape[0])
    return spline_eval.gather_windows(k, i0).contiguous(), u.contiguous()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("M", [5000, 1, 127, 129])
@pytest.mark.parametrize("order", ["random", "frame order"])
@pytest.mark.parametrize("kind", ["r3", "so3", "se3"])
def test_evaluate_windows_kernel_matches_plain(cuda, kind, order, M, dtype):
    """B5 in both orders and on ragged M (partial blocks), with a window of
    equal knots first where M > 1 (the log/exp Taylor branches; alone its
    angular velocity is roundoff, which no relative gate can hold)."""
    win, u = _query_windows(kind, cuda, M=M, order=order)
    win, u = win.to(dtype), u.to(dtype)
    if kind != "r3" and M > 1:
        win[0] = win[0, :1]
    before = dict(lk.evaluate_windows.launches)
    got = lk.evaluate_windows(kind, win, u, 0.1)
    assert lk.evaluate_windows.launches[kind] == before[kind] + 1
    tol = 1e-4 if dtype == torch.float32 else 1e-12 if kind == "r3" else 1e-10
    _assert_close(got, lk.evaluate_windows_plain(kind, win, u, 0.1), tol)


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-4)])
@pytest.mark.parametrize("case", ["shuffled", "wide span"])
def test_r3_evaluate_kernel_matches_plain(cuda, case, dtype, tol):
    rng = np.random.default_rng(11)
    n = 2000
    knots = torch.tensor(rng.normal(size=(n, 3)), dtype=dtype, device=cuda)
    if case == "shuffled":
        ts = rng.permutation(np.linspace(-0.5, n - 3 + 0.5, 100_000))
    else:  # each 256 consecutive times span far more than 512 knots
        ts = np.linspace(0.0, (n - 3) - 1e-3, 1024)
    ts = torch.tensor(ts, dtype=dtype, device=cuda)
    before = sk.r3_evaluate_kernel.launches
    got = sk.r3_evaluate_kernel(knots, 0.0, 1.0, ts)
    assert sk.r3_evaluate_kernel.launches == before + 1
    _assert_close(got, sk.r3_evaluate_plain(knots, 0.0, 1.0, ts), tol)
    empty = sk.r3_evaluate_kernel(knots, 0.0, 1.0, ts[:0])
    assert empty[0].shape == (0, 3) and sk.r3_evaluate_kernel.launches == before + 1


def test_cuda_calls_launch_and_never_take_the_plain_path(cuda, monkeypatch):
    def forbidden(*args, **kwargs):
        raise AssertionError("the plain version ran for a CUDA tensor")

    monkeypatch.setattr(lk, "evaluate_windows_plain", forbidden)
    monkeypatch.setattr(sk, "r3_evaluate_plain", forbidden)
    win, u = _query_windows("se3", cuda, M=300)
    before = lk.evaluate_windows.launches["se3"]
    lk.evaluate_windows("se3", win, u, 0.1)
    assert lk.evaluate_windows.launches["se3"] == before + 1
    knots = torch.zeros(10, 3, dtype=torch.float64, device=cuda)
    before = sk.r3_evaluate_kernel.launches
    sk.r3_evaluate_kernel(knots, 0.0, 1.0, torch.rand(7, dtype=torch.float64, device=cuda))
    assert sk.r3_evaluate_kernel.launches == before + 1


def test_default_device_queries_run_on_the_card(cuda):
    """Trajectories built with ``device=None`` query through B5 on the card
    (split: one r3 and one so3 launch per query) and equal the CPU
    queries."""
    traj = synthetic.make_split_trajectory(5.0, seed=5)
    se3 = synthetic.make_se3_trajectory(5.0, seed=5)
    ts = np.linspace(0.0, 5.0, 101, endpoint=False)
    cpu = SplitTrajectory(traj.R3_spline, traj.SO3_spline, device="cpu")
    for q in ("position", "angular_velocity"):
        before = dict(lk.evaluate_windows.launches)
        got = getattr(traj, q)(ts)
        after = lk.evaluate_windows.launches
        assert (after["r3"] - before["r3"], after["so3"] - before["so3"]) == (1, 1)
        np.testing.assert_allclose(got, getattr(cpu, q)(ts), rtol=1e-10, atol=1e-12)
    before = lk.evaluate_windows.launches["se3"]
    X = np.ones(3)
    np.testing.assert_allclose(se3.to_world(se3.from_world(X, ts), ts), np.tile(X, (101, 1)),
                               atol=1e-12)
    assert lk.evaluate_windows.launches["se3"] == before + 2


def test_pose_estimator_on_cuda_matches_cpu(cuda):
    truth = synthetic.make_split_trajectory(2.0, dt=0.1, seed=6)
    ms = synthetic.make_pose_measurements(truth, 0.0, 2.0, 50.0, 0.002, 0.002, seed=8)
    summaries = {}
    for device in (None, "cpu"):
        estimator = TrajectoryEstimator(synthetic.perturb_trajectory(truth, seed=7),
                                        device=device)
        for m in ms:
            estimator.add_measurement(m)
        summaries[device] = estimator.solve(max_iterations=3, progress=False,
                                            function_tolerance=0.0)
    for g, c in zip(summaries[None].iterations, summaries["cpu"].iterations):
        np.testing.assert_allclose(g.cost, c.cost, rtol=1e-8)


def _expand_inputs(M, dtype, device, WB=109, C=61, seed=0):
    """Random B6 inputs: each row draws its ids from [-1, WB] with every id
    at most twice, so duplicates and both kinds of out-of-range id occur
    (and, as in camera rows, no id more than twice)."""
    g = torch.Generator().manual_seed(seed)
    Jw = torch.randn(M, 2, C, generator=g, dtype=torch.float64).to(dtype)
    pool = torch.rand(M, 2 * (WB + 2), generator=g).argsort(dim=1)[:, :C]
    return Jw.to(device), (pool // 2 - 1).to(device)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("M", [0, 1, 300, 1037])
def test_onehot_expand_kernel_matches_plain(cuda, M, dtype):
    Jw, rel = _expand_inputs(M, dtype, cuda)
    before = lk.onehot_expand_rows.launches
    got = lk.onehot_expand_rows(Jw, rel, 109)
    torch.cuda.synchronize()
    assert lk.onehot_expand_rows.launches == before + (M > 0)
    assert got.shape == (M, 2, 109) and got.dtype == dtype
    assert torch.equal(got, lk.onehot_expand_rows_plain(Jw, rel, 109))


def test_onehot_expand_kernel_wide_rows(cuda):
    """A pair window wider than the 48 KB of default shared memory per
    block of rows (one float64 row of 2 x 4,000 columns)."""
    Jw, rel = _expand_inputs(37, torch.float64, cuda, WB=4000)
    got = lk.onehot_expand_rows(Jw, rel, 4000)
    assert torch.equal(got, lk.onehot_expand_rows_plain(Jw, rel, 4000))


def test_onehot_expand_cuda_never_takes_the_plain_path(cuda, monkeypatch):
    def forbidden(*args, **kwargs):
        raise AssertionError("the plain version ran for a CUDA tensor")

    monkeypatch.setattr(lk, "onehot_expand_rows_plain", forbidden)
    Jw, rel = _expand_inputs(64, torch.float64, cuda)
    lk.onehot_expand_rows(Jw, rel, 109)
    with pytest.raises(ValueError):
        lk.onehot_expand_rows(Jw, rel.to(torch.int32), 109)


@pytest.mark.parametrize("imu_rate", [0.0, 50.0])
def test_segment_ba_step_on_cuda_matches_cpu(cuda, imu_rate):
    out = {}
    for device in (cuda, "cpu"):
        big = synthetic.make_big_ba_problem(n_views=40, n_landmarks=120, obs_per_landmark=4,
                                            seed=11, imu_rate=imu_rate, device=device)
        step, total_cost = make_segment_ba_step(big["problem"])
        before = (lk.onehot_expand_rows.launches, lk.linearize_rows.split_launches)
        out[str(device)] = step(big["problem"].state0, 1e-4) + (
            total_cost(big["problem"].state0),)
        after = (lk.onehot_expand_rows.launches, lk.linearize_rows.split_launches)
        if device == cuda:
            assert after == (before[0] + 1 + (imu_rate > 0) * 2, before[1] + 1)
    gpu, cpu = out["cuda"], out["cpu"]
    for i in (0, 2, 3, 4, 5):
        np.testing.assert_allclose(gpu[i].item(), cpu[i].item(), rtol=1e-9)
    for k, v in cpu[1].items():
        np.testing.assert_allclose(gpu[1][k].cpu().numpy(), v.numpy(), rtol=0, atol=1e-9)


BRANCHES = [f"{kind} {camera} {rows}" for kind in ("se3", "split")
            for camera in ("pinhole", "atan") for rows in ("static", "lifting")]


@pytest.fixture(scope="module")
def branch_rows(cuda):
    """Camera rows of every B1/B3 branch on the card: each window kind's
    rows of an atan lifting problem, and the same rows without the atan or
    the lifting inputs for the other branches."""
    rows = {}
    for kind in ("se3", "split"):
        gen = make_rsvi_problem(nviews=8, nlandmarks=24, imu_rate=0.0, seed=3,
                                noise_px=1.0, camera_kind="atan", rs="lifting",
                                trajectory=kind)
        traj = regrid(gen["trajectory"]) if kind == "split" else gen["trajectory"]
        problem = Problem(traj, gen["measurements"], device=cuda)
        spec, rt = kernels.problem_spec(problem), kernels.problem_runtime(problem)
        cfg, ins = kernels._camera_inputs(spec, rt, problem.state0, rt["data"][0])[:2]
        assert (cfg["camera"], cfg["lifting"]) == ("AtanCamera", True)
        for camera in ("PinholeCamera", "AtanCamera"):
            for lifting in (False, True):
                c = dict(cfg, camera=camera, lifting=lifting, rdim=2 + lifting,
                         C=61 + lifting)
                names = {s[0] for s in lk.camera_inputs(c) if s is not None}
                rows[lk.camera_branch(c)] = (c, {k: v for k, v in ins.items() if k in names})
    return rows


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10), (torch.float32, 1e-3)])
@pytest.mark.parametrize("branch", BRANCHES)
def test_camera_branch_kernels_match_plain(branch_rows, branch, dtype, tol):
    """B1 and B3 on each window x camera x rows branch against their plain
    versions, with and without ``valid``; each launch counts on its branch."""
    cfg, ins = branch_rows[branch]
    x = {k: v.to(dtype).contiguous() for k, v in ins.items()}
    M = x["u_ref"].shape[1]
    xv = dict(x, valid=(torch.arange(M, device=x["u_ref"].device) % 5 != 2).to(dtype)[None, :])
    rdim, C = lk.camera_shape(cfg)
    for inputs in (x, xv):
        before = (lk.linearize_rows.branch_launches.get(branch, 0),
                  lk.cost_rows.branch_launches.get(branch, 0))
        got = lk.linearize_rows(cfg, inputs)
        r = lk.cost_rows(cfg, inputs)
        assert (lk.linearize_rows.branch_launches[branch],
                lk.cost_rows.branch_launches[branch]) == (before[0] + 1, before[1] + 1)
        assert got[1].shape == (M, rdim, C) and r.shape == (M, rdim)
        _assert_close(got, lk.linearize_rows_plain(cfg, inputs), tol)
        _assert_close((r,), (lk.cost_rows_plain(cfg, inputs),), max(tol, 1e-4)
                      if dtype == torch.float32 else tol)
    if dtype == torch.float64:
        _assert_close((lk.cost_rows(cfg, x),), (lk.linearize_rows(cfg, x)[0],), 1e-12)


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10), (torch.float32, 1e-4)])
@pytest.mark.parametrize("rows", ["M1", "M7", "M129", "wave-1", "wave+1"])
@pytest.mark.parametrize("branch", ["se3 pinhole static", "split pinhole static",
                                    "split atan lifting"])
def test_cost_rows_ragged_rows(cuda, branch_rows, branch, rows, dtype, tol):
    """B3 on M = 1, 7 and 129 rows and on one wave of its lane kernel less
    and plus one row (the lane kernel's and the one-row-per-thread kernel's
    ragged last blocks), the branch's rows repeated to length, every third
    row at valid = 0 (exactly zero there); in float64 also against B1's
    residual (1e-12)."""
    cfg, ins = branch_rows[branch]
    wave = lk.cost_rows_wave(cfg, dtype)
    M = {"M1": 1, "M7": 7, "M129": 129, "wave-1": wave - 1, "wave+1": wave + 1}[rows]
    reps = -(-M // ins["u_ref"].shape[1])
    x = {k: v.repeat(1, reps)[:, :M].to(dtype).contiguous() for k, v in ins.items()}
    x["valid"] = (torch.arange(M, device=cuda) % 3 != 1).to(dtype)[None, :]
    before = lk.cost_rows.launches
    r = lk.cost_rows(cfg, x)
    assert lk.cost_rows.launches == before + 1 and r.shape == (M, lk.camera_shape(cfg)[0])
    _assert_close((r,), (lk.cost_rows_plain(cfg, x),), tol)
    assert torch.all(r[x["valid"][0] == 0] == 0)
    if dtype == torch.float64:
        _assert_close((r,), (lk.linearize_rows(cfg, x)[0],), 1e-12)


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-4)])
@pytest.mark.parametrize("B", [1, 255, 257, 1023, 1025, 4099])
@pytest.mark.parametrize("N", [4, 40])
def test_r3_evaluate_kernel_edges(cuda, N, B, dtype, tol):
    """B7 on batch sizes about a block of 1,024 times, on a spline of one
    window (N = 4) and of 40 knots, at sorted times from before t0 to past
    the last window's end (the clamped windows), then the same times
    shuffled."""
    rng = np.random.default_rng(100 * N + B)
    t0, dt = 0.3, 0.25
    ts = np.sort(rng.uniform(t0 - 2 * dt, t0 + N * dt, B))
    knots = torch.tensor(rng.normal(size=(N, 3)), dtype=dtype, device=cuda)
    for order in (ts, rng.permutation(ts)):
        t = torch.tensor(order, dtype=dtype, device=cuda)
        _assert_close(sk.r3_evaluate_kernel(knots, t0, dt, t),
                      sk.r3_evaluate_plain(knots, t0, dt, t), tol)


def test_atan_lifting_solve_on_cuda_matches_cpu(cuda):
    """The fused Schur solve of an atan lifting problem on the card equals
    the CPU run; the row times stay in [0, 1]."""
    out = {}
    for device in ("cpu", cuda):
        gen = make_rsvi_problem(nviews=8, nlandmarks=24, imu_rate=0.0, seed=3, noise_px=1.0,
                                camera_kind="atan", rs="lifting")
        problem = Problem(gen["trajectory"], gen["measurements"], device=device)
        out[str(device)] = make_fused_solver(problem, 8, function_tolerance=0.0,
                                             strategy="schur")(problem.state0)
    (cs, cc, ci), (gs, gc, gi) = out["cpu"], out["cuda"]
    assert ci == gi == 8
    np.testing.assert_allclose(gc.item(), cc.item(), rtol=1e-9)
    np.testing.assert_allclose(gs["vt"].cpu().numpy(), cs["vt"].numpy(), rtol=0, atol=1e-8)
    assert 0.0 <= gs["vt"].min().item() and gs["vt"].max().item() <= 1.0


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-3)])
@pytest.mark.parametrize("M", [1, 7, 129])
@pytest.mark.parametrize("branch", ["se3 pinhole static", "split atan lifting"])
def test_linearize_rows_ragged_rows(branch_rows, branch, M, dtype, tol):
    """B1 on row counts that leave the last lane group and block ragged,
    every third row with valid = 0 (exact zeros)."""
    cfg, ins = branch_rows[branch]
    n = min(M, ins["u_ref"].shape[1])
    x = {k: v[:, :n].to(dtype).contiguous() for k, v in ins.items()}
    x["valid"] = (torch.arange(n, device=x["u_ref"].device) % 3 != 1).to(dtype)[None, :]
    got = lk.linearize_rows(cfg, x)
    _assert_close(got, lk.linearize_rows_plain(cfg, x), tol)
    off = x["valid"][0] == 0
    assert all(bool((a[off] == 0).all()) for a in got)


NEWTON_BRANCHES = ("se3 pinhole", "se3 atan", "split pinhole", "split atan")


@pytest.fixture(scope="module")
def newton_rows_cuda(cuda):
    """B8's rows of every branch on the card: each window kind's rows of a
    Newton atan problem (camera pose and time offset free), and the same
    rows without the atan inputs for the pinhole branches."""
    rows = {}
    for kind in ("se3", "split"):
        gen = make_rsvi_problem(nviews=8, nlandmarks=24, imu_rate=0.0, seed=43, noise_px=1.0,
                                perturb_rho=0.05, camera_kind="atan", rs="newton",
                                trajectory=kind)
        cam = gen["camera"]
        cam.relative_orientation_locked = cam.relative_position_locked = False
        cam.max_time_offset, cam.time_offset_locked = 0.01, False
        problem = Problem(gen["trajectory"], gen["measurements"], device=cuda)
        spec, rt = kernels.problem_spec(problem), kernels.problem_runtime(problem)
        cfg, ins = kernels._newton_inputs(spec, spec.buckets[0], rt, problem.state0,
                                          rt["data"][0])[:2]
        assert cfg["camera"] == "AtanCamera" and max(cfg["Ws"]) > 4
        for camera in ("PinholeCamera", "AtanCamera"):
            c = dict(cfg, camera=camera)
            names = {s[0] for s in lk.newton_inputs(c) if s is not None}
            rows[lk.newton_branch(c)] = (c, {k: v for k, v in ins.items() if k in names})
    return rows


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10), (torch.float32, 1e-3)])
@pytest.mark.parametrize("branch", NEWTON_BRANCHES)
def test_newton_rows_kernel_matches_plain(newton_rows_cuda, branch, dtype, tol):
    """B8 linearize and cost-only on each window x camera branch against the
    plain version, with and without ``valid``; each launch counts on its
    branch and form; in float64 the cost-only residual equals the
    linearize form's."""
    cfg, ins = newton_rows_cuda[branch]
    x = {k: v.to(dtype).contiguous() for k, v in ins.items()}
    M = x["u_ref"].shape[1]
    xv = dict(x, valid=(torch.arange(M, device=x["u_ref"].device) % 5 != 2).to(dtype)[None, :])
    C = lk.newton_shape(cfg)[1]
    for inputs in (x, xv):
        before = (lk.newton_rows.branch_launches.get(branch, 0),
                  lk.newton_rows.branch_launches.get(f"{branch} cost-only", 0))
        got = lk.newton_rows(cfg, inputs)
        r = lk.newton_rows(cfg, inputs, cost_only=True)
        assert (lk.newton_rows.branch_launches[branch],
                lk.newton_rows.branch_launches[f"{branch} cost-only"]) == (before[0] + 1,
                                                                          before[1] + 1)
        assert got[1].shape == (M, 2, C) and r.shape == (M, 2)
        _assert_close(got, lk.newton_rows_plain(cfg, inputs), tol)
        _assert_close((r,), (lk.newton_rows_plain(cfg, inputs, cost_only=True),),
                      max(tol, 1e-4) if dtype == torch.float32 else tol)
    if dtype == torch.float64:
        _assert_close((lk.newton_rows(cfg, x, cost_only=True),), (lk.newton_rows(cfg, x)[0],),
                      1e-10)


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10), (torch.float32, 1e-3)])
@pytest.mark.parametrize("rows", ["M1", "M7", "M129", "wave-1", "wave+1"])
@pytest.mark.parametrize("branch", ["split pinhole", "se3 atan"])
def test_newton_rows_ragged_rows(cuda, newton_rows_cuda, branch, rows, dtype, tol):
    """B8 on M = 1, 7 and 129 rows and on one wave of its linearize kernel
    less and plus one row (ragged last blocks of both kernels), the
    branch's rows repeated to length, every third row at valid = 0 (exactly
    zero there)."""
    cfg, ins = newton_rows_cuda[branch]
    wave = lk.newton_rows_wave(cfg, dtype)
    M = {"M1": 1, "M7": 7, "M129": 129, "wave-1": wave - 1, "wave+1": wave + 1}[rows]
    reps = -(-M // ins["u_ref"].shape[1])
    x = {k: v.repeat(1, reps)[:, :M].to(dtype).contiguous() for k, v in ins.items()}
    x["valid"] = (torch.arange(M, device=cuda) % 3 != 1).to(dtype)[None, :]
    got = lk.newton_rows(cfg, x)
    r = lk.newton_rows(cfg, x, cost_only=True)
    _assert_close(got, lk.newton_rows_plain(cfg, x), tol)
    _assert_close((r,), (lk.newton_rows_plain(cfg, x, cost_only=True),),
                  max(tol, 1e-4) if dtype == torch.float32 else tol)
    off = x["valid"][0] == 0
    for a in (*got, r):
        assert torch.all(a[off] == 0)


@pytest.fixture(scope="module")
def newton_w10_cuda(cuda):
    """B8's rows of every branch on 10-knot windows (knots closer than
    readout / 3: the default camera's 0.025 s over 4.5), their first rows
    at the edges of the Newton path (``synthetic.newton_edge_rows``: updates
    clamped at 0 and at the readout, five steps, steps across knots)."""
    rows = {}
    for kind in ("se3", "split"):
        gen = make_rsvi_problem(nviews=8, nlandmarks=24, imu_rate=0.0, seed=43, noise_px=1.0,
                                perturb_rho=0.05, camera_kind="atan", rs="newton",
                                trajectory=kind, knot_dt=0.025 / 4.5)
        problem = Problem(gen["trajectory"], gen["measurements"], device=cuda)
        spec, rt = kernels.problem_spec(problem), kernels.problem_runtime(problem)
        cfg, ins = kernels._newton_inputs(spec, spec.buckets[0], rt, problem.state0,
                                          rt["data"][0])[:2]
        assert max(cfg["Ws"]) == 10
        ins = synthetic.newton_edge_rows(ins)
        for camera in ("PinholeCamera", "AtanCamera"):
            c = dict(cfg, camera=camera)
            names = {s[0] for s in lk.newton_inputs(c) if s is not None}
            rows[lk.newton_branch(c)] = (c, {k: v for k, v in ins.items() if k in names})
    return rows


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10), (torch.float32, 1e-3)])
@pytest.mark.parametrize("branch", NEWTON_BRANCHES)
def test_newton_rows_w10_edges(newton_w10_cuda, branch, dtype, tol):
    """B8 linearize and cost-only on 10-knot windows, with rows at the
    edges of the Newton path, every third row at valid = 0 (exactly zero
    there), against the plain version."""
    cfg, ins = newton_w10_cuda[branch]
    M = ins["u_ref"].shape[1]
    x = {k: v.to(dtype).contiguous() for k, v in ins.items()}
    x["valid"] = (torch.arange(M, device=x["u_ref"].device) % 3 != 1).to(dtype)[None, :]
    got = lk.newton_rows(cfg, x)
    r = lk.newton_rows(cfg, x, cost_only=True)
    _assert_close(got, lk.newton_rows_plain(cfg, x), tol)
    _assert_close((r,), (lk.newton_rows_plain(cfg, x, cost_only=True),),
                  max(tol, 1e-4) if dtype == torch.float32 else tol)
    off = x["valid"][0] == 0
    for a in (*got, r):
        assert torch.all(a[off] == 0)


def test_newton_rows_refuses_windows_past_shared_memory(cuda):
    """The wrapper refuses, naming the card's limit, windows whose block of
    rows would not fit in shared memory (80-knot SE3 windows), and launches
    nothing; 10-knot windows fit."""
    cfg = dict(kind="se3", camera="PinholeCamera", Ws=(80,))
    ins = {name: torch.zeros(k, 1, dtype=torch.float64, device=cuda)
           for name, k in (s for s in lk.newton_inputs(cfg) if s is not None)}
    need, limit = lk.newton_rows_smem(cfg)
    assert need > limit >= 200_000
    assert lk.newton_rows_smem(dict(cfg, Ws=(10,)))[0] < limit
    before = lk.newton_rows.launches
    with pytest.raises(NotImplementedError, match=f"more than the card's {limit}"):
        lk.newton_rows(cfg, ins)
    assert lk.newton_rows.launches == before


def test_newton_solve_on_cuda_matches_cpu(cuda):
    """The fused Schur solve of a Newton problem (split, with IMU rows) on
    the card equals the CPU run, through B8, B4 and B2."""
    out = {}
    for device in ("cpu", cuda):
        gen = make_rsvi_problem(nviews=8, nlandmarks=24, imu_rate=200.0, seed=4, noise_px=1.0,
                                rs="newton")
        problem = Problem(gen["trajectory"], gen["measurements"], device=device)
        before = lk.newton_rows.launches
        out[str(device)] = make_fused_solver(problem, 5, function_tolerance=0.0,
                                             strategy="schur")(problem.state0)
        assert lk.newton_rows.launches - before == (6 if device == cuda else 0)
    (_, cc, ci), (_, gc, gi) = out["cpu"], out["cuda"]
    assert ci == gi == 5
    np.testing.assert_allclose(gc.item(), cc.item(), rtol=1e-9)


@pytest.mark.parametrize("method", ["scan", "pcr"])
@pytest.mark.parametrize("nb,d,R", [(1, 12, 1), (13, 12, 14), (64, 48, 14)])
def test_band_solve_on_cuda_matches_cpu(cuda, method, nb, d, R):
    """The band solve (PCR) and its scan reference on the card against the
    CPU runs and each other (1e-10 of the solution's largest entry)."""
    from kontiki_tpu_torch.solver.banded import _scan_solve, block_tridiag_solve

    solves = {"scan": _scan_solve, "pcr": block_tridiag_solve}
    rng = np.random.default_rng(nb + d)
    D = rng.normal(size=(nb, d, d))
    D = torch.from_numpy(D @ D.transpose(0, 2, 1) + 4 * d * np.eye(d))
    U = torch.from_numpy(rng.normal(size=(nb, d, d)))
    rhs = torch.from_numpy(rng.normal(size=(nb, d, R)))
    cpu = solves[method](D, U, rhs)
    gpu = solves[method](D.to(cuda), U.to(cuda), rhs.to(cuda)).cpu()
    scale = cpu.abs().max().item()
    assert (gpu - cpu).abs().max().item() <= 1e-10 * scale
    other = solves["pcr" if method == "scan" else "scan"](D, U, rhs)
    assert (other - cpu).abs().max().item() <= 1e-10 * scale


def test_iterative_step_on_cuda_matches_cpu(cuda, problems):
    """One iterative-Schur step (converged CG) of the SE3 camera problem on
    the card equals the CPU run, through B1 and without B2."""
    from kontiki_tpu_torch.solver.iterative import make_iterative_step

    out = {}
    for problem in problems[1:]:
        before = (lk.linearize_rows.launches, ak.assemble_schur_blocks.launches)
        out[problem.device.type] = make_iterative_step(problem, cg_tol=1e-14,
                                                       cg_maxiter=2000)[0](problem.state0, 1e-3)
        after = (lk.linearize_rows.launches, ak.assemble_schur_blocks.launches)
        if problem.device.type == "cuda":
            assert after[0] == before[0] + 1 and after[1] == before[1]
    gpu, cpu = out["cuda"], out["cpu"]
    for i in (0, 2, 3, 5):
        np.testing.assert_allclose(gpu[i].item(), cpu[i].item(), rtol=1e-9)
    for k, v in cpu[1].items():
        np.testing.assert_allclose(gpu[1][k].cpu().numpy(), v.numpy(), rtol=0, atol=1e-8)


@pytest.mark.parametrize("method", ["scan", "pcr"])
def test_banded_step_on_cuda_matches_cpu(cuda, method, monkeypatch):
    """One banded-strategy step of config 2's model (1 s) on the card equals
    the CPU run, through B4, with the band solve (PCR) or its scan
    reference."""
    from kontiki_tpu_torch.solver import banded
    from kontiki_tpu_torch.solver.banded import make_banded_step

    if method == "scan":
        monkeypatch.setattr(banded, "block_tridiag_solve", banded._scan_solve)
    out = {}
    for device in ("cpu", cuda):
        gen = make_imu_problem(duration=1.0, rate=100.0, seed=2)
        problem = Problem(gen["trajectory"], gen["measurements"], device=device)
        before = lk.imu_rows.launches
        out[str(device)] = make_banded_step(problem)[0](problem.state0, 1e-3)
        assert lk.imu_rows.launches - before == (4 if device == cuda else 0)
    gpu, cpu = out["cuda"], out["cpu"]
    for i in (0, 2, 3, 5):
        np.testing.assert_allclose(gpu[i].item(), cpu[i].item(), rtol=1e-9)
    np.testing.assert_allclose(gpu[4].cpu().numpy(), cpu[4].numpy(), rtol=0, atol=1e-10)


def test_segment_ba_pcg_step_on_cuda_matches_cpu(cuda):
    """One segment-BA step in PCG mode (converged CG) on the card equals the
    CPU run, through B1 and without B6."""
    out = {}
    for device in (cuda, "cpu"):
        big = synthetic.make_big_ba_problem(n_views=40, n_landmarks=120, obs_per_landmark=4,
                                            seed=11, imu_rate=50.0, device=device)
        step, _ = make_segment_ba_step(big["problem"], mode="pcg", cg_tol=1e-12,
                                       cg_maxiter=400)
        before = (lk.onehot_expand_rows.launches, lk.linearize_rows.split_launches)
        out[str(device)] = step(big["problem"].state0, 1e-4)
        after = (lk.onehot_expand_rows.launches, lk.linearize_rows.split_launches)
        if device == cuda:
            assert after == (before[0], before[1] + 1)
    gpu, cpu = out["cuda"], out["cpu"]
    for i in (0, 2, 3, 4):
        np.testing.assert_allclose(gpu[i].item(), cpu[i].item(), rtol=1e-9)
    for k, v in cpu[1].items():
        np.testing.assert_allclose(gpu[1][k].cpu().numpy(), v.numpy(), rtol=0, atol=1e-8)


@pytest.fixture(scope="module")
def long_imu(cuda):
    """The long-sequence path's 1,000 s recording (200,000 gyro and 200,000
    accel rows in batch containers) compiled on the card and on the CPU."""
    gen = synthetic.make_long_imu_problem()
    return (gen, Problem(gen["trajectory"], gen["measurements"], device=cuda),
            Problem(gen["trajectory"], gen["measurements"], device="cpu"))


@pytest.mark.parametrize("cost_only", [False, True], ids=["linearize", "cost-only"])
@pytest.mark.parametrize("kind", ["gyro", "accel"])
def test_imu_rows_kernel_at_200k_rows(long_imu, kind, cost_only):
    """B4 at the long path's 200,000 rows of each kind (float64, 1e-10)."""
    problem = long_imu[1]
    spec, rt = kernels.problem_spec(problem), kernels.problem_runtime(problem)
    (i,) = [i for i, b in enumerate(spec.buckets) if b.kind == kind]
    cfg, ins, _ = kernels._imu_inputs(spec, spec.buckets[i], rt, problem.state0, rt["data"][i])
    assert ins["u_so3"].shape[1] == 200_000
    before = lk.imu_rows.launches
    got = lk.imu_rows(cfg, ins, cost_only=cost_only)
    assert lk.imu_rows.launches == before + 1
    want = lk.imu_rows_plain(cfg, ins, cost_only=cost_only)
    _assert_close((got,) if cost_only else got, (want,) if cost_only else want, 1e-10)


def test_batch_problem_on_cuda_equals_cpu(long_imu):
    """The containers compile to the same tensors on the card as on the
    CPU (the native helper's activation, the splice), and one banded
    estimator iteration on the first 20 s agrees (1e-9)."""
    gen, gpu, cpu = long_imu
    assert gpu.device.type == "cuda" and cpu.device.type == "cpu"
    assert list(gpu.buckets) == list(cpu.buckets) == ["gyro", "accel"]
    for key, b in gpu.buckets.items():
        assert b.M == cpu.buckets[key].M == 200_000
        for k, v in b.data.items():
            assert v.device.type == "cuda" and torch.equal(v.cpu(), cpu.buckets[key].data[k])
    for k, v in gpu.state0.items():
        assert torch.equal(v.cpu(), cpu.state0[k]), k
    assert torch.equal(gpu.mask.cpu(), cpu.mask)
    for name in ("num_parameters", "num_parameter_blocks", "num_parameters_reduced",
                 "num_parameter_blocks_reduced", "num_residuals", "num_residual_blocks",
                 "num_residuals_reduced", "num_residual_blocks_reduced"):
        assert getattr(gpu, name) == getattr(cpu, name), name
    costs = {}
    for device in (None, "cpu"):
        # copies: the solve writes back into the trajectory and the IMU
        traj, batches = copy.deepcopy((gen["trajectory"], gen["measurements"]))
        if device == "cpu":
            traj = SplitTrajectory(traj.R3_spline, traj.SO3_spline, device="cpu")
        est = TrajectoryEstimator(traj, device=device)
        for m in batches:
            est.add_measurement(type(m)(m.imu, m.t[m.t < 20.5],
                                        getattr(m, m._value_field)[m.t < 20.5],
                                        weight=m.weight[m.t < 20.5]))
        summary = est.solve(max_iterations=1, progress=False, strategy="banded",
                            function_tolerance=0.0)
        costs[device] = [it.cost for it in summary.iterations]
    np.testing.assert_allclose(costs[None], costs["cpu"], rtol=1e-9)
