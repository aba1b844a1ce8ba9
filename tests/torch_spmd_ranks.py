"""Rank-side functions of the port's multi-process tests
(``tests/test_torch_mesh.py``, ``test_torch_sharded*.py``,
``test_torch_segments_ba.py``): each runs on every rank of a
``parallel.launch.run_spmd`` world on the CPU and returns what the test
module's parent process checks. This module imports no jax and nothing of
the JAX package: the ranks import it by name, and the parent computes the
JAX package's values."""
import torch
import torch.distributed as dist

from kontiki_tpu_torch import interop
from kontiki_tpu_torch.parallel import Mesh

torch.set_num_threads(1)


def pairs_cases(n):
    """ppermute pair lists at n shards: cyclic both ways, a shift by two,
    only shard 0 receiving, self pairs, and a mix of a self pair and a
    send."""
    cases = {
        "cyclic right": [(i, (i + 1) % n) for i in range(n)],
        "cyclic left": [(i, (i - 1) % n) for i in range(n)],
        "one receiver": [(n - 1, 0)],
        "self": [(i, i) for i in range(n)],
        "self and a send": [(0, 0), (1, n - 1)] if n > 2 else [(0, 0)],
    }
    if n > 2:
        cases["shift by two"] = [(i, (i + 2) % n) for i in range(n)]
    return cases


def rank_value(rank, shape=(3, 2)):
    """The tensor shard ``rank`` contributes (distinct per shard)."""
    g = torch.Generator().manual_seed(100 + rank)
    return torch.randn(*shape, dtype=torch.float64, generator=g)


def _subgroups(mesh):
    """The world's mesh, and this rank's mesh of the pairs {0, 1}, {2, 3}
    (every rank creates every group, in order)."""
    world = dist.get_world_size()
    pairs = [list(range(i, min(i + 2, world))) for i in range(0, world, 2)]
    groups = [dist.new_group(p) for p in pairs]
    for p, g in zip(pairs, groups):
        if dist.get_rank() in p:
            return Mesh(g, mesh.device), p
    raise AssertionError("rank in no pair")


def _collectives(mesh):
    x = rank_value(mesh.rank)
    out = dict(rank=mesh.rank, size=mesh.size,
               psum=mesh.psum(x), pmax=mesh.pmax(x),
               psum_list=mesh.psum([x, x[0, 0] * 2.0]),
               allgather=mesh.allgather(x))
    for name, pairs in pairs_cases(mesh.size).items():
        out[f"ppermute {name}"] = mesh.ppermute(x, pairs)
    out["ppermute list"] = mesh.ppermute([x, x[:, 0]], pairs_cases(mesh.size)["cyclic right"])
    mesh.barrier()
    return out


def _spike(mesh, system):
    from kontiki_tpu_torch.solver.banded import spike_block_tridiag_solve

    D, U, rhs = (torch.as_tensor(a) for a in system)
    sb = D.shape[0] // mesh.size
    part = [a[mesh.rank * sb:(mesh.rank + 1) * sb] for a in (D, U, rhs)]
    return spike_block_tridiag_solve(*part, mesh)


def mesh_world(mesh, spike_systems, h5_path):
    """The checks of ``test_torch_mesh.py`` on a 4-rank world: collectives
    on the world and on its pairs, SPIKE (pairs: ``spike_systems[2]``;
    world: ``[4]``), ``distributed`` inside a running group, and
    ``io.save_solver_state`` under each pair's mesh (``h5_path`` with the
    pair's first rank in the name)."""
    from kontiki_tpu_torch.parallel import distributed

    pair, members = _subgroups(mesh)
    out = {"world": _collectives(mesh), "pair": _collectives(pair), "members": members}
    out["spike 4"] = _spike(mesh, spike_systems[4])
    out["spike 2"] = _spike(pair, spike_systems[2])
    gm = distributed.global_mesh("cpu")
    out["distributed"] = dict(initialize=distributed.initialize(),
                              is_multiprocess=distributed.is_multiprocess(),
                              global_mesh=(gm.rank, gm.size),
                              rows=distributed.process_local_rows(10))
    out["io"] = _save_once(pair, h5_path.format(members[0]))
    return out


def _save_once(mesh, path):
    """Save a state under ``mesh`` (counting this rank's writes), then load
    it back on every rank after the barrier."""
    from kontiki_tpu_torch import io

    writes = []
    real = io._create_h5_group

    def counting(*args, **kw):
        writes.append(1)
        return real(*args, **kw)

    io._create_h5_group = counting
    try:
        state = {"r3": torch.arange(12.0, dtype=torch.float64).reshape(4, 3),
                 "rho": torch.linspace(0.5, 1.5, 5, dtype=torch.float64)}
        io.save_solver_state(path, state, trust_region_radius=2.5, iteration=7, mesh=mesh)
        loaded, meta = io.load_solver_state(path, device="cpu")
    finally:
        io._create_h5_group = real
    return dict(writes=len(writes), state=loaded, meta=meta)


def failing(mesh):
    """Rank 1 raises; rank 0 waits in a collective (the group's timeout or
    the launcher ends it)."""
    if mesh.rank == 1:
        raise ValueError("rank 1 fails on purpose")
    mesh.barrier()
    return mesh.rank


#: the JAX package's tests/test_parallel.py and tests/test_segments.py problems
RSVI = dict(nviews=6, nlandmarks=12, imu_rate=60.0, seed=2)
SEGMENTS = dict(duration=4.0, rate=60.0, seed=8)
LAMS = (1e-4, 1e-1)
CG = dict(cg_tol=1e-12, cg_maxiter=400)


def rsvi_problem():
    from kontiki_tpu_torch.solver.problem import Problem
    from kontiki_tpu_torch.synthetic import make_rsvi_problem

    gen = make_rsvi_problem(**RSVI)
    return gen, Problem(gen["trajectory"], gen["measurements"], device="cpu")


def trajectory_problem(maker):
    from kontiki_tpu_torch import synthetic
    from kontiki_tpu_torch.solver.problem import Problem

    gen = getattr(synthetic, maker)(**SEGMENTS)
    return gen, Problem(gen["trajectory"], gen["measurements"], device="cpu")


def sharded_world(mesh):
    """The checks of ``test_torch_sharded.py`` on a 3-rank world: on the
    pair {0, 1}, measurement sharding (cost, linearization, step), the
    landmark-block Schur step and the iterative step on the rsvi problem,
    the knot-segment step on the gyro and IMU problems; on all three ranks,
    measurement sharding with rows padded to a multiple of 3."""
    from kontiki_tpu_torch import parallel

    pair, members = _subgroups(mesh)
    _, p = rsvi_problem()
    s0 = p.state0
    out = {}
    if len(members) == 2:
        cost_fn, lin_fn, _, _ = parallel.make_sharded_functions(p, pair)
        out["cost 2"] = cost_fn(s0)
        out["lin 2"] = lin_fn(s0)
        out["step 2"] = parallel.make_sharded_step(p, pair)[0](s0, 1e-4)
        step, cost = parallel.make_sharded_schur_step(p, pair)
        out["schur 2"] = [step(s0, lam) for lam in LAMS]
        out["schur cost 2"] = cost(s0)
        out["iterative 2"] = parallel.make_sharded_iterative_step(p, pair, **CG)[0](s0, 1e-4)
        for maker in ("make_gyro_problem", "make_imu_problem"):
            _, tp = trajectory_problem(maker)
            step, cost = parallel.make_segment_sharded_step(tp, pair)
            out[f"segments {maker}"] = [step(tp.state0, lam) for lam in LAMS]
            out[f"segments cost {maker}"] = cost(tp.state0)
    cost_fn, lin_fn, _, _ = parallel.make_sharded_functions(p, mesh)
    out["cost 3"] = cost_fn(s0)
    out["lin 3"] = lin_fn(s0)
    return out


#: the JAX package's tests/test_segments_ba.py problem
SEGMENT_BA = dict(n_views=60, n_landmarks=300, obs_per_landmark=4, seed=11, imu_rate=50.0)
#: a converged CG, as the JAX package's segment-BA tests run it
SBA_CG = dict(cg_tol=1e-12, cg_maxiter=400)


def segment_ba_world(mesh, arrays, mode):
    """The segment-BA step of ``arrays``' problem in ``mode`` at lam 1e-4
    on both pairs of a 4-rank world (n = 2) and on the world (n = 4), with
    ``total_cost``; and a 2-iteration solve on the world."""
    from kontiki_tpu_torch.parallel import make_segment_ba_solver, make_segment_ba_step

    pair, _ = _subgroups(mesh)
    p = interop.raw_problem_from_numpy(**arrays, device="cpu")
    cg = SBA_CG if mode == "pcg" else {}
    out = {}
    for n, m in ((2, pair), (4, mesh)):
        step, cost = make_segment_ba_step(p, m, mode=mode, **cg)
        out[n] = (step(p.state0, 1e-4), cost(p.state0))
    out["solve 4"] = make_segment_ba_solver(p, mesh, max_iterations=2, function_tolerance=0.0,
                                            mode=mode, **cg)(p.state0)
    return out


#: the rows checks' camera problems: 64 views at 8 fps on a split
#: trajectory (knots every 0.15 s), 32 landmarks, each seen in the 3 views
#: after its reference view, 40 Hz IMU rows. Landmarks local in time let
#: the knot segments split: at n = 2 both shards hold camera rows,
#: landmarks and vt slots (the JAX package's test problems, whose 12
#: landmarks span the whole sequence, put every camera row on shard 0)
LOCAL = dict(nviews=64, nlandmarks=32, k=3, fps=8.0, imu_rate=40.0)


def _local_rsvi(rs, seed):
    """``make_rsvi_problem``'s rolling-shutter problem (``rs`` rows,
    ``seed``) with the landmarks of ``LOCAL``: reference views spread
    evenly, each landmark observed in the ``k`` views after it where it
    projects into the image (0.5 px noise; rho perturbed by 3%)."""
    import numpy as np

    from kontiki_tpu_torch import synthetic
    from kontiki_tpu_torch.math import quaternion as quat
    from kontiki_tpu_torch.sensors import BasicImu
    from kontiki_tpu_torch.sfm import Landmark, View

    mcls = {"static": synthetic.StaticRsCameraMeasurement,
            "newton": synthetic.NewtonRsCameraMeasurement,
            "lifting": synthetic.LiftingRsCameraMeasurement}[rs]
    nviews, L, k, fps = LOCAL["nviews"], LOCAL["nlandmarks"], LOCAL["k"], LOCAL["fps"]
    rng = np.random.default_rng(seed)
    span = (nviews - 1) / fps
    truth = synthetic.make_split_trajectory(span + 1.5, dt=0.15, seed=seed, speed=0.3, wmag=0.25)
    camera = synthetic.make_camera("pinhole")
    t0s = 0.5 + np.arange(nviews) / fps
    views = [View(i, t) for i, t in enumerate(t0s)]
    ref_idx = np.arange(L) * (nviews - k - 1) // L
    uv_ref = np.stack([rng.uniform(0.3 * camera.cols, 0.7 * camera.cols, L),
                       rng.uniform(0.3 * camera.rows, 0.7 * camera.rows, L)], axis=1)
    z_ref = rng.uniform(4.0, 12.0, L)
    at = truth._eval(t0s[ref_idx] + uv_ref[:, 1] * camera.readout / camera.rows, device="cpu")
    q_ct, p_ct = (torch.from_numpy(a) for a in camera.relative_pose)
    X_cam = torch.from_numpy(z_ref[:, None] * np.stack([camera.unproject(u) for u in uv_ref]))
    X_world = (quat.qrotate(torch.from_numpy(at["orientation"]),
                            quat.qrotate(quat.qconj(q_ct), X_cam - p_ct))
               + torch.from_numpy(at["position"])).numpy()
    uv, _, ok = synthetic._rs_fixed_point(truth, camera, X_world, t0s)
    measurements = []
    for li in range(L):
        seen = [vi for vi in range(ref_idx[li] + 1, ref_idx[li] + 1 + k) if ok[li, vi]]
        if not seen:
            continue
        lm = Landmark()
        lm.inverse_depth = 1.0 / z_ref[li]
        lm.reference = views[ref_idx[li]].create_observation(lm, uv_ref[li])
        for vi in seen:
            y = uv[li, vi] + rng.normal(scale=0.5, size=2)
            measurements.append(mcls(camera, views[vi].create_observation(lm, y)))
        lm.inverse_depth = max(lm.inverse_depth * (1.0 + rng.normal(scale=0.03)), 1e-4)
    imu = BasicImu()
    measurements += synthetic.make_imu_measurements(truth, imu, 0.5, 0.5 + span + camera.readout,
                                                    LOCAL["imu_rate"])
    return dict(trajectory=synthetic.perturb_trajectory(truth, sigma_p=0.01, sigma_q=0.005,
                                                        seed=seed + 1),
                camera=camera, imu=imu, views=views, measurements=measurements)


def rows_objects(case):
    """``dict(trajectory=, measurements=)`` of a rows check's problem, from
    its seed: ``_local_rsvi``'s static rows with the camera's and IMU's time
    offsets free (seed 23), its Newton rows (21) and lifting rows (29); pose
    rows (a short motion-capture fit, ``test_torch_pose.py``'s ``_fit``).
    The dict keeps the views alive, which the landmarks' reference
    observations need."""
    from kontiki_tpu_torch import synthetic

    if case == "pose rows":
        truth = synthetic.make_split_trajectory(2.0, dt=0.1, seed=6)
        start = synthetic.perturb_trajectory(truth, seed=7)
        return dict(trajectory=start, measurements=synthetic.make_pose_measurements(
            truth, 0.0, 2.0, 50.0, 0.002, 0.002, seed=8))
    seed, rs = {"unlocked offsets": (23, "static"), "rs_newton": (21, "newton"),
                "rs_lifting": (29, "lifting")}[case]
    gen = _local_rsvi(rs, seed)
    if case == "unlocked offsets":
        for sensor in (gen["camera"], gen["imu"]):
            sensor.time_offset_locked = False
            sensor.max_time_offset = 0.05
    return gen


def rows_problem(case):
    """The port's problem of ``rows_objects(case)``."""
    from kontiki_tpu_torch.solver.problem import Problem

    gen = rows_objects(case)
    return Problem(gen["trajectory"], gen["measurements"], device="cpu")


#: (problem, mode) of the rows checks at n = 2
ROWS_CASES = (("unlocked offsets", "banded"), ("unlocked offsets", "pcg"),
              ("rs_newton", "banded"), ("rs_newton", "pcg"), ("rs_lifting", "pcg"),
              ("pose rows", "banded"), ("pose rows", "pcg"))
#: a converged CG for the rows checks' PCG steps (the block-Jacobi PCG
#: converges slowly on these problems; stopped at a cap, its iterates follow
#: the summation order)
ROWS_CG = dict(cg_tol=1e-14, cg_maxiter=3000)


def rows_step(mesh, case, mode):
    """One segment-BA step at lam 1e-4 of ``rows_problem(case)`` on
    ``mesh``, and its ``total_cost`` at the start."""
    from kontiki_tpu_torch.parallel import make_segment_ba_step

    p = rows_problem(case)
    step, cost = make_segment_ba_step(p, mesh, mode=mode, **(ROWS_CG if mode == "pcg" else {}))
    return step(p.state0, 1e-4), cost(p.state0)


#: the JAX package's sharded full-solve gate (tests/test_segments_ba.py)
FULL_SOLVE = dict(n_views=120, n_landmarks=600, obs_per_landmark=4, seed=13, imu_rate=50.0)


def rows_world(mesh, cases, solve_arrays=None):
    """The steps of ``cases`` (``(problem, mode)`` pairs of ``ROWS_CASES``)
    on a 2-rank world, and with ``solve_arrays`` the full banded solve of
    their problem (20 iterations, function tolerance 1e-12)."""
    from kontiki_tpu_torch.parallel import make_segment_ba_solver

    out = {f"{case} {mode}": rows_step(mesh, case, mode) for case, mode in cases}
    if solve_arrays is not None:
        p = interop.raw_problem_from_numpy(**solve_arrays, device="cpu")
        out["full solve"] = make_segment_ba_solver(p, mesh, max_iterations=20,
                                                   function_tolerance=1e-12)(p.state0)
    return out


def two_shards(mesh, arrays):
    """The banded step and a 3-iteration solve of ``arrays``' problem on a
    2-rank world."""
    from kontiki_tpu_torch.parallel import make_segment_ba_solver, make_segment_ba_step

    p = interop.raw_problem_from_numpy(**arrays, device="cpu")
    step, cost = make_segment_ba_step(p, mesh)
    return dict(step=step(p.state0, 1e-4), cost=cost(p.state0),
                solve=make_segment_ba_solver(p, mesh, max_iterations=3,
                                             function_tolerance=0.0)(p.state0))
