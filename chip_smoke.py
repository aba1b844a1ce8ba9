#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (kontiki_tpu_torch) on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero without the final line:

1. device: a CUDA device must be present; prints its name and power limit;
2. build: compiles the hand-written kernels (one nvcc per source, sm_90a,
   in parallel), loads them, and builds their row code for the host
   beside them (operation counts for the bounds); prints the registers and
   spill of each B1-B5 and B7 instantiation from ``ptxas -v``;
3. B1 (camera-row linearization) and 4. B2 (Schur assembly): each kernel
   against its plain PyTorch version on the same config-4 inputs on the
   card, in float64 and float32, with errors, median times and bounds;
   then B2 on random inputs the main path never makes (P = 600, past the
   head triangle its shared memory holds; repeated and out-of-range ids;
   out-of-range landmarks; ``with_rho=False``; M = 1 and 0);
5. solve: BASELINE config 4 through the normal entry points
   (``synthetic.make_rsvi_problem`` -> ``Problem`` -> ``make_fused_solver``):
   a 1-iteration cost against the JAX package's value, an untimed warm-up
   solve, then the timed 25-iteration solve with launch counts,
   final/initial cost and iterations per second;
6. B1's split branch against its plain version on config-3 inputs (split
   R3 + SO3 trajectory), float64 and float32, with time and bound;
7. B3 (camera-row cost) against its plain version on config-3 (split) and
   config-4 (SE3) inputs, float64 and float32, and against B1's residual,
   with times (per call and per launch on the card) and bounds;
8. config 3 (``make_rsvi_problem`` with its split trajectory ->
   ``Problem`` -> ``make_fused_solver``, 'auto' -> Schur): structure,
   initial and 1-iteration costs against the JAX package's, an untimed
   warm-up solve, the timed 25-iteration solve;
9. B4 (gyro/accel rows): the kernel against its plain version at config-1
   and config-2 shapes (gyro on SO3, gyro and accel on the split
   trajectory), linearization and cost-only, float64 and float32, also on
   M = 1, 127 and 129 rows and each bucket with every third row at
   valid = 0 (exact zeros there); the time per launch of each form on
   each bucket;
10. configs 1 and 2 (``make_gyro_problem`` / ``make_imu_problem`` ->
    ``Problem`` on the card by default -> ``make_fused_solver``, 'auto' ->
    dense): structure, initial and 1-iteration costs against the JAX
    package's, an untimed warm-up solve, the timed 25-iteration solve;
11. breakdown: where one config-2 LM iteration's time goes (host clock with
    a synchronize after each part, median of 5) and the card's busy share
    over 3 iterations (``torch.profiler``);
12. estimator: ``TrajectoryEstimator(trajectory).solve(...)`` (on the card
    by default; the phase-split ``solver.lm.solve``) on the config-3 and
    config-4 measurement objects: Summary costs and counts against the JAX
    package's ``lm.solve``, launches per iteration (B3 re-costs, B1/B2
    linearize), the written-back objects holding the final state, and the
    Summary's per-phase times (config 3's and config 4's iteration
    breakdown);
13. B5 (trajectory-query window evaluation: r3, so3, se3) and B7 (the R3
    spline at arbitrary times) against their plain versions at user size:
    the 4,800,000 row times of a 10,000-frame rolling-shutter sequence (30
    fps, 480 rows, readout 0.02 s) on the SE3 and split trajectories that
    ``make_big_ba_problem(n_views=10_000)`` sizes (3,352 knots per spline),
    float64 and float32, with times and bounds, B5 and B7 also on the same
    times shuffled, B5 on M = 1, 127 and 129 of them and on a window of
    equal knots, B7 on 1, 255, 257, 1,023 and 1,025 times on splines of 4
    and 40 knots from before t0 to past the last window;
14. read-back through the entry points: the trajectory queries at those
    4.8 M times on both trajectories (B5, exact launches per query) and B7
    through ``ops.r3_evaluate_kernel`` in both orders; config 4's built
    trajectory queried at its 425 gyro times against the JAX package's
    values; one se3 query call split into its stages (range check, host
    -> device, ``index_and_u``, ``gather_windows``, B5, device -> host);
    ``trajectory_ate``/``trajectory_aoe`` of config 4's built and
    written-back trajectories against the truth, against the JAX
    package's;
15. pose fit: ``TrajectoryEstimator(trajectory).solve(max_iterations=10,
    function_tolerance=0.0)`` of a perturbed 60 s split trajectory against
    6,000 position and 6,000 orientation rows at 100 Hz (motion capture,
    'auto' -> dense, P = 3,624): Summary costs and counts against the JAX
    ``lm.solve``, per-phase times, then the solution read back through B5
    and scored against the truth (ATE, AOE);
16. config 5 built through the entry points on the card
    (``make_big_ba_problem(n_views=10_000, n_landmarks=100_000,
    obs_per_landmark=5, seed=5)``, a ``RawProblem`` of 500,000 camera
    rows), host seconds of generation and layout, structure against the
    JAX package's;
17. B1 (split) and B3 against their plain versions at config 5's rows (B3
    also per launch on the card);
    B6 (one-hot row expansion) against its plain version on config 5's
    rows at ``state0`` (and a random case with duplicates, ids -1 and WB,
    and a row count that is not a multiple of a block's rows; and no
    rows), float64 and float32, exact; the count of in-range Jacobian
    entries it would drop (must be 0); times beside ``scatter_add_``;
18. config 5 through ``parallel.segments_ba``: the cost at ``state0``, the
    ``total_cost`` of ``make_segment_ba_step`` (B3) and the 1-iteration
    cost against the JAX package's, an untimed warm-up, then the timed
    6-iteration ``make_segment_ba_solver`` (exact B1/B6 launches, final
    cost against the JAX package's, iterations per second, peak device
    memory), one iteration's breakdown, and the solution's ATE through B5
    against the JAX package's;
19. config 3-atan and config 3-atan-lifting (config 3's generator with the
    atan camera, static or lifting rows) built through the entry points:
    structure against the JAX package's; B1 on their rows; B1 and B3 on
    all eight window x camera x rows branches against their plain
    versions in float64 and float32 (split on those two problems' rows,
    SE3 on ``make_rsvi_problem(nviews=64, nlandmarks=200, imu_rate=200.0,
    seed=4, trajectory="se3", camera_kind="atan", rs="lifting")``'s camera
    rows, a branch without the atan or lifting inputs on the same rows
    with them dropped), B3 against B1's residual, each branch's time,
    bound and plain time; B2 on the lifting bucket (rdim 3, C 62, the
    row times in the reduced system) against its plain version beside
    cuBLAS; B1 on M = 1, 7 and 129 rows of config 4 and config
    3-atan-lifting with rows of valid = 0; B3 on M = 1, 7, 129 and one wave
    of its lane kernel less and plus one row of config 4's, config 3's and
    config 3-atan-lifting's rows, every third row at valid = 0, against its
    plain version and B1's residual;
20. both through ``make_fused_solver(strategy="schur")``: initial and
    1-iteration costs against the JAX package's (1e-9), an untimed
    warm-up, the timed 25-iteration solve (final cost against the JAX
    package's, 1e-6; exact B1/B2/B3 launches per branch), then
    ``TrajectoryEstimator.solve`` on both against the JAX package's (costs,
    Summary counts with the row-time blocks, steps, launches, per-phase
    times, the row times written back into the lifting measurements) and
    the solution's ATE through B5.

21. config 4-Newton (``make_rsvi_problem(nviews=64, nlandmarks=200,
    imu_rate=200.0, seed=4, rs="newton", trajectory="split")``, Newton
    rolling-shutter rows on 6-knot readout-slack windows) built through the
    entry points: structure against the JAX package's; B8 (Newton rows,
    linearize and cost-only) on its four window x camera branches against
    its plain version in float64 and float32 (split on config 4-Newton's
    rows, SE3 on the same generator's rows at 16 views, the atan branches
    with the atan camera's ``wc`` and ``gamma`` added to the same rows),
    the cost-only residual against the linearize form's, the rows' Newton
    steps, the main branch's times per call and per launch on the card,
    plain time and bound; B8 on M = 1, 7, 129 and one wave of its
    linearize kernel less and plus one row, every third row at valid = 0
    (exact zeros there); B2 on its camera bucket (C 85) beside cuBLAS;
22. config 4-Newton through ``make_fused_solver(strategy="schur")``:
    initial and 1-iteration costs against the JAX package's (1e-6), an
    untimed warm-up, the timed 25-iteration solve (final/initial under
    1e-8, exact B8/B4/B2 launches, it/s), then ``TrajectoryEstimator.solve``
    ('auto' -> Schur) against the JAX package's (costs, Summary counts,
    steps, exact launches, the written-back objects, per-phase times, ATE
    through B5).

23. the solver family on one device, each on its main path's problem:
    iterative Schur (``make_fused_solver(strategy="iterative_schur")``) on
    config 4 (after its Schur solve) and config 3-atan-lifting (after its
    solves): the 1-iteration cost (CG converged; the default tolerance's
    beside it) against the JAX package's and the port's Schur path
    (1e-6), the timed 5-iteration solve against the JAX
    package's (1e-6), CG iterations per solve, exact launches (B1, no B2,
    no B3); on config 3-atan-lifting the phase-split ``lm.solve`` under
    ``schur`` and ``iterative_schur`` with each one's per-phase times;
    after config 4-Newton's phases, one segment-BA banded step on its rows
    (B8 on 6-knot windows, B6 at C 85 against its plain version) against
    the port's iterative and Schur steps (1e-6); after configs 1-2's
    solves, ``strategy="banded"`` on each (1 iteration within 1e-9 of the
    dense strategy's, the timed 25-iteration solve, exact B4 launches);
24. after config 5's phases: config 5 in PCG mode (``mode="pcg"``, the
    timed 6-iteration solve with its CG iterations and exact B1/B3
    launches, its 1- and 6-iteration costs beside the JAX package's PCG
    values and their change under a 1e-15 change of CG's right-hand side,
    one step with a converged CG against the banded step, and one with CG
    cut after 5 iterations against the JAX package's, 1e-10); the
    10,050-knot SO3 gyro band (``synthetic.make_gyro_band_problem``): one
    banded step against the JAX package's (1e-8), a timed 10-iteration
    fused banded solve with its peak memory; the band solve
    (``solver.banded.block_tridiag_solve``, PCR) and its scan reference
    (``_scan_solve``) on config 5's and the gyro band's damped bands,
    against each other and a dense LU of the expanded system (1e-10
    normwise), with each method's time; config 5's banded solve with each,
    patched into ``parallel.segments_ba``, with its rate.

25. the long-sequence IMU path (``synthetic.make_long_imu_problem``): a
    1,000 s recording at 200 Hz on a split trajectory of 10,014 knots per
    spline, config 2's biases unlocked; SEW's knot spacings and variances
    (beside the grid's 0.1 s) against the JAX package's, the weights ``1 /
    sqrt(variance)`` in one ``GyroscopeMeasurements`` and one
    ``AccelerometerMeasurements``; ``Problem`` from the two containers and
    from the same 400,000 rows as per-object measurements, their host build
    times, the two equal exactly and their counts the JAX package's; the
    native helper (C++) against its numpy versions on those times, with
    both times; B4 at 200,000 rows of each kind against its plain version,
    each form's time per launch, the plain time and the bound; one banded
    iteration's stages timed on the card;
    ``TrajectoryEstimator(trajectory).solve(max_iterations=5,
    strategy="banded", function_tolerance=0.0)`` on the card, first on the
    rows of the first 100 s (every cost against the JAX package's banded
    ``lm.solve``: initial and 1-iteration within 1e-9, the last at most the
    JAX package's), then on all 400,000 rows (the initial cost against the
    JAX package's, every step accepted), each with exact B4 launches,
    it/s, the Summary's phase times and the peak device memory.

26. the scale-out layer (``kontiki_tpu_torch.parallel``), after config 5's
    one-shard phases, each world spawned once by ``parallel.launch.
    run_spmd`` on ``cuda:0`` (a one-card rehearsal over host-staged gloo,
    not a scaling figure): config 5 at full size on 4 gloo ranks through
    ``make_segment_ba_step`` / ``_solver`` with a mesh (``total_cost``, one
    banded step, one PCG step with CG cut after 5 iterations and config
    4-Newton's banded step against the one-shard path at 1e-9 with the
    state at 1e-9; the timed 6-iteration solve, its iterations and final
    cost against the one-shard solve's; every rank the same bits; per rank
    the B1/B3/B6/B8 (and B4) launches, peak memory, it/s and one step's
    stages with the time inside the collectives; last, f32_check's config 5
    in float32 for phase 27); SPIKE on 4 ranks on
    config 5's and the gyro band's damped bands against
    ``block_tridiag_solve`` (1e-9); a one-rank NCCL world running config
    5's step (device-side ``all_reduce``, a self ``ppermute``; 1e-12 from
    the one-shard path); config 4 through ``make_sharded_schur_step`` (B1,
    B2 a rank) and config 2 through ``make_sharded_step`` (B4 a rank) on 2
    gloo ranks against the port's one-device steps (1e-9). Each prints its
    backend and transport; a failing rank fails the script.

27. the float32 tier (the JAX package's ``KONTIKI_TPU_X64=0``):
    ``tests/f32_check.py``'s five problems at its sizes, seeds, iterations
    and solver options through the port in ``torch.float32`` (configs 1-4:
    ``Problem(..., dtype=torch.float32)`` -> ``solver.lm.solve``; config 5:
    ``make_big_ba_problem(..., dtype=torch.float32)`` ->
    ``make_segment_ba_solver`` on one shard, and on the 4 gloo ranks of
    phase 26's world), held to its gates, every float tensor float32; then
    the five BASELINE configs at full size in float32 beside float64
    (configs 1-4 through ``make_fused_solver(problem, 25,
    function_tolerance=0.0)``, config 5 through ``make_segment_ba_solver(
    problem, max_iterations=6, mode="banded")`` on its arrays in float32):
    each dtype's rate after a one-iteration warm-up, config 5's memory,
    the float32 initial cost within ``F32_COST0_RTOL`` of the JAX
    package's float32 one and the score within f32_check's bound of it,
    and B1, B2, B3, B4 and B6 launched in float32.

The JAX values of phases 19-20 come from ``JAX_PLATFORMS=cpu python3
tools/atan_lifting_reference.py``, those of phases 21-22 from
``JAX_PLATFORMS=cpu python3 tools/newton_reference.py``, those of phases
23-24 from ``JAX_PLATFORMS=cpu python3 tools/solvers_reference.py``, those
of phase 25 from ``JAX_PLATFORMS=cpu python3 tools/imu_long_reference.py``,
those of phase 27 from ``JAX_PLATFORMS=cpu python3 tools/f32_reference.py``.

Each path's launch counts are set to 0 just before its timed solve and
read just after. A kernel's bound is the larger of its bytes (each input
read once, each output written once) over 3.35 TB/s and the floating-point
operations its function needs on these inputs over the H100 SXM's float64
peak, 67 TFLOP/s on its tensor cores (NVIDIA's data sheet). B1's, B4's and
B8's operations are counted by running their row code on the host once per
row in one full-width jet (B8: one a stage), with structural zeros and ones free
(``csrc/host_rows.cpp``), B3's as its scalar chain once per row, B5's and
B7's as each query's chain once (B5's time derivatives in forward mode, as
the kernel runs them); B2's from the shapes, the upper triangle of the
symmetric H only. A kernel's
``launches`` in the JSON line is the sum over the main-path runs (the
timed fused solves and the estimator solves). Its ``ms`` is the median
CUDA-event time of one wrapper call; B3's and B4's entries also give
``graph_ms``, the time per launch on the card from a CUDA graph of
launches (B4's two entries, linearize and cost-only, on config 2's accel
bucket; B7's at 4.8 M times), and B7's the shuffled order's times beside
the frame order's.

The last two lines are a JSON object with the kernels' numbers and the JSON
result ``{"ok": true, "device": {...}}``.
"""
import json
import math
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

# BASELINE config 4 (bench.py config4): rolling-shutter VI on an SE3 spline.
CONFIG4 = dict(nviews=64, nlandmarks=200, imu_rate=200.0, seed=4, trajectory="se3")
# Its structure, as the JAX package builds it from the same seed.
CONFIG4_SHAPE = {"rs_static": 12304, "gyro": 425, "accel": 425, "num_tangent": 394}
# Costs of config 4 in float64 from the JAX package (kontiki_tpu) on the
# CPU: the linearization cost at state0, and the final cost of
# make_fused_solver(problem, 1, function_tolerance=0.0, strategy="schur").
JAX_COST_0 = 58760.57182460807
JAX_COST_1 = 1.5295605102254368
COST_RTOL = 1e-6
# Config 4 is noise-free: 25 LM iterations must reach this ratio.
FINAL_RATIO = 1e-8

# BASELINE config 3 (bench.py config3): rolling-shutter SfM on a split
# R3 + SO3 trajectory (make_rsvi_problem's default), no IMU.
CONFIG3 = dict(nviews=32, nlandmarks=200, imu_rate=0.0, seed=3)
CONFIG3_SHAPE = {"rs_static": 6091, "num_tangent": 339}
# Costs of config 3 in float64 from the JAX package on the CPU: the
# linearization cost at state0 and the final cost of
# make_fused_solver(problem, 1, function_tolerance=0.0) ('auto' -> schur).
# After 25 iterations the JAX package reaches final/initial 4.07e-28; the
# bound leaves room for the last, roundoff-level iterations to differ.
JAX_COST_CONFIG3_0 = 36944.3554707825
JAX_COST_CONFIG3_1 = 15.992373182756788
FINAL_RATIO_CONFIG3 = 1e-20
# The JAX package's lm.solve(problem, max_iterations=3, function_tolerance=
# 0.0, strategy="schur") on the CPU in float64: initial and iteration-1
# costs and the Summary's counts (num_parameters, num_parameter_blocks,
# num_parameters_reduced, num_residuals, num_residual_blocks). Config 4's
# costs are its fused values above: lm.solve takes the same first step
# (on config 3 the two iteration-1 costs differ by 8e-12 relative); its
# counts come from the JAX package's Problem on the same generator.
LM_SOLVE = {
    "config 3": dict(cost0=36944.3554707825, cost1=15.992373182884757,
                     counts=(285, 225, 277, 12182, 6091)),
    "config 4": dict(cost0=JAX_COST_0, cost1=JAX_COST_1,
                     counts=(342, 224, 326, 27158, 13154)),
}
SUMMARY_COUNTS = ("num_parameters", "num_parameter_blocks", "num_parameters_reduced",
                  "num_residuals", "num_residual_blocks")

CAMERA_CONFIGS = {
    "config 4": dict(kwargs=CONFIG4, shape=CONFIG4_SHAPE, cost0=JAX_COST_0,
                     cost1=JAX_COST_1, final_ratio=FINAL_RATIO),
    "config 3": dict(kwargs=CONFIG3, shape=CONFIG3_SHAPE, cost0=JAX_COST_CONFIG3_0,
                     cost1=JAX_COST_CONFIG3_1, final_ratio=FINAL_RATIO_CONFIG3),
}

# Config 3-atan and config 3-atan-lifting: config 3's generator with the atan
# camera (synthetic.make_camera("atan")) and static or lifting rows. The atan
# unprojection of the reference pixels moves landmarks, so fewer rows stay
# in view than in config 3. Their structure and costs in float64 from the
# JAX package on the CPU (tools/atan_lifting_reference.py): the Schur
# linearization's cost at state0 and the final costs of make_fused_solver(
# problem, n, function_tolerance=0.0, strategy="schur") for n = 1 and 25.
# The data are pinhole projections fitted with the atan model: the first
# steps are rejected and the cost stays far from 0, so the 25-iteration
# cost is held to the JAX package's, not to a ratio.
ATAN_CONFIGS = {
    "config 3-atan": dict(
        kwargs=dict(CONFIG3, camera_kind="atan", rs="static"),
        shape={"rs_static": 3837, "num_tangent": 269},
        cost0=1324749.7362606903, cost1=1324749.7362606898, cost25=451487.0914830953),
    "config 3-atan-lifting": dict(
        kwargs=dict(CONFIG3, camera_kind="atan", rs="lifting"),
        shape={"rs_lifting": 3837, "num_tangent": 4106},
        cost0=1324749.7362606903, cost1=1324749.7362606898, cost25=512470.0554649725),
}
CAMERA_CONFIGS.update(ATAN_CONFIGS)
ATAN_COST_RTOL = {"cost0": 1e-9, "cost1": 1e-9, "cost25": 1e-6}
# TrajectoryEstimator(trajectory).solve(max_iterations=10, progress=False,
# function_tolerance=0.0) on both, from the JAX package on the CPU: initial,
# iteration-1 and final costs, the Summary's counts (ATAN_SUMMARY_COUNTS),
# successful and unsuccessful steps, the sum, min and max of the
# written-back row times (lifting), and the unaligned ATE (n = 200 on
# [0.5, 0.5 + 31/30)) of the start and of the written-back trajectory.
JAX_ATAN_ESTIMATOR = {
    "config 3-atan": dict(
        cost0=1324749.7362606903, cost1=1324749.7362606903, final=607058.109140536,
        counts=(215, 155, 207, 152, 7674, 3837, 7674, 3837), steps=(6, 4),
        ate_start=0.02545798811149049, ate=0.57226192233863),
    "config 3-atan-lifting": dict(
        cost0=1324749.7362606903, cost1=1324749.7362606903, final=598157.5916397376,
        counts=(4052, 3992, 4044, 3989, 11511, 3837, 11511, 3837), steps=(6, 4),
        vt=(1924.4958160466497, 0.0, 0.9994522909799352), ate_start=0.02545798811149049,
        ate=0.5689597300651952),
}
ATAN_SUMMARY_COUNTS = ("num_parameters", "num_parameter_blocks", "num_parameters_reduced",
                       "num_parameter_blocks_reduced", "num_residuals", "num_residual_blocks",
                       "num_residuals_reduced", "num_residual_blocks_reduced")
# The SE3 rows of the eight-branch check: config 4's generator with the atan
# camera and lifting rows (camera rows only; no solve).
SE3_ATAN_LIFTING = dict(CONFIG4, camera_kind="atan", rs="lifting")

# BASELINE config 4-Newton (bench.py config4_newton): config 4's generator
# on the split trajectory with Newton rolling-shutter rows (kernel B8). Its
# structure and float64 values from the JAX package on the CPU
# (tools/newton_reference.py, through its fused Newton tile): the camera
# rows' readout-slack windows (6 knots on both splines) and the reduced
# system's size; the Schur linearization's cost at state0; the final costs
# of make_fused_solver(problem, n, function_tolerance=0.0,
# strategy="schur") for n = 1 and 25; TrajectoryEstimator(trajectory).solve(
# max_iterations=10, progress=False, function_tolerance=0.0): initial,
# iteration-1 and final costs, the Summary's counts (ATAN_SUMMARY_COUNTS),
# successful and unsuccessful steps, and the unaligned ATE (n = 200 on
# [0.5, 0.5 + 63/30)) of the start and of the written-back trajectory. The
# gates are config 4's: initial and 1-iteration costs 1e-6, final/initial
# after 25 iterations under 1e-8 (the data are noise-free).
CONFIG4_NEWTON = dict(CONFIG4, rs="newton", trajectory="split")
CONFIG4_NEWTON_SHAPE = {"rs_newton": 12304, "gyro": 425, "accel": 425, "num_tangent": 394}
NEWTON_WINDOWS, NEWTON_PC = (6, 6), 194
JAX_NEWTON = dict(
    cost0=181314.74731668772, cost1=2.405791759183384, cost25=3.9992258777303754e-23,
    estimator=dict(cost0=181314.74731668772, cost1=2.4057917591949787,
                   final=4.382790330509873e-23,
                   counts=(342, 242, 326, 236, 27158, 13154, 27158, 13154), steps=(10, 0),
                   ate_start=0.02379180398234376, ate=0.014660968596071631))
# The SE3 rows of B8's four-branch check: the same generator on the SE3
# spline, cut to 16 views; the atan branches take each problem's rows with
# the atan camera's wc and gamma (synthetic.make_camera("atan")) added.
NEWTON_SE3 = dict(CONFIG4_NEWTON, nviews=16, trajectory="se3")
# B8's edge row counts, beside one wave of its linearize kernel less and
# plus one row (newton_rows_wave)
NEWTON_EDGES = (1, 7, 129)
# B8's rows on 10-knot windows: knots closer than readout / 3 (the default
# camera's readout 0.025 s over 4.5), a small problem on each trajectory
# (the CUDA tests' B8 problem)
NEWTON_W10 = dict(nviews=8, nlandmarks=24, imu_rate=0.0, seed=43, rs="newton", noise_px=1.0,
                  perturb_rho=0.05, knot_dt=0.025 / 4.5)

# BASELINE configs 1 and 2 (bench.py config1/config2), their structure as
# the JAX package builds it, and their costs in float64 from the JAX package
# on the CPU: total_cost at state0 and the final cost of
# make_fused_solver(problem, 1, function_tolerance=0.0) ('auto' -> dense).
# After 25 iterations the JAX package reaches final/initial 7.0e-31
# (config 1, roundoff) and 1.24e-12 (config 2); the bounds leave room for
# the last iterations' roundoff-level paths to differ.
JAX_COST_CONFIG1_0 = 88.5467294379849
JAX_COST_CONFIG1_1 = 0.013452322257610914
JAX_COST_CONFIG2_0 = 116355.77064652363
JAX_COST_CONFIG2_1 = 49.12247040995038
IMU_CONFIGS = {
    "config 1": dict(make="make_gyro_problem", kwargs=dict(duration=5.0, rate=200.0, seed=1),
                     shape={"gyro": 1000, "num_tangent": 205},
                     cost0=JAX_COST_CONFIG1_0, cost1=JAX_COST_CONFIG1_1, final_ratio=1e-20),
    "config 2": dict(make="make_imu_problem", kwargs=dict(duration=5.0, rate=200.0, seed=2),
                     shape={"gyro": 1000, "accel": 1000, "num_tangent": 397},
                     cost0=JAX_COST_CONFIG2_0, cost1=JAX_COST_CONFIG2_1, final_ratio=1e-10),
}

# BASELINE config 5 (bench.py config5): banded segment BA on one device.
CONFIG5 = dict(n_views=10_000, n_landmarks=100_000, obs_per_landmark=5, seed=5)
CONFIG5_ITERATIONS = 6
# The JAX package's values in float64 on the CPU (tools/config5_reference.py):
# the structure, the cost at state0 (the speculative loop's linearization,
# max_iterations=0, and make_segment_ba_step's total_cost), the final cost of
# make_segment_ba_solver(problem, mesh of 1, max_iterations=1 and 6,
# function_tolerance=0.0, mode="banded") and the iterations it ran, and the
# unaligned ATE (n = 200 on [t1, t2]) of the start and of the 6-iteration
# solution against the truth.
JAX_CONFIG5 = dict(
    shape=dict(rows=500000, weight=499989.0, knots=3352, seg=3360, G=8, nbloc=420,
               Lb=100000, LaMax=251, Ma=[1255]),
    cost0=784576.9477794562,
    total_cost0=784576.9477794562,
    cost1=330.01275275253386,
    cost6=1.0437217947864471e-4,
    iterations6=6,
    ate_start=0.01210908571174575,
    ate6=0.0015382327687632653,
)
# The 6-iteration cost is 1.3e-10 of the initial one: roundoff of the
# 784,577-cost linearizations (rel ~1e-15, i.e. ~1e-9 absolute in the cost,
# ~1e-5 of the final value) decides its last digits, so it is held to 1e-4.
CONFIG5_FINAL_RTOL = 1e-4
# ATE is a function of the state, which agrees far better than the tiny
# final cost: the start to the queries' roundoff, the solution to 1e-6.
CONFIG5_ATE_RTOL = {"ate_start": 1e-12, "ate6": 1e-6}

# Peak rates of one H100 SXM at 700 W (NVIDIA's data sheet): HBM3, and
# float64 on the tensor cores. B1's and B4's row chains cannot use the
# tensor cores (34 TFLOP/s outside them), so their bounds are lower still
# than they need be.
HBM_BYTES_PER_S = 3.35e12
F64_OPS_PER_S = 67e12

# Kernel vs plain version, max |kernel - plain| / max |plain| per output.
# f64: both run the same formulas in another order (and B2's atomics sum
# in a run-dependent order), so they agree to rounding. f32: the SE3 log
# and V^-1 coefficients cancel (1/theta^2 - ...), which amplifies f32
# rounding by ~1e2..1e3; B2 sums ~1e4 terms per entry.
TOL = {
    ("linearize_rows", torch.float64): 1e-10,
    ("linearize_rows", torch.float32): 1e-3,
    ("assemble_schur_blocks", torch.float64): 1e-10,
    ("assemble_schur_blocks", torch.float32): 1e-4,
    # IMU rows in f32: each side is ~1e-6 from f64 at these inputs, and the
    # residual y - body cancels
    ("imu_rows", torch.float64): 1e-10,
    ("imu_rows", torch.float32): 1e-4,
    # B1 and B3 on each window x camera x rows branch: the same formulas in
    # another order in f64; in f32 each side rounds at ~1e-7 along the chain
    # (the rows' residuals are ~1e1-1e2 px, so the r cancellation stays mild)
    ("linearize_rows branch", torch.float64): 1e-12,
    ("linearize_rows branch", torch.float32): 1e-4,
    ("cost_rows branch", torch.float64): 1e-12,
    ("cost_rows branch", torch.float32): 1e-4,
    # camera-row cost: B1's primal chain without the Jacobian's
    # cancellations; and B3 against B1's residual on the same inputs
    ("cost_rows", torch.float64): 1e-10,
    ("cost_rows", torch.float32): 1e-4,
    ("cost_rows vs linearize_rows", torch.float64): 1e-12,
    # query kernels: R3 values are the same basis sums in another order;
    # the SO3/SE3 chains run forward mode in the time shift against the
    # plain closed forms (4x4 product rule), so their derivatives differ
    # by more roundoff; f32: each side rounds at ~1e-6 along a chain of
    # ~1e2 operations and the derivatives scale by 1/dt and 1/dt^2
    ("evaluate_windows r3", torch.float64): 1e-12,
    ("evaluate_windows r3", torch.float32): 1e-4,
    ("evaluate_windows so3", torch.float64): 1e-10,
    ("evaluate_windows so3", torch.float32): 1e-4,
    ("evaluate_windows se3", torch.float64): 1e-10,
    ("evaluate_windows se3", torch.float32): 1e-4,
    ("r3_evaluate_kernel", torch.float64): 1e-12,
    ("r3_evaluate_kernel", torch.float32): 1e-4,
    # the split trajectory's position query (B5 r3) against B7 at the same
    # times: two kernels, one spline
    ("query vs r3_evaluate_kernel", torch.float64): 1e-12,
    # Newton rows (B8): the same chain in another order in f64; in f32 each
    # side rounds at ~1e-7 along up to five Newton steps, and the Jacobian's
    # mixed second derivatives of the obs window (f' = dv/dt - rows /
    # readout) cancel as the SE3 and SO3 logs do in B1's
    ("newton_rows", torch.float64): 1e-10,
    ("newton_rows", torch.float32): 1e-3,
    ("newton_rows cost-only", torch.float64): 1e-10,
    ("newton_rows cost-only", torch.float32): 1e-4,
    ("newton_rows cost-only vs linearize", torch.float64): 1e-10,
    # one-hot expansion: each output sums at most two entries, so it equals
    # its plain version exactly; the gate allows the last bit
    ("onehot_expand_rows", torch.float64): 1e-14,
    ("onehot_expand_rows", torch.float32): 1e-14,
}

# Read-back at user size: the row times of a 10,000-frame rolling-shutter
# sequence (30 fps, 480 rows, readout 0.02 s, first frame at 0.5 s), on
# trajectories as long as make_big_ba_problem(n_views=10_000) makes them:
# (10,000 - 1) / 30 + 1.5 s at dt = 0.1 -> 3,352 knots per spline.
QUERY_FRAMES, QUERY_FPS, QUERY_ROWS, QUERY_READOUT, QUERY_T_FIRST = (
    10_000, 30.0, 480, 0.02, 0.5)
QUERY_DURATION = (QUERY_FRAMES - 1) / QUERY_FPS + 1.5
QUERY_KNOTS = 3352
#: rows per chunk of the plain versions at user size (bounds their temporaries)
PLAIN_CHUNK = 1 << 20
#: where the query phases put their tensors (the trajectories' own queries
#: use their default device, the card)
QUERY_DEVICE = "cuda"

# Config 4's trajectory as make_rsvi_problem builds it (the perturbed start),
# queried by the JAX package in float64 on the CPU at its 425 gyro times:
# per query the sum of |values| and rows 0, 212 and 424
# (tools/query_reference.py).
JAX_CONFIG4_QUERIES = {
    "position": (206.48975102915387, {
        0: [0.07247913639886731, -0.13156439144335294, -0.07400531655257328],
        212: [0.11854261683403457, -0.1347330975722521, -0.17409660841681027],
        424: [0.2410233640477627, -0.06990281925643788, -0.2579248367472761]}),
    "velocity": (152.02658175710144, {
        0: [0.17564885424913998, -0.04111823864924133, -0.20518770010775592],
        212: [0.10650652871035844, -0.1663058967797454, -0.200881101387169],
        424: [0.06623407248092364, 0.4645628094594163, -0.053635835486914515]}),
    "acceleration": (1242.210729269506, {
        0: [0.5335159369317288, 1.4843318311081886, -0.008429249662631061],
        212: [1.370519781116684, -0.9036963914666858, -1.1014305620678047],
        424: [-0.6920805882685989, -0.2623221841298891, 0.1264770574202885]}),
    "orientation": (477.24424922589355, {
        0: [0.9975188506823891, 0.03853530093685096, 0.054916713996851114,
            0.021338407597088122],
        212: [0.9964720152734402, 0.048582787640121854, 0.06843188235036358,
              0.0005594640201326878],
        424: [0.9937303761369487, 0.08277728638994707, 0.014508296741374634,
              0.0737385226750567]}),
    "angular_velocity": (117.35273768011226, {
        0: [-0.017520070610854657, 0.09847216380282968, -0.12420103642050506],
        212: [-0.08294746912742597, -0.08787321225030453, 0.06726447452864069],
        424: [0.11295593083636302, -0.1314385774238886, 0.2591805064451883]}),
}
QUERY_RTOL = 1e-12
# trajectory_ate (align False, "se3") and trajectory_aoe (align False) of
# config 4's built trajectory and of the one the estimator phase writes back
# (TrajectoryEstimator.solve(max_iterations=10, function_tolerance=0.0))
# against the truth on [0.5, 0.5 + 63/30), n = 200, from the JAX package
# (tools/query_reference.py). The written-back trajectory equals the truth
# up to the gauge (global translation and yaw), so its se3-aligned ATE is
# the solve's roundoff (1.8e-16 m in the JAX package): it is held to an
# absolute bound, every other score to SCORE_RTOL.
JAX_CONFIG4_SCORES = {
    "built": (0.024373380883095708, 0.02043949062680765, 0.0060516638102657274),
    "written-back": (0.008950649180413007, 1.7597233040735971e-16, 0.000644692505524337),
}
SCORE_RTOL = 1e-6
ALIGNED_ATE_ABS = 1e-9
# Pose fit (motion capture): make_split_trajectory(60.0, dt=0.1, seed=6)
# perturbed with perturb_trajectory(seed=7); make_pose_measurements at
# 100 Hz on [0, 60) with noise std 0.002 (m, rad) from seed 8. The JAX
# package's lm.solve(problem, max_iterations=1, function_tolerance=0.0) on
# the same rows: initial and iteration-1 costs and the Summary's counts
# (tools/query_reference.py).
POSE_FIT = dict(duration=60.0, dt=0.1, seed=6, perturb_seed=7, rate=100.0, noise=0.002,
                noise_seed=8)
JAX_POSE_FIT = dict(cost0=11.630382382384372, cost1=0.1675783358026372,
                    counts=(4221, 1206, 4221, 24000, 12000))


#: the card's name and power limit (nvidia-smi), printed beside B4's and
#: B5's times
CARD = "not read"


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def cuda_ms(fn, reps=20, warmup=3):
    """Median milliseconds of ``fn()`` on the card (CUDA events)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def graph_ms(fn, n=50):
    """Device milliseconds of one ``fn()``: ``n`` calls captured in a CUDA
    graph and replayed (``cuda_ms``), over ``n``. The time of a kernel of a
    few microseconds without the host's enqueue of each call, which
    ``cuda_ms`` of a single call measures as well."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    return cuda_ms(graph.replay) / n


def bound(nbytes, ops):
    """(bound_ms, bound_by): the least time the card could take."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F64_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def f32_counted(lk, ak):
    """B1, B3, B2, B4 and B6: the wrappers that count their float32 launches
    (``f32_launches``)."""
    return (lk.linearize_rows, lk.cost_rows, ak.assemble_schur_blocks, lk.imu_rows,
            lk.onehot_expand_rows)


def reset_counts():
    from kontiki_tpu_torch.ops import assembly_kernels as ak
    from kontiki_tpu_torch.ops import linearize_kernels as lk
    from kontiki_tpu_torch.ops import spline_kernels as sk

    lk.linearize_rows.launches = 0
    lk.linearize_rows.split_launches = 0
    for wrapper in f32_counted(lk, ak):
        wrapper.f32_launches = 0
    lk.linearize_rows.branch_launches.clear()
    lk.cost_rows.launches = 0
    lk.cost_rows.branch_launches.clear()
    ak.assemble_schur_blocks.launches = 0
    ak.assemble_schur_blocks.shape_launches.clear()
    lk.imu_rows.launches = 0
    lk.imu_rows.cost_launches = 0
    for kind in lk.evaluate_windows.launches:
        lk.evaluate_windows.launches[kind] = 0
    sk.r3_evaluate_kernel.launches = 0
    lk.onehot_expand_rows.launches = 0
    lk.newton_rows.launches = 0
    lk.newton_rows.cost_launches = 0
    lk.newton_rows.branch_launches.clear()


def read_counts():
    from kontiki_tpu_torch.ops import assembly_kernels as ak
    from kontiki_tpu_torch.ops import linearize_kernels as lk
    from kontiki_tpu_torch.ops import spline_kernels as sk

    counts = {
        "linearize_rows": lk.linearize_rows.launches,
        "linearize_rows split": lk.linearize_rows.split_launches,
        "cost_rows": lk.cost_rows.launches,
        "assemble_schur_blocks": ak.assemble_schur_blocks.launches,
        **{f"assemble_schur_blocks {k}": n
           for k, n in ak.assemble_schur_blocks.shape_launches.items()},
        "imu_rows": lk.imu_rows.launches,
        "imu_rows cost-only": lk.imu_rows.cost_launches,
        **{f"evaluate_windows {k}": n for k, n in lk.evaluate_windows.launches.items()},
        "r3_evaluate_kernel": sk.r3_evaluate_kernel.launches,
        "onehot_expand_rows": lk.onehot_expand_rows.launches,
        **{f"linearize_rows {b}": n for b, n in lk.linearize_rows.branch_launches.items()},
        **{f"cost_rows {b}": n for b, n in lk.cost_rows.branch_launches.items()},
        "newton_rows": lk.newton_rows.launches,
        "newton_rows cost-only": lk.newton_rows.cost_launches,
        **{f"newton_rows {b}": n for b, n in lk.newton_rows.branch_launches.items()},
        **{f"{w.__name__} f32": w.f32_launches for w in f32_counted(lk, ak)},
    }
    for name, n in counts.items():
        MAIN_PATH_LAUNCHES[name] = MAIN_PATH_LAUNCHES.get(name, 0) + n
    return counts


#: launches summed over the main-path runs (each read by read_counts)
MAIN_PATH_LAUNCHES = {}


def compare(kernel, dtype, names, got, want):
    """Print and check normwise errors; returns the max abs error."""
    tol = TOL[(kernel, dtype)]
    worst = 0.0
    for name, a, b in zip(names, got, want):
        if a.shape != b.shape or not torch.isfinite(a).all():
            fail(f"{kernel} {dtype} {name}: shape {tuple(a.shape)} vs "
                 f"{tuple(b.shape)} or non-finite output")
        err = (a - b).abs().max().item() if a.numel() else 0.0
        scale = b.abs().max().item() if b.numel() else 0.0
        rel = err / scale if scale else err
        print(f"  {kernel} {str(dtype)[6:]} {name}: max_abs_err {err:.3e} "
              f"max_abs {scale:.3e} rel {rel:.3e} (tol {tol:.0e})", flush=True)
        if not rel <= tol:
            fail(f"{kernel} {dtype} {name}: rel error {rel:.3e} > {tol:.0e}")
        worst = max(worst, err)
    return worst


def phase_device():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    )
    global CARD
    CARD = smi.stdout.strip() or smi.stderr.strip()
    print(f"card: {CARD}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def phase_build():
    from kontiki_tpu_torch.ops import build

    from kontiki_tpu_torch import native

    t0 = time.time()
    # the host row code and the native helper compile beside the nvcc processes
    with ThreadPoolExecutor(max_workers=2) as pool:
        host = pool.submit(build.load_host_library)
        helper = pool.submit(native._lib)
        so = build.build()
        build.load_library()
        print(f"build: {time.time() - t0:.1f} s -> {os.path.relpath(so, ROOT)}", flush=True)
        host.result()
        helper.result()
    print(f"host row code and native helper: ready {time.time() - t0:.1f} s after the build "
          "began", flush=True)
    log = so.with_suffix(".log").read_text()
    for line in log.splitlines():
        if ("Compiling entry" in line or "Function properties" in line
                or "registers" in line or "spill" in line or line.startswith("==")):
            print(f"  ptxas: {line.strip()}", flush=True)
    for name, regs, spill in ptxas_summary(log):
        print(f"ptxas {name}: {regs} registers, {spill} bytes spill stores", flush=True)


#: B1 and B3 (lane groups; one row per thread), B2, B4 (linearize;
#: cost-only), B5 and B7's kernels in a mangled ptxas name: kernel, then the
#: scalar and, for B1/B3, the Split, Atan and Lifting flags, for B5 the kind
#: (B5's f64 se3 kernel, eval_windows_capped_kernel, is no template);
#: cost_rows_kernel is B3's earlier single kernel (an older checkout's build)
_KERNEL_NAME = re.compile(r"(linearize_rows_kernel|linearize_rows_thread_kernel"
                          r"|cost_rows_lane_kernel|cost_rows_thread_kernel|cost_rows_kernel"
                          r"|assemble_schur_kernel|imu_rows_kernel|imu_cost_kernel"
                          r"|eval_windows_kernel|eval_windows_capped_kernel|r3_evaluate_kernel)"
                          r"(?:I([df])(?:Lb([01])ELb([01])ELb([01])E|Li([012])E)?E)?")


#: B8's kernels (linearize: the primal kernel, then the lane kernel;
#: cost-only): the scalar, the Split and Atan flags and, for the kernels of
#: a row a thread, whether the windows are wide (more than 8 knots)
_NEWTON_NAME = re.compile(r"(newton_rows_kernel|newton_path_kernel|newton_cost_kernel)"
                          r"I([df])Lb([01])ELb([01])E(?:Lb([01])E)?E")


def ptxas_summary(log):
    """[(kernel, registers, spill store bytes)] of each instantiation of
    B1-B5, B7 and B8 in the build's ``ptxas -v`` report."""
    out, name, spill = [], None, 0
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            nm = _NEWTON_NAME.search(entry.group(1))
            if nm:
                name = (f"{nm.group(1)}<{'double' if nm.group(2) == 'd' else 'float'}, "
                        f"{('se3', 'split')[int(nm.group(3))]}, "
                        f"{('pinhole', 'atan')[int(nm.group(4))]}"
                        + ("" if nm.group(5) is None else
                           f", {('W <= 8', 'wide')[int(nm.group(5))]}") + ">")
                spill = 0
                continue
            m = _KERNEL_NAME.search(entry.group(1))
            name = m and (m.group(1) if m.group(2) is None else
                          f"{m.group(1)}<{'double' if m.group(2) == 'd' else 'float'}"
                          + ("" if m.group(3) is None else
                             f", {('se3', 'split')[int(m.group(3))]}, "
                             f"{('pinhole', 'atan')[int(m.group(4))]}, "
                             f"{('static', 'lifting')[int(m.group(5))]}")
                          + ("" if m.group(6) is None else
                             f", {('r3', 'so3', 'se3')[int(m.group(6))]}") + ">")
            spill = 0
            continue
        st = re.search(r"(\d+) bytes spill stores", line)
        if st:
            spill = int(st.group(1))
        used = re.search(r"Used (\d+) registers", line)
        if used and name:
            out.append((name, int(used.group(1)), spill))
            name = None
    return out


def phase_problem(name):
    """Build config 3 or 4 through the entry points on the card and check
    its structure against the JAX package's."""
    from kontiki_tpu_torch.solver import kernels
    from kontiki_tpu_torch.solver.problem import Problem
    from kontiki_tpu_torch.synthetic import make_rsvi_problem

    cfg = CAMERA_CONFIGS[name]
    t0 = time.time()
    prob = make_rsvi_problem(**cfg["kwargs"])
    problem = Problem(prob["trajectory"], prob["measurements"])
    if problem.device.type != "cuda":
        fail(f"{name}: Problem built on {problem.device}, not on the card")
    spec = kernels.problem_spec(problem)
    shape = {b.kind: b.M for b in spec.buckets}
    shape["num_tangent"] = spec.num_tangent
    print(f"{name}: {shape}, splines {[(sp.kind, sp.n) for sp in spec.splines]}, "
          f"landmarks {spec.num_landmarks}, Pc {spec.num_tangent - spec.num_landmarks} "
          f"({time.time() - t0:.1f} s on the host)", flush=True)
    if shape != cfg["shape"]:
        fail(f"{name} structure {shape} != {cfg['shape']}")
    return prob, problem


def phase_b1(problem):
    from kontiki_tpu_torch.ops import linearize_kernels as lk

    cfg, ins = camera_rows(problem)
    names = ("r", "J", "J_rho")
    out = {}
    for dtype in (torch.float64, torch.float32):
        x = {k: v.to(dtype).contiguous() for k, v in ins.items()}
        got = lk.linearize_rows(cfg, x)
        torch.cuda.synchronize()
        want = lk.linearize_rows_plain(cfg, x)
        err = compare("linearize_rows", dtype, names, got, want)
        if dtype == torch.float64:
            out["max_abs_err"] = err
            out["ms"] = cuda_ms(lambda: lk.linearize_rows(cfg, x))
            out["plain_ms"] = cuda_ms(lambda: lk.linearize_rows_plain(cfg, x), reps=5)
            M = x["u_ref"].shape[1]
            rdim, C = lk.camera_shape(cfg)
            nbytes = 8 * M * (n_inputs(cfg, x) + rdim * (C + 2))
            ops = lk.linearize_rows_ops(cfg, x)
            out["bound_ms"], out["bound_by"] = bound(nbytes, ops)
            out["library_ms"] = None  # no single PyTorch call computes B1
            print(f"  linearize_rows {lk.camera_branch(cfg)} f64 M={M}: kernel {out['ms']:.3f} ms, "
                  f"plain {out['plain_ms']:.3f} ms, bound {out['bound_ms']:.4f} ms by "
                  f"{out['bound_by']} ({nbytes} bytes, {ops} operations)", flush=True)
    return out


def camera_rows(problem):
    """(cfg, ins) of the problem's camera bucket at state0, on the card."""
    from kontiki_tpu_torch.solver import kernels

    spec = kernels.problem_spec(problem)
    runtime = kernels.problem_runtime(problem)
    (cam,) = [i for i, b in enumerate(spec.buckets) if b.kind in kernels.CAMERA_KINDS]
    return kernels._camera_inputs(spec, runtime, problem.state0, runtime["data"][cam])[:2]


def n_inputs(cfg, x):
    """Values a camera row reads: the sizes of the inputs present."""
    from kontiki_tpu_torch.ops import linearize_kernels as lk

    return sum(slot[1] for slot in lk.camera_inputs(cfg) if slot is not None and slot[0] in x)


def phase_b3(problems):
    """B3 against its plain version and against B1's residual, on the
    camera rows of each problem; returns the numbers of the first."""
    from kontiki_tpu_torch.ops import linearize_kernels as lk

    first = None
    for name, problem in problems.items():
        cfg, ins = camera_rows(problem)
        M = ins["u_ref"].shape[1]
        print(f"  {name} ({cfg['kind']}) M={M}", flush=True)
        for dtype in (torch.float64, torch.float32):
            x = {k: v.to(dtype).contiguous() for k, v in ins.items()}
            got = lk.cost_rows(cfg, x)
            torch.cuda.synchronize()
            err = compare("cost_rows", dtype, ("r",), (got,), (lk.cost_rows_plain(cfg, x),))
            if dtype != torch.float64:
                continue
            compare("cost_rows vs linearize_rows", dtype, ("r",), (got,),
                    (lk.linearize_rows(cfg, x)[0],))
            out = dict(max_abs_err=err)
            out["ms"] = cuda_ms(lambda: lk.cost_rows(cfg, x))
            out["graph_ms"] = graph_ms(lambda: lk.cost_rows(cfg, x))
            out["plain_ms"] = cuda_ms(lambda: lk.cost_rows_plain(cfg, x), reps=5)
            nbytes = 8 * M * (n_inputs(cfg, x) + lk.camera_shape(cfg)[0])
            ops = lk.cost_rows_ops(cfg, x)
            out["bound_ms"], out["bound_by"] = bound(nbytes, ops)
            out["library_ms"] = None  # no single PyTorch call computes B3
            print(f"  cost_rows {cfg['kind']} f64 M={M}: kernel {out['graph_ms']:.5f} ms per "
                  f"launch on the card ({out['ms']:.4f} ms per call with the host's enqueue), "
                  f"plain {out['plain_ms']:.3f} ms, bound {out['bound_ms']:.5f} ms by "
                  f"{out['bound_by']} ({nbytes} bytes, {ops} operations) [{CARD}]", flush=True)
            first = first or out
    return first


def phase_b2(problem):
    from kontiki_tpu_torch.ops import assembly_kernels as ak
    from kontiki_tpu_torch.solver import kernels
    from kontiki_tpu_torch.solver.schur import whitened_rows

    spec = kernels.problem_spec(problem)
    runtime = kernels.problem_runtime(problem)
    L = spec.num_landmarks
    Pc = spec.num_tangent - L
    lo = spec.landmark_offset
    mask_l = runtime["mask"][lo:lo + L]
    names = ("H", "g", "E", "D", "g_l")
    out = {}
    for bspec, data in zip(spec.buckets, runtime["data"]):
        _, rows = whitened_rows(spec, bspec, runtime, problem.state0, data, mask_l)
        with_rho = bspec.kind in kernels.LANDMARK_KINDS
        for dtype in (torch.float64, torch.float32):
            x = tuple(a.to(dtype) if a.is_floating_point() else a for a in rows)
            kw = dict(P=Pc, L=L, with_rho=with_rho)
            got = ak.assemble_schur_blocks(*x, **kw)
            torch.cuda.synchronize()
            want = ak.assemble_schur_blocks_plain(*x, **kw)
            n = 5 if with_rho else 2
            print(f"  bucket {bspec.kind} M={bspec.M} C={x[0].shape[2]}", flush=True)
            err = compare("assemble_schur_blocks", dtype, names[:n], got[:n], want[:n])
            if with_rho and dtype == torch.float64:
                out["max_abs_err"] = err
                out["ms"] = cuda_ms(lambda: ak.assemble_schur_blocks(*x, **kw))
                out["plain_ms"] = cuda_ms(lambda: ak.assemble_schur_blocks_plain(*x, **kw))
                Jw, cols = x[0], x[1]
                M, rdim, C = Jw.shape
                nbytes = (8 * (Jw.numel() + 2 * M * rdim + Pc * Pc + Pc + L * Pc + 2 * L)
                          + 4 * (cols.numel() + M))
                # per row, rdim multiply-adds for each of: the C(C+1)/2
                # products of the symmetric H's upper triangle, C for g and
                # C for E, one each for D and g_l
                ops = M * 2 * rdim * (C * (C + 1) // 2 + 2 * C + 2)
                out["bound_ms"], out["bound_by"] = bound(nbytes, ops)
                # the yardstick: one cuBLAS product of the densely scattered rows
                Jd = torch.zeros(M, rdim, Pc, dtype=Jw.dtype, device=Jw.device)
                Jd.scatter_add_(2, cols.long()[:, None, :].expand(M, rdim, C), Jw)
                Jd = Jd.reshape(M * rdim, Pc)
                out["library_ms"] = cuda_ms(lambda: Jd.T @ Jd)
                print(f"  assemble_schur_blocks f64 camera bucket: kernel "
                      f"{out['ms']:.3f} ms, plain {out['plain_ms']:.3f} ms, cuBLAS "
                      f"Jd^T Jd [{M * rdim} x {Pc}] {out['library_ms']:.4f} ms, bound "
                      f"{out['bound_ms']:.4f} ms by {out['bound_by']} ({nbytes} bytes, "
                      f"{ops} operations)", flush=True)
    return out


def schur_edge_rows(M, P, L, rdim, C, seed, dtype):
    """Random B2 inputs on the card shaped like a camera bucket: rows in
    runs of one landmark sharing 20 ids, one id repeated in every row (equal
    ids at i != j), ids and lids out of range here and there."""
    import numpy as np

    rng = np.random.default_rng(seed)
    lid = np.sort(rng.integers(0, L, size=M))
    cols = rng.integers(0, P, size=(M, C))
    cols[:, 2:22] = rng.integers(0, P, size=(L, 20))[lid]
    cols[:, 1] = cols[:, 0]
    cols[rng.random((M, C)) < 0.02] = -1
    cols[rng.random((M, C)) < 0.02] = P + 3
    lid[rng.random(M) < 0.05] = L
    real = lambda a: torch.tensor(a, dtype=dtype, device="cuda")  # noqa: E731
    return (real(rng.normal(size=(M, rdim, C))),
            torch.tensor(cols.astype(np.int32), device="cuda"),
            real(rng.normal(size=(M, rdim))), real(rng.normal(size=(M, rdim))),
            torch.tensor(lid.astype(np.int32), device="cuda"))


#: B2 on inputs the main path never makes: (name, M, P, L, rdim, C,
#: with_rho); P = 600 lies past the head triangle that fits the shared
#: memory (~222 ids in f64, ~324 in f32), so part of H goes to global atomics
B2_EDGE_CASES = (("P 600", 3000, 600, 50, 2, 61, True),
                 ("P 600, rdim 3, C 62", 1000, 600, 50, 3, 62, True),
                 ("with_rho False", 500, 194, 10, 2, 61, False),
                 ("M 1", 1, 600, 5, 2, 61, True),
                 ("M 0", 0, 600, 5, 2, 61, True))


def phase_b2_edges():
    """B2 against its plain version (the entries it drops taken out) on
    B2_EDGE_CASES, float64 and float32."""
    from kontiki_tpu_torch.ops import assembly_kernels as ak

    names = ("H", "g", "E", "D", "g_l")
    for i, (case, M, P, L, rdim, C, with_rho) in enumerate(B2_EDGE_CASES):
        for dtype in (torch.float64, torch.float32):
            Jw, cols, rw, J_rho, lid = schur_edge_rows(M, P, L, rdim, C, i, dtype)
            kw = dict(P=P, L=L, with_rho=with_rho)
            got = ak.assemble_schur_blocks(Jw, cols, rw, J_rho, lid, **kw)
            torch.cuda.synchronize()
            drop = (cols < 0) | (cols >= P)
            off = (lid < 0) | (lid >= L)
            want = ak.assemble_schur_blocks_plain(
                Jw * ~drop[:, None, :], torch.where(drop, 0, cols), rw,
                J_rho * ~off[:, None], torch.where(off, 0, lid), **kw)
            n = 5 if with_rho else 2
            print(f"  B2 edge case {case}: M={M} P={P} rdim={rdim} C={C}", flush=True)
            compare("assemble_schur_blocks", dtype, names[:n], got[:n], want[:n])
            if not with_rho and got[2:] != (None, None, None):
                fail(f"assemble_schur_blocks {case}: landmark outputs without with_rho")


def phase_b1_ragged(problems):
    """B1 against its plain version on M = 1, 7 and 129 rows cut from each
    problem's camera rows (a ragged last lane group and block), every third
    row with valid = 0 (its outputs must be exact zeros), float64 and
    float32."""
    from kontiki_tpu_torch.ops import linearize_kernels as lk

    for name, problem in problems.items():
        cfg, ins = camera_rows(problem)
        for M in (1, 7, 129):
            for dtype in (torch.float64, torch.float32):
                x = {k: v[:, :M].to(dtype).contiguous() for k, v in ins.items()}
                x["valid"] = (torch.arange(M, device="cuda") % 3 != 1).to(dtype)[None, :]
                got = lk.linearize_rows(cfg, x)
                torch.cuda.synchronize()
                print(f"  B1 {name} ({lk.camera_branch(cfg)}) M={M}", flush=True)
                compare("linearize_rows branch", dtype, ("r", "J", "J_rho"), got,
                        lk.linearize_rows_plain(cfg, x))
                off = x["valid"][0] == 0
                if not all(bool((a[off] == 0).all()) for a in got):
                    fail(f"linearize_rows {name} M={M}: a row with valid = 0 is not zero")


def phase_b3_ragged(problems):
    """B3 against its plain version (and B1's residual in float64) on
    M = 1, 7 and 129 rows and on one wave of its lane kernel less and plus
    one row (the lane kernel's and the one-row-per-thread kernel's ragged
    last blocks), each problem's camera rows repeated to length, every
    third row with valid = 0 (its residual must be exactly zero), float64
    and float32."""
    from kontiki_tpu_torch.ops import linearize_kernels as lk

    for name, problem in problems.items():
        cfg, ins = camera_rows(problem)
        n = ins["u_ref"].shape[1]
        for dtype in (torch.float64, torch.float32):
            wave = lk.cost_rows_wave(cfg, dtype)
            for M in (1, 7, 129, wave - 1, wave + 1):
                reps = -(-M // n)
                x = {k: v.repeat(1, reps)[:, :M].to(dtype).contiguous() for k, v in ins.items()}
                x["valid"] = (torch.arange(M, device="cuda") % 3 != 1).to(dtype)[None, :]
                got = lk.cost_rows(cfg, x)
                torch.cuda.synchronize()
                print(f"  B3 {name} ({lk.camera_branch(cfg)}) M={M} (wave {wave}):", flush=True)
                compare("cost_rows branch", dtype, ("r",), (got,), (lk.cost_rows_plain(cfg, x),))
                if dtype == torch.float64:
                    compare("cost_rows vs linearize_rows", dtype, ("r",), (got,),
                            (lk.linearize_rows(cfg, x)[0],))
                if not bool((got[x["valid"][0] == 0] == 0).all()):
                    fail(f"cost_rows {name} M={M}: a row with valid = 0 is not zero")


def phase_solve(name, problem):
    """Configs 3/4 and 3-atan(-lifting) ('auto' -> Schur): initial and
    1-iteration costs against the JAX package, a warm-up solve, then the
    timed 25-iteration solve."""
    from kontiki_tpu_torch.ops import linearize_kernels as lk
    from kontiki_tpu_torch.solver import kernels
    from kontiki_tpu_torch.solver.lm import make_fused_solver
    from kontiki_tpu_torch.solver.schur import build_schur_parts

    cfg = CAMERA_CONFIGS[name]
    spec = kernels.problem_spec(problem)
    runtime = kernels.problem_runtime(problem)
    cost0 = build_schur_parts(spec)["linearize"](runtime, problem.state0)[0].item()
    _, cost1, _ = make_fused_solver(problem, 1, function_tolerance=0.0)(problem.state0)
    cost1 = cost1.item()
    atan = name in ATAN_CONFIGS
    for what, got, key in (("initial", cost0, "cost0"), ("1-iteration", cost1, "cost1")):
        want, tol = cfg[key], ATAN_COST_RTOL[key] if atan else COST_RTOL
        rel = abs(got - want) / want
        print(f"{name}: {what} cost {got!r} (JAX {want!r}, rel {rel:.2e}, tol {tol:.0e})",
              flush=True)
        if not rel <= tol:
            fail(f"{name}: {what} cost differs from the JAX package by {rel:.2e}")

    solve = make_fused_solver(problem, 25, function_tolerance=0.0)
    # The first solve on a fresh process pays one-off set-up (lazy CUDA
    # module loads, library handles) worth several solves: time the second.
    t0 = time.perf_counter()
    solve(problem.state0)
    torch.cuda.synchronize()
    print(f"{name}: warm-up solve {time.perf_counter() - t0:.3f} s", flush=True)
    reset_counts()
    t0 = time.perf_counter()
    state, cost, iters = solve(problem.state0)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_counts()
    cost = cost.item()
    ratio = cost / cost0
    print(f"{name}: {iters} iterations in {seconds:.3f} s = {iters / seconds:.2f} it/s; "
          f"initial cost {cost0:.6e} final cost {cost:.6e} ratio {ratio:.3e}; "
          f"launches {launches}", flush=True)
    for k, v in state.items():
        if v.shape != problem.state0[k].shape or not torch.isfinite(v).all():
            fail(f"{name}: final state {k}: bad shape or non-finite values")
    if atan:
        rel = abs(cost - cfg["cost25"]) / cfg["cost25"]
        print(f"{name}: 25-iteration cost {cost!r} (JAX {cfg['cost25']!r}, rel {rel:.2e}, "
              f"tol {ATAN_COST_RTOL['cost25']:.0e})", flush=True)
        if not rel <= ATAN_COST_RTOL["cost25"]:
            fail(f"{name}: 25-iteration cost differs from the JAX package by {rel:.2e}")
    elif not (math.isfinite(ratio) and ratio <= cfg["final_ratio"]):
        fail(f"{name}: final/initial cost {ratio:.3e} > {cfg['final_ratio']:.0e}")
    if iters != 25:
        fail(f"{name}: ran {iters} iterations, expected 25")
    if spec.num_vt and not (0.0 <= state["vt"].min().item() <= state["vt"].max().item() <= 1.0):
        fail(f"{name}: row times left [0, 1]")
    # the speculative loop linearizes state0 and each iteration's candidate,
    # all on the camera bucket's branch
    split = spec.splines[0].kind != "se3"
    branch = lk.camera_branch(camera_rows(problem)[0])
    want = {"linearize_rows": iters + 1, "linearize_rows split": (iters + 1) * split,
            f"linearize_rows {branch}": iters + 1,
            "assemble_schur_blocks": (iters + 1) * len(spec.buckets)}
    if spec.num_vt:  # config 3-atan-lifting's only bucket
        want[B2_LIFTING] = iters + 1
    got = {k: launches.get(k, 0) for k in want}
    if got != want:
        fail(f"{name}: launches {got}, expected {want}")
    return launches


#: B2's per-shape counts of the lifting bucket and config 4-Newton's camera bucket
B2_LIFTING = "assemble_schur_blocks rdim 3 C 62"
B2_NEWTON = "assemble_schur_blocks rdim 2 C 85"


def branch_inputs(problems):
    """(cfg, ins) on the card of every B1/B3 branch: split static branches
    on config 3-atan's rows, split lifting on config 3-atan-lifting's, SE3
    on SE3_ATAN_LIFTING's camera rows; a branch without the atan or lifting
    inputs takes its problem's rows with them dropped."""
    from kontiki_tpu_torch.ops import linearize_kernels as lk
    from kontiki_tpu_torch.solver.problem import Problem
    from kontiki_tpu_torch.synthetic import make_rsvi_problem

    t0 = time.time()
    prob = make_rsvi_problem(**SE3_ATAN_LIFTING)
    se3 = Problem(prob["trajectory"], prob["measurements"])
    print(f"SE3 atan lifting rows: {time.time() - t0:.1f} s on the host", flush=True)
    sources = {("split", False): camera_rows(problems["config 3-atan"]),
               ("split", True): camera_rows(problems["config 3-atan-lifting"]),
               ("se3", False): camera_rows(se3), ("se3", True): camera_rows(se3)}
    out = {}
    for (kind, lifting), (cfg, ins) in sources.items():
        for camera in ("PinholeCamera", "AtanCamera"):
            c = dict(cfg, camera=camera, lifting=lifting, rdim=2 + lifting, C=61 + lifting)
            names = {slot[0] for slot in lk.camera_inputs(c) if slot is not None}
            out[lk.camera_branch(c)] = (c, {k: v for k, v in ins.items() if k in names})
    return out


def phase_branches(branches):
    """B1 and B3 on each branch against their plain versions (f64, f32)
    and B3 against B1's residual; per branch and kernel its error, times
    and bound."""
    from kontiki_tpu_torch.ops import linearize_kernels as lk

    out = {}
    for branch, (cfg, ins) in branches.items():
        M = ins["u_ref"].shape[1]
        rdim, C = lk.camera_shape(cfg)
        print(f"  branch {branch}: M={M}, rdim {rdim}, C {C}", flush=True)
        for dtype in (torch.float64, torch.float32):
            x = {k: v.to(dtype).contiguous() for k, v in ins.items()}
            got = lk.linearize_rows(cfg, x)
            r = lk.cost_rows(cfg, x)
            torch.cuda.synchronize()
            err1 = compare("linearize_rows branch", dtype, ("r", "J", "J_rho"), got,
                           lk.linearize_rows_plain(cfg, x))
            err3 = compare("cost_rows branch", dtype, ("r",), (r,),
                           (lk.cost_rows_plain(cfg, x),))
            if dtype != torch.float64:
                continue
            compare("cost_rows vs linearize_rows", dtype, ("r",), (r,), (got[0],))
            n_in = n_inputs(cfg, x)
            for kernel, fn, plain, err, n_out, ops in (
                    ("linearize_rows", lk.linearize_rows, lk.linearize_rows_plain, err1,
                     rdim * (C + 2), lk.linearize_rows_ops(cfg, x)),
                    ("cost_rows", lk.cost_rows, lk.cost_rows_plain, err3, rdim,
                     lk.cost_rows_ops(cfg, x))):
                rec = dict(max_abs_err=err, ms=cuda_ms(lambda: fn(cfg, x)),
                           plain_ms=cuda_ms(lambda: plain(cfg, x), reps=5))
                per_launch = ""
                if kernel == "cost_rows":
                    rec["graph_ms"] = graph_ms(lambda: fn(cfg, x))
                    per_launch = f", {rec['graph_ms']:.5f} ms per launch on the card"
                nbytes = 8 * M * (n_in + n_out)
                rec["bound_ms"], rec["bound_by"] = bound(nbytes, ops)
                rec["library_ms"] = None  # no single PyTorch call computes B1 or B3
                out[kernel, branch] = rec
                print(f"  {kernel} {branch} f64 M={M}: kernel {rec['ms']:.4f} ms per call"
                      f"{per_launch}, plain {rec['plain_ms']:.3f} ms, bound "
                      f"{rec['bound_ms']:.5f} ms by {rec['bound_by']} ({nbytes} bytes, {ops} "
                      f"operations) [{CARD}]", flush=True)
    return out


def phase_atan_estimator(name, prob):
    """``TrajectoryEstimator`` on config 3-atan's or 3-atan-lifting's
    measurement objects (on the card by default): the Summary against the
    JAX package's, the row times written back, the solution's ATE through
    B5."""
    from kontiki_tpu_torch import TrajectoryEstimator
    from kontiki_tpu_torch.solver import kernels
    from kontiki_tpu_torch.solver.lm import solve as lm_solve
    from kontiki_tpu_torch.solver.problem import Problem
    from kontiki_tpu_torch.synthetic import trajectory_ate

    ref = JAX_ATAN_ESTIMATOR[name]
    lifting = "vt" in ref
    truth, span = prob["true_trajectory"], (0.5, 0.5 + 31 / 30)
    ate_start = trajectory_ate(prob["trajectory"], truth, *span)
    estimator = TrajectoryEstimator(prob["trajectory"])
    for m in prob["measurements"]:
        estimator.add_measurement(m)
    t0 = time.perf_counter()
    lm_solve(Problem(prob["trajectory"], prob["measurements"]), max_iterations=1)
    torch.cuda.synchronize()
    print(f"{name} estimator: warm-up solve {time.perf_counter() - t0:.3f} s", flush=True)
    reset_counts()
    t0 = time.perf_counter()
    summary = estimator.solve(max_iterations=10, progress=False, function_tolerance=0.0)
    seconds = time.perf_counter() - t0
    launches = read_counts()
    n = len(summary.iterations) - 1
    print(f"{name} estimator: {summary.BriefReport()}; {n} iterations in {seconds:.3f} s "
          f"(with problem build and write-back); launches {launches}", flush=True)
    times = (("jacobian", summary.jacobian_evaluation_time_in_seconds),
             ("linear solver", summary.linear_solver_time_in_seconds),
             ("residual", summary.residual_evaluation_time_in_seconds))
    print(f"{name} estimator per-phase times per iteration: "
          + ", ".join(f"{k} {1e3 * v / max(n, 1):.3f} ms" for k, v in times), flush=True)
    for what, got, key, tol in (("initial", summary.initial_cost, "cost0", 1e-9),
                                ("iteration-1", summary.iterations[1].cost, "cost1", 1e-9),
                                ("final", summary.final_cost, "final", 1e-6)):
        rel = abs(got - ref[key]) / ref[key]
        print(f"{name} estimator: {what} cost {got!r} (JAX {ref[key]!r}, rel {rel:.2e}, "
              f"tol {tol:.0e})", flush=True)
        if not rel <= tol:
            fail(f"{name} estimator: {what} cost differs from the JAX package by {rel:.2e}")
    counts = tuple(getattr(summary, k) for k in ATAN_SUMMARY_COUNTS)
    steps = (summary.num_successful_steps, summary.num_unsuccessful_steps)
    print(f"{name} estimator: counts {counts}, steps {steps} (JAX {ref['counts']}, "
          f"{ref['steps']})", flush=True)
    if counts != ref["counts"] or steps != ref["steps"]:
        fail(f"{name} estimator: Summary counts or steps differ from the JAX package's")
    branch = f"split atan {'lifting' if lifting else 'static'}"
    want = {f"cost_rows {branch}": n, f"linearize_rows {branch}": n,
            "assemble_schur_blocks": n, B2_LIFTING: n if lifting else 0}
    got = {k: launches.get(k, 0) for k in want}
    if got != want:
        fail(f"{name} estimator: launches {got}, expected {want} for {n} iterations")
    # the row times land in the measurements; rebuilt, the objects cost the final state
    if lifting:
        vt = torch.tensor([m.vt for m in prob["measurements"]], dtype=torch.float64)
        stats = (vt.sum().item(), vt.min().item(), vt.max().item())
        print(f"{name} estimator: written-back row times sum/min/max {stats} (JAX "
              f"{ref['vt']})", flush=True)
        if not (abs(stats[0] - ref["vt"][0]) <= 1e-6 * ref["vt"][0]
                and all(abs(a - b) <= 1e-6 for a, b in zip(stats[1:], ref["vt"][1:]))):
            fail(f"{name} estimator: written-back row times differ from the JAX package's")
    problem = Problem(prob["trajectory"], prob["measurements"])
    spec = kernels.problem_spec(problem)
    written = kernels.total_cost(spec, kernels.problem_runtime(problem), problem.state0).item()
    if not abs(written - summary.final_cost) <= 1e-9 * summary.initial_cost:
        fail(f"{name} estimator: the written-back objects do not hold the final state "
             f"({written!r} vs {summary.final_cost!r})")
    reset_counts()
    ate = trajectory_ate(prob["trajectory"], truth, *span)
    check_launches(f"{name} ATE", read_counts(),
                   {"evaluate_windows r3": 2, "evaluate_windows so3": 2})
    for what, got, key in (("start", ate_start, "ate_start"), ("solution", ate, "ate")):
        rel = abs(got - ref[key]) / ref[key]
        print(f"{name}: ATE vs truth on {span}, {what}: {got!r} (JAX {ref[key]!r}, rel "
              f"{rel:.2e})", flush=True)
        if not rel <= 1e-6:
            fail(f"{name}: {what} ATE differs from the JAX package's by {rel:.2e}")
    return dict(times, iterations=n)


def imu_problem(name):
    """Build a config-1/2 problem through the entry points (on the card by
    default) and check its structure against the JAX package's."""
    from kontiki_tpu_torch import synthetic
    from kontiki_tpu_torch.solver import kernels
    from kontiki_tpu_torch.solver.problem import Problem

    cfg = IMU_CONFIGS[name]
    t0 = time.time()
    prob = getattr(synthetic, cfg["make"])(**cfg["kwargs"])
    problem = Problem(prob["trajectory"], prob["measurements"])
    if problem.device.type != "cuda":
        fail(f"{name}: Problem built on {problem.device}, not on the card")
    spec = kernels.problem_spec(problem)
    shape = {b.kind: b.M for b in spec.buckets}
    shape["num_tangent"] = spec.num_tangent
    print(f"{name}: {shape}, splines {[(sp.kind, sp.n) for sp in spec.splines]} "
          f"({time.time() - t0:.1f} s on the host)", flush=True)
    if shape != cfg["shape"]:
        fail(f"{name} structure {shape} != {cfg['shape']}")
    return problem


def imu_edge_inputs(ins, M):
    """The first M of a bucket's [k, n] IMU inputs (rows repeated as
    needed; M = None keeps the bucket), every third row with valid = 0."""
    n = ins["u_so3"].shape[1]
    M = n if M is None else M
    x = {k: v.repeat(1, -(-M // n))[:, :M].contiguous() for k, v in ins.items()}
    valid = x.get("valid", torch.ones_like(x["u_so3"])).clone()
    valid[:, ::3] = 0.0
    x["valid"] = valid
    return x


def phase_b4(problems):
    """B4 against its plain version on every bucket of configs 1 and 2, and
    on M = 1, 127 and 129 rows and the whole bucket with every third row at
    valid = 0 (exact zeros there); the time per launch of each form on each
    bucket (on the card, from a CUDA graph of launches, and per call).
    Returns the numbers of each form on the largest bucket (config 2's
    accel rows) with the worst error over all buckets: ``ms`` per call, as
    every kernel's, and ``graph_ms`` per launch on the card."""
    from kontiki_tpu_torch.ops import linearize_kernels as lk
    from kontiki_tpu_torch.solver import kernels

    forms = {"linearize": None, "cost-only": None}
    worst = 0.0
    for name, problem in problems.items():
        spec = kernels.problem_spec(problem)
        runtime = kernels.problem_runtime(problem)
        for bspec, data in zip(spec.buckets, runtime["data"]):
            cfg, ins, _ = kernels._imu_inputs(spec, bspec, runtime, problem.state0, data)
            tag = f"{bspec.kind}/{'so3' if cfg['so3_only'] else 'split'}"
            M = bspec.M
            print(f"  {name} {tag} M={M} C={lk.imu_columns(cfg)}", flush=True)
            for dtype in (torch.float64, torch.float32):
                x = {k: v.to(dtype).contiguous() for k, v in ins.items()}
                got = lk.imu_rows(cfg, x)
                got_c = lk.imu_rows(cfg, x, cost_only=True)
                torch.cuda.synchronize()
                want = lk.imu_rows_plain(cfg, x)
                err = compare("imu_rows", dtype, ("r", "J", "r cost-only"),
                              (*got, got_c), (*want, want[0]))
                for rows in (1, 127, 129, None):
                    xe = imu_edge_inputs(x, rows)
                    got = (*lk.imu_rows(cfg, xe), lk.imu_rows(cfg, xe, cost_only=True))
                    torch.cuda.synchronize()
                    want_e = lk.imu_rows_plain(cfg, xe)
                    what = f"M={xe['u_so3'].shape[1]}, valid=0 rows"
                    print(f"  {name} {tag} {what}:", flush=True)
                    err = max(err, compare("imu_rows", dtype, ("r", "J", "r cost-only"), got,
                                           (*want_e, want_e[0])))
                    dead = xe["valid"][0] == 0
                    if any(torch.count_nonzero(g[dead]).item() for g in got):
                        fail(f"imu_rows {dtype} {name} {tag} {what}: nonzero outputs on rows "
                             "with valid = 0")
                if dtype != torch.float64:
                    continue
                worst = max(worst, err)
                n_in = sum(k for n, k in lk.IMU_INPUTS if n in x)
                for form, cost_only in (("linearize", False), ("cost-only", True)):
                    call_ms = cuda_ms(lambda: lk.imu_rows(cfg, x, cost_only=cost_only))
                    ms = graph_ms(lambda: lk.imu_rows(cfg, x, cost_only=cost_only))
                    plain_ms = cuda_ms(
                        lambda: lk.imu_rows_plain(cfg, x, cost_only=cost_only), reps=5)
                    nbytes = 8 * M * (n_in + 3 + (0 if cost_only else 3 * lk.imu_columns(cfg)))
                    ops = lk.imu_rows_ops(cfg, x, cost_only=cost_only)
                    b_ms, b_by = bound(nbytes, ops)
                    print(f"  imu_rows f64 {name} {tag} {form} M={M}: kernel {ms:.4f} ms per "
                          f"launch on the card ({call_ms:.4f} ms per call with the host's "
                          f"enqueue), plain {plain_ms:.3f} ms, bound {b_ms:.5f} ms by {b_by} "
                          f"({nbytes} bytes, {ops} operations) [{CARD}]", flush=True)
                    if (name, bspec.kind) == ("config 2", "accel"):
                        forms[form] = dict(ms=call_ms, graph_ms=ms, plain_ms=plain_ms,
                                           bound_ms=b_ms, bound_by=b_by,
                                           library_ms=None)  # no single PyTorch call
    for r in forms.values():
        r["max_abs_err"] = worst
    return forms


def phase_imu_solve(name, problem):
    """Configs 1/2: initial and 1-iteration costs against the JAX package,
    a warm-up solve, then the timed 25-iteration solve."""
    from kontiki_tpu_torch.solver import kernels
    from kontiki_tpu_torch.solver.lm import make_fused_solver

    cfg = IMU_CONFIGS[name]
    spec = kernels.problem_spec(problem)
    runtime = kernels.problem_runtime(problem)
    cost0 = kernels.build_parts(spec)["total_cost"](runtime, problem.state0).item()
    _, cost1, _ = make_fused_solver(problem, 1, function_tolerance=0.0)(problem.state0)
    cost1 = cost1.item()
    for what, got, want in (("initial", cost0, cfg["cost0"]), ("1-iteration", cost1, cfg["cost1"])):
        rel = abs(got - want) / want
        print(f"{name}: {what} cost {got!r} (JAX {want!r}, rel {rel:.2e})", flush=True)
        if not rel <= COST_RTOL:
            fail(f"{name}: {what} cost differs from the JAX package by {rel:.2e}")

    solve = make_fused_solver(problem, 25, function_tolerance=0.0)  # 'auto' -> dense
    t0 = time.perf_counter()
    solve(problem.state0)
    torch.cuda.synchronize()
    print(f"{name}: warm-up solve {time.perf_counter() - t0:.3f} s", flush=True)
    reset_counts()
    t0 = time.perf_counter()
    state, cost, iters = solve(problem.state0)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_counts()
    ratio = cost.item() / cost0
    print(f"{name}: {iters} iterations in {seconds:.4f} s = {iters / seconds:.2f} it/s; "
          f"initial cost {cost0:.6e} final cost {cost.item():.6e} ratio {ratio:.3e}; "
          f"launches {launches}", flush=True)
    for k, v in state.items():
        if v.shape != problem.state0[k].shape or not torch.isfinite(v).all():
            fail(f"{name}: final state {k}: bad shape or non-finite values")
    if not (math.isfinite(ratio) and ratio <= cfg["final_ratio"]):
        fail(f"{name}: final/initial cost {ratio:.3e} > {cfg['final_ratio']:.0e}")
    if iters != 25:
        fail(f"{name}: ran {iters} iterations, expected 25")
    n_lin = launches["imu_rows"] - launches["imu_rows cost-only"]
    if n_lin <= 0 or launches["imu_rows cost-only"] <= 0:
        fail(f"{name}: imu_rows was not launched by both the linearization and the "
             f"re-cost ({launches})")
    return launches


def host_ms(fn, reps=5):
    """Median host milliseconds of ``fn()`` ending in a synchronize."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    times.sort()
    return times[len(times) // 2]


def phase_breakdown(problem):
    """One config-2 LM iteration (``build_parts`` step) by part."""
    from kontiki_tpu_torch.ops import linearize_kernels as lk
    from kontiki_tpu_torch.solver import kernels

    spec = kernels.problem_spec(problem)
    rt = kernels.problem_runtime(problem)
    parts = kernels.build_parts(spec)
    s0 = problem.state0
    lam = torch.tensor(1e-4, dtype=problem.dtype, device=problem.device)
    cost, H, g = parts["linearize"](rt, s0)
    delta, _ = parts["solve_from_lin"](rt, s0, H, g, lam)
    rows = {}
    for bspec, data in zip(spec.buckets, rt["data"]):
        cfg, ins, _ = kernels._imu_inputs(spec, bspec, rt, s0, data)
        rows[bspec.kind] = (
            host_ms(lambda: kernels._imu_inputs(spec, bspec, rt, s0, data)),
            host_ms(lambda: lk.imu_rows(cfg, ins)),
            host_ms(lambda: lk.imu_rows(cfg, ins, cost_only=True)),
        )
    table = [
        ("step (one LM iteration)", host_ms(lambda: parts["step"](rt, s0, lam))),
        ("- linearize (2 buckets, dense assembly)", host_ms(lambda: parts["linearize"](rt, s0))),
        *[(f"-- {k}: gather {a:.3f} + B4 {b:.3f}", a + b) for k, (a, b, _) in rows.items()],
        ("- damped solve + projection + prediction",
         host_ms(lambda: parts["solve_from_lin"](rt, s0, H, g, lam))),
        ("- retract", host_ms(lambda: parts["retract"](rt, s0, delta))),
        ("- re-cost (total_cost)", host_ms(lambda: parts["total_cost"](rt, s0))),
        *[(f"-- {k}: B4 cost-only", c) for k, (_, _, c) in rows.items()],
    ]
    print("config 2 iteration breakdown (host ms, synchronize after each part, median of 5):",
          flush=True)
    for name, ms in table:
        print(f"  {name}: {ms:.3f} ms", flush=True)
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            parts["step"](rt, s0, lam)
        torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t0)
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    dev = sum(e.self_device_time_total for e in events) / 1e3
    n = sum(e.count for e in events)
    if not (n > 0 and dev > 0):
        fail(f"profiler: no device time in the trace ({n} device events)")
    print(f"  profiler, 3 iterations: {n} device kernels, {dev:.3f} ms of device "
          f"time in {wall:.3f} ms of wall time (busy {dev / wall:.1%}, profiler on)",
          flush=True)


def phase_estimator(name, prob):
    """``TrajectoryEstimator`` on a config's measurement objects, on the
    card by default: ``solve(max_iterations=10, progress=False,
    function_tolerance=0.0)`` against the JAX package's ``lm.solve``."""
    from kontiki_tpu_torch import TrajectoryEstimator
    from kontiki_tpu_torch.solver import kernels
    from kontiki_tpu_torch.solver.lm import solve as lm_solve
    from kontiki_tpu_torch.solver.problem import Problem

    ref = LM_SOLVE[name]
    estimator = TrajectoryEstimator(prob["trajectory"])
    for m in prob["measurements"]:
        estimator.add_measurement(m)
    # untimed warm-up of the phase-split path (no write-back)
    t0 = time.perf_counter()
    lm_solve(Problem(prob["trajectory"], prob["measurements"]), max_iterations=1)
    torch.cuda.synchronize()
    print(f"{name} estimator: warm-up solve {time.perf_counter() - t0:.3f} s", flush=True)
    reset_counts()
    t0 = time.perf_counter()
    summary = estimator.solve(max_iterations=10, progress=False, function_tolerance=0.0)
    seconds = time.perf_counter() - t0
    launches = read_counts()
    n = len(summary.iterations) - 1
    print(f"{name} estimator: {summary.BriefReport()}; {n} iterations in {seconds:.3f} s "
          f"(with problem build and write-back); launches {launches}", flush=True)
    times = (("jacobian", summary.jacobian_evaluation_time_in_seconds),
             ("linear solver", summary.linear_solver_time_in_seconds),
             ("residual", summary.residual_evaluation_time_in_seconds))
    print(f"{name} estimator per-phase times (host clock, each phase ended by its "
          f"result's host read), per iteration: "
          + ", ".join(f"{k} {1e3 * v / max(n, 1):.3f} ms" for k, v in times)
          + f"; minimizer {summary.minimizer_time_in_seconds:.3f} s, total "
          f"{summary.total_time_in_seconds:.3f} s", flush=True)

    for what, got, want in (("initial", summary.initial_cost, ref["cost0"]),
                            ("iteration-1", summary.iterations[1].cost, ref["cost1"])):
        rel = abs(got - want) / want
        print(f"{name} estimator: {what} cost {got!r} (JAX lm.solve {want!r}, rel {rel:.2e})",
              flush=True)
        if not rel <= COST_RTOL:
            fail(f"{name} estimator: {what} cost differs from the JAX package by {rel:.2e}")
    counts = tuple(getattr(summary, k) for k in SUMMARY_COUNTS)
    if counts != ref["counts"]:
        fail(f"{name} estimator: Summary counts {counts} != JAX {ref['counts']}")
    if summary.termination_type.name not in ("NoConvergence", "Convergence") or n < 2:
        fail(f"{name} estimator: {summary.termination_type.name} after {n} iterations")

    problem = Problem(prob["trajectory"], prob["measurements"])
    spec = kernels.problem_spec(problem)
    cams = sum(b.kind == "rs_static" for b in spec.buckets)
    want = {"cost_rows": n * cams, "linearize_rows": n * cams,
            "assemble_schur_blocks": n * len(spec.buckets)}
    got = {k: launches[k] for k in want}
    if got != want:
        fail(f"{name} estimator: launches {got}, expected {want} for {n} iterations")
    # the written-back objects hold the final state: rebuilt, they cost it
    written = kernels.total_cost(spec, kernels.problem_runtime(problem), problem.state0).item()
    print(f"{name} estimator: cost of the written-back objects {written!r}, Summary final "
          f"cost {summary.final_cost!r}", flush=True)
    if not abs(written - summary.final_cost) <= 1e-9 * summary.initial_cost:
        fail(f"{name} estimator: the written-back objects do not hold the final state")
    return dict(times, iterations=n)


def query_setup():
    """The user-size query inputs: the SE3 and split trajectories, the
    4.8 M row times (numpy, frame order) and a seeded permutation of them."""
    import numpy as np

    from kontiki_tpu_torch import synthetic

    t0 = time.time()
    se3 = synthetic.make_se3_trajectory(QUERY_DURATION, dt=0.1, seed=5)
    split = synthetic.make_split_trajectory(QUERY_DURATION, dt=0.1, seed=5, speed=0.3,
                                            wmag=0.2)
    sizes = (len(se3), len(split.R3_spline), len(split.SO3_spline))
    if sizes != (QUERY_KNOTS,) * 3:
        fail(f"query trajectories have {sizes} knots, expected {QUERY_KNOTS}")
    frames = QUERY_T_FIRST + np.arange(QUERY_FRAMES) / QUERY_FPS
    rows = np.arange(QUERY_ROWS) * (QUERY_READOUT / QUERY_ROWS)
    ts = (frames[:, None] + rows[None, :]).ravel()
    perm = np.random.default_rng(5).permutation(ts.shape[0])
    print(f"queries: {ts.shape[0]} row times on [{ts[0]}, {ts[-1]}], trajectories of "
          f"{QUERY_KNOTS} knots ({time.time() - t0:.1f} s on the host)", flush=True)
    return dict(se3=se3, split=split, ts=ts, perm=perm)


def plain_chunked(fn, *args, n):
    """``fn`` on consecutive chunks of the ``n`` rows of every tensor
    argument with ``n`` rows (the plain versions' temporaries at 4.8 M
    rows; knots pass whole), outputs concatenated."""
    def chunk(a, i):
        return a[i:i + PLAIN_CHUNK] if torch.is_tensor(a) and a.shape[0] == n else a

    outs = [fn(*[chunk(a, i) for a in args]) for i in range(0, n, PLAIN_CHUNK)]
    return tuple(torch.cat(parts) for parts in zip(*outs))


def phase_b5(q):
    """B5 against its plain version on the user-size windows of each kind,
    in frame order and shuffled, on M = 1, 127 and 129 of them (partial
    blocks) and, so3/se3, on a window of equal knots (the log/exp Taylor
    branches); times per launch in both orders. Returns the frame order's
    numbers."""
    from kontiki_tpu_torch.ops import linearize_kernels as lk
    from kontiki_tpu_torch.trajectories import spline_eval as ev

    dev = torch.device(QUERY_DEVICE)
    orders = {"frame order": torch.tensor(q["ts"], device=dev),
              "shuffled": torch.tensor(q["ts"][q["perm"]], device=dev)}
    splines = {"r3": q["split"].R3_spline, "so3": q["split"].SO3_spline, "se3": q["se3"]}
    names = {"r3": ("p", "v", "a"), "so3": ("q", "w"), "se3": ("p", "v", "a", "q", "w")}
    out = {}
    for kind, sp in splines.items():
        knots = torch.tensor(sp.knots, device=dev)
        for order, ts in orders.items():
            M = ts.shape[0]
            i0, u = ev.index_and_u(ts, sp.t0, sp.dt, knots.shape[0])
            win = ev.gather_windows(knots, i0).contiguous()
            u = u.contiguous()
            del i0
            print(f"  evaluate_windows {kind} {order}: windows {tuple(win.shape)}", flush=True)
            for dtype in (torch.float64, torch.float32):
                w, uu = win.to(dtype), u.to(dtype)
                got = lk.evaluate_windows(kind, w, uu, sp.dt)
                torch.cuda.synchronize()
                want = plain_chunked(lk.evaluate_windows_plain, kind, w, uu, sp.dt, n=M)
                err = compare(f"evaluate_windows {kind}", dtype, names[kind], got, want)
                del got, want
                if order == "frame order":
                    for m in (1, 127, 129):
                        print(f"  evaluate_windows {kind} M={m}:", flush=True)
                        wm, um = w[:m].contiguous(), uu[:m].contiguous()
                        err = max(err, compare(f"evaluate_windows {kind}", dtype, names[kind],
                                               lk.evaluate_windows(kind, wm, um, sp.dt),
                                               lk.evaluate_windows_plain(kind, wm, um, sp.dt)))
                    if kind != "r3":
                        print(f"  evaluate_windows {kind}, a window of equal knots:", flush=True)
                        wm, um = w[:129].clone(), uu[:129].contiguous()
                        wm[0] = wm[0, :1]
                        err = max(err, compare(f"evaluate_windows {kind}", dtype, names[kind],
                                               lk.evaluate_windows(kind, wm, um, sp.dt),
                                               lk.evaluate_windows_plain(kind, wm, um, sp.dt)))
                if dtype != torch.float64:
                    continue
                r = dict(max_abs_err=err)
                r["ms"] = cuda_ms(lambda: lk.evaluate_windows(kind, w, uu, sp.dt))
                r["plain_ms"] = cuda_ms(
                    lambda: plain_chunked(lk.evaluate_windows_plain, kind, w, uu, sp.dt, n=M),
                    reps=3, warmup=1)
                n_out = sum(lk.EVAL_OUTPUTS[kind])
                nbytes = 8 * M * (4 * lk.EVAL_KNOT_DIM[kind] + 1 + n_out)
                t0 = time.time()
                if order == "frame order":  # the same count in both orders
                    ops = lk.evaluate_windows_ops(kind, w, uu, sp.dt)
                r["bound_ms"], r["bound_by"] = bound(nbytes, ops)
                r["library_ms"] = None  # no single PyTorch call computes B5
                print(f"  evaluate_windows {kind} f64 {order} M={M}: kernel {r['ms']:.4f} ms "
                      f"per launch, plain {r['plain_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms "
                      f"by {r['bound_by']} ({nbytes} bytes, {ops} operations, counted in "
                      f"{time.time() - t0:.1f} s on the host) [{CARD}]", flush=True)
                if order == "frame order":
                    out[kind] = r
                else:
                    out[kind]["max_abs_err"] = max(out[kind]["max_abs_err"], err)
            del win, u, w, uu
    return out


def phase_b7(q):
    """B7 against its plain version at the user-size times, in frame order
    and shuffled (times and bound in both orders), then on the edges: B = 1,
    255, 257, 1,023 and 1,025 times (about a block of 1,024), a spline of
    one window (N = 4), times before t0 and past the last window (the
    clamp), sorted and shuffled. Returns the frame order's numbers with the
    shuffled order's beside them and the worst error of all."""
    import numpy as np

    from kontiki_tpu_torch.ops import spline_kernels as sk

    dev = torch.device(QUERY_DEVICE)
    sp = q["split"].R3_spline
    orders = {"frame order": torch.tensor(q["ts"], device=dev),
              "shuffled": torch.tensor(q["ts"][q["perm"]], device=dev)}
    out = {}
    worst = 0.0
    for order, ts in orders.items():
        M = ts.shape[0]
        for dtype in (torch.float64, torch.float32):
            knots = torch.tensor(sp.knots, device=dev, dtype=dtype)
            t = ts.to(dtype)
            got = sk.r3_evaluate_kernel(knots, sp.t0, sp.dt, t)
            torch.cuda.synchronize()
            want = plain_chunked(sk.r3_evaluate_plain, knots, sp.t0, sp.dt, t, n=M)
            print(f"  r3_evaluate_kernel {order}:", flush=True)
            err = compare("r3_evaluate_kernel", dtype, ("p", "v", "a"), got, want)
            if dtype != torch.float64:
                continue
            worst = max(worst, err)
            ms = cuda_ms(lambda: sk.r3_evaluate_kernel(knots, sp.t0, sp.dt, t))
            per_launch = graph_ms(lambda: sk.r3_evaluate_kernel(knots, sp.t0, sp.dt, t), n=10)
            plain_ms = cuda_ms(lambda: sk.r3_evaluate_plain(knots, sp.t0, sp.dt, t),
                               reps=3, warmup=1)
            nbytes = 8 * (M * (1 + 9) + knots.numel())
            ops = sk.r3_evaluate_ops(knots, sp.t0, sp.dt, t)
            b_ms, b_by = bound(nbytes, ops)
            print(f"  r3_evaluate_kernel f64 {order} M={M}: kernel {ms:.4f} ms per call, "
                  f"{per_launch:.4f} ms per launch on the card, plain {plain_ms:.3f} ms, bound "
                  f"{b_ms:.4f} ms by {b_by} ({nbytes} bytes, {ops} operations) [{CARD}]",
                  flush=True)
            out[order] = dict(ms=ms, graph_ms=per_launch, plain_ms=plain_ms, bound_ms=b_ms,
                              bound_by=b_by)
    rng = np.random.default_rng(9)
    t0, dt = 0.3, 0.25
    for N in (4, 40):
        for B in (1, 255, 257, 1023, 1025):
            ts = np.sort(rng.uniform(t0 - 2 * dt, t0 + N * dt, B))
            for dtype in (torch.float64, torch.float32):
                knots = torch.tensor(rng.normal(size=(N, 3)), device=dev, dtype=dtype)
                for order, tv in (("sorted", ts), ("shuffled", rng.permutation(ts))):
                    t = torch.tensor(tv, device=dev, dtype=dtype)
                    print(f"  r3_evaluate_kernel N={N} B={B} {order}, times on "
                          f"[t0 - 2 dt, t0 + N dt]:", flush=True)
                    err = compare("r3_evaluate_kernel", dtype, ("p", "v", "a"),
                                  sk.r3_evaluate_kernel(knots, t0, dt, t),
                                  sk.r3_evaluate_plain(knots, t0, dt, t))
                    if dtype == torch.float64:
                        worst = max(worst, err)
    first = out["frame order"]
    return dict(max_abs_err=worst, **first, shuffled_ms=out["shuffled"]["ms"],
                shuffled_graph_ms=out["shuffled"]["graph_ms"],
                shuffled_plain_ms=out["shuffled"]["plain_ms"],
                shuffled_bound_ms=out["shuffled"]["bound_ms"],
                library_ms=None)  # no single PyTorch call computes B7


def check_launches(what, launches, want):
    got = {k: launches.get(k, 0) for k in want}
    if got != want:
        fail(f"{what}: launches {got}, expected {want}")


def phase_readback(q, built4):
    """Queries through the entry points: the user-size read-back (B5 via
    the trajectory API, B7 via ``ops.r3_evaluate_kernel``) and config 4's
    built trajectory against the JAX package's values."""
    import numpy as np

    from kontiki_tpu_torch.ops import r3_evaluate_kernel

    ts = q["ts"]
    M = ts.shape[0]
    reset_counts()
    got, times = {}, []
    for name, traj in (("se3", q["se3"]), ("split", q["split"])):
        for query in ("position", "orientation"):
            t0 = time.perf_counter()
            got[name, query] = getattr(traj, query)(ts)
            times.append(f"{name} {query} {time.perf_counter() - t0:.3f} s")
    sp = q["split"].R3_spline
    knots = torch.tensor(sp.knots, device=QUERY_DEVICE)
    t_dev = torch.tensor(ts, device=QUERY_DEVICE)
    t0 = time.perf_counter()
    p7 = r3_evaluate_kernel(knots, sp.t0, sp.dt, t_dev)[0].cpu().numpy()
    times.append(f"B7 frame order {time.perf_counter() - t0:.3f} s")
    perm = q["perm"]
    t_perm = torch.tensor(ts[perm], device=QUERY_DEVICE)
    t0 = time.perf_counter()
    p7s = r3_evaluate_kernel(knots, sp.t0, sp.dt, t_perm)[0].cpu().numpy()
    times.append(f"B7 shuffled {time.perf_counter() - t0:.3f} s")
    launches = read_counts()
    print(f"read-back of {M} row times (host clock per call, transfers included): "
          + ", ".join(times) + f"; launches {launches}", flush=True)
    check_launches("user-size read-back", launches, {
        "evaluate_windows se3": 2, "evaluate_windows r3": 2, "evaluate_windows so3": 2,
        "r3_evaluate_kernel": 2})
    for key, v in got.items():
        width = 3 if key[1] == "position" else 4
        if v.shape != (M, width) or not np.isfinite(v).all():
            fail(f"read-back {key}: shape {v.shape} or non-finite values")
    norms = np.linalg.norm(got["se3", "orientation"], axis=1)
    print(f"  max | |q| - 1 | over the se3 orientations: {np.abs(norms - 1).max():.2e}",
          flush=True)
    if not np.abs(norms - 1).max() <= 1e-12:
        fail("read-back: se3 orientations are not unit quaternions")
    inv = np.empty_like(perm)
    inv[perm] = np.arange(M)
    compare("query vs r3_evaluate_kernel", torch.float64, ("position", "shuffled"),
            (torch.from_numpy(got["split", "position"]), torch.from_numpy(p7s[inv])),
            (torch.from_numpy(p7), torch.from_numpy(p7)))

    gyro_ts = np.array([m.t for m in built4["measurements"] if type(m).__name__ ==
                        "GyroscopeMeasurement"])
    traj = built4["trajectory"]
    reset_counts()
    values = {name: getattr(traj, name)(gyro_ts) for name in JAX_CONFIG4_QUERIES}
    launches = read_counts()
    check_launches("config 4 queries", launches, {"evaluate_windows se3": 5})
    for name, (checksum, rows) in JAX_CONFIG4_QUERIES.items():
        v = values[name]
        if v.shape[0] != 425:
            fail(f"config 4 {name}: {v.shape[0]} gyro times, expected 425")
            continue
        rel_sum = abs(np.abs(v).sum() - checksum) / checksum
        want = np.array([rows[i] for i in sorted(rows)])
        rel_rows = np.abs(v[sorted(rows)] - want).max() / np.abs(want).max()
        print(f"  config 4 {name} at {len(gyro_ts)} gyro times: sum|.| {np.abs(v).sum()!r} "
              f"(JAX {checksum!r}, rel {rel_sum:.2e}); rows 0/212/424 rel {rel_rows:.2e}",
              flush=True)
        if not (rel_sum <= QUERY_RTOL and rel_rows <= QUERY_RTOL):
            fail(f"config 4 {name}: differs from the JAX package's values")


def phase_readback_split(q):
    """Where one read-back query call goes: the se3 trajectory's
    ``position`` at the 4.8 M row times as a whole, then its stages one by
    one on the host clock with a synchronize after each (the range check,
    host -> device of the knots and times, ``index_and_u``,
    ``gather_windows``, B5, device -> host of the five outputs, as the
    trajectory's ``_eval`` returns them all)."""
    import numpy as np

    from kontiki_tpu_torch.ops import linearize_kernels as lk
    from kontiki_tpu_torch.trajectories import spline_eval as ev

    traj, ts = q["se3"], q["ts"]
    traj.position(ts)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    whole = traj.position(ts)
    total = time.perf_counter() - t0
    stages = []
    t = time.perf_counter()

    def lap(stage, t):
        torch.cuda.synchronize()
        now = time.perf_counter()
        stages.append(f"{stage} {1e3 * (now - t):.3f}")
        return now

    ts_np, _ = traj._times(ts)
    t = lap("range check", t)
    knots = traj._knots_on(traj._resolve(None))
    t_dev = torch.as_tensor(ts_np, device=knots.device)
    t = lap("host -> device", t)
    i0, u = ev.index_and_u(t_dev, traj.t0, traj.dt, knots.shape[0])
    t = lap("index_and_u", t)
    win, u = ev.gather_windows(knots, i0).contiguous(), u.contiguous()
    t = lap("gather_windows", t)
    outs = lk.evaluate_windows("se3", win, u, traj.dt)
    t = lap("B5", t)
    host = [o.cpu().numpy() for o in outs]
    t = lap("device -> host", t)
    print(f"read-back split, se3 position at {ts.shape[0]} row times: whole call "
          f"{1e3 * total:.3f} ms; stages (ms) " + ", ".join(stages) + f" [{CARD}]", flush=True)
    if not np.array_equal(host[0], whole):
        fail("read-back split: the staged query differs from the whole call")


def phase_scores(built_traj, prob4):
    """ATE/AOE of config 4's built and written-back trajectories against
    the truth, through the queries on the card, against the JAX package's."""
    from kontiki_tpu_torch.synthetic import trajectory_aoe, trajectory_ate

    truth, span = prob4["true_trajectory"], (0.5, 0.5 + 63 / 30)
    reset_counts()
    for what, traj in (("built", built_traj), ("written-back", prob4["trajectory"])):
        got = (trajectory_ate(traj, truth, *span), trajectory_ate(traj, truth, *span,
                                                                 align="se3"),
               trajectory_aoe(traj, truth, *span, align=False))
        want = JAX_CONFIG4_SCORES[what]
        print(f"config 4 {what} trajectory vs truth: ATE {got[0]!r}, ATE(se3) {got[1]!r}, "
              f"AOE {got[2]!r} (JAX {want})", flush=True)
        for i, name in enumerate(("ATE", "ATE(se3)", "AOE")):
            if what == "written-back" and name == "ATE(se3)":
                ok = got[i] <= ALIGNED_ATE_ABS
            else:
                ok = abs(got[i] - want[i]) <= SCORE_RTOL * want[i]
            if not ok:
                fail(f"config 4 {what} {name} {got[i]!r} differs from the JAX package's "
                     f"{want[i]!r}")
    check_launches("config 4 scores", read_counts(), {"evaluate_windows se3": 12})


def phase_pose_fit():
    """The motion-capture pose fit through ``TrajectoryEstimator`` on the
    card, against the JAX ``lm.solve``; then the solution's queries."""
    from kontiki_tpu_torch import TrajectoryEstimator
    from kontiki_tpu_torch import synthetic
    from kontiki_tpu_torch.solver.lm import solve as lm_solve
    from kontiki_tpu_torch.solver.problem import Problem

    c = POSE_FIT
    t0 = time.time()
    truth = synthetic.make_split_trajectory(c["duration"], dt=c["dt"], seed=c["seed"])
    traj = synthetic.perturb_trajectory(truth, seed=c["perturb_seed"])
    ms = synthetic.make_pose_measurements(truth, 0.0, c["duration"], c["rate"], c["noise"],
                                          c["noise"], seed=c["noise_seed"])
    problem = Problem(traj, ms)
    print(f"pose fit: {len(ms)} rows, {len(traj.R3_spline)} + {len(traj.SO3_spline)} "
          f"knots, P = {problem.num_tangent} on {problem.device} "
          f"({time.time() - t0:.1f} s on the host)", flush=True)
    t0 = time.perf_counter()
    lm_solve(problem, max_iterations=1, progress=False)
    torch.cuda.synchronize()
    print(f"pose fit: warm-up solve {time.perf_counter() - t0:.3f} s", flush=True)
    estimator = TrajectoryEstimator(traj)
    for m in ms:
        estimator.add_measurement(m)
    reset_counts()
    t0 = time.perf_counter()
    summary = estimator.solve(max_iterations=10, progress=False, function_tolerance=0.0)
    seconds = time.perf_counter() - t0
    launches = read_counts()
    n = len(summary.iterations) - 1
    print(f"pose fit: {summary.BriefReport()}; {n} iterations in {seconds:.3f} s (with "
          f"problem build and write-back); launches {launches}", flush=True)
    print("pose fit per-phase times (host clock, each phase ended by its result's host "
          "read), per iteration: "
          f"jacobian {1e3 * summary.jacobian_evaluation_time_in_seconds / max(n, 1):.3f} ms, "
          f"linear solver {1e3 * summary.linear_solver_time_in_seconds / max(n, 1):.3f} ms, "
          f"residual {1e3 * summary.residual_evaluation_time_in_seconds / max(n, 1):.3f} ms; "
          f"minimizer {summary.minimizer_time_in_seconds:.3f} s, total "
          f"{summary.total_time_in_seconds:.3f} s", flush=True)
    ref = JAX_POSE_FIT
    for what, got, want in (("initial", summary.initial_cost, ref["cost0"]),
                            ("iteration-1", summary.iterations[1].cost, ref["cost1"])):
        rel = abs(got - want) / want
        print(f"pose fit: {what} cost {got!r} (JAX lm.solve {want!r}, rel {rel:.2e})",
              flush=True)
        if not rel <= COST_RTOL:
            fail(f"pose fit: {what} cost differs from the JAX package by {rel:.2e}")
    counts = tuple(getattr(summary, k) for k in SUMMARY_COUNTS)
    if counts != ref["counts"]:
        fail(f"pose fit: Summary counts {counts} != JAX {ref['counts']}")
    if summary.termination_type.name not in ("NoConvergence", "Convergence") or n < 2:
        fail(f"pose fit: {summary.termination_type.name} after {n} iterations")

    span = (0.0, c["duration"] - 1.0 / c["rate"])
    start = synthetic.perturb_trajectory(truth, seed=c["perturb_seed"])
    reset_counts()
    scores = {what: (synthetic.trajectory_ate(t, truth, *span, n=6000),
                     synthetic.trajectory_aoe(t, truth, *span, n=6000, align=False))
              for what, t in (("start", start), ("solution", traj))}
    check_launches("pose fit scores", read_counts(),
                   {"evaluate_windows r3": 8, "evaluate_windows so3": 8})
    print(f"pose fit vs truth at 6,000 times: start ATE {scores['start'][0]:.6e} m, AOE "
          f"{scores['start'][1]:.6e} rad; solution ATE {scores['solution'][0]:.6e} m, AOE "
          f"{scores['solution'][1]:.6e} rad", flush=True)
    if not (scores["solution"][0] < scores["start"][0]
            and scores["solution"][1] < scores["start"][1]):
        fail("pose fit: the solution is not closer to the truth than the start")
    return summary


def config5_problem():
    """Config 5 through ``make_big_ba_problem`` on the card, with its layout
    and structure against the JAX package's."""
    from kontiki_tpu_torch.parallel.segments_ba import segment_ba_layout
    from kontiki_tpu_torch.synthetic import make_big_ba_problem

    t0 = time.time()
    big = make_big_ba_problem(**CONFIG5)
    gen_s = time.time() - t0
    problem = big["problem"]
    if problem.device.type != "cuda":
        fail(f"config 5: RawProblem built on {problem.device}, not on the card")
    t0 = time.time()
    _, _, _, lay = segment_ba_layout(problem, 1)
    layout_s = time.time() - t0
    cam = problem.buckets["rs_static:PinholeCamera"]
    shape = dict(rows=cam.M, weight=cam.data["weight"].sum().item(),
                 knots=problem.splines[0].n, seg=lay["seg"], G=lay["G"], nbloc=lay["nbloc"],
                 Lb=lay["Lb"], LaMax=lay["LaMax"], Ma=[t["Ma"] for t in lay["banded_tables"]])
    print(f"config 5: {shape}; generation {gen_s:.1f} s, layout {layout_s:.2f} s on the host",
          flush=True)
    if shape != JAX_CONFIG5["shape"]:
        fail(f"config 5 structure {shape} != {JAX_CONFIG5['shape']}")
    return big


def config5_camera_rows(problem):
    """(cfg, ins) of config 5's camera rows at state0 in the segment layout
    (padded knots, window bases clamped at the real knot count, the
    ``valid`` input), on the card."""
    from kontiki_tpu_torch.parallel.segments_ba import _build_segment_ba
    from kontiki_tpu_torch.solver import kernels

    b = _build_segment_ba(problem, None, "banded")
    rt = b["runtime"]
    cfg, ins, _ = kernels._camera_inputs(b["spec_local"], rt, b["to_sharded"](problem.state0),
                                         rt["data"][0])
    if "valid" not in ins:
        fail("config 5 camera rows: the kernels' inputs lack the rows' valid flags")
    return cfg, ins


def phase_config5_rows(problem):
    """B1 (split) and B3 against their plain versions at config 5's 500,000
    camera rows in the segment layout (config5_camera_rows), float64 and
    float32."""
    from kontiki_tpu_torch.ops import linearize_kernels as lk

    cfg, ins = config5_camera_rows(problem)
    M = ins["u_ref"].shape[1]
    for dtype in (torch.float64, torch.float32):
        x = {k: v.to(dtype).contiguous() for k, v in ins.items()}
        got = lk.linearize_rows(cfg, x)
        got_c = lk.cost_rows(cfg, x)
        torch.cuda.synchronize()
        compare("linearize_rows", dtype, ("r", "J", "J_rho"), got, lk.linearize_rows_plain(cfg, x))
        compare("cost_rows", dtype, ("r",), (got_c,), (lk.cost_rows_plain(cfg, x),))
        if dtype == torch.float64:
            ms = cuda_ms(lambda: lk.linearize_rows(cfg, x))
            ms_c = cuda_ms(lambda: lk.cost_rows(cfg, x))
            graph_c = graph_ms(lambda: lk.cost_rows(cfg, x))
            print(f"  config 5 camera rows M={M} f64: linearize_rows split {ms:.3f} ms, "
                  f"cost_rows {ms_c:.4f} ms per call, {graph_c:.5f} ms per launch on the "
                  f"card [{CARD}]", flush=True)
            # their bounds at these rows: bytes of the rows' inputs and outputs,
            # operations counted by the host row code in parallel chunks
            rdim, C = lk.camera_shape(cfg)
            for kernel, kms, n_out, count in (
                    ("linearize_rows split", ms, rdim * (C + 2), lk.linearize_rows_ops),
                    ("cost_rows", ms_c, rdim, lk.cost_rows_ops)):
                nbytes = 8 * M * (n_inputs(cfg, x) + n_out)
                ops = lk.count_in_chunks(
                    lambda a, b: count(cfg, {k: v[:, a:b].contiguous() for k, v in x.items()}),
                    M)
                b_ms, b_by = bound(nbytes, ops)
                print(f"  config 5 {kernel} f64 M={M}: kernel {kms:.4f} ms, bound "
                      f"{b_ms:.4f} ms by {b_by} ({nbytes} bytes, {ops} operations)",
                      flush=True)
        del got, got_c, x


def phase_b6(problem):
    """B6 against its plain version on config 5's camera rows at state0,
    on a random case and on no rows; times beside ``scatter_add_``."""
    from kontiki_tpu_torch.ops import linearize_kernels as lk
    from kontiki_tpu_torch.parallel.segments_ba import _build_segment_ba

    b = _build_segment_ba(problem, None, "banded")
    _, blocks, _ = b["whitened_blocks"](b["to_sharded"](problem.state0))
    (blk,), (layout,) = blocks, b["layouts"]
    WB = b["WB"]
    rel = b["colrel"](blk, layout)
    Jw = blk["Jw"].contiguous()
    del blocks, blk
    M, rdim, C = Jw.shape
    weight = b["runtime"]["data"][0]["weight"]
    outside = (rel < 0) | (rel >= WB)
    dropped = (outside & (Jw != 0).any(1) & (weight > 0)[:, None]).sum().item()
    print(f"  config 5 rows M={M} rdim={rdim} C={C} WB={WB}: {outside.sum().item()} ids "
          f"outside [0, WB), {dropped} of them non-zero on rows of weight > 0", flush=True)
    if dropped:
        fail(f"onehot_expand_rows: config 5 would drop {dropped} in-range Jacobian entries")
    # random rows: ids drawn from [-1, WB] with each id at most twice per
    # row (as in camera rows), M not a multiple of a block's rows
    dev = Jw.device
    g = torch.Generator(device=dev).manual_seed(6)
    Mr = 100_003
    pool = torch.rand(Mr, 2 * (WB + 2), device=dev, generator=g).argsort(dim=1)[:, :C]
    cases = {"config 5": (Jw, rel),
             "random": (torch.randn(Mr, rdim, C, device=dev, dtype=torch.float64,
                                    generator=g), pool // 2 - 1),
             "no rows": (Jw[:0], rel[:0])}
    out = {}
    for case, (J, r) in cases.items():
        for dtype in (torch.float64, torch.float32):
            x = J.to(dtype)
            before = lk.onehot_expand_rows.launches
            got = lk.onehot_expand_rows(x, r, WB)
            torch.cuda.synchronize()
            if lk.onehot_expand_rows.launches != before + (x.shape[0] > 0):
                fail(f"onehot_expand_rows {case}: launched {lk.onehot_expand_rows.launches - before} times")
            want = lk.onehot_expand_rows_plain(x, r, WB)
            print(f"  onehot_expand_rows {case} M={x.shape[0]} {str(dtype)[6:]}: "
                  f"{'equal' if torch.equal(got, want) else 'NOT equal'} to the plain version",
                  flush=True)
            err = compare("onehot_expand_rows", dtype, ("Jd",), (got,), (want,))
            del got, want
            if case == "config 5" and dtype == torch.float64:
                out["max_abs_err"] = err
    out["ms"] = cuda_ms(lambda: lk.onehot_expand_rows(Jw, rel, WB))
    out["plain_ms"] = cuda_ms(lambda: lk.onehot_expand_rows_plain(Jw, rel, WB), reps=3, warmup=1)
    # the yardstick: scatter_add_ along the columns into a zeroed Jd (the
    # zero fill outside the timing), ids outside [0, WB) masked to a 0 entry
    idx = torch.where(outside, 0, rel)[:, None, :].expand(M, rdim, C).contiguous()
    src = torch.where(outside[:, None, :], 0.0, Jw)
    Jd = torch.zeros(M, rdim, WB, dtype=Jw.dtype, device=Jw.device)
    out["library_ms"] = cuda_ms(lambda: Jd.scatter_add_(2, idx, src))
    del idx, src, Jd
    nbytes = 8 * (Jw.numel() + rel.numel() + M * rdim * WB)
    ops = rdim * int((~outside).sum().item())  # one addition per in-range entry
    out["bound_ms"], out["bound_by"] = bound(nbytes, ops)
    print(f"  onehot_expand_rows f64 M={M}: kernel {out['ms']:.4f} ms, plain "
          f"{out['plain_ms']:.3f} ms, scatter_add_ {out['library_ms']:.4f} ms, bound "
          f"{out['bound_ms']:.4f} ms by {out['bound_by']} ({nbytes} bytes, {ops} operations)",
          flush=True)
    return out


def phase_config5(big):
    """Config 5 through ``parallel.segments_ba`` on the card against the JAX
    package's values; the timed 6-iteration solve, its breakdown and the
    solution's ATE."""
    from kontiki_tpu_torch import interop
    from kontiki_tpu_torch.ops import linearize_kernels as lk
    from kontiki_tpu_torch.parallel.segments_ba import (
        _build_segment_ba,
        make_segment_ba_solver,
        make_segment_ba_step,
    )
    from kontiki_tpu_torch.solver import kernels
    from kontiki_tpu_torch.synthetic import trajectory_ate

    ref = JAX_CONFIG5
    problem = big["problem"]
    s0 = problem.state0
    cost0 = make_segment_ba_solver(problem, max_iterations=0, function_tolerance=0.0)(s0)[1]
    _, total_cost = make_segment_ba_step(problem)
    reset_counts()
    total0 = total_cost(s0).item()
    check_launches("config 5 total_cost", read_counts(),
                   {"cost_rows": 1, "linearize_rows": 0, "onehot_expand_rows": 0})
    cost1 = make_segment_ba_solver(problem, max_iterations=1, function_tolerance=0.0)(s0)[1]
    for what, got, want in (("cost at state0", cost0.item(), ref["cost0"]),
                            ("total_cost at state0", total0, ref["total_cost0"]),
                            ("1-iteration cost", cost1.item(), ref["cost1"])):
        rel = abs(got - want) / want
        print(f"config 5: {what} {got!r} (JAX {want!r}, rel {rel:.2e})", flush=True)
        if not rel <= COST_RTOL:
            fail(f"config 5: {what} differs from the JAX package by {rel:.2e}")

    solve = make_segment_ba_solver(problem, max_iterations=CONFIG5_ITERATIONS,
                                   function_tolerance=0.0)
    t0 = time.perf_counter()
    solve(s0)
    torch.cuda.synchronize()
    print(f"config 5: warm-up solve {time.perf_counter() - t0:.3f} s", flush=True)
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, cost, iters = solve(s0)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    cost = cost.item()
    rel = abs(cost - ref["cost6"]) / ref["cost6"]
    print(f"config 5: {iters} iterations in {seconds:.3f} s = {iters / seconds:.3f} it/s; "
          f"final cost {cost!r} (JAX {ref['cost6']!r} after {ref['iterations6']}, rel "
          f"{rel:.2e}, tol {CONFIG5_FINAL_RTOL:.0e}); peak device memory "
          f"{peak / 2**30:.2f} GiB; launches {launches}", flush=True)
    for k, v in state.items():
        if v.shape != s0[k].shape or not torch.isfinite(v).all():
            fail(f"config 5: final state {k}: bad shape or non-finite values")
    if iters != ref["iterations6"]:
        fail(f"config 5: ran {iters} iterations, the JAX package {ref['iterations6']}")
    if not rel <= CONFIG5_FINAL_RTOL:
        fail(f"config 5: final cost differs from the JAX package's by {rel:.2e}")
    # the speculative loop linearizes state0 and each iteration's candidate
    check_launches("config 5 solve", launches, {
        "linearize_rows split": iters + 1, "onehot_expand_rows": iters + 1,
        "cost_rows": 0, "imu_rows": 0})

    # one iteration by part (host clock, synchronize after each, median of 3)
    b = _build_segment_ba(problem, None, "banded")
    st = b["to_sharded"](s0)
    spec_l, rt = b["spec_local"], b["runtime"]
    cfg, ins, _ = kernels._camera_inputs(spec_l, rt, st, rt["data"][0])
    lam = torch.tensor(1e-4, dtype=problem.dtype, device=problem.device)
    c, blocks, ml = b["whitened_blocks"](st)
    blk, layout = blocks[0], b["layouts"][0]
    rel_ids = b["colrel"](blk, layout)
    Jw = blk["Jw"].contiguous()
    asm = b["assemble_band"](blocks)
    ctx = b["eliminate"](asm, ml, lam, st)
    sol = b["band_solve"](ctx)
    xb, xs = b["sensor_solve"](ctx, sol, lam)
    dc, dl, _, _ = b["back_substitute"](ctx, xb, xs, st)
    nb, d = ctx["Dd"].shape[:2]
    table = [
        ("one iteration (solve from the carried assembly, retract, linearize and assemble "
         "the candidate)", host_ms(lambda: b["step_spec_local"](st, (c, asm, ml), lam), reps=3)),
        ("- linearize (whitened rows)", host_ms(lambda: b["whitened_blocks"](st), reps=3)),
        ("-- camera-row gather", host_ms(
            lambda: kernels._camera_inputs(spec_l, rt, st, rt["data"][0]), reps=3)),
        ("-- B1 split", host_ms(lambda: lk.linearize_rows(cfg, ins), reps=3)),
        ("- band assembly (_colrel + B6 + batched products)",
         host_ms(lambda: b["assemble_band"](blocks), reps=3)),
        ("-- _colrel + B6", host_ms(lambda: b["dense_rows"](blk, layout), reps=3)),
        ("--- B6", host_ms(lambda: lk.onehot_expand_rows(Jw, rel_ids, b["WB"]), reps=3)),
        ("- landmark elimination and fold into the band",
         host_ms(lambda: b["eliminate"](asm, ml, lam, st), reps=3)),
        (f"- block_tridiag_solve ({nb} blocks of {d})", host_ms(lambda: b["band_solve"](ctx),
                                                              reps=3)),
        ("- sensor solve", host_ms(lambda: b["sensor_solve"](ctx, sol, lam), reps=3)),
        ("- landmark back-substitution and pred",
         host_ms(lambda: b["back_substitute"](ctx, xb, xs, st), reps=3)),
        ("- retract", host_ms(lambda: b["retract_local"](st, dc, dl), reps=3)),
    ]
    print("config 5 iteration breakdown (host ms, synchronize after each part, median of 3):",
          flush=True)
    for name, ms in table:
        print(f"  {name}: {ms:.3f} ms", flush=True)
    del b, blocks, asm, ctx, sol, Jw, rel_ids

    # the solution read back through B5 and scored against the truth
    sp_r3, sp_so3 = problem.splines
    solved = interop.split_trajectory_from_numpy(
        state["r3"].cpu().numpy(), state["so3"].cpu().numpy(), sp_r3.dt, sp_so3.dt,
        sp_r3.t0, sp_so3.t0)
    truth, t1, t2 = big["true_trajectory"], big["t1"], big["t2"]
    reset_counts()
    ates = {"ate_start": trajectory_ate(big["trajectory"], truth, t1, t2),
            "ate6": trajectory_ate(solved, truth, t1, t2)}
    check_launches("config 5 scores", read_counts(),
                   {"evaluate_windows r3": 4, "evaluate_windows so3": 4})
    for k, got in ates.items():
        want = ref[k]
        rel = abs(got - want) / want
        print(f"config 5: ATE vs truth on [{t1}, {t2}], {k}: {got!r} (JAX {want!r}, rel "
              f"{rel:.2e}, tol {CONFIG5_ATE_RTOL[k]:.0e})", flush=True)
        if not rel <= CONFIG5_ATE_RTOL[k]:
            fail(f"config 5: {k} differs from the JAX package's by {rel:.2e}")
    return launches


def newton_problem(kwargs):
    """A Newton-row problem built through the entry points on the card."""
    from kontiki_tpu_torch.solver.problem import Problem
    from kontiki_tpu_torch.synthetic import make_rsvi_problem

    prob = make_rsvi_problem(**kwargs)
    problem = Problem(prob["trajectory"], prob["measurements"])
    if problem.device.type != "cuda":
        fail(f"Newton rows: Problem built on {problem.device}, not on the card")
    return prob, problem


def phase_newton_problem():
    """Config 4-Newton through the entry points on the card: its structure
    against the JAX package's (tools/newton_reference.py)."""
    from kontiki_tpu_torch.solver import kernels

    t0 = time.time()
    prob, problem = newton_problem(CONFIG4_NEWTON)
    spec = kernels.problem_spec(problem)
    shape = {b.kind: b.M for b in spec.buckets}
    shape["num_tangent"] = spec.num_tangent
    windows = {b.kind: b.windows for b in spec.buckets}
    Pc = spec.num_tangent - spec.num_landmarks
    print(f"config 4-Newton: {shape}, windows {windows}, splines "
          f"{[(sp.kind, sp.n) for sp in spec.splines]}, Pc {Pc} ({time.time() - t0:.1f} s on "
          f"the host)", flush=True)
    if shape != CONFIG4_NEWTON_SHAPE or windows["rs_newton"] != NEWTON_WINDOWS or Pc != NEWTON_PC:
        fail(f"config 4-Newton structure {shape}, {windows}, Pc {Pc} != "
             f"{CONFIG4_NEWTON_SHAPE}, rs_newton {NEWTON_WINDOWS}, Pc {NEWTON_PC}")
    return prob, problem


def newton_inputs(problem):
    """(cfg, ins) of the problem's Newton bucket at state0, on the card."""
    from kontiki_tpu_torch.solver import kernels

    spec = kernels.problem_spec(problem)
    runtime = kernels.problem_runtime(problem)
    (b,) = [i for i, bs in enumerate(spec.buckets) if bs.kind == "rs_newton"]
    return kernels._newton_inputs(spec, spec.buckets[b], runtime, problem.state0,
                                  runtime["data"][b])[:2]


def with_atan(cfg, ins):
    """{branch: (cfg, ins)}: a Newton bucket's rows on the pinhole and on
    the atan camera (its wc and gamma added to the same rows)."""
    from kontiki_tpu_torch.ops import linearize_kernels as lk
    from kontiki_tpu_torch.synthetic import make_camera

    atan = make_camera("atan")
    M = ins["u_ref"].shape[1]
    opts = dict(dtype=ins["u_ref"].dtype, device=ins["u_ref"].device)
    out = {}
    for camera in ("PinholeCamera", "AtanCamera"):
        c = dict(cfg, camera=camera)
        x = dict(ins)
        if camera == "AtanCamera":
            x["wc"] = torch.tensor(atan.wc, **opts)[:, None].expand(2, M).contiguous()
            x["gamma"] = torch.full((1, M), atan.gamma, **opts)
        out[lk.newton_branch(c)] = (c, x)
    return out


def newton_branches(problem4n):
    """(cfg, ins) on the card of B8's four branches: split on config
    4-Newton's rows, SE3 on NEWTON_SE3's; the atan branches with the atan
    camera's wc and gamma added to the same rows."""
    t0 = time.time()
    _, se3 = newton_problem(NEWTON_SE3)
    print(f"Newton SE3 rows ({NEWTON_SE3['nviews']} views): {time.time() - t0:.1f} s on the host",
          flush=True)
    out = {}
    for cfg, ins in (newton_inputs(problem4n), newton_inputs(se3)):
        out.update(with_atan(cfg, ins))
    return out


def newton_w10_branches():
    """(cfg, ins) on the card of B8's four branches on 10-knot windows
    (NEWTON_W10 on each trajectory), the rows at the edges of the Newton
    path moved there (synthetic.newton_edge_rows)."""
    from kontiki_tpu_torch.synthetic import newton_edge_rows

    out = {}
    for trajectory in ("split", "se3"):
        _, problem = newton_problem(dict(NEWTON_W10, trajectory=trajectory))
        cfg, ins = newton_inputs(problem)
        if max(cfg["Ws"]) != 10:
            fail(f"Newton rows on knots {NEWTON_W10['knot_dt']:.5f} s apart: windows "
                 f"{cfg['Ws']}, not 10 knots")
        out.update(with_atan(cfg, newton_edge_rows(ins)))
    return out


def newton_bound(cfg, x, cost_only, ops):
    """B8's bound: each input read once and each output written once, and
    ``ops`` float64 operations."""
    from kontiki_tpu_torch.ops import linearize_kernels as lk

    M = x["u_ref"].shape[1]
    n_in = sum(slot[1] for slot in lk.newton_inputs(cfg) if slot is not None and slot[0] in x)
    n_out = 2 if cost_only else 2 * (lk.newton_shape(cfg)[1] + 2)
    nbytes = 8 * M * (n_in + n_out)
    return nbytes, bound(nbytes, ops)


def phase_b8(branches):
    """B8 linearize and cost-only on each branch against the plain version
    (f64, f32), the cost-only residual against the linearize form's; the
    Newton steps the rows take (the host row code's f64 primal path); on
    the main branch (split pinhole, config 4-Newton's rows) the times per
    call and per launch, the plain version's and the bound."""
    from kontiki_tpu_torch.ops import linearize_kernels as lk

    out = {}
    for branch, (cfg, ins) in branches.items():
        M = ins["u_ref"].shape[1]
        print(f"  B8 branch {branch}: M={M}, windows {cfg['Ws']}, C {lk.newton_shape(cfg)[1]}",
              flush=True)
        for dtype in (torch.float64, torch.float32):
            x = {k: v.to(dtype).contiguous() for k, v in ins.items()}
            got = lk.newton_rows(cfg, x)
            r = lk.newton_rows(cfg, x, cost_only=True)
            torch.cuda.synchronize()
            err = compare("newton_rows", dtype, ("r", "J", "J_rho"), got,
                          lk.newton_rows_plain(cfg, x))
            err_c = compare("newton_rows cost-only", dtype, ("r",), (r,),
                            (lk.newton_rows_plain(cfg, x, cost_only=True),))
            if dtype != torch.float64:
                continue
            compare("newton_rows cost-only vs linearize", dtype, ("r",), (r,), (got[0],))
            host = {k: v.cpu() for k, v in x.items()}
            _, steps, margin = lk.newton_rows_host(cfg, host, cost_only=True, steps=True)
            hist = torch.bincount(steps.long(), minlength=6)[1:].tolist()
            print(f"  B8 {branch}: rows by Newton steps 1..5 {hist}, smallest convergence-test "
                  f"margin {margin.min().item():.3e}, rows within 1e-6 of it "
                  f"{int((margin < 1e-6).sum())}", flush=True)
            if branch != "split pinhole":
                continue
            for form, cost_only, e in (("linearize", False, err), ("cost-only", True, err_c)):
                rec = dict(max_abs_err=e,
                           ms=cuda_ms(lambda: lk.newton_rows(cfg, x, cost_only=cost_only)),
                           graph_ms=graph_ms(lambda: lk.newton_rows(cfg, x, cost_only=cost_only),
                                             n=20),
                           plain_ms=cuda_ms(lambda: lk.newton_rows_plain(cfg, x,
                                                                         cost_only=cost_only),
                                            reps=3, warmup=1))
                ops = lk.newton_rows_ops(cfg, host, cost_only=cost_only)
                if not cost_only:
                    # the function needs no more than its cheapest known
                    # schedule: the one-jet count's or the kernel's own
                    rec["function_ops"] = ops
                    rec["schedule_ops"] = lk.newton_rows_ops(cfg, host, schedule=True)
                    ops = min(ops, rec["schedule_ops"])
                nbytes, (rec["bound_ms"], rec["bound_by"]) = newton_bound(cfg, x, cost_only, ops)
                rec["library_ms"] = None  # no single PyTorch call computes B8
                rec["steps"] = hist
                out[form] = rec
                print(f"  newton_rows ({form}) {branch} f64 M={M}: kernel {rec['graph_ms']:.4f} "
                      f"ms per launch on the card ({rec['ms']:.4f} ms per call with the host's "
                      f"enqueue), plain {rec['plain_ms']:.3f} ms, bound {rec['bound_ms']:.5f} ms "
                      f"by {rec['bound_by']} ({nbytes} bytes, {ops} operations) [{CARD}]",
                      flush=True)
                if not cost_only:
                    rec["wave"] = lk.newton_rows_wave(cfg)
                    print(f"  newton_rows (linearize) {branch}: operations by one jet a stage "
                          f"{rec['function_ops']}, by the kernel's own schedule "
                          f"{rec['schedule_ops']} (the bound counts the smaller); one wave "
                          f"{rec['wave']} rows", flush=True)
    return out


def b8_edge_check(what, cfg, x, dtype):
    """B8 linearize and cost-only on ``x`` (every third row at valid = 0)
    against the plain version: the invalid rows exactly zero."""
    from kontiki_tpu_torch.ops import linearize_kernels as lk

    M = x["u_ref"].shape[1]
    valid = (torch.arange(M, device=x["u_ref"].device) % 3 != 1).to(dtype)
    x = dict({k: v.to(dtype).contiguous() for k, v in x.items()}, valid=valid[None].contiguous())
    got = lk.newton_rows(cfg, x)
    r = lk.newton_rows(cfg, x, cost_only=True)
    torch.cuda.synchronize()
    print(f"  B8 edge {what} {str(dtype)[6:]}", flush=True)
    compare("newton_rows", dtype, ("r", "J", "J_rho"), got, lk.newton_rows_plain(cfg, x))
    compare("newton_rows cost-only", dtype, ("r",), (r,),
            (lk.newton_rows_plain(cfg, x, cost_only=True),))
    off = valid == 0
    if any(bool(a[off].abs().max() > 0) for a in (*got, r) if off.any()):
        fail(f"newton_rows {what} {dtype}: rows with valid = 0 are not zero")


def phase_b8_edges(cfg, ins, w10):
    """B8 on the first M rows of config 4-Newton's, for M in NEWTON_EDGES
    and one wave of the linearize kernel less and plus one row, with its
    first rows at the edges of the Newton path (synthetic.newton_edge_rows:
    every update clamped at 0 or at the readout, five steps), and on each
    branch's rows on 10-knot windows (``w10``, newton_w10_branches: steps
    that cross knots too), every third row at valid = 0, against the plain
    version (f64, f32): the invalid rows exactly zero. Prints the rows'
    Newton paths (the host row code's primal stage)."""
    from kontiki_tpu_torch.ops import linearize_kernels as lk
    from kontiki_tpu_torch.synthetic import newton_edge_rows

    ins = newton_edge_rows(ins)
    wave = {dt: lk.newton_rows_wave(cfg, dt) for dt in (torch.float64, torch.float32)}
    print(f"  B8 linearize kernel: one wave {wave[torch.float64]} rows in f64, "
          f"{wave[torch.float32]} in f32; {lk.newton_rows_smem(cfg)[0]} bytes of shared "
          f"memory a block of {NEWTON_WINDOWS}-knot windows", flush=True)
    for dtype in (torch.float64, torch.float32):
        for M in (*NEWTON_EDGES, wave[dtype] - 1, wave[dtype], wave[dtype] + 1):
            b8_edge_check(f"M={M}", cfg, {k: v[:, :M] for k, v in ins.items()}, dtype)
    for branch, (c, x) in w10.items():
        paths = lk.newton_rows_paths(c, {k: v.cpu() for k, v in x.items()})
        steps, low, high, moved = paths.T
        print(f"  B8 {branch} windows {c['Ws']}: M={x['u_ref'].shape[1]}, rows by Newton steps "
              f"1..5 {torch.bincount(steps.long(), minlength=6)[1:].tolist()}, updates clamped "
              f"at 0 / readout {int(low.sum())} / {int(high.sum())}, steps onto another "
              f"sub-window {int(moved.sum())}; {lk.newton_rows_smem(c)[0]} bytes of shared "
              f"memory a block", flush=True)
        if not (low.sum() > 0 and high.sum() > 0 and moved.sum() > 0 and (steps == 5).any()):
            fail(f"newton_rows {branch} W=10: the edge rows miss a clamp, a knot or step 5")
        for dtype in (torch.float64, torch.float32):
            b8_edge_check(f"{branch} W={max(c['Ws'])}", c, x, dtype)


def newton_launches(n_lin, n_cost, buckets):
    """Main-path launches of ``n_lin`` Newton-bucket linearizations (B8,
    and B4 and B2 on the IMU buckets and B2 on all) and ``n_cost`` re-costs."""
    return {"newton_rows": n_lin + n_cost, "newton_rows cost-only": n_cost,
            "newton_rows split pinhole": n_lin,
            "newton_rows split pinhole cost-only": n_cost,
            "imu_rows": 2 * (n_lin + n_cost), "imu_rows cost-only": 2 * n_cost,
            "assemble_schur_blocks": buckets * n_lin, B2_NEWTON: n_lin,
            "linearize_rows": 0, "cost_rows": 0}


def phase_newton_solve(problem):
    """Config 4-Newton through make_fused_solver(strategy="schur"): the
    initial and 1-iteration costs against the JAX package's, an untimed
    warm-up, the timed 25-iteration solve with exact launches, its
    final/initial cost and iterations per second."""
    from kontiki_tpu_torch.solver import kernels
    from kontiki_tpu_torch.solver.lm import make_fused_solver
    from kontiki_tpu_torch.solver.schur import build_schur_parts

    name = "config 4-Newton"
    spec = kernels.problem_spec(problem)
    runtime = kernels.problem_runtime(problem)
    cost0 = build_schur_parts(spec)["linearize"](runtime, problem.state0)[0].item()
    _, cost1, _ = make_fused_solver(problem, 1, function_tolerance=0.0,
                                    strategy="schur")(problem.state0)
    for what, got, key in (("initial", cost0, "cost0"), ("1-iteration", cost1.item(), "cost1")):
        want = JAX_NEWTON[key]
        rel = abs(got - want) / want
        print(f"{name}: {what} cost {got!r} (JAX {want!r}, rel {rel:.2e}, tol "
              f"{COST_RTOL:.0e})", flush=True)
        if not rel <= COST_RTOL:
            fail(f"{name}: {what} cost differs from the JAX package by {rel:.2e}")
    solve = make_fused_solver(problem, 25, function_tolerance=0.0, strategy="schur")
    t0 = time.perf_counter()
    solve(problem.state0)
    torch.cuda.synchronize()
    print(f"{name}: warm-up solve {time.perf_counter() - t0:.3f} s", flush=True)
    reset_counts()
    t0 = time.perf_counter()
    state, cost, iters = solve(problem.state0)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_counts()
    cost = cost.item()
    ratio = cost / cost0
    print(f"{name}: {iters} iterations in {seconds:.3f} s = {iters / seconds:.2f} it/s; initial "
          f"cost {cost0:.6e} final cost {cost!r} (JAX {JAX_NEWTON['cost25']!r}) ratio "
          f"{ratio:.3e} (gate {FINAL_RATIO:.0e}); launches {launches}", flush=True)
    for k, v in state.items():
        if v.shape != problem.state0[k].shape or not torch.isfinite(v).all():
            fail(f"{name}: final state {k}: bad shape or non-finite values")
    if not (math.isfinite(ratio) and ratio <= FINAL_RATIO):
        fail(f"{name}: final/initial cost {ratio:.3e} > {FINAL_RATIO:.0e}")
    if iters != 25:
        fail(f"{name}: ran {iters} iterations, expected 25")
    want = newton_launches(iters + 1, 0, len(spec.buckets))
    check_launches(name, launches, want)
    return dict(it_per_s=iters / seconds)


def phase_newton_estimator(prob):
    """``TrajectoryEstimator`` on config 4-Newton's measurement objects (on
    the card by default, 'auto' -> Schur): the Summary against the JAX
    package's, exact launches, the written-back objects, the per-phase
    times and the solution's ATE through B5."""
    from kontiki_tpu_torch import TrajectoryEstimator
    from kontiki_tpu_torch.solver import kernels
    from kontiki_tpu_torch.solver.lm import _resolve_strategy
    from kontiki_tpu_torch.solver.lm import solve as lm_solve
    from kontiki_tpu_torch.solver.problem import Problem
    from kontiki_tpu_torch.synthetic import trajectory_ate

    name = "config 4-Newton"
    ref = JAX_NEWTON["estimator"]
    truth, span = prob["true_trajectory"], (0.5, 0.5 + 63 / 30)
    ate_start = trajectory_ate(prob["trajectory"], truth, *span)
    estimator = TrajectoryEstimator(prob["trajectory"])
    for m in prob["measurements"]:
        estimator.add_measurement(m)
    problem = Problem(prob["trajectory"], prob["measurements"])
    if _resolve_strategy(problem, "auto") != "schur":
        fail(f"{name} estimator: 'auto' does not choose the Schur strategy")
    t0 = time.perf_counter()
    lm_solve(problem, max_iterations=1)
    torch.cuda.synchronize()
    print(f"{name} estimator: warm-up solve {time.perf_counter() - t0:.3f} s", flush=True)
    reset_counts()
    t0 = time.perf_counter()
    summary = estimator.solve(max_iterations=10, progress=False, function_tolerance=0.0)
    seconds = time.perf_counter() - t0
    launches = read_counts()
    n = len(summary.iterations) - 1
    print(f"{name} estimator: {summary.BriefReport()}; {n} iterations in {seconds:.3f} s "
          f"(with problem build and write-back); launches {launches}", flush=True)
    times = (("jacobian", summary.jacobian_evaluation_time_in_seconds),
             ("linear solver", summary.linear_solver_time_in_seconds),
             ("residual", summary.residual_evaluation_time_in_seconds))
    print(f"{name} estimator per-phase times per iteration: "
          + ", ".join(f"{k} {1e3 * v / max(n, 1):.3f} ms" for k, v in times), flush=True)
    for what, got, key in (("initial", summary.initial_cost, "cost0"),
                           ("iteration-1", summary.iterations[1].cost, "cost1")):
        rel = abs(got - ref[key]) / ref[key]
        print(f"{name} estimator: {what} cost {got!r} (JAX {ref[key]!r}, rel {rel:.2e}, tol "
              f"{COST_RTOL:.0e})", flush=True)
        if not rel <= COST_RTOL:
            fail(f"{name} estimator: {what} cost differs from the JAX package by {rel:.2e}")
    print(f"{name} estimator: final cost {summary.final_cost!r} (JAX {ref['final']!r})",
          flush=True)
    counts = tuple(getattr(summary, k) for k in ATAN_SUMMARY_COUNTS)
    steps = (summary.num_successful_steps, summary.num_unsuccessful_steps)
    print(f"{name} estimator: counts {counts}, steps {steps} (JAX {ref['counts']}, "
          f"{ref['steps']})", flush=True)
    if counts != tuple(ref["counts"]) or steps != tuple(ref["steps"]):
        fail(f"{name} estimator: Summary counts or steps differ from the JAX package's")
    check_launches(f"{name} estimator", launches,
                   newton_launches(n, n, len(kernels.problem_spec(problem).buckets)))
    problem = Problem(prob["trajectory"], prob["measurements"])
    spec = kernels.problem_spec(problem)
    written = kernels.total_cost(spec, kernels.problem_runtime(problem), problem.state0).item()
    if not abs(written - summary.final_cost) <= 1e-9 * summary.initial_cost:
        fail(f"{name} estimator: the written-back objects do not hold the final state "
             f"({written!r} vs {summary.final_cost!r})")
    reset_counts()
    ate = trajectory_ate(prob["trajectory"], truth, *span)
    check_launches(f"{name} ATE", read_counts(),
                   {"evaluate_windows r3": 2, "evaluate_windows so3": 2})
    for what, got, key in (("start", ate_start, "ate_start"), ("solution", ate, "ate")):
        rel = abs(got - ref[key]) / ref[key]
        print(f"{name}: ATE vs truth on {span}, {what}: {got!r} (JAX {ref[key]!r}, rel "
              f"{rel:.2e})", flush=True)
        if not rel <= 1e-6:
            fail(f"{name}: {what} ATE differs from the JAX package's by {rel:.2e}")
    return dict(times, iterations=n)


# ---------------------------------------------------------------------------
# the solver family on one device: iterative Schur, banded, the PCR band
# solve, segment BA's PCG mode and its Newton rows
# ---------------------------------------------------------------------------

# The JAX package's float64 values on the CPU (tools/solvers_reference.py):
# the final costs of make_fused_solver(problem, n, function_tolerance=0.0,
# strategy="iterative_schur") for n = 1 and 5 (its default cg_tol 1e-10,
# cg_maxiter 500).
JAX_ITERATIVE = {
    "config 4": dict(cost1=1.529560428892923, cost5=8.190725375699584e-06),
    "config 3-atan-lifting": dict(cost1=1324749.7362606898, cost5=1229865.1119934404),
}
ITERATIVE_ITERATIONS = 5
ITERATIVE_RTOL = 1e-6
# The 1-iteration cost is gated with CG run to convergence: at the default
# cg_tol (1e-10) CG's truncation, and the order in which the card's
# atomic index_add_ sums, move config 4's 1-iteration cost by up to a few
# 1e-7 between runs (7.0e-8 and 4.1e-7 from the JAX package's in two
# calls), where the JAX package's own value sits 5.3e-8 from its Schur
# path's. The default-tolerance value is printed beside it.
ITERATIVE_CONVERGED_CG = dict(cg_tol=1e-14, cg_maxiter=2000)
# The 10,050-knot SO3 gyro band (synthetic.make_gyro_band_problem, the JAX
# package's tests/test_banded.py problem): num_tangent, and the cost, new
# cost and predicted decrease of one make_banded_step step at lam = 1e-2.
JAX_GYRO_BAND = dict(num_tangent=30163, cost0=7.794021089826632,
                     new_cost=0.001901764355493234, pred=7.792123069394589)
GYRO_BAND_RTOL = 1e-8
GYRO_BAND_ITERATIONS = 10
# Config 5 in PCG mode: the final costs of make_segment_ba_solver(problem,
# mesh of 1, max_iterations=n, function_tolerance=0.0, mode="pcg") (its
# default cg_tol 1e-6, cg_maxiter 200) for n = 1 and 6. They are printed
# beside the port's, not gated: CG stops at its 200-iteration cap in every
# LM iteration (the residual stays above 1e-6), where its iterate depends
# on roundoff (the phase measures how much: the same solve with its
# right-hand side changed by 1e-15 relative). What is gated is the PCG
# path's step with a converged CG against the banded (exact) step, and one
# step with CG cut after 5 iterations (make_segment_ba_step(problem, mesh,
# mode="pcg", cg_tol=1e-14, cg_maxiter=5) at lam = 1e-4: ``cut``), where
# the step depends on the preconditioner and not yet on roundoff, against
# the JAX package's (tools/solvers_reference.py --only config5cut).
JAX_CONFIG5_PCG = dict(cost1=372.74140414906356, cost6=0.00870018668800289, iterations6=6,
                       cut=dict(cost=784576.9477794562, new_cost=34003.32338489117,
                                pred=757100.4885196856, gmax=313507.9930911808))
# the converged PCG step against the banded step: new cost and pred
CONFIG5_PCG_CONVERGED_RTOL = 1e-8
# the cut-CG step against the JAX package's: cost, new cost, pred, max |g|
CONFIG5_PCG_CUT = dict(cg_tol=1e-14, cg_maxiter=5)
CONFIG5_PCG_CUT_RTOL = 1e-10
# The banded strategy's 1-iteration cost against the dense strategy's, and
# the band solves (scan, PCR, dense LU of the expanded system) against each
# other, normwise relative.
BANDED_VS_DENSE_RTOL = 1e-9
BAND_SOLVE_RTOL = 1e-10
# Newton rows in segment BA against the port's iterative and Schur steps
NEWTON_SBA_RTOL = 1e-6


def phase_iterative(name, problem):
    """``make_fused_solver(problem, n, strategy="iterative_schur")``: the
    1-iteration cost (CG converged) against the JAX package's and the
    port's Schur path, an untimed warm-up, then the timed 5-iteration solve
    (its cost against the JAX package's, CG iterations per solve, exact
    launches: B1 on the linearizations, no B2, no B3)."""
    from kontiki_tpu_torch.solver import iterative, kernels
    from kontiki_tpu_torch.solver.lm import make_fused_solver

    ref = JAX_ITERATIVE[name]
    s0 = problem.state0
    schur1 = make_fused_solver(problem, 1, function_tolerance=0.0, strategy="schur")(s0)[1]
    it1 = make_fused_solver(problem, 1, function_tolerance=0.0,
                            strategy="iterative_schur")(s0)[1].item()
    print(f"{name} iterative Schur: 1-iteration cost at the default cg_tol {it1!r} (JAX "
          f"{ref['cost1']!r}, rel {abs(it1 - ref['cost1']) / ref['cost1']:.2e})", flush=True)
    it1 = make_fused_solver(problem, 1, function_tolerance=0.0, strategy="iterative_schur",
                            **ITERATIVE_CONVERGED_CG)(s0)[1].item()
    for what, want in (("JAX iterative Schur", ref["cost1"]), ("port Schur", schur1.item())):
        rel = abs(it1 - want) / want
        print(f"{name} iterative Schur: 1-iteration cost, CG converged, {it1!r} ({what} "
              f"{want!r}, rel {rel:.2e}, tol {ITERATIVE_RTOL:.0e})", flush=True)
        if not rel <= ITERATIVE_RTOL:
            fail(f"{name} iterative Schur: 1-iteration cost differs from the {what} by {rel:.2e}")
    solve = make_fused_solver(problem, ITERATIVE_ITERATIONS, function_tolerance=0.0,
                              strategy="iterative_schur")
    t0 = time.perf_counter()
    solve(s0)
    torch.cuda.synchronize()
    print(f"{name} iterative Schur: warm-up solve {time.perf_counter() - t0:.3f} s", flush=True)
    ks = []
    pcg = iterative.pcg

    def counted(*args, **kw):
        x, k = pcg(*args, **kw)
        ks.append(k)
        return x, k

    iterative.pcg = counted
    try:
        reset_counts()
        t0 = time.perf_counter()
        state, cost, iters = solve(s0)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = read_counts()
    finally:
        iterative.pcg = pcg
    cg = [int(k) for k in ks]
    cost = cost.item()
    rel = abs(cost - ref["cost5"]) / ref["cost5"]
    print(f"{name} iterative Schur: {iters} iterations in {seconds:.3f} s = "
          f"{iters / seconds:.2f} it/s; CG iterations per solve {cg}; final cost {cost!r} "
          f"(JAX {ref['cost5']!r}, rel {rel:.2e}, tol {ITERATIVE_RTOL:.0e}); launches "
          f"{launches}", flush=True)
    for k, v in state.items():
        if v.shape != s0[k].shape or not torch.isfinite(v).all():
            fail(f"{name} iterative Schur: final state {k}: bad shape or non-finite values")
    if iters != ITERATIVE_ITERATIONS or len(cg) != iters:
        fail(f"{name} iterative Schur: ran {iters} iterations ({len(cg)} CG solves)")
    if not rel <= ITERATIVE_RTOL:
        fail(f"{name} iterative Schur: final cost differs from the JAX package's by {rel:.2e}")
    spec = kernels.problem_spec(problem)
    branch = ("linearize_rows se3 pinhole static" if spec.splines[0].kind == "se3"
              else "linearize_rows split atan lifting")
    # the speculative loop linearizes state0 and each candidate; nothing is
    # assembled and nothing re-costs
    check_launches(f"{name} iterative Schur", launches, {
        branch: iters + 1, "linearize_rows": iters + 1, "assemble_schur_blocks": 0,
        "cost_rows": 0, "imu_rows": 0})
    return dict(it_per_s=iters / seconds, cg=cg)


def phase_lifting_strategies(name, prob):
    """The estimator's phase-split ``lm.solve`` (10 iterations) on config
    3-atan-lifting's objects under ``schur`` and ``iterative_schur``: the
    same initial cost, the iteration-1 costs within 1e-6, and each
    strategy's per-phase times per iteration."""
    from kontiki_tpu_torch.solver.lm import solve as lm_solve
    from kontiki_tpu_torch.solver.problem import Problem

    out = {}
    for strategy in ("schur", "iterative_schur"):
        problem = Problem(prob["trajectory"], prob["measurements"])
        lm_solve(problem, max_iterations=1, strategy=strategy)
        torch.cuda.synchronize()
        _, summary = lm_solve(problem, max_iterations=10, function_tolerance=0.0,
                              strategy=strategy)
        n = len(summary.iterations) - 1
        times = {k: 1e3 * v / max(n, 1) for k, v in (
            ("jacobian", summary.jacobian_evaluation_time_in_seconds),
            ("linear solver", summary.linear_solver_time_in_seconds),
            ("residual", summary.residual_evaluation_time_in_seconds))}
        print(f"{name} lm.solve, strategy {strategy}: {summary.BriefReport()}; per iteration "
              + ", ".join(f"{k} {v:.3f} ms" for k, v in times.items()), flush=True)
        out[strategy] = (summary, times)
    (a, _), (b, _) = out["schur"], out["iterative_schur"]
    rel0 = abs(a.initial_cost - b.initial_cost) / a.initial_cost
    rel1 = abs(a.iterations[1].cost - b.iterations[1].cost) / a.iterations[1].cost
    print(f"{name} lm.solve: iterative Schur against Schur, initial cost rel {rel0:.2e}, "
          f"iteration-1 cost rel {rel1:.2e} (tol {ITERATIVE_RTOL:.0e})", flush=True)
    if not (rel0 <= 1e-12 and rel1 <= ITERATIVE_RTOL):
        fail(f"{name} lm.solve: the iterative-Schur costs differ from the Schur strategy's")
    return {k: v[1] for k, v in out.items()}


def phase_banded_imu(name, problem):
    """``make_fused_solver(problem, n, strategy="banded")`` on configs 1 and
    2: the initial and 1-iteration costs against the JAX package's dense
    values and the 1-iteration cost against the port's dense strategy's
    (1e-9), an untimed warm-up, the timed 25-iteration solve (final/initial
    under the dense path's gate, exact B4 launches: one linearization a
    bucket per iteration and for state0, no re-cost)."""
    from kontiki_tpu_torch.solver import kernels
    from kontiki_tpu_torch.solver.banded import build_banded_parts
    from kontiki_tpu_torch.solver.lm import make_fused_solver

    cfg = IMU_CONFIGS[name]
    s0 = problem.state0
    spec = kernels.problem_spec(problem)
    cost0 = build_banded_parts(spec)["linearize"](kernels.problem_runtime(problem), s0)[0].item()
    dense1 = make_fused_solver(problem, 1, function_tolerance=0.0, strategy="dense")(s0)[1].item()
    band1 = make_fused_solver(problem, 1, function_tolerance=0.0,
                              strategy="banded")(s0)[1].item()
    for what, got, want, tol in (("initial", cost0, cfg["cost0"], COST_RTOL),
                                 ("1-iteration", band1, cfg["cost1"], COST_RTOL),
                                 ("1-iteration vs the port's dense", band1, dense1,
                                  BANDED_VS_DENSE_RTOL)):
        rel = abs(got - want) / want
        print(f"{name} banded: {what} cost {got!r} ({want!r}, rel {rel:.2e}, tol {tol:.0e})",
              flush=True)
        if not rel <= tol:
            fail(f"{name} banded: {what} cost differs by {rel:.2e}")
    solve = make_fused_solver(problem, 25, function_tolerance=0.0, strategy="banded")
    t0 = time.perf_counter()
    solve(s0)
    torch.cuda.synchronize()
    print(f"{name} banded: warm-up solve {time.perf_counter() - t0:.3f} s", flush=True)
    reset_counts()
    t0 = time.perf_counter()
    state, cost, iters = solve(s0)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_counts()
    ratio = cost.item() / cost0
    print(f"{name} banded: {iters} iterations in {seconds:.4f} s = {iters / seconds:.2f} it/s; "
          f"final cost {cost.item():.6e} ratio {ratio:.3e} (gate {cfg['final_ratio']:.0e}); "
          f"launches {launches}", flush=True)
    for k, v in state.items():
        if v.shape != s0[k].shape or not torch.isfinite(v).all():
            fail(f"{name} banded: final state {k}: bad shape or non-finite values")
    if iters != 25 or not (math.isfinite(ratio) and ratio <= cfg["final_ratio"]):
        fail(f"{name} banded: {iters} iterations, final/initial cost {ratio:.3e}")
    nb = len(spec.buckets)
    check_launches(f"{name} banded", launches, {"imu_rows": (iters + 1) * nb,
                                                "imu_rows cost-only": 0})
    return dict(it_per_s=iters / seconds)


def gyro_band_problem():
    """The 10,050-knot SO3 gyro band through the entry point, on the card."""
    from kontiki_tpu_torch.synthetic import make_gyro_band_problem

    t0 = time.time()
    problem = make_gyro_band_problem()
    if problem.device.type != "cuda":
        fail(f"gyro band: RawProblem built on {problem.device}, not on the card")
    print(f"gyro band: {problem.splines[0].n} knots, {problem.buckets['gyro'].M} gyro rows, "
          f"num_tangent {problem.num_tangent} ({time.time() - t0:.1f} s on the host)",
          flush=True)
    if problem.num_tangent != JAX_GYRO_BAND["num_tangent"]:
        fail(f"gyro band: num_tangent {problem.num_tangent} != {JAX_GYRO_BAND['num_tangent']}")
    return problem


def phase_gyro_band(problem):
    """One ``make_banded_step`` step of the 10,050-knot band against the
    JAX package's (1e-8; it must lower the cost; exact B4 launches), then a
    timed 10-iteration fused banded solve with its peak device memory."""
    from kontiki_tpu_torch.solver.banded import make_banded_step
    from kontiki_tpu_torch.solver.lm import make_fused_solver

    s0 = problem.state0
    step, _ = make_banded_step(problem)
    step(s0, 1e-2)
    reset_counts()
    c0, _, nc, pred, delta, _ = step(s0, 1e-2)
    torch.cuda.synchronize()
    check_launches("gyro band step", read_counts(), {"imu_rows": 2, "imu_rows cost-only": 1})
    for what, got, key in (("cost", c0, "cost0"), ("new cost", nc, "new_cost"),
                           ("pred", pred, "pred")):
        got, want = got.item(), JAX_GYRO_BAND[key]
        rel = abs(got - want) / abs(want)
        print(f"gyro band step: {what} {got!r} (JAX {want!r}, rel {rel:.2e}, tol "
              f"{GYRO_BAND_RTOL:.0e})", flush=True)
        if not rel <= GYRO_BAND_RTOL:
            fail(f"gyro band step: {what} differs from the JAX package's by {rel:.2e}")
    if not (nc.item() < c0.item() and torch.isfinite(delta).all()):
        fail("gyro band step: the step does not lower the cost")
    solve = make_fused_solver(problem, GYRO_BAND_ITERATIONS, function_tolerance=0.0,
                              strategy="banded")
    t0 = time.perf_counter()
    solve(s0)
    torch.cuda.synchronize()
    print(f"gyro band: warm-up solve {time.perf_counter() - t0:.3f} s", flush=True)
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, cost, iters = solve(s0)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    print(f"gyro band: {iters} iterations in {seconds:.3f} s = {iters / seconds:.3f} it/s; "
          f"cost {c0.item():.6e} -> {cost.item():.6e}; peak device memory "
          f"{peak / 2**30:.3f} GiB; launches {launches}", flush=True)
    if iters != GYRO_BAND_ITERATIONS or not cost.item() < c0.item():
        fail(f"gyro band: {iters} iterations, final cost {cost.item()!r}")
    check_launches("gyro band solve", launches, {"imu_rows": iters + 1,
                                                 "imu_rows cost-only": 0})
    return dict(it_per_s=iters / seconds, peak_gib=peak / 2**30)


def dense_band(D, U):
    """The symmetric block-tridiagonal matrix of ``(D, U)`` as a dense
    ``[nb d, nb d]`` tensor."""
    nb, d, _ = D.shape
    T = torch.zeros(nb, d, nb, d, dtype=D.dtype, device=D.device)
    k = torch.arange(nb, device=D.device)
    T[k, :, k, :] = D
    T[k[:-1], :, k[1:], :] = U[:-1]
    T[k[1:], :, k[:-1], :] = U[:-1].transpose(1, 2)
    return T.reshape(nb * d, nb * d)


def band_systems(big, band_problem):
    """The damped bands the main paths solve: config 5's at ``state0`` and
    lam = 1e-4 (its first iteration's, landmarks eliminated, the sensor
    border as right-hand sides) and the gyro band's at lam = 1e-2."""
    from kontiki_tpu_torch.parallel.segments_ba import _build_segment_ba
    from kontiki_tpu_torch.solver import kernels
    from kontiki_tpu_torch.solver.banded import build_banded_parts

    problem = big["problem"]
    b = _build_segment_ba(problem, None, "banded")
    st = b["to_sharded"](problem.state0)
    _, blocks, ml = b["whitened_blocks"](st)
    ctx = b["eliminate"](b["assemble_band"](blocks), ml, 1e-4, st)
    parts = build_banded_parts(kernels.problem_spec(band_problem))
    rt = kernels.problem_runtime(band_problem)
    _, bl = parts["linearize"](rt, band_problem.state0)
    g = parts["grad_and_diag"](bl)[0]
    D, U, rhs, _ = parts["damped_system"](rt, bl, g, 1e-2)
    return {"config 5": (ctx["Dd"], ctx["Uband"], ctx["rhs"]), "gyro band": (D, U, rhs)}


def phase_band_solve(systems):
    """Scan and PCR on each damped band against each other and against a
    dense LU solve of the expanded system (normwise relative), with each
    method's median CUDA-event time."""
    from kontiki_tpu_torch.solver.banded import _scan_solve, block_tridiag_solve

    solves = {"scan": _scan_solve, "pcr": block_tridiag_solve}
    out = {}
    for name, (D, U, rhs) in systems.items():
        nb, d, _ = D.shape
        R = rhs.shape[-1]
        sols = {m: f(D, U, rhs) for m, f in solves.items()}
        sols["dense"] = torch.linalg.solve(dense_band(D, U),
                                           rhs.reshape(nb * d, R)).reshape(nb, d, R)
        for a, b in (("scan", "dense"), ("pcr", "dense"), ("pcr", "scan")):
            rel = (torch.linalg.vector_norm(sols[a] - sols[b])
                   / torch.linalg.vector_norm(sols[b])).item()
            print(f"band solve {name} (nb {nb}, d {d}, R {R}): {a} vs {b} normwise rel "
                  f"{rel:.3e} (tol {BAND_SOLVE_RTOL:.0e})", flush=True)
            if not rel <= BAND_SOLVE_RTOL:
                fail(f"band solve {name}: {a} and {b} differ by {rel:.3e}")
        del sols
        times = {"scan": cuda_ms(lambda: _scan_solve(D, U, rhs), reps=5, warmup=1),
                 "pcr": cuda_ms(lambda: block_tridiag_solve(D, U, rhs))}
        print(f"band solve {name} (nb {nb}, d {d}, R {R}): scan {times['scan']:.3f} ms, pcr "
              f"{times['pcr']:.3f} ms ({CARD})", flush=True)
        out[name] = times
    return out


def phase_config5_methods(big):
    """Config 5's banded solve with its band solve (PCR) and with the scan
    reference patched in: the 1-iteration costs within 1e-10 of each
    other, the 6-iteration costs within config 5's 1e-4, and each one's
    iterations per second."""
    from kontiki_tpu_torch.parallel import segments_ba as sba
    from kontiki_tpu_torch.solver.banded import _scan_solve, block_tridiag_solve

    problem = big["problem"]
    s0 = problem.state0
    out = {}
    try:
        for method, solve_band in (("scan", _scan_solve), ("pcr", block_tridiag_solve)):
            sba.block_tridiag_solve = solve_band
            cost1 = sba.make_segment_ba_solver(problem, max_iterations=1,
                                               function_tolerance=0.0)(s0)[1].item()
            solve = sba.make_segment_ba_solver(problem, max_iterations=CONFIG5_ITERATIONS,
                                               function_tolerance=0.0)
            solve(s0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, cost, iters = solve(s0)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            out[method] = dict(cost1=cost1, cost=cost.item(), it_per_s=iters / seconds)
            print(f"config 5 banded, band solve {method}: 1-iteration cost {cost1!r}; {iters} "
                  f"iterations in {seconds:.3f} s = {iters / seconds:.3f} it/s; final cost "
                  f"{cost.item()!r}", flush=True)
    finally:
        sba.block_tridiag_solve = block_tridiag_solve
    a, b = out["scan"], out["pcr"]
    rel1 = abs(a["cost1"] - b["cost1"]) / a["cost1"]
    rel6 = abs(a["cost"] - b["cost"]) / a["cost"]
    print(f"config 5 banded: pcr vs scan, 1-iteration cost rel {rel1:.2e} (tol 1e-10), "
          f"6-iteration rel {rel6:.2e} (tol {CONFIG5_FINAL_RTOL:.0e})", flush=True)
    if not (rel1 <= 1e-10 and rel6 <= CONFIG5_FINAL_RTOL):
        fail("config 5 banded: the band-solve methods give different costs")
    return out


def phase_config5_pcg(big):
    """Config 5 through ``make_segment_ba_solver(mode="pcg")``: the
    1-iteration and timed 6-iteration costs beside the JAX package's PCG
    values, the change of both under a 1e-15 relative change of CG's
    right-hand side (the yardstick of their gap to the JAX values), CG
    iterations per solve, exact B1/B3 launches (a linearization and a
    re-cost an iteration, no B6), falling costs, one step with a converged
    CG against the banded step (1e-8), and one step with CG cut after 5
    iterations, which depends on the preconditioner, against the JAX
    package's (1e-10)."""
    from kontiki_tpu_torch.parallel import segments_ba as sba

    problem = big["problem"]
    s0 = problem.state0
    ks = []
    pcg = sba.pcg

    def counted(*args, **kw):
        x, k = pcg(*args, **kw)
        ks.append(k)
        return x, k

    sba.pcg = counted
    try:
        cost1 = sba.make_segment_ba_solver(problem, max_iterations=1, function_tolerance=0.0,
                                           mode="pcg")(s0)[1].item()

        def nudged(matvec, precond, b, *args, **kw):
            sign = 1.0 - 2.0 * (torch.arange(b.numel(), device=b.device, dtype=b.dtype) % 2)
            return counted(matvec, precond, b * (1.0 + 1e-15 * sign), *args, **kw)

        sba.pcg = nudged
        cost_nudged = {n: sba.make_segment_ba_solver(problem, max_iterations=n,
                                                     function_tolerance=0.0,
                                                     mode="pcg")(s0)[1].item()
                       for n in (1, CONFIG5_ITERATIONS)}
        sba.pcg = counted
        solve = sba.make_segment_ba_solver(problem, max_iterations=CONFIG5_ITERATIONS,
                                           function_tolerance=0.0, mode="pcg")
        solve(s0)
        torch.cuda.synchronize()
        ks.clear()
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, cost, iters = solve(s0)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = read_counts()
        peak = torch.cuda.max_memory_allocated()
        cg = [int(k) for k in ks]
        ks.clear()
        conv = sba.make_segment_ba_step(problem, mode="pcg", cg_tol=1e-12,
                                        cg_maxiter=20_000)[0](s0, 1e-4)
        cg_conv = int(ks[-1])
    finally:
        sba.pcg = pcg
    band = sba.make_segment_ba_step(problem)[0](s0, 1e-4)
    cut = sba.make_segment_ba_step(problem, mode="pcg", **CONFIG5_PCG_CUT)[0](s0, 1e-4)
    ref = JAX_CONFIG5_PCG
    cost = cost.item()
    print(f"config 5 pcg: {iters} iterations in {seconds:.3f} s = {iters / seconds:.3f} it/s; "
          f"CG iterations per solve {cg}; peak device memory {peak / 2**30:.2f} GiB; "
          f"launches {launches}", flush=True)
    for k, v in state.items():
        if v.shape != s0[k].shape or not torch.isfinite(v).all():
            fail(f"config 5 pcg: final state {k}: bad shape or non-finite values")
    for what, got, want in (("1-iteration cost", cost1, ref["cost1"]),
                            ("6-iteration cost", cost, ref["cost6"])):
        rel = abs(got - want) / want
        print(f"config 5 pcg: {what} {got!r} (JAX pcg {want!r}, rel {rel:.2e})", flush=True)
    nudge = {}
    for n, unchanged in ((1, cost1), (CONFIG5_ITERATIONS, cost)):
        nudge[n] = abs(cost_nudged[n] - unchanged) / unchanged
        print(f"config 5 pcg: {n}-iteration cost with CG's right-hand side changed by 1e-15 "
              f"relative: {cost_nudged[n]!r} (rel {nudge[n]:.2e} from the unchanged solve's)",
              flush=True)
    rel_c = {i: abs(conv[i].item() - band[i].item()) / abs(band[i].item()) for i in (0, 2, 3)}
    print(f"config 5 pcg: one step with a converged CG ({cg_conv} iterations): cost, new cost, "
          f"pred {[conv[i].item() for i in (0, 2, 3)]} against the banded step's "
          f"{[band[i].item() for i in (0, 2, 3)]}, rel {rel_c} (tol "
          f"{CONFIG5_PCG_CONVERGED_RTOL:.0e})", flush=True)
    rel_cut = {}
    for i, name in ((0, "cost"), (2, "new_cost"), (3, "pred"), (4, "gmax")):
        rel_cut[name] = abs(cut[i].item() - ref["cut"][name]) / abs(ref["cut"][name])
    print(f"config 5 pcg: one step with CG cut after {CONFIG5_PCG_CUT['cg_maxiter']} "
          f"iterations: cost, new cost, pred, max |g| {[cut[i].item() for i in (0, 2, 3, 4)]} "
          f"against the JAX package's, rel {rel_cut} (tol {CONFIG5_PCG_CUT_RTOL:.0e})",
          flush=True)
    if not max(rel_cut.values()) <= CONFIG5_PCG_CUT_RTOL:
        fail("config 5 pcg: the cut-CG step differs from the JAX package's")
    if iters != ref["iterations6"]:
        fail(f"config 5 pcg: ran {iters} iterations, the JAX package {ref['iterations6']}")
    if not (max(rel_c.values()) <= CONFIG5_PCG_CONVERGED_RTOL and cg_conv < 20_000):
        fail("config 5 pcg: the converged PCG step differs from the banded step")
    if not cost < cost1 < JAX_CONFIG5["cost0"]:
        fail(f"config 5 pcg: the costs do not fall ({JAX_CONFIG5['cost0']!r}, {cost1!r}, "
             f"{cost!r})")
    # one linearization (B1) and one re-cost (B3) an iteration, the cost of
    # state0 once; nothing is expanded (B6) or assembled
    check_launches("config 5 pcg", launches, {
        "linearize_rows split": iters, "cost_rows": iters + 1, "onehot_expand_rows": 0,
        "assemble_schur_blocks": 0})
    return dict(it_per_s=iters / seconds, cg=cg, cost1=cost1, cost=cost, conv=rel_c,
                cg_conv=cg_conv, nudge=nudge, cut=rel_cut)


def phase_newton_segment(problem):
    """One ``make_segment_ba_step`` banded step on config 4-Newton: its new
    cost and predicted decrease against the port's iterative-Schur and
    Schur steps (1e-6; the JAX package's own test), exact B8/B4/B6
    launches, and B6 on the Newton bucket (C 85) against its plain
    version."""
    from kontiki_tpu_torch.ops import linearize_kernels as lk
    from kontiki_tpu_torch.parallel.segments_ba import _build_segment_ba, make_segment_ba_step
    from kontiki_tpu_torch.solver import kernels
    from kontiki_tpu_torch.solver.iterative import make_iterative_step
    from kontiki_tpu_torch.solver.schur import build_schur_parts

    name = "config 4-Newton segment BA"
    s0 = problem.state0
    step, _ = make_segment_ba_step(problem)
    step(s0, 1e-4)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    got = step(s0, 1e-4)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_counts()
    spec = kernels.problem_spec(problem)
    nb = len(spec.buckets)
    print(f"{name}: one step {1e3 * seconds:.1f} ms; cost {got[0].item()!r}, new cost "
          f"{got[2].item()!r}, pred {got[3].item()!r}; launches {launches}", flush=True)
    check_launches(name, launches, {
        "newton_rows": 2, "newton_rows cost-only": 1, "imu_rows": 2 * (nb - 1),
        "imu_rows cost-only": nb - 1, "onehot_expand_rows": nb, "linearize_rows": 0,
        "assemble_schur_blocks": 0})
    it = make_iterative_step(problem, cg_tol=1e-12, cg_maxiter=2000)[0](s0, 1e-4)
    rt = kernels.problem_runtime(problem)
    parts = build_schur_parts(spec)
    lin = parts["linearize"](rt, s0)
    delta, pred = parts["solve_from_lin"](rt, s0, *lin[1:], 1e-4)
    schur_new = parts["total_cost"](rt, parts["retract"](rt, s0, delta)).item()
    for what, new_cost, p in (("iterative Schur", it[2].item(), it[3].item()),
                              ("Schur", schur_new, pred.item())):
        rels = (abs(got[2].item() - new_cost) / new_cost, abs(got[3].item() - p) / abs(p))
        print(f"{name}: against the {what} step: new cost {new_cost!r} pred {p!r}, rel "
              f"{rels[0]:.2e}, {rels[1]:.2e} (tol {NEWTON_SBA_RTOL:.0e})", flush=True)
        if not max(rels) <= NEWTON_SBA_RTOL:
            fail(f"{name}: new cost or pred differs from the {what} step's")
    b = _build_segment_ba(problem, None, "banded")
    st = b["to_sharded"](s0)
    _, blocks, _ = b["whitened_blocks"](st)
    i = [k.kind for k in b["spec_local"].buckets].index("rs_newton")
    blk, layout = blocks[i], b["layouts"][i]
    rel_ids = b["colrel"](blk, layout)
    Jw = blk["Jw"].contiguous()
    out = {}
    for dtype in (torch.float64, torch.float32):
        x = Jw.to(dtype)
        err = compare("onehot_expand_rows", dtype, ["Jd (C 85)"],
                      [lk.onehot_expand_rows(x, rel_ids, b["WB"])],
                      [lk.onehot_expand_rows_plain(x, rel_ids, b["WB"])])
        out[dtype] = err
    ms = cuda_ms(lambda: lk.onehot_expand_rows(Jw, rel_ids, b["WB"]))
    print(f"{name}: B6 at C {Jw.shape[2]}, M {Jw.shape[0]}, WB {b['WB']}: {ms:.4f} ms "
          f"({CARD})", flush=True)
    return dict(b6_ms=ms)


# ---------------------------------------------------------------------------
# the long-sequence IMU path: SEW, batch containers, the native helper, the
# banded estimator on kernel B4 at 200,000 rows of each kind
# ---------------------------------------------------------------------------

#: synthetic.make_long_imu_problem: a 1,000 s recording at 200 Hz of
#: make_split_trajectory(1001.0, dt=0.1, seed=2) (10,014 knots per spline),
#: config 2's biases (unlocked), SEW weights at quality 0.99, the start
#: perturbed as in config 2
LONG_IMU = dict(duration=1000.0, rate=200.0, knot_dt=0.1, seed=2, quality=0.99)
LONG_IMU_ROWS = 200_000
LONG_IMU_ITERATIONS = 5
LONG_IMU_COUNTS = SUMMARY_COUNTS[:3] + ("num_parameter_blocks_reduced", "num_residuals",
                                        "num_residual_blocks", "num_residuals_reduced",
                                        "num_residual_blocks_reduced")
#: the JAX package's values (JAX_PLATFORMS=cpu python3
#: tools/imu_long_reference.py): SEW's (spacing, variance) per signal, the
#: problem's counts and initial cost at 1,000 s, and the banded lm.solve's
#: costs on the rows of the first 100 s (the JAX band assembly needs ~33 GB
#: of host memory at 1,000 s)
JAX_LONG_IMU = dict(
    sew={"gyro": (0.29890395494040833, 0.000277633763220701),
         "accel": (0.45465758751066476, 0.29803958614501896)},
    num_tangent=60097,
    counts=(70035, 20011, 70027, 20008, 1200000, 400000, 1200000, 400000),
    cost0=76706848.10652633,
    cut=100.0,
    cut_costs=(7686239.91143666, 784.8834805178585, 0.6731213970796224, 0.12536476070958782,
               0.03534723876221713, 0.009085533778585167),
)
#: initial and 1-iteration costs against the JAX package's (the same
#: arrays; on the CPU the two agree to 2e-14 after one iteration at 300 s);
#: SEW's spacing and variance (numpy on both sides, the signals differ by
#: roundoff); the final cost at most the JAX package's after as many
#: iterations, to roundoff
LONG_IMU_RTOL = 1e-9
SEW_RTOL = 1e-9
LONG_IMU_FINAL_SLACK = 1e-6


def long_imu_problem():
    """The long recording through ``synthetic.make_long_imu_problem`` (SEW
    inside): rows and knots, SEW's spacings beside the grid's, against the
    JAX package's."""
    from kontiki_tpu_torch import synthetic

    t0 = time.time()
    gen = synthetic.make_long_imu_problem(**LONG_IMU)
    g, a = gen["measurements"]
    traj = gen["trajectory"]
    print(f"long IMU: {len(g)} gyro and {len(a)} accel rows on "
          f"{len(traj.R3_spline)} + {len(traj.SO3_spline)} knots, generated with SEW in "
          f"{time.time() - t0:.1f} s on the host", flush=True)
    if (len(g), len(a)) != (LONG_IMU_ROWS, LONG_IMU_ROWS):
        fail(f"long IMU: {len(g)} gyro and {len(a)} accel rows, not {LONG_IMU_ROWS}")
    for kind, (dt, var) in gen["sew"].items():
        jdt, jvar = JAX_LONG_IMU["sew"][kind]
        rel = max(abs(dt - jdt) / jdt, abs(var - jvar) / jvar)
        print(f"long IMU SEW {kind}: knot spacing {dt!r} s (the grid's {LONG_IMU['knot_dt']} s), "
              f"variance {var!r}, weight {1 / math.sqrt(var)!r}; JAX rel {rel:.2e} "
              f"(tol {SEW_RTOL:.0e})", flush=True)
        if not rel <= SEW_RTOL:
            fail(f"long IMU SEW {kind}: differs from the JAX package's by {rel:.2e}")
    return gen


def _objects(batches):
    """The containers' rows as per-object measurements, in order."""
    from kontiki_tpu_torch.measurements import (AccelerometerMeasurement,
                                                GyroscopeMeasurement)

    out = []
    for b in batches:
        cls, y = ((GyroscopeMeasurement, b.w) if hasattr(b, "w")
                  else (AccelerometerMeasurement, b.a))
        out += [cls(b.imu, t, yi, weight=w)
                for t, yi, w in zip(b.t.tolist(), y, b.weight.tolist())]
    return out


def phase_long_imu_build(gen):
    """``Problem`` from the two containers and from the same 400,000 rows as
    per-object measurements, both on the card: host build times, and the
    two equal exactly (buckets, state0, mask, active knots, counts); the
    counts against the JAX package's."""
    from kontiki_tpu_torch.solver.problem import Problem

    traj, batches = gen["trajectory"], gen["measurements"]
    t0 = time.perf_counter()
    batch = Problem(traj, batches)
    torch.cuda.synchronize()
    t_batch = time.perf_counter() - t0
    t0 = time.perf_counter()
    objs = _objects(batches)
    t_objs = time.perf_counter() - t0
    t0 = time.perf_counter()
    per_object = Problem(traj, objs)
    torch.cuda.synchronize()
    t_obj = time.perf_counter() - t0
    print(f"long IMU build on the host: batch containers {t_batch:.3f} s; per-object "
          f"{t_obj:.3f} s for {len(objs)} objects (making them {t_objs:.3f} s), "
          f"{t_obj / t_batch:.0f}x", flush=True)
    if batch.device.type != "cuda":
        fail(f"long IMU: Problem built on {batch.device}, not on the card")
    for key, b in batch.buckets.items():
        o = per_object.buckets[key]
        if (b.M, b.window, b.data.keys()) != (o.M, o.window, o.data.keys()) or not all(
                torch.equal(v, o.data[k]) for k, v in b.data.items()):
            fail(f"long IMU: bucket {key} differs between the batch and per-object builds")
    if list(batch.buckets) != list(per_object.buckets) or not all(
            torch.equal(v, per_object.state0[k]) for k, v in batch.state0.items()) or not (
            torch.equal(batch.mask, per_object.mask)) or not all(
            np.array_equal(x.active, y.active) for x, y in zip(batch.splines, per_object.splines)):
        fail("long IMU: state0, mask or active knots differ between the two builds")
    counts = tuple(getattr(batch, k) for k in LONG_IMU_COUNTS)
    if counts != tuple(getattr(per_object, k) for k in LONG_IMU_COUNTS):
        fail("long IMU: counts differ between the batch and per-object builds")
    print(f"long IMU: the two builds equal exactly; num_tangent {batch.num_tangent}, "
          f"counts {counts}", flush=True)
    if (batch.num_tangent, counts) != (JAX_LONG_IMU["num_tangent"], JAX_LONG_IMU["counts"]):
        fail(f"long IMU: num_tangent and counts {batch.num_tangent} {counts} != the JAX "
             f"package's {JAX_LONG_IMU['num_tangent']} {JAX_LONG_IMU['counts']}")
    del per_object, objs
    return batch


def _host_median_ms(fn, reps=3):
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        times.append(time.perf_counter() - t0)
    return out, 1e3 * sorted(times)[len(times) // 2]


def phase_native(gen, problem):
    """The native helper (``kontiki_tpu_torch.native``, C++) against its
    plain numpy versions on the problem's 400,000 row times: the batch
    path's checked activation per container and spline, window bases,
    span checks, a stable argsort (ties: both containers share their
    times) and the active knots' segments. Outputs equal exactly; the
    median host time of each."""
    from kontiki_tpu_torch import native

    traj, batches = gen["trajectory"], gen["measurements"]
    times = np.concatenate([b.t for b in batches])
    tmin, tmax = traj.min_time, traj.max_time
    sp = problem.splines[0]
    srt = np.sort(times)
    cases = {
        "activate_points": lambda n: [
            getattr(native, n)(b.t, 0.0, tmin, tmax, s.t0, s.dt, s.n)
            for b in batches for s in problem.splines],
        "window_bases": lambda n: getattr(native, n)(times, sp.t0, sp.dt, sp.n, 4),
        "check_spans": lambda n: getattr(native, n)(srt, srt, tmin, tmax),
        "argsort_times": lambda n: getattr(native, n)(times),
        "coalesce": lambda n: getattr(native, n)(sp.active),
    }
    for name, call in cases.items():
        got, ms = _host_median_ms(lambda: call(name))
        want, plain_ms = _host_median_ms(lambda: call(name + "_plain"))
        same = (got == want if name == "coalesce" or got is None
                else all(np.array_equal(x, y) for x, y in zip(
                    got if isinstance(got, list) else [got],
                    want if isinstance(want, list) else [want])))
        print(f"native {name} on {len(times)} times: C++ {ms:.3f} ms, plain numpy "
              f"{plain_ms:.3f} ms, outputs {'equal' if same else 'DIFFER'}", flush=True)
        if not same:
            fail(f"native {name}: the C++ and numpy outputs differ")


def phase_long_imu_b4(problem):
    """B4 at the long path's 200,000 rows of each kind, at ``state0``: the
    kernel against its plain version (f64, its TOL), the median CUDA-event
    time of one launch of each form, the plain version's time once (after
    one untimed call), and the bound. Returns each form's numbers on the
    accel rows, the worst error over both kinds."""
    from kontiki_tpu_torch.ops import linearize_kernels as lk
    from kontiki_tpu_torch.solver import kernels

    spec = kernels.problem_spec(problem)
    runtime = kernels.problem_runtime(problem)
    forms, worst = {}, 0.0
    for bspec, data in zip(spec.buckets, runtime["data"]):
        cfg, ins, _ = kernels._imu_inputs(spec, bspec, runtime, problem.state0, data)
        M = bspec.M
        got = (*lk.imu_rows(cfg, ins), lk.imu_rows(cfg, ins, cost_only=True))
        torch.cuda.synchronize()
        want = lk.imu_rows_plain(cfg, ins)
        print(f"  long IMU {bspec.kind} M={M}:", flush=True)
        worst = max(worst, compare("imu_rows", torch.float64, ("r", "J", "r cost-only"), got,
                                   (*want, want[0])))
        del got, want
        n_in = sum(k for n, k in lk.IMU_INPUTS if n in ins)
        for form, cost_only in (("linearize", False), ("cost-only", True)):
            ms = cuda_ms(lambda: lk.imu_rows(cfg, ins, cost_only=cost_only))
            plain_ms = cuda_ms(lambda: lk.imu_rows_plain(cfg, ins, cost_only=cost_only),
                               reps=1, warmup=1)
            nbytes = 8 * M * (n_in + 3 + (0 if cost_only else 3 * lk.imu_columns(cfg)))
            ops = lk.imu_rows_ops(cfg, ins, cost_only=cost_only)
            b_ms, b_by = bound(nbytes, ops)
            print(f"  imu_rows f64 long IMU {bspec.kind} {form} M={M}: kernel {ms:.4f} ms a "
                  f"launch, plain {plain_ms:.3f} ms, bound {b_ms:.5f} ms by {b_by} "
                  f"({nbytes} bytes, {ops} operations) [{CARD}]", flush=True)
            if bspec.kind == "accel":
                forms[form] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                                   library_ms=None)  # no single PyTorch call
    for r in forms.values():
        r["max_abs_err"] = worst
    return forms


def phase_long_imu_breakdown(problem):
    """Where one banded iteration's time goes at the long path's 400,000
    rows (state0, lam 1e-4): median CUDA-event ms of the linearization
    (B4 and the compressed rows), then the linear-solver phase's stages:
    gradient and diagonal, the band and border assembly (``index_add_`` of
    each row's [C, C] product), the damped system (with the assembly), the
    PCR band solve, the bordered solve (all of it but the prediction), and
    the whole phase (``solve_with_pred``)."""
    from kontiki_tpu_torch.solver import kernels
    from kontiki_tpu_torch.solver.banded import block_tridiag_solve, build_banded_parts

    spec, runtime, s0 = kernels.problem_spec(problem), kernels.problem_runtime(problem), \
        problem.state0
    parts = build_banded_parts(spec)
    lam = 1e-4
    _, blocks = parts["linearize"](runtime, s0)
    g = parts["grad_and_diag"](blocks)[0]
    D, U, rhs, _ = parts["damped_system"](runtime, blocks, g, lam)
    stages = {
        "linearize": lambda: parts["linearize"](runtime, s0),
        "grad_and_diag": lambda: parts["grad_and_diag"](blocks),
        "assemble": lambda: parts["assemble"](blocks, problem.dtype, problem.device),
        "damped_system": lambda: parts["damped_system"](runtime, blocks, g, lam),
        "block_tridiag_solve": lambda: block_tridiag_solve(D, U, rhs),
        "banded_solve": lambda: parts["banded_solve"](runtime, blocks, g, lam),
        "solve_with_pred": lambda: parts["solve_with_pred"](runtime, blocks, lam, s0),
    }
    ms = {k: cuda_ms(fn, reps=3, warmup=1) for k, fn in stages.items()}
    print("long IMU banded iteration breakdown (CUDA events, median of 3): "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in ms.items())
          + f"; band {tuple(D.shape)} with {rhs.shape[-1]} right-hand sides [{CARD}]",
          flush=True)
    return ms


def _solve_long(traj, batches, what):
    """``TrajectoryEstimator(traj).solve(LONG_IMU_ITERATIONS,
    strategy="banded", function_tolerance=0.0)`` on the card, counts reset
    just before and read just after; exact B4 launches (each iteration
    linearizes and re-costs both buckets), the rate, the Summary's phase
    times and the peak device memory."""
    from kontiki_tpu_torch import TrajectoryEstimator

    est = TrajectoryEstimator(traj)
    for b in batches:
        est.add_measurement(b)
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    summary = est.solve(max_iterations=LONG_IMU_ITERATIONS, progress=False,
                        strategy="banded", function_tolerance=0.0)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    n = len(summary.iterations) - 1
    costs = [it.cost for it in summary.iterations]
    times = (("jacobian", summary.jacobian_evaluation_time_in_seconds),
             ("linear solver", summary.linear_solver_time_in_seconds),
             ("residual", summary.residual_evaluation_time_in_seconds))
    print(f"{what}: {summary.BriefReport()}; {n} iterations, minimizer "
          f"{summary.minimizer_time_in_seconds:.3f} s = "
          f"{n / summary.minimizer_time_in_seconds:.3f} it/s, {seconds:.3f} s with the "
          f"problem build and write-back; per iteration "
          + ", ".join(f"{k} {1e3 * v / max(n, 1):.3f} ms" for k, v in times)
          + f"; peak device memory {peak / 2**30:.3f} GiB; costs {costs}; launches "
          f"{ {k: v for k, v in launches.items() if v} }", flush=True)
    if n != LONG_IMU_ITERATIONS or not all(it.step_is_successful for it in summary.iterations):
        fail(f"{what}: {n} iterations, steps "
             f"{[it.step_is_successful for it in summary.iterations]}")
    check_launches(what, launches, {"imu_rows": 4 * n, "imu_rows cost-only": 2 * n})
    return summary, costs, launches


def phase_long_imu_solve(gen):
    """The banded estimator on the long recording: first on the rows of its
    first 100 s (copies of the objects), every cost against the JAX
    package's banded ``lm.solve`` (initial and 1-iteration within 1e-9, the
    last at most the JAX package's), then on all 400,000 rows: the initial
    cost against the JAX package's, every step accepted, exact launches."""
    import copy

    traj, batches = gen["trajectory"], gen["measurements"]
    cut_traj, cut_batches = copy.deepcopy((traj, batches))  # the IMU object shared
    end = 0.5 + JAX_LONG_IMU["cut"]
    cut_batches = [type(b)(b.imu, b.t[b.t < end], getattr(b, b._value_field)[b.t < end],
                           weight=b.weight[b.t < end]) for b in cut_batches]
    _, costs, _ = _solve_long(cut_traj, cut_batches, f"long IMU, first {JAX_LONG_IMU['cut']} s")
    jax_costs = JAX_LONG_IMU["cut_costs"]
    for i, (got, want) in enumerate(zip(costs, jax_costs)):
        rel = abs(got - want) / want
        print(f"long IMU, first {JAX_LONG_IMU['cut']} s: cost {i} {got!r} (JAX {want!r}, "
              f"rel {rel:.2e})", flush=True)
        if i < 2 and not rel <= LONG_IMU_RTOL:
            fail(f"long IMU: cost {i} differs from the JAX package's by {rel:.2e}")
    if not costs[-1] <= jax_costs[-1] * (1 + LONG_IMU_FINAL_SLACK):
        fail(f"long IMU: final cost {costs[-1]!r} above the JAX package's {jax_costs[-1]!r}")

    what = f"long IMU, {LONG_IMU['duration']:g} s"
    summary, costs, launches = _solve_long(traj, batches, what)
    rel = abs(costs[0] - JAX_LONG_IMU["cost0"]) / JAX_LONG_IMU["cost0"]
    print(f"{what}: initial cost {costs[0]!r} (JAX {JAX_LONG_IMU['cost0']!r}, rel "
          f"{rel:.2e}, tol {LONG_IMU_RTOL:.0e}); final/initial {costs[-1] / costs[0]:.3e} "
          f"(the first 100 s: {jax_costs[-1] / jax_costs[0]:.3e} in the JAX package)",
          flush=True)
    if not rel <= LONG_IMU_RTOL:
        fail(f"long IMU: initial cost differs from the JAX package's by {rel:.2e}")
    if not (math.isfinite(costs[-1]) and costs[-1] < costs[0]):
        fail(f"long IMU: the solve did not lower the cost ({costs[0]!r} -> {costs[-1]!r})")
    return launches


# ---------------------------------------------------------------------------
# the scale-out layer: process-group meshes on the one card (a rehearsal of
# the multi-shard paths over host-staged gloo, not a scaling figure)
# ---------------------------------------------------------------------------

#: ranks of the config-5 rehearsal, of the sharded Schur and dense steps
SHARDED_RANKS = 4
SCHUR_RANKS = 2
#: sharded against one-shard results: costs and the state after one step
SHARDED_RTOL = 1e-9
SHARDED_STATE_ATOL = 1e-9
#: the one-rank NCCL world's cost against the one-shard path's
NCCL_RTOL = 1e-12
#: the group's bound on every collective (seconds)
SPMD_TIMEOUT = 300.0


def _timed_collectives(mesh):
    """Wrap ``mesh``'s ``psum``, ``pmax`` and ``ppermute`` to add their host
    milliseconds (the card synchronized on either side) to the returned
    dict; ``allgather`` and ``barrier`` go through ``psum``."""
    acc = {"ppermute": 0.0, "psum": 0.0, "pmax": 0.0}

    def timed(name, fn):
        def call(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            acc[name] += 1e3 * (time.perf_counter() - t0)
            return out
        return call

    for name in acc:
        setattr(mesh, name, timed(name, getattr(mesh, name)))
    return acc


def _stage_ms(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t0)


def _rank_config5(mesh, arrays, f32_arrays):
    """One rank of the config-5 rehearsal: the problem from the parent's
    arrays on this rank's card; banded ``total_cost``, one step and the
    timed 6-iteration solve (after an untimed one; launches counted from 0
    just before, read just after); one PCG step with CG cut after 5
    iterations; config 4-Newton's banded step (B8 and B4 on every rank);
    one banded step's stages timed, with the time inside the collectives;
    last, f32_check's config 5 in float32 from ``f32_arrays``
    (``_f32_config5``)."""
    from kontiki_tpu_torch import interop
    from kontiki_tpu_torch.parallel.segments_ba import (
        _build_segment_ba,
        make_segment_ba_solver,
        make_segment_ba_step,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    out = dict(rank=mesh.rank, backend=mesh.backend, transport=mesh.transport,
               device=str(mesh.device))
    problem = interop.raw_problem_from_numpy(**arrays, device=mesh.device)
    s0 = problem.state0
    step, total_cost = make_segment_ba_step(problem, mesh)
    out["total_cost0"] = total_cost(s0).item()
    reset_counts()
    out["step"] = step(s0, 1e-4)
    out["step_launches"] = read_counts()
    out["pcg_cut"] = make_segment_ba_step(problem, mesh, mode="pcg", **CONFIG5_PCG_CUT)[0](
        s0, 1e-4)
    solve = make_segment_ba_solver(problem, mesh, max_iterations=CONFIG5_ITERATIONS,
                                   function_tolerance=0.0)
    solve(s0)
    torch.cuda.synchronize()
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, cost, iters = solve(s0)
    torch.cuda.synchronize()
    out["solve"] = dict(state=state, cost=cost.item(), iterations=iters,
                        seconds=time.perf_counter() - t0, launches=read_counts(),
                        peak=torch.cuda.max_memory_allocated())

    # config 4-Newton's banded step: Newton rows (B8) and IMU rows (B4)
    _, newton = newton_problem(CONFIG4_NEWTON)
    nstep, _ = make_segment_ba_step(newton, mesh)
    reset_counts()
    out["newton_step"] = nstep(newton.state0, 1e-4)
    out["newton_launches"] = read_counts()
    del newton, nstep

    # one banded step by stage; the collectives' time inside them
    b = _build_segment_ba(problem, mesh, "banded")
    st = b["to_sharded"](s0)
    lam = torch.tensor(1e-4, dtype=problem.dtype, device=problem.device)
    b["step_local"](st, lam)
    acc = _timed_collectives(mesh)
    ms = {}
    (c, blocks, ml), ms["rows (halo_state, whitened rows, cost psum)"] = _stage_ms(
        lambda: b["whitened_blocks"](st))
    asm, ms["assembly (colrel, B6, pair blocks)"] = _stage_ms(lambda: b["assemble_band"](blocks))
    del blocks
    ctx, ms["elimination, fold, halo reduce, sensor psums"] = _stage_ms(
        lambda: b["eliminate"](asm, ml, lam, st))
    sol, ms["SPIKE band solve"] = _stage_ms(lambda: b["band_solve"](ctx))
    (xb, xs), ms["sensor solve"] = _stage_ms(lambda: b["sensor_solve"](ctx, sol, lam))
    (dc, dl, _, _), ms["back-substitution and pred"] = _stage_ms(
        lambda: b["back_substitute"](ctx, xb, xs, st))
    new, ms["retract"] = _stage_ms(lambda: b["retract_local"](st, dc, dl))
    _, ms["re-cost (cost_local)"] = _stage_ms(lambda: b["cost_local"](new))
    out["stages_ms"] = ms
    out["collectives_ms"] = dict(acc)
    del b, st, asm, ctx, sol, new
    out["f32_check"] = _f32_config5(mesh, f32_arrays)
    return out


def phase_sharded_config5(big, f32_arrays):
    """Config 5 at full size on ``SHARDED_RANKS`` gloo ranks on the one card
    through ``make_segment_ba_step`` / ``_solver`` against the one-shard
    path of this script (whose values are pinned to the JAX package's):
    ``total_cost``, one banded step (costs to 1e-9 relative, the state to
    1e-9), the 6-iteration solve (the same iterations, the final cost
    within config 5's 1e-4), one PCG step with CG cut after 5 iterations
    (1e-9), config 4-Newton's banded step (1e-9); every rank the same bits;
    per rank the B1/B3/B6/B8 launches, peak memory, it/s and one step's
    stages. Labelled a one-card rehearsal over host-staged gloo. The same
    world solves f32_check's config 5 in float32 from ``f32_arrays``
    (``phase_f32_check`` reads it from the returned ranks' outputs)."""
    from kontiki_tpu_torch import interop
    from kontiki_tpu_torch.parallel.launch import backend_for, run_spmd
    from kontiki_tpu_torch.parallel.segments_ba import make_segment_ba_solver, make_segment_ba_step

    problem = big["problem"]
    s0 = problem.state0
    one = dict(total_cost0=make_segment_ba_step(problem)[1](s0).item(),
               step=make_segment_ba_step(problem)[0](s0, 1e-4),
               pcg_cut=make_segment_ba_step(problem, mode="pcg", **CONFIG5_PCG_CUT)[0](s0, 1e-4))
    one["solve"] = make_segment_ba_solver(problem, max_iterations=CONFIG5_ITERATIONS,
                                          function_tolerance=0.0)(s0)
    _, newton = newton_problem(CONFIG4_NEWTON)
    one["newton_step"] = make_segment_ba_step(newton)[0](newton.state0, 1e-4)
    del newton
    arrays = interop.raw_problem_arrays(problem)
    n = SHARDED_RANKS
    label = (f"one-card rehearsal, {n} ranks on cuda:0 over {backend_for('cuda:0', n)}, "
             f"not a scaling figure [{CARD}]")
    t0 = time.perf_counter()
    outs = run_spmd(_rank_config5, n, "cuda:0", arrays, f32_arrays, timeout=SPMD_TIMEOUT)
    print(f"sharded config 5: {n} ranks ran in {time.perf_counter() - t0:.1f} s with the "
          f"spawn and each rank's build ({label})", flush=True)

    def check(what, got, want, rtol):
        rel = abs(got - want) / abs(want)
        print(f"sharded config 5: {what} {got!r} (one shard {want!r}, rel {rel:.2e}, tol "
              f"{rtol:.0e})", flush=True)
        if not rel <= rtol:
            fail(f"sharded config 5: {what} differs from the one-shard path's by {rel:.2e}")

    def same_bits(what, get):
        ref = get(outs[0])
        for o in outs[1:]:
            x = get(o)
            if isinstance(ref, dict):
                ok = all(torch.equal(x[k], ref[k]) for k in ref)
            else:
                ok = all(torch.equal(a, b) if torch.is_tensor(a) else a == b
                         for a, b in zip(x, ref))
            if not ok:
                fail(f"sharded config 5: {what} differs between rank 0 and rank {o['rank']}")

    r0 = outs[0]
    print(f"sharded config 5: backend {r0['backend']}, transport {r0['transport']}, devices "
          f"{[o['device'] for o in outs]}", flush=True)
    check("total_cost at state0", r0["total_cost0"], one["total_cost0"], SHARDED_RTOL)
    for name in ("step", "pcg_cut", "newton_step"):
        for i, what in ((0, "cost"), (2, "new cost"), (3, "pred"), (4, "max |g|")):
            check(f"{name} {what}", r0[name][i].item(), one[name][i].item(), SHARDED_RTOL)
        err = max((r0[name][1][k].cpu() - v.cpu()).abs().max().item()
                  for k, v in one[name][1].items() if v.numel())
        print(f"sharded config 5: {name} state max abs diff {err:.3e} (tol "
              f"{SHARDED_STATE_ATOL:.0e})", flush=True)
        if not err <= SHARDED_STATE_ATOL:
            fail(f"sharded config 5: {name} state differs from the one-shard step's by {err:.3e}")
        same_bits(f"{name} outputs", lambda o: (*[o[name][i] for i in (0, 2, 3, 4)],))
        same_bits(f"{name} state", lambda o: o[name][1])
    sol = r0["solve"]
    if sol["iterations"] != one["solve"][2]:
        fail(f"sharded config 5: {sol['iterations']} iterations, one shard {one['solve'][2]}")
    check(f"{CONFIG5_ITERATIONS}-iteration cost", sol["cost"], one["solve"][1].item(),
          CONFIG5_FINAL_RTOL)
    same_bits("solve state", lambda o: o["solve"]["state"])
    want = {"linearize_rows split": CONFIG5_ITERATIONS + 1,
            "onehot_expand_rows": CONFIG5_ITERATIONS + 1, "cost_rows": 0}
    for o in outs:
        s = o["solve"]
        counts = {k: v for k, v in s["launches"].items() if v}
        print(f"sharded config 5 rank {o['rank']}: {s['iterations']} iterations in "
              f"{s['seconds']:.3f} s = {s['iterations'] / s['seconds']:.3f} it/s, peak device "
              f"memory {s['peak'] / 2**30:.2f} GiB, solve launches {counts}; step launches "
              f"{ {k: v for k, v in o['step_launches'].items() if v} }; config 4-Newton step "
              f"launches { {k: v for k, v in o['newton_launches'].items() if v} } ({label})",
              flush=True)
        check_launches(f"sharded config 5 rank {o['rank']} solve", s["launches"], want)
        check_launches(f"sharded config 5 rank {o['rank']} step", o["step_launches"],
                       {"linearize_rows split": 1, "cost_rows": 1, "onehot_expand_rows": 1})
        if not (o["newton_launches"]["newton_rows"] > 0 and o["newton_launches"]["imu_rows"] > 0):
            fail(f"sharded config 5 rank {o['rank']}: config 4-Newton's step launched no B8/B4")
        stages = ", ".join(f"{k} {v:.3f}" for k, v in o["stages_ms"].items())
        coll = ", ".join(f"{k} {v:.3f}" for k, v in o["collectives_ms"].items())
        print(f"sharded config 5 rank {o['rank']} one banded step by stage (host ms, card "
              f"synchronized): {stages}; inside them, collectives: {coll} ({label})",
              flush=True)
        for name, counts in (("solve", s["launches"]), ("step", o["step_launches"]),
                             ("newton", o["newton_launches"])):
            for k, v in counts.items():
                MAIN_PATH_LAUNCHES[k] = MAIN_PATH_LAUNCHES.get(k, 0) + v
    return outs


def _rank_schur(mesh, names):
    """Config 4 through ``make_sharded_schur_step`` (B1, B2 a rank) and
    config 2 through ``make_sharded_step`` (B4 a rank), rebuilt from their
    seeds on this rank's card; one step each at lam 1e-4, launches counted."""
    from kontiki_tpu_torch import parallel, synthetic
    from kontiki_tpu_torch.solver.problem import Problem

    torch.backends.cuda.matmul.allow_tf32 = False
    out = dict(rank=mesh.rank, backend=mesh.backend, transport=mesh.transport)
    prob = synthetic.make_rsvi_problem(**CONFIG4)
    p4 = Problem(prob["trajectory"], prob["measurements"])
    reset_counts()
    out["config 4"] = parallel.make_sharded_schur_step(p4, mesh)[0](p4.state0, 1e-4)
    out["config 4 launches"] = read_counts()
    cfg = IMU_CONFIGS["config 2"]
    prob = getattr(synthetic, cfg["make"])(**cfg["kwargs"])
    p2 = Problem(prob["trajectory"], prob["measurements"])
    reset_counts()
    out["config 2"] = parallel.make_sharded_step(p2, mesh)[0](p2.state0, 1e-4)
    out["config 2 launches"] = read_counts()
    return out


def phase_sharded_schur(problem4, problem2):
    """Config 4 through the landmark-block-sharded Schur step and config 2
    through the measurement-sharded dense step on ``SCHUR_RANKS`` gloo ranks
    on the one card, against the port's one-device steps (1e-9), with
    B1/B2 and B4 launches on every rank."""
    from kontiki_tpu_torch.parallel.launch import backend_for, run_spmd
    from kontiki_tpu_torch.solver import kernels
    from kontiki_tpu_torch.solver.schur import build_schur_parts

    ref = {}
    spec, rt = kernels.problem_spec(problem4), kernels.problem_runtime(problem4)
    parts = build_schur_parts(spec)
    s0 = problem4.state0
    cost, *lin = parts["linearize"](rt, s0)
    delta, pred = parts["solve_from_lin"](rt, s0, *lin, 1e-4)
    new = parts["retract"](rt, s0, delta)
    ref["config 4"] = (cost, new, parts["total_cost"](rt, new), pred)
    spec, rt = kernels.problem_spec(problem2), kernels.problem_runtime(problem2)
    ref["config 2"] = kernels.build_parts(spec)["step"](rt, problem2.state0, 1e-4)[:4]
    n = SCHUR_RANKS
    outs = run_spmd(_rank_schur, n, "cuda:0", list(ref), timeout=SPMD_TIMEOUT)
    print(f"sharded Schur and dense steps: {n} ranks, backend {outs[0]['backend']}, "
          f"transport {outs[0]['transport']} (one-card rehearsal over "
          f"{backend_for('cuda:0', n)}) [{CARD}]", flush=True)
    for name, want_launch in (("config 4", ("linearize_rows", "assemble_schur_blocks")),
                              ("config 2", ("imu_rows",))):
        got = outs[0][name]
        for i, what in ((0, "cost"), (2, "new cost"), (3, "pred")):
            g, w = got[i].item(), ref[name][i].item()
            rel = abs(g - w) / abs(w)
            print(f"sharded {name}: {what} {g!r} (one device {w!r}, rel {rel:.2e}, tol "
                  f"{SHARDED_RTOL:.0e})", flush=True)
            if not rel <= SHARDED_RTOL:
                fail(f"sharded {name}: {what} differs from the one-device step's by {rel:.2e}")
        err = max((got[1][k] - v.cpu()).abs().max().item() for k, v in ref[name][1].items()
                  if v.numel())
        print(f"sharded {name}: state max abs diff {err:.3e}", flush=True)
        if not err <= SHARDED_STATE_ATOL:
            fail(f"sharded {name}: state differs from the one-device step's by {err:.3e}")
        for o in outs:
            launches = o[f"{name} launches"]
            print(f"sharded {name} rank {o['rank']}: launches "
                  f"{ {k: v for k, v in launches.items() if v} }", flush=True)
            if not all(launches[k] > 0 for k in want_launch):
                fail(f"sharded {name} rank {o['rank']}: {want_launch} not all launched")
            if not all(torch.equal(o[name][1][k], got[1][k]) for k in got[1]):
                fail(f"sharded {name}: rank {o['rank']}'s state differs from rank 0's")
            for k, v in launches.items():
                MAIN_PATH_LAUNCHES[k] = MAIN_PATH_LAUNCHES.get(k, 0) + v


def _rank_spike(mesh, systems):
    """SPIKE on this rank's super-blocks of each system; its time."""
    from kontiki_tpu_torch.solver.banded import spike_block_tridiag_solve

    out = dict(transport=mesh.transport)
    for name, (D, U, rhs) in systems.items():
        sb = D.shape[0] // mesh.size
        part = [a[mesh.rank * sb:(mesh.rank + 1) * sb].to(mesh.device) for a in (D, U, rhs)]
        spike_block_tridiag_solve(*part, mesh)
        out[name] = _stage_ms(lambda: spike_block_tridiag_solve(*part, mesh))
    return out


def phase_spike(systems):
    """SPIKE (``solver.banded.spike_block_tridiag_solve``) on
    ``SHARDED_RANKS`` gloo ranks on config 5's damped band (``band_systems``;
    its blocks padded to a multiple of the ranks with identity blocks)
    against ``block_tridiag_solve`` on one device (rtol 1e-9), with its
    time per rank."""
    from kontiki_tpu_torch.parallel.launch import run_spmd
    from kontiki_tpu_torch.solver.banded import block_tridiag_solve

    n = SHARDED_RANKS
    ref, inputs = {}, {}
    for name, (D, U, rhs) in systems.items():
        nb, d, _ = D.shape
        pad = (-nb) % n + (n if (nb + (-nb) % n) // n < 2 else 0)
        eye = torch.eye(d, dtype=D.dtype, device=D.device).expand(pad, d, d)
        U = U.clone()
        U[-1] = 0.0
        D = torch.cat([D, eye])
        U = torch.cat([U, torch.zeros_like(eye)])
        rhs = torch.cat([rhs, torch.zeros(pad, d, rhs.shape[-1], dtype=rhs.dtype,
                                          device=rhs.device)])
        ref[name] = block_tridiag_solve(D, U, rhs).cpu()
        inputs[name] = (D.cpu(), U.cpu(), rhs.cpu())
    outs = run_spmd(_rank_spike, n, "cuda:0", inputs, timeout=SPMD_TIMEOUT)
    for name in systems:
        x = torch.cat([o[name][0] for o in outs])
        err = ((x - ref[name]).abs().max() / ref[name].abs().max()).item()
        ms = [round(o[name][1], 3) for o in outs]
        print(f"SPIKE on {n} gloo ranks, {name} ({tuple(inputs[name][0].shape)} blocks, "
              f"{inputs[name][2].shape[-1]} right-hand sides): rel err {err:.2e} against "
              f"block_tridiag_solve (tol 1e-9); ms per rank {ms} (one-card rehearsal, "
              f"{outs[0]['transport']}) [{CARD}]", flush=True)
        if not err <= 1e-9:
            fail(f"SPIKE on {name}: rel error {err:.2e} against block_tridiag_solve")


def _rank_nccl(mesh, arrays):
    """The one-rank NCCL world: config 5's segment-BA banded step through
    the same code (device-side ``all_reduce``), and a self ``ppermute``."""
    from kontiki_tpu_torch import interop
    from kontiki_tpu_torch.parallel.segments_ba import make_segment_ba_step

    torch.backends.cuda.matmul.allow_tf32 = False
    problem = interop.raw_problem_from_numpy(**arrays, device=mesh.device)
    step, total_cost = make_segment_ba_step(problem, mesh)
    x = torch.arange(5.0, dtype=torch.float64, device=mesh.device)
    return dict(backend=mesh.backend, transport=mesh.transport,
                total_cost0=total_cost(problem.state0).item(),
                step=step(problem.state0, 1e-4), self_copy=mesh.ppermute(x, [(0, 0)]),
                psum=mesh.psum(x), on_card=x.is_cuda)


def phase_sharded_nccl(big):
    """A one-rank NCCL world runs config 5's segment-BA step: its costs
    against the one-shard path's (1e-12), the self ``ppermute`` a copy."""
    from kontiki_tpu_torch import interop
    from kontiki_tpu_torch.parallel.launch import run_spmd
    from kontiki_tpu_torch.parallel.segments_ba import make_segment_ba_step

    problem = big["problem"]
    step, total_cost = make_segment_ba_step(problem)
    want = step(problem.state0, 1e-4)
    want_total = total_cost(problem.state0).item()
    (o,) = run_spmd(_rank_nccl, 1, "cuda:0", interop.raw_problem_arrays(problem),
                    timeout=SPMD_TIMEOUT)
    x = torch.arange(5.0, dtype=torch.float64)
    print(f"one-rank world: backend {o['backend']}, transport {o['transport']}; self "
          f"ppermute {o['self_copy'].tolist()}, psum {o['psum'].tolist()}", flush=True)
    if o["backend"] != "nccl" or not (torch.equal(o["self_copy"], x) and torch.equal(o["psum"], x)):
        fail("one-rank NCCL world: wrong backend, or its self ppermute or psum is not a copy")
    for what, got, w in (("total_cost", o["total_cost0"], want_total),
                         ("step cost", o["step"][0].item(), want[0].item()),
                         ("step new cost", o["step"][2].item(), want[2].item())):
        rel = abs(got - w) / abs(w)
        print(f"one-rank NCCL world, config 5: {what} {got!r} (one shard {w!r}, rel {rel:.2e}, "
              f"tol {NCCL_RTOL:.0e})", flush=True)
        if not rel <= NCCL_RTOL:
            fail(f"one-rank NCCL world: {what} differs from the one-shard path's by {rel:.2e}")


# The JAX package's float32 tier (KONTIKI_TPU_X64=0, kontiki_tpu/config.py:
# state, data, times and normal equations in float32, no compensated
# accumulation): tests/f32_check.py's five problems at its sizes, seeds,
# iterations and solver options, and its gates on the solutions' scores
# (config 1 the aligned AOE in rad, config 2 the ATE, config 3 the
# sim3-aligned ATE, configs 4-5 the se3-aligned ATE, in m). Config 4 also
# needs the ATE below the start's and the cost down by 1e6.
F32_CHECK = {
    "config 1": dict(make="make_gyro_problem", max_iterations=30, gate=1e-4,
                     kwargs=dict(duration=3.0, rate=100.0, seed=1, sigma_q=0.05)),
    "config 2": dict(make="make_imu_problem", max_iterations=40, gate=1e-3,
                     kwargs=dict(duration=3.0, rate=100.0, seed=2, position_rate=5.0)),
    "config 3": dict(make="make_rsvi_problem", max_iterations=40, gate=2e-3,
                     kwargs=dict(nviews=8, nlandmarks=20, imu_rate=0.0, seed=3, perturb_rho=0.1,
                                 sigma_p=0.02, sigma_q=0.01)),
    "config 4": dict(make="make_rsvi_problem", max_iterations=40, gate=2e-3,
                     kwargs=dict(nviews=8, nlandmarks=24, imu_rate=100.0, seed=12,
                                 perturb_rho=0.05, sigma_p=0.02, sigma_q=0.01)),
}
F32_CHECK5 = dict(n_views=120, n_landmarks=600, obs_per_landmark=4, seed=13, imu_rate=50.0)
F32_CHECK5_SOLVER = dict(max_iterations=20, function_tolerance=1e-12, cg_tol=1e-6,
                         cg_maxiter=100)
F32_CHECK5_GATE = 2e-3
# The five BASELINE configs at full size in the JAX package's float32 tier,
# on the CPU (JAX_PLATFORMS=cpu python3 tools/f32_reference.py): the initial
# cost, the final cost and iterations of make_fused_solver(problem, 25,
# function_tolerance=0.0) (config 5: make_segment_ba_solver(problem, mesh of
# one, max_iterations=6, function_tolerance=0.0, mode="banded")), and the
# score of the start and of the solution (f32_check's, on [0.5, 5.5] for
# configs 1-2, the views' span for 3-4, [t1, t2] for 5).
JAX_F32 = {
    "config 1": dict(cost0=88.54670715332031, cost=1.1803922422837232e-11, iterations=25,
                     score0=0.034181322902441025, score=6.397623764087257e-08),
    "config 2": dict(cost0=116355.7421875, cost=3.3772977303669904e-07, iterations=25,
                     score0=0.057742778211832047, score=0.0228236336261034),
    "config 3": dict(cost0=36944.4140625, cost=4.242252089170506e-06, iterations=25,
                     score0=0.015422929448432706, score=8.761633764692909e-08),
    "config 4": dict(cost0=58760.5859375, cost=1.0678278158593457e-05, iterations=25,
                     score0=0.020439486423104346, score=7.787591881105015e-08),
    "config 5": dict(cost0=784575.3125, cost=0.1164119690656662, iterations=6,
                     score0=0.012044502215480814, score=0.0015811954843755324),
}
# The port's float32 initial cost against the JAX package's: two float32
# sums of the same rows in another order. On the CPU the port's plain
# versions came within 1.7e-7 to 1.2e-6 of them (configs 1-4), and the JAX
# package's own float32 initial costs are 2.4e-7 to 2.1e-6 from its float64
# ones.
F32_COST0_RTOL = 1e-4
# |score of the port's float32 solution - the JAX package's| at full size:
# f32_check's bound of each config.
F32_SCORE_BOUND = {"config 1": 1e-4, "config 2": 1e-3, "config 3": 2e-3, "config 4": 2e-3,
                   "config 5": 2e-3}
F32_KERNELS = ("linearize_rows", "assemble_schur_blocks", "cost_rows", "imu_rows",
               "onehot_expand_rows")


def f32_score(name, kwargs, gen, traj):
    """f32_check's score of ``traj`` against the truth of ``gen`` (the
    queries through B5 on the card)."""
    from kontiki_tpu_torch.synthetic import trajectory_aoe, trajectory_ate

    truth = gen["true_trajectory"]
    if name in ("config 1", "config 2"):
        t1, t2 = 0.5, 0.5 + kwargs["duration"]
        return (trajectory_aoe if name == "config 1" else trajectory_ate)(truth, traj, t1, t2)
    t1, t2 = gen["views"][0].t0, gen["views"][-1].t0
    return trajectory_ate(truth, traj, t1, t2, align="sim3" if name == "config 3" else "se3")


def big_ba_score(big, state):
    """Config 5's se3-aligned ATE of ``state``'s knots on [t1, t2]."""
    from kontiki_tpu_torch.synthetic import trajectory_ate

    solved = big["trajectory"].clone()
    solved.R3_spline.set_knots(state["r3"].cpu().numpy())
    solved.SO3_spline.set_knots(state["so3"].cpu().numpy())
    return trajectory_ate(big["true_trajectory"], solved, big["t1"], big["t2"], align="se3")


def check_float32(what, tensors):
    """Fail unless every float tensor of ``tensors`` ((name, tensor) pairs)
    is float32."""
    bad = {k: str(v.dtype) for k, v in tensors if v.is_floating_point() and v.dtype != torch.float32}
    if bad:
        fail(f"{what}: tensors left float32: {bad}")


def problem_tensors(problem):
    yield "mask", problem.mask
    yield "d_max", problem.d_max
    yield from problem.state0.items()
    for key, b in problem.buckets.items():
        for k, v in b.data.items():
            yield f"{key}.{k}", v


def f32_launches(launches):
    return {k: launches.get(f"{k} f32", 0) for k in F32_KERNELS}


def _f32_config5(mesh, arrays):
    """f32_check's config 5 on this rank of ``mesh``: the problem from the
    parent's arrays in float32 on this rank's card, solved by
    ``make_segment_ba_solver`` (launches counted from 0 just before)."""
    from kontiki_tpu_torch import interop
    from kontiki_tpu_torch.parallel.segments_ba import make_segment_ba_solver

    problem = interop.raw_problem_from_numpy(**arrays, device=mesh.device, dtype=torch.float32)
    reset_counts()
    t0 = time.perf_counter()
    state, cost, iters = make_segment_ba_solver(problem, mesh, **F32_CHECK5_SOLVER)(
        problem.state0)
    torch.cuda.synchronize()
    return dict(rank=mesh.rank, seconds=time.perf_counter() - t0, launches=read_counts(),
                state={k: v.cpu() for k, v in state.items()}, cost=cost.item(), iterations=iters,
                dtypes=sorted({str(v.dtype) for v in list(state.values()) + [cost]}))


def f32_check5_problem():
    """f32_check's config 5 through ``make_big_ba_problem(...,
    dtype=torch.float32)`` on the card."""
    from kontiki_tpu_torch import synthetic

    big = synthetic.make_big_ba_problem(**F32_CHECK5, dtype=torch.float32)
    check_float32("f32 tier config 5 problem", problem_tensors(big["problem"]))
    return big


def phase_f32_check(big, sharded):
    """tests/f32_check.py's five problems through the port in float32 on the
    card, at its sizes, seeds, iterations and solver options, held to its
    gates: configs 1-4 through ``Problem(..., dtype=torch.float32)`` and
    ``solver.lm.solve``, config 5 (``big``, ``f32_check5_problem``) through
    ``make_segment_ba_solver`` on one shard, and its solve on the
    ``SHARDED_RANKS`` gloo ranks of ``phase_sharded_config5`` (``sharded``,
    the ranks' outputs; the JAX tier runs it on 4 devices). Every float
    tensor of each problem and solution is float32; each solve's float32
    launches are printed. Returns the float32 launches of the phase,
    summed."""
    from kontiki_tpu_torch import synthetic
    from kontiki_tpu_torch.parallel.launch import backend_for
    from kontiki_tpu_torch.parallel.segments_ba import make_segment_ba_solver
    from kontiki_tpu_torch.solver.lm import solve
    from kontiki_tpu_torch.solver.problem import Problem

    f32 = torch.float32
    total = dict.fromkeys(F32_KERNELS, 0)

    def add(launches):
        for k, v in f32_launches(launches).items():
            total[k] += v

    for name, cfg in F32_CHECK.items():
        gen = getattr(synthetic, cfg["make"])(**cfg["kwargs"])
        problem = Problem(gen["trajectory"], gen["measurements"], dtype=f32)
        check_float32(f"f32 tier {name} problem", problem_tensors(problem))
        score0 = f32_score(name, cfg["kwargs"], gen, gen["trajectory"])
        reset_counts()
        t0 = time.perf_counter()
        state, summary = solve(problem, max_iterations=cfg["max_iterations"], progress=False)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = read_counts()
        add(launches)
        check_float32(f"f32 tier {name} solution", state.items())
        problem.write_back(state)
        score = f32_score(name, cfg["kwargs"], gen, gen["trajectory"])
        ratio = summary.final_cost / max(summary.initial_cost, 1e-30)
        print(f"f32 tier (f32_check) {name}: {len(summary.iterations) - 1} iterations "
              f"({summary.num_successful_steps} accepted) in {seconds:.3f} s, cost "
              f"{summary.initial_cost:.6e} -> {summary.final_cost:.6e} (x{ratio:.2e}), score "
              f"{score0:.3e} -> {score:.3e} (gate {cfg['gate']:.0e}); float32 launches "
              f"{f32_launches(launches)} [{CARD}]", flush=True)
        if not score < cfg["gate"]:
            fail(f"f32 tier {name}: score {score:.3e} >= {cfg['gate']:.0e}")
        if name == "config 4" and not (score < score0 and ratio < 1e-6):
            fail(f"f32 tier {name}: ATE {score0:.3e} -> {score:.3e}, cost x{ratio:.2e}")
        if sum(f32_launches(launches).values()) == 0:
            fail(f"f32 tier {name}: no float32 kernel launch")

    problem = big["problem"]
    reset_counts()
    t0 = time.perf_counter()
    state, cost, iters = make_segment_ba_solver(problem, **F32_CHECK5_SOLVER)(problem.state0)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_counts()
    add(launches)
    check_float32("f32 tier config 5 solution", list(state.items()) + [("cost", cost)])
    score = big_ba_score(big, state)
    print(f"f32 tier (f32_check) config 5, one shard: {iters} iterations in {seconds:.3f} s, "
          f"final cost {cost.item():.6e}, ATE {score:.3e} (gate {F32_CHECK5_GATE:.0e}); "
          f"float32 launches {f32_launches(launches)} [{CARD}]", flush=True)
    if not score < F32_CHECK5_GATE:
        fail(f"f32 tier config 5: ATE {score:.3e} >= {F32_CHECK5_GATE:.0e}")
    if iters != F32_CHECK5_SOLVER["max_iterations"]:
        fail(f"f32 tier config 5: {iters} iterations; below float32's epsilon the function "
             f"tolerance cannot stop the loop")

    n = len(sharded)
    label = f"one-card rehearsal, {n} ranks on cuda:0 over {backend_for('cuda:0', n)}"
    outs = [o["f32_check"] for o in sharded]
    r0 = outs[0]
    score4 = big_ba_score(big, r0["state"])
    rel = abs(r0["cost"] - cost.item()) / cost.item()
    print(f"f32 tier (f32_check) config 5, {n} ranks: {r0['iterations']} iterations, final "
          f"cost {r0['cost']:.6e} (one shard {cost.item():.6e}, rel {rel:.2e}), ATE "
          f"{score4:.3e} (gate {F32_CHECK5_GATE:.0e}), dtypes {r0['dtypes']} ({label}) "
          f"[{CARD}]", flush=True)
    if not score4 < F32_CHECK5_GATE:
        fail(f"f32 tier config 5 on {n} ranks: ATE {score4:.3e} >= {F32_CHECK5_GATE:.0e}")
    if r0["dtypes"] != ["torch.float32"] or r0["iterations"] != iters:
        fail(f"f32 tier config 5 on {n} ranks: dtypes {r0['dtypes']}, {r0['iterations']} "
             f"iterations")
    for o in outs:
        if any(not torch.equal(o["state"][k], v) for k, v in r0["state"].items()):
            fail(f"f32 tier config 5: rank {o['rank']}'s state differs from rank 0's")
        counts = f32_launches(o["launches"])
        print(f"f32 tier config 5 rank {o['rank']}: {o['seconds']:.3f} s, float32 launches "
              f"{counts} ({label}) [{CARD}]", flush=True)
        if not all(counts[k] > 0 for k in ("linearize_rows", "imu_rows", "onehot_expand_rows")):
            fail(f"f32 tier config 5 rank {o['rank']}: B1, B4 or B6 not launched in float32")
        add(o["launches"])
        for k, v in o["launches"].items():
            MAIN_PATH_LAUNCHES[k] = MAIN_PATH_LAUNCHES.get(k, 0) + v
    return total


def _timed(solve, warm_up, s0):
    """(state, cost, iterations, seconds, launches) of ``solve(s0)`` after
    an untimed ``warm_up(s0)`` (a one-iteration solve: the first call pays
    the one-off set-up), launches counted from 0 just before the timed
    call, the host clock ending in a synchronize."""
    warm_up(s0)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    state, cost, iters = solve(s0)
    torch.cuda.synchronize()
    return state, cost.item(), iters, time.perf_counter() - t0, read_counts()


def phase_f32_baseline(big5, f32_check_launches):
    """The five BASELINE configs at full size in float32 beside the same
    runs in float64: configs 1-4 through ``make_fused_solver(problem, 25,
    function_tolerance=0.0)`` on the generators' problems, config 5 through
    ``make_segment_ba_solver(problem, max_iterations=6,
    function_tolerance=0.0, mode="banded")`` on config 5's arrays. Each
    dtype's rate (host clock after a warm-up), and config 5's memory; the
    float32 runs held to the JAX package's float32 values (``JAX_F32``): the
    initial cost within ``F32_COST0_RTOL``, the score within
    ``F32_SCORE_BOUND``, the final cost below the initial one. B1, B2, B3, B4
    and B6 must each have launched in float32 in this phase or in
    ``phase_f32_check`` (``f32_check_launches``)."""
    from kontiki_tpu_torch import interop, synthetic
    from kontiki_tpu_torch.parallel.segments_ba import make_segment_ba_solver
    from kontiki_tpu_torch.solver.lm import make_fused_solver
    from kontiki_tpu_torch.solver.problem import Problem

    dtypes = (torch.float64, torch.float32)
    total = dict(f32_check_launches)
    runs = {}
    for name in ("config 1", "config 2", "config 3", "config 4"):
        cfg = IMU_CONFIGS.get(name) or dict(make="make_rsvi_problem", **CAMERA_CONFIGS[name])
        gen = getattr(synthetic, cfg["make"])(**cfg["kwargs"])
        problems = {dt: Problem(gen["trajectory"], gen["measurements"], dtype=dt)
                    for dt in dtypes}
        check_float32(f"f32 {name} problem", problem_tensors(problems[torch.float32]))
        for dt, problem in problems.items():
            s0 = problem.state0
            cost0 = make_fused_solver(problem, 0, function_tolerance=0.0)(s0)[1].item()
            solve = make_fused_solver(problem, 25, function_tolerance=0.0)
            warm_up = make_fused_solver(problem, 1, function_tolerance=0.0)
            state, cost, iters, seconds, launches = _timed(solve, warm_up, s0)
            runs[name, dt] = dict(cost0=cost0, cost=cost, iterations=iters, seconds=seconds,
                                  launches=launches, state=state)
        for dt, problem in problems.items():  # each solution into the objects in turn
            problem.write_back(runs[name, dt]["state"])
            runs[name, dt]["score"] = f32_score(name, cfg["kwargs"], gen, gen["trajectory"])
    arrays = interop.raw_problem_arrays(big5["problem"])
    for dt in dtypes:
        problem = (big5["problem"] if dt == torch.float64
                   else interop.raw_problem_from_numpy(**arrays, dtype=dt))
        resident = sum(v.numel() * v.element_size() for _, v in problem_tensors(problem))
        s0 = problem.state0
        cost0 = make_segment_ba_solver(problem, max_iterations=0, function_tolerance=0.0)(s0)[1]
        solve, warm_up = (make_segment_ba_solver(problem, max_iterations=k,
                                                 function_tolerance=0.0, mode="banded")
                          for k in (CONFIG5_ITERATIONS, 1))
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        state, cost, iters, seconds, launches = _timed(solve, warm_up, s0)
        runs["config 5", dt] = dict(
            cost0=cost0.item(), cost=cost, iterations=iters, seconds=seconds, launches=launches,
            score=big_ba_score(big5, state), resident=resident,
            peak=torch.cuda.max_memory_allocated() - base)
        del problem, state, solve, warm_up
    for name in ("config 1", "config 2", "config 3", "config 4", "config 5"):
        r64, r32, ref = runs[name, torch.float64], runs[name, torch.float32], JAX_F32[name]
        for r in (r64, r32):
            print(f"f32 tier {name} {'float32' if r is r32 else 'float64'}: {r['iterations']} "
                  f"iterations in {r['seconds']:.4f} s = {r['iterations'] / r['seconds']:.2f} "
                  f"it/s; cost {r['cost0']!r} -> {r['cost']!r}; score {r['score']!r}"
                  + (f"; problem tensors {r['resident'] / 2**30:.3f} GiB, the solve's peak "
                     f"above them {r['peak'] / 2**30:.3f} GiB" if name == "config 5" else "")
                  + f" [{CARD}]", flush=True)
        rel0 = abs(r32["cost0"] - ref["cost0"]) / ref["cost0"]
        dscore = abs(r32["score"] - ref["score"])
        counts = f32_launches(r32["launches"])
        print(f"f32 tier {name}: float32 against the JAX package's float32 tier: initial cost "
              f"rel {rel0:.2e} (tol {F32_COST0_RTOL:.0e}), final cost {r32['cost']:.3e} (JAX "
              f"{ref['cost']:.3e}), score {r32['score']:.3e} (JAX {ref['score']:.3e}, |diff| "
              f"{dscore:.2e}, bound {F32_SCORE_BOUND[name]:.0e}); float32 rate over float64 "
              f"rate {r64['seconds'] / r32['seconds']:.3f}; float32 launches {counts} [{CARD}]",
              flush=True)
        if not rel0 <= F32_COST0_RTOL:
            fail(f"f32 tier {name}: initial cost {r32['cost0']!r} differs from the JAX "
                 f"package's float32 {ref['cost0']!r} by {rel0:.2e}")
        if not dscore <= F32_SCORE_BOUND[name]:
            fail(f"f32 tier {name}: score {r32['score']:.3e} vs the JAX package's "
                 f"{ref['score']:.3e}")
        if not (math.isfinite(r32["cost"]) and r32["cost"] < r32["cost0"]):
            fail(f"f32 tier {name}: final cost {r32['cost']!r} not below the initial one")
        if r32["iterations"] != ref["iterations"]:
            fail(f"f32 tier {name}: {r32['iterations']} iterations, the JAX package "
                 f"{ref['iterations']}")
        for k in F32_KERNELS:
            total[k] += counts[k]
    print(f"f32 tier: float32 launches of the phase (f32_check's problems and the full-size "
          f"solves) {total} [{CARD}]", flush=True)
    missing = [k for k, v in total.items() if not v > 0]
    if missing:
        fail(f"f32 tier: {missing} never launched in float32 on a solve path")
    return runs


def main():
    from kontiki_tpu_torch.interop import raw_problem_arrays

    phase_device()
    phase_build()
    prob4, problem4 = phase_problem("config 4")
    built4 = dict(trajectory=prob4["trajectory"].clone(), measurements=prob4["measurements"])
    b1 = phase_b1(problem4)
    b2 = phase_b2(problem4)
    phase_b2_edges()
    phase_solve("config 4", problem4)
    phase_iterative("config 4", problem4)
    prob3, problem3 = phase_problem("config 3")
    b1_split = phase_b1(problem3)
    b3 = phase_b3({"config 3": problem3, "config 4": problem4})
    phase_solve("config 3", problem3)
    atan = {name: phase_problem(name) for name in ATAN_CONFIGS}
    branches = phase_branches(branch_inputs({name: p for name, (_, p) in atan.items()}))
    b2_lifting = phase_b2(atan["config 3-atan-lifting"][1])
    phase_b1_ragged({"config 4": problem4, "config 3-atan-lifting": atan["config 3-atan-lifting"][1]})
    phase_b3_ragged({"config 4": problem4, "config 3": problem3,
                     "config 3-atan-lifting": atan["config 3-atan-lifting"][1]})
    for name, (_, p) in atan.items():
        phase_solve(name, p)
    phase_iterative("config 3-atan-lifting", atan["config 3-atan-lifting"][1])
    phase_lifting_strategies("config 3-atan-lifting", atan["config 3-atan-lifting"][0])
    for name, (prob, _) in atan.items():
        phase_atan_estimator(name, prob)
    prob4n, problem4n = phase_newton_problem()
    b8 = phase_b8(newton_branches(problem4n))
    phase_b8_edges(*newton_inputs(problem4n), newton_w10_branches())
    b2_newton = phase_b2(problem4n)
    phase_newton_solve(problem4n)
    phase_newton_estimator(prob4n)
    phase_newton_segment(problem4n)
    del problem4n
    imu = {name: imu_problem(name) for name in IMU_CONFIGS}
    b4 = phase_b4(imu)
    for name, p in imu.items():
        phase_imu_solve(name, p)
        phase_banded_imu(name, p)
    phase_breakdown(imu["config 2"])
    for name, prob in (("config 3", prob3), ("config 4", prob4)):
        phase_estimator(name, prob)
    queries = query_setup()
    b5 = phase_b5(queries)
    b7 = phase_b7(queries)
    phase_readback(queries, built4)
    phase_readback_split(queries)
    phase_scores(built4["trajectory"], prob4)
    phase_pose_fit()
    big5 = config5_problem()
    phase_config5_rows(big5["problem"])
    b6 = phase_b6(big5["problem"])
    phase_config5(big5)
    phase_config5_pcg(big5)
    band = gyro_band_problem()
    phase_gyro_band(band)
    systems = band_systems(big5, band)
    phase_band_solve(systems)
    phase_config5_methods(big5)
    f32_big5 = f32_check5_problem()
    sharded = phase_sharded_config5(big5, raw_problem_arrays(f32_big5["problem"]))
    phase_spike(systems)
    phase_sharded_nccl(big5)
    phase_sharded_schur(problem4, imu["config 2"])
    phase_f32_baseline(big5, phase_f32_check(f32_big5, sharded))
    del big5, band, systems
    long_imu = long_imu_problem()
    long_problem = phase_long_imu_build(long_imu)
    phase_native(long_imu, long_problem)
    b4_long = phase_long_imu_b4(long_problem)
    phase_long_imu_breakdown(long_problem)
    del long_problem
    long_launches = phase_long_imu_solve(long_imu)
    n = MAIN_PATH_LAUNCHES
    print(f"main-path launches: {n}", flush=True)
    b1_source = dict(route="cuda", source="kontiki_tpu_torch/csrc/linearize_rows.cu")
    atan_source = dict(route="cuda", source="kontiki_tpu_torch/csrc/linearize_rows_atan.cu")
    kernels = [
        dict(name="linearize_rows", **b1_source,
             replaces="kontiki_tpu/ops/linearize_kernels.py:682",
             launches=n.get("linearize_rows se3 pinhole static", 0), **b1),
        dict(name="linearize_rows (split)", **b1_source,
             replaces="kontiki_tpu/ops/linearize_kernels.py:682",
             launches=n.get("linearize_rows split pinhole static", 0), **b1_split),
        *[dict(name=f"{kernel} (split, atan{', lifting' if rows == 'lifting' else ''})",
               **atan_source,
               replaces=("kontiki_tpu/ops/linearize_kernels.py:682"
                         if kernel == "linearize_rows"
                         else "kontiki_tpu/ops/linearize_kernels.py:1220"),
               launches=n.get(f"{kernel} split atan {rows}", 0),
               **branches[kernel, f"split atan {rows}"])
          for kernel in ("linearize_rows", "cost_rows") for rows in ("static", "lifting")],
        dict(name="assemble_schur_blocks (rdim 3, C 62)", route="cuda",
             source="kontiki_tpu_torch/csrc/assemble_schur.cu",
             replaces="kontiki_tpu/ops/assembly_kernels.py:102",
             launches=n.get(B2_LIFTING, 0), **b2_lifting),
        dict(name="assemble_schur_blocks", route="cuda",
             source="kontiki_tpu_torch/csrc/assemble_schur.cu",
             replaces="kontiki_tpu/ops/assembly_kernels.py:102",
             launches=n["assemble_schur_blocks"], **b2),
        dict(name="assemble_schur_blocks (C 85, config 4-Newton's camera bucket)", route="cuda",
             source="kontiki_tpu_torch/csrc/assemble_schur.cu",
             replaces="kontiki_tpu/ops/assembly_kernels.py:102",
             launches=n.get(B2_NEWTON, 0), **b2_newton),
        *[dict(name=f"newton_rows ({form})", route="cuda",
               source="kontiki_tpu_torch/csrc/newton_rows.cu",
               replaces="kontiki_tpu/ops/linearize_kernels.py:1114",
               launches=n.get("newton_rows split pinhole"
                              + (" cost-only" if form == "cost-only" else ""), 0), **b8[form])
          for form in ("linearize", "cost-only")],
        dict(name="cost_rows", **b1_source,
             replaces="kontiki_tpu/ops/linearize_kernels.py:1220",
             launches=n.get("cost_rows se3 pinhole static", 0)
             + n.get("cost_rows split pinhole static", 0), **b3),
        *[dict(name=f"imu_rows ({form}, per launch at config 2's accel bucket)",
               route="cuda", source="kontiki_tpu_torch/csrc/imu_rows.cu",
               replaces="kontiki_tpu/ops/linearize_kernels.py:1601",
               launches=(n["imu_rows cost-only"] if form == "cost-only"
                         else n["imu_rows"] - n["imu_rows cost-only"]), **b4[form])
          for form in ("linearize", "cost-only")],
        *[dict(name=f"imu_rows ({form}, per launch at the long-sequence path's 200,000 "
                    "accel rows)",
               route="cuda", source="kontiki_tpu_torch/csrc/imu_rows.cu",
               replaces="kontiki_tpu/ops/linearize_kernels.py:1601",
               launches=(long_launches["imu_rows cost-only"] if form == "cost-only"
                         else long_launches["imu_rows"] - long_launches["imu_rows cost-only"]),
               **b4_long[form])
          for form in ("linearize", "cost-only")],
        *[dict(name=f"evaluate_windows ({kind})", route="cuda",
               source="kontiki_tpu_torch/csrc/eval_windows.cu",
               replaces="kontiki_tpu/ops/linearize_kernels.py:1368",
               launches=n[f"evaluate_windows {kind}"], **b5[kind])
          for kind in ("r3", "so3", "se3")],
        dict(name="r3_evaluate_kernel", route="cuda",
             source="kontiki_tpu_torch/csrc/r3_evaluate.cu",
             replaces="kontiki_tpu/ops/spline_kernels.py:147",
             launches=n["r3_evaluate_kernel"], **b7),
        dict(name="onehot_expand_rows", route="cuda",
             source="kontiki_tpu_torch/csrc/onehot_expand.cu",
             replaces="kontiki_tpu/ops/linearize_kernels.py:1148",
             launches=n["onehot_expand_rows"], **b6),
    ]
    for k in kernels:
        if not k["launches"] > 0:
            fail(f"{k['name']} was not launched on the main path")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
