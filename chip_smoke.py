#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (kontiki_tpu_torch) on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero without the final line:

1. device: a CUDA device must be present; prints its name and power limit;
2. build: compiles the hand-written kernels (nvcc, sm_90a) and loads them;
3. B1 (camera-row linearization) and 4. B2 (Schur assembly): each kernel
   against its plain PyTorch version on the same config-4 inputs on the
   card, in float64 and float32, with errors and median times;
5. solve: BASELINE config 4 through the normal entry points
   (``synthetic.make_rsvi_problem`` -> ``Problem`` -> ``make_fused_solver``):
   a 1-iteration cost against the JAX package's value, an untimed warm-up
   solve, then the timed 25-iteration solve with launch counts,
   final/initial cost and iterations per second.

The last two lines are a JSON object with the kernels' numbers and the JSON
result ``{"ok": true, "device": {...}}``.
"""
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

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
}


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
    print(f"card: {smi.stdout.strip() or smi.stderr.strip()}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def phase_build():
    from kontiki_tpu_torch.ops import build

    t0 = time.time()
    so = build.build()
    build.load_library()
    print(f"build: {time.time() - t0:.1f} s -> {os.path.relpath(so, ROOT)}", flush=True)
    for line in so.with_suffix(".log").read_text().splitlines():
        if "Function properties" in line or "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}", flush=True)


def phase_problem():
    from kontiki_tpu_torch.solver import kernels
    from kontiki_tpu_torch.solver.problem import Problem
    from kontiki_tpu_torch.synthetic import make_rsvi_problem

    t0 = time.time()
    prob = make_rsvi_problem(**CONFIG4)
    problem = Problem(prob["trajectory"], prob["measurements"], device="cuda")
    spec = kernels.problem_spec(problem)
    shape = {b.kind: b.M for b in spec.buckets}
    shape["num_tangent"] = spec.num_tangent
    print(f"config 4: {shape}, landmarks {spec.num_landmarks} "
          f"({time.time() - t0:.1f} s on the host)", flush=True)
    if shape != CONFIG4_SHAPE:
        fail(f"config 4 structure {shape} != {CONFIG4_SHAPE}")
    return prob, problem


def phase_b1(problem):
    from kontiki_tpu_torch.ops import linearize_kernels as lk
    from kontiki_tpu_torch.solver import kernels

    spec = kernels.problem_spec(problem)
    runtime = kernels.problem_runtime(problem)
    (cam,) = [i for i, b in enumerate(spec.buckets) if b.kind == "rs_static"]
    ins, _ = kernels._camera_inputs(spec, runtime, problem.state0, runtime["data"][cam])
    names = ("r", "J", "J_rho")
    out = {}
    for dtype in (torch.float64, torch.float32):
        x = {k: v.to(dtype).contiguous() for k, v in ins.items()}
        got = lk.linearize_rows(x)
        torch.cuda.synchronize()
        want = lk.linearize_rows_plain(x)
        err = compare("linearize_rows", dtype, names, got, want)
        if dtype == torch.float64:
            out["max_abs_err"] = err
            out["ms"] = cuda_ms(lambda: lk.linearize_rows(x))
            out["plain_ms"] = cuda_ms(lambda: lk.linearize_rows_plain(x), reps=5)
            print(f"  linearize_rows f64 M={x['u_ref'].shape[1]}: kernel "
                  f"{out['ms']:.3f} ms, plain {out['plain_ms']:.3f} ms", flush=True)
    return out


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
        with_rho = bspec.kind == "rs_static"
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
                print(f"  assemble_schur_blocks f64 camera bucket: kernel "
                      f"{out['ms']:.3f} ms, plain {out['plain_ms']:.3f} ms", flush=True)
    return out


def phase_solve(problem):
    from kontiki_tpu_torch.ops import assembly_kernels as ak
    from kontiki_tpu_torch.ops import linearize_kernels as lk
    from kontiki_tpu_torch.solver import kernels
    from kontiki_tpu_torch.solver.lm import make_fused_solver
    from kontiki_tpu_torch.solver.schur import build_schur_parts

    spec = kernels.problem_spec(problem)
    runtime = kernels.problem_runtime(problem)
    cost0 = build_schur_parts(spec)["linearize"](runtime, problem.state0)[0].item()
    rel0 = abs(cost0 - JAX_COST_0) / JAX_COST_0
    print(f"initial cost {cost0!r} (JAX {JAX_COST_0!r}, rel {rel0:.2e})", flush=True)
    if not rel0 <= COST_RTOL:
        fail(f"initial cost differs from the JAX package by {rel0:.2e}")

    solve1 = make_fused_solver(problem, 1, function_tolerance=0.0, strategy="schur")
    _, cost1, _ = solve1(problem.state0)
    cost1 = cost1.item()
    rel1 = abs(cost1 - JAX_COST_1) / JAX_COST_1
    print(f"1-iteration cost {cost1!r} (JAX {JAX_COST_1!r}, rel {rel1:.2e})", flush=True)
    if not rel1 <= COST_RTOL:
        fail(f"1-iteration cost differs from the JAX package by {rel1:.2e}")

    solve = make_fused_solver(problem, 25, function_tolerance=0.0, strategy="schur")
    # The first solve on a fresh process pays one-off set-up (lazy CUDA
    # module loads, library handles) worth several solves: time the second.
    t0 = time.perf_counter()
    solve(problem.state0)
    torch.cuda.synchronize()
    print(f"warm-up solve: {time.perf_counter() - t0:.3f} s", flush=True)
    lk.linearize_rows.launches = 0
    ak.assemble_schur_blocks.launches = 0
    t0 = time.perf_counter()
    state, cost, iters = solve(problem.state0)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {
        "linearize_rows": lk.linearize_rows.launches,
        "assemble_schur_blocks": ak.assemble_schur_blocks.launches,
    }
    cost = cost.item()
    ratio = cost / cost0
    print(f"solve: {iters} iterations in {seconds:.3f} s = {iters / seconds:.2f} it/s; "
          f"initial cost {cost0:.6e} final cost {cost:.6e} ratio {ratio:.3e}; "
          f"launches {launches}", flush=True)
    for k, v in state.items():
        if v.shape != problem.state0[k].shape or not torch.isfinite(v).all():
            fail(f"final state {k}: bad shape or non-finite values")
    if not (math.isfinite(ratio) and ratio <= FINAL_RATIO):
        fail(f"final/initial cost {ratio:.3e} > {FINAL_RATIO:.0e}")
    if iters != 25:
        fail(f"ran {iters} iterations, expected 25")
    for name, n in launches.items():
        if n <= 0:
            fail(f"{name} was never launched by the solve")
    return launches


def main():
    phase_device()
    phase_build()
    _, problem = phase_problem()
    b1 = phase_b1(problem)
    b2 = phase_b2(problem)
    launches = phase_solve(problem)
    kernels = [
        dict(name="linearize_rows", route="cuda",
             source="kontiki_tpu_torch/csrc/linearize_rows.cu",
             replaces="kontiki_tpu/ops/linearize_kernels.py:682",
             launches=launches["linearize_rows"], **b1),
        dict(name="assemble_schur_blocks", route="cuda",
             source="kontiki_tpu_torch/csrc/assemble_schur.cu",
             replaces="kontiki_tpu/ops/assembly_kernels.py:102",
             launches=launches["assemble_schur_blocks"], **b2),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
