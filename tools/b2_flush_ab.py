#!/usr/bin/env python3
"""Time B2's two ways of flushing the blocks' head triangles on the card,
in turns, on the camera buckets of config 4 (rdim 2, Pc 194) and config
3-atan-lifting (rdim 3, Pc 3,976) at state0, float64:

- workspace: ``ops.assembly_kernels.assemble_schur_blocks`` (the port's
  kernel): each block stores its triangle in a workspace, and a second
  launch sums it over the blocks in order into H and g;
- atomic: ``tools/b2_flush_atomic.cu``: each block adds the nonzero
  entries of its triangle into H and g with global atomics.

Prints the median CUDA-event times (workspace, atomic, atomic, workspace),
each variant's largest difference to the plain version, with the card's
name and power limit. Run from the repository root on a machine with a
CUDA card and ``nvcc``:

    python3 tools/b2_flush_ab.py
"""
import ctypes
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def build_atomic():
    from kontiki_tpu_torch.ops import build

    so = build.BUILD_DIR / "b2_flush_atomic.so"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = os.path.join(ROOT, "tools", "b2_flush_atomic.cu")
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-shared", src, "-o", str(so)],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    lib.b2_atomic_f64.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.b2_atomic_f64.restype = ctypes.c_int
    return lib


def bucket_rows(kwargs):
    """B2's inputs of the problem's camera bucket at state0, and (Pc, L)."""
    from kontiki_tpu_torch.solver import kernels
    from kontiki_tpu_torch.solver.problem import Problem
    from kontiki_tpu_torch.solver.schur import whitened_rows
    from kontiki_tpu_torch.synthetic import make_rsvi_problem

    gen = make_rsvi_problem(**kwargs)
    problem = Problem(gen["trajectory"], gen["measurements"])
    spec, rt = kernels.problem_spec(problem), kernels.problem_runtime(problem)
    L = spec.num_landmarks
    lo = spec.landmark_offset
    (cam,) = [i for i, b in enumerate(spec.buckets) if b.kind in kernels.CAMERA_KINDS]
    _, rows = whitened_rows(spec, spec.buckets[cam], rt, problem.state0, rt["data"][cam],
                            rt["mask"][lo:lo + L])
    return rows, spec.num_tangent - L, L


def median_ms(fn, reps=50, warmup=5):
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[reps // 2]


def main():
    from kontiki_tpu_torch.ops import assembly_kernels as ak

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(f"card: {smi.stdout.strip()}", flush=True)
    lib = build_atomic()
    cases = {
        "config 4": dict(nviews=64, nlandmarks=200, imu_rate=200.0, seed=4, trajectory="se3"),
        "config 3-atan-lifting": dict(nviews=32, nlandmarks=200, imu_rate=0.0, seed=3,
                                      camera_kind="atan", rs="lifting"),
    }
    for name, kwargs in cases.items():
        rows, P, L = bucket_rows(kwargs)
        M, rdim, C = rows[0].shape
        kw = dict(P=P, L=L, with_rho=True)
        want = ak.assemble_schur_blocks_plain(*rows, **kw)

        def atomic():
            opts = dict(dtype=torch.float64, device="cuda")
            out = (torch.zeros(P, P, **opts), torch.zeros(P, **opts), torch.zeros(L, P, **opts),
                   torch.zeros(L, **opts), torch.zeros(L, **opts))
            err = lib.b2_atomic_f64(*[ctypes.c_void_p(a.data_ptr()) for a in (*rows, *out)], M,
                                    rdim, C, P, L, 1,
                                    ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
            if err:
                raise RuntimeError(f"b2_atomic_f64: CUDA error {err}")
            return out

        variants = {"workspace": lambda: ak.assemble_schur_blocks(*rows, **kw),
                    "atomic": atomic}
        for vname, fn in variants.items():
            got = fn()
            torch.cuda.synchronize()
            rel = max(((x - y).abs().max() / y.abs().max()).item() for x, y in zip(got, want))
            print(f"{name} M={M} rdim={rdim} C={C} P={P}: {vname}: rel err {rel:.2e}",
                  flush=True)
        times = {v: [] for v in variants}
        for v in ("workspace", "atomic", "atomic", "workspace"):
            times[v].append(median_ms(variants[v]))
        print(f"{name}: ms workspace {times['workspace']}, atomic {times['atomic']}", flush=True)


if __name__ == "__main__":
    main()
