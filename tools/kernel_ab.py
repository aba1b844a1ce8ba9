#!/usr/bin/env python3
"""Time the port's hand-written kernels built from other sources against
each other, in one process, in turns on the same inputs.

A variant is ``NAME=CSRC`` or ``NAME=CSRC:DEFINE,...``: a ``csrc``
directory (this checkout's, or another checkout's, e.g. unpacked from
``git archive``) and ``-D`` defines for ``nvcc``. Each variant's ``.cu``
files are compiled with the port's flags (``ops.build.NVCC_FLAGS``) into a
library of its own under the git-ignored ``kontiki_tpu_torch/_build/ab``
(kept under a hash of its sources and flags), all compiles started
together, and ``ops.build.load_library`` is pointed at
each library in turn, so this checkout's wrappers and solvers drive every
variant (its C entry points must be this checkout's). Cases:

- ``b4``: B4 (``imu_rows``) on every bucket of configs 1 and 2, float64,
  linearize and cost-only: ms per launch on the card (a CUDA graph of
  launches, ``chip_smoke.graph_ms``), ms per call (``chip_smoke.cuda_ms``)
  and the host's microseconds to enqueue one call;
- ``b5``: B5 (``evaluate_windows``) at ``chip_smoke.py``'s 4.8 M read-back
  row times, in frame order and shuffled, each kind, float64: ms per call;
- ``b3``: B3 (``cost_rows``) at every size the main path runs it (configs
  3-atan and 3-atan-lifting's 3,837 rows, config 3's 6,091, config 4's
  12,304, config 5's 500,000), float64: ms per launch on the card, ms per
  call and the host's microseconds to enqueue one call, as ``b4``;
- ``b7``: B7 (``r3_evaluate_kernel``) at ``chip_smoke.py``'s 4.8 M
  read-back row times, in frame order and shuffled, float64: ms per launch
  on the card (a CUDA graph of 10 launches) and per call;
- ``b8``: B8 (``newton_rows``) at config 4-Newton's 12,304 rows, split
  pinhole, float64, linearize and cost-only: ms per launch on the card (a
  CUDA graph of 20 launches) and ms per call; per variant the rows one
  wave of its linearize kernel holds, the operations of the function in
  one jet a stage and of the kernel's own schedule as its host row code
  counts them (an older checkout's counts the function; the bound takes
  the smaller), and its largest normwise error against the plain version
  there and on every branch's rows of ``chip_smoke.py``'s 10-knot windows
  (``newton_w10_branches``; an older checkout's B8, which took windows of
  at most 8 knots, refuses them);
- ``rates``: configs 1 and 2's 25-iteration fused solves (``chip_smoke``'s
  timed solve), it/s on the host clock, five after a warm-up each round.

A round runs the variants in order, the next round in reverse (A B, B A,
...). Prints the card's name and power limit, each variant's ``ptxas``
registers and spill, its largest normwise error against the plain version
(b4, b5, b8), every number of every round, and per variant the median and
quartiles over rounds; for b3, b7 and b8 also the operations of the
bound as each variant's own host row code (its ``host_rows.cpp``, built
beside its kernels) counts them. ``--only GLOB`` compiles only the
``.cu`` files of each variant that match (``newton_rows*.cu`` for b8), so
variants build in seconds to minutes. Needs a CUDA card and ``nvcc``; run
from anywhere:

    python3 tools/kernel_ab.py --case b5 --rounds 10 \\
        --variant shared=kontiki_tpu_torch/csrc \\
        --variant own=kontiki_tpu_torch/csrc:KT_EVAL_WARP_SHARE=0
    python3 tools/kernel_ab.py --case b8 --rounds 8 --only 'newton_rows*.cu' \\
        --variant parent=_archive/parent/kontiki_tpu_torch/csrc \\
        --variant change=kontiki_tpu_torch/csrc
"""
import argparse
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from kontiki_tpu_torch.ops import build  # noqa: E402


#: {library: the same variant's host row code (csrc/host_rows.cpp)}
HOSTS = {}


def build_variants(specs, only="*.cu"):
    """{name: library} of each ``NAME=CSRC[:DEFINES]``, compiled in parallel
    (kept under a hash of the sources and flags, and reused), each with its
    host row code beside it (``HOSTS``) for the operation counts; only the
    ``.cu`` files matching ``only`` are compiled."""
    jobs = {}
    for spec in specs:
        name, _, rest = spec.partition("=")
        csrc, _, defines = rest.partition(":")
        flags = [*build.NVCC_FLAGS, *(f"-D{d}" for d in defines.split(",") if d)]
        srcs = sorted(Path(csrc).resolve().glob("*.cu*"))
        out = build._library_path(name, [*flags, only], srcs).with_suffix("")
        out = out.parent / "ab" / out.name
        procs = []
        if not (out / "lib.so").exists():
            out.mkdir(parents=True, exist_ok=True)
            procs = [(cu, subprocess.Popen([build._nvcc(), *flags, "-c", str(cu), "-o",
                                            str(out / f"{cu.stem}.o")],
                                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                           text=True))
                     for cu in srcs if cu.suffix == ".cu" and cu.match(only)]
            host = Path(csrc).resolve() / "host_rows.cpp"
            cxx = [build.shutil.which("c++") or "g++", *build.HOST_FLAGS,
                   *(f"-D{d}" for d in defines.split(",") if d), str(host), "-o",
                   str(out / "host.so")]
            procs.append((host, subprocess.Popen(cxx, stdout=subprocess.PIPE,
                                                 stderr=subprocess.STDOUT, text=True)))
        jobs[name] = (out, procs)
    libs = {}
    for name, (out, procs) in jobs.items():
        if procs:
            log = ""
            for cu, proc in procs:
                log += proc.communicate()[0]
                if proc.returncode:
                    sys.exit(f"nvcc failed on {name} {cu.name}:\n{log}")
            subprocess.run([build._nvcc(), "-shared", *build.NVCC_FLAGS[:2],
                            *map(str, sorted(out.glob("*.o"))), "-o", str(out / "lib.so")],
                           check=True)
            (out / "ptxas.log").write_text(log)
        for kernel, regs, spill in cs.ptxas_summary((out / "ptxas.log").read_text()):
            print(f"ptxas {name} {kernel}: {regs} registers, {spill} bytes spill stores",
                  flush=True)
        libs[name] = build.bind_library(out / "lib.so")
        HOSTS[libs[name]] = build.bind_host_library(out / "host.so")
        stub_older(libs[name], HOSTS[libs[name]])
    return libs


def stub_older(lib, host):
    """Give a library built from an older checkout's sources the newer
    entries this checkout's wrappers call: B8's shared-memory need (an
    older B8 took windows of at most 8 knots, so a wider one is refused as
    needing more than any card holds) and the one-jet chain's widest
    window."""
    for suffix in ("_f32", "_f64"):
        if not hasattr(lib, "kontiki_newton_rows_smem" + suffix):
            setattr(lib, "kontiki_newton_rows_smem" + suffix,
                    lambda W0, W1, flags: 0 if max(W0, W1) <= 8 else 1 << 30)
    if not hasattr(host, "kontiki_newton_local_w"):
        host.kontiki_newton_local_w = lambda: 8


def use(lib):
    build.load_library = lambda: lib
    build.load_host_library = lambda: HOSTS[lib]


def host_us(fn, reps=200):
    """Host microseconds to enqueue one ``fn()`` (median of ``reps``)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(1e6 * (time.perf_counter() - t0))
    torch.cuda.synchronize()
    return sorted(times)[reps // 2]


def normwise(got, want):
    return max(((g - w).abs().max() / w.abs().max()).item() for g, w in zip(got, want))


def case_b4():
    from kontiki_tpu_torch.ops import linearize_kernels as lk
    from kontiki_tpu_torch.solver import kernels

    cases = {}
    for name in cs.IMU_CONFIGS:
        problem = cs.imu_problem(name)
        spec, rt = kernels.problem_spec(problem), kernels.problem_runtime(problem)
        for i, b in enumerate(spec.buckets):
            cfg, x, _ = kernels._imu_inputs(spec, b, rt, problem.state0, rt["data"][i])
            x = {k: v.to(torch.float64).contiguous() for k, v in x.items()}
            for form, cost_only in (("linearize", False), ("cost-only", True)):
                def fn(cfg=cfg, x=x, cost_only=cost_only):
                    return lk.imu_rows(cfg, x, cost_only=cost_only)

                def err(fn=fn, cfg=cfg, x=x, cost_only=cost_only):
                    got = fn()
                    want = lk.imu_rows_plain(cfg, x, cost_only=cost_only)
                    return normwise([got] if cost_only else got,
                                    [want] if cost_only else want)

                cases[f"{name} {b.kind} {form}"] = (fn, err)
    return ({f"{c} {m}": f for c, (fn, _) in cases.items() for m, f in timed(fn).items()},
            {c: err for c, (_, err) in cases.items()})


def case_b5():
    from kontiki_tpu_torch.ops import linearize_kernels as lk
    from kontiki_tpu_torch.trajectories import spline_eval as ev

    q = cs.query_setup()
    splines = {"r3": q["split"].R3_spline, "so3": q["split"].SO3_spline, "se3": q["se3"]}
    orders = {"frame order": q["ts"], "shuffled": q["ts"][q["perm"]]}
    times, errs = {}, {}
    for kind, sp in splines.items():
        knots = torch.tensor(sp.knots, device="cuda")
        for order, ts in orders.items():
            i0, u = ev.index_and_u(torch.tensor(ts, device="cuda"), sp.t0, sp.dt,
                                   knots.shape[0])
            win, u = ev.gather_windows(knots, i0).contiguous(), u.contiguous()

            def fn(kind=kind, win=win, u=u, dt=sp.dt):
                return lk.evaluate_windows(kind, win, u, dt)

            def err(fn=fn, kind=kind, win=win, u=u, dt=sp.dt, n=u.shape[0]):
                return normwise(fn(), cs.plain_chunked(lk.evaluate_windows_plain, kind, win,
                                                       u, dt, n=n))

            times[f"{kind} {order} ms per call"] = lambda fn=fn: cs.cuda_ms(fn)
            errs[f"{kind} {order}"] = err
    return times, errs


def timed(fn):
    """The three measures of ``b3`` and ``b4``: per launch on the card, per
    call, the host's enqueue."""
    return {"ms per launch": lambda: cs.graph_ms(fn), "ms per call": lambda: cs.cuda_ms(fn),
            "host us per call": lambda: host_us(fn)}


def case_b3():
    from kontiki_tpu_torch.ops import linearize_kernels as lk

    rows = {}
    for name in ("config 3-atan", "config 3-atan-lifting", "config 3", "config 4"):
        rows[name] = cs.camera_rows(cs.phase_problem(name)[1])
    big = cs.config5_problem()
    rows["config 5"] = cs.config5_camera_rows(big["problem"])
    del big
    times, errs = {}, {}
    for name, (cfg, ins) in rows.items():
        x = {k: v.to(torch.float64).contiguous() for k, v in ins.items()}
        case = f"{name} {lk.camera_branch(cfg)} M={x['u_ref'].shape[1]}"

        def fn(cfg=cfg, x=x):
            return lk.cost_rows(cfg, x)

        times.update({f"{case} {m}": f for m, f in timed(fn).items()})
        errs[case] = lambda fn=fn, cfg=cfg, x=x: normwise([fn()], [lk.cost_rows_plain(cfg, x)])
        errs[f"{case} operations"] = lambda cfg=cfg, x=x: lk.count_in_chunks(
            lambda a, b: lk.cost_rows_ops(cfg, {k: v[:, a:b].contiguous() for k, v in x.items()}),
            x["u_ref"].shape[1])
    return times, errs


def case_b7():
    from kontiki_tpu_torch.ops import spline_kernels as sk

    q = cs.query_setup()
    sp = q["split"].R3_spline
    knots = torch.tensor(sp.knots, device="cuda")
    times, errs = {}, {}
    for order, ts in (("frame order", q["ts"]), ("shuffled", q["ts"][q["perm"]])):
        t = torch.tensor(ts, device="cuda")

        def fn(t=t):
            return sk.r3_evaluate_kernel(knots, sp.t0, sp.dt, t)

        times[f"{order} ms per launch"] = lambda fn=fn: cs.graph_ms(fn, n=10)
        times[f"{order} ms per call"] = lambda fn=fn: cs.cuda_ms(fn)
        errs[order] = lambda fn=fn, t=t: normwise(
            fn(), cs.plain_chunked(sk.r3_evaluate_plain, knots, sp.t0, sp.dt, t, n=t.shape[0]))
    t = torch.tensor(q["ts"], device="cuda")
    errs["operations"] = lambda: sk.r3_evaluate_ops(knots, sp.t0, sp.dt, t)
    return times, errs


def case_b8():
    from kontiki_tpu_torch.ops import linearize_kernels as lk

    _, problem = cs.newton_problem(cs.CONFIG4_NEWTON)
    cfg, ins = cs.newton_inputs(problem)
    del problem
    x = {k: v.to(torch.float64).contiguous() for k, v in ins.items()}
    host = {k: v.cpu() for k, v in x.items()}
    M = x["u_ref"].shape[1]
    case = f"config 4-Newton {lk.newton_branch(cfg)} M={M}"
    times, errs = {}, {}
    for form, cost_only in (("linearize", False), ("cost-only", True)):
        def fn(cost_only=cost_only):
            return lk.newton_rows(cfg, x, cost_only=cost_only)

        want = lk.newton_rows_plain(cfg, x, cost_only=cost_only)
        times[f"{case} {form} ms per launch"] = lambda fn=fn: cs.graph_ms(fn, n=20)
        times[f"{case} {form} ms per call"] = lambda fn=fn: cs.cuda_ms(fn)
        errs[f"{case} {form}"] = lambda fn=fn, want=want, c=cost_only: normwise(
            [fn()] if c else fn(), [want] if c else want)
    errs[f"{case} linearize rows a wave"] = lambda: lk.newton_rows_wave(cfg)
    errs[f"{case} linearize kernels, device ms in one call (profile)"] = lambda: profile_ms(
        lambda: lk.newton_rows(cfg, x))
    errs[f"{case} linearize operations"] = lambda: lk.newton_rows_ops(cfg, host)
    errs[f"{case} linearize schedule operations"] = lambda: lk.newton_rows_ops(
        cfg, host, schedule=True)
    for branch, (c, xb) in cs.newton_w10_branches().items():
        xb = {k: v.to(torch.float64).contiguous() for k, v in xb.items()}
        want = lk.newton_rows_plain(c, xb)

        errs[f"{branch} W={max(c['Ws'])} M={xb['u_ref'].shape[1]} linearize"] = (
            lambda c=c, xb=xb, want=want: normwise(lk.newton_rows(c, xb), want))
    return times, errs


def profile_ms(fn, reps=5):
    """{kernel: device ms a call} of ``fn``'s kernels, from ``torch.profiler``
    over ``reps`` calls after a warm-up (names cut at the template)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0)
        if us:
            m = re.search(r"(\w*kernel\w*)", ev.key)
            name = m.group(1) if m else ev.key[:40]
            out[name] = round(out.get(name, 0.0) + us / 1e3 / reps, 5)
    return out


def case_rates():
    from kontiki_tpu_torch.solver.lm import make_fused_solver

    times = {}
    for name in cs.IMU_CONFIGS:
        problem = cs.imu_problem(name)

        def rate(problem=problem):
            solve = make_fused_solver(problem, 25, function_tolerance=0.0)
            solve(problem.state0)
            torch.cuda.synchronize()
            rates = []
            for _ in range(5):
                t0 = time.perf_counter()
                _, _, iters = solve(problem.state0)
                torch.cuda.synchronize()
                rates.append(iters / (time.perf_counter() - t0))
            return statistics.median(rates)

        times[f"{name} it/s"] = rate
    return times, {}


def quartiles(xs):
    xs = sorted(xs)
    if len(xs) < 2:
        return xs[0], xs[0], xs[0]
    q = statistics.quantiles(xs, n=4)
    return q[0], statistics.median(xs), q[2]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", action="append", required=True,
                    help="NAME=CSRC[:DEFINE,...]; two or more")
    ap.add_argument("--case", choices=("b3", "b4", "b5", "b7", "b8", "rates"), required=True)
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--only", default="*.cu", help="compile only the .cu files matching this")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("tools/kernel_ab.py needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(f"card: {smi.stdout.strip() or smi.stderr.strip()}", flush=True)
    libs = build_variants(args.variant, args.only)
    use(next(iter(libs.values())))
    times, errs = {"b3": case_b3, "b4": case_b4, "b5": case_b5, "b7": case_b7, "b8": case_b8,
                   "rates": case_rates}[args.case]()
    for name, lib in libs.items():
        use(lib)
        for what, err in errs.items():
            try:
                got = err()
            except (NotImplementedError, RuntimeError) as e:  # a variant that refuses
                print(f"{name} {what}: refused: {e}", flush=True)
                continue
            if what.endswith(("operations", "wave", "(profile)")):  # the variant's own figures
                print(f"{name} {what}: {got}", flush=True)
            else:
                print(f"{name} {what}: max normwise error against plain {got:.2e}", flush=True)
    got = {(v, t): [] for v in libs for t in times}
    names = list(libs)
    for r in range(args.rounds):
        for name in names if r % 2 == 0 else names[::-1]:
            use(libs[name])
            for what, fn in times.items():
                got[name, what].append(fn())
                print(f"round {r} {name} {what}: {got[name, what][-1]:.5f}", flush=True)
    for what in times:
        for name in names:
            lo, mid, hi = quartiles(got[name, what])
            print(f"summary {what} {name}: median {mid:.5f} (quartiles {lo:.5f}-{hi:.5f}, "
                  f"{args.rounds} rounds) [{smi.stdout.strip()}]", flush=True)


if __name__ == "__main__":
    main()
