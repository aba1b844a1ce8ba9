"""Levenberg-Marquardt trust-region loops (counterpart of
``kontiki_tpu.solver.lm``: the dense, Schur, iterative-Schur and banded
strategies).

The policy follows Ceres's LevenbergMarquardtStrategy: radius ``mu`` with
damping ``1/mu * diag(JtJ)`` (diagonal clamped to [1e-6, 1e32]), accept
when the relative decrease exceeds 1e-3, radius update
``mu / max(1/3, 1 - (2*rho - 1)^3)`` on success, and division by an
escalating factor on failure. Three loops use it:

- ``solve`` (``TrajectoryEstimator.solve``) runs the three phases Ceres
  reports (linearize, linear solve, retract + residual-only re-cost) one
  after another and takes each decision on the host, so iteration callbacks
  fire and the Summary carries per-phase wall times;
- ``trust_region_loop_spec`` (Schur, iterative Schur and banded, fused)
  carries the linearization at the current state and linearizes each
  candidate in full, so an accepted iteration streams the measurement data
  once;
- ``trust_region_loop`` (dense, fused) linearizes, solves and re-costs the
  candidate with the residual-only pass.

The fused loops take the policy on the device (``trust_region_update``,
branch-free ``torch.where`` selects, as the JAX ``lax.while_loop`` bodies)
and read ``done`` once per iteration; ``solve`` takes it on host floats, as
the JAX ``solve`` does.
"""
import contextlib
import math
import os
import time

import torch

from .._ceres import CallbackReturnType, IterationSummary, Summary, TerminationType
from .banded import build_banded_parts
from .iterative import build_iterative_parts
from .kernels import build_parts, problem_runtime, problem_spec
from .schur import build_schur_parts

#: the linear-solver strategies besides 'auto'
STRATEGIES = ("dense", "schur", "iterative_schur", "banded")


def _resolve_strategy(problem, strategy):
    """'auto' eliminates landmarks whenever there are any (Ceres
    SPARSE_SCHUR) and is dense otherwise; 'iterative_schur' (matrix-free
    PCG) and 'banded' (the block-tridiagonal solve) are taken only by name.
    Another name raises ``ValueError``."""
    if strategy == "auto":
        strategy = "schur" if len(problem.landmarks) else "dense"
    if strategy not in STRATEGIES:
        raise ValueError(f"strategy must be 'auto' or one of {STRATEGIES}, got {strategy!r}")
    return strategy


def trust_region_update(cost, new_cost, pred, mu, dec, *, function_tolerance,
                        min_relative_decrease=1e-3,
                        max_trust_region_radius=1e16):
    """One accept/reject decision and radius update, all device tensors.

    Returns ``(ok, mu, dec, done)``: ``ok`` accepts the step, ``done`` means
    it was accepted with ``|cost - new_cost| <= function_tolerance * cost``."""
    rel = torch.where(pred > 0, (cost - new_cost) / pred, -1.0)
    ok = torch.isfinite(new_cost) & (rel > min_relative_decrease)
    mu_ok = mu / torch.clamp(1.0 - (2.0 * rel - 1.0) ** 3, min=1.0 / 3.0)
    mu = torch.where(ok, torch.clamp(mu_ok, max=max_trust_region_radius), mu / dec)
    dec = torch.where(ok, 2.0, dec * 2.0)
    done = ok & (torch.abs(cost - new_cost) <= function_tolerance * cost)
    return ok, mu, dec, done


def _select(ok, a, b):
    """``b`` where ``ok`` else ``a``, leaf by leaf over nested dicts, tuples
    and lists of tensors (``torch.where``, no host read)."""
    if isinstance(a, dict):
        return {k: _select(ok, a[k], b[k]) for k in a}
    if isinstance(a, (tuple, list)):
        return type(a)(_select(ok, x, y) for x, y in zip(a, b))
    return torch.where(ok, b, a)


def trust_region_loop(one_step, cost0, state, *, max_iterations,
                      function_tolerance):
    """Classic LM loop. ``one_step(state, lam)`` returns ``(cost, new_state,
    new_cost, pred, ...)``: the cost at ``state``, the candidate, its cost
    and the predicted reduction. Returns ``(state, final_cost,
    iterations_run)``; the iterate sequence is the JAX loop's."""
    cost = cost0
    mu = torch.full_like(cost0, 1e4)
    dec = torch.full_like(cost0, 2.0)
    it = 0
    while it < max_iterations:
        cost_i, new_state, new_cost, pred = one_step(state, 1.0 / mu)[:4]
        ok, mu, dec, done = trust_region_update(
            cost_i, new_cost, pred, mu, dec,
            function_tolerance=function_tolerance,
        )
        state = {k: torch.where(ok, new_state[k], v) for k, v in state.items()}
        cost = torch.where(ok, new_cost, cost_i)
        it += 1
        if bool(done):
            break
    return state, cost, it


def trust_region_loop_spec(step_spec, lin0, state, *, max_iterations,
                           function_tolerance):
    """Speculative-linearization LM loop.

    ``step_spec(state, lin, lam) -> (new_state, new_lin, pred)`` and
    ``lin0`` is the linearization at ``state`` with ``lin0[0]`` its cost;
    the rest of ``lin`` may nest dicts and tuples of tensors (the banded
    segment-BA step carries ``(cost, assembly dict, mask_l)``). Returns
    ``(state, final_cost, iterations_run)``; the iterate sequence is the
    JAX loop's."""
    lin = lin0
    mu = torch.full_like(lin[0], 1e4)
    dec = torch.full_like(lin[0], 2.0)
    it = 0
    while it < max_iterations:
        cost = lin[0]
        new_state, new_lin, pred = step_spec(state, lin, 1.0 / mu)
        ok, mu, dec, done = trust_region_update(
            cost, new_lin[0], pred, mu, dec,
            function_tolerance=function_tolerance,
        )
        state = _select(ok, state, new_state)
        lin = _select(ok, lin, new_lin)
        it += 1
        if bool(done):
            break
    return state, lin[0], it


def make_fused_solver(problem, max_iterations=50, function_tolerance=1e-6,
                      strategy="auto", cg_tol=1e-10, cg_maxiter=500):
    """LM solver over ``problem``'s device tensors, without callbacks.

    Returns ``solve(state) -> (state, final_cost, iterations_run)``. The
    dense strategy runs the classic loop (its re-cost is B4's cheap
    residual-only pass); Schur, iterative Schur and banded run the
    speculative one, as in the JAX package. ``cg_tol`` and ``cg_maxiter``
    are the iterative strategy's PCG stopping rule."""
    strategy = _resolve_strategy(problem, strategy)
    spec = problem_spec(problem)
    runtime = problem_runtime(problem)
    if strategy == "dense":
        dense = build_parts(spec)

        def solve_dense(state):
            return trust_region_loop(
                lambda s, lam: dense["step"](runtime, s, lam),
                dense["total_cost"](runtime, state), state,
                max_iterations=max_iterations,
                function_tolerance=function_tolerance,
            )

        return solve_dense
    build = {"schur": build_schur_parts, "iterative_schur": build_iterative_parts,
             "banded": build_banded_parts}[strategy]
    parts = build(spec)
    cg = dict(cg_tol=cg_tol, cg_maxiter=cg_maxiter) if strategy == "iterative_schur" else {}

    def solve(state):
        return trust_region_loop_spec(
            lambda s, lin, lam: parts["step_spec"](runtime, s, lin, lam, **cg),
            parts["linearize"](runtime, state), state,
            max_iterations=max_iterations,
            function_tolerance=function_tolerance,
        )

    return solve


# ---------------------------------------------------------------------------
# the phase-split solve with callbacks (TrajectoryEstimator.solve)
# ---------------------------------------------------------------------------

def _make_phases(problem, strategy, cg_tol=1e-10, cg_maxiter=500):
    """Per-phase solver functions, for the Summary's per-phase times
    (the reference's py_ceres.cc): ``linearize(state) -> (cost, lin_out)``
    [jacobian evaluation], ``solve(lin_out, lam, state) -> (delta, pred,
    grad_max)`` [linear solver], and ``retract`` / ``cost`` [residual
    evaluation]. The iterative and banded strategies linearize into the
    compressed row blocks."""
    strategy = _resolve_strategy(problem, strategy)
    spec = problem_spec(problem)
    runtime = problem_runtime(problem)

    if strategy == "schur":
        parts = build_schur_parts(spec)

        def linearize(state):
            cost, *lin_out = parts["linearize"](runtime, state)
            return cost, lin_out

        def solve_phase(lin_out, lam, state):
            H_cc, g_c, E, D, g_l = lin_out
            delta, pred = parts["solve_from_lin"](runtime, state, H_cc, g_c, E, D, g_l, lam)
            return delta, pred, parts["grad_max"](g_c, g_l)

    elif strategy in ("iterative_schur", "banded"):
        if strategy == "banded":
            parts = build_banded_parts(spec)
            solve_with_pred = parts["solve_with_pred"]
        else:
            parts = build_iterative_parts(spec)

            def solve_with_pred(rt, blocks, lam, state):
                return parts["solve_with_pred"](rt, blocks, lam, cg_tol, cg_maxiter, state=state)

        def linearize(state):
            return parts["linearize"](runtime, state)

        def solve_phase(blocks, lam, state):
            return solve_with_pred(runtime, blocks, lam, state)

    else:
        parts = build_parts(spec)

        def linearize(state):
            cost, H, g = parts["linearize"](runtime, state)
            return cost, (H, g)

        def solve_phase(lin_out, lam, state):
            H, g = lin_out
            delta, pred = parts["solve_from_lin"](runtime, state, H, g, lam)
            return delta, pred, parts["grad_max"](state, g)

    return dict(
        linearize=linearize,
        solve=solve_phase,
        retract=lambda state, delta: parts["retract"](runtime, state, delta),
        cost=lambda state: parts["total_cost"](runtime, state),
    )


def _profiler(trace_dir, device):
    """A ``torch.profiler`` context that writes a Chrome trace into
    ``trace_dir`` when it closes (CPU activity, and the card's when the
    problem lies on one)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)

    def write(prof):
        prof.export_chrome_trace(os.path.join(trace_dir, f"kontiki_trace_{os.getpid()}.json"))

    return profile(activities=activities, on_trace_ready=write)


def solve(
    problem,
    max_iterations=50,
    progress=False,
    callbacks=(),
    callback_needs_state=False,
    function_tolerance=1e-6,
    gradient_tolerance=1e-10,
    min_relative_decrease=1e-3,
    initial_trust_region_radius=1e4,
    max_trust_region_radius=1e16,
    min_trust_region_radius=1e-32,
    strategy="auto",
    trace_dir=None,
):
    """Run LM on a compiled problem, the three phases one after another
    with the accept/reject decision on the host. Returns (final_state,
    Summary).

    After each iteration the callbacks get its ``IterationSummary`` (with
    ``callback_needs_state``, the problem's objects hold the current state
    first); ``Abort`` ends the solve as ``UserFailure``,
    ``TerminateSuccessfully`` as ``UserSuccess``. Then, on a successful
    step, the function tolerance and the gradient tolerance are tested, and
    last the minimum trust-region radius. Each phase's wall time ends with
    the host read of its result (``.item()``). ``trace_dir`` records a
    ``torch.profiler`` trace of the whole solve there, each phase under
    ``record_function("kontiki/jacobian" | "kontiki/linear_solver" |
    "kontiki/residual")``."""
    t_start = time.time()
    summary = Summary()
    for name in ("num_parameters", "num_parameter_blocks", "num_parameters_reduced",
                 "num_parameter_blocks_reduced", "num_residuals", "num_residual_blocks",
                 "num_residuals_reduced", "num_residual_blocks_reduced"):
        setattr(summary, name, getattr(problem, name))

    state = problem.state0
    if problem.num_residual_blocks == 0 or problem.num_parameter_blocks_reduced == 0:
        # Nothing to optimize; mirror Ceres's trivial convergence.
        summary.termination_type = TerminationType.Convergence
        summary.message = "Problem is empty or fully constant."
        summary.total_time_in_seconds = time.time() - t_start
        return state, summary

    phases = _make_phases(problem, strategy)
    t_jacobian = t_linear = t_residual = 0.0
    trace = _profiler(trace_dir, problem.device) if trace_dir else contextlib.nullcontext()

    def annotate(name):
        if not trace_dir:
            return contextlib.nullcontext()
        return torch.profiler.record_function(name)

    mu = initial_trust_region_radius
    decrease_factor = 2.0

    def run_callbacks(it_summary):
        if callback_needs_state:
            problem.write_back(state)
        for cb in callbacks:
            ret = cb(it_summary)
            if ret == CallbackReturnType.Abort:
                return TerminationType.UserFailure
            if ret == CallbackReturnType.TerminateSuccessfully:
                return TerminationType.UserSuccess
        return None

    termination = None
    message = ""
    cost = None
    t_min_start = time.time()
    with trace:
        for iteration in range(max_iterations):
            it_t0 = time.time()
            lam = 1.0 / mu

            # Phase 1: residual + Jacobian evaluation (Ceres jacobian phase).
            with annotate("kontiki/jacobian"):
                cost_i, lin_out = phases["linearize"](state)
                cost_i = cost_i.item()
            t_jacobian += time.time() - it_t0

            # Phase 2: damped (Schur) linear solve.
            t1 = time.time()
            with annotate("kontiki/linear_solver"):
                delta, pred, grad_max = phases["solve"](lin_out, lam, state)
                pred_f = pred.item()
                grad_max_f = grad_max.item()
                step_norm = torch.linalg.vector_norm(delta).item()
            t_linear += time.time() - t1

            # Phase 3: retraction + re-cost (Ceres residual phase).
            t2 = time.time()
            with annotate("kontiki/residual"):
                new_state = phases["retract"](state, delta)
                new_cost_f = phases["cost"](new_state).item()
            t_residual += time.time() - t2

            if cost is None:
                cost = cost_i
                summary.initial_cost = cost_i
                it0 = IterationSummary(
                    iteration=0,
                    cost=cost_i,
                    cost_change=0.0,
                    gradient_max_norm=grad_max_f,
                    trust_region_radius=mu,
                    iteration_time_in_seconds=0.0,
                    cumulative_time_in_seconds=time.time() - t_start,
                )
                summary.iterations.append(it0)
                termination = run_callbacks(it0)
                if termination is not None:
                    message = "Terminated by user callback."
                    break

            relative_decrease = (cost_i - new_cost_f) / pred_f if pred_f > 0 else -1.0
            step_successful = (math.isfinite(new_cost_f)
                               and relative_decrease > min_relative_decrease)
            if step_successful:
                cost_change = cost_i - new_cost_f
                state = new_state
                mu = mu / max(1.0 / 3.0, 1.0 - (2.0 * relative_decrease - 1.0) ** 3)
                mu = min(mu, max_trust_region_radius)
                decrease_factor = 2.0
                summary.num_successful_steps += 1
                cost = new_cost_f
            else:
                cost_change = 0.0
                mu = mu / decrease_factor
                decrease_factor *= 2.0
                summary.num_unsuccessful_steps += 1

            it_summary = IterationSummary(
                iteration=iteration + 1,
                step_is_valid=math.isfinite(new_cost_f),
                step_is_successful=step_successful,
                cost=cost,
                cost_change=cost_change,
                gradient_max_norm=grad_max_f,
                step_norm=step_norm,
                relative_decrease=relative_decrease,
                trust_region_radius=mu,
                iteration_time_in_seconds=time.time() - it_t0,
                cumulative_time_in_seconds=time.time() - t_start,
            )
            summary.iterations.append(it_summary)
            if progress:
                print(
                    f"iter {iteration + 1:3d}  cost {cost:.6e}  "
                    f"change {cost_change:.3e}  |g| {grad_max_f:.3e}  "
                    f"tr {mu:.1e}  {'ok' if step_successful else 'reject'}"
                )

            termination = run_callbacks(it_summary)
            if termination is not None:
                message = "Terminated by user callback."
                break
            if step_successful:
                if abs(cost_change) <= function_tolerance * cost_i:
                    termination = TerminationType.Convergence
                    message = (
                        f"Function tolerance reached: |dc| = {abs(cost_change):.3e} "
                        f"<= {function_tolerance} * {cost_i:.3e}"
                    )
                    break
                if grad_max_f <= gradient_tolerance:
                    termination = TerminationType.Convergence
                    message = f"Gradient tolerance reached: {grad_max_f:.3e}"
                    break
            if mu < min_trust_region_radius:
                termination = TerminationType.Convergence
                message = "Trust region radius below minimum."
                break

    if termination is None:
        termination = TerminationType.NoConvergence
        message = f"Maximum number of iterations reached ({max_iterations})."
    summary.termination_type = termination
    summary.message = message
    summary.final_cost = cost if cost is not None else 0.0
    summary.minimizer_time_in_seconds = time.time() - t_min_start
    summary.total_time_in_seconds = time.time() - t_start
    summary.jacobian_evaluation_time_in_seconds = t_jacobian
    summary.linear_solver_time_in_seconds = t_linear
    summary.residual_evaluation_time_in_seconds = t_residual
    return state, summary
