"""Levenberg-Marquardt trust-region loop (counterpart of
``kontiki_tpu.solver.lm.make_fused_solver``, Schur strategy).

The policy follows Ceres's LevenbergMarquardtStrategy: radius ``mu`` with
damping ``1/mu * diag(JtJ)`` (diagonal clamped to [1e-6, 1e32]), accept
when the relative decrease exceeds 1e-3, radius update
``mu / max(1/3, 1 - (2*rho - 1)^3)`` on success, and division by an
escalating factor on failure. The loop carries the linearization at the
current state and linearizes each candidate in full, so an accepted
iteration streams the measurement data once.

The body is branch-free on the device (``torch.where`` selects, as the JAX
``lax.while_loop`` body); the host reads ``done`` once per iteration.
"""
import torch

from .kernels import problem_runtime, problem_spec
from .schur import build_schur_parts


def _resolve_strategy(problem, strategy):
    """'auto' eliminates landmarks whenever there are any (Ceres
    SPARSE_SCHUR); only the Schur strategy is ported."""
    if strategy == "auto":
        strategy = "schur" if len(problem.landmarks) else "dense"
    if strategy != "schur":
        raise NotImplementedError(f"strategy {strategy!r} is not ported")
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


def trust_region_loop_spec(step_spec, lin0, state, *, max_iterations,
                           function_tolerance):
    """Speculative-linearization LM loop.

    ``step_spec(state, lin, lam) -> (new_state, new_lin, pred)`` and
    ``lin0`` is the linearization at ``state`` with ``lin0[0]`` its cost.
    Returns ``(state, final_cost, iterations_run)``; the iterate sequence is
    the JAX loop's."""
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
        state = {k: torch.where(ok, new_state[k], v) for k, v in state.items()}
        lin = tuple(torch.where(ok, b, a) for a, b in zip(lin, new_lin))
        it += 1
        if bool(done):
            break
    return state, lin[0], it


def make_fused_solver(problem, max_iterations=50, function_tolerance=1e-6,
                      strategy="auto"):
    """LM solver over ``problem``'s device tensors, without callbacks.

    Returns ``solve(state) -> (state, final_cost, iterations_run)``."""
    _resolve_strategy(problem, strategy)
    spec = problem_spec(problem)
    runtime = problem_runtime(problem)
    parts = build_schur_parts(spec)

    def solve(state):
        return trust_region_loop_spec(
            lambda s, lin, lam: parts["step_spec"](runtime, s, lin, lam),
            parts["linearize"](runtime, state), state,
            max_iterations=max_iterations,
            function_tolerance=function_tolerance,
        )

    return solve
