"""Bounds-aware first-order optimality (KKT) residual (counterpart of
``kontiki_tpu.solver.kkt``).

At an unconstrained stationary point the gradient vanishes; with the
reference's box bounds (rho >= 0, |time offset| <= max_time_offset, vt in
[0, 1]) the certificate is the projected gradient:

    interior component:        |g_i|
    at a lower bound:          max(-g_i, 0)   (descent would leave the box)
    at an upper bound:         max(+g_i, 0)
    locked / padded parameter: 0

A solve that ends at a point whose KKT residual is tiny next to the initial
gradient is stationary; a wrong Jacobian block or Hessian column fails it
even where the trajectory error looks plausible.
"""
import numpy as np

from .kernels import build_parts, problem_runtime, problem_spec
from .problem import SENSOR_TANGENT_DIM


def kkt_residual(problem, state, *, bound_eps=1e-12):
    """Infinity norm of the bounds-projected gradient at ``state``.

    ``problem`` is a ``Problem`` or ``RawProblem``; ``state`` a solver state
    (``problem.state0`` or a solve's result), on the problem's device. The
    gradient is the dense linearization's (``kernels.build_parts``);
    locked parameters (mask 0) count 0, as Ceres leaves constant blocks out
    of its gradient-norm test. Returns a float."""
    spec = problem_spec(problem)
    runtime = problem_runtime(problem)
    _, _, g = build_parts(spec)["linearize"](runtime, state)
    g = g.detach().cpu().numpy().astype(np.float64)
    mask = runtime["mask"].detach().cpu().numpy().astype(np.float64)
    pg = np.abs(g) * mask

    def host(x):
        return x.detach().cpu().numpy().astype(np.float64)

    def at_bound(idx, lower_active, upper_active):
        """Replace |g| with the one-sided violation on bounded coordinates."""
        gi = g[idx]
        vi = np.abs(gi)
        vi = np.where(lower_active, np.maximum(-gi, 0.0), vi)
        vi = np.where(upper_active, np.maximum(gi, 0.0), vi)
        # both bounds active (a degenerate box, d_max == 0): the feasible set
        # is a point, with no first-order condition to violate
        vi = np.where(lower_active & upper_active, 0.0, vi)
        pg[idx] = vi * mask[idx]

    S, L, V = spec.num_sensors, spec.num_landmarks, spec.num_vt
    if S:
        d, d_max = host(state["d"]), host(runtime["d_max"])
        idx = spec.sensor_offset + np.arange(S) * SENSOR_TANGENT_DIM + 6
        at_bound(idx, d <= -d_max + bound_eps, d >= d_max - bound_eps)
    if L:
        rho = host(state["rho"])
        at_bound(spec.landmark_offset + np.arange(L), rho <= bound_eps, np.zeros(L, dtype=bool))
    if V:
        vt = host(state["vt"])
        at_bound(spec.vt_offset + np.arange(V), vt <= bound_eps, vt >= 1.0 - bound_eps)
    return float(np.max(pg)) if pg.size else 0.0
