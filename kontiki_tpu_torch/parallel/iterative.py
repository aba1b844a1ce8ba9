"""Measurement-sharded matrix-free iterative Schur (counterpart of
``kontiki_tpu.parallel.iterative``).

Every bucket's rows are split over the mesh (no landmark grouping: the
per-landmark sums ride the same ``psum``); each shard keeps its rows'
compressed Jacobian blocks (``solver.iterative``: kernel B1 on camera rows,
B4 on IMU rows) and every global reduction of the solve, the costs,
``g_c``, the damping diagonal, ``D``, ``g_l``, each CG matvec's scatter and
the block-Jacobi blocks, is one ``psum`` (``build_iterative_parts(spec,
psum=mesh.psum)``). The vectors PCG iterates on are then the same on every
shard, so its dots and stopping test need no reduction. Nothing quadratic
in the parameters is formed on any shard.
"""
from ..solver.iterative import build_iterative_parts
from . import padded_spec_and_runtime, shard_rows

__all__ = ["make_sharded_iterative_step", "make_sharded_iterative_solver"]


def _build(problem, mesh):
    spec, runtime = shard_rows(*padded_spec_and_runtime(problem, mesh.size), mesh)
    return runtime, build_iterative_parts(spec, psum=mesh.psum)


def make_sharded_iterative_step(problem, mesh, cg_tol=1e-10, cg_maxiter=500):
    """``step(state, lam) -> (cost, new_state, new_cost, pred, delta,
    grad_max)`` with measurement-sharded compressed linearization and
    psum-reduced matrix-free PCG, and ``total_cost(state)``."""
    runtime, parts = _build(problem, mesh)
    return (lambda state, lam: parts["step"](runtime, state, lam, cg_tol, cg_maxiter),
            lambda state: parts["total_cost"](runtime, state))


def make_sharded_iterative_solver(problem, mesh, max_iterations=50, function_tolerance=1e-6,
                                  cg_tol=1e-6, cg_maxiter=200):
    """LM with matrix-free PCG linear solves on every shard: ``solve(state)
    -> (state, final_cost, iterations)``."""
    from ..solver.lm import trust_region_loop

    runtime, parts = _build(problem, mesh)

    def solve(state):
        return trust_region_loop(
            lambda s, lam: parts["step"](runtime, s, lam, cg_tol, cg_maxiter),
            parts["total_cost"](runtime, state), state,
            max_iterations=max_iterations, function_tolerance=function_tolerance)

    return solve
