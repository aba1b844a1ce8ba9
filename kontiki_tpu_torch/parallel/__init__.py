"""Scale-out over a process-group mesh (counterpart of
``kontiki_tpu.parallel``): each shard is one process of a
``torch.distributed`` group (``parallel.mesh.Mesh``; ``parallel.launch.
run_spmd`` starts ``n`` of them on one host, ``parallel.distributed``
joins a multi-host job), and the JAX package's collectives inside
``shard_map`` are the mesh's ``psum``, ``pmax``, ``ppermute`` and
``axis_index``. The layouts:

- **measurement sharding** (this module): every bucket's rows are split
  over the shards, padded to a multiple of the shard count with ``valid =
  0`` rows that repeat row 0; each shard linearizes its rows through the
  dense parts (kernels B1 on camera rows, B4 on IMU rows) and one ``psum``
  reduces ``(cost, H, g)``; the damped solve runs replicated;
- **landmark-block sharding** (``parallel.schur``): camera rows go to the
  shard owning their landmark's block, ``E, D, g_l`` stay there (B1, B2
  per shard), ``(cost, H_cc, g_c)`` and ``E^T D^-1 E`` are summed;
- **measurement-sharded matrix-free PCG** (``parallel.iterative``);
- **knot segments** (``parallel.segments``, trajectory-only problems) with
  the distributed SPIKE band solve (``solver.banded``);
- **knot segments x landmark blocks** (``parallel.segments_ba``, BASELINE
  config 5), banded with SPIKE or PCG.

Every function takes the mesh in place of the JAX package's; a one-shard
``Mesh()`` runs the same code in one process, its collectives identities.
States in and out are global and the same on every shard.
"""
import torch

from ..solver.kernels import build_parts, damped_solve, problem_runtime, problem_spec
from .mesh import MEASUREMENT_AXIS, Mesh

__all__ = [
    "MEASUREMENT_AXIS",
    "Mesh",
    "padded_spec_and_runtime",
    "make_sharded_functions",
    "make_sharded_step",
    "make_sharded_solver",
]


def _pad_rows(arr, target):
    """Pad the leading axis to ``target`` rows by repeating row 0 (indices,
    times and camera intrinsics of padded rows stay well formed)."""
    pad = target - arr.shape[0]
    if pad <= 0:
        return arr
    return torch.cat([arr, arr[:1].expand(pad, *arr.shape[1:])])


def padded_spec_and_runtime(problem, n_shards):
    """The problem's spec and runtime with every bucket padded to a
    multiple of ``n_shards`` rows and a ``valid`` column added."""
    spec = problem_spec(problem)
    runtime = problem_runtime(problem)
    new_buckets, new_data = [], []
    for bspec, data in zip(spec.buckets, runtime["data"]):
        M = bspec.M
        M_pad = max(-(-M // n_shards) * n_shards, n_shards)
        d = {k: _pad_rows(v, M_pad) for k, v in data.items()}
        valid = torch.ones(M_pad, dtype=problem.mask.dtype, device=problem.mask.device)
        valid[M:] = 0.0
        d["valid"] = valid
        new_data.append(d)
        new_buckets.append(bspec._replace(M=M_pad))
    runtime["data"] = new_data
    return spec._replace(buckets=tuple(new_buckets)), runtime


def shard_rows(spec, runtime, mesh):
    """This shard's rows of a padded spec and runtime (each bucket's
    ``M / n`` consecutive rows)."""
    n, s = mesh.size, mesh.axis_index()
    buckets = tuple(b._replace(M=b.M // n) for b in spec.buckets)
    rt = dict(runtime)
    rt["data"] = [{k: v[s * b.M:(s + 1) * b.M] for k, v in d.items()}
                  for b, d in zip(buckets, runtime["data"])]
    return spec._replace(buckets=buckets), rt


def make_sharded_functions(problem, mesh):
    """``(cost_fn(state), linearize_fn(state) -> (cost, H, g), parts,
    runtime)`` with the rows sharded over ``mesh`` and the results summed
    (the same on every shard); ``runtime`` holds this shard's rows."""
    spec, runtime = shard_rows(*padded_spec_and_runtime(problem, mesh.size), mesh)
    parts = build_parts(spec)

    def cost_fn(state):
        return mesh.psum(parts["total_cost"](runtime, state))

    def lin_fn(state):
        return tuple(mesh.psum(list(parts["linearize"](runtime, state))))

    return cost_fn, lin_fn, parts, runtime


def _dense_step(lin_fn, cost_fn, parts, runtime):
    def step(state, lam):
        cost, H, g = lin_fn(state)
        delta = damped_solve(runtime["mask"], H, g, lam)
        new_state = parts["retract"](runtime, state, delta)
        new_cost = cost_fn(new_state)
        pred = -(g @ delta + 0.5 * delta @ (H @ delta))
        grad_max = g.abs().max() if g.numel() else torch.zeros((), dtype=g.dtype)
        return cost, new_state, new_cost, pred, delta, grad_max

    return step


def make_sharded_step(problem, mesh):
    """``step(state, lam) -> (cost, new_state, new_cost, pred, delta,
    grad_max)`` with measurement-sharded linearization (the damped solve
    replicated), and ``total_cost(state)``."""
    cost_fn, lin_fn, parts, runtime = make_sharded_functions(problem, mesh)
    return _dense_step(lin_fn, cost_fn, parts, runtime), cost_fn


def make_sharded_solver(problem, mesh, max_iterations=50, function_tolerance=1e-6):
    """LM with measurement-sharded linearization on every shard: ``solve(
    state) -> (state, final_cost, iterations)``."""
    from ..solver.lm import trust_region_loop

    cost_fn, lin_fn, parts, runtime = make_sharded_functions(problem, mesh)
    step = _dense_step(lin_fn, cost_fn, parts, runtime)

    def solve(state):
        return trust_region_loop(step, cost_fn(state), state, max_iterations=max_iterations,
                                 function_tolerance=function_tolerance)

    return solve


# the other layouts (imported last: they use the helpers above)
from . import distributed  # noqa: E402
from .iterative import make_sharded_iterative_solver, make_sharded_iterative_step  # noqa: E402
from .schur import (  # noqa: E402
    make_sharded_schur_functions,
    make_sharded_schur_solver,
    make_sharded_schur_step,
)
from .segments import make_segment_sharded_solver, make_segment_sharded_step  # noqa: E402
from .segments_ba import (  # noqa: E402
    make_segment_ba_solver,
    make_segment_ba_step,
    segment_ba_layout,
)

__all__ += [
    "distributed",
    "make_sharded_schur_functions", "make_sharded_schur_step", "make_sharded_schur_solver",
    "make_sharded_iterative_step", "make_sharded_iterative_solver",
    "make_segment_sharded_step", "make_segment_sharded_solver",
    "make_segment_ba_step", "make_segment_ba_solver", "segment_ba_layout",
]
