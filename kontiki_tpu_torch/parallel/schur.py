"""Landmark-block sharding of the Schur elimination (counterpart of
``kontiki_tpu.parallel.schur``).

Each shard owns a contiguous block of ``Lb = ceil(L / n)`` landmarks, and
every camera row lives on the shard owning its landmark (rows regrouped by
owner, each shard's count padded to the largest with ``valid = 0`` rows);
the other buckets are measurement-sharded. A shard linearizes its rows
through the port's Schur parts in their landmark-block form
(``solver.schur.build_schur_parts(spec, local_L=Lb, shard=s,
psum=mesh.psum, allgather=mesh.allgather, pmax=mesh.pmax)``: kernel B1 on
the camera rows, B2 assembling ``H_cc, g_c`` and the shard's ``E [Lb, Pc],
D, g_l``).
``(cost, H_cc, g_c)`` are summed over the shards; the landmark blocks never
leave their shard. The damped solve sums the shards' ``E^T D^-1 E`` and
``E^T D^-1 g_l`` ([Pc, Pc] and [Pc]), solves the reduced system on every
shard and back-substitutes each shard's landmarks locally; their steps are
gathered into the replicated state. The step is projected to the bounds
as on one device (rho, the time offsets, vt; the JAX package's sharded
step projects rho only, which differs in the predicted decrease alone, and
only where a step crosses another bound).
"""
import math

import numpy as np
import torch

from ..solver.kernels import problem_runtime, problem_spec
from ..solver.schur import build_schur_parts
from . import _pad_rows, shard_rows

__all__ = ["make_sharded_schur_functions", "make_sharded_schur_step",
           "make_sharded_schur_solver"]


def _schur_padded_layout(problem, n_shards):
    """Pad the landmark axis to a multiple of ``n_shards`` and regroup the
    camera rows by owning shard. Returns ``(spec, runtime, layout)``."""
    spec = problem_spec(problem)
    runtime = problem_runtime(problem)
    L = spec.num_landmarks
    if L == 0:
        raise ValueError("sharded Schur requires landmarks; use the dense path")
    n = n_shards
    Lb = max(1, math.ceil(L / n))
    L_pad = Lb * n
    pad_L = L_pad - L
    lo = spec.landmark_offset
    dev = problem.mask.device
    new_buckets, new_data = [], []
    for bspec, data in zip(spec.buckets, runtime["data"]):
        M = bspec.M
        if "lid" in data:
            # landmark-owned rows: grouped by owner, equal rows per shard
            owner = data["lid"].cpu().numpy() // Lb
            M_per = max(int(np.bincount(owner, minlength=n).max()), 1)
            idx = np.zeros(n * M_per, dtype=np.int64)
            valid = np.zeros(n * M_per)
            for s in range(n):
                rows = np.nonzero(owner == s)[0]
                idx[s * M_per: s * M_per + len(rows)] = rows
                valid[s * M_per: s * M_per + len(rows)] = 1.0
            idx_t = torch.as_tensor(idx, device=dev)
            d = {k: v[idx_t] for k, v in data.items()}
            valid = torch.as_tensor(valid, device=dev)
            # inert pad rows: any id in range both globally (the rho gather)
            # and locally (the E scatter)
            d["lid"] = torch.where(valid > 0, d["lid"], 0)
            d["lid_local"] = torch.where(
                valid > 0, d["lid"] - torch.as_tensor(owner[idx], device=dev) * Lb, 0)
            M_pad = n * M_per
        else:
            M_pad = max(-(-M // n) * n, n)
            d = {k: _pad_rows(v, M_pad) for k, v in data.items()}
            valid = torch.ones(M_pad, device=dev)
            valid[M:] = 0.0
        d["valid"] = valid.to(problem.mask.dtype)
        new_data.append(d)
        new_buckets.append(bspec._replace(M=M_pad))
    mask = runtime["mask"]
    mask_pad = torch.cat([mask[:lo + L], torch.zeros(pad_L, dtype=mask.dtype, device=dev),
                          mask[lo + L:]])
    spec = spec._replace(buckets=tuple(new_buckets), num_landmarks=L_pad,
                         vt_offset=spec.vt_offset + pad_L,
                         num_tangent=spec.num_tangent + pad_L)
    runtime["data"] = new_data
    runtime["mask"] = mask_pad
    runtime["mask_l"] = mask_pad[lo:lo + L_pad]
    return spec, runtime, dict(L=L, L_pad=L_pad, Lb=Lb, pad_L=pad_L, lo=lo, n=n)


def _pad_state(state, layout):
    s = dict(state)
    if layout["pad_L"]:
        rho = s["rho"]
        s["rho"] = torch.cat([rho, torch.ones(layout["pad_L"], dtype=rho.dtype,
                                              device=rho.device)])
    return s


def _unpad_state(state, layout):
    s = dict(state)
    s["rho"] = s["rho"][:layout["L"]]
    return s


def _unpad_delta(delta, layout):
    lo, L, L_pad = layout["lo"], layout["L"], layout["L_pad"]
    return torch.cat([delta[:lo + L], delta[lo + L_pad:]])


def make_sharded_schur_functions(problem, mesh):
    """Landmark-block-sharded Schur parts on this shard: ``(cost_fn,
    lin_fn, solve_fn, retract_fn, layout, runtime, parts)``.
    ``lin_fn(state_pad) -> (cost, H_cc, g_c, E, D, g_l)`` with ``(cost,
    H_cc, g_c)`` summed over the shards and ``E [Lb, Pc], D, g_l`` this
    shard's landmark block; ``solve_fn(H_cc, g_c, E, D, g_l, lam, state) ->
    delta`` (global, padded); ``parts`` are ``solver.schur``'s on this
    shard's rows with the mesh's ``psum`` and ``allgather``, ``runtime``
    those rows; states are padded (``L_pad`` landmarks)."""
    s = mesh.axis_index()
    spec, runtime, layout = _schur_padded_layout(problem, mesh.size)
    Lb = layout["Lb"]
    spec_r, rt = shard_rows(spec, runtime, mesh)
    rt["mask_l"] = runtime["mask_l"][s * Lb:(s + 1) * Lb]
    parts = build_schur_parts(spec_r, local_L=Lb, shard=s, psum=mesh.psum,
                              allgather=mesh.allgather, pmax=mesh.pmax)
    return (lambda state: parts["total_cost"](rt, state),
            lambda state: parts["linearize"](rt, state),
            lambda H_cc, g_c, E, D, g_l, lam, state=None: parts["schur_solve"](
                rt, H_cc, g_c, E, D, g_l, lam, state=state),
            lambda state, delta: parts["retract"](rt, state, delta),
            layout, rt, parts)


def _step_fn(problem, mesh):
    """One LM step on padded states: ``step(state, lam) -> (cost,
    new_state, new_cost, pred, delta, grad_max)``, the delta projected to
    the bounded retraction's increment; and the padded ``total_cost``."""
    cost_fn, _, _, _, layout, rt, parts = make_sharded_schur_functions(problem, mesh)
    return (lambda state, lam: parts["step"](rt, state, lam)), cost_fn, layout


def make_sharded_schur_step(problem, mesh):
    """``step(state, lam) -> (cost, new_state, new_cost, pred, delta,
    grad_max)`` with landmark-block-sharded Schur elimination (unpadded
    states and deltas in and out, the same on every shard), and
    ``total_cost(state)``."""
    one_step, cost_fn, layout = _step_fn(problem, mesh)

    def step(state, lam):
        cost, new_state, new_cost, pred, delta, grad_max = one_step(
            _pad_state(state, layout), lam)
        return (cost, _unpad_state(new_state, layout), new_cost, pred,
                _unpad_delta(delta, layout), grad_max)

    return step, lambda state: cost_fn(_pad_state(state, layout))


def make_sharded_schur_solver(problem, mesh, max_iterations=50, function_tolerance=1e-6):
    """LM with landmark-block-sharded Schur elimination on every shard:
    ``solve(state) -> (state, final_cost, iterations)``."""
    from ..solver.lm import trust_region_loop

    one_step, cost_fn, layout = _step_fn(problem, mesh)

    def solve(state):
        st = _pad_state(state, layout)
        st, cost, it = trust_region_loop(one_step, cost_fn(st), st,
                                         max_iterations=max_iterations,
                                         function_tolerance=function_tolerance)
        return _unpad_state(st, layout), cost, it

    return solve
