"""Schur elimination of landmarks (counterpart of
``kontiki_tpu.solver.schur``; Ceres SPARSE_SCHUR analogue).

Each landmark's scalar inverse depth couples to the rest of the state only
through its own observations, so the landmark block of the Hessian is
diagonal and its elimination is exact and parallel:

    [H_cc  E^T] [dc]   [-g_c]
    [E     D  ] [dl] = [-g_l]

    S  = H_cc - E^T D^-1 E ,   dc = S^-1 (E^T D^-1 g_l - g_c)
    dl = -(g_l + E dc) / D

LM damping goes on both diagonals before elimination, so the step equals
the dense damped solve. The lifted row times ``vt`` stay in the reduced
system: c-space is the tangent vector without the landmark block, so
``vt_offset + i`` maps to ``landmark_offset + i``. Kernel B2 (``ops.assembly_kernels``) assembles the
blocks; whitening, masks, ``E^T (E / D)`` and the dense solve of the
reduced system stay plain torch.
"""
import torch

from ..ops.assembly_kernels import assemble_schur_blocks
from .kernels import (
    LANDMARK_KINDS,
    _bucket_cost,
    _retract_state,
    bucket_terms,
    landmark_free_mask,
    problem_runtime,
    problem_spec,
    project_delta,
    total_cost,
)


def whitened_rows(spec, bspec, runtime, state, data, mask_l, lid_key="lid"):
    """Linearize one bucket and whiten it for assembly.

    Returns ``(cost, (Jw, cols_c, rw, Jw_rho, lid))``: the bucket's cost and
    B2's inputs (Huber ``sqrt(rho')`` whitening; c-space column ids; the
    landmark column masked per row by the landmark lock mask). ``lid_key``
    names the rows' landmark ids in ``mask_l`` and B2's landmark blocks
    (``"lid_local"``: a shard's block of landmarks)."""
    r, J, cols, J_rho = bucket_terms(spec, bspec, runtime, state, data)
    cost, rho_p = _bucket_cost(bspec, data, r)
    lo, L = spec.landmark_offset, spec.num_landmarks
    cols_c = torch.where(cols >= lo, cols - L, cols).to(torch.int32)
    sq = torch.sqrt(rho_p)
    Jw = (J * sq[:, None, None]).contiguous()
    rw = (r * sq[:, None]).contiguous()
    if J_rho is None:
        M, rdim = rw.shape
        Jw_rho = torch.zeros(M, rdim, dtype=rw.dtype, device=rw.device)
        lid = torch.zeros(M, dtype=torch.int32, device=rw.device)
    else:
        Jw_rho = (J_rho * sq[:, None] * mask_l[data[lid_key]][:, None]).contiguous()
        lid = data[lid_key].to(torch.int32)
    return cost, (Jw, cols_c, rw, Jw_rho, lid)


def _identity(x):
    return x


def build_schur_parts(spec, local_L=0, shard=0, psum=_identity, allgather=_identity,
                      pmax=_identity):
    """Solver functions with per-landmark Schur elimination:
    ``linearize(runtime, state) -> (cost, H_cc, g_c, E, D, g_l)``,
    ``schur_solve``, ``solve_from_lin``, ``grad_max(g_c, g_l)``,
    ``retract``, ``step(runtime, state, lam) -> (cost, new_state, new_cost,
    pred, delta, grad_max)`` (the classic LM step), ``step_spec`` and
    ``total_cost(runtime, state)`` (the residual-only re-cost).

    With ``local_L > 0`` (landmark-block sharding, ``parallel.schur``) this
    is shard ``shard``'s part: the landmark blocks ``E, D, g_l`` are those
    of landmarks ``[shard * local_L, (shard + 1) * local_L)``, the rows
    scatter by ``data["lid_local"]`` and the landmark lock mask is
    ``runtime["mask_l"]``, the shard's block. ``psum`` sums over the shards
    (the costs, ``H_cc``, ``g_c``, ``E^T D^-1 E`` and ``E^T D^-1 g_l``, the
    landmark terms of the predicted decrease), ``allgather`` joins the
    shards' landmark steps and ``pmax`` takes the largest landmark gradient
    over the shards; all three are identities on one device."""
    L = spec.num_landmarks
    P = spec.num_tangent
    Pc = P - L
    lo = spec.landmark_offset

    # this shard's landmarks
    block = slice(shard * local_L, (shard + 1) * local_L) if local_L else slice(0, L)

    def split_mask(mask):
        return torch.cat([mask[:lo], mask[lo + L:]]), mask[lo:lo + L]

    def linearize(runtime, state):
        mask = runtime["mask"]
        opts = dict(dtype=mask.dtype, device=mask.device)
        mask_c, mask_l = split_mask(mask)
        E_rows = local_L or L
        if local_L:
            mask_l = runtime["mask_l"]
        H_cc = torch.zeros(Pc, Pc, **opts)
        g_c = torch.zeros(Pc, **opts)
        E = torch.zeros(E_rows, Pc, **opts)
        D = torch.zeros(E_rows, **opts)
        g_l = torch.zeros(E_rows, **opts)
        cost = torch.zeros((), **opts)
        for bspec, data in zip(spec.buckets, runtime["data"]):
            c, rows = whitened_rows(spec, bspec, runtime, state, data, mask_l,
                                    "lid_local" if local_L else "lid")
            with_rho = bspec.kind in LANDMARK_KINDS
            Hb, gb, Eb, Db, glb = assemble_schur_blocks(
                *rows, P=Pc, L=E_rows, with_rho=with_rho
            )
            cost = cost + c
            H_cc = H_cc + Hb
            g_c = g_c + gb
            if with_rho:
                E = E + Eb
                D = D + Db
                g_l = g_l + glb
        # Lock masking after assembly in the block space; with 0/1 masks it
        # equals masking every row: (J diag(m))^T (J diag(m)) = m m^T o J^T J.
        # The landmark mask stays per row (whitened_rows).
        H_cc = H_cc * (mask_c[:, None] * mask_c[None, :])
        g_c = g_c * mask_c
        E = E * mask_c[None, :]
        cost, H_cc, g_c = psum([cost, H_cc, g_c])
        return cost, H_cc, g_c, E, D, g_l

    def schur_solve(runtime, H_cc, g_c, E, D, g_l, lam, state=None):
        """Damped block solve; returns the full tangent delta [P]. With
        ``state`` given, landmarks at the rho = 0 bound whose gradient
        points outward are frozen for this step."""
        mask_c, mask_l = split_mask(runtime["mask"])
        if local_L:
            mask_l = runtime["mask_l"]
        if state is not None and L:
            mask_l = landmark_free_mask(state["rho"][block], g_l, mask_l)
            E = E * mask_l[:, None]
        diag_c = torch.clamp(torch.diagonal(H_cc), 1e-6, 1e32)
        A_cc = H_cc + lam * torch.diag(diag_c) + torch.diag(1.0 - mask_c)
        D_d = D + lam * torch.clamp(D, 1e-6, 1e32) + (1.0 - mask_l)
        if L:
            ETE, ETg = psum([E.T @ (E / D_d[:, None]), E.T @ (g_l / D_d)])
            dc = torch.linalg.solve(A_cc - ETE, ETg - g_c) * mask_c
            dl = allgather(-(g_l + E @ dc) / D_d * mask_l)
        else:
            dc = torch.linalg.solve(A_cc, -g_c) * mask_c
            dl = dc[:0]
        return torch.cat([dc[:lo], dl, dc[lo:]])

    def solve_from_lin(runtime, state, H_cc, g_c, E, D, g_l, lam):
        """(projected delta, predicted cost reduction) from a linearization."""
        delta = schur_solve(runtime, H_cc, g_c, E, D, g_l, lam, state=state)
        delta = project_delta(spec, runtime, state, delta)
        dc = torch.cat([delta[:lo], delta[lo + L:]])
        dl = delta[lo:lo + L][block]
        gTd_l, dEd, dDd = psum([g_l @ dl, 2.0 * dl @ (E @ dc), dl @ (D * dl)])
        gTd = g_c @ dc + gTd_l
        dHd = dc @ (H_cc @ dc) + dEd + dDd
        return delta, -(gTd + 0.5 * dHd)

    def grad_max(g_c, g_l):
        """max |g| over the reduced and the landmark gradient (before the
        step's landmark freeze, as the JAX package's Schur step takes it)."""
        gmax = g_c.abs().max() if Pc else g_c.new_zeros(())
        if L:
            gmax = torch.maximum(gmax, pmax(g_l.abs().max()))
        return gmax

    def retract(runtime, state, delta):
        return _retract_state(spec, runtime, state, delta)

    def re_cost(runtime, state):
        return psum(total_cost(spec, runtime, state))

    def step(runtime, state, lam):
        cost, H_cc, g_c, E, D, g_l = linearize(runtime, state)
        delta, pred = solve_from_lin(runtime, state, H_cc, g_c, E, D, g_l, lam)
        new_state = retract(runtime, state, delta)
        return cost, new_state, re_cost(runtime, new_state), pred, delta, grad_max(g_c, g_l)

    def step_spec(runtime, state, lin, lam):
        """Speculative-linearization step: solve from the linearization at
        ``state``, retract, and linearize the candidate in full (its cost is
        the re-cost; its blocks are the next linearization on accept)."""
        cost, H_cc, g_c, E, D, g_l = lin
        delta, pred = solve_from_lin(runtime, state, H_cc, g_c, E, D, g_l, lam)
        new_state = retract(runtime, state, delta)
        return new_state, linearize(runtime, new_state), pred

    return dict(
        linearize=linearize,
        schur_solve=schur_solve,
        solve_from_lin=solve_from_lin,
        grad_max=grad_max,
        retract=retract,
        step=step,
        step_spec=step_spec,
        total_cost=re_cost,
    )


def make_schur_step(problem):
    """``(step(state, lam), cost_fn(state))`` with Schur elimination of the
    landmarks, over ``problem``'s runtime; the contract of
    ``kernels.make_step``."""
    spec, runtime = problem_spec(problem), problem_runtime(problem)
    parts = build_schur_parts(spec)
    return (lambda state, lam: parts["step"](runtime, state, lam),
            lambda state: parts["total_cost"](runtime, state))
