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
the dense damped solve. Kernel B2 (``ops.assembly_kernels``) assembles the
blocks; whitening, masks, ``E^T (E / D)`` and the dense solve of the
reduced system stay plain torch.
"""
import torch

from ..ops.assembly_kernels import assemble_schur_blocks
from .kernels import (
    _huber,
    _huber_prime,
    _retract_state,
    bucket_terms,
    landmark_free_mask,
    project_delta,
)


def whitened_rows(spec, bspec, runtime, state, data, mask_l):
    """Linearize one bucket and whiten it for assembly.

    Returns ``(cost, (Jw, cols_c, rw, Jw_rho, lid))``: the bucket's cost and
    B2's inputs (Huber ``sqrt(rho')`` whitening; c-space column ids; the
    landmark column masked per row by the landmark lock mask)."""
    r, J, cols, J_rho = bucket_terms(spec, bspec, runtime, state, data)
    s = torch.sum(r * r, dim=-1)
    if J_rho is not None:
        c = data["huber_c"]
        rho_p = _huber_prime(s, c)
        cost = 0.5 * torch.sum(_huber(s, c))
    else:
        rho_p = torch.ones_like(s)
        cost = 0.5 * torch.sum(s)
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
        Jw_rho = (J_rho * sq[:, None] * mask_l[data["lid"]][:, None]).contiguous()
        lid = data["lid"].to(torch.int32)
    return cost, (Jw, cols_c, rw, Jw_rho, lid)


def build_schur_parts(spec):
    """Solver functions with per-landmark Schur elimination:
    ``linearize(runtime, state) -> (cost, H_cc, g_c, E, D, g_l)``,
    ``schur_solve``, ``solve_from_lin``, ``retract`` and ``step_spec``."""
    L = spec.num_landmarks
    P = spec.num_tangent
    Pc = P - L
    lo = spec.landmark_offset

    def split_mask(mask):
        return torch.cat([mask[:lo], mask[lo + L:]]), mask[lo:lo + L]

    def linearize(runtime, state):
        mask = runtime["mask"]
        opts = dict(dtype=mask.dtype, device=mask.device)
        mask_c, mask_l = split_mask(mask)
        H_cc = torch.zeros(Pc, Pc, **opts)
        g_c = torch.zeros(Pc, **opts)
        E = torch.zeros(L, Pc, **opts)
        D = torch.zeros(L, **opts)
        g_l = torch.zeros(L, **opts)
        cost = torch.zeros((), **opts)
        for bspec, data in zip(spec.buckets, runtime["data"]):
            c, rows = whitened_rows(spec, bspec, runtime, state, data, mask_l)
            with_rho = bspec.kind == "rs_static"
            Hb, gb, Eb, Db, glb = assemble_schur_blocks(
                *rows, P=Pc, L=L, with_rho=with_rho
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
        return cost, H_cc, g_c, E, D, g_l

    def schur_solve(runtime, H_cc, g_c, E, D, g_l, lam, state=None):
        """Damped block solve; returns the full tangent delta [P]. With
        ``state`` given, landmarks at the rho = 0 bound whose gradient
        points outward are frozen for this step."""
        mask_c, mask_l = split_mask(runtime["mask"])
        if state is not None and L:
            mask_l = landmark_free_mask(state["rho"], g_l, mask_l)
            E = E * mask_l[:, None]
        diag_c = torch.clamp(torch.diagonal(H_cc), 1e-6, 1e32)
        A_cc = H_cc + lam * torch.diag(diag_c) + torch.diag(1.0 - mask_c)
        D_d = D + lam * torch.clamp(D, 1e-6, 1e32) + (1.0 - mask_l)
        if L:
            Ew = E / D_d[:, None]
            S = A_cc - E.T @ Ew
            rhs = E.T @ (g_l / D_d) - g_c
            dc = torch.linalg.solve(S, rhs) * mask_c
            dl = -(g_l + E @ dc) / D_d * mask_l
        else:
            dc = torch.linalg.solve(A_cc, -g_c) * mask_c
            dl = dc[:0]
        return torch.cat([dc[:lo], dl, dc[lo:]])

    def solve_from_lin(runtime, state, H_cc, g_c, E, D, g_l, lam):
        """(projected delta, predicted cost reduction) from a linearization."""
        delta = schur_solve(runtime, H_cc, g_c, E, D, g_l, lam, state=state)
        delta = project_delta(spec, runtime, state, delta)
        dc = torch.cat([delta[:lo], delta[lo + L:]])
        dl = delta[lo:lo + L]
        gTd = g_c @ dc + g_l @ dl
        dHd = dc @ (H_cc @ dc) + 2.0 * dl @ (E @ dc) + dl @ (D * dl)
        return delta, -(gTd + 0.5 * dHd)

    def retract(runtime, state, delta):
        return _retract_state(spec, runtime, state, delta)

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
        retract=retract,
        step_spec=step_spec,
    )
