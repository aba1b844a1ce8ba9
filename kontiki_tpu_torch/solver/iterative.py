"""Iterative Schur: matrix-free PCG on the reduced camera/trajectory system
(counterpart of ``kontiki_tpu.solver.iterative``, one device; Ceres
ITERATIVE_SCHUR).

The damped reduced system

    S dc = rhs,   S = A_cc - E^T D^-1 E,   rhs = E^T D^-1 g_l - g_c

is solved by preconditioned conjugate gradients with matrix-free matvecs.
The linearization keeps each row's Jacobian in compressed form, ``Jw [M,
rdim, C]`` over its C columns with the ids ``cols [M, C]`` and the landmark
column ``J_rho [M, rdim]`` (the rows of ``solver.kernels.bucket_terms``:
B1, B8, B4 or ``torch.func``), so a matvec is two batched ``einsum``s and
an ``index_add_`` per bucket:

    A_cc x = sum_rows Jw^T (Jw x[cols])
    E x    = segment_sum(J_rho . (Jw x[cols]))     ([L])
    E^T w  = sum_rows Jw^T (J_rho * w[lid])

Nothing quadratic in the parameters is built. The preconditioner is
block-Jacobi over per-knot ``[td, td]`` and per-sensor ``[13, 13]`` blocks
of the damped A_cc (Ceres's JACOBI for ITERATIVE_SCHUR), factored once a
solve; entries outside the blocks (the lifted row times) take the point
Jacobi ``1 / (diag + damping)``.

PCG runs in chunks of ``PCG_CHUNK`` iterations with one host read of the
stopping test a chunk: inside a chunk ``torch.where`` freezes the iterates
and the count once ``k < maxiter and r.r > tol^2 b.b`` fails, so the extra
iterations change nothing and the iterates and count are the JAX
``while_loop``'s.
"""
from typing import NamedTuple, Tuple

import torch

from .kernels import (
    CAMERA_KINDS,
    _bucket_cost,
    _retract_state,
    bucket_terms,
    landmark_free_mask,
    problem_runtime,
    problem_spec,
    total_cost,
)
from .problem import SENSOR_TANGENT_DIM, TANGENT_DIMS

#: bucket kinds whose rows carry their sensor's 13 tangent columns
_SENSOR_KINDS = CAMERA_KINDS + ("rs_newton", "gyro", "accel")
#: PCG iterations between two host reads of the stopping test
PCG_CHUNK = 10


class _BucketLayout(NamedTuple):
    """C-axis layout of one bucket's ``J [M, rdim, C]``: for each (tag,
    spline) window a ``(col_offset, spline_index, W, td)`` entry, then the
    sensor slot offset (or -1), and C."""
    windows: Tuple[Tuple[int, int, int, int], ...]
    sensor_off: int
    C: int


def _bucket_layout(spec, bspec) -> _BucketLayout:
    """The columns of ``solver.kernels.bucket_terms`` for each kind: camera
    rows (``rs_static``, ``rs_lifting``) a ref and an obs window per spline,
    each the 4-knot window B1 differentiates; Newton rows a ref and an obs
    window per spline of the bucket's W knots (B8, C = 2 Ct + 13); IMU and
    pose rows one window per spline of the bucket's width; then the sensor
    block for the kinds that have one, and a lifting row's ``vt`` column
    last."""
    two = bspec.kind in CAMERA_KINDS or bspec.kind == "rs_newton"
    off = 0
    wins = []
    for _ in ("ref", "obs") if two else ("t",):
        for si, sp in enumerate(spec.splines):
            W = 4 if bspec.kind in CAMERA_KINDS else bspec.windows[si]
            td = TANGENT_DIMS[sp.kind]
            wins.append((off, si, W, td))
            off += W * td
    sensor_off = -1
    if bspec.kind in _SENSOR_KINDS:
        sensor_off = off
        off += SENSOR_TANGENT_DIM
    if bspec.kind == "rs_lifting":
        off += 1
    return _BucketLayout(tuple(wins), sensor_off, off)


def duplicate_cross_diag(blk, layout):
    """Extra diagonal mass from duplicate column ids within a row.

    ``diag(H)[c]`` must square the sum of a row's entries that share a
    column id. Duplicates arise only between the ref and obs windows of
    camera and Newton rows (the two windows can alias). Each window is a
    contiguous id range, so the aliasing is a per-row shift: obs column j
    matches ref column ``j + (base_obs - base_ref)``. Returns ``[M, C]``
    additions aligned with ``blk["cols"]``, the cross terms 2ab at the obs
    columns, in O(M C)."""
    Jw, cols = blk["Jw"], blk["cols"]
    M, rdim, C = Jw.shape
    out = torch.zeros(M, C, dtype=Jw.dtype, device=Jw.device)
    by_si = {}
    for w in layout.windows:
        by_si.setdefault(w[1], []).append(w)
    for ws in by_si.values():
        if len(ws) != 2:
            continue
        (off_r, _, Wr, td), (off_o, _, Wo, _) = ws
        nr, no = Wr * td, Wo * td
        shift = cols[:, off_o] - cols[:, off_r]
        idx = torch.arange(no, device=cols.device)[None, :] + shift[:, None]
        ok = (idx >= 0) & (idx < nr)
        Jr = torch.gather(Jw[:, :, off_r:off_r + nr], 2,
                          idx.clamp(0, nr - 1)[:, None, :].expand(M, rdim, no))
        Jo = Jw[:, :, off_o:off_o + no]
        out[:, off_o:off_o + no] += 2.0 * torch.sum(Jr * Jo, dim=1) * ok.to(Jw.dtype)
    return out


def hcc_matvec(blocks, x):
    """Undamped ``A_cc x`` (Gauss-Newton, landmark columns excluded) over
    the compressed rows' columns."""
    y = torch.zeros_like(x)
    for blk in blocks:
        t = torch.einsum("mrc,mc->mr", blk["Jw"], x[blk["cols"]])
        y.index_add_(0, blk["cols"].reshape(-1),
                     torch.einsum("mrc,mr->mc", blk["Jw"], t).reshape(-1))
    return y


def e_matvec(blocks, x, n):
    """``E x`` over ``n`` landmark ids."""
    Ex = torch.zeros(n, dtype=x.dtype, device=x.device)
    for blk in blocks:
        if "J_rho" in blk:
            t = torch.einsum("mrc,mc->mr", blk["Jw"], x[blk["cols"]])
            Ex.index_add_(0, blk["lid"], torch.sum(blk["J_rho"] * t, dim=1))
    return Ex


def et_matvec(blocks, w, n):
    """``E^T w`` over ``n`` columns."""
    y = torch.zeros(n, dtype=w.dtype, device=w.device)
    for blk in blocks:
        if "J_rho" in blk:
            coeff = blk["J_rho"] * w[blk["lid"]][:, None]
            y.index_add_(0, blk["cols"].reshape(-1),
                         torch.einsum("mr,mrc->mc", coeff, blk["Jw"]).reshape(-1))
    return y


def _dot(a, b):
    return a @ b


def pcg(matvec, precond, b, tol, maxiter, chunk=PCG_CHUNK, dot=_dot):
    """Preconditioned CG from x = 0 while ``k < maxiter and r.r > tol^2
    b.b``. Returns ``(x, k)``, ``k`` a 0-d int64 tensor. ``dot`` is the
    inner product (a sharded one sums over the shards: every shard then
    reads the same stopping test)."""
    x = torch.zeros_like(b)
    r = b
    z = precond(r)
    p = z
    rz = dot(r, z)
    k = torch.zeros((), dtype=torch.int64, device=b.device)
    thresh2 = (tol * tol) * dot(b, b)

    def going(r, k):
        return (k < maxiter) & (dot(r, r) > thresh2)

    while bool(going(r, k)):
        for _ in range(chunk):
            go = going(r, k)
            Ap = matvec(p)
            pAp = dot(p, Ap)
            alpha = rz / torch.where(pAp == 0, 1.0, pAp)
            x_n = x + alpha * p
            r_n = r - alpha * Ap
            z_n = precond(r_n)
            rz_n = dot(r_n, z_n)
            beta = rz_n / torch.where(rz == 0, 1.0, rz)
            p_n = z_n + beta * p
            x, r, z, p, rz = (torch.where(go, a, b_) for a, b_ in
                              ((x_n, x), (r_n, r), (z_n, z), (p_n, p), (rz_n, rz)))
            k = k + go.to(k.dtype)
    return x, k


def _factor(B):
    """LU factors of a batch of preconditioner blocks."""
    return torch.linalg.lu_factor_ex(B)[:2]


def _apply(factors, r):
    """``B^-1 r`` for a batch of blocks from their LU factors, r ``[n, k]``."""
    return torch.linalg.lu_solve(*factors, r[..., None])[..., 0]


class Columns(NamedTuple):
    """Where a reduced system's block-Jacobi blocks lie: per spline
    ``(offset, knots, td)`` of its knot tangents, then the sensors' offset
    and count. Columns outside them (lifted row times) are point Jacobi."""
    knots: Tuple[Tuple[int, int, int], ...]
    sensor_offset: int
    num_sensors: int


def grad_and_diag(blocks, layouts, n, nl):
    """``(g [n], diag [n], D [nl], g_l [nl])`` of compressed rows over ``n``
    columns and ``nl`` landmarks: ``J^T r``, the diagonal of ``J^T J``,
    which squares the sum of a row's entries that share a column
    (``duplicate_cross_diag``: along gauge directions the damping alone
    sets the step, so it must match the dense path's diagonal exactly), and
    the landmark column's ``J_rho^T J_rho`` and ``J_rho^T r``."""
    opts = dict(dtype=blocks[0]["Jw"].dtype, device=blocks[0]["Jw"].device)
    g = torch.zeros(n, **opts)
    diag = torch.zeros(n, **opts)
    D = torch.zeros(max(nl, 1), **opts)
    g_l = torch.zeros_like(D)
    for blk, layout in zip(blocks, layouts):
        ids = blk["cols"].reshape(-1)
        g.index_add_(0, ids, torch.einsum("mrc,mr->mc", blk["Jw"], blk["rw"]).reshape(-1))
        diag.index_add_(0, ids, (torch.sum(blk["Jw"] ** 2, dim=1)
                                 + duplicate_cross_diag(blk, layout)).reshape(-1))
        if "J_rho" in blk:
            D.index_add_(0, blk["lid"], torch.sum(blk["J_rho"] ** 2, dim=1))
            g_l.index_add_(0, blk["lid"], torch.sum(blk["J_rho"] * blk["rw"], dim=1))
    return g, diag, D[:nl], g_l[:nl]


def precond_blocks(blocks, layouts, columns):
    """Per-knot ``[td, td]`` and per-sensor ``[13, 13]`` diagonal blocks of
    the undamped ``J^T J`` (lock-masked through ``Jw``) at ``columns``."""
    opts = dict(dtype=blocks[0]["Jw"].dtype, device=blocks[0]["Jw"].device)
    kblocks = [torch.zeros(n, td, td, **opts) for _, n, td in columns.knots]
    sd = SENSOR_TANGENT_DIM
    sblocks = torch.zeros(max(columns.num_sensors, 1), sd, sd, **opts)
    for blk, layout in zip(blocks, layouts):
        Jw, cols = blk["Jw"], blk["cols"]
        M, rdim = Jw.shape[:2]
        for off, si, W, td in layout.windows:
            Jwin = Jw[:, :, off:off + W * td].reshape(M, rdim, W, td)
            kidx = ((cols[:, off] - columns.knots[si][0]) // td)[:, None] + \
                torch.arange(W, device=opts["device"])
            kblocks[si].index_add_(0, kidx.reshape(-1), torch.einsum(
                "mrwd,mrwe->mwde", Jwin, Jwin).reshape(-1, td, td))
        if layout.sensor_off >= 0:
            s0 = layout.sensor_off
            Js = Jw[:, :, s0:s0 + sd]
            sid = (cols[:, s0] - columns.sensor_offset) // sd
            sblocks.index_add_(0, sid, torch.einsum("mrd,mre->mde", Js, Js))
    return kblocks, sblocks


def preconditioner(kblocks, sblocks, columns, diag_d, point):
    """The inverse of the damped block-Jacobi preconditioner as a function
    of r, its blocks factored once: ``diag_d`` is the damping diagonal
    ``lam clip(diag) + (1 - mask)``, which also makes locked rows
    invertible; entries outside the blocks take ``r / point``."""
    parts = [(o, n, td, _factor(kb + torch.diag_embed(diag_d[o:o + n * td].reshape(n, td))))
             for (o, n, td), kb in zip(columns.knots, kblocks)]
    S, sd, so = columns.num_sensors, SENSOR_TANGENT_DIM, columns.sensor_offset
    if S:
        parts.append((so, S, sd, _factor(sblocks[:S] + torch.diag_embed(
            diag_d[so:so + S * sd].reshape(S, sd)))))

    def apply(r):
        out = r / point
        for o, n, k, fac in parts:
            out[o:o + n * k] = _apply(fac, r[o:o + n * k].reshape(n, k)).reshape(-1)
        return out

    return apply


def _identity(x):
    return x


def build_iterative_parts(spec, psum=_identity):
    """Solver functions for the matrix-free iterative-Schur path:
    ``total_cost``, ``linearize(runtime, state) -> (cost, blocks)``,
    ``grad_and_diag(blocks) -> (g_c, diag, D, g_l)``, ``hcc_matvec``,
    ``e_matvec``, ``et_matvec``, ``schur_solve``, ``solve_with_pred``,
    ``retract``,
    ``step(runtime, state, lam, cg_tol, cg_maxiter) -> (cost, new_state,
    new_cost, pred, delta, grad_max)`` and ``step_spec``.

    ``psum`` sums over the shards of a measurement-sharded problem
    (``parallel.iterative``; a shard's rows may be any rows): every global
    reduction passes through it, the costs, the gradient and diagonals,
    each matvec's scatter and the preconditioner blocks, so every vector
    the solve reads is the same on every shard."""
    layouts = [_bucket_layout(spec, b) for b in spec.buckets]
    columns = Columns(tuple((sp.tangent_offset, sp.n, TANGENT_DIMS[sp.kind])
                            for sp in spec.splines), spec.sensor_offset, spec.num_sensors)
    L = spec.num_landmarks
    Pc = spec.num_tangent - L
    lo = spec.landmark_offset

    def split_mask(mask):
        return torch.cat([mask[:lo], mask[lo + L:]]), mask[lo:lo + L]

    def linearize(runtime, state):
        """Compressed linearization: ``(cost, blocks)``, a dict a bucket
        ``{rw, Jw, cols[, J_rho, lid]}``, robust-whitened, lock-masked per
        column, column ids in the landmark-free c-space."""
        mask_c, mask_l = split_mask(runtime["mask"])
        cost = torch.zeros((), dtype=mask_c.dtype, device=mask_c.device)
        blocks = []
        for bspec, data in zip(spec.buckets, runtime["data"]):
            r, J, cols, J_rho = bucket_terms(spec, bspec, runtime, state, data)
            c, rho_p = _bucket_cost(bspec, data, r)
            cost = cost + c
            cols_c = torch.where(cols >= lo, cols - L, cols)
            sq = torch.sqrt(rho_p)
            blk = {"rw": r * sq[:, None],
                   "Jw": J * mask_c[cols_c][:, None, :] * sq[:, None, None],
                   "cols": cols_c}
            if J_rho is not None:
                blk["J_rho"] = J_rho * sq[:, None] * mask_l[data["lid"]][:, None]
                blk["lid"] = data["lid"]
            blocks.append(blk)
        return psum(cost), blocks

    def grad_and_diag_c(blocks):
        """``(g_c, diag(A_cc), D, g_l)``."""
        return tuple(psum(list(grad_and_diag(blocks, layouts, Pc, L))))

    def hcc_matvec_c(blocks, x):
        """``A_cc x`` (undamped)."""
        return psum(hcc_matvec(blocks, x))

    def e_matvec_c(blocks, x):
        """``E x -> [L]``."""
        return psum(e_matvec(blocks, x, max(L, 1))[:L])

    def et_matvec_c(blocks, w):
        """``E^T w -> [Pc]``."""
        return psum(et_matvec(blocks, w, Pc))

    def precond_blocks_c(blocks):
        kblocks, sblocks = precond_blocks(blocks, layouts, columns)
        *kblocks, sblocks = psum([*kblocks, sblocks])
        return kblocks, sblocks

    def schur_solve(runtime, blocks, lam, cg_tol, cg_maxiter, state=None):
        """Damped iterative Schur solve: ``(delta [P], cg_iters, (g_c, g_l,
        D, dc, dl))``. With ``state``, landmarks at the rho = 0 bound with an
        outward gradient are frozen for this step."""
        mask_c, mask_l = split_mask(runtime["mask"])
        g_c, diag, D, g_l = grad_and_diag_c(blocks)
        if state is not None and L:
            mask_l = landmark_free_mask(state["rho"], g_l, mask_l)
        diag_d = lam * torch.clamp(diag, 1e-6, 1e32) + (1.0 - mask_c)
        precond = preconditioner(*precond_blocks_c(blocks), columns, diag_d, diag + diag_d)
        if L:
            D_d = D + lam * torch.clamp(D, 1e-6, 1e32) + (1.0 - mask_l)
            rhs = et_matvec_c(blocks, mask_l * g_l / D_d) - g_c

            def matvec(x):
                y = hcc_matvec_c(blocks, x) + diag_d * x
                return y - et_matvec_c(blocks, e_matvec_c(blocks, x) * mask_l / D_d)
        else:
            rhs = -g_c

            def matvec(x):
                return hcc_matvec_c(blocks, x) + diag_d * x

        dc, k = pcg(matvec, precond, rhs, cg_tol, cg_maxiter)
        dc = dc * mask_c
        if L:
            dl = -(g_l + e_matvec_c(blocks, dc)) / D_d * mask_l
        else:
            dl = dc[:0]
        return torch.cat([dc[:lo], dl, dc[lo:]]), k, (g_c, g_l, D, dc, dl)

    def solve_with_pred(runtime, blocks, lam, cg_tol, cg_maxiter, state=None):
        """``(delta, pred, grad_max)`` from a linearization. With ``state``
        the landmark step is projected to the increment the bounded
        retraction (rho >= 0) applies before ``pred``."""
        delta, _, (g_c, g_l, D, dc, dl) = schur_solve(
            runtime, blocks, lam, cg_tol, cg_maxiter, state=state)
        if state is not None and L:
            dl = torch.clamp(state["rho"] + dl, min=0.0) - state["rho"]
            delta = torch.cat([delta[:lo], dl, delta[lo + L:]])
        gTd = g_c @ dc
        dHd = dc @ hcc_matvec_c(blocks, dc)
        grad_max = g_c.abs().max()
        if L:
            gTd = gTd + g_l @ dl
            dHd = dHd + 2.0 * (dl @ e_matvec_c(blocks, dc)) + dl @ (D * dl)
            grad_max = torch.maximum(grad_max, g_l.abs().max())
        return delta, -(gTd + 0.5 * dHd), grad_max

    def retract(runtime, state, delta):
        return _retract_state(spec, runtime, state, delta)

    def step(runtime, state, lam, cg_tol=1e-10, cg_maxiter=500):
        cost, blocks = linearize(runtime, state)
        delta, pred, grad_max = solve_with_pred(runtime, blocks, lam, cg_tol, cg_maxiter,
                                                state=state)
        new_state = retract(runtime, state, delta)
        return cost, new_state, total_cost_c(runtime, new_state), pred, delta, grad_max

    def step_spec(runtime, state, lin, lam, cg_tol=1e-10, cg_maxiter=500):
        """Speculative-linearization step: solve from the linearization at
        ``state``, retract, linearize the candidate."""
        delta, pred, _ = solve_with_pred(runtime, lin[1], lam, cg_tol, cg_maxiter,
                                         state=state)
        new_state = retract(runtime, state, delta)
        return new_state, linearize(runtime, new_state), pred

    def total_cost_c(runtime, state):
        return psum(total_cost(spec, runtime, state))

    return dict(
        total_cost=total_cost_c,
        linearize=linearize, retract=retract, step=step, step_spec=step_spec,
        schur_solve=schur_solve, solve_with_pred=solve_with_pred, hcc_matvec=hcc_matvec_c,
        e_matvec=e_matvec_c, et_matvec=et_matvec_c, grad_and_diag=grad_and_diag_c,
    )


def make_iterative_step(problem, cg_tol=1e-10, cg_maxiter=500):
    """``step(state, lam) -> (cost, new_state, new_cost, pred, delta,
    grad_max)`` on matrix-free PCG, and ``total_cost(state)``; the
    problem's device runs them."""
    parts = build_iterative_parts(problem_spec(problem))
    runtime = problem_runtime(problem)
    return (lambda state, lam: parts["step"](runtime, state, lam, cg_tol, cg_maxiter),
            lambda state: parts["total_cost"](runtime, state))
