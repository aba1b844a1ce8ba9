"""Banded (block-tridiagonal) exact solve of the reduced normal equations
(counterpart of ``kontiki_tpu.solver.banded``, one device).

The 4-knot support of cubic B-splines makes the knot-knot block of the
Gauss-Newton Hessian banded in time: knot i couples only to knots within
the rows' window width W. Grouping W consecutive knots into super-blocks
(all splines interleaved per knot) makes it block-tridiagonal, solved by
``block_tridiag_solve`` in O(n) time and memory. Sensor columns couple to
every knot and form a border,

    [T   B^T] [x]   [b]
    [B   C  ] [y] = [c],

solved through the band solve with the border as extra right-hand sides and
a small dense Schur complement over the ns = 13 S sensor columns.

``build_banded_parts`` assembles the band ``Hband [nb, 2, G BD, G BD]``
(diagonal and first super-diagonal super-blocks) and the border from the
iterative path's compressed row blocks (``solver.iterative``), by
``index_add_`` on flattened ids: nothing quadratic in the knot count. It
takes problems without landmarks or lifted row times, all splines on one
knot grid; ``lm.solve`` and ``make_fused_solver`` call it
``strategy="banded"``.

``block_tridiag_solve`` is parallel cyclic reduction (ceil(log2 nb) levels
of batched ``[nb, d, d]`` solves and products) with one step of iterative
refinement, unlike the JAX package, whose default is the sequential block
Cholesky: on an NVIDIA H100 80GB HBM3 at 700 W (``chip_smoke.py``'s
band-solve phase, float64) config 5's damped band (420 blocks of 48, 14
right-hand sides) takes 137.4 ms by the sequential scan and 19.0 ms by one
PCR solve, the 10,050-knot gyro band (2,513 blocks of 12, 14 right-hand
sides) 788.1 ms and 5.5 ms; the scan's ~10 launches a block are its cost
there. The scan stays as ``_scan_solve``, the reference that the tests
and ``chip_smoke.py`` hold PCR against.

``spike_block_tridiag_solve`` is the distributed solve of such a band
whose blocks lie on the shards of a ``parallel.mesh.Mesh`` (SPIKE: each
shard's interior by ``block_tridiag_solve``, the shards' boundary pairs by
``pcr_block_tridiag_row_solve``, parallel cyclic reduction with one row a
shard over ``ppermute``); ``parallel.segments`` and ``parallel.segments_ba``
call it.
"""
import numpy as np
import torch

from .iterative import _bucket_layout, build_iterative_parts
from .kernels import project_delta
from .problem import SENSOR_TANGENT_DIM, TANGENT_DIMS


def _scan_solve(D, U, rhs):
    """The reference solve of ``block_tridiag_solve``'s system (the JAX
    package's ``"scan"`` method), run by the tests and ``chip_smoke.py``
    only: the sequential block Cholesky T = L L^T with ``L_kk = C_k``,
    ``L_{k+1,k} = B_k``: ``C_0 C_0^T = D_0``, ``B_k = (C_k^{-1} U_k)^T``,
    ``C_{k+1} C_{k+1}^T = D_{k+1} - B_k B_k^T``; then forward and backward
    substitution. ``cholesky_ex`` does not read its ``info`` back to the
    host, so the loop never waits on the device; a block that is not
    positive definite turns its factor into NaN, as the JAX Cholesky does."""
    nb = D.shape[0]
    tri = torch.linalg.solve_triangular
    Cs, BTs, zs = [], [], []
    for k in range(nb):
        Dk, rk = D[k], rhs[k]
        if k:
            # B_{k-1}^T = C_{k-1}^{-1} U_{k-1}
            BT = tri(Cs[-1], U[k - 1], upper=False)
            Dk = Dk - BT.T @ BT
            rk = rk - BT.T @ zs[-1]
            BTs.append(BT)
        Ck, info = torch.linalg.cholesky_ex(Dk)
        Ck = torch.where(info == 0, Ck, torch.nan)
        Cs.append(Ck)
        zs.append(tri(Ck, rk, upper=False))
    xs = [None] * nb
    for k in reversed(range(nb)):
        # L^T x = z: x_k = C_k^{-T} (z_k - B_k^T x_{k+1})
        zk = zs[k] if k == nb - 1 else zs[k] - BTs[k] @ xs[k + 1]
        xs[k] = tri(Cs[k].T, zk, upper=True)
    return torch.stack(xs)


def _solve(A, B):
    """Batched ``A^-1 B`` by LU with partial pivoting, without the host
    check of ``torch.linalg.solve``: a singular block gives inf or NaN, as
    the JAX package's ``jnp.linalg.solve`` does."""
    return torch.linalg.solve_ex(A, B)[0]


def block_tridiag_solve(D, U, rhs):
    """Solve the symmetric block-tridiagonal system T x = rhs by parallel
    cyclic reduction (``_pcr_solve``) and one step of iterative refinement,
    ``x += PCR(rhs - T x)``.

    ``D [nb, d, d]``: diagonal blocks; ``U [nb, d, d]``: super-diagonal
    blocks (``U[k] = T[k, k+1]``, ``U[nb-1]`` ignored); ``rhs [nb, d, R]``.

    PCR alone is not backward stable where the scan is: on config 2's
    damped band (16 blocks of 24, condition 1.7e6) its residual is 8.9e-13
    of the right-hand side against the scan's 4.8e-16, and the banded
    strategy's 1-iteration cost lands 2.6e-9 from the dense strategy's
    (the scan's 2.6e-11); after the refinement the residual is 3.9e-16 and
    the cost 3.7e-11 away (float64 on the CPU, ``tools/solver_accuracy.py``).
    The reduction does not
    depend on the right-hand side, so it runs once and the refinement
    only re-applies it."""
    fac = _pcr_factor(D, U)
    x = _pcr_apply(fac, rhs)
    return x + _pcr_apply(fac, rhs - _band_matvec(D, U, x))


def _band_matvec(D, U, x):
    """``T x`` for the system of ``block_tridiag_solve``."""
    y = torch.bmm(D, x)
    y[:-1] += torch.bmm(U[:-1], x[1:])
    y[1:] += torch.bmm(U[:-1].transpose(1, 2), x[:-1])
    return y


def _down(a, h, fill):
    """a[k] <- a[k - h] (fill for k < h)."""
    return torch.cat([fill.expand(h, *a.shape[1:]), a[:-h]])


def _up(a, h, fill):
    """a[k] <- a[k + h] (fill for k >= nb - h)."""
    return torch.cat([a[h:], fill.expand(h, *a.shape[1:])])


def _pcr_factor(D, U):
    """Parallel cyclic reduction of ``block_tridiag_solve``'s matrix (the
    JAX package's ``pcr_block_tridiag_solve`` without its right-hand side):
    ``([(h, alpha, beta), ...], LU factors of the decoupled blocks)``.

    Row k couples to k - 1 through ``L[k] = U[k-1]^T`` and to k + 1 through
    ``U[k]``. At level h every row eliminates its neighbours at distance h:
    ``alpha = L D[k-h]^-1``, ``beta = U D[k+h]^-1`` (two batched solves),
    ``D -= alpha U[k-h] + beta L[k+h]``, ``L = -alpha L[k-h]``, ``U = -beta
    U[k+h]`` (six batched products); rows past either end read an identity
    block and zeros. After ceil(log2 nb) levels the rows are decoupled. The
    batched solves are LU with partial pivoting (the JAX package's), so an
    indefinite block is solved and a singular one gives inf or NaN."""
    nb, d, _ = D.shape
    opts = dict(dtype=D.dtype, device=D.device)
    L = torch.cat([torch.zeros(1, d, d, **opts), U[:-1].transpose(1, 2)])
    Uc = torch.cat([U[:-1], torch.zeros(1, d, d, **opts)])
    eye = torch.eye(d, **opts)
    zero = torch.zeros(d, d, **opts)
    levels = []
    h = 1
    while h < nb:
        D_m, L_m, U_m = _down(D, h, eye), _down(L, h, zero), _down(Uc, h, zero)
        D_p, L_p, U_p = _up(D, h, eye), _up(L, h, zero), _up(Uc, h, zero)
        # alpha = L D_m^-1, beta = U D_p^-1: (D^T)^-1 applied to the transposes
        alpha = _solve(D_m.transpose(1, 2), L.transpose(1, 2)).transpose(1, 2)
        beta = _solve(D_p.transpose(1, 2), Uc.transpose(1, 2)).transpose(1, 2)
        D = D - torch.bmm(alpha, U_m) - torch.bmm(beta, L_p)
        L = -torch.bmm(alpha, L_m)
        Uc = -torch.bmm(beta, U_p)
        levels.append((h, alpha, beta))
        h *= 2
    return levels, torch.linalg.lu_factor_ex(D)[:2]


def _pcr_apply(fac, rhs):
    """The reduction of ``_pcr_factor`` applied to ``rhs [nb, d, R]``: at
    each level ``b -= alpha b[k-h] + beta b[k+h]``, then the decoupled
    blocks' solves."""
    levels, lu = fac
    zero_b = torch.zeros(rhs.shape[1:], dtype=rhs.dtype, device=rhs.device)
    b = rhs
    for h, alpha, beta in levels:
        b = b - torch.bmm(alpha, _down(b, h, zero_b)) - torch.bmm(beta, _up(b, h, zero_b))
    return torch.linalg.lu_solve(*lu, b)


def _rsolve(A, B):
    """``A B^-1`` without forming the inverse (batched LU of ``B^T``)."""
    return _solve(B.transpose(-1, -2), A.transpose(-1, -2)).transpose(-1, -2)


def pcr_block_tridiag_row_solve(L, U, b, mesh):
    """Distributed parallel cyclic reduction with one K-block row per shard
    of ``mesh`` (``parallel.mesh.Mesh``): solves ``u_s + L_s u_{s-1} + U_s
    u_{s+1} = b_s`` (``L_0 = U_{n-1} = 0``), shard s holding ``L, U [K, K]``
    and ``b [K, R]``. Each of the ceil(log2 n) levels fetches the rows at
    distance h with two ``ppermute``s (below and above; cyclic pairs, whose
    wrapped rows meet ``L = 0`` or ``U = 0``) and eliminates them; then every
    shard solves its decoupled K-system. Returns ``u_s [K, R]``."""
    n = mesh.size
    K = b.shape[0]
    D = torch.eye(K, dtype=b.dtype, device=b.device)
    h = 1
    for _ in range(max(1, (n - 1).bit_length())):
        below = [(i, (i + h) % n) for i in range(n)]  # receive row s - h
        above = [(i, (i - h) % n) for i in range(n)]  # receive row s + h
        D_m, L_m, U_m, b_m = mesh.ppermute([D, L, U, b], below)
        D_p, L_p, U_p, b_p = mesh.ppermute([D, L, U, b], above)
        alpha = _rsolve(L, D_m)
        beta = _rsolve(U, D_p)
        D = D - alpha @ U_m - beta @ L_p
        b = b - alpha @ b_m - beta @ b_p
        L = -alpha @ L_m
        U = -beta @ U_p
        h *= 2
    return _solve(D, b)


def spike_block_tridiag_solve(D, U, rhs, mesh):
    """Distributed exact solve of a symmetric block-tridiagonal system whose
    super-blocks lie ``sb`` consecutive ones a shard of ``mesh``: ``D [sb,
    B, B]`` the diagonal blocks, ``U [sb, B, B]`` the couplings to the next
    block (``U[sb-1]`` to the next shard's first block, zero on the last
    shard), ``rhs [sb, B, R]``.

    SPIKE (the JAX package's ``spike_block_tridiag_solve``): each shard
    factors its interior once by ``block_tridiag_solve`` (PCR and one
    refinement step) with ``R + 2B`` right-hand sides, the rhs and the two
    boundary spikes; the shards' [first; last] boundary pairs form a
    block-tridiagonal interface system with one 2B row a shard, solved by
    ``pcr_block_tridiag_row_solve``; one local combination finishes. A
    one-shard mesh is ``block_tridiag_solve``. Needs ``sb >= 2``. Returns
    this shard's ``x [sb, B, R]``."""
    sb, B, _ = D.shape
    R = rhs.shape[-1]
    n = mesh.size
    if n == 1:
        return block_tridiag_solve(D, U, rhs)
    if sb < 2:
        raise ValueError("spike solve requires >= 2 super-blocks per shard")
    idx = mesh.axis_index()
    first = 1.0 if idx == 0 else 0.0
    last = 1.0 if idx == n - 1 else 0.0
    # the coupling into block 0 from the previous shard's last block is, by
    # symmetry, that shard's U[sb-1]^T
    U_from_left = mesh.ppermute(U[sb - 1], [(i, (i + 1) % n) for i in range(n)])
    U_loc = U.clone()
    U_loc[sb - 1] = 0.0
    aug = torch.zeros(sb, B, R + 2 * B, dtype=D.dtype, device=D.device)
    aug[:, :, :R] = rhs
    aug[0, :, R:R + B] = (1.0 - first) * U_from_left.T
    aug[sb - 1, :, R + B:] = (1.0 - last) * U[sb - 1]
    sol = block_tridiag_solve(D, U_loc, aug)
    Y = sol[:, :, :R]
    W = sol[:, :, R:R + B]  # x -= W x_{previous shard, last block}
    V = sol[:, :, R + B:]   # x -= V x_{next shard, first block}
    zB = torch.zeros(B, B, dtype=D.dtype, device=D.device)
    L_row = torch.cat([torch.cat([zB, W[0]], dim=1), torch.cat([zB, W[sb - 1]], dim=1)])
    U_row = torch.cat([torch.cat([V[0], zB], dim=1), torch.cat([V[sb - 1], zB], dim=1)])
    u = pcr_block_tridiag_row_solve(L_row, U_row, torch.cat([Y[0], Y[sb - 1]]), mesh)
    # the neighbours' boundary values (the wrapped ones meet W = 0 on the
    # first shard and V = 0 on the last)
    z_prev = mesh.ppermute(u, [(i, (i + 1) % n) for i in range(n)])[B:]
    z_next = mesh.ppermute(u, [(i, (i - 1) % n) for i in range(n)])[:B]
    return Y - torch.einsum("kbc,cr->kbr", W, z_prev) - torch.einsum("kbc,cr->kbr", V, z_next)


# ---------------------------------------------------------------------------
# band assembly from compressed row blocks: the "banded" strategy
# ---------------------------------------------------------------------------

def build_banded_parts(spec):
    """Solver functions on the exact block-tridiagonal solve:
    ``total_cost``, ``linearize`` (the iterative path's compressed blocks),
    ``retract``, ``grad_and_diag``, ``assemble``, ``damped_system``,
    ``banded_solve``, ``solve_with_pred``, ``step(runtime,
    state, lam) -> (cost, new_state, new_cost, pred, delta, grad_max)`` and
    ``step_spec``. Raises ``ValueError`` on landmarks, lifted row times and
    splines on different knot grids, as the JAX package does."""
    if spec.num_landmarks or spec.num_vt:
        raise ValueError(
            "banded solve handles knot+sensor problems only; camera/landmark "
            "problems use strategy='schur' or 'iterative_schur'")
    ns_list = [sp.n for sp in spec.splines]
    if len(set(ns_list)) != 1:
        raise ValueError("banded solve requires all splines on one knot grid")
    nk = ns_list[0]

    it = build_iterative_parts(spec)
    layouts = [_bucket_layout(spec, b) for b in spec.buckets]
    tds = [TANGENT_DIMS[sp.kind] for sp in spec.splines]
    BD = sum(tds)
    sub_off = np.concatenate([[0], np.cumsum(tds)[:-1]]).astype(np.int64)
    G = max(max(b.windows) for b in spec.buckets)
    nb = -(-nk // G)
    GBD = G * BD
    Pk = nb * GBD  # padded banded knot space
    S = spec.num_sensors
    ns = S * SENSOR_TANGENT_DIM
    so = spec.sensor_offset

    # original knot tangent index -> banded index
    perm_np = np.zeros(so, dtype=np.int64)
    for si, sp in enumerate(spec.splines):
        k, j = np.meshgrid(np.arange(nk), np.arange(tds[si]), indexing="ij")
        perm_np[(sp.tangent_offset + k * tds[si] + j).ravel()] = (
            k * BD + sub_off[si] + j).ravel()
    perms = {}

    def perm_on(device):
        if device not in perms:
            perms[device] = torch.as_tensor(perm_np, device=device)
        return perms[device]

    def to_banded_vec(v):
        """An original-order knot vector in padded banded order."""
        out = torch.zeros(Pk, dtype=v.dtype, device=v.device)
        out[perm_on(v.device)] = v[:so]
        return out

    def from_banded_vec(vb):
        return vb[perm_on(vb.device)]

    def assemble(blocks, dtype, device):
        """Band and border Gauss-Newton blocks from the compressed rows:
        each row's ``[C, C]`` product goes to its (super-block, diagonal or
        super-diagonal, offset, offset) entries by ``index_add_`` on
        flattened ids; pairs off the band, and knot-sensor pairs in the
        band, add zeros at a clamped id."""
        opts = dict(dtype=dtype, device=device)
        Hband = torch.zeros(nb * 2 * GBD * GBD, **opts)
        Bsen = torch.zeros(max(ns, 1) * Pk, **opts)
        Csen = torch.zeros(max(ns, 1) * max(ns, 1), **opts)
        for blk, layout in zip(blocks, layouts):
            Jw, cols = blk["Jw"], blk["cols"]
            M = Jw.shape[0]
            P_full = torch.einsum("mrc,mrd->mcd", Jw, Jw)
            bidx, is_knot = [], []
            for off, si, W, td in layout.windows:
                k0 = (cols[:, off] - spec.splines[si].tangent_offset) // td
                w = torch.arange(W, device=device)
                j = torch.arange(td, device=device)
                b = (k0[:, None, None] + w[None, :, None]) * BD + int(sub_off[si]) + j
                bidx.append(b.reshape(M, W * td))
                is_knot.append(torch.ones(M, W * td, dtype=torch.bool, device=device))
            if layout.sensor_off >= 0:
                s0 = layout.sensor_off
                bidx.append(cols[:, s0:s0 + SENSOR_TANGENT_DIM] - so)
                is_knot.append(torch.zeros(M, SENSOR_TANGENT_DIM, dtype=torch.bool,
                                           device=device))
            bidx = torch.cat(bidx, dim=1)  # [M, C]
            is_knot = torch.cat(is_knot, dim=1)
            sblk = bidx // GBD
            o = bidx % GBD
            d = sblk[:, None, :] - sblk[:, :, None]  # s2 - s1
            kk = is_knot[:, :, None] & is_knot[:, None, :]
            keep = kk & ((d == 0) | (d == 1))
            lin = ((sblk.clamp(0, nb - 1)[:, :, None] * 2 + d.clamp(0, 1)) * GBD
                   + o[:, :, None]) * GBD + o[:, None, :]
            Hband.index_add_(0, lin.reshape(-1),
                             torch.where(keep, P_full, 0.0).reshape(-1))
            if layout.sensor_off >= 0:
                b1 = bidx[:, :, None].clamp(0, max(ns, 1) - 1)
                sk = (~is_knot[:, :, None]) & is_knot[:, None, :]
                lin = b1 * Pk + bidx[:, None, :].clamp(0, Pk - 1)
                Bsen.index_add_(0, lin.reshape(-1), torch.where(sk, P_full, 0.0).reshape(-1))
                ss = (~is_knot[:, :, None]) & (~is_knot[:, None, :])
                lin = b1 * max(ns, 1) + bidx[:, None, :].clamp(0, max(ns, 1) - 1)
                Csen.index_add_(0, lin.reshape(-1), torch.where(ss, P_full, 0.0).reshape(-1))
        return (Hband.reshape(nb, 2, GBD, GBD), Bsen.reshape(max(ns, 1), Pk),
                Csen.reshape(max(ns, 1), max(ns, 1)))

    def damped_system(runtime, blocks, g, lam):
        """The damped bordered system: ``(D, U, rhs, (Bsen, Cd, g_sen))``,
        the band ``D, U [nb, GBD, GBD]`` and its right-hand sides ``rhs [nb,
        GBD, 1 + ns]`` (``-g`` in banded order, then the border's columns),
        with the border's blocks (None without sensors)."""
        mask = runtime["mask"]
        Hband, Bsen, Csen = assemble(blocks, mask.dtype, mask.device)
        # damping: lam * clip(diag) + identity on locked and padded columns
        diag_band = torch.diagonal(Hband[:, 0], dim1=1, dim2=2).reshape(Pk)
        damp_band = lam * torch.clamp(diag_band, 1e-6, 1e32) + (1.0 - to_banded_vec(mask))
        D = Hband[:, 0] + torch.diag_embed(damp_band.reshape(nb, GBD))
        g_band = to_banded_vec(g)
        if not ns:
            return D, Hband[:, 1], (-g_band).reshape(nb, GBD, 1), None
        damp_sen = (lam * torch.clamp(torch.diagonal(Csen)[:ns], 1e-6, 1e32)
                    + (1.0 - mask[so:so + ns]))
        Cd = Csen[:ns, :ns] + torch.diag(damp_sen)
        rhs = torch.cat([-g_band[:, None], Bsen[:ns].T], dim=1).reshape(nb, GBD, 1 + ns)
        return D, Hband[:, 1], rhs, (Bsen[:ns], Cd, g[so:so + ns])

    def banded_solve(runtime, blocks, g, lam):
        """The damped bordered solve: ``delta [P]`` (masked)."""
        D, U, rhs, border = damped_system(runtime, blocks, g, lam)
        sol = block_tridiag_solve(D, U, rhs).reshape(Pk, -1)
        if border is None:
            return from_banded_vec(sol[:, 0]) * runtime["mask"]
        Bsen, Cd, g_sen = border
        y, X = sol[:, 0], sol[:, 1:]
        x_sen = torch.linalg.solve(Cd - Bsen @ X, -g_sen - Bsen @ y)
        return torch.cat([from_banded_vec(y - X @ x_sen), x_sen]) * runtime["mask"]

    def solve_with_pred(runtime, blocks, lam, state=None):
        """(delta, pred, grad_max) from a linearization; with ``state`` the
        delta is projected to the bounds the retraction keeps."""
        g, _, _, _ = it["grad_and_diag"](blocks)
        delta = banded_solve(runtime, blocks, g, lam)
        if state is not None:
            delta = project_delta(spec, runtime, state, delta)
        pred = -(g @ delta + 0.5 * delta @ it["hcc_matvec"](blocks, delta))
        return delta, pred, g.abs().max()

    def step(runtime, state, lam):
        cost, blocks = it["linearize"](runtime, state)
        delta, pred, grad_max = solve_with_pred(runtime, blocks, lam, state)
        new_state = it["retract"](runtime, state, delta)
        return cost, new_state, it["total_cost"](runtime, new_state), pred, delta, grad_max

    def step_spec(runtime, state, lin, lam):
        """Speculative-linearization step: solve from the linearization at
        ``state``, retract, linearize the candidate."""
        delta, pred, _ = solve_with_pred(runtime, lin[1], lam, state)
        new_state = it["retract"](runtime, state, delta)
        return new_state, it["linearize"](runtime, new_state), pred

    return dict(total_cost=it["total_cost"], linearize=it["linearize"], retract=it["retract"],
                grad_and_diag=it["grad_and_diag"], assemble=assemble,
                damped_system=damped_system, banded_solve=banded_solve,
                solve_with_pred=solve_with_pred, step=step, step_spec=step_spec)


def make_banded_step(problem):
    """``step(state, lam) -> (cost, new_state, new_cost, pred, delta,
    grad_max)`` on the exact block-tridiagonal solve, and
    ``total_cost(state)``; the problem's device runs them."""
    from .kernels import problem_runtime, problem_spec

    parts = build_banded_parts(problem_spec(problem))
    runtime = problem_runtime(problem)
    return (lambda state, lam: parts["step"](runtime, state, lam),
            lambda state: parts["total_cost"](runtime, state))
