"""Knot-segment sharding of trajectory-only problems (counterpart of
``kontiki_tpu.parallel.segments``): sequence parallelism over time.

- The knot axis is cut into contiguous segments of ``seg`` knots, a
  multiple of the superblock size ``G = W_max``; a row lives on the shard
  owning its window's base knot (time offsets locked, so ownership is
  static).
- A row whose window reaches past the segment reads ``h = W_max`` halo
  knots of the right neighbour (one ``ppermute`` a spline), and its
  Gauss-Newton products there go back to that neighbour (one extra
  superblock, returned by the reverse ``ppermute`` and added to its first).
- Each shard assembles its segment's block-tridiagonal superblocks by
  ``index_add_`` of its rows' products (the rows through kernel B4); the
  sensor border ``[ns, Pk]``, ``C`` and ``g_sen`` are summed over the
  shards.
- The band is solved distributed by SPIKE (``solver.banded.
  spike_block_tridiag_solve``) when each shard holds at least two
  superblocks, else gathered and solved on every shard; the predicted
  decrease needs one exchange of boundary blocks.

States in and out are global (knots padded to ``n seg`` inside), the same
on every shard; camera problems are rejected (they shard by landmark).
"""
import math

import numpy as np
import torch

from ..solver.banded import block_tridiag_solve, spike_block_tridiag_solve
from ..solver.iterative import _bucket_layout
from ..solver.kernels import (
    _bucket_cost,
    _retract_state,
    bucket_terms,
    problem_runtime,
    problem_spec,
)
from ..solver.problem import SENSOR_TANGENT_DIM, TANGENT_DIMS

__all__ = ["make_segment_sharded_step", "make_segment_sharded_solver"]

_SINGLE_WINDOW = ("position", "orientation", "gyro", "accel")


def _segment_layout(problem, n_shards):
    """The static layout: ``(spec, spec_global, spec_local, runtime, lay)``,
    the rows reordered by owning shard (padded per shard, ``valid`` 0 on pad
    rows pinned inside their segment)."""
    spec = problem_spec(problem)
    runtime = problem_runtime(problem)
    if any(b.kind.split(":")[0] not in _SINGLE_WINDOW for b in spec.buckets):
        raise ValueError(
            "knot-segment sharding supports single-window (trajectory/IMU) "
            "buckets; camera problems shard by landmark instead")
    mask = problem.mask.cpu().numpy()
    for i in range(len(problem.sensors)):
        if mask[problem.sensor_offset + i * SENSOR_TANGENT_DIM + 6] != 0.0:
            raise ValueError("knot-segment sharding requires locked time offsets "
                             "(window ownership must be static)")
    ns_list = [sp.n for sp in spec.splines]
    if len(set(ns_list)) != 1:
        raise ValueError("segment sharding requires all splines on one grid")
    nk = ns_list[0]
    W_max = max(max(b.windows) for b in spec.buckets)
    G = W_max
    n = n_shards
    # halo knots fetched from the right neighbour; one shard needs none
    h = W_max if n > 1 else 0
    sb = max(1, math.ceil(nk / (n * G)))
    seg = sb * G
    t0 = float(problem.splines[0].t0)
    dt = float(problem.splines[0].dt)
    dev = problem.mask.device
    new_buckets, new_data = [], []
    for bspec, data in zip(spec.buckets, runtime["data"]):
        W = max(bspec.windows)
        t_base = data["t"].cpu().numpy()
        if "sid" in data:
            d0 = np.array([problem.sensors[s].time_offset
                           for s in data["sid"].cpu().numpy()])
            t_base = t_base + d0
        i_base = np.clip(np.floor((t_base - t0) / dt).astype(np.int64), 0, nk - W)
        owner = np.minimum(i_base // seg, n - 1)
        M_per = max(int(np.bincount(owner, minlength=n).max()), 1)
        idx = np.zeros(n * M_per, dtype=np.int64)
        valid = np.zeros(n * M_per)
        for s in range(n):
            rows = np.nonzero(owner == s)[0]
            idx[s * M_per: s * M_per + len(rows)] = rows
            valid[s * M_per: s * M_per + len(rows)] = 1.0
        idx_t = torch.as_tensor(idx, device=dev)
        valid_t = torch.as_tensor(valid, device=dev)
        d = {k: v[idx_t] for k, v in data.items()}
        # pad rows stay inside the owning shard's segment (valid 0 zeroes them)
        seg_start_t = t0 + (np.arange(n * M_per) // M_per) * seg * dt
        d["t"] = torch.where(valid_t > 0, d["t"],
                             torch.as_tensor(seg_start_t + 2.0 * dt, device=dev,
                                             dtype=d["t"].dtype))
        d["valid"] = valid_t.to(problem.mask.dtype)
        new_data.append(d)
        new_buckets.append(bspec._replace(M=n * M_per))
    spec_global = spec._replace(buckets=tuple(new_buckets))
    loc_splines, off = [], 0
    for sp in spec.splines:
        loc_splines.append(sp._replace(n=seg + h, tangent_offset=off))
        off += (seg + h) * TANGENT_DIMS[sp.kind]
    spec_local = spec_global._replace(splines=tuple(loc_splines))
    runtime["data"] = new_data
    lay = dict(nk=nk, nk_pad=seg * n, seg=seg, h=h, G=G, n=n, sb_per_shard=sb, W_max=W_max,
               t0=t0, dt=dt)
    return spec, spec_global, spec_local, runtime, lay


def make_segment_sharded_step(problem, mesh):
    """``step(state, lam) -> (cost, new_state, new_cost, pred, delta,
    grad_max)`` with the knot axis sharded over ``mesh`` (the JAX package's
    ``make_segment_sharded_step``), and ``total_cost(state)``."""
    n, s = mesh.size, mesh.axis_index()
    spec, spec_global, spec_local, runtime, lay = _segment_layout(problem, n)
    seg, h, G, nk, nk_pad = lay["seg"], lay["h"], lay["G"], lay["nk"], lay["nk_pad"]
    sb = lay["sb_per_shard"]
    tds = [TANGENT_DIMS[sp.kind] for sp in spec.splines]
    BD = sum(tds)
    sub_off = np.concatenate([[0], np.cumsum(tds)[:-1]]).astype(np.int64)
    GBD = G * BD
    ns = spec.num_sensors * SENSOR_TANGENT_DIM
    Pk = (nk_pad // G) * GBD
    dev = problem.mask.device
    opts = dict(dtype=problem.mask.dtype, device=dev)
    spec_r = spec_local._replace(
        buckets=tuple(b._replace(M=b.M // n) for b in spec_local.buckets))
    layouts = [_bucket_layout(spec_r, b) for b in spec_r.buckets]
    rt = dict(runtime)
    rt["spline_t0"] = [t0 + s * (seg * dt) for t0, dt in zip(runtime["spline_t0"],
                                                              runtime["spline_dt"])]
    rt["data"] = [{k: v[s * b.M:(s + 1) * b.M] for k, v in d.items()}
                  for b, d in zip(spec_r.buckets, runtime["data"])]

    # the global banded permutation (original order -> banded order) over
    # the padded knots, as in solver.banded
    perm_np = np.zeros(spec.sensor_offset, dtype=np.int64)
    for si, sp in enumerate(spec.splines):
        k, j = np.meshgrid(np.arange(sp.n), np.arange(tds[si]), indexing="ij")
        perm_np[(sp.tangent_offset + k * tds[si] + j).ravel()] = (k * BD + sub_off[si] + j).ravel()
    perm = torch.as_tensor(perm_np, device=dev)
    mask = problem.mask
    mask_band = torch.zeros(Pk, **opts)
    mask_band[perm] = mask[:spec.sensor_offset]
    mask_sen = mask[spec.sensor_offset:spec.sensor_offset + ns]
    # this shard's knot columns in banded order, the halo included (the
    # last shard's halo reaches past Pk: zeros)
    mask_loc = torch.cat([mask_band, torch.zeros(h * BD, **opts)])[
        s * seg * BD:(s * seg + seg + h) * BD]
    fwd = [(i, (i - 1) % n) for i in range(n)]  # shard i + 1 -> shard i
    rev = [(i, (i + 1) % n) for i in range(n)]  # shard i -> shard i + 1

    def local_state(state):
        """This shard's knots with the right neighbour's first h knots."""
        out = dict(state)
        knots = [state[sp.kind][s * seg:(s + 1) * seg] for sp in spec.splines]
        halos = mesh.ppermute([k[:h] for k in knots], fwd) if h else [k[:0] for k in knots]
        for sp, k, hk in zip(spec.splines, knots, halos):
            out[sp.kind] = torch.cat([k, hk])
        return out

    def cost_local(state):
        st = local_state(state)
        cost = torch.zeros((), **opts)
        for bspec, data in zip(spec_r.buckets, rt["data"]):
            r = bucket_terms(spec_r, bspec, rt, st, data, cost_only=True)
            cost = cost + _bucket_cost(bspec, data, r)[0]
        return mesh.psum(cost)

    def linearize_local(state):
        """This shard's band ``(cost, D [sb, GBD, GBD], U, g [sb GBD])`` with
        the halo superblock returned to its owner, and the sensor border
        ``(B [ns, Pk], C, g_sen)`` summed over the shards."""
        st = local_state(state)
        nsb = max(ns, 1)
        Dband = torch.zeros((sb + 1) * GBD * GBD, **opts)
        Uband = torch.zeros((sb + 1) * GBD * GBD, **opts)
        gband = torch.zeros((sb + 1) * GBD, **opts)
        Bsen = torch.zeros(nsb * Pk, **opts)
        Csen = torch.zeros(nsb * nsb, **opts)
        gsen = torch.zeros(nsb, **opts)
        cost = torch.zeros((), **opts)
        for bspec, data, layout in zip(spec_r.buckets, rt["data"], layouts):
            r, J, cols, _ = bucket_terms(spec_r, bspec, rt, st, data)
            c, rho_p = _bucket_cost(bspec, data, r)
            cost = cost + c
            sq = torch.sqrt(rho_p)
            M = J.shape[0]
            bidx, is_knot = [], []
            for off, si, W, td in layout.windows:
                k0 = (cols[:, off] - spec_r.splines[si].tangent_offset) // td
                w = torch.arange(W, device=dev)
                j = torch.arange(td, device=dev)
                b = (k0[:, None, None] + w[None, :, None]) * BD + int(sub_off[si]) + j
                bidx.append(b.reshape(M, W * td))
                is_knot.append(torch.ones(M, W * td, dtype=torch.bool, device=dev))
            if layout.sensor_off >= 0:
                so = layout.sensor_off
                bidx.append(cols[:, so:so + SENSOR_TANGENT_DIM] - spec_r.sensor_offset)
                is_knot.append(torch.zeros(M, SENSOR_TANGENT_DIM, dtype=torch.bool,
                                           device=dev))
            bidx = torch.cat(bidx, dim=1)
            is_knot = torch.cat(is_knot, dim=1)
            # lock mask and whitening per row
            colmask = torch.where(is_knot, mask_loc[bidx.clamp(0, mask_loc.numel() - 1)],
                                  mask_sen[bidx.clamp(0, nsb - 1)] if ns else 0.0)
            Jw = J * colmask[:, None, :] * sq[:, None, None]
            rw = r * sq[:, None]
            P_full = torch.einsum("mrc,mrd->mcd", Jw, Jw)
            gv = torch.einsum("mrc,mr->mc", Jw, rw)
            sblk = bidx // GBD
            o = bidx % GBD
            d = sblk[:, None, :] - sblk[:, :, None]
            kk = is_knot[:, :, None] & is_knot[:, None, :]
            lin = ((sblk.clamp(0, sb)[:, :, None] * GBD + o[:, :, None]) * GBD
                   + o[:, None, :]).reshape(-1)
            Dband.index_add_(0, lin, torch.where(kk & (d == 0), P_full, 0.0).reshape(-1))
            Uband.index_add_(0, lin, torch.where(kk & (d == 1), P_full, 0.0).reshape(-1))
            gband.index_add_(0, bidx.clamp(0, (sb + 1) * GBD - 1).reshape(-1),
                             torch.where(is_knot, gv, 0.0).reshape(-1))
            if layout.sensor_off >= 0:
                # the sensor-knot coupling at global banded column ids
                gcol = bidx + s * seg * BD
                b1 = bidx[:, :, None].clamp(0, nsb - 1)
                sk = (~is_knot[:, :, None]) & is_knot[:, None, :] & (gcol < Pk)[:, None, :]
                Bsen.index_add_(0, (b1 * Pk + gcol[:, None, :].clamp(0, Pk - 1)).reshape(-1),
                                torch.where(sk, P_full, 0.0).reshape(-1))
                ss = (~is_knot[:, :, None]) & (~is_knot[:, None, :])
                Csen.index_add_(0, (b1 * nsb + bidx[:, None, :].clamp(0, nsb - 1)).reshape(-1),
                                torch.where(ss, P_full, 0.0).reshape(-1))
                gsen.index_add_(0, bidx.clamp(0, nsb - 1).reshape(-1),
                                torch.where(~is_knot, gv, 0.0).reshape(-1))
        Dband = Dband.reshape(sb + 1, GBD, GBD)
        Uband = Uband.reshape(sb + 1, GBD, GBD)
        # the halo superblock's sums belong to the right neighbour's block 0
        D_h, g_h, U_h = mesh.ppermute([Dband[sb], gband[sb * GBD:], Uband[sb]], rev)
        Dloc = Dband[:sb].clone()
        Dloc[0] += D_h
        gloc = gband[:sb * GBD].clone()
        gloc[:GBD] += g_h
        Uloc = Uband[:sb].clone()
        Uloc[0] += U_h
        cost, Bsen, Csen, gsen = mesh.psum([cost, Bsen.reshape(nsb, Pk),
                                            Csen.reshape(nsb, nsb), gsen])
        return cost, Dloc, Uloc, gloc, Bsen, Csen, gsen

    def damped(D, g, mask_b, lam, Bcols, Csen, gsen):
        nb = D.shape[0]
        damp = lam * torch.clamp(torch.diagonal(D, dim1=1, dim2=2).reshape(-1), 1e-6, 1e32) \
            + (1.0 - mask_b)
        Dd = D + torch.diag_embed(damp.reshape(nb, GBD))
        if not ns:
            return Dd, (-g).reshape(nb, GBD, 1), None
        damp_s = lam * torch.clamp(torch.diagonal(Csen)[:ns], 1e-6, 1e32) + (1.0 - mask_sen)
        rhs = torch.cat([-g[:, None], Bcols.T], dim=1).reshape(nb, GBD, 1 + ns)
        return Dd, rhs, Csen[:ns, :ns] + torch.diag(damp_s)

    def band_hx(D, U, x, x_next0=None, x_prevl=None, U_prevl=None):
        """``T x`` on this shard's blocks, with the neighbours' boundary
        blocks where the band crosses to them."""
        xs = x.reshape(-1, GBD)
        Hx = torch.einsum("kij,kj->ki", D, xs)
        Hx[:-1] += torch.einsum("kij,kj->ki", U[:-1], xs[1:])
        Hx[1:] += torch.einsum("kji,kj->ki", U[:-1], xs[:-1])
        if x_next0 is not None:
            Hx[-1] += U[-1] @ x_next0
            Hx[0] += U_prevl.T @ x_prevl
        return Hx.reshape(-1)

    def solve_spike(D, U, g, Bsen, Csen, gsen, lam):
        """The distributed band solve (SPIKE) and the replicated sensor
        border; pred and max |gradient| with one neighbour exchange."""
        start = s * sb * GBD
        Bloc = Bsen[:ns, start:start + sb * GBD]
        Dd, rhs, Cd = damped(D, g, mask_band[start:start + sb * GBD], lam, Bloc, Csen, gsen)
        sol = spike_block_tridiag_solve(Dd, U, rhs, mesh).reshape(sb * GBD, -1)
        y = sol[:, 0]
        if ns:
            X = sol[:, 1:]
            BX, By = mesh.psum([Bloc @ X, Bloc @ y])
            x_sen = torch.linalg.solve(Cd - BX, -gsen[:ns] - By)
            x_band = y - X @ x_sen
        else:
            x_sen = torch.zeros(0, **opts)
            x_band = y
        xs = x_band.reshape(sb, GBD)
        x_next0 = mesh.ppermute(xs[0], fwd)
        x_prevl, U_prevl = mesh.ppermute([xs[sb - 1], U[sb - 1]], rev)
        last = 0.0 if s == n - 1 else 1.0
        first = 0.0 if s == 0 else 1.0
        Hx = band_hx(D, U, x_band, last * x_next0, x_prevl, first * U_prevl)
        gTd, dHd = mesh.psum(torch.stack([g @ x_band, x_band @ Hx]))
        if ns:
            Bx = mesh.psum(Bloc @ x_band)
            gTd = gTd + gsen[:ns] @ x_sen
            dHd = dHd + 2.0 * x_sen @ Bx + x_sen @ (Csen[:ns, :ns] @ x_sen)
        gmax = mesh.pmax(g.abs().max())
        if ns:
            gmax = torch.maximum(gmax, gsen[:ns].abs().max())
        x_full = mesh.allgather(x_band)
        return torch.cat([x_full[perm], x_sen]) * mask, -(gTd + 0.5 * dHd), gmax

    def solve_gathered(D, U, g, Bsen, Csen, gsen, lam):
        """The band gathered to every shard and solved there (fewer than
        two superblocks a shard)."""
        D, U, g = mesh.allgather([D, U, g])
        Dd, rhs, Cd = damped(D, g, mask_band, lam, Bsen[:ns], Csen, gsen)
        sol = block_tridiag_solve(Dd, U, rhs).reshape(Pk, -1)
        if ns:
            y, X = sol[:, 0], sol[:, 1:]
            x_sen = torch.linalg.solve(Cd - Bsen[:ns] @ X, -gsen[:ns] - Bsen[:ns] @ y)
            x_band = y - X @ x_sen
        else:
            x_band, x_sen = sol[:, 0], torch.zeros(0, **opts)
        gTd = g @ x_band + (gsen[:ns] @ x_sen if ns else 0.0)
        dHd = x_band @ band_hx(D, U, x_band)
        if ns:
            dHd = dHd + 2.0 * x_sen @ (Bsen[:ns] @ x_band) + x_sen @ (Csen[:ns, :ns] @ x_sen)
        gmax = g.abs().max()
        if ns:
            gmax = torch.maximum(gmax, gsen[:ns].abs().max())
        return torch.cat([x_band[perm], x_sen]) * mask, -(gTd + 0.5 * dHd), gmax

    solve = solve_spike if n > 1 and sb >= 2 else solve_gathered

    # the retraction on the padded global state
    pad_splines, off = [], 0
    for sp in spec.splines:
        pad_splines.append(sp._replace(n=nk_pad, tangent_offset=off))
        off += nk_pad * TANGENT_DIMS[sp.kind]
    tail = spec.num_tangent - spec.sensor_offset
    spec_pad = spec._replace(splines=tuple(pad_splines), sensor_offset=off,
                             landmark_offset=off + ns, vt_offset=off + ns,
                             num_tangent=off + tail)

    def extend(v, fill):
        parts = []
        for sp, td in zip(spec.splines, tds):
            parts.append(v[sp.tangent_offset:sp.tangent_offset + nk * td])
            parts.append(fill((nk_pad - nk) * td))
        parts.append(v[spec.sensor_offset:])
        return torch.cat(parts)

    rt_pad = {"mask": extend(mask, lambda k: torch.zeros(k, **opts)), "d_max": runtime["d_max"]}

    def pad_knots(state):
        out = dict(state)
        for sp in spec.splines:
            arr = state[sp.kind]
            if nk_pad > arr.shape[0]:
                out[sp.kind] = torch.cat([arr, arr[-1:].expand(nk_pad - arr.shape[0], -1)])
        return out

    def step(state, lam):
        st = pad_knots(state)
        cost, *lin = linearize_local(st)
        delta, pred, gmax = solve(*lin, lam)
        new_st = _retract_state(spec_pad, rt_pad, st,
                                extend(delta, lambda k: torch.zeros(k, **opts)))
        new_cost = cost_local(new_st)
        out = dict(new_st)
        for sp in spec.splines:
            out[sp.kind] = new_st[sp.kind][:nk]
        return cost, out, new_cost, pred, delta, gmax

    return step, lambda state: cost_local(pad_knots(state))


def make_segment_sharded_solver(problem, mesh, max_iterations=50, function_tolerance=1e-6):
    """LM through the knot-segment-sharded step on every shard: ``solve(
    state) -> (state, final_cost, iterations)``."""
    from ..solver.lm import trust_region_loop

    step, total_cost = make_segment_sharded_step(problem, mesh)

    def solve(state):
        return trust_region_loop(step, total_cost(state), state,
                                 max_iterations=max_iterations,
                                 function_tolerance=function_tolerance)

    return solve
