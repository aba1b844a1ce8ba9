"""Knot-segment x landmark-block bundle adjustment on a process-group
mesh, banded direct solve or matrix-free PCG (counterpart of
``kontiki_tpu.parallel.segments_ba``; BASELINE config 5).

The layout (``segment_ba_layout``, host numpy, any number of shards) cuts
the knot axis into contiguous segments of ``seg`` knots and gives every
landmark, with all of its rows, to the segment that owns its reference
window; a lifting row's ``vt`` goes with its row. Superblocks of ``G``
knots are wide enough that each row and each landmark touches at most two
consecutive superblocks, so the reduced system (knots and sensors,
landmarks eliminated) is block-tridiagonal in superblocks with a dense
sensor border.

One LM iteration of the banded mode (``mode="banded"``):

1. linearize: each bucket's compressed rows ``J [M, rdim, C]`` (camera rows
   through kernel B1, Newton rows through B8 on their W-knot windows, IMU
   rows through B4, pose rows on ``torch.func``), robust-whitened, columns
   in the segment's local layout (``whitened_blocks``);
2. assemble: each row's columns become pair-window ids relative to its
   anchor superblock (``colrel``), kernel B6
   (``ops.linearize_kernels.onehot_expand_rows``) expands the rows to dense
   pair-window rows ``Jd [M, rdim, WB]``, ``WB = 2 G BD + ns``, and batched
   products per anchor give the pair blocks ``Pa [nbloc, WB, WB]``, ``ga``
   and the landmark-slot blocks ``Ea``, ``Da``, ``gla``; lock masks apply
   after assembly (``assemble_band``);
3. solve: damping from the pair blocks' diagonals, landmark elimination in
   slot space, the block-tridiagonal solve (``solver.banded.
   block_tridiag_solve``; SPIKE on several shards) with the sensor border
   as extra right-hand sides, the 13 x 13-per-sensor Schur solve, landmark
   back-substitution, and the predicted decrease from the same blocks;
4. retract and re-linearize the candidate: its cost is the re-cost
   (``make_segment_ba_solver`` runs ``lm.trust_region_loop_spec`` on the
   carried ``(cost, assembly, mask_l)``).

The PCG mode (``mode="pcg"``) linearizes the rows masked per column, with
the gradient, the duplicate-aware diagonal and per-knot and per-sensor
preconditioner blocks (``linearize_pcg``, on ``solver.iterative``'s
``grad_and_diag`` and ``precond_blocks``), solves the damped Schur complement by PCG on the
compressed rows (``solve_pcg``; a lifting row's ``vt`` is a column past the
sensor border, preconditioned by its diagonal and clipped to [0, 1]), and
re-costs the candidate in ``lm.trust_region_loop``.

Each shard is one rank of a ``parallel.mesh.Mesh``: it stores its
``seg`` knots of each spline, its ``Lb`` landmark slots and its lifting
rows' ``vt`` slots, and holds the rows it owns. Windows that cross the
segment read two-sided knot halos (``Hl`` knots from the left neighbour,
``Hr`` from the right: one ``ppermute`` a side for all splines), and the
halo columns' sums go back to their owners (``reduce_halo``: knot
gradients, diagonals and preconditioner blocks in PCG mode, the pair
blocks folded per anchor in banded mode). The sensor border, the costs,
the predicted decrease and the CG dots are ``psum``s, max |gradient| a
``pmax``; the band is solved by SPIKE across the shards
(``solver.banded.spike_block_tridiag_solve``); ``to_global`` gathers the
segments, so every rank returns the same global state. The trust-region
loop runs on every rank and reads the same reduced scalars. ``mesh=None``
is the one-shard mesh: the halos are empty (``Hl = Hr = 0``), the knot and
landmark arrays are the whole problem padded to ``seg`` knots, and every
collective is an identity. Lifting buckets raise ``ValueError`` in banded
mode, as the JAX package's do: their per-row ``vt`` columns ride the PCG
mode.
"""
import math

import numpy as np
import torch

from ..math import quaternion as quat
from ..math import se3 as se3m
from ..ops.linearize_kernels import onehot_expand_rows
from ..solver.banded import block_tridiag_solve, spike_block_tridiag_solve
from ..solver.iterative import (
    Columns,
    _bucket_layout,
    e_matvec,
    et_matvec,
    grad_and_diag,
    hcc_matvec,
    pcg,
    precond_blocks,
    preconditioner,
)
from ..solver.kernels import (
    _bucket_cost,
    bucket_terms,
    landmark_free_mask,
    problem_runtime,
    problem_spec,
    retract_window,
)
from ..solver.lm import trust_region_loop, trust_region_loop_spec
from ..solver.problem import SENSOR_TANGENT_DIM, TANGENT_DIMS, as_tensor
from .mesh import Mesh

__all__ = ["make_segment_ba_step", "make_segment_ba_solver", "segment_ba_layout"]

_SINGLE_WINDOW = ("position", "orientation", "gyro", "accel")


def _numpy(a):
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _rank_in_groups(keys):
    """Rank of each entry among the entries with the same key, in index
    order (a running count per key)."""
    order = np.argsort(keys, kind="stable")
    sk = keys[order]
    first = np.ones(len(sk), dtype=bool)
    first[1:] = sk[1:] != sk[:-1]
    starts = np.maximum.accumulate(np.where(first, np.arange(len(sk)), 0))
    rank = np.empty(len(keys), dtype=np.int64)
    rank[order] = np.arange(len(sk)) - starts
    return rank


def segment_ba_layout(problem, n_shards):
    """Static layout of the composed sharding, host numpy.

    Returns ``(spec, spec_local, runtime, lay)``: the global spec, the
    per-shard spec (splines ``Hl + seg + Hr`` knots long, ``Lb`` landmark
    slots), the runtime whose bucket data are reordered by owning shard
    (padded per shard, ``valid`` 0 on pad rows; landmark ids rewritten to
    per-shard slots; ``anchor`` and, on camera rows, ``lrel`` added; on the
    problem's device) and ``lay``, the sizes and tables (numpy)."""
    spec = problem_spec(problem)
    runtime = problem_runtime(problem)
    kinds = [b.kind.split(":")[0] for b in spec.buckets]
    for k in kinds:
        if k not in _SINGLE_WINDOW + ("rs_static", "rs_newton", "rs_lifting"):
            raise ValueError(
                f"segment BA sharding supports rs_static/rs_newton/"
                f"rs_lifting + trajectory/IMU buckets; got {k}"
            )
    mask = _numpy(problem.mask)
    d0 = np.array([s.time_offset if hasattr(s, "time_offset") else 0.0
                   for s in problem.sensors])
    S_n = len(problem.sensors)
    d_unlocked = np.array([
        mask[problem.sensor_offset + i * SENSOR_TANGENT_DIM + 6] != 0.0
        for i in range(S_n)
    ], dtype=bool)
    d_max_s = _numpy(problem.d_max).reshape(-1)[: max(S_n, 1)]
    # an unlocked time offset moves a row's window over t -+ d_max, a locked
    # one keeps it at d0: ownership and anchors come from the lower bound,
    # halos and superblocks cover the whole range
    if S_n:
        t_add_lo = np.where(d_unlocked, -d_max_s[:S_n], d0)
        t_add_hi = np.where(d_unlocked, d_max_s[:S_n], d0)
    else:
        t_add_lo = t_add_hi = d0
    grids = {(sp.n, round(float(problem.splines[i].t0), 12),
              round(float(problem.splines[i].dt), 12))
             for i, sp in enumerate(spec.splines)}
    if len(grids) != 1:
        raise ValueError("segment BA sharding requires all splines on one grid")
    nk = spec.splines[0].n
    t0 = float(problem.splines[0].t0)
    dt = float(problem.splines[0].dt)
    W_max = max(max(b.windows) for b in spec.buckets)
    n = n_shards
    data_np = [{k: _numpy(v) for k, v in data.items()} for data in runtime["data"]]

    # --- row ownership + halo sizing: rows' window-base knots as the
    # linearization computes them (frame-start times for camera rows,
    # clipped to n - W)
    i_refs, i_obs_list, i_ref_hi_list, i_obs_hi_list = [], [], [], []
    max_dpos = 0  # max rightward column reach beyond the anchor (knots)
    max_dneg = 0  # max leftward column reach before the anchor (knots)
    for bspec, d in zip(spec.buckets, data_np):
        W_b = max(bspec.windows)

        def _idx(t):
            return np.clip(np.floor((t - t0) / dt).astype(np.int64), 0, nk - W_b)

        i_obs = i_obs_hi = None
        if bspec.kind.startswith("rs_"):
            lo_add = t_add_lo[d["sid"]]
            hi_add = t_add_hi[d["sid"]]
            i_ref = _idx(d["t0_ref"] + lo_add)
            i_ref_hi = _idx(d["t0_ref"] + hi_add)
            i_obs = _idx(d["t0_obs"] + lo_add)
            i_obs_hi = _idx(d["t0_obs"] + hi_add)
            if len(i_ref):
                right = np.maximum(i_obs_hi, i_ref_hi) - i_ref
                left = np.maximum(i_ref - i_obs, 0)
                max_dpos = max(max_dpos, int(right.max()))
                max_dneg = max(max_dneg, int(left.max()))
        else:
            if "sid" in d:
                lo_add = t_add_lo[d["sid"]]
                hi_add = t_add_hi[d["sid"]]
            else:
                lo_add = hi_add = np.zeros(len(d["t"]))
            i_ref = _idx(d["t"] + lo_add)
            i_ref_hi = _idx(d["t"] + hi_add)
            if len(i_ref):
                max_dpos = max(max_dpos, int((i_ref_hi - i_ref).max()))
        i_refs.append(i_ref)
        i_obs_list.append(i_obs)
        i_ref_hi_list.append(i_ref_hi)
        i_obs_hi_list.append(i_obs_hi)

    # per-landmark knot-column support [lm_lo, lm_hi + W_max): all of a
    # landmark's rows anchor at its block, so G must hold the landmark's
    # whole support in two superblocks
    L = spec.num_landmarks
    lm_lo = np.full(max(L, 1), 10**9, dtype=np.int64)
    lm_hi = np.full(max(L, 1), -1, dtype=np.int64)
    for bspec, d, i_ref, i_obs, i_ref_hi, i_obs_hi in zip(
        spec.buckets, data_np, i_refs, i_obs_list, i_ref_hi_list, i_obs_hi_list
    ):
        if not bspec.kind.startswith("rs_"):
            continue
        np.minimum.at(lm_lo, d["lid"], np.minimum(i_ref, i_obs))
        np.maximum.at(lm_hi, d["lid"], np.maximum(i_ref_hi, i_obs_hi))

    # superblock size: every row / landmark touches at most two
    # consecutive G-blocks, so the reduced system is block-tridiagonal
    G = max(max_dpos + max_dneg + W_max, 2)
    seen_lm = lm_hi >= 0
    if seen_lm.any():
        span = lm_hi[seen_lm] - lm_lo[seen_lm] + W_max
        G = max(G, int(span.max()))
        assert (
            lm_hi[seen_lm] + W_max - 1 - (lm_lo[seen_lm] // G) * G < 2 * G
        ).all(), "landmark column support exceeds two G-superblocks"
    if n == 1:
        Hl = Hr = 0
        # one extra pad block so the (anchor, anchor+1) pair always exists
        seg = (int(math.ceil(nk / G)) + 1) * G
    else:
        Hl = int(math.ceil((max_dneg + W_max) / G)) * G
        Hr = int(math.ceil((max_dpos + W_max) / G)) * G
        # one-hop halos must fit in a neighbour's segment, and a distributed
        # band solve needs >= 2 superblocks per shard
        seg = max(int(math.ceil(nk / n)), W_max, Hl, Hr, 2 * G)
        seg = int(math.ceil(seg / G)) * G
    nk_pad = seg * n
    owners = [np.minimum(i_ref // seg, n - 1) for i_ref in i_refs]

    # --- landmark blocks: owner = owner of the landmark's rows ----------
    lm_owner = np.zeros(L, dtype=np.int64)
    seen = np.zeros(L, dtype=bool)
    for bspec, d, owner in zip(spec.buckets, data_np, owners):
        if not bspec.kind.startswith("rs_"):
            continue
        lid = d["lid"]
        lm_owner[lid] = np.where(seen[lid], lm_owner[lid], owner)
        seen[lid] = True
        if np.any(lm_owner[lid] != owner):
            raise ValueError("landmark observed from rows on multiple shards")
    lm_owner[~seen] = 0
    counts_l = np.bincount(lm_owner, minlength=n)
    Lb = max(int(counts_l.max()), 1)
    # global landmark id -> (owner, slot), slots in id order
    slot = _rank_in_groups(lm_owner)
    lid_to_padded = lm_owner * Lb + slot  # [L] -> index into [n*Lb]

    # --- lifting row times: one vt per row, owned with its row (each row
    # touches only its own vt, so the vt axis shards with row ownership)
    V = spec.num_vt
    vt_owner = np.zeros(max(V, 1), dtype=np.int64)
    vt_seen = np.zeros(max(V, 1), dtype=bool)
    for bspec, d, owner in zip(spec.buckets, data_np, owners):
        if bspec.kind == "rs_lifting":
            vt_owner[d["vt_idx"]] = owner
            vt_seen[d["vt_idx"]] = True
    Vb = 1
    vslot = np.zeros(max(V, 1), dtype=np.int64)
    if V:
        Vb = max(int(np.bincount(vt_owner[vt_seen], minlength=n).max()), 1)
        seen_ids = np.nonzero(vt_seen)[0]
        vslot[seen_ids] = _rank_in_groups(vt_owner[seen_ids])
    vtid_to_padded = vt_owner * Vb + vslot  # [V] -> index into [n*Vb]

    # --- banded-block bookkeeping ------------------------------------------
    sbG = seg // G
    hl_b, hr_b = Hl // G, Hr // G
    nbloc = hl_b + sbG + hr_b
    lm_imin = lm_lo  # per-landmark minimum window knot

    # landmark anchor block (local ids) + per-(shard, anchor) slot layout
    la_of_lm = np.zeros(max(L, 1), dtype=np.int64)
    if L:
        la_of_lm = np.where(seen, lm_imin[:L] // G - lm_owner * sbG + hl_b, 0)
        if seen.any():
            chk = la_of_lm[seen]
            assert chk.min() >= 0 and chk.max() <= nbloc - 2, (
                chk.min(), chk.max(), nbloc)
    slot_in_anchor = np.zeros(max(L, 1), dtype=np.int64)
    LaMax = 1
    lid_of_slot = np.zeros((n, nbloc, 1), dtype=np.int64)
    smask = np.zeros((n, nbloc, 1))
    if L:
        # running count per (shard, anchor) in landmark id order
        slot_in_anchor = _rank_in_groups(lm_owner * nbloc + la_of_lm)
        LaMax = max(int(slot_in_anchor.max()) + 1, 1)
        lid_of_slot = np.zeros((n, nbloc, LaMax), dtype=np.int64)
        smask = np.zeros((n, nbloc, LaMax))
        lid_of_slot[lm_owner, la_of_lm, slot_in_anchor] = slot
        smask[lm_owner, la_of_lm, slot_in_anchor] = 1.0

    # --- reindex rows per shard ------------------------------------------
    new_data = []
    new_buckets = []
    banded_tables = []
    for bspec, d, owner, i_ref in zip(spec.buckets, data_np, owners, i_refs):
        cam = bspec.kind.startswith("rs_")
        counts = np.bincount(owner, minlength=n)
        M_per = max(int(counts.max()), 1)
        idx = np.zeros(n * M_per, dtype=np.int64)
        valid = np.zeros(n * M_per)
        for s in range(n):
            rows = np.nonzero(owner == s)[0]
            idx[s * M_per: s * M_per + len(rows)] = rows
            valid[s * M_per: s * M_per + len(rows)] = 1.0
        owner_row = np.arange(n * M_per) // M_per
        # anchor block of each (reordered) row, a local block id: camera
        # rows anchor at their landmark's block, so one grouping serves both
        # the H and the landmark-elimination passes
        if cam:
            anchor = lm_imin[d["lid"][idx]] // G - owner_row * sbG + hl_b
            lrel = slot_in_anchor[d["lid"][idx]]
        else:
            anchor = i_ref[idx] // G - owner_row * sbG + hl_b
            lrel = None
        d = {k: v[idx] for k, v in d.items()}
        seg_start_t = t0 + (np.arange(n * M_per) // M_per) * seg * dt
        pin_t = seg_start_t + min(W_max + 1, max(seg - 4, 1)) * dt
        # pad rows: pinned inside the owning segment, anchored from the
        # pinned time (valid = 0 zeroes their contributions)
        i_pin = np.clip(((pin_t - t0) / dt).astype(np.int64), 0, nk_pad - 4)
        a_pin = np.clip(i_pin // G - owner_row * sbG + hl_b, 0, nbloc - 2)
        anchor = np.where(valid > 0, anchor, a_pin)
        assert anchor.min() >= 0 and anchor.max() <= nbloc - 2, (
            anchor.min(), anchor.max(), nbloc)
        if cam:
            d["t0_ref"] = np.where(valid > 0, d["t0_ref"], pin_t)
            d["t0_obs"] = np.where(valid > 0, d["t0_obs"], pin_t)
            d["v_ref"] = np.where(valid > 0, d["v_ref"], 0.0)
            d["v_obs"] = np.where(valid > 0, d["v_obs"], 0.0)
            # local slot ids replace the global ids inside a shard
            d["lid"] = np.where(valid > 0, slot[d["lid"]], 0)
            d["lrel"] = np.where(valid > 0, lrel, 0)
            if "vt_idx" in d:
                d["vt_idx"] = np.where(valid > 0, vslot[d["vt_idx"]], 0)
        else:
            d["t"] = np.where(valid > 0, d["t"], pin_t)
        d["valid"] = valid.astype(mask.dtype)
        d["anchor"] = anchor.astype(np.int64)

        # anchor-grouped row permutation per shard, padded uniformly: the
        # valid rows of each (shard, anchor) in row order
        shard_of = np.arange(n * M_per) // M_per
        rows = np.nonzero(valid > 0)[0]
        key = shard_of[rows] * nbloc + anchor[rows]
        fill = _rank_in_groups(key)
        Ma = max(int(fill.max()) + 1 if len(rows) else 1, 1)
        perm = np.zeros((n, nbloc, Ma), dtype=np.int64)
        pmask = np.zeros((n, nbloc, Ma))
        perm[shard_of[rows], anchor[rows], fill] = rows - shard_of[rows] * M_per
        pmask[shard_of[rows], anchor[rows], fill] = 1.0
        banded_tables.append(dict(
            perm=perm.reshape(n, nbloc * Ma),
            pmask=pmask.reshape(n, nbloc * Ma).astype(mask.dtype),
            Ma=Ma,
        ))
        new_data.append({k: as_tensor(v, problem.device, problem.dtype)
                         for k, v in d.items()})
        new_buckets.append(bspec._replace(M=n * M_per))

    # local spec: per-shard knot arrays are [Hl + seg + Hr] long, the
    # landmark table is the local block [Lb]
    nloc = Hl + seg + Hr
    loc_splines = []
    off = 0
    for sp in spec.splines:
        loc_splines.append(sp._replace(n=nloc, tangent_offset=off))
        off += nloc * TANGENT_DIMS[sp.kind]
    Pk_loc = off
    spec_local = spec._replace(
        splines=tuple(loc_splines),
        buckets=tuple(new_buckets),
        num_landmarks=Lb,
        num_vt=Vb if V else 0,
    )
    runtime["data"] = new_data

    # landmark mask, permuted into padded slots
    mask_l = np.zeros(n * Lb, dtype=mask.dtype)
    if L:
        mask_l[lid_to_padded] = mask[spec.landmark_offset: spec.landmark_offset + L]
    # vt mask, permuted into padded slots
    mask_v = np.zeros(n * Vb, dtype=mask.dtype)
    if V:
        mask_v[vtid_to_padded[:V]] = mask[spec.vt_offset: spec.vt_offset + V]
    # knot tangent mask, padded to nk_pad (pad knots are locked)
    kmask = []
    for sp in spec.splines:
        td = TANGENT_DIMS[sp.kind]
        m = mask[sp.tangent_offset: sp.tangent_offset + nk * td]
        kmask.append(
            np.concatenate([m, np.zeros((nk_pad - nk) * td, mask.dtype)]).reshape(nk_pad, td)
        )
    ns = len(problem.sensors) * SENSOR_TANGENT_DIM
    mask_sen = mask[spec.sensor_offset: spec.sensor_offset + ns]

    lay = dict(
        nk=nk, nk_pad=nk_pad, seg=seg, Hl=Hl, Hr=Hr, n=n, Lb=Lb, L=L,
        t0=t0, dt=dt, Pk_loc=Pk_loc, ns=ns, nloc=nloc,
        V=V, Vb=Vb, vtid_to_padded=vtid_to_padded[:V], mask_v=mask_v,
        lid_to_padded=lid_to_padded,
        mask_l=mask_l, mask_sen=mask_sen, kmask=kmask,
        W_max=W_max,
        # banded reduced-system structure
        G=G, sbG=sbG, hl_b=hl_b, hr_b=hr_b, nbloc=nbloc, LaMax=LaMax,
        lid_of_slot=lid_of_slot.reshape(n, nbloc * LaMax),
        smask=smask.reshape(n, nbloc * LaMax).astype(mask.dtype),
        banded_tables=banded_tables,
    )
    return spec, spec_local, runtime, lay


def _check_supported(problem, mode):
    if mode not in ("banded", "pcg"):
        raise ValueError(f"segment BA mode must be 'banded' or 'pcg', got {mode!r}")
    if mode == "banded" and any(k.split(":")[0] == "rs_lifting" for k in problem.buckets):
        raise ValueError(
            "rs_lifting buckets ride the segment-BA PCG mode (per-row vt "
            "columns are not banded); use mode='pcg'")


def _as_mesh(mesh, n_shards, device):
    """The mesh of the entry points: ``mesh`` as given, or with ``mesh=None``
    the one-shard mesh (``n_shards`` None or 1, the callers from before the
    mesh argument)."""
    if mesh is None:
        if n_shards not in (None, 1):
            raise ValueError(
                f"segment BA on {n_shards} shards runs on a mesh of {n_shards} ranks: pass "
                "mesh= (parallel.launch.run_spmd, parallel.distributed.global_mesh)")
        return Mesh(device=device)
    if n_shards not in (None, mesh.size):
        raise ValueError(f"n_shards={n_shards} on a mesh of {mesh.size} ranks")
    return mesh


def _build_segment_ba(problem, mesh, mode, cg_tol=1e-10, cg_maxiter=500):
    """This rank's parts of the step, banded or PCG (see the module
    docstring); ``mesh`` is a ``parallel.mesh.Mesh`` or None (one shard)."""
    _check_supported(problem, mode)
    mesh = _as_mesh(mesh, None, problem.device)
    n, s = mesh.size, mesh.axis_index()
    dev = problem.device
    spec, spec_local, runtime, lay = segment_ba_layout(problem, n)
    # this rank's rows: the layout orders every bucket by owning shard
    spec_local = spec_local._replace(
        buckets=tuple(b._replace(M=b.M // n) for b in spec_local.buckets))
    layouts = [_bucket_layout(spec_local, b) for b in spec_local.buckets]
    dtype = problem.mask.dtype
    opts = dict(dtype=dtype, device=dev)
    seg, Hl, Hr, nloc = lay["seg"], lay["Hl"], lay["Hr"], lay["nloc"]
    Lb, Pk_loc, ns = lay["Lb"], lay["Pk_loc"], lay["ns"]
    # the lifting rows' vt slots: local columns past the sensor border
    nvt = lay["Vb"] if lay["V"] else 0
    tds = [TANGENT_DIMS[sp.kind] for sp in spec.splines]
    S = len(problem.sensors)
    # owned-vector layout: per-spline [seg * td] slices; local: [nloc * td]
    own_off = np.concatenate([[0], np.cumsum([seg * td for td in tds])]).astype(np.int64)
    loc_off = np.concatenate([[0], np.cumsum([nloc * td for td in tds])]).astype(np.int64)
    Pown = int(own_off[-1])

    # local knot i is global knot s * seg - Hl + i: the spline origins shift,
    # and window bases clamp at the real spline's knot count in local ids. A
    # shard past the real spline end holds pad rows only (valid 0, zero
    # Jacobians); the bound W_max keeps their bases at 0 or above, where the
    # JAX package's bases go negative and its scatters wrap them (a shard
    # with rows has more than Hl + W local knots, so W_max changes nothing
    # there).
    shift = s * seg - Hl
    W_max = lay["W_max"]
    rt = {
        "mask": runtime["mask"].to(dev),
        "d_max": runtime["d_max"].to(dev),
        "spline_t0": [t0 + shift * dt for t0, dt in zip(runtime["spline_t0"],
                                                         runtime["spline_dt"])],
        "spline_dt": list(runtime["spline_dt"]),
        "spline_n_eval": [max(sp.n - shift, W_max) for sp in spec.splines],
        "data": [{k: v[s * b.M:(s + 1) * b.M].to(dev) for k, v in d.items()}
                 for b, d in zip(spec_local.buckets, runtime["data"])],
    }

    # ---- halos: the knots next to the segment on either side --------------
    # to_right: shard i sends to i + 1 (this shard's left halo comes from
    # s - 1); to_left: shard i sends to i - 1. Both cyclic, as in the JAX
    # package: the wrapped halos are fetched and never read.
    to_left = [(i, (i - 1) % n) for i in range(n)]
    to_right = [(i, (i + 1) % n) for i in range(n)]

    def fill_halo(arrs, hl, hr):
        """Owned ``[core, ...]`` arrays -> ``[hl + core + hr, ...]`` with the
        neighbours' edge rows (JAX ``_halo_fill`` / ``_halo_state``): one
        ``ppermute`` a side for all of them."""
        if not (hl or hr):
            return list(arrs)
        lefts = (mesh.ppermute([a[a.shape[0] - hl:] for a in arrs], to_right) if hl
                 else [a[:0] for a in arrs])
        rights = mesh.ppermute([a[:hr] for a in arrs], to_left) if hr else [a[:0] for a in arrs]
        return [torch.cat([lf, a, rg]) for lf, a, rg in zip(lefts, arrs, rights)]

    def reduce_halo(arrs, hl, hr):
        """Local ``[hl + core + hr, ...]`` sums -> owned ``[core, ...]``, the
        halo rows' sums returned to their owners and added (JAX
        ``_halo_reduce`` / ``_halo_reduce_blocks`` /
        ``_halo_reduce_anchors``)."""
        cores = [a[hl:a.shape[0] - hr].clone() for a in arrs]
        if hl:
            for c, f in zip(cores, mesh.ppermute([a[:hl] for a in arrs], to_left)):
                c[c.shape[0] - hl:] += f
        if hr:
            for c, f in zip(cores, mesh.ppermute([a[a.shape[0] - hr:] for a in arrs],
                                                 to_right)):
                c[:hr] += f
        return cores

    def knot_parts(x, off, rows):
        return [x[off[si]:off[si + 1]].reshape(rows, td) for si, td in enumerate(tds)]

    def halo_fill(x_own):
        """[Pown] owned knot tangents -> [Pk_loc], both halos filled."""
        return torch.cat([p.reshape(-1) for p in fill_halo(knot_parts(x_own, own_off, seg),
                                                           Hl, Hr)])

    def halo_state(state):
        """This rank's state with its knot arrays extended by both halos."""
        out = dict(state)
        for sp, arr in zip(spec.splines, fill_halo([state[sp.kind] for sp in spec.splines],
                                                   Hl, Hr)):
            out[sp.kind] = arr
        return out

    def own_slice(a, rows):
        return torch.as_tensor(a[s * rows:(s + 1) * rows]).to(**opts)

    mask_own = torch.cat([own_slice(km, seg).reshape(-1) for km in lay["kmask"]])
    mask_l = own_slice(lay["mask_l"], Lb)
    mask_sen = torch.as_tensor(lay["mask_sen"]).to(**opts)
    mask_v = own_slice(lay["mask_v"], nvt)
    mask_loc = halo_fill(mask_own)
    # the PCG mode's local columns: knots with halos, sensors, vt slots; its
    # vectors: owned knots, sensors, vt slots
    mask_cat = torch.cat([mask_loc, mask_sen, mask_v])
    mask_own_cat = torch.cat([mask_own, mask_sen, mask_v])
    d_max = problem.d_max.to(**opts)

    # sensor columns move to [Pk_loc, Pk_loc + ns) of the local layout, a
    # lifting row's vt column (vt_offset + its slot) to Pk_loc + ns + slot
    col_shift = []
    for layout in layouts:
        shift_c = np.zeros(layout.C, np.int64)
        if layout.sensor_off >= 0:
            shift_c[layout.sensor_off: layout.sensor_off + SENSOR_TANGENT_DIM] = (
                Pk_loc - spec_local.sensor_offset)
            vt_pos = layout.sensor_off + SENSOR_TANGENT_DIM
            shift_c[vt_pos:] = Pk_loc + ns - spec_local.vt_offset
        col_shift.append(torch.as_tensor(shift_c, device=dev))

    def whitened_blocks(state, col_mask=False):
        """(cost, blocks, mask_l): each bucket's robust-whitened compressed
        rows ``Jw``, ``rw``, columns in the local layout, anchors and (camera
        rows) the landmark column, slot and slot-in-anchor; the cost summed
        over the shards. The banded mode applies the lock masks after
        assembly, in pair-block space; with ``col_mask`` (the PCG mode,
        whose matvecs read ``Jw``) each row's columns are masked."""
        st = halo_state(state)
        cost = torch.zeros((), **opts)
        blocks = []
        for bspec, data, sh in zip(spec_local.buckets, rt["data"], col_shift):
            r, J, cols, J_rho = bucket_terms(spec_local, bspec, rt, st, data)
            c, rho_p = _bucket_cost(bspec, data, r)
            cost = cost + c
            sq = torch.sqrt(rho_p)
            cols = cols + sh[None, :]
            Jw = J * sq[:, None, None]
            if col_mask:
                Jw = Jw * mask_cat[cols][:, None, :]
            blk = {"rw": r * sq[:, None], "Jw": Jw, "cols": cols, "anchor": data["anchor"]}
            if J_rho is not None:
                blk["J_rho"] = J_rho * sq[:, None] * mask_l[data["lid"]][:, None]
                blk["lid"] = data["lid"]
                blk["lrel"] = data["lrel"]
            blocks.append(blk)
        return mesh.psum(cost), blocks, mask_l

    # ---- banded reduced system ---------------------------------------------
    G, sbG, nbloc, LaMax = lay["G"], lay["sbG"], lay["nbloc"], lay["LaMax"]
    hl_b, hr_b = lay["hl_b"], lay["hr_b"]
    BD = sum(tds)
    GBD = G * BD
    WB = 2 * GBD + ns
    sub_off = np.concatenate([[0], np.cumsum(tds)[:-1]]).astype(np.int64)

    def band_perms(n_knots, offsets):
        """Permutations between the per-spline-contiguous ("ps") and the
        knot-interleaved banded layouts of ``n_knots`` knots."""
        ps_of_band = np.zeros(n_knots * BD, dtype=np.int64)
        for si, td in enumerate(tds):
            k, j = np.meshgrid(np.arange(n_knots), np.arange(td), indexing="ij")
            ps_of_band[(k * BD + sub_off[si] + j).ravel()] = (offsets[si] + k * td + j).ravel()
        band_of_ps = np.zeros_like(ps_of_band)
        band_of_ps[ps_of_band] = np.arange(len(ps_of_band))
        return torch.as_tensor(ps_of_band, device=dev), torch.as_tensor(band_of_ps, device=dev)

    ps_of_band, band_of_ps = band_perms(seg, own_off)
    ps_of_band_loc, _ = band_perms(nloc, loc_off)

    tables = [dict(perm=torch.as_tensor(t["perm"][s], device=dev),
                   pmask=torch.as_tensor(t["pmask"][s]).to(**opts).reshape(nbloc, t["Ma"]),
                   Ma=t["Ma"]) for t in lay["banded_tables"]]
    lid_slot = torch.as_tensor(lay["lid_of_slot"][s], device=dev)
    smask = torch.as_tensor(lay["smask"][s]).to(**opts)
    smask_a = smask.reshape(nbloc, LaMax)
    slots = torch.arange(LaMax, device=dev)

    # lock mask of each anchor's pair window: H = M J^T J M, g = M J^T r,
    # E = E M, applied to the assembled blocks instead of to every row
    mb = mask_loc[ps_of_band_loc].reshape(nbloc, GBD)
    mask_w = torch.cat([mb, torch.cat([mb[1:], torch.zeros(1, GBD, **opts)]),
                        mask_sen[None, :].expand(nbloc, ns)], dim=1)

    def colrel(blk, layout):
        """Pair-window-relative column ids aligned with ``Jw``'s C axis: knot
        columns -> banded id - anchor * GBD in [0, 2 GBD); sensor columns
        -> 2 GBD + slot."""
        cols = blk["cols"]
        M = cols.shape[0]
        parts = []
        for off, si, W, td in layout.windows:
            k0 = (cols[:, off] - int(loc_off[si])) // td
            w = torch.arange(W, device=dev)
            j = torch.arange(td, device=dev)
            b = (k0[:, None, None] + w[None, :, None]) * BD + int(sub_off[si]) + j[None, None, :]
            parts.append(b.reshape(M, W * td))
        rel = torch.cat(parts, dim=1) - (blk["anchor"] * GBD)[:, None]
        if layout.sensor_off >= 0:
            so = layout.sensor_off
            rel = torch.cat([rel, cols[:, so: so + SENSOR_TANGENT_DIM] - Pk_loc + 2 * GBD], dim=1)
        return rel.contiguous()

    def dense_rows(blk, layout):
        """Kernel B6: the rows as dense pair-window rows [M, rdim, WB]."""
        return onehot_expand_rows(blk["Jw"].contiguous(), colrel(blk, layout), WB)

    def assemble_band(blocks):
        """Lock-masked pair-block assembly ``{Pa, ga, Ea, Da, gla}`` over this
        rank's anchors (halo blocks included); it depends only on the
        linearization, so the speculative loop carries it and re-solves it
        with a new damping on a rejected step."""
        Pa = torch.zeros(nbloc, WB, WB, **opts)
        ga = torch.zeros(nbloc, WB, **opts)
        Ea = torch.zeros(nbloc, LaMax, WB, **opts)
        Da = torch.zeros(nbloc, LaMax, **opts)
        gla = torch.zeros(nbloc, LaMax, **opts)
        for blk, layout, t in zip(blocks, layouts, tables):
            Jd = dense_rows(blk, layout)
            Ma, perm, pm = t["Ma"], t["perm"], t["pmask"]
            rdim = Jd.shape[1]
            Jg = Jd[perm].reshape(nbloc, Ma, rdim, WB).mul_(pm[:, :, None, None])
            del Jd
            rg = blk["rw"][perm].reshape(nbloc, Ma, rdim) * pm[:, :, None]
            Pa = Pa + torch.einsum("amrw,amrv->awv", Jg, Jg)
            ga = ga + torch.einsum("amrw,amr->aw", Jg, rg)
            if "J_rho" in blk:
                Jr = blk["J_rho"][perm].reshape(nbloc, Ma, rdim) * pm[:, :, None]
                lrel = blk["lrel"][perm].reshape(nbloc, Ma)
                ohL = (lrel[:, :, None] == slots).to(dtype) * pm[:, :, None]
                A = torch.einsum("amr,amrw->amw", Jr, Jg)
                Ea = Ea + torch.einsum("aml,amw->alw", ohL, A)
                Da = Da + torch.einsum("aml,am->al", ohL, torch.sum(Jr * Jr, dim=2))
                gla = gla + torch.einsum("aml,am->al", ohL, torch.sum(Jr * rg, dim=2))
        Pa = Pa * mask_w[:, :, None] * mask_w[:, None, :]
        return dict(Pa=Pa, ga=ga * mask_w, Ea=Ea * mask_w[:, None, :], Da=Da, gla=gla)

    def fold(a, b):
        """Pair quantities -> per-block sums: the anchor's first half plus
        the previous anchor's second half."""
        out = a.clone()
        out[1:] += b[:-1]
        return out

    def eliminate(asm, mask_l, lam, state):
        """Damping diagonals from the pair blocks (pre-elimination, as the
        exact-Schur path damps), landmark elimination in slot space, the
        fold into per-block band, border and gradient parts, their halo
        blocks returned to the owners, the sensor sums over the shards.
        Returns the context of the later stages."""
        Pa, ga, Ea, Da, gla = (asm[k] for k in ("Pa", "ga", "Ea", "Da", "gla"))
        diagPa = torch.diagonal(Pa, dim1=1, dim2=2)

        # bound active set: freeze rho = 0 slots with an outward gradient
        rho_slots = state["rho"][lid_slot].reshape(nbloc, LaMax)
        free_slots = 1.0 - ((rho_slots <= 0.0) & (gla > 0.0)).to(dtype)
        mask_l_slots = mask_l[lid_slot].reshape(nbloc, LaMax) * smask_a * free_slots
        D_d_slots = Da + lam * torch.clamp(Da, 1e-6, 1e32) + (1.0 - mask_l_slots)
        w_slots = smask_a * free_slots / D_d_slots
        Ew = Ea * w_slots[:, :, None]
        Pe = Pa - torch.einsum("alw,alv->awv", Ew, Ea)
        ge = ga - torch.einsum("alw,al->aw", Ew, gla)

        k1, k2 = slice(0, GBD), slice(GBD, 2 * GBD)
        sen = slice(2 * GBD, None)
        diag_b, graw_b, Dband, Uband, Bown, gband = reduce_halo([
            fold(diagPa[:, k1], diagPa[:, k2]), fold(ga[:, k1], ga[:, k2]),
            fold(Pe[:, k1, k1], Pe[:, k2, k2]), Pe[:, k1, k2],
            fold(Pe[:, sen, k1], Pe[:, sen, k2]),  # [sbG, ns, GBD]
            fold(ge[:, k1], ge[:, k2])], hl_b, hr_b)
        diag_sen, g_sen_raw, Csen, gsen = mesh.psum([
            diagPa[:, sen].sum(0), ga[:, sen].sum(0), Pe[:, sen, sen].sum(0), ge[:, sen].sum(0)])
        mask_band = mask_own[ps_of_band]
        damp = lam * torch.clamp(diag_b.reshape(-1), 1e-6, 1e32) + (1.0 - mask_band)
        Dd = Dband + torch.diag_embed(damp.reshape(sbG, GBD))
        Bloc = Bown.permute(1, 0, 2).reshape(ns, sbG * GBD)
        rhs = torch.cat([-gband.reshape(-1, 1), Bloc.T], dim=1).reshape(sbG, GBD, 1 + ns)
        return dict(Dd=Dd, Uband=Uband, rhs=rhs, Bloc=Bloc, Csen=Csen, gsen=gsen,
                    diag_sen=diag_sen, g_band_raw=graw_b.reshape(-1), g_sen_raw=g_sen_raw,
                    mask_band=mask_band, mask_l_slots=mask_l_slots, D_d_slots=D_d_slots,
                    Pa_raw=Pa, Ea=Ea, Da=Da, gla=gla)

    def band_solve(ctx):
        """The block-tridiagonal solve, SPIKE across the shards: this
        rank's [sbG * GBD, 1 + ns]."""
        args = (ctx["Dd"], ctx["Uband"], ctx["rhs"])
        sol = block_tridiag_solve(*args) if n == 1 else spike_block_tridiag_solve(*args, mesh)
        return sol.reshape(sbG * GBD, -1)

    def sensor_solve(ctx, sol, lam):
        """The sensors' Schur complement (ns x ns, its border products summed
        over the shards) and this rank's band step."""
        y = sol[:, 0]
        if not ns:
            return y * ctx["mask_band"], torch.zeros(0, **opts)
        X, Bloc = sol[:, 1:], ctx["Bloc"]
        BX, By = mesh.psum([Bloc @ X, Bloc @ y])
        damp_s = lam * torch.clamp(ctx["diag_sen"], 1e-6, 1e32) + (1.0 - mask_sen)
        Ssen = ctx["Csen"] + torch.diag(damp_s) - BX
        x_sen = torch.linalg.solve(Ssen, -ctx["gsen"] - By) * mask_sen
        return (y - X @ x_sen) * ctx["mask_band"], x_sen

    def slot_sum(v):
        """Slot-space values -> [Lb] per landmark (unused slots add 0)."""
        return torch.zeros(Lb, **opts).index_add_(
            0, lid_slot, torch.where(smask > 0, v.reshape(-1), 0.0))

    def back_substitute(ctx, x_band, x_sen, state):
        """Landmark back-substitution in slot space (the knot step's halos
        from the neighbours) and the predicted decrease ``-(g.d + d.H d /
        2)`` and max |gradient| from the assembled (pre-elimination) blocks,
        summed over the shards. Returns ``(dc, dl, pred, gmax)`` with ``dc =
        (owned knot step, sensor step)``."""
        dc_own = x_band[band_of_ps] * mask_own
        xb = halo_fill(dc_own)[ps_of_band_loc].reshape(nbloc, GBD)
        dcw = torch.cat([xb, torch.cat([xb[1:], torch.zeros(1, GBD, **opts)]),
                         x_sen[None, :].expand(nbloc, ns)], dim=1)
        Edc_slots = torch.einsum("alw,aw->al", ctx["Ea"], dcw)
        dl_slots = -(ctx["gla"] + Edc_slots) / ctx["D_d_slots"] * ctx["mask_l_slots"]
        # projected landmark step (rho >= 0), so pred is the step taken
        rho = state["rho"]
        dl = torch.clamp(rho + slot_sum(dl_slots), min=0.0) - rho

        g_own = ctx["g_band_raw"][band_of_ps]
        gl = slot_sum(ctx["gla"])
        # H = sum_a S_a^T Pa_a S_a with S_a dc = dcw_a: each row lies in one
        # anchor of one shard, so the sums over the shards count it once
        gTd_own, dHd_own = mesh.psum(torch.stack([
            g_own @ dc_own + gl @ dl,
            torch.einsum("aw,awv,av->", dcw, ctx["Pa_raw"], dcw)
            + 2.0 * (dl @ slot_sum(Edc_slots)) + dl @ (slot_sum(ctx["Da"]) * dl)]))
        pred = -(gTd_own + ctx["g_sen_raw"] @ x_sen + 0.5 * dHd_own)
        gmax = mesh.pmax(torch.stack([g_own.abs().max(), gl.abs().max()])).max()
        if ns:
            gmax = torch.maximum(gmax, ctx["g_sen_raw"].abs().max())
        return (dc_own, x_sen), dl, pred, gmax

    def solve_band_from_asm(asm, mask_l, lam, state):
        """Damped banded solve of the assembled pair blocks: ``(dc, dl,
        pred, gmax)``."""
        ctx = eliminate(asm, mask_l, lam, state)
        x_band, x_sen = sensor_solve(ctx, band_solve(ctx), lam)
        return back_substitute(ctx, x_band, x_sen, state)

    def retract_local(state, dc, dl):
        dc_own, dc_sen = dc[0], dc[1]
        new = dict(state)
        for si, sp in enumerate(spec.splines):
            blk = dc_own[own_off[si]: own_off[si + 1]].reshape(seg, tds[si])
            new[sp.kind] = retract_window(sp.kind, state[sp.kind], blk)
        if S:
            sens = dc_sen.reshape(S, SENSOR_TANGENT_DIM)
            new["q_ct"] = quat.qmul(se3m.so3_exp_quat(sens[:, 0:3]), state["q_ct"])
            new["p_ct"] = state["p_ct"] + sens[:, 3:6]
            new["d"] = torch.clamp(state["d"] + sens[:, 6], -d_max, d_max)
            new["abias"] = state["abias"] + sens[:, 7:10]
            new["gbias"] = state["gbias"] + sens[:, 10:13]
        new["rho"] = torch.clamp(state["rho"] + dl, min=0.0)
        if nvt and len(dc) > 2:
            new["vt"] = torch.clamp(state["vt"] + dc[2], 0.0, 1.0)
        return new

    def cost_local(state):
        """The cost from the rows' residuals alone (B3 for camera rows),
        summed over the shards."""
        st = halo_state(state)
        cost = torch.zeros((), **opts)
        for bspec, data in zip(spec_local.buckets, rt["data"]):
            r = bucket_terms(spec_local, bspec, rt, st, data, cost_only=True)
            cost = cost + _bucket_cost(bspec, data, r)[0]
        return mesh.psum(cost)

    def lin0(state):
        """(cost, assembly, mask_l): the speculative loop's carried
        linearization."""
        cost, blocks, ml = whitened_blocks(state)
        return cost, assemble_band(blocks), ml

    def step_spec(state, lin, lam):
        """Solve from the carried assembly, then linearize and assemble the
        candidate: its cost is the re-cost, so an accepted iteration streams
        the rows once, and a rejected one re-solves the carried band."""
        _, asm, ml = lin
        dc, dl, pred, _ = solve_band_from_asm(asm, ml, lam, state)
        new_state = retract_local(state, dc, dl)
        return new_state, lin0(new_state), pred

    def step_local(state, lam):
        cost, blocks, ml = whitened_blocks(state)
        dc, dl, pred, gmax = solve_band_from_asm(assemble_band(blocks), ml, lam, state)
        new_state = retract_local(state, dc, dl)
        return cost, new_state, cost_local(new_state), pred, (dc, dl), gmax

    # ---- matrix-free PCG on the reduced system -----------------------------
    # local columns (n_cat): knots with halos, sensors, vt slots; the PCG
    # vectors (n_own): owned knots, sensors, vt slots
    n_cat = Pk_loc + ns + nvt
    loc_columns = Columns(tuple((int(loc_off[si]), nloc, td) for si, td in enumerate(tds)),
                          Pk_loc, S)
    own_columns = Columns(tuple((int(own_off[si]), seg, td) for si, td in enumerate(tds)),
                          Pown, S)

    # one shard has no halos: its local columns are the owned ones, and the
    # CG's vectors pass through unchanged
    def to_local(x):
        """Owned (knots, sensors, vt) -> local columns, halos filled."""
        if n == 1:
            return x
        return torch.cat([halo_fill(x[:Pown]), x[Pown:]])

    def to_owned(y):
        """Local column sums -> owned: halo sums returned to their owners,
        sensor sums over the shards, vt slots local."""
        if n == 1:
            return y
        knots = reduce_halo(knot_parts(y, loc_off, nloc), Hl, Hr)
        return torch.cat([p.reshape(-1) for p in knots]
                         + [mesh.psum(y[Pk_loc:Pk_loc + ns]), y[Pk_loc + ns:]])

    def pdot(a, b):
        """Dot of two owned vectors: knot and vt parts summed over the
        shards, the sensor part replicated."""
        if n == 1:
            return a @ b
        own = a[:Pown] @ b[:Pown] + a[Pown + ns:] @ b[Pown + ns:]
        return mesh.psum(own) + a[Pown:Pown + ns] @ b[Pown:Pown + ns]

    def linearize_pcg(state):
        """``(cost, blocks, g, diag, D, g_l, kblocks, sblocks)``: the rows
        masked per column, and over the owned columns the gradient, the
        duplicate-aware diagonal and the per-knot and per-sensor
        preconditioner blocks (local sums, halo-reduced and summed over the
        shards), the landmark blocks of this rank."""
        cost, blocks, _ = whitened_blocks(state, col_mask=True)
        g, diag, D, g_l = grad_and_diag(blocks, layouts, n_cat, Lb)
        kb, sb = precond_blocks(blocks, layouts, loc_columns)
        kp = [k.reshape(nloc, -1) for k in kb]
        red = reduce_halo(knot_parts(g, loc_off, nloc) + knot_parts(diag, loc_off, nloc) + kp,
                          Hl, Hr)
        nsp = len(tds)
        g_sen, diag_sen, sb = mesh.psum([g[Pk_loc:Pk_loc + ns], diag[Pk_loc:Pk_loc + ns], sb])
        g_o = torch.cat([p.reshape(-1) for p in red[:nsp]] + [g_sen, g[Pk_loc + ns:]])
        diag_o = torch.cat([p.reshape(-1) for p in red[nsp:2 * nsp]]
                           + [diag_sen, diag[Pk_loc + ns:]])
        kblocks = [p.reshape(seg, td, td) for p, td in zip(red[2 * nsp:], tds)]
        return cost, blocks, g_o, diag_o, D, g_l, kblocks, sb

    def schur_matvec(blocks, x, D_d, free):
        """``A_cc x - E^T diag(free / D_d) E x`` on the local columns, each
        row's ``Jw x`` formed once (a landmark's rows are all on its
        rank)."""
        y = torch.zeros_like(x)
        ts = [torch.einsum("mrc,mc->mr", blk["Jw"], x[blk["cols"]]) for blk in blocks]
        Ex = torch.zeros(Lb, **opts)
        for blk, t in zip(blocks, ts):
            if "J_rho" in blk:
                Ex.index_add_(0, blk["lid"], torch.sum(blk["J_rho"] * t, dim=1))
        w = Ex * free / D_d
        for blk, t in zip(blocks, ts):
            if "J_rho" in blk:
                t = t - blk["J_rho"] * w[blk["lid"]][:, None]
            y.index_add_(0, blk["cols"].reshape(-1),
                         torch.einsum("mrc,mr->mc", blk["Jw"], t).reshape(-1))
        return y

    def solve_pcg(lin, lam, state):
        """The damped PCG solve and the LM bookkeeping: ``(dc, dl, pred,
        gmax)`` with ``dc = (owned knot step, sensor step, vt step)``, the
        vt and landmark steps projected to their bounds."""
        _, blocks, g, diag, D, g_l, kblocks, sblocks = lin
        # bound active set: freeze rho = 0 landmarks with an outward gradient
        free = landmark_free_mask(state["rho"], g_l, mask_l)
        diag_d = lam * torch.clamp(diag, 1e-6, 1e32) + (1.0 - mask_own_cat)
        D_d = D + lam * torch.clamp(D, 1e-6, 1e32) + (1.0 - free)
        rhs = to_owned(et_matvec(blocks, free * g_l / D_d, n_cat)) - g

        def matvec(x):
            return to_owned(schur_matvec(blocks, to_local(x), D_d, free)) + diag_d * x

        # a vt column by its damped diagonal entry alone, as the JAX
        # package's segment BA preconditions it
        precond = preconditioner(kblocks, sblocks, own_columns, diag_d, diag_d)
        x, _ = pcg(matvec, precond, rhs, cg_tol, cg_maxiter, dot=pdot)
        dvt = x[Pown + ns:] * mask_v
        if nvt:  # the increment the bounded retraction applies (vt in [0, 1])
            dvt = torch.clamp(state["vt"] + dvt, 0.0, 1.0) - state["vt"]
        dc = torch.cat([x[:Pown] * mask_own, x[Pown:Pown + ns] * mask_sen, dvt])
        dc_loc = to_local(dc)
        Edc = e_matvec(blocks, dc_loc, Lb)
        dl = -(g_l + Edc) / D_d * free
        dl = torch.clamp(state["rho"] + dl, min=0.0) - state["rho"]
        lm_dot, lm_dHd = mesh.psum(torch.stack([g_l @ dl, 2.0 * (dl @ Edc) + dl @ (D * dl)]))
        gTd = pdot(g, dc) + lm_dot
        dHd = pdot(dc, to_owned(hcc_matvec(blocks, dc_loc))) + lm_dHd
        pred = -(gTd + 0.5 * dHd)
        gm = [g[:Pown].abs().max(), g_l.abs().max()]
        if nvt:
            gm.append(g[Pown + ns:].abs().max())
        gmax = mesh.pmax(torch.stack(gm)).max()
        if ns:
            gmax = torch.maximum(gmax, g[Pown:Pown + ns].abs().max())
        return (dc[:Pown], dc[Pown:Pown + ns], dc[Pown + ns:]), dl, pred, gmax

    def step_local_pcg(state, lam):
        lin = linearize_pcg(state)
        dc, dl, pred, gmax = solve_pcg(lin, lam, state)
        new_state = retract_local(state, dc, dl)
        return lin[0], new_state, cost_local(new_state), pred, (dc, dl), gmax

    # ---- global <-> this rank's state ---------------------------------------
    nk, nk_pad, L = lay["nk"], lay["nk_pad"], lay["L"]
    lid_to_padded = torch.as_tensor(lay["lid_to_padded"], device=dev)
    vtid_to_padded = torch.as_tensor(lay["vtid_to_padded"], device=dev)

    def to_sharded(state):
        """Global state -> this rank's: its ``seg`` knots of each spline (the
        knots padded to ``nk_pad`` with copies of the last one), its ``Lb``
        landmark slots and its ``Vb`` row-time slots; sensors replicated."""
        st = {k: v.to(dev) for k, v in state.items()}
        for sp in spec.splines:
            arr = st[sp.kind]
            pad = nk_pad - arr.shape[0]
            if pad:
                arr = torch.cat([arr, arr[-1:].expand(pad, -1)])
            st[sp.kind] = arr[s * seg:(s + 1) * seg].clone()
        rho_p = torch.zeros(n * Lb, dtype=st["rho"].dtype, device=dev)
        if L:
            rho_p[lid_to_padded] = st["rho"]
        st["rho"] = rho_p[s * Lb:(s + 1) * Lb].clone()
        if nvt:
            vt_p = torch.zeros(n * nvt, dtype=st["vt"].dtype, device=dev)
            vt_p[vtid_to_padded] = st["vt"]
            st["vt"] = vt_p[s * nvt:(s + 1) * nvt].clone()
        return st

    def to_global(st):
        """This rank's state -> the global state, the segments gathered from
        every rank (the same on every rank)."""
        keys = [sp.kind for sp in spec.splines] + ["rho"] + (["vt"] if nvt else [])
        full = dict(zip(keys, mesh.allgather([st[k] for k in keys])))
        out = dict(st)
        for sp in spec.splines:
            out[sp.kind] = full[sp.kind][:nk]
        out["rho"] = full["rho"][lid_to_padded] if L else full["rho"][:0]
        if nvt:
            out["vt"] = full["vt"][vtid_to_padded]
        return out

    # the entry points' parts, and the stages that chip_smoke.py times apart
    return dict(
        spec_local=spec_local, runtime=rt, layouts=layouts, WB=WB,
        whitened_blocks=whitened_blocks, colrel=colrel, dense_rows=dense_rows,
        assemble_band=assemble_band, eliminate=eliminate, band_solve=band_solve,
        sensor_solve=sensor_solve, back_substitute=back_substitute,
        retract_local=retract_local, cost_local=cost_local, lin0_local=lin0,
        step_spec_local=step_spec, to_sharded=to_sharded, to_global=to_global,
        linearize_pcg=linearize_pcg, solve_pcg=solve_pcg,
        step_local=step_local if mode == "banded" else step_local_pcg,
    )


def make_segment_ba_step(problem, mesh=None, cg_tol=1e-10, cg_maxiter=500, mode="banded",
                         n_shards=None):
    """``step(state, lam) -> (cost, new_state, new_cost, pred, grad_max)``
    and ``total_cost(state)`` of the segment x landmark layout on ``mesh``
    (the JAX package's ``make_segment_ba_step``; ``mesh=None`` is one shard,
    as is ``n_shards=1``). States are global, the same on every rank; the
    problem's device runs this rank's part. ``mode`` is ``"banded"`` or
    ``"pcg"``, whose CG stops at ``cg_tol`` relative or after
    ``cg_maxiter`` iterations."""
    b = _build_segment_ba(problem, _as_mesh(mesh, n_shards, problem.device), mode, cg_tol,
                          cg_maxiter)

    def step(state, lam):
        cost, new_st, new_cost, pred, _, gmax = b["step_local"](b["to_sharded"](state), lam)
        return cost, b["to_global"](new_st), new_cost, pred, gmax

    def total_cost(state):
        return b["cost_local"](b["to_sharded"](state))

    return step, total_cost


def make_segment_ba_solver(problem, mesh=None, max_iterations=50, function_tolerance=1e-6,
                           cg_tol=1e-6, cg_maxiter=200, mode="banded", n_shards=None):
    """LM with the segment x landmark layout on ``mesh`` (``None``: one
    shard). The whole trust-region loop runs on every rank on its part of
    the state, every rank reading the same reduced scalars. Banded mode
    runs the speculative loop (``solver.lm.trust_region_loop_spec``) on the
    carried ``(cost, assembly, mask_l)``; PCG mode the classic loop
    (``solver.lm.trust_region_loop``), each step linearizing, solving by
    PCG (``cg_tol``, ``cg_maxiter``) and re-costing, as in the JAX package.
    Returns ``solve(state) -> (state, final_cost, iterations_run)`` with
    global states, the same on every rank."""
    b = _build_segment_ba(problem, _as_mesh(mesh, n_shards, problem.device), mode, cg_tol,
                          cg_maxiter)

    def solve(state):
        st = b["to_sharded"](state)
        if mode == "banded":
            st, cost, it = trust_region_loop_spec(
                b["step_spec_local"], b["lin0_local"](st), st,
                max_iterations=max_iterations, function_tolerance=function_tolerance)
        else:
            st, cost, it = trust_region_loop(
                lambda s, lam: b["step_local"](s, lam)[:4], b["cost_local"](st), st,
                max_iterations=max_iterations, function_tolerance=function_tolerance)
        return b["to_global"](st), cost, it

    return solve
