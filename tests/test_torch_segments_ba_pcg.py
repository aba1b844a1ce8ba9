"""Segment BA's PCG mode (``parallel.segments_ba``, one shard) on lifting
rows and with CG cut short, against the JAX package's one-shard PCG step,
in float64 on the CPU:

- lifting rows (the JAX package's ``tests/test_segments_ba.py`` problem: 8
  views, 12 landmarks, 40 Hz IMU rows, seed 29, split trajectory), a
  converged CG (1e-12, at most 400 iterations): each row's ``vt`` a column
  past the sensor border, point-Jacobi preconditioned and clipped to
  [0, 1]; also against the port's iterative step;
- CG stopped at its cap after 5 iterations, where the step depends on the
  preconditioner (the per-knot and per-sensor blocks, the vt columns'
  point Jacobi), on config 5's model at the JAX tests' size (60 views, 300
  landmarks) and on the lifting problem with its sensors free.

``tests/test_torch_segments_ba.py`` holds the converged PCG step on config
5's model, the banded mode and the rows of other kinds.
"""
import numpy as np
import pytest
import torch

from kontiki_tpu import parallel as jax_parallel
from kontiki_tpu.parallel import segments_ba as jax_sba
from kontiki_tpu_torch.parallel import segments_ba as sba
from kontiki_tpu_torch.solver import iterative
from test_torch_segments_ba import CG, _check_against, _pair, _rows_pair


def test_lifting_rows_pcg_match_jax():
    """Lifting rows in PCG mode, the JAX package's test problem: each row's
    ``vt`` a column past the sensor border, point-Jacobi preconditioned and
    clipped to [0, 1] in the retraction. One step (converged CG) against the
    JAX package's one-shard PCG step (cost 1e-10, new cost and max
    |gradient| 1e-9 and 1e-10, pred 1e-8 relative, state 1e-10 relative and
    1e-9 absolute: r3 reaches ~1e4) and the port's iterative step (cost
    1e-10, new cost and pred 1e-8 relative, state 1e-6; the JAX test holds
    its own pair to 1e-9, 1e-5 and 2e-4)."""
    jl, tl = _rows_pair("lifting")
    assert tl.state0["vt"].numel() > 0
    want = jax_sba.make_segment_ba_step(jl, jax_parallel.default_mesh(n_devices=1),
                                        mode="pcg", **CG)[0](jl.state0, 1e-4)
    step, cost = sba.make_segment_ba_step(tl, mode="pcg", **CG)
    got = step(tl.state0, 1e-4)
    assert got[2].item() < got[0].item()
    _check_against(got, want, 1e-9, state_rtol=1e-10)
    np.testing.assert_allclose(cost(tl.state0).item(), float(want[0]), rtol=1e-10)
    vt = got[1]["vt"]
    assert vt.shape == tl.state0["vt"].shape and (vt >= 0).all() and (vt <= 1).all()
    ref = iterative.make_iterative_step(tl, **CG)[0](tl.state0, 1e-4)
    for i, rtol in ((0, 1e-10), (2, 1e-8), (3, 1e-8)):
        np.testing.assert_allclose(got[i].item(), ref[i].item(), rtol=rtol, err_msg=str(i))
    for k in ("r3", "so3", "rho", "vt"):
        np.testing.assert_allclose(got[1][k].numpy(), ref[1][k].numpy(), rtol=0, atol=1e-6,
                                   err_msg=k)


#: CG stopped at its cap after a few iterations, where its iterates are
#: not yet chaotic and depend on the preconditioner
FEW_CG = dict(cg_tol=1e-14, cg_maxiter=5)


@pytest.mark.parametrize("rows", ["camera", "lifting, free sensors"])
def test_truncated_pcg_matches_jax(rows):
    """The PCG mode with CG cut after 5 iterations against the JAX
    package's one-shard PCG step: the step then depends on the per-knot and
    per-sensor blocks and on the vt columns' point Jacobi, so this pins the
    preconditioner (cost, new cost, pred and max |gradient| to 1e-9
    relative, state 1e-9; the test problems lock their sensors, so the
    lifting case frees them)."""
    jp, tp = _pair(0.0) if rows == "camera" else _rows_pair("lifting", free_sensors=True)
    want = jax_sba.make_segment_ba_step(jp, jax_parallel.default_mesh(n_devices=1),
                                        mode="pcg", **FEW_CG)[0](jp.state0, 1e-4)
    got = sba.make_segment_ba_step(tp, mode="pcg", **FEW_CG)[0](tp.state0, 1e-4)
    for i in (0, 2, 3, 4):
        np.testing.assert_allclose(got[i].item(), float(want[i]), rtol=1e-9, err_msg=str(i))
    for k, v in got[1].items():
        if v.numel():
            np.testing.assert_allclose(v.numpy(), np.asarray(want[1][k]), rtol=0, atol=1e-9,
                                       err_msg=k)
    if rows.endswith("sensors"):
        for k in ("q_ct", "p_ct", "d"):
            assert not torch.equal(got[1][k], tp.state0[k]), k
