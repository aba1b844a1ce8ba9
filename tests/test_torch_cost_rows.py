"""Port parity: residual-only costs against ``kontiki_tpu`` in float64.

- Kernel B3 (``cost_rows``, plain version) on SE3 camera rows against the
  JAX package's ``cost_rows(backend="xla")``, and against B1's residual.
- ``total_cost`` of the Schur and dense parts against the JAX package's on
  an SE3 problem with camera and IMU rows (config 4's model, cut to 4 views,
  8 landmarks and 100 Hz) and on a split camera problem (config 3's, cut to
  6 views). The JAX side
  takes its generic residual path here, so this is also an independent
  check of B3's and the SE3 IMU rows' cost-only path. The port's run fails
  if it reaches B1's linearization or ``torch.func.jacfwd``.

Tolerance: 1e-10 relative per residual, 1e-12 relative on a cost."""
import functools

import jax
import numpy as np
import pytest
import torch

from kontiki_tpu.ops import linearize_kernels as jlk
from kontiki_tpu.solver import kernels as jk
from kontiki_tpu.solver.schur import build_schur_parts as jax_schur_parts
from kontiki_tpu_torch.ops import linearize_kernels as tlk
from kontiki_tpu_torch.solver import kernels as tk
from kontiki_tpu_torch.solver.schur import build_schur_parts
from kontiki_tpu_torch.synthetic import make_rsvi_problem
from test_torch_split_camera import split_pair, twin_pair

torch.set_num_threads(1)

@functools.lru_cache(maxsize=None)
def _se3_pair():
    gen = make_rsvi_problem(nviews=4, nlandmarks=8, imu_rate=100.0, seed=4, noise_px=1.0,
                            trajectory="se3")
    return twin_pair(gen["trajectory"], gen["measurements"])


PAIRS = {"se3+imu": _se3_pair, "split": lambda: split_pair(noise_px=1.0)}


def _pair(name):
    return PAIRS[name]()


def test_b3_se3_plain_matches_jax():
    pair = _pair("se3+imu")
    spec, jrt, J = pair["jspec"], pair["jrt"], pair["jax"]
    (ci,) = [i for i, b in enumerate(spec.buckets) if b.kind == "rs_static"]
    ins, cfg, _, _ = jk._fused_camera_inputs(spec, spec.buckets[ci], jrt, J.state0,
                                             jrt["data"][ci])
    want = np.asarray(jlk.cost_rows(cfg, ins, backend="xla"))
    tcfg, tins, _ = tk._camera_inputs(pair["tspec"], pair["rt"], pair["state"],
                                      pair["rt"]["data"][ci])
    got = tlk.cost_rows_plain(tcfg, tins).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10 * np.abs(want).max())
    r1 = tlk.linearize_rows_plain(tcfg, tins)[0].numpy()
    np.testing.assert_allclose(got, r1, rtol=1e-12, atol=1e-12 * np.abs(r1).max())


@functools.lru_cache(maxsize=None)
def _jax_cost(name):
    """The JAX package's ``total_cost`` (its Schur and dense parts share
    the one function)."""
    pair = _pair(name)
    total_cost = jax_schur_parts(pair["jspec"], True)["total_cost"]
    return float(jax.jit(total_cost)(pair["jrt"], pair["jax"].state0))


@pytest.mark.parametrize("name", list(PAIRS))
@pytest.mark.parametrize("strategy", ["schur", "dense"])
def test_total_cost_matches_jax_without_linearization(name, strategy, monkeypatch):
    pair = _pair(name)

    def forbidden(*args, **kwargs):
        raise AssertionError("a residual-only cost reached a linearization")

    monkeypatch.setattr(tk, "linearize_rows", forbidden)
    monkeypatch.setattr(torch.func, "jacfwd", forbidden)
    parts = (build_schur_parts(pair["tspec"]) if strategy == "schur"
             else tk.build_parts(pair["tspec"]))
    got = parts["total_cost"](pair["rt"], pair["state"]).item()
    want = _jax_cost(name)
    assert want > 0
    assert got == pytest.approx(want, rel=1e-12)


def test_se3_imu_costs_equal_linearization_residuals():
    """The SE3 IMU rows' cost-only path gives the linearization's r."""
    pair = _pair("se3+imu")
    spec = pair["tspec"]
    for bspec, data in zip(spec.buckets, pair["rt"]["data"]):
        if bspec.kind in ("gyro", "accel"):
            r = tk.bucket_terms(spec, bspec, pair["rt"], pair["state"], data, cost_only=True)
            r1 = tk.bucket_terms(spec, bspec, pair["rt"], pair["state"], data)[0]
            torch.testing.assert_close(r, r1, rtol=1e-14, atol=1e-14)
