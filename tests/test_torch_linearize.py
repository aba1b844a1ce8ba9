"""Port parity: camera-row linearization (kernel B1's plain PyTorch version,
``ops.linearize_kernels.linearize_rows_plain``, and its gather stage)
against ``kontiki_tpu`` on the same inputs, in float64.

Tolerance: |port - jax| <= 1e-10 * max|jax| per output (the two sides
evaluate the same formulas in another order, and the JAX component path
uses a Newton arctangent). The CUDA kernel itself is held against the
plain version by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``."""
import jax
import numpy as np
import pytest
import torch

from kontiki_tpu.ops import linearize_kernels as jlk
from kontiki_tpu.solver import kernels as jk
from kontiki_tpu_torch.ops import linearize_kernels as tlk
from kontiki_tpu_torch.solver import kernels as tk
from test_torch_problem import problem_pair

torch.set_num_threads(1)
RTOL = 1e-10


def _close(got, want, name):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, name
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=RTOL * np.abs(want).max(), err_msg=name)


@pytest.fixture(scope="module")
def camera():
    pair = problem_pair()
    spec, jrt, J = pair["jspec"], pair["jrt"], pair["jax"]
    (ci,) = [i for i, b in enumerate(spec.buckets) if b.kind == "rs_static"]
    ins, cfg, i0s, _ = jk._fused_camera_inputs(
        spec, spec.buckets[ci], jrt, J.state0, jrt["data"][ci]
    )
    tins = {k: torch.tensor(np.array(v)) for k, v in ins.items()}
    return dict(pair=pair, ci=ci, ins=ins, cfg=cfg, tins=tins)


def test_gather_stage_matches_jax(camera):
    pair = camera["pair"]
    tspec = tk.problem_spec(pair["torch"])
    tins, _ = tk._camera_inputs(tspec, pair["rt"], pair["state"],
                                pair["rt"]["data"][camera["ci"]])
    assert sorted(tins) == sorted(camera["ins"])
    for k, v in tins.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(camera["ins"][k]), err_msg=k)


def test_plain_matches_jax_component_path(camera):
    want = jlk.linearize_rows(camera["cfg"], camera["ins"], backend="xla")
    got = tlk.linearize_rows_plain(camera["tins"])
    for name, g, w in zip(("r", "J", "J_rho"), got, want):
        _close(g.numpy(), w, name)


def test_camera_rows_match_jax_staged_path(camera):
    """The port's camera bucket terms (gather + B1 + column ids) against the
    JAX package's vmapped staged Jacobian on the same state."""
    pair, ci = camera["pair"], camera["ci"]
    spec, jrt = pair["jspec"], pair["jrt"]
    bspec = spec.buckets[ci]
    res, flags = jk._make_residual(spec, bspec)
    want = jax.jit(
        lambda rt, st: jk._bucket_terms(spec, bspec, res, flags, rt, st,
                                        rt["data"][ci], True, split_rho=True)
    )(jrt, pair["jax"].state0)
    tspec = tk.problem_spec(pair["torch"])
    got = tk.bucket_terms(tspec, tspec.buckets[ci], pair["rt"], pair["state"],
                          pair["rt"]["data"][ci])
    for name, g, w in zip(("r", "J", "cols", "J_rho"), got, want):
        if name == "cols":
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        else:
            _close(g.numpy(), w, name)


def test_wrapper_on_cpu_runs_plain_and_checks_inputs(camera):
    tins = camera["tins"]
    for g, w in zip(tlk.linearize_rows(tins), tlk.linearize_rows_plain(tins)):
        assert torch.equal(g, w)
    bad = dict(tins, rho=tins["rho"][:, :-1])
    with pytest.raises(ValueError):
        tlk.linearize_rows(bad)
    bad = dict(tins, K=tins["K"].float())
    with pytest.raises(ValueError):
        tlk.linearize_rows(bad)

