"""Port parity: gyro/accel rows on SO3 and split R3 + SO3 splines, kernel
B4's plain PyTorch version ``ops.linearize_kernels.imu_rows_plain``,
against the JAX package in float64.

- ``imu_rows_plain`` against ``kontiki_tpu.ops.linearize_kernels.imu_rows``
  with ``backend="xla"`` (the TPU kernel's tile function ``_tile_imu`` as
  one XLA program, no Pallas interpret mode), on the same random [k, M]
  inputs with nonzero biases, time-shift columns and invalid rows: r to
  1e-9, J to 1e-7 (relative to max |jax| per output). The JAX cost-only
  form is ``_tile_imu``'s residual, so the port's cost-only rows are held
  to the residual of the same JAX call. The bucket path (gather, column
  ids, an unlocked time offset) is pinned through the dense linearization
  in ``tests/test_torch_dense.py``.

The CUDA kernel is held against the plain version on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``, and its row code on the
host by ``tests/test_torch_imu_host.py``."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kontiki_tpu.ops import linearize_kernels as jlk
from kontiki_tpu_torch.ops import linearize_kernels as tlk

torch.set_num_threads(1)
TOL = {"r": 1e-9, "J": 1e-7}

#: (kind, so3_only, r3_first) of each kernel variant
VARIANTS = {
    "gyro-so3": ("gyro", True, False),
    "gyro-split": ("gyro", False, True),
    "accel-split": ("accel", False, True),
    "accel-split-so3-first": ("accel", False, False),
}


def _cfg(variant):
    kind, so3_only, r3_first = VARIANTS[variant]
    return dict(kind=kind, so3_only=so3_only, r3_first=r3_first)


def _windows(rng, M, scale):
    """[16, M] SO3 windows: 4 unit quaternions per row, each a random
    rotation of size ~scale from the previous one."""
    out = np.empty((M, 4, 4))
    for m in range(M):
        q = np.array([1.0, 0.0, 0.0, 0.0])
        for j in range(4):
            v = rng.normal(size=3) * scale
            th = np.linalg.norm(v)
            d = np.r_[np.cos(th / 2), np.sin(th / 2) * v / th]
            q = np.array([
                d[0] * q[0] - d[1] * q[1] - d[2] * q[2] - d[3] * q[3],
                d[0] * q[1] + d[1] * q[0] + d[2] * q[3] - d[3] * q[2],
                d[0] * q[2] - d[1] * q[3] + d[2] * q[0] + d[3] * q[1],
                d[0] * q[3] + d[1] * q[2] - d[2] * q[1] + d[3] * q[0],
            ])
            out[m, j] = q / np.linalg.norm(q)
    return out.reshape(M, 16).T.copy()


@functools.lru_cache(maxsize=None)
def _inputs(variant, M=8):
    """Random [k, M] inputs from a seed: rows at u = 0 and u -> 1, nonzero
    biases and a few invalid rows."""
    _, so3_only, _ = VARIANTS[variant]
    rng = np.random.default_rng(11)
    ins = {
        "win_so3": _windows(rng, M, 0.3), "u_so3": rng.uniform(0, 1, (1, M)),
        "dts_so3": np.full((1, M), 0.1), "y": rng.normal(size=(3, M)),
        "weight": rng.uniform(0.5, 2.0, (1, M)), "bias": rng.normal(scale=0.1, size=(3, M)),
        "valid": (rng.uniform(size=(1, M)) > 0.2).astype(np.float64),
    }
    ins["u_so3"][0, :2] = [0.0, 0.999999]
    if not so3_only:
        ins["win_r3"] = rng.normal(size=(12, M))
        ins["u_r3"] = rng.uniform(0, 1, (1, M))
        ins["dts_r3"] = np.full((1, M), 0.12)
    return ins


@functools.lru_cache(maxsize=None)
def _jax_rows(variant):
    ins = {k: jnp.asarray(v) for k, v in _inputs(variant).items()}
    return tuple(np.asarray(a) for a in jlk.imu_rows(_cfg(variant), ins, backend="xla"))


def _torch_ins(variant):
    return {k: torch.tensor(v) for k, v in _inputs(variant).items()}


def _close(got, want, name):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape, name
    tol = TOL[name]
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * np.abs(want).max(), err_msg=name)


@pytest.mark.parametrize("cost_only", [False, True], ids=["linearize", "cost"])
@pytest.mark.parametrize("variant", ["gyro-so3", "gyro-split", "accel-split"])
def test_plain_matches_jax_tile(variant, cost_only):
    got = tlk.imu_rows_plain(_cfg(variant), _torch_ins(variant), cost_only=cost_only)
    want = _jax_rows(variant)
    if cost_only:
        _close(got, want[0], "r")
    else:
        for name, g, w in zip(("r", "J"), got, want):
            _close(g, w, name)


def test_wrapper_on_cpu_runs_plain_and_checks_inputs():
    tins = _torch_ins("accel-split")
    cfg = _cfg("accel-split")
    for g, w in zip(tlk.imu_rows(cfg, tins), tlk.imu_rows_plain(cfg, tins)):
        assert torch.equal(g, w)
    assert torch.equal(tlk.imu_rows(cfg, tins, cost_only=True),
                       tlk.imu_rows_plain(cfg, tins, cost_only=True))
    with pytest.raises(ValueError):
        tlk.imu_rows(cfg, dict(tins, bias=tins["bias"][:, :-1]))
    with pytest.raises(ValueError):
        tlk.imu_rows(cfg, dict(tins, y=tins["y"].float()))
    with pytest.raises(ValueError):
        tlk.imu_rows(cfg, {k: v for k, v in tins.items() if k != "win_r3"})
    with pytest.raises(ValueError):  # accel rows need the R3 spline
        tlk.imu_rows(dict(cfg, so3_only=True), tins)
    with pytest.raises(TypeError):
        tlk.imu_rows(cfg, {k: v.to(torch.int64) for k, v in tins.items()})
