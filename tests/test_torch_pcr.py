"""``solver.banded.block_tridiag_solve``, the band solve by parallel cyclic
reduction and one refinement step, against the sequential scan
(``_scan_solve``, the reference),
a dense solve and the JAX package's ``pcr_block_tridiag_solve``, on
symmetric positive definite block-tridiagonal systems made from numpy
seeds, in float64.

Shapes: nb of 1, 2, 8 (a power of 2) and 3, 5, 9, 13 (not one), blocks of
d = 1, 6, 12 and 48, R = 1 and 14 right-hand sides. Tolerance: 1e-10
relative to the solution's largest entry (the systems are diagonally
dominant, condition ~10; PCR's LU solves and the scan's Cholesky round
differently by a few units). On a block that is not positive definite
each method gives what the JAX package's gives: the scan NaN (Cholesky),
PCR a finite solution on an indefinite block (LU) and inf or NaN on a
singular one.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kontiki_tpu.solver.banded import block_tridiag_solve as jax_solve
from kontiki_tpu_torch.solver.banded import _scan_solve, block_tridiag_solve
from test_torch_banded import _system

RTOL = 1e-10


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("R", [1, 14])
@pytest.mark.parametrize("nb,d", [(1, 6), (2, 6), (8, 12), (13, 12), (3, 1), (5, 48), (9, 6)])
def test_pcr_matches_scan_dense_and_jax(nb, d, R):
    D, U, rhs, T = _system(nb, d, R, seed=10 * nb + R)
    got = block_tridiag_solve(*_torch(D, U, rhs)).numpy()
    assert got.shape == (nb, d, R)
    scan = _scan_solve(*_torch(D, U, rhs)).numpy()
    dense = np.linalg.solve(T, rhs.reshape(nb * d, R)).reshape(nb, d, R)
    want = np.asarray(jax_solve(jnp.asarray(D), jnp.asarray(U), jnp.asarray(rhs), method="pcr"))
    scale = np.abs(dense).max()
    for name, other in (("scan", scan), ("dense", dense), ("JAX pcr", want)):
        assert np.abs(got - other).max() <= RTOL * scale, name


def test_pcr_ignores_the_last_super_diagonal_block():
    """``U[nb-1]`` couples to nothing, as in the scan."""
    D, U, rhs, _ = _system(5, 6, 2, seed=3)
    U2 = U.copy()
    U2[-1] = np.random.default_rng(0).normal(size=(6, 6))
    a = block_tridiag_solve(*_torch(D, U, rhs)).numpy()
    b = block_tridiag_solve(*_torch(D, U2, rhs)).numpy()
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("block", ["indefinite", "singular"])
def test_bad_blocks_follow_jax(block):
    """Each method is finite exactly where the JAX package's same method
    is; neither hands over to the other."""
    D, U, rhs, _ = _system(6, 6, 2, seed=7)
    D[2] = -np.eye(6) if block == "indefinite" else 0.0
    if block == "singular":
        U[1] = U[2] = 0.0  # block 2 stands alone: a zero pivot
    for method, solve in (("scan", _scan_solve), ("pcr", block_tridiag_solve)):
        got = solve(*_torch(D, U, rhs)).numpy()
        want = np.asarray(jax_solve(jnp.asarray(D), jnp.asarray(U), jnp.asarray(rhs),
                                    method=method))
        assert np.isfinite(got).all() == np.isfinite(want).all(), method
        if np.isfinite(want).all():
            np.testing.assert_allclose(got, want, rtol=0, atol=RTOL * np.abs(want).max())
    assert not np.isfinite(_scan_solve(*_torch(D, U, rhs)).numpy()).all()
