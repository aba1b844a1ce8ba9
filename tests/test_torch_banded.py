"""``solver.banded._scan_solve``, the sequential block Cholesky that the
tests hold the port's band solve (PCR: ``tests/test_torch_pcr.py``)
against, against the JAX package's
"scan" method and against a dense solve, on random symmetric positive
definite block-tridiagonal systems (nb = 12 blocks of d = 12, R = 3
right-hand sides), in float64.

Tolerance: 1e-12 relative to the solution's largest entry. The systems are
diagonally dominant (condition ~10), so the block Cholesky and the dense
LU agree to a few units of roundoff; the JAX scan runs the same block
recurrence.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kontiki_tpu.solver.banded import block_tridiag_solve as jax_solve
from kontiki_tpu_torch.solver.banded import _scan_solve


def _system(nb, d, R, seed):
    """(D [nb, d, d], U [nb, d, d], rhs [nb, d, R], dense T [nb d, nb d])."""
    rng = np.random.default_rng(seed)
    D = rng.normal(size=(nb, d, d))
    D = D @ D.transpose(0, 2, 1) + 4 * d * np.eye(d)
    U = rng.normal(size=(nb, d, d))
    U[-1] = 0.0  # ignored by the solvers; zero so that T is the same system
    T = np.zeros((nb * d, nb * d))
    for k in range(nb):
        T[k * d:(k + 1) * d, k * d:(k + 1) * d] = D[k]
        if k + 1 < nb:
            T[k * d:(k + 1) * d, (k + 1) * d:(k + 2) * d] = U[k]
            T[(k + 1) * d:(k + 2) * d, k * d:(k + 1) * d] = U[k].T
    return D, U, rng.normal(size=(nb, d, R)), T


@pytest.mark.parametrize("nb,d,R,seed", [(12, 12, 3, 0), (12, 12, 3, 1), (1, 12, 3, 2),
                                         (5, 48, 14, 3)])
def test_block_tridiag_solve_matches_jax_and_dense(nb, d, R, seed):
    D, U, rhs, T = _system(nb, d, R, seed)
    got = _scan_solve(*(torch.from_numpy(a) for a in (D, U, rhs))).numpy()
    assert got.shape == (nb, d, R)
    want_jax = np.asarray(jax_solve(jnp.asarray(D), jnp.asarray(U), jnp.asarray(rhs),
                                    method="scan"))
    want_dense = np.linalg.solve(T, rhs.reshape(nb * d, R)).reshape(nb, d, R)
    scale = np.abs(want_dense).max()
    assert np.abs(got - want_jax).max() <= 1e-12 * scale
    assert np.abs(got - want_dense).max() <= 1e-12 * scale


def test_indefinite_block_gives_nan_like_jax():
    """A block that is not positive definite makes the solution NaN (the JAX
    Cholesky's answer), without an error or a host read."""
    D, U, rhs, _ = _system(4, 6, 2, 4)
    D[2] = -np.eye(6)
    got = _scan_solve(*(torch.from_numpy(a) for a in (D, U, rhs))).numpy()
    want = np.asarray(jax_solve(jnp.asarray(D), jnp.asarray(U), jnp.asarray(rhs),
                                method="scan"))
    assert np.isnan(want).any() and np.isnan(got).any()
