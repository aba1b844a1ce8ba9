"""Port parity: Schur assembly (kernel B2's plain PyTorch version,
``ops.assembly_kernels.assemble_schur_blocks_plain``) against the JAX
package's Pallas kernel (interpret mode, one 128-row tile) and against the
numpy loop oracle of ``tests/test_assembly_kernel.py``, in float64
(rtol 1e-10, atol 1e-12 as in that test). Duplicate column ids within a
row must accumulate."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kontiki_tpu.ops.assembly_kernels import assemble_schur_blocks as jax_assemble
from kontiki_tpu_torch.ops import assembly_kernels as tak
from test_assembly_kernel import _reference

torch.set_num_threads(1)
NAMES = ("H", "g", "E", "D", "g_l")


def _rows(M, rdim, C, P, L, seed):
    rng = np.random.default_rng(seed)
    Jw = rng.normal(size=(M, rdim, C))
    cols = rng.integers(0, P, size=(M, C)).astype(np.int32)
    cols[:, 1] = cols[:, 0]  # duplicate columns within a row
    rw = rng.normal(size=(M, rdim))
    J_rho = rng.normal(size=(M, rdim))
    lid = rng.integers(0, L, size=M).astype(np.int32)
    return Jw, cols, rw, J_rho, lid


def _torch(rows):
    return tuple(torch.tensor(a) for a in rows)


def _close(got, want):
    for name, g, w in zip(NAMES, got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-10, atol=1e-12,
                                   err_msg=name)


def test_plain_matches_pallas_kernel_one_tile():
    M, rdim, C, P, L = 37, 2, 11, 29, 5
    rows = _rows(M, rdim, C, P, L, seed=0)
    want = jax_assemble(*[jnp.asarray(a) for a in rows], P=P, L=L,
                        with_rho=True, interpret=True)
    got = tak.assemble_schur_blocks_plain(*_torch(rows), P=P, L=L, with_rho=True)
    _close(got, want)


@pytest.mark.parametrize("M,rdim,C,P,L", [
    (37, 2, 11, 29, 5), (130, 3, 7, 150, 20), (300, 2, 61, 40, 12),
])
def test_plain_matches_numpy_oracle(M, rdim, C, P, L):
    rows = _rows(M, rdim, C, P, L, seed=M)
    got = tak.assemble_schur_blocks_plain(*_torch(rows), P=P, L=L, with_rho=True)
    _close(got, _reference(*rows, P, L))


def test_without_rho_and_wrapper_on_cpu():
    M, rdim, C, P = 40, 3, 9, 33
    rows = _rows(M, rdim, C, P, 1, seed=1)
    rows = (rows[0], rows[1], rows[2], np.zeros((M, rdim)), np.zeros(M, np.int32))
    H, g, E, D, g_l = tak.assemble_schur_blocks(*_torch(rows), P=P, L=1, with_rho=False)
    assert E is None and D is None and g_l is None
    _close((H, g), _reference(*rows, P, 1)[:2])


def test_wrapper_checks_inputs():
    rows = _torch(_rows(10, 2, 5, 8, 3, seed=2))
    with pytest.raises(ValueError):  # int64 column ids
        tak.assemble_schur_blocks(rows[0], rows[1].long(), *rows[2:], P=8, L=3,
                                  with_rho=True)
    with pytest.raises(ValueError):  # non-contiguous rows
        tak.assemble_schur_blocks(rows[0].transpose(1, 2).contiguous().transpose(1, 2),
                                  *rows[1:], P=8, L=3, with_rho=True)

