"""Kernel B6's plain version (``onehot_expand_rows_plain``) against the JAX
package's ``onehot_expand_rows`` (Pallas, interpret mode) and against the
one-hot product of its non-TPU path, on M = 300 rows (three of the TPU
kernel's 128-row tiles), rdim 2, C = 61, WB = 109, with duplicate ids and
ids -1 and WB in every row, in float64.

Tolerance: exact. Every output entry sums at most two entries (a camera
row's ref and obs windows may name one knot twice), and a + b rounds the
same way in any order, with or without the zero products of the one-hot
form.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kontiki_tpu.ops.linearize_kernels import onehot_expand_rows as jax_expand
from kontiki_tpu_torch.ops import linearize_kernels as lk

M, RDIM, C, WB = 300, 2, 61, 109


def _inputs(M=M, WB=WB, seed=0):
    """Jw [M, 2, C] and rel [M, C]: per row, C ids drawn from [-1, WB]
    with every id at most twice."""
    rng = np.random.default_rng(seed)
    Jw = rng.normal(size=(M, RDIM, C))
    pool = np.argsort(rng.random((M, 2 * (WB + 2))), axis=1)[:, :C]
    return Jw, pool // 2 - 1


def _plain(Jw, rel, **kw):
    return lk.onehot_expand_rows_plain(torch.from_numpy(Jw), torch.from_numpy(rel), WB,
                                       **kw).numpy()


def test_inputs_hold_duplicates_and_out_of_range_ids():
    _, rel = _inputs()
    counts = np.stack([np.bincount(r + 1, minlength=WB + 2) for r in rel])
    assert counts.max() == 2 and (counts[:, 1:-1] == 2).any(axis=1).all()
    assert (rel == -1).any() and (rel == WB).any()


def test_plain_matches_pallas_interpret():
    Jw, rel = _inputs()
    want = np.asarray(jax_expand(jnp.asarray(Jw), jnp.asarray(rel), WB=WB, interpret=True))
    np.testing.assert_array_equal(_plain(Jw, rel), want)


@pytest.mark.parametrize("chunk", [4096, 128, 7])
def test_plain_matches_jax_onehot_product(chunk):
    """The JAX package's non-TPU formula (parallel/segments_ba.py
    ``_dense_rows``): a one-hot of ``rel`` against ``arange(WB)`` and one
    product, whatever the plain version's chunk of rows."""
    Jw, rel = _inputs()
    oh = (jnp.asarray(rel)[:, :, None] == jnp.arange(WB)[None, None, :]).astype(jnp.float64)
    want = np.asarray(jnp.einsum("mrc,mcw->mrw", jnp.asarray(Jw), oh))
    np.testing.assert_array_equal(_plain(Jw, rel, chunk=chunk), want)


def test_plain_sums_duplicates_and_drops_out_of_range():
    Jw, rel = _inputs(M=5)
    got = _plain(Jw, rel)
    want = np.zeros((5, RDIM, WB))
    for m in range(5):
        for c in range(C):
            if 0 <= rel[m, c] < WB:
                want[m, :, rel[m, c]] += Jw[m, :, c]
    np.testing.assert_array_equal(got, want)


def test_cpu_wrapper_takes_the_plain_version(monkeypatch):
    Jw, rel = _inputs(M=20)
    calls = []
    plain = lk.onehot_expand_rows_plain
    monkeypatch.setattr(lk, "onehot_expand_rows_plain",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    before = lk.onehot_expand_rows.launches
    got = lk.onehot_expand_rows(torch.from_numpy(Jw), torch.from_numpy(rel), WB)
    assert calls == [1] and lk.onehot_expand_rows.launches == before
    np.testing.assert_array_equal(got.numpy(), _plain(Jw, rel))
    empty = lk.onehot_expand_rows(torch.zeros(0, RDIM, C, dtype=torch.float64),
                                  torch.zeros(0, C, dtype=torch.int64), WB)
    assert empty.shape == (0, RDIM, WB)


@pytest.mark.parametrize("bad", ["int32 ids", "shape", "integer Jw"])
def test_wrapper_rejects_bad_inputs(bad):
    Jw, rel = (torch.from_numpy(a) for a in _inputs(M=4))
    if bad == "int32 ids":
        rel = rel.to(torch.int32)
    elif bad == "shape":
        rel = rel[:, :-1]
    else:
        Jw = Jw.to(torch.int64)
    with pytest.raises(ValueError):
        lk.onehot_expand_rows(Jw, rel, WB)
