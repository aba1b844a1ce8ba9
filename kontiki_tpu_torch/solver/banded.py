"""Block-tridiagonal solve (counterpart of ``kontiki_tpu.solver.banded``'s
``block_tridiag_solve``, its sequential "scan" method; parallel cyclic
reduction and the ``KONTIKI_BAND_SOLVE`` switch are not ported, ROADMAP.md
Queue A 2.1)."""
import torch


def block_tridiag_solve(D, U, rhs):
    """Solve the symmetric block-tridiagonal system T x = rhs.

    ``D [nb, d, d]``: diagonal blocks; ``U [nb, d, d]``: super-diagonal
    blocks (``U[k] = T[k, k+1]``, ``U[nb-1]`` ignored); ``rhs [nb, d, R]``.

    Block Cholesky T = L L^T with ``L_kk = C_k``, ``L_{k+1,k} = B_k``:
    ``C_0 C_0^T = D_0``, ``B_k = (C_k^{-1} U_k)^T``,
    ``C_{k+1} C_{k+1}^T = D_{k+1} - B_k B_k^T``; then forward and backward
    substitution, one Python loop over the blocks each (the JAX package's
    two ``lax.scan``s). ``cholesky_ex`` does not read its ``info`` back to
    the host, so the loop never waits on the device; a block that is not
    positive definite turns its factor into NaN, as the JAX Cholesky does."""
    nb = D.shape[0]
    tri = torch.linalg.solve_triangular
    Cs, BTs, zs = [], [], []
    for k in range(nb):
        Dk, rk = D[k], rhs[k]
        if k:
            # B_{k-1}^T = C_{k-1}^{-1} U_{k-1}
            BT = tri(Cs[-1], U[k - 1], upper=False)
            Dk = Dk - BT.T @ BT
            rk = rk - BT.T @ zs[-1]
            BTs.append(BT)
        Ck, info = torch.linalg.cholesky_ex(Dk)
        Ck = torch.where(info == 0, Ck, torch.nan)
        Cs.append(Ck)
        zs.append(tri(Ck, rk, upper=False))
    xs = [None] * nb
    for k in reversed(range(nb)):
        # L^T x = z: x_k = C_k^{-T} (z_k - B_k^T x_{k+1})
        zk = zs[k] if k == nb - 1 else zs[k] - BTs[k] @ xs[k + 1]
        xs[k] = tri(Cs[k].T, zk, upper=True)
    return torch.stack(xs)
