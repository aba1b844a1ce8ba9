"""The iterative-Schur strategy's fused solver against the JAX package's,
in float64 on the CPU: ``make_fused_solver(problem, 3,
function_tolerance=0.0, strategy="iterative_schur")`` on the split camera
problem of ``tests/test_torch_iterative.py`` (a file of its own: the JAX
loop's compile takes about half a minute). The same iterations, the final
cost to 1e-9 relative or 1e-10 of the initial cost (CG stops at a residual
of 1e-10 relative, so the two packages' steps differ by ~1e-10 relative);
one CG solve an iteration, each within its 500-iteration cap."""
import torch

from kontiki_tpu.solver import lm as jlm
from kontiki_tpu_torch.solver import iterative as tit
from kontiki_tpu_torch.solver import lm as tlm
from test_torch_iterative import camera

torch.set_num_threads(1)


def test_fused_solver_matches_jax(monkeypatch):
    J, T = camera()["jax"], camera()["torch"]
    want = jlm.make_fused_solver(J, 3, function_tolerance=0.0,
                                 strategy="iterative_schur")(J.state0)
    ks = []
    pcg = tit.pcg

    def counted(*args, **kw):
        x, k = pcg(*args, **kw)
        ks.append(int(k))
        return x, k

    monkeypatch.setattr(tit, "pcg", counted)
    got = tlm.make_fused_solver(T, 3, function_tolerance=0.0,
                                strategy="iterative_schur")(T.state0)
    assert got[2] == int(want[2]) == 3
    c0 = tit.make_iterative_step(T)[1](T.state0).item()
    assert abs(got[1].item() - float(want[1])) <= max(1e-9 * float(want[1]), 1e-10 * c0)
    assert len(ks) == 3 and all(0 < k <= 500 for k in ks)
