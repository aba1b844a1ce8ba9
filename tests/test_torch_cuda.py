"""The port's CUDA kernels against their plain PyTorch versions on the card.

Needs a CUDA device (marked ``gpu``; skipped elsewhere). Imports neither jax
nor the JAX package, so it runs where only the port is installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_cuda.py

Tolerances are normwise (max |kernel - plain| / max |plain|): 1e-10 in
float64; in float32 1e-3 for the linearization (cancellation in the SE3
log / V^-1 coefficients) and 1e-4 for the assembly (~1e4-term sums whose
order the atomics change from run to run)."""
import numpy as np
import pytest
import torch

from kontiki_tpu_torch.ops import assembly_kernels as ak
from kontiki_tpu_torch.ops import linearize_kernels as lk
from kontiki_tpu_torch.solver import kernels
from kontiki_tpu_torch.solver.lm import make_fused_solver
from kontiki_tpu_torch.solver.problem import Problem
from kontiki_tpu_torch.synthetic import make_rsvi_problem

torch.set_num_threads(1)
pytestmark = pytest.mark.gpu
SMALL = dict(nviews=8, nlandmarks=24, imu_rate=200.0, seed=4, noise_px=1.0)


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(scope="module")
def problems(cuda):
    gen = make_rsvi_problem(**SMALL)
    return (gen, Problem(gen["trajectory"], gen["measurements"]),
            Problem(gen["trajectory"], gen["measurements"], device=cuda))


def _assert_close(got, want, tol):
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert (g - w).abs().max().item() <= tol * w.abs().max().item()


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10), (torch.float32, 1e-3)])
def test_linearize_rows_kernel_matches_plain(problems, dtype, tol):
    problem = problems[2]
    spec, rt = kernels.problem_spec(problem), kernels.problem_runtime(problem)
    ins, _ = kernels._camera_inputs(spec, rt, problem.state0, rt["data"][0])
    x = {k: v.to(dtype).contiguous() for k, v in ins.items()}
    before = lk.linearize_rows.launches
    got = lk.linearize_rows(x)
    assert lk.linearize_rows.launches == before + 1
    _assert_close(got, lk.linearize_rows_plain(x), tol)


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10), (torch.float32, 1e-4)])
def test_assemble_kernel_matches_plain(cuda, dtype, tol):
    rng = np.random.default_rng(3)
    M, rdim, C, P, L = 300, 2, 61, 40, 12
    cols = rng.integers(0, P, size=(M, C)).astype(np.int32)
    cols[:, 1] = cols[:, 0]  # duplicate columns within a row accumulate
    rows = (
        torch.tensor(rng.normal(size=(M, rdim, C)), dtype=dtype, device=cuda),
        torch.tensor(cols, device=cuda),
        torch.tensor(rng.normal(size=(M, rdim)), dtype=dtype, device=cuda),
        torch.tensor(rng.normal(size=(M, rdim)), dtype=dtype, device=cuda),
        torch.tensor(rng.integers(0, L, size=M).astype(np.int32), device=cuda),
    )
    before = ak.assemble_schur_blocks.launches
    got = ak.assemble_schur_blocks(*rows, P=P, L=L, with_rho=True)
    assert ak.assemble_schur_blocks.launches == before + 1
    _assert_close(got, ak.assemble_schur_blocks_plain(*rows, P=P, L=L, with_rho=True), tol)


def test_solve_on_cuda_matches_cpu(problems):
    """The whole slice through the kernels equals the plain CPU path."""
    _, cpu, gpu = problems
    s0, c0, it0 = make_fused_solver(cpu, 5, function_tolerance=0.0)(cpu.state0)
    s1, c1, it1 = make_fused_solver(gpu, 5, function_tolerance=0.0)(gpu.state0)
    assert it1 == it0
    np.testing.assert_allclose(c1.item(), c0.item(), rtol=1e-8)
    for k, v in s1.items():
        np.testing.assert_allclose(v.cpu().numpy(), s0[k].numpy(), rtol=0, atol=1e-7)
