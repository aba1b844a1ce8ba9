"""The CUDA kernels' own row code, compiled for the host with a plain C++
compiler (``csrc/host_rows.cpp``), against the plain PyTorch versions in
float64: B4 ``imu_rows`` in every variant, and B1 ``linearize_rows`` on a
small config-4-shaped problem. This checks the kernels' arithmetic without
a card (1e-12 relative to max |plain| per output), in the kernels' own
schedules (B4: its lane group, lane after lane) and in the one full-width
jet per row that the operation counts for the kernels' bounds in
``chip_smoke.py`` run."""
import shutil

import pytest
import torch

from kontiki_tpu_torch.ops import linearize_kernels as tlk
from kontiki_tpu_torch.solver import kernels as tk
from kontiki_tpu_torch.solver.problem import Problem
from kontiki_tpu_torch.synthetic import make_rsvi_problem
from test_torch_imu_kernel import VARIANTS, _cfg, _torch_ins

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def host_library():
    if not (shutil.which("c++") or shutil.which("g++")):
        pytest.skip("needs a host C++ compiler")
    from kontiki_tpu_torch.ops.build import load_host_library

    return load_host_library()


def _assert_close(got, want):
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-12, atol=1e-12 * w.abs().max().item())


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_imu_row_code_matches_plain(host_library, variant):
    cfg, tins = _cfg(variant), _torch_ins(variant)
    want = tlk.imu_rows_plain(cfg, tins)
    _assert_close(tlk.imu_rows_host(cfg, tins), want)
    _assert_close(tlk.imu_rows_host(cfg, tins, wide=True), want)
    _assert_close([tlk.imu_rows_host(cfg, tins, cost_only=True)], [want[0]])
    assert tlk.imu_rows_ops(cfg, tins) > tlk.imu_rows_ops(cfg, tins, cost_only=True) > 0


def test_linearize_row_code_matches_plain(host_library):
    gen = make_rsvi_problem(nviews=3, nlandmarks=6, imu_rate=0.0, seed=4, trajectory="se3")
    problem = Problem(gen["trajectory"], gen["measurements"], device="cpu")
    spec, rt = tk.problem_spec(problem), tk.problem_runtime(problem)
    cfg, ins, _ = tk._camera_inputs(spec, rt, problem.state0, rt["data"][0])
    want = tlk.linearize_rows_plain(cfg, ins)
    _assert_close(tlk.linearize_rows_host(cfg, ins), want)
    _assert_close(tlk.linearize_rows_host(cfg, ins, wide=True), want)
    assert tlk.linearize_rows_ops(cfg, ins) > 0
