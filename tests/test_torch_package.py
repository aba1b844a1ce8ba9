"""The port stands alone: ``kontiki_tpu_torch`` imports without jax."""
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "kontiki_tpu_torch"


def test_import_with_jax_blocked():
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import kontiki_tpu_torch, kontiki_tpu_torch.synthetic, kontiki_tpu_torch.utils, "
        "kontiki_tpu_torch.interop, kontiki_tpu_torch.estimator, kontiki_tpu_torch._ceres\n"
        "from kontiki_tpu_torch.solver import lm, schur, kernels\n"
        "from kontiki_tpu_torch.ops import build, linearize_kernels, assembly_kernels, "
        "spline_kernels, r3_evaluate_kernel\n"
        "from kontiki_tpu_torch.trajectories import spline_eval, splines\n"
        "from kontiki_tpu_torch.measurements import PositionMeasurement, "
        "OrientationMeasurement\n"
        "from kontiki_tpu_torch.interop import trajectory_from_numpy, raw_problem_from_numpy\n"
        "from kontiki_tpu_torch.solver import banded, iterative, kkt\n"
        "from kontiki_tpu_torch.parallel import segments_ba, make_segment_ba_solver\n"
        "from kontiki_tpu_torch.parallel import mesh, launch, distributed, schur, iterative, "
        "segments\n"
        "from kontiki_tpu_torch.parallel import Mesh, make_sharded_step, "
        "make_sharded_schur_step, make_sharded_iterative_step, make_segment_sharded_step\n"
        "from kontiki_tpu_torch.parallel.launch import run_spmd\n"
        "from kontiki_tpu_torch.solver.banded import spike_block_tridiag_solve\n"
        "from kontiki_tpu_torch.ops.linearize_kernels import onehot_expand_rows\n"
        "from kontiki_tpu_torch.ops.linearize_kernels import newton_rows, newton_rows_plain\n"
        "from kontiki_tpu_torch.measurements import NewtonRsCameraMeasurement\n"
        "from kontiki_tpu_torch import native, sew, io\n"
        "from kontiki_tpu_torch.measurements import GyroscopeMeasurements, "
        "AccelerometerMeasurements\n"
        "assert native.available()\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'kontiki_tpu.')) "
        "for m in sys.modules if sys.modules[m] is not None)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize(
    "path", sorted(str(p.relative_to(ROOT)) for p in PKG.rglob("*.py"))
)
def test_no_jax_import_in_port(path):
    text = (ROOT / path).read_text()
    assert "import jax" not in text and "from jax" not in text
    assert "from kontiki_tpu " not in text and "import kontiki_tpu\n" not in text
    assert "from kontiki_tpu." not in text and "import kontiki_tpu." not in text
