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
        "import kontiki_tpu_torch, kontiki_tpu_torch.synthetic, "
        "kontiki_tpu_torch.interop\n"
        "from kontiki_tpu_torch.solver import lm, schur, kernels\n"
        "from kontiki_tpu_torch.ops import build, linearize_kernels, assembly_kernels\n"
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
