"""kontiki_tpu_torch — the PyTorch + CUDA port of kontiki_tpu.

Mirrors the JAX package's module paths and names. It imports torch and never
jax; the JAX package stays beside it as the reference the port is tested
against. The hot kernels of the config-4 solve (camera-row linearization and
Schur assembly) are hand-written CUDA C++ for Hopper (``csrc/``), each beside
a plain PyTorch version that runs for CPU tensors.
"""
from . import config  # noqa: F401

__version__ = "0.1.0"

from . import constants, math, rotations  # noqa: F401,E402
from .trajectories import UniformSE3SplineTrajectory  # noqa: F401,E402
from . import measurements, sensors, sfm  # noqa: F401,E402
