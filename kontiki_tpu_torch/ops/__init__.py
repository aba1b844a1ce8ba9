"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version: ``linearize_kernels`` (camera-row linearization and cost, IMU
rows, the trajectory queries' window evaluation, the one-hot row expansion
of the banded segment-BA assembly), ``assembly_kernels``
(Gauss-Newton and landmark-elimination assembly) and ``spline_kernels``
(``r3_evaluate_kernel``, the R3 spline at arbitrary times). Sources live in
``../csrc``; they are built with ``nvcc`` at first use on a CUDA tensor
(``ops/build.py``)."""
from .spline_kernels import r3_evaluate_kernel  # noqa: F401
