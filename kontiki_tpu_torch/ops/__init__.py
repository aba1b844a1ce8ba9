"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version: ``linearize_kernels.linearize_rows`` (camera-row linearization)
and ``assembly_kernels.assemble_schur_blocks`` (Gauss-Newton and
landmark-elimination assembly). Sources live in ``../csrc``; they are built
with ``nvcc`` at first use on a CUDA tensor (``ops/build.py``)."""
