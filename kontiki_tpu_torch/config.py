"""Numerical defaults of the port.

Everything is float64 by default, like the JAX package's x64 default: the
reference (Ceres) is double-only and its oracles sit at ~1e-7, and Hopper
runs f64 natively. ``Problem`` and the solver take an explicit ``dtype`` and
``device``; host-side object code (trajectories, sensors, measurements)
stores numpy float64.

Entry points that place tensors (``Problem``, ``interop``) run on the CUDA
card unless the caller asks for another device; the CPU is taken only when
asked for by name (``device="cpu"``), never as a fallback.
"""
import numpy as np
import torch

#: dtype of device state and solver tensors
default_dtype = torch.float64
#: dtype of host-side numpy arrays in the object API
host_dtype = np.float64


def resolve_device(device=None):
    """``device`` as a ``torch.device``; ``None`` means the CUDA card, and
    raises where there is none (no silent CPU fallback)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return torch.device("cuda")
