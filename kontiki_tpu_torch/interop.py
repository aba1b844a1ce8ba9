"""Bring numpy copies of the JAX package's state and runtime into the port,
so both packages compute on the very same numbers.

Convert the JAX side with ``np.asarray`` first (this module never imports
jax): ``state_from_numpy({k: np.asarray(v) for k, v in problem.state0.items()},
...)``. Floats become ``dtype``, integer index arrays int64.
"""
import numpy as np
import torch

from .config import default_dtype


def _tensor(a, device, dtype):
    a = np.array(a)  # a writable copy: JAX hands out read-only buffers
    if np.issubdtype(a.dtype, np.integer):
        return torch.as_tensor(a, device=device).to(torch.int64)
    return torch.as_tensor(a, device=device).to(dtype)


def state_from_numpy(state, device=None, dtype=default_dtype):
    """State dict of numpy arrays -> dict of tensors on ``device``."""
    return {k: _tensor(v, device, dtype) for k, v in state.items()}


def runtime_from_numpy(runtime, device=None, dtype=default_dtype):
    """``problem_runtime`` of the JAX package, as numpy, -> the port's
    runtime (spline timing as host floats, tensors elsewhere)."""
    return {
        "mask": _tensor(runtime["mask"], device, dtype),
        "d_max": _tensor(runtime["d_max"], device, dtype),
        "spline_t0": [float(t) for t in runtime["spline_t0"]],
        "spline_dt": [float(t) for t in runtime["spline_dt"]],
        "data": [
            {k: _tensor(v, device, dtype) for k, v in data.items()}
            for data in runtime["data"]
        ],
    }
