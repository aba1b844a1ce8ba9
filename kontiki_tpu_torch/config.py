"""Numerical defaults of the port.

Everything is float64 by default, like the JAX package's x64 default: the
reference (Ceres) is double-only and its oracles sit at ~1e-7, and Hopper
runs f64 natively. ``Problem`` and the solver take an explicit ``dtype`` and
``device``; host-side object code (trajectories, sensors, measurements)
stores numpy float64.
"""
import numpy as np
import torch

#: dtype of device state and solver tensors
default_dtype = torch.float64
#: dtype of host-side numpy arrays in the object API
host_dtype = np.float64
