"""Bring numpy copies of the JAX package's state and runtime into the port,
so both packages compute on the very same numbers.

Convert the JAX side with ``np.asarray`` first (this module never imports
jax): ``state_from_numpy({k: np.asarray(v) for k, v in problem.state0.items()},
...)``. Every key is carried as it is, so SE3, R3, SO3 and split states,
the IMU biases and the lifted row times ``vt`` all come across, and so do
the bucket data of atan cameras (``wc``, ``gamma``) and lifting rows
(``vt_idx``, ``vt_orig``). Floats become ``dtype``, integer index arrays
int64. ``device=None`` means the CUDA card (``config.resolve_device``).

``trajectory_from_numpy`` and ``split_trajectory_from_numpy`` carry a
trajectory's knots across: the JAX package's stored knot rows (R3 xyz, SO3
wxyz, SE3 packed q wxyz + t; ``np.asarray(traj.knots)``) become a port
trajectory with the same ``dt``, ``t0`` and rows, bit for bit.

``raw_problem_arrays`` reads either package's ``RawProblem`` into numpy
(splines, bucket data, sensors, rho, masks); ``raw_problem_from_numpy``
builds the port's ``RawProblem`` from them, so both packages compute on
the same array-level problem (BASELINE config 5).
"""
import numpy as np
import torch

from .config import default_dtype, host_dtype, resolve_device
from .trajectories import (
    SplitTrajectory,
    UniformR3SplineTrajectory,
    UniformSE3SplineTrajectory,
    UniformSO3SplineTrajectory,
)

_SPLINES = {"r3": UniformR3SplineTrajectory, "so3": UniformSO3SplineTrajectory,
            "se3": UniformSE3SplineTrajectory}


def _tensor(a, device, dtype):
    a = np.array(a)  # a writable copy: JAX hands out read-only buffers
    if np.issubdtype(a.dtype, np.integer):
        return torch.as_tensor(a, device=device).to(torch.int64)
    return torch.as_tensor(a, device=device).to(dtype)


def state_from_numpy(state, device=None, dtype=default_dtype):
    """State dict of numpy arrays -> dict of tensors on ``device``."""
    device = resolve_device(device)
    return {k: _tensor(v, device, dtype) for k, v in state.items()}


def runtime_from_numpy(runtime, device=None, dtype=default_dtype):
    """``problem_runtime`` of the JAX package, as numpy, -> the port's
    runtime (spline timing as host floats, tensors elsewhere)."""
    device = resolve_device(device)
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


def trajectory_from_numpy(kind, knots, dt, t0, device=None):
    """A port spline of ``kind`` ('r3' | 'so3' | 'se3') holding the stored
    knot rows ``knots`` [n, D] as they are (no re-validation or
    re-conversion); its queries run on ``device`` (None: the CUDA card)."""
    traj = _SPLINES[kind](dt, t0, device=device)
    knots = np.array(knots, dtype=host_dtype).reshape(-1, traj._KNOT_DIM)
    if len(knots):
        traj._knots = knots
        traj._n = len(knots)
    return traj


def split_trajectory_from_numpy(r3_knots, so3_knots, r3_dt, so3_dt, r3_t0, so3_t0,
                                device=None):
    """A port ``SplitTrajectory`` from the R3 and SO3 splines' stored knot
    rows, spacings and start times."""
    return SplitTrajectory(
        trajectory_from_numpy("r3", r3_knots, r3_dt, r3_t0, device),
        trajectory_from_numpy("so3", so3_knots, so3_dt, so3_t0, device),
        device=device,
    )


def raw_problem_arrays(problem):
    """The arrays of a ``RawProblem`` of either package as numpy: the
    keyword arguments of ``raw_problem_from_numpy``. Buckets become dicts of
    ``rdim``, ``window``, ``data`` and ``camera`` (the camera class's name
    or None)."""
    def arr(a):
        return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)

    state = {k: arr(v) for k, v in problem.state0.items()}
    mask = arr(problem.mask)
    S, L = len(problem.sensors), len(problem.landmarks)
    so, lo = problem.sensor_offset, problem.landmark_offset
    sensors = {k: state[k] for k in ("q_ct", "p_ct", "d", "abias", "gbias")}
    sensors["mask"] = mask[so: so + 13 * S].reshape(S, 13)
    sensors["d_max"] = arr(problem.d_max)
    return dict(
        splines=[(sp.kind, state[sp.kind], sp.t0, sp.dt) for sp in problem.splines],
        buckets={key: dict(rdim=b.rdim, window=dict(b.window),
                           data={k: arr(v) for k, v in b.data.items()},
                           camera=b.camera_cls.__name__ if b.camera_cls else None)
                 for key, b in problem.buckets.items()},
        sensors=sensors,
        rho=state["rho"],
        landmark_mask=mask[lo: lo + L],
        vt=state["vt"],
    )


def raw_problem_from_numpy(splines, buckets, sensors, rho, landmark_mask=None, vt=None,
                           device=None, dtype=default_dtype):
    """The port's ``solver.problem.RawProblem`` on ``device`` (None: the CUDA
    card) from numpy arrays in ``raw_problem_arrays``'s form; a bucket's
    ``camera`` names a camera class of ``kontiki_tpu_torch.sensors``."""
    from . import sensors as sensor_classes
    from .solver.problem import RawBucket, RawProblem

    raw = {}
    for key, b in buckets.items():
        cam = getattr(sensor_classes, b["camera"]) if b.get("camera") else None
        M = int(next(iter(b["data"].values())).shape[0]) if b["data"] else 0
        raw[key] = RawBucket(kind=key, M=M, rdim=int(b["rdim"]), data=dict(b["data"]),
                             window=dict(b["window"]), camera_cls=cam)
    return RawProblem(splines, raw, sensors, rho, landmark_mask=landmark_mask, vt=vt,
                      device=device, dtype=dtype)
