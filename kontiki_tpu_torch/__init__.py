"""kontiki_tpu_torch — the PyTorch + CUDA port of kontiki_tpu.

Mirrors the JAX package's module paths and names. It imports torch and never
jax; the JAX package stays beside it as the reference the port is tested
against. Users call ``TrajectoryEstimator(trajectory).solve()`` as with the
reference and read the trajectory back through its queries. The hot kernels
of the camera solves of configs 3 and 4 (camera-row linearization and cost
on pinhole and atan cameras, static and lifting rows; Schur assembly), of
the IMU-fusion solves of configs 1 and 2 (gyro and accel rows), of config
5's banded segment BA (one-hot row expansion) and of the trajectory queries
(window evaluation, the R3 spline at arbitrary times) are hand-written CUDA
C++ for Hopper (``csrc/``), each beside a plain PyTorch version that runs
for CPU tensors. Long IMU recordings go in as arrays (the batch containers
``measurements.GyroscopeMeasurements`` / ``AccelerometerMeasurements``,
weighted by ``sew``), compiled through the native C++ host helper
(``native``); ``io`` reads and writes the reference's HDF5 files (it needs
``h5py`` and is not imported here).
"""
from . import config  # noqa: F401

__version__ = "0.1.0"

from . import constants, math, rotations, sew, utils  # noqa: F401,E402
from .trajectories import (  # noqa: F401,E402
    SplitTrajectory,
    UniformR3SplineTrajectory,
    UniformSE3SplineTrajectory,
    UniformSO3SplineTrajectory,
)
from . import measurements, sensors, sfm  # noqa: F401,E402
from .measurements import OrientationMeasurement, PositionMeasurement  # noqa: F401,E402
from . import _ceres  # noqa: F401,E402
from ._ceres import (  # noqa: F401,E402
    CallbackReturnType,
    IterationSummary,
    Summary,
    TerminationType,
)
from .estimator import TrajectoryEstimator  # noqa: F401,E402
