from .splines import (  # noqa: F401
    SplitTrajectory,
    UniformR3SplineTrajectory,
    UniformSE3SplineTrajectory,
    UniformSO3SplineTrajectory,
)
from . import spline_eval  # noqa: F401
