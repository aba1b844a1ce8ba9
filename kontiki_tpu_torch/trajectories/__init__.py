from .splines import UniformSE3SplineTrajectory  # noqa: F401
from . import spline_eval  # noqa: F401
