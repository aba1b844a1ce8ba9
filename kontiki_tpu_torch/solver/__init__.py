from .problem import Problem  # noqa: F401
from .lm import make_fused_solver  # noqa: F401
