from .problem import Problem  # noqa: F401
from .kernels import make_functions, retract_state  # noqa: F401
from .lm import make_fused_solver, solve  # noqa: F401
