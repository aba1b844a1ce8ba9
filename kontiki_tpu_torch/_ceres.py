"""Solver observability surface, Ceres-compatible (counterpart of
``kontiki_tpu._ceres``).

The reference exposes ceres::Solver::Summary, IterationSummary,
TerminationType and CallbackReturnType to Python (its py_ceres.cc). The
same names, fields and defaults are kept here, so code written against the
reference or the JAX package reads the port's Summary unchanged. Fields the
JAX package leaves at 0 (``fixed_cost``, ``num_effective_parameters*``,
``gradient_norm``, ``linear_solver_iterations``) stay 0 here too; the
values are filled in by ``solver.lm.solve``."""
import enum
from dataclasses import dataclass, field
from typing import List


class CallbackReturnType(enum.Enum):
    Abort = 0
    Continue = 1
    TerminateSuccessfully = 2


class TerminationType(enum.Enum):
    Convergence = 0
    NoConvergence = 1
    Failure = 2
    UserSuccess = 3
    UserFailure = 4


@dataclass
class IterationSummary:
    iteration: int = 0
    step_is_valid: bool = True
    step_is_nonmonotonic: bool = False
    step_is_successful: bool = True
    cost: float = 0.0
    cost_change: float = 0.0
    gradient_norm: float = 0.0
    gradient_max_norm: float = 0.0
    step_norm: float = 0.0
    relative_decrease: float = 0.0
    trust_region_radius: float = 0.0
    eta: float = 0.0
    linear_solver_iterations: int = 0
    step_solver_time_in_seconds: float = 0.0
    iteration_time_in_seconds: float = 0.0
    cumulative_time_in_seconds: float = 0.0


@dataclass
class Summary:
    initial_cost: float = 0.0
    final_cost: float = 0.0
    fixed_cost: float = 0.0
    num_parameters: int = 0
    num_parameter_blocks: int = 0
    num_parameters_reduced: int = 0
    num_parameter_blocks_reduced: int = 0
    num_residuals: int = 0
    num_residual_blocks: int = 0
    num_residuals_reduced: int = 0
    num_residual_blocks_reduced: int = 0
    num_effective_parameters: int = 0
    num_effective_parameters_reduced: int = 0
    num_successful_steps: int = 0
    num_unsuccessful_steps: int = 0
    num_inner_iteration_steps: int = 0
    preprocessor_time_in_seconds: float = 0.0
    minimizer_time_in_seconds: float = 0.0
    postprocessor_time_in_seconds: float = 0.0
    total_time_in_seconds: float = 0.0
    linear_solver_time_in_seconds: float = 0.0
    residual_evaluation_time_in_seconds: float = 0.0
    jacobian_evaluation_time_in_seconds: float = 0.0
    num_threads_given: int = 1
    num_threads_used: int = 1
    termination_type: TerminationType = TerminationType.Failure
    message: str = ""
    iterations: List[IterationSummary] = field(default_factory=list)

    def IsSolutionUsable(self):
        return self.termination_type in (
            TerminationType.Convergence,
            TerminationType.NoConvergence,
            TerminationType.UserSuccess,
        )

    def BriefReport(self):
        return (
            f"kontiki_tpu_torch Solver Report: Iterations: {len(self.iterations)}, "
            f"Initial cost: {self.initial_cost:.6e}, "
            f"Final cost: {self.final_cost:.6e}, "
            f"Termination: {self.termination_type.name}"
        )

    def FullReport(self):
        lines = [
            "",
            "kontiki_tpu_torch Solver Report",
            "-------------------------",
            f"{'Parameter blocks':<32}{self.num_parameter_blocks:>12}{self.num_parameter_blocks_reduced:>12}",
            f"{'Parameters':<32}{self.num_parameters:>12}{self.num_parameters_reduced:>12}",
            f"{'Residual blocks':<32}{self.num_residual_blocks:>12}{self.num_residual_blocks_reduced:>12}",
            f"{'Residuals':<32}{self.num_residuals:>12}{self.num_residuals_reduced:>12}",
            "",
            f"{'Initial cost':<32}{self.initial_cost:.6e}",
            f"{'Final cost':<32}{self.final_cost:.6e}",
            f"{'Termination':<32}{self.termination_type.name} ({self.message})",
            "",
            f"{'Successful steps':<32}{self.num_successful_steps:>12}",
            f"{'Unsuccessful steps':<32}{self.num_unsuccessful_steps:>12}",
            "",
            f"{'Time (in seconds):':<32}",
            f"{'  Residual evaluation':<32}{self.residual_evaluation_time_in_seconds:>12.6f}",
            f"{'  Jacobian evaluation':<32}{self.jacobian_evaluation_time_in_seconds:>12.6f}",
            f"{'  Linear solver':<32}{self.linear_solver_time_in_seconds:>12.6f}",
            f"{'  Minimizer':<32}{self.minimizer_time_in_seconds:>12.6f}",
            f"{'  Total':<32}{self.total_time_in_seconds:>12.6f}",
        ]
        return "\n".join(lines)
