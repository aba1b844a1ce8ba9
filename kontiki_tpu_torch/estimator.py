"""TrajectoryEstimator: the user-facing solver facade (counterpart of
``kontiki_tpu.estimator``).

API of the reference bindings (its py_trajectory_estimator.cc and
kontiki/__init__.py): construct with a trajectory, ``add_measurement``,
``add_callback(cb, update_state=False)``, ``solve(max_iterations=50,
progress=True, num_threads=-1)`` returning a Ceres-compatible Summary.
Measurements are recorded here and compiled into device tensors
(``solver.problem.Problem``) at ``solve()`` time, on the CUDA card unless
``device`` names another (``device="cpu"`` runs on the CPU); the solution
is written back into the trajectory, sensor and landmark objects, and the
lifted row times into the ``LiftingRsCameraMeasurement`` objects.
"""
from ._ceres import CallbackReturnType, Summary, TerminationType  # noqa: F401
from .config import default_dtype
from .solver.lm import solve as _lm_solve
from .solver.problem import Problem


class TrajectoryEstimator:
    def __init__(self, trajectory, device=None, dtype=default_dtype):
        self._trajectory = trajectory
        self._device = device
        self._dtype = dtype
        self._measurements = []
        self._callbacks = []
        self._callback_needs_state = False

    @property
    def trajectory(self):
        return self._trajectory

    def add_measurement(self, m):
        self._measurements.append(m)

    def add_callback(self, callback, update_state=False):
        self._callbacks.append(callback)
        self._callback_needs_state = self._callback_needs_state or update_state

    def solve(self, max_iterations=50, progress=True, num_threads=-1, **options):
        """Compile the problem and run Levenberg-Marquardt
        (``solver.lm.solve``; ``options`` go to it). ``num_threads`` is
        accepted for the reference's API and recorded in the Summary."""
        problem = Problem(self._trajectory, self._measurements, device=self._device,
                          dtype=self._dtype)
        state, summary = _lm_solve(
            problem,
            max_iterations=max_iterations,
            progress=progress,
            callbacks=self._callbacks,
            callback_needs_state=self._callback_needs_state,
            **options,
        )
        problem.write_back(state)
        summary.num_threads_given = num_threads
        return summary
