"""``parallel.segments_ba`` with gyro and accel rows (kernel B4) beside the
camera rows: BASELINE config 5's generator with IMU rows at 50 Hz from a
second sensor, at the JAX tests' size, against the JAX package's step,
``total_cost`` and 3-iteration solver (the tolerances of
``tests/test_torch_segments_ba.py``)."""
import pytest

from test_torch_segments_ba import _check_solve, _check_step, _pair


@pytest.fixture(scope="module")
def imu():
    return _pair(50.0)


def test_step_matches_jax_with_imu_rows(imu):
    _check_step(*imu)


def test_solver_matches_jax_with_imu_rows(imu):
    _check_solve(*imu)
