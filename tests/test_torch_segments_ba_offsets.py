"""Segment BA (``parallel.segments_ba``, banded mode, one shard) on a
``Problem`` with the camera's and the IMU's time offsets unlocked, against
the JAX package's ``make_segment_ba_step(problem, mesh of 1 device,
mode="banded")`` on the same objects: the port of
``tests/test_segments_ba.py``'s ``test_unlocked_offsets_match_single_chip``
at one shard.

The problem is that test's: ``make_rsvi_problem(nviews=8, nlandmarks=12,
imu_rate=40.0, seed=23, perturb_rho=0.03, sigma_p=0.01, sigma_q=0.005,
noise_px=0.5, trajectory="split")`` with both offsets free at
``max_time_offset=0.05``, so camera (two-window) and gyro/accel
(one-window) rows all take dynamic window bases and the offset columns
ride the sensor border. One step at lam = 1e-4: the cost, the candidate's
cost and the port's ``total_cost`` to 1e-10 relative of the JAX step's,
the predicted decrease to 1e-8 (a difference of two costs), the candidate
state to 1e-8 absolute; the step moves both offsets."""
import numpy as np
import pytest
import torch

from kontiki_tpu import parallel as jax_parallel
from kontiki_tpu.parallel import segments_ba as jax_sba
from kontiki_tpu_torch.parallel import segments_ba as sba
from kontiki_tpu_torch.synthetic import make_rsvi_problem
from test_torch_split_camera import twin_pair

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pair():
    gen = make_rsvi_problem(nviews=8, nlandmarks=12, imu_rate=40.0, seed=23,
                            perturb_rho=0.03, sigma_p=0.01, sigma_q=0.005, noise_px=0.5,
                            trajectory="split")
    for sensor in (gen["camera"], gen["imu"]):
        sensor.time_offset_locked = False
        sensor.max_time_offset = 0.05
    return twin_pair(gen["trajectory"], gen["measurements"])


def test_unlocked_offsets_match_jax(pair):
    J, T = pair["jax"], pair["torch"]
    live = [T.mask[T.sensor_offset + 13 * s + 6].item() for s in range(len(T.sensors))]
    assert live == [1.0, 1.0]
    assert T.d_max.tolist() == np.asarray(J.d_max).tolist() == [0.05, 0.05]
    jstep, _ = jax_sba.make_segment_ba_step(J, jax_parallel.default_mesh(n_devices=1),
                                            mode="banded")
    step, cost = sba.make_segment_ba_step(T)
    want = jstep(J.state0, 1e-4)
    got = step(T.state0, 1e-4)
    for i, rtol in ((0, 1e-10), (2, 1e-10), (3, 1e-8)):
        np.testing.assert_allclose(got[i].item(), float(want[i]), rtol=rtol, err_msg=str(i))
    assert set(got[1]) == set(want[1])
    for k, v in got[1].items():
        np.testing.assert_allclose(v.numpy(), np.asarray(want[1][k]), rtol=0, atol=1e-8,
                                   err_msg=k)
    # total_cost is the step's cost at state0 (the JAX package's is a
    # second compile of the same residuals; the step's cost is held above)
    np.testing.assert_allclose(cost(T.state0).item(), float(want[0]), rtol=1e-10)
    # the step moves both offsets off their start
    assert torch.all(got[1]["d"] != T.state0["d"])
