"""Port parity, end to end, BASELINE config 1's path: ``make_gyro_problem``
(gyro rows on an SO3 spline) -> ``Problem`` -> ``make_fused_solver``
('auto' -> dense) in ``kontiki_tpu_torch`` against the JAX package's
``make_fused_solver``, cut to 1 s at 40 Hz with gyro noise so the final
cost is not at roundoff: 5 iterations, the same iteration count, the final
cost to rtol 1e-8 and the final state to 1e-7. The port's generator is
held to the JAX package's on the same seed."""
import numpy as np
import torch

from kontiki_tpu.synthetic import make_so3_trajectory as jax_so3_trajectory
from kontiki_tpu.synthetic import perturb_trajectory as jax_perturb
from kontiki_tpu_torch.synthetic import make_gyro_problem
from test_torch_dense_solve import check_solve_matches_jax

torch.set_num_threads(1)
SMALL = dict(duration=1.0, rate=40.0, seed=1, noise=0.05)


def test_config1_path_matches_jax():
    tgen = make_gyro_problem(**SMALL)
    true = jax_so3_trajectory(2.0, seed=1)
    np.testing.assert_array_equal(tgen["true_trajectory"].knots, true.knots)
    np.testing.assert_array_equal(tgen["trajectory"].knots,
                                  jax_perturb(true, sigma_q=0.05, seed=2).knots)
    check_solve_matches_jax(tgen)
