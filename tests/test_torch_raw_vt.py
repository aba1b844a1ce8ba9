"""``RawProblem(..., vt=...)``, array-level lifted row times, against the
JAX package's ``RawProblem`` on the same numpy-seeded arrays: tangent
offsets, ``state0``, mask (the row times always free) and every count
equal exactly; ``interop`` carries ``vt`` both ways."""
import numpy as np
import pytest

from kontiki_tpu.solver.problem import RawBucket as JRawBucket
from kontiki_tpu.solver.problem import RawProblem as JRawProblem
from kontiki_tpu_torch import interop
from kontiki_tpu_torch.solver.problem import RawBucket, RawProblem

COUNTS = ("num_tangent", "sensor_offset", "landmark_offset", "vt_offset", "num_parameters",
          "num_parameter_blocks", "num_parameters_reduced", "num_parameter_blocks_reduced",
          "num_residuals", "num_residual_blocks", "num_residuals_reduced",
          "num_residual_blocks_reduced")


def _arrays(V, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(12, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    splines = [("r3", rng.normal(size=(12, 3)), 0.0, 0.1), ("so3", q, 0.0, 0.1)]
    S, L, M = 2, 5, 7
    sensors = {"q_ct": np.tile([1.0, 0, 0, 0], (S, 1)), "p_ct": rng.normal(size=(S, 3)),
               "d": np.zeros(S), "abias": np.zeros((S, 3)), "gbias": np.zeros((S, 3)),
               "mask": (rng.uniform(size=(S, 13)) < 0.5).astype(float),
               "d_max": np.full(S, 0.01)}
    data = {"sid": np.zeros(M, np.int64), "lid": rng.integers(0, L, M),
            "vt_idx": np.arange(M) % max(V, 1), "weight": np.ones(M)}
    rho = rng.uniform(0.1, 1.0, L)
    lmask = np.array([1.0, 0.0, 1.0, 1.0, 0.0])
    vt = rng.uniform(size=V) if V else None
    return splines, data, M, sensors, rho, lmask, vt


@pytest.mark.parametrize("V", [0, 7])
def test_raw_problem_vt_matches_jax(V):
    splines, data, M, sensors, rho, lmask, vt = _arrays(V)
    window = {"r3": 4, "so3": 4}
    p = RawProblem(splines, {"rs_lifting": RawBucket("rs_lifting", M, 3, dict(data), window)},
                   sensors, rho, landmark_mask=lmask, vt=vt, device="cpu")
    jp = JRawProblem(splines, {"rs_lifting": JRawBucket("rs_lifting", M, 3, dict(data),
                                                         window)},
                     sensors, rho, landmark_mask=lmask, vt=vt)
    for name in COUNTS:
        assert getattr(p, name) == getattr(jp, name), name
    assert len(p._lifting) == len(jp._lifting) == V
    for k, v in p.state0.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(jp.state0[k]), err_msg=k)
    np.testing.assert_array_equal(p.mask.numpy(), np.asarray(jp.mask))
    assert p.mask[p.vt_offset:].tolist() == [1.0] * V

    # interop: the JAX problem's arrays build the same port problem
    q = interop.raw_problem_from_numpy(**interop.raw_problem_arrays(jp), device="cpu")
    for name in COUNTS:
        assert getattr(q, name) == getattr(p, name), name
    for k, v in p.state0.items():
        np.testing.assert_array_equal(q.state0[k].numpy(), v.numpy(), err_msg=k)
    np.testing.assert_array_equal(q.mask.numpy(), p.mask.numpy())
