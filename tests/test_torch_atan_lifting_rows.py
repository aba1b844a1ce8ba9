"""Port parity, camera rows of the atan camera and lifting rows on the split
R3 + SO3 trajectory (config 3-atan-lifting's model) and on the cumulative
SE3 spline (config 4's): the gather stage, the plain versions of kernels B1
(``linearize_rows``) and B3 (``cost_rows``) and the bucket terms' column
ids against ``kontiki_tpu`` on the same inputs, in float64.

The problem is the JAX package's own small one
(``tests/test_linearize_kernel.py``: ``make_rsvi_problem(nviews=6,
nlandmarks=9, imu_rate=0.0, seed=41, perturb_rho=0.1)`` with the camera's
pose and time offset free, bound 0.01) with an atan camera and lifting
rows. The branches without the atan or the lifting inputs run on the same
rows with those inputs dropped, on both sides, so each window kind's four
branches see the same windows. The JAX side runs its fused tile eagerly
(``backend="xla"``), as the port's other row tests do, once per camera on
lifting rows: a static row's B1 is the lifting row's without the third
residual and the vt column (the tile computes those two rows and 61
columns with the same operations), so the static branches are held to
that slice; B3 runs on every branch on both sides. Both window kinds share
this file so that they share the JAX package's eager warm-up.

Tolerance: |port - jax| <= 1e-10 * max|jax| per output (the same formulas
in another order; the JAX tile's arctangent is a Newton iteration)."""
import functools

import numpy as np
import pytest
import torch

from kontiki_tpu.ops import linearize_kernels as jlk
from kontiki_tpu.solver import kernels as jk
from kontiki_tpu_torch.ops import linearize_kernels as tlk
from kontiki_tpu_torch.solver import kernels as tk
from kontiki_tpu_torch.synthetic import make_rsvi_problem
from test_torch_camera_host import _assert_close as _assert_host_close
from test_torch_camera_host import host_library  # noqa: F401
from test_torch_split_camera import twin_pair

torch.set_num_threads(1)
RTOL = 1e-10
BRANCHES = {  # (camera, lifting) per branch name
    "atan static": ("AtanCamera", False),
    "atan lifting": ("AtanCamera", True),
    "pinhole static": ("PinholeCamera", False),
    "pinhole lifting": ("PinholeCamera", True),
}


def _close(got, want, name):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, name
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * np.abs(want).max(),
                               err_msg=name)


@functools.lru_cache(maxsize=None)
def atan_lifting_pair(trajectory, rs="lifting", camera_kind="atan"):
    """Both packages' problems over the JAX tests' small rolling-shutter
    problem, camera pose and time offset free."""
    gen = make_rsvi_problem(nviews=6, nlandmarks=9, imu_rate=0.0, seed=41, perturb_rho=0.1,
                            camera_kind=camera_kind, rs=rs, trajectory=trajectory)
    cam = gen["camera"]
    cam.relative_orientation_locked = False
    cam.relative_position_locked = False
    cam.max_time_offset = 0.01
    cam.time_offset_locked = False
    return twin_pair(gen["trajectory"], gen["measurements"])


@functools.lru_cache(maxsize=None)
def branch_rows(trajectory):
    """Per branch: the JAX package's and the port's (cfg, ins) on the
    atan lifting problem's rows, without the inputs the branch lacks."""
    pair = atan_lifting_pair(trajectory)
    spec, jrt, J = pair["jspec"], pair["jrt"], pair["jax"]
    ins, cfg, _, _ = jk._fused_camera_inputs(spec, spec.buckets[0], jrt, J.state0,
                                             jrt["data"][0])
    tcfg, tins, _ = tk._camera_inputs(pair["tspec"], pair["rt"], pair["state"],
                                      pair["rt"]["data"][0])
    out = {}
    for name, (camera, lifting) in BRANCHES.items():
        c = dict(cfg, camera=camera, lifting=lifting, rdim=2 + lifting, C=61 + lifting)
        tc = dict(tcfg, camera=camera, lifting=lifting, rdim=2 + lifting, C=61 + lifting)
        names = {s[0] for s in tlk.camera_inputs(tc) if s is not None}
        out[name] = (c, {k: v for k, v in ins.items() if k in names},
                     tc, {k: v for k, v in tins.items() if k in names})
    return pair, cfg, ins, tcfg, tins, out


@functools.lru_cache(maxsize=None)
def jax_cost(trajectory, branch):
    """The JAX package's B3 (its tile, eagerly) on one branch's rows."""
    cfg, ins, _, _ = branch_rows(trajectory)[5][branch]
    return np.asarray(jlk.cost_rows(cfg, ins, backend="xla"))


@pytest.fixture(scope="module", params=["split", "se3"])
def rows(request):
    return request.param, branch_rows(request.param)


def check_camera(kind, branches, camera):
    """B1 and B3 plain on one camera's static and lifting branches against
    the JAX package's tile (B1 static: the lifting tile's slice)."""
    cfg, ins, tcfg, tins = branches[f"{camera} lifting"]
    want = [np.asarray(a) for a in jlk.linearize_rows(cfg, ins, backend="xla")]
    for rows in ("lifting", "static"):
        cfg, ins, tcfg, tins = branches[f"{camera} {rows}"]
        got = tlk.linearize_rows_plain(tcfg, tins)
        rdim, C = tlk.camera_shape(tcfg)
        assert got[1].shape == (tins["u_ref"].shape[1], rdim, C)
        sliced = (want[0][:, :rdim], want[1][:, :rdim, :C], want[2][:, :rdim])
        for name, g, w in zip(("r", "J", "J_rho"), got, sliced):
            _close(g.numpy(), w, f"{rows} {name}")
        _close(tlk.cost_rows_plain(tcfg, tins).numpy(), jax_cost(kind, f"{camera} {rows}"),
               f"{rows} B3 r")


def test_gather_matches_jax(rows):
    """The port's gather equals the JAX package's: the cfg, every input
    (the obs windows at the lifted row times), and the branch inputs."""
    kind, (pair, cfg, ins, tcfg, tins, _) = rows
    assert tcfg == cfg == dict(kind=kind, r3_first=kind == "split", camera="AtanCamera",
                               lifting=True, rdim=3, C=62)
    assert sorted(tins) == sorted(ins)
    for k in ("wc", "gamma", "vt0", "vt_orig", "rows", "readout"):
        assert k in tins
    for k, v in tins.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(ins[k]), err_msg=k)


@pytest.mark.parametrize("camera", ["atan", "pinhole"])
def test_plain_rows_match_jax(rows, camera):
    check_camera(rows[0], rows[1][5], camera)


@pytest.mark.parametrize("camera", ["atan", "pinhole"])
def test_b3_host_schedules_match_jax(host_library, rows, camera):
    """B3's CUDA row code built for the host (``cost_rows_host``) in both
    its kernels' schedules, on one camera's static and lifting branches:
    against the JAX package's tile (RTOL) and the plain version (1e-12,
    ``test_torch_camera_host.py``'s gate)."""
    kind, branches = rows[0], rows[1][5]
    for rs in ("static", "lifting"):
        _, _, tcfg, tins = branches[f"{camera} {rs}"]
        want = jax_cost(kind, f"{camera} {rs}")
        plain = tlk.cost_rows_plain(tcfg, tins)
        for lanes in (False, True):
            got = tlk.cost_rows_host(tcfg, tins, lanes=lanes)
            _close(got.numpy(), want, f"{rs} lanes={lanes}")
            _assert_host_close([got], [plain])


def test_lifting_columns_match_jax(rows):
    """The bucket terms' column ids end in the vt column ``vt_offset +
    vt_idx``, as the JAX package's fused camera rows do."""
    pair = rows[1][0]
    spec, jrt, J = pair["jspec"], pair["jrt"], pair["jax"]
    tspec = pair["tspec"]
    r, Jt, cols, J_rho = tk.bucket_terms(tspec, tspec.buckets[0], pair["rt"], pair["state"],
                                         pair["rt"]["data"][0])
    assert cols.shape == (r.shape[0], 62) and Jt.shape == (r.shape[0], 3, 62)
    vt_idx = pair["rt"]["data"][0]["vt_idx"]
    np.testing.assert_array_equal(cols[:, -1].numpy(), (tspec.vt_offset + vt_idx).numpy())
    assert tspec.vt_offset == J.vt_offset == tspec.landmark_offset + tspec.num_landmarks
    # the same ids as the JAX package's column construction
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jlk, "linearize_rows", lambda cfg, ins, backend: (None, None, None))
        want = jk._camera_rows_fused(spec, spec.buckets[0], jrt, J.state0, jrt["data"][0],
                                     True)[2]
    np.testing.assert_array_equal(cols.numpy(), np.asarray(want))
