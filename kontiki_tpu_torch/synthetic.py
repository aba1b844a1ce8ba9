"""Synthetic problem generators (counterpart of ``kontiki_tpu.synthetic``):
the SE3 rolling-shutter visual-inertial problem of BASELINE config 4.

Random draws come from ``numpy.random.default_rng(seed)`` in the same order
as the JAX package, so both packages build the same problem from one seed.
Trajectory evaluation runs through the port's torch spline kernels on the
CPU in float64; the solver runs wherever ``Problem`` puts the arrays.
"""
import numpy as np
import torch

from .config import host_dtype
from .constants import GRAVITY
from .math import quaternion as quat
from .measurements import (
    AccelerometerMeasurement,
    GyroscopeMeasurement,
    StaticRsCameraMeasurement,
)
from .rotations import axis_angle_to_quat, quat_mult, quat_to_rotation_matrix
from .sensors import BasicImu, PinholeCamera
from .sfm import Landmark, View
from .trajectories import UniformSE3SplineTrajectory


def _smooth_noise(rng, n, dim, scale, smooth=4):
    """Low-pass-filtered white noise [n, dim] — a gentle random signal."""
    x = rng.normal(size=(n + 2 * smooth, dim))
    kernel = np.hanning(2 * smooth + 1)
    kernel /= kernel.sum()
    out = np.stack([np.convolve(x[:, d], kernel, mode="same") for d in range(dim)])
    return scale * out.T[smooth: smooth + n]


def _so3_knots(rng, n, dt, wmag):
    """Unit-quaternion knot sequence integrating a smooth angular velocity."""
    w = _smooth_noise(rng, n, 3, wmag)
    qs = np.empty((n, 4), dtype=host_dtype)
    qs[0] = np.array([1.0, 0, 0, 0])
    for i in range(1, n):
        angle = np.linalg.norm(w[i] * dt)
        axis = w[i] / max(np.linalg.norm(w[i]), 1e-12)
        qs[i] = quat_mult(axis_angle_to_quat(axis, angle), qs[i - 1])
        qs[i] /= np.linalg.norm(qs[i])
    return qs


def make_se3_trajectory(duration, dt=0.1, t0=0.0, seed=0, speed=0.5, wmag=0.4):
    """Smooth random SE3 cumulative spline valid on [t0, t0 + duration)."""
    rng = np.random.default_rng(seed)
    n = int(np.ceil(duration / dt)) + 4
    vel = _smooth_noise(rng, n, 3, speed)
    pos = np.cumsum(vel * dt, axis=0)
    qs = _so3_knots(rng, n, dt, wmag)
    traj = UniformSE3SplineTrajectory(dt, t0)
    for q, p in zip(qs, pos):
        q = np.asarray(q, dtype=np.float64)
        q /= np.linalg.norm(q)
        T = np.eye(4)
        T[:3, :3] = quat_to_rotation_matrix(q)
        T[:3, 3] = p
        traj.append_knot(T)
    return traj


def perturb_trajectory(traj, sigma_p=0.05, sigma_q=0.02, seed=1):
    """Clone with perturbed knots — a realistic optimizer starting point."""
    rng = np.random.default_rng(seed)
    out = traj.clone()
    knots = out.knots.copy()
    for i in range(knots.shape[0]):
        axis = rng.normal(size=3)
        axis /= np.linalg.norm(axis)
        dq = axis_angle_to_quat(axis, rng.normal(scale=sigma_q))
        knots[i, :4] = quat_mult(dq, knots[i, :4])
        knots[i, :4] /= np.linalg.norm(knots[i, :4])
    knots[:, 4:] += rng.normal(scale=sigma_p, size=(knots.shape[0], 3))
    out.set_knots(knots)
    return out


def _body_imu(traj, ts):
    """Batched ideal body-frame gyro/accel samples at times ts."""
    res = traj._eval(np.asarray(ts, dtype=host_dtype))
    q_conj = quat.qconj(torch.from_numpy(res["orientation"]))
    w = torch.from_numpy(res["angular_velocity"])
    a = torch.from_numpy(res["acceleration"])
    g = torch.as_tensor(GRAVITY, dtype=a.dtype)
    return quat.qrotate(q_conj, w).numpy(), quat.qrotate(q_conj, a + g).numpy()


def make_imu_measurements(traj, imu, t1, t2, rate):
    """Noise-free gyro then accel measurements at ``rate`` on [t1, t2)."""
    ts = np.arange(t1, t2, 1.0 / rate)
    w, a = _body_imu(traj, ts)
    ms = [GyroscopeMeasurement(imu, t, wi) for t, wi in zip(ts, w)]
    ms += [AccelerometerMeasurement(imu, t, ai) for t, ai in zip(ts, a)]
    return ms


_DEFAULT_K = np.array([[500.0, 0.0, 320.0], [0.0, 500.0, 240.0], [0.0, 0.0, 1.0]])


def make_camera(readout=0.025, rows=480, cols=640):
    return PinholeCamera(rows, cols, readout, _DEFAULT_K.copy())


def _rs_fixed_point(traj, camera, X_world, t0s, iters=25):
    """Solve t = t0 + v(t)*readout/rows for all (landmark, view) pairs by
    fixed-point iteration. Returns (uv [L,V,2], z [L,V], ok [L,V])."""
    L, V = X_world.shape[0], t0s.shape[0]
    K = torch.from_numpy(camera.camera_matrix)
    q_ct, p_ct = (torch.from_numpy(a) for a in camera.relative_pose)
    X = torch.from_numpy(X_world)[:, None, :]
    t0 = torch.from_numpy(t0s)[None, :]
    ro = camera.readout
    rows = camera.rows

    v = torch.full((L, V), 0.5 * rows, dtype=torch.float64)
    z = torch.ones((L, V), dtype=torch.float64)
    uv = torch.zeros((L, V, 2), dtype=torch.float64)
    for _ in range(iters):
        t = t0 + v * ro / rows
        res = traj._eval(t.numpy().ravel())
        q = torch.from_numpy(res["orientation"]).reshape(L, V, 4)
        p = torch.from_numpy(res["position"]).reshape(L, V, 3)
        X_traj = quat.qrotate(quat.qconj(q), X - p)
        X_cam = quat.qrotate(q_ct, X_traj) + p_ct
        h = X_cam @ K.T
        z = h[..., 2]
        uv = h[..., :2] / torch.where(torch.abs(z) < 1e-12, 1e-12, z)[..., None]
        v = torch.clamp(uv[..., 1], 0.0, rows - 1e-6)
    converged = (torch.abs(uv[..., 1] - v) < 1e-9) & (z > 0.2)
    inside = (
        (uv[..., 0] >= 0) & (uv[..., 0] < camera.cols)
        & (uv[..., 1] >= 0) & (uv[..., 1] < rows)
    )
    return uv.numpy(), z.numpy(), (converged & inside).numpy()


def make_rsvi_problem(
    nviews=10,
    nlandmarks=40,
    fps=30.0,
    imu_rate=0.0,
    knot_dt=0.15,
    seed=0,
    noise_px=0.0,
    sigma_p=0.02,
    sigma_q=0.01,
    perturb_rho=0.0,
    speed=0.3,
    wmag=0.25,
    trajectory="se3",
):
    """Rolling-shutter SfM on an SE3 spline, optionally with IMU (BASELINE
    config 4 is ``nviews=64, nlandmarks=200, imu_rate=200.0, seed=4``).

    Camera rows are ``StaticRsCameraMeasurement`` on a pinhole camera; the
    IMU is a ``BasicImu``."""
    if trajectory != "se3":
        raise ValueError(f"only trajectory='se3' is ported, got {trajectory!r}")
    rng = np.random.default_rng(seed)
    span = (nviews - 1) / fps
    duration = span + 1.5
    true_traj = make_se3_trajectory(
        duration, dt=knot_dt, seed=seed, speed=speed, wmag=wmag
    )
    camera = make_camera()
    t_first = 0.5
    t0s = t_first + np.arange(nviews) / fps
    views = [View(i, t) for i, t in enumerate(t0s)]

    # --- sample landmarks anchored in early views --------------------------
    ref_idx = rng.integers(0, max(1, nviews // 3), size=nlandmarks)
    uv_ref = np.stack(
        [
            rng.uniform(0.05 * camera.cols, 0.95 * camera.cols, nlandmarks),
            rng.uniform(0.05 * camera.rows, 0.95 * camera.rows, nlandmarks),
        ],
        axis=1,
    )
    z_ref = rng.uniform(2.0, 20.0, nlandmarks)

    t_ref = t0s[ref_idx] + uv_ref[:, 1] * camera.readout / camera.rows
    res = true_traj._eval(t_ref)
    q_t = torch.from_numpy(res["orientation"])
    p_t = torch.from_numpy(res["position"])
    yh = np.stack([camera.unproject(uv) for uv in uv_ref])
    X_cam = torch.from_numpy(z_ref[:, None] * yh)
    q_ct, p_ct = (torch.from_numpy(a) for a in camera.relative_pose)
    X_traj = quat.qrotate(quat.qconj(q_ct), X_cam - p_ct)
    X_world = (quat.qrotate(q_t, X_traj) + p_t).numpy()

    uv, z, ok = _rs_fixed_point(true_traj, camera, X_world, t0s)

    landmarks = []
    measurements = []
    for li in range(nlandmarks):
        obs_views = [
            vi for vi in range(nviews) if vi != ref_idx[li] and ok[li, vi]
        ]
        if not obs_views:
            continue
        lm = Landmark()
        lm.inverse_depth = 1.0 / z_ref[li]
        ref_obs = views[ref_idx[li]].create_observation(lm, uv_ref[li])
        lm.reference = ref_obs
        for vi in obs_views:
            y = uv[li, vi]
            if noise_px:
                y = y + rng.normal(scale=noise_px, size=2)
            o = views[vi].create_observation(lm, y)
            measurements.append(StaticRsCameraMeasurement(camera, o))
        if perturb_rho:
            lm.inverse_depth = max(
                lm.inverse_depth * (1.0 + rng.normal(scale=perturb_rho)), 1e-4
            )
        landmarks.append(lm)

    imu = None
    if imu_rate:
        imu = BasicImu()
        measurements += make_imu_measurements(
            true_traj, imu, t_first, t_first + span + camera.readout, imu_rate
        )

    traj = perturb_trajectory(true_traj, sigma_p=sigma_p, sigma_q=sigma_q, seed=seed + 1)
    return dict(
        trajectory=traj,
        true_trajectory=true_traj,
        camera=camera,
        imu=imu,
        views=views,
        landmarks=landmarks,
        measurements=measurements,
    )
