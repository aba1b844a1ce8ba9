"""Synthetic problem generators (counterpart of ``kontiki_tpu.synthetic``):
the gyro-only SO3 fit of BASELINE config 1, the IMU fusion on a split
R3 + SO3 trajectory of config 2 (and a 1,000 s recording of it in
batch containers weighted by SEW, ``make_long_imu_problem``), the
rolling-shutter SfM on a split
trajectory of config 3 (with a pinhole or an atan camera, static or
lifting rows), the SE3 rolling-shutter visual-inertial problem of config 4
and the array-level bundle adjustment of config 5
(``make_big_ba_problem``, a ``RawProblem``), and a long gyro-only band
(``make_gyro_band_problem``, a ``RawProblem``).

Random draws come from ``numpy.random.default_rng(seed)`` in the same order
as the JAX package, so both packages build the same problem from one seed.
Problem generation evaluates trajectories on the host CPU in float64
(``device="cpu"``, as the JAX package's ``_host_generation`` pins it); the
generated trajectories keep the default device (the CUDA card) for their
users' queries, and the solver runs wherever ``Problem`` puts the arrays.
``trajectory_ate`` and ``trajectory_aoe`` score a trajectory against
another, evaluating each on its own device.
"""
import numpy as np
import torch

from .config import default_dtype, host_dtype, resolve_device
from .constants import GRAVITY
from .math import quaternion as quat
from .measurements import (
    AccelerometerMeasurement,
    AccelerometerMeasurements,
    GyroscopeMeasurement,
    GyroscopeMeasurements,
    LiftingRsCameraMeasurement,
    NewtonRsCameraMeasurement,
    OrientationMeasurement,
    PositionMeasurement,
    StaticRsCameraMeasurement,
)
from .rotations import axis_angle_to_quat, quat_conj, quat_mult, quat_to_rotation_matrix
from .sensors import AtanCamera, BasicImu, ConstantBiasImu, PinholeCamera
from .sfm import Landmark, View
from .trajectories import (
    SplitTrajectory,
    UniformSE3SplineTrajectory,
    UniformSO3SplineTrajectory,
)


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


def make_split_trajectory(duration, dt=0.1, t0=0.0, seed=0, speed=0.5, wmag=0.4):
    """Smooth random SplitTrajectory valid on [t0, t0 + duration)."""
    rng = np.random.default_rng(seed)
    n = int(np.ceil(duration / dt)) + 4
    traj = SplitTrajectory(dt, dt, t0, t0)
    vel = _smooth_noise(rng, n, 3, speed)
    for p in np.cumsum(vel * dt, axis=0):
        traj.R3_spline.append_knot(p)
    for q in _so3_knots(rng, n, dt, wmag):
        traj.SO3_spline.append_knot(q)
    return traj


def make_so3_trajectory(duration, dt=0.1, t0=0.0, seed=0, wmag=0.4):
    """Smooth random SO3 spline valid on [t0, t0 + duration)."""
    rng = np.random.default_rng(seed)
    n = int(np.ceil(duration / dt)) + 4
    traj = UniformSO3SplineTrajectory(dt, t0)
    for q in _so3_knots(rng, n, dt, wmag):
        traj.append_knot(q)
    return traj


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


def _perturb_rotations(rng, qs, sigma_q):
    """Left-multiply each wxyz row of ``qs`` (in place) by a random rotation."""
    for i in range(qs.shape[0]):
        axis = rng.normal(size=3)
        axis /= np.linalg.norm(axis)
        dq = axis_angle_to_quat(axis, rng.normal(scale=sigma_q))
        qs[i] = quat_mult(dq, qs[i])
        qs[i] /= np.linalg.norm(qs[i])


def perturb_trajectory(traj, sigma_p=0.05, sigma_q=0.02, seed=1):
    """Clone with perturbed knots — a realistic optimizer starting point.
    R3 knots move additively, SO3 and SE3 rotations by a left increment."""
    rng = np.random.default_rng(seed)
    out = traj.clone()
    splines = [out.R3_spline, out.SO3_spline] if isinstance(out, SplitTrajectory) else [out]
    for sp in splines:
        knots = sp.knots.copy()
        if knots.shape[1] == 3:
            knots = knots + rng.normal(scale=sigma_p, size=knots.shape)
        elif knots.shape[1] == 4:
            _perturb_rotations(rng, knots, sigma_q)
        else:  # packed SE3 (q wxyz, t)
            _perturb_rotations(rng, knots[:, :4], sigma_q)  # in place on the view
            knots[:, 4:] += rng.normal(scale=sigma_p, size=(knots.shape[0], 3))
        sp.set_knots(knots)
    return out


def _body_imu(traj, ts):
    """Batched ideal body-frame gyro/accel samples at times ts."""
    res = traj._eval(np.asarray(ts, dtype=host_dtype), device="cpu")
    q_conj = quat.qconj(torch.from_numpy(res["orientation"]))
    w = torch.from_numpy(res["angular_velocity"])
    a = torch.from_numpy(res["acceleration"])
    g = torch.as_tensor(GRAVITY, dtype=a.dtype)
    return quat.qrotate(q_conj, w).numpy(), quat.qrotate(q_conj, a + g).numpy()


def make_imu_measurements(traj, imu, t1, t2, rate, noise=0.0, seed=0, gyro=True,
                          accel=True):
    """Gyro then accel measurements at ``rate`` on [t1, t2), with the IMU's
    constant biases added and optional white noise of std ``noise``."""
    rng = np.random.default_rng(seed)
    ts = np.arange(t1, t2, 1.0 / rate)
    w, a = _body_imu(traj, ts)
    gb = getattr(imu, "gyroscope_bias", np.zeros(3))
    ab = getattr(imu, "accelerometer_bias", np.zeros(3))
    if noise:
        w = w + rng.normal(scale=noise, size=w.shape)
        a = a + rng.normal(scale=noise, size=a.shape)
    ms = []
    if gyro:
        ms += [GyroscopeMeasurement(imu, t, wi + gb) for t, wi in zip(ts, w)]
    if accel:
        ms += [AccelerometerMeasurement(imu, t, ai + ab) for t, ai in zip(ts, a)]
    return ms


def make_pose_measurements(traj, t1, t2, rate, noise_p=0.0, noise_q=0.0, seed=0):
    """Position then orientation measurements of ``traj`` at ``rate`` on
    [t1, t2) (motion-capture style), with white position noise of std
    ``noise_p`` and a left rotation by a random rotation vector of std
    ``noise_q`` (radians, per axis) on each orientation."""
    rng = np.random.default_rng(seed)
    ts = np.arange(t1, t2, 1.0 / rate)
    res = traj._eval(ts, device="cpu")
    p = res["position"] + rng.normal(scale=noise_p, size=(len(ts), 3))
    r = rng.normal(scale=noise_q, size=(len(ts), 3))
    theta = np.linalg.norm(r, axis=1, keepdims=True)
    axis = r / np.where(theta > 0, theta, 1.0)
    dq = np.concatenate([np.cos(theta / 2), np.sin(theta / 2) * axis], axis=1)
    q = _qmul_rows(dq, res["orientation"])
    return ([PositionMeasurement(t, pi) for t, pi in zip(ts, p)]
            + [OrientationMeasurement(t, qi) for t, qi in zip(ts, q)])


def make_gyro_problem(duration=5.0, rate=200.0, knot_dt=0.1, seed=0, noise=0.0,
                      sigma_q=0.05):
    """BASELINE config 1: gyro-only SO3 spline fit."""
    true_traj = make_so3_trajectory(duration + 1.0, dt=knot_dt, seed=seed)
    imu = BasicImu()
    ms = make_imu_measurements(
        true_traj, imu, 0.5, 0.5 + duration, rate, noise=noise, seed=seed, accel=False
    )
    traj = perturb_trajectory(true_traj, sigma_q=sigma_q, seed=seed + 1)
    return dict(trajectory=traj, true_trajectory=true_traj, imu=imu, measurements=ms)


def _bias_imu(seed):
    """Config 2's IMU: constant biases drawn from ``seed + 7``, unlocked."""
    rng = np.random.default_rng(seed + 7)
    imu = ConstantBiasImu(rng.normal(scale=0.05, size=3), rng.normal(scale=0.01, size=3))
    imu.accelerometer_bias_locked = False
    imu.gyroscope_bias_locked = False
    return imu


def make_imu_problem(duration=5.0, rate=200.0, knot_dt=0.1, seed=0, noise=0.0,
                     bias=True, sigma_p=0.05, sigma_q=0.02, position_rate=0.0):
    """BASELINE config 2: gyro + accel fusion on a split trajectory, with
    unlocked constant biases when ``bias``. ``position_rate > 0`` adds
    position rows at that rate on the same span: gyro and accel alone leave
    the global position and a constant velocity unobservable, so a fit
    scored against the truth needs the anchor."""
    true_traj = make_split_trajectory(duration + 1.0, dt=knot_dt, seed=seed)
    imu = _bias_imu(seed) if bias else BasicImu()
    ms = make_imu_measurements(
        true_traj, imu, 0.5, 0.5 + duration, rate, noise=noise, seed=seed
    )
    if position_rate:
        ts = np.arange(0.5, 0.5 + duration, 1.0 / position_rate)
        ps = true_traj._eval(ts, device="cpu")["position"]
        ms += [PositionMeasurement(t, p) for t, p in zip(ts, ps)]
    traj = perturb_trajectory(true_traj, sigma_p=sigma_p, sigma_q=sigma_q, seed=seed + 1)
    return dict(trajectory=traj, true_trajectory=true_traj, imu=imu, measurements=ms)


def make_long_imu_problem(duration=1000.0, rate=200.0, knot_dt=0.1, seed=2, quality=0.99,
                          sigma_p=0.05, sigma_q=0.02):
    """A long IMU recording through the reference's workflow: ideal gyro and
    accel samples at ``rate`` Hz on [0.5, 0.5 + duration) of
    ``make_split_trajectory(duration + 1.0, knot_dt, seed)``, with config
    2's constant biases (``make_imu_problem``'s draws, both unlocked) added;
    SEW (``sew.knot_spacing_and_variance`` at ``quality``) picks each
    signal's spacing and fit-error variance, and the weights ``1 /
    sqrt(variance)`` go into one ``GyroscopeMeasurements`` and one
    ``AccelerometerMeasurements``. The start is the truth perturbed as in
    config 2. The trajectory keeps its knot grid (SEW's spacings are
    returned, not applied), so the banded strategy takes it. At the default
    1,000 s: 10,014 knots per spline, 200,000 rows of each kind."""
    from . import sew

    true_traj = make_split_trajectory(duration + 1.0, dt=knot_dt, seed=seed)
    imu = _bias_imu(seed)
    ts = np.arange(0.5, 0.5 + duration, 1.0 / rate)
    w, a = _body_imu(true_traj, ts)
    w = w + imu.gyroscope_bias
    a = a + imu.accelerometer_bias
    spacing = {"gyro": sew.knot_spacing_and_variance(w.T, ts, quality),
               "accel": sew.knot_spacing_and_variance(a.T, ts, quality)}
    ms = [GyroscopeMeasurements(imu, ts, w, weight=1.0 / np.sqrt(spacing["gyro"][1])),
          AccelerometerMeasurements(imu, ts, a, weight=1.0 / np.sqrt(spacing["accel"][1]))]
    traj = perturb_trajectory(true_traj, sigma_p=sigma_p, sigma_q=sigma_q, seed=seed + 1)
    return dict(trajectory=traj, true_trajectory=true_traj, imu=imu, measurements=ms,
                sew=spacing)


_DEFAULT_K = np.array([[500.0, 0.0, 320.0], [0.0, 500.0, 240.0], [0.0, 0.0, 1.0]])


def make_camera(kind="pinhole", readout=0.025, rows=480, cols=640):
    """The generators' camera: pinhole, or ``kind="atan"`` with the
    distortion centre at the image centre (normalised) and gamma 0.9."""
    if kind == "atan":
        return AtanCamera(
            rows, cols, readout, _DEFAULT_K.copy(),
            wc=np.array([0.5 * cols, 0.5 * rows]) @ np.linalg.inv(_DEFAULT_K[:2, :2]).T,
            gamma=0.9,
        )
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
        res = traj._eval(t.numpy().ravel(), device="cpu")
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
    camera_kind="pinhole",
    rs="static",
    noise_px=0.0,
    sigma_p=0.02,
    sigma_q=0.01,
    perturb_rho=0.0,
    speed=0.3,
    wmag=0.25,
    trajectory="split",
):
    """Rolling-shutter SfM, optionally with IMU, on a split R3 + SO3
    trajectory (``trajectory="split"``) or a cumulative SE3 spline
    (``"se3"``). BASELINE config 3 is ``nviews=32, nlandmarks=200,
    imu_rate=0.0, seed=3`` (split); config 4 is ``nviews=64, nlandmarks=200,
    imu_rate=200.0, seed=4, trajectory="se3"``.

    ``camera_kind`` ('pinhole' | 'atan') selects the camera (``make_camera``)
    and ``rs`` the camera rows: 'static' (``StaticRsCameraMeasurement``),
    'newton' (``NewtonRsCameraMeasurement``; config 4-Newton is config 4's
    arguments with ``rs="newton", trajectory="split"``) or 'lifting'
    (``LiftingRsCameraMeasurement``). The observations are the pinhole
    projections in every case, as in the JAX package. The IMU is a
    ``BasicImu``."""
    if trajectory not in ("split", "se3"):
        raise ValueError(f"trajectory must be 'split' or 'se3', got {trajectory!r}")
    mcls = {"static": StaticRsCameraMeasurement, "newton": NewtonRsCameraMeasurement,
            "lifting": LiftingRsCameraMeasurement}.get(rs)
    if mcls is None:
        raise ValueError(f"rs must be 'static', 'lifting' or 'newton', got {rs!r}")
    rng = np.random.default_rng(seed)
    span = (nviews - 1) / fps
    duration = span + 1.5
    make = make_se3_trajectory if trajectory == "se3" else make_split_trajectory
    true_traj = make(duration, dt=knot_dt, seed=seed, speed=speed, wmag=wmag)
    camera = make_camera(camera_kind)
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
    res = true_traj._eval(t_ref, device="cpu")
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
            measurements.append(mcls(camera, o))
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


def make_big_ba_problem(
    n_views=1000,
    n_landmarks=10_000,
    obs_per_landmark=5,
    fps=30.0,
    knot_dt=0.1,
    imu_rate=0.0,
    seed=0,
    readout=0.02,
    rows=480,
    cols=640,
    sigma_p=0.01,
    sigma_q=0.005,
    perturb_rho=0.05,
    noise_px=0.0,
    device=None,
    dtype=default_dtype,
):
    """BASELINE config 5 at scale: array-level rolling-shutter BA on a split
    R3 + SO3 trajectory, built as a ``solver.problem.RawProblem`` on
    ``device`` (None: the CUDA card) in ``dtype`` without per-observation
    objects. The draws and the row-time fixed point run in float64 whatever
    ``dtype`` is, so a float32 problem holds the float64 one's arrays
    rounded once.

    Each landmark is observed in its reference view and the
    ``obs_per_landmark`` frames after it; the rolling-shutter row time of
    every (landmark, view) pair is solved by 25 fixed-point steps on the CPU,
    so observations are exactly self-consistent (weight 0 where the point
    is behind the camera, out of the image or unconverged). ``imu_rate``
    adds ideal gyro and accel rows from a second sensor. The numpy draws
    are the JAX package's, in its order (uv, z, pixel noise, knot noise,
    axis, angle, rho), so one seed gives both packages the same arrays.

    Returns a dict with ``problem``, ``true_trajectory``, ``trajectory``
    (the perturbed start), the span ``t1``/``t2`` and ``n_obs``."""
    from .sensors import PinholeCamera
    from .solver.problem import RawBucket, RawProblem

    device = resolve_device(device)  # raise before generating for want of a card
    rng = np.random.default_rng(seed)
    span = (n_views - 1) / fps
    true_traj = make_split_trajectory(span + 1.5, dt=knot_dt, seed=seed, speed=0.3, wmag=0.2)
    t_first = 0.5
    t0s = t_first + np.arange(n_views) / fps

    K = np.array([[500.0, 0.0, 0.5 * cols], [0.0, 500.0, 0.5 * rows], [0.0, 0.0, 1.0]])
    Kinv = np.linalg.inv(K)

    L, k = n_landmarks, obs_per_landmark
    ref_idx = (np.arange(L) * max(n_views - k - 1, 1) // max(L, 1)).astype(np.int64)
    ref_idx = np.minimum(ref_idx, n_views - k - 1)
    uv_ref = np.stack(
        [rng.uniform(0.05 * cols, 0.95 * cols, L), rng.uniform(0.05 * rows, 0.95 * rows, L)],
        axis=1,
    )
    z_ref = rng.uniform(2.0, 20.0, L)
    yh_ref = np.concatenate([uv_ref, np.ones((L, 1))], axis=1) @ Kinv.T

    # world points through the (identity-relative-pose) camera at the exact
    # rolling-shutter reference row time
    res = true_traj._eval_t(t0s[ref_idx] + uv_ref[:, 1] * readout / rows, device="cpu")
    X_world = quat.qrotate(res["orientation"], torch.from_numpy(z_ref[:, None] * yh_ref)) \
        + res["position"]

    # observation views: the k frames after the reference; the row-time
    # fixed point over all (landmark, view) pairs
    t0_obs = t0s[ref_idx[:, None] + 1 + np.arange(k)[None, :]]  # [L, k]
    Kt = torch.from_numpy(K)
    Xw = X_world[:, None, :]
    v = torch.full((L, k), 0.5 * rows, dtype=torch.float64)
    for _ in range(25):
        t = torch.from_numpy(t0_obs) + v * readout / rows
        r = true_traj._eval_t(t.reshape(-1).numpy(), device="cpu")
        q = r["orientation"].reshape(L, k, 4)
        p = r["position"].reshape(L, k, 3)
        h = quat.qrotate(quat.qconj(q), Xw - p) @ Kt.T
        z = h[..., 2]
        uv = h[..., :2] / torch.where(torch.abs(z) < 1e-12, 1e-12, z)[..., None]
        v = torch.clamp(uv[..., 1], 0.0, rows - 1e-6)
    ok = (torch.abs(uv[..., 1] - v) < 1e-8) & (z > 0.2)
    ok = (ok & (uv[..., 0] >= 0) & (uv[..., 0] < cols)).numpy()
    uv = uv.numpy()

    M = L * k
    uv_obs = uv.reshape(M, 2)
    if noise_px:
        uv_obs = uv_obs + rng.normal(scale=noise_px, size=(M, 2))
    cam_data = {
        "sid": np.zeros(M, dtype=np.int64),
        "lid": np.repeat(np.arange(L, dtype=np.int64), k),
        "uv_obs": uv_obs,
        "v_obs": uv_obs[:, 1],
        "t0_obs": t0_obs.reshape(M),
        "t0_ref": np.repeat(t0s[ref_idx], k),
        "v_ref": np.repeat(uv_ref[:, 1], k),
        "yh_ref": np.repeat(yh_ref, k, axis=0),
        "readout": np.full(M, readout),
        "rows": np.full(M, float(rows)),
        "K": np.broadcast_to(K, (M, 3, 3)),
        "weight": ok.reshape(M).astype(np.float64),
        "huber_c": np.full(M, 5.0),
    }
    r3, so3 = true_traj.R3_spline, true_traj.SO3_spline
    W_cam = 4 + int(np.ceil(readout / knot_dt)) + 1
    buckets = {
        "rs_static:PinholeCamera": RawBucket(
            kind="rs_static:PinholeCamera", M=M, rdim=2, data=cam_data,
            window={"r3": W_cam, "so3": W_cam}, camera_cls=PinholeCamera,
        )
    }
    n_sensors = 1
    if imu_rate:
        ts = np.arange(t_first, t_first + span + readout, 1.0 / imu_rate)
        w_b, a_b = _body_imu(true_traj, ts)
        for key, y in (("gyro", w_b), ("accel", a_b)):
            data = {"t": ts, "y": y, "weight": np.ones(len(ts)),
                    "sid": np.ones(len(ts), dtype=np.int64)}
            buckets[key] = RawBucket(kind=key, M=len(ts), rdim=3, data=data,
                                     window={"r3": 4, "so3": 4})
        n_sensors = 2

    # perturbed initial state
    traj = true_traj.clone()
    knots_p = r3.knots + rng.normal(scale=sigma_p, size=(len(r3), 3))
    axis = rng.normal(size=(len(so3), 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    ang = rng.normal(scale=sigma_q, size=(len(so3), 1))
    dq = np.concatenate([np.cos(ang / 2), np.sin(ang / 2) * axis], axis=1)
    knots_q = quat.qmul(torch.from_numpy(dq), torch.from_numpy(so3.knots)).numpy()
    knots_q /= np.linalg.norm(knots_q, axis=1, keepdims=True)
    traj.R3_spline.set_knots(knots_p)
    traj.SO3_spline.set_knots(knots_q)

    rho0 = 1.0 / z_ref
    if perturb_rho:
        rho0 = np.maximum(rho0 * (1.0 + rng.normal(scale=perturb_rho, size=L)), 1e-4)

    S = n_sensors
    sensors = {
        "q_ct": np.tile(np.array([1.0, 0, 0, 0]), (S, 1)),
        "p_ct": np.zeros((S, 3)),
        "d": np.zeros(S),
        "abias": np.zeros((S, 3)),
        "gbias": np.zeros((S, 3)),
        "mask": np.zeros((S, 13)),
        "d_max": np.zeros(S),
    }
    problem = RawProblem(
        splines=[("r3", knots_p, r3.t0, r3.dt), ("so3", knots_q, so3.t0, so3.dt)],
        buckets=buckets, sensors=sensors, rho=rho0, device=device, dtype=dtype,
    )
    return dict(problem=problem, true_trajectory=true_traj, trajectory=traj,
                t1=float(t0s[0]), t2=float(t0s[-1]), n_obs=M)


def make_gyro_band_problem(n_knots=10_050, dt=0.1, rate=20.0, seed=3, perturb_seed=1,
                           device=None, dtype=default_dtype):
    """A long gyro-only SO3 fit as a ``RawProblem`` (the JAX package's
    ``tests/test_banded.py`` 10k-knot problem): ``n_knots`` knots of
    ``make_so3_trajectory(duration, dt, seed, wmag=0.3)``, ideal gyro rows
    at ``rate`` Hz on [0.5, duration - 0.5), the knots perturbed by 1e-3
    (``perturb_seed``) and renormalized, one locked ``BasicImu``, on
    ``device`` (None: the CUDA card) in ``dtype``. At 10,050
    knots its dense normal equations would take ~7 GB; the banded strategy
    solves it in O(n)."""
    from .solver.problem import RawBucket, RawProblem

    device = resolve_device(device)
    duration = (n_knots - 4) * dt
    traj = make_so3_trajectory(duration, dt=dt, seed=seed, wmag=0.3)
    ts = np.arange(0.5, duration - 0.5, 1.0 / rate)
    w, _ = _body_imu(traj, ts)
    data = {"t": ts, "y": w, "weight": np.ones(len(ts)), "sid": np.zeros(len(ts), np.int64)}
    knots = np.asarray(traj.knots)
    pert = knots + np.random.default_rng(perturb_seed).normal(scale=1e-3, size=knots.shape)
    pert /= np.linalg.norm(pert, axis=1, keepdims=True)
    sensors = {"q_ct": np.tile([1.0, 0, 0, 0], (1, 1)), "p_ct": np.zeros((1, 3)),
               "d": np.zeros(1), "abias": np.zeros((1, 3)), "gbias": np.zeros((1, 3)),
               "mask": np.zeros((1, 13)), "d_max": np.zeros(1)}
    return RawProblem(
        splines=[("so3", pert, traj.t0, dt)],
        buckets={"gyro": RawBucket(kind="gyro", M=len(ts), rdim=3, data=data,
                                   window={"so3": 4})},
        sensors=sensors, rho=np.zeros(0), device=device, dtype=dtype)


def newton_edge_rows(ins, n=2):
    """Newton rows at the edges of their Newton path, for the checks of
    kernel B8: a copy of B8's inputs ``ins`` (a dict of [k, M] tensors,
    ``ops.linearize_kernels.newton_inputs``) in which the camera's
    principal row (``K[5]``) moves two image heights, lower for rows 0 ..
    n - 1 and higher for rows n .. 2n - 1, so that the point projects above
    or below the image: every update clamps the row time at 0 or at the
    readout and the loop runs its five steps. Where the knots of the (SE3
    or R3) spline lie closer than two thirds of the readout, rows 2n .. 3n
    - 1 also start their row time 1.5 knot spacings away, so that their
    steps cross a knot and move the window's sub-window."""
    out = {k: v.clone() for k, v in ins.items()}
    rows, readout, v = ins["rows"][0], ins["readout"][0], ins["v_obs"][0]
    down, up = slice(0, n), slice(n, 2 * n)
    out["K"][5, down] -= 2 * rows[down]
    out["K"][5, up] += 2 * rows[up]
    dt = ins["dts"][0]
    far = slice(2 * n, 3 * n)
    shift = 1.5 * dt[far] * rows[far] / readout[far]
    near = 1.5 * dt[far] < readout[far]
    moved = torch.where(v[far] + shift <= rows[far], v[far] + shift, v[far] - shift)
    out["v_obs"][0, far] = torch.where(near, moved, v[far])
    return out


def trajectory_ate(traj_a, traj_b, t1, t2, n=200, align=False):
    """RMS position error between two trajectories on [t1, t2), at ``n``
    evenly spaced times.

    ``align`` removes the estimation gauge first (the standard ATE
    convention): ``"se3"``/True removes the best rotation + translation
    (visual-inertial: global translation and yaw are unobservable);
    ``"sim3"`` additionally removes scale (pure visual estimation with
    inverse-depth landmarks leaves scale free)."""
    ts = np.linspace(t1, t2, n, endpoint=False)
    pa = traj_a._eval(ts)["position"]
    pb = traj_b._eval(ts)["position"]
    if align:
        ca, cb = pa.mean(axis=0), pb.mean(axis=0)
        A, B = pa - ca, pb - cb
        U, S, Vt = np.linalg.svd(B.T @ A)
        d = np.sign(np.linalg.det(U @ Vt))
        D = np.diag([1.0, 1.0, d])
        R = U @ D @ Vt
        s = 1.0
        if align == "sim3":
            varA = np.sum(A * A)
            s = np.sum(np.diag(D) * S) / np.where(varA == 0, 1.0, varA)
        pa = s * (R @ A.T).T
        pb = B
    return float(np.sqrt(np.mean(np.sum((pa - pb) ** 2, axis=-1))))


def _qmul_rows(a, b):
    """Hamilton products of [n, 4] wxyz rows."""
    w1, x1, y1, z1 = a.T
    w2, x2, y2, z2 = b.T
    return np.stack([w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
                     w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                     w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                     w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2], axis=1)


def trajectory_aoe(traj_a, traj_b, t1, t2, n=200, align=True):
    """RMS orientation error (radians) between two trajectories on
    [t1, t2).

    With ``align=True`` the best-fit constant left rotation is removed
    first (Markley quaternion average of q_b q_a^-1): gyro-only estimation
    determines orientation only up to a global rotation."""
    ts = np.linspace(t1, t2, n, endpoint=False)
    qa = traj_a._eval(ts)["orientation"]
    qb = traj_b._eval(ts)["orientation"]
    qe = _qmul_rows(qb, qa * np.array([1.0, -1.0, -1.0, -1.0]))
    if align:
        qe_s = np.where(qe[:, :1] < 0, -qe, qe)
        w, V = np.linalg.eigh(qe_s.T @ qe_s)
        q_off = V[:, -1]
        qe = _qmul_rows(np.broadcast_to(quat_conj(q_off), qe.shape), qe)
    vn = np.linalg.norm(qe[:, 1:], axis=1)
    ang = 2.0 * np.arctan2(vn, np.abs(qe[:, 0]))
    return float(np.sqrt(np.mean(ang**2)))
