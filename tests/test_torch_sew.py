"""``kontiki_tpu_torch.sew`` against ``kontiki_tpu.sew`` on the same
numpy-seeded signals (both numpy: equal to 1e-15 relative, the bisection's
knot spacings exactly), and the JAX package's SEW property oracles
(``tests/test_sew.py``) on the port: the response is a low-pass, slower
signals get larger spacings, higher quality denser knots, the quality holds
at the spacing found, and the predicted variance tracks the residual of an
R3 spline fitted at that spacing through the port's estimator on the
CPU."""
import numpy as np
import pytest
import torch

from kontiki_tpu import sew as jsew
from kontiki_tpu_torch import sew
from kontiki_tpu_torch.estimator import TrajectoryEstimator
from kontiki_tpu_torch.measurements import PositionMeasurement
from kontiki_tpu_torch.trajectories import UniformR3SplineTrajectory

torch.set_num_threads(1)
RTOL = 1e-15


def _signal(freq_hz, rate=200.0, duration=10.0, axes=3, seed=0):
    rng = np.random.default_rng(seed)
    times = np.arange(0, duration, 1.0 / rate)
    phases = rng.uniform(0, 2 * np.pi, axes)
    sig = np.stack([np.sin(2 * np.pi * freq_hz * times + ph) for ph in phases])
    return sig, times


def _noisy(seed=1, n=3000, rate=100.0):
    """A smooth random walk with white noise: a broad spectrum."""
    rng = np.random.default_rng(seed)
    sig = np.cumsum(rng.normal(size=(3, n)), axis=1) * 0.05 + 0.1 * rng.normal(size=(3, n))
    return sig, np.arange(n) / rate


def test_spectral_functions_match_jax():
    w = np.linspace(-300.0, 300.0, 1001)
    for dt in (0.01, 0.1, 0.37):
        np.testing.assert_allclose(sew.bspline_interp_freq_func(w, dt),
                                   jsew.bspline_interp_freq_func(w, dt), rtol=RTOL, atol=0)
        np.testing.assert_allclose(sew.spline_interpolation_response(w / 6.0, dt),
                                   jsew.spline_interpolation_response(w / 6.0, dt),
                                   rtol=RTOL, atol=0)
    sig, times = _noisy()
    X = sew.make_reference_spectrum(sig)
    np.testing.assert_allclose(X, jsew.make_reference_spectrum(sig), rtol=RTOL, atol=0)
    np.testing.assert_allclose(sew.make_reference_spectrum(sig[0]),
                               jsew.make_reference_spectrum(sig[0]), rtol=RTOL, atol=0)
    assert sew.signal_energy(X) == pytest.approx(jsew.signal_energy(X), rel=RTOL)
    freqs = np.fft.fftfreq(len(times), d=times[1] - times[0])
    assert sew.dt_to_variance_spectrum(X, freqs, 0.2) == pytest.approx(
        jsew.dt_to_variance_spectrum(X, freqs, 0.2), rel=RTOL)
    assert sew.quality_to_variance_spectrum(X, 0.95) == pytest.approx(
        jsew.quality_to_variance_spectrum(X, 0.95), rel=RTOL)
    with pytest.raises(ValueError, match="at most 2D"):
        sew.make_reference_spectrum(np.zeros((2, 3, 4)))


def test_bisect_root_matches_jax():
    def f(x):
        return np.cos(x) - x

    got = sew._bisect_root(f, 0.0, 1.0, f(0.0), f(1.0))
    assert got == jsew._bisect_root(f, 0.0, 1.0, f(0.0), f(1.0))
    assert abs(f(got)) < 1e-11


@pytest.mark.parametrize("case", ["noisy 0.99", "noisy 0.9", "sine 0.99", "sine max_dt",
                                  "unreachable", "endpoint"])
def test_knot_spacing_matches_jax(case):
    sig, times = _noisy() if case.startswith("noisy") else _signal(2.0, seed=3)
    kwargs = {"noisy 0.99": dict(quality=0.99), "noisy 0.9": dict(quality=0.9),
              "sine 0.99": dict(quality=0.99), "sine max_dt": dict(quality=0.99, max_dt=0.3),
              "unreachable": dict(quality=1.0 - 1e-14, min_dt=0.05),
              "endpoint": dict(quality=0.0)}[case]
    got = sew.knot_spacing_and_variance(sig, times, **kwargs)
    want = jsew.knot_spacing_and_variance(sig, times, **kwargs)
    assert got[0] == want[0]
    assert got[1] == pytest.approx(want[1], rel=RTOL)
    q = kwargs.pop("quality")
    assert sew.find_uniform_knot_spacing(sig, times, q, **kwargs) == got[0]
    X = sew.make_reference_spectrum(sig)
    assert sew.find_uniform_knot_spacing_spectrum(X, times, q, **kwargs) == got[0]


# ---------------------------------------------------------------------------
# the JAX package's oracles (tests/test_sew.py), on the port
# ---------------------------------------------------------------------------

def test_response_is_lowpass():
    freqs = np.linspace(0.0, 50.0, 200)
    H = sew.spline_interpolation_response(freqs, 0.1)
    assert H[0] == pytest.approx(1.0)
    main = freqs <= 1.0 / 0.1
    assert np.all(np.diff(H[main]) <= 1e-12)
    assert np.all(H[freqs > 1.0 / 0.1] < 0.01)


def test_low_frequency_signal_gets_larger_dt():
    slow, times = _signal(0.5)
    fast, _ = _signal(5.0)
    assert sew.find_uniform_knot_spacing(slow, times, 0.99) > 2 * sew.find_uniform_knot_spacing(
        fast, times, 0.99)


def test_higher_quality_needs_denser_knots():
    sig, times = _signal(2.0)
    assert (sew.find_uniform_knot_spacing(sig, times, 0.999)
            < sew.find_uniform_knot_spacing(sig, times, 0.90))


def test_quality_is_achieved_at_found_dt():
    sig, times = _signal(2.0, seed=3)
    q = 0.99
    Xhat = sew.make_reference_spectrum(sig)
    dt = sew.find_uniform_knot_spacing_spectrum(Xhat, times, q)
    rate = 1.0 / np.mean(np.diff(times))
    freqs = np.fft.fftfreq(len(times), d=1.0 / rate)
    H = sew.spline_interpolation_response(freqs, dt)
    removed = sew.signal_energy((1.0 - H) * Xhat)
    assert removed <= (1 - q) * sew.signal_energy(Xhat) * (1 + 1e-6)


def test_variance_predicts_actual_fit_error():
    """An R3 spline at the SEW spacing fitted to a band-limited signal: its
    mean squared residual within a small factor of the predicted variance."""
    rng = np.random.default_rng(7)
    rate, duration = 100.0, 8.0
    times = np.arange(0, duration, 1.0 / rate)
    sig = np.zeros((3, len(times)))
    for f, amp in [(0.7, 1.0), (1.3, 0.5), (2.1, 0.25)]:
        sig += amp * np.sin(2 * np.pi * f * times[None, :] + rng.uniform(0, 2 * np.pi, (3, 1)))

    dt, var = sew.knot_spacing_and_variance(sig, times, 0.97)
    traj = UniformR3SplineTrajectory(dt, times[0] - 2 * dt, device="cpu")
    for _ in range(4):
        traj.append_knot(np.zeros(3))
    while traj.max_time <= times[-1] + dt:
        traj.append_knot(np.zeros(3))
    est = TrajectoryEstimator(traj, device="cpu")
    for t, p in zip(times, sig.T):
        est.add_measurement(PositionMeasurement(t, p))
    est.solve(max_iterations=30, progress=False)
    resid = np.asarray(traj.position(times)) - sig.T
    actual_var = np.mean(resid**2)
    assert var / 50 < actual_var < 10 * var
