"""Spline Error Weighting (SEW): automatic knot spacing and fit-error
variance (counterpart of ``kontiki_tpu.sew``).

Implements Ovrén & Forssén, "Spline Error Weighting for Robust
Visual-Inertial Fusion" (CVPR 2018), as the reference package's ``sew.py``
provides it: given an IMU signal, pick the largest uniform knot spacing
``dt`` such that a cubic B-spline fit retains a requested fraction
("quality") of the signal's (DC-removed) energy, and predict the variance
of the resulting spline approximation error, used to weight measurements in
the estimator.

The cubic B-spline interpolation frequency response follows Mihajlovic,
Goluban & Zagar, "Frequency Domain Analysis of B-Spline Interpolation"
(ISIE 1999):

    H(w; dt) ∝ dt * 3 sinc(w dt / 2π)^4 / (2 + cos(w dt)),  normalized so
    H(0) = 1.

This is host-side signal analysis on a spectrum, in numpy: the signals
arrive as host arrays, one FFT of a 200,000-sample recording takes
milliseconds on the CPU, and numpy's FFT gives the JAX package's values
bit for bit on the same arrays (a device round trip would add a copy and
change the rounding).

Typical use (the reference's docstring)::

    so3_dt, so3_var = knot_spacing_and_variance(gyro, gyro_times, 0.99)
    r3_dt,  r3_var  = knot_spacing_and_variance(acc, acc_times, 0.99)
    trajectory = SplitTrajectory(r3_dt, so3_dt)
    weight = 1 / sqrt(var)
"""
import numpy as np

__all__ = [
    "bspline_interp_freq_func",
    "spline_interpolation_response",
    "make_reference_spectrum",
    "signal_energy",
    "find_uniform_knot_spacing",
    "find_uniform_knot_spacing_spectrum",
    "knot_spacing_and_variance",
]


def bspline_interp_freq_func(w, dt=1.0):
    """Un-normalized cubic B-spline interpolation frequency response at
    angular frequencies ``w`` (rad/s) for knot spacing ``dt``."""
    x = np.asarray(w, dtype=float) * dt
    # np.sinc is sin(pi u)/(pi u); the response uses sinc(x / 2pi).
    num = 3.0 * np.sinc(x / (2.0 * np.pi)) ** 4
    den = 2.0 + np.cos(x)
    return dt * num / den


def spline_interpolation_response(freqs, dt):
    """Normalized response (H(0)=1) at frequencies ``freqs`` in Hz."""
    H = bspline_interp_freq_func(2.0 * np.pi * np.asarray(freqs, float), dt)
    return H / bspline_interp_freq_func(0.0, dt)


def signal_energy(spectrum):
    """Mean squared magnitude (Parseval-normalized energy) of a spectrum."""
    spectrum = np.asarray(spectrum)
    return float(np.sum(np.abs(spectrum) ** 2) / spectrum.shape[-1])


def make_reference_spectrum(signal):
    """Combined multi-axis magnitude spectrum with the DC bin removed."""
    signal = np.atleast_2d(np.asarray(signal, float))
    if signal.ndim != 2:
        raise ValueError("Signal must be at most 2D")
    d = signal.shape[0]
    S = np.fft.fft(signal, axis=1)
    S[:, 0] = 0.0
    return np.sqrt(1.0 / d) * np.linalg.norm(S, axis=0)


def _bisect_root(f, lo, hi, f_lo, f_hi, iters=80, xtol=1e-12):
    """Plain bisection for a sign change of f on [lo, hi]."""
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        if hi - lo < xtol * max(1.0, abs(mid)):
            break
        f_mid = f(mid)
        if (f_mid > 0) == (f_lo > 0):
            lo, f_lo = mid, f_mid
        else:
            hi, f_hi = mid, f_mid
    return 0.5 * (lo + hi)


def find_uniform_knot_spacing_spectrum(
    Xhat, times, quality, *, min_dt=None, max_dt=None, verbose=False
):
    """Largest dt keeping ``quality`` fraction of the spectrum's energy.

    Semantics follow the reference search (sew.py:85-160): start from
    ``max_dt`` and backtrack with halving steps until the retained-energy
    condition holds, then refine the boundary by root finding on
    [dt, max_dt]. If no dt in range satisfies the condition, the best
    (highest-quality) dt probed is returned."""
    times = np.asarray(times, float)
    Xhat = np.asarray(Xhat, float)
    sample_rate = 1.0 / float(np.mean(np.diff(times)))
    freqs = np.fft.fftfreq(len(times), d=1.0 / sample_rate)
    budget = signal_energy(Xhat) * (1.0 - quality)

    def excess(dt):
        """>0 when the energy removed by spline smoothing is within budget."""
        H = spline_interpolation_response(freqs, dt)
        removed = signal_energy((1.0 - H) * Xhat)
        return budget - removed

    if min_dt is None:
        min_dt = 1.0 / sample_rate
    if max_dt is None:
        max_dt = (len(times) / 4.0) / sample_rate

    e_hi = excess(max_dt)
    if e_hi >= 0:
        if verbose:
            print(f"sew: endpoint dt={max_dt} already satisfies quality")
        return float(max_dt)

    dt = max_dt
    step = 0.5 * max_dt
    best_dt, best_excess = None, -np.inf
    while True:
        dt = max(dt - step, min_dt)
        e = excess(dt)
        if verbose:
            print(f"sew: probe dt={dt:.6g} excess={e:.3e}")
        if e > 0:
            return float(_bisect_root(excess, dt, max_dt, e, e_hi))
        step *= 0.5
        if e > best_excess:
            best_excess, best_dt = e, dt
        if dt <= min_dt:
            if verbose:
                print(f"sew: no dt meets quality; best dt={best_dt:.6g}")
            return float(best_dt)


def find_uniform_knot_spacing(signal, times, quality, *, verbose=False,
                              min_dt=None, max_dt=None):
    """Largest dt keeping ``quality`` fraction of the signal's energy."""
    Xhat = make_reference_spectrum(signal)
    return find_uniform_knot_spacing_spectrum(
        Xhat, times, quality, verbose=verbose, min_dt=min_dt, max_dt=max_dt
    )


def dt_to_variance_spectrum(spectrum, freqs, spline_dt):
    """Predicted per-sample variance of the spline fit error at ``spline_dt``."""
    H = spline_interpolation_response(freqs, spline_dt)
    return signal_energy((1.0 - H) * spectrum) / len(spectrum)


def quality_to_variance_spectrum(spectrum, q):
    """Variance implied directly by a quality level (energy fraction lost)."""
    spectrum = np.asarray(spectrum)
    return (1.0 - q) * float(np.mean(spectrum**2)) / len(spectrum)


def knot_spacing_and_variance(signal, times, quality, *, min_dt=None,
                              max_dt=None, verbose=False):
    """(dt, variance): knot spacing at the quality level + predicted spline
    fit-error variance for weighting measurements (reference sew.py:198-232).
    ``signal`` is ``[axes, samples]`` at ``times``."""
    Xhat = make_reference_spectrum(signal)
    dt = find_uniform_knot_spacing_spectrum(
        Xhat, times, quality, min_dt=min_dt, max_dt=max_dt, verbose=verbose
    )
    times = np.asarray(times, float)
    sample_rate = 1.0 / float(np.mean(np.diff(times)))
    freqs = np.fft.fftfreq(len(Xhat), d=1.0 / sample_rate)
    return dt, dt_to_variance_spectrum(Xhat, freqs, dt)
