"""Native (C++) host helper of the problem compiler (counterpart of
``kontiki_tpu.native``): span validation, knot activation, window base
indices, segment coalescing and a stable time argsort over contiguous
arrays, the reference's C++ problem assembly (trajectory_estimator.h:
97-122, spline_base.h:361-404).

``csrc/kontiki_host.cpp`` is compiled with the host C++ compiler at first
use (``ops.build.build_host``, into ``kontiki_tpu_torch/_build``) and bound
with ``ctypes``; a build or load failure raises. Each function's numpy
version (``*_plain``) is the plain reference the tests hold the C++ to, and
no path falls back to it.
"""
import ctypes
import functools

import numpy as np

__all__ = [
    "available",
    "check_spans",
    "activate_spans",
    "activate_points",
    "window_bases",
    "coalesce",
    "argsort_times",
]

SPAN_ERRORS = {
    1: "Time span out of range for trajectory",
    2: "At least one time span begins before it ends",
    3: "Time spans are not ordered",
}

_D = ctypes.c_double
_I64 = ctypes.c_int64
_P = ctypes.c_void_p
#: C entry points: name -> (argument types, return type)
_ENTRIES = {
    "kontiki_check_spans": ([_P, _P, _I64, _D, _D], ctypes.c_int),
    "kontiki_activate_spans": ([_P, _P, _I64, _D, _D, _I64, _P], None),
    "kontiki_activate_points": ([_P, _I64, _D, _D, _D, _D, _D, _I64, _P], ctypes.c_int),
    "kontiki_window_bases": ([_P, _I64, _D, _D, _I64, _I64, _P], None),
    "kontiki_coalesce": ([_P, _I64, _P, _P], _I64),
    "kontiki_argsort": ([_P, _I64, _P], None),
}


@functools.lru_cache(maxsize=None)
def _lib():
    """Build (if needed) and bind the helper; raises on failure."""
    from ..ops.build import build_host

    lib = ctypes.CDLL(str(build_host("kontiki_host.cpp")))
    for name, (argtypes, restype) in _ENTRIES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def available():
    """Whether the helper builds and loads here (a probe: every entry point
    raises where it does not)."""
    try:
        _lib()
    except Exception:
        return False
    return True


def _f64(a):
    return np.ascontiguousarray(a, dtype=np.float64)


def _ptr(a):
    return a.ctypes.data


def _active(active, nknots):
    if active is None:
        return np.zeros(nknots, dtype=np.uint8)
    if active.dtype != np.uint8 or not active.flags.c_contiguous or len(active) != nknots:
        raise ValueError(f"active must be a contiguous uint8 array of {nknots} knots")
    return active


def _raise(code):
    if code:
        raise ValueError(SPAN_ERRORS[code])


def check_spans(t1, t2, tmin, tmax):
    """Raise ``ValueError`` on the first invalid span (trajectory_estimator.h:
    97-122): out of [tmin, tmax), beginning after it ends, or beginning
    before the previous span."""
    t1, t2 = _f64(t1), _f64(t2)
    _raise(_lib().kontiki_check_spans(_ptr(t1), _ptr(t2), len(t1), float(tmin), float(tmax)))


def activate_spans(t1, t2, t0, dt, nknots, active=None):
    """Mark the knots of the 4-knot windows of the [t1, t2] spans active
    (spline_base.h:361-404) in a uint8 ``[nknots]`` mask (``active``,
    updated in place, or a new one); returns the mask."""
    t1, t2 = _f64(t1), _f64(t2)
    active = _active(active, nknots)
    _lib().kontiki_activate_spans(_ptr(t1), _ptr(t2), len(t1), float(t0), float(dt),
                                  nknots, _ptr(active))
    return active


def activate_points(t, slack, tmin, tmax, t0, dt, nknots, active=None):
    """Check and activate the spans ``[t - slack, t + slack]`` of point
    measurements at sorted times ``t`` in one pass (the IMU batch path);
    raises on an invalid span. Returns the mask."""
    t = _f64(t)
    active = _active(active, nknots)
    _raise(_lib().kontiki_activate_points(_ptr(t), len(t), float(slack), float(tmin),
                                          float(tmax), float(t0), float(dt), nknots,
                                          _ptr(active)))
    return active


def window_bases(t, t0, dt, nknots, W):
    """``clip(floor((t - t0) / dt), 0, nknots - W)`` as int32."""
    t = _f64(t)
    out = np.empty(len(t), dtype=np.int32)
    _lib().kontiki_window_bases(_ptr(t), len(t), float(t0), float(dt), nknots, int(W),
                                _ptr(out))
    return out


def coalesce(active):
    """The contiguous (start, stop) runs of an active mask (the reference's
    segments, spline_base.h:377-390)."""
    active = np.ascontiguousarray(active, dtype=np.uint8)
    n = len(active)
    starts = np.empty(n // 2 + 1, dtype=np.int64)
    stops = np.empty(n // 2 + 1, dtype=np.int64)
    k = _lib().kontiki_coalesce(_ptr(active), n, _ptr(starts), _ptr(stops))
    return list(zip(starts[:k].tolist(), stops[:k].tolist()))


def argsort_times(t):
    """Stable argsort of times (int64)."""
    t = _f64(t)
    out = np.empty(len(t), dtype=np.int64)
    _lib().kontiki_argsort(_ptr(t), len(t), _ptr(out))
    return out


# ---------------------------------------------------------------------------
# plain numpy versions: the references the tests hold the C++ to
# ---------------------------------------------------------------------------

def check_spans_plain(t1, t2, tmin, tmax):
    """``check_spans`` in numpy: each span's first failing rule, and the
    first failing span's error, as the C++ loop finds it."""
    t1, t2 = _f64(t1), _f64(t2)
    unordered = np.zeros(len(t1), dtype=bool)
    unordered[1:] = t1[1:] < t1[:-1]
    codes = np.where((t1 < tmin) | (t2 >= tmax), 1,
                     np.where(t1 > t2, 2, np.where(unordered, 3, 0)))
    bad = np.flatnonzero(codes)
    if len(bad):
        _raise(int(codes[bad[0]]))


def activate_spans_plain(t1, t2, t0, dt, nknots, active=None):
    """``activate_spans`` in numpy: a difference array paints the windows."""
    t1, t2 = _f64(t1), _f64(t2)
    active = _active(active, nknots)
    i1 = np.clip(np.floor((t1 - t0) / dt).astype(np.int64), 0, None)
    i2 = np.minimum(np.floor((t2 - t0) / dt).astype(np.int64) + 4, nknots)
    diff = np.zeros(nknots + 1, dtype=np.int64)
    valid = i1 < i2
    np.add.at(diff, i1[valid], 1)
    np.add.at(diff, i2[valid], -1)
    active |= (np.cumsum(diff[:-1]) > 0).astype(np.uint8)
    return active


def activate_points_plain(t, slack, tmin, tmax, t0, dt, nknots, active=None):
    """``activate_points`` in numpy: the spans checked, then activated."""
    t = _f64(t)
    check_spans_plain(t - slack, t + slack, tmin, tmax)
    return activate_spans_plain(t - slack, t + slack, t0, dt, nknots, active)


def window_bases_plain(t, t0, dt, nknots, W):
    """``window_bases`` in numpy."""
    return np.clip(np.floor((_f64(t) - t0) / dt).astype(np.int64), 0,
                   nknots - W).astype(np.int32)


def coalesce_plain(active):
    """``coalesce`` in numpy."""
    a = np.asarray(active).astype(bool)
    edges = np.flatnonzero(np.diff(np.concatenate([[False], a, [False]])))
    return list(zip(edges[0::2].tolist(), edges[1::2].tolist()))


def argsort_times_plain(t):
    """``argsort_times`` in numpy."""
    return np.argsort(_f64(t), kind="stable")
