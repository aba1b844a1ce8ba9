"""Valid-time selection helpers (the port's own copy of ``kontiki_tpu.utils``).

Behavioral parity with the reference's ``kontiki.utils`` (its Python
package's kontiki/utils.py): pick evaluation times/spans
inside a trajectory's valid range, handling half-infinite and fully
infinite ranges. Rewritten around a single range-classification helper.
"""
import math

#: Arbitrary anchor used when the valid range is unbounded on both sides
#: (any finite time is equally safe then); value kept for parity with the
#: reference's choice.
_UNBOUNDED_ANCHOR = 42.0


def _classify(trajectory):
    """(tmin, tmax, kind) where kind is 'bounded' | 'left' | 'right' | 'free'.

    Raises if an unbounded range is inverted (tmax <= tmin with at least one
    infinite endpoint means the range is empty or ill-formed).
    """
    tmin, tmax = trajectory.valid_time
    lo_fin = math.isfinite(tmin)
    hi_fin = math.isfinite(tmax)
    if lo_fin and hi_fin:
        return tmin, tmax, "bounded"
    if tmax <= tmin:
        raise ValueError(f"No safe time: tmax <= tmin! ({tmax} <= {tmin})")
    if lo_fin:
        return tmin, tmax, "left"
    if hi_fin:
        return tmin, tmax, "right"
    return tmin, tmax, "free"


def safe_time(trajectory):
    """A single time at which the trajectory is valid to evaluate."""
    tmin, tmax, kind = _classify(trajectory)
    t = {
        "bounded": lambda: 0.5 * (tmin + tmax),
        "left": lambda: tmin + 1.0,
        "right": lambda: tmax - 1.0,
        "free": lambda: _UNBOUNDED_ANCHOR,
    }[kind]()
    if not math.isfinite(t):
        raise ValueError("No safe time: result was not finite")
    return t


def safe_time_span(trajectory, length, *, allow_shorter=False):
    """A (t1, t2) span of the given length inside the valid range.

    With ``allow_shorter=True`` a bounded range shorter than ``length``
    (but non-empty) is returned whole instead of raising.
    """
    tmin, tmax, kind = _classify(trajectory)
    if kind == "bounded":
        if tmax - tmin >= length:
            span = (tmin, tmin + length)
        elif allow_shorter and tmax > tmin:
            span = (tmin, tmax)
        else:
            raise ValueError("No safe time span: trajectory is too short")
    elif kind == "left":
        span = (tmin, tmin + length)
    elif kind == "right":
        span = (tmax - length, tmax)
    else:
        span = (_UNBOUNDED_ANCHOR, _UNBOUNDED_ANCHOR + length)
    if not all(math.isfinite(t) for t in span):
        raise ValueError("No safe time span: got non-finite result")
    return span
