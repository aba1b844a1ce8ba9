// Native host helper of kontiki_tpu_torch's problem compiler (a copy of
// the JAX package's kontiki_tpu/native/csrc/kontiki_host.cpp; the port
// imports nothing of that package).
//
// The reference implements its entire problem-assembly path in C++
// (trajectory_estimator.h:66-122 AddMeasurement/AddTrajectoryForTimes,
// spline_base.h:361-404 knot-window activation). Problem compilation is a
// host-side O(M) pass over measurements; at the 10^5-measurement scale of
// long IMU recordings a Python loop dominates it. This library is the
// native equivalent of the reference's C++ assembly layer: span
// validation, knot-window activation, window base-index computation,
// segment coalescing and a stable time argsort, all on contiguous arrays.
//
// Exposed through a plain C ABI, bound with ctypes by
// kontiki_tpu_torch/native (built with the host C++ compiler by
// ops/build.py build_host). Every function is pure and thread-safe.

#include <algorithm>
#include <cmath>
#include <cstdint>

extern "C" {

// Validate measurement time spans against the trajectory's valid range.
// Mirrors TrajectoryEstimator::CheckTimeSpans (trajectory_estimator.h:97-122).
// Returns 0 on success, 1 = span out of range, 2 = span begins after it
// ends, 3 = spans not ordered.
int kontiki_check_spans(const double* t1, const double* t2, int64_t nspans,
                        double tmin, double tmax) {
  double prev = -HUGE_VAL;
  for (int64_t i = 0; i < nspans; ++i) {
    if (t1[i] < tmin || t2[i] >= tmax) return 1;
    if (t1[i] > t2[i]) return 2;
    if (t1[i] < prev) return 3;
    prev = t1[i];
  }
  return 0;
}

// Mark knots touched by [t1, t2] spans as active: window [i1, i2+4) per
// span, clamped to [0, nknots) (spline_base.h:361-404).
void kontiki_activate_spans(const double* t1, const double* t2, int64_t nspans,
                            double t0, double dt, int64_t nknots,
                            uint8_t* active) {
  for (int64_t i = 0; i < nspans; ++i) {
    int64_t i1 = (int64_t)std::floor((t1[i] - t0) / dt);
    int64_t i2 = (int64_t)std::floor((t2[i] - t0) / dt);
    int64_t lo = std::max<int64_t>(i1, 0);
    int64_t hi = std::min<int64_t>(i2 + 4, nknots);
    for (int64_t k = lo; k < hi; ++k) active[k] = 1;
  }
}

// Point measurements at times t with symmetric slack (unlocked time offset):
// activate the window of every span (t[i]-slack, t[i]+slack). Fused variant
// of check+activate for the dominant IMU case. Returns the check code.
int kontiki_activate_points(const double* t, int64_t m, double slack,
                            double tmin, double tmax, double t0, double dt,
                            int64_t nknots, uint8_t* active) {
  double prev = -HUGE_VAL;
  for (int64_t i = 0; i < m; ++i) {
    double a = t[i] - slack, b = t[i] + slack;
    if (a < tmin || b >= tmax) return 1;
    if (a < prev) return 3;
    prev = a;
    int64_t i1 = (int64_t)std::floor((a - t0) / dt);
    int64_t i2 = (int64_t)std::floor((b - t0) / dt);
    int64_t lo = std::max<int64_t>(i1, 0);
    int64_t hi = std::min<int64_t>(i2 + 4, nknots);
    for (int64_t k = lo; k < hi; ++k) active[k] = 1;
  }
  return 0;
}

// Window base indices for W-knot windows: clip(floor((t-t0)/dt), 0, n-W).
void kontiki_window_bases(const double* t, int64_t m, double t0, double dt,
                          int64_t nknots, int64_t W, int32_t* ibase) {
  for (int64_t i = 0; i < m; ++i) {
    int64_t b = (int64_t)std::floor((t[i] - t0) / dt);
    b = std::min(std::max<int64_t>(b, 0), nknots - W);
    ibase[i] = (int32_t)b;
  }
}

// Coalesce overlapping/adjacent active-knot windows into contiguous
// segments. Writes (start, stop) pairs; returns the segment count. The
// reference's AddToProblem builds exactly these coalesced segments
// (spline_base.h:377-390); the solver uses them to size knot-shard halos.
int64_t kontiki_coalesce(const uint8_t* active, int64_t n, int64_t* seg_start,
                         int64_t* seg_stop) {
  int64_t nseg = 0;
  int64_t i = 0;
  while (i < n) {
    if (active[i]) {
      int64_t j = i;
      while (j < n && active[j]) ++j;
      seg_start[nseg] = i;
      seg_stop[nseg] = j;
      ++nseg;
      i = j;
    } else {
      ++i;
    }
  }
  return nseg;
}

// Stable argsort of measurement times into ord (int64 indices); used to
// order buckets by time so the knot-segment sharding gets contiguous
// windows per device shard.
void kontiki_argsort(const double* t, int64_t m, int64_t* ord) {
  for (int64_t i = 0; i < m; ++i) ord[i] = i;
  std::stable_sort(ord, ord + m,
                   [t](int64_t a, int64_t b) { return t[a] < t[b]; });
}

}  // extern "C"
