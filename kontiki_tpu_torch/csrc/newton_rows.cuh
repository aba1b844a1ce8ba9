// Newton rolling-shutter rows for Hopper (sm_90a): the per-row code of
// kernel B8 newton_rows and its kernels, shared by newton_rows.cu (pinhole
// camera) and newton_rows_atan.cu (atan camera), and compiled for the host
// by host_rows.cpp. Replaces the JAX package's fused tile
// kontiki_tpu/ops/linearize_kernels.py newton_rows -> _tile_newton_linearize /
// _tile_newton_cost (an XLA program there: its Mosaic lowering was removed).
// The plain PyTorch version is kontiki_tpu_torch/ops/linearize_kernels.py
// newton_rows_plain, which the wrapper runs for CPU tensors.
//
// A row (reference newton_rscamera_measurement.h:23-120):
//  - the world point X from the ref side's (p, q) at its row time;
//  - at most five Newton steps on f(t) = v(t) - rows t / readout in the row
//    time t relative to the frame start t0_obs + d, from t = v_obs readout /
//    rows: each evaluates the obs window at t0_obs + d + t and its time
//    derivative, the camera point X_cam and dX_cam / dt (with the
//    reference's `+ rho p_ct`, newton_rscamera_measurement.h:91, kept for
//    parity), the projection y and dy / dt, the step dt = f / f'; a step
//    with dt^2 < (readout / (2 rows))^2 ends the loop, any other moves t to
//    t - dt clamped to [0, readout];
//  - r = w (uv_obs - y) with the last step's y.
// The Newton time moves within the readout, which can cross knot
// boundaries, so each side streams its W-knot readout-slack window and a
// step evaluates the 4-knot sub-window j = clip(floor(u + s / dt), 0, W - 4)
// at u + s / dt - j, j held at the value's floor (the JAX tile's masked
// blend, whose 0/1 masks select the same knots and increments).
//
// Linearize form: r [M, 2], J [M, 2, C] over [ref window (Ct) | obs window
// (Ct) | sensor (13)], C = 2 Ct + 13, Ct = W x 6 (SE3) or 3 (W_r3 + W_so3)
// (split), and the landmark column J_rho [M, 2]. The time t carries
// tangents (every step's t depends on the parameters through the steps
// before it) and f' is dy/dt, so the Jacobian needs the obs chain's mixed
// second derivatives (parameters x time): the obs window and X_cam run on
// TD<Jet<T, N>> (jet.cuh), jvp in time inside forward mode over the seeds,
// as the tile nests jax.jvp inside jax.linearize. Clamps pass a tangent
// inside the bounds and zero it at a bound; the loop ends at the first
// step that passes the test (the tile runs all five under `where`, which
// changes nothing after it). The stages, as in B1 (camera_rows.cuh):
//   0. the ref sub-window at s = 0 and its primal (p, q) (B1's row_primal);
//   1. the Newton chain over NS = 7 + Ct + 8 seeds: the ref (p, q), the obs
//      window's Ct knot tangents, the sensor rotation and translation, the
//      inverse depth and the time shift s of both sides (d), in chunks of
//      kNewtonN seeds (newton_chain) -> JG [NS, 2] and r;
//   2. the ref sub-window in forward mode over its 24 knot tangents and s
//      in B1's chunks (B1's window_pq), chained through the (p, q)
//      bottleneck with JG's first 7 rows and written at the sub-window's
//      columns of the ref block; s's into t_ref;
//   3. the obs block JG[7 .. 7 + Ct), the sensor block [JG rotation (3),
//      translation (3), d = JG[s] + t_ref, biases (6) = 0] and J_rho =
//      JG[rho], everything times valid.
// A row runs on one warp (kNewtonGroup lanes): every lane of stage 1 runs
// the same primal Newton path (the same code on the same values in the
// same order: the lanes agree on every step and clamp) with its own seeds;
// stage 2 takes 8 lanes (split) or 12 (SE3), stage 3 all; the stages hand
// over in shared memory (NewtonGroup) and the block writes its rows' J
// tiles, contiguous in J, with 16-byte stores.
// Cost-only form: r [M, 2] alone, one row per thread, the same chain on
// plain scalars with a time dual TD<T> (newton_cost_row).
#pragma once

#include "camera_rows.cuh"

namespace {

// flags of the C entry points
constexpr int kNewtonSplit = 1;     // split R3 + SO3 windows (else SE3)
constexpr int kNewtonR3First = 2;   // split: the R3 spline comes first
constexpr int kNewtonAtan = 4;      // atan camera (else pinhole)
constexpr int kNewtonCostOnly = 8;  // residuals only

constexpr int kNewtonMaxW = 8;                      // knots of a side's window
constexpr int kNewtonMaxCt = 6 * kNewtonMaxW;       // a side's window tangents
constexpr int kNewtonMaxNS = kNewtonMaxCt + 15;     // chain seeds
constexpr int kNewtonSteps = 5;                     // Newton steps at most

// A row kind's window widths and column layout: W the SE3 window's knots
// or (W_r3, W_so3); off_r3 / off_so3 where each split spline's tangents
// start within a side's Ct.
struct NewtonShape {
  int W[2], Ct, NS, C, off_r3, off_so3;
};

KT_HD NewtonShape newton_shape(int W0, int W1, int flags) {
  NewtonShape sh;
  sh.W[0] = W0;
  sh.W[1] = W1;
  if (flags & kNewtonSplit) {
    const bool r3_first = (flags & kNewtonR3First) != 0;
    sh.Ct = 3 * (W0 + W1);
    sh.off_r3 = r3_first ? 0 : 3 * W1;
    sh.off_so3 = r3_first ? 3 * W0 : 0;
  } else {
    sh.Ct = 6 * W0;
    sh.off_r3 = sh.off_so3 = 0;
  }
  sh.NS = sh.Ct + 15;
  sh.C = 2 * sh.Ct + 13;
  return sh;
}

// Inputs are [k, M] arrays, in the order of the C entry points' pointer
// array: the windows (SE3 win_* [7 W], dts [1]; split win_* [3 W_r3],
// win_*_so3 [4 W_so3], u_*_so3, dts [2]), the row constants B1 reads
// (camera_rows.cuh Inputs: q_ct .. K, wc and gamma of the atan camera,
// valid may be null), then v_obs, rows and readout.
template <typename T>
struct NewtonInputs {
  Inputs<T> cam;
  const T* v_obs;
  int W[2];
};

constexpr int kNewtonSlots = 22;

template <typename T>
KT_HD NewtonInputs<T> make_newton_inputs(const void* const* p, int M, int W0, int W1,
                                         int flags) {
  NewtonInputs<T> in;
  Inputs<T>& c = in.cam;
  const T** slots[kNewtonSlots] = {
      &c.win_ref, &c.win_ref_so3, &c.u_ref, &c.u_ref_so3, &c.win_obs, &c.win_obs_so3,
      &c.u_obs, &c.u_obs_so3, &c.dts, &c.q_ct, &c.p_ct, &c.rho, &c.yh_ref, &c.uv_obs,
      &c.weight, &c.K, &c.wc, &c.gamma, &in.v_obs, &c.rows, &c.readout, &c.valid};
  for (int i = 0; i < kNewtonSlots; ++i) *slots[i] = static_cast<const T*>(p[i]);
  c.vt0 = c.vt_orig = nullptr;
  c.M = M;
  c.flags = flags;
  in.W[0] = W0;
  in.W[1] = W1;
  return in;
}

// A row's constants: B1's and the observation's row, rows and readout.
template <typename T>
struct NewtonRow : Row<T> {
  T v_obs;
};

// A row's two W-knot windows (0 ref, 1 obs): SE3 knots (7 x W) or R3 knots
// (3 x W_r3) then SO3 knots (4 x W_so3); u of the SE3 / R3 spline and of
// the SO3 spline (the ref side's at its row time, the obs side's at the
// frame start); knot spacings.
template <typename T>
struct NewtonWindows {
  T win[2][7 * kNewtonMaxW], u[2][2], dt[2];
};

template <typename T, bool Split, bool Atan>
KT_HD void load_newton_row(const NewtonInputs<T>& in, int m, NewtonWindows<T>& w,
                           NewtonRow<T>& row) {
  const Inputs<T>& c = in.cam;
  const int M = c.M;
  const T* win[2] = {c.win_ref, c.win_obs};
  const T* win_so3[2] = {c.win_ref_so3, c.win_obs_so3};
  const T* u[2] = {c.u_ref, c.u_obs};
  const T* u_so3[2] = {c.u_ref_so3, c.u_obs_so3};
  for (int i = 0; i < 2; ++i) {
    if (Split) {
      const int n3 = 3 * in.W[0];
      for (int k = 0; k < n3; ++k) w.win[i][k] = win[i][k * M + m];
      for (int k = 0; k < 4 * in.W[1]; ++k) w.win[i][n3 + k] = win_so3[i][k * M + m];
      w.u[i][1] = u_so3[i][m];
    } else {
      for (int k = 0; k < 7 * in.W[0]; ++k) w.win[i][k] = win[i][k * M + m];
      w.u[i][1] = T(0);
    }
    w.u[i][0] = u[i][m];
  }
  w.dt[0] = c.dts[m];
  w.dt[1] = Split ? c.dts[M + m] : w.dt[0];
  load_consts<T, Atan, false>(c, m, row);
  row.rows = c.rows[m];
  row.readout = c.readout[m];
  row.v_obs = in.v_obs[m];
}

// The base knot j = clip(floor(x), 0, W - 4) of a 4-knot sub-window.
template <typename T>
KT_HD int sub_base(T x, int W) {
  const int j = static_cast<int>(kt_floor(x));
  return j < 0 ? 0 : (j > W - 4 ? W - 4 : j);
}

// A value of S with tangent 1 in seed `slot` (none outside the seeds; a
// plain T has none).
template <typename S>
struct SeedOf {
  template <typename T>
  static KT_HD S make(T x, int) { return S(x); }
};
template <typename T, int N>
struct SeedOf<Jet<T, N>> {
  static KT_HD Jet<T, N> make(T x, int slot) { return seeded<T, N>(x, slot); }
};

// A side's window increments in the chain: increment x (of Ct) is zero
// with tangent 1 in seed base + x.
template <typename T, typename S>
struct WindowSeeds {
  int base;
  KT_HD S operator[](int x) const { return SeedOf<S>::make(T(0), base + x); }
};

// delta[o + k] as delta'[k]: an SE3 sub-window's increments.
template <typename D>
struct Shifted {
  const D& d;
  int o;
  KT_HD auto operator[](int k) const { return d[o + k]; }
};

// A split side's increments as pq_split takes a sub-window's (its R3
// knots' 12, then its SO3 knots' 12): the side's tangents from o_r3 and
// o_so3 on.
template <typename D>
struct SplitShifted {
  const D& d;
  int o_r3, o_so3;
  KT_HD auto operator[](int k) const { return k < 12 ? d[o_r3 + k] : d[o_so3 + k - 12]; }
};

// (p, q) of side i's window at u + s / dt (per spline) through its 4-knot
// sub-window at j = clip(floor(u + s / dt), 0, W - 4): B1's pq_se3 and
// pq_split on that sub-window, with knot increments delta (indexed over
// the side's Ct tangents, values of SK) and the time shift s (ST: SK, or a
// TD<SK> for the time derivative).
template <typename T, bool Split, typename SK, typename ST, typename D>
KT_HD void newton_pq(const NewtonWindows<T>& w, int i, const NewtonShape& sh, const D& delta,
                     const ST& s, ST* out) {
  const T* win = w.win[i];
  const T sv = val(s);
  const int j0 = sub_base<T>(w.u[i][0] + sv / w.dt[0], sh.W[0]);
  if (Split) {
    const int jq = sub_base<T>(w.u[i][1] + sv / w.dt[1], sh.W[1]);
    const SplitShifted<D> d = {delta, sh.off_r3 + 3 * j0, sh.off_so3 + 3 * jq};
    pq_split<T, ST, SplitShifted<D>, false, SK>(win + 3 * j0, win + 3 * sh.W[0] + 4 * jq,
                                                w.u[i][0], w.u[i][1], w.dt[0], w.dt[1], d, s,
                                                true, out, j0, jq);
  } else {
    const Shifted<D> d = {delta, 6 * j0};
    pq_se3<T, ST, Shifted<D>, false, SK>(win + 7 * j0, w.u[i][0], w.dt[0], d, s, out, j0);
  }
}

// The pinhole projection y of X and its time derivative dy given dX / dt
// (camera_models.pinhole_evaluate, the same eps placement).
template <typename T, typename S>
KT_HD void evaluate_pinhole(const Row<T>& row, const V3<S>& X, const V3<S>& dX, S* y, S* dy) {
  const T* K = row.K;
  const S px = K[0] * X.x + K[1] * X.y + K[2] * X.z;
  const S py = K[3] * X.x + K[4] * X.y + K[5] * X.z;
  const S pz = K[6] * X.x + K[7] * X.y + K[8] * X.z;
  const S dpx = K[0] * dX.x + K[1] * dX.y + K[2] * dX.z;
  const S dpy = K[3] * dX.x + K[4] * dX.y + K[5] * dX.z;
  const S dpz = K[6] * dX.x + K[7] * dX.y + K[8] * dX.z;
  const S den = pz * pz + T(kEpsP);
  y[0] = px / pz;
  y[1] = py / pz;
  dy[0] = (dpx * pz - px * dpz) / den;
  dy[1] = (dpy * pz - py * dpz) / den;
}

// The atan camera's y (B1's project_atan) and dy (camera_models.atan_evaluate).
template <typename T, typename S>
KT_HD void evaluate_atan(const Row<T>& row, const V3<S>& X, const V3<S>& dX, S* y, S* dy) {
  project_atan<T, S>(row, X, y);
  const T* K = row.K;
  const S Az = X.z + T(kEpsP);
  const S L0 = X.x / Az - row.wc[0];
  const S L1 = X.y / Az - row.wc[1];
  const S r = kt_sqrt(L0 * L0 + L1 * L1 + T(kEpsP));
  const S f = kt_atan(r * row.gamma) / row.gamma;
  const S g0 = L0 / r;
  const S g1 = L1 / r;
  const S z2 = X.z * X.z + T(kEpsP);
  const S dx = (dX.x * X.z - X.x * dX.z) / z2;
  const S dyv = (dX.y * X.z - X.y * dX.z) / z2;
  const S common = g0 * dx + g1 * dyv;
  const S df = common / (T(1) + row.gamma * row.gamma * r * r);
  const S du = f * ((dx * r - L0 * common) / (r * r)) + df * g0;
  const S dv = f * ((dyv * r - L1 * common) / (r * r)) + df * g1;
  dy[0] = K[0] * du + K[1] * dv;
  dy[1] = K[3] * du + K[4] * dv;
}

// The Newton chain of a row (stage 1) on S: a Jet<T, N> over seeds k0 ..
// k0 + N - 1 of the NS (ref (p, q) 7, obs window Ct, sensor rotation and
// translation 6, inverse depth, time shift s), or a plain T. pq_ref is the
// ref side's primal (p, q). Writes r [2]; returns the steps taken. With
// margin (a check's), also the smallest |dt^2 - bound| / bound of the
// convergence tests the row took.
template <typename T, bool Split, bool Atan, typename S>
KT_HD int newton_chain(const NewtonWindows<T>& w, const NewtonRow<T>& row, const T* pq_ref,
                       const NewtonShape& sh, int k0, S* r, T* margin = nullptr) {
  using Seed = SeedOf<S>;
  using D2 = TD<S>;
  S ur[7], dsen[6];
  for (int k = 0; k < 7; ++k) ur[k] = Seed::make(pq_ref[k], k - k0);
  for (int k = 0; k < 6; ++k) dsen[k] = Seed::make(T(0), 7 + sh.Ct + k - k0);
  const S drho = Seed::make(T(0), 13 + sh.Ct - k0);
  const S ds = Seed::make(T(0), 14 + sh.Ct - k0);
  const WindowSeeds<T, S> delta = {7 - k0};

  const Q4<S> q_ct = qmul(so3_exp_quat(V3<S>{dsen[0], dsen[1], dsen[2]}),
                          Q4<S>{S(row.q_ct[0]), S(row.q_ct[1]), S(row.q_ct[2]), S(row.q_ct[3])});
  const V3<S> p_ct = {row.p_ct[0] + dsen[3], row.p_ct[1] + dsen[4], row.p_ct[2] + dsen[5]};
  const S rho = row.rho + drho;
  const V3<S> a = {row.yh[0] - rho * p_ct.x, row.yh[1] - rho * p_ct.y, row.yh[2] - rho * p_ct.z};
  const V3<S> Xw = qrotate(Q4<S>{ur[3], ur[4], ur[5], ur[6]}, qrotate(qconj(q_ct), a));
  const V3<S> X = {Xw.x + rho * ur[0], Xw.y + rho * ur[1], Xw.z + rho * ur[2]};
  const Q4<D2> q_ct2 = {D2(q_ct.w), D2(q_ct.x), D2(q_ct.y), D2(q_ct.z)};

  const T row_delta = row.readout / row.rows;
  const T half = T(0.5) * row_delta;
  const T max_dt2 = half * half;
  S t_rel = S(row.v_obs * row_delta);
  S y[2], dy[2];
  int steps = 0;
  for (;;) {
    D2 pq[7];
    newton_pq<T, Split, S, D2>(w, 1, sh, delta, D2(ds + t_rel, S(T(1))), pq);
    const V3<D2> sv = {X.x - rho * pq[0], X.y - rho * pq[1], X.z - rho * pq[2]};
    const V3<D2> Xc = qrotate(q_ct2, qrotate(qconj(Q4<D2>{pq[3], pq[4], pq[5], pq[6]}), sv));
    const V3<S> Xcam = {Xc.x.a + rho * p_ct.x, Xc.y.a + rho * p_ct.y, Xc.z.a + rho * p_ct.z};
    // the reference's constant offset in the time derivative
    const V3<S> dXcam = {Xc.x.d + rho * p_ct.x, Xc.y.d + rho * p_ct.y, Xc.z.d + rho * p_ct.z};
    if constexpr (Atan) {
      evaluate_atan<T, S>(row, Xcam, dXcam, y, dy);
    } else {
      evaluate_pinhole<T, S>(row, Xcam, dXcam, y, dy);
    }
    ++steps;
    const S dtn = (y[1] - row.rows * t_rel / row.readout) / (dy[1] - row.rows / row.readout);
    const T dv = val(dtn);
    if (margin) {
      const T mm = kt_abs(dv * dv - max_dt2) / max_dt2;
      if (steps == 1 || mm < *margin) *margin = mm;
    }
    if (dv * dv < max_dt2 || steps == kNewtonSteps) break;
    t_rel = t_rel - dtn;
    if (val(t_rel) < T(0)) {
      t_rel = S(T(0));
    } else if (val(t_rel) > row.readout) {
      t_rel = S(row.readout);
    }
  }
  r[0] = row.weight * (row.uv[0] - y[0]);
  r[1] = row.weight * (row.uv[1] - y[1]);
  return steps;
}

// Stage 0: the ref side's 4-knot sub-window at s = 0 into slot 0 of B1's
// Windows (knots j .. j + 3 per spline, u - j), its bases j_ref.
template <typename T, bool Split>
KT_HD void ref_sub_window(const NewtonWindows<T>& w, const NewtonShape& sh, Windows<T>& sub,
                          int* j_ref) {
  const T* win = w.win[0];
  const int j0 = sub_base<T>(w.u[0][0], sh.W[0]);
  j_ref[0] = j0;
  sub.u[0][0] = w.u[0][0] - T(j0);
  sub.dt[0] = w.dt[0];
  sub.dt[1] = w.dt[1];
  if (Split) {
    const int j1 = sub_base<T>(w.u[0][1], sh.W[1]);
    j_ref[1] = j1;
    for (int k = 0; k < 12; ++k) sub.win[0][k] = win[3 * j0 + k];
    for (int k = 0; k < 16; ++k) sub.win[0][12 + k] = win[3 * sh.W[0] + 4 * j1 + k];
    sub.u[0][1] = w.u[0][1] - T(j1);
  } else {
    j_ref[1] = 0;
    for (int k = 0; k < 28; ++k) sub.win[0][k] = win[7 * j0 + k];
    sub.u[0][1] = T(0);
  }
}

// What a row's stages hand on: the ref sub-window, its bases and primal
// (p, q), the chain's seed columns JG and r, the residual's derivative
// through the ref side's time shift, and the Newton steps taken.
template <typename T>
struct NewtonStages {
  Windows<T> sub;
  int j_ref[2], steps;
  T pq_ref[7], JG[kNewtonMaxNS][2], r[2], t_ref[2];
};

// The ref block's column of the sub-window's local tangent k (of 24: the
// first spline's 12, then the second's; SE3 knots' 6 each).
KT_HD int ref_column(const NewtonShape& sh, bool split, bool r3_first, const int* j_ref, int k) {
  if (!split) return 6 * j_ref[0] + k;
  const bool r3 = (k < 12) == r3_first;
  const int kk = k < 12 ? k : k - 12;
  return r3 ? sh.off_r3 + 3 * j_ref[0] + kk : sh.off_so3 + 3 * j_ref[1] + kk;
}

// Stage 1: the chain over seed chunk c of width N into st.JG; chunk 0 also
// writes r and the steps.
template <typename T, bool Split, bool Atan, int N>
KT_HD void newton_chain_chunk(const NewtonWindows<T>& w, const NewtonRow<T>& row,
                              const NewtonShape& sh, NewtonStages<T>& st, int c) {
  using S = Jet<T, N>;
  const int k0 = N * c;
  S r[2];
  const int steps = newton_chain<T, Split, Atan, S>(w, row, st.pq_ref, sh, k0, r);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (k0 + i < sh.NS) {
      st.JG[k0 + i][0] = r[0].v[i];
      st.JG[k0 + i][1] = r[1].v[i];
    }
  }
  if (c == 0) {
    st.r[0] = r[0].a;
    st.r[1] = r[1].a;
    st.steps = steps;
  }
}

// Stage 2: the ref sub-window over its chunk c (B1's row_window schedule:
// Per knot tangents and, in the last slot when N1 > Per, the time shift),
// chained with JG's first 7 rows into J [2, C] at the sub-window's columns
// (times v), the time shift's into t_ref.
template <typename T, bool Split, int N1, int Per>
KT_HD void newton_ref_window(NewtonStages<T>& st, const NewtonShape& sh, bool r3_first, int c,
                             T v, T* J) {
  using S = Jet<T, N1>;
  const int k0 = Per * c;
  const SeededDelta<T, N1> delta = {k0, Per};
  const S s = seeded<T, N1>(T(0), N1 > Per ? Per : 24 - k0);
  S out[7];
  window_pq<T, Split, S, true>(st.sub, 0, r3_first, delta, s, out);
#pragma unroll
  for (int j = 0; j < N1; ++j) {
    const int sd = j < Per ? k0 + j : 24;
    if (sd > 24 || (j >= Per && c != 0)) continue;
    for (int rr = 0; rr < 2; ++rr) {
      T acc = T(0);
      for (int k = 0; k < 7; ++k) acc = acc + st.JG[k][rr] * out[k].v[j];
      if (sd < 24) {
        J[rr * sh.C + ref_column(sh, Split, r3_first, st.j_ref, sd)] = acc * v;
      } else {
        st.t_ref[rr] = acc;
      }
    }
  }
}

// The stage-2 lanes' widths (B1's Lanes): Per knot tangents a lane.
template <bool Split>
struct NewtonRefLanes {
  static constexpr int per = Split ? 3 : 2;
  static constexpr int chunks = 24 / per;
};

constexpr int kNewtonN = 2;        // chain seeds a stage-1 lane
constexpr int kNewtonGroup = 32;   // lanes a row: ceil(kNewtonMaxNS / kNewtonN)
static_assert((kNewtonMaxNS + kNewtonN - 1) / kNewtonN <= kNewtonGroup, "chain lanes");

// Lane `lane` of a row's group of `lanes` in stage `stage` (0-3 as above)
// on the row's J tile [2, C] (zeroed in stage 0) and outputs r, J_rho [2].
template <typename T, bool Split, bool Atan>
KT_HD void newton_stage(int stage, int lane, int lanes, const NewtonWindows<T>& w,
                        const NewtonRow<T>& row, const NewtonShape& sh, bool r3_first,
                        NewtonStages<T>& st, T* J, T* r_out, T* Jrho_out) {
  using K = NewtonRefLanes<Split>;
  const T v = row.valid;
  if (stage == 0) {
    for (int e = lane; e < 2 * sh.Ct; e += lanes) J[(e / sh.Ct) * sh.C + e % sh.Ct] = T(0);
    if (lane == 0) {
      ref_sub_window<T, Split>(w, sh, st.sub, st.j_ref);
      row_primal<T, Split>(st.sub, 0, r3_first, st.pq_ref);
    }
  } else if (stage == 1) {
    if (lane < (sh.NS + kNewtonN - 1) / kNewtonN) {
      newton_chain_chunk<T, Split, Atan, kNewtonN>(w, row, sh, st, lane);
    }
  } else if (stage == 2) {
    if (lane < K::chunks) newton_ref_window<T, Split, K::per + 1, K::per>(st, sh, r3_first, lane, v, J);
  } else {
    const int n = sh.C - sh.Ct;  // the obs and sensor blocks
    for (int e = lane; e < 2 * n; e += lanes) {
      const int rr = e / n, col = e % n;  // col: within the obs block, then the sensor's
      T x;
      if (col < sh.Ct + 6) {
        x = st.JG[7 + col][rr];
      } else if (col == sh.Ct + 6) {
        x = st.JG[14 + sh.Ct][rr] + st.t_ref[rr];
      } else {
        x = T(0);
      }
      J[rr * sh.C + sh.Ct + col] = x * v;
    }
    if (lane == 0) {
      for (int rr = 0; rr < 2; ++rr) {
        r_out[rr] = st.r[rr] * v;
        Jrho_out[rr] = st.JG[13 + sh.Ct][rr] * v;
      }
    }
  }
}

// Row m as the kernel's lane group computes it, the lanes of each stage one
// after the other: the host's check of the kernel's schedule. Returns the
// Newton steps.
template <typename T, bool Split, bool Atan>
KT_HD int newton_row_lanes(const NewtonInputs<T>& in, int m, T* r_out, T* J_out,
                           T* Jrho_out) {
  const NewtonShape sh = newton_shape(in.W[0], in.W[1], in.cam.flags);
  const bool r3_first = (in.cam.flags & kNewtonR3First) != 0;
  NewtonWindows<T> w;
  NewtonRow<T> row;
  load_newton_row<T, Split, Atan>(in, m, w, row);
  NewtonStages<T> st;
  T* J = J_out + static_cast<size_t>(m) * 2 * sh.C;
  for (int stage = 0; stage < 4; ++stage) {
    for (int lane = 0; lane < kNewtonGroup; ++lane) {
      newton_stage<T, Split, Atan>(stage, lane, kNewtonGroup, w, row, sh, r3_first, st, J,
                                   r_out + 2 * m, Jrho_out + 2 * m);
    }
  }
  return st.steps;
}

// Residual only of row m into r_out [2] (times valid): the ref sub-window's
// primal, then the chain on plain scalars. Returns the Newton steps (and
// their tests' margin, as newton_chain's).
template <typename T, bool Split, bool Atan>
KT_HD int newton_cost_row(const NewtonInputs<T>& in, int m, T* r_out, T* margin = nullptr) {
  const NewtonShape sh = newton_shape(in.W[0], in.W[1], in.cam.flags);
  const bool r3_first = (in.cam.flags & kNewtonR3First) != 0;
  NewtonWindows<T> w;
  NewtonRow<T> row;
  load_newton_row<T, Split, Atan>(in, m, w, row);
  Windows<T> sub;
  int j_ref[2];
  T pq_ref[7], r[2];
  ref_sub_window<T, Split>(w, sh, sub, j_ref);
  row_primal<T, Split>(sub, 0, r3_first, pq_ref);
  const int steps = newton_chain<T, Split, Atan, T>(w, row, pq_ref, sh, 0, r, margin);
  r_out[0] = r[0] * row.valid;
  r_out[1] = r[1] * row.valid;
  return steps;
}

#ifdef __CUDACC__

constexpr int kNewtonThreads = 128;
constexpr int kNewtonRows = kNewtonThreads / kNewtonGroup;  // rows a block

// A row group's inputs and stage results in shared memory.
template <typename T>
struct NewtonGroup {
  NewtonWindows<T> w;
  NewtonRow<T> row;
  NewtonStages<T> st;
};

template <typename T>
size_t newton_smem_bytes(int C) {
  return kNewtonRows * (sizeof(T) * 2 * C + sizeof(NewtonGroup<T>));
}

// B8 linearize: a block of kNewtonRows rows, each on one warp
// (newton_stage); the warp's J tile is staged in shared memory and the
// block's tiles, contiguous in J, are written out together.
template <typename T, bool Split, bool Atan>
__global__ void __launch_bounds__(kNewtonThreads) newton_rows_kernel(NewtonInputs<T> in, T* r,
                                                                    T* J, T* J_rho) {
  extern __shared__ __align__(16) unsigned char smem[];
  const NewtonShape sh = newton_shape(in.W[0], in.W[1], in.cam.flags);
  T* tiles = reinterpret_cast<T*>(smem);
  NewtonGroup<T>* groups = reinterpret_cast<NewtonGroup<T>*>(tiles + kNewtonRows * 2 * sh.C);
  const int grp = threadIdx.x / kNewtonGroup;
  const int lane = threadIdx.x % kNewtonGroup;
  const int m0 = blockIdx.x * kNewtonRows;
  const int m = m0 + grp;
  const bool live = m < in.cam.M;
  NewtonGroup<T>& g = groups[grp];
  T* tile = tiles + grp * 2 * sh.C;
  const bool r3_first = (in.cam.flags & kNewtonR3First) != 0;
  if (live && lane == 0) load_newton_row<T, Split, Atan>(in, m, g.w, g.row);
  __syncwarp();
  for (int stage = 0; stage < 4; ++stage) {
    if (live) {
      newton_stage<T, Split, Atan>(stage, lane, kNewtonGroup, g.w, g.row, sh, r3_first, g.st,
                                   tile, r + 2 * m, J_rho + 2 * m);
    }
    __syncwarp();
  }
  __syncthreads();
  const int rows = in.cam.M - m0 < kNewtonRows ? in.cam.M - m0 : kNewtonRows;
  copy_out(tiles, J + static_cast<size_t>(m0) * 2 * sh.C, rows * 2 * sh.C);
}

constexpr int kNewtonCostThreads = 64;

// B8 cost-only: one row per thread (newton_cost_row).
template <typename T, bool Split, bool Atan>
__global__ void __launch_bounds__(kNewtonCostThreads) newton_cost_kernel(NewtonInputs<T> in,
                                                                        T* r) {
  const int m = blockIdx.x * kNewtonCostThreads + threadIdx.x;
  if (m < in.cam.M) newton_cost_row<T, Split, Atan>(in, m, r + 2 * m);
}

// Rows B8's linearize kernel holds on the card at once, for these window
// widths (its shared memory grows with C).
template <typename T, bool Atan>
int newton_wave(int W0, int W1, int flags) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const size_t smem = newton_smem_bytes<T>(newton_shape(W0, W1, flags).C);
  if (flags & kNewtonSplit) {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, newton_rows_kernel<T, true, Atan>,
                                                  kNewtonThreads, smem);
  } else {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, newton_rows_kernel<T, false, Atan>,
                                                  kNewtonThreads, smem);
  }
  return sms * (per_sm > 0 ? per_sm : 1) * kNewtonRows;
}

// Launch B8 (J == nullptr: the cost-only form) on one camera, on the
// flags' window kind; returns cudaGetLastError().
template <typename T, bool Atan>
int launch_newton(const void* const* ins, void* r, void* J, void* J_rho, int M, int W0,
                  int W1, int flags, void* stream) {
  const NewtonInputs<T> in = make_newton_inputs<T>(ins, M, W0, W1, flags);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  T* rp = static_cast<T*>(r);
  const bool split = (flags & kNewtonSplit) != 0;
  if (J == nullptr) {
    const int blocks = (M + kNewtonCostThreads - 1) / kNewtonCostThreads;
    if (split) {
      newton_cost_kernel<T, true, Atan><<<blocks, kNewtonCostThreads, 0, st>>>(in, rp);
    } else {
      newton_cost_kernel<T, false, Atan><<<blocks, kNewtonCostThreads, 0, st>>>(in, rp);
    }
  } else {
    const int C = newton_shape(W0, W1, flags).C;
    const size_t smem = newton_smem_bytes<T>(C);
    const int blocks = (M + kNewtonRows - 1) / kNewtonRows;
    T* Jp = static_cast<T*>(J);
    T* Jr = static_cast<T*>(J_rho);
    if (split) {
      newton_rows_kernel<T, true, Atan><<<blocks, kNewtonThreads, smem, st>>>(in, rp, Jp, Jr);
    } else {
      newton_rows_kernel<T, false, Atan><<<blocks, kNewtonThreads, smem, st>>>(in, rp, Jp, Jr);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

#endif  // __CUDACC__

}  // namespace
