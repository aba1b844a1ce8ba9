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
//    rows: each evaluates the obs window at e = t0_obs + d + t and its time
//    derivative, the camera point X_cam and dX_cam / dt (with the
//    reference's `+ rho p_ct`, newton_rscamera_measurement.h:91, kept for
//    parity), the projection y and dy / dt, the step dt = f / f'; a step
//    with dt^2 < (readout / (2 rows))^2 ends the loop, any other moves t to
//    t - dt clamped to [0, readout];
//  - r = w (uv_obs - y) with the last step's y.
// The Newton time moves within the readout, which can cross knot
// boundaries, so each side streams its W-knot readout-slack window and a
// step evaluates the 4-knot sub-window j = clip(floor(u + e / dt), 0, W - 4)
// at u + e / dt - j, j held at the value's floor (the JAX tile's masked
// blend, whose 0/1 masks select the same knots and increments).
//
// Linearize form: r [M, 2], J [M, 2, C] over [ref window (Ct) | obs window
// (Ct) | sensor (13)], C = 2 Ct + 13, Ct = W x 6 (SE3) or 3 (W_r3 + W_so3)
// (split), and the landmark column J_rho [M, 2], over NS = 7 + Ct + 8 seeds
// of the chain: the ref (p, q), the obs window's Ct knot tangents, the
// sensor rotation and translation, the inverse depth and the time shift d.
// Every step's time t_k carries tangents tau (it depends on the parameters
// through the steps before it) and f' is dy/dt, so the Jacobian needs the
// obs chain's mixed second derivatives (parameters x time).
//
// Design: the primal Newton path once a row, each step's local derivatives
// at that step's fixed time e_k, chained through the steps in the seed
// dimension (the chain rule the jets of a forward pass apply, in another
// order; the results agree to rounding). Per row, in stages:
//   1. the primal path (newton_primal): the ref (p, q) and X, then each
//      step's obs window on Taylor2 in e (p, q, their first and second
//      e-derivatives) and its head on them: y, f, f' and the primal
//      e-derivatives of y and of f' (the f' the code computes: through
//      d^2 Xc / de^2 and X_cam's own d/de, the `+ rho p_ct` quirk kept).
//      Each step's record (e_k, its sub-window bases, whether its update
//      clamped, those values) and the step that ended the loop make the
//      row's path (NewtonPath);
//   2. the local tiles, in rounds of kNewtonBatch steps (newton_task): one
//      task a seed chunk of N, all on TD<Jet<T, N>> (jet.cuh), in an order
//      that gives a warp's pass tasks of one kind:
//       - the ref sub-window over its 24 knot tangents and its time shift
//         (round 0 only): its local Jacobian [25][7];
//       - the obs sub-window of step k at e_k over 24 local knot tangents,
//         through the head: the tangents' partials of (y1, f') (of (y0,
//         y1) at the last step), in B1's window chunks (pq_se3 / pq_split
//         on a sub-window base); a split window's R3 knot tangents move p
//         alone, so their chunks run the R3 spline and take q from the
//         step's record;
//       - the head of step k over the 14 seeds it takes directly (the ref
//         (p, q), the sensor, rho) at the step's fixed (p, q);
//   3. the chain (newton_seed_chain), one lane a seed: at each step of the
//      round, the tangents of e (tau, plus 1 for d) and of f and f' from
//      the step's partials and primal e-derivatives, then
//      tau <- tau - (df - (f / f') df') / f' (0 when the update clamped);
//      at the last step J_i = -w dy_i, written at the seed's column;
//   4. the ref block: the ref window's local Jacobian chained with the ref
//      (p, q) seeds' J, and d = its column + the ref time shift's.
// Everything is multiplied by valid. The host's check runs the four stages
// on a row's lanes one after the other (newton_row_lanes). On the card the
// linearize form is two kernels: stage 1 a row a thread (newton_path_kernel,
// every row's primal path at once; it leaves the path in the row's slot of
// J), then stages 2-4 on kNewtonLanes lanes a row (newton_rows_kernel),
// whose windows, paths, tiles and tangents live in shared memory sized by
// the launch's W (no bound on W but the card's shared memory); the lanes
// hand over there, and the block writes its rows' J tiles, contiguous in
// J, with 16-byte stores over the paths.
// Bound: at config 4-Newton's 12,304 rows the function needs at most
// ~625 M f64 operations, the cheaper of the two schedules host_rows.cpp
// counts (one full-width jet a stage: ~731 M; these kernels' own stages:
// ~625 M), ~0.0093 ms at 67 TFLOP/s; the kernels take ~52x that on an
// H100: a task's window on TD<Jet<T, 3>>
// needs the 255 registers of two blocks an SM, so 8 warps an SM run long
// chains of dependent f64 operations (sincos, atan2, sqrt and divisions
// on jets). One wave holds 4,224 rows.
//
// Cost-only form: r [M, 2] alone, one row per thread, the chain on plain
// scalars with a time dual TD<T> (newton_cost_row).
#pragma once

#include "camera_rows.cuh"

namespace {

// flags of the C entry points
constexpr int kNewtonSplit = 1;     // split R3 + SO3 windows (else SE3)
constexpr int kNewtonR3First = 2;   // split: the R3 spline comes first
constexpr int kNewtonAtan = 4;      // atan camera (else pinhole)
constexpr int kNewtonCostOnly = 8;  // residuals only

constexpr int kNewtonSteps = 5;     // Newton steps at most
constexpr int kNewtonBatch = 2;     // steps a round of local tiles
constexpr int kNewtonRounds = (kNewtonSteps + kNewtonBatch - 1) / kNewtonBatch;
constexpr int kNewtonHeadSeeds = 14;                // ref (p, q) 7, sensor 6, rho
constexpr int kNewtonPartials = 24 + kNewtonHeadSeeds;  // a step's partials a residual

// The widest windows (knots a spline) that a row's fixed-size arrays hold:
// the kernels that run a row a thread keep its windows in local memory, or
// (Wide: wider windows) in shared memory, a block's rows side by side; the
// host's one-jet chain of the operation count (host_rows.cpp
// newton_row_wide) takes windows up to this width too.
constexpr int kNewtonLocalW = 8;

// A row kind's window widths and column layout: W the SE3 window's knots
// or (W_r3, W_so3); off_r3 / off_so3 where each split spline's tangents
// start within a side's Ct; win the values of a side's window.
struct NewtonShape {
  int W[2], Ct, NS, C, off_r3, off_so3, win;
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
    sh.win = 3 * W0 + 4 * W1;
  } else {
    sh.Ct = 6 * W0;
    sh.off_r3 = sh.off_so3 = 0;
    sh.win = 7 * W0;
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

// A row's two W-knot windows (0 ref, 1 obs), each NewtonShape::win values:
// SE3 knots (7 x W) or R3 knots (3 x W_r3) then SO3 knots (4 x W_so3); u of
// the SE3 / R3 spline and of the SO3 spline (the ref side's at its row
// time, the obs side's at the frame start); knot spacings.
template <typename T>
struct NewtonWindows {
  T* win[2];
  T u[2][2], dt[2];
};

// Row m's windows, into w.win (set by the caller), and constants. Lane
// `lane` of `lanes` loads every lanes-th window value; lane 0 the rest.
template <typename T, bool Split, bool Atan>
KT_HD void load_newton_row(const NewtonInputs<T>& in, int m, NewtonWindows<T>& w,
                           NewtonRow<T>& row, int lane = 0, int lanes = 1) {
  const Inputs<T>& c = in.cam;
  const int M = c.M;
  const T* win[2] = {c.win_ref, c.win_obs};
  const T* win_so3[2] = {c.win_ref_so3, c.win_obs_so3};
  const int n = Split ? 3 * in.W[0] + 4 * in.W[1] : 7 * in.W[0];
  const int n3 = Split ? 3 * in.W[0] : n;
  for (int i = 0; i < 2; ++i) {
    for (int k = lane; k < n3; k += lanes) w.win[i][k] = win[i][k * M + m];
    for (int k = lane; k < n - n3; k += lanes) w.win[i][n3 + k] = win_so3[i][k * M + m];
  }
  if (lane != 0) return;
  const T* u[2] = {c.u_ref, c.u_obs};
  const T* u_so3[2] = {c.u_ref_so3, c.u_obs_so3};
  for (int i = 0; i < 2; ++i) {
    w.u[i][0] = u[i][m];
    w.u[i][1] = Split ? u_so3[i][m] : T(0);
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

// Side i's sub-window bases at time shift s: the SE3 / R3 spline's and the
// SO3 spline's (split; 0 on SE3).
template <typename T, bool Split>
KT_HD void sub_bases(const NewtonWindows<T>& w, int i, const NewtonShape& sh, T s, int* j) {
  j[0] = sub_base<T>(w.u[i][0] + s / w.dt[0], sh.W[0]);
  j[1] = Split ? sub_base<T>(w.u[i][1] + s / w.dt[1], sh.W[1]) : 0;
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
// sub-window at bases j: B1's pq_se3 and pq_split on that sub-window, with
// the sub-window's 24 increments delta (values of SK: its R3 knots' 12,
// then its SO3 knots' 12, split) and the time shift s (ST: SK, or a time
// dual or Taylor2 of it). Split without Rot: p alone (out[0..2]).
template <typename T, bool Split, typename SK, typename ST, bool Lazy = false, bool Rot = true,
          typename D>
KT_HD void newton_pq_sub(const NewtonWindows<T>& w, int i, const NewtonShape& sh, const int* j,
                         const D& delta, const ST& s, ST* out) {
  const T* win = w.win[i];
  if (Split) {
    pq_split<T, ST, D, Lazy, SK, Rot>(win + 3 * j[0], win + 3 * sh.W[0] + 4 * j[1], w.u[i][0],
                                      w.u[i][1], w.dt[0], w.dt[1], delta, s, true, out, j[0],
                                      j[1]);
  } else {
    pq_se3<T, ST, D, Lazy, SK>(win + 7 * j[0], w.u[i][0], w.dt[0], delta, s, out, j[0]);
  }
}

// newton_pq_sub at the bases of s's value, with increments delta indexed
// over the side's Ct tangents.
template <typename T, bool Split, typename SK, typename ST, typename D>
KT_HD void newton_pq(const NewtonWindows<T>& w, int i, const NewtonShape& sh, const D& delta,
                     const ST& s, ST* out) {
  int j[2];
  sub_bases<T, Split>(w, i, sh, val(s), j);
  if (Split) {
    const SplitShifted<D> d = {delta, sh.off_r3 + 3 * j[0], sh.off_so3 + 3 * j[1]};
    newton_pq_sub<T, Split, SK, ST>(w, i, sh, j, d, s, out);
  } else {
    const Shifted<D> d = {delta, 6 * j[0]};
    newton_pq_sub<T, Split, SK, ST>(w, i, sh, j, d, s, out);
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

template <typename T, bool Atan, typename S>
KT_HD void newton_evaluate(const Row<T>& row, const V3<S>& X, const V3<S>& dX, S* y, S* dy) {
  if constexpr (Atan) {
    evaluate_atan<T, S>(row, X, dX, y, dy);
  } else {
    evaluate_pinhole<T, S>(row, X, dX, y, dy);
  }
}

// The step-independent part of the chain: the sensor pose q_ct, p_ct and
// rho with their increments dsen, drho, and the world point X from the ref
// side's (p, q) ur.
template <typename T, typename S>
KT_HD void newton_point(const Row<T>& row, const S* ur, const S* dsen, const S& drho, V3<S>& X,
                        Q4<S>& q_ct, V3<S>& p_ct, S& rho) {
  q_ct = qmul(so3_exp_quat(V3<S>{dsen[0], dsen[1], dsen[2]}),
              Q4<S>{S(row.q_ct[0]), S(row.q_ct[1]), S(row.q_ct[2]), S(row.q_ct[3])});
  p_ct = {row.p_ct[0] + dsen[3], row.p_ct[1] + dsen[4], row.p_ct[2] + dsen[5]};
  rho = row.rho + drho;
  const V3<S> a = {row.yh[0] - rho * p_ct.x, row.yh[1] - rho * p_ct.y, row.yh[2] - rho * p_ct.z};
  const V3<S> Xw = qrotate(Q4<S>{ur[3], ur[4], ur[5], ur[6]}, qrotate(qconj(q_ct), a));
  X = {Xw.x + rho * ur[0], Xw.y + rho * ur[1], Xw.z + rho * ur[2]};
}

// A step's head: from the obs side's (p, q) and its time derivative pq
// (TD<S>), the camera point X_cam and its derivative with the reference's
// constant offset, their projection y and dy. The step-independent part
// (newton_point) on P: S, or T where it carries no seeds.
template <typename T, bool Atan, typename S, typename P = S>
KT_HD void newton_head(const Row<T>& row, const V3<P>& X, const Q4<P>& q_ct, const V3<P>& p_ct,
                       const P& rho, const TD<S>* pq, S* y, S* dy) {
  using D2 = TD<S>;
  const Q4<D2> q_ct2 = {D2(q_ct.w), D2(q_ct.x), D2(q_ct.y), D2(q_ct.z)};
  const V3<D2> sv = {X.x - rho * pq[0], X.y - rho * pq[1], X.z - rho * pq[2]};
  const V3<D2> Xc = qrotate(q_ct2, qrotate(qconj(Q4<D2>{pq[3], pq[4], pq[5], pq[6]}), sv));
  const V3<S> Xcam = {Xc.x.a + rho * p_ct.x, Xc.y.a + rho * p_ct.y, Xc.z.a + rho * p_ct.z};
  // the reference's constant offset in the time derivative
  const V3<S> dXcam = {Xc.x.d + rho * p_ct.x, Xc.y.d + rho * p_ct.y, Xc.z.d + rho * p_ct.z};
  newton_evaluate<T, Atan, S>(row, Xcam, dXcam, y, dy);
}

// The Newton chain of a row in one forward pass on S: a Jet<T, N> over
// seeds k0 .. k0 + N - 1 of the NS (ref (p, q) 7, obs window Ct, sensor
// rotation and translation 6, inverse depth, time shift d), or a plain T.
// pq_ref is the ref side's primal (p, q). Writes r [2]; returns the steps
// taken. With margin (a check's), also the smallest |dt^2 - bound| / bound
// of the convergence tests the row took. The cost-only form's chain, and
// the operation count's (host_rows.cpp newton_row_wide).
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
  V3<S> X, p_ct;
  Q4<S> q_ct;
  S rho;
  newton_point<T, S>(row, ur, dsen, drho, X, q_ct, p_ct, rho);

  const T row_delta = row.readout / row.rows;
  const T half = T(0.5) * row_delta;
  const T max_dt2 = half * half;
  S t_rel = S(row.v_obs * row_delta);
  S y[2], dy[2];
  int steps = 0;
  for (;;) {
    D2 pq[7];
    newton_pq<T, Split, S, D2>(w, 1, sh, delta, D2(ds + t_rel, S(T(1))), pq);
    newton_head<T, Atan, S>(row, X, q_ct, p_ct, rho, pq, y, dy);
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

// Stage 0 of the cost-only form and of the operation count: the ref side's
// 4-knot sub-window at s = 0 into slot 0 of B1's Windows (knots j .. j + 3
// per spline, u - j), its bases j_ref.
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

// The ref block's column of B1's sub-window tangent k (of 24: the first
// spline's 12, then the second's; SE3 knots' 6 each), in B1's window order.
KT_HD int ref_column(const NewtonShape& sh, bool split, bool r3_first, const int* j_ref, int k) {
  if (!split) return 6 * j_ref[0] + k;
  const bool r3 = (k < 12) == r3_first;
  const int kk = k < 12 ? k : k - 12;
  return r3 ? sh.off_r3 + 3 * j_ref[0] + kk : sh.off_so3 + 3 * j_ref[1] + kk;
}

// A side's column (of Ct) of newton_pq_sub's local tangent l at bases j
// (split: the R3 knots' 12, then the SO3 knots' 12), and the inverse: the
// local tangent of column c, or -1 outside the sub-window.
template <bool Split>
KT_HD int side_column(const NewtonShape& sh, const int* j, int l) {
  if (!Split) return 6 * j[0] + l;
  return l < 12 ? sh.off_r3 + 3 * j[0] + l : sh.off_so3 + 3 * j[1] + l - 12;
}

template <bool Split>
KT_HD int local_tangent(const NewtonShape& sh, const int* j, int c) {
  if (!Split) {
    const int l = c - 6 * j[0];
    return l >= 0 && l < 24 ? l : -1;
  }
  const int lr = c - sh.off_r3 - 3 * j[0];
  if (lr >= 0 && lr < 12) return lr;
  const int lq = c - sh.off_so3 - 3 * j[1];
  return lq >= 0 && lq < 12 ? 12 + lq : -1;
}

// ---- the linearize form's row, in stages ---------------------------------

// A step's record from the primal path: the evaluation time e (= t, d at
// 0); the obs (p, q) and its e-derivative; the e-derivatives of y (true)
// and of the code's f'; f and f'; the obs sub-window bases and whether the
// update after the step clamped.
template <typename T>
struct NewtonStep {
  T e, pq[7], dpq[7], ey[2], efp, f, fp;
  short j[2], clamp;
};

// A row's primal path: its steps' records, the ref (p, q) and its bases,
// the steps taken. On the card the primal kernel leaves it in the row's
// slot of J, which holds it for every window of 4 knots or more (C >= 61).
template <typename T>
struct NewtonPath {
  NewtonStep<T> step[kNewtonSteps];
  T pq_ref[7];
  short j_ref[2], steps;
};

static_assert(sizeof(NewtonPath<double>) <= 2 * 61 * sizeof(double), "path in a row of J");
static_assert(sizeof(NewtonPath<float>) <= 2 * 61 * sizeof(float), "path in a row of J");

// Sub-window bases as the window code takes them.
struct Bases {
  int j[2];
  KT_HD explicit Bases(const short* s) : j{s[0], s[1]} {}
};

// A row's state in shared memory (the host's check: in its work buffer):
// its windows and constants, its primal path, the ref window's local
// Jacobian (24 knot tangents, then the time shift, by (p, q) component),
// the last step's J of the ref (p, q) seeds and of d.
template <typename T>
struct NewtonState {
  NewtonWindows<T> w;
  NewtonRow<T> row;
  NewtonPath<T> path;
  T Lref[25][7], JG7[7][2], JGs[2];
};

// Bytes of one row's state and its arrays sized by the shape: the two
// windows (2 win), the seeds' tangents tau (NS), a round's partials
// [kNewtonBatch][kNewtonPartials][2].
template <typename T>
KT_HD int newton_state_bytes() {
  return (static_cast<int>(sizeof(NewtonState<T>)) + 15) / 16 * 16;
}

template <typename T>
KT_HD int newton_group_bytes(const NewtonShape& sh) {
  const int n = 2 * sh.win + sh.NS + kNewtonBatch * kNewtonPartials * 2;
  return (newton_state_bytes<T>() + static_cast<int>(sizeof(T)) * n + 15) / 16 * 16;
}

// A row's arrays behind its state.
template <typename T>
struct NewtonArrays {
  T *win, *tau, *part;
};

template <typename T>
KT_HD NewtonArrays<T> newton_arrays(unsigned char* group, const NewtonShape& sh) {
  T* base = reinterpret_cast<T*>(group + newton_state_bytes<T>());
  return {base, base + 2 * sh.win, base + 2 * sh.win + sh.NS};
}

// Seeds a task's jet carries: the window chunks' knot tangents and the
// head chunks' seeds. A split window's first r3 chunks hold R3 knot
// tangents alone, which move p and not q: those run the R3 spline only.
template <bool Split>
struct NewtonLanes {
  static constexpr int N = Split ? 3 : 2;
  static constexpr int win = (24 + N - 1) / N;                  // window chunks
  static constexpr int head = (kNewtonHeadSeeds + N - 1) / N;   // head chunks
  static constexpr int r3 = Split ? 12 / N : 0;                 // R3-only window chunks
  static constexpr int rot = win - r3;                          // the others
  static_assert(!Split || 12 % N == 0, "a chunk holds R3 or SO3 tangents, not both");
};

// Stage 1 (one lane; on the card a kernel of its own, a row a thread): the
// primal path (see the top) of the row with windows w and constants row
// into path; r [2] (times valid).
template <typename T, bool Split, bool Atan>
KT_HD void newton_primal(const NewtonWindows<T>& w, const NewtonRow<T>& row,
                         const NewtonShape& sh, NewtonPath<T>& path, T* r_out) {
  using S2 = Taylor2<T>;
  const WindowSeeds<T, T> zero = {0};
  int j_ref[2];
  sub_bases<T, Split>(w, 0, sh, T(0), j_ref);
  path.j_ref[0] = static_cast<short>(j_ref[0]);
  path.j_ref[1] = static_cast<short>(j_ref[1]);
  newton_pq_sub<T, Split, T, T>(w, 0, sh, j_ref, zero, T(0), path.pq_ref);
  T dsen[6];
  for (int k = 0; k < 6; ++k) dsen[k] = T(0);
  V3<T> X, p_ct;
  Q4<T> q_ct;
  T rho;
  newton_point<T, T>(row, path.pq_ref, dsen, T(0), X, q_ct, p_ct, rho);
  const Q4<S2> q_ct2 = {S2(q_ct.w), S2(q_ct.x), S2(q_ct.y), S2(q_ct.z)};

  const T row_delta = row.readout / row.rows;
  const T half = T(0.5) * row_delta;
  const T max_dt2 = half * half;
  T t = row.v_obs * row_delta;
  T y[2];
  int steps = 0;
  for (;;) {
    NewtonStep<T>& s = path.step[steps];
    s.e = t;
    int j[2];
    sub_bases<T, Split>(w, 1, sh, t, j);
    s.j[0] = static_cast<short>(j[0]);
    s.j[1] = static_cast<short>(j[1]);
    S2 pq[7];
    newton_pq_sub<T, Split, T, S2>(w, 1, sh, j, zero, S2(t, T(1), T(0)), pq);
    // the head on Taylor2 in e: X_cam and its d/de, and the code's dX_cam
    // and its d/de, as time duals
    const V3<S2> sv = {X.x - rho * pq[0], X.y - rho * pq[1], X.z - rho * pq[2]};
    const V3<S2> Xc = qrotate(q_ct2, qrotate(qconj(Q4<S2>{pq[3], pq[4], pq[5], pq[6]}), sv));
    const V3<TD<T>> Xcam = {TD<T>(Xc.x.a + rho * p_ct.x, Xc.x.d),
                            TD<T>(Xc.y.a + rho * p_ct.y, Xc.y.d),
                            TD<T>(Xc.z.a + rho * p_ct.z, Xc.z.d)};
    const V3<TD<T>> dXcam = {TD<T>(Xc.x.d + rho * p_ct.x, Xc.x.e),
                             TD<T>(Xc.y.d + rho * p_ct.y, Xc.y.e),
                             TD<T>(Xc.z.d + rho * p_ct.z, Xc.z.e)};
    TD<T> yy[2], dy[2];
    newton_evaluate<T, Atan, TD<T>>(row, Xcam, dXcam, yy, dy);
    for (int k = 0; k < 7; ++k) {
      s.pq[k] = pq[k].a;
      s.dpq[k] = pq[k].d;
    }
    s.ey[0] = yy[0].d;
    s.ey[1] = yy[1].d;
    s.efp = dy[1].d;
    s.f = yy[1].a - row.rows * t / row.readout;
    s.fp = dy[1].a - row.rows / row.readout;
    s.clamp = 0;
    y[0] = yy[0].a;
    y[1] = yy[1].a;
    ++steps;
    const T dtn = s.f / s.fp;
    if (dtn * dtn < max_dt2 || steps == kNewtonSteps) break;
    t = t - dtn;
    if (t < T(0)) {
      t = T(0);
      s.clamp = 1;
    } else if (t > row.readout) {
      t = row.readout;
      s.clamp = 1;
    }
  }
  path.steps = static_cast<short>(steps);
  r_out[0] = row.weight * (row.uv[0] - y[0]) * row.valid;
  r_out[1] = row.weight * (row.uv[1] - y[1]) * row.valid;
}

// The tasks of round `round` (steps kNewtonBatch round .. of those taken):
// the ref window's chunks (round 0), each step's obs window chunks and
// each step's head chunks; newton_task orders them so that a pass of a
// warp holds tasks of one kind: the window chunks through the rotations
// (ref, then each step's obs), then the R3-only chunks (ref, then obs),
// then the heads.
template <typename T, bool Split>
KT_HD int newton_round_tasks(const NewtonState<T>& st, int round) {
  using K = NewtonLanes<Split>;
  int nk = st.path.steps - kNewtonBatch * round;
  nk = nk < 0 ? 0 : (nk > kNewtonBatch ? kNewtonBatch : nk);
  return (round == 0 ? K::win : 0) + nk * (K::win + K::head);
}

// Task t's kind (0 ref window, 1 obs window, 2 head), step of the round
// and chunk, in newton_round_tasks' order.
template <bool Split>
KT_HD void newton_task_of(int t, bool ref, int nk, int& kind, int& kb, int& chunk) {
  using K = NewtonLanes<Split>;
  // each group: its kind, its chunks (a step's, or the ref's once), the
  // first of them
  const int kinds[5] = {0, 1, 0, 1, 2};
  const int widths[5] = {K::rot, K::rot, K::r3, K::r3, K::head};
  const int first[5] = {K::r3, K::r3, 0, 0, 0};
  for (int g = 0; g < 5; ++g) {
    const int n = kinds[g] == 0 ? (ref ? widths[g] : 0) : nk * widths[g];
    if (t < n) {
      kind = kinds[g];
      kb = kinds[g] == 0 ? 0 : t / widths[g];
      chunk = first[g] + t % widths[g];
      return;
    }
    t -= n;
  }
}

// Stage 2: task t of round `round` on TD<Jet<T, N>> (see the top): the ref
// window's local Jacobian into st.Lref, or a step's partials into part
// [kNewtonBatch][kNewtonPartials][2] (obs local tangents 0-23, head seeds
// 24-37): of (y1, f') at a step that is not the last, of (y0, y1) at the
// last.
template <typename T, bool Split, bool Atan>
KT_HD void newton_task(NewtonState<T>& st, const NewtonShape& sh, T* part, int round, int t) {
  using K = NewtonLanes<Split>;
  constexpr int N = K::N;
  using S = Jet<T, N>;
  using D2 = TD<S>;
  const int ref = round == 0 ? K::win : 0;
  const int nk = (newton_round_tasks<T, Split>(st, round) - ref) / (K::win + K::head);
  int kind = 0, kb = 0, chunk = 0;
  newton_task_of<Split>(t, ref > 0, nk, kind, kb, chunk);
  const int k = kNewtonBatch * round + kb;
  const NewtonStep<T>& rec = st.path.step[k];
  D2 pq[7];
  if (kind != 2) {
    const SeededDelta<T, N> delta = {N * chunk, N};
    const D2 s = D2(S(kind == 0 ? T(0) : rec.e), S(T(1)));
    const Bases j(kind == 0 ? st.path.j_ref : rec.j);
    if (chunk < K::r3) {
      // R3 knot tangents: p through the R3 spline, q as it is (the ref's
      // q columns are zero, the obs step's q and its time derivative come
      // from its record)
      newton_pq_sub<T, Split, S, D2, true, false>(st.w, kind, sh, j.j, delta, s, pq);
      for (int c = 3; c < 7; ++c) {
        pq[c] = kind == 0 ? D2(S(T(0))) : D2(S(rec.pq[c]), S(rec.dpq[c]));
      }
    } else {
      newton_pq_sub<T, Split, S, D2, true>(st.w, kind, sh, j.j, delta, s, pq);
    }
  } else {
    for (int c = 0; c < 7; ++c) pq[c] = D2(S(rec.pq[c]), S(rec.dpq[c]));
  }
  if (kind == 0) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int l = N * chunk + i;
      if (l < 24) {
        for (int c = 0; c < 7; ++c) st.Lref[l][c] = pq[c].a.v[i];
      }
    }
    if (chunk == K::r3) {  // the first chunk through the rotations: the time shift's
      for (int c = 0; c < 7; ++c) st.Lref[24][c] = pq[c].d.a;
    }
    return;
  }
  S y[2], dy[2];
  if (kind == 1) {
    // an obs chunk: the head's own seeds carry no tangent here
    const T zero[6] = {T(0), T(0), T(0), T(0), T(0), T(0)};
    V3<T> X, p_ct;
    Q4<T> q_ct;
    T rho;
    newton_point<T, T>(st.row, st.path.pq_ref, zero, T(0), X, q_ct, p_ct, rho);
    newton_head<T, Atan, S, T>(st.row, X, q_ct, p_ct, rho, pq, y, dy);
  } else {
    // a head chunk: its seeds of the ref (p, q), the sensor and rho
    const int k0 = N * chunk;
    S ur[7], dsen[6];
    for (int c = 0; c < 7; ++c) ur[c] = seeded<T, N>(st.path.pq_ref[c], c - k0);
    for (int c = 0; c < 6; ++c) dsen[c] = seeded<T, N>(T(0), 7 + c - k0);
    const S drho = seeded<T, N>(T(0), 13 - k0);
    V3<S> X, p_ct;
    Q4<S> q_ct;
    S rho;
    newton_point<T, S>(st.row, ur, dsen, drho, X, q_ct, p_ct, rho);
    newton_head<T, Atan, S>(st.row, X, q_ct, p_ct, rho, pq, y, dy);
  }
  const bool last = k == st.path.steps - 1;
  const S& a0 = last ? y[0] : y[1];
  const S& a1 = last ? y[1] : dy[1];
  const int base = kind == 1 ? N * chunk : 24 + N * chunk;
  const int end = kind == 1 ? 24 : kNewtonPartials;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (base + i < end) {
      T* p = part + 2 * (kNewtonPartials * kb + base + i);
      p[0] = a0.v[i];
      p[1] = a1.v[i];
    }
  }
}

// Stage 3: seed i's tangent tau through round `round`'s steps (tau in
// shared memory between rounds) and, at the last step, its J: the ref (p,
// q) seeds' and d's into st (for stage 4), the others at their columns of
// the row's J tile [2, C] (and J_rho), times valid.
template <typename T, bool Split>
KT_HD void newton_seed_chain(NewtonState<T>& st, const NewtonShape& sh, const T* part, T* tau_s,
                             int round, int i, T* J, T* Jrho_out) {
  const NewtonRow<T>& row = st.row;
  const int ds = 14 + sh.Ct;
  T tau = round == 0 ? T(0) : tau_s[i];
  for (int kb = 0; kb < kNewtonBatch; ++kb) {
    const int k = kNewtonBatch * round + kb;
    if (k >= st.path.steps) break;
    const NewtonStep<T>& rec = st.path.step[k];
    int p = -1;  // the seed's partial of this step
    if (i < 7) {
      p = 24 + i;
    } else if (i < 7 + sh.Ct) {
      p = local_tangent<Split>(sh, Bases(rec.j).j, i - 7);
    } else if (i < ds) {
      p = 24 + 7 + (i - 7 - sh.Ct);
    }
    const T a0 = p >= 0 ? part[2 * (kNewtonPartials * kb + p)] : T(0);
    const T a1 = p >= 0 ? part[2 * (kNewtonPartials * kb + p) + 1] : T(0);
    const T eps = i == ds ? tau + T(1) : tau;  // e = d + t
    if (k == st.path.steps - 1) {
      const T v = row.valid;
      for (int rr = 0; rr < 2; ++rr) {
        const T Jv = row.weight * -((rr == 0 ? a0 : a1) + rec.ey[rr] * eps);
        if (i < 7) {
          st.JG7[i][rr] = Jv;
        } else if (i < 7 + sh.Ct) {
          J[rr * sh.C + i - 7 + sh.Ct] = Jv * v;
        } else if (i < 13 + sh.Ct) {
          J[rr * sh.C + 2 * sh.Ct + (i - 7 - sh.Ct)] = Jv * v;
        } else if (i == 13 + sh.Ct) {
          Jrho_out[rr] = Jv * v;
        } else {
          st.JGs[rr] = Jv;
        }
      }
    } else {
      const T df = (a0 + rec.ey[1] * eps) - row.rows * tau / row.readout;
      const T dfp = a1 + rec.efp * eps;
      const T dtn = rec.f / rec.fp;
      tau = rec.clamp ? T(0) : tau - (df - dtn * dfp) / rec.fp;
    }
  }
  tau_s[i] = tau;
}

// Stage 4, task e of 50: the ref block's column of local tangent e / 2 (of
// 24) of residual row e % 2, or (the 25th) the d column: J of the ref (p,
// q) seeds through the ref window's local Jacobian, times valid.
template <typename T, bool Split>
KT_HD void newton_ref_block(const NewtonState<T>& st, const NewtonShape& sh, int e, T* J) {
  const int l = e / 2, rr = e % 2;
  T acc = T(0);
  for (int c = 0; c < 7; ++c) acc = acc + st.JG7[c][rr] * st.Lref[l][c];
  if (l < 24) {
    J[rr * sh.C + side_column<Split>(sh, Bases(st.path.j_ref).j, l)] = acc * st.row.valid;
  } else {
    J[rr * sh.C + 2 * sh.Ct + 6] = (st.JGs[rr] + acc) * st.row.valid;
  }
}

// The stages of a row (newton_stage): load, primal path, kNewtonRounds
// rounds of local tiles and the chain, the ref block.
constexpr int kNewtonStages = 3 + 2 * kNewtonRounds;

// Lane `lane` of a row's group of `lanes` in stage `stage` on row m of in,
// its state st with its arrays a (in the caller's group memory), its J tile
// [2, C] and outputs r, J_rho [2]. With path (the card: the primal kernel's
// record of the row), stage 0 copies the row's primal path and stage 1 has
// nothing to do; without, stage 1 runs the primal path.
template <typename T, bool Split, bool Atan>
KT_HD void newton_stage(int stage, int lane, int lanes, const NewtonInputs<T>& in, int m,
                        const NewtonShape& sh, NewtonState<T>& st, const NewtonArrays<T>& a,
                        T* J, T* r_out, T* Jrho_out, const NewtonPath<T>* path = nullptr) {
  if (stage == 0) {
    // load (lane 0 into the row's state, the others' window values through
    // pointers of their own), and zero the ref block and the bias columns
    NewtonWindows<T> w;
    w.win[0] = a.win;
    w.win[1] = a.win + sh.win;
    if (lane == 0) {
      st.w.win[0] = w.win[0];
      st.w.win[1] = w.win[1];
    }
    load_newton_row<T, Split, Atan>(in, m, lane == 0 ? st.w : w, st.row, lane, lanes);
    if (path) {
      const int* src = reinterpret_cast<const int*>(path);
      int* dst = reinterpret_cast<int*>(&st.path);
      for (int e = lane; e < static_cast<int>(sizeof(NewtonPath<T>) / 4); e += lanes) {
        dst[e] = src[e];
      }
    }
    const int n = sh.Ct + 6;
    for (int e = lane; e < 2 * n; e += lanes) {
      const int rr = e / n, c = e % n;
      J[rr * sh.C + (c < sh.Ct ? c : 2 * sh.Ct + 7 + c - sh.Ct)] = T(0);
    }
  } else if (stage == 1) {
    if (lane == 0 && !path) newton_primal<T, Split, Atan>(st.w, st.row, sh, st.path, r_out);
  } else if (stage < 2 + 2 * kNewtonRounds) {
    const int round = (stage - 2) / 2;
    if (stage % 2 == 0) {
      const int n = newton_round_tasks<T, Split>(st, round);
      for (int t = lane; t < n; t += lanes) newton_task<T, Split, Atan>(st, sh, a.part, round, t);
    } else if (kNewtonBatch * round < st.path.steps) {
      for (int i = lane; i < sh.NS; i += lanes) {
        newton_seed_chain<T, Split>(st, sh, a.part, a.tau, round, i, J, Jrho_out);
      }
    }
  } else {
    for (int e = lane; e < 50; e += lanes) newton_ref_block<T, Split>(st, sh, e, J);
  }
}

constexpr int kNewtonLanes = 8;  // lanes a row

// Row m as the kernel's lane group computes it, the lanes of each stage one
// after the other, in group memory `work` (newton_group_bytes): the host's
// check of the kernel's schedule. Returns the Newton steps.
template <typename T, bool Split, bool Atan>
KT_HD int newton_row_lanes(const NewtonInputs<T>& in, int m, T* r_out, T* J_out, T* Jrho_out,
                           unsigned char* work, int lanes = kNewtonLanes) {
  const NewtonShape sh = newton_shape(in.W[0], in.W[1], in.cam.flags);
  NewtonState<T>& st = *reinterpret_cast<NewtonState<T>*>(work);
  const NewtonArrays<T> a = newton_arrays<T>(work, sh);
  T* J = J_out + static_cast<size_t>(m) * 2 * sh.C;
  for (int stage = 0; stage < kNewtonStages; ++stage) {
    for (int lane = 0; lane < lanes; ++lane) {
      newton_stage<T, Split, Atan>(stage, lane, lanes, in, m, sh, st, a, J, r_out + 2 * m,
                                   Jrho_out + 2 * m);
    }
  }
  return st.path.steps;
}

// Residual only of row m into r_out [2] (times valid): the ref sub-window's
// primal, then the chain on plain scalars. win: 2 NewtonShape::win values
// for the windows. Returns the Newton steps (and their tests' margin, as
// newton_chain's).
template <typename T, bool Split, bool Atan>
KT_HD int newton_cost_row(const NewtonInputs<T>& in, int m, T* r_out, T* win,
                          T* margin = nullptr) {
  const NewtonShape sh = newton_shape(in.W[0], in.W[1], in.cam.flags);
  const bool r3_first = (in.cam.flags & kNewtonR3First) != 0;
  NewtonWindows<T> w;
  w.win[0] = win;
  w.win[1] = win + sh.win;
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
constexpr int kNewtonRows = kNewtonThreads / kNewtonLanes;  // rows a block

// Shared memory of a linearize block: its rows' J tiles [rows, 2, C], then
// each row's group (state and arrays).
template <typename T>
KT_HD size_t newton_tiles_bytes(const NewtonShape& sh) {
  return (kNewtonRows * 2 * sh.C * sizeof(T) + 15) / 16 * 16;
}

template <typename T>
KT_HD size_t newton_smem_bytes(const NewtonShape& sh) {
  return newton_tiles_bytes<T>(sh) + kNewtonRows * static_cast<size_t>(newton_group_bytes<T>(sh));
}

// B8 linearize, after newton_path_kernel: a block of kNewtonRows rows,
// each on kNewtonLanes lanes of a warp (newton_stage), from the primal
// paths that kernel left in the rows' slots of J; the rows' J tiles are
// staged in shared memory and the block's tiles, contiguous in J, are
// written out together over those slots. Two blocks an SM: a task's
// window on TD<Jet<T, 3>> takes the 255 registers that allows.
template <typename T, bool Split, bool Atan>
__global__ void __launch_bounds__(kNewtonThreads, 2)
    newton_rows_kernel(NewtonInputs<T> in, T* r, T* J, T* J_rho) {
  extern __shared__ __align__(16) unsigned char smem[];
  const NewtonShape sh = newton_shape(in.W[0], in.W[1], in.cam.flags);
  T* tiles = reinterpret_cast<T*>(smem);
  const int grp = threadIdx.x / kNewtonLanes;
  const int lane = threadIdx.x % kNewtonLanes;
  const int m0 = blockIdx.x * kNewtonRows;
  const int m = m0 + grp;
  const bool live = m < in.cam.M;
  unsigned char* group = smem + newton_tiles_bytes<T>(sh) + grp * newton_group_bytes<T>(sh);
  NewtonState<T>& st = *reinterpret_cast<NewtonState<T>*>(group);
  const NewtonArrays<T> a = newton_arrays<T>(group, sh);
  T* tile = tiles + grp * 2 * sh.C;
  const NewtonPath<T>* path =
      reinterpret_cast<const NewtonPath<T>*>(J + static_cast<size_t>(m) * 2 * sh.C);
  for (int stage = 0; stage < kNewtonStages; ++stage) {
    if (live) {
      newton_stage<T, Split, Atan>(stage, lane, kNewtonLanes, in, m, sh, st, a, tile, r + 2 * m,
                                   J_rho + 2 * m, path);
    }
    __syncwarp();
  }
  __syncthreads();
  const int rows = in.cam.M - m0 < kNewtonRows ? in.cam.M - m0 : kNewtonRows;
  copy_out(tiles, J + static_cast<size_t>(m0) * 2 * sh.C, rows * 2 * sh.C);
}

constexpr int kNewtonCostThreads = 64;

KT_HD bool newton_wide(const NewtonShape& sh) { return sh.win > 7 * kNewtonLocalW; }

template <typename T>
size_t newton_thread_smem(const NewtonShape& sh) {
  return newton_wide(sh) ? kNewtonCostThreads * 2 * sh.win * sizeof(T) : 0;
}

// B8 cost-only: one row per thread (newton_cost_row).
template <typename T, bool Split, bool Atan, bool Wide>
__global__ void __launch_bounds__(kNewtonCostThreads) newton_cost_kernel(NewtonInputs<T> in,
                                                                        T* r) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int m = blockIdx.x * kNewtonCostThreads + threadIdx.x;
  if (m >= in.cam.M) return;
  T local[Wide ? 1 : 2 * 7 * kNewtonLocalW];
  T* win = local;
  if constexpr (Wide) {
    const int n = newton_shape(in.W[0], in.W[1], in.cam.flags).win;
    win = reinterpret_cast<T*>(smem) + static_cast<size_t>(threadIdx.x) * 2 * n;
  }
  newton_cost_row<T, Split, Atan>(in, m, r + 2 * m, win);
}

// B8 linearize, first kernel: the primal path of one row a thread
// (newton_primal, the linearize schedule's stage 1), all rows at once
// rather than one lane of each lane group, wave after wave; writes r and
// leaves the path in the row's slot of J for newton_rows_kernel.
template <typename T, bool Split, bool Atan, bool Wide>
__global__ void __launch_bounds__(kNewtonCostThreads) newton_path_kernel(NewtonInputs<T> in,
                                                                        T* r, T* J) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int m = blockIdx.x * kNewtonCostThreads + threadIdx.x;
  if (m >= in.cam.M) return;
  const NewtonShape sh = newton_shape(in.W[0], in.W[1], in.cam.flags);
  T local[Wide ? 1 : 2 * 7 * kNewtonLocalW];
  NewtonWindows<T> w;
  w.win[0] = local;
  if constexpr (Wide) {
    w.win[0] = reinterpret_cast<T*>(smem) + static_cast<size_t>(threadIdx.x) * 2 * sh.win;
  }
  w.win[1] = w.win[0] + sh.win;
  NewtonRow<T> row;
  load_newton_row<T, Split, Atan>(in, m, w, row);
  newton_primal<T, Split, Atan>(
      w, row, sh, *reinterpret_cast<NewtonPath<T>*>(J + static_cast<size_t>(m) * 2 * sh.C),
      r + 2 * m);
}

// Raise a kernel's dynamic shared memory limit to `bytes` where that is
// above the default 48 KB.
template <typename K>
void newton_allow_smem(K kernel, size_t bytes) {
  if (bytes > 48 * 1024) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(bytes));
  }
}

// Shared memory a linearize block needs for these window widths.
template <typename T>
size_t newton_linearize_smem(int W0, int W1, int flags) {
  return newton_smem_bytes<T>(newton_shape(W0, W1, flags));
}

// Rows B8's linearize kernel holds on the card at once, for these window
// widths (its shared memory grows with W).
template <typename T, bool Atan>
int newton_wave(int W0, int W1, int flags) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const size_t smem = newton_linearize_smem<T>(W0, W1, flags);
  if (flags & kNewtonSplit) {
    newton_allow_smem(newton_rows_kernel<T, true, Atan>, smem);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, newton_rows_kernel<T, true, Atan>,
                                                  kNewtonThreads, smem);
  } else {
    newton_allow_smem(newton_rows_kernel<T, false, Atan>, smem);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, newton_rows_kernel<T, false, Atan>,
                                                  kNewtonThreads, smem);
  }
  return sms * (per_sm > 0 ? per_sm : 1) * kNewtonRows;
}

// B8's kernels on one window kind and window width class: the cost-only
// kernel (J == nullptr), or the primal kernel and then the lane kernel.
template <typename T, bool Split, bool Atan, bool Wide>
void launch_newton_kind(const NewtonInputs<T>& in, const NewtonShape& sh, T* r, T* J, T* J_rho,
                        cudaStream_t st) {
  const int M = in.cam.M;
  const int thread_blocks = (M + kNewtonCostThreads - 1) / kNewtonCostThreads;
  const size_t thread_smem = newton_thread_smem<T>(sh);
  if (J == nullptr) {
    newton_allow_smem(newton_cost_kernel<T, Split, Atan, Wide>, thread_smem);
    newton_cost_kernel<T, Split, Atan, Wide>
        <<<thread_blocks, kNewtonCostThreads, thread_smem, st>>>(in, r);
    return;
  }
  newton_allow_smem(newton_path_kernel<T, Split, Atan, Wide>, thread_smem);
  newton_path_kernel<T, Split, Atan, Wide>
      <<<thread_blocks, kNewtonCostThreads, thread_smem, st>>>(in, r, J);
  const size_t smem = newton_smem_bytes<T>(sh);
  newton_allow_smem(newton_rows_kernel<T, Split, Atan>, smem);
  newton_rows_kernel<T, Split, Atan>
      <<<(M + kNewtonRows - 1) / kNewtonRows, kNewtonThreads, smem, st>>>(in, r, J, J_rho);
}

// Launch B8 (J == nullptr: the cost-only form) on one camera, on the
// flags' window kind; returns cudaGetLastError().
template <typename T, bool Atan>
int launch_newton(const void* const* ins, void* r, void* J, void* J_rho, int M, int W0,
                  int W1, int flags, void* stream) {
  const NewtonInputs<T> in = make_newton_inputs<T>(ins, M, W0, W1, flags);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const NewtonShape sh = newton_shape(W0, W1, flags);
  T *rp = static_cast<T*>(r), *Jp = static_cast<T*>(J), *Jr = static_cast<T*>(J_rho);
  const bool split = (flags & kNewtonSplit) != 0, wide = newton_wide(sh);
  if (split) {
    if (wide) {
      launch_newton_kind<T, true, Atan, true>(in, sh, rp, Jp, Jr, st);
    } else {
      launch_newton_kind<T, true, Atan, false>(in, sh, rp, Jp, Jr, st);
    }
  } else if (wide) {
    launch_newton_kind<T, false, Atan, true>(in, sh, rp, Jp, Jr, st);
  } else {
    launch_newton_kind<T, false, Atan, false>(in, sh, rp, Jp, Jr, st);
  }
  return static_cast<int>(cudaGetLastError());
}

#endif  // __CUDACC__

}  // namespace
