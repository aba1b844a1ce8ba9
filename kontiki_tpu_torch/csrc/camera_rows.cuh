// Camera rows for Hopper (sm_90a): the per-row code of kernels B1
// linearize_rows and B3 cost_rows, and their kernels, shared by
// linearize_rows.cu (pinhole camera) and linearize_rows_atan.cu (atan
// camera), and compiled for the host by host_rows.cpp.
//
//  - B1 linearize_rows: residual, compressed Jacobian and landmark column.
//    Replaces the Pallas TPU kernel kontiki_tpu/ops/linearize_kernels.py
//    linearize_rows -> _linearize_call / _tile_linearize.
//  - B3 cost_rows: the residual only (the LM re-cost), each window's pose
//    at u on the chain of window_chain.cuh, which B5 shares. Replaces
//    cost_rows -> _cost_only_call / _tile_cost.
// Their plain PyTorch versions are kontiki_tpu_torch/ops/linearize_kernels.py
// linearize_rows_plain and cost_rows_plain, which the wrappers run for CPU
// tensors. Rows with valid = 0 give zeros. A row is never padded (the TPU
// kernels pad divisors with 1.0 to a 128-row tile): a group of lanes or a
// thread past the last row idles.
//
// Branches, template parameters of the row code and the kernels, chosen by
// the C entry points' flags:
//  - window: a cumulative SE3 spline's 4 knots (right increments
//    (q exp(w), t + R(q) V(w) v)) or, Split, the R3 spline's 4 knots
//    (linear, additive increments) and the SO3 spline's 4 knots
//    (cumulative, left exp increments, relative knots' log in atan2 form),
//    each at its own u and dt; the 24 window seeds are the first spline's
//    12, then the second's;
//  - camera: pinhole (K X hnormalized) or, Atan, the Devernay-Faugeras FOV
//    model (f = atan(r gamma) / gamma about the distortion centre wc, CUDA's
//    atan; the 1e-32 in X.z and under the norm keeps the derivative at the
//    centre 0 / r, not NaN);
//  - rows: static (rdim 2, C 61) or, Lifting, the row time lifted to a
//    parameter vt: the observed window comes evaluated at
//    t0_obs + d + vt0 readout (the host gathers it there), a 22nd residual
//    seed dvt and a third residual w rows (vt - vt_orig), and the vt column
//    J_vt = dG/dvt + (dG/du_obs dW_obs/dt) readout (rdim 3, C 62).
//
// B1 design: forward mode carried explicitly in Jet<T, N> dual numbers
// (jet.cuh), the way ceres::Jet differentiates the reference, in stages:
//   1. primal (p, q) of the ref and obs windows (row_primal);
//   2. the projection residual over 21 seeds (p, q of ref and obs, sensor
//      rotation and translation, inverse depth) and, lifting, dvt, in
//      chunks of N2 = 7 (row_residual): the lifting rows' 22nd seed takes a
//      fourth chunk of the same width;
//   3. each window in forward mode over 25 seeds (24 knot tangents + the
//      time shift s, u_eff = u + s/dt), each chunk's tangents chained
//      through the (p, q) bottleneck at once and written out (row_window),
//      so no window Jacobian is kept;
// then the sensor block [q_ct(3), p_ct(3), d = t_ref + t_obs, biases = 0],
// where t_ref and t_obs are the residual's derivatives through each
// window's time shift; the lifting vt column reuses t_obs (row_finish).
// Two kernels, chosen by M (launch_linearize):
//  - lane groups, while one row per thread would not fill the card (configs
//    3 and 4: 3,837-12,304 rows): a row runs on a group of lanes of a warp
//    (32 on SE3, 16 split; Lanes), the row's inputs and each stage's
//    results (RowStages) in shared memory, the lanes of a stage the same
//    instructions on different seeds in narrow jets (seed chunks of 2 on
//    SE3 and 3 split, each window chunk with the time shift), so a row's
//    latency is one pass per stage; the group stages its J row in shared
//    memory, and the block writes its rows, which are contiguous in J,
//    with 16-byte stores;
//  - one row per thread from a full wave on (config 5: 500,000 rows), the
//    stages in sequence in seed chunks of 5 (windows) and 7 (residual),
//    every lane busy in every stage.
// In both, a window's increments are made as the chain reads them
// (SeededDelta) and its knots incremented as the chain reaches them (Lazy),
// so one knot's jets are held at a time. The host runs the lane schedule lane
// after lane (linearize_row_lanes) and the stages in chunks
// (linearize_row: N1 = 5, N2 = 7, or one full-width jet each).
//
// B1 bound: an SE3 row reads 82 values (pinhole static; 3 more atan, 4 more
// lifting; split rows 3 more) and writes 126 (192 lifting), ~1.7 KB in
// f64, and the function needs ~27 k float64 operations on SE3
// (csrc/host_rows.cpp counts them): at config 4's 12,304 rows, ~6 us of
// bytes and ~5 us of operations at 67 TFLOP/s.
// The kernel's time is set by arithmetic latency and registers instead:
// the window chain (trig, sqrt, atan) and the residual chain in jets.
// One thread per row with every window increment made up front (the first
// port) spilled in f64 (SE3: 255 registers, 5.7 KB) and ran a chain of 13
// jet passes per row, too few rows to fill the card at configs 3 and 4.
// Seed chunks keep the live jets small (a 25-wide jet would need ~50
// registers per value); the price is re-running the primal chain once per
// chunk.
//
// B3 design: the windows' poses at u with no increments, on the chain of
// window_chain.cuh that B5 runs too: the knot pairs (knot-only) and their
// factors at B(u), then the products from knot 0 (pair_factor,
// window_products), then B1's residual_G on plain scalars (cost_residual).
// B1's chain would multiply each knot by exp(0) and carry zero increments
// through V and exp; with none, split rows give B1's r bit for bit and SE3
// rows to rounding (the tail's products regrouped). A row reads 82-93
// values and writes 2 or 3 (~0.7 KB in f64) and needs ~1 k operations:
// bytes bound it on paper, the latency of the f64 transcendentals (~30 a
// row) in practice. Two kernels, chosen by M (launch_cost):
//  - lane groups while the rows fit one wave of them (configs 3, 3-atan(-
//    lifting) and 4: 3,837-12,304 rows, where one row a thread fills 30-97
//    blocks): a row on kB3Group lanes; lanes 0-5 run the 2 x 3 knot pairs
//    and their factors, lanes 0-1 the two windows' products, lane 0 the
//    residual, handing over in shared memory, so a row's latency is one
//    pair, one tail and the residual (cost_stage). Registers are capped at
//    80 so that 12,304 rows fit one wave; past one wave a second pass of
//    lane groups costs more than the thread kernel's whole chain (measured
//    crossover on an H100 between 12,182 and 15,348 rows);
//  - one row per thread beyond (config 5: 500,000 rows), every lane busy,
//    registers capped at 128 for four blocks an SM
//    (cost_rows_thread_kernel).
// Both read the inputs from global memory as the chain needs them: staging
// a block's inputs in shared memory first (coalesced cp.async copies of the
// [k, M] slices) measured slower in both, by ~4 us a launch in the lane
// kernel (the block waits for every copy before its first pair) and by 2%
// at 500,000 rows (shared memory cuts the blocks an SM holds).
// The host runs both schedules (host_rows.cpp: the lane schedule lane
// after lane).
#pragma once

#include "window_chain.cuh"

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

namespace {

constexpr int kC = 61;            // static columns: 24 ref | 24 obs | 13 sensor
constexpr int kN1 = 5;            // window seed chunk, one row per thread (25 = 5 x 5)
constexpr int kN2 = 7;            // residual seed chunk, one row per thread (21 = 3 x 7)
constexpr double kEpsP = 1e-32;   // projection guard (camera_models._EPS)

// flags of the C entry points
constexpr int kCamSplit = 1;      // split R3 + SO3 windows (else SE3)
constexpr int kCamR3First = 2;    // split: the R3 spline comes first
constexpr int kCamAtan = 4;       // atan camera (else pinhole)
constexpr int kCamLifting = 8;    // lifting rows (else static)

// Residual rows, Jacobian columns and residual seeds of a row kind.
template <bool Lifting>
struct RowShape {
  static constexpr int R = Lifting ? 3 : 2;
  static constexpr int C = kC + (Lifting ? 1 : 0);
  static constexpr int NS = 21 + (Lifting ? 1 : 0);
};

// Split window (p, q): the R3 spline at u_r3 + s/dt_r3 (win [4, 3], knots
// additive) and the cumulative SO3 spline at u_so3 + s/dt_so3 (win_so3
// [4, 4], knots left exp(w) q). delta holds the first spline's 12
// increments, then the second's. SK and the sub-window's first knots jr
// and jq as pq_se3's SK and j0. Without Rot only p (out[0..2]).
template <typename T, typename S, typename D, bool Lazy = false, typename SK = S,
          bool Rot = true>
KT_HD void pq_split(const T* win, const T* win_so3, T u_r3, T u_so3, T dt_r3, T dt_so3,
                    const D& delta, const S& s, bool r3_first, S* out, int jr = 0,
                    int jq = 0) {
  const int off_r3 = r3_first ? 0 : 12;
  const int off_so3 = r3_first ? 12 : 0;

  S ur = u_r3 + s / dt_r3;
  if (jr != 0) ur = ur - T(jr);
  S Br[4];
  standard_basis<T>(ur, Br);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    S acc = Br[0] * (win[k] + delta[off_r3 + k]);
#pragma unroll
    for (int j = 1; j < 4; ++j) acc = acc + Br[j] * (win[3 * j + k] + delta[off_r3 + 3 * j + k]);
    out[k] = acc;
  }
  if constexpr (!Rot) return;

  // knot j of the SO3 spline with its increment; Lazy as for pq_se3
  auto knot = [&](int j) {
    const T* w = win_so3 + 4 * j;
    const Q4<SK> qj = {SK(w[0]), SK(w[1]), SK(w[2]), SK(w[3])};
    const V3<SK> dw = {delta[off_so3 + 3 * j], delta[off_so3 + 3 * j + 1],
                       delta[off_so3 + 3 * j + 2]};
    return qmul(so3_exp_quat(dw), qj);
  };
  Q4<SK> kq[4];
#pragma unroll
  for (int j = 0; j < (Lazy ? 1 : 4); ++j) kq[j] = knot(j);
  S uq = u_so3 + s / dt_so3;
  if (jq != 0) uq = uq - T(jq);
  const S q2 = uq * uq;
  const S q3 = q2 * uq;
  const S B[3] = {(T(5) + T(3) * uq - T(3) * q2 + q3) / T(6),
                  (T(1) + T(3) * uq + T(3) * q2 - T(2) * q3) / T(6),
                  q3 / T(6)};
  Q4<S> q = {S(kq[0].w), S(kq[0].x), S(kq[0].y), S(kq[0].z)};
#pragma unroll
  for (int j = 1; j < 4; ++j) {
    if (Lazy) kq[j] = knot(j);
    const V3<SK> w3 = logq_vec(qmul(qconj(kq[j - 1]), kq[j]));
    const S b = B[j - 1];
    q = qmul(q, expq_pure(V3<S>{b * w3.x, b * w3.y, b * w3.z}));
  }
  out[3] = q.w; out[4] = q.x; out[5] = q.y; out[6] = q.z;
}

// The two windows of a row: SE3 knots (7 x 4) or R3 (3 x 4) then SO3 (4 x 4)
// knots; u of the SE3 / R3 spline and of the SO3 spline; knot spacings.
template <typename T>
struct Windows {
  T win[2][28], u[2][2], dt[2];
};

// (p, q) of window i (0 ref, 1 obs) with increments delta and time shift s.
template <typename T, bool Split, typename S, bool Lazy = false, typename D>
KT_HD void window_pq(const Windows<T>& w, int i, bool r3_first, const D& delta,
                     const S& s, S* out) {
  if (Split) {
    pq_split<T, S, D, Lazy>(w.win[i], w.win[i] + 12, w.u[i][0], w.u[i][1], w.dt[0], w.dt[1],
                            delta, s, r3_first, out);
  } else {
    pq_se3<T, S, D, Lazy>(w.win[i], w.u[i][0], w.dt[0], delta, s, out);
  }
}

// A row's constants; wc and gamma are read for the atan camera, vt0,
// vt_orig, rows and readout for lifting rows.
template <typename T>
struct Row {
  T q_ct[4], p_ct[3], rho, yh[3], uv[2], weight, K[9], valid;
  T wc[2], gamma;
  T vt0, vt_orig, rows, readout;
};

// Pinhole projection: K X hnormalized.
template <typename T, typename S>
KT_HD void project_pinhole(const Row<T>& row, const V3<S>& X, S* y) {
  const S px = row.K[0] * X.x + row.K[1] * X.y + row.K[2] * X.z;
  const S py = row.K[3] * X.x + row.K[4] * X.y + row.K[5] * X.z;
  const S pz = row.K[6] * X.x + row.K[7] * X.y + row.K[8] * X.z;
  y[0] = px / pz;
  y[1] = py / pz;
}

// Devernay-Faugeras FOV projection (camera_models.atan_project): about the
// distortion centre wc, f = atan(r gamma) / gamma, then K (wc + f L / r, 1).
template <typename T, typename S>
KT_HD void project_atan(const Row<T>& row, const V3<S>& X, S* y) {
  const S Az = X.z + T(kEpsP);
  const S L0 = X.x / Az - row.wc[0];
  const S L1 = X.y / Az - row.wc[1];
  const S r = kt_sqrt(L0 * L0 + L1 * L1 + T(kEpsP));
  const S f = kt_atan(r * row.gamma) / row.gamma;
  const S Y0 = row.wc[0] + f * (L0 / r);
  const S Y1 = row.wc[1] + f * (L1 / r);
  y[0] = row.K[0] * Y0 + row.K[1] * Y1 + row.K[2];
  y[1] = row.K[3] * Y0 + row.K[4] * Y1 + row.K[5];
}

// Projection residual through the (p, q) bottleneck: r[0..1] the pixel
// residual and, lifting, r[2] = w rows (vt0 + dvt - vt_orig).
template <typename T, typename S, bool Atan, bool Lifting>
KT_HD void residual_G(const Row<T>& row, const S* ur, const S* uo,
                      const S* dsen, const S& drho, const S& dvt, S* r) {
  const V3<S> p_ref = {ur[0], ur[1], ur[2]};
  const Q4<S> q_ref = {ur[3], ur[4], ur[5], ur[6]};
  const V3<S> p_obs = {uo[0], uo[1], uo[2]};
  const Q4<S> q_obs = {uo[3], uo[4], uo[5], uo[6]};
  const Q4<S> q_ct0 = {S(row.q_ct[0]), S(row.q_ct[1]), S(row.q_ct[2]), S(row.q_ct[3])};
  const Q4<S> q_ct = qmul(so3_exp_quat(V3<S>{dsen[0], dsen[1], dsen[2]}), q_ct0);
  const V3<S> p_ct = {row.p_ct[0] + dsen[3], row.p_ct[1] + dsen[4], row.p_ct[2] + dsen[5]};
  const S rho = row.rho + drho;

  const V3<S> a = {row.yh[0] - rho * p_ct.x, row.yh[1] - rho * p_ct.y,
                   row.yh[2] - rho * p_ct.z};
  const V3<S> Xw = qrotate(q_ref, qrotate(qconj(q_ct), a));
  const V3<S> X = {Xw.x + rho * p_ref.x, Xw.y + rho * p_ref.y, Xw.z + rho * p_ref.z};
  const V3<S> b = {X.x - rho * p_obs.x, X.y - rho * p_obs.y, X.z - rho * p_obs.z};
  const V3<S> Xc = qrotate(q_ct, qrotate(qconj(q_obs), b));
  const V3<S> Xcam = {Xc.x + rho * p_ct.x, Xc.y + rho * p_ct.y, Xc.z + rho * p_ct.z};
  S y[2];
  if constexpr (Atan) {
    project_atan<T, S>(row, Xcam, y);
  } else {
    project_pinhole<T, S>(row, Xcam, y);
  }
  r[0] = row.weight * (row.uv[0] - y[0]);
  r[1] = row.weight * (row.uv[1] - y[1]);
  if constexpr (Lifting) {
    r[2] = row.weight * row.rows * ((row.vt0 + dvt) - row.vt_orig);
  }
}

// Inputs are [k, M] arrays (component k of row m at k * M + m), in the
// order of the C entry points' pointer array. SE3 rows use win_ref/win_obs
// [28] and dts [1]; split rows win_ref/win_obs for the R3 windows [12],
// win_*_so3 [16], u_*_so3 and dts [2] (R3, SO3). wc [2] and gamma are read
// for the atan camera, vt0, vt_orig, rows and readout for lifting rows;
// valid may be null.
template <typename T>
struct Inputs {
  const T *win_ref, *win_ref_so3, *u_ref, *u_ref_so3, *win_obs, *win_obs_so3,
      *u_obs, *u_obs_so3, *dts, *q_ct, *p_ct, *rho, *yh_ref, *uv_obs, *weight, *K,
      *wc, *gamma, *vt0, *vt_orig, *rows, *readout, *valid;
  int M, flags;
};

constexpr int kCameraSlots = 23;

template <typename T>
KT_HD Inputs<T> make_inputs(const void* const* p, int M, int flags) {
  Inputs<T> in;
  const T** slots[kCameraSlots] = {
      &in.win_ref, &in.win_ref_so3, &in.u_ref, &in.u_ref_so3, &in.win_obs,
      &in.win_obs_so3, &in.u_obs, &in.u_obs_so3, &in.dts, &in.q_ct, &in.p_ct,
      &in.rho, &in.yh_ref, &in.uv_obs, &in.weight, &in.K, &in.wc, &in.gamma,
      &in.vt0, &in.vt_orig, &in.rows, &in.readout, &in.valid};
  for (int i = 0; i < kCameraSlots; ++i) *slots[i] = static_cast<const T*>(p[i]);
  in.M = M;
  in.flags = flags;
  return in;
}

// The row constants of row m (Row<T>).
template <typename T, bool Atan, bool Lifting>
KT_HD void load_consts(const Inputs<T>& in, int m, Row<T>& row) {
  const int M = in.M;
  for (int k = 0; k < 4; ++k) row.q_ct[k] = in.q_ct[k * M + m];
  for (int k = 0; k < 3; ++k) {
    row.p_ct[k] = in.p_ct[k * M + m];
    row.yh[k] = in.yh_ref[k * M + m];
  }
  row.rho = in.rho[m];
  row.uv[0] = in.uv_obs[m];
  row.uv[1] = in.uv_obs[M + m];
  row.weight = in.weight[m];
  for (int k = 0; k < 9; ++k) row.K[k] = in.K[k * M + m];
  row.valid = in.valid ? in.valid[m] : T(1);
  if constexpr (Atan) {
    row.wc[0] = in.wc[m];
    row.wc[1] = in.wc[M + m];
    row.gamma = in.gamma[m];
  }
  if constexpr (Lifting) {
    row.vt0 = in.vt0[m];
    row.vt_orig = in.vt_orig[m];
    row.rows = in.rows[m];
    row.readout = in.readout[m];
  }
}

template <typename T, bool Split, bool Atan, bool Lifting>
KT_HD void load_row(const Inputs<T>& in, int m, Windows<T>& w, Row<T>& row) {
  const int M = in.M;
  const T* win[2] = {in.win_ref, in.win_obs};
  const T* win_so3[2] = {in.win_ref_so3, in.win_obs_so3};
  const T* u[2] = {in.u_ref, in.u_obs};
  const T* u_so3[2] = {in.u_ref_so3, in.u_obs_so3};
  for (int i = 0; i < 2; ++i) {
    if (Split) {
      for (int k = 0; k < 12; ++k) w.win[i][k] = win[i][k * M + m];
      for (int k = 0; k < 16; ++k) w.win[i][12 + k] = win_so3[i][k * M + m];
      w.u[i][1] = u_so3[i][m];
    } else {
      for (int k = 0; k < 28; ++k) w.win[i][k] = win[i][k * M + m];
      w.u[i][1] = T(0);
    }
    w.u[i][0] = u[i][m];
  }
  w.dt[0] = in.dts[m];
  w.dt[1] = Split ? in.dts[M + m] : w.dt[0];
  load_consts<T, Atan, Lifting>(in, m, row);
}

// What a row's stages hand on: the primal (p, q) of both windows, the
// residual's seed columns JG and value r, and the residual's derivatives t
// through each window's time shift (t_ref, t_obs).
template <typename T, bool Lifting>
struct RowStages {
  static constexpr int R = RowShape<Lifting>::R;
  static constexpr int NS = RowShape<Lifting>::NS;
  T pq[2][7], JG[NS][R], r[R], t[2][R];
};

// Stage 1: the primal (p, q) of window i (0 ref, 1 obs).
template <typename T, bool Split>
KT_HD void row_primal(const Windows<T>& w, int i, bool r3_first, T* pq) {
  T zero[24];
  for (int k = 0; k < 24; ++k) zero[k] = T(0);
  const T zs = T(0);
  window_pq<T, Split, T>(w, i, r3_first, zero, zs, pq);
}

// Stage 2: the residual over its seed chunk c of width N2 (seeds N2 c ..
// N2 c + N2 - 1 of the NS: p, q of ref and obs, sensor rotation and
// translation, inverse depth and, lifting, dvt) into JG; chunk 0 also
// writes r.
template <typename T, bool Atan, bool Lifting, int N2>
KT_HD void row_residual(const Row<T>& row, RowStages<T, Lifting>& st, int c) {
  constexpr int R = RowShape<Lifting>::R;
  constexpr int NS = RowShape<Lifting>::NS;
  using S = Jet<T, N2>;
  const int s0 = N2 * c;
  S ur[7], uo[7], dsen[6], out[R];
  for (int k = 0; k < 7; ++k) {
    ur[k] = seeded<T, N2>(st.pq[0][k], k - s0);
    uo[k] = seeded<T, N2>(st.pq[1][k], 7 + k - s0);
  }
  for (int k = 0; k < 6; ++k) dsen[k] = seeded<T, N2>(T(0), 14 + k - s0);
  const S drho = seeded<T, N2>(T(0), 20 - s0);
  const S dvt = seeded<T, N2>(T(0), 21 - s0);
  residual_G<T, S, Atan, Lifting>(row, ur, uo, dsen, drho, dvt, out);
#pragma unroll
  for (int i = 0; i < N2; ++i) {
    if (s0 + i < NS) {
      for (int rr = 0; rr < R; ++rr) st.JG[s0 + i][rr] = out[rr].v[i];
    }
  }
  if (c == 0) {
    for (int rr = 0; rr < R; ++rr) st.r[rr] = out[rr].a;
  }
}

// A window's 24 increments in a seed chunk, each made when it is read (so
// the window chain holds one knot's at a time): increment k carries
// tangent 1 in slot k - k0 for k0 <= k < k0 + Per, none otherwise.
template <typename T, int N>
struct SeededDelta {
  int k0, per;
  KT_HD Jet<T, N> operator[](int k) const {
    return seeded<T, N>(T(0), (k >= k0 && k < k0 + per) ? k - k0 : -1);
  }
};

// Stage 3: window i in forward mode over its seed chunk c in one Jet<T, N1>:
// the knot tangents Per c .. Per c + Per - 1 (of 24) and the time shift s
// (u_eff = u + s/dt), in the last slot when N1 > Per (every chunk carries
// it; chunk 0 keeps it), else as seed 24 of the chunk that reaches it. The
// tangents are chained through the (p, q) bottleneck with JG and written,
// times v, into the row's J [R, C]; the time shift's into t[i].
template <typename T, bool Split, bool Lifting, int N1, int Per>
KT_HD void row_window(const Windows<T>& w, int i, int c, bool r3_first,
                      RowStages<T, Lifting>& st, T v, T* J) {
  constexpr int R = RowShape<Lifting>::R;
  constexpr int C = RowShape<Lifting>::C;
  using S = Jet<T, N1>;
  const int k0 = Per * c;
  const SeededDelta<T, N1> delta = {k0, Per};
  const S s = seeded<T, N1>(T(0), N1 > Per ? Per : 24 - k0);
  S out[7];
  window_pq<T, Split, S, true>(w, i, r3_first, delta, s, out);
#pragma unroll
  for (int j = 0; j < N1; ++j) {
    const int sd = j < Per ? k0 + j : 24;
    if (sd > 24 || (j >= Per && c != 0)) continue;
    for (int rr = 0; rr < R; ++rr) {
      T acc = T(0);
      for (int k = 0; k < 7; ++k) acc = acc + st.JG[7 * i + k][rr] * out[k].v[j];
      if (sd < 24) {
        J[rr * C + 24 * i + sd] = acc * v;
      } else {
        st.t[i][rr] = acc;
      }
    }
  }
}

// The row's remaining outputs, after stages 1-3: the sensor block
// [q_ct(3), p_ct(3), d = t_ref + t_obs, biases = 0] and, lifting, the vt
// column of J [R, C], and r [R], J_rho [R], all times valid.
template <typename T, bool Lifting>
KT_HD void row_finish(const Row<T>& row, const RowStages<T, Lifting>& st, T* J, T* r_out,
                      T* Jrho_out) {
  constexpr int R = RowShape<Lifting>::R;
  constexpr int C = RowShape<Lifting>::C;
  const T v = row.valid;
  for (int rr = 0; rr < R; ++rr) {
    for (int j = 0; j < 6; ++j) J[rr * C + 48 + j] = st.JG[14 + j][rr] * v;
    J[rr * C + 54] = (st.t[0][rr] + st.t[1][rr]) * v;
    for (int j = 55; j < kC; ++j) J[rr * C + j] = T(0);
    if constexpr (Lifting) {
      // the row time moves the obs window: dW_obs/dvt = dW_obs/dt readout
      J[rr * C + kC] = (st.JG[21][rr] + st.t[1][rr] * row.readout) * v;
    }
    r_out[rr] = st.r[rr] * v;
    Jrho_out[rr] = st.JG[20][rr] * v;
  }
}

// Linearize row m: r [M, R], J [M, R, C], J_rho [M, R] (RowShape), the
// stages in sequence in seed chunks N1 (windows, 25 seeds) and N2
// (residual): the one-row-per-thread kernel (N1 = kN1, N2 = kN2) and, on
// the host, N1 = 25, N2 = NS, one chunk each, as the operation count runs
// it.
template <typename T, bool Split, bool Atan, bool Lifting, int N1 = kN1, int N2 = kN2>
KT_HD void linearize_row(const Inputs<T>& in, int m, T* r_out, T* J_out,
                         T* Jrho_out) {
  constexpr int R = RowShape<Lifting>::R;
  constexpr int C = RowShape<Lifting>::C;
  constexpr int NS = RowShape<Lifting>::NS;
  Windows<T> w;
  Row<T> row;
  load_row<T, Split, Atan, Lifting>(in, m, w, row);
  const bool r3_first = (in.flags & kCamR3First) != 0;
  RowStages<T, Lifting> st;
  T* J = J_out + static_cast<size_t>(m) * R * C;
  for (int i = 0; i < 2; ++i) row_primal<T, Split>(w, i, r3_first, st.pq[i]);
  for (int c = 0; c < (NS + N2 - 1) / N2; ++c) row_residual<T, Atan, Lifting, N2>(row, st, c);
  for (int i = 0; i < 2; ++i) {
    for (int c = 0; c < (25 + N1 - 1) / N1; ++c) {
      row_window<T, Split, Lifting, N1, N1>(w, i, c, r3_first, st, row.valid, J);
    }
  }
  row_finish<T, Lifting>(row, st, J, r_out + R * m, Jrho_out + R * m);
}

// B1's lane kernel runs one row on a group of lanes of a warp, stage by
// stage (Lanes: the widths and the group of each window kind):
//   1. lanes 0-1: the primal (p, q) of the ref and obs windows;
//   2. one residual seed chunk of `res` seeds a lane (11 lanes on SE3, 8
//      split; the lifting rows' 22nd seed is one of them);
//   3. one window seed chunk a lane, `win` knot tangents plus the time
//      shift, window lane / (24 / win) (24 lanes on SE3, 16 split).
// Narrow jets keep a lane's registers few: the 8-wide jets of the first
// design spilled 10 KB on SE3 and 1.7 KB split in f64; the SE3 chain is the
// longer, so its chunks are the narrower.
constexpr int kB1Threads = 128;

template <bool Split>
struct Lanes {
  static constexpr int res = Split ? 3 : 2;  // residual seeds of a stage-2 lane
  static constexpr int win = Split ? 3 : 2;  // knot tangents of a stage-3 lane
  static constexpr int win_chunks = 24 / win;  // stage-3 lanes per window
  static constexpr int res_chunks = (22 + res - 1) / res;
  static constexpr int needed = res_chunks > 2 * win_chunks ? res_chunks : 2 * win_chunks;
  static constexpr int group = needed <= 8 ? 8 : needed <= 16 ? 16 : 32;  // lanes a row
  static constexpr int rows = kB1Threads / group;                         // rows a block
};

// Lane `lane` of a row's group in stage `stage` (0, 1, 2 as above).
template <typename T, bool Split, bool Atan, bool Lifting>
KT_HD void row_stage(int stage, int lane, const Windows<T>& w, const Row<T>& row,
                     bool r3_first, RowStages<T, Lifting>& st, T* J) {
  using K = Lanes<Split>;
  constexpr int NS = RowShape<Lifting>::NS;
  if (stage == 0) {
    if (lane < 2) row_primal<T, Split>(w, lane, r3_first, st.pq[lane]);
  } else if (stage == 1) {
    if (lane < (NS + K::res - 1) / K::res) row_residual<T, Atan, Lifting, K::res>(row, st, lane);
  } else if (lane < 2 * K::win_chunks) {
    row_window<T, Split, Lifting, K::win + 1, K::win>(
        w, lane / K::win_chunks, lane % K::win_chunks, r3_first, st, row.valid, J);
  }
}

// Row m as the kernel's lane group computes it, the lanes of each stage
// one after the other: the host's check of the kernel's schedule.
template <typename T, bool Split, bool Atan, bool Lifting>
KT_HD void linearize_row_lanes(const Inputs<T>& in, int m, T* r_out, T* J_out,
                               T* Jrho_out) {
  constexpr int R = RowShape<Lifting>::R;
  constexpr int C = RowShape<Lifting>::C;
  Windows<T> w;
  Row<T> row;
  load_row<T, Split, Atan, Lifting>(in, m, w, row);
  const bool r3_first = (in.flags & kCamR3First) != 0;
  RowStages<T, Lifting> st;
  T* J = J_out + static_cast<size_t>(m) * R * C;
  for (int stage = 0; stage < 3; ++stage) {
    for (int lane = 0; lane < Lanes<Split>::group; ++lane) {
      row_stage<T, Split, Atan, Lifting>(stage, lane, w, row, r3_first, st, J);
    }
  }
  row_finish<T, Lifting>(row, st, J, r_out + R * m, Jrho_out + R * m);
}

// ---- B3 cost_rows ----------------------------------------------------------

// Window i (0 ref, 1 obs) of row m, indexed as Windows::win: SE3 knots 7 x 4;
// split the R3 knots 3 x 4, then the SO3 knots 4 x 4.
template <typename T, bool Split>
struct WindowAt {
  const Inputs<T>& in;
  int i, m;
  KT_HD T operator[](int k) const {
    if (Split && k >= 12) return (i ? in.win_obs_so3 : in.win_ref_so3)[(k - 12) * in.M + m];
    return (i ? in.win_obs : in.win_ref)[k * in.M + m];
  }
};

// The cumulative basis B_0..B_2 at window i's u (the SO3 spline's, split).
template <typename T, bool Split>
KT_HD void window_basis(const Inputs<T>& in, int i, int m, T* B) {
  cumulative_basis<T>(Split ? (i ? in.u_obs_so3 : in.u_ref_so3)[m] : (i ? in.u_obs : in.u_ref)[m],
                      B);
}

// The factor of knot pair j (1..3) of window i of row m at b = B_{j-1}(u)
// (window_chain.cuh; no increments, no time shift): SE3 V(b omega) b
// upsilon in f[0..2] and exp(b omega) in f[3..6]; split expq(b w) of the
// SO3 spline in f[3..6].
template <typename T, bool Split>
KT_HD void pair_factor(const Inputs<T>& in, int i, int j, int m, T b, T* f) {
  const WindowAt<T, Split> win = {in, i, m};
  Q4<T> e;
  if (Split) {
    const V3<T> w3 = so3_pair<T>(win, 12, j);
    e = expq_pure(V3<T>{b * w3.x, b * w3.y, b * w3.z});
  } else {
    V3<T> omega, ups, vu;
    se3_pair(win, j, omega, ups);
    V_apply_exp(b, omega, ups, vu, e);
    f[0] = vu.x; f[1] = vu.y; f[2] = vu.z;
  }
  f[3] = e.w; f[4] = e.x; f[5] = e.y; f[6] = e.z;
}

// Pose (p, q) at u of window i of row m from its pair factors f (knot 0,
// then the products): pq_se3's and pq_split's chains at zero increments.
template <typename T, bool Split>
KT_HD void window_products(const Inputs<T>& in, int i, int m, const T (*f)[7], T* pq) {
  const WindowAt<T, Split> win = {in, i, m};
  if (Split) {
    T Br[4];
    standard_basis<T>((i ? in.u_obs : in.u_ref)[m], Br);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      T acc = Br[0] * win[k];
#pragma unroll
      for (int j = 1; j < 4; ++j) acc = acc + Br[j] * win[3 * j + k];
      pq[k] = acc;
    }
    Q4<T> q = {win[12], win[13], win[14], win[15]};
#pragma unroll
    for (int j = 0; j < 3; ++j) q = qmul(q, Q4<T>{f[j][3], f[j][4], f[j][5], f[j][6]});
    pq[3] = q.w; pq[4] = q.x; pq[5] = q.y; pq[6] = q.z;
  } else {
    V3<T> Pt = {win[4], win[5], win[6]};
    Q4<T> Pq = {win[0], win[1], win[2], win[3]};
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      se3_step(V3<T>{f[j][0], f[j][1], f[j][2]}, Q4<T>{f[j][3], f[j][4], f[j][5], f[j][6]},
               Pt, Pq);
    }
    pq[0] = Pt.x; pq[1] = Pt.y; pq[2] = Pt.z;
    pq[3] = Pq.w; pq[4] = Pq.x; pq[5] = Pq.y; pq[6] = Pq.z;
  }
}

// Row m's residual from its windows' poses pq, times valid, into r_out [R].
template <typename T, bool Atan, bool Lifting>
KT_HD void cost_residual(const Inputs<T>& in, int m, const T (*pq)[7], T* r_out) {
  constexpr int R = RowShape<Lifting>::R;
  Row<T> row;
  load_consts<T, Atan, Lifting>(in, m, row);
  T zero[6], r[R];
  for (int k = 0; k < 6; ++k) zero[k] = T(0);
  const T zs = T(0);
  residual_G<T, T, Atan, Lifting>(row, pq[0], pq[1], zero, zs, zs, r);
  for (int rr = 0; rr < R; ++rr) r_out[rr] = r[rr] * row.valid;
}

// Residual only of row m (B3) into r_out [R]: each window's pairs and tail
// in sequence, then the residual. The one-row-per-thread kernel's chain, and
// the operation count's.
template <typename T, bool Split, bool Atan, bool Lifting>
KT_HD void cost_row(const Inputs<T>& in, int m, T* r_out) {
  T pq[2][7];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    T f[3][7], B[3];
    window_basis<T, Split>(in, i, m, B);
#pragma unroll
    for (int j = 1; j < 4; ++j) pair_factor<T, Split>(in, i, j, m, B[j - 1], f[j - 1]);
    window_products<T, Split>(in, i, m, f, pq[i]);
  }
  cost_residual<T, Atan, Lifting>(in, m, pq, r_out);
}

// B3's lane kernel runs one row on kB3Group lanes, stage by stage:
//   0. lanes 0-5: window lane / 3's knot pair lane % 3 + 1 and its factor;
//   1. lanes 0-1: window lane's pose from knot 0 and its three factors;
//   2. lane 0: the residual.
constexpr int kB3Group = 8;                        // lanes a row
constexpr int kB3LaneRows = kB1Threads / kB3Group;  // rows a block

// What a B3 lane group hands on: each window's pair factors, then its pose.
template <typename T>
struct CostStages {
  T f[2][3][7], pq[2][7];
};

// Lane `lane` of a row's group in stage `stage`, row m of in.
template <typename T, bool Split, bool Atan, bool Lifting>
KT_HD void cost_stage(int stage, int lane, const Inputs<T>& in, int m, CostStages<T>& st,
                      T* r_out) {
  if (stage == 0) {
    if (lane < 6) {
      const int i = lane / 3, j = lane % 3;
      T B[3];
      window_basis<T, Split>(in, i, m, B);
      pair_factor<T, Split>(in, i, j + 1, m, j == 0 ? B[0] : j == 1 ? B[1] : B[2], st.f[i][j]);
    }
  } else if (stage == 1) {
    if (lane < 2) window_products<T, Split>(in, lane, m, st.f[lane], st.pq[lane]);
  } else if (lane == 0) {
    cost_residual<T, Atan, Lifting>(in, m, st.pq, r_out);
  }
}

#ifdef __CUDACC__

// A row group's inputs and stage results in shared memory.
template <typename T, bool Lifting>
struct GroupRow {
  Windows<T> w;
  Row<T> row;
  RowStages<T, Lifting> st;
};

// Shared memory of a B1 block: the rows' J tiles [rows, R, C], then their
// GroupRows.
template <typename T, bool Split, bool Lifting>
constexpr size_t b1_smem_bytes() {
  return Lanes<Split>::rows * (sizeof(T) * RowShape<Lifting>::R * RowShape<Lifting>::C +
                               sizeof(GroupRow<T, Lifting>));
}

// B1: a block of Lanes::rows rows, each on a group of Lanes::group lanes
// of one warp (row_stage); the group's J tile is staged in shared memory
// and the block's tiles, contiguous in J, are written out together.
template <typename T, bool Split, bool Atan, bool Lifting>
__global__ void __launch_bounds__(kB1Threads) linearize_rows_kernel(
    Inputs<T> in, T* r, T* J, T* J_rho) {
  using K = Lanes<Split>;
  constexpr int R = RowShape<Lifting>::R;
  constexpr int C = RowShape<Lifting>::C;
  extern __shared__ __align__(16) unsigned char smem[];
  T* tiles = reinterpret_cast<T*>(smem);
  GroupRow<T, Lifting>* groups =
      reinterpret_cast<GroupRow<T, Lifting>*>(tiles + K::rows * R * C);
  const int grp = threadIdx.x / K::group;
  const int lane = threadIdx.x % K::group;
  const int m0 = blockIdx.x * K::rows;
  const int m = m0 + grp;
  const bool live = m < in.M;
  GroupRow<T, Lifting>& g = groups[grp];
  T* tile = tiles + grp * R * C;
  const bool r3_first = (in.flags & kCamR3First) != 0;
  if (live && lane == 0) load_row<T, Split, Atan, Lifting>(in, m, g.w, g.row);
  __syncwarp();
  for (int stage = 0; stage < 3; ++stage) {
    if (live) row_stage<T, Split, Atan, Lifting>(stage, lane, g.w, g.row, r3_first, g.st, tile);
    __syncwarp();
  }
  if (live && lane == 0) row_finish<T, Lifting>(g.row, g.st, tile, r + R * m, J_rho + R * m);
  __syncthreads();
  const int rows = in.M - m0 < K::rows ? in.M - m0 : K::rows;
  copy_out(tiles, J + static_cast<size_t>(m0) * R * C, rows * R * C);
}

// B1 for many rows: one row per thread, the stages in sequence in the seed
// chunks of linearize_row (kN1, kN2), the stage results in registers.
template <typename T, bool Split, bool Atan, bool Lifting>
__global__ void __launch_bounds__(128) linearize_rows_thread_kernel(
    Inputs<T> in, T* r, T* J, T* J_rho) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m < in.M) linearize_row<T, Split, Atan, Lifting>(in, m, r, J, J_rho);
}

// Rows the one-row-per-thread kernel holds on the card at once.
template <typename T, bool Split, bool Atan, bool Lifting>
int thread_kernel_wave() {
  static int wave = 0;
  if (!wave) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, linearize_rows_thread_kernel<T, Split, Atan, Lifting>, 128, 0);
    wave = sms * (per_sm > 0 ? per_sm : 1) * 128;
  }
  return wave;
}

// B1 on the kernel that suits M: lane groups (a row's latency is one pass
// per stage) while one row per thread would not fill the card; one row
// per thread (every lane busy in every stage) from a full wave on.
template <typename T, bool Split, bool Atan, bool Lifting>
void launch_linearize(const Inputs<T>& in, T* r, T* J, T* J_rho, cudaStream_t st) {
  if (in.M >= thread_kernel_wave<T, Split, Atan, Lifting>()) {
    linearize_rows_thread_kernel<T, Split, Atan, Lifting><<<(in.M + 127) / 128, 128, 0, st>>>(
        in, r, J, J_rho);
  } else {
    constexpr int rows = Lanes<Split>::rows;
    linearize_rows_kernel<T, Split, Atan, Lifting>
        <<<(in.M + rows - 1) / rows, kB1Threads, b1_smem_bytes<T, Split, Lifting>(), st>>>(
            in, r, J, J_rho);
  }
}

// B3 while its rows fit one wave of this kernel (launch_cost): kB3LaneRows
// rows a block, each row on a group of kB3Group lanes (cost_stage), reading
// its inputs as each stage needs them; registers capped at 80 (six blocks
// an SM: config 4's 12,304 rows in one wave).
template <typename T, bool Split, bool Atan, bool Lifting>
__global__ void __launch_bounds__(kB1Threads, 6) cost_rows_lane_kernel(Inputs<T> in, T* r) {
  constexpr int R = RowShape<Lifting>::R;
  __shared__ CostStages<T> stages[kB3LaneRows];
  const int grp = threadIdx.x / kB3Group;
  const int lane = threadIdx.x % kB3Group;
  const int m = blockIdx.x * kB3LaneRows + grp;
  for (int stage = 0; stage < 3; ++stage) {
    if (m < in.M) cost_stage<T, Split, Atan, Lifting>(stage, lane, in, m, stages[grp], r + R * m);
    __syncwarp();
  }
}

constexpr int kB3Rows = 128;  // rows a block of the one-row-per-thread kernel

// B3 beyond one wave of the lane kernel (config 5: 500,000 rows): one row
// per thread (cost_row), reading its inputs as the chain needs them;
// registers capped at 128 (four blocks an SM).
template <typename T, bool Split, bool Atan, bool Lifting>
__global__ void __launch_bounds__(kB3Rows, 4) cost_rows_thread_kernel(Inputs<T> in, T* r) {
  constexpr int R = RowShape<Lifting>::R;
  const int m = blockIdx.x * kB3Rows + threadIdx.x;
  if (m < in.M) cost_row<T, Split, Atan, Lifting>(in, m, r + R * m);
}

// Rows B3's lane kernel holds on the card at once.
template <typename T, bool Split, bool Atan, bool Lifting>
int cost_lane_wave() {
  static int wave = 0;
  if (!wave) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, cost_rows_lane_kernel<T, Split, Atan, Lifting>, kB1Threads, 0);
    wave = sms * (per_sm > 0 ? per_sm : 1) * kB3LaneRows;
  }
  return wave;
}

// B3 on the kernel that suits M: lane groups while all rows fit one wave of
// them (a row's latency is one pair, one tail and the residual), one row
// per thread beyond (a second wave of lane groups would cost more than the
// thread kernel's whole chain).
template <typename T, bool Split, bool Atan, bool Lifting>
void launch_cost(const Inputs<T>& in, T* r, cudaStream_t st) {
  if (in.M > cost_lane_wave<T, Split, Atan, Lifting>()) {
    cost_rows_thread_kernel<T, Split, Atan, Lifting>
        <<<(in.M + kB3Rows - 1) / kB3Rows, kB3Rows, 0, st>>>(in, r);
  } else {
    cost_rows_lane_kernel<T, Split, Atan, Lifting>
        <<<(in.M + kB3LaneRows - 1) / kB3LaneRows, kB1Threads, 0, st>>>(in, r);
  }
}

// The most rows B3 runs on its lane kernel, on the flags' window kind.
template <typename T, bool Atan, bool Lifting>
int cost_wave(int flags) {
  return (flags & kCamSplit) ? cost_lane_wave<T, true, Atan, Lifting>()
                             : cost_lane_wave<T, false, Atan, Lifting>();
}

// Launch B1 (J != nullptr) or B3 (J == nullptr) of one camera and row kind
// on the flags' window kind; returns cudaGetLastError().
template <typename T, bool Atan, bool Lifting>
int launch_camera(const void* const* ins, void* r, void* J, void* J_rho, int M,
                  int flags, void* stream) {
  const Inputs<T> in = make_inputs<T>(ins, M, flags);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  T* rp = static_cast<T*>(r);
  const bool split = (flags & kCamSplit) != 0;
  if (J == nullptr) {
    if (split) {
      launch_cost<T, true, Atan, Lifting>(in, rp, st);
    } else {
      launch_cost<T, false, Atan, Lifting>(in, rp, st);
    }
  } else if (split) {
    launch_linearize<T, true, Atan, Lifting>(in, rp, static_cast<T*>(J),
                                             static_cast<T*>(J_rho), st);
  } else {
    launch_linearize<T, false, Atan, Lifting>(in, rp, static_cast<T*>(J),
                                              static_cast<T*>(J_rho), st);
  }
  return static_cast<int>(cudaGetLastError());
}

#endif  // __CUDACC__

}  // namespace
