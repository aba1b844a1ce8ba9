// Camera rows for Hopper (sm_90a): the per-row code of kernels B1
// linearize_rows and B3 cost_rows, and their kernels, shared by
// linearize_rows.cu (pinhole camera) and linearize_rows_atan.cu (atan
// camera), and compiled for the host by host_rows.cpp.
//
//  - B1 linearize_rows: residual, compressed Jacobian and landmark column.
//    Replaces the Pallas TPU kernel kontiki_tpu/ops/linearize_kernels.py
//    linearize_rows -> _linearize_call / _tile_linearize.
//  - B3 cost_rows: the residual only, B1's primal chain with zero
//    increments and no seeds (the LM re-cost). Replaces cost_rows ->
//    _cost_only_call / _tile_cost.
// Their plain PyTorch versions are kontiki_tpu_torch/ops/linearize_kernels.py
// linearize_rows_plain and cost_rows_plain, which the wrappers run for CPU
// tensors. Rows with valid = 0 give zeros. One thread per row, so there are
// no padded lanes (the TPU kernels pad divisors with 1.0 to a 128-row tile).
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
// (jet.cuh), the way ceres::Jet differentiates the reference.
//   1. primal (p, q) of the ref and obs windows;
//   2. the projection residual over 21 seeds (p, q of ref and obs, sensor
//      rotation and translation, inverse depth) and, lifting, dvt, in
//      chunks of N2 = 7: the lifting rows' 22nd seed takes a fourth chunk
//      of the same width, so every branch runs 8-wide jets (B1 split
//      pinhole static already runs at 255 registers with spill);
//   3. each window in forward mode over 25 seeds (24 knot tangents + the
//      time shift s, u_eff = u + s/dt), in chunks of N1 = 5; each chunk's
//      tangents are chained through the (p, q) bottleneck at once and
//      written out, so no window Jacobian is kept per thread.
// The sensor block is [q_ct(3), p_ct(3), d = t_ref + t_obs, biases = 0],
// where t_ref and t_obs are the residual's derivatives through each
// window's time shift; the lifting vt column reuses t_obs.
//
// B1 bound: an SE3 row reads 82 values (pinhole static; 3 more atan, 4 more
// lifting; split rows 3 more) and writes 126 (192 lifting), ~1.7 KB in
// f64, and the function needs ~27 k float64 operations on SE3
// (csrc/host_rows.cpp counts them): at config 4's 12,304 rows, ~6 us of
// bytes and ~5 us of operations at 67 TFLOP/s.
// The kernel's time is set by arithmetic latency and registers instead:
// each row runs the window chain (trig, sqrt, atan) 10 times with 6-wide
// jets and the residual 3 times (4 lifting) with 8-wide jets. Seed chunks
// keep the live jets small (a 25-wide jet would need ~50 registers per
// value and spill heavily); the price is re-running the primal chain once
// per chunk.
//
// B3 design: the same row code instantiated on the plain scalar T instead
// of a Jet, so the primal math is written once and checked on the host
// (csrc/host_rows.cpp). A row reads 82-93 values and writes 2 or 3
// (~0.7 KB in f64) and needs ~1 k operations: bytes bound it on paper, the
// latency of one thread's chain of ~30 dependent transcendentals in
// practice.
#pragma once

#include "rowmath.cuh"

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

namespace {

constexpr int kC = 61;            // static columns: 24 ref | 24 obs | 13 sensor
constexpr int kN1 = 5;            // stage-1 seed chunk (25 = 5 x 5)
constexpr int kN2 = 7;            // stage-2 seed chunk (21 = 3 x 7; 22 = 4 chunks)
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

// Split window (p, q): the R3 spline at u_r3 + s/dt_r3 (win[0..11], knots
// additive) and the cumulative SO3 spline at u_so3 + s/dt_so3 (win[12..27],
// knots left exp(w) q). delta holds the first spline's 12 increments, then
// the second's.
template <typename T, typename S>
KT_HD void pq_split(const T* win, T u_r3, T u_so3, T dt_r3, T dt_so3,
                    const S* delta, const S& s, bool r3_first, S* out) {
  const int off_r3 = r3_first ? 0 : 12;
  const int off_so3 = r3_first ? 12 : 0;

  const S ur = u_r3 + s / dt_r3;
  const S r2 = ur * ur;
  const S r3 = r2 * ur;
  const S Br[4] = {(T(1) - T(3) * ur + T(3) * r2 - r3) / T(6),
                   (T(4) - T(6) * r2 + T(3) * r3) / T(6),
                   (T(1) + T(3) * ur + T(3) * r2 - T(3) * r3) / T(6),
                   r3 / T(6)};
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    S acc = Br[0] * (win[k] + delta[off_r3 + k]);
#pragma unroll
    for (int j = 1; j < 4; ++j) acc = acc + Br[j] * (win[3 * j + k] + delta[off_r3 + 3 * j + k]);
    out[k] = acc;
  }

  Q4<S> kq[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const T* w = win + 12 + 4 * j;
    const Q4<S> qj = {S(w[0]), S(w[1]), S(w[2]), S(w[3])};
    const V3<S> dw = {delta[off_so3 + 3 * j], delta[off_so3 + 3 * j + 1],
                      delta[off_so3 + 3 * j + 2]};
    kq[j] = qmul(so3_exp_quat(dw), qj);
  }
  const S uq = u_so3 + s / dt_so3;
  const S q2 = uq * uq;
  const S q3 = q2 * uq;
  const S B[3] = {(T(5) + T(3) * uq - T(3) * q2 + q3) / T(6),
                  (T(1) + T(3) * uq + T(3) * q2 - T(2) * q3) / T(6),
                  q3 / T(6)};
  Q4<S> q = kq[0];
#pragma unroll
  for (int j = 1; j < 4; ++j) {
    const V3<S> w3 = logq_vec(qmul(qconj(kq[j - 1]), kq[j]));
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
template <typename T, bool Split, typename S>
KT_HD void window_pq(const Windows<T>& w, int i, bool r3_first, const S* delta,
                     const S& s, S* out) {
  if (Split) {
    pq_split<T, S>(w.win[i], w.u[i][0], w.u[i][1], w.dt[0], w.dt[1], delta, s,
                   r3_first, out);
  } else {
    pq_se3<T, S>(w.win[i], w.u[i][0], w.dt[0], delta, s, out);
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

// Linearize row m: r [M, R], J [M, R, C], J_rho [M, R] (RowShape). The
// kernel runs the seed chunks N1 = kN1, N2 = kN2; N1 = 25, N2 = NS is one
// chunk each.
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

  // 1. primal (p, q) of both windows
  T pq[2][7];
  {
    T zero[24];
    for (int k = 0; k < 24; ++k) zero[k] = T(0);
    const T zs = T(0);
    window_pq<T, Split, T>(w, 0, r3_first, zero, zs, pq[0]);
    window_pq<T, Split, T>(w, 1, r3_first, zero, zs, pq[1]);
  }

  // 2. residual and its NS seed columns
  T JG[NS][R], r[R];
  for (int s0 = 0; s0 < NS; s0 += N2) {
    using S = Jet<T, N2>;
    S ur[7], uo[7], dsen[6], out[R];
    for (int k = 0; k < 7; ++k) {
      ur[k] = seeded<T, N2>(pq[0][k], k - s0);
      uo[k] = seeded<T, N2>(pq[1][k], 7 + k - s0);
    }
    for (int k = 0; k < 6; ++k) dsen[k] = seeded<T, N2>(T(0), 14 + k - s0);
    const S drho = seeded<T, N2>(T(0), 20 - s0);
    const S dvt = seeded<T, N2>(T(0), 21 - s0);
    residual_G<T, S, Atan, Lifting>(row, ur, uo, dsen, drho, dvt, out);
#pragma unroll
    for (int i = 0; i < N2; ++i) {
      if (NS % N2 == 0 || s0 + i < NS) {
        for (int rr = 0; rr < R; ++rr) JG[s0 + i][rr] = out[rr].v[i];
      }
    }
    for (int rr = 0; rr < R; ++rr) r[rr] = out[rr].a;
  }

  // 3. window tangents, chained through the (p, q) bottleneck
  const T v = row.valid;
  T* J = J_out + static_cast<size_t>(m) * R * C;
  // d(r)/d(time): t_ref + t_obs in one running sum, and t_obs alone for the
  // lifting vt column (one sum, not one per window: per-window sums changed
  // the pinhole static kernels' register allocation and spill, and slowed
  // the SE3 one)
  T t_sum[R], t_obs[R];
  for (int rr = 0; rr < R; ++rr) t_sum[rr] = T(0);
  for (int i = 0; i < 2; ++i) {
    for (int s0 = 0; s0 < 25; s0 += N1) {
      using S = Jet<T, N1>;
      S delta[24], out[7];
      for (int k = 0; k < 24; ++k) delta[k] = seeded<T, N1>(T(0), k - s0);
      const S s = seeded<T, N1>(T(0), 24 - s0);
      window_pq<T, Split, S>(w, i, r3_first, delta, s, out);
#pragma unroll
      for (int j = 0; j < N1; ++j) {
        const int c = s0 + j;
        for (int rr = 0; rr < R; ++rr) {
          T acc = T(0);
          for (int k = 0; k < 7; ++k) acc = acc + JG[7 * i + k][rr] * out[k].v[j];
          if (c < 24) {
            J[rr * C + 24 * i + c] = acc * v;
          } else {
            t_sum[rr] = t_sum[rr] + acc;
            if (Lifting && i == 1) t_obs[rr] = acc;
          }
        }
      }
    }
  }
  for (int rr = 0; rr < R; ++rr) {
    for (int j = 0; j < 6; ++j) J[rr * C + 48 + j] = JG[14 + j][rr] * v;
    J[rr * C + 54] = t_sum[rr] * v;
    for (int j = 55; j < kC; ++j) J[rr * C + j] = T(0);
    if constexpr (Lifting) {
      // the row time moves the obs window: dW_obs/dvt = dW_obs/dt readout
      J[rr * C + kC] = (JG[21][rr] + t_obs[rr] * row.readout) * v;
    }
    r_out[R * m + rr] = r[rr] * v;
    Jrho_out[R * m + rr] = JG[20][rr] * v;
  }
}

// Residual only of row m (B3): r [M, R], B1's primal chain at zero
// increments.
template <typename T, bool Split, bool Atan, bool Lifting>
KT_HD void cost_row(const Inputs<T>& in, int m, T* r_out) {
  constexpr int R = RowShape<Lifting>::R;
  Windows<T> w;
  Row<T> row;
  load_row<T, Split, Atan, Lifting>(in, m, w, row);
  const bool r3_first = (in.flags & kCamR3First) != 0;
  T zero[24], pq[2][7], r[R];
  for (int k = 0; k < 24; ++k) zero[k] = T(0);
  const T zs = T(0);
  window_pq<T, Split, T>(w, 0, r3_first, zero, zs, pq[0]);
  window_pq<T, Split, T>(w, 1, r3_first, zero, zs, pq[1]);
  residual_G<T, T, Atan, Lifting>(row, pq[0], pq[1], zero, zs, zs, r);
  for (int rr = 0; rr < R; ++rr) r_out[R * m + rr] = r[rr] * row.valid;
}

#ifdef __CUDACC__

template <typename T, bool Split, bool Atan, bool Lifting>
__global__ void __launch_bounds__(128) linearize_rows_kernel(
    Inputs<T> in, T* r, T* J, T* J_rho) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m < in.M) linearize_row<T, Split, Atan, Lifting>(in, m, r, J, J_rho);
}

template <typename T, bool Split, bool Atan, bool Lifting>
__global__ void __launch_bounds__(128) cost_rows_kernel(Inputs<T> in, T* r) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m < in.M) cost_row<T, Split, Atan, Lifting>(in, m, r);
}

// Launch B1 (J != nullptr) or B3 (J == nullptr) of one camera and row kind
// on the flags' window kind; returns cudaGetLastError().
template <typename T, bool Atan, bool Lifting>
int launch_camera(const void* const* ins, void* r, void* J, void* J_rho, int M,
                  int flags, void* stream) {
  const Inputs<T> in = make_inputs<T>(ins, M, flags);
  const int threads = 128;
  const int blocks = (M + threads - 1) / threads;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  T* rp = static_cast<T*>(r);
  const bool split = (flags & kCamSplit) != 0;
  if (J == nullptr) {
    if (split) {
      cost_rows_kernel<T, true, Atan, Lifting><<<blocks, threads, 0, st>>>(in, rp);
    } else {
      cost_rows_kernel<T, false, Atan, Lifting><<<blocks, threads, 0, st>>>(in, rp);
    }
  } else if (split) {
    linearize_rows_kernel<T, true, Atan, Lifting><<<blocks, threads, 0, st>>>(
        in, rp, static_cast<T*>(J), static_cast<T*>(J_rho));
  } else {
    linearize_rows_kernel<T, false, Atan, Lifting><<<blocks, threads, 0, st>>>(
        in, rp, static_cast<T*>(J), static_cast<T*>(J_rho));
  }
  return static_cast<int>(cudaGetLastError());
}

#endif  // __CUDACC__

}  // namespace
