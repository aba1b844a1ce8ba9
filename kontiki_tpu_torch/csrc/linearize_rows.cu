// Camera-row linearization for Hopper (sm_90a): residual, compressed
// Jacobian and landmark column of rolling-shutter pinhole rows on a
// cumulative SE3 spline.
//
// Replaces the Pallas TPU kernel B1, kontiki_tpu/ops/linearize_kernels.py
// linearize_rows -> _linearize_call / _tile_linearize. Its plain PyTorch
// version is kontiki_tpu_torch/ops/linearize_kernels.py
// linearize_rows_plain, which the wrapper runs for CPU tensors.
//
// Design: one thread per row; forward mode carried explicitly in
// Jet<T, N> dual numbers (jet.cuh), the way ceres::Jet differentiates the
// reference.
//   1. primal (p, q) of the ref and obs windows;
//   2. the projection residual over 21 seeds (p, q of ref and obs, sensor
//      rotation and translation, inverse depth), in chunks of N2 = 7;
//   3. each window in forward mode over 25 seeds (24 knot tangents + the
//      time shift s, u_eff = u + s/dt), in chunks of N1 = 5; each chunk's
//      tangents are chained through the (p, q) bottleneck at once and
//      written out, so no window Jacobian is kept per thread.
// The sensor block is [q_ct(3), p_ct(3), d = t_ref + t_obs, biases = 0].
//
// Bound: arithmetic and registers. A row reads 82 values and writes 126, so
// memory traffic is small (~1.6 KB/row in f64); each row runs the SE3
// window chain (trig, sqrt, atan) 10 times with 6-wide jets and the
// residual 3 times with 8-wide jets. Seed chunks keep the live jets small
// (a 25-wide jet would need ~50 registers per value and spill heavily);
// the price is re-running the primal chain once per chunk.
#include "jet.cuh"

namespace {

constexpr double kEps3 = 1e-10;   // theta^2 guard (math.se3._EPS)
constexpr double kPi = 3.14159265358979323846;
constexpr int kC = 61;            // Jacobian columns: 24 ref | 24 obs | 13 sensor
constexpr int kN1 = 5;            // stage-1 seed chunk (25 = 5 x 5)
constexpr int kN2 = 7;            // stage-2 seed chunk (21 = 3 x 7)

template <typename S>
struct V3 { S x, y, z; };
template <typename S>
struct Q4 { S w, x, y, z; };

template <typename S>
KT_HD Q4<S> qmul(const Q4<S>& a, const Q4<S>& b) {
  return {a.w * b.w - a.x * b.x - a.y * b.y - a.z * b.z,
          a.w * b.x + a.x * b.w + a.y * b.z - a.z * b.y,
          a.w * b.y - a.x * b.z + a.y * b.w + a.z * b.x,
          a.w * b.z + a.x * b.y - a.y * b.x + a.z * b.w};
}

template <typename S>
KT_HD Q4<S> qconj(const Q4<S>& q) { return {q.w, -q.x, -q.y, -q.z}; }

template <typename S>
KT_HD V3<S> cross(const V3<S>& a, const V3<S>& b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}

// (q (0,v) q*).vec in the 15-multiply form
template <typename S>
KT_HD V3<S> qrotate(const Q4<S>& q, const V3<S>& v) {
  using T = typename BaseT<S>::type;
  const V3<S> qv = {q.x, q.y, q.z};
  V3<S> t = cross(qv, v);
  t = {T(2) * t.x, T(2) * t.y, T(2) * t.z};
  const V3<S> c = cross(qv, t);
  return {v.x + q.w * t.x + c.x, v.y + q.w * t.y + c.y, v.z + q.w * t.z + c.z};
}

// rotation vector -> unit quaternion, Taylor-guarded
template <typename S>
KT_HD Q4<S> so3_exp_quat(const V3<S>& o) {
  using T = typename BaseT<S>::type;
  const S theta2 = o.x * o.x + o.y * o.y + o.z * o.z;
  S k, w;
  if (val(theta2) <= T(kEps3)) {
    k = T(0.5) - theta2 / T(48);
    w = T(1) - theta2 / T(8);
  } else {
    const S theta = kt_sqrt(theta2);
    const S half = T(0.5) * theta;
    k = kt_sin(half) / theta;
    w = kt_cos(half);
  }
  return {w, k * o.x, k * o.y, k * o.z};
}

// unit quaternion -> minimal rotation vector (Sophus SO3::log branches)
template <typename S>
KT_HD V3<S> so3_log(const Q4<S>& q) {
  using T = typename BaseT<S>::type;
  const S n2 = q.x * q.x + q.y * q.y + q.z * q.z;
  const T w = val(q.w);
  S k;
  if (val(n2) <= T(kEps3)) {
    const S ws = (kt_abs(w) <= T(kEps3)) ? S(T(1)) : q.w;
    k = T(2) / ws - T(2.0 / 3.0) * n2 / (ws * ws * ws);
  } else {
    const S n = kt_sqrt(n2);
    if (kt_abs(w) <= T(1e-10)) {
      k = (w >= T(0) ? T(kPi) : T(-kPi)) / n;
    } else {
      k = T(2) * kt_atan(n / q.w) / n;
    }
  }
  return {k * q.x, k * q.y, k * q.z};
}

// V(omega) u = u + a w x u + b w x (w x u)
template <typename S>
KT_HD V3<S> V_apply(const V3<S>& o, const V3<S>& u) {
  using T = typename BaseT<S>::type;
  const S theta2 = o.x * o.x + o.y * o.y + o.z * o.z;
  S a, b;
  if (val(theta2) <= T(kEps3)) {
    a = T(0.5) - theta2 / T(24);
    b = T(1.0 / 6.0) - theta2 / T(120);
  } else {
    const S theta = kt_sqrt(theta2);
    a = (T(1) - kt_cos(theta)) / theta2;
    b = (theta - kt_sin(theta)) / (theta2 * theta);
  }
  const V3<S> c1 = cross(o, u);
  const V3<S> c2 = cross(o, c1);
  return {u.x + a * c1.x + b * c2.x, u.y + a * c1.y + b * c2.y,
          u.z + a * c1.z + b * c2.z};
}

// V^{-1}(omega) t = t - w x t / 2 + c w x (w x t)
template <typename S>
KT_HD V3<S> Vinv_apply(const V3<S>& o, const V3<S>& t) {
  using T = typename BaseT<S>::type;
  const S theta2 = o.x * o.x + o.y * o.y + o.z * o.z;
  S c;
  if (val(theta2) <= T(kEps3)) {
    c = T(1.0 / 12.0) + theta2 / T(720);
  } else {
    const S theta = kt_sqrt(theta2);
    const S sin_t = kt_sin(theta);
    const S safe = (kt_abs(val(sin_t)) <= T(kEps3)) ? S(T(1)) : T(2) * theta * sin_t;
    c = T(1) / theta2 - (T(1) + kt_cos(theta)) / safe;
  }
  const V3<S> c1 = cross(o, t);
  const V3<S> c2 = cross(o, c1);
  return {t.x - T(0.5) * c1.x + c * c2.x, t.y - T(0.5) * c1.y + c * c2.y,
          t.z - T(0.5) * c1.z + c * c2.z};
}

// Cumulative SE3 window (p, q) at u + s/dt with right increments
// (q exp(w), t + R(q) V(w) v) on the 4 knots; delta rows 6j+0..2 are
// translation, 6j+3..5 rotation.
template <typename T, typename S>
KT_HD void pq_se3(const T* win, T u, T dt, const S* delta, const S& s, S* out) {
  Q4<S> kq[4];
  V3<S> kt[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const Q4<S> qj = {S(win[7 * j]), S(win[7 * j + 1]), S(win[7 * j + 2]),
                      S(win[7 * j + 3])};
    const V3<S> dv = {delta[6 * j], delta[6 * j + 1], delta[6 * j + 2]};
    const V3<S> dw = {delta[6 * j + 3], delta[6 * j + 4], delta[6 * j + 5]};
    const V3<S> rt = qrotate(qj, V_apply(dw, dv));
    kq[j] = qmul(qj, so3_exp_quat(dw));
    kt[j] = {win[7 * j + 4] + rt.x, win[7 * j + 5] + rt.y, win[7 * j + 6] + rt.z};
  }

  const S ue = u + s / dt;
  const S u2 = ue * ue;
  const S u3 = u2 * ue;
  const S B[3] = {(T(5) + T(3) * ue - T(3) * u2 + u3) / T(6),
                  (T(1) + T(3) * ue + T(3) * u2 - T(2) * u3) / T(6),
                  u3 / T(6)};

  Q4<S> Pq = kq[0];
  V3<S> Pt = kt[0];
#pragma unroll
  for (int j = 1; j < 4; ++j) {
    const Q4<S> qi = qconj(kq[j - 1]);
    const V3<S> ti = qrotate(qi, kt[j - 1]);
    const Q4<S> q_rel = qmul(qi, kq[j]);
    const V3<S> rt = qrotate(qi, kt[j]);
    const V3<S> t_rel = {rt.x + -ti.x, rt.y + -ti.y, rt.z + -ti.z};
    const V3<S> omega = so3_log(q_rel);
    const V3<S> ups = Vinv_apply(omega, t_rel);
    const S b = B[j - 1];
    const V3<S> bo = {b * omega.x, b * omega.y, b * omega.z};
    const V3<S> bu = {b * ups.x, b * ups.y, b * ups.z};
    const V3<S> rt2 = qrotate(Pq, V_apply(bo, bu));
    Pt = {Pt.x + rt2.x, Pt.y + rt2.y, Pt.z + rt2.z};
    Pq = qmul(Pq, so3_exp_quat(bo));
  }
  out[0] = Pt.x; out[1] = Pt.y; out[2] = Pt.z;
  out[3] = Pq.w; out[4] = Pq.x; out[5] = Pq.y; out[6] = Pq.z;
}

template <typename T>
struct Row {
  T q_ct[4], p_ct[3], rho, yh[3], uv[2], weight, K[9];
};

// Projection residual through the (p, q) bottleneck, pinhole camera.
template <typename T, typename S>
KT_HD void residual_G(const Row<T>& row, const S* ur, const S* uo,
                      const S* dsen, const S& drho, S* r) {
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
  const S px = row.K[0] * Xcam.x + row.K[1] * Xcam.y + row.K[2] * Xcam.z;
  const S py = row.K[3] * Xcam.x + row.K[4] * Xcam.y + row.K[5] * Xcam.z;
  const S pz = row.K[6] * Xcam.x + row.K[7] * Xcam.y + row.K[8] * Xcam.z;
  r[0] = row.weight * (row.uv[0] - px / pz);
  r[1] = row.weight * (row.uv[1] - py / pz);
}

// Inputs are [k, M] arrays (component k of row m at k * M + m).
template <typename T>
struct Inputs {
  const T *win_ref, *u_ref, *win_obs, *u_obs, *dts, *q_ct, *p_ct, *rho,
      *yh_ref, *uv_obs, *weight, *K;
  int M;
};

}  // namespace

// Linearize row m: r [M, 2], J [M, 2, 61], J_rho [M, 2].
template <typename T>
KT_HD void linearize_row(const Inputs<T>& in, int m, T* r_out, T* J_out,
                         T* Jrho_out) {
  const int M = in.M;
  T win[2][28], u[2];
#pragma unroll
  for (int k = 0; k < 28; ++k) {
    win[0][k] = in.win_ref[k * M + m];
    win[1][k] = in.win_obs[k * M + m];
  }
  u[0] = in.u_ref[m];
  u[1] = in.u_obs[m];
  const T dt = in.dts[m];
  Row<T> row;
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

  // 1. primal (p, q) of both windows
  T pq[2][7];
  {
    T zero[24];
    for (int k = 0; k < 24; ++k) zero[k] = T(0);
    const T zs = T(0);
    pq_se3<T, T>(win[0], u[0], dt, zero, zs, pq[0]);
    pq_se3<T, T>(win[1], u[1], dt, zero, zs, pq[1]);
  }

  // 2. residual and its 21 seed columns
  T JG[21][2], r[2];
  for (int s0 = 0; s0 < 21; s0 += kN2) {
    using S = Jet<T, kN2>;
    S ur[7], uo[7], dsen[6], out[2];
    for (int k = 0; k < 7; ++k) {
      ur[k] = seeded<T, kN2>(pq[0][k], k - s0);
      uo[k] = seeded<T, kN2>(pq[1][k], 7 + k - s0);
    }
    for (int k = 0; k < 6; ++k) dsen[k] = seeded<T, kN2>(T(0), 14 + k - s0);
    const S drho = seeded<T, kN2>(T(0), 20 - s0);
    residual_G<T, S>(row, ur, uo, dsen, drho, out);
#pragma unroll
    for (int i = 0; i < kN2; ++i) {
      JG[s0 + i][0] = out[0].v[i];
      JG[s0 + i][1] = out[1].v[i];
    }
    r[0] = out[0].a;
    r[1] = out[1].a;
  }

  // 3. window tangents, chained through the (p, q) bottleneck
  T* J = J_out + static_cast<size_t>(m) * 2 * kC;
  T t_sum[2] = {T(0), T(0)};  // d(r)/d(time): t_ref + t_obs
  for (int w = 0; w < 2; ++w) {
    for (int s0 = 0; s0 < 25; s0 += kN1) {
      using S = Jet<T, kN1>;
      S delta[24], out[7];
      for (int k = 0; k < 24; ++k) delta[k] = seeded<T, kN1>(T(0), k - s0);
      const S s = seeded<T, kN1>(T(0), 24 - s0);
      pq_se3<T, S>(win[w], u[w], dt, delta, s, out);
#pragma unroll
      for (int i = 0; i < kN1; ++i) {
        const int c = s0 + i;
        for (int rr = 0; rr < 2; ++rr) {
          T acc = T(0);
          for (int k = 0; k < 7; ++k) acc = acc + JG[7 * w + k][rr] * out[k].v[i];
          if (c < 24) {
            J[rr * kC + 24 * w + c] = acc;
          } else {
            t_sum[rr] = t_sum[rr] + acc;
          }
        }
      }
    }
  }
  for (int rr = 0; rr < 2; ++rr) {
    for (int j = 0; j < 6; ++j) J[rr * kC + 48 + j] = JG[14 + j][rr];
    J[rr * kC + 54] = t_sum[rr];
    for (int j = 55; j < kC; ++j) J[rr * kC + j] = T(0);
    r_out[2 * m + rr] = r[rr];
    Jrho_out[2 * m + rr] = JG[20][rr];
  }
}

#ifdef __CUDACC__

#include <cuda_runtime.h>

template <typename T>
__global__ void __launch_bounds__(128) linearize_rows_kernel(
    Inputs<T> in, T* r, T* J, T* J_rho) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m < in.M) linearize_row<T>(in, m, r, J, J_rho);
}

template <typename T>
static int launch_linearize(const void* const* ins, void* r, void* J,
                            void* J_rho, int M, void* stream) {
  const Inputs<T> in = {
      static_cast<const T*>(ins[0]), static_cast<const T*>(ins[1]),
      static_cast<const T*>(ins[2]), static_cast<const T*>(ins[3]),
      static_cast<const T*>(ins[4]), static_cast<const T*>(ins[5]),
      static_cast<const T*>(ins[6]), static_cast<const T*>(ins[7]),
      static_cast<const T*>(ins[8]), static_cast<const T*>(ins[9]),
      static_cast<const T*>(ins[10]), static_cast<const T*>(ins[11]), M};
  const int threads = 128;
  const int blocks = (M + threads - 1) / threads;
  linearize_rows_kernel<T><<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      in, static_cast<T*>(r), static_cast<T*>(J), static_cast<T*>(J_rho));
  return static_cast<int>(cudaGetLastError());
}

#define KT_LINEARIZE_ENTRY(NAME, T)                                            \
  extern "C" int NAME(const void* win_ref, const void* u_ref,                  \
                      const void* win_obs, const void* u_obs, const void* dts, \
                      const void* q_ct, const void* p_ct, const void* rho,     \
                      const void* yh_ref, const void* uv_obs,                  \
                      const void* weight, const void* K, void* r, void* J,     \
                      void* J_rho, int M, void* stream) {                      \
    const void* ins[12] = {win_ref, u_ref, win_obs, u_obs, dts, q_ct,         \
                           p_ct, rho, yh_ref, uv_obs, weight, K};              \
    return launch_linearize<T>(ins, r, J, J_rho, M, stream);                   \
  }

KT_LINEARIZE_ENTRY(kontiki_linearize_rows_f32, float)
KT_LINEARIZE_ENTRY(kontiki_linearize_rows_f64, double)

#endif  // __CUDACC__
