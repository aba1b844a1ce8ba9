// Quaternion, rotation and spline-window helpers on scalars, Jets or
// Taylor2 numbers, shared by the port's row kernels (linearize_rows.cu,
// imu_rows.cu, eval_windows.cu, r3_evaluate.cu). Formulas and guards mirror
// kontiki_tpu_torch.math.{quaternion,se3}; guards are taken on the primal
// value, as the TPU kernels' `where` does.
#pragma once

#include "jet.cuh"

namespace {

constexpr double kEps3 = 1e-10;   // theta^2 guard (math.se3._EPS)
constexpr double kEpsQ = 1e-16;   // quaternion log/exp guard (math.quaternion.EPS)
constexpr double kPi = 3.14159265358979323846;

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

// Unit-quaternion log, vector part: k v with k = atan2(|v|, w) / |v|.
template <typename S>
KT_HD V3<S> logq_vec(const Q4<S>& q) {
  using T = typename BaseT<S>::type;
  const S v2 = q.x * q.x + q.y * q.y + q.z * q.z;
  if (val(v2) <= T(kEpsQ)) return {q.x, q.y, q.z};
  const S vn = kt_sqrt(v2);
  const S k = kt_atan2(vn, q.w) / vn;
  return {k * q.x, k * q.y, k * q.z};
}

// exp of the pure quaternion (0, v): (cos|v|, sinc(|v|) v), or (1, v) when
// |v|^2 <= kEpsQ.
template <typename S>
KT_HD Q4<S> expq_pure(const V3<S>& v) {
  using T = typename BaseT<S>::type;
  const S v2 = v.x * v.x + v.y * v.y + v.z * v.z;
  if (val(v2) <= T(kEpsQ)) return {S(T(1)), v.x, v.y, v.z};
  const S vn = kt_sqrt(v2);
  const S kv = kt_sin(vn) / vn;
  return {kt_cos(vn), kv * v.x, kv * v.y, kv * v.z};
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

// Knot j of an SE3 window with its right increment (q exp(w), t + R(q)
// V(w) v); delta rows 6j+0..2 are translation, 6j+3..5 rotation (delta: an
// array of S or anything indexed like one).
template <typename T, typename S, typename D>
KT_HD void se3_knot(const T* win, int j, const D& delta, Q4<S>& kq, V3<S>& kt) {
  const Q4<S> qj = {S(win[7 * j]), S(win[7 * j + 1]), S(win[7 * j + 2]), S(win[7 * j + 3])};
  const V3<S> dv = {delta[6 * j], delta[6 * j + 1], delta[6 * j + 2]};
  const V3<S> dw = {delta[6 * j + 3], delta[6 * j + 4], delta[6 * j + 5]};
  const V3<S> rt = qrotate(qj, V_apply(dw, dv));
  kq = qmul(qj, so3_exp_quat(dw));
  kt = {win[7 * j + 4] + rt.x, win[7 * j + 5] + rt.y, win[7 * j + 6] + rt.z};
}

// Cumulative SE3 window (p, q) at u + s/dt with right increments on the 4
// knots (se3_knot). Lazy increments each knot when the chain reaches it, so
// two are held at a time (B1's wide jets need that to fit their registers);
// otherwise all four come first (B1's primal stage). The knots and their
// pairs run on SK, the basis and the products on S (B8 takes the knots on
// jets and the rest on a time dual of them). A 4-knot sub-window of a wider
// window starts at knot j0: win and delta start there, and the basis is
// taken at u + s/dt - j0.
template <typename T, typename S, typename D, bool Lazy = false, typename SK = S>
KT_HD void pq_se3(const T* win, T u, T dt, const D& delta, const S& s, S* out, int j0 = 0) {
  Q4<SK> kq[4];
  V3<SK> kt[4];
#pragma unroll
  for (int j = 0; j < (Lazy ? 1 : 4); ++j) se3_knot<T, SK, D>(win, j, delta, kq[j], kt[j]);

  S ue = u + s / dt;
  if (j0 != 0) ue = ue - T(j0);
  const S u2 = ue * ue;
  const S u3 = u2 * ue;
  const S B[3] = {(T(5) + T(3) * ue - T(3) * u2 + u3) / T(6),
                  (T(1) + T(3) * ue + T(3) * u2 - T(2) * u3) / T(6),
                  u3 / T(6)};

  Q4<S> Pq = {S(kq[0].w), S(kq[0].x), S(kq[0].y), S(kq[0].z)};
  V3<S> Pt = {S(kt[0].x), S(kt[0].y), S(kt[0].z)};
#pragma unroll
  for (int j = 1; j < 4; ++j) {
    if (Lazy) se3_knot<T, SK, D>(win, j, delta, kq[j], kt[j]);
    const Q4<SK> qi = qconj(kq[j - 1]);
    const V3<SK> ti = qrotate(qi, kt[j - 1]);
    const Q4<SK> q_rel = qmul(qi, kq[j]);
    const V3<SK> rt = qrotate(qi, kt[j]);
    const V3<SK> t_rel = {rt.x + -ti.x, rt.y + -ti.y, rt.z + -ti.z};
    const V3<SK> omega = so3_log(q_rel);
    const V3<SK> ups = Vinv_apply(omega, t_rel);
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

// The R3 spline's standard cubic basis at u (columns of [1, u, u^2, u^3] M,
// spline_base.h:18-22) and its first and second time derivatives.
template <typename T>
KT_HD void r3_basis(T u, T dt, T* B, T* dB, T* d2B) {
  const T c6 = T(1) / T(6);
  const T u2 = u * u;
  const T u3 = u2 * u;
  const T dti = T(1) / dt;
  const T dti2 = dti * dti;
  B[0] = c6 * (T(1) - T(3) * u + T(3) * u2 - u3);
  B[1] = c6 * (T(4) - T(6) * u2 + T(3) * u3);
  B[2] = c6 * (T(1) + T(3) * u + T(3) * u2 - T(3) * u3);
  B[3] = c6 * u3;
  dB[0] = dti * (c6 * (T(-3) + T(6) * u - T(3) * u2));
  dB[1] = dti * (c6 * (T(-12) * u + T(9) * u2));
  dB[2] = dti * (c6 * (T(3) + T(6) * u - T(9) * u2));
  dB[3] = dti * (c6 * (T(3) * u2));
  d2B[0] = dti2 * (T(1) - u);
  d2B[1] = dti2 * (c6 * (T(-12) + T(18) * u));
  d2B[2] = dti2 * (c6 * (T(6) - T(18) * u));
  d2B[3] = dti2 * u;
}

#ifdef __CUDACC__

// n values from shared src to global dst by the block's threads, in 16-byte
// stores where dst allows (src is 16-byte aligned): B1's and B4's J tiles.
template <typename T>
__device__ void copy_out(const T* src, T* dst, int n) {
  constexpr int V = 16 / sizeof(T);
  int done = 0;
  if (reinterpret_cast<unsigned long long>(dst) % 16 == 0) {
    const int4* s = reinterpret_cast<const int4*>(src);
    int4* d = reinterpret_cast<int4*>(dst);
    for (int i = threadIdx.x; i < n / V; i += blockDim.x) d[i] = s[i];
    done = n / V * V;
  }
  for (int i = done + threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
}

#endif  // __CUDACC__

}  // namespace
