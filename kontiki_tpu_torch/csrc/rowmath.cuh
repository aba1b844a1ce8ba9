// Quaternion and rotation helpers on scalars or Jets, shared by the
// port's row kernels (linearize_rows.cu, imu_rows.cu). Formulas and guards
// mirror kontiki_tpu_torch.math.{quaternion,se3}; guards are taken on the
// primal value, as the TPU kernels' `where` does.
#pragma once

#include "jet.cuh"

namespace {

constexpr double kEps3 = 1e-10;   // theta^2 guard (math.se3._EPS)
constexpr double kEpsQ = 1e-16;   // quaternion log/exp guard (math.quaternion.EPS)

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

}  // namespace
