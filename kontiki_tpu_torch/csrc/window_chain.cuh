// The cumulative spline windows' chain without increments, shared by kernels
// B3 cost_rows (camera_rows.cuh: each window's pose at u) and B5
// evaluate_windows (eval_windows.cu: the pose and its time derivatives).
//
// It is B1's window chain (rowmath.cuh pq_se3, camera_rows.cuh pq_split)
// at zero increments, split by what depends on u:
//  - the knot pairs, knot-only, on plain scalars: SE3 the relative
//    transform of knots j-1 and j, its so3_log omega and V^-1 upsilon
//    (se3_pair); SO3 w = logq of conj(q_{j-1}) q_j (so3_pair);
//  - the tail at b = B_{j-1}(u) of the cumulative basis
//    (cumulative_basis): each pair's factor, SE3 V(b omega) b upsilon and
//    exp(b omega) (V_apply_exp), SO3 expq(b w), then the products from
//    knot 0 on (se3_step; qmul).
// The tail runs on a plain scalar (B3, the pose) or on Taylor2<T> seeded in
// the time shift s (B5, the derivatives). In V_apply_exp b is taken out of
// V's vector products, so only scalar functions of b run on Taylor2, with
// one sincos per angle. Same formulas and guards as pq_se3 and pq_split
// (the tail's vector products regrouped), so the results change by
// rounding only; with no increments a knot is read as it is, where B1's
// chain multiplies it by exp(0).
#pragma once

#include "rowmath.cuh"

namespace {

// sin and cos of x at once (one argument reduction on the card; the host's
// operation counter takes them apart).
template <typename T>
KT_HD void kt_sincos(T x, T* s, T* c) {
  *s = kt_sin(x);
  *c = kt_cos(x);
}
KT_HD void kt_sincos(float x, float* s, float* c) {
#ifdef __CUDA_ARCH__
  sincosf(x, s, c);
#else
  *s = sinf(x);
  *c = cosf(x);
#endif
}
KT_HD void kt_sincos(double x, double* s, double* c) {
#ifdef __CUDA_ARCH__
  sincos(x, s, c);
#else
  *s = sin(x);
  *c = cos(x);
#endif
}

// The cumulative basis B_0..B_2 at ue (u, or u + s/dt on Taylor2).
template <typename T, typename S>
KT_HD void cumulative_basis(const S& ue, S* B) {
  const S u2 = ue * ue;
  const S u3 = u2 * ue;
  B[0] = (T(5) + T(3) * ue - T(3) * u2 + u3) / T(6);
  B[1] = (T(1) + T(3) * ue + T(3) * u2 - T(2) * u3) / T(6);
  B[2] = u3 / T(6);
}

// The standard (R3) basis B_0..B_3 at ur, as B1's split windows take it.
template <typename T, typename S>
KT_HD void standard_basis(const S& ur, S* Br) {
  const S r2 = ur * ur;
  const S r3 = r2 * ur;
  Br[0] = (T(1) - T(3) * ur + T(3) * r2 - r3) / T(6);
  Br[1] = (T(4) - T(6) * r2 + T(3) * r3) / T(6);
  Br[2] = (T(1) + T(3) * ur + T(3) * r2 - T(3) * r3) / T(6);
  Br[3] = r3 / T(6);
}

// SE3 knot pair j (1..3) of a window win [4, 7] (q wxyz, t per knot; a
// pointer or anything indexed like one): omega = so3_log(q_rel), upsilon
// = V^-1(omega) t_rel of the relative transform.
template <typename T, typename W>
KT_HD void se3_pair(const W& win, int j, V3<T>& omega, V3<T>& ups) {
  const int a = 7 * (j - 1);
  const int b = 7 * j;
  const Q4<T> qi = qconj(Q4<T>{win[a], win[a + 1], win[a + 2], win[a + 3]});
  const V3<T> ti = qrotate(qi, V3<T>{win[a + 4], win[a + 5], win[a + 6]});
  const Q4<T> q_rel = qmul(qi, Q4<T>{win[b], win[b + 1], win[b + 2], win[b + 3]});
  const V3<T> rt = qrotate(qi, V3<T>{win[b + 4], win[b + 5], win[b + 6]});
  const V3<T> t_rel = {rt.x + -ti.x, rt.y + -ti.y, rt.z + -ti.z};
  omega = so3_log(q_rel);
  ups = Vinv_apply(omega, t_rel);
}

// SO3 knot pair j (1..3) of a cumulative window whose knot i (wxyz) starts
// at win[o + 4 i]: the vector part of logq(conj(q_{j-1}) q_j).
template <typename T, typename W>
KT_HD V3<T> so3_pair(const W& win, int o, int j) {
  const int a = o + 4 * (j - 1);
  const int b = o + 4 * j;
  const Q4<T> qa = {win[a], win[a + 1], win[a + 2], win[a + 3]};
  const Q4<T> qb = {win[b], win[b + 1], win[b + 2], win[b + 3]};
  return logq_vec(qmul(qconj(qa), qb));
}

// V_apply(b omega, b upsilon) and so3_exp_quat(b omega) for a scalar or
// Taylor2 b and constant omega, upsilon, by the formulas and guards of
// rowmath.cuh with b taken out of the vectors: theta^2 = b^2 |omega|^2,
// (b omega) x (b upsilon) = b^2 (omega x upsilon) and (b omega) x
// ((b omega) x (b upsilon)) = b^3 (omega x (omega x upsilon)), whose
// vectors do not depend on s, so only scalar functions of b run on Taylor2;
// each angle's sin and cos are taken at once.
template <typename T, typename S>
KT_HD void V_apply_exp(const S& b, const V3<T>& omega, const V3<T>& ups, V3<S>& vu,
                       Q4<S>& e) {
  const S b2 = b * b;
  const S theta2 = b2 * (omega.x * omega.x + omega.y * omega.y + omega.z * omega.z);
  S a, c, k, w;
  if (val(theta2) <= T(kEps3)) {
    a = T(0.5) - theta2 / T(24);
    c = T(1.0 / 6.0) - theta2 / T(120);
    k = T(0.5) - theta2 / T(48);
    w = T(1) - theta2 / T(8);
  } else {
    const S theta = kt_sqrt(theta2);
    T st, ct;
    kt_sincos(val(theta), &st, &ct);
    const S sin_t = chain2(st, ct, -st, theta);
    const S cos_t = chain2(ct, -st, -ct, theta);
    a = (T(1) - cos_t) / theta2;
    c = (theta - sin_t) / (theta2 * theta);
    const S half = T(0.5) * theta;
    T sh, ch;
    kt_sincos(val(half), &sh, &ch);
    k = chain2(sh, ch, -sh, half) / theta;
    w = chain2(ch, -sh, -ch, half);
  }
  const V3<T> c1 = cross(omega, ups);
  const V3<T> c2 = cross(omega, c1);
  const S ab = a * b2, cb = c * (b2 * b), kb = k * b;
  vu = {b * ups.x + ab * c1.x + cb * c2.x, b * ups.y + ab * c1.y + cb * c2.y,
        b * ups.z + ab * c1.z + cb * c2.z};
  e = {w, kb * omega.x, kb * omega.y, kb * omega.z};
}

// One step of the SE3 products: Pt += R(Pq) vu, Pq = Pq e.
template <typename S>
KT_HD void se3_step(const V3<S>& vu, const Q4<S>& e, V3<S>& Pt, Q4<S>& Pq) {
  const V3<S> rt2 = qrotate(Pq, vu);
  Pt = {Pt.x + rt2.x, Pt.y + rt2.y, Pt.z + rt2.z};
  Pq = qmul(Pq, e);
}

}  // namespace
