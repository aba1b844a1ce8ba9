// Forward-mode dual numbers for the port's CUDA kernels.
//
// Jet<T, N> carries a value and N tangents, the way ceres::Jet
// differentiates the reference. Functions are __host__ __device__ so the
// per-row math also compiles as plain C++ for checks off the card.
#pragma once

#include <math.h>

#ifdef __CUDACC__
#define KT_HD __host__ __device__ __forceinline__
#else
#define KT_HD inline
#endif

template <typename T, int N>
struct Jet {
  T a;     // value
  T v[N];  // tangents
  KT_HD Jet() {}
  KT_HD explicit Jet(T x) : a(x) {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = T(0);
  }
};

// The base scalar type of a scalar or a Jet.
template <typename S>
struct BaseT { using type = S; };
template <typename T, int N>
struct BaseT<Jet<T, N>> { using type = T; };

// A value with tangent 1 in slot `idx` (no tangent if idx is outside [0, N)).
template <typename T, int N>
KT_HD Jet<T, N> seeded(T x, int idx) {
  Jet<T, N> r(x);
#pragma unroll
  for (int i = 0; i < N; ++i) r.v[i] = (i == idx) ? T(1) : T(0);
  return r;
}

KT_HD float val(float x) { return x; }
KT_HD double val(double x) { return x; }
template <typename T, int N>
KT_HD T val(const Jet<T, N>& x) { return x.a; }

// ---- arithmetic --------------------------------------------------------

template <typename T, int N>
KT_HD Jet<T, N> operator+(const Jet<T, N>& x, const Jet<T, N>& y) {
  Jet<T, N> r;
  r.a = x.a + y.a;
#pragma unroll
  for (int i = 0; i < N; ++i) r.v[i] = x.v[i] + y.v[i];
  return r;
}

template <typename T, int N>
KT_HD Jet<T, N> operator-(const Jet<T, N>& x, const Jet<T, N>& y) {
  Jet<T, N> r;
  r.a = x.a - y.a;
#pragma unroll
  for (int i = 0; i < N; ++i) r.v[i] = x.v[i] - y.v[i];
  return r;
}

template <typename T, int N>
KT_HD Jet<T, N> operator-(const Jet<T, N>& x) {
  Jet<T, N> r;
  r.a = -x.a;
#pragma unroll
  for (int i = 0; i < N; ++i) r.v[i] = -x.v[i];
  return r;
}

template <typename T, int N>
KT_HD Jet<T, N> operator*(const Jet<T, N>& x, const Jet<T, N>& y) {
  Jet<T, N> r;
  r.a = x.a * y.a;
#pragma unroll
  for (int i = 0; i < N; ++i) r.v[i] = x.v[i] * y.a + x.a * y.v[i];
  return r;
}

template <typename T, int N>
KT_HD Jet<T, N> operator/(const Jet<T, N>& x, const Jet<T, N>& y) {
  Jet<T, N> r;
  const T inv = T(1) / y.a;
  r.a = x.a * inv;
#pragma unroll
  for (int i = 0; i < N; ++i) r.v[i] = (x.v[i] - r.a * y.v[i]) * inv;
  return r;
}

template <typename T, int N>
KT_HD Jet<T, N> operator+(const Jet<T, N>& x, T y) {
  Jet<T, N> r = x;
  r.a = x.a + y;
  return r;
}

template <typename T, int N>
KT_HD Jet<T, N> operator+(T x, const Jet<T, N>& y) {
  Jet<T, N> r = y;
  r.a = x + y.a;
  return r;
}

template <typename T, int N>
KT_HD Jet<T, N> operator-(const Jet<T, N>& x, T y) {
  Jet<T, N> r = x;
  r.a = x.a - y;
  return r;
}

template <typename T, int N>
KT_HD Jet<T, N> operator-(T x, const Jet<T, N>& y) {
  Jet<T, N> r;
  r.a = x - y.a;
#pragma unroll
  for (int i = 0; i < N; ++i) r.v[i] = -y.v[i];
  return r;
}

template <typename T, int N>
KT_HD Jet<T, N> operator*(const Jet<T, N>& x, T y) {
  Jet<T, N> r;
  r.a = x.a * y;
#pragma unroll
  for (int i = 0; i < N; ++i) r.v[i] = x.v[i] * y;
  return r;
}

template <typename T, int N>
KT_HD Jet<T, N> operator*(T x, const Jet<T, N>& y) {
  Jet<T, N> r;
  r.a = x * y.a;
#pragma unroll
  for (int i = 0; i < N; ++i) r.v[i] = x * y.v[i];
  return r;
}

template <typename T, int N>
KT_HD Jet<T, N> operator/(const Jet<T, N>& x, T y) {
  Jet<T, N> r;
  r.a = x.a / y;
#pragma unroll
  for (int i = 0; i < N; ++i) r.v[i] = x.v[i] / y;
  return r;
}

template <typename T, int N>
KT_HD Jet<T, N> operator/(T x, const Jet<T, N>& y) {
  Jet<T, N> r;
  r.a = x / y.a;
  const T d = -r.a / y.a;
#pragma unroll
  for (int i = 0; i < N; ++i) r.v[i] = d * y.v[i];
  return r;
}

// ---- elementary functions (CUDA's own on the card) --------------------

KT_HD float kt_sqrt(float x) { return sqrtf(x); }
KT_HD double kt_sqrt(double x) { return sqrt(x); }
KT_HD float kt_sin(float x) { return sinf(x); }
KT_HD double kt_sin(double x) { return sin(x); }
KT_HD float kt_cos(float x) { return cosf(x); }
KT_HD double kt_cos(double x) { return cos(x); }
KT_HD float kt_atan(float x) { return atanf(x); }
KT_HD double kt_atan(double x) { return atan(x); }
KT_HD float kt_atan2(float y, float x) { return atan2f(y, x); }
KT_HD double kt_atan2(double y, double x) { return atan2(y, x); }
KT_HD float kt_floor(float x) { return floorf(x); }
KT_HD double kt_floor(double x) { return floor(x); }
KT_HD float kt_abs(float x) { return fabsf(x); }
KT_HD double kt_abs(double x) { return fabs(x); }

template <typename T, int N>
KT_HD Jet<T, N> kt_sqrt(const Jet<T, N>& x) {
  Jet<T, N> r;
  r.a = kt_sqrt(x.a);
  const T d = T(0.5) / r.a;
#pragma unroll
  for (int i = 0; i < N; ++i) r.v[i] = d * x.v[i];
  return r;
}

template <typename T, int N>
KT_HD Jet<T, N> kt_sin(const Jet<T, N>& x) {
  Jet<T, N> r;
  r.a = kt_sin(x.a);
  const T d = kt_cos(x.a);
#pragma unroll
  for (int i = 0; i < N; ++i) r.v[i] = d * x.v[i];
  return r;
}

template <typename T, int N>
KT_HD Jet<T, N> kt_cos(const Jet<T, N>& x) {
  Jet<T, N> r;
  r.a = kt_cos(x.a);
  const T d = -kt_sin(x.a);
#pragma unroll
  for (int i = 0; i < N; ++i) r.v[i] = d * x.v[i];
  return r;
}

template <typename T, int N>
KT_HD Jet<T, N> kt_atan(const Jet<T, N>& x) {
  Jet<T, N> r;
  r.a = kt_atan(x.a);
  const T d = T(1) / (T(1) + x.a * x.a);
#pragma unroll
  for (int i = 0; i < N; ++i) r.v[i] = d * x.v[i];
  return r;
}

template <typename T, int N>
KT_HD Jet<T, N> kt_atan2(const Jet<T, N>& y, const Jet<T, N>& x) {
  Jet<T, N> r;
  r.a = kt_atan2(y.a, x.a);
  const T d = T(1) / (x.a * x.a + y.a * y.a);
#pragma unroll
  for (int i = 0; i < N; ++i) r.v[i] = (x.a * y.v[i] - y.a * x.v[i]) * d;
  return r;
}

// ---- second-order Taylor numbers in one direction ----------------------
//
// Taylor2<T> carries f(s) = a + d s + e s^2 / 2 as (a, d = f'(0),
// e = f''(0)): the value and the first two derivatives along one seed, the
// nested forward mode the TPU kernels take as jvp(jvp(f)). The query
// kernel (eval_windows.cu) seeds the time shift s with it.

template <typename T>
struct Taylor2 {
  T a, d, e;
  KT_HD Taylor2() {}
  KT_HD explicit Taylor2(T x) : a(x), d(T(0)), e(T(0)) {}
  KT_HD Taylor2(T x, T dx, T ex) : a(x), d(dx), e(ex) {}
};

template <typename T>
struct BaseT<Taylor2<T>> { using type = T; };

template <typename T>
KT_HD T val(const Taylor2<T>& x) { return x.a; }

template <typename T>
KT_HD Taylor2<T> operator+(const Taylor2<T>& x, const Taylor2<T>& y) {
  return {x.a + y.a, x.d + y.d, x.e + y.e};
}

template <typename T>
KT_HD Taylor2<T> operator-(const Taylor2<T>& x, const Taylor2<T>& y) {
  return {x.a - y.a, x.d - y.d, x.e - y.e};
}

template <typename T>
KT_HD Taylor2<T> operator-(const Taylor2<T>& x) { return {-x.a, -x.d, -x.e}; }

template <typename T>
KT_HD Taylor2<T> operator*(const Taylor2<T>& x, const Taylor2<T>& y) {
  return {x.a * y.a, x.d * y.a + x.a * y.d,
          x.e * y.a + T(2) * (x.d * y.d) + x.a * y.e};
}

template <typename T>
KT_HD Taylor2<T> operator/(const Taylor2<T>& x, const Taylor2<T>& y) {
  Taylor2<T> r;
  r.a = x.a / y.a;
  r.d = (x.d - r.a * y.d) / y.a;
  r.e = (x.e - T(2) * (r.d * y.d) - r.a * y.e) / y.a;
  return r;
}

template <typename T>
KT_HD Taylor2<T> operator+(const Taylor2<T>& x, T y) { return {x.a + y, x.d, x.e}; }
template <typename T>
KT_HD Taylor2<T> operator+(T x, const Taylor2<T>& y) { return {x + y.a, y.d, y.e}; }
template <typename T>
KT_HD Taylor2<T> operator-(const Taylor2<T>& x, T y) { return {x.a - y, x.d, x.e}; }
template <typename T>
KT_HD Taylor2<T> operator-(T x, const Taylor2<T>& y) { return {x - y.a, -y.d, -y.e}; }
template <typename T>
KT_HD Taylor2<T> operator*(const Taylor2<T>& x, T y) { return {x.a * y, x.d * y, x.e * y}; }
template <typename T>
KT_HD Taylor2<T> operator*(T x, const Taylor2<T>& y) { return {x * y.a, x * y.d, x * y.e}; }
template <typename T>
KT_HD Taylor2<T> operator/(const Taylor2<T>& x, T y) { return {x.a / y, x.d / y, x.e / y}; }

template <typename T>
KT_HD Taylor2<T> operator/(T x, const Taylor2<T>& y) {
  Taylor2<T> r;
  r.a = x / y.a;
  r.d = -(r.a * y.d) / y.a;
  r.e = -(T(2) * (r.d * y.d) + r.a * y.e) / y.a;
  return r;
}

// f(x) for f with derivatives f1 = f'(x.a), f2 = f''(x.a)
template <typename T>
KT_HD Taylor2<T> chain2(T fa, T f1, T f2, const Taylor2<T>& x) {
  return {fa, f1 * x.d, f2 * (x.d * x.d) + f1 * x.e};
}

// the same for a plain scalar x: the value
template <typename T>
KT_HD T chain2(T fa, T, T, T) { return fa; }

template <typename T>
KT_HD Taylor2<T> kt_sqrt(const Taylor2<T>& x) {
  const T r = kt_sqrt(x.a);
  const T f1 = T(0.5) / r;
  return chain2(r, f1, -f1 / (T(2) * x.a), x);
}

template <typename T>
KT_HD Taylor2<T> kt_sin(const Taylor2<T>& x) {
  const T s = kt_sin(x.a);
  return chain2(s, kt_cos(x.a), -s, x);
}

template <typename T>
KT_HD Taylor2<T> kt_cos(const Taylor2<T>& x) {
  const T c = kt_cos(x.a);
  return chain2(c, -kt_sin(x.a), -c, x);
}

template <typename T>
KT_HD Taylor2<T> kt_atan(const Taylor2<T>& x) {
  const T f1 = T(1) / (T(1) + x.a * x.a);
  return chain2(kt_atan(x.a), f1, -T(2) * x.a * (f1 * f1), x);
}

template <typename T>
KT_HD Taylor2<T> kt_atan2(const Taylor2<T>& y, const Taylor2<T>& x) {
  Taylor2<T> r;
  const T n = x.a * x.a + y.a * y.a;
  r.a = kt_atan2(y.a, x.a);
  r.d = (x.a * y.d - y.a * x.d) / n;
  const T dn = T(2) * (x.a * x.d + y.a * y.d);
  r.e = (x.a * y.e - y.a * x.e - r.d * dn) / n;
  return r;
}

// ---- first-order duals in time over any scalar --------------------------
//
// TD<S> carries f(t) = a + d t to first order in one direction, the time,
// with parts a and d of any scalar type S: a plain T, or a Jet<T, N> over
// parameter seeds, so that d's tangents are the mixed second derivatives
// (parameters x time). It is jvp in time inside forward mode over the
// seeds, as the TPU tile nests jax.jvp inside jax.linearize. B8's Newton
// rows (newton_rows.cuh) evaluate the observed window on it. A plain T or
// an S mixes with a TD as a constant in time.

template <typename S>
struct TD {
  S a, d;
  KT_HD TD() {}
  KT_HD TD(const S& x, const S& dx) : a(x), d(dx) {}
  // a constant in time, from a T or an S
  template <typename U>
  KT_HD TD(const U& x) : a(x), d(typename BaseT<S>::type(0)) {}
};

template <typename S>
struct BaseT<TD<S>> { using type = typename BaseT<S>::type; };

template <typename S>
KT_HD auto val(const TD<S>& x) { return val(x.a); }

template <typename S>
KT_HD TD<S> operator+(const TD<S>& x, const TD<S>& y) { return {x.a + y.a, x.d + y.d}; }
template <typename S>
KT_HD TD<S> operator-(const TD<S>& x, const TD<S>& y) { return {x.a - y.a, x.d - y.d}; }
template <typename S>
KT_HD TD<S> operator-(const TD<S>& x) { return {-x.a, -x.d}; }
template <typename S>
KT_HD TD<S> operator*(const TD<S>& x, const TD<S>& y) {
  return {x.a * y.a, x.d * y.a + x.a * y.d};
}
template <typename S>
KT_HD TD<S> operator/(const TD<S>& x, const TD<S>& y) {
  const S q = x.a / y.a;
  return {q, (x.d - q * y.d) / y.a};
}

// with a constant in time (a T or an S)
template <typename S, typename U>
KT_HD TD<S> operator+(const TD<S>& x, const U& y) { return {x.a + y, x.d}; }
template <typename S, typename U>
KT_HD TD<S> operator+(const U& x, const TD<S>& y) { return {x + y.a, y.d}; }
template <typename S, typename U>
KT_HD TD<S> operator-(const TD<S>& x, const U& y) { return {x.a - y, x.d}; }
template <typename S, typename U>
KT_HD TD<S> operator-(const U& x, const TD<S>& y) { return {x - y.a, -y.d}; }
template <typename S, typename U>
KT_HD TD<S> operator*(const TD<S>& x, const U& y) { return {x.a * y, x.d * y}; }
template <typename S, typename U>
KT_HD TD<S> operator*(const U& x, const TD<S>& y) { return {x * y.a, x * y.d}; }
template <typename S, typename U>
KT_HD TD<S> operator/(const TD<S>& x, const U& y) { return {x.a / y, x.d / y}; }
template <typename S, typename U>
KT_HD TD<S> operator/(const U& x, const TD<S>& y) {
  const S q = x / y.a;
  return {q, -(q * y.d) / y.a};
}

template <typename S>
KT_HD TD<S> kt_sqrt(const TD<S>& x) {
  const S r = kt_sqrt(x.a);
  return {r, x.d / (typename BaseT<S>::type(2) * r)};
}
template <typename S>
KT_HD TD<S> kt_sin(const TD<S>& x) { return {kt_sin(x.a), kt_cos(x.a) * x.d}; }
template <typename S>
KT_HD TD<S> kt_cos(const TD<S>& x) { return {kt_cos(x.a), -(kt_sin(x.a) * x.d)}; }
template <typename S>
KT_HD TD<S> kt_atan(const TD<S>& x) {
  return {kt_atan(x.a), x.d / (typename BaseT<S>::type(1) + x.a * x.a)};
}
