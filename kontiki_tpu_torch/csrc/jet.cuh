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
