// Batched spline-window evaluation for Hopper (sm_90a): the trajectory
// queries' kernel (B5).
//
// Replaces the Pallas TPU kernel kontiki_tpu/ops/linearize_kernels.py
// evaluate_windows -> _eval_call / _make_eval_kernel / _tile_eval. Its plain
// PyTorch version is kontiki_tpu_torch/ops/linearize_kernels.py
// evaluate_windows_plain (the window functions of trajectories/spline_eval
// with the queries as the batch dimension), which the wrapper runs for CPU
// tensors.
//
// Per query m, from its gathered 4-knot window win[m] ([4, D] row-major)
// and interpolation amount u[m], with the knot spacing dt:
//   r3  (D = 3): p, v, a                  (K = 9 outputs)
//   so3 (D = 4): q (wxyz), w              (K = 7)
//   se3 (D = 7): p, v, a, q, w            (K = 16)
// v and a are the first and second derivatives in the time shift s
// (u_eff = u + s/dt), w = 2 vec(dq/ds q*) is the world angular velocity.
// SE3's a is the translation of P'', as in the reference (not body
// acceleration).
//
// Design: one thread per query, no padding (the TPU kernel pads to
// 128-query tiles with dt = 1 on the pad lanes; here the ragged edge is
// masked by the thread index). The time derivatives are forward mode in s,
// as the TPU kernel takes them with jvp:
//   - r3: the standard basis and its analytic derivatives (rowmath.cuh
//     r3_basis);
//   - so3: the cumulative window chain on Jet<T, 1> seeded in s (first
//     derivative only);
//   - se3: B1's SE3 window chain (rowmath.cuh pq_se3, zero increments) on
//     Taylor2<T> (jet.cuh) seeded in s, which carries the second
//     derivative that a needs.
// The row code is __host__ __device__, so csrc/host_rows.cpp builds it for
// the host (checks without a card, operation counts for the bound).
//
// Bound: bytes. A query reads 4 D + 1 values and writes K (r3 22, so3 24,
// se3 45 in f64, 176-360 bytes); at the 4.8 M row times of a 10,000-frame
// rolling-shutter sequence that is 0.85-1.73 GB, 0.25-0.52 ms at 3.35
// TB/s. The se3 chain needs ~10^3 float64 operations per query (counted on
// the host), ~0.1 ms at 67 TFLOP/s. A thread reads its window as 4 D
// consecutive values, so a warp's loads are strided by 4 D values; L1 and
// L2 keep every byte of the lines fetched in use.
#include "rowmath.cuh"

namespace {

// kinds of the C entry point
constexpr int kEvalR3 = 0;
constexpr int kEvalSo3 = 1;
constexpr int kEvalSe3 = 2;

constexpr KT_HD int eval_knot_dim(int kind) {
  return kind == kEvalR3 ? 3 : kind == kEvalSo3 ? 4 : 7;
}

// world angular velocity 2 vec(dq q*) from q and dq/ds
template <typename T>
KT_HD void omega_from(const Q4<T>& q, const Q4<T>& dq, T* w) {
  const Q4<T> wq = qmul(dq, qconj(q));
  w[0] = T(2) * wq.x;
  w[1] = T(2) * wq.y;
  w[2] = T(2) * wq.z;
}

// r3 query: win [4, 3]; out p, v, a (each 3)
template <typename T>
KT_HD void eval_r3_row(const T* win, T u, T dt, T* p, T* v, T* a) {
  T B[4], dB[4], d2B[4];
  r3_basis(u, dt, B, dB, d2B);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    T pk = B[0] * win[k], vk = dB[0] * win[k], ak = d2B[0] * win[k];
#pragma unroll
    for (int j = 1; j < 4; ++j) {
      pk = pk + B[j] * win[3 * j + k];
      vk = vk + dB[j] * win[3 * j + k];
      ak = ak + d2B[j] * win[3 * j + k];
    }
    p[k] = pk;
    v[k] = vk;
    a[k] = ak;
  }
}

// so3 query: win [4, 4] wxyz; out q (4), w (3)
template <typename T>
KT_HD void eval_so3_row(const T* win, T u, T dt, T* q_out, T* w_out) {
  using S = Jet<T, 1>;
  const S s = seeded<T, 1>(T(0), 0);
  const S ue = u + s / dt;
  const S u2 = ue * ue;
  const S u3 = u2 * ue;
  const S B[3] = {(T(5) + T(3) * ue - T(3) * u2 + u3) / T(6),
                  (T(1) + T(3) * ue + T(3) * u2 - T(2) * u3) / T(6),
                  u3 / T(6)};
  Q4<S> q = {S(win[0]), S(win[1]), S(win[2]), S(win[3])};
#pragma unroll
  for (int j = 1; j < 4; ++j) {
    const Q4<T> qa = {win[4 * j - 4], win[4 * j - 3], win[4 * j - 2], win[4 * j - 1]};
    const Q4<T> qb = {win[4 * j], win[4 * j + 1], win[4 * j + 2], win[4 * j + 3]};
    const V3<T> w3 = logq_vec(qmul(qconj(qa), qb));
    const S b = B[j - 1];
    q = qmul(q, expq_pure(V3<S>{b * w3.x, b * w3.y, b * w3.z}));
  }
  const Q4<T> qv = {q.w.a, q.x.a, q.y.a, q.z.a};
  const Q4<T> dq = {q.w.v[0], q.x.v[0], q.y.v[0], q.z.v[0]};
  q_out[0] = qv.w; q_out[1] = qv.x; q_out[2] = qv.y; q_out[3] = qv.z;
  omega_from(qv, dq, w_out);
}

// se3 query: win [4, 7] packed (q wxyz, t); out p, v, a (3 each), q (4), w (3)
template <typename T>
KT_HD void eval_se3_row(const T* win, T u, T dt, T* p, T* v, T* a, T* q_out,
                        T* w_out) {
  using S = Taylor2<T>;
  S delta[24], out[7];
#pragma unroll
  for (int k = 0; k < 24; ++k) delta[k] = S(T(0));
  const S s(T(0), T(1), T(0));
  pq_se3<T, S>(win, u, dt, delta, s, out);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    p[k] = out[k].a;
    v[k] = out[k].d;
    a[k] = out[k].e;
  }
  const Q4<T> qv = {out[3].a, out[4].a, out[5].a, out[6].a};
  const Q4<T> dq = {out[3].d, out[4].d, out[5].d, out[6].d};
  q_out[0] = qv.w; q_out[1] = qv.x; q_out[2] = qv.y; q_out[3] = qv.z;
  omega_from(qv, dq, w_out);
}

// Query m of the batch: win_m points at its [4, D] window; outs are the
// kind's outputs ([M, k] each, row-major).
template <typename T>
KT_HD void eval_row(int kind, const T* win_m, T u, T dt, T* const* outs, int m) {
  const size_t i3 = 3 * static_cast<size_t>(m), i4 = 4 * static_cast<size_t>(m);
  if (kind == kEvalR3) {
    eval_r3_row(win_m, u, dt, outs[0] + i3, outs[1] + i3, outs[2] + i3);
  } else if (kind == kEvalSo3) {
    eval_so3_row(win_m, u, dt, outs[0] + i4, outs[1] + i3);
  } else {
    eval_se3_row(win_m, u, dt, outs[0] + i3, outs[1] + i3, outs[2] + i3, outs[3] + i4,
                 outs[4] + i3);
  }
}

}  // namespace

#ifdef __CUDACC__

#include <cuda_runtime.h>

template <typename T>
struct EvalOuts {
  T* o[5];
};

template <typename T, int Kind>
__global__ void __launch_bounds__(128) eval_windows_kernel(
    const T* __restrict__ win, const T* __restrict__ u, T dt, EvalOuts<T> outs, int M) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= M) return;
  constexpr int D = eval_knot_dim(Kind);
  T w[4 * D];
#pragma unroll
  for (int k = 0; k < 4 * D; ++k) w[k] = win[static_cast<size_t>(m) * 4 * D + k];
  eval_row<T>(Kind, w, u[m], dt, outs.o, m);
}

template <typename T>
static int launch_eval(int kind, const void* win, const void* u, double dt,
                       void* const* outs, int M, void* stream) {
  EvalOuts<T> o;
  const int n_out = kind == kEvalR3 ? 3 : kind == kEvalSo3 ? 2 : 5;
  for (int i = 0; i < 5; ++i) o.o[i] = i < n_out ? static_cast<T*>(outs[i]) : nullptr;
  const int threads = 128;
  const int blocks = (M + threads - 1) / threads;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* w = static_cast<const T*>(win);
  const T* up = static_cast<const T*>(u);
  if (kind == kEvalR3) {
    eval_windows_kernel<T, kEvalR3><<<blocks, threads, 0, st>>>(w, up, T(dt), o, M);
  } else if (kind == kEvalSo3) {
    eval_windows_kernel<T, kEvalSo3><<<blocks, threads, 0, st>>>(w, up, T(dt), o, M);
  } else if (kind == kEvalSe3) {
    eval_windows_kernel<T, kEvalSe3><<<blocks, threads, 0, st>>>(w, up, T(dt), o, M);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// kind: 0 r3, 1 so3, 2 se3; win [M, 4, D], u [M]; outs: the kind's output
// pointers in order (r3 p, v, a; so3 q, w; se3 p, v, a, q, w).
extern "C" int kontiki_eval_windows_f32(int kind, const void* win, const void* u,
                                        double dt, void* const* outs, int M,
                                        void* stream) {
  return launch_eval<float>(kind, win, u, dt, outs, M, stream);
}

extern "C" int kontiki_eval_windows_f64(int kind, const void* win, const void* u,
                                        double dt, void* const* outs, int M,
                                        void* stream) {
  return launch_eval<double>(kind, win, u, dt, outs, M, stream);
}

#endif  // __CUDACC__
