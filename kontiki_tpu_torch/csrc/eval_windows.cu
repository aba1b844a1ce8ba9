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
// Design: one thread per query in blocks of 128, no padding (the TPU
// kernel pads to 128-query tiles with dt = 1 on the pad lanes; here the
// ragged last block masks by its query count). The time derivatives are
// forward mode in s, as the TPU kernel takes them with jvp:
//   - r3: the standard basis and its analytic derivatives (rowmath.cuh
//     r3_basis);
//   - so3: the cumulative window chain on Jet<T, 1> seeded in s (first
//     derivative only), the knot pairs' logs on plain scalars;
//   - se3: the chain of window_chain.cuh, which B3 shares: the knot pairs'
//     relative transforms, so3_log and V^-1 on plain scalars (se3_pair),
//     and only the tail on Taylor2<T> (jet.cuh) seeded in s, which carries
//     the second derivative that a needs (se3_tail). Carrying the
//     knot-only part on Taylor2 too would triple its values and add every
//     one of its transcendentals' derivatives, all exactly zero.
// Memory: a block stages its [128, 4 D] windows (contiguous in the input)
// and u in shared memory with 16-byte loads, consecutive threads on
// consecutive addresses (stage_windows), at an odd stride per query so a
// thread's reads of its own window hit distinct banks; a thread's outputs
// go back into the same shared memory and each output's [128, k] slice of
// the block leaves as stores of consecutive addresses (a thread reading
// its own window from global memory touches 32 lines per warp load).
// cp.async staging measured no faster.
// In frame order a warp's 32 queries nearly always share a window (a
// frame's 480 rows span 0.02 s of a 0.1 s knot interval), so for se3 the
// warp checks that by shuffles and lanes 0-2 compute one knot pair each,
// handed over by shuffles (eval_se3_warp); shuffled queries compute their
// own pairs.
// The row code is __host__ __device__, so csrc/host_rows.cpp builds it for
// the host (checks without a card, operation counts for the bound).
//
// Bound: bytes. A query reads 4 D + 1 values and writes K (r3 22, so3 24,
// se3 45 in f64, 176-360 bytes); at the 4.8 M row times of a 10,000-frame
// rolling-shutter sequence that is 0.85-1.73 GB, 0.25-0.52 ms at 3.35
// TB/s. The se3 chain needs ~2.8 k float64 operations per query (counted
// on the host), ~0.2 ms at 67 TFLOP/s, but f64 sin/cos/atan/sqrt are
// long instruction sequences (each counted as one operation), so se3 is
// bound by the arithmetic in practice and r3/so3 by bytes.
#include "window_chain.cuh"

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
  S B[3];
  cumulative_basis<T>(u + s / dt, B);
  Q4<S> q = {S(win[0]), S(win[1]), S(win[2]), S(win[3])};
#pragma unroll
  for (int j = 1; j < 4; ++j) {
    const V3<T> w3 = so3_pair<T>(win, 0, j);
    const S b = B[j - 1];
    q = qmul(q, expq_pure(V3<S>{b * w3.x, b * w3.y, b * w3.z}));
  }
  const Q4<T> qv = {q.w.a, q.x.a, q.y.a, q.z.a};
  const Q4<T> dq = {q.w.v[0], q.x.v[0], q.y.v[0], q.z.v[0]};
  q_out[0] = qv.w; q_out[1] = qv.x; q_out[2] = qv.y; q_out[3] = qv.z;
  omega_from(qv, dq, w_out);
}

// se3 query: win [4, 7] packed (q wxyz, t); o its p, v, a (3 each), q (4),
// w (3). pq_se3's chain at zero increments, split by what depends on the
// time shift s: the knots as read and, for each knot pair, the relative
// transform, its so3_log and V^-1 (se3_pair, on T: their s-derivatives are
// exactly zero, so carrying them as Taylor2 only multiplied the work); then
// the tail on Taylor2<T> seeded in s (se3_tail): B(u + s/dt), V_apply and
// so3_exp_quat of b omega (V_apply_exp), the rotation by Pq and the
// cumulative products. Same formulas and guards as pq_se3 (the tail's
// vector products regrouped), so the outputs change by rounding only.
template <typename T>
KT_HD void se3_tail(const T* win, T u, T dt, const V3<T>* omega, const V3<T>* ups, T* o) {
  using S = Taylor2<T>;
  const S s(T(0), T(1), T(0));
  S B[3];
  cumulative_basis<T>(u + s / dt, B);
  Q4<S> Pq = {S(win[0]), S(win[1]), S(win[2]), S(win[3])};
  V3<S> Pt = {S(win[4]), S(win[5]), S(win[6])};
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    V3<S> vu;
    Q4<S> e;
    V_apply_exp(B[j], omega[j], ups[j], vu, e);
    se3_step(vu, e, Pt, Pq);
  }
  const S pt[3] = {Pt.x, Pt.y, Pt.z};
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    o[k] = pt[k].a;
    o[3 + k] = pt[k].d;
    o[6 + k] = pt[k].e;
  }
  const Q4<T> qv = {Pq.w.a, Pq.x.a, Pq.y.a, Pq.z.a};
  const Q4<T> dq = {Pq.w.d, Pq.x.d, Pq.y.d, Pq.z.d};
  o[9] = qv.w; o[10] = qv.x; o[11] = qv.y; o[12] = qv.z;
  omega_from(qv, dq, o + 13);
}

template <typename T>
KT_HD void eval_se3_row(const T* win, T u, T dt, T* o) {
  V3<T> omega[3], ups[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) se3_pair(win, j + 1, omega[j], ups[j]);
  se3_tail(win, u, dt, omega, ups, o);
}

// Output widths of a kind, in order (r3 p, v, a; so3 q, w; se3 p, v, a,
// q, w), and their sum K, a query's values.
constexpr KT_HD int eval_n_outs(int kind) {
  return kind == kEvalR3 ? 3 : kind == kEvalSo3 ? 2 : 5;
}
constexpr KT_HD int eval_out_width(int kind, int i) {
  return (kind == kEvalSo3 ? i == 0 : kind == kEvalSe3 && i == 3) ? 4 : 3;
}
constexpr KT_HD int eval_out_total(int kind) {
  return kind == kEvalR3 ? 9 : kind == kEvalSo3 ? 7 : 16;
}

// One query: win its [4, D] window; o its K values, the outputs in order.
template <typename T>
KT_HD void eval_query(int kind, const T* win, T u, T dt, T* o) {
  if (kind == kEvalR3) {
    eval_r3_row(win, u, dt, o, o + 3, o + 6);
  } else if (kind == kEvalSo3) {
    eval_so3_row(win, u, dt, o, o + 4);
  } else {
    eval_se3_row(win, u, dt, o);
  }
}

// Query m of the batch: win_m points at its [4, D] window; outs are the
// kind's outputs ([M, k] each, row-major).
template <typename T>
KT_HD void eval_row(int kind, const T* win_m, T u, T dt, T* const* outs, int m) {
  T o[16];
  eval_query(kind, win_m, u, dt, o);
  for (int i = 0, off = 0; i < eval_n_outs(kind); off += eval_out_width(kind, i++)) {
    const int k = eval_out_width(kind, i);
    for (int c = 0; c < k; ++c) outs[i][static_cast<size_t>(m) * k + c] = o[off + c];
  }
}

}  // namespace

#ifdef __CUDACC__

#include <cuda_runtime.h>

// KT_EVAL_WARP_SHARE=0 builds se3 without the warp-shared knot pairs, every
// lane on its own three (tools/kernel_ab.py times the two builds).
#ifndef KT_EVAL_WARP_SHARE
#define KT_EVAL_WARP_SHARE 1
#endif

template <typename T>
struct EvalOuts {
  T* o[5];
};

constexpr int kEvalThreads = 128;  // queries a block, one a thread

// The block's n window values, contiguous at src, into shared dst at a
// stride of W + 1 a window (odd, so the threads of a warp reading their own
// windows hit distinct banks): 16-byte loads where src allows, consecutive
// threads on consecutive addresses, all of a full block's loads issued
// before the first store.
template <typename T, int W>
__device__ __forceinline__ void stage_windows(const T* __restrict__ src, int n, T* dst) {
  constexpr int V = 16 / sizeof(T);  // values a 16-byte load
  constexpr int P = W + 1;
  const int t = threadIdx.x;
  int done = 0;
  if (reinterpret_cast<unsigned long long>(src) % 16 == 0) {
    const int4* s = reinterpret_cast<const int4*>(src);
    if (n == kEvalThreads * W) {
      int4 x[W / V];
#pragma unroll
      for (int r = 0; r < W / V; ++r) x[r] = __ldg(s + r * kEvalThreads + t);
#pragma unroll
      for (int r = 0; r < W / V; ++r) {
        const T* xv = reinterpret_cast<const T*>(&x[r]);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const int e = (r * kEvalThreads + t) * V + j;
          dst[e / W * P + e % W] = xv[j];
        }
      }
      return;
    }
    for (int i = t; i < n / V; i += kEvalThreads) {
      const int4 x = __ldg(s + i);
      const T* xv = reinterpret_cast<const T*>(&x);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const int e = i * V + j;
        dst[e / W * P + e % W] = xv[j];
      }
    }
    done = n / V * V;
  }
  for (int e = done + t; e < n; e += kEvalThreads) dst[e / W * P + e % W] = src[e];
}

// se3 in the kernel, all 32 lanes of a warp: when they hold one window (the
// frame order, where a frame's rows fall between the same knots), lanes
// 0-2 each compute one knot pair and hand its omega and upsilon over by
// shuffles, which takes two pairs' chains off every lane; otherwise each
// lane computes its three. The other 27 values are compared only when the
// first agrees on every lane, so shuffled queries pay one shuffle.
template <typename T>
__device__ __forceinline__ void eval_se3_warp(const T* win, T u, T dt, T* o) {
  constexpr unsigned kAll = 0xffffffffu;
  bool same = win[0] == __shfl_sync(kAll, win[0], 0);
  if (__all_sync(kAll, same)) {
#pragma unroll
    for (int k = 1; k < 28; ++k) same = same & (win[k] == __shfl_sync(kAll, win[k], 0));
  }
  V3<T> omega[3], ups[3];
  if (__all_sync(kAll, same)) {
    V3<T> om, up;
    se3_pair(win, threadIdx.x % 32 % 3 + 1, om, up);
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      omega[j] = {__shfl_sync(kAll, om.x, j), __shfl_sync(kAll, om.y, j),
                  __shfl_sync(kAll, om.z, j)};
      ups[j] = {__shfl_sync(kAll, up.x, j), __shfl_sync(kAll, up.y, j),
                __shfl_sync(kAll, up.z, j)};
    }
  } else {
#pragma unroll
    for (int j = 0; j < 3; ++j) se3_pair(win, j + 1, omega[j], ups[j]);
  }
  se3_tail(win, u, dt, omega, ups, o);
}

// A block of kEvalThreads queries: the windows and u staged into shared
// memory (stage_windows), a thread's query read there, its K outputs back
// into the same shared values at an odd stride, and each output's
// [n, k] slice of the block written out by consecutive threads on
// consecutive addresses. The ragged last block masks by n.
template <typename T, int Kind>
__device__ __forceinline__ void eval_windows_block(const T* __restrict__ win,
                                                   const T* __restrict__ u, T dt,
                                                   const EvalOuts<T>& outs, int M) {
  constexpr int W = 4 * eval_knot_dim(Kind);
  constexpr int P = W + 1;
  constexpr int K = eval_out_total(Kind);
  constexpr int PK = K | 1;  // odd, as P
  static_assert(PK <= P, "the outputs reuse the windows' shared values");
  __shared__ T sw[kEvalThreads * P];
  __shared__ T su[kEvalThreads];
  const int t = threadIdx.x;
  const int m0 = blockIdx.x * kEvalThreads;
  const int n = M - m0 < kEvalThreads ? M - m0 : kEvalThreads;
  stage_windows<T, W>(win + static_cast<size_t>(m0) * W, n * W, sw);
  if (t < n) su[t] = u[m0 + t];
  __syncthreads();
  T o[K];
  if constexpr (Kind == kEvalSe3 && KT_EVAL_WARP_SHARE) {  // every lane, past n on n - 1
    const int tq = t < n ? t : n - 1;
    eval_se3_warp<T>(sw + tq * P, su[tq], dt, o);
  } else if (t < n) {
    eval_query<T>(Kind, sw + t * P, su[t], dt, o);
  }
  __syncthreads();
  if (t < n) {
#pragma unroll
    for (int k = 0; k < K; ++k) sw[t * PK + k] = o[k];
  }
  __syncthreads();
  int off = 0;
#pragma unroll
  for (int i = 0; i < eval_n_outs(Kind); ++i) {
    const int k = eval_out_width(Kind, i);
    T* dst = outs.o[i] + static_cast<size_t>(m0) * k;
    for (int e = t; e < n * k; e += kEvalThreads) dst[e] = sw[e / k * PK + off + e % k];
    off += k;
  }
}

template <typename T, int Kind>
__global__ void __launch_bounds__(kEvalThreads) eval_windows_kernel(
    const T* __restrict__ win, const T* __restrict__ u, T dt, EvalOuts<T> outs, int M) {
  eval_windows_block<T, Kind>(win, u, dt, outs, M);
}

// f64 se3 capped at 128 registers (24 bytes of spill), four blocks an SM:
// ~12% faster than at its own 164 registers (three blocks). The cap slows
// f32 and the other kinds (even __launch_bounds__(128, 1) changes their
// register allocation), so it has a kernel of its own.
__global__ void __launch_bounds__(kEvalThreads, 4) eval_windows_capped_kernel(
    const double* __restrict__ win, const double* __restrict__ u, double dt,
    EvalOuts<double> outs, int M) {
  eval_windows_block<double, kEvalSe3>(win, u, dt, outs, M);
}

template <typename T>
static int launch_eval(int kind, const void* win, const void* u, double dt,
                       void* const* outs, int M, void* stream) {
  EvalOuts<T> o;
  for (int i = 0; i < 5; ++i) o.o[i] = i < eval_n_outs(kind) ? static_cast<T*>(outs[i]) : nullptr;
  const int blocks = (M + kEvalThreads - 1) / kEvalThreads;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* w = static_cast<const T*>(win);
  const T* up = static_cast<const T*>(u);
  if (kind == kEvalR3) {
    eval_windows_kernel<T, kEvalR3><<<blocks, kEvalThreads, 0, st>>>(w, up, T(dt), o, M);
  } else if (kind == kEvalSo3) {
    eval_windows_kernel<T, kEvalSo3><<<blocks, kEvalThreads, 0, st>>>(w, up, T(dt), o, M);
  } else if (kind == kEvalSe3) {
    if constexpr (sizeof(T) == 8) {
      eval_windows_capped_kernel<<<blocks, kEvalThreads, 0, st>>>(w, up, T(dt), o, M);
    } else {
      eval_windows_kernel<T, kEvalSe3><<<blocks, kEvalThreads, 0, st>>>(w, up, T(dt), o, M);
    }
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
