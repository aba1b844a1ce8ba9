// Batched R3 spline evaluation at arbitrary times for Hopper (sm_90a): the
// public ops entry point's kernel (B7).
//
// Replaces the Pallas TPU kernel kontiki_tpu/ops/spline_kernels.py
// r3_evaluate_pallas -> _r3_pallas_call / _r3_kernel. Its plain PyTorch
// version is kontiki_tpu_torch/ops/spline_kernels.py r3_evaluate_plain
// (spline_eval.index_and_u + gather_windows + r3_window), which the wrapper
// runs for CPU tensors.
//
// Per time t[b]: i0 = clamp(floor((t - t0) / dt), 0, N - 4),
// u = (t - t0) / dt - i0, and p, v, a = sum_j (B_j, dB_j, d2B_j)(u) k[i0 + j]
// with the standard cubic basis (spline_base.h:18-22).
//
// Bound: bytes. A time reads 1 value and writes 9 (80 bytes in f64), plus
// the knots once (N x 3); at the 4.8 M row times of a 10,000-frame
// rolling-shutter sequence that is 384 MB, 0.115 ms at 3.35 TB/s. The
// function needs ~60 float64 operations per time (counted on the host).
//
// Design: a block of kR3Threads threads takes kR3Times consecutive times,
// kR3PerThread consecutive ones a thread, read with 16-byte loads. The TPU
// kernel sorts the times on the host into 256-time chunks and turns each
// chunk into a banded [256, 512] x [512, 3] matmul on the MXU, falling back
// to a gather when a chunk spans more than 512 knots; none of that is
// needed here, and times in any order need no sort:
//  - knots: the block finds the span of its windows (a min/max over its
//    threads) and, when it is at most kR3KnotsMax knots (frame order: a
//    block's 1,024 times fall in 1-2 knot intervals), stages them in shared
//    memory; otherwise (shuffled times) each thread reads its windows from
//    global memory through the read-only path;
//  - outputs: p, v and a leave one at a time through shared memory, so each
//    output's contiguous [n, 3] slice of the block is written with
//    consecutive 16-byte stores (a thread's own 3 values a time would be
//    24-byte strided stores).
// The host runs the same block schedule (r3_evaluate_blocks, host_rows.cpp).
#include "rowmath.cuh"

namespace {

constexpr int kR3Threads = 256;    // threads a block
constexpr int kR3PerThread = 4;    // consecutive times a thread
constexpr int kR3Times = kR3Threads * kR3PerThread;  // times a block
constexpr int kR3KnotsMax = 64;    // knots a block stages in shared memory, at most

// Window of time t: returns i0 = clamp(floor((t - t0) / dt), 0, N - 4) and
// sets u = (t - t0) / dt - i0 (spline_eval.index_and_u).
template <typename T>
KT_HD int r3_index(T t, int N, T t0, T dt, T* u) {
  const T s = (t - t0) / dt;
  const double f = kt_floor(val(s));  // clamped before the cast: no overflow
  const int i0 = f < 0.0 ? 0 : (f > static_cast<double>(N - 4) ? N - 4 : static_cast<int>(f));
  *u = s - T(static_cast<double>(i0));
  return i0;
}

// p, v, a into o[0..2], o[3..5], o[6..8] at u from the window's 4 knots k0
// [4, 3].
template <typename T>
KT_HD void r3_values(const T* k0, T u, T dt, T* o) {
  T B[4], dB[4], d2B[4];
  r3_basis(u, dt, B, dB, d2B);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    T pk = B[0] * k0[k], vk = dB[0] * k0[k], ak = d2B[0] * k0[k];
#pragma unroll
    for (int j = 1; j < 4; ++j) {
      pk = pk + B[j] * k0[3 * j + k];
      vk = vk + dB[j] * k0[3 * j + k];
      ak = ak + d2B[j] * k0[3 * j + k];
    }
    o[k] = pk;
    o[3 + k] = vk;
    o[6 + k] = ak;
  }
}

// One time t on knots [N, 3]: p, v, a into o[0..8] (the operation count's
// unit).
template <typename T>
KT_HD void r3_time(const T* knots, int N, T t0, T dt, T t, T* o) {
  T u;
  const int i0 = r3_index(t, N, t0, dt, &u);
  r3_values(knots + 3 * static_cast<size_t>(i0), u, dt, o);
}

}  // namespace

#ifdef __CUDACC__

#include <cuda_runtime.h>

#include <climits>

template <typename T>
__global__ void __launch_bounds__(kR3Threads) r3_evaluate_kernel(
    const T* __restrict__ knots, int N, T t0, T dt, const T* __restrict__ ts, T* p, T* v,
    T* a, int B) {
  constexpr int V = 16 / sizeof(T);  // times a 16-byte load
  __shared__ __align__(16) T so[kR3Times * 3];
  __shared__ T sk[kR3KnotsMax * 3];
  __shared__ int red[2][kR3Threads / 32];
  const int t = threadIdx.x;
  const size_t b0 = static_cast<size_t>(blockIdx.x) * kR3Times;
  const int n = B - b0 < static_cast<size_t>(kR3Times) ? static_cast<int>(B - b0) : kR3Times;
  const int j0 = t * kR3PerThread;  // the thread's first time in the block

  T tv[kR3PerThread];
  const T* tb = ts + b0;
  if (n == kR3Times && reinterpret_cast<unsigned long long>(tb) % 16 == 0) {
#pragma unroll
    for (int l = 0; l < kR3PerThread / V; ++l) {
      const int4 x = __ldg(reinterpret_cast<const int4*>(tb + j0) + l);
      const T* xv = reinterpret_cast<const T*>(&x);
#pragma unroll
      for (int q = 0; q < V; ++q) tv[l * V + q] = xv[q];
    }
  } else {
#pragma unroll
    for (int q = 0; q < kR3PerThread; ++q) tv[q] = j0 + q < n ? tb[j0 + q] : T(0);
  }

  int i0[kR3PerThread];
  T u[kR3PerThread];
  int lo = INT_MAX, hi = INT_MIN;
#pragma unroll
  for (int q = 0; q < kR3PerThread; ++q) {
    i0[q] = r3_index(tv[q], N, t0, dt, &u[q]);
    if (j0 + q < n) {
      lo = min(lo, i0[q]);
      hi = max(hi, i0[q]);
    }
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, d));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, d));
  }
  if (t % 32 == 0) {
    red[0][t / 32] = lo;
    red[1][t / 32] = hi;
  }
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kR3Threads / 32; ++w) {
    lo = min(lo, red[0][w]);
    hi = max(hi, red[1][w]);
  }
  const bool staged = hi - lo + 4 <= kR3KnotsMax;
  if (staged) {
    const T* src = knots + 3 * static_cast<size_t>(lo);
    for (int e = t; e < 3 * (hi - lo + 4); e += kR3Threads) sk[e] = __ldg(src + e);
  }
  __syncthreads();
  const T* kb = staged ? sk : knots;
  const int base = staged ? lo : 0;

  T o[kR3PerThread][9];
#pragma unroll
  for (int q = 0; q < kR3PerThread; ++q) {
    if (j0 + q < n) r3_values(kb + 3 * (i0[q] - base), u[q], dt, o[q]);
  }
  T* outs[3] = {p, v, a};
#pragma unroll
  for (int c = 0; c < 3; ++c) {
#pragma unroll
    for (int q = 0; q < kR3PerThread; ++q) {
      if (j0 + q < n) {
#pragma unroll
        for (int k = 0; k < 3; ++k) so[3 * (j0 + q) + k] = o[q][3 * c + k];
      }
    }
    __syncthreads();
    copy_out(so, outs[c] + 3 * b0, 3 * n);
    __syncthreads();
  }
}

template <typename T>
static int launch_r3(const void* knots, int N, double t0, double dt, const void* ts,
                     void* p, void* v, void* a, int B, void* stream) {
  const int blocks = (B + kR3Times - 1) / kR3Times;
  r3_evaluate_kernel<T><<<blocks, kR3Threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(knots), N, T(t0), T(dt), static_cast<const T*>(ts),
      static_cast<T*>(p), static_cast<T*>(v), static_cast<T*>(a), B);
  return static_cast<int>(cudaGetLastError());
}

// knots [N, 3] (N >= 4), ts [B]; p, v, a [B, 3].
extern "C" int kontiki_r3_evaluate_f32(const void* knots, int N, double t0, double dt,
                                       const void* ts, void* p, void* v, void* a, int B,
                                       void* stream) {
  return launch_r3<float>(knots, N, t0, dt, ts, p, v, a, B, stream);
}

extern "C" int kontiki_r3_evaluate_f64(const void* knots, int N, double t0, double dt,
                                       const void* ts, void* p, void* v, void* a, int B,
                                       void* stream) {
  return launch_r3<double>(knots, N, t0, dt, ts, p, v, a, B, stream);
}

#endif  // __CUDACC__
