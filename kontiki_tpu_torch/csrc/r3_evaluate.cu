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
// Design: one thread per time, which reads its own 4 knots. The TPU kernel
// sorts the times on the host into 256-time chunks and turns each chunk
// into a banded [256, 512] x [512, 3] matmul on the MXU, falling back to a
// gather when a chunk spans more than 512 knots. None of that is needed
// here: neighbouring times share knots in L1/L2, times in any order need no
// sort, and any span works.
//
// Bound: bytes. A time reads 1 value and writes 9 (80 bytes in f64), plus
// the knots once (N x 3); at the 4.8 M row times of a 10,000-frame
// rolling-shutter sequence that is 384 MB, 0.115 ms at 3.35 TB/s. The
// function needs ~60 float64 operations per time (counted on the host).
#include "rowmath.cuh"

namespace {

// Time b: p, v, a [B, 3] from knots [N, 3].
template <typename T>
KT_HD void r3_evaluate_row(const T* knots, int N, T t0, T dt, const T* ts, int b, T* p,
                           T* v, T* a) {
  const T s = (ts[b] - t0) / dt;
  const double f = kt_floor(val(s));  // clamped before the cast: no overflow
  const int i0 = f < 0.0 ? 0 : (f > static_cast<double>(N - 4) ? N - 4 : static_cast<int>(f));
  const T u = s - T(static_cast<double>(i0));
  T B[4], dB[4], d2B[4];
  r3_basis(u, dt, B, dB, d2B);
  const T* k0 = knots + 3 * static_cast<size_t>(i0);
  const size_t o = 3 * static_cast<size_t>(b);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    T pk = B[0] * k0[k], vk = dB[0] * k0[k], ak = d2B[0] * k0[k];
#pragma unroll
    for (int j = 1; j < 4; ++j) {
      pk = pk + B[j] * k0[3 * j + k];
      vk = vk + dB[j] * k0[3 * j + k];
      ak = ak + d2B[j] * k0[3 * j + k];
    }
    p[o + k] = pk;
    v[o + k] = vk;
    a[o + k] = ak;
  }
}

}  // namespace

#ifdef __CUDACC__

#include <cuda_runtime.h>

template <typename T>
__global__ void __launch_bounds__(256) r3_evaluate_kernel(
    const T* __restrict__ knots, int N, T t0, T dt, const T* __restrict__ ts, T* p, T* v,
    T* a, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b < B) r3_evaluate_row<T>(knots, N, t0, dt, ts, b, p, v, a);
}

template <typename T>
static int launch_r3(const void* knots, int N, double t0, double dt, const void* ts,
                     void* p, void* v, void* a, int B, void* stream) {
  const int threads = 256;
  const int blocks = (B + threads - 1) / threads;
  r3_evaluate_kernel<T><<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
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
