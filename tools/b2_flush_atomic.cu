// B2 (kontiki_tpu_torch/csrc/assemble_schur.cu) with the other flush of the
// blocks' head triangles: each block adds every nonzero entry of its
// triangle into H (mirrored) and of its g head into g with one global
// atomic, each block starting at its own diagonal, instead of storing them
// into a workspace that a second launch sums. Built and timed beside the
// kernel by tools/b2_flush_ab.py; the port does not use it.
#include "../kontiki_tpu_torch/csrc/assemble_schur.cu"

namespace {

template <typename T>
__global__ void __launch_bounds__(kWarps * 32) assemble_atomic_kernel(SchurArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int Ph = a.Ph;
  const int nv = head_values(Ph);
  T* U = reinterpret_cast<T*>(smem);
  T* gh = U + nv - Ph;
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  T* wv = U + nv + w * warp_values(a.rdim, a.C);
  int* wi = reinterpret_cast<int*>(U + nv + kWarps * warp_values(a.rdim, a.C)) +
            w * warp_ints(a.C);
  for (int i = threadIdx.x; i < nv; i += blockDim.x) U[i] = T(0);
  __syncthreads();
  int lo, hi;
  warp_range(a.M, gridDim.x, kWarps, blockIdx.x, w, &lo, &hi);
  warp_rows(a, lo, hi, U, gh, wv, wi, lane, 32);
  __syncthreads();
  const int start = Ph ? static_cast<int>((7LL * blockIdx.x) % Ph) : 0;
  for (int dd = 0; dd < Ph; ++dd) {
    const int d = dd + start < Ph ? dd + start : dd + start - Ph;
    for (int x = threadIdx.x; x < Ph - d; x += blockDim.x) {
      const T v = U[tri_offset(x, d, Ph)];
      if (v == T(0)) continue;
      atomicAdd(&a.H[static_cast<size_t>(x) * a.P + x + d], v);
      if (d) atomicAdd(&a.H[static_cast<size_t>(x + d) * a.P + x], v);
    }
  }
  for (int x = threadIdx.x; x < Ph; x += blockDim.x) {
    if (gh[x] != T(0)) atomicAdd(&a.g[x], gh[x]);
  }
}

}  // namespace

// As kontiki_assemble_schur_f64 (no workspace), with the atomic flush.
extern "C" int b2_atomic_f64(const void* Jw, const void* cols, const void* rw,
                             const void* J_rho, const void* lid, void* H, void* g, void* E,
                             void* D, void* g_l, int M, int rdim, int C, int P, int L,
                             int with_rho, void* stream) {
  using T = double;
  SchurArgs<T> a = {static_cast<const T*>(Jw), static_cast<const T*>(rw),
                    static_cast<const T*>(J_rho), static_cast<const int*>(cols),
                    static_cast<const int*>(lid), static_cast<T*>(H), static_cast<T*>(g),
                    static_cast<T*>(E), static_cast<T*>(D), static_cast<T*>(g_l),
                    M, rdim, C, P, L, with_rho, 0};
  size_t smem;
  int blocks;
  const int err = plan_assemble<T>(M, rdim, C, P, &a.Ph, &smem, &blocks);
  if (err) return err;
  cudaFuncSetAttribute(assemble_atomic_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  assemble_atomic_kernel<T><<<blocks, kWarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
