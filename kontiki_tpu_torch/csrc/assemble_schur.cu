// Gauss-Newton and landmark-elimination assembly for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel B2, kontiki_tpu/ops/assembly_kernels.py
// assemble_schur_blocks -> _make_kernel. Its plain PyTorch version is
// kontiki_tpu_torch/ops/assembly_kernels.py assemble_schur_blocks_plain,
// which the wrapper runs for CPU tensors.
//
// From whitened compressed rows Jw [M, rdim, C] with column ids cols [M, C]:
//   H[cols_i, cols_j] += sum_r Jw[r, i] Jw[r, j]     g[cols_i] += sum_r Jw[r, i] rw[r]
// and, with landmarks, E[lid, cols_i] += sum_r J_rho[r] Jw[r, i],
// D[lid] += |J_rho|^2, g_l[lid] += J_rho . rw. Duplicate column ids in a row
// accumulate; ids out of range are dropped. The outputs arrive zeroed.
//
// Design: one block per row. The row is staged in shared memory; the
// block's threads stride over the C x C products and add each into H with
// a global atomicAdd (Hopper has native f32 and f64 atomics).
//
// Bound: atomics into L2. A config-4 camera bucket makes M C^2 = 45.8 M
// atomic adds into a 194 x 194 H, and rows of one time window hit the same
// entries, so same-address atomics serialize. A per-block shared copy of H
// does not fit (194^2 doubles = 301 KB > 227 KB), which is why this first
// version adds straight into global memory; the TPU kernel's
// one-hot-expand-then-matmul formulation (a tensor-core GEMM per row tile)
// is the candidate for a faster version. Atomics change the order of the
// sums from run to run, so results agree with the plain version to
// rounding, not bit for bit.
#include <cuda_runtime.h>

namespace {

template <typename T>
__global__ void __launch_bounds__(128) assemble_schur_kernel(
    const T* __restrict__ Jw, const int* __restrict__ cols,
    const T* __restrict__ rw, const T* __restrict__ J_rho,
    const int* __restrict__ lid, T* H, T* g, T* E, T* D, T* g_l,
    int rdim, int C, int P, int L, int with_rho) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* sJ = reinterpret_cast<T*>(smem);  // [rdim, C]
  T* sr = sJ + rdim * C;               // [rdim]
  T* sJr = sr + rdim;                  // [rdim]
  int* sc = reinterpret_cast<int*>(sJr + rdim);  // [C]

  const int m = blockIdx.x;
  const int tid = threadIdx.x;
  const size_t base = static_cast<size_t>(m) * rdim * C;
  for (int i = tid; i < rdim * C; i += blockDim.x) sJ[i] = Jw[base + i];
  for (int i = tid; i < C; i += blockDim.x) sc[i] = cols[static_cast<size_t>(m) * C + i];
  for (int i = tid; i < rdim; i += blockDim.x) {
    sr[i] = rw[static_cast<size_t>(m) * rdim + i];
    sJr[i] = J_rho[static_cast<size_t>(m) * rdim + i];
  }
  __syncthreads();

  for (int p = tid; p < C * C; p += blockDim.x) {
    const int i = p / C;
    const int j = p - i * C;
    const int ci = sc[i];
    const int cj = sc[j];
    if (ci < 0 || ci >= P || cj < 0 || cj >= P) continue;
    T h = T(0);
    for (int r = 0; r < rdim; ++r) h += sJ[r * C + i] * sJ[r * C + j];
    atomicAdd(&H[static_cast<size_t>(ci) * P + cj], h);
  }

  const int l = with_rho ? lid[m] : -1;
  const bool land = l >= 0 && l < L;
  for (int i = tid; i < C; i += blockDim.x) {
    const int ci = sc[i];
    if (ci < 0 || ci >= P) continue;
    T gi = T(0), e = T(0);
    for (int r = 0; r < rdim; ++r) {
      gi += sJ[r * C + i] * sr[r];
      e += sJr[r] * sJ[r * C + i];
    }
    atomicAdd(&g[ci], gi);
    if (land) atomicAdd(&E[static_cast<size_t>(l) * P + ci], e);
  }
  if (land && tid == 0) {
    T d = T(0), gl = T(0);
    for (int r = 0; r < rdim; ++r) {
      d += sJr[r] * sJr[r];
      gl += sJr[r] * sr[r];
    }
    atomicAdd(&D[l], d);
    atomicAdd(&g_l[l], gl);
  }
}

template <typename T>
int launch_assemble(const void* Jw, const void* cols, const void* rw,
                    const void* J_rho, const void* lid, void* H, void* g,
                    void* E, void* D, void* g_l, int M, int rdim, int C,
                    int P, int L, int with_rho, void* stream) {
  const size_t smem = (static_cast<size_t>(rdim) * C + 2 * rdim) * sizeof(T) +
                      static_cast<size_t>(C) * sizeof(int);
  assemble_schur_kernel<T><<<M, 128, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(Jw), static_cast<const int*>(cols),
      static_cast<const T*>(rw), static_cast<const T*>(J_rho),
      static_cast<const int*>(lid), static_cast<T*>(H), static_cast<T*>(g),
      static_cast<T*>(E), static_cast<T*>(D), static_cast<T*>(g_l), rdim, C,
      P, L, with_rho);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define KT_ASSEMBLE_ENTRY(NAME, T)                                             \
  extern "C" int NAME(const void* Jw, const void* cols, const void* rw,        \
                      const void* J_rho, const void* lid, void* H, void* g,    \
                      void* E, void* D, void* g_l, int M, int rdim, int C,     \
                      int P, int L, int with_rho, void* stream) {              \
    return launch_assemble<T>(Jw, cols, rw, J_rho, lid, H, g, E, D, g_l, M,    \
                              rdim, C, P, L, with_rho, stream);                \
  }

KT_ASSEMBLE_ENTRY(kontiki_assemble_schur_f32, float)
KT_ASSEMBLE_ENTRY(kontiki_assemble_schur_f64, double)
