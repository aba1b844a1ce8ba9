// One-hot row expansion for Hopper (sm_90a): compressed row Jacobians to
// dense pair-window rows, the first step of the banded segment-BA assembly.
//
// Replaces the Pallas TPU kernel B6, kontiki_tpu/ops/linearize_kernels.py:1148
// onehot_expand_rows -> _make_expand_kernel. Its plain PyTorch version is
// kontiki_tpu_torch/ops/linearize_kernels.py onehot_expand_rows_plain (the
// chunked one-hot product of the JAX package's non-TPU path), which the
// wrapper runs for CPU tensors.
//
//   Jd[m, r, rel[m, c]] += Jw[m, r, c]     Jw [M, rdim, C], rel [M, C] int64
//
// ids outside [0, WB) are dropped; every output row is written once, zeros
// included. A camera row's ref and obs windows can name the same knots, so
// an id may occur twice in a row and the two entries must add.
//
// Design: a block owns ROWS consecutive rows. It zeroes a shared tile of
// ROWS x rdim x WB, its threads walk the rows' (c, r) entries and add each
// in-range one into the tile with a shared-memory atomicAdd, and then it
// copies the tile out: the block's rows are contiguous in Jd, so the write
// is one coalesced stream. With at most two entries per id the sum is
// 0 + a + b in either order, so the result equals the plain version's bit
// for bit.
//
// Bound: bytes. At BASELINE config 5 (M = 500,000, rdim = 2, C = 61,
// WB = 109, float64) it reads Jw (488 MB) and rel (244 MB) and writes Jd
// (872 MB): 1.60 GB, 0.48 ms at 3.35 TB/s; its 61 M additions are
// negligible beside that. The TPU kernel compares every column with an iota
// over WB (C x WB multiply-adds per row entry); here each entry costs one
// shared atomic, and the tile never leaves the SM until it is final.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxRows = 8;

template <typename T>
__global__ void __launch_bounds__(kThreads) onehot_expand_kernel(
    const T* __restrict__ Jw, const long long* __restrict__ rel,
    T* __restrict__ out, int M, int rdim, int C, int WB, int rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* tile = reinterpret_cast<T*>(smem);  // [rows, rdim, WB]

  const int m0 = blockIdx.x * rows;
  const int nrows = min(rows, M - m0);
  const int row_len = rdim * WB;
  const int n_out = nrows * row_len;
  for (int i = threadIdx.x; i < n_out; i += blockDim.x) tile[i] = T(0);
  __syncthreads();

  // entries (row i, column c); rdim adds each
  const int n_in = nrows * C;
  for (int e = threadIdx.x; e < n_in; e += blockDim.x) {
    const int i = e / C;
    const int c = e - i * C;
    const size_t m = static_cast<size_t>(m0 + i);
    const long long w = rel[m * C + c];
    if (w < 0 || w >= WB) continue;
    T* dst = tile + i * row_len + static_cast<int>(w);
    const T* src = Jw + m * rdim * C + c;
    for (int r = 0; r < rdim; ++r) atomicAdd(dst + r * WB, src[r * C]);
  }
  __syncthreads();

  T* dst = out + static_cast<size_t>(m0) * row_len;
  for (int i = threadIdx.x; i < n_out; i += blockDim.x) dst[i] = tile[i];
}

template <typename T>
int launch_expand(const void* Jw, const void* rel, void* out, int M, int rdim,
                  int C, int WB, void* stream) {
  if (M <= 0) return static_cast<int>(cudaSuccess);
  const size_t row_bytes = static_cast<size_t>(rdim) * WB * sizeof(T);
  // as many rows as fit the default 48 KB of shared memory, at most kMaxRows;
  // one row beyond that takes the opt-in shared memory of the SM
  int rows = static_cast<int>((48 * 1024) / row_bytes);
  rows = rows < 1 ? 1 : (rows > kMaxRows ? kMaxRows : rows);
  const size_t smem = rows * row_bytes;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        onehot_expand_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (M + rows - 1) / rows;
  onehot_expand_kernel<T><<<blocks, kThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(Jw), static_cast<const long long*>(rel),
      static_cast<T*>(out), M, rdim, C, WB, rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define KT_EXPAND_ENTRY(NAME, T)                                            \
  extern "C" int NAME(const void* Jw, const void* rel, void* out, int M,    \
                      int rdim, int C, int WB, void* stream) {              \
    return launch_expand<T>(Jw, rel, out, M, rdim, C, WB, stream);          \
  }

KT_EXPAND_ENTRY(kontiki_onehot_expand_f32, float)
KT_EXPAND_ENTRY(kontiki_onehot_expand_f64, double)
