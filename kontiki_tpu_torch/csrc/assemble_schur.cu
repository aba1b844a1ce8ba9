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
// accumulate; ids out of range are dropped (and the landmark outputs of a
// row whose lid is out of range). The outputs arrive zeroed.
//
// Design: a private copy of H's head per block in shared memory.
//  - A persistent grid of one block per SM (the copy takes most of its
//    shared memory). The rows are cut into one contiguous range per warp,
//    and a block's warps take ranges spread over the whole bucket, so a
//    block's warps work on different landmarks at any time. Each warp
//    stages its rows one at a time in its shared memory.
//  - The block keeps a copy of H's upper triangle over the head ids
//    [0, Ph) and of g[0, Ph) in shared memory. Each unordered pair of a
//    row's positions {i, j} adds its product there with a shared atomicAdd
//    when both ids are below Ph (twice on the diagonal when two positions
//    carry the same id: both orders of Jd^T Jd), and to both mirror entries
//    of H in global memory otherwise; exact zeros (the sensor's bias
//    columns) add nothing. Ph is the largest width whose triangle fits the
//    opt-in shared memory beside the warps' rows (~222 ids in f64, ~324 in
//    f32), so the kernel is right for every P; config 3's and 4's buckets
//    (Pc 139, 194) fit whole, and at config 3-atan-lifting (Pc 3,976) the
//    ids past the head are the lifted row times, each unique to its row,
//    whose products do not contend.
//  - On sm_90 a shared f32/f64 atomicAdd is a compare-and-swap loop
//    (ATOMS.CAST.SPIN), which retries while other warps hit the same entry.
//    Warps on consecutive rows of one landmark share its reference window's
//    and the sensor's ids and kept retrying (0.29 ms at config 4 when a
//    block's warps took neighbouring ranges); warps on ranges far apart
//    meet on the sensor's entries only.
//  - The pairs of a row are enumerated cyclically, (i, i + k mod C) for
//    k = 0 .. C/2, so each unordered pair comes once and neighbouring lanes
//    take neighbouring positions; the triangle is stored by diagonal
//    (d = b - a, then a), so the neighbouring ids of a window land in
//    neighbouring banks.
//  - When its rows are done the block stores its triangle and g head into
//    a workspace [blocks, Ph(Ph + 3)/2], and a second launch sums it over
//    the blocks into H, mirrored, and g (measured against one global atomic
//    per entry and block: tools/b2_flush_ab.py).
//  - E stays in global memory. A camera bucket lists each landmark's rows
//    together (solver/problem.py builds it landmark by landmark), and those
//    rows share the reference window's and the sensor's ids, so each warp
//    sums E over runs of rows with the same (lid, id) at a position, and D
//    and g_l over runs of the same lid, and adds once per run.
// The shared atomics sum in a run-dependent order, so results agree with
// the plain version to rounding, not bit for bit.
//
// Tensor cores: not used. A row is a rank-rdim update on C of the P columns
// (61 of 194, 31%, at config 4; 62 of 3,976, 1.6%, at config
// 3-atan-lifting); the TPU kernel's one-hot GEMM form
// (kontiki_tpu/ops/assembly_kernels.py:9-19) multiplies the dense rows, 3-60x
// the work.
//
// Bound: bytes on paper (config 4's camera bucket: 16.1 MB, 4.8 us at
// 3.35 TB/s); in practice the shared-memory atomic adds, C(C+1)/2 = 1,891
// per row at config 4 (23 M in all, ~93 rows per SM), and the workspace
// (Ph(Ph + 3)/2 values per block, written once and read once).
#include "jet.cuh"

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

namespace {

// Add v into *p: an atomic on the card (shared or global memory), a plain
// add on the host.
template <typename T>
KT_HD void acc_add(T* p, T v) {
#ifdef __CUDA_ARCH__
  atomicAdd(p, v);
#else
  *p += v;
#endif
}

KT_HD void kt_syncwarp() {
#ifdef __CUDA_ARCH__
  __syncwarp();
#endif
}

// Offset of the head triangle's entry (a, a + d): stored by diagonal d,
// each diagonal by a; Ph(Ph + 1)/2 entries in all.
KT_HD int tri_offset(int a, int d, int Ph) { return d * Ph - d * (d - 1) / 2 + a; }

// Values of a block's head: the triangle, then g's head.
KT_HD int head_values(int Ph) { return Ph * (Ph + 3) / 2; }

// The largest head width h <= P whose head takes at most `words` values.
KT_HD int head_width(long long words, int P) {
  int h = 0;
  while (h < P && head_values(h + 1) <= words) ++h;
  return h;
}

// Part p of parts of the n items: [*lo, *hi).
KT_HD void part_range(int n, int parts, int p, int* lo, int* hi) {
  *lo = static_cast<int>(static_cast<long long>(n) * p / parts);
  *hi = static_cast<int>(static_cast<long long>(n) * (p + 1) / parts);
}

// Row range of warp w of block b (blocks x warps ranges; a block's warps
// take ranges `blocks` apart).
KT_HD void warp_range(int M, int blocks, int warps, int b, int w, int* lo, int* hi) {
  part_range(M, blocks * warps, w * blocks + b, lo, hi);
}

template <typename T>
struct SchurArgs {
  const T *Jw, *rw, *J_rho;
  const int *cols, *lid;
  T *H, *g, *E, *D, *g_l;
  int M, rdim, C, P, L, with_rho, Ph;
};

// One staged row's H and g products (J [rdim, C], cols [C], rw [rdim]),
// lane `lane` of `nlanes`: pairs with both ids below Ph into the head
// triangle U and g head gh, the others into H and g.
template <typename T>
KT_HD void row_products(const T* J, const int* cols, const T* rw, int rdim, int C, int P,
                        int Ph, T* U, T* gh, T* H, T* g, int lane, int nlanes) {
  // each unordered pair of positions once: (i, i + k mod C), k = 0 .. C/2
  for (int k = 0; 2 * k <= C; ++k) {
    const int n = 2 * k == C ? k : C;  // C even: distance C/2 from the first half
    for (int i = lane; i < n; i += nlanes) {
      const int j = i + k < C ? i + k : i + k - C;
      const int ci = cols[i];
      const int cj = cols[j];
      if (ci < 0 || ci >= P || cj < 0 || cj >= P) continue;
      T h = T(0);
      for (int r = 0; r < rdim; ++r) h += J[r * C + i] * J[r * C + j];
      if (h == T(0)) continue;
      const int a = ci < cj ? ci : cj;
      const int b = ci < cj ? cj : ci;
      if (a == b && i != j) h += h;  // both orders of an id repeated in the row
      if (b < Ph) {
        acc_add(&U[tri_offset(a, b - a, Ph)], h);
      } else {
        acc_add(&H[static_cast<size_t>(a) * P + b], h);
        if (a != b) acc_add(&H[static_cast<size_t>(b) * P + a], h);
      }
    }
  }
  for (int i = lane; i < C; i += nlanes) {
    const int ci = cols[i];
    if (ci < 0 || ci >= P) continue;
    T gi = T(0);
    for (int r = 0; r < rdim; ++r) gi += J[r * C + i] * rw[r];
    acc_add(ci < Ph ? &gh[ci] : &g[ci], gi);
  }
}

// E over runs: position i keeps the sum eacc[i] of its run of rows with
// the same landmark and the same id eid[i] (-1: no run), and adds it into
// E when the run ends. same_l: this row's landmark is prev_l, the previous
// row's.
template <typename T>
KT_HD void e_runs_row(const T* J, const int* cols, const T* Jr, int rdim, int C, int P,
                      bool land, bool same_l, int prev_l, T* eacc, int* eid, T* E,
                      int lane, int nlanes) {
  for (int i = lane; i < C; i += nlanes) {
    const int ci = cols[i];
    const bool ok = land && ci >= 0 && ci < P;
    T e = T(0);
    for (int r = 0; r < rdim; ++r) e += Jr[r] * J[r * C + i];
    if (ok && same_l && eid[i] == ci) {
      eacc[i] += e;
      continue;
    }
    if (eid[i] >= 0) acc_add(&E[static_cast<size_t>(prev_l) * P + eid[i]], eacc[i]);
    eid[i] = ok ? ci : -1;
    eacc[i] = e;
  }
}

template <typename T>
KT_HD void e_runs_flush(int C, int P, int l, T* eacc, int* eid, T* E, int lane, int nlanes) {
  for (int i = lane; i < C; i += nlanes) {
    if (eid[i] >= 0) acc_add(&E[static_cast<size_t>(l) * P + eid[i]], eacc[i]);
    eid[i] = -1;
  }
}

// D and g_l over a run of rows of landmark l (-1: no run).
template <typename T>
struct LandRun {
  int l;
  T d, gl;
};

template <typename T>
KT_HD void land_run_flush(LandRun<T>& run, T* D, T* g_l) {
  if (run.l >= 0) {
    acc_add(&D[run.l], run.d);
    acc_add(&g_l[run.l], run.gl);
  }
  run.l = -1;
}

template <typename T>
KT_HD void land_run_row(const T* Jr, const T* rw, int rdim, bool land, int l,
                        LandRun<T>& run, T* D, T* g_l) {
  T d = T(0), gl = T(0);
  for (int r = 0; r < rdim; ++r) {
    d += Jr[r] * Jr[r];
    gl += Jr[r] * rw[r];
  }
  if (land && l == run.l) {
    run.d += d;
    run.gl += gl;
    return;
  }
  land_run_flush(run, D, g_l);
  run = {land ? l : -1, d, gl};
}

// Values of one warp's staging area: the row, then the E runs' sums; and
// its ints: the row's ids, then the runs' ids.
KT_HD int warp_values(int rdim, int C) { return rdim * C + 2 * rdim + C; }
KT_HD int warp_ints(int C) { return 2 * C; }

// The rows [lo, hi) of one warp, as lane `lane` of `nlanes`: each row
// staged in its values wv and ints wi (warp_values, warp_ints), its
// products into the head (U, gh) or H and g, its landmark outputs in runs.
template <typename T>
KT_HD void warp_rows(const SchurArgs<T>& a, int lo, int hi, T* U, T* gh, T* wv, int* wi,
                     int lane, int nlanes) {
  const int rdim = a.rdim, C = a.C, n = rdim * C;
  T* sJ = wv;
  T* sr = sJ + n;
  T* sJr = sr + rdim;
  T* eacc = sJr + rdim;
  int* sc = wi;
  int* eid = wi + C;
  for (int i = lane; i < C; i += nlanes) eid[i] = -1;
  LandRun<T> run = {-1, T(0), T(0)};  // lane 0's
  int prev_l = -1;
  for (int m = lo; m < hi; ++m) {
    kt_syncwarp();  // every lane is done with the previous row
    for (int i = lane; i < n; i += nlanes) sJ[i] = a.Jw[static_cast<size_t>(m) * n + i];
    for (int i = lane; i < C; i += nlanes) sc[i] = a.cols[static_cast<size_t>(m) * C + i];
    for (int i = lane; i < rdim; i += nlanes) {
      sr[i] = a.rw[static_cast<size_t>(m) * rdim + i];
      sJr[i] = a.J_rho[static_cast<size_t>(m) * rdim + i];
    }
    kt_syncwarp();
    row_products(sJ, sc, sr, rdim, C, a.P, a.Ph, U, gh, a.H, a.g, lane, nlanes);
    if (!a.with_rho) continue;
    const int l = a.lid[m];
    const bool land = l >= 0 && l < a.L;
    e_runs_row(sJ, sc, sJr, rdim, C, a.P, land, land && l == prev_l, prev_l, eacc, eid,
               a.E, lane, nlanes);
    if (lane == 0) land_run_row(sJr, sr, rdim, land, l, run, a.D, a.g_l);
    prev_l = land ? l : -1;
  }
  if (a.with_rho) {
    e_runs_flush(C, a.P, prev_l, eacc, eid, a.E, lane, nlanes);
    if (lane == 0) land_run_flush(run, a.D, a.g_l);
  }
}

// Entry t of the blocks' heads (ws [blocks, head_values(Ph)]) summed over
// the blocks in order into H (mirrored) or g: plain stores, no block
// writes these entries otherwise.
template <typename T>
KT_HD void reduce_head(const T* ws, int blocks, int P, int Ph, int t, T* H, T* g) {
  const int nv = head_values(Ph);
  T s = T(0);
  for (int b = 0; b < blocks; ++b) s += ws[static_cast<size_t>(b) * nv + t];
  const int Th = nv - Ph;
  if (t >= Th) {
    g[t - Th] = s;
    return;
  }
  int d = 0;  // the diagonal of entry t
  while (d + 1 < Ph && tri_offset(0, d + 1, Ph) <= t) ++d;
  const int x = t - tri_offset(0, d, Ph);
  H[static_cast<size_t>(x) * P + x + d] = s;
  if (d) H[static_cast<size_t>(x + d) * P + x] = s;
}

#ifdef __CUDACC__

constexpr int kWarps = 16;
constexpr int kMinRows = 2 * kWarps;  // rows per block at the least

template <typename T>
__global__ void __launch_bounds__(kWarps * 32) assemble_schur_kernel(SchurArgs<T> a, T* ws) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nv = head_values(a.Ph);
  T* U = reinterpret_cast<T*>(smem);
  T* gh = U + nv - a.Ph;
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
  T* out = ws + static_cast<size_t>(blockIdx.x) * nv;
  for (int i = threadIdx.x; i < nv; i += blockDim.x) out[i] = U[i];
}

template <typename T>
__global__ void reduce_head_kernel(const T* ws, int blocks, int P, int Ph, T* H, T* g) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t < head_values(Ph)) reduce_head(ws, blocks, P, Ph, t, H, g);
}

// The launch for these shapes: head width, shared memory, blocks. The
// card's limits and the last shape's occupancy are kept between calls.
template <typename T>
int plan_assemble(int M, int rdim, int C, int P, int* Ph, size_t* smem, int* blocks) {
  static int optin = 0, sms = 0, per_sm = 0;
  static size_t planned = 0;  // the shared memory per_sm was found for
  if (!optin) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const size_t warp_bytes = kWarps * (static_cast<size_t>(warp_values(rdim, C)) * sizeof(T) +
                                      static_cast<size_t>(warp_ints(C)) * sizeof(int));
  if (warp_bytes >= static_cast<size_t>(optin)) return static_cast<int>(cudaErrorInvalidValue);
  *Ph = head_width(static_cast<long long>((optin - warp_bytes) / sizeof(T)), P);
  *smem = static_cast<size_t>(head_values(*Ph)) * sizeof(T) + warp_bytes;
  if (*smem != planned) {
    auto kernel = assemble_schur_kernel<T>;
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(*smem));
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kWarps * 32, *smem);
    planned = *smem;
  }
  const int most = sms * (per_sm > 0 ? per_sm : 1);
  const int want = (M + kMinRows - 1) / kMinRows;
  *blocks = want < most ? (want > 0 ? want : 1) : most;
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
long long workspace_assemble(int M, int rdim, int C, int P) {
  int Ph, blocks;
  size_t smem;
  if (plan_assemble<T>(M, rdim, C, P, &Ph, &smem, &blocks)) return -1;
  return static_cast<long long>(blocks) * head_values(Ph);
}

template <typename T>
int launch_assemble(const void* Jw, const void* cols, const void* rw,
                    const void* J_rho, const void* lid, void* H, void* g,
                    void* E, void* D, void* g_l, int M, int rdim, int C,
                    int P, int L, int with_rho, void* ws, void* stream) {
  SchurArgs<T> a = {static_cast<const T*>(Jw), static_cast<const T*>(rw),
                    static_cast<const T*>(J_rho), static_cast<const int*>(cols),
                    static_cast<const int*>(lid), static_cast<T*>(H), static_cast<T*>(g),
                    static_cast<T*>(E), static_cast<T*>(D), static_cast<T*>(g_l),
                    M, rdim, C, P, L, with_rho, 0};
  size_t smem;
  int blocks;
  const int err = plan_assemble<T>(M, rdim, C, P, &a.Ph, &smem, &blocks);
  if (err) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  T* w = static_cast<T*>(ws);
  assemble_schur_kernel<T><<<blocks, kWarps * 32, smem, st>>>(a, w);
  const int nv = head_values(a.Ph);
  reduce_head_kernel<T><<<(nv + 255) / 256, 256, 0, st>>>(w, blocks, P, a.Ph, a.H, a.g);
  return static_cast<int>(cudaGetLastError());
}

#endif  // __CUDACC__

}  // namespace

#ifdef __CUDACC__

// ws: the workspace, kontiki_assemble_schur_workspace_* values.
#define KT_ASSEMBLE_ENTRY(SUFFIX, T)                                                   \
  extern "C" int kontiki_assemble_schur##SUFFIX(                                       \
      const void* Jw, const void* cols, const void* rw, const void* J_rho,             \
      const void* lid, void* H, void* g, void* E, void* D, void* g_l, int M, int rdim, \
      int C, int P, int L, int with_rho, void* ws, void* stream) {                     \
    return launch_assemble<T>(Jw, cols, rw, J_rho, lid, H, g, E, D, g_l, M, rdim, C, P, \
                              L, with_rho, ws, stream);                                \
  }                                                                                    \
  extern "C" long long kontiki_assemble_schur_workspace##SUFFIX(int M, int rdim, int C, \
                                                                int P) {               \
    return workspace_assemble<T>(M, rdim, C, P);                                       \
  }

KT_ASSEMBLE_ENTRY(_f32, float)
KT_ASSEMBLE_ENTRY(_f64, double)

#endif  // __CUDACC__
