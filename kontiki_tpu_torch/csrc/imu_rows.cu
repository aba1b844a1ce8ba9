// Gyro and accelerometer rows for Hopper (sm_90a): residual and compressed
// Jacobian of IMU rows on an SO3 spline or a split R3 + SO3 trajectory, and
// the residual-only variant the LM re-cost uses.
//
// Replaces the Pallas TPU kernel B4, kontiki_tpu/ops/linearize_kernels.py
// imu_rows -> _imu_call / _tile_imu (and _tile_imu_cost). Its plain PyTorch
// version is kontiki_tpu_torch/ops/linearize_kernels.py imu_rows_plain, which
// the wrapper runs for CPU tensors.
//
// Per row, at the shifted time u + s/dt of each window:
//   gyro:  body = R(q)^T omega_world,  omega_world = 2 (dq/dt q^-1).vec
//   accel: body = R(q)^T (d2p/dt2 + g), g = (0, 0, -9.80665)
//   r = w (y - body - bias);  J = -w d(body)/d(seeds), bias columns -w I,
// with SO3 knot increments as left exp and R3 knots additive. Rows with
// valid = 0 give zeros.
//
// Design: the TPU kernel takes the time derivatives as nested JVPs through
// the time shift s. Here they are analytic inside and forward mode outside
// (the "analytic inner, Jet outer" choice; nested Jet<Jet<T,1>,N> would
// need a third nesting level for the accel time column):
//  - q and dq/dt come from the product rule of the cumulative SO3 window
//    (spline_eval.so3_window). Each factor exp(B_j w_j) gets its time
//    derivative in the branch the TPU kernel's jvp takes: (0, dB_j w_j) x
//    exp(B_j w_j), or (0, dB_j w_j) in the |B_j w_j|^2 <= EPS Taylor branch
//    where exp(v) is (1, v).
//  - d2p/dt2 = sum_j d2B_j(u) p_j with the standard basis.
//  - The outer Jet carries the 12 SO3 knot increments and s. B, dB
//    and d2B are polynomials of the jet u + s/dt, so d(omega)/ds and
//    d(d2p/dt2)/ds (second and third time derivatives) need no more code.
//  - R3 knots enter d2p/dt2 linearly; their columns are written in closed
//    form, d(body)/d(p_jk) = d2B_j R(q)^T e_k, which keeps the seed count
//    at 13 for every variant.
//  - Guards are taken on the primal value (quaternion log/exp: |v|^2 <=
//    1e-16; so3 exp: theta^2 <= 1e-10), as the TPU kernel's `where` does;
//    CUDA's atan2 replaces the Mosaic Newton arctangent.
//
// Bound: bytes on paper, latency in practice. A bucket holds M = 1,000
// rows (configs 1 and 2). A split accel row reads 40 values and writes
// 3 + 3 * 37, ~1.2 KB in f64, ~1.2 MB per bucket (0.37 us at 3.35 TB/s);
// the function needs ~8.3 k float64 operations per gyro row and ~4.1 k per
// accel row (csrc/host_rows.cpp counts them), ~0.1 us at 67 TFLOP/s.
// A bucket is far too small to fill the card one row per thread, so the
// time is one row's chain: ~10 f64 transcendentals and their jets in
// sequence. The design shortens that chain and spreads the rows:
//  - a row runs on a group of 16 lanes (imu_row_lane), one seed a lane in
//    Jet<T, 1> (13 busy): a 1,000-row bucket is 125 blocks of 128 threads
//    on the 132 SMs, and a lane carries 2 values per number, not 6, so its
//    four knots and the chain stay in registers (the first port's 5-seed
//    chunks spilled 1.7 KB in f64; two seeds a lane on 8 lanes measured
//    ~35% slower). Every lane repeats the primal chain; the lanes do not
//    diverge until the write-out;
//  - the three lanes that hold no seed write the residual, the sensor
//    block's other columns (zeros; -w in the bias columns) and, on split
//    rows, the R3 columns in closed form, one component a lane
//    (imu_row_rest), while the seed lanes write theirs;
//  - the block's rows, contiguous in J, go through a shared tile and leave
//    in 16-byte stores (copy_out), not one strided value at a time.
// The cost-only variant runs the primal chain once per row, one row a
// thread.
#include "rowmath.cuh"

namespace {

constexpr double kGravityZ = -9.80665;
constexpr int kSensorCols = 13;
constexpr int kSeeds = 13;        // 12 SO3 knot increments + the time shift s

// flags of the C entry point
constexpr int kAccel = 1;
constexpr int kSplit = 2;
constexpr int kR3First = 4;
constexpr int kCostOnly = 8;

// exp of the pure quaternion (0, v) and its time derivative along vd (a
// multiple of v), in the branch the TPU kernel takes.
template <typename S>
KT_HD void expq_pure_dt(const V3<S>& v, const V3<S>& vd, bool need_dt,
                        Q4<S>& e, Q4<S>& ed) {
  using T = typename BaseT<S>::type;
  const S v2 = v.x * v.x + v.y * v.y + v.z * v.z;
  const Q4<S> pd = {S(T(0)), vd.x, vd.y, vd.z};
  if (val(v2) <= T(kEpsQ)) {
    e = {S(T(1)), v.x, v.y, v.z};
    if (need_dt) ed = pd;
    return;
  }
  const S vn = kt_sqrt(v2);
  const S kv = kt_sin(vn) / vn;
  e = {kt_cos(vn), kv * v.x, kv * v.y, kv * v.z};
  if (need_dt) ed = qmul(pd, e);
}

template <typename T>
struct ImuRow {
  T ws[16], u_so3, dt_so3, wr[12], u_r3, dt_r3, y[3], w, bias[3], valid;
};

// Inputs are [k, M] arrays (component k of row m at k * M + m); the r3
// arrays are null for SO3-only problems and valid may be null.
template <typename T>
struct ImuInputs {
  const T *win_so3, *u_so3, *dts_so3, *win_r3, *u_r3, *dts_r3, *y, *weight,
      *bias, *valid;
  int M, flags;
};

template <typename T>
KT_HD ImuRow<T> load_row(const ImuInputs<T>& in, int m) {
  const int M = in.M;
  ImuRow<T> row;
  for (int k = 0; k < 16; ++k) row.ws[k] = in.win_so3[k * M + m];
  row.u_so3 = in.u_so3[m];
  row.dt_so3 = in.dts_so3[m];
  if (in.flags & kSplit) {
    for (int k = 0; k < 12; ++k) row.wr[k] = in.win_r3[k * M + m];
    row.u_r3 = in.u_r3[m];
    row.dt_r3 = in.dts_r3[m];
  }
  for (int k = 0; k < 3; ++k) {
    row.y[k] = in.y[k * M + m];
    row.bias[k] = in.bias[k * M + m];
  }
  row.w = in.weight[m];
  row.valid = in.valid ? in.valid[m] : T(1);
  return row;
}

// Second time derivatives of the standard (R3) basis at u, times dt^2.
template <typename S>
KT_HD void d2_standard_basis(const S& u, S* d2) {
  using T = typename BaseT<S>::type;
  d2[0] = T(1) - u;
  d2[1] = T(3) * u - T(2);
  d2[2] = T(1) - T(3) * u;
  d2[3] = u;
}

// Modelled body-frame rate (gyro) or specific force (accel) at u + s/dt
// with SO3 knot increments d[12]; q_out receives the orientation.
template <typename T, typename S>
KT_HD V3<S> imu_body(const ImuRow<T>& row, bool accel, const S* d, const S& s,
                     Q4<S>& q_out) {
  Q4<S> kq[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const Q4<S> qj = {S(row.ws[4 * j]), S(row.ws[4 * j + 1]), S(row.ws[4 * j + 2]),
                      S(row.ws[4 * j + 3])};
    kq[j] = qmul(so3_exp_quat(V3<S>{d[3 * j], d[3 * j + 1], d[3 * j + 2]}), qj);
  }
  const S ue = row.u_so3 + s / row.dt_so3;
  const S u2 = ue * ue;
  const S u3 = u2 * ue;
  const S B[3] = {(T(5) + T(3) * ue - T(3) * u2 + u3) / T(6),
                  (T(1) + T(3) * ue + T(3) * u2 - T(2) * u3) / T(6),
                  u3 / T(6)};
  const T idt = T(1) / row.dt_so3;
  const S dB[3] = {(T(3) - T(6) * ue + T(3) * u2) / T(6) * idt,
                   (T(3) + T(6) * ue - T(6) * u2) / T(6) * idt,
                   T(3) * u2 / T(6) * idt};

  // q = kq0 e1 e2 e3 and, for gyro, its time derivative by the product rule
  Q4<S> q = kq[0];
  Q4<S> dq = {S(T(0)), S(T(0)), S(T(0)), S(T(0))};
#pragma unroll
  for (int j = 1; j < 4; ++j) {
    const V3<S> w3 = logq_vec(qmul(qconj(kq[j - 1]), kq[j]));
    const S b = B[j - 1];
    const S db = dB[j - 1];
    Q4<S> e, ed;
    expq_pure_dt(V3<S>{b * w3.x, b * w3.y, b * w3.z},
                 V3<S>{db * w3.x, db * w3.y, db * w3.z}, !accel, e, ed);
    if (!accel) {
      const Q4<S> a1 = qmul(dq, e);
      const Q4<S> a2 = qmul(q, ed);
      dq = {a1.w + a2.w, a1.x + a2.x, a1.y + a2.y, a1.z + a2.z};
    }
    q = qmul(q, e);
  }
  q_out = q;
  const Q4<S> qc = qconj(q);
  if (!accel) {
    const Q4<S> wq = qmul(dq, qc);
    return qrotate(qc, V3<S>{T(2) * wq.x, T(2) * wq.y, T(2) * wq.z});
  }
  const S ur = row.u_r3 + s / row.dt_r3;
  S d2[4];
  d2_standard_basis(ur, d2);
  const T idt2 = T(1) / (row.dt_r3 * row.dt_r3);
  V3<S> a = {S(T(0)), S(T(0)), S(T(0))};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const S c = d2[j] * idt2;
    a = {a.x + c * row.wr[3 * j], a.y + c * row.wr[3 * j + 1],
         a.z + c * row.wr[3 * j + 2]};
  }
  return qrotate(qc, V3<S>{a.x, a.y, a.z + T(kGravityZ)});
}

}  // namespace

// Jacobian width: 12 SO3 (+ 12 R3) window columns, then the sensor block.
KT_HD int imu_columns(int flags) { return ((flags & kSplit) ? 24 : 12) + kSensorCols; }

// Seed chunk `chunk` of width NC of a row (seeds NC chunk .. NC chunk +
// NC - 1 of the 13; a chunk past them carries none and computes the primal
// alone): the body in Jet<T, NC>, the chunk's columns of the row's J [3, C]
// (-w d(body)/d(seed); the time shift's in sensor column 6), and the primal
// body and orientation q for the rest of the row.
template <typename T, int NC>
KT_HD void imu_row_seeds(const ImuRow<T>& row, int flags, int chunk, T* J, T* body_out,
                         Q4<T>& q_out) {
  using S = Jet<T, NC>;
  const bool split = (flags & kSplit) != 0;
  const int C = imu_columns(flags);
  const int nk = split ? 24 : 12;
  const int off_so3 = split && (flags & kR3First) ? 12 : 0;
  const int s0 = chunk * NC;

  S d[12];
#pragma unroll
  for (int k = 0; k < 12; ++k) d[k] = seeded<T, NC>(T(0), k - s0);
  const S s = seeded<T, NC>(T(0), 12 - s0);
  Q4<S> q;
  const V3<S> body = imu_body<T, S>(row, (flags & kAccel) != 0, d, s, q);

  const T wv = row.w * row.valid;  // d(r)/d(body) = -w, zeroed when invalid
  const S bc[3] = {body.x, body.y, body.z};
  for (int i = 0; i < NC && s0 + i < kSeeds; ++i) {
    const int c = (s0 + i < 12) ? off_so3 + s0 + i : nk + 6;
    for (int rr = 0; rr < 3; ++rr) J[rr * C + c] = -wv * bc[rr].v[i];
  }
  for (int rr = 0; rr < 3; ++rr) body_out[rr] = bc[rr].a;
  q_out = {q.w.a, q.x.a, q.y.a, q.z.a};
}

// Items of a row that are no seed's: 0, r [3] and the sensor block's
// other columns (zeros, -w in the bias columns); on split rows 1 + k for
// k = 0..2, the R3 knots' columns of component k (d(body)/d(p_jk) = d2B_j
// R(q)^T e_k on accel rows, zeros on gyro rows, which do not see the R3
// knots).
KT_HD int imu_rest_items(int flags) { return (flags & kSplit) ? 4 : 1; }

// Item `item` of the row from its primal body and q.
template <typename T>
KT_HD void imu_row_rest(const ImuRow<T>& row, int flags, const T* body, const Q4<T>& q,
                        int item, T* J, T* r) {
  const bool accel = (flags & kAccel) != 0;
  const int C = imu_columns(flags);
  const int nk = (flags & kSplit) ? 24 : 12;
  const T wv = row.w * row.valid;
  if (item == 0) {
    for (int rr = 0; rr < 3; ++rr) {
      r[rr] = wv * (row.y[rr] - body[rr] - row.bias[rr]);
      for (int c = nk; c < C; ++c) {
        if (c != nk + 6) J[rr * C + c] = T(0);
      }
      J[rr * C + nk + (accel ? 7 : 10) + rr] = -wv;
    }
    return;
  }
  const int k = item - 1;
  const int off_r3 = ((flags & kR3First) ? 0 : 12) + k;
  if (!accel) {
    for (int j = 0; j < 4; ++j)
      for (int rr = 0; rr < 3; ++rr) J[rr * C + off_r3 + 3 * j] = T(0);
    return;
  }
  T d2[4];
  d2_standard_basis<T>(row.u_r3, d2);
  const T idt2 = T(1) / (row.dt_r3 * row.dt_r3);
  const V3<T> ek = {T(k == 0), T(k == 1), T(k == 2)};
  const V3<T> col = qrotate(qconj(q), ek);
  const T cv[3] = {col.x, col.y, col.z};
  for (int j = 0; j < 4; ++j) {
    for (int rr = 0; rr < 3; ++rr) J[rr * C + off_r3 + 3 * j] = -wv * d2[j] * idt2 * cv[rr];
  }
}

// Linearize row m: r [M, 3] and J [M, 3, C], the 13 seeds in one
// full-width jet, then the rest. The host runs it, as the operation count
// runs it.
template <typename T>
KT_HD void imu_row_wide(const ImuInputs<T>& in, int m, T* r_out, T* J_out) {
  const ImuRow<T> row = load_row(in, m);
  T* J = J_out + static_cast<size_t>(m) * 3 * imu_columns(in.flags);
  T body[3];
  Q4<T> q;
  imu_row_seeds<T, kSeeds>(row, in.flags, 0, J, body, q);
  for (int item = 0; item < imu_rest_items(in.flags); ++item)
    imu_row_rest<T>(row, in.flags, body, q, item, J, r_out + 3 * m);
}

// B4's lane group: a row on kImuGroup lanes, lane l < kImuSeedLanes on seed
// chunk l of kImuPer seeds; every lane runs the same jet chain (lanes past
// the seeds on no seed), so the group does not diverge until the lanes
// that hold no seed write the rest's items, item i on free lane i % free.
constexpr int kImuPer = 1;                                    // seeds a lane
constexpr int kImuSeedLanes = (kSeeds + kImuPer - 1) / kImuPer;
constexpr int kImuGroup = kImuSeedLanes < 8 ? 8 : kImuSeedLanes < 16 ? 16 : 32;

// Lane `lane` of row `row`'s group: J its [3, C], r its [3].
template <typename T>
KT_HD void imu_row_lane(const ImuRow<T>& row, int flags, int lane, T* J, T* r) {
  constexpr int free_lanes = kImuGroup - kImuSeedLanes;
  T body[3];
  Q4<T> q;
  imu_row_seeds<T, kImuPer>(row, flags, lane, J, body, q);
  if (lane < kImuSeedLanes) return;
  for (int item = lane - kImuSeedLanes; item < imu_rest_items(flags); item += free_lanes)
    imu_row_rest<T>(row, flags, body, q, item, J, r);
}

// Residual only of row m: r [M, 3].
template <typename T>
KT_HD void imu_row_cost(const ImuInputs<T>& in, int m, T* r_out) {
  const ImuRow<T> row = load_row(in, m);
  T d[12];
  for (int k = 0; k < 12; ++k) d[k] = T(0);
  Q4<T> q;
  const V3<T> body = imu_body<T, T>(row, (in.flags & kAccel) != 0, d, T(0), q);
  const T bc[3] = {body.x, body.y, body.z};
  const T wv = row.w * row.valid;
  for (int rr = 0; rr < 3; ++rr) r_out[3 * m + rr] = wv * (row.y[rr] - bc[rr] - row.bias[rr]);
}

template <typename T>
KT_HD ImuInputs<T> make_imu_inputs(const void* const* ins, int M, int flags) {
  return {static_cast<const T*>(ins[0]), static_cast<const T*>(ins[1]),
          static_cast<const T*>(ins[2]), static_cast<const T*>(ins[3]),
          static_cast<const T*>(ins[4]), static_cast<const T*>(ins[5]),
          static_cast<const T*>(ins[6]), static_cast<const T*>(ins[7]),
          static_cast<const T*>(ins[8]), static_cast<const T*>(ins[9]), M, flags};
}

#ifdef __CUDACC__

#include <cuda_runtime.h>

constexpr int kImuThreads = 128;
constexpr int kImuRows = kImuThreads / kImuGroup;  // rows a block

// B4: a block of kImuRows rows, each on a lane group (imu_row_lane); the
// rows' J [3, C] go to a shared tile, which the block writes out, its rows
// contiguous in J, in 16-byte stores (copy_out).
template <typename T>
__global__ void __launch_bounds__(kImuThreads) imu_rows_kernel(ImuInputs<T> in, T* r, T* J) {
  __shared__ __align__(16) T tile[kImuRows * 3 * (24 + kSensorCols)];
  const int C = imu_columns(in.flags);
  const int grp = threadIdx.x / kImuGroup;
  const int m0 = blockIdx.x * kImuRows;
  const int m = m0 + grp;
  if (m < in.M) {
    imu_row_lane<T>(load_row(in, m), in.flags, threadIdx.x % kImuGroup, tile + grp * 3 * C,
                    r + 3 * static_cast<size_t>(m));
  }
  __syncthreads();
  const int rows = in.M - m0 < kImuRows ? in.M - m0 : kImuRows;
  copy_out(tile, J + static_cast<size_t>(m0) * 3 * C, rows * 3 * C);
}

// Residual only: one row per thread (blocks of 32 rows, a 1,000-row bucket
// over 32 SMs, measured no faster: ~5 us either way).
template <typename T>
__global__ void __launch_bounds__(kImuThreads) imu_cost_kernel(ImuInputs<T> in, T* r) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m < in.M) imu_row_cost<T>(in, m, r);
}

template <typename T>
static int launch_imu(const void* const* ins, void* r, void* J, int M, int flags,
                      void* stream) {
  const ImuInputs<T> in = make_imu_inputs<T>(ins, M, flags);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (flags & kCostOnly) {
    imu_cost_kernel<T><<<(M + kImuThreads - 1) / kImuThreads, kImuThreads, 0, st>>>(
        in, static_cast<T*>(r));
  } else {
    imu_rows_kernel<T><<<(M + kImuRows - 1) / kImuRows, kImuThreads, 0, st>>>(
        in, static_cast<T*>(r), static_cast<T*>(J));
  }
  return static_cast<int>(cudaGetLastError());
}

#define KT_IMU_ENTRY(NAME, T)                                                  \
  extern "C" int NAME(const void* win_so3, const void* u_so3,                  \
                      const void* dts_so3, const void* win_r3,                 \
                      const void* u_r3, const void* dts_r3, const void* y,     \
                      const void* weight, const void* bias,                    \
                      const void* valid, void* r, void* J, int M, int flags,   \
                      void* stream) {                                          \
    const void* ins[10] = {win_so3, u_so3, dts_so3, win_r3, u_r3,             \
                           dts_r3,  y,     weight,  bias,   valid};            \
    return launch_imu<T>(ins, r, J, M, flags, stream);                         \
  }

KT_IMU_ENTRY(kontiki_imu_rows_f32, float)
KT_IMU_ENTRY(kontiki_imu_rows_f64, double)

#endif  // __CUDACC__
