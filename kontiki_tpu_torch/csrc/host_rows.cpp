// The row kernels' per-row code (camera_rows.cuh: B1 and B3; imu_rows.cu:
// B4; eval_windows.cu: B5; r3_evaluate.cu: B7; newton_rows.cuh: B8) and
// B2's block accumulation
// (assemble_schur.cu), compiled for the host with a plain C++ compiler. Two
// uses:
//   - on double, the same row functions the CUDA kernels run, to check the
//     row math against the plain PyTorch versions without a card;
//   - on Counted, a double that counts its floating-point operations, to
//     count the operations the function needs on given inputs (the
//     operation side of the bound that chip_smoke.py reports).
// The count is of the function, not of the kernel's schedule:
//   - each row runs once with one jet as wide as all its seeds, so the
//     primal chain is counted once and not once per seed chunk (B1's
//     separate primal stage, which its jets recompute, is subtracted; B8's
//     ref primal is its ref window jet's value);
//     B3 runs the primal chain on the scalar alone; B5 and B7 run each
//     query once as the kernels do;
//   - a constant 0 or 1 in the code (a jet lane no seed reaches, a seed's
//     unit tangent, an identity) is structural: adding or multiplying by it,
//     and anything computed only from zeros, counts nothing;
//   - each +, -, *, / of two other values counts one; each sqrt, sin, cos,
//     atan and atan2 counts one too, which undercounts them; sign flips,
//     fabs and B7's floor of the knot index count nothing. So the bound
//     stays a lower bound.
// The count is per thread (thread_local), so callers may count chunks of
// the rows in parallel threads and add the counts.
// Built by kontiki_tpu_torch/ops/build.py build_host():
//   c++ -std=c++17 -O1 -shared -fPIC -o libkontiki_host.so host_rows.cpp
#include <algorithm>
#include <cmath>
#include <vector>

namespace {
__attribute__((tls_model("initial-exec"))) thread_local long long g_ops = 0;
}

struct Counted {
  enum Kind { kValue, kZero, kOne };
  double x = 0.0;
  Kind kind = kValue;
  Counted() {}
  // A constant of the code: 0 and 1 are structural.
  Counted(double v) : x(v), kind(v == 0.0 ? kZero : v == 1.0 ? kOne : kValue) {}
  // An input or a computed value, whatever it holds.
  static Counted value(double v) {
    Counted c;
    c.x = v;
    return c;
  }
};

inline Counted counted(double v) { ++g_ops; return Counted::value(v); }
inline Counted operator-(Counted a) {
  Counted r = Counted::value(-a.x);
  if (a.kind == Counted::kZero) r.kind = Counted::kZero;
  return r;
}
inline Counted operator+(Counted a, Counted b) {
  if (a.kind == Counted::kZero) return b;
  if (b.kind == Counted::kZero) return a;
  return counted(a.x + b.x);
}
inline Counted operator-(Counted a, Counted b) {
  if (b.kind == Counted::kZero) return a;
  if (a.kind == Counted::kZero) return -b;
  return counted(a.x - b.x);
}
inline Counted operator*(Counted a, Counted b) {
  if (a.kind == Counted::kZero || b.kind == Counted::kZero) return Counted(0.0);
  if (a.kind == Counted::kOne) return b;
  if (b.kind == Counted::kOne) return a;
  return counted(a.x * b.x);
}
inline Counted operator/(Counted a, Counted b) {
  if (a.kind == Counted::kZero) return Counted(0.0);
  if (b.kind == Counted::kOne) return a;
  return counted(a.x / b.x);
}
inline bool operator<=(Counted a, Counted b) { return a.x <= b.x; }
inline bool operator>=(Counted a, Counted b) { return a.x >= b.x; }
inline bool operator<(Counted a, Counted b) { return a.x < b.x; }
inline bool operator>(Counted a, Counted b) { return a.x > b.x; }
inline Counted val(Counted a) { return a; }
inline Counted kt_sqrt(Counted a) { return a.kind == Counted::kZero ? a : counted(std::sqrt(a.x)); }
inline Counted kt_sin(Counted a) { return a.kind == Counted::kZero ? a : counted(std::sin(a.x)); }
inline Counted kt_cos(Counted a) { return a.kind == Counted::kZero ? Counted(1.0) : counted(std::cos(a.x)); }
inline Counted kt_atan(Counted a) { return a.kind == Counted::kZero ? a : counted(std::atan(a.x)); }
inline Counted kt_atan2(Counted a, Counted b) { return counted(std::atan2(a.x, b.x)); }
inline double kt_floor(Counted a) { return std::floor(a.x); }
inline Counted kt_abs(Counted a) {
  Counted r = Counted::value(std::fabs(a.x));
  r.kind = a.kind;
  return r;
}

#include "eval_windows.cu"
#include "imu_rows.cu"
#include "camera_rows.cuh"
#include "newton_rows.cuh"
#include "r3_evaluate.cu"
#include "assemble_schur.cu"

namespace {

// Copies of [k, M] double inputs as Counted (null stays null).
struct CountedInputs {
  std::vector<std::vector<Counted>> store;
  std::vector<const Counted*> ptrs;
  CountedInputs(const double* const* ins, const int* ks, int n, int M) {
    store.resize(n);
    for (int i = 0; i < n; ++i) {
      if (!ins[i]) {
        ptrs.push_back(nullptr);
        continue;
      }
      const size_t len = static_cast<size_t>(ks[i]) * M;
      for (size_t j = 0; j < len; ++j) store[i].push_back(Counted::value(ins[i][j]));
      ptrs.push_back(store[i].data());
    }
  }
};

const int kImuKs[10] = {16, 1, 1, 12, 1, 1, 3, 1, 3, 1};

// Leading sizes of the camera kernels' input slots (Inputs order).
void camera_ks(int flags, int* ks) {
  static const int se3[kCameraSlots] = {28, 0, 1, 0, 28, 0, 1, 0, 1, 4, 3, 1,
                                        3, 2, 1, 9, 2, 1, 1, 1, 1, 1, 1};
  static const int split[kCameraSlots] = {12, 16, 1, 1, 12, 16, 1, 1, 2, 4, 3, 1,
                                          3, 2, 1, 9, 2, 1, 1, 1, 1, 1, 1};
  for (int i = 0; i < kCameraSlots; ++i) ks[i] = (flags & kCamSplit) ? split[i] : se3[i];
}

// Fn::run<Split, Atan, Lifting>(args...) on the flags' branch.
template <typename Fn, typename... A>
auto camera_dispatch(int flags, A&&... a) {
  const bool atan = (flags & kCamAtan) != 0, lifting = (flags & kCamLifting) != 0;
  if (flags & kCamSplit) {
    if (atan) {
      return lifting ? Fn::template run<true, true, true>(a...)
                     : Fn::template run<true, true, false>(a...);
    }
    return lifting ? Fn::template run<true, false, true>(a...)
                   : Fn::template run<true, false, false>(a...);
  }
  if (atan) {
    return lifting ? Fn::template run<false, true, true>(a...)
                   : Fn::template run<false, true, false>(a...);
  }
  return lifting ? Fn::template run<false, false, true>(a...)
                 : Fn::template run<false, false, false>(a...);
}

// B1's row code in a check mode: the seed chunks (kB1Chunks), one
// full-width jet per stage (kB1Wide), or the kernel's lane group, lane after
// lane (kB1Lanes).
enum { kB1Chunks = 0, kB1Wide = 1, kB1Lanes = 2 };

struct HostLinearize {
  template <bool Split, bool Atan, bool Lifting>
  static void run(const Inputs<double>& in, double* r, double* J, double* J_rho,
                  int mode) {
    constexpr int NS = RowShape<Lifting>::NS;
    for (int m = 0; m < in.M; ++m) {
      if (mode == kB1Wide) {
        linearize_row<double, Split, Atan, Lifting, 25, NS>(in, m, r, J, J_rho);
      } else if (mode == kB1Lanes) {
        linearize_row_lanes<double, Split, Atan, Lifting>(in, m, r, J, J_rho);
      } else {
        linearize_row<double, Split, Atan, Lifting>(in, m, r, J, J_rho);
      }
    }
  }
};

// B3's row code in its kernels' schedules: the one-row-per-thread kernel's
// chain, or the lane kernel's stages, each row's lane group lane after lane.
struct HostCost {
  template <bool Split, bool Atan, bool Lifting>
  static void run(const Inputs<double>& in, double* r, int lanes) {
    constexpr int R = RowShape<Lifting>::R;
    for (int m = 0; m < in.M; ++m) {
      if (!lanes) {
        cost_row<double, Split, Atan, Lifting>(in, m, r + R * m);
        continue;
      }
      CostStages<double> cs;
      for (int stage = 0; stage < 3; ++stage) {
        for (int lane = 0; lane < kB3Group; ++lane) {
          cost_stage<double, Split, Atan, Lifting>(stage, lane, in, m, cs, r + R * m);
        }
      }
    }
  }
};

// B1's operations: each row once with one jet per stage (25 and 21 or 22
// seeds), less the primal windows of stage 1, which the stage-3 jets
// compute again.
struct CountLinearize {
  template <bool Split, bool Atan, bool Lifting>
  static long long run(const Inputs<Counted>& in) {
    using Shape = RowShape<Lifting>;
    const size_t M = static_cast<size_t>(in.M);
    std::vector<Counted> r(M * Shape::R), J_rho(M * Shape::R), J(M * Shape::R * Shape::C);
    g_ops = 0;
    for (int m = 0; m < in.M; ++m) {
      linearize_row<Counted, Split, Atan, Lifting, 25, Shape::NS>(in, m, r.data(), J.data(),
                                                                  J_rho.data());
    }
    const long long total = g_ops;
    g_ops = 0;
    const bool r3_first = (in.flags & kCamR3First) != 0;
    Counted zero[24], out[7];
    for (int k = 0; k < 24; ++k) zero[k] = Counted(0.0);
    for (int m = 0; m < in.M; ++m) {
      Windows<Counted> w;
      Row<Counted> row;
      load_row<Counted, Split, Atan, Lifting>(in, m, w, row);
      for (int i = 0; i < 2; ++i) {
        window_pq<Counted, Split, Counted>(w, i, r3_first, zero, Counted(0.0), out);
      }
    }
    return total - g_ops;
  }
};

// B3's operations: each row's chain once (its knot pairs, tails and
// residual, in sequence as one thread runs them).
struct CountCost {
  template <bool Split, bool Atan, bool Lifting>
  static long long run(const Inputs<Counted>& in) {
    std::vector<Counted> r(static_cast<size_t>(in.M) * RowShape<Lifting>::R);
    g_ops = 0;
    for (int m = 0; m < in.M; ++m) {
      cost_row<Counted, Split, Atan, Lifting>(in, m, r.data() + RowShape<Lifting>::R * m);
    }
    return g_ops;
  }
};

// Leading sizes of B8's input slots (NewtonInputs order).
void newton_ks(int W0, int W1, int flags, int* ks) {
  const bool split = (flags & kNewtonSplit) != 0;
  const int win = split ? 3 * W0 : 7 * W0, win_so3 = split ? 4 * W1 : 0, u_so3 = split ? 1 : 0;
  const int head[9] = {win, win_so3, 1, u_so3, win, win_so3, 1, u_so3, split ? 2 : 1};
  static const int rest[kNewtonSlots - 9] = {4, 3, 1, 3, 2, 1, 9, 2, 1, 1, 1, 1, 1};
  for (int i = 0; i < 9; ++i) ks[i] = head[i];
  for (int i = 9; i < kNewtonSlots; ++i) ks[i] = rest[i - 9];
}

// Fn::run<Split, Atan>(args...) on the flags' branch.
template <typename Fn, typename... A>
auto newton_dispatch(int flags, A&&... a) {
  const bool atan = (flags & kNewtonAtan) != 0;
  if (flags & kNewtonSplit) {
    return atan ? Fn::template run<true, true>(a...) : Fn::template run<true, false>(a...);
  }
  return atan ? Fn::template run<false, true>(a...) : Fn::template run<false, false>(a...);
}

// The widest chain newton_row_wide takes in one jet: NS seeds of windows
// of at most kNewtonLocalW knots a spline.
constexpr int kNewtonWideNS = 6 * kNewtonLocalW + 15;

// B8's row m in one full-width jet a stage: the ref sub-window over its 25
// seeds (its value the ref side's primal (p, q)), then the chain over all
// NS seeds, the ref block chained through the ref (p, q) seeds; the
// operation count's schedule (the function's work, whatever the kernel's
// schedule). Returns the Newton steps, or -1 for windows wider than
// kNewtonLocalW.
template <typename T, bool Split, bool Atan>
int newton_row_wide(const NewtonInputs<T>& in, int m, T* r_out, T* J_out, T* Jrho_out) {
  const NewtonShape sh = newton_shape(in.W[0], in.W[1], in.cam.flags);
  if (sh.NS > kNewtonWideNS) return -1;
  const bool r3_first = (in.cam.flags & kNewtonR3First) != 0;
  std::vector<T> buf(2 * sh.win);
  NewtonWindows<T> w;
  w.win[0] = buf.data();
  w.win[1] = buf.data() + sh.win;
  NewtonRow<T> row;
  load_newton_row<T, Split, Atan>(in, m, w, row);
  Windows<T> sub;
  int j_ref[2];
  ref_sub_window<T, Split>(w, sh, sub, j_ref);
  using S1 = Jet<T, 25>;
  const SeededDelta<T, 25> delta = {0, 24};
  S1 pq[7];
  window_pq<T, Split, S1, true>(sub, 0, r3_first, delta, seeded<T, 25>(T(0), 24), pq);
  T pq_ref[7];
  for (int k = 0; k < 7; ++k) pq_ref[k] = pq[k].a;
  using S2 = Jet<T, kNewtonWideNS>;
  S2 r[2];
  const int steps = newton_chain<T, Split, Atan, S2>(w, row, pq_ref, sh, 0, r);
  const T v = row.valid;
  T* J = J_out + static_cast<size_t>(m) * 2 * sh.C;
  for (int rr = 0; rr < 2; ++rr) {
    const T* JG = r[rr].v;
    for (int c = 0; c < sh.Ct; ++c) J[rr * sh.C + c] = T(0);
    T t_ref = T(0);
    for (int sd = 0; sd < 25; ++sd) {
      T acc = T(0);
      for (int k = 0; k < 7; ++k) acc = acc + JG[k] * pq[k].v[sd];
      if (sd < 24) {
        J[rr * sh.C + ref_column(sh, Split, r3_first, j_ref, sd)] = acc * v;
      } else {
        t_ref = acc;
      }
    }
    for (int col = 0; col < sh.Ct + 13; ++col) {
      T x;
      if (col < sh.Ct + 6) {
        x = JG[7 + col];
      } else if (col == sh.Ct + 6) {
        x = JG[14 + sh.Ct] + t_ref;
      } else {
        x = T(0);
      }
      J[rr * sh.C + sh.Ct + col] = x * v;
    }
    r_out[2 * m + rr] = r[rr].a * v;
    Jrho_out[2 * m + rr] = JG[13 + sh.Ct] * v;
  }
  return steps;
}

// B8's row code on double: the cost-only chain, the kernel's lane group
// lane after lane (kB1Lanes), or one full-width jet a stage (kB1Wide).
struct HostNewton {
  template <bool Split, bool Atan>
  static void run(const NewtonInputs<double>& in, double* r, double* J, double* J_rho,
                  int* steps, double* margin, int mode) {
    const NewtonShape sh = newton_shape(in.W[0], in.W[1], in.cam.flags);
    std::vector<double> win(2 * sh.win);
    std::vector<unsigned char> work(newton_group_bytes<double>(sh));
    for (int m = 0; m < in.cam.M; ++m) {
      double rc[2];
      steps[m] = newton_cost_row<double, Split, Atan>(in, m, rc, win.data(), margin + m);
      if (in.cam.flags & kNewtonCostOnly) {
        r[2 * m] = rc[0];
        r[2 * m + 1] = rc[1];
      } else if (mode == kB1Wide) {
        newton_row_wide<double, Split, Atan>(in, m, r, J, J_rho);
      } else {
        newton_row_lanes<double, Split, Atan>(in, m, r, J, J_rho, work.data());
      }
    }
  }
};

// Each row's Newton path as the linearize schedule's primal stage records
// it: paths [M, 4] = the steps, the updates clamped at 0 and at readout,
// and the steps whose obs sub-window bases differ from the step before.
struct HostNewtonPaths {
  template <bool Split, bool Atan>
  static void run(const NewtonInputs<double>& in, int* paths) {
    const NewtonShape sh = newton_shape(in.W[0], in.W[1], in.cam.flags);
    std::vector<unsigned char> work(newton_group_bytes<double>(sh));
    const size_t M = static_cast<size_t>(in.cam.M);
    std::vector<double> r(2 * M), J(2 * M * sh.C), J_rho(2 * M);
    for (int m = 0; m < in.cam.M; ++m) {
      newton_row_lanes<double, Split, Atan>(in, m, r.data(), J.data(), J_rho.data(),
                                            work.data());
      const NewtonPath<double>& path =
          reinterpret_cast<const NewtonState<double>*>(work.data())->path;
      const NewtonStep<double>* step = path.step;
      int* p = paths + 4 * m;
      p[0] = path.steps;
      p[1] = p[2] = p[3] = 0;
      for (int k = 0; k + 1 < path.steps; ++k) {
        if (step[k].clamp) ++p[step[k + 1].e == 0.0 ? 1 : 2];
      }
      for (int k = 1; k < path.steps; ++k) {
        p[3] += step[k].j[0] != step[k - 1].j[0] || step[k].j[1] != step[k - 1].j[1];
      }
    }
  }
};

// The count's flag for the kernel's own schedule (the lane group's stages)
// instead of the function's.
constexpr int kNewtonCountLanes = 16;

// B8's operations: each row once in one full-width jet a stage, or the
// cost-only chain once; with kNewtonCountLanes, each row in the kernel's
// lane schedule. -1 for windows wider than newton_row_wide takes.
struct CountNewton {
  template <bool Split, bool Atan>
  static long long run(const NewtonInputs<Counted>& in) {
    const NewtonShape sh = newton_shape(in.W[0], in.W[1], in.cam.flags);
    const size_t M = static_cast<size_t>(in.cam.M);
    std::vector<Counted> r(M * 2), J_rho(M * 2), J(M * 2 * sh.C), win(2 * sh.win);
    std::vector<unsigned char> work(newton_group_bytes<Counted>(sh));
    g_ops = 0;
    for (int m = 0; m < in.cam.M; ++m) {
      if (in.cam.flags & kNewtonCostOnly) {
        newton_cost_row<Counted, Split, Atan>(in, m, r.data() + 2 * m, win.data());
      } else if (in.cam.flags & kNewtonCountLanes) {
        newton_row_lanes<Counted, Split, Atan>(in, m, r.data(), J.data(), J_rho.data(),
                                               work.data());
      } else if (newton_row_wide<Counted, Split, Atan>(in, m, r.data(), J.data(),
                                                       J_rho.data()) < 0) {
        return -1;
      }
    }
    return g_ops;
  }
};

}  // namespace

extern "C" {

// B8 row code on double: ins, W0, W1 and flags as for
// kontiki_newton_rows_f64 (the cost-only bit runs the cost chain; J and
// J_rho unused); mode kB1Lanes or kB1Wide; steps [M] and margin [M]: the
// Newton steps each row took and the smallest margin of their convergence
// tests, |dt^2 - bound| / bound, from the cost chain.
void kontiki_host_newton_rows_f64(const double* const* ins, double* r, double* J,
                                  double* J_rho, int* steps, double* margin, int M, int W0,
                                  int W1, int flags, int mode) {
  const NewtonInputs<double> in = make_newton_inputs<double>(
      reinterpret_cast<const void* const*>(ins), M, W0, W1, flags);
  newton_dispatch<HostNewton>(flags, in, r, J, J_rho, steps, margin, mode);
}

// Each row's Newton path in the linearize schedule (HostNewtonPaths):
// ins, W0, W1 and flags as for kontiki_newton_rows_f64; paths [M, 4].
void kontiki_host_newton_paths_f64(const double* const* ins, int* paths, int M, int W0, int W1,
                                   int flags) {
  const NewtonInputs<double> in = make_newton_inputs<double>(
      reinterpret_cast<const void* const*>(ins), M, W0, W1, flags);
  newton_dispatch<HostNewtonPaths>(flags, in, paths);
}

// The widest windows (knots a spline) of the function's operation count
// and of kontiki_host_newton_rows_f64's full-width mode.
int kontiki_newton_local_w() { return kNewtonLocalW; }

// Operations of B8's function on these inputs (the cost-only bit: of its
// cost-only form; kNewtonCountLanes: of the linearize kernel's schedule);
// -1 for windows wider than the function's count takes (kNewtonLocalW).
long long kontiki_count_newton_rows(const double* const* ins, int M, int W0, int W1,
                                    int flags) {
  int ks[kNewtonSlots];
  newton_ks(W0, W1, flags, ks);
  CountedInputs c(ins, ks, kNewtonSlots, M);
  const NewtonInputs<Counted> in = make_newton_inputs<Counted>(
      reinterpret_cast<const void* const*>(c.ptrs.data()), M, W0, W1, flags);
  return newton_dispatch<CountNewton>(flags, in);
}

// B4 row code on double: ins as for kontiki_imu_rows_f64; J unused when
// flags has the cost-only bit. wide = 0 runs the kernel's lane group, lane
// after lane; wide = 1 the one full-width jet that the operation count runs.
void kontiki_host_imu_rows_f64(const double* const* ins, double* r, double* J,
                               int M, int flags, int wide) {
  const ImuInputs<double> in =
      make_imu_inputs<double>(reinterpret_cast<const void* const*>(ins), M, flags);
  const int C = imu_columns(flags);
  for (int m = 0; m < M; ++m) {
    if (flags & kCostOnly) {
      imu_row_cost<double>(in, m, r);
    } else if (wide) {
      imu_row_wide<double>(in, m, r, J);
    } else {
      const ImuRow<double> row = load_row(in, m);
      for (int lane = 0; lane < kImuGroup; ++lane)
        imu_row_lane<double>(row, flags, lane, J + static_cast<size_t>(m) * 3 * C, r + 3 * m);
    }
  }
}

// Operations of B4's function on these inputs: each row once, all 13 seeds
// in one jet (the kernel's lanes each run one, each re-running the primal
// chain).
long long kontiki_count_imu_rows(const double* const* ins, int M, int flags) {
  CountedInputs c(ins, kImuKs, 10, M);
  const ImuInputs<Counted> in = make_imu_inputs<Counted>(
      reinterpret_cast<const void* const*>(c.ptrs.data()), M, flags);
  std::vector<Counted> r(static_cast<size_t>(M) * 3);
  std::vector<Counted> J(static_cast<size_t>(M) * 3 * imu_columns(flags));
  g_ops = 0;
  for (int m = 0; m < M; ++m) {
    if (flags & kCostOnly) {
      imu_row_cost<Counted>(in, m, r.data());
    } else {
      imu_row_wide<Counted>(in, m, r.data(), J.data());
    }
  }
  return g_ops;
}

// B1 row code on double: ins and flags as for kontiki_linearize_rows_f64;
// mode kB1Chunks, kB1Wide or kB1Lanes.
void kontiki_host_linearize_rows_f64(const double* const* ins, double* r, double* J,
                                     double* J_rho, int M, int flags, int mode) {
  const Inputs<double> in =
      make_inputs<double>(reinterpret_cast<const void* const*>(ins), M, flags);
  camera_dispatch<HostLinearize>(flags, in, r, J, J_rho, mode);
}

// B2 on double as the kernel accumulates it: the rows cut into blocks x
// warps ranges (a block's warps take ranges `blocks` apart), each block
// adding the products of ids below Ph into its own head triangle and g
// head, the others straight into H and g, the landmark outputs in runs per
// warp; the blocks' heads summed in order into H, mirrored, and g.
// Arguments as for kontiki_assemble_schur_f64; the outputs arrive zeroed.
void kontiki_host_assemble_schur_f64(const double* Jw, const int* cols, const double* rw,
                                     const double* J_rho, const int* lid, double* H,
                                     double* g, double* E, double* D, double* g_l, int M,
                                     int rdim, int C, int P, int L, int with_rho, int Ph,
                                     int blocks, int warps) {
  const SchurArgs<double> a = {Jw, rw, J_rho, cols, lid, H, g, E, D, g_l,
                               M, rdim, C, P, L, with_rho, Ph};
  const int nv = head_values(Ph);
  std::vector<double> ws(static_cast<size_t>(blocks) * nv);
  std::vector<double> wv(warp_values(rdim, C));
  std::vector<int> wi(warp_ints(C));
  for (int b = 0; b < blocks; ++b) {
    double* U = ws.data() + static_cast<size_t>(b) * nv;
    for (int w = 0; w < warps; ++w) {
      int lo, hi;
      warp_range(M, blocks, warps, b, w, &lo, &hi);
      warp_rows(a, lo, hi, U, U + nv - Ph, wv.data(), wi.data(), 0, 1);
    }
  }
  for (int t = 0; t < nv; ++t) reduce_head(ws.data(), blocks, P, Ph, t, H, g);
}

// B3 row code on double: ins and flags as for kontiki_cost_rows_f64; lanes
// = 0 runs the one-row-per-thread kernel's chain, 1 the lane kernel's
// stages.
void kontiki_host_cost_rows_f64(const double* const* ins, double* r, int M, int flags,
                                int lanes) {
  const Inputs<double> in =
      make_inputs<double>(reinterpret_cast<const void* const*>(ins), M, flags);
  camera_dispatch<HostCost>(flags, in, r, lanes);
}

// Operations of B1's function on these inputs.
long long kontiki_count_linearize_rows(const double* const* ins, int M, int flags) {
  int ks[kCameraSlots];
  camera_ks(flags, ks);
  CountedInputs c(ins, ks, kCameraSlots, M);
  const Inputs<Counted> in = make_inputs<Counted>(
      reinterpret_cast<const void* const*>(c.ptrs.data()), M, flags);
  return camera_dispatch<CountLinearize>(flags, in);
}

// Operations of B3's function on these inputs.
long long kontiki_count_cost_rows(const double* const* ins, int M, int flags) {
  int ks[kCameraSlots];
  camera_ks(flags, ks);
  CountedInputs c(ins, ks, kCameraSlots, M);
  const Inputs<Counted> in = make_inputs<Counted>(
      reinterpret_cast<const void* const*>(c.ptrs.data()), M, flags);
  return camera_dispatch<CountCost>(flags, in);
}

// B5 row code on double: kind 0 r3 / 1 so3 / 2 se3 (kEval*), win [M, 4, D],
// u [M]; outs the kind's outputs as for kontiki_eval_windows_f64.
void kontiki_host_eval_windows_f64(int kind, const double* win, const double* u,
                                   double dt, double* const* outs, int M) {
  const int n = 4 * eval_knot_dim(kind);
  for (int m = 0; m < M; ++m) eval_row<double>(kind, win + static_cast<size_t>(m) * n, u[m], dt, outs, m);
}

// Operations of B5's function on these queries: each query once.
long long kontiki_count_eval_windows(int kind, const double* win, const double* u,
                                     double dt, int M) {
  const int n = 4 * eval_knot_dim(kind);
  Counted w[28], o[5][4];
  Counted* outs[5] = {o[0], o[1], o[2], o[3], o[4]};
  g_ops = 0;
  for (int m = 0; m < M; ++m) {
    for (int k = 0; k < n; ++k) w[k] = Counted::value(win[static_cast<size_t>(m) * n + k]);
    eval_row<Counted>(kind, w, Counted::value(u[m]), Counted::value(dt), outs, 0);
  }
  return g_ops;
}

// B7 row code on double in its kernel's block schedule: knots [N, 3], ts
// [B]; p, v, a [B, 3]. Each block of kR3Times times stages its knots when
// they span at most kR3KnotsMax, and its outputs, each written from the
// staged copy.
void kontiki_host_r3_evaluate_f64(const double* knots, int N, double t0, double dt,
                                  const double* ts, double* p, double* v, double* a,
                                  int B) {
  std::vector<double> sk(3 * kR3KnotsMax), so(3 * kR3Times);
  double* outs[3] = {p, v, a};
  for (int b0 = 0; b0 < B; b0 += kR3Times) {
    const int n = std::min(kR3Times, B - b0);
    std::vector<int> i0(n);
    std::vector<double> u(n);
    int lo = N, hi = -1;
    for (int j = 0; j < n; ++j) {
      i0[j] = r3_index(ts[b0 + j], N, t0, dt, &u[j]);
      lo = std::min(lo, i0[j]);
      hi = std::max(hi, i0[j]);
    }
    const bool staged = hi - lo + 4 <= kR3KnotsMax;
    if (staged) std::copy(knots + 3 * lo, knots + 3 * (hi + 4), sk.begin());
    const double* kb = staged ? sk.data() : knots;
    const int base = staged ? lo : 0;
    std::vector<double> o(9 * static_cast<size_t>(n));
    for (int t = 0; t < kR3Threads; ++t) {
      for (int q = 0; q < kR3PerThread; ++q) {
        const int j = t * kR3PerThread + q;
        if (j < n) r3_values(kb + 3 * (i0[j] - base), u[j], dt, &o[9 * j]);
      }
    }
    for (int c = 0; c < 3; ++c) {
      for (int j = 0; j < n; ++j) {
        for (int k = 0; k < 3; ++k) so[3 * j + k] = o[9 * j + 3 * c + k];
      }
      std::copy(so.begin(), so.begin() + 3 * n, outs[c] + 3 * static_cast<size_t>(b0));
    }
  }
}

// Operations of B7's function on these times: each time once.
long long kontiki_count_r3_evaluate(const double* knots, int N, double t0, double dt,
                                    const double* ts, int B) {
  std::vector<Counted> k(static_cast<size_t>(N) * 3);
  for (size_t i = 0; i < k.size(); ++i) k[i] = Counted::value(knots[i]);
  Counted o[9];
  g_ops = 0;
  for (int b = 0; b < B; ++b) {
    r3_time<Counted>(k.data(), N, Counted::value(t0), Counted::value(dt),
                     Counted::value(ts[b]), o);
  }
  return g_ops;
}

}  // extern "C"
