// Kernel B8 newton_rows (csrc/newton_rows.cuh holds its row code and
// design): the C entry points, and the pinhole camera's instantiations on
// SE3 and split windows. The atan camera's are in newton_rows_atan.cu, so
// the two halves compile in parallel.
#include "newton_rows.cuh"

// newton_rows_atan.cu
extern "C" int kontiki_newton_atan_f32(const void* const* ins, void* r, void* J, void* J_rho,
                                       int M, int W0, int W1, int flags, void* stream);
extern "C" int kontiki_newton_atan_f64(const void* const* ins, void* r, void* J, void* J_rho,
                                       int M, int W0, int W1, int flags, void* stream);
extern "C" int kontiki_newton_atan_wave_f32(int W0, int W1, int flags);
extern "C" int kontiki_newton_atan_wave_f64(int W0, int W1, int flags);

// ins: kNewtonSlots (22) pointers in the order of NewtonInputs; W0, W1: the
// window widths (SE3 W, W; split W_r3, W_so3); flags: kNewtonSplit |
// kNewtonR3First | kNewtonAtan | kNewtonCostOnly. r [M, 2], J [M, 2, C] and
// J_rho [M, 2], C = 2 Ct + 13; J == nullptr (the cost-only form) writes r
// alone. kontiki_newton_rows_wave: the rows the linearize kernel holds on
// the card at once; kontiki_newton_rows_smem: the bytes of shared memory a
// block of it takes (the wrapper refuses windows whose block would not fit
// the card).
#define KT_NEWTON_ENTRY(SUFFIX, T)                                                    \
  extern "C" int kontiki_newton_rows##SUFFIX(const void* const* ins, void* r, void* J, \
                                             void* J_rho, int M, int W0, int W1,      \
                                             int flags, void* stream) {               \
    if (flags & kNewtonCostOnly) J = J_rho = nullptr;                                 \
    if (flags & kNewtonAtan) {                                                        \
      return kontiki_newton_atan##SUFFIX(ins, r, J, J_rho, M, W0, W1, flags, stream); \
    }                                                                                 \
    return launch_newton<T, false>(ins, r, J, J_rho, M, W0, W1, flags, stream);       \
  }                                                                                   \
  extern "C" int kontiki_newton_rows_wave##SUFFIX(int W0, int W1, int flags) {        \
    return (flags & kNewtonAtan) ? kontiki_newton_atan_wave##SUFFIX(W0, W1, flags)    \
                                 : newton_wave<T, false>(W0, W1, flags);              \
  }                                                                                   \
  extern "C" int kontiki_newton_rows_smem##SUFFIX(int W0, int W1, int flags) {        \
    return static_cast<int>(newton_linearize_smem<T>(W0, W1, flags));                 \
  }

KT_NEWTON_ENTRY(_f32, float)
KT_NEWTON_ENTRY(_f64, double)
