// Kernel B8 newton_rows on the atan camera (csrc/newton_rows.cuh holds its
// row code and design): SE3 and split windows. The C entry points in
// newton_rows.cu call these for flags with kNewtonAtan.
#include "newton_rows.cuh"

// As kontiki_newton_rows_*, on the atan camera.
extern "C" int kontiki_newton_atan_f32(const void* const* ins, void* r, void* J, void* J_rho,
                                       int M, int W0, int W1, int flags, void* stream) {
  return launch_newton<float, true>(ins, r, J, J_rho, M, W0, W1, flags, stream);
}

extern "C" int kontiki_newton_atan_f64(const void* const* ins, void* r, void* J, void* J_rho,
                                       int M, int W0, int W1, int flags, void* stream) {
  return launch_newton<double, true>(ins, r, J, J_rho, M, W0, W1, flags, stream);
}

// As kontiki_newton_rows_wave_*, on the atan camera.
extern "C" int kontiki_newton_atan_wave_f32(int W0, int W1, int flags) {
  return newton_wave<float, true>(W0, W1, flags);
}

extern "C" int kontiki_newton_atan_wave_f64(int W0, int W1, int flags) {
  return newton_wave<double, true>(W0, W1, flags);
}
