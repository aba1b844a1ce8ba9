// Kernels B1 linearize_rows and B3 cost_rows on the atan camera
// (csrc/camera_rows.cuh holds their row code, design and bounds): static
// and lifting rows on SE3 and split windows. The C entry points in
// linearize_rows.cu call these for flags with kCamAtan.
#include "camera_rows.cuh"

namespace {

template <typename T>
int launch_atan(const void* const* ins, void* r, void* J, void* J_rho, int M,
                int flags, void* stream) {
  if (flags & kCamLifting) {
    return launch_camera<T, true, true>(ins, r, J, J_rho, M, flags, stream);
  }
  return launch_camera<T, true, false>(ins, r, J, J_rho, M, flags, stream);
}

template <typename T>
int atan_wave(int flags) {
  return (flags & kCamLifting) ? cost_wave<T, true, true>(flags)
                               : cost_wave<T, true, false>(flags);
}

}  // namespace

// As kontiki_linearize_rows_*, J == nullptr launching B3.
extern "C" int kontiki_camera_atan_f32(const void* const* ins, void* r, void* J,
                                       void* J_rho, int M, int flags, void* stream) {
  return launch_atan<float>(ins, r, J, J_rho, M, flags, stream);
}

extern "C" int kontiki_camera_atan_f64(const void* const* ins, void* r, void* J,
                                       void* J_rho, int M, int flags, void* stream) {
  return launch_atan<double>(ins, r, J, J_rho, M, flags, stream);
}

// As kontiki_cost_rows_wave_*, on the atan camera.
extern "C" int kontiki_camera_atan_wave_f32(int flags) { return atan_wave<float>(flags); }

extern "C" int kontiki_camera_atan_wave_f64(int flags) { return atan_wave<double>(flags); }
