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
