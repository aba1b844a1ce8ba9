// Kernels B1 linearize_rows and B3 cost_rows (csrc/camera_rows.cuh holds
// their row code, design and bounds): the C entry points, and the pinhole
// camera's instantiations, static and lifting rows on SE3 and split
// windows. The atan camera's are in linearize_rows_atan.cu, so the two
// halves compile in parallel.
#include "camera_rows.cuh"

// linearize_rows_atan.cu
extern "C" int kontiki_camera_atan_f32(const void* const* ins, void* r, void* J,
                                       void* J_rho, int M, int flags, void* stream);
extern "C" int kontiki_camera_atan_f64(const void* const* ins, void* r, void* J,
                                       void* J_rho, int M, int flags, void* stream);
extern "C" int kontiki_camera_atan_wave_f32(int flags);
extern "C" int kontiki_camera_atan_wave_f64(int flags);

namespace {

template <typename T>
int launch_pinhole(const void* const* ins, void* r, void* J, void* J_rho, int M,
                   int flags, void* stream) {
  if (flags & kCamLifting) {
    return launch_camera<T, false, true>(ins, r, J, J_rho, M, flags, stream);
  }
  return launch_camera<T, false, false>(ins, r, J, J_rho, M, flags, stream);
}

template <typename T>
int pinhole_wave(int flags) {
  return (flags & kCamLifting) ? cost_wave<T, false, true>(flags)
                               : cost_wave<T, false, false>(flags);
}

}  // namespace

// ins: kCameraSlots (23) pointers in the order of Inputs; flags: kCamSplit |
// kCamR3First | kCamAtan | kCamLifting. r [M, R], J [M, R, C], J_rho [M, R]
// with R, C of the rows' kind (RowShape). kontiki_cost_rows_wave: the most
// rows B3 runs on its lane kernel (more take its one-row-per-thread kernel).
#define KT_CAMERA_ENTRIES(SUFFIX, T)                                            \
  extern "C" int kontiki_linearize_rows##SUFFIX(const void* const* ins, void* r, \
                                               void* J, void* J_rho, int M,     \
                                               int flags, void* stream) {       \
    if (flags & kCamAtan) {                                                     \
      return kontiki_camera_atan##SUFFIX(ins, r, J, J_rho, M, flags, stream);   \
    }                                                                           \
    return launch_pinhole<T>(ins, r, J, J_rho, M, flags, stream);               \
  }                                                                             \
  extern "C" int kontiki_cost_rows##SUFFIX(const void* const* ins, void* r,     \
                                          int M, int flags, void* stream) {     \
    if (flags & kCamAtan) {                                                     \
      return kontiki_camera_atan##SUFFIX(ins, r, nullptr, nullptr, M, flags,    \
                                         stream);                               \
    }                                                                           \
    return launch_pinhole<T>(ins, r, nullptr, nullptr, M, flags, stream);       \
  }                                                                             \
  extern "C" int kontiki_cost_rows_wave##SUFFIX(int flags) {                    \
    return (flags & kCamAtan) ? kontiki_camera_atan_wave##SUFFIX(flags)         \
                              : pinhole_wave<T>(flags);                         \
  }

KT_CAMERA_ENTRIES(_f32, float)
KT_CAMERA_ENTRIES(_f64, double)
