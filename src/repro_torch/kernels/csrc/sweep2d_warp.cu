// K3's and K4b's 2-D warp-register kernel on float grids: the entry points
// of sweep2d_warp.cuh (design, bound and the TPU kernel it replaces there).
#include "sweep2d_warp.cuh"

extern "C" int64_t repro_sweep2d_warp_max_depth(int64_t m, int64_t r) {
  return max_depth((int)m, (int)r);
}
extern "C" int64_t repro_sweep2d_warp_has_depth(int64_t m, int64_t r, int64_t depth) {
  return has_depth(m, r, depth);
}
extern "C" int64_t repro_sweep2d_warp_warps() { return kWarps; }

// sweep2d_warp_run (sweep2d_warp.cuh) on float elements.
extern "C" int repro_sweep2d_warp_f32(const void* in, void* out, int64_t batch, int64_t n0,
                                      int64_t nb, int64_t m, int64_t vl, int64_t r,
                                      int64_t depth, int64_t edge, int64_t seg, int64_t ntaps,
                                      const int32_t* offsets, const float* coeffs,
                                      void* stream) {
  return sweep2d_warp_run<float>(in, out, batch, n0, nb, m, vl, r, depth, edge, seg, ntaps,
                                 offsets, coeffs, stream);
}
