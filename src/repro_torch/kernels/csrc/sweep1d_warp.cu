// K1's and K4a's warp-register kernel on float grids: the entry points of
// sweep1d_warp.cuh (design, bound and the TPU kernel it replaces there).
#include "sweep1d_warp.cuh"

extern "C" int64_t repro_sweep1d_warp_blocks(int64_t m) { return run_blocks((int)m); }

// sweep1d_warp_run (sweep1d_warp.cuh) on float elements.
extern "C" int repro_sweep1d_warp_f32(const void* in, void* out, int64_t batch, int64_t nb,
                                      int64_t m, int64_t vl, int64_t r, int64_t blocks,
                                      int64_t depth, int64_t edge, int64_t ntaps,
                                      const int32_t* offsets, const float* coeffs,
                                      void* stream) {
  return sweep1d_warp_run<float>(in, out, batch, nb, m, vl, r, blocks, depth, edge, ntaps,
                                 offsets, coeffs, stream);
}
