// K1's and K4a's warp-register kernel on bfloat16 grids: the entry point of
// sweep1d_warp.cuh (design, bound and the TPU kernel it replaces there), in
// a translation unit of its own so that it builds beside the float one.
#include "sweep1d_warp.cuh"

// sweep1d_warp_run (sweep1d_warp.cuh) on bfloat16 elements: the any-vl
// instances at every vl, each product and sum rounded to bfloat16.
extern "C" int repro_sweep1d_warp_bf16(const void* in, void* out, int64_t batch, int64_t nb,
                                       int64_t m, int64_t vl, int64_t r, int64_t blocks,
                                       int64_t depth, int64_t edge, int64_t ntaps,
                                       const int32_t* offsets, const float* coeffs,
                                       void* stream) {
  return sweep1d_warp_run<__nv_bfloat16>(in, out, batch, nb, m, vl, r, blocks, depth, edge,
                                         ntaps, offsets, coeffs, stream);
}
