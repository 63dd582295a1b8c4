// K3's and K4b's 2-D warp-register kernel on bfloat16 grids: the entry
// point of sweep2d_warp.cuh (design, bound and the TPU kernel it replaces
// there), in a translation unit of its own so that it builds beside the
// float one.
#include "sweep2d_warp.cuh"

// sweep2d_warp_run (sweep2d_warp.cuh) on bfloat16 elements: the any-vl
// instances at every vl, each product and sum rounded to bfloat16.
extern "C" int repro_sweep2d_warp_bf16(const void* in, void* out, int64_t batch, int64_t n0,
                                       int64_t nb, int64_t m, int64_t vl, int64_t r,
                                       int64_t depth, int64_t edge, int64_t seg, int64_t ntaps,
                                       const int32_t* offsets, const float* coeffs,
                                       void* stream) {
  return sweep2d_warp_run<__nv_bfloat16>(in, out, batch, n0, nb, m, vl, r, depth, edge, seg,
                                         ntaps, offsets, coeffs, stream);
}
