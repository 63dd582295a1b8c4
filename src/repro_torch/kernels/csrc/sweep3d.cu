// K3's and K4b's 3-D streaming kernel on float grids: the entry points of
// sweep3d.cuh (design, bound and the TPU kernel it replaces there).
#include "sweep3d.cuh"

// The deepest instance of (m, r) (m its M: 1, 2, 4 or 8; 0 for none).
extern "C" int64_t repro_sweep3d_max_depth(int64_t m, int64_t r) {
  return max_depth((int)m, (int)r);
}

// An instance's tile (m its M: 1, 2, 4 or 8; the same for float and
// bfloat16): `what` 0 its rows Ty, 1 its columns Cx, 2 its threads, 3 its
// dynamic shared memory in bytes (-1 for no instance: r > 1 has the
// run-time order, and r = 2 the star's).
extern "C" int64_t repro_sweep3d_tile(int64_t m, int64_t r, int64_t depth, int64_t order,
                                      int64_t what) {
  switch (m) {
    case 1: return tile_of_m<1>(r, depth, order, what);
    case 2: return tile_of_m<2>(r, depth, order, what);
    case 4: return tile_of_m<4>(r, depth, order, what);
    case 8: return tile_of_m<8>(r, depth, order, what);
    default: return -1;
  }
}

// sweep3d_run (sweep3d.cuh) on float elements.
extern "C" int repro_sweep3d_f32(const void* in, void* out, int64_t batch, int64_t n0,
                                 int64_t n1, int64_t nb, int64_t m, int64_t vl, int64_t r,
                                 int64_t depth, int64_t edge, int64_t seg, int64_t ntaps,
                                 const int32_t* offsets, const float* coeffs, void* stream) {
  return sweep3d_run<float>(in, out, batch, n0, n1, nb, m, vl, r, depth, edge, seg, ntaps,
                            offsets, coeffs, stream);
}
