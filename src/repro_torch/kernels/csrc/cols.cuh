// The local transpose layout's columns, as the register kernels
// (sweep1d_warp.cu, sweep2d_warp.cu, sweep3d.cu) address them.
//
// A row of the layout (the whole array at 1-D) is nb blocks of m * vl
// floats; column c (0 <= c < C = nb * vl) is lane c % vl of block c / vl,
// and its element s lies at ((c / vl) * m + s) * vl + c % vl.  Off the
// kernels' own vl = 32 the split of c is done at run time, once per thread:
// a shift and a mask when vl is a power of two, else one division.
//
// Sub-columns.  The kernels' instances hold M in {1, 2, 4, 8} elements a
// column.  Column c holds m consecutive natural points, so at m = g * M (M
// the largest of 8, 4, 2, 1 dividing m) it is g sub-columns of M points:
// sub-column u = g * c + h (0 <= h < g) has its element s at
// ((c / vl) * m + h * M + s) * vl + c % vl.  Its elements stay vl floats
// apart, sub-column u holds natural points u * M .. u * M + M - 1, and a
// row's C' = g * C sub-columns wrap mod C', which is the natural wrap; so a
// kernel written for columns of M runs every m with only its offsets
// changed (split_sub: c = u / g, a shift when g is a power of two, else
// one division).  The kernels' instances of vl = 32 take g = 1 only.
#pragma once
#include <stdint.h>

namespace {

// Columns a row may have for the 32-bit split (stencil_kernels.MAX_COLS
// holds the same): nvcc's 64-bit division is a call, and a call ahead of
// the shuffles of the 2-D kernel makes it wrap each shuffle in code for a
// split warp.
constexpr int64_t kMaxCols = int64_t(1) << 30;

// Grids of a batch a launch takes, one a blockIdx.y: the card's limit on
// gridDim.y (stencil_kernels.MAX_BATCH holds the same).
constexpr int64_t kMaxBatch = 65535;

__device__ __forceinline__ int64_t wrap(int64_t i, int64_t n) {
  if (i >= 0 && i < n) return i;
  const int64_t r = i % n;
  return r < 0 ? r + n : r;
}

// C columns (a row's, at 2-D and 3-D), vl to a block.  shift is log2(vl)
// when vl is a power of two, else -1.
struct Cols {
  int64_t n;
  int vl, shift;
};

inline Cols make_cols(int64_t nb, int64_t vl) {
  const int shift = (vl & (vl - 1)) == 0 ? __builtin_ctzll((unsigned long long)vl) : -1;
  return Cols{nb * vl, (int)vl, shift};
}

// Block q and lane rem of column u mod C (u unwrapped), in 32-bit
// arithmetic: C < kMaxCols.
__device__ __forceinline__ void split_col(int u, const Cols& cols, unsigned& q, unsigned& rem) {
  int c = u;
  if (c < 0 || c >= (int)cols.n) {
    c %= (int)cols.n;
    if (c < 0) c += (int)cols.n;
  }
  if (cols.shift >= 0) {
    q = (unsigned)c >> cols.shift;
    rem = (unsigned)c & (cols.vl - 1);
  } else {
    q = (unsigned)c / (unsigned)cols.vl;
    rem = (unsigned)c - q * cols.vl;
  }
}

// Sub-column u mod C' (u unwrapped) as block q and lane rem of its column
// c = u / g and its place h = u % g in that column (`sub`: C' sub-columns,
// g to a column; `cols`: C columns, vl to a block), in 32-bit arithmetic:
// C' < kMaxCols.  Its element 0 lies at (q * g + h) * (M * vl) + rem.
__device__ __forceinline__ void split_sub(int u, const Cols& cols, const Cols& sub, unsigned& q,
                                          unsigned& h, unsigned& rem) {
  unsigned c;
  split_col(u, sub, c, h);
  split_col((int)c, cols, q, rem);      // 0 <= c < C
}

}  // namespace
