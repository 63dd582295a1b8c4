// Depth-`depth` advance of a 2-D grid held in the paper's local transpose
// layout (n0, nb, m, vl) on its minor axis, one launch per sweep chunk:
// K3's and K4b's warp-register kernel for 2-D stencils.
//
// Replaces: src/repro/kernels/stencil_kernels.py::_kernel_nd as launched by
// stencil_nd_sweep_ttile (K3, fully periodic) and by stencil_nd_multistep /
// stencil_nd_sweep_halo (K4b, with `edge_mask`: a Dirichlet ring, or open
// ends of axis 0), for 2-D stencils of reach r <= 4, any vl and any m on
// the instance M (the largest of 8, 4, 2, 1 dividing m), with depth up to
// repro_sweep2d_warp_max_depth(M, r) or the deep instance's below
// (stencil_kernels.sweep2d_launches cuts a deeper sweep into consecutive
// launches before the launch).  Only 2-D stencils of reach r > 4 or of
// more than kMaxTaps taps, which no registry stencil has, take the
// far-reach kernel of csrc/sweep_far.cu.
//
// Design: K1's warp-register kernel (csrc/sweep1d_warp.cu) streamed along
// axis 0.  A row's C = nb * vl columns each hold m consecutive elements;
// column c's element s lies at ((c / vl) * m + s) * vl + c % vl of the row.
// A warp row is 32 consecutive columns, and lane j of warp row v holds
// column (32 * v + j) mod C, whatever vl is: its m elements of a row, in m
// registers, so a tap shift along x inside a column is a register index.
// The r elements beyond a column's ends come from the lanes beside it by
// shuffle, one a halo element: left halo element q (0 <= q < r) is element
// m-1-(q % m) of lane j - d and right halo element q is element q % m of
// lane j + d, d = 1 + q / m (at r <= m every one is a neighbour's; at r > m
// the halo reaches ceil(r / m) lanes a side, as in csrc/sweep1d_warp.cu).
// A lane j < d (j >= 32 - d) takes the previous (next) warp row's edge
// element instead, a select after the shuffle.  A CTA holds kWarps warps
// on kWarps consecutive warp rows, their columns unwrapped and taken mod C
// lane by lane (so C < 32 and a partial last warp row work); a warp row's
// neighbour is another warp, so each warp publishes the r first and r last
// elements of its row in shared memory, from its ceil(r / m) end lanes on
// each side.  The two end warps are halo: their
// outer neighbours are missing (their own edges stand in), the error this
// makes moves r elements per step, and depth * r <= 32 * m keeps it inside
// them.  Only the middle warps store, and a lane only when its unwrapped
// column lies in [0, C): each column once, by a predicated store, so that
// no lane's test splits its warp ahead of the next step's shuffles (a
// branch there makes nvcc wrap each shuffle in code for a split warp).  Each lane computes its column's offset once per CTA
// (a shift and a mask when vl is a power of two, else one division).
// vl = 32 has instances of its own (kVl), with every stride a constant:
// a run-time stride costs the copies and stores an address computation
// per element.
//
// Sub-columns (csrc/cols.cuh).  The instances hold M in {1, 2, 4, 8}
// elements a column.  At m = g * M (M the largest of them dividing m) a
// column is g sub-columns of M
// consecutive elements of its row, sub-column u = g * c + h's element s
// at ((c / vl) * m + h * M + s) * vl + c % vl, and a row's C' = g * C
// sub-columns wrap mod C', the natural wrap.  Lane j of warp row v holds
// sub-column (32 * v + j) mod C', its x-neighbours are the lanes beside it
// as a column's are, and only a lane's offset changes: below, a column is
// a sub-column of M, m is M and C is C'.  The instances of any vl keep the
// one-column form for g = 1 as a branch of its own (as csrc/sweep3d.cu
// does); vl = 32's instances take g = 1 only.
//
// Along axis 0 a CTA walks a segment of rows [y0, y1), starting depth * r
// rows early and ending depth * r rows late, row indices wrapped mod n0 (in
// the periodic mode; see the ends below).
// Level l (l = 1..depth, level 0 the input) keeps its last 2r + 1 rows in
// registers: depth * (2r + 1) * m values a lane.  At step i the input row
// y0 - depth*r + i arrives and level l computes row y0 - depth*r + i -
// l*(r + 1), from rows of level l - 1 made at steps i - 1 - 2r .. i - 1.
// The skew of r + 1 (not r) rows per level means every level reads only
// what earlier steps made, so the levels of a step are independent and one
// barrier per step publishes every level's edges.  The levels run from
// depth down to 1, each reading its window's oldest row before the level
// below overwrites it.  Edge slots cycle mod 2r + 2: the 2r + 1 rows a step
// reads plus the one it writes.  Rows made before a level's first needed
// row, and after its last, feed no stored value.
//
// Input rows reach shared memory ahead of use: each lane copies its own m
// elements of row i + kStages with cp.async while step i computes (kStages
// rows of every warp in flight, a ring of kStages + 1 slots, 32 columns a
// warp).  A bfloat16 element is copied as the 4-byte word that holds it
// (elem.cuh); only the lane that copied it reads it, so it keeps which half
// is its own per ring slot (a bit a slot) and takes that half as it reads
// the row.  A warp's copy of an element row is 32 / vl runs of vl floats
// (vl <= 32) or one run of 32; at vl < 8 each run is half a 32-byte sector,
// whose other half the copy of the next element row reads from L1 (the
// copies are the L1-caching .ca form).
//
// The ends of axis 0 (the minor axis stays periodic).  Every thread of a
// CTA makes the same row of a level at a step, so whether that row lies at
// an end is one CTA-uniform test per level and step.  The periodic mode
// has instances of its own (kEnds false), free of those tests: in the same
// instances as ring and open they cost K3 10% at depth 4 on an H100.  Ring
// and open share instances (kEnds true) and tell each other apart by the
// run-time `edge`.  Outside the periodic mode row indices are not wrapped,
// and input rows outside [0, n0) are not loaded.
// - open: rows beyond either end hold 0 at every step.  A level row (the
//   input included) outside [0, n0) is published as zeros, into the window
//   and the edge slots; at level D it is never stored (the store guard keeps
//   to the segment's rows).
// - ring: the r first and last rows keep their value.  A level row y with
//   y < r or y >= n0 - r takes the previous level's row y (ext[R], already
//   in registers) in place of the tap sum, and is published and stored like
//   any other.  A row r or more from an end reads only rows inside the
//   grid, so what rows beyond the ends hold (never loaded) reaches only
//   rows beyond the ends: bit for bit the plain version's where(ring, old,
//   step).
// The selects come before `publish`, so no edge slot is read and written
// in one step, as in the periodic mode.
//
// Taps are summed in the spec's order, one multiply and one add each, with
// the coefficients already rounded to the element type and each product and
// sum rounded to it (elem.cuh's mul and add); built with -fmad=false this
// is bit for bit the plain PyTorch version.  At r = 1 the two orders the
// registry's 2-D stencils use (the star (0,0), (-1,0), (1,0), (0,-1),
// (0,1) of 2d5p and heat2d; row-major -1..1 x -1..1 of 2d9p) are template
// parameters, so every offset is a constant; any other tap list goes
// through a warp-uniform switch per tap.  At r = 2 the star of
// stencils._star_taps (centre, axis 0 at -1, +1, -2, +2, then axis 1) is
// a template parameter too.  Any other tap list of r > 1 is read at run
// time, which keeps the build short: the host cuts it into runs of
// consecutive taps on one window row (Taps2's runs; a star of reach r is
// 2r + 2 of them), and a run takes its row's x halo once, by shuffle, only
// when one of its taps is off x = 0, then each tap through a warp-uniform
// switch on its x offset (a switch on the row picks the window registers).
// So the window rows keep their registers and only the run's row is
// widened by its halo.  The r > 1 instances have the any-vl form only.
//
// Elements are float or bfloat16 (T) in device memory, registers and the
// edge slots (the input ring holds 4-byte words).  bfloat16 has the any-vl
// instances only (vl = 32 included).  The entry points are sweep2d_warp.cu (float) and
// sweep2d_warp_bf16.cu, each its own translation unit, built in parallel.
//
// Bound on H100: bytes.  A launch must read the grid once and write it once
// (2 * numel * sizeof(T) bytes); its arithmetic is depth * (2 * taps - 1) flops per
// point.  The design's extra reads are the halo warps (2 of kWarps blocks,
// read at the same time by the neighbouring CTA, so mostly L2 hits) and the
// 2 * depth * r warm-up rows of each segment.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#include "cols.cuh"
#include "elem.cuh"

namespace {

constexpr int kLanes = 32;               // a warp row: one column per lane
constexpr int kWarps = 10;               // warps per CTA: 8 stored blocks + 2 halo
constexpr int kThreads = kLanes * kWarps;
constexpr int kStages = 6;               // input rows in flight per warp
constexpr int kSlots = kStages + 1;      // the ring of input rows
constexpr int kMaxTaps = 64;
constexpr int kMaxR = 4;                 // the reaches the instances take: 1..kMaxR

// the ends of axis 0, numbered as csrc/sweep_far.cu's Edge
enum Edge : int { kPeriodic = 0, kRing = 1, kOpen = 2 };

// Deepest instance by (m, r) (stencil_kernels.WARP2D_DEPTH holds the
// same; every depth up to it): the register windows grow as depth * (2r +
// 1) * m, and ptxas caps a thread of a 320-thread CTA at 168 registers; at
// m = 8, r = 1 depth 5 spilled.  At r > 1 the depths stop at 2 (1 at m = 8
// beyond r = 2), which keeps the build short (each r > 1 instance builds
// slower than an r = 1 one; PERF.md section 6); deeper sweeps are
// consecutive launches.
__host__ __device__ constexpr int max_depth(int m, int r) {
  if (m != 1 && m != 2 && m != 4 && m != 8) return 0;
  if (r == 1) return m == 8 ? 4 : 8;
  if (r < 1 || r > kMaxR) return 0;
  return m == 8 && r > 2 ? 1 : 2;
}

// The deep instance past max_depth (stencil_kernels.WARP2D_DEEP holds the
// same): depth 16 at M = 2, 96 window values a lane, the reference tuner's
// deepest plan (k = 4, ttile = 4) in one launch where M = 2 is the largest
// instance dividing m (on an H100 4% faster than two of depth 8 at m = 2;
// at m = 8 four depth-4 launches of M = 8 beat it 2×, PERF.md section 6:
// a smaller M's deeper instance is issue-bound).  Built for the any-vl form
// only, at r = 1.
constexpr int kDeepM = 2, kDeepD = 16;

// The taps.  `runs` (r > 1): run q covers taps [end of run q - 1, end),
// all on window row k = oy + r, packed as k | x << 8 | end << 16, x 1 when
// a tap of the run is off x = 0.  The r > 1 path keeps its coefficients as
// floats (`f`): a bfloat16 array indexed at run time put the whole struct
// in local memory in the 1-D kernel.
template <typename T>
struct Taps2 {
  int n, nruns;
  int oy[kMaxTaps], ox[kMaxTaps];
  T c[kMaxTaps];
  float f[kMaxTaps];
  int runs[kMaxTaps];
};

// Offset of element 0 of sub-column u mod C' (u unwrapped) in its row;
// element s is s * vl on.  kVl: vl when the instance fixes it (g = 1),
// else 0, and then the 32-bit splits of cols.cuh (`sub`: C' sub-columns,
// g to a column), g = 1 in the one-column form.
template <int M, int kVl>
__device__ __forceinline__ int64_t col_offset(int64_t u, const Cols& cols, const Cols& sub) {
  if constexpr (kVl > 0) {
    const int64_t c = wrap(u, cols.n);
    return c / kVl * (M * kVl) + c % kVl;
  } else {
    unsigned q, h, rem;
    if (sub.vl == 1) {
      split_col((int)u, cols, q, rem);    // -32 <= u < C + 32 * kWarps
      return (int64_t)q * (M * cols.vl) + rem;
    }
    split_sub((int)u, cols, sub, q, h, rem);   // -32 <= u < C' + 32 * kWarps
    return (int64_t)(q * sub.vl + h) * (M * cols.vl) + rem;
  }
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// *dst = v where ok, with no branch: a lane's test never splits its warp
// before the shuffles that follow
__device__ __forceinline__ void store_if(float* dst, float v, bool ok) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %2, 0;\n @p st.global.f32 [%0], %1;\n}\n" ::"l"(dst),
      "f"(v), "r"((int)ok));
}

__device__ __forceinline__ void store_if(__nv_bfloat16* dst, __nv_bfloat16 v, bool ok) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %2, 0;\n @p st.global.b16 [%0], %1;\n}\n" ::"l"(dst),
      "h"(__bfloat16_as_ushort(v)), "r"((int)ok));
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The order of the taps, when it is one the kernel knows at compile time.
enum Order : int { kRuntime = 0, kStar = 1, kBox = 2 };

// Tap t of a known order as (oy, ox).  The star: centre, then axis 0 at
// -1, +1, -2, +2, ..., then axis 1 likewise; the box: row-major.
template <int R, int kOrder>
__host__ __device__ constexpr int tap_oy(int t) {
  return kOrder == kBox ? t / (2 * R + 1) - R
         : t == 0 || t > 2 * R ? 0 : ((t - 1) / 2 + 1) * ((t - 1) % 2 ? 1 : -1);
}

template <int R, int kOrder>
__host__ __device__ constexpr int tap_ox(int t) {
  return kOrder == kBox ? t % (2 * R + 1) - R
         : t <= 2 * R ? 0 : ((t - 1 - 2 * R) / 2 + 1) * ((t - 1 - 2 * R) % 2 ? 1 : -1);
}

template <int R, int kOrder>
__host__ __device__ constexpr int fixed_taps() {
  return kOrder == kBox ? (2 * R + 1) * (2 * R + 1) : 4 * R + 1;
}

// Whether row y + oy of the window needs the lanes' x halo: in the star
// only the centre row has taps off x = 0.
template <int R, int kOrder>
__host__ __device__ constexpr bool needs_x(int oy) {
  return kOrder != kStar || oy == 0;
}

// acc[s] (+)= ext[R + OY][R + s + OX] * cf for every row s, each product
// and sum rounded to T.  ext[k] holds row y + k - R of the previous level
// with R halo elements on each side.
template <typename T, int M, int R, int OY, int OX>
__device__ __forceinline__ void add_tap(T (&acc)[M], const T (&ext)[2 * R + 1][M + 2 * R], T cf,
                                        bool first) {
#pragma unroll
  for (int s = 0; s < M; ++s) {
    const T term = mul(ext[R + OY][R + s + OX], cf);
    acc[s] = first ? term : add(acc[s], term);
  }
}

template <typename T, int M, int R, int kOrder, int I = 0>
__device__ __forceinline__ void fixed(T (&acc)[M], const T (&ext)[2 * R + 1][M + 2 * R],
                                      const Taps2<T>& taps) {
  if constexpr (I < fixed_taps<R, kOrder>()) {
    add_tap<T, M, R, tap_oy<R, kOrder>(I), tap_ox<R, kOrder>(I)>(acc, ext, taps.c[I], I == 0);
    fixed<T, M, R, kOrder, I + 1>(acc, ext, taps);
  }
}

// Taps read at run time at r = 1: a warp-uniform switch per tap.
template <typename T, int M>
__device__ __forceinline__ void runtime(T (&acc)[M], const T (&ext)[3][M + 2],
                                        const Taps2<T>& taps) {
#pragma unroll 1
  for (int t = 0; t < taps.n; ++t) {
    const T cf = taps.c[t];
    const bool first = t == 0;
    switch ((taps.oy[t] + 1) * 3 + taps.ox[t] + 1) {   // the same case on every thread
      case 0: add_tap<T, M, 1, -1, -1>(acc, ext, cf, first); break;
      case 1: add_tap<T, M, 1, -1, 0>(acc, ext, cf, first); break;
      case 2: add_tap<T, M, 1, -1, 1>(acc, ext, cf, first); break;
      case 3: add_tap<T, M, 1, 0, -1>(acc, ext, cf, first); break;
      case 4: add_tap<T, M, 1, 0, 0>(acc, ext, cf, first); break;
      case 5: add_tap<T, M, 1, 0, 1>(acc, ext, cf, first); break;
      case 6: add_tap<T, M, 1, 1, -1>(acc, ext, cf, first); break;
      case 7: add_tap<T, M, 1, 1, 0>(acc, ext, cf, first); break;
      case 8: add_tap<T, M, 1, 1, 1>(acc, ext, cf, first); break;
      default: break;   // the entry point checks |oy|, |ox| <= 1
    }
  }
}

template <typename T, int M, int R, int kOrder>
__device__ __forceinline__ void apply_taps(T (&acc)[M], const T (&ext)[2 * R + 1][M + 2 * R],
                                           const Taps2<T>& taps) {
  if constexpr (kOrder != kRuntime) {
    fixed<T, M, R, kOrder>(acc, ext, taps);
  } else {
    runtime<T, M>(acc, ext, taps);
  }
}

template <int M, int R, int D>
constexpr size_t smem_floats() {
  return (size_t)kSlots * kWarps * M * kLanes + (size_t)D * (2 * R + 2) * kWarps * 2 * R;
}

// The input row of step p into ring slot p % kSlots: each lane copies the
// m elements of its column (`col`: element 0 of it in row 0; a row is
// `row` elements), bfloat16 ones as their words, and keeps in bit p %
// kSlots of `halves` which half of its element 0's word is the element.
// One commit group per step, empty past the rows the segment needs and,
// unless the mode is periodic, for rows beyond the ends.
template <typename T, int M, bool kEnds>
__device__ __forceinline__ void issue(const T* __restrict__ col, float* ring, unsigned& halves,
                                      int p, int nload, int64_t base, int64_t n0, int64_t row,
                                      int vl) {
  const int64_t y = base + p;
  if (p < nload && (!kEnds || (y >= 0 && y < n0))) {
    const T* src = col + wrap(y, n0) * row;
    const int slot = p % kSlots;
    float* dst = ring + slot * (kWarps * M * kLanes);
#pragma unroll
    for (int s = 0; s < M; ++s) cp_async4(dst + s * kLanes, word_of(src + s * vl));
    if constexpr (kIsBf16<T>) halves = (halves & ~(1u << slot)) | (word_parity(src) << slot);
  }
  cp_async_commit();
}

// A level-l row v made at a step i = q mod (2R + 1): into the window and,
// from the ceil(R / M) lanes at each end of the warp row, its R first and R
// last elements into edge slot e = i mod (2R + 2): element h of the first
// (h from the row's start: lane h / M, element h % M) at eg[h], and of the
// last (h from its end: lane 31 - h / M, element M - 1 - h % M) at eg[R + h].
template <typename T, int M, int R, int D>
__device__ __forceinline__ void publish(T (&win)[D][2 * R + 1][M], T* edges, int l, int q, int e,
                                        int w, int lane, const T (&v)[M]) {
  constexpr int kSpan = (R + M - 1) / M;   // lanes an edge spans
#pragma unroll
  for (int s = 0; s < M; ++s) win[l][q][s] = v[s];
  T* eg = edges + (((size_t)l * (2 * R + 2) + e) * kWarps + w) * 2 * R;
  if (lane < kSpan) {
#pragma unroll
    for (int s = 0; s < M; ++s)
      if (lane * M + s < R) eg[lane * M + s] = v[s];
  }
  if (lane >= kLanes - kSpan) {
#pragma unroll
    for (int s = 0; s < M; ++s) {
      const int h = (kLanes - 1 - lane) * M + M - 1 - s;
      if (h < R) eg[R + h] = v[s];
    }
  }
}

// Halo element q (0 <= q < R) beyond the left end of a lane's column: element
// M-1-(q % M) of lane j - d, d = 1 + q / M, by shuffle; a lane j < d takes
// element (d - 1 - j) * M + q % M of the previous warp row's last elements
// (`last`, published) instead.
template <typename T, int M>
__device__ __forceinline__ T halo_left(const T (&v)[M], const T* last, int lane, int q) {
  const int d = 1 + q / M, p = q % M;
  const T sh = shuffle(v[M - 1 - p], (lane + kLanes - d) & (kLanes - 1));
  return lane < d ? last[(d - 1 - lane) * M + p] : sh;
}

// Halo element q beyond the right end: element q % M of lane j + d; a lane
// j >= 32 - d takes element (j + d - 32) * M + q % M of the next warp row's
// first elements (`first`).
template <typename T, int M>
__device__ __forceinline__ T halo_right(const T (&v)[M], const T* first, int lane, int q) {
  const int d = 1 + q / M, p = q % M;
  const T sh = shuffle(v[p], (lane + d) & (kLanes - 1));
  return lane >= kLanes - d ? first[(lane + d - kLanes) * M + p] : sh;
}

// acc[s] (+)= row[R + s + OX] * cf for the tap with x offset ox (r > 1):
// a warp-uniform switch, a constant register index in each case.
template <typename T, int M, int R, int OX = -R>
__device__ __forceinline__ void tap_x(int ox, T (&acc)[M], const T (&row)[M + 2 * R], T cf,
                                      bool first) {
  if constexpr (OX <= R) {
    if (ox != OX) {
      tap_x<T, M, R, OX + 1>(ox, acc, row, cf, first);
      return;
    }
#pragma unroll
    for (int s = 0; s < M; ++s) {
      const T term = mul(row[R + s + OX], cf);
      acc[s] = first ? term : add(acc[s], term);
    }
  }
}

// Window row k into `row` (r > 1): the registers wv[(ph + K) % NW], a
// constant index once ph is; a switch on k, a constant K in each case.
template <typename T, int M, int R, int K = 0>
__device__ __forceinline__ void row_of(int k, T (&row)[M + 2 * R], const T (&wv)[2 * R + 1][M],
                                       int ph) {
  if constexpr (K <= 2 * R) {
    if (k != K) {
      row_of<T, M, R, K + 1>(k, row, wv, ph);
      return;
    }
#pragma unroll
    for (int s = 0; s < M; ++s) row[R + s] = wv[(ph + K) % (2 * R + 1)][s];
  }
}

// The r > 1 taps, their runs in order (Taps2): each run's row (row_of),
// widened by its x halo when the run needs it (edge slot (i + 1 + k) % E of
// the source level's edges `eg`), then its taps in order.
template <typename T, int M, int R>
__device__ __forceinline__ void runs(T (&acc)[M], const T (&wv)[2 * R + 1][M], int ph,
                                     const T* eg, int i, int lane, int wl, int wr,
                                     const Taps2<T>& taps) {
  int t0 = 0;
#pragma unroll 1
  for (int q = 0; q < taps.nruns; ++q) {
    const int run = taps.runs[q], k = run & 0xff, t1 = run >> 16;
    T row[M + 2 * R];
    row_of<T, M, R>(k, row, wv, ph);
    if ((run >> 8) & 1) {   // the same on every thread
      const T(&v)[M] = reinterpret_cast<const T(&)[M]>(row[R]);
      const T* egk = eg + (size_t)((i + 1 + k) % (2 * R + 2)) * kWarps * 2 * R;
#pragma unroll
      for (int h = 0; h < R; ++h) {
        const T left = halo_left(v, egk + (wl * 2 + 1) * R, lane, h);
        const T right = halo_right(v, egk + (wr * 2) * R, lane, h);
        row[R - 1 - h] = left;
        row[R + M + h] = right;
      }
    }
#pragma unroll 1
    for (int t = t0; t < t1; ++t)
      tap_x<T, M, R>(taps.ox[t], acc, row, from_f<T>(taps.f[t]), t == 0);
    t0 = t1;
  }
}

template <typename T, int M, int R, int D, int kOrder, bool kEnds, int kVl>
__global__ void __launch_bounds__(kThreads, 1)
sweep2d_warp(const T* __restrict__ in, T* __restrict__ out, int64_t n0, Cols cols, int64_t ncol,
             int64_t seg, int edge, Taps2<T> taps, Cols sub) {
  constexpr int NW = 2 * R + 1;    // window rows per level
  constexpr int E = 2 * R + 2;     // edge slots per level
  constexpr int X = M + 2 * R;     // a column with its x halo
  constexpr int kRow = kWarps * M * kLanes;   // one ring slot: a row span of the CTA
  extern __shared__ float smem[];
  // [D][E][kWarps][2][R]: lane 0's, lane 31's
  T* edges = reinterpret_cast<T*>(smem + (size_t)kSlots * kRow);
  // grid blockIdx.y of the batch: n0 rows of C' * M elements a grid, offset
  // in 64 bits
  in += (int64_t)blockIdx.y * n0 * ((kVl > 0 ? cols.n : sub.n) * M);
  out += (int64_t)blockIdx.y * n0 * ((kVl > 0 ? cols.n : sub.n) * M);
  const int lane = threadIdx.x & (kLanes - 1);
  const int w = threadIdx.x >> 5;
  const int64_t col = blockIdx.x % ncol;
  const int64_t y0 = blockIdx.x / ncol * seg;
  const int rows = (int)(n0 - y0 < seg ? n0 - y0 : seg);
  const int steps = rows + D * NW;
  const int nload = rows + 2 * D * R;
  const int64_t base = y0 - D * R;                   // the input row of step 0
  // level rows outside [lo, hi) are the ends' (ring: kept; open: zeros)
  const int64_t lo = edge == kRing ? R : 0;
  const int64_t hi = edge == kRing ? n0 - R : n0;
  // lane 0's column and this lane's, unwrapped (warp w holds warp row
  // col * (kWarps - 2) + w - 1), and the offset of its element 0 in a row
  const int64_t C = kVl > 0 ? cols.n : sub.n;        // C' (g = 1 at vl = 32)
  const int64_t ub = (col * (kWarps - 2) + w - 1) * kLanes;
  const int64_t u = ub + lane;
  const int64_t lane_col = col_offset<M, kVl>(u, cols, sub);
  const int64_t row = C * M;                         // elements a row
  const int vl = kVl > 0 ? kVl : cols.vl;
  // the middle warps store, those whose warp row starts inside the row, and
  // in them the lanes whose column does (at vl = 32, every lane)
  const bool stores = w >= 1 && w <= kWarps - 2 && ub < C;
  const bool lane_stores = kVl == kLanes || u < C;
  const int wl = w > 0 ? w - 1 : 0;                  // the end warps see themselves
  const int wr = w < kWarps - 1 ? w + 1 : kWarps - 1;
  float* ring = smem + w * (M * kLanes) + lane;      // this lane's elements of slot 0
  const T* lane_in = in + lane_col;
  unsigned halves = 0;                               // bfloat16: issue's bit a ring slot

  for (int e = threadIdx.x; e < D * E * kWarps * 2 * R; e += kThreads) edges[e] = zero<T>();

#pragma unroll
  for (int p = 0; p < kStages; ++p)
    issue<T, M, kEnds>(lane_in, ring, halves, p, nload, base, n0, row, vl);
  cp_async_wait<kStages - 1>();
  __syncthreads();

  // win[l][q]: the level-l row made at a step = q mod NW
  T win[D][NW][M];
#pragma unroll
  for (int l = 0; l < D; ++l)
#pragma unroll
    for (int q = 0; q < NW; ++q)
#pragma unroll
      for (int s = 0; s < M; ++s) win[l][q][s] = zero<T>();

#pragma unroll 1
  for (int i0 = 0; i0 < steps; i0 += NW) {
#pragma unroll
    for (int ph = 0; ph < NW; ++ph) {   // unrolled: every window index a constant
      const int i = i0 + ph;
      if (i >= steps) continue;         // the same on every thread
      T cur[M];
      const float* src = ring + (i % kSlots) * kRow;
      // bfloat16: element s lies s * vl elements past element 0
      const unsigned par = (halves >> (i % kSlots)) & 1u;
#pragma unroll
      for (int s = 0; s < M; ++s) cur[s] = word_elem<T>(src[s * kLanes], par ^ (s & vl & 1));
      if (kEnds && edge == kOpen && (base + i < 0 || base + i >= n0)) {
#pragma unroll
        for (int s = 0; s < M; ++s) cur[s] = zero<T>();
      }
#pragma unroll
      for (int l = D; l >= 1; --l) {
        // rows y + k - R of level l - 1, made at steps i - 1 - 2R + k:
        // window slot (ph + k) % NW, edge slot (i + 1 + k) % E
        const T* eg = edges + (size_t)(l - 1) * E * kWarps * 2 * R;
        T acc[M];
        if constexpr (R == 1 || kOrder != kRuntime) {
          T ext[NW][X];
#pragma unroll
          for (int k = 0; k < NW; ++k) {
            const T(&v)[M] = win[l - 1][(ph + k) % NW];
#pragma unroll
            for (int s = 0; s < M; ++s) ext[k][R + s] = v[s];
            if (needs_x<R, kOrder>(k - R)) {
              const T* egk = eg + (size_t)((i + 1 + k) % E) * kWarps * 2 * R;
#pragma unroll
              for (int q = 0; q < R; ++q) {
                ext[k][R - 1 - q] = halo_left(v, egk + (wl * 2 + 1) * R, lane, q);
                ext[k][R + M + q] = halo_right(v, egk + (wr * 2) * R, lane, q);
              }
            }
          }
          apply_taps<T, M, R, kOrder>(acc, ext, taps);
        } else {
          runs<T, M, R>(acc, win[l - 1], ph, eg, i, lane, wl, wr, taps);
        }
        if (kEnds) {
          const int64_t y = base + i - l * (R + 1);   // the row this level makes
          if (y < lo || y >= hi) {
            const T(&prev)[M] = win[l - 1][(ph + R) % NW];   // the previous level's row y
#pragma unroll
            for (int s = 0; s < M; ++s) acc[s] = edge == kRing ? prev[s] : zero<T>();
          }
        }
        if (l == D) {
          if (stores && i >= D * NW) {
            T* dst = out + (y0 + i - D * NW) * row + lane_col;
            if (kVl == kLanes) {
#pragma unroll
              for (int s = 0; s < M; ++s) dst[s * vl] = acc[s];
            } else {
#pragma unroll
              for (int s = 0; s < M; ++s) store_if(dst + s * vl, acc[s], lane_stores);
            }
          }
        } else {
          publish<T, M, R, D>(win, edges, l, ph, i % E, w, lane, acc);
        }
      }
      publish<T, M, R, D>(win, edges, 0, ph, i % E, w, lane, cur);
      issue<T, M, kEnds>(lane_in, ring, halves, i + kStages, nload, base, n0, row, vl);
      cp_async_wait<kStages - 1>();   // this lane's copy of row i + 1 has landed
      __syncthreads();                // every lane's, and this step's edges
    }
  }
  cp_async_wait<0>();
}

template <typename T, int M, int R, int D, int kOrder>
int go(const T* in, T* out, int64_t n0, const Cols& cols, const Cols& sub, int64_t ncol,
       int64_t seg, int edge, dim3 ctas, const Taps2<T>& taps, cudaStream_t stream) {
  const size_t smem = smem_floats<M, R, D>() * sizeof(float);
  // float's vl = 32 has instances of its own at g = 1, every stride a
  // constant (the deep instance and r > 1 have the any-vl form only)
  constexpr bool kHas32 = R == 1 && D <= max_depth(M, 1) && !kIsBf16<T>;
  constexpr int k32 = kHas32 ? kLanes : 0;
  const bool v32 = kHas32 && cols.vl == kLanes && sub.vl == 1;
  const auto kernel = edge == kPeriodic
                          ? (v32 ? sweep2d_warp<T, M, R, D, kOrder, false, k32>
                                 : sweep2d_warp<T, M, R, D, kOrder, false, 0>)
                          : (v32 ? sweep2d_warp<T, M, R, D, kOrder, true, k32>
                                 : sweep2d_warp<T, M, R, D, kOrder, true, 0>);
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<ctas, kThreads, smem, stream>>>(in, out, n0, cols, ncol, seg, edge, taps, sub);
  return (int)cudaGetLastError();
}

template <typename T, int M, int R, int D>
int launch_order(const T* in, T* out, int64_t n0, const Cols& cols, const Cols& sub,
                 int64_t ncol, int64_t seg, int edge, dim3 ctas, const Taps2<T>& taps,
                 int order, cudaStream_t stream) {
  if constexpr (R > 2) {   // run-time taps only
    return go<T, M, R, D, kRuntime>(in, out, n0, cols, sub, ncol, seg, edge, ctas, taps, stream);
  } else if constexpr (R == 2) {   // the star's compile-time order, or run-time taps
    return order == kStar
               ? go<T, M, R, D, kStar>(in, out, n0, cols, sub, ncol, seg, edge, ctas, taps, stream)
               : go<T, M, R, D, kRuntime>(in, out, n0, cols, sub, ncol, seg, edge, ctas, taps,
                                          stream);
  } else {
    switch (order) {
      case kStar:
        return go<T, M, R, D, kStar>(in, out, n0, cols, sub, ncol, seg, edge, ctas, taps, stream);
      case kBox:
        return go<T, M, R, D, kBox>(in, out, n0, cols, sub, ncol, seg, edge, ctas, taps, stream);
      default:
        return go<T, M, R, D, kRuntime>(in, out, n0, cols, sub, ncol, seg, edge, ctas, taps,
                                        stream);
    }
  }
}

template <typename T, int M, int R, int D>
int launch_depth(int depth, const T* in, T* out, int64_t n0, const Cols& cols, const Cols& sub,
                 int64_t ncol, int64_t seg, int edge, dim3 ctas, const Taps2<T>& taps,
                 int order, cudaStream_t stream) {
  if constexpr (M == kDeepM && R == 1) {
    if (depth == kDeepD)
      return launch_order<T, M, R, kDeepD>(in, out, n0, cols, sub, ncol, seg, edge, ctas, taps,
                                           order, stream);
  }
  if constexpr (D >= 1) {
    if (depth != D)
      return launch_depth<T, M, R, D - 1>(depth, in, out, n0, cols, sub, ncol, seg, edge, ctas,
                                          taps, order, stream);
    return launch_order<T, M, R, D>(in, out, n0, cols, sub, ncol, seg, edge, ctas, taps, order,
                                    stream);
  } else {
    return (int)cudaErrorInvalidValue;
  }
}

// The instances of M at reach 1 .. kMaxR, each from its deepest depth down.
template <typename T, int M>
int launch_m(int r, int depth, const T* in, T* out, int64_t n0, const Cols& cols,
             const Cols& sub, int64_t ncol, int64_t seg, int edge, dim3 ctas,
             const Taps2<T>& taps, int order, cudaStream_t stream) {
  switch (r) {
    case 1: return launch_depth<T, M, 1, max_depth(M, 1)>(depth, in, out, n0, cols, sub, ncol, seg, edge, ctas, taps, order, stream);
    case 2: return launch_depth<T, M, 2, max_depth(M, 2)>(depth, in, out, n0, cols, sub, ncol, seg, edge, ctas, taps, order, stream);
    case 3: return launch_depth<T, M, 3, max_depth(M, 3)>(depth, in, out, n0, cols, sub, ncol, seg, edge, ctas, taps, order, stream);
    case 4: return launch_depth<T, M, 4, max_depth(M, 4)>(depth, in, out, n0, cols, sub, ncol, seg, edge, ctas, taps, order, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Whether the instance (M, r) has depth `depth`.
constexpr bool has_depth(int64_t m, int64_t r, int64_t depth) {
  return (depth >= 1 && depth <= max_depth((int)m, (int)r)) ||
         (m == kDeepM && r == 1 && depth == kDeepD);
}

// Which Order the (oy, ox) offsets are in: the star or box at r = 1, the
// star at r = 2; any other list is read at run time.
template <int R>
int order_of(const int32_t* offsets, int64_t ntaps) {
  bool star = ntaps == fixed_taps<R, kStar>(), box = R == 1 && ntaps == fixed_taps<R, kBox>();
  for (int t = 0; t < ntaps; ++t) {
    const int oy = offsets[2 * t], ox = offsets[2 * t + 1];
    star = star && oy == tap_oy<R, kStar>(t) && ox == tap_ox<R, kStar>(t);
    box = box && oy == tap_oy<R, kBox>(t) && ox == tap_ox<R, kBox>(t);
  }
  return star ? kStar : box ? kBox : kRuntime;
}

int tap_order(const int32_t* offsets, int64_t ntaps, int64_t r) {
  return r == 1 ? order_of<1>(offsets, ntaps) : r == 2 ? order_of<2>(offsets, ntaps) : kRuntime;
}

// `depth` steps of each of the `batch` (n0, nb, m, vl) layout arrays `in`
// (contiguous, a grid a blockIdx.y, batch <= kMaxBatch) into `out` (another
// buffer) of T elements, at any vl and m (on the instance M, the largest
// of 8, 4, 2, 1 dividing m, with C' = nb * vl * m / M sub-columns a row;
// C' < 2^30 unless T is float, r = 1, vl = 32 and m = M) that has `depth`,
// for a 2-D stencil of reach r <= 4 (depth * r <= 32 * M), with the ends of
// axis 0 `edge` (0 periodic, 1 ring, 2 open; the minor axis is periodic),
// in segments of `seg` rows per CTA.  `offsets` holds ntaps (oy, ox) pairs
// and `coeffs` ntaps coefficients (rounded to T, as floats), both in host
// memory.  Returns the CUDA error code.
template <typename T>
int sweep2d_warp_run(const void* in, void* out, int64_t batch, int64_t n0, int64_t nb, int64_t m,
                     int64_t vl, int64_t r, int64_t depth, int64_t edge, int64_t seg,
                     int64_t ntaps, const int32_t* offsets, const float* coeffs, void* stream) {
  if (m < 1 || batch < 1 || batch > kMaxBatch) return (int)cudaErrorInvalidValue;
  const int64_t mi = m % 8 == 0 ? 8 : m % 4 == 0 ? 4 : m % 2 == 0 ? 2 : 1;   // the instance M
  const int64_t g = m / mi;                                  // sub-columns a column
  // the any-vl form's 32-bit column math (the deep instance, r > 1 and
  // bfloat16 have no other)
  const bool any_form =
      kIsBf16<T> || vl != kLanes || g != 1 || r != 1 || depth > max_depth((int)mi, 1);
  if (r < 1 || r > kMaxR || !has_depth(mi, r, depth) || depth * r > kLanes * mi ||
      edge < kPeriodic || edge > kOpen || n0 < 1 || nb < 1 || vl < 1 ||
      (any_form && nb * vl * g >= kMaxCols) || seg < 1 || seg > (1 << 24) ||
      ntaps < 1 || ntaps > kMaxTaps)
    return (int)cudaErrorInvalidValue;
  Taps2<T> taps;
  taps.n = (int)ntaps;
  taps.nruns = 0;
  for (int t = 0; t < ntaps; ++t) {
    taps.oy[t] = offsets[2 * t];
    taps.ox[t] = offsets[2 * t + 1];
    taps.c[t] = coeff_of<T>(coeffs[t]);
    taps.f[t] = coeffs[t];
    if (taps.oy[t] < -r || taps.oy[t] > r || taps.ox[t] < -r || taps.ox[t] > r)
      return (int)cudaErrorInvalidValue;
    // a tap on another row than the last one's starts a run
    const int k = taps.oy[t] + (int)r;
    if (t == 0 || (taps.runs[taps.nruns - 1] & 0xff) != k) taps.runs[taps.nruns++] = k;
    int& run = taps.runs[taps.nruns - 1];
    run = (run & 0x1ff) | (taps.ox[t] != 0 ? 0x100 : 0) | ((t + 1) << 16);
  }
  const Cols cols = make_cols(nb, vl);
  const Cols sub = make_cols(nb * vl, g);   // C' sub-columns, g to a column
  const int64_t wrows = (sub.n + kLanes - 1) / kLanes;   // warp rows of a row
  const int64_t ncol = (wrows + kWarps - 3) / (kWarps - 2);
  const int64_t ctas = ncol * ((n0 + seg - 1) / seg);
  if (ctas > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const T* src = static_cast<const T*>(in);
  T* dst = static_cast<T*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int d = (int)depth, e = (int)edge, rr = (int)r, order = tap_order(offsets, ntaps, r);
  const dim3 grid((unsigned)ctas, (unsigned)batch);   // the batch's grids along y
  switch (mi) {
    case 1: return launch_m<T, 1>(rr, d, src, dst, n0, cols, sub, ncol, seg, e, grid, taps, order, st);
    case 2: return launch_m<T, 2>(rr, d, src, dst, n0, cols, sub, ncol, seg, e, grid, taps, order, st);
    case 4: return launch_m<T, 4>(rr, d, src, dst, n0, cols, sub, ncol, seg, e, grid, taps, order, st);
    default: return launch_m<T, 8>(rr, d, src, dst, n0, cols, sub, ncol, seg, e, grid, taps, order, st);
  }
}

}  // namespace
