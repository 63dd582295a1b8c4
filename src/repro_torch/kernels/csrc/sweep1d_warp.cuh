// Depth-`depth` advance of a 1-D grid held in the paper's local transpose
// layout (nb, m, vl), one launch per sweep chunk: K1's and K4a's
// warp-register kernel.
//
// Replaces: src/repro/kernels/stencil_kernels.py::_kernel_1d as launched by
// stencil1d_sweep_ttile (K1, fully periodic) and by stencil1d_multistep /
// stencil1d_sweep_halo (K4a, with `edge_mask`: a Dirichlet ring, or open
// ends), for any vl, any m on the instance M (the largest of 8, 4, 2, 1
// dividing m) and any reach r <= 4: one launch takes depth * r <= 32 * M,
// and stencil_kernels.sweep1d_launches cuts a deeper sweep into consecutive
// launches (stencil_kernels.sweep1d_route picks this kernel before the
// launch).  Only r > 4 or more than kMaxTaps taps, which no registry
// stencil has, takes the far-reach kernel of csrc/sweep_far.cu.
//
// Design: K5b (csrc/onestep.cu) carried through `depth` steps in registers.
// The layout's C = nb * vl columns each hold m consecutive natural
// elements; column c's element s lives at ((c / vl) * m + s) * vl + c % vl.
// A warp row is 32 consecutive columns, and lane j of warp row v holds
// column (32 * v + j) mod C: its m elements, in m registers, whatever vl is.
// At vl = 32 a warp row is a layout block.  A warp owns a run of B
// consecutive warp rows and loads it with one halo warp row on each side:
// B + 2 slots of m registers per lane.  Each lane computes its column's
// offset once per slot (a shift and a mask when vl is a power of two, else
// one division), and reads row s at offset + s * vl: a warp's load of a row
// is 32 / vl runs of vl floats (vl <= 32) or one run of 32.  Columns are
// taken mod C, so a grid of fewer than 32 columns wraps within a slot.  The
// slots hold (B + 2) * 32 * m consecutive natural elements of the periodic
// grid.  vl = 32 has instances of its own (kVl), with every stride a
// constant and the ends tested per slot: a slot then lies inside the grid
// or beyond it as a whole.  The instances of any other vl (kVl = 0) cost
// the address arithmetic of a run-time vl, once per slot at the load and
// the store.
//
// Sub-columns (csrc/cols.cuh).  The instances hold M in {1, 2, 4, 8}
// registers a slot.  At m = g * M a column is g sub-columns of M
// consecutive natural elements, sub-column u = g * c + h's element s at
// ((c / vl) * m + h * M + s) * vl + c % vl, and the C' = g * C
// sub-columns wrap mod C', the natural wrap.  Lane j of warp row v holds
// sub-column (32 * v + j) mod C', its neighbours are the lanes beside it as
// a column's are, and only a lane's offsets change: below, a column is a
// sub-column of M, m is M and C is C'.  At g > 1 a lane splits its slot-0
// sub-column once and steps its (block, lane, place) by the 32 sub-columns
// of a warp row from slot to slot (SubWalk, 32-bit: C' < 2^30), with no
// division per slot:
// the split at every slot ran 1d3p at m = 3 3.2 times slower (PERF.md,
// section 6).  g = 1 keeps the one-column form as a branch of its own (as
// csrc/sweep3d.cu does); vl = 32's instances take g = 1 only.
//
// Each step runs in registers.  A tap shift inside a column is a register
// index.  The r rows beyond each end of a column come from the lanes beside
// it, one shuffle a row: left halo row q (0 <= q < r) is row M-1-(q % M) of
// lane j - d and right halo row q is row q % M of lane j + d, where d = 1 +
// q / M (so at r <= M every halo row is a neighbour's; at r > M, as 1d5p at
// odd m, the halo reaches ceil(r / M) lanes a side).  A lane j < d (j >= 32
// - d) takes its left (right) rows from lane 32 + j - d (j + d - 32) of the
// previous (next) slot, which that lane sends in place of its own: a select
// a distance before the shuffle, the paper's Assemble.  Slots are updated
// in place in ascending order.  The min(r, M) old tail rows of the previous
// slot are carried in registers, because lanes 32 - d .. 31 send them to the
// next slot's first lanes after their slot was overwritten; the next slot's
// head rows are still old when they are sent.  Every edge row of a slot is
// shuffled before the slot is overwritten.
//
// The two ends of the loaded span have no loaded neighbour (the slot's own
// rows stand in), so after `depth` steps the outer depth * r elements of
// each end are wrong.  They lie inside the halo slots as long as
// depth * r <= 32 * m, and a lane stores only in the middle B slots, and
// only when its unwrapped column 32 * v + j lies in [0, C): each column
// once, never a wrapped duplicate.  No shared memory, no barrier, no
// division per element.  Idle warps of the last CTA compute the last run
// again and store nothing, so every lane runs every shuffle.
//
// The ends of the grid (kEdge, warp-uniform, a template parameter), decided
// per lane by its unwrapped column u (at vl = 32 per slot):
// - periodic: as above.
// - open: cells beyond either end read as 0 at every step.  A lane whose u
//   lies outside [0, C) loads zeros and never writes them, so it is the
//   exact neighbour of the end column.
// - ring: the r cells nearest each end keep their value: rows s of the
//   lanes with u < ceil(r / M) where u * M + s < r, and of the lanes with
//   u >= C - ceil(r / M) where u * M + s >= C * M - r.  The periodic update
//   runs unchanged, and those lanes put back the values they loaded as each
//   slot is written.  A cell at least r from an end never reads beyond it,
//   so what a wrapped column holds reaches only ring cells, which are
//   restored: bit for bit the plain version's where(ring, old, step).
//
// Taps are summed in the spec's order, one multiply and one add each, with
// the coefficients already rounded to the element type and each product and
// sum rounded to it (elem.cuh's mul and add); built with -fmad=false this
// is bit for bit the plain PyTorch version.  The two orders the registry's 1-D
// stencils use (0, -1, 1, -2, 2, ... and -r..r) are template parameters, so
// every offset is a constant; any other tap list goes through a
// warp-uniform switch per tap and slot, as in K5b.  Of the instances with
// r > M only (M, r) = (1, 2), 1d5p's at odd m, has the compile-time orders:
// the others read their taps at run time, which keeps the build short.
//
// Elements are float or bfloat16 (T), in device memory and in registers.
// bfloat16 has the any-vl instances only (kVl = 0, vl = 32 included): its
// own vl = 32 instances would double its build for a stride.  The entry
// points are sweep1d_warp.cu (float) and sweep1d_warp_bf16.cu, each its own
// translation unit so that nvcc builds them in parallel.
//
// Bound on H100: bytes.  A launch must read the grid once and write it once
// (2 * numel * sizeof(T) bytes); its arithmetic is depth * (2 * taps - 1) flops per
// point, far below the FP32 rate.  Each warp row is read from device memory
// by its own warp; the halo slots are the neighbouring warps' rows, mostly
// L2 hits.  The cost of the design is the 2 / B halo recompute; B is chosen
// per m so that a lane's (B + 2) * m values stay at 80 or below.  At vl < 8
// a row load uses half of each 32-byte sector; the other half is the next
// row's, read from L1.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#include "cols.cuh"
#include "elem.cuh"

namespace {

constexpr int kLanes = 32;    // a warp row: one column per lane
constexpr int kWarps = 4;     // warps per CTA
constexpr int kMaxTaps = 16;
constexpr int kMaxR = 4;

// the ends of the grid, numbered as csrc/sweep_far.cu's Edge
enum Edge : int { kPeriodic = 0, kRing = 1, kOpen = 2 };

// Warp rows per warp run, by m (stencil_kernels.WARP_BLOCKS holds the same).
// m = 1 stops at 32: nvcc leaves a loop of 66 slots rolled, which puts them
// in local memory.
constexpr int run_blocks(int m) { return m == 1 ? 32 : m == 2 ? 32 : m == 4 ? 16 : 8; }

// The coefficients stay floats (each already rounded to the element type):
// a bfloat16 array indexed at run time put the whole struct in local memory
// (104 bytes a thread; a float array is read from the parameter bank).
struct Taps1 {
  int n;
  int o[kMaxTaps];
  float c[kMaxTaps];
};

// Offset of element 0 of column c (0 <= c < C); element s is s * vl on.
template <int M>
__device__ __forceinline__ int64_t col_offset(int64_t c, const Cols& cols) {
  int64_t q, rem;
  if (cols.shift >= 0) {
    q = c >> cols.shift;
    rem = c & (cols.vl - 1);
  } else {
    q = c / cols.vl;
    rem = c - q * cols.vl;
  }
  return q * (M * cols.vl) + rem;
}

// The offsets of element 0 of one lane's sub-columns u, u + 32, u + 64, ...
// mod C' at g = sub.vl > 1 (C' < kMaxCols), one a slot: u is split once
// (cols.cuh's split_sub) into block q, lane rem and place h, and each step
// adds the 32 sub-columns of a warp row (32 / g columns, 32 % g places)
// with carries, no division.  Sub-column (q, h, rem)'s element 0 lies at
// (q * g + h) * (M * vl) + rem.
template <int M>
struct SubWalk {
  unsigned q, h, rem, g, vl, nb, dq, dh, dr;
  __device__ __forceinline__ SubWalk(int64_t u, const Cols& cols, const Cols& sub)
      : g(sub.vl), vl(cols.vl) {
    split_sub((int)u, cols, sub, q, h, rem);    // -32 <= u < C' + 32 * S
    nb = cols.shift >= 0 ? (unsigned)cols.n >> cols.shift : (unsigned)cols.n / vl;
    dh = kLanes % g;
    dq = kLanes / g / vl;
    dr = kLanes / g - dq * vl;
  }
  __device__ __forceinline__ int64_t offset() const {
    return (int64_t)(q * g + h) * ((int64_t)M * vl) + rem;
  }
  __device__ __forceinline__ void step() {
    h += dh;
    const unsigned carry = h >= g;
    if (carry) h -= g;
    rem += dr + carry;
    q += dq;
    if (rem >= vl) {
      rem -= vl;
      ++q;
    }
    while (q >= nb) q -= nb;   // past sub-column C' - 1
  }
};

// acc[s] (+)= ext[R + s + O] * cf for every row s: a register index, each
// product and sum rounded to T.  ext holds the column's rows with R
// Assembled rows on each side.
template <typename T, int M, int R, int O>
__device__ __forceinline__ void add_tap(T (&acc)[M], const T (&ext)[M + 2 * R], T cf,
                                        bool first) {
  if constexpr (O >= -R && O <= R) {
#pragma unroll
    for (int s = 0; s < M; ++s) {
      const T term = mul(ext[R + s + O], cf);
      acc[s] = first ? term : add(acc[s], term);
    }
  }
}

// Taps read at run time: a warp-uniform switch per tap (as K5b).
template <typename T, int M, int R>
__device__ __forceinline__ void apply_runtime_taps(T (&acc)[M], const T (&ext)[M + 2 * R],
                                                   const Taps1& taps) {
  // kept rolled: unrolled, it stops nvcc unrolling the slot loop at m = 1,
  // which then puts the slots in local memory
#pragma unroll 1
  for (int t = 0; t < taps.n; ++t) {
    const T cf = from_f<T>(taps.c[t]);
    const bool first = t == 0;
    switch (taps.o[t]) {   // the same case on every thread: no divergence
      case -4: add_tap<T, M, R, -4>(acc, ext, cf, first); break;
      case -3: add_tap<T, M, R, -3>(acc, ext, cf, first); break;
      case -2: add_tap<T, M, R, -2>(acc, ext, cf, first); break;
      case -1: add_tap<T, M, R, -1>(acc, ext, cf, first); break;
      case 0: add_tap<T, M, R, 0>(acc, ext, cf, first); break;
      case 1: add_tap<T, M, R, 1>(acc, ext, cf, first); break;
      case 2: add_tap<T, M, R, 2>(acc, ext, cf, first); break;
      case 3: add_tap<T, M, R, 3>(acc, ext, cf, first); break;
      case 4: add_tap<T, M, R, 4>(acc, ext, cf, first); break;
      default: break;   // the entry point checks |o| <= r
    }
  }
}

// The order of the taps, when it is one the kernel knows at compile time:
// the registry's star stencils list 0, -1, 1, -2, 2, ... (kCenterFirst),
// heat1d lists -r..r (kAscending); any other list is read at run time.
enum Order : int { kRuntime = 0, kCenterFirst = 1, kAscending = 2 };

template <int R, int kOrder>
__host__ __device__ constexpr int tap_offset(int t) {
  return kOrder == kAscending ? t - R : t == 0 ? 0 : (t + 1) / 2 * (t % 2 ? -1 : 1);
}

// The 2R+1 taps of a known order: every offset and `first` a constant.
template <typename T, int M, int R, int kOrder, int I = 0>
__device__ __forceinline__ void fixed_taps(T (&acc)[M], const T (&ext)[M + 2 * R],
                                           const Taps1& taps) {
  if constexpr (I < 2 * R + 1) {
    add_tap<T, M, R, tap_offset<R, kOrder>(I)>(acc, ext, from_f<T>(taps.c[I]), I == 0);
    fixed_taps<T, M, R, kOrder, I + 1>(acc, ext, taps);
  }
}

template <typename T, int M, int R, int kOrder>
__device__ __forceinline__ void apply_taps(T (&acc)[M], const T (&ext)[M + 2 * R],
                                           const Taps1& taps) {
  if constexpr (kOrder != kRuntime) {
    fixed_taps<T, M, R, kOrder>(acc, ext, taps);
  } else {
    apply_runtime_taps<T, M, R>(acc, ext, taps);
  }
}

// The periodic and open instances are held to 168 registers, three CTAs an
// SM: at m = 8 more registers leave two, and the sweep streams less well.
// The ring instances need more.
template <typename T, int M, int R, int B, int kOrder, int kEdge, int kVl>
__global__ void __launch_bounds__(kLanes * kWarps, kEdge == kRing ? 1 : 3)
sweep1d_warp(const T* __restrict__ in, T* __restrict__ out, Cols cols, int64_t nruns,
             int depth, Taps1 taps, Cols sub) {
  constexpr int S = B + 2;   // slots: the halo warp row, the run, the halo warp row
  constexpr int kSpan = (R + M - 1) / M;   // lanes a halo reaches a side
  constexpr int K = R < M ? R : M;         // rows of a slot a halo takes
  const int lane = threadIdx.x & (kLanes - 1);
  const int64_t w = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const bool live = w < nruns;
  const int64_t C = kVl == kLanes ? cols.n : sub.n;   // C' (g = 1 at vl = 32)
  // grid blockIdx.y of the batch: C' * M elements a grid, offset in 64 bits
  in += (int64_t)blockIdx.y * (C * M);
  out += (int64_t)blockIdx.y * (C * M);
  const int vl = kVl > 0 ? kVl : cols.vl;
  // lane 0's column in slot 0, unwrapped (only the first run's slot 0 lies
  // before column 0), and this lane's: slot i holds u0 + 32 * i
  const int64_t ub = ((live ? w : nruns - 1) * B - 1) * kLanes;
  const int64_t u0 = ub + lane;
  const bool first_run = ub < 0;
  // Slot i's columns against the grid's ends.  At vl = 32 (C a multiple of
  // 32) a slot lies inside the grid or beyond it as a whole, and slot `last`
  // (if below S) holds column C - 1 in lane 31: tests per slot.  At any
  // other vl each lane tests its own column.
  const int64_t tail_slot = (C - ub) / kLanes - 1;
  const int last = (int)(tail_slot < S ? tail_slot : S);
  auto beyond = [&](int i) {
    if constexpr (kVl == kLanes) {
      return (i == 0 && first_run) || i > last;
    } else {
      const int64_t u = u0 + i * kLanes;
      return u < 0 || u >= C;
    }
  };
  // element 0 of this lane's column in slot i (at vl = 32 slot i is layout
  // block ub / 32 + i), wrapped into the grid where it lies beyond it; at
  // g > 1 a SubWalk gives the slots' offsets in turn instead
  const bool one_col = kVl == kLanes || sub.vl == 1;
  auto offset = [&](int i, bool wrapped) {
    if constexpr (kVl == kLanes) {
      const int64_t b = ub / kLanes + i;
      return (wrapped ? wrap(b, C / kLanes) : b) * (M * kLanes) + lane;
    } else {
      const int64_t u = u0 + i * kLanes;
      return col_offset<M>(wrapped ? wrap(u, C) : u, cols);
    }
  };
  // v[i][s]: row s of this lane's column in slot i
  T v[S][M];
  // ring mode: the loaded ring rows, the first K of the lane's column in
  // slot 1 of the first run (columns u < kSpan) and the last K of its
  // column in slot hi_slot (columns C - 1 - hi_e, hi_e < kSpan), if any
  T ring_lo[K], ring_hi[K];
  int hi_slot = -1, hi_e = 0;
  if (one_col) {
#pragma unroll
    for (int i = 0; i < S; ++i) {
      if (kEdge == kOpen && beyond(i)) {
#pragma unroll
        for (int s = 0; s < M; ++s) v[i][s] = zero<T>();
        continue;
      }
      const T* src = in + offset(i, true);
#pragma unroll
      for (int s = 0; s < M; ++s) v[i][s] = src[s * vl];
    }
  } else {
    SubWalk<M> walk(u0, cols, sub);
#pragma unroll
    for (int i = 0; i < S; ++i) {
      const T* src = in + walk.offset();
      walk.step();
#pragma unroll
      for (int s = 0; s < M; ++s) v[i][s] = kEdge == kOpen && beyond(i) ? zero<T>() : src[s * vl];
    }
  }
  if (kEdge == kRing) {
    // columns 0 .. kSpan - 1 are lanes 0 .. kSpan - 1 of the first run's slot 1
#pragma unroll
    for (int p = 0; p < K; ++p) {
      ring_lo[p] = v[1][p];
      ring_hi[p] = zero<T>();
    }
#pragma unroll
    for (int i = 1; i < S; ++i) {
      const int64_t e = C - 1 - (u0 + i * kLanes);
      if (e >= 0 && e < kSpan) {
        hi_slot = i;
        hi_e = (int)e;
#pragma unroll
        for (int p = 0; p < K; ++p) ring_hi[p] = v[i][M - K + p];
      }
    }
  }
#pragma unroll 1
  for (int step = 0; step < depth; ++step) {
    // old rows M-1-p of the previous slot (slot 0 has none loaded: its own
    // rows stand in, inside the error the left halo slot absorbs)
    T tail[K];
#pragma unroll
    for (int p = 0; p < K; ++p) tail[p] = v[0][M - 1 - p];
#pragma unroll
    for (int i = 0; i < S; ++i) {
      constexpr int kLast = S - 1;
      const int nxt = i < kLast ? i + 1 : kLast;   // past the right end: own rows
      T ext[M + 2 * R];
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const int d = 1 + q / M, p = q % M;   // the lane distance and the row
        const T to_right = lane >= kLanes - d ? tail[p] : v[i][M - 1 - p];
        ext[R - 1 - q] = shuffle(to_right, (lane + kLanes - d) & (kLanes - 1));
        const T to_left = lane < d ? v[nxt][p] : v[i][p];
        ext[R + M + q] = shuffle(to_left, (lane + d) & (kLanes - 1));
      }
#pragma unroll
      for (int s = 0; s < M; ++s) ext[R + s] = v[i][s];
#pragma unroll
      for (int p = 0; p < K; ++p) tail[p] = v[i][M - 1 - p];
      T acc[M] = {};
      apply_taps<T, M, R, kOrder>(acc, ext, taps);
      if (kEdge == kRing) {
        // a row is a ring row when its natural point lies within r of an
        // end (at kSpan = 1 every row of the K kept)
        if (i == 1 && first_run && lane < kSpan) {
#pragma unroll
          for (int p = 0; p < K; ++p)
            if (kSpan == 1 || lane * M + p < R) acc[p] = ring_lo[p];
        }
        if (i == hi_slot) {
#pragma unroll
          for (int p = 0; p < K; ++p)
            if (kSpan == 1 || hi_e * M + K - p <= R) acc[M - K + p] = ring_hi[p];
        }
      }
      const bool hold = kEdge == kOpen && beyond(i);
      if (!hold) {
#pragma unroll
        for (int s = 0; s < M; ++s) v[i][s] = acc[s];
      }
    }
  }
  if (live && one_col) {
#pragma unroll
    for (int i = 1; i <= B; ++i) {
      if (!beyond(i)) {
        T* dst = out + offset(i, false);
#pragma unroll
        for (int s = 0; s < M; ++s) dst[s * vl] = v[i][s];
      }
    }
  } else if (live) {
    SubWalk<M> walk(u0 + kLanes, cols, sub);
#pragma unroll
    for (int i = 1; i <= B; ++i) {
      T* dst = out + walk.offset();
      walk.step();
      if (!beyond(i)) {
#pragma unroll
        for (int s = 0; s < M; ++s) dst[s * vl] = v[i][s];
      }
    }
  }
}

// The instance of tap order kOrder: vl = 32's own (float only, g = 1) or
// the any-vl one.  At r > M the layout's m >= r makes g = m / M at least 2,
// so those instances have no vl = 32 form.
template <typename T, int M, int R, int B, int kOrder, int kEdge>
auto instance(bool v32) {
  constexpr int k32 = kIsBf16<T> || R > M ? 0 : kLanes;
  return v32 ? sweep1d_warp<T, M, R, B, kOrder, kEdge, k32>
             : sweep1d_warp<T, M, R, B, kOrder, kEdge, 0>;
}

template <typename T, int M, int R, int kEdge>
int launch(const T* in, T* out, unsigned batch, const Cols& cols, const Cols& sub, int depth,
           const Taps1& taps, int order, cudaStream_t stream) {
  constexpr int B = run_blocks(M);
  // the compile-time tap orders: every r <= M, and 1d5p's (1, 2) of r > M
  constexpr bool kFixed = R <= M || (M == 1 && R == 2);
  const int64_t wrows = (sub.n + kLanes - 1) / kLanes;   // warp rows of C' sub-columns
  const int64_t nruns = (wrows + B - 1) / B;
  const int64_t ctas = (nruns + kWarps - 1) / kWarps;
  if (ctas > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)ctas, batch);   // the batch's grids along y
  constexpr int kThreads = kLanes * kWarps;
  // vl = 32 has instances of its own at g = 1, every stride a constant
  // (float only)
  const bool v32 = !kIsBf16<T> && cols.vl == kLanes && sub.vl == 1;
  auto kernel = instance<T, M, R, B, kRuntime, kEdge>(v32);
  if constexpr (kFixed) {
    if (order == kCenterFirst) kernel = instance<T, M, R, B, kCenterFirst, kEdge>(v32);
    if (order == kAscending) kernel = instance<T, M, R, B, kAscending, kEdge>(v32);
  }
  kernel<<<grid, kThreads, 0, stream>>>(in, out, cols, nruns, depth, taps, sub);
  return (int)cudaGetLastError();
}

template <typename T, int M, int R>
int launch_edge(const T* in, T* out, unsigned batch, const Cols& cols, const Cols& sub,
                int depth, const Taps1& taps, int order, int edge, cudaStream_t stream) {
  switch (edge) {
    case kPeriodic:
      return launch<T, M, R, kPeriodic>(in, out, batch, cols, sub, depth, taps, order, stream);
    case kRing:
      return launch<T, M, R, kRing>(in, out, batch, cols, sub, depth, taps, order, stream);
    case kOpen:
      return launch<T, M, R, kOpen>(in, out, batch, cols, sub, depth, taps, order, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Every reach 1 .. kMaxR at every M (r > M: a halo of ceil(r / M) lanes)
template <typename T, int M>
int launch_m(const T* in, T* out, unsigned batch, const Cols& cols, const Cols& sub, int r,
             int depth, const Taps1& taps, int order, int edge, cudaStream_t stream) {
  switch (r) {
    case 1:
      return launch_edge<T, M, 1>(in, out, batch, cols, sub, depth, taps, order, edge, stream);
    case 2:
      return launch_edge<T, M, 2>(in, out, batch, cols, sub, depth, taps, order, edge, stream);
    case 3:
      return launch_edge<T, M, 3>(in, out, batch, cols, sub, depth, taps, order, edge, stream);
    case 4:
      return launch_edge<T, M, 4>(in, out, batch, cols, sub, depth, taps, order, edge, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Which Order the r-reach list of offsets is in.
int tap_order(const int32_t* offsets, int64_t ntaps, int64_t r) {
  if (ntaps != 2 * r + 1) return kRuntime;
  bool center = true, ascending = true;
  for (int t = 0; t < ntaps; ++t) {
    center = center && offsets[t] == (t == 0 ? 0 : (t + 1) / 2 * (t % 2 ? -1 : 1));
    ascending = ascending && offsets[t] == t - r;
  }
  return center ? kCenterFirst : ascending ? kAscending : kRuntime;
}

// `depth` steps of each of the `batch` (nb, m, vl) layout arrays `in`
// (contiguous, a grid a blockIdx.y, batch <= kMaxBatch) into `out` (another
// buffer) of T elements, for a stencil of reach r, with the grid's ends
// `edge` (0 periodic, 1 ring, 2 open), at any vl and m: on the instance M,
// the largest of 8, 4, 2, 1 dividing m, with C' = nb * vl * m / M
// sub-columns, r <= 4, depth * r <= 32 * M and, unless m = M, C' < 2^30.
// `blocks` must be the run length this build uses for M; `offsets` /
// `coeffs`: ntaps tap offsets and coefficients (rounded to T, as floats) in
// host memory.  Returns the CUDA error code.
template <typename T>
int sweep1d_warp_run(const void* in, void* out, int64_t batch, int64_t nb, int64_t m, int64_t vl,
                     int64_t r, int64_t blocks, int64_t depth, int64_t edge, int64_t ntaps,
                     const int32_t* offsets, const float* coeffs, void* stream) {
  if (m < 1 || batch < 1 || batch > kMaxBatch) return (int)cudaErrorInvalidValue;
  const int64_t mi = m % 8 == 0 ? 8 : m % 4 == 0 ? 4 : m % 2 == 0 ? 2 : 1;   // the instance M
  if (blocks != run_blocks((int)mi) || nb < 1 || vl < 1 || vl > (1 << 30) || r < 1 ||
      r > kMaxR || depth < 0 || depth * r > kLanes * mi || ntaps < 1 || ntaps > kMaxTaps ||
      (m != mi && nb * vl * (m / mi) >= kMaxCols))
    return (int)cudaErrorInvalidValue;
  Taps1 taps;
  taps.n = (int)ntaps;
  for (int t = 0; t < ntaps; ++t) {
    if (offsets[t] < -r || offsets[t] > r) return (int)cudaErrorInvalidValue;
    taps.o[t] = offsets[t];
    taps.c[t] = coeffs[t];
  }
  const T* src = static_cast<const T*>(in);
  T* dst = static_cast<T*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rr = (int)r, d = (int)depth, order = tap_order(offsets, ntaps, r);
  const int e = (int)edge;
  const Cols cols = make_cols(nb, vl);
  const Cols sub = make_cols(nb * vl, m / mi);   // C' sub-columns, g = m / M to a column
  switch (mi) {
    case 1: return launch_m<T, 1>(src, dst, (unsigned)batch, cols, sub, rr, d, taps, order, e, st);
    case 2: return launch_m<T, 2>(src, dst, (unsigned)batch, cols, sub, rr, d, taps, order, e, st);
    case 4: return launch_m<T, 4>(src, dst, (unsigned)batch, cols, sub, rr, d, taps, order, e, st);
    default: return launch_m<T, 8>(src, dst, (unsigned)batch, cols, sub, rr, d, taps, order, e, st);
  }
}

}  // namespace
