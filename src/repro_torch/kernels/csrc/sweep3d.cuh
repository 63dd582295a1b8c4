// Depth-`depth` advance of a 3-D grid held in the paper's local transpose
// layout (n0, n1, nb, m, vl) on its minor axis, one launch per sweep chunk:
// K3's and K4b's streaming kernel for 3-D stencils.
//
// Replaces: src/repro/kernels/stencil_kernels.py::_kernel_nd as launched by
// stencil_nd_sweep_ttile (K3, fully periodic) and by stencil_nd_multistep /
// stencil_nd_sweep_halo (K4b, with `edge_mask`: a Dirichlet ring, or open
// ends of axis 0), for 3-D stencils of reach r <= 4 at any vl, any m and
// depth 1..max_depth(M, r) (stencil_kernels.sweep3d_route picks it before
// the launch, and stencil_kernels.sweep3d_launches cuts a deeper sweep into
// consecutive launches).  Only 3-D stencils of reach r > 4 or of more
// than kMaxTaps taps, which no registry stencil has, take the far-reach
// kernel of csrc/sweep_far.cu.
//
// Design: 2.5-D blocking, streamed along axis 0 (z) as csrc/sweep2d_warp.cu
// streams along y.
// - Columns.  A row's C = nb * vl columns each hold m consecutive natural
//   elements: column c's element s lies at ((c / vl) * m + s) * vl + c % vl
//   of the row.  Thread t of a CTA owns column cx = t % Cx of tile row
//   ty = t / Cx and keeps its m elements in registers: an x shift inside a
//   column is a register index, and a column's neighbours are the threads
//   beside it, whatever vl is.  vl only places a column in device memory:
//   its offset is worked out once per thread (a shift and a mask when vl is
//   a power of two, else one 32-bit division; C < 2^30), and its elements
//   lie vl floats apart.  vl = 32 has instances of its own (kVl), with
//   every stride a constant.
// - Sub-columns.  The instances hold M in {1, 2, 4, 8} elements a column.
//   Column c holds m consecutive natural points, so at m = g * M (M the
//   largest of 8, 4, 2, 1 dividing m) it is g sub-columns of M points, and
//   sub-column u = g * c + h (0 <= h < g) has its element s at
//   ((c / vl) * m + h * M + s) * vl + c % vl of its row.  The element
//   stride stays vl and x-neighbours stay the threads beside each other;
//   a row's C' = g * C sub-columns wrap mod C', which is the natural wrap.
//   So the any-vl instances run every m with only a thread's offset
//   changed (worked out once per thread: c = u / g a shift when g is a
//   power of two, else one 32-bit division), and below everything said of
//   columns holds for sub-columns of M elements.  vl = 32's own instances
//   take g = 1 only.
// - The tile.  A CTA stores kLanes consecutive columns of Ty - 2 Hy
//   consecutive rows of every plane of its z segment, and computes Ty x Cx
//   columns: Hx = ceil(depth r / M) columns and Hy = depth r rows of halo on
//   each side, rows wrapped mod n1 and columns mod C (so C below kLanes and
//   n1 below a tile work).  A halo's outer neighbours are missing (the
//   tile's edge threads read zeros or the next row's column), the error
//   this makes moves r elements or rows per step, and the halo holds it.
//   Only the inner threads store, and only rows below n1 and columns below
//   C: each (plane, row, column) once.
// - Along z a CTA walks a segment of planes [z0, z1), starting depth * r
//   planes early and ending depth * r planes late, plane indices wrapped
//   mod n0 in the periodic mode.  At step i the input plane z0 - depth*r + i
//   is in flight and level l (l = 1..depth, level 0 the input) makes plane
//   z0 - depth*r + i - l*(r + 1) from planes of level l - 1 made at steps
//   i - 1 - 2r .. i - 1.  The skew of r + 1 (not r) planes per level means
//   every level reads only what earlier steps made, so one barrier per step
//   serves every level; the levels run from depth down to 1.
// - Shared memory.  Every in-plane neighbour comes from shared memory.  A
//   plane of the tile is stored [e][t] (element e of column t), so a warp
//   reads 32 consecutive words, with r * Cx + ceil(r / M) words before and
//   after each element row that are never written (zeros) for the tile's
//   edge threads.
//   Input planes land by cp.async in a ring of Slots planes, Stages ahead
//   of use; level 1 reads all its taps from there.  Levels 1..depth-1 keep
//   their column of their last 2r + 1 planes in registers (the taps off the
//   plane) and publish planes for the in-plane taps.  The star reads the
//   in-plane neighbours of the centre plane only, r + 1 steps after it was
//   made, so a level publishes a plane from its registers r steps after
//   making it, into one of 2 slots; the box reads them on all 2r + 1 planes,
//   so a level publishes a plane as it makes it, into one of 2r + 2 slots.
//   No slot is read and written in one step.  Level depth stores.
// - Reach r > 1 (any-vl instances).  The star of r = 2 (stencils._star_taps'
//   order) is compiled in as at r = 1: the levels keep their column of 5
//   planes, and the star publishes its centre plane r steps after making
//   it, into one of 2 slots.  Any other tap list of r > 1 is read at run
//   time, which keeps the build short: every tap reads shared memory, the
//   ring's planes at level 1 and the published planes (2r + 2 slots) above
//   it, so no level keeps planes in registers, and a tap is a CTA-uniform
//   switch on its x offset with its plane and row offset as addresses.  The
//   tile's halo grows with r (Hx = ceil(depth r / M) columns, Hy = depth r
//   rows) and the ring holds 2r + 1 planes beside those in flight, so the
//   depths a tile fits fall with r (max_depth); deeper sweeps are
//   consecutive launches.
//   A bfloat16 element is copied as the 4-byte word that holds it
//   (elem.cuh), and once its copy has landed, the thread that issued it
//   (before the barrier that publishes the plane) moves the element into
//   the word's low half where it was the high one: the ring then holds an
//   element a word's low half, as the published planes do, and the
//   neighbours read it as it is.
// - Level l needs only rows [l r, Ty - l r) of the tile for the stored rows
//   (the halo shrinks by r rows per level); a warp whose rows all lie
//   outside skips the level (at depth 4, 8 of 64 warp-levels).
//
// The ends of axis 0 (axes 1 and 2 stay periodic).  Every thread of a CTA
// makes the same plane of a level at a step, so whether that plane lies at
// an end is one CTA-uniform test per level and step.  The periodic mode has
// instances of its own (kEnds false), free of those tests (in the 2-D kernel
// they cost K3 10% at depth 4 on an H100).  Ring and open share instances
// (kEnds true) and tell each other apart by the run-time `edge`.  Outside
// the periodic mode plane indices are not wrapped.
// - open: planes beyond either end hold 0 at every step.  An input plane
//   outside [0, n0) is written to its ring slot as zeros; a level plane
//   outside [0, n0) is made as zeros; at level depth it is never stored.
// - ring: the r first and last planes keep their value.  A level plane z
//   with z < r or z >= n0 - r takes the previous level's plane z (already in
//   registers or the ring) in place of the tap sum.  Input planes beyond the
//   ends are not loaded; what they hold reaches only planes beyond the ends:
//   bit for bit the plain version's where(ring, old, step).
//
// Taps are summed in the spec's order, one multiply and one add each, with
// the coefficients already rounded to the element type and each product and
// sum rounded to it (elem.cuh's mul and add); built with -fmad=false this
// is bit for bit the plain PyTorch version.  The two orders the registry's
// 3-D
// stencils use (the star (0,0,0), (-1,0,0), (1,0,0), (0,-1,0), ..., (0,0,1)
// of 3d7p; row-major -1..1 cubed of 3d27p), and the star of reach 2, are
// template parameters, so every offset is a constant; any other tap list
// goes through a CTA-uniform switch per tap (at r > 1, one on its x offset).
//
// Elements are float or bfloat16 (El) in device memory, registers and
// shared memory, one 4-byte word an element (a bfloat16 in its low half),
// so the tiles are the same for both.  bfloat16 has the
// any-vl instances only (vl = 32 included).  The entry points are sweep3d.cu
// (float) and sweep3d_bf16.cu, each its own translation unit, built in
// parallel.
//
// Bound on H100: a launch must read the grid once and write it once
// (2 * numel * sizeof(El) bytes, 0.32 ms at 512^3 in float) and do depth * (2 * taps - 1)
// flops per point.  What this design pays on top: the halo (a tile computes
// Ty * Cx columns to store (Ty - 2 Hy) * kLanes), read again from L2 by the
// neighbouring CTAs; 2 * depth * r warm-up planes per segment; and an SM's
// issue slots, where every tap is one multiply and one add and every
// in-plane neighbour one shared-memory load.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#include "cols.cuh"
#include "elem.cuh"

namespace {

constexpr int kVl32 = 32;                // the vl with instances of its own (r = 1)
constexpr int kMaxR = 4;                 // the reaches the instances take: 1..kMaxR
constexpr int kLanes = 16;               // columns a CTA stores per row
constexpr int kMaxThreads = 512;
// Input planes in flight beyond the landed one: 2, and 3 at depth 1, where a
// step is short (tools/sweep3d_tune.py on an H100 80GB HBM3 at 700 W: 3 took
// K3 3d7p 512^3 at depth 1 from 0.654 to 0.449 ms, and cost depth 2 6%).
constexpr int kStages = 2;
constexpr int kStagesD1 = 3;
constexpr int kMaxTaps = 64;
constexpr int kSmemMax = 232448;         // H100: dynamic shared memory a CTA may use

// the ends of axis 0, numbered as csrc/sweep_far.cu's Edge
enum Edge : int { kPeriodic = 0, kRing = 1, kOpen = 2 };

// The order of the taps, when it is one the kernel knows at compile time.
enum Order : int { kRuntime = 0, kStar = 1, kBox = 2 };

// Deepest instance by (M, r) (stencil_kernels.SWEEP3D_DEPTH holds the same;
// every depth up to it).  At r = 1 depth 4 at every M (a depth-8 instance
// at M = 1 or 2 lost to two depth-4 launches on an H100, PERF.md section
// 6).  At r > 1 the depths whose tile keeps at least 0.4 of what it
// computes for storing (Tile: (Ty - 2 Hy) * kLanes of Ty * Cx columns; at
// r = 1 depth 4 keeps 0.41 at M = 1); depth 1 at every (M, r).
__host__ __device__ constexpr int max_depth(int m, int r) {
  if (m != 1 && m != 2 && m != 4 && m != 8) return 0;
  if (r == 1) return 4;
  if (r == 2) return m == 4 ? 3 : 2;
  if (r == 3) return m == 4 ? 2 : 1;
  return r == 4 ? 1 : 0;
}

// The tile of an instance (stencil_kernels.sweep3d_tile holds the same).
template <int M, int D, int R, int kOrder>
struct Tile {
  static constexpr int NW = 2 * R + 1;                        // window planes per level
  static constexpr int Stages = D == 1 ? kStagesD1 : kStages;
  static constexpr int Slots = Stages + 2 * R + 2;            // the ring: in flight, landed, read
  static constexpr int Hx = (D * R + M - 1) / M;              // halo columns per side
  static constexpr int Hy = D * R;                            // halo rows per side
  static constexpr int Cx = kLanes + 2 * Hx;                  // tile columns
  static constexpr int E = kOrder == kStar ? 2 : 2 * R + 2;   // slots per published level
  static constexpr int Planes = Slots + (D - 1) * E;          // planes in shared memory
  // unwritten words per side: a tap reaches R rows and ceil(R / M) columns
  static constexpr int Pad = R * Cx + (R + M - 1) / M;
  static constexpr int TyThreads = kMaxThreads / Cx;
  static constexpr int TySmem = (kSmemMax / 4 / (Planes * M) - 2 * Pad) / Cx;
  static constexpr int Ty = TyThreads < TySmem ? TyThreads : TySmem;   // tile rows
  static constexpr int Threads = Ty * Cx;
  static constexpr int Stride = Threads + 2 * Pad;            // floats per element row
  static constexpr int Plane = M * Stride;                    // floats per plane
  static constexpr size_t Bytes = (size_t)Planes * Plane * sizeof(float);
  static_assert(Ty > 2 * Hy, "a tile must store rows");
  static_assert(Bytes <= (size_t)kSmemMax, "shared memory");
};

// The taps; the r > 1 path reads its coefficients as floats (`f`): a
// bfloat16 array indexed at run time put the whole struct in local memory
// in the 1-D kernel.
template <typename El>
struct Taps3 {
  int n;
  int oz[kMaxTaps], oy[kMaxTaps], ox[kMaxTaps];
  El c[kMaxTaps];
  float f[kMaxTaps];
};

// Offset of element 0 of sub-column u mod C' (u unwrapped) of row y in
// plane 0; element s is s * vl on.  kVl: vl when the instance fixes it (its
// C' is nb * kVl, g = 1), else 0, and then the 32-bit splits of cols.cuh:
// u into column c and sub-column h (`sub`: C' sub-columns, g to a column),
// c into block q and lane rem (`cols`: C columns, vl to a block).
template <int M, int kVl>
__device__ __forceinline__ int64_t col_offset(int64_t y, int64_t u, int64_t nb,
                                              const Cols& cols, const Cols& sub) {
  if constexpr (kVl > 0) {
    const int64_t g = wrap(u, nb * kVl);
    return (y * nb + g / kVl) * (kVl * M) + g % kVl;
  } else {
    unsigned h, q, rem;
    // g = 1 keeps the one-column form: with the general form alone the box
    // order's K3 at vl=8, m=8, d=4 ran 5% slower again (PERF.md, section 6)
    if (sub.vl == 1) {
      split_col((int)u, cols, q, rem);
      return (y * nb + q) * (M * cols.vl) + rem;
    }
    split_sub((int)u, cols, sub, q, h, rem);   // -Hx <= u < C' + kLanes + Hx
    const int run = M * cols.vl;   // elements of a block's rows of one sub-column
    return (y * nb + q) * (run * sub.vl) + (h * run + rem);
  }
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Tap t of a known order of reach R as (oz, oy, ox).  The star: centre,
// then axis 0 at -1, +1, -2, +2, ..., -R, +R, then axis 1, then axis 2
// (the order of stencils._star_taps); the box (R = 1): row-major.
template <int R, int kOrder>
__host__ __device__ constexpr int tap_off(int t, int axis) {
  return kOrder == kBox ? (axis == 0 ? t / 9 : axis == 1 ? t / 3 % 3 : t % 3) - 1
         : t == 0 || (t - 1) / (2 * R) != axis
             ? 0
             : ((t - 1) % (2 * R) / 2 + 1) * ((t - 1) % 2 ? 1 : -1);
}

template <int R, int kOrder>
__host__ __device__ constexpr int fixed_taps() {
  return kOrder == kBox ? 27 : 6 * R + 1;
}

// acc[s] (+)= (plane OZ of the source level)[row + OY][s + OX] * cf, each
// product and sum rounded to El.  The source's own column of the plane is w
// (registers) unless the source is the input ring; everything else is read
// from the shared-memory plane at p (this thread's element 0): element
// (s + OX) mod M of the column floor((s + OX) / M) away.
template <typename T, typename El, int M, int OY, int OX, bool kFromRing>
__device__ __forceinline__ void add_tap(El (&acc)[M], const El (&w)[M], const float* p,
                                        El cf, bool first) {
#pragma unroll
  for (int s = 0; s < M; ++s) {
    const int x = s + OX;
    El v;
    if (!kFromRing && OY == 0 && x >= 0 && x < M) {
      v = w[x < 0 ? 0 : x >= M ? M - 1 : x];
    } else {
      const int dx = x >= 0 ? x / M : -((M - 1 - x) / M);   // floor(x / M)
      v = ld_word<El>(p + (x - dx * M) * T::Stride + OY * T::Cx + dx);
    }
    const El term = mul(v, cf);
    acc[s] = first ? term : add(acc[s], term);
  }
}

// The tap (OZ, OY, OX) on plane k = OZ + R of the source: its own column
// wl[(ph + k) % NW] (the window slot of the plane made at step i - 1 - 2R +
// k; a constant index once ph is) and its shared-memory plane p[k].
template <typename T, typename El, int M, int R, int OZ, int OY, int OX, bool kFromRing>
__device__ __forceinline__ void tap(El (&acc)[M], const El (&wl)[2 * R + 1][M], int ph,
                                    const float* const (&p)[2 * R + 1], El cf, bool first) {
  add_tap<T, El, M, OY, OX, kFromRing>(acc, wl[(ph + OZ + R) % (2 * R + 1)], p[OZ + R], cf,
                                       first);
}

template <typename T, typename El, int M, int R, int kOrder, bool kFromRing, int I = 0>
__device__ __forceinline__ void fixed(El (&acc)[M], const El (&wl)[2 * R + 1][M], int ph,
                                      const float* const (&p)[2 * R + 1],
                                      const Taps3<El>& taps) {
  if constexpr (I < fixed_taps<R, kOrder>()) {
    tap<T, El, M, R, tap_off<R, kOrder>(I, 0), tap_off<R, kOrder>(I, 1),
        tap_off<R, kOrder>(I, 2), kFromRing>(acc, wl, ph, p, taps.c[I], I == 0);
    fixed<T, El, M, R, kOrder, kFromRing, I + 1>(acc, wl, ph, p, taps);
  }
}

// Taps read at run time (r = 1): a CTA-uniform switch per tap.
template <typename T, typename El, int M, bool kFromRing, int C = 0>
__device__ __forceinline__ void runtime_case(int c, El (&acc)[M], const El (&wl)[3][M], int ph,
                                             const float* const (&p)[3], El cf, bool first) {
  if constexpr (C < 27) {
    if (c == C) {
      tap<T, El, M, 1, C / 9 - 1, C / 3 % 3 - 1, C % 3 - 1, kFromRing>(acc, wl, ph, p, cf,
                                                                      first);
    } else {
      runtime_case<T, El, M, kFromRing, C + 1>(c, acc, wl, ph, p, cf, first);
    }
  }
}

// Reach r > 1: acc[s] (+)= (plane at p)[s + OX] * cf for a tap of x offset
// ox, p already at the tap's plane and row; a CTA-uniform switch on ox, so
// that each element's place (element (s + OX) mod M of the column
// floor((s + OX) / M) away) is a constant.
template <typename T, typename El, int M, int R, int OX = -R>
__device__ __forceinline__ void far_x(int ox, El (&acc)[M], const float* p, El cf, bool first) {
  if constexpr (OX <= R) {
    if (ox != OX) {
      far_x<T, El, M, R, OX + 1>(ox, acc, p, cf, first);
      return;
    }
#pragma unroll
    for (int s = 0; s < M; ++s) {
      const int x = s + OX;
      const int dc = x >= 0 ? x / M : -((M - 1 - x) / M);   // floor(x / M)
      const El term = mul(ld_word<El>(p + (x - dc * M) * T::Stride + dc), cf);
      acc[s] = first ? term : add(acc[s], term);
    }
  }
}

// Reach r > 1: every tap from shared memory, in the spec's order.  Plane k =
// oz + r of the source was made at step k0 + k (k0 = i - 1 - 2r) and lies in
// slot (k0 + k) mod kMod of `src` (the ring: kMod = Slots; a published
// level: kMod = E).
template <typename T, typename El, int M, int R, int kMod>
__device__ __forceinline__ void far_taps(El (&acc)[M], const float* src, int k0,
                                         const Taps3<El>& taps) {
#pragma unroll 1
  for (int t = 0; t < taps.n; ++t) {   // the entry point checks every offset is in -r..r
    const int slot = (k0 + taps.oz[t] + R + kMod) % kMod;
    const float* p = src + slot * T::Plane + taps.oy[t] * T::Cx;
    far_x<T, El, M, R>(taps.ox[t], acc, p, from_f<El>(taps.f[t]), t == 0);
  }
}

// The taps of a compile-time order (any R), or read at run time at R = 1;
// wl: the source level's window, p: its planes' shared memory.
template <typename T, typename El, int M, int R, int kOrder, bool kFromRing>
__device__ __forceinline__ void apply_taps(El (&acc)[M], const El (&wl)[2 * R + 1][M], int ph,
                                           const float* const (&p)[2 * R + 1],
                                           const Taps3<El>& taps) {
  if constexpr (kOrder != kRuntime) {
    fixed<T, El, M, R, kOrder, kFromRing>(acc, wl, ph, p, taps);
  } else {
#pragma unroll 1
    for (int t = 0; t < taps.n; ++t) {   // the entry point checks every offset is in -1..1
      const int c = (taps.oz[t] + 1) * 9 + (taps.oy[t] + 1) * 3 + taps.ox[t] + 1;
      runtime_case<T, El, M, kFromRing>(c, acc, wl, ph, p, taps.c[t], t == 0);
    }
  }
}

// The input plane of step p into ring slot p % Slots: each thread copies
// its column's m elements, vl elements apart (bfloat16 ones as their words:
// bit p % Slots of `copied` says the slot was copied, of `halves` which
// half of element 0's word is the element).  One commit group per step,
// empty past the planes the segment needs and, outside the periodic mode,
// for planes beyond the ends (open mode writes those as zeros).
template <typename T, typename El, int M, bool kEnds>
__device__ __forceinline__ void issue(const El* __restrict__ in, float* mine, unsigned& copied,
                                      unsigned& halves, int p, int nload, int64_t base,
                                      int64_t n0, int64_t plane, int64_t col, int vl, int edge) {
  const int64_t z = base + p;
  const int slot = p % T::Slots;
  float* dst = mine + slot * T::Plane;
  if constexpr (kIsBf16<El>) copied &= ~(1u << slot);
  if (p < nload) {
    if (!kEnds || (z >= 0 && z < n0)) {
      const El* src = in + wrap(z, n0) * plane + col;
#pragma unroll
      for (int s = 0; s < M; ++s) cp_async4(dst + s * T::Stride, word_of(src + s * vl));
      if constexpr (kIsBf16<El>) {
        copied |= 1u << slot;
        halves = (halves & ~(1u << slot)) | (word_parity(src) << slot);
      }
    } else if (edge == kOpen) {
#pragma unroll
      for (int s = 0; s < M; ++s) dst[s * T::Stride] = 0.0f;
    }
  }
  cp_async_commit();
}

template <typename El, int M, int D, int R, int kOrder, bool kEnds, int kVl>
__global__ void __launch_bounds__(Tile<M, D, R, kOrder>::Threads, 1)
sweep3d(const El* __restrict__ in, El* __restrict__ out, int64_t n0, int64_t n1, int64_t nb,
        int64_t ntx, int64_t nty, int64_t seg, int edge, Taps3<El> taps, Cols cols, Cols sub) {
  using T = Tile<M, D, R, kOrder>;
  constexpr int kNW = T::NW;
  constexpr bool kStarPub = kOrder == kStar;   // publish r steps late, 2 slots
  // levels keep their column's planes in registers (not at r > 1 with the
  // taps read at run time)
  constexpr bool kRegs = R == 1 || kOrder != kRuntime;
  extern __shared__ float smem[];
  const int t = threadIdx.x;
  const int ty = t / T::Cx, cx = t - ty * T::Cx;
  // the first and last tile row of this thread's warp
  const int wrow0 = (t & ~31) / T::Cx;
  const int wrow1 = ((t | 31) < T::Threads ? (t | 31) : T::Threads - 1) / T::Cx;
  const int vl = kVl > 0 ? kVl : cols.vl;
  const int gs = kVl > 0 ? 1 : sub.vl;               // sub-columns a column
  const int64_t ncol = nb * vl * gs;                 // C'
  const int64_t xt = blockIdx.x % ntx;
  const int64_t yt = blockIdx.x / ntx % nty;
  const int64_t z0 = blockIdx.x / ntx / nty * seg;
  const int rows = (int)(n0 - z0 < seg ? n0 - z0 : seg);
  const int steps = rows + D * kNW;
  const int nload = rows + 2 * D * R;
  const int64_t base = z0 - D * R;                   // the input plane of step 0
  // level planes outside [lo, hi) are the ends' (ring: kept; open: zeros)
  const int64_t lo = edge == kRing ? R : 0;
  const int64_t hi = edge == kRing ? n0 - R : n0;
  const int64_t gu = xt * kLanes - T::Hx + cx;                     // column, unwrapped
  const int64_t yu = yt * (T::Ty - 2 * T::Hy) - T::Hy + ty;        // row, unwrapped
  const int64_t y = wrap(yu, n1);
  const bool stores = cx >= T::Hx && cx < T::Cx - T::Hx && gu < ncol && ty >= T::Hy &&
                      ty < T::Ty - T::Hy && yu < n1;
  const int64_t plane = n1 * nb * (vl * M * gs);     // vl * m < 2^31
  // grid blockIdx.y of the batch: n0 planes a grid, offset in 64 bits
  in += (int64_t)blockIdx.y * n0 * plane;
  out += (int64_t)blockIdx.y * n0 * plane;
  const int64_t col = col_offset<M, kVl>(y, gu, nb, cols, sub);   // element 0 in plane 0
  float* const mine = smem + T::Pad + t;             // element 0 of this column, ring slot 0
  float* const levels = mine + T::Slots * T::Plane;  // the published levels' slots
  unsigned copied = 0, halves = 0;                   // bfloat16: issue's bits a ring slot

  for (int e = t; e < T::Planes * T::Plane; e += T::Threads) smem[e] = 0.0f;
  __syncthreads();
#pragma unroll
  for (int p = 0; p < T::Stages; ++p)
    issue<T, El, M, kEnds>(in, mine, copied, halves, p, nload, base, n0, plane, col, vl, edge);

  // win[l - 1][q]: this column of the level-l plane made at a step = q mod kNW
  // (levels 1..D-1; win[D - 1] is never used; r > 1 keeps none)
  El win[kRegs ? D : 1][kNW][M];
#pragma unroll
  for (int l = 0; l < (kRegs ? D : 1); ++l)
#pragma unroll
    for (int q = 0; q < kNW; ++q)
#pragma unroll
      for (int s = 0; s < M; ++s) win[l][q][s] = zero<El>();

#pragma unroll 1
  for (int i0 = 0; i0 < steps; i0 += kNW) {
#pragma unroll
    for (int ph = 0; ph < kNW; ++ph) {   // unrolled: every window index a constant
      const int i = i0 + ph;
      if (i >= steps) continue;          // the same on every thread
      // plane k = 0..2r of a source level (oz = k - r) was made at step i - 1 - 2r + k
      const float* ring[kNW];
      int pub[kNW];
#pragma unroll
      for (int k = 0; k < kNW; ++k) {
        ring[k] = mine + ((i - 1 - 2 * R + k + T::Slots) % T::Slots) * T::Plane;
        pub[k] = kStarPub ? ((i + 1) % T::E) * T::Plane   // the centre, published at i - 1
                          : ((i - 1 - 2 * R + k + T::E) % T::E) * T::Plane;
      }
      const int wslot = (i % T::E) * T::Plane;        // the slot a level publishes into
#pragma unroll
      for (int l = D; l >= 1; --l) {
        // a stored row needs rows [l r, Ty - l r) of level l: a warp with
        // none of them skips the level (its rows of level l stay stale and
        // reach only rows no stored row needs)
        if (wrow1 < l * R || wrow0 >= T::Ty - l * R) continue;
        El acc[M];
        const float* lv = levels + (l >= 2 ? l - 2 : 0) * T::E * T::Plane;   // level l - 1's slots
        // the source level's window, and its own column of the centre plane
        // (ring mode's kept value)
        const El(&wl)[kNW][M] = win[kRegs && l >= 2 ? l - 2 : 0];
        const El(&w1)[M] = wl[(ph + R) % kNW];
        if constexpr (kRegs) {
          if (l == 1) {
            apply_taps<T, El, M, R, kOrder, true>(acc, wl, ph, ring, taps);
          } else {
            const float* lp[kNW];
#pragma unroll
            for (int k = 0; k < kNW; ++k) lp[k] = lv + pub[k];
            apply_taps<T, El, M, R, kOrder, false>(acc, wl, ph, lp, taps);
          }
        } else if (l == 1) {
          far_taps<T, El, M, R, T::Slots>(acc, mine, i - 1 - 2 * R, taps);
        } else {
          far_taps<T, El, M, R, T::E>(acc, lv, i - 1 - 2 * R, taps);
        }
        if (kEnds) {
          const int64_t z = base + i - l * (R + 1);    // the plane this level makes
          if (z < lo || z >= hi) {
#pragma unroll
            for (int s = 0; s < M; ++s)
              acc[s] = edge != kRing ? zero<El>()
                       : l == 1      ? ld_word<El>(ring[R] + s * T::Stride)
                       : kRegs       ? w1[s]
                                     : ld_word<El>(lv + pub[R] + s * T::Stride);
          }
        }
        if (l == D) {
          if (stores && i >= D * kNW) {
            El* dst = out + (z0 + i - D * kNW) * plane + col;
#pragma unroll
            for (int s = 0; s < M; ++s) dst[s * vl] = acc[s];
          }
        } else {
          float* slot = levels + (l - 1) * T::E * T::Plane + wslot;
          // the star publishes the plane made R steps ago (its centre plane's
          // in-plane neighbours are read at step i + 1)
          const El(&pubv)[M] = kStarPub ? win[l - 1][(ph + R + 1) % kNW] : acc;
#pragma unroll
          for (int s = 0; s < M; ++s) st_word<El>(slot + s * T::Stride, pubv[s]);
          if constexpr (kRegs) {
#pragma unroll
            for (int s = 0; s < M; ++s) win[l - 1][ph][s] = acc[s];
          }
        }
      }
      issue<T, El, M, kEnds>(in, mine, copied, halves, i + T::Stages, nload, base, n0, plane,
                             col, vl, edge);
      cp_async_wait<T::Stages>();   // this thread's copy of plane i has landed
      if constexpr (kIsBf16<El>) {
        // each element to its word's low half (element s lies s * vl
        // elements past element 0); plane i's slot is read from the next
        // step on
        const int slot = i % T::Slots;
        if ((copied >> slot) & 1u) {
          const unsigned par = (halves >> slot) & 1u;
          float* w = mine + slot * T::Plane;
#pragma unroll
          for (int s = 0; s < M; ++s)
            if (par ^ (s & vl & 1))
              st_word<El>(w + s * T::Stride, word_elem<El>(w[s * T::Stride], 1));
        }
      }
      __syncthreads();              // every thread's, and this step's published planes
    }
  }
  cp_async_wait<0>();
}

template <typename El, int M, int D, int R, int kOrder>
int go(const El* in, El* out, unsigned batch, int64_t n0, int64_t n1, int64_t nb,
       const Cols& cols, const Cols& sub, int64_t seg, int edge, const Taps3<El>& taps,
       cudaStream_t stream) {
  using T = Tile<M, D, R, kOrder>;
  // float's vl = 32 has instances of its own at g = 1 and r = 1, every
  // stride a constant
  constexpr int k32 = kIsBf16<El> || R > 1 ? 0 : kVl32;
  const bool v32 = k32 > 0 && cols.vl == kVl32 && sub.vl == 1;
  const auto kernel = edge == kPeriodic
                          ? (v32 ? sweep3d<El, M, D, R, kOrder, false, k32>
                                 : sweep3d<El, M, D, R, kOrder, false, 0>)
                          : (v32 ? sweep3d<El, M, D, R, kOrder, true, k32>
                                 : sweep3d<El, M, D, R, kOrder, true, 0>);
  if (T::Bytes > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::Bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const int64_t ntx = (sub.n + kLanes - 1) / kLanes;
  const int64_t nty = (n1 + T::Ty - 2 * T::Hy - 1) / (T::Ty - 2 * T::Hy);
  const int64_t ctas = ntx * nty * ((n0 + seg - 1) / seg);
  if (ctas > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)ctas, batch);   // the batch's grids along y
  kernel<<<grid, T::Threads, T::Bytes, stream>>>(in, out, n0, n1, nb, ntx, nty, seg, edge, taps,
                                                  cols, sub);
  return (int)cudaGetLastError();
}

template <typename El, int M, int R, int D>
int launch_depth(int depth, int order, const El* in, El* out, unsigned batch, int64_t n0,
                 int64_t n1, int64_t nb, const Cols& cols, const Cols& sub, int64_t seg,
                 int edge, const Taps3<El>& taps, cudaStream_t stream) {
  if constexpr (D >= 1) {
    if (depth != D)
      return launch_depth<El, M, R, D - 1>(depth, order, in, out, batch, n0, n1, nb, cols, sub,
                                           seg, edge, taps, stream);
    if constexpr (R > 2) {   // run-time taps only
      return go<El, M, D, R, kRuntime>(in, out, batch, n0, n1, nb, cols, sub, seg, edge, taps,
                                       stream);
    } else if constexpr (R == 2) {   // the star's compile-time order, or run-time taps
      return order == kStar
                 ? go<El, M, D, R, kStar>(in, out, batch, n0, n1, nb, cols, sub, seg, edge, taps,
                                          stream)
                 : go<El, M, D, R, kRuntime>(in, out, batch, n0, n1, nb, cols, sub, seg, edge, taps,
                                             stream);
    } else {
      switch (order) {
        case kStar:
          return go<El, M, D, R, kStar>(in, out, batch, n0, n1, nb, cols, sub, seg, edge, taps,
                                        stream);
        case kBox:
          return go<El, M, D, R, kBox>(in, out, batch, n0, n1, nb, cols, sub, seg, edge, taps,
                                       stream);
        default:
          return go<El, M, D, R, kRuntime>(in, out, batch, n0, n1, nb, cols, sub, seg, edge, taps,
                                           stream);
      }
    }
  } else {
    return (int)cudaErrorInvalidValue;
  }
}

// The instances of M at reach 1 .. kMaxR, each from its deepest depth down.
template <typename El, int M>
int launch_m(int r, int depth, int order, const El* in, El* out, unsigned batch, int64_t n0,
             int64_t n1, int64_t nb, const Cols& cols, const Cols& sub, int64_t seg, int edge,
             const Taps3<El>& taps, cudaStream_t stream) {
  switch (r) {
    case 1: return launch_depth<El, M, 1, max_depth(M, 1)>(depth, order, in, out, batch, n0, n1, nb, cols, sub, seg, edge, taps, stream);
    case 2: return launch_depth<El, M, 2, max_depth(M, 2)>(depth, order, in, out, batch, n0, n1, nb, cols, sub, seg, edge, taps, stream);
    case 3: return launch_depth<El, M, 3, max_depth(M, 3)>(depth, order, in, out, batch, n0, n1, nb, cols, sub, seg, edge, taps, stream);
    case 4: return launch_depth<El, M, 4, max_depth(M, 4)>(depth, order, in, out, batch, n0, n1, nb, cols, sub, seg, edge, taps, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Which Order the (oz, oy, ox) offsets are in: the star or box at r = 1,
// the star at r = 2; any other list is read at run time.
template <int R>
int order_of(const int32_t* offsets, int64_t ntaps) {
  bool star = ntaps == fixed_taps<R, kStar>(), box = R == 1 && ntaps == fixed_taps<R, kBox>();
  for (int t = 0; t < ntaps; ++t) {
    for (int a = 0; a < 3; ++a) {
      star = star && offsets[3 * t + a] == tap_off<R, kStar>(t, a);
      box = box && offsets[3 * t + a] == tap_off<R, kBox>(t, a);
    }
  }
  return star ? kStar : box ? kBox : kRuntime;
}

int tap_order(const int32_t* offsets, int64_t ntaps, int64_t r) {
  return r == 1 ? order_of<1>(offsets, ntaps) : r == 2 ? order_of<2>(offsets, ntaps) : kRuntime;
}

template <int M, int R, int D>
int64_t tile_of(int64_t depth, int64_t order, int64_t what) {
  if constexpr (D >= 1) {
    if (depth != D) return tile_of<M, R, D - 1>(depth, order, what);
    const auto pick = [what](auto tile) -> int64_t {
      using T = decltype(tile);
      return what == 0 ? T::Ty : what == 1 ? T::Cx : what == 2 ? T::Threads : (int64_t)T::Bytes;
    };
    if constexpr (R > 2) {
      return order == kRuntime ? pick(Tile<M, D, R, kRuntime>{}) : -1;
    } else if constexpr (R == 2) {
      return order == kRuntime ? pick(Tile<M, D, R, kRuntime>{})
             : order == kStar  ? pick(Tile<M, D, R, kStar>{}) : -1;
    } else {
      return order == kStar ? pick(Tile<M, D, R, kStar>{})
             : order == kBox ? pick(Tile<M, D, R, kBox>{}) : pick(Tile<M, D, R, kRuntime>{});
    }
  } else {
    return -1;
  }
}

template <int M>
int64_t tile_of_m(int64_t r, int64_t depth, int64_t order, int64_t what) {
  switch (r) {
    case 1: return tile_of<M, 1, max_depth(M, 1)>(depth, order, what);
    case 2: return tile_of<M, 2, max_depth(M, 2)>(depth, order, what);
    case 3: return tile_of<M, 3, max_depth(M, 3)>(depth, order, what);
    case 4: return tile_of<M, 4, max_depth(M, 4)>(depth, order, what);
    default: return -1;
  }
}

// `depth` steps of each of the `batch` (n0, n1, nb, m, vl) layout arrays
// `in` (contiguous, a grid a blockIdx.y, batch <= kMaxBatch) into `out`
// (another buffer) of El elements, at any vl and m (on the instance M, the
// largest of 8, 4, 2, 1 dividing m, with C' = nb * vl * m / M sub-columns
// a row; C' < 2^30 unless El is float, r = 1, vl = 32 and m = M), for a
// 3-D stencil of reach r <= 4 and depth <= max_depth(M, r), with the ends
// of axis 0 `edge` (0 periodic, 1 ring, 2 open; axes 1 and 2 are
// periodic), in segments of `seg` planes per CTA.  `offsets` holds ntaps
// (oz, oy, ox) triples and `coeffs` ntaps coefficients (rounded to El, as
// floats), both in host memory.  Returns the CUDA error code.
template <typename El>
int sweep3d_run(const void* in, void* out, int64_t batch, int64_t n0, int64_t n1, int64_t nb,
                int64_t m, int64_t vl, int64_t r, int64_t depth, int64_t edge, int64_t seg,
                int64_t ntaps, const int32_t* offsets, const float* coeffs, void* stream) {
  if (m < 1 || batch < 1 || batch > kMaxBatch || r < 1 || r > kMaxR || depth < 1 || edge < kPeriodic || edge > kOpen || n0 < 1 ||
      n1 < 1 || nb < 1 || vl < 1 || seg < 1 || seg > (1 << 24) || ntaps < 1 ||
      ntaps > kMaxTaps)
    return (int)cudaErrorInvalidValue;
  const int64_t mi = m % 8 == 0 ? 8 : m % 4 == 0 ? 4 : m % 2 == 0 ? 2 : 1;   // the instance M
  const int64_t g = m / mi;                                  // sub-columns a column
  if (depth > max_depth((int)mi, (int)r)) return (int)cudaErrorInvalidValue;
  if ((kIsBf16<El> || vl != kVl32 || g != 1 || r != 1) && nb * vl * g >= kMaxCols)
    return (int)cudaErrorInvalidValue;
  if (m * vl >= (int64_t(1) << 31)) return (int)cudaErrorInvalidValue;
  Taps3<El> taps;
  taps.n = (int)ntaps;
  for (int t = 0; t < ntaps; ++t) {
    taps.oz[t] = offsets[3 * t];
    taps.oy[t] = offsets[3 * t + 1];
    taps.ox[t] = offsets[3 * t + 2];
    taps.c[t] = coeff_of<El>(coeffs[t]);
    taps.f[t] = coeffs[t];
    for (int a = 0; a < 3; ++a)
      if (offsets[3 * t + a] < -r || offsets[3 * t + a] > r) return (int)cudaErrorInvalidValue;
  }
  const El* src = static_cast<const El*>(in);
  El* dst = static_cast<El*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int d = (int)depth, e = (int)edge, rr = (int)r, order = tap_order(offsets, ntaps, r);
  const Cols cols = make_cols(nb, vl);
  const Cols sub = make_cols(nb * vl, g);   // C' sub-columns, g to a column
  switch (mi) {
    case 1: return launch_m<El, 1>(rr, d, order, src, dst, (unsigned)batch, n0, n1, nb, cols, sub, seg, e, taps, st);
    case 2: return launch_m<El, 2>(rr, d, order, src, dst, (unsigned)batch, n0, n1, nb, cols, sub, seg, e, taps, st);
    case 4: return launch_m<El, 4>(rr, d, order, src, dst, (unsigned)batch, n0, n1, nb, cols, sub, seg, e, taps, st);
    default: return launch_m<El, 8>(rr, d, order, src, dst, (unsigned)batch, n0, n1, nb, cols, sub, seg, e, taps, st);
  }
}

}  // namespace
