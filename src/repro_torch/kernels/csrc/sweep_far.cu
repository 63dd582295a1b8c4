// Depth-`depth` advance, in one launch, of a grid held in the paper's local
// transpose layout (..., nb, m, vl) by a stencil of any reach and any tap
// list: the far-reach sweep kernel of K1, K3 and K4.
//
// Replaces: src/repro/kernels/stencil_kernels.py::_kernel_1d (launched by
// stencil1d_sweep_ttile, K1, and by stencil1d_multistep /
// stencil1d_sweep_halo, K4a) and ::_kernel_nd (launched by
// stencil_nd_sweep_ttile, K3, and by stencil_nd_multistep /
// stencil_nd_sweep_halo, K4b), for the stencils the register kernels
// (csrc/sweep1d_warp.cu, sweep2d_warp.cu, sweep3d.cu) do not take: reach
// r > 4, or more taps than they hold (16 at 1-D, 64 at 2-D and 3-D).
// stencil_kernels.sweep{1,2,3}d_route picks it before the launch, and
// stencil_kernels.far_launches cuts a sweep deeper than one launch takes
// into consecutive launches.  No registry stencil reaches it.
//
// Design.  One kernel serves every rank: a grid is (nz, ny, nx) in natural
// coordinates, nz the stencil's axis 0 in 2-D and 3-D (the stream axis), ny
// the 3-D mid axis, nx the minor axis, held in the layout (1 where the
// stencil has no such axis).
// - Columns in natural order.  The minor axis is C = nb * vl columns of m
//   consecutive natural points; column c's element s lies at ((c / vl) * m
//   + s) * vl + c % vl of its row.  A CTA keeps a plane of its tile as
//   [row][s][column] in shared memory: element s of every column of a row
//   is one run of words, so an x shift by o is row s + o of the same
//   column, or of the column beside it where s + o leaves [0, m) (the
//   paper's vector set and its Assembled rows), and a warp's lanes on
//   consecutive columns read consecutive words whatever the tap.  The
//   column pitch is picked on the host (far_pitch): of those that fit two
//   CTAs an SM, the one that puts a warp's rows of the 3-D tile on the
//   fewest words in a bank.  Where an element lives in device memory is
//   worked out once per CTA (a table of each loaded point's offset): no
//   division is left in the step loop.
// - Streaming along axis 0 (2-D, 3-D), one step a launch.  A CTA owns ty
//   rows by tc columns of every plane of a segment of axis 0 and walks it,
//   starting r planes early.  At step i it copies input plane zs + i + 1
//   (cp.async for float, in flight through the step) into a ring of 2r + 3
//   planes and makes plane zs + i - (r + 1) from the 2r + 1 planes about
//   it, copied at earlier steps: one barrier a step.  A plane covers the
//   output tile and r rows and ceil(r / m) columns around it, so the
//   loaded-to-stored ratio is (ty + 2r)(tc + 2) / (ty tc) at m >= r.  A
//   deeper sweep is consecutive launches (stencil_kernels.far_launches): on
//   an H100 two or more steps a launch, each with a ring of its own planes
//   skewed r + 1 behind the one below, ran 4x (2-D) to 20x (3-D) slower
//   than the chain of one-step launches (PERF.md section 6).
// - 1-D: no stream axis (nz = 1), a CTA's tile is tc columns; up to 8 steps
//   a launch, levels of one step each that alternate between two planes.
// - Taps at run time.  A table holds, for every row s of a column and every
//   tap, the tap's offset inside a plane and the offset of its plane in the
//   ring, and a list the coefficients, so a tap is two shared-memory loads
//   shared by a lane's points and one load a point.  A lane's 8 points lie
//   32 columns apart in 1-D and 2-D (a load each at an immediate offset
//   from one address a tap), its 4 over the level's rows and columns in
//   3-D.  Any tap count: the taps come from device memory and the tables'
//   shared memory is sized at run time.
// - Ends.  Axis 0 is periodic (K1, K3), a Dirichlet ring (the r cells
//   nearest each end keep their value at every step) or open (cells beyond
//   the ends hold 0 at every step); the other axes wrap.  In 2-D and 3-D a
//   plane beyond the ends is zeros, a ring plane is copied from the level
//   below; in 1-D the CTAs whose columns reach the ring or the ends check
//   each point.
//
// Arithmetic.  Taps are summed in the spec's order, one multiply and one
// add each in the element type, each rounded to it (elem.cuh's mul / add;
// built with -fmad=false): bit for bit the plain PyTorch version.
// Elements are float or bfloat16 in device and in shared memory
// (repro_sweep_far_f32 / _bf16); bfloat16 planes are copied with plain
// loads, cp.async moving 4 bytes at least.
//
// Bound on H100: bytes for the reaches and depths the engines use.  A
// launch must read the grid once and write it once; its arithmetic is
// depth * (2 taps - 1) operations a point.  What it costs beyond that is
// a shared-memory load a tap and a point, and the halo's recompute in the
// planes (none along axis 0).  On an H100 at reach 5 it runs 8-17x that
// bound (PERF.md section 6): its tap loop issues 4.6-4.9 instructions a
// point and tap, and runs about 3x its issue time.
#include <cuda_runtime.h>
#include <stdint.h>

#include "elem.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kP = 8;    // points a lane computes a work unit (one row s), 1-D and 2-D
constexpr int kP3 = 4;   // the same in 3-D
// blockIdx.z's limit, gridDim.z on the card: the batch's grids times their
// axis-0 segments (stencil_kernels.MAX_BATCH holds the same)
constexpr int64_t kMaxZ = 65535;

enum Edge : int { kPeriodic = 0, kRing = 1, kOpen = 2 };

struct Geom {
  int64_t nz, nx, ncols;   // axis-0 (stream) extent, minor extent, its columns
  int ny;                  // mid extent (3-D), else 1
  int vl, m;
  int rz, ry, r, hc;       // reach along z, y, x; columns a level's halo grows (ceil(r / m))
  int depth, levels;       // levels = max(depth, 1) (1 along a stream axis); depth 0 copies
  int ty, tc;              // output tile: rows, columns
  int py, nc, ncp;         // a plane: rows, columns, column pitch
  int slots;               // the input ring's planes: 2 rz + 3 (2 rz + 1 read, one landing,
                           // one in flight); 1-D: one
  int seg;                 // axis-0 positions a CTA stores
  int ntaps;
  int xends;               // 1: the ends are those of the minor axis (1-D)
};

// the rows and columns of a level-l plane: the output tile and (depth - l)
// steps' reach around it
__host__ __device__ inline int ext_of(const Geom& g, int l) {
  return g.depth - l > 0 ? g.depth - l : 0;
}

// 3-D: a word a point of the output tile (its index in a plane)
__host__ __device__ inline int64_t qtab_words(const Geom& g) {
  return g.py == 1 ? 0 : (int64_t)g.ty * g.tc;
}

struct Layout {
  int64_t tab, coef, lg, og, lq, qt, ring, bytes;
  int plane, planes;
};

// Dynamic shared memory of a CTA: the tap table (an int2 a row s and tap,
// and a word a tap's coefficient),
// the loaded plane's device offsets (int64) and shared-memory indices, the
// output tile's device offsets, the 3-D tile's point indices, then the
// planes (element size esize) and, in 1-D and 2-D, a slack of 64 elements
// that the lanes past a level's last point read and drop (a row s + o of
// the plane, at most 32 columns past its end).
__host__ __device__ inline Layout layout(const Geom& g, int esize) {
  Layout L;
  int64_t o = 0;
  L.tab = o;
  o += (int64_t)8 * g.m * g.ntaps;
  L.coef = o;
  o += (int64_t)4 * g.ntaps;
  o = (o + 7) & ~(int64_t)7;
  L.lg = o;
  o += (int64_t)8 * g.py * g.nc;
  L.og = o;
  o += (int64_t)8 * g.ty * g.tc;
  L.lq = o;
  o += (int64_t)4 * g.py * g.nc;
  L.qt = o;
  o += 4 * qtab_words(g);
  o = (o + 15) & ~(int64_t)15;
  L.ring = o;
  L.plane = g.py * g.m * g.ncp;
  L.planes = g.rz > 0 ? g.slots : (g.levels < 2 ? g.levels : 2);
  o += (int64_t)esize * (L.plane * L.planes + (g.py == 1 ? 64 : 0));
  L.bytes = o;
  return L;
}

__device__ __forceinline__ int64_t wrap(int64_t i, int64_t n) {
  if (i >= 0 && i < n) return i;
  const int64_t r = i % n;
  return r < 0 ? r + n : r;
}

// offset of element 0 of natural column c inside its row (the wrapper
// checks that a row has fewer than 2^31 columns)
__device__ __forceinline__ int64_t col_offset(int c, int vl, int m) {
  const int b = c / vl;
  return (int64_t)b * m * vl + (c - b * vl);
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

template <typename T>
__device__ __forceinline__ T from_bits(int b) {
  if constexpr (kIsBf16<T>) {
    return __ushort_as_bfloat16((unsigned short)b);
  } else {
    return __int_as_float(b);
  }
}

enum Mode : int { kCompute = 0, kCopy = 1, kZero = 2 };

// What a level's work units share within one step: the plane (1-D) or ring
// (2-D, 3-D) it reads and the offsets of the planes at p - rz and p in it,
// where the level writes (1-D: the other plane, or at the last level the
// device-memory plane with the output tile's offsets), and how (Mode), and
// whether the CTA checks the 1-D ends point by point.
template <typename T>
struct Level {
  const T* prev;
  T* dst;
  T* gout;
  const int64_t* og;
  int q0p, czo, ringsz, mode;
  bool xedge;
};

// One work unit: the points k < KP of row s at shared-memory offsets
// idx(k) of the plane, their level-q indices q + 32 k (below nq: the
// others are skipped, or read and dropped), the taps in the spec's order.
// col0 is the plane's first natural column (1-D ends).
template <typename T, int KP, int kEdge, typename Idx>
__device__ __forceinline__ void level_unit(const Geom& g, const Level<T>& lv,
                                           const int2* __restrict__ tp,
                                           const int* __restrict__ coef, int s, int64_t col0,
                                           int q, int nq, Idx idx) {
  const int lane0 = q & 31;
  const int kn = (nq - (q - lane0) + 31) / 32;   // slices with a point below nq (warp-uniform)
  T acc[KP];
  if (lv.mode == kCompute) {
    {
      const int2 e = tp[0];
      int zo = lv.q0p + e.y;
      if (zo >= lv.ringsz) zo -= lv.ringsz;
      const T* src = lv.prev + zo + e.x;
      const T c = from_bits<T>(coef[0]);
#pragma unroll
      for (int k = 0; k < KP; ++k)
        if (k < kn) acc[k] = mul(src[idx(k)], c);
    }
#pragma unroll 4
    for (int t = 1; t < g.ntaps; ++t) {
      const int2 e = tp[t];
      int zo = lv.q0p + e.y;
      if (zo >= lv.ringsz) zo -= lv.ringsz;
      const T* src = lv.prev + zo + e.x;
      const T c = from_bits<T>(coef[t]);
#pragma unroll
      for (int k = 0; k < KP; ++k)
        if (k < kn) acc[k] = add(acc[k], mul(src[idx(k)], c));
    }
    if (kEdge != kPeriodic && lv.xedge) {   // 1-D: beyond the ends 0, the ring keeps its value
#pragma unroll
      for (int k = 0; k < KP; ++k) {
        if (k >= kn) continue;
        const int64_t x = (col0 + idx(k) - s * g.ncp) * g.m + s;
        if (x < 0 || x >= g.nx) {
          acc[k] = zero<T>();
        } else if (kEdge == kRing && (x < g.r || x >= g.nx - g.r)) {
          acc[k] = lv.prev[lv.czo + idx(k)];
        }
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < KP; ++k)
      if (k < kn) acc[k] = lv.mode == kCopy ? lv.prev[lv.czo + idx(k)] : zero<T>();
  }
#pragma unroll
  for (int k = 0; k < KP; ++k) {
    if (k >= kn || q + 32 * k >= nq) continue;
    if (lv.gout) {
      const int64_t o = lv.og[q + 32 * k];
      if (o >= 0) lv.gout[o + (int64_t)s * g.vl] = acc[k];
    } else {
      lv.dst[idx(k)] = acc[k];
    }
  }
}

template <typename T, int kEdge>
__global__ void __launch_bounds__(kThreads)
sweep_far(const T* __restrict__ in, T* __restrict__ out, Geom g, const int4* __restrict__ taps) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout(g, (int)sizeof(T));
  int2* tab = reinterpret_cast<int2*>(smem + L.tab);
  int* coef = reinterpret_cast<int*>(smem + L.coef);
  int64_t* lg = reinterpret_cast<int64_t*>(smem + L.lg);
  int64_t* og = reinterpret_cast<int64_t*>(smem + L.og);
  int* lq = reinterpret_cast<int*>(smem + L.lq);
  int* qt = reinterpret_cast<int*>(smem + L.qt);
  T* ring = reinterpret_cast<T*>(smem + L.ring);
  const int plane = L.plane;
  // 2-D, 3-D: the input ring; 1-D: the input plane, and the levels take it
  // and the one after it in turn
  const int ringsz = g.slots * plane;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t c0 = (int64_t)blockIdx.x * g.tc;
  const int y0 = blockIdx.y * g.ty;
  // blockIdx.z = b * nseg + the axis-0 segment: grid b of the batch, its
  // offset in 64 bits
  const int64_t nseg = (g.nz + g.seg - 1) / g.seg;
  const int64_t b = blockIdx.z / nseg;
  const int64_t z0 = ((int64_t)blockIdx.z - b * nseg) * g.seg;
  const int hy = g.depth * g.ry, hcol = g.depth * g.hc;
  const int64_t zstride = (int64_t)g.ny * g.nx;
  in += b * g.nz * zstride;
  out += b * g.nz * zstride;

  // the tap table: row s, tap t -> (offset in a plane, offset of the
  // tap's plane from the ring slot of position p - rz); the coefficients
  for (int e = tid; e < g.m * g.ntaps; e += kThreads) {
    const int s = e / g.ntaps, t = e - s * g.ntaps;
    const int4 tp = taps[t];            // (oz, oy, ox, coefficient bits)
    const int ss = s + tp.z;
    const int dc = ss >= 0 ? ss / g.m : -((g.m - 1 - ss) / g.m);   // floor
    tab[e] = make_int2((tp.y * g.m + ss - dc * g.m - s) * g.ncp + dc, (tp.x + g.rz) * plane);
    if (s == 0) coef[t] = tp.w;
  }
  // the loaded plane: rows y0 - hy .., columns c0 - hcol .., wrapped; in
  // 1-D with ends, columns beyond them are -1 (zeros)
  for (int q = tid; q < g.py * g.nc; q += kThreads) {
    const int ly = q / g.nc, lc = q - ly * g.nc;
    lq[q] = ly * g.m * g.ncp + lc;
    const int64_t gc = c0 - hcol + lc;
    if (kEdge != kPeriodic && g.xends && (gc < 0 || gc >= g.ncols)) {
      lg[q] = -1;
    } else {
      lg[q] = wrap(y0 - hy + ly, g.ny) * g.nx + col_offset((int)wrap(gc, g.ncols), g.vl, g.m);
    }
  }
  for (int q = tid; q < g.ty * g.tc; q += kThreads) {
    const int y = q / g.tc, c = q - y * g.tc;
    og[q] = (y0 + y < g.ny && c0 + c < g.ncols)
                ? (int64_t)(y0 + y) * g.nx + col_offset((int)(c0 + c), g.vl, g.m)
                : -1;
  }
  if (g.py > 1) {   // 3-D: the output tile's points, row-major
    for (int q = tid; q < g.ty * g.tc; q += kThreads) {
      const int y = q / g.tc;
      qt[q] = (hy + y) * g.m * g.ncp + hcol + q - y * g.tc;
    }
  }
  // 1-D: whether this CTA's columns reach the ring or the ends
  const bool xedge = kEdge != kPeriodic && g.xends &&
                     ((c0 - hcol) * g.m < g.r || (c0 + g.tc + hcol) * g.m > g.nx - g.r);
  __syncthreads();

  const int64_t zs = z0 - (int64_t)g.depth * g.rz;
  const int64_t load_end = z0 + g.seg - 1 + (int64_t)g.depth * g.rz;
  const int64_t iters = g.seg + (int64_t)g.levels * (g.rz + 1) + (int64_t)g.depth * g.rz;
  const int q0n = g.py * g.nc;
  const int chunks0 = (q0n + 31) / 32;
  // a warp's copy units u = warp, warp + kWarps, ..: row s = u / chunks0,
  // chunk u % chunks0, stepped by (ds0, dch0) without a division
  const int s00 = warp / chunks0, ch00 = warp - s00 * chunks0;
  const int ds0 = kWarps / chunks0, dch0 = kWarps - ds0 * chunks0;
  // input plane z into ring slot `slot`: zeros beyond the ends of axis 0
  // (2-D, 3-D) or columns beyond those of the minor axis (1-D, lg < 0)
  auto load = [&](int64_t z, int slot) {
    T* dst = ring + slot * plane;
    const bool inside = kEdge == kPeriodic || g.xends || (z >= 0 && z < g.nz);
    const T* src = in + wrap(z, g.nz) * zstride;
    for (int s = s00, ch = ch00; s < g.m; s += ds0, ch += dch0) {
      if (ch >= chunks0) {
        ch -= chunks0;
        if (++s >= g.m) break;
      }
      const int q = ch * 32 + lane;
      if (q >= q0n) continue;
      T* d = dst + lq[q] + s * g.ncp;
      const int64_t o = inside ? lg[q] : -1;
      if (o < 0) {
        *d = zero<T>();
      } else if constexpr (sizeof(T) == 4) {
        cp_async4(d, src + o + (int64_t)s * g.vl);
      } else {
        *d = src[o + (int64_t)s * g.vl];
      }
    }
  };
  // the ring's plane at position p sits in slot (p - zs) mod slots; a0 is
  // (zi - zs) mod slots, kept step by step
  int a0 = 0;
  // one cp.async group a step (empty when nothing is copied), so that
  // waiting for all but the newest finishes the plane copied a step before
  load(zs, a0);
  if constexpr (sizeof(T) == 4) cp_async_commit();
  for (int64_t i = 0; i < iters; ++i) {
    const int64_t zi = zs + i;
    // plane zi + 1 in flight through this step (plane zi landed at the last
    // barrier but is read from the next step on)
    if (zi + 1 <= load_end) load(zi + 1, a0 + 1 == g.slots ? 0 : a0 + 1);
    if constexpr (sizeof(T) == 4) cp_async_commit();
    // levels 1..levels (2-D, 3-D: one), each from planes of the level below
    // made at earlier steps; p past the grid's end: a short last segment
    for (int l = 1; l <= g.levels; ++l) {
      const int64_t p = zi - (int64_t)l * (g.rz + 1);
      if (p < z0 || p >= z0 + g.seg || p >= g.nz) continue;
      const int ext = ext_of(g, l);
      const bool last = l == g.levels;
      int mode = g.depth == 0 ? kCopy : kCompute;
      if (kEdge != kPeriodic && !g.xends && mode == kCompute) {
        if (p < 0 || p >= g.nz) {
          mode = kZero;
        } else if (kEdge == kRing && (p < g.rz || p >= g.nz - g.rz)) {
          mode = kCopy;
        }
      }
      // the plane below (1-D: the levels' two in turn), the slot of its
      // plane p - rz (2-D, 3-D: zi - (2 rz + 1)) and of plane p, and where
      // this level writes (1-D: the other plane, unless it stores)
      const T* prev = ring + (g.rz > 0 ? 0 : ((l - 1) & 1) * plane);
      int q0 = a0 - (2 * g.rz + 1) % g.slots;
      if (q0 < 0) q0 += g.slots;
      const int q0p = q0 * plane;
      int czo = q0p + g.rz * plane;
      if (czo >= ringsz) czo -= ringsz;
      T* dst = last ? nullptr : ring + (l & 1) * plane;
      T* gout = last ? out + p * zstride : nullptr;
      const int rows = g.ty + 2 * ext * g.ry, cols = g.tc + 2 * ext * g.hc;
      const int nq = rows * cols;
      const Level<T> lv{prev, dst, gout, og, q0p, czo, ringsz, mode, xedge};
      if (g.py == 1) {   // 1-D, 2-D: a lane's points 32 columns apart
        const int clo = hcol - ext * g.hc;
        const int chunks = (nq + 32 * kP - 1) / (32 * kP);
        for (int u = warp; u < g.m * chunks; u += kWarps) {
          const int s = u / chunks;
          const int q0 = (u - s * chunks) * (32 * kP);
          const int base = clo + q0 + lane + s * g.ncp;
          level_unit<T, kP, kEdge>(g, lv, tab + s * g.ntaps, coef, s, c0 - hcol, q0 + lane, nq,
                                   [base](int k) { return base + 32 * k; });
        }
      } else {           // 3-D: a lane's points over the level's rows and columns
        const int chunks = (nq + 32 * kP3 - 1) / (32 * kP3);
        for (int u = warp; u < g.m * chunks; u += kWarps) {
          const int s = u / chunks;
          const int q0 = (u - s * chunks) * (32 * kP3) + lane;
          int idx[kP3];
#pragma unroll
          for (int k = 0; k < kP3; ++k) {
            const int q = q0 + 32 * k;
            idx[k] = qt[q < nq ? q : 0] + s * g.ncp;
          }
          level_unit<T, kP3, kEdge>(g, lv, tab + s * g.ntaps, coef, s, c0 - hcol, q0, nq,
                                    [&idx](int k) { return idx[k]; });
        }
      }
    }
    if constexpr (sizeof(T) == 4) cp_async_wait_prior();   // all but plane zi + 1
    __syncthreads();
    a0 = a0 + 1 == g.slots ? 0 : a0 + 1;
  }
}

template <typename T>
int launch(const T* in, T* out, int64_t batch, const Geom& g, const int4* taps, int edge,
           cudaStream_t stream) {
  const Layout L = layout(g, (int)sizeof(T));
  auto kernel = edge == kRing ? sweep_far<T, kRing>
                : edge == kOpen ? sweep_far<T, kOpen> : sweep_far<T, kPeriodic>;
  if (L.bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)L.bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const int64_t zs = batch * ((g.nz + g.seg - 1) / g.seg);   // the batch's segments
  if (zs > kMaxZ) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((g.ncols + g.tc - 1) / g.tc), (unsigned)((g.ny + g.ty - 1) / g.ty),
                  (unsigned)zs);
  kernel<<<grid, kThreads, (size_t)L.bytes, stream>>>(in, out, g, taps);
  return (int)cudaGetLastError();
}

Geom make_geom(int64_t nz, int64_t ny, int64_t nx, int64_t vl, int64_t m, int64_t rz, int64_t ry,
               int64_t r, int64_t depth, int64_t ty, int64_t tc, int64_t ncp, int64_t seg,
               int64_t ntaps, int64_t xends) {
  Geom g;
  g.nz = nz;
  g.ny = (int)ny;
  g.nx = nx;
  g.vl = (int)vl;
  g.m = (int)m;
  g.ncols = m > 0 ? nx / m : 0;
  g.rz = (int)rz;
  g.ry = (int)ry;
  g.r = (int)r;
  g.hc = m > 0 ? (int)((r + m - 1) / m) : 0;
  g.depth = (int)depth;
  g.levels = depth > 1 ? (int)depth : 1;
  g.ty = (int)ty;
  g.tc = (int)tc;
  g.py = (int)(ty + 2 * depth * ry);
  g.nc = (int)(tc + 2 * depth * g.hc);
  g.ncp = (int)ncp;
  g.slots = rz > 0 ? (int)(2 * rz + 3) : 1;
  g.seg = (int)seg;
  g.ntaps = (int)ntaps;
  g.xends = (int)xends;
  return g;
}

// Advance each of the `batch` grids of `in` by `depth` steps (at most 1
// where rz > 0) into `out` (both contiguous (batch, nz, ny, nx) in the
// layout, of T elements, distinct buffers; batch times the axis-0 segments
// at most kMaxZ) on `stream`: rz / ry / r the
// reach along axis 0 (the stream axis, 0 in 1-D), the 3-D mid axis (else 0)
// and the minor axis; a CTA stores ty rows by tc columns of seg axis-0
// positions, its planes' columns ncp words apart; `edge` the ends of the
// stencil's axis 0 (0 periodic, 1 ring, 2 open; xends 1: the minor axis in
// 1-D, else axis 0); `taps` ntaps int4s (oz, oy, ox, the coefficient's
// bits as T) in device memory.  Returns the CUDA error code.
template <typename T>
int sweep(const void* in, void* out, int64_t batch, int64_t nz, int64_t ny, int64_t nx,
          int64_t vl, int64_t m, int64_t rz, int64_t ry, int64_t r, int64_t depth, int64_t ty,
          int64_t tc, int64_t ncp, int64_t seg, int64_t edge, int64_t xends, int64_t ntaps,
          const void* taps, void* stream) {
  if (batch < 1 || ntaps < 1 || m < 1 || vl < 1 || nx % m || depth < 0 || ty < 1 || tc < 1 ||
      seg < 1 || edge < 0 || edge > 2 || (rz == 0 && (nz != 1 || seg != 1)) ||
      (rz > 0 && depth > 1))
    return (int)cudaErrorInvalidValue;
  const Geom g = make_geom(nz, ny, nx, vl, m, rz, ry, r, depth, ty, tc, ncp, seg, ntaps, xends);
  if (g.ncp < g.nc) return (int)cudaErrorInvalidValue;
  return launch<T>(static_cast<const T*>(in), static_cast<T*>(out), batch, g,
                   static_cast<const int4*>(taps), (int)edge, static_cast<cudaStream_t>(stream));
}

}  // namespace

// The dynamic shared memory (bytes) of one CTA of the geometry below, for
// elements of esize bytes (the wrapper's far_smem, held against it on the
// card).
extern "C" int64_t repro_sweep_far_smem(int64_t m, int64_t rz, int64_t ry, int64_t r,
                                        int64_t depth, int64_t ty, int64_t tc, int64_t ncp,
                                        int64_t ntaps, int64_t esize) {
  const Geom g = make_geom(rz > 0 ? 2 : 1, 1, m, 1, m, rz, ry, r, depth, ty, tc, ncp, 1, ntaps, 0);
  return layout(g, (int)esize).bytes;
}

// sweep (above) on float elements.
extern "C" int repro_sweep_far_f32(const void* in, void* out, int64_t batch, int64_t nz,
                                   int64_t ny, int64_t nx, int64_t vl, int64_t m, int64_t rz,
                                   int64_t ry, int64_t r, int64_t depth, int64_t ty, int64_t tc,
                                   int64_t ncp, int64_t seg, int64_t edge, int64_t xends,
                                   int64_t ntaps, const void* taps, void* stream) {
  return sweep<float>(in, out, batch, nz, ny, nx, vl, m, rz, ry, r, depth, ty, tc, ncp, seg, edge,
                      xends, ntaps, taps, stream);
}

// sweep (above) on bfloat16 elements.
extern "C" int repro_sweep_far_bf16(const void* in, void* out, int64_t batch, int64_t nz,
                                    int64_t ny, int64_t nx, int64_t vl, int64_t m, int64_t rz,
                                    int64_t ry, int64_t r, int64_t depth, int64_t ty, int64_t tc,
                                    int64_t ncp, int64_t seg, int64_t edge, int64_t xends,
                                    int64_t ntaps, const void* taps, void* stream) {
  return sweep<__nv_bfloat16>(in, out, batch, nz, ny, nx, vl, m, rz, ry, r, depth, ty, tc, ncp,
                              seg, edge, xends, ntaps, taps, stream);
}
