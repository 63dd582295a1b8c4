// Batched small-matrix transpose: the move into and out of the paper's local
// transpose layout (K2).
//
// Replaces: src/repro/kernels/stencil_kernels.py::_kernel_transpose, launched
// by block_transpose (N,) -> (nb, m, vl) and block_untranspose (nb, m, vl) ->
// (N,).  Here one library serves the 1-D and the n-D paths: the layout of
// (..., N) is the per-block transpose of the flattened array, so both are a
// (B, vl, m) <-> (B, m, vl) transpose with B = prod(lead) * nb.
//
// Bound on H100: bytes.  It reads each element once and writes it once and
// does no arithmetic, so its least time is 2 * numel * itemsize over the
// card's memory rate.
//
// One route, a register kernel (repro_transpose_reg), at every vl and m and
// for elements of 2, 4 or 8 bytes: a transpose moves bits.  Three forms:
//
// * vl >= 4 (transpose_reg, transpose_any).  One thread per column of a
//   block, holding the column's m elements in registers: lane j of block
//   row s is natural element j*m + s of its block, so thread g (column g of
//   the flattened (B*vl, m) view) owns the m consecutive natural elements
//   from g*m, and row s of its block holds them at ((g / vl) * m + s) * vl +
//   g % vl.  The natural side is read (or written) as whole 16-, 8- or
//   4-byte chunks where m * itemsize and the pointer allow; the layout side
//   moves one element per row, and for each row the threads of consecutive
//   columns touch consecutive addresses, so a warp moves whole 128-byte
//   lines at vl >= 32 (whole 32-byte sectors below).  No shared memory and
//   no barrier: a few instructions per element where the shared-memory
//   kernel this replaced spent about a hundred (two run-time divisions per
//   element and phase).  One column per thread and plain loads and stores:
//   2 or 4 columns per thread and the streaming cache hints were no faster
//   on the H100 (PERF.md, section 6).
//   Sub-columns: a column of m = G * M consecutive natural elements is G
//   sub-columns of M, one a thread (the caller names M: stencil_kernels.
//   transpose_sub takes the largest of 1..8 dividing m with G a power of
//   two, else the largest dividing m, so a warp's 32 threads cover 32 / G
//   whole columns and its layout-side rows fill whole sectors; m = 24 on
//   M = 8, G = 3 moved the layout side 13% slower than on M = 6, G = 4,
//   PERF.md section 6):
//   sub-column u = G * g + h (0 <= h < G) of column g holds natural
//   elements u * M .. u * M + M - 1 and its element s lies in block row
//   h * M + s.  So the natural side moves exactly as at m = M, and the
//   layout side's rows as at m = M too.  A thread holding all 16 or 32
//   elements of a column moved the same bytes but made each warp store of
//   the natural side span 16 or 32 lines instead of 8 (0.2445 against
//   0.1875 ms from the layout at 2^26 f32, vl=8, m=16; PERF.md, section 6).
//   Two forms, both with M a template parameter:
//   - vl a power of two, m in 1..8 (G = 1), 16 or 32 (M = 8, G = 2 or 4):
//     G a template parameter and vl a shift, so no division at all
//     (transpose_reg);
//   - every other m and vl >= 4 (vl off the powers of two, m such as 12,
//     24 or 25 that the reference's _fit_m gives): G and vl at run time,
//     one 32-bit division by each per thread (transpose_any).  Past 2^31
//     sub-columns its wide instance (kWide) splits the grid into
//     super-chunks of whole blocks along blockIdx.y, each fewer than 2^31
//     sub-columns, so the divisions stay 32-bit; below, the instances
//     without it run as they did.
// * vl in {1, 2, 3} (transpose_small).  A layout row is then only vl
//   elements, so a thread a column (or a sub-block of rows: a first form,
//   0.2346 / 0.2352 ms at 2^26 f32, vl=2, m=8, above the library's 0.2222,
//   and 0.8421 ms from the layout at m=7, where each thread stored single
//   elements 28 bytes apart; PERF.md section 6) spreads every warp access
//   over 32 places.  Instead a warp owns a span of whole blocks (about
//   kSmallK * 32 elements), and lane l moves output elements l, l + 32,
//   l + 64, ... of it: every store is 32 consecutive elements.  Output
//   element (block b, place i) comes from input element b * vl * m +
//   perm(i) of the same span (layout place s * vl + j <-> natural place
//   j * m + s), so a warp's load gathers within the blocks its store
//   covers: one or two lines, served from L1.  A lane steps (b, i) by 32
//   elements with a carry, so the only division is its first place.  It
//   replaced a shared-memory kernel (batched_transpose) that served vl < 4
//   at 1.37x the time of torch's transpose().contiguous() (PERF.md,
//   section 6).
//
// A batch whose grids lie in separate tensors (the requests of a served
// batch) moves into one layout tensor in one launch: the C entry takes a
// table of the natural side's pointers (Parts, a kernel argument read from
// the constant bank), and grid axis z is the part.  Part z reads from its
// own pointer and writes the z-th slice of the layout, z * numel elements
// in (64-bit), so no copy stacks the grids first.  Each part is whole
// blocks, so every form runs on a part as on one array.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRegThreads = 256;
constexpr int kSmallK = 16;   // transpose_small: elements a lane moves a round

// The m transpose_reg has instances for (stencil_kernels.TRANSPOSE_M).
constexpr bool reg_m(int64_t m) { return (m >= 1 && m <= 8) || m == 16 || m == 32; }

// Threads (sub-columns, or sub-blocks at vl < 4) a grid of transpose_any
// or a super-chunk along blockIdx.y holds: below it, 32-bit indices.
constexpr int64_t kMaxSub = int64_t(1) << 31;

// The parts one launch into the layout reads (stencil_kernels.
// TRANSPOSE_MAX_PARTS): the natural pointer of each and the elements of one
// (n = 0: one contiguous array, the kernel's own `in`).
constexpr int kMaxParts = 64;
struct Parts {
  const void* p[kMaxParts];
  int64_t numel;
  int64_t n;
};

// Into the layout from part blockIdx.z: its own natural pointer, and its
// slice of the layout.
template <bool kToLayout, typename T>
__device__ __forceinline__ void take_part(const T* __restrict__& in, T* __restrict__& out,
                                          const Parts& parts) {
  if constexpr (kToLayout) {
    if (parts.n) {
      in = static_cast<const T*>(parts.p[blockIdx.z]);
      out += (int64_t)blockIdx.z * parts.numel;
    }
  }
}

using u16 = unsigned short;
using u32 = unsigned int;
using u64 = unsigned long long;

template <int BYTES> struct Chunk;
template <> struct Chunk<2> { using type = u16; };
template <> struct Chunk<4> { using type = u32; };
template <> struct Chunk<8> { using type = uint2; };
template <> struct Chunk<16> { using type = uint4; };

// Elements per chunk of a run of M elements (a column's natural run, or at
// vl < 4 a sub-block's layout run of vl * M): the largest power of two
// dividing M whose bytes fit in 16 (the run is then a whole number of
// chunks, and each run starts at a multiple of the chunk's size).
template <typename T, int M>
constexpr int chunk_elems() {
  int v = 1;
  while (M % (2 * v) == 0 && 2 * v * (int)sizeof(T) <= 16) v *= 2;
  return v;
}

// The M consecutive elements at p, in kVec-element chunks.
template <int kVec, typename T, int M>
__device__ __forceinline__ void load_run(const T* p, T (&v)[M]) {
  using C = typename Chunk<kVec * sizeof(T)>::type;
  union U { C c; T e[kVec]; };
#pragma unroll
  for (int c = 0; c < M / kVec; ++c) {
    U u;
    u.c = reinterpret_cast<const C*>(p)[c];
#pragma unroll
    for (int e = 0; e < kVec; ++e) v[c * kVec + e] = u.e[e];
  }
}

template <int kVec, typename T, int M>
__device__ __forceinline__ void store_run(T* p, const T (&v)[M]) {
  using C = typename Chunk<kVec * sizeof(T)>::type;
  union U { C c; T e[kVec]; };
#pragma unroll
  for (int c = 0; c < M / kVec; ++c) {
    U u;
#pragma unroll
    for (int e = 0; e < kVec; ++e) u.e[e] = v[c * kVec + e];
    reinterpret_cast<C*>(p)[c] = u.c;
  }
}

// kToLayout: (B*vl, m) natural -> (B, m, vl) layout (m = G * M); else the
// inverse.  Sub-column u = blockIdx.x * kRegThreads + threadIdx.x of the
// ncols * G: M elements of column g = u / G.  The guard is tested
// twice, around the loads and around the stores, with an empty asm between
// them so that the compiler keeps the two apart: merged into one early exit
// ahead of the loads, the from-layout direction ran 13% slower on the H100
// (0.208 against 0.185 ms at 2^26 f32, vl=32, m=8; tools/kernel_ab.py).
template <typename T, int M, int G, int kVec, bool kToLayout>
__global__ void __launch_bounds__(kRegThreads)
transpose_reg(const T* __restrict__ in, T* __restrict__ out, int64_t nsub, int lv,
              const __grid_constant__ Parts parts) {
  static_assert(G == 1 || G == 2 || G == 4, "sub-columns a column");
  take_part<kToLayout>(in, out, parts);
  constexpr int kLg = G == 4 ? 2 : G == 2 ? 1 : 0;
  const int64_t u = (int64_t)blockIdx.x * kRegThreads + threadIdx.x;
  const int64_t g = u >> kLg, h = u & (G - 1);
  const int64_t row0 = ((((g >> lv) * G + h) * M) << lv) + (g & (((int64_t)1 << lv) - 1));
  T v[M];
  if (u < nsub) {
    if constexpr (kToLayout) {
      load_run<kVec>(in + u * M, v);
    } else {
#pragma unroll
      for (int s = 0; s < M; ++s) v[s] = in[row0 + ((int64_t)s << lv)];
    }
  }
  asm volatile("" ::: "memory");
  if (u < nsub) {
    if constexpr (kToLayout) {
#pragma unroll
      for (int s = 0; s < M; ++s) out[row0 + ((int64_t)s << lv)] = v[s];
    } else {
      store_run<kVec>(out + u * M, v);
    }
  }
}

// The same move with G and vl at run time (m = G * M, vl >= 4): sub-column
// u = blockIdx.x * kRegThreads + threadIdx.x of the nsub < 2^31, column
// g = u / G and its block g / vl, one 32-bit division each.  kWide: the
// grid's super-chunk blockIdx.y holds `chunk` whole blocks of the
// `nblocks` (chunk * vl * G < 2^31 sub-columns), its own nsub and its own
// offset into both arrays.
template <typename T, int M, int kVec, bool kToLayout, bool kWide>
__global__ void __launch_bounds__(kRegThreads)
transpose_any(const T* __restrict__ in, T* __restrict__ out, unsigned nsub, unsigned G,
              unsigned vl, int64_t nblocks, unsigned chunk, const __grid_constant__ Parts parts) {
  take_part<kToLayout>(in, out, parts);
  if constexpr (kWide) {
    const int64_t q0 = (int64_t)blockIdx.y * chunk;
    const int64_t left = nblocks - q0;
    nsub = (unsigned)((left < chunk ? left : chunk) * vl * G);
    const int64_t first = q0 * vl * G * M;   // elements before the super-chunk
    in += first;
    out += first;
  }
  const unsigned u = blockIdx.x * kRegThreads + threadIdx.x;
  const unsigned g = u / G, h = u - g * G;
  const unsigned q = g / vl, rem = g - q * vl;
  const int64_t row0 = ((int64_t)q * G + h) * M * vl + rem;
  T v[M];
  if (u < nsub) {
    if constexpr (kToLayout) {
      load_run<kVec>(in + (int64_t)u * M, v);
    } else {
#pragma unroll
      for (int s = 0; s < M; ++s) v[s] = in[row0 + (int64_t)s * vl];
    }
  }
  asm volatile("" ::: "memory");
  if (u < nsub) {
    if constexpr (kToLayout) {
#pragma unroll
      for (int s = 0; s < M; ++s) out[row0 + (int64_t)s * vl] = v[s];
    } else {
      store_run<kVec>(out + (int64_t)u * M, v);
    }
  }
}

// vl in {1, 2, 3} (VL), m elements a column, bs = VL * m a block: warp w
// owns blocks [w * per_warp, (w + 1) * per_warp) of the nblocks, and in
// rounds of kSmallK * 32 elements lane l moves output elements l + 32 k of
// the span, each from input element b * bs + perm(i) of its block b.  (db,
// di) = (32 / bs, 32 % bs): the step of (b, i) from one of a lane's
// elements to the next.
template <typename T, int VL, bool kToLayout>
__global__ void __launch_bounds__(kRegThreads)
transpose_small(const T* __restrict__ in, T* __restrict__ out, int64_t nblocks, unsigned m,
                unsigned per_warp, unsigned db, unsigned di, const __grid_constant__ Parts parts) {
  take_part<kToLayout>(in, out, parts);
  const unsigned bs = VL * m;
  const unsigned lane = threadIdx.x & 31;
  const int64_t q0 = (((int64_t)blockIdx.x * kRegThreads + threadIdx.x) >> 5) * per_warp;
  if (q0 >= nblocks) return;                         // the same on the whole warp
  const int64_t left = nblocks - q0;
  const unsigned span = (unsigned)(left < per_warp ? left : per_warp) * bs;
  in += q0 * bs;
  out += q0 * bs;
  unsigned b = lane / bs, i = lane - b * bs;         // this lane's first element
#pragma unroll 1
  for (unsigned o0 = 0; o0 < span; o0 += kSmallK * 32) {
    T v[kSmallK];
#pragma unroll
    for (int k = 0; k < kSmallK; ++k) {
      if (o0 + k * 32 + lane < span) {
        unsigned src;
        if constexpr (kToLayout) {        // layout place i = s * VL + j <- natural j * m + s
          const unsigned s = i / VL, j = i - s * VL;
          src = b * bs + j * m + s;
        } else {                          // natural place i = j * m + s <- layout s * VL + j
          const unsigned j = VL == 1 ? 0 : (i >= m) + (VL == 3 && i >= 2 * m);
          src = b * bs + (i - j * m) * VL + j;
        }
        v[k] = in[src];
      }
      b += db;
      i += di;
      if (i >= bs) {
        i -= bs;
        ++b;
      }
    }
#pragma unroll
    for (int k = 0; k < kSmallK; ++k) {
      const unsigned o = o0 + k * 32 + lane;
      if (o < span) out[o] = v[k];
    }
  }
}

// Whether the natural side (`natural`, or every part's pointer) is aligned
// to `bytes`.
bool natural_aligned(const void* natural, const Parts& parts, int64_t bytes) {
  if (parts.n == 0) return reinterpret_cast<uintptr_t>(natural) % bytes == 0;
  for (int64_t i = 0; i < parts.n; ++i)
    if (reinterpret_cast<uintptr_t>(parts.p[i]) % bytes) return false;
  return true;
}

// The grid axis z: one a part
unsigned part_z(const Parts& parts) { return parts.n ? (unsigned)parts.n : 1u; }

template <typename T, int M, bool kToLayout>
int launch_any(const void* in, void* out, int64_t ncols, int64_t g, int64_t vl,
               const Parts& parts, cudaStream_t stream) {
  constexpr int kVec = chunk_elems<T, M>();
  const int64_t nsub = ncols * g;
  const bool aligned = natural_aligned(kToLayout ? in : out, parts, kVec * sizeof(T));
  const T* src = static_cast<const T*>(in);
  T* dst = static_cast<T*>(out);
  const bool vec = kVec > 1 && aligned;
  if (nsub < kMaxSub) {
    const dim3 grid((unsigned)((nsub + kRegThreads - 1) / kRegThreads), 1, part_z(parts));
    const auto kernel = vec ? transpose_any<T, M, kVec, kToLayout, false>
                            : transpose_any<T, M, 1, kToLayout, false>;
    kernel<<<grid, kRegThreads, 0, stream>>>(src, dst, (unsigned)nsub, (unsigned)g,
                                             (unsigned)vl, 0, 0, parts);
    return (int)cudaGetLastError();
  }
  // super-chunks of whole blocks, each fewer than 2^31 sub-columns
  const int64_t per_block = vl * g, nblocks = ncols / vl;
  if (per_block >= kMaxSub) return (int)cudaErrorInvalidValue;
  const int64_t chunk = (kMaxSub - 1) / per_block;
  const int64_t ys = (nblocks + chunk - 1) / chunk;
  if (ys > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((chunk * per_block + kRegThreads - 1) / kRegThreads),
                  (unsigned)ys, part_z(parts));
  const auto kernel = vec ? transpose_any<T, M, kVec, kToLayout, true>
                          : transpose_any<T, M, 1, kToLayout, true>;
  kernel<<<grid, kRegThreads, 0, stream>>>(src, dst, 0, (unsigned)g, (unsigned)vl, nblocks,
                                           (unsigned)chunk, parts);
  return (int)cudaGetLastError();
}

template <typename T, int M>
int launch_any_dir(const void* in, void* out, int64_t ncols, int64_t g, int64_t vl,
                   bool to_layout, const Parts& parts, cudaStream_t s) {
  return to_layout ? launch_any<T, M, true>(in, out, ncols, g, vl, parts, s)
                   : launch_any<T, M, false>(in, out, ncols, g, vl, parts, s);
}

// m = G * M on the instance M the caller names (1..8 dividing m)
template <typename T>
int launch_any_m(const void* in, void* out, int64_t ncols, int64_t vl, int64_t m, int64_t mi,
                 bool to_layout, const Parts& parts, cudaStream_t s) {
  const int64_t g = m / mi;
  switch (mi) {
    case 1: return launch_any_dir<T, 1>(in, out, ncols, g, vl, to_layout, parts, s);
    case 2: return launch_any_dir<T, 2>(in, out, ncols, g, vl, to_layout, parts, s);
    case 3: return launch_any_dir<T, 3>(in, out, ncols, g, vl, to_layout, parts, s);
    case 4: return launch_any_dir<T, 4>(in, out, ncols, g, vl, to_layout, parts, s);
    case 5: return launch_any_dir<T, 5>(in, out, ncols, g, vl, to_layout, parts, s);
    case 6: return launch_any_dir<T, 6>(in, out, ncols, g, vl, to_layout, parts, s);
    case 7: return launch_any_dir<T, 7>(in, out, ncols, g, vl, to_layout, parts, s);
    default: return launch_any_dir<T, 8>(in, out, ncols, g, vl, to_layout, parts, s);
  }
}

template <typename T, int M, int G, bool kToLayout>
int launch_reg(const void* in, void* out, int64_t ncols, int lv, const Parts& parts,
               cudaStream_t stream) {
  constexpr int kVec = chunk_elems<T, M>();
  const int64_t nsub = ncols * G;
  const int64_t ctas = (nsub + kRegThreads - 1) / kRegThreads;
  if (ctas > 0x7fffffff) return (int)cudaErrorInvalidValue;
  // the natural side moves whole chunks only where its pointers are aligned
  const bool aligned = natural_aligned(kToLayout ? in : out, parts, kVec * sizeof(T));
  const T* src = static_cast<const T*>(in);
  T* dst = static_cast<T*>(out);
  const dim3 grid((unsigned)ctas, 1, part_z(parts));
  if (kVec > 1 && aligned) {
    transpose_reg<T, M, G, kVec, kToLayout><<<grid, kRegThreads, 0, stream>>>(
        src, dst, nsub, lv, parts);
  } else {
    transpose_reg<T, M, G, 1, kToLayout><<<grid, kRegThreads, 0, stream>>>(
        src, dst, nsub, lv, parts);
  }
  return (int)cudaGetLastError();
}

// M elements a thread, G sub-columns a column: m = G * M
template <typename T, int M, int G = 1>
int launch_dir(const void* in, void* out, int64_t ncols, int lv, bool to_layout,
               const Parts& parts, cudaStream_t s) {
  return to_layout ? launch_reg<T, M, G, true>(in, out, ncols, lv, parts, s)
                   : launch_reg<T, M, G, false>(in, out, ncols, lv, parts, s);
}

template <typename T>
int launch_m(const void* in, void* out, int64_t ncols, int lv, int m, bool to_layout,
             const Parts& parts, cudaStream_t s) {
  switch (m) {
    case 1: return launch_dir<T, 1>(in, out, ncols, lv, to_layout, parts, s);
    case 2: return launch_dir<T, 2>(in, out, ncols, lv, to_layout, parts, s);
    case 3: return launch_dir<T, 3>(in, out, ncols, lv, to_layout, parts, s);
    case 4: return launch_dir<T, 4>(in, out, ncols, lv, to_layout, parts, s);
    case 5: return launch_dir<T, 5>(in, out, ncols, lv, to_layout, parts, s);
    case 6: return launch_dir<T, 6>(in, out, ncols, lv, to_layout, parts, s);
    case 7: return launch_dir<T, 7>(in, out, ncols, lv, to_layout, parts, s);
    case 8: return launch_dir<T, 8>(in, out, ncols, lv, to_layout, parts, s);
    case 16: return launch_dir<T, 8, 2>(in, out, ncols, lv, to_layout, parts, s);
    case 32: return launch_dir<T, 8, 4>(in, out, ncols, lv, to_layout, parts, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// log2(vl) for a vl that transpose_reg takes (a power of two from 4 up,
// dividing ncols), else -1
int reg_shift(int64_t ncols, int64_t vl) {
  if (vl < 4 || vl > (int64_t(1) << 30) || (vl & (vl - 1)) || ncols < 0 || ncols % vl)
    return -1;
  int lv = 0;
  while ((int64_t)1 << lv < vl) ++lv;
  return lv;
}

// vl in {1, 2, 3}: transpose_small, about kSmallK * 32 elements a warp in
// whole blocks
template <typename T, int VL, bool kToLayout>
int launch_small(const void* in, void* out, int64_t nblocks, int64_t m, const Parts& parts,
                 cudaStream_t stream) {
  const int64_t bs = VL * m;
  if (bs >= (int64_t(1) << 31)) return (int)cudaErrorInvalidValue;
  const int64_t per_warp = bs >= kSmallK * 32 ? 1 : kSmallK * 32 / bs;
  const int64_t ctas = ((nblocks + per_warp - 1) / per_warp + kRegThreads / 32 - 1) /
                       (kRegThreads / 32);
  if (ctas > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)ctas, 1, part_z(parts));
  transpose_small<T, VL, kToLayout><<<grid, kRegThreads, 0, stream>>>(
      static_cast<const T*>(in), static_cast<T*>(out), nblocks, (unsigned)m,
      (unsigned)per_warp, (unsigned)(32 / bs), (unsigned)(32 % bs), parts);
  return (int)cudaGetLastError();
}

template <typename T, int VL>
int launch_small_dir(const void* in, void* out, int64_t nblocks, int64_t m, bool to_layout,
                     const Parts& parts, cudaStream_t s) {
  return to_layout ? launch_small<T, VL, true>(in, out, nblocks, m, parts, s)
                   : launch_small<T, VL, false>(in, out, nblocks, m, parts, s);
}

template <typename T>
int launch_small_vl(const void* in, void* out, int64_t ncols, int64_t vl, int64_t m,
                    bool to_layout, const Parts& parts, cudaStream_t s) {
  const int64_t nblocks = ncols / vl;
  switch (vl) {
    case 1: return launch_small_dir<T, 1>(in, out, nblocks, m, to_layout, parts, s);
    case 2: return launch_small_dir<T, 2>(in, out, nblocks, m, to_layout, parts, s);
    default: return launch_small_dir<T, 3>(in, out, nblocks, m, to_layout, parts, s);
  }
}

}  // namespace

// K2: (ncols * m) elements of `elem_size` bytes (2, 4 or 8), as (ncols / vl,
// vl, m) natural -> (ncols / vl, m, vl) layout (`to_layout` != 0) or the
// inverse, both contiguous, on `stream`, one thread a sub-column of `mi`
// elements (1..8 dividing m; unused at vl < 4).  vl must divide ncols;
// vl < 4 takes transpose_small, a power of two from 4
// with m in 1..8 (mi = m), 16 or 32 (mi = 8) transpose_reg, every other
// shape transpose_any (vl below 2^31).  `nparts` > 0 (into the layout
// only, up to kMaxParts): `in` is unused, the natural side is the `nparts`
// arrays at parts[0 .. nparts), each of ncols * m elements, and `out` their
// layouts one after another.  Returns the CUDA error code of the launch.
extern "C" int repro_transpose_reg(const void* in, void* out, int64_t ncols, int64_t vl,
                                   int64_t m, int64_t mi, int64_t elem_size, int64_t to_layout,
                                   const void* const* parts, int64_t nparts, void* stream) {
  if (vl < 1 || m < 1 || mi < 1 || mi > 8 || m % mi || ncols < 0 || ncols % vl ||
      (elem_size != 2 && elem_size != 4 && elem_size != 8) || nparts < 0 ||
      nparts > kMaxParts || (nparts && !to_layout))
    return (int)cudaErrorInvalidValue;
  if (ncols == 0) return 0;
  Parts table{};
  table.n = nparts;
  table.numel = ncols * m;
  for (int64_t i = 0; i < nparts; ++i) table.p[i] = parts[i];
  if (nparts) in = parts[0];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool dir = to_layout != 0;
  if (vl < 4) {
    switch (elem_size) {
      case 2: return launch_small_vl<u16>(in, out, ncols, vl, m, dir, table, s);
      case 4: return launch_small_vl<u32>(in, out, ncols, vl, m, dir, table, s);
      default: return launch_small_vl<u64>(in, out, ncols, vl, m, dir, table, s);
    }
  }
  const int lv = reg_shift(ncols, vl);
  if (lv >= 0 && reg_m(m) && mi == (m <= 8 ? m : 8)) {
    switch (elem_size) {
      case 2: return launch_m<u16>(in, out, ncols, lv, (int)m, dir, table, s);
      case 4: return launch_m<u32>(in, out, ncols, lv, (int)m, dir, table, s);
      default: return launch_m<u64>(in, out, ncols, lv, (int)m, dir, table, s);
    }
  }
  if (vl >= kMaxSub) return (int)cudaErrorInvalidValue;
  switch (elem_size) {
    case 2: return launch_any_m<u16>(in, out, ncols, vl, m, mi, dir, table, s);
    case 4: return launch_any_m<u32>(in, out, ncols, vl, m, mi, dir, table, s);
    default: return launch_any_m<u64>(in, out, ncols, vl, m, mi, dir, table, s);
  }
}
