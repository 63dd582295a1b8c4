// Mamba2 SSD chunk scan (state-space duality) on the tensor cores: y =
// y_intra + y_inter of one SSD layer, and the final state.
//
// Replaces: src/repro/kernels/ssd_kernel.py::_kernel, launched by
// ssd_chunk_scan.  For every (batch, head), over chunks of tokens:
//   cs      = inclusive cumsum over the chunk of dt * a
//   att     = (C B^T) * exp(cs[q] - cs[t]) * dt[t] for t <= q, else 0
//   y       = att x + (C h^T) * exp(cs[q])
//   h       = h * exp(cs[last]) + B^T (x * dt * exp(cs[last] - cs))
// with h in float32, zero before the first token.  y and the final h do not
// depend on where the chunks are cut, so the kernels walk the caller's
// nc * Q tokens in chunks of their own, kChunk = 128 tokens: token t sits at
// (t / Q, t % Q) of the caller's chunks, and rows past the end are zeros
// with dt = 0, which add nothing.
//
// Bound on H100: operations on the tensor cores.  Per (batch, head, chunk
// of Q) the function needs Q(Q+1)(N+P) + 4QNP operations (the causal
// products only over the lower triangle) against Q(2P + 2N + 1) values
// moved: 9.4 GFLOP and 47 MB (bfloat16 x) at 2048 tokens of mamba2-2.7b
// (H=80, P=64, N=128), 0.019 ms at 495 TFLOP/s (TF32, dense) and 0.014 ms
// at 3.35 TB/s.
//
// Design: two kernels, launched in order on one stream, no atomics.
//   ssd_state  grid (head, N tile of 32 x P tile of 64, batch).  The CTA
//              walks the internal chunks in order, the paper's vrl carry:
//              its P x 32 tile of h stays in the accumulators of 4 compute
//              warps (a warp: 16 rows of P x the 32 columns; the hi*hi
//              products and the small terms of the split in two
//              accumulators, two dependency chains) from chunk to chunk.
//              Before a chunk a warp stores its tile to the scratch h_in
//              (B, K, H, P, Npad), the state entering that chunk.  Four more
//              warps only load: the next chunk's x, its slice of B and dt
//              by cp.async into the other buffer, while the compute warps
//              scan dt (a warp scan, 4 rows a lane) into w = dt *
//              exp(cs[last] - cs), scale their accumulators by exp(cs[last])
//              and add (x * w)^T B_slice with mma.sync.m16n8k8 TF32; one
//              barrier a chunk.  The tiles are XOR-swizzled, not padded, so
//              that three bfloat16 CTAs (two float32) share an SM: 320 CTAs
//              at mamba2-2.7b's shape run in one wave.
//   ssd_out    grid (head, internal chunk, batch x P tile): every chunk
//              at once.  Warp w owns 16 rows of the chunk.  C, B and h_in
//              stream through a ring of slabs of 16 columns of N (3 slabs
//              in bfloat16, which fits two CTAs on an SM, 4 in float32),
//              and per slab each warp adds to its rows of C B^T, over the
//              column tiles t <= its rows only (the causal triangle), and
//              of C h_in^T.  Then it applies the mask, decay and dt in
//              registers and feeds the accumulators straight back as the A
//              operand of att x: the C/D fragment of m16n8k8 holds columns
//              (2j, 2j+1) where the A fragment wants (j, j+4), so the
//              product runs over the chunk's tokens in the order that the
//              fragment already has, and x is read in the same order.  The
//              Q x Q block never leaves registers.  Sub-partition s (warps
//              s and s + 4) owns row tiles s and 7 - s, which balances the
//              triangle.
// B and C are read by every head of a group (head stride 0 in ssd_full),
// and the grids put the heads innermost, so their tiles come from L2.  At
// 2048 tokens both kernels are bound by those L2 reads (ssd_out moves
// about 200 KB per CTA, 164 MB of its 256 MB being B and C again for each
// head); sharing them across a group's heads is later work.
//
// Precision: TF32 keeps 10 bits of mantissa.  An operand is rounded as
// cvt.rna.tf32.f32 rounds it (raw float bits in an mma would be truncated),
// computed on the integer pipe (tf32() below); where a product must hold
// float32 accuracy it is split in three, hi*hi + hi*lo + lo*hi with hi =
// rna(v) and lo = rna(v - hi).  The state product is split in both dtypes
// (the final state is held at 2e-4 either way); the y products (C B^T,
// att x, C h^T) are split for float32 x and rounded once for bfloat16 x,
// whose y is rounded to bfloat16 at the store; there ssd_out rounds each
// staged value of C, B and h_in once in shared memory.  A bfloat16 x
// widened to float32 is a TF32 value already and enters the mma as it is.
// Inputs are read through element strides (16-byte cp.async where the rows
// are contiguous and aligned, element loads otherwise).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 128;       // tokens per internal chunk
constexpr int kThreads = 256;     // 8 warps in either kernel
constexpr int kStateCols = 32;    // columns of N per ssd_state CTA
constexpr int kPTile = 64;        // rows of P per ssd_state CTA, at most per ssd_out CTA
constexpr int kMaxN = 128;        // state size: 8 pairs of k-steps in ssd_out

// n / d for 0 <= n < 2^31 by a multiply and a shift (Granlund and
// Montgomery): s = ceil(log2 d), m = 2^32 (2^s - d) / d + 1.
struct FastDiv {
  uint32_t d, m, s;
  __device__ __forceinline__ uint32_t div(uint32_t n) const { return (__umulhi(n, m) + n) >> s; }
};

FastDiv make_fastdiv(uint32_t d) {
  uint32_t s = 0;
  while ((1u << s) < d) ++s;
  const uint64_t m = ((uint64_t(1) << 32) * ((uint64_t(1) << s) - d)) / d + 1;
  return FastDiv{d, (uint32_t)m, s};
}

struct Geom {
  int64_t sx[5], sb[5], sc[5], sd[4], sy[5];   // element strides
  FastDiv fq;   // the caller's chunk length q
  int nc, nb, q, nh, p, n;
  int seq;      // nc * q tokens
  int nk;       // internal chunks
  int npad;     // n rounded up to 16: h_in's row
  int nnt;      // ssd_state's N tiles
  int npt;      // P tiles (64 rows for ssd_state, the instance's width for ssd_out)
  int vx, vb, vc;   // rows of x, B, C may be copied 16 bytes at a time
  int vy;           // y's P axis is contiguous and element pairs are aligned
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);   // round to nearest even, as astype(bfloat16)
}

// two adjacent elements of y in one store
__device__ __forceinline__ void store_pair(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}

// ---- PTX ------------------------------------------------------------------

// cvt.rna.tf32.f32 (round to nearest, ties away from zero) on the integer
// pipe: the same bits for every input but NaN (repro_ssd_tf32_mismatches
// holds the two against each other over all 2^32 patterns).  The
// conversion instruction runs at a quarter of the integer rate, and the
// kernels round one operand per use.
__device__ __forceinline__ uint32_t tf32(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ uint32_t tf32_cvt(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem), "r"(bytes));
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---- m16n8k8 fragments (PTX ISA, "Matrix Fragments for mma.m16n8k8"), with
// g = lane / 4, j = lane % 4:  A a0 (g, j), a1 (g+8, j), a2 (g, j+4), a3
// (g+8, j+4);  B b0 (j, g), b1 (j+4, g);  C/D c0 (g, 2j), c1 (g, 2j+1),
// c2 (g+8, 2j), c3 (g+8, 2j+1)  ((row, column); k is A's column, B's row).

template <bool k3>
struct FragA {
  uint32_t hi[4], lo[4];
};
template <bool k3>
struct FragB {
  uint32_t hi[2], lo[2];
};

template <bool k3>
__device__ __forceinline__ FragA<k3> frag_a(float a0, float a1, float a2, float a3) {
  FragA<k3> f;
  const float v[4] = {a0, a1, a2, a3};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f.hi[i] = tf32(v[i]);
    if (k3) f.lo[i] = tf32(v[i] - __uint_as_float(f.hi[i]));
  }
  return f;
}

template <bool k3>
__device__ __forceinline__ FragB<k3> frag_b(float b0, float b1) {
  FragB<k3> f;
  f.hi[0] = tf32(b0);
  f.hi[1] = tf32(b1);
  if (k3) {
    f.lo[0] = tf32(b0 - __uint_as_float(f.hi[0]));
    f.lo[1] = tf32(b1 - __uint_as_float(f.hi[1]));
  }
  return f;
}

// Operands read from a tile that was rounded in place (bfloat16 x): the
// bits are TF32 values already.  With float32 x the tile holds the raw
// values, which are split here.
template <bool k3>
__device__ __forceinline__ FragA<k3> frag_a_tile(float a0, float a1, float a2, float a3) {
  if (k3) return frag_a<k3>(a0, a1, a2, a3);
  FragA<k3> f;
  f.hi[0] = __float_as_uint(a0);
  f.hi[1] = __float_as_uint(a1);
  f.hi[2] = __float_as_uint(a2);
  f.hi[3] = __float_as_uint(a3);
  return f;
}
template <bool k3>
__device__ __forceinline__ FragB<k3> frag_b_tile(float b0, float b1) {
  if (k3) return frag_b<k3>(b0, b1);
  FragB<k3> f;
  f.hi[0] = __float_as_uint(b0);
  f.hi[1] = __float_as_uint(b1);
  return f;
}

// x as the B operand: float32 is rounded (and split); a bfloat16 value
// widened to float32 is already a TF32 value.
template <bool k3>
__device__ __forceinline__ FragB<k3> frag_x(float v0, float v1) { return frag_b<k3>(v0, v1); }
template <bool k3>
__device__ __forceinline__ FragB<k3> frag_x(__nv_bfloat16 v0, __nv_bfloat16 v1) {
  FragB<k3> f;
  f.hi[0] = __float_as_uint(__bfloat162float(v0));
  f.hi[1] = __float_as_uint(__bfloat162float(v1));
  if (k3) f.lo[0] = f.lo[1] = 0u;
  return f;
}

// d += a b: one TF32 product, or three (lo*hi + hi*lo + hi*hi, small terms first)
template <bool k3>
__device__ __forceinline__ void mma_tf32(float (&d)[4], const FragA<k3>& a, const FragB<k3>& b) {
  if (k3) {
    mma(d, a.lo, b.hi);
    mma(d, a.hi, b.lo);
  }
  mma(d, a.hi, b.hi);
}

// The same split product into two accumulators, hi*hi into d and the small
// terms into e (d + e is the sum): two dependency chains in place of one.
__device__ __forceinline__ void mma_split(float (&d)[4], float (&e)[4], const FragA<true>& a,
                                          const FragB<true>& b) {
  mma(e, a.lo, b.hi);
  mma(d, a.hi, b.hi);
  mma(e, a.hi, b.lo);
}

// ---- staging tiles in shared memory -------------------------------------

// Rows r < rows of a tile are tokens t0 + r, token t at element offset
// base + (t / q) * s_chunk + (t % q) * s_tok, columns c < cols at c *
// s_col.  Rows up to rows_pad and columns up to cols_pad are filled with
// zeros.  The scratch h_in is staged with q = 1, rows at pitch s_chunk.
struct Rows {
  int64_t base, s_chunk, s_tok, s_col;
  FastDiv q;
  int t0, rows, cols;
};

__device__ __forceinline__ int64_t row_offset(const Rows& R, int r) {
  const uint32_t t = R.t0 + r, ci = R.q.div(t);
  return R.base + (int64_t)ci * R.s_chunk + (int64_t)(t - ci * R.q.d) * R.s_tok;
}

// A tile's 16-byte chunk c of row r sits at chunk c ^ ((r & rmask) * mul)
// of its row: which rows a fragment read touches together decides the XOR
// that puts them on distinct banks.
struct Swz {
  int rmask, mul;
  __device__ __forceinline__ int operator()(int r, int c) const { return c ^ ((r & rmask) * mul); }
};

template <typename T>
__device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

// Which threads share a tile's items: thread `me` of `count`.
struct Team {
  int me, count;
  __device__ __forceinline__ static Team block() { return Team{(int)threadIdx.x, (int)blockDim.x}; }
};

// f(r, c) for this thread's items (row r, item c of per_row) of a tile, the
// threads of the team taking consecutive items; no division per item.
template <class F>
__device__ __forceinline__ void for_items(Team tm, int rows_pad, int per_row, F&& f) {
  const int dr = tm.count / per_row, dc = tm.count - dr * per_row;
  int r = tm.me / per_row, c = tm.me - r * per_row;
  while (r < rows_pad) {
    f(r, c);
    r += dr;
    c += dc;
    if (c >= per_row) {
      c -= per_row;
      ++r;
    }
  }
}

// The tile into dst: row r at pitch ld elements, its chunk c at chunk c0 + c
// (swizzled).  vec: cp.async 16 bytes at a time (unit column stride,
// 16-byte aligned rows, cols a multiple of 16 bytes); otherwise element
// loads.
template <typename T>
__device__ void stage(Team tm, T* dst, int ld, Swz sw, int c0, const T* __restrict__ src,
                      const Rows& R, int rows_pad, int cols_pad, bool vec) {
  constexpr int E = 16 / sizeof(T);
  for_items(tm, rows_pad, vec ? cols_pad / E : cols_pad, [&](int r, int c) {
    const bool in = r < R.rows;
    const int64_t row = in ? row_offset(R, r) : 0;
    if (vec) {
      const bool ok = in && c * E < R.cols;
      cp_async16(dst + r * ld + sw(r, c0 + c) * E, ok ? src + row + c * E : src, ok ? 16 : 0);
    } else {
      const T v = in && c < R.cols ? src[row + c * R.s_col] : zero<T>();
      dst[r * ld + sw(r, c0 + c / E) * E + c % E] = v;
    }
  });
}

// Round to TF32 in place the items that this thread staged with the same
// arguments (its own cp.async data is visible to it once waited for), so
// that a value read by many fragments is rounded once.
__device__ void round_staged(Team tm, float* dst, int ld, Swz sw, int c0, int rows_pad,
                             int cols_pad, bool vec) {
  for_items(tm, rows_pad, vec ? cols_pad / 4 : cols_pad, [&](int r, int c) {
    if (vec) {
      float4* p = reinterpret_cast<float4*>(dst + r * ld) + sw(r, c0 + c);
      const float4 v = *p;
      *p = make_float4(__uint_as_float(tf32(v.x)), __uint_as_float(tf32(v.y)),
                       __uint_as_float(tf32(v.z)), __uint_as_float(tf32(v.w)));
    } else {
      float* p = dst + r * ld + sw(r, c0 + c / 4) * 4 + c % 4;
      *p = __uint_as_float(tf32(*p));
    }
  });
}

// dt of the chunk's kChunk rows (zeros past its end)
__device__ __forceinline__ void stage_dt(Team tm, float* dst, const float* __restrict__ dt,
                                         const Rows& R) {
  for (int r = tm.me; r < kChunk; r += tm.count) {
    const bool ok = r < R.rows;
    cp_async4(dst + r, ok ? dt + row_offset(R, r) : dt, ok ? 4 : 0);
  }
}

// Inclusive cumsum of dt * a over one chunk (kChunk rows of dts), by one
// warp: lane l holds rows 4l .. 4l+3.
__device__ __forceinline__ float4 cumsum_chunk(const float* dts, float an, int lane) {
  const float4 d = reinterpret_cast<const float4*>(dts)[lane];
  float4 c;
  c.x = d.x * an;
  c.y = c.x + d.y * an;
  c.z = c.y + d.z * an;
  c.w = c.z + d.w * an;
  float run = c.w;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float v = __shfl_up_sync(0xffffffffu, run, o);
    if (lane >= o) run += v;
  }
  float before = __shfl_up_sync(0xffffffffu, run, 1);
  if (lane == 0) before = 0.f;
  c.x += before;
  c.y += before;
  c.z += before;
  c.w += before;
  return c;
}

// ---- ssd_state -----------------------------------------------------------

// x's tile in ssd_state: P columns rounded up to 32, so that a row holds
// the 8 (float) or 4 (bfloat16) chunks its swizzle needs.
__host__ __device__ __forceinline__ int state_xcols(int mt) { return (16 * mt + 31) / 32 * 32; }

constexpr int kStateLoaders = 4;   // warps of a ssd_state CTA that only load

// mt compute warps (16 rows of P and the tile's 32 columns of N each), then
// kStateLoaders warps that load the next chunk while they compute.
template <typename T>
__global__ void __launch_bounds__(32 * (kPTile / 16 + kStateLoaders), 3)
ssd_state(const T* __restrict__ x, const float* __restrict__ bm, const float* __restrict__ dt,
          const float* __restrict__ a_neg, float* __restrict__ hin, float* __restrict__ hout,
          const Geom g) {
  constexpr int E = 16 / sizeof(T);
  const int mt = blockDim.x / 32 - kStateLoaders;
  const int xcols = state_xcols(mt);
  // A reads rows t = 8k + tq and 8k + tq + 4: the swizzle keys on t & 3
  const Swz xsw{3, E == 4 ? 2 : 1}, bsw{3, 2};
  const int hh = blockIdx.x, bb = blockIdx.z;
  const int ntile = blockIdx.y % g.nnt, ptile = blockIdx.y / g.nnt;
  const int n0 = ntile * kStateCols, p0 = ptile * kPTile;
  const int pw = min(kPTile, g.p - p0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gq = lane >> 2, tq = lane & 3;
  const bool loader = warp >= mt;
  extern __shared__ __align__(16) unsigned char smem[];
  // per buffer: x (kChunk, xcols) T | B slice (kChunk, kStateCols) | dt (kChunk);
  // then each compute warp's w (kChunk)
  const int xbytes = kChunk * xcols * (int)sizeof(T);
  const int buf = xbytes + kChunk * kStateCols * 4 + kChunk * 4;

  // chunk k into buffer b, by the loading warps, which wait for it
  auto load = [&](int k, int b) {
    const Team tm{tid - 32 * mt, 32 * kStateLoaders};
    const int t0 = k * kChunk, len = min(kChunk, g.seq - t0);
    unsigned char* base = smem + b * buf;
    stage<T>(tm, reinterpret_cast<T*>(base), xcols, xsw, 0, x,
             Rows{bb * g.sx[1] + hh * g.sx[3] + p0 * g.sx[4], g.sx[0], g.sx[2], g.sx[4], g.fq,
                  t0, len, pw},
             kChunk, xcols, g.vx);
    stage<float>(tm, reinterpret_cast<float*>(base + xbytes), kStateCols, bsw, 0, bm,
                 Rows{bb * g.sb[1] + hh * g.sb[3] + n0 * g.sb[4], g.sb[0], g.sb[2], g.sb[4], g.fq,
                      t0, len, max(0, min(kStateCols, g.n - n0))},
                 kChunk, kStateCols, g.vb);
    stage_dt(tm, reinterpret_cast<float*>(base + xbytes + kChunk * kStateCols * 4), dt,
             Rows{bb * g.sd[1] + hh * g.sd[3], g.sd[0], g.sd[2], 0, g.fq, t0, len, 1});
    cp_commit();
    cp_wait<0>();
  };

  // the state tile: hi*hi products in acc, the small terms in cor
  float acc[4][4] = {}, cor[4][4] = {};
  // rows p, columns n < ncols at pitch ld; pairs (n, n + 1) as one float2
  // where ld is even (h_in's rows are 16 floats a multiple)
  auto store = [&](float* dst, int ld, int ncols) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int n = n0 + 8 * ni + 2 * tq;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int p = 16 * warp + gq + 8 * half;
        if (p >= pw) continue;
        float* row = dst + (int64_t)(p0 + p) * ld;
        const float v0 = acc[ni][2 * half] + cor[ni][2 * half];
        const float v1 = acc[ni][2 * half + 1] + cor[ni][2 * half + 1];
        if (n + 1 < ncols && ld % 2 == 0) {
          *reinterpret_cast<float2*>(row + n) = make_float2(v0, v1);
        } else {
          if (n < ncols) row[n] = v0;
          if (n + 1 < ncols) row[n + 1] = v1;
        }
      }
    }
  };

  // this lane's columns in the swizzled tiles: rows ta and tb = ta + 4 share
  // t & 3 = tq, so each read's column is fixed per lane
  const int pa = 16 * warp + gq;
  const int xa = xsw(tq, pa / E) * E + pa % E, xb = xsw(tq, (pa + 8) / E) * E + (pa + 8) % E;
  int bcol[4];
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int n = 8 * ni + gq;
    bcol[ni] = bsw(tq, n / 4) * 4 + n % 4;
  }
  float* ws = reinterpret_cast<float*>(smem + 2 * buf) + warp * kChunk;
  const float an = a_neg[hh];

  if (loader) load(0, 0);
  for (int k = 0; k < g.nk; ++k) {
    const int b = k & 1;
    __syncthreads();   // chunk k is in buffer b; buffer b ^ 1 is free
    if (loader) {
      if (k + 1 < g.nk) load(k + 1, b ^ 1);
      continue;
    }
    // the state entering chunk k is ssd_out's h_in[k]
    store(hin + (((int64_t)bb * g.nk + k) * g.nh + hh) * g.p * g.npad, g.npad, g.npad);

    const T* xs = reinterpret_cast<const T*>(smem + b * buf);
    const float* bs = reinterpret_cast<const float*>(smem + b * buf + xbytes);
    const float* dts = bs + kChunk * kStateCols;
    const float4 cs = cumsum_chunk(dts, an, lane);
    const float last = __shfl_sync(0xffffffffu, cs.w, 31);
    {
      const float4 d = reinterpret_cast<const float4*>(dts)[lane];
      reinterpret_cast<float4*>(ws)[lane] =
          make_float4(d.x * expf(last - cs.x), d.y * expf(last - cs.y),
                      d.z * expf(last - cs.z), d.w * expf(last - cs.w));
    }
    __syncwarp();
    const float decay = expf(last);
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[ni][e] *= decay;
        cor[ni][e] *= decay;
      }

    // h += (x * w)^T B_slice: A (rows p, k = t), B (k = t, columns n)
    const int steps = (min(kChunk, g.seq - k * kChunk) + 7) / 8;
#pragma unroll 2
    for (int kk = 0; kk < steps; ++kk) {
      const int ta = 8 * kk + tq, tb = ta + 4;
      const float wa = ws[ta], wb = ws[tb];
      const T* xra = xs + ta * xcols;
      const T* xrb = xs + tb * xcols;
      const FragA<true> fa = frag_a<true>(to_f(xra[xa]) * wa, to_f(xra[xb]) * wa,
                                          to_f(xrb[xa]) * wb, to_f(xrb[xb]) * wb);
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
        mma_split(acc[ni], cor[ni], fa,
                  frag_b<true>(bs[ta * kStateCols + bcol[ni]], bs[tb * kStateCols + bcol[ni]]));
    }
  }
  if (hout != nullptr && !loader)
    store(hout + ((int64_t)bb * g.nh + hh) * g.p * g.n, g.n, g.n);
}

// ---- ssd_out -------------------------------------------------------------

// Slabs of 16 columns of n (C's and B's chunk rows, h_in's rows of P) pass
// through a ring of out_ring buffers; a bfloat16 CTA then fits twice on an
// SM.  A slab holds C and B (kChunk, 16) and h_in (pw, 16), in floats.
__host__ __device__ constexpr int out_ring(bool k3) { return k3 ? 4 : 3; }
__host__ __device__ constexpr int out_slab_floats(int pw) { return (2 * kChunk + pw) * 16; }

template <typename T, int PT>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 2 ? 2 : 1)
ssd_out(const T* __restrict__ x, const float* __restrict__ bm, const float* __restrict__ cm,
        const float* __restrict__ dt, const float* __restrict__ a_neg,
        const float* __restrict__ hin, T* __restrict__ y, const Geom g) {
  constexpr bool k3 = sizeof(T) == 4;        // split the y products for float32 x
  constexpr int PW = 8 * PT;                  // columns of P per CTA
  constexpr int ldx = PW + (k3 ? 4 : 8);      // conflict-free B reads of x in both dtypes
  constexpr int kRing = out_ring(k3);
  constexpr int kSlab = out_slab_floats(PW);
  // A slab row is 4 chunks, so the float4 reads of rows r and r + 1 fall on
  // distinct banks without a swizzle.
  const Swz sw{0, 0};
  const int NP = g.npad, nk2 = NP / 16;
  const int hh = blockIdx.x, kc = blockIdx.y;
  const int bb = blockIdx.z / g.npt, ptile = blockIdx.z % g.npt;
  const int p0 = ptile * PW, pw = min(PW, g.p - p0);
  const int t0 = kc * kChunk, len = min(kChunk, g.seq - t0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gq = lane >> 2, tq = lane & 3;
  extern __shared__ __align__(16) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);   // kRing x (C | B | h_in) slabs
  float* css = ring + kRing * kSlab;              // (kChunk) cumsum
  float* dts = css + kChunk;                      // (kChunk)
  T* Xs = reinterpret_cast<T*>(dts + kChunk);     // (kChunk, ldx)

  // slab kk into ring slot kk % kRing: columns 16 kk .. 16 kk + 15
  auto load_slab = [&](int kk) {
    const Team tm = Team::block();
    float* slab = ring + (kk % kRing) * kSlab;
    const int cols = min(16, g.n - 16 * kk);
    stage<float>(tm, slab, 16, sw, 0, cm,
                 Rows{bb * g.sc[1] + hh * g.sc[3] + 16 * kk * g.sc[4], g.sc[0], g.sc[2], g.sc[4],
                      g.fq, t0, len, cols},
                 kChunk, 16, g.vc);
    stage<float>(tm, slab + kChunk * 16, 16, sw, 0, bm,
                 Rows{bb * g.sb[1] + hh * g.sb[3] + 16 * kk * g.sb[4], g.sb[0], g.sb[2], g.sb[4],
                      g.fq, t0, len, cols},
                 kChunk, 16, g.vb);
    stage<float>(tm, slab + 2 * kChunk * 16, 16, sw, 0, hin,
                 Rows{((((int64_t)bb * g.nk + kc) * g.nh + hh) * g.p + p0) * NP + 16 * kk, NP, 0,
                      1, FastDiv{1, 1, 0}, 0, pw, 16},
                 PW, 16, true);
  };
  auto round_slab = [&](int kk) {   // bfloat16 x: the y products take their operands rounded once
    const Team tm = Team::block();
    float* slab = ring + (kk % kRing) * kSlab;
    round_staged(tm, slab, 16, sw, 0, kChunk, 16, g.vc);
    round_staged(tm, slab + kChunk * 16, 16, sw, 0, kChunk, 16, g.vb);
    round_staged(tm, slab + 2 * kChunk * 16, 16, sw, 0, PW, 16, true);
  };

  // group 0: dt and x; groups 1 .. kRing - 1: the first slabs
  stage_dt(Team::block(), dts, dt,
           Rows{bb * g.sd[1] + hh * g.sd[3], g.sd[0], g.sd[2], 0, g.fq, t0, len, 1});
  stage<T>(Team::block(), Xs, ldx, Swz{0, 0}, 0, x,
           Rows{bb * g.sx[1] + hh * g.sx[3] + p0 * g.sx[4], g.sx[0], g.sx[2], g.sx[4], g.fq, t0,
                len, pw},
           kChunk, PW, g.vx);
  cp_commit();
#pragma unroll
  for (int kk = 0; kk < kRing - 1; ++kk) {
    if (kk < nk2) load_slab(kk);
    cp_commit();
  }

  const int rt = warp < 4 ? warp : 11 - warp;   // row tile
  const int qa = 16 * rt + gq, qb = qa + 8;      // this lane's rows
  const bool active = 16 * rt < len;
  const int nj = 2 * (min(rt, (len - 1) >> 4) + 1);   // column tiles of 8 tokens up to the diagonal

  // Per slab, C rows as the A operand (k = n): a lane holds columns 4 tq ..
  // 4 tq + 3 of the slab's 16, the first two for k-step 0 (k = tq and tq + 4),
  // the last two for k-step 1; the B operands (B's rows t, h_in's rows p)
  // follow suit.
  //   S     = C_rows B^T over the column tiles up to the diagonal
  //   inter = C_rows h_in^T
  float s[2 * kChunk / 16][4] = {};
  float inter[PT][4] = {};
#pragma unroll 1
  for (int kk = 0; kk < nk2; ++kk) {
    cp_wait<kRing - 2>();   // slab kk has landed (and dt, x before it)
    if (!k3) round_slab(kk);
    __syncthreads();        // ... for every thread; slot (kk - 1) % kRing is free
    if (kk + kRing - 1 < nk2) load_slab(kk + kRing - 1);
    cp_commit();
    if (kk == 0 && warp == 0)
      reinterpret_cast<float4*>(css)[lane] = cumsum_chunk(dts, a_neg[hh], lane);
    if (!active) continue;
    const float4* slab = reinterpret_cast<const float4*>(ring + (kk % kRing) * kSlab);
    const float4 u = slab[qa * 4 + tq], v = slab[qb * 4 + tq];
    FragA<k3> a[2];
    a[0] = frag_a_tile<k3>(u.x, v.x, u.y, v.y);
    a[1] = frag_a_tile<k3>(u.z, v.z, u.w, v.w);
    const float4* b4 = slab + kChunk * 4 + gq * 4 + tq;
#pragma unroll
    for (int j = 0; j < 2 * kChunk / 16; ++j) {
      if (j < nj) {
        const float4 w = b4[j * 32];
        mma_tf32<k3>(s[j], a[0], frag_b_tile<k3>(w.x, w.y));
        mma_tf32<k3>(s[j], a[1], frag_b_tile<k3>(w.z, w.w));
      }
    }
    const float4* h4 = slab + 2 * kChunk * 4 + gq * 4 + tq;
#pragma unroll
    for (int ni = 0; ni < PT; ++ni) {
      const float4 w = h4[ni * 32];
      mma_tf32<k3>(inter[ni], a[0], frag_b_tile<k3>(w.x, w.y));
      mma_tf32<k3>(inter[ni], a[1], frag_b_tile<k3>(w.z, w.w));
    }
  }
  __syncthreads();   // the cumsum, for every warp
  if (!active) return;

  // y = exp(cs[q]) * inter + att x, with att = S * exp(cs[q] - cs[t]) *
  // dt[t] for t <= q (the exponent clamped at 0: above the diagonal it
  // would overflow, and the select drops it there).  att x runs over the
  // tokens t = 8j + 2tq, 8j + 2tq + 1 of the accumulator fragment: A (g, tq)
  // <- c0, (g+8, tq) <- c2, (g, tq+4) <- c1, (g+8, tq+4) <- c3, and x's rows
  // in that order.
  const float cqa = css[qa], cqb = css[qb];
  const float ea = expf(cqa), eb = expf(cqb);
  float acc[PT][4];
#pragma unroll
  for (int ni = 0; ni < PT; ++ni) {
    acc[ni][0] = ea * inter[ni][0];
    acc[ni][1] = ea * inter[ni][1];
    acc[ni][2] = eb * inter[ni][2];
    acc[ni][3] = eb * inter[ni][3];
  }
#pragma unroll
  for (int j = 0; j < 2 * kChunk / 16; ++j) {
    if (j < nj) {
      const int t = 8 * j + 2 * tq;
      const float2 ct = *reinterpret_cast<const float2*>(css + t);
      const float2 dd = *reinterpret_cast<const float2*>(dts + t);
      const float a0 = t <= qa ? s[j][0] * expf(fminf(cqa - ct.x, 0.f)) * dd.x : 0.f;
      const float a2 = t + 1 <= qa ? s[j][1] * expf(fminf(cqa - ct.y, 0.f)) * dd.y : 0.f;
      const float a1 = t <= qb ? s[j][2] * expf(fminf(cqb - ct.x, 0.f)) * dd.x : 0.f;
      const float a3 = t + 1 <= qb ? s[j][3] * expf(fminf(cqb - ct.y, 0.f)) * dd.y : 0.f;
      const FragA<k3> fa = frag_a<k3>(a0, a1, a2, a3);
      const T* x0 = Xs + t * ldx + gq;
#pragma unroll
      for (int ni = 0; ni < PT; ++ni)
        mma_tf32<k3>(acc[ni], fa, frag_x<k3>(x0[8 * ni], x0[ldx + 8 * ni]));
    }
  }

  // y in the output dtype, rows q < len, columns p < pw
  const int64_t yb = bb * g.sy[1] + hh * g.sy[3] + p0 * g.sy[4];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int q = half ? qb : qa;
    if (q >= len) continue;
    const uint32_t t = t0 + q, ci = g.fq.div(t);
    T* row = y + yb + (int64_t)ci * g.sy[0] + (int64_t)(t - ci * g.q) * g.sy[2];
#pragma unroll
    for (int ni = 0; ni < PT; ++ni) {
      const int p = 8 * ni + 2 * tq;
      const float v0 = acc[ni][2 * half], v1 = acc[ni][2 * half + 1];
      if (g.vy && p + 1 < pw) {
        store_pair(row + p, v0, v1);
      } else {
        if (p < pw) row[p * g.sy[4]] = from_f<T>(v0);
        if (p + 1 < pw) row[(p + 1) * g.sy[4]] = from_f<T>(v1);
      }
    }
  }
}

// ---- host side -------------------------------------------------------------

int state_warps(int p) { return (min(p, kPTile) + 15) / 16 + kStateLoaders; }

// two buffers of x, the B slice and dt; each compute warp's w
int64_t state_smem(int p, int esize) {
  const int mt = state_warps(p) - kStateLoaders;
  const int64_t xcols = state_xcols(mt);
  return 2 * (kChunk * xcols * esize + kChunk * kStateCols * 4 + kChunk * 4) +
         (int64_t)mt * kChunk * 4;
}

int out_pt(int p) { return p <= 16 ? 2 : p <= 32 ? 4 : 8; }

// the ring of slabs, the cumsum and dt, and x
int64_t out_smem(int p, int n, int esize) {
  const int pw = 8 * out_pt(p);
  const int64_t ldx = pw + (esize == 4 ? 4 : 8);
  return ((int64_t)out_ring(esize == 4) * out_slab_floats(pw) + 2 * kChunk) * 4 +
         kChunk * ldx * esize;
}

Geom make_geom(int64_t nc, int64_t nb, int64_t q, int64_t nh, int64_t p, int64_t n,
               const int64_t* strides, int64_t vec) {
  Geom g;
  for (int i = 0; i < 5; ++i) {
    g.sx[i] = strides[i];
    g.sb[i] = strides[5 + i];
    g.sc[i] = strides[10 + i];
    g.sy[i] = strides[19 + i];
  }
  for (int i = 0; i < 4; ++i) g.sd[i] = strides[15 + i];
  g.fq = make_fastdiv((uint32_t)q);
  g.nc = (int)nc;
  g.nb = (int)nb;
  g.q = (int)q;
  g.nh = (int)nh;
  g.p = (int)p;
  g.n = (int)n;
  g.seq = (int)(nc * q);
  g.nk = (g.seq + kChunk - 1) / kChunk;
  g.npad = (g.n + 15) / 16 * 16;
  g.nnt = (g.npad + kStateCols - 1) / kStateCols;
  g.npt = 0;
  g.vx = (int)(vec & 1);
  g.vb = (int)((vec >> 1) & 1);
  g.vc = (int)((vec >> 2) & 1);
  g.vy = (int)((vec >> 3) & 1);
  return g;
}

bool shape_ok(int64_t q, int64_t n) { return q >= 1 && q <= kChunk && n >= 1 && n <= kMaxN; }

template <typename K>
int prepare(K kern, int64_t smem) {
  if (smem > 48 * 1024)
    return (int)cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  return 0;
}

template <typename T>
int launch_state(const void* x, const void* bm, const void* dt, const void* a, void* hin,
                 void* hout, Geom g, cudaStream_t stream) {
  g.npt = (g.p + kPTile - 1) / kPTile;
  const int64_t smem = state_smem(g.p, sizeof(T));
  auto kern = ssd_state<T>;
  const int err = prepare(kern, smem);
  if (err) return err;
  const dim3 grid(g.nh, g.nnt * g.npt, g.nb);
  kern<<<grid, 32 * state_warps(g.p), (size_t)smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(bm), static_cast<const float*>(dt),
      static_cast<const float*>(a), static_cast<float*>(hin), static_cast<float*>(hout), g);
  return (int)cudaGetLastError();
}

template <typename T, int PT>
int launch_out(const void* x, const void* bm, const void* cm, const void* dt, const void* a,
               const void* hin, void* y, Geom g, cudaStream_t stream) {
  g.npt = (g.p + 8 * PT - 1) / (8 * PT);
  const int64_t smem = out_smem(g.p, g.n, sizeof(T));
  auto kern = ssd_out<T, PT>;
  const int err = prepare(kern, smem);
  if (err) return err;
  const dim3 grid(g.nh, g.nk, g.nb * g.npt);
  kern<<<grid, kThreads, (size_t)smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(bm), static_cast<const float*>(cm),
      static_cast<const float*>(dt), static_cast<const float*>(a), static_cast<const float*>(hin),
      static_cast<T*>(y), g);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_out(const void* x, const void* bm, const void* cm, const void* dt, const void* a,
                 const void* hin, void* y, const Geom& g, cudaStream_t s) {
  switch (out_pt(g.p)) {
    case 2: return launch_out<T, 2>(x, bm, cm, dt, a, hin, y, g, s);
    case 4: return launch_out<T, 4>(x, bm, cm, dt, a, hin, y, g, s);
    default: return launch_out<T, 8>(x, bm, cm, dt, a, hin, y, g, s);
  }
}

}  // namespace

namespace {

// Per thread, the non-NaN float bit patterns of its share of all 2^32 on
// which tf32() and cvt.rna.tf32.f32 differ.
__global__ void tf32_check(unsigned int* mismatches) {
  const uint32_t id = blockIdx.x * blockDim.x + threadIdx.x, threads = gridDim.x * blockDim.x;
  unsigned int mine = 0;
  for (uint64_t i = id; i < (1ull << 32); i += threads) {
    const float v = __uint_as_float((uint32_t)i);
    if (!isnan(v) && tf32(v) != tf32_cvt(v)) ++mine;
  }
  mismatches[id] = mine;
}

}  // namespace

// The count of tf32_check for each of its threads (a check
// of the kernels' rounding, not a part of them).
extern "C" int64_t repro_ssd_tf32_check_threads() { return 1024 * 256; }
extern "C" int repro_ssd_tf32_mismatches(void* mismatches, void* stream) {
  tf32_check<<<1024, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned int*>(mismatches));
  return (int)cudaGetLastError();
}

extern "C" int64_t repro_ssd_max_chunk() { return kChunk; }
extern "C" int64_t repro_ssd_max_state() { return kMaxN; }
extern "C" int64_t repro_ssd_chunk() { return kChunk; }

// Dynamic shared memory per CTA: kernel 0 ssd_state, 1 ssd_out.
extern "C" int64_t repro_ssd_smem_bytes(int64_t kernel, int64_t bf16, int64_t p, int64_t n) {
  const int esize = bf16 ? 2 : 4;
  return kernel == 0 ? state_smem((int)p, esize) : out_smem((int)p, (int)n, esize);
}

// Arguments of both entry points: x (nc, B, Q, H, P) float32 (`bf16` 0) or
// bfloat16 (`bf16` 1); b, c (nc, B, Q, H, N), dt (nc, B, Q, H) and a (H,)
// float32, a contiguous; `strides` holds the element strides of x, b, c (5
// each), dt (4) and y (5), in that order; bit 0, 1, 2 of `vec` says that
// x's, b's, c's rows may be copied 16 bytes at a time, bit 3 that y's
// element pairs (p, p + 1), p even, may be stored at once.  `hin` is the scratch
// (B, K, H, P, Npad) float32, contiguous, K = ceil(nc Q / 128), Npad = N
// rounded up to 16.  Each returns the CUDA error code of its launch.

// ssd_state: h_in[:, k] = the state entering internal chunk k; `hout`, when
// not null, receives the final state (B, H, P, N), contiguous float32.
extern "C" int repro_ssd_state(const void* x, const void* bm, const void* dt, const void* a,
                               void* hin, void* hout, int64_t bf16, int64_t nc, int64_t nb,
                               int64_t q, int64_t nh, int64_t p, int64_t n,
                               const int64_t* strides, int64_t vec, void* stream) {
  if (!shape_ok(q, n)) return (int)cudaErrorInvalidValue;
  const Geom g = make_geom(nc, nb, q, nh, p, n, strides, vec);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) return launch_state<__nv_bfloat16>(x, bm, dt, a, hin, hout, g, s);
  return launch_state<float>(x, bm, dt, a, hin, hout, g, s);
}

// ssd_out: y (nc, B, Q, H, P), x's dtype, through its strides, from h_in.
extern "C" int repro_ssd_out(const void* x, const void* bm, const void* cm, const void* dt,
                             const void* a, const void* hin, void* y, int64_t bf16, int64_t nc,
                             int64_t nb, int64_t q, int64_t nh, int64_t p, int64_t n,
                             const int64_t* strides, int64_t vec, void* stream) {
  if (!shape_ok(q, n)) return (int)cudaErrorInvalidValue;
  const Geom g = make_geom(nc, nb, q, nh, p, n, strides, vec);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) return dispatch_out<__nv_bfloat16>(x, bm, cm, dt, a, hin, y, g, s);
  return dispatch_out<float>(x, bm, cm, dt, a, hin, y, g, s);
}
