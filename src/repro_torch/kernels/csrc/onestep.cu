// One fully periodic step of a 1-D stencil, in the natural layout (K5a) and
// in the paper's transpose layout (K5b): the layout A/B of the paper, one
// launch per step each.
//
// Replaces: src/repro/kernels/stencil_kernels.py::_kernel_naive_1d (launched
// by stencil1d_naive_onestep, K5a) and ::_kernel_transpose_1d (launched by
// stencil1d_transpose_onestep, K5b).
//
// Bound on H100: bytes.  A step must read the array once and write it once
// (2 * N * sizeof(element) bytes); its arithmetic is 2*taps - 1 operations a
// point.
//
// Design: a register window a thread, the same for both layouts.  A thread
// holds P runs of E consecutive natural points, each with the r points past
// either end: win[p][R + i] is point i of run p for -r <= i < E + r.  A tap
// of offset o is then a register index, win[p][R + i + o]: a switch on o,
// the same case on every thread, jumps to code compiled for that offset,
// and the taps are kernel arguments read at run time (up to kMaxTaps,
// summed in the spec's order).  The window's reach R is compiled at 4, 8
// and 16 (kNarrowR, kMidR, kMaxR); the host takes the narrowest that holds
// the stencil's reach r, since a wider window costs registers and with them
// warps in flight.  Each element is read from device memory and written
// once; the halo points come from the lanes beside a thread (K5a) or from
// L1 (K5b).
//
// K5a, natural layout: one run a thread, 32 bytes at the narrow window (E =
// 8 float, 16 bfloat16) and kWideRun points past it, loaded and stored as
// 16-byte words; lane L of a warp owns the run after lane L - 1's, so halo
// point q of a side is a shuffle of a run element from the lane d = 1 + q /
// E away, and the d edge lanes load it from device memory (wrapped)
// instead.  A thread whose run reaches past the array's end, or any thread
// when a pointer is not 16-byte aligned, loads and stores element by
// element, wrapped mod N.  The natural layout is the flat array whatever
// its row width vl.  Past the windows (kMaxR < r <= kLaneR), and past the
// narrow one at up to kLaneTaps taps (bfloat16: past the middle one), K5a
// takes its lane form
// (onestep_naive_lane): a warp's lanes hold vectors of 32 points, a tap is
// one shuffle a vector with the select on the sending lane, no switch.
//
// K5b, transpose layout (nb, m, vl): column c (block c / vl, lane c % vl)
// holds m consecutive natural points, its row s at ((c / vl) * m + s) * vl
// + c % vl.  A run is E rows of a column: 16 where 16 divides m, else the
// most rows up to kMaxRun that divide m (one row at a prime m past 8).  A
// warp takes one run of P column groups of 32 consecutive columns (P = 2,
// or 1 at E = 16), so each of its loads and stores is a row of 32
// consecutive elements at vl >= 32 (vl-element pieces below), and one
// switch a tap serves P runs.  The warps of a CTA take the m / E runs of
// their columns in turn.  A halo row past a column's end is a row of the
// column beside it (r <= m), read from device memory: mostly an L1 hit on a
// row the warp just loaded.  The split of a column into block and lane is
// a shift at vl a power of two, else one division, none a point.
//
// What binds it (PERF.md, sections 5 and 7; A/B turns on the card): up to
// 5 taps both kernels run at the copy rate in float32 and bfloat16.  Past
// that a tap costs its switch (a binary search and an indirect branch,
// amortised over P * E points) and a wider window's registers cap the
// warps that keep loads in flight: more points a switch (E = 16, P = 2) and
// the narrowest window paid, a window in shared memory read at run-time
// offsets did not, nor did the loads of four taps issued together.  A
// lane-form tap costs a shuffle a point at any reach, a window its halo and
// registers once: at reach 5, 2^26, the lane form took 0.1818 / 0.1823 /
// 0.1912 ms at 3 / 5 / 7 taps in float32 against the middle window's
// 0.2026-0.2033, but 0.2926 against 0.2285 at 13; in bfloat16 the middle
// window won from 3 taps (0.1115 against 0.1141, 5 taps 0.1190 against
// 0.1492), the wide one lost at 3 (0.1942 against 0.1141 at reach 12).
// Past reach 16 the lane form replaces the memory form (0.1819 against
// 0.3319 ms f32 at 3 taps of reach 20).  Runs
// of every length up to 8 (E = 3, 5, 6, 7 too) and the shift beat runs of a
// power of two rows and a division alone: K5b at m = 3, 6, 7 on E = 1, 2, 1
// took 2.4, 1.5 and 2.7 times as long, and without the shift K5b at reach
// 6 0.2929 against 0.2219 ms (PERF.md section 6).
// bfloat16 is held and computed in bfloat16 registers (elem.cuh's mul and
// add: mul.rn.bf16 / add.rn.bf16, no conversion), the plain version's float
// product and sum rounded to bfloat16 bit for bit.  The forms this file
// replaced held float registers, rounding each product and sum with a
// conversion, and K5a paid two shuffles a tap: their bfloat16 rows ran at
// the float32 rows' time, these at 1.15-1.33 times the bytes bound.
// Taps are summed in the spec's order, one multiply and one add each, with
// the coefficients already rounded to the element type (float built with
// -fmad=false): both kernels are bit for bit their plain PyTorch versions.
//
// Past the register forms (K5a an offset beyond kLaneR, K5b beyond kMaxR,
// or more than kMaxTaps taps) each kernel has a form that reads its taps
// from device memory (onestep_naive_mem, onestep_transpose_mem: any tap
// count and reach): a thread an element, every tap's element read from
// device memory, wrapped periodically.
#include <cuda_runtime.h>
#include <stdint.h>

#include "elem.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTaps = 64;   // the register forms' taps (kernel arguments)
constexpr int kMaxR = 16;      // the register forms' reach: the wide window
constexpr int kMidR = 8;       // the middle window's reach
constexpr int kNarrowR = 4;    // the narrow window's reach
constexpr int kWideRun = 16;   // K5a: points a run past the narrow window
constexpr int kLaneR = 32;     // K5a's lane form: one neighbouring vector of 32 a side
constexpr int kLaneRun = 8;    // K5a's lane form: vectors of 32 points a thread
constexpr int kLaneTaps = 7;   // K5a: the lane form past the narrow window up to these taps
constexpr int kMaxRun = 8;     // K5b: rows a run at most where 16 does not divide m

struct Taps {
  int n;
  int o[kMaxTaps];
  float c[kMaxTaps];
};

__device__ __forceinline__ int64_t wrap(int64_t i, int64_t n) {
  if (i >= 0 && i < n) return i;
  const int64_t r = i % n;
  return r < 0 ? r + n : r;
}

// a / d for 0 <= a, 0 < d: a 32-bit division where both fit
__device__ __forceinline__ int64_t divide(int64_t a, int64_t d) {
  if (((a | d) >> 32) == 0) return (int64_t)((unsigned)a / (unsigned)d);
  return a / d;
}

// ---------------------------------------------------------------------------
// The register window's step
// ---------------------------------------------------------------------------

// acc[p][i] (+)= win[p][R + i + O] * cf for the thread's P runs of E
// points: a register index; offsets beyond the window compile to nothing
// (the host sends none)
template <typename T, int P, int E, int R, int O, bool First>
__device__ __forceinline__ void tap(T (&acc)[P][E], const T (&win)[P][E + 2 * R], T cf) {
  if constexpr (O >= -R && O <= R) {
#pragma unroll
    for (int p = 0; p < P; ++p) {
#pragma unroll
      for (int i = 0; i < E; ++i) {
        const T term = mul(win[p][R + i + O], cf);
        acc[p][i] = First ? term : add(acc[p][i], term);
      }
    }
  }
}

#define K5_TAP(O)                              \
  case O:                                      \
    tap<T, P, E, R, O, First>(acc, win, cf);   \
    break;

template <typename T, int P, int E, int R, bool First>
__device__ __forceinline__ void apply(T (&acc)[P][E], const T (&win)[P][E + 2 * R], int o,
                                      T cf) {
  switch (o) {   // the same case on every thread: no divergence
    K5_TAP(-16) K5_TAP(-15) K5_TAP(-14) K5_TAP(-13) K5_TAP(-12) K5_TAP(-11)
    K5_TAP(-10) K5_TAP(-9) K5_TAP(-8) K5_TAP(-7) K5_TAP(-6) K5_TAP(-5)
    K5_TAP(-4) K5_TAP(-3) K5_TAP(-2) K5_TAP(-1) K5_TAP(0) K5_TAP(1)
    K5_TAP(2) K5_TAP(3) K5_TAP(4) K5_TAP(5) K5_TAP(6) K5_TAP(7)
    K5_TAP(8) K5_TAP(9) K5_TAP(10) K5_TAP(11) K5_TAP(12) K5_TAP(13)
    K5_TAP(14) K5_TAP(15) K5_TAP(16)
    default: break;   // the host checks |o| <= r <= R
  }
}
#undef K5_TAP
static_assert(kMaxR == 16, "apply's cases cover offsets -16..16");

// The thread's E outputs: every tap in the spec's order, the first one
// setting acc, each product and sum rounded to T.
template <typename T, int P, int E, int R>
__device__ __forceinline__ void step(T (&acc)[P][E], const T (&win)[P][E + 2 * R],
                                     const Taps& taps) {
  apply<T, P, E, R, true>(acc, win, taps.o[0], from_f<T>(taps.c[0]));
  for (int t = 1; t < taps.n; ++t)
    apply<T, P, E, R, false>(acc, win, taps.o[t], from_f<T>(taps.c[t]));
}

// ---------------------------------------------------------------------------
// K5a: natural layout
// ---------------------------------------------------------------------------

// word i of a 16-byte load
__device__ __forceinline__ unsigned word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// win[at ..] = the 16 / sizeof(T) elements of v, in memory order
template <typename T, int N>
__device__ __forceinline__ void unpack(const uint4& v, T (&win)[N], int at) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const unsigned w = word(v, i);
    if constexpr (kIsBf16<T>) {
      win[at + 2 * i] = __ushort_as_bfloat16((unsigned short)(w & 0xffffu));
      win[at + 2 * i + 1] = __ushort_as_bfloat16((unsigned short)(w >> 16));
    } else {
      win[at + i] = __uint_as_float(w);
    }
  }
}

// the 16 / sizeof(T) elements acc[at ..] as one 16-byte word
template <typename T, int N>
__device__ __forceinline__ uint4 pack(const T (&acc)[N], int at) {
  unsigned w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (kIsBf16<T>) {
      w[i] = (unsigned)__bfloat16_as_ushort(acc[at + 2 * i]) |
             ((unsigned)__bfloat16_as_ushort(acc[at + 2 * i + 1]) << 16);
    } else {
      w[i] = __float_as_uint(acc[at + i]);
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// K5a's run: 32 bytes, but kWideRun points past the narrow window
template <typename T, int R>
__host__ __device__ constexpr int naive_run() {
  return R > kNarrowR ? kWideRun : 32 / sizeof(T);
}

// K5b's column groups a warp: two for runs up to 8 rows, one for 16
__host__ __device__ constexpr int transpose_groups(int e) { return e <= 8 ? 2 : 1; }

template <typename T, int R>
__global__ void __launch_bounds__(kThreads)
onestep_naive(const T* __restrict__ x, T* __restrict__ y, int64_t n, int r, int aligned,
              const __grid_constant__ Taps taps) {
  constexpr int V = 16 / sizeof(T);   // elements a 16-byte word
  constexpr int E = naive_run<T, R>();
  constexpr int W = E / V;            // 16-byte words a run
  const int lane = threadIdx.x & 31;
  const int64_t k0 = ((int64_t)blockIdx.x * kThreads + threadIdx.x) * E;
  const bool whole = aligned && k0 + E <= n;
  T win[1][E + 2 * R];
  if (whole) {
    const uint4* p = reinterpret_cast<const uint4*>(x + k0);
#pragma unroll
    for (int w = 0; w < W; ++w) unpack<T>(p[w], win[0], R + w * V);
  } else {   // past the end (every lane still shuffles) or unaligned
#pragma unroll
    for (int i = 0; i < E; ++i) win[0][R + i] = x[wrap(k0 + i, n)];
  }
  // halo point q of each side: run element E-1-q%E (q%E) of the lane
  // d = 1 + q/E before (after); the d lanes at the warp's edge load it
#pragma unroll
  for (int q = 0; q < R; ++q) {
    if (q < r) {
      const int d = 1 + q / E;
      T left = shuffle(win[0][R + E - 1 - q % E], (lane - d) & 31);
      T right = shuffle(win[0][R + q % E], (lane + d) & 31);
      if (lane < d) left = x[wrap(k0 - 1 - q, n)];
      if (lane >= 32 - d) right = x[wrap(k0 + E + q, n)];
      win[0][R - 1 - q] = left;
      win[0][R + E + q] = right;
    }
  }
  T acc[1][E];
  step<T, 1, E, R>(acc, win, taps);
  if (whole) {
    uint4* p = reinterpret_cast<uint4*>(y + k0);
#pragma unroll
    for (int w = 0; w < W; ++w) p[w] = pack<T>(acc[0], w * V);
  } else {
#pragma unroll
    for (int i = 0; i < E; ++i)
      if (k0 + i < n) y[k0 + i] = acc[0][i];
  }
}

// K5a past the windows (kMaxR < r <= kLaneR), and past the narrow one at up
// to kLaneTaps taps (bfloat16: the middle one): lane L of a warp holds point
// L of kLaneRun consecutive vectors of 32 points and of the vector before
// and after them.  Tap o is one shuffle a vector from lane (L + o) & 31,
// which sends its neighbouring vector's point where the shift crosses into
// it (lanes below o for o > 0, from 32 + o up for o < 0): no switch, the
// offset a run-time lane.
template <typename T>
__global__ void __launch_bounds__(kThreads)
onestep_naive_lane(const T* __restrict__ x, T* __restrict__ y, int64_t n,
                   const __grid_constant__ Taps taps) {
  const int lane = threadIdx.x & 31;
  const int64_t warp = ((int64_t)blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int64_t base = warp * (32 * kLaneRun) + lane;
  // v[i + 1] is vector i of the run; v[0] and v[kLaneRun + 1] its neighbours
  T v[kLaneRun + 2];
#pragma unroll
  for (int i = 0; i < kLaneRun + 2; ++i) v[i] = x[wrap(base + (int64_t)(i - 1) * 32, n)];
  T acc[kLaneRun];
  for (int t = 0; t < taps.n; ++t) {
    const int o = taps.o[t];
    const T cf = from_f<T>(taps.c[t]);
    const int src = (lane + o) & 31;
    const int side = o > 0 ? (lane < o) : -(lane >= 32 + o);   // the vector this lane sends
#pragma unroll
    for (int i = 0; i < kLaneRun; ++i) {
      const T sent = side > 0 ? v[i + 2] : side < 0 ? v[i] : v[i + 1];
      const T term = mul(shuffle(sent, src), cf);
      acc[i] = t == 0 ? term : add(acc[i], term);
    }
  }
#pragma unroll
  for (int i = 0; i < kLaneRun; ++i) {
    const int64_t e = base + (int64_t)i * 32;
    if (e < n) y[e] = acc[i];
  }
}

// ---------------------------------------------------------------------------
// K5b: transpose layout
// ---------------------------------------------------------------------------

// A warp takes one run of rows of P column groups of 32 (columns 32 * (P *
// group + p) + lane): the taps' switch serves P runs.  vl_shift: log2(vl)
// when vl is a power of two, else -1.
template <typename T, int E, int R, int P>
__global__ void __launch_bounds__(kThreads)
onestep_transpose(const T* __restrict__ in, T* __restrict__ out, int64_t nb, int m, int vl,
                  int vl_shift, int r, const __grid_constant__ Taps taps) {
  const int lane = threadIdx.x & 31;
  const int64_t warp = ((int64_t)blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int g = m / E;                                  // runs a column
  const int64_t group = g == 1 ? warp : divide(warp, g);
  const int s0 = (int)(warp - group * g) * E;           // the run's first row
  const int64_t ncols = nb * vl;
  const int64_t c0 = group * P * 32 + lane;
  if (c0 >= ncols) return;
  const int64_t block = (int64_t)m * vl;
  int64_t at[P];
  T win[P][E + 2 * R];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    int64_t c = c0 + p * 32;
    if (c >= ncols) c = c0;        // computed, never stored
    const int64_t b = vl_shift >= 0 ? c >> vl_shift : divide(c, vl);
    const int j = (int)(c - b * vl);
    // row 0 of column c and of the columns beside it (wrapped mod ncols)
    at[p] = b * block + j;
    const int64_t left = j > 0 ? at[p] - 1 : (b > 0 ? b - 1 : nb - 1) * block + vl - 1;
    const int64_t right = j < vl - 1 ? at[p] + 1 : (b < nb - 1 ? b + 1 : 0) * block;
#pragma unroll
    for (int i = 0; i < E; ++i) win[p][R + i] = in[at[p] + (int64_t)(s0 + i) * vl];
#pragma unroll
    for (int q = 0; q < R; ++q) {
      if (q < r) {
        const int wl = s0 - 1 - q, wr = s0 + E + q;   // rows of column c, or beyond it
        win[p][R - 1 - q] =
            in[wl >= 0 ? at[p] + (int64_t)wl * vl : left + (int64_t)(wl + m) * vl];
        win[p][R + E + q] =
            in[wr < m ? at[p] + (int64_t)wr * vl : right + (int64_t)(wr - m) * vl];
      }
    }
  }
  T acc[P][E];
  step<T, P, E, R>(acc, win, taps);
#pragma unroll
  for (int p = 0; p < P; ++p) {
    if (c0 + p * 32 < ncols) {
#pragma unroll
      for (int i = 0; i < E; ++i) out[at[p] + (int64_t)(s0 + i) * vl] = acc[p][i];
    }
  }
}

// ---------------------------------------------------------------------------
// The "mem" forms: one thread per element, tap t an int2 (offset, float
// bits of the coefficient rounded to T) in device memory, any count.
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
onestep_naive_mem(const T* __restrict__ x, T* __restrict__ y, int64_t n, int ntaps,
                  const int2* __restrict__ taps) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float acc = 0.0f;
  for (int t = 0; t < ntaps; ++t) {
    const int2 tp = taps[t];
    const float term = rnd<T>(to_f(x[wrap(e + tp.x, n)]) * __int_as_float(tp.y));
    acc = t == 0 ? term : rnd<T>(acc + term);
  }
  y[e] = from_f<T>(acc);
}

// Element (b, s, j) of the layout: tap o reads row s + o of the same
// column, or of the column beside it (|o| <= r <= m): the block and lane of
// that column step by one, wrapping across blocks and around the row.
template <typename T>
__global__ void __launch_bounds__(kThreads)
onestep_transpose_mem(const T* __restrict__ in, T* __restrict__ out, int64_t nb, int vl, int m,
                      int ntaps, const int2* __restrict__ taps) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= nb * m * vl) return;
  const int64_t row = e / vl;                    // b * m + s
  const int64_t b = row / m;
  const int s = (int)(row - b * m);
  const int j = (int)(e - row * vl);
  float acc = 0.0f;
  for (int t = 0; t < ntaps; ++t) {
    const int2 tp = taps[t];
    int s2 = s + tp.x, j2 = j;
    int64_t b2 = b;
    if (s2 < 0 || s2 >= m) {
      const int dc = s2 < 0 ? -1 : 1;
      s2 -= dc * m;
      j2 += dc;
      if (j2 < 0) {
        j2 += vl;
        b2 = b2 == 0 ? nb - 1 : b2 - 1;
      } else if (j2 >= vl) {
        j2 -= vl;
        b2 = b2 == nb - 1 ? 0 : b2 + 1;
      }
    }
    const float term = rnd<T>(to_f(in[(b2 * m + s2) * vl + j2]) * __int_as_float(tp.y));
    acc = t == 0 ? term : rnd<T>(acc + term);
  }
  out[e] = from_f<T>(acc);
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

// The taps into `taps` and their largest |offset| into `reach`; false past
// kMaxTaps or past an |offset| of `limit`.
bool fill_taps(Taps& taps, int64_t ntaps, const int32_t* offsets, const float* coeffs,
               int limit, int& reach) {
  if (ntaps < 1 || ntaps > kMaxTaps) return false;
  reach = 0;
  taps.n = (int)ntaps;
  for (int t = 0; t < ntaps; ++t) {
    const int o = offsets[t];
    if (o < -limit || o > limit) return false;
    reach = o < 0 ? (-o > reach ? -o : reach) : (o > reach ? o : reach);
    taps.o[t] = o;
    taps.c[t] = coeffs[t];
  }
  return true;
}

template <typename T, int R>
int launch_naive(const T* x, T* y, int64_t n, int r, int aligned, const Taps& taps,
                 cudaStream_t stream) {
  constexpr int64_t per_block = (int64_t)kThreads * naive_run<T, R>();   // points a CTA
  const int64_t blocks = (n + per_block - 1) / per_block;
  onestep_naive<T, R><<<(unsigned)blocks, kThreads, 0, stream>>>(x, y, n, r, aligned, taps);
  return (int)cudaGetLastError();
}

template <typename T, int E, int R>
int launch_transpose(const T* in, T* out, int64_t nb, int64_t m, int64_t vl, int r,
                     const Taps& taps, cudaStream_t stream) {
  constexpr int P = transpose_groups(E);
  const int64_t warps = (nb * vl + 32 * P - 1) / (32 * P) * (m / E);
  const int64_t blocks = (warps * 32 + kThreads - 1) / kThreads;
  const int shift = (vl & (vl - 1)) == 0 ? __builtin_ctzll((unsigned long long)vl) : -1;
  onestep_transpose<T, E, R, P><<<(unsigned)blocks, kThreads, 0, stream>>>(
      in, out, nb, (int)m, (int)vl, shift, r, taps);
  return (int)cudaGetLastError();
}

template <typename T, int E>
int launch_transpose_r(const T* in, T* out, int64_t nb, int64_t m, int64_t vl, int r,
                       const Taps& taps, cudaStream_t stream) {
  if (r <= kNarrowR) return launch_transpose<T, E, kNarrowR>(in, out, nb, m, vl, r, taps, stream);
  if (r <= kMidR) return launch_transpose<T, E, kMidR>(in, out, nb, m, vl, r, taps, stream);
  return launch_transpose<T, E, kMaxR>(in, out, nb, m, vl, r, taps, stream);
}

// One periodic step of the natural-layout array `x` (n elements) into `y`,
// every |offset| <= kLaneR.  `offsets` / `coeffs`: ntaps tap offsets and
// coefficients (rounded to T, as floats) in host memory.  Returns the CUDA
// error code.
template <typename T>
int naive(const void* x, void* y, int64_t n, int64_t ntaps, const int32_t* offsets,
          const float* coeffs, void* stream) {
  Taps taps;
  int r = 0;
  if (n < 1 || !fill_taps(taps, ntaps, offsets, coeffs, kLaneR, r))
    return (int)cudaErrorInvalidValue;
  const T* src = static_cast<const T*>(x);
  T* dst = static_cast<T*>(y);
  const int aligned = ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) & 15) == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (r <= kNarrowR) return launch_naive<T, kNarrowR>(src, dst, n, r, aligned, taps, st);
  // past the narrow window a few taps take the lane form, but bfloat16's middle window
  const bool lane = taps.n <= kLaneTaps && !(kIsBf16<T> && r <= kMidR);
  if (r <= kMidR && !lane) return launch_naive<T, kMidR>(src, dst, n, r, aligned, taps, st);
  if (r <= kMaxR && !lane) return launch_naive<T, kMaxR>(src, dst, n, r, aligned, taps, st);
  const int64_t warps = (n + 32 * kLaneRun - 1) / (32 * kLaneRun);   // a run a warp
  const int64_t blocks = (warps * 32 + kThreads - 1) / kThreads;
  onestep_naive_lane<T><<<(unsigned)blocks, kThreads, 0, st>>>(src, dst, n, taps);
  return (int)cudaGetLastError();
}

// One periodic step of the (nb, m, vl) layout array `in` into `out`, for a
// stencil whose every |offset| is at most r <= min(m, kMaxR).  Returns the
// CUDA error code.
template <typename T>
int transpose(const void* in, void* out, int64_t nb, int64_t m, int64_t vl, int64_t r,
              int64_t ntaps, const int32_t* offsets, const float* coeffs, void* stream) {
  Taps taps;
  int reach = 0;
  if (nb < 1 || vl < 1 || m < 1 || r < 0 || m < r || r > kMaxR || m > INT32_MAX ||
      vl > INT32_MAX || !fill_taps(taps, ntaps, offsets, coeffs, (int)r, reach))
    return (int)cudaErrorInvalidValue;
  const int rr = (int)r;
  const T* src = static_cast<const T*>(in);
  T* dst = static_cast<T*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (m % 16 == 0) return launch_transpose_r<T, 16>(src, dst, nb, m, vl, rr, taps, st);
  int e = kMaxRun;   // a run: the most rows up to kMaxRun that divide m
  while (m % e) --e;
  switch (e) {
    case 8: return launch_transpose_r<T, 8>(src, dst, nb, m, vl, rr, taps, st);
    case 7: return launch_transpose_r<T, 7>(src, dst, nb, m, vl, rr, taps, st);
    case 6: return launch_transpose_r<T, 6>(src, dst, nb, m, vl, rr, taps, st);
    case 5: return launch_transpose_r<T, 5>(src, dst, nb, m, vl, rr, taps, st);
    case 4: return launch_transpose_r<T, 4>(src, dst, nb, m, vl, rr, taps, st);
    case 3: return launch_transpose_r<T, 3>(src, dst, nb, m, vl, rr, taps, st);
    case 2: return launch_transpose_r<T, 2>(src, dst, nb, m, vl, rr, taps, st);
    default: return launch_transpose_r<T, 1>(src, dst, nb, m, vl, rr, taps, st);
  }
}

// The "mem" forms (above) of the natural-layout step (n elements) and of
// the layout step ((nb, m, vl), any m, every |offset| <= m): `taps` ntaps
// int2 (offset, coefficient bits) in device memory.  Returns the CUDA
// error code.
template <typename T>
int naive_mem(const void* x, void* y, int64_t n, int64_t ntaps, const void* taps, void* stream) {
  if (n < 1 || ntaps < 1) return (int)cudaErrorInvalidValue;
  onestep_naive_mem<T><<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<T*>(y), n, (int)ntaps,
      static_cast<const int2*>(taps));
  return (int)cudaGetLastError();
}

template <typename T>
int transpose_mem(const void* in, void* out, int64_t nb, int64_t m, int64_t vl, int64_t ntaps,
                  const void* taps, void* stream) {
  if (nb < 1 || m < 1 || vl < 1 || ntaps < 1) return (int)cudaErrorInvalidValue;
  const int64_t n = nb * m * vl;
  onestep_transpose_mem<T><<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(in), static_cast<T*>(out), nb, (int)vl, (int)m, (int)ntaps,
      static_cast<const int2*>(taps));
  return (int)cudaGetLastError();
}

}  // namespace

// the register forms' limits (stencil_kernels.ONESTEP_*)
extern "C" int64_t repro_onestep_max_reach() { return kMaxR; }
extern "C" int64_t repro_onestep_naive_max_reach() { return kLaneR; }
extern "C" int64_t repro_onestep_lane_taps() { return kLaneTaps; }
extern "C" int64_t repro_onestep_max_taps() { return kMaxTaps; }

// naive / transpose (above) on float and on bfloat16 elements.
extern "C" int repro_onestep_naive_f32(const void* x, void* y, int64_t n, int64_t ntaps,
                                       const int32_t* offsets, const float* coeffs,
                                       void* stream) {
  return naive<float>(x, y, n, ntaps, offsets, coeffs, stream);
}

extern "C" int repro_onestep_naive_bf16(const void* x, void* y, int64_t n, int64_t ntaps,
                                        const int32_t* offsets, const float* coeffs,
                                        void* stream) {
  return naive<__nv_bfloat16>(x, y, n, ntaps, offsets, coeffs, stream);
}

extern "C" int repro_onestep_transpose_f32(const void* in, void* out, int64_t nb,
                                           int64_t m, int64_t vl, int64_t r, int64_t ntaps,
                                           const int32_t* offsets, const float* coeffs,
                                           void* stream) {
  return transpose<float>(in, out, nb, m, vl, r, ntaps, offsets, coeffs, stream);
}

extern "C" int repro_onestep_transpose_bf16(const void* in, void* out, int64_t nb,
                                            int64_t m, int64_t vl, int64_t r, int64_t ntaps,
                                            const int32_t* offsets, const float* coeffs,
                                            void* stream) {
  return transpose<__nv_bfloat16>(in, out, nb, m, vl, r, ntaps, offsets, coeffs, stream);
}

// naive_mem / transpose_mem (above) on float and on bfloat16 elements.
extern "C" int repro_onestep_naive_mem_f32(const void* x, void* y, int64_t n, int64_t ntaps,
                                           const void* taps, void* stream) {
  return naive_mem<float>(x, y, n, ntaps, taps, stream);
}

extern "C" int repro_onestep_naive_mem_bf16(const void* x, void* y, int64_t n, int64_t ntaps,
                                            const void* taps, void* stream) {
  return naive_mem<__nv_bfloat16>(x, y, n, ntaps, taps, stream);
}

extern "C" int repro_onestep_transpose_mem_f32(const void* in, void* out, int64_t nb, int64_t m,
                                               int64_t vl, int64_t ntaps, const void* taps,
                                               void* stream) {
  return transpose_mem<float>(in, out, nb, m, vl, ntaps, taps, stream);
}

extern "C" int repro_onestep_transpose_mem_bf16(const void* in, void* out, int64_t nb,
                                                int64_t m, int64_t vl, int64_t ntaps,
                                                const void* taps, void* stream) {
  return transpose_mem<__nv_bfloat16>(in, out, nb, m, vl, ntaps, taps, stream);
}
