// One fully periodic step of a 1-D stencil, in the natural layout (K5a) and
// in the paper's transpose layout (K5b): the layout A/B of the paper, one
// launch per step each.
//
// Replaces: src/repro/kernels/stencil_kernels.py::_kernel_naive_1d (launched
// by stencil1d_naive_onestep, K5a) and ::_kernel_transpose_1d (launched by
// stencil1d_transpose_onestep, K5b).
//
// K5a, natural layout.  A warp's 32 lanes hold one vector of 32 consecutive
// elements; a thread keeps kVec such vectors of its warp's run in registers,
// plus the vector before and after it.  A shift by o crosses lanes: each tap
// of each vector takes two warp shuffles (this vector and its neighbour) and
// a select on the lanes that cross — the paper's cross-lane roll per tap.
// Any vl: the natural layout is the flat array whatever its row width.
// One neighbouring vector a side reaches |o| <= 32.
//
// K5b, transpose layout (nb, m, vl).  A thread holds the m values of one
// natural column (block c / vl, lane c % vl) in registers, and neighbouring
// threads hold neighbouring columns.  A shift by o within the column is a
// register index; only the 2r boundary rows need one shuffle from the
// neighbouring thread plus a select (the warp's first and last lane, whose
// neighbour lives in another warp, load it instead) — the paper's Assemble.
// The register version covers m <= 16 and r <= kMaxR.
//
// Past the register forms (more than kMaxTaps taps, K5a past |o| = 32, K5b
// past r = kMaxR or m = 16) each has a form that reads its taps from device
// memory (onestep_naive_mem, onestep_transpose_mem: any tap count and
// reach): one thread an element, every tap's element read from device
// memory, wrapped periodically (K5b: the column beside it found by a step
// of its block and lane, no division a tap).
//
// Taps are summed in the spec's order, one multiply and one add each, with
// the coefficients already rounded to the element type and each product and
// sum rounded to it (elem.cuh's rnd); built with -fmad=false both kernels
// are bit for bit their plain PyTorch versions.  Elements are float or
// bfloat16 in device memory (the _f32 and _bf16 entry points), float in
// registers: a step does a few operations an element, and in bfloat16 this
// form took 0.174-0.261 ms at 2^26 against 0.275-0.277 for bfloat16
// registers and arithmetic (PERF.md section 6).
//
// Bound on H100: bytes.  A step must read the array once and write it once
// (2 * N * sizeof(element) bytes); its arithmetic is 2*taps - 1 flops per point.  Both
// designs read each element from device memory once per warp (K5a also
// reads its two neighbouring vectors, K5b the neighbour columns of the two
// edge lanes, mostly from L1/L2).
#include <cuda_runtime.h>
#include <stdint.h>

#include "elem.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTaps = 16;   // the register forms' taps
constexpr int kMaxR = 4;       // K5b's register form: reach of a tap
constexpr int kMaxM = 16;      // K5b's register form: rows of a column
constexpr int kNaiveR = 32;    // K5a's register form: one neighbouring vector
constexpr int kVec = 8;        // K5a: vectors per warp run
constexpr unsigned kFull = 0xffffffffu;

struct Taps1 {
  int n;
  int o[kMaxTaps];
  float c[kMaxTaps];
};

__device__ __forceinline__ int64_t wrap(int64_t i, int64_t n) {
  if (i >= 0 && i < n) return i;
  const int64_t r = i % n;
  return r < 0 ? r + n : r;
}

// ---------------------------------------------------------------------------
// K5a: natural layout
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
onestep_naive(const T* __restrict__ x, T* __restrict__ y, int64_t n, Taps1 taps) {
  const int lane = threadIdx.x & 31;
  const int64_t warp = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int64_t base = warp * (32 * kVec) + lane;
  // v[i + 1] is vector i of the run; v[0] and v[kVec + 1] its neighbours
  float v[kVec + 2];
#pragma unroll
  for (int i = 0; i < kVec + 2; ++i) v[i] = to_f(x[wrap(base + (int64_t)(i - 1) * 32, n)]);
  float acc[kVec];
  for (int t = 0; t < taps.n; ++t) {
    const int o = taps.o[t];
    const float cf = taps.c[t];
    const int src = (lane + o) & 31;
    const bool cross = lane + o >= 32 || lane + o < 0;
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const float here = __shfl_sync(kFull, v[i + 1], src);
      const float next = __shfl_sync(kFull, o > 0 ? v[i + 2] : v[i], src);
      const float term = rnd<T>((cross ? next : here) * cf);
      acc[i] = t == 0 ? term : rnd<T>(acc[i] + term);
    }
  }
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    const int64_t e = base + (int64_t)i * 32;
    if (e < n) y[e] = from_f<T>(acc[i]);
  }
}

// ---------------------------------------------------------------------------
// K5b: transpose layout
// ---------------------------------------------------------------------------

// Address of row s of natural column c in the (nb, m, vl) layout.
__device__ __forceinline__ int64_t col_addr(int64_t c, int s, int vl, int m) {
  const int64_t b = c / vl;
  return (b * m + s) * vl + (c - b * vl);
}

// acc[s] (+)= ext[kMaxR + s + O] * cf for every row s: a register index,
// each product and sum rounded to T
template <typename T, int M, int O>
__device__ __forceinline__ void add_tap(float (&acc)[M], const float (&ext)[M + 2 * kMaxR],
                                        float cf, bool first) {
#pragma unroll
  for (int s = 0; s < M; ++s) {
    const float term = rnd<T>(ext[kMaxR + s + O] * cf);
    acc[s] = first ? term : rnd<T>(acc[s] + term);
  }
}

template <typename T, int M>
__global__ void __launch_bounds__(kThreads)
onestep_transpose(const T* __restrict__ in, T* __restrict__ out, int64_t ncols, int vl, int r,
                  Taps1 taps) {
  const int lane = threadIdx.x & 31;
  const int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = c < ncols;
  const int64_t cc = live ? c : ncols - 1;   // idle tail threads still shuffle
  // ext[kMaxR + s] is row s of the column; rows -q and M-1+q (q = 1..r)
  // are the Assembled rows of the neighbouring columns
  float ext[M + 2 * kMaxR] = {};
#pragma unroll
  for (int s = 0; s < M; ++s) ext[kMaxR + s] = to_f(in[col_addr(cc, s, vl, M)]);
#pragma unroll
  for (int q = 0; q < (M < kMaxR ? M : kMaxR); ++q) {
    if (q < r) {
      float left = __shfl_up_sync(kFull, ext[kMaxR + M - 1 - q], 1);
      float right = __shfl_down_sync(kFull, ext[kMaxR + q], 1);
      if (lane == 0) left = to_f(in[col_addr(wrap(cc - 1, ncols), M - 1 - q, vl, M)]);
      if (lane == 31 || c + 1 >= ncols)
        right = to_f(in[col_addr(wrap(cc + 1, ncols), q, vl, M)]);
      ext[kMaxR - 1 - q] = left;
      ext[kMaxR + M + q] = right;
    }
  }
  float acc[M];
  for (int t = 0; t < taps.n; ++t) {
    const float cf = taps.c[t];
    const bool first = t == 0;
    switch (taps.o[t]) {   // the same case on every thread: no divergence
      case -4: add_tap<T, M, -4>(acc, ext, cf, first); break;
      case -3: add_tap<T, M, -3>(acc, ext, cf, first); break;
      case -2: add_tap<T, M, -2>(acc, ext, cf, first); break;
      case -1: add_tap<T, M, -1>(acc, ext, cf, first); break;
      case 0: add_tap<T, M, 0>(acc, ext, cf, first); break;
      case 1: add_tap<T, M, 1>(acc, ext, cf, first); break;
      case 2: add_tap<T, M, 2>(acc, ext, cf, first); break;
      case 3: add_tap<T, M, 3>(acc, ext, cf, first); break;
      case 4: add_tap<T, M, 4>(acc, ext, cf, first); break;
      default: break;   // the wrapper checks |o| <= r <= kMaxR
    }
  }
  if (live) {
#pragma unroll
    for (int s = 0; s < M; ++s) out[col_addr(c, s, vl, M)] = from_f<T>(acc[s]);
  }
}

// The "mem" forms: one thread per element, tap t an int2 (offset, float
// bits of the coefficient rounded to T) in device memory, any count.
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

template <typename T, int M>
int launch_transpose(const T* in, T* out, int64_t ncols, int vl, int r, const Taps1& taps,
                     cudaStream_t stream) {
  const int64_t blocks = (ncols + kThreads - 1) / kThreads;
  onestep_transpose<T, M><<<(unsigned)blocks, kThreads, 0, stream>>>(in, out, ncols, vl, r,
                                                                      taps);
  return (int)cudaGetLastError();
}

bool fill_taps(Taps1& taps, int64_t ntaps, const int32_t* offsets, const float* coeffs,
               int reach) {
  if (ntaps < 1 || ntaps > kMaxTaps) return false;
  taps.n = (int)ntaps;
  for (int t = 0; t < ntaps; ++t) {
    if (offsets[t] < -reach || offsets[t] > reach) return false;
    taps.o[t] = offsets[t];
    taps.c[t] = coeffs[t];
  }
  return true;
}

// One periodic step of the natural-layout array `x` (n elements) into `y`.
// `offsets` / `coeffs`: ntaps tap offsets and coefficients (rounded to T,
// as floats) in host memory.  Returns the CUDA error code.
template <typename T>
int naive(const void* x, void* y, int64_t n, int64_t ntaps, const int32_t* offsets,
          const float* coeffs, void* stream) {
  Taps1 taps;
  if (n < 1 || !fill_taps(taps, ntaps, offsets, coeffs, kNaiveR))
    return (int)cudaErrorInvalidValue;
  const int64_t per_block = (int64_t)kThreads * kVec;   // elements per CTA
  const int64_t blocks = (n + per_block - 1) / per_block;
  onestep_naive<T><<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<T*>(y), n, taps);
  return (int)cudaGetLastError();
}

// One periodic step of the (nb, m, vl) layout array `in` into `out`, for a
// stencil of reach r <= min(m, kMaxR) at m <= kMaxM.  Returns the CUDA
// error code.
template <typename T>
int transpose(const void* in, void* out, int64_t nb, int64_t m, int64_t vl, int64_t r,
              int64_t ntaps, const int32_t* offsets, const float* coeffs, void* stream) {
  Taps1 taps;
  if (nb < 1 || m < r || r > kMaxR || !fill_taps(taps, ntaps, offsets, coeffs, kMaxR))
    return (int)cudaErrorInvalidValue;
  const T* src = static_cast<const T*>(in);
  T* dst = static_cast<T*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t ncols = nb * vl;
  const int v = (int)vl, rr = (int)r;
  switch (m) {
    case 1: return launch_transpose<T, 1>(src, dst, ncols, v, rr, taps, st);
    case 2: return launch_transpose<T, 2>(src, dst, ncols, v, rr, taps, st);
    case 3: return launch_transpose<T, 3>(src, dst, ncols, v, rr, taps, st);
    case 4: return launch_transpose<T, 4>(src, dst, ncols, v, rr, taps, st);
    case 5: return launch_transpose<T, 5>(src, dst, ncols, v, rr, taps, st);
    case 6: return launch_transpose<T, 6>(src, dst, ncols, v, rr, taps, st);
    case 7: return launch_transpose<T, 7>(src, dst, ncols, v, rr, taps, st);
    case 8: return launch_transpose<T, 8>(src, dst, ncols, v, rr, taps, st);
    case 9: return launch_transpose<T, 9>(src, dst, ncols, v, rr, taps, st);
    case 10: return launch_transpose<T, 10>(src, dst, ncols, v, rr, taps, st);
    case 11: return launch_transpose<T, 11>(src, dst, ncols, v, rr, taps, st);
    case 12: return launch_transpose<T, 12>(src, dst, ncols, v, rr, taps, st);
    case 13: return launch_transpose<T, 13>(src, dst, ncols, v, rr, taps, st);
    case 14: return launch_transpose<T, 14>(src, dst, ncols, v, rr, taps, st);
    case 15: return launch_transpose<T, 15>(src, dst, ncols, v, rr, taps, st);
    case 16: return launch_transpose<T, 16>(src, dst, ncols, v, rr, taps, st);
    default: return (int)cudaErrorInvalidValue;
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
extern "C" int64_t repro_onestep_naive_max_reach() { return kNaiveR; }
extern "C" int64_t repro_onestep_max_taps() { return kMaxTaps; }
extern "C" int64_t repro_onestep_max_m() { return kMaxM; }

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
