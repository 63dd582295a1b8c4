// The element types of the stencil kernels (sweep_far.cu, onestep.cu,
// sweep1d_warp.cuh, sweep2d_warp.cuh, sweep3d.cuh): float and __nv_bfloat16.
//
// The plain versions compute in the tensor's dtype: each product of a value
// and a coefficient (already rounded to the dtype) and each partial sum is
// rounded to it (src/repro/kernels/stencil_kernels.py::_tap_sum_1d: term =
// sl * c; acc = acc + term).  The register kernels do the same in the
// element type itself: mul() and add() below are one multiply and one add,
// each rounded once (mul.rn.bf16 / add.rn.bf16 on sm_90: .rn also keeps
// ptxas from fusing them), and the plain versions' float32 product and sum
// rounded to bfloat16 are bit for bit the same (a product of two bfloat16
// values is exact in float32, and rounding a float32 sum of two bfloat16
// values equals rounding the exact sum: 24 >= 2 * 8 + 2 bits).  Registers,
// shuffles and shared memory hold the element type, so bfloat16 costs the
// kernels no conversion (a first form kept float registers and rounded
// every product and sum with cvt.rn.bf16.f32, which runs at a quarter of
// the FP32 rate: the 2-D sweep at depth 4 took 0.99 ms against float32's
// 0.21; PERF.md section 6).  The far-reach kernel (sweep_far.cu) holds
// the element type in shared memory and registers and computes with mul()
// and add() too, as do the one-step kernels' register forms (onestep.cu);
// only their memory-tap forms keep float registers and round with rnd().
//
// cp.async moves 4, 8 or 16 bytes, so the kernels that stage device memory
// in shared memory with it (sweep2d_warp, sweep3d) copy a bfloat16 element
// as the aligned 4-byte word that holds it: the word never crosses a page,
// the other half is discarded, and the shared-memory ring keeps 4 bytes an
// element as for float.  word_parity() says which half is the element's,
// word_elem() takes it, and ld_word() / st_word() read and write an element
// kept in the low half of its word.  shuffle() is the warp kernels' one
// element from another lane, in the element type.
#pragma once
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace {

template <typename T>
constexpr bool kIsBf16 = std::is_same<T, __nv_bfloat16>::value;

__device__ __forceinline__ float mul(float a, float b) { return a * b; }
__device__ __forceinline__ float add(float a, float b) { return a + b; }

__device__ __forceinline__ __nv_bfloat16 mul(__nv_bfloat16 a, __nv_bfloat16 b) {
  unsigned short r;
  asm("mul.rn.bf16 %0, %1, %2;"
      : "=h"(r)
      : "h"(__bfloat16_as_ushort(a)), "h"(__bfloat16_as_ushort(b)));
  return __ushort_as_bfloat16(r);
}

__device__ __forceinline__ __nv_bfloat16 add(__nv_bfloat16 a, __nv_bfloat16 b) {
  unsigned short r;
  asm("add.rn.bf16 %0, %1, %2;"
      : "=h"(r)
      : "h"(__bfloat16_as_ushort(a)), "h"(__bfloat16_as_ushort(b)));
  return __ushort_as_bfloat16(r);
}

// 0 of the element type
template <typename T>
__device__ __forceinline__ T zero() {
  if constexpr (kIsBf16<T>) {
    return __ushort_as_bfloat16(0);
  } else {
    return 0.0f;
  }
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v) {
  if constexpr (kIsBf16<T>) {
    return __float2bfloat16_rn(v);
  } else {
    return v;
  }
}

// v rounded to T (to bfloat16 and back; float: v itself)
template <typename T>
__device__ __forceinline__ float rnd(float v) {
  return to_f(from_f<T>(v));
}

// A coefficient (a float already rounded to T) as T, on the host.
template <typename T>
inline T coeff_of(float c) {
  if constexpr (kIsBf16<T>) {
    return __float2bfloat16_rn(c);
  } else {
    return c;
  }
}

// The 4-byte word a cp.async copies for the element at p: p itself for
// float, the aligned word holding it for bfloat16.
template <typename T>
__device__ __forceinline__ const float* word_of(const T* p) {
  if constexpr (kIsBf16<T>) {
    return reinterpret_cast<const float*>(reinterpret_cast<uintptr_t>(p) & ~uintptr_t(3));
  } else {
    return p;
  }
}

// Which half of its word the bfloat16 element at p is (1: the high half).
template <typename T>
__device__ __forceinline__ unsigned word_parity(const T* p) {
  return (unsigned)(reinterpret_cast<uintptr_t>(p) >> 1) & 1u;
}

// The element in a copied word: the word itself for float, half `par` of
// it for bfloat16.
template <typename T>
__device__ __forceinline__ T word_elem(float word, unsigned par) {
  if constexpr (kIsBf16<T>) {
    const unsigned w = __float_as_uint(word);
    return __ushort_as_bfloat16((unsigned short)(par ? w >> 16 : w));
  } else {
    return word;
  }
}

// An element kept in the low half of a shared-memory word (all of it for
// float): read and written as T.
template <typename T>
__device__ __forceinline__ T ld_word(const float* p) {
  return *reinterpret_cast<const T*>(p);
}

template <typename T>
__device__ __forceinline__ void st_word(float* p, T v) {
  *reinterpret_cast<T*>(p) = v;
}

// One element from lane src of the full warp.  A bfloat16 moves as its 16
// bits in one word: the library's bfloat16 shuffle packs it into a pair
// first, and in the 1-D warp kernel at (M, r) = (1, 2) those packs put the
// slots in local memory (PERF.md section 6).
template <typename T>
__device__ __forceinline__ T shuffle(T v, int src) {
  if constexpr (kIsBf16<T>) {
    return __ushort_as_bfloat16(
        (unsigned short)__shfl_sync(0xffffffffu, (unsigned)__bfloat16_as_ushort(v), src));
  } else {
    return __shfl_sync(0xffffffffu, v, src);
  }
}

}  // namespace
