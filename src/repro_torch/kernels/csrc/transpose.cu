// Batched small-matrix transpose: the move into and out of the paper's local
// transpose layout.
//
// Replaces: src/repro/kernels/stencil_kernels.py::_kernel_transpose, launched
// by block_transpose (N,) -> (nb, m, vl) and block_untranspose (nb, m, vl) ->
// (N,).  Here one kernel serves the 1-D and the n-D drivers: the layout of
// (..., N) is the per-block transpose of the flattened array, so both are a
// (B, rows, cols) -> (B, cols, rows) transpose with B = prod(lead) * nb.
//
// Bound on H100: bytes.  It reads each element once and writes it once and
// does no arithmetic, so its least time is 2 * numel * itemsize over the
// card's memory rate.
//
// Design: each CTA owns a contiguous run of whole matrices (about 4096
// elements).  It reads the run in input order (neighbouring threads on
// neighbouring addresses), parks it in shared memory with each row padded
// to an odd pitch (so the column-wise reads of the second phase hit 32
// distinct banks), and writes the run in output order, again contiguous.
// Every element crosses device memory once each way.  The kernel is generic
// in the element size (2, 4 or 8 bytes): a transpose moves bits.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTargetElems = 4096;   // elements parked per CTA

template <typename T>
__global__ void batched_transpose(const T* __restrict__ in, T* __restrict__ out,
                                  int64_t batch, int rows, int cols,
                                  int per_cta, int pitch) {
  extern __shared__ unsigned char smem_raw[];
  T* tile = reinterpret_cast<T*>(smem_raw);
  const int mat = rows * cols;
  const int64_t first = (int64_t)blockIdx.x * per_cta;
  const int64_t left = batch - first;
  const int nmat = left < per_cta ? (int)left : per_cta;
  const int n = nmat * mat;
  const T* src = in + first * mat;
  T* dst = out + first * mat;
  // phase 1: input order, element (b, i, j) of (B, rows, cols)
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int b = e / mat;
    const int w = e - b * mat;
    const int i = w / cols;
    const int j = w - i * cols;
    tile[(b * rows + i) * pitch + j] = src[e];
  }
  __syncthreads();
  // phase 2: output order, element (b, j, i) of (B, cols, rows)
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int b = e / mat;
    const int w = e - b * mat;
    const int j = w / rows;
    const int i = w - j * rows;
    dst[e] = tile[(b * rows + i) * pitch + j];
  }
}

template <typename T>
int launch(const void* in, void* out, int64_t batch, int64_t rows, int64_t cols,
           cudaStream_t stream) {
  const int mat = (int)(rows * cols);
  const int per_cta = mat >= kTargetElems ? 1 : kTargetElems / mat;
  const int pitch = (int)(cols | 1);
  const size_t smem = (size_t)per_cta * rows * pitch * sizeof(T);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        batched_transpose<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int64_t grid = (batch + per_cta - 1) / per_cta;
  batched_transpose<T><<<(unsigned)grid, kThreads, smem, stream>>>(
      static_cast<const T*>(in), static_cast<T*>(out), batch, (int)rows,
      (int)cols, per_cta, pitch);
  return (int)cudaGetLastError();
}

}  // namespace

// Shared memory, in bytes, that one launch parks per CTA (the wrapper checks
// it against the card's limit before launching).
extern "C" int64_t repro_transpose_smem_bytes(int64_t rows, int64_t cols,
                                              int64_t elem_size) {
  const int64_t mat = rows * cols;
  const int64_t per_cta = mat >= kTargetElems ? 1 : kTargetElems / mat;
  return per_cta * rows * (cols | 1) * elem_size;
}

// (batch, rows, cols) -> (batch, cols, rows), both contiguous, on `stream`.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int repro_transpose(const void* in, void* out, int64_t batch,
                               int64_t rows, int64_t cols, int64_t elem_size,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (elem_size) {
    case 2: return launch<uint16_t>(in, out, batch, rows, cols, s);
    case 4: return launch<uint32_t>(in, out, batch, rows, cols, s);
    case 8: return launch<uint64_t>(in, out, batch, rows, cols, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
