// Throughput of mma.sync on one card: TF32 m16n8k8 and bf16 m16n8k16, 8
// independent accumulators a warp, 528 CTAs of 4, 8 or 16 warps, timed with
// CUDA events.  The rate that K6's products (csrc/ssd_scan.cu) can reach
// without wgmma.
//
//   mkdir -p build && nvcc -gencode arch=compute_90a,code=sm_90a -O3 \
//       -o build/mma_rate tools/mma_rate.cu && build/mma_rate
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

constexpr int kChains = 8;

template <bool kBf16>
__global__ void rate(float* out, int iters) {
  float d[kChains][4] = {};
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = kBf16 ? 0x3f803f80u + threadIdx.x : __float_as_uint(1.f + i);
  for (int i = 0; i < 2; ++i) b[i] = kBf16 ? 0x3f003f00u : __float_as_uint(0.5f + i);
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int c = 0; c < kChains; ++c) {
      if (kBf16)
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
            "{%8,%9}, {%0,%1,%2,%3};\n"
            : "+f"(d[c][0]), "+f"(d[c][1]), "+f"(d[c][2]), "+f"(d[c][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
      else
        asm volatile(
            "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
            "{%8,%9}, {%0,%1,%2,%3};\n"
            : "+f"(d[c][0]), "+f"(d[c][1]), "+f"(d[c][2]), "+f"(d[c][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
    }
  }
  float s = 0.f;
  for (int c = 0; c < kChains; ++c) s += d[c][0] + d[c][1] + d[c][2] + d[c][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

int main() {
  const int blocks = 528, iters = 4096;
  float* out;
  cudaMalloc(&out, blocks * 512 * sizeof(float));
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  for (int warps : {4, 8, 16}) {
    for (int bf16 = 0; bf16 < 2; ++bf16) {
      auto run = [&]() {
        if (bf16) rate<true><<<blocks, 32 * warps>>>(out, iters);
        else rate<false><<<blocks, 32 * warps>>>(out, iters);
      };
      run();
      cudaEventRecord(e0);
      run();
      cudaEventRecord(e1);
      cudaEventSynchronize(e1);
      float ms = 0.f;
      cudaEventElapsedTime(&ms, e0, e1);
      const double flop = 2.0 * 16 * 8 * (bf16 ? 16 : 8) * kChains * iters * (double)blocks * warps;
      printf("%s, %d warps a CTA: %.3f ms, %.1f TFLOP/s\n",
             bf16 ? "bf16 m16n8k16" : "tf32 m16n8k8", warps, ms, flop / ms / 1e9);
    }
  }
  return cudaGetLastError() != cudaSuccess;
}
