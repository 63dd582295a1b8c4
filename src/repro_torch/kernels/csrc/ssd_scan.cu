// Mamba2 SSD chunk scan (state-space duality): y = y_intra + y_inter of one
// SSD layer, and the state carried from chunk to chunk.
//
// Replaces: src/repro/kernels/ssd_kernel.py::_kernel, launched by
// ssd_chunk_scan.  Per chunk of Q tokens it computes, for every (batch, head):
//   cs      = inclusive cumsum over the chunk of dt * a              (Q)
//   att     = (C B^T) * exp(cs[q] - cs[t]) * dt[t] for t <= q, else 0 (Q, Q)
//   y       = att x + (C h^T) * exp(cs[q])                           (Q, P)
//   h       = h * exp(cs[Q-1]) + B^T (x * dt * exp(cs[Q-1] - cs))    (P, N)
// with h in float32, zero before the first chunk.
//
// Bound on H100: FP32 operations.  Per (batch, head, chunk) the work is
// 2 (Q^2 N + Q^2 P + 2 Q N P) operations against Q (2P + 2N + 1) values
// moved, about 65 operations per byte at Q = 128, P = 64, N = 128 (the
// card's FP32 balance is 20).
//
// Design: the Pallas grid walks the chunks in order and keeps h in VMEM
// scratch.  CUDA blocks run in no order, so here one CTA owns one (batch,
// head, 16-column tile of P) and loops over the chunks itself, h's 16 rows
// in shared memory.  Rows of h for different columns of P never mix, so no
// CTA waits on another.  A chunk's B and C (transposed, odd pitch), its
// masked Q x Q attention, the CTA's x columns and h fit one CTA's shared
// memory at Q = N = 128 (216 KB); the Q x Q block is recomputed by each
// P tile.  Inputs are read through element strides, so a stride of 0 on
// the head axis (B and C shared by every head of a group) costs no copy.
// x and y are float32 or bfloat16; everything is computed in float32.  The
// decay is evaluated only where t <= q: for t > q the exponent is positive
// and may overflow.  Products are summed with explicit fmaf (the build
// passes -fmad=false, which keeps the stencil kernels bitwise).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kGrid = 16;          // the Q x Q block is a 16 x 16 thread grid
constexpr int kPT = 16;            // columns of P per CTA
constexpr int kMaxQT = 8;          // rows per thread: Q <= 128
constexpr int kMaxNT = 8;          // state columns per thread: N <= 128
constexpr int kUnroll = 8;         // loads in flight per thread

struct Geom {
  int64_t sx[5], sb[5], sc[5], sd[4], sy[5];   // element strides
  int nc, nb, q, nh, p, n, ldq, ldn;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);   // round to nearest even, as astype(bfloat16)
}

int64_t smem_floats(int64_t q, int64_t n) {
  const int64_t qp = (q + kGrid - 1) / kGrid * kGrid;
  const int64_t ldq = qp + 1, ldn = n | 1;
  return 2 * n * ldq + qp * ldq + qp * kPT + kPT * ldn + 3 * qp;
}

template <typename T, int QT>
__global__ void __launch_bounds__(kThreads, 1)
ssd_scan(const T* __restrict__ x, const float* __restrict__ bm,
         const float* __restrict__ cm, const float* __restrict__ dt,
         const float* __restrict__ a_neg, T* __restrict__ y,
         float* __restrict__ hout, const Geom g) {
  constexpr int QP = QT * kGrid;   // chunk rows padded to the thread grid
  extern __shared__ float sm[];
  const int N = g.n, Q = g.q, ldq = g.ldq, ldn = g.ldn;
  float* bT = sm;                  // (N, ldq)   B of the chunk, transposed
  float* cT = bT + N * ldq;        // (N, ldq)   C, transposed
  float* att = cT + N * ldq;       // (QP, ldq)  masked decay attention
  float* xs = att + QP * ldq;      // (QP, kPT)  this CTA's columns of x
  float* hs = xs + QP * kPT;       // (kPT, ldn) this CTA's rows of h
  float* dts = hs + kPT * ldn;     // (QP)       dt
  float* cs = dts + QP;            // (QP)       inclusive cumsum of dt * a
  float* ws = cs + QP;             // (QP)       dt * exp(cs[Q-1] - cs)

  const int tiles = (g.p + kPT - 1) / kPT;
  const int tile = blockIdx.x % tiles;
  const int hh = (blockIdx.x / tiles) % g.nh;
  const int bb = blockIdx.x / (tiles * g.nh);
  const int p0 = tile * kPT;
  const int pw = min(kPT, g.p - p0);
  const float an = a_neg[hh];
  const int tid = threadIdx.x;

  for (int e = tid; e < kPT * ldn; e += kThreads) hs[e] = 0.f;

  for (int c = 0; c < g.nc; ++c) {
    // ---- the chunk into shared memory (rows t >= Q are zeros) ----------
    const int64_t b0 = c * g.sb[0] + bb * g.sb[1] + hh * g.sb[3];
    const int64_t c0 = c * g.sc[0] + bb * g.sc[1] + hh * g.sc[3];
    const int64_t x0 = c * g.sx[0] + bb * g.sx[1] + hh * g.sx[3] + p0 * g.sx[4];
    const int64_t d0 = c * g.sd[0] + bb * g.sd[1] + hh * g.sd[3];
    const int64_t y0 = c * g.sy[0] + bb * g.sy[1] + hh * g.sy[3] + p0 * g.sy[4];
    const int total = QP * N;
    for (int e0 = tid; e0 < total; e0 += kThreads * kUnroll) {
      float vb[kUnroll], vc[kUnroll];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const int e = e0 + k * kThreads;
        const int t = e / N, nn = e - t * N;
        const bool ok = e < total && t < Q;
        vb[k] = ok ? bm[b0 + t * g.sb[2] + nn * g.sb[4]] : 0.f;
        vc[k] = ok ? cm[c0 + t * g.sc[2] + nn * g.sc[4]] : 0.f;
      }
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const int e = e0 + k * kThreads;
        if (e < total) {
          const int t = e / N, nn = e - t * N;
          bT[nn * ldq + t] = vb[k];
          cT[nn * ldq + t] = vc[k];
        }
      }
    }
#pragma unroll 4
    for (int e = tid; e < QP * kPT; e += kThreads) {
      const int t = e / kPT, pp = e % kPT;
      xs[e] = (t < Q && pp < pw) ? to_f(x[x0 + t * g.sx[2] + pp * g.sx[4]]) : 0.f;
    }
    for (int t = tid; t < QP; t += kThreads) dts[t] = t < Q ? dt[d0 + t * g.sd[2]] : 0.f;
    __syncthreads();

    for (int t = tid; t < QP; t += kThreads) {
      float s = 0.f;
      for (int u = 0; u <= t && u < Q; ++u) s += dts[u] * an;
      cs[t] = s;
    }
    __syncthreads();
    const float last = cs[Q - 1];
    for (int t = tid; t < QP; t += kThreads) ws[t] = t < Q ? dts[t] * expf(last - cs[t]) : 0.f;

    // ---- att = (C B^T) * exp(cs[q] - cs[t]) * dt[t], t <= q ------------
    {
      const int tq = tid / kGrid, tt = tid % kGrid;
      float acc[QT][QT];
#pragma unroll
      for (int i = 0; i < QT; ++i)
#pragma unroll
        for (int j = 0; j < QT; ++j) acc[i][j] = 0.f;
      for (int nn = 0; nn < N; ++nn) {
        float cv[QT], bv[QT];
#pragma unroll
        for (int i = 0; i < QT; ++i) cv[i] = cT[nn * ldq + tq + kGrid * i];
#pragma unroll
        for (int j = 0; j < QT; ++j) bv[j] = bT[nn * ldq + tt + kGrid * j];
#pragma unroll
        for (int i = 0; i < QT; ++i)
#pragma unroll
          for (int j = 0; j < QT; ++j) acc[i][j] = fmaf(cv[i], bv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < QT; ++i) {
        const int qq = tq + kGrid * i;
#pragma unroll
        for (int j = 0; j < QT; ++j) {
          const int t = tt + kGrid * j;
          att[qq * ldq + t] =
              (t <= qq && qq < Q) ? acc[i][j] * expf(cs[qq] - cs[t]) * dts[t] : 0.f;
        }
      }
    }
    __syncthreads();

    // ---- y = att x + (C h^T) * exp(cs) ---------------------------------
    {
      const int pp = tid % kPT, r0 = tid / kPT;   // kThreads / kPT == kGrid rows
      float acc[QT], inter[QT];
#pragma unroll
      for (int i = 0; i < QT; ++i) acc[i] = inter[i] = 0.f;
      for (int t = 0; t < QP; ++t) {
        const float xv = xs[t * kPT + pp];
#pragma unroll
        for (int i = 0; i < QT; ++i) acc[i] = fmaf(att[(r0 + kGrid * i) * ldq + t], xv, acc[i]);
      }
      for (int nn = 0; nn < N; ++nn) {
        const float hv = hs[pp * ldn + nn];
#pragma unroll
        for (int i = 0; i < QT; ++i) inter[i] = fmaf(cT[nn * ldq + r0 + kGrid * i], hv, inter[i]);
      }
#pragma unroll
      for (int i = 0; i < QT; ++i) {
        const int qq = r0 + kGrid * i;
        if (qq < Q && pp < pw)
          y[y0 + qq * g.sy[2] + pp * g.sy[4]] = from_f<T>(acc[i] + inter[i] * expf(cs[qq]));
      }
    }
    __syncthreads();

    // ---- h = h * exp(cs[Q-1]) + B^T (x * ws) ---------------------------
    {
      const int pp = tid / kGrid, n0 = tid % kGrid;
      const int nt = (N + kGrid - 1) / kGrid;
      float acc[kMaxNT];
#pragma unroll
      for (int j = 0; j < kMaxNT; ++j) acc[j] = 0.f;
      for (int t = 0; t < Q; ++t) {
        const float wv = xs[t * kPT + pp] * ws[t];
#pragma unroll
        for (int j = 0; j < kMaxNT; ++j) {
          const int nn = n0 + kGrid * j;
          if (j < nt && nn < N) acc[j] = fmaf(bT[nn * ldq + t], wv, acc[j]);
        }
      }
      const float decay = expf(last);
#pragma unroll
      for (int j = 0; j < kMaxNT; ++j) {
        const int nn = n0 + kGrid * j;
        if (j < nt && nn < N) hs[pp * ldn + nn] = hs[pp * ldn + nn] * decay + acc[j];
      }
    }
    __syncthreads();
  }

  if (hout != nullptr) {
    for (int e = tid; e < pw * N; e += kThreads) {
      const int pp = e / N, nn = e - pp * N;
      hout[(((int64_t)bb * g.nh + hh) * g.p + p0 + pp) * N + nn] = hs[pp * ldn + nn];
    }
  }
}

template <typename T, int QT>
int launch(const void* x, const void* bm, const void* cm, const void* dt, const void* a,
           void* y, void* hout, const Geom& g, cudaStream_t stream) {
  const int64_t smem = smem_floats(g.q, g.n) * 4;
  auto kern = ssd_scan<T, QT>;
  if (smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int64_t grid = (int64_t)g.nb * g.nh * ((g.p + kPT - 1) / kPT);
  kern<<<(unsigned)grid, kThreads, (size_t)smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(bm), static_cast<const float*>(cm),
      static_cast<const float*>(dt), static_cast<const float*>(a), static_cast<T*>(y),
      static_cast<float*>(hout), g);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, const void* bm, const void* cm, const void* dt, const void* a,
             void* y, void* hout, const Geom& g, cudaStream_t s) {
  switch ((g.q + kGrid - 1) / kGrid) {
    case 1: return launch<T, 1>(x, bm, cm, dt, a, y, hout, g, s);
    case 2: return launch<T, 2>(x, bm, cm, dt, a, y, hout, g, s);
    case 3: return launch<T, 3>(x, bm, cm, dt, a, y, hout, g, s);
    case 4: return launch<T, 4>(x, bm, cm, dt, a, y, hout, g, s);
    case 5: return launch<T, 5>(x, bm, cm, dt, a, y, hout, g, s);
    case 6: return launch<T, 6>(x, bm, cm, dt, a, y, hout, g, s);
    case 7: return launch<T, 7>(x, bm, cm, dt, a, y, hout, g, s);
    case 8: return launch<T, 8>(x, bm, cm, dt, a, y, hout, g, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int64_t repro_ssd_max_chunk() { return kMaxQT * kGrid; }
extern "C" int64_t repro_ssd_max_state() { return kMaxNT * kGrid; }

// y (nc, B, Q, H, P) from x (nc, B, Q, H, P), b and c (nc, B, Q, H, N), dt
// (nc, B, Q, H), a (H,) contiguous, on `stream`.  `strides` holds the element
// strides of x, b, c (5 each), dt (4) and y (5), in that order.  x and y are
// float32 (`bf16` 0) or bfloat16 (`bf16` 1); b, c, dt and a are float32.
// `hout`, when not null, receives the final state (B, H, P, N), contiguous
// float32.  Returns the CUDA error code of the launch.
extern "C" int repro_ssd_scan(const void* x, const void* bm, const void* cm, const void* dt,
                              const void* a, void* y, void* hout, int64_t bf16, int64_t nc,
                              int64_t nb, int64_t q, int64_t nh, int64_t p, int64_t n,
                              const int64_t* strides, void* stream) {
  if (q < 1 || q > kMaxQT * kGrid || n < 1 || n > kMaxNT * kGrid)
    return (int)cudaErrorInvalidValue;
  Geom g;
  for (int i = 0; i < 5; ++i) {
    g.sx[i] = strides[i];
    g.sb[i] = strides[5 + i];
    g.sc[i] = strides[10 + i];
    g.sy[i] = strides[19 + i];
  }
  for (int i = 0; i < 4; ++i) g.sd[i] = strides[15 + i];
  g.nc = (int)nc;
  g.nb = (int)nb;
  g.q = (int)q;
  g.nh = (int)nh;
  g.p = (int)p;
  g.n = (int)n;
  g.ldq = (int)((q + kGrid - 1) / kGrid * kGrid + 1);
  g.ldn = (int)(n | 1);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) return dispatch<__nv_bfloat16>(x, bm, cm, dt, a, y, hout, g, s);
  return dispatch<float>(x, bm, cm, dt, a, y, hout, g, s);
}
