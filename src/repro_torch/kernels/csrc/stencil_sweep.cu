// Depth-`depth` Jacobi advance of a grid held in the paper's local transpose
// layout (..., nb, m, vl) — one launch per sweep chunk.
//
// Replaces: src/repro/kernels/stencil_kernels.py::_kernel_1d (launched by
// stencil1d_sweep_ttile, K1, and by stencil1d_multistep / stencil1d_sweep_halo,
// K4a) and ::_kernel_nd (launched by stencil_nd_sweep_ttile, K3, and by
// stencil_nd_multistep / stencil_nd_sweep_halo, K4b).  They come here only
// for the reach their register kernels (csrc/sweep1d_warp.cu, sweep2d_warp.cu,
// sweep3d.cu) do not take: r > 4 at 1-D, r > 1 at 2-D and 3-D
// (stencil_kernels.sweep{1,2,3}d_route); no registry stencil has it.  One kernel serves
// 1-D, 2-D and 3-D: a grid is seen as (nz, ny, nx) in natural coordinates
// with size-1 leading axes where the stencil has none, and the minor axis nx
// is addressed through the layout map (natural g of a row lives at block
// g / (vl*m), row g % m, lane (g % (vl*m)) / m).
//
// The stencil's axis 0 (nx in 1-D, ny in 2-D, nz in 3-D; `eaxis`) has one of
// three boundary modes, a template parameter:
//   periodic  every axis wraps (K1/K3, the resident sweeps);
//   ring      the Pallas kernels' edge_mask=True: the r cells nearest each
//             end of axis 0 keep their value at every step;
//   open      edge_mask=False: cells outside the domain along axis 0 hold 0
//             at every step (read as zeros, never updated).
// The other axes always wrap.  In the non-periodic modes the gather loads an
// out-of-domain axis-0 cell as 0 instead of wrapping it, and the step loop
// writes 0 there (open) or the previous value on the ring (ring); a CTA
// whose loaded region stays clear of the ring and the grid's ends skips
// those checks.  The periodic instantiation is the same code as before the
// modes existed.
//
// The Pallas kernels lean on the TPU grid running in order and carry a window
// of time-skewed blocks in VMEM scratch from one grid step to the next.  CUDA
// blocks run in no order, so this kernel carries what those kernels compute,
// not their schedule: each CTA owns a rectangular output tile, gathers it
// with a depth*r halo on every axis (every periodic index wrapped, so a
// halo wider than the grid is fine), advances all `depth` steps in shared
// memory (ping-pong between two buffers, the valid region shrinking by r per
// step and per axis), and stores the tile's interior.  The redundant work is
// the halo recompute.  The minor-axis halo is rounded up to whole groups of m
// elements so that loads and stores walk the layout in address order.
//
// Taps are summed in the spec's order with each coefficient already rounded
// to the element type, one multiply and one add per tap, each rounded to
// it (elem.cuh); built with -fmad=false this is bit for bit what the plain
// PyTorch version computes.  Elements are float or bfloat16 in device
// memory (repro_stencil_sweep_f32 / _bf16), float in shared memory.
//
// Bound on H100: bytes, in every mode.  A launch must read the grid once and
// write it once (2 * numel * sizeof(element) bytes); its arithmetic is depth * (2*taps - 1)
// flops per point, far below the FP32 rate for the depths the engines use.
// The design keeps device-memory traffic near that bound (halo reads mostly
// hit L2); its cost is the halo recompute and the shared-memory tap reads,
// which the register-resident warp kernels remove where they apply.
#include <cuda_runtime.h>
#include <stdint.h>

#include "elem.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kMaxTaps = 64;

enum Edge : int { kPeriodic = 0, kRing = 1, kOpen = 2 };

struct Taps {
  int n;
  int oz[kMaxTaps], oy[kMaxTaps], ox[kMaxTaps];
  float c[kMaxTaps];
};

struct Geom {
  int64_t nz, ny, nx;   // natural extents (1 for absent leading axes)
  int vl, m;            // transpose layout of the minor axis
  int tz, ty, tx;       // output tile (tx a multiple of m)
  int hz, hy, hx;       // loaded halo per side (hx a multiple of m)
  int rz, ry, rx;       // reach of one step per axis (0 for absent axes)
  int depth;
};

// i mod n for any i; the halo of a tile is rarely out of range, so the
// division is skipped when it is not
__device__ __forceinline__ int64_t wrap(int64_t i, int64_t n) {
  if (i >= 0 && i < n) return i;
  const int64_t r = i % n;
  return r < 0 ? r + n : r;
}

// Offset, inside its (nb, m, vl) row, of natural minor index c*m + s: the
// m elements of a natural column c share block c / vl and lane c % vl.
// Columns are counted in 32 bits (the wrapper checks nx / m < 2^31).
__device__ __forceinline__ int64_t layout_offset(int c, int s, int vl, int m) {
  const int b = c / vl;
  const int j = c - b * vl;
  return ((int64_t)b * m + s) * vl + j;
}

// Whether the cell at natural (z, y, x) lies inside the grid along the
// non-periodic axis `eaxis` (0 = z, 1 = y, 2 = x), and whether it lies on
// that axis's Dirichlet ring (within one step's reach of either end).
__device__ __forceinline__ bool in_domain(int eaxis, int64_t z, int64_t y, int64_t x,
                                          const Geom& g) {
  const int64_t a = eaxis == 0 ? z : eaxis == 1 ? y : x;
  const int64_t n = eaxis == 0 ? g.nz : eaxis == 1 ? g.ny : g.nx;
  return a >= 0 && a < n;
}

__device__ __forceinline__ bool on_ring(int eaxis, int64_t z, int64_t y, int64_t x,
                                        const Geom& g) {
  const int64_t a = eaxis == 0 ? z : eaxis == 1 ? y : x;
  const int64_t n = eaxis == 0 ? g.nz : eaxis == 1 ? g.ny : g.nx;
  const int r = eaxis == 0 ? g.rz : eaxis == 1 ? g.ry : g.rx;
  return a < r || a >= n - r;
}

template <typename T, int kEdge>
__global__ void __launch_bounds__(kThreads)
stencil_sweep(const T* __restrict__ in, T* __restrict__ out, Geom g, Taps taps, int eaxis) {
  extern __shared__ float smem[];
  __shared__ int dlin[kMaxTaps];
  __shared__ float coef[kMaxTaps];
  const int sz = g.tz + 2 * g.hz, sy = g.ty + 2 * g.hy, sx = g.tx + 2 * g.hx;
  const int vol = sz * sy * sx;
  float* cur = smem;
  float* nxt = smem + vol;
  for (int t = threadIdx.x; t < taps.n; t += blockDim.x) {
    dlin[t] = (taps.oz[t] * sy + taps.oy[t]) * sx + taps.ox[t];
    coef[t] = taps.c[t];
  }
  const int64_t z0 = (int64_t)blockIdx.z * g.tz;
  const int64_t y0 = (int64_t)blockIdx.y * g.ty;
  const int64_t x0 = (int64_t)blockIdx.x * g.tx;
  // only a tile whose loaded region reaches the ring or past the grid
  // along axis 0 checks its cells; the others run the periodic code
  bool edge_tile = false;
  if (kEdge != kPeriodic) {
    const int64_t lo = eaxis == 0 ? z0 - g.hz : eaxis == 1 ? y0 - g.hy : x0 - g.hx;
    const int64_t hi = lo + (eaxis == 0 ? sz : eaxis == 1 ? sy : sx);
    const int64_t n = eaxis == 0 ? g.nz : eaxis == 1 ? g.ny : g.nx;
    const int r = eaxis == 0 ? g.rz : eaxis == 1 ? g.ry : g.rx;
    edge_tile = lo < r || hi > n - r;
  }

  // gather tile + halo.  x0 - hx is a multiple of m, so each run of m
  // natural elements is one natural column: one lane j of one block.
  // Walking q = s*cols + jj puts neighbouring threads on neighbouring
  // lanes (addresses).  Outside the domain of a non-periodic axis 0 (whole
  // columns in 1-D: nx is a multiple of m) the cell is 0.
  const int cols = sx / g.m;
  const int64_t ncols = g.nx / g.m;
  const int64_t col0 = (x0 - g.hx) / g.m;
  for (int e = threadIdx.x; e < vol; e += blockDim.x) {
    const int row = e / sx;
    const int q = e - row * sx;
    const int s = q / cols;
    const int jj = q - s * cols;
    const int lz = row / sy;
    const int ly = row - lz * sy;
    const int64_t z = z0 - g.hz + lz, y = y0 - g.hy + ly, col = col0 + jj;
    float v = 0.0f;
    if (kEdge == kPeriodic || !edge_tile || in_domain(eaxis, z, y, col * g.m, g)) {
      const int64_t gz = wrap(z, g.nz);
      const int64_t gy = wrap(y, g.ny);
      const int c = (int)wrap(col, ncols);
      v = to_f(in[(gz * g.ny + gy) * g.nx + layout_offset(c, s, g.vl, g.m)]);
    }
    cur[row * sx + jj * g.m + s] = v;
  }
  __syncthreads();

  // depth Jacobi steps; after step k the region [k*r, S - k*r) is exact
  for (int step = 1; step <= g.depth; ++step) {
    const int az = step * g.rz, ay = step * g.ry, ax = step * g.rx;
    const int ny_ = sy - 2 * ay, nx_ = sx - 2 * ax;
    const int cnt = (sz - 2 * az) * ny_ * nx_;
    for (int e = threadIdx.x; e < cnt; e += blockDim.x) {
      const int row = e / nx_;
      const int lx = e - row * nx_ + ax;
      const int lz = row / ny_;
      const int ly = row - lz * ny_ + ay;
      const int base = ((lz + az) * sy + ly) * sx + lx;
      float acc = rnd<T>(cur[base + dlin[0]] * coef[0]);
      for (int t = 1; t < taps.n; ++t) acc = rnd<T>(acc + rnd<T>(cur[base + dlin[t]] * coef[t]));
      if (kEdge != kPeriodic && edge_tile) {
        const int64_t z = z0 - g.hz + lz + az, y = y0 - g.hy + ly, x = x0 - g.hx + lx;
        if (!in_domain(eaxis, z, y, x, g)) {
          acc = 0.0f;
        } else if (kEdge == kRing && on_ring(eaxis, z, y, x, g)) {
          acc = cur[base];
        }
      }
      nxt[base] = acc;
    }
    __syncthreads();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }

  // store the tile's interior, again in layout address order
  const int tcols = g.tx / g.m;
  const int tvol = g.tz * g.ty * g.tx;
  const int64_t tcol0 = x0 / g.m;
  for (int e = threadIdx.x; e < tvol; e += blockDim.x) {
    const int row = e / g.tx;
    const int q = e - row * g.tx;
    const int s = q / tcols;
    const int jj = q - s * tcols;
    const int lz = row / g.ty;
    const int ly = row - lz * g.ty;
    const int64_t gz = z0 + lz, gy = y0 + ly, c = tcol0 + jj;
    if (gz < g.nz && gy < g.ny && c * g.m < g.nx) {
      out[(gz * g.ny + gy) * g.nx + layout_offset((int)c, s, g.vl, g.m)] =
          from_f<T>(cur[((lz + g.hz) * sy + ly + g.hy) * sx + jj * g.m + s + g.hx]);
    }
  }
}

template <typename T, int kEdge>
int launch(const T* in, T* out, const Geom& g, const Taps& taps, int eaxis, int64_t smem_bytes,
           cudaStream_t stream) {
  if (smem_bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        stencil_sweep<T, kEdge>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((unsigned)((g.nx + g.tx - 1) / g.tx), (unsigned)((g.ny + g.ty - 1) / g.ty),
            (unsigned)((g.nz + g.tz - 1) / g.tz));
  stencil_sweep<T, kEdge><<<grid, kThreads, (size_t)smem_bytes, stream>>>(in, out, g, taps,
                                                                          eaxis);
  return (int)cudaGetLastError();
}

// Advance `in` by `depth` steps into `out` (both contiguous (nz, ny, nx) in
// layout, of T elements, distinct buffers) on `stream`.  `edge` is the
// boundary mode of axis `eaxis` (0 periodic, 1 ring, 2 open; eaxis 0 = z,
// 1 = y, 2 = x).  `offsets` holds ntaps (oz, oy, ox) triples and `coeffs`
// ntaps coefficients (rounded to T, as floats), both in host memory.
// `smem_bytes` is the dynamic shared memory of one CTA: 2 * (tz+2hz) *
// (ty+2hy) * (tx+2hx) * 4.  Returns the CUDA error code.
template <typename T>
int sweep(const void* in, void* out, int64_t nz, int64_t ny, int64_t nx, int64_t vl, int64_t m,
          int64_t tz, int64_t ty, int64_t tx, int64_t hz, int64_t hy, int64_t hx, int64_t rz,
          int64_t ry, int64_t rx, int64_t depth, int64_t edge, int64_t eaxis, int64_t ntaps,
          const int32_t* offsets, const float* coeffs, int64_t smem_bytes, void* stream) {
  if (ntaps < 1 || ntaps > kMaxTaps || eaxis < 0 || eaxis > 2)
    return (int)cudaErrorInvalidValue;
  Taps taps;
  taps.n = (int)ntaps;
  for (int t = 0; t < ntaps; ++t) {
    taps.oz[t] = offsets[3 * t];
    taps.oy[t] = offsets[3 * t + 1];
    taps.ox[t] = offsets[3 * t + 2];
    taps.c[t] = coeffs[t];
  }
  Geom g{nz, ny, nx, (int)vl, (int)m, (int)tz, (int)ty, (int)tx,
         (int)hz, (int)hy, (int)hx, (int)rz, (int)ry, (int)rx, (int)depth};
  const T* src = static_cast<const T*>(in);
  T* dst = static_cast<T*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (edge) {
    case kPeriodic: return launch<T, kPeriodic>(src, dst, g, taps, (int)eaxis, smem_bytes, st);
    case kRing: return launch<T, kRing>(src, dst, g, taps, (int)eaxis, smem_bytes, st);
    case kOpen: return launch<T, kOpen>(src, dst, g, taps, (int)eaxis, smem_bytes, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int64_t repro_stencil_max_taps() { return kMaxTaps; }

// sweep (above) on float elements.
extern "C" int repro_stencil_sweep_f32(
    const void* in, void* out, int64_t nz, int64_t ny, int64_t nx,
    int64_t vl, int64_t m, int64_t tz, int64_t ty, int64_t tx,
    int64_t hz, int64_t hy, int64_t hx, int64_t rz, int64_t ry, int64_t rx,
    int64_t depth, int64_t edge, int64_t eaxis, int64_t ntaps, const int32_t* offsets,
    const float* coeffs, int64_t smem_bytes, void* stream) {
  return sweep<float>(in, out, nz, ny, nx, vl, m, tz, ty, tx, hz, hy, hx, rz, ry, rx, depth,
                      edge, eaxis, ntaps, offsets, coeffs, smem_bytes, stream);
}

// sweep (above) on bfloat16 elements.
extern "C" int repro_stencil_sweep_bf16(
    const void* in, void* out, int64_t nz, int64_t ny, int64_t nx,
    int64_t vl, int64_t m, int64_t tz, int64_t ty, int64_t tx,
    int64_t hz, int64_t hy, int64_t hx, int64_t rz, int64_t ry, int64_t rx,
    int64_t depth, int64_t edge, int64_t eaxis, int64_t ntaps, const int32_t* offsets,
    const float* coeffs, int64_t smem_bytes, void* stream) {
  return sweep<__nv_bfloat16>(in, out, nz, ny, nx, vl, m, tz, ty, tx, hz, hy, hx, rz, ry, rx,
                              depth, edge, eaxis, ntaps, offsets, coeffs, smem_bytes, stream);
}
