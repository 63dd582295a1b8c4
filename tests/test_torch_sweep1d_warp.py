"""K1's warp-register kernel (``csrc/sweep1d_warp.cu``), transcribed into
numpy line for line and held bit for bit against the plain version
``stencil1d_sweep_ttile_ref``, and the route that picks it.

The CPU has no CUDA compiler, so this transcription checks the kernel's
schedule: warps of ``kWarps`` per CTA with the idle ones recomputing the
last run, lanes as an array axis, a shuffle as a gather along that axis
with the lane-0 / lane-31 select before it, the halo slots' wrapped block
indices, the in-place slot order with its r-row carry, and the store
guard (each block written exactly once).  It runs in float32 with the
float32-rounded coefficients summed in the spec's order, as the kernel
does under ``-fmad=false``.  One case is also held against the JAX
package's Pallas kernel in interpret mode (2e-6: XLA's CPU backend may
contract a multiply-add into an FMA).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import layouts as jlay
from repro.core import stencils as jst
from repro.kernels import stencil_kernels as jsk
from repro_torch.core import layouts as tlay
from repro_torch.core import stencils as tst
from repro_torch.core.stencils import coeff
from repro_torch.kernels import stencil_kernels as sk

K_WARPS = 4      # csrc/sweep1d_warp.cu's kWarps
VL = 32


def warp_kernel_np(spec, t: np.ndarray, depth: int) -> tuple[np.ndarray, np.ndarray]:
    """The kernel's output and how often each block was stored."""
    nb, m, vl = t.shape
    assert vl == VL and sk.sweep1d_route(vl, m, depth, spec.r) == "warp"
    B, R = sk.WARP_BLOCKS[m], spec.r
    S = B + 2
    taps = [(off[0], np.float32(coeff(c, torch.float32))) for off, c in spec.taps]
    nruns = -(-nb // B)
    ctas = -(-nruns // K_WARPS)
    w = np.arange(ctas * K_WARPS)[:, None]                  # (warps, 1)
    lane = np.arange(VL)[None, :]                           # (1, lanes)
    live = w < nruns
    b0 = np.where(live, w, nruns - 1) * B
    # v[i][s]: (warps, lanes) registers, row s of slot i (block b0 - 1 + i)
    v = [[t[(b0[:, 0] - 1 + i) % nb, s, :] for s in range(m)] for i in range(S)]
    left, right = (lane + VL - 1) % VL, (lane + 1) % VL

    def shfl(x, src):
        return np.take_along_axis(x, np.broadcast_to(src, x.shape), axis=1)

    for _ in range(depth):
        tail = [v[0][m - 1 - q] for q in range(R)]
        for i in range(S):
            nxt = i + 1 if i < S - 1 else S - 1
            ext = [None] * (m + 2 * R)
            for q in range(R):
                to_right = np.where(lane == VL - 1, tail[q], v[i][m - 1 - q])
                ext[R - 1 - q] = shfl(to_right, left)
                to_left = np.where(lane == 0, v[nxt][q], v[i][q])
                ext[R + m + q] = shfl(to_left, right)
            for s in range(m):
                ext[R + s] = v[i][s]
            for q in range(R):
                tail[q] = v[i][m - 1 - q]
            acc = [None] * m
            for n, (o, cf) in enumerate(taps):
                for s in range(m):
                    term = ext[R + s + o] * cf
                    acc[s] = term if n == 0 else acc[s] + term
            v[i] = acc
    out = np.full_like(t, np.nan)
    stores = np.zeros(nb, dtype=np.int64)
    for i in range(1, B + 1):
        b = b0[:, 0] - 1 + i
        ok = live[:, 0] & (b < nb)
        np.add.at(stores, b[ok], 1)
        for s in range(m):
            out[b[ok], s, :] = v[i][s][ok]
    return out, stores


def _t(nb, m, seed):
    x = np.random.default_rng(seed).standard_normal(nb * VL * m).astype(np.float32)
    return tlay.to_transpose_layout(torch.from_numpy(x), VL, m).numpy()


def _nbs(m):
    B = sk.WARP_BLOCKS[m]
    return sorted({1, 2, B - 1, B, B + 1, 3 * B + 2})


CASES = [(name, m, nb) for name in ("1d3p", "1d5p", "heat1d") for m in (1, 2, 4, 8)
         if m >= tst.make(name).r for nb in _nbs(m)]


@pytest.mark.parametrize("depth", range(1, 13))
@pytest.mark.parametrize("name,m,nb", CASES)
def test_warp_kernel_schedule_bitwise(name, m, nb, depth):
    spec = tst.make(name)
    t = _t(nb, m, seed=nb * 16 + m)
    got, stores = warp_kernel_np(spec, t, depth)
    np.testing.assert_array_equal(stores, np.ones(nb, dtype=np.int64))
    want = sk.stencil1d_sweep_ttile_ref(spec, torch.from_numpy(t), depth, 1).numpy()
    np.testing.assert_array_equal(got, want)


# tap lists in no order the kernel knows at compile time: it reads them at
# run time (the registry's 1-D stencils all take a compile-time order)
RUNTIME_TAPS = (
    (((1,), 0.25), ((0,), 0.5), ((-1,), 0.25)),
    (((0,), 0.375), ((-1,), 0.25), ((1,), 0.25), ((0,), 0.125)),     # 0 twice
    (((2,), 0.125), ((-1,), 0.25), ((0,), 0.25), ((1,), 0.25), ((-2,), 0.125)),
)


@pytest.mark.parametrize("depth", [1, 5])
@pytest.mark.parametrize("taps", RUNTIME_TAPS)
def test_warp_kernel_schedule_runtime_taps(taps, depth):
    r = max(abs(off[0]) for off, _ in taps)
    spec = tst.StencilSpec("custom1d", 1, r, "star", taps)
    t = _t(2 * sk.WARP_BLOCKS[4] + 3, 4, seed=9)
    got, _ = warp_kernel_np(spec, t, depth)
    want = sk.stencil1d_sweep_ttile_ref(spec, torch.from_numpy(t), depth, 1).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name,m,nb,depth", [("1d3p", 8, 3, 4), ("1d5p", 2, 5, 3)])
def test_warp_kernel_schedule_matches_pallas(name, m, nb, depth):
    t = _t(nb, m, seed=7)
    want = np.asarray(jsk.stencil1d_sweep_ttile(jst.make(name), jnp.asarray(t), depth, 1,
                                                interpret=True))
    got, _ = warp_kernel_np(tst.make(name), t, depth)
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=2e-6)
    np.testing.assert_array_equal(np.asarray(jlay.from_transpose_layout(jnp.asarray(t), VL, m)),
                                  tlay.from_transpose_layout(torch.from_numpy(t), VL, m).numpy())


@pytest.mark.parametrize("vl,m,depth,r,route", [
    (32, 8, 4, 1, "warp"),        # the main path: 1d3p at 2^26, k=2, ttile=2
    (32, 8, 1, 1, "warp"),
    (32, 8, 256, 1, "warp"),      # depth·r = vl·m: the halo block just holds it
    (32, 8, 257, 1, "smem"),      # depth·r > vl·m at vl = 32
    (32, 2, 16, 2, "warp"),
    (32, 2, 33, 2, "smem"),
    (32, 1, 32, 1, "warp"),
    (32, 1, 33, 1, "smem"),
    (128, 8, 4, 1, "smem"),       # a plan carried over from the JAX package
    (8, 8, 4, 1, "smem"),
    (32, 3, 2, 1, "smem"),        # no instance for m = 3
    (32, 16, 2, 1, "smem"),
    (32, 8, 2, 5, "smem"),        # beyond the kernel's reach
])
def test_sweep1d_route(vl, m, depth, r, route):
    assert sk.sweep1d_route(vl, m, depth, r) == route


def test_cpu_wrapper_counts_no_route():
    spec = tst.make("1d3p")
    t = torch.from_numpy(_t(4, 8, 1))
    sk.reset_launches()
    got = sk.stencil1d_sweep_ttile(spec, t, 2, 2)
    assert sk.LAUNCHES == dict.fromkeys(sk.LAUNCHES, 0)       # CPU: no kernel
    assert torch.equal(got, sk.stencil1d_sweep_ttile_ref(spec, t, 2, 2))
    assert {"sweep_1d", "sweep_1d_smem"} <= set(sk.LAUNCHES)
