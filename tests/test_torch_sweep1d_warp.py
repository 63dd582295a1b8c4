"""K1's and K4a's warp-register kernel (``csrc/sweep1d_warp.cu``),
transcribed into numpy line for line and held bit for bit against the plain
versions ``stencil1d_sweep_ttile_ref`` (periodic) and
``stencil1d_multistep_ref`` (the ring and open ends), and the route that
picks it.

The CPU has no CUDA compiler, so this transcription checks the kernel's
schedule: warps of ``kWarps`` per CTA with the idle ones recomputing the
last run, lanes as an array axis, each lane's column in a slot (warp row
v, lane j: column 32·v + j mod C of the layout's C = nb·vl columns) and
its offset in the (nb, m, vl) layout at any m (the instance M =
``sub_columns(m)``: a layout column of m = g·M elements is g sub-columns
of M, sub-column u = g·c + h's element s at ((c // vl)·m + h·M + s)·vl +
c % vl, C' = g·C of them, the lane's offsets at g > 1 stepped slot by
slot by ``SubWalk``, held against that map; "column" below means
sub-column, m the instance's M and C the C'), a shuffle as a gather along
the lane
axis with the lane-0 / lane-31 select before it, the in-place slot order
with its r-row carry, and the store rule (a lane stores in the middle
slots when its unwrapped column lies in [0, C): each column written
exactly once, also when C is below 32 or no multiple of it); in the ring
and open modes, the lanes whose unwrapped column lies beyond the ends, the
zeros an open end loads and holds, and the ring rows the lanes holding
columns 0 and C - 1 put back.  In ring mode the lanes beyond the ends are
filled with NaN instead of their wrapped columns: no NaN may reach a stored
value.  It runs in float32 with the float32-rounded coefficients summed in
the spec's order, as the kernel does under ``-fmad=false``.  A few cases
are also held against the JAX package's Pallas kernel in interpret mode at
the same (vl, m) (2e-6: XLA's CPU backend may contract a multiply-add into
an FMA); in open mode only at k·r or more from the ends, where the
reference's values are specified.
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
LANES = 32       # a warp row: one column per lane
VL = 32
VLS = (1, 2, 4, 8, 16, 32, 64, 128)


def sub_walk(u, nb, vl, g, m, nslots):
    """csrc/sweep1d_warp.cu's SubWalk (g > 1): the offsets of element 0 of
    sub-columns u, u + 32, ... mod C' (C' = nb·vl·g, M = m points each),
    one a step, from one split of u and then carries, no division."""
    u = u % (nb * vl * g)
    c, h = u // g, u % g
    q, rem = c // vl, c % vl
    dh, dc = LANES % g, LANES // g
    dq, dr = dc // vl, dc % vl
    offs = []
    for _ in range(nslots):
        offs.append((q * g + h) * (m * vl) + rem)
        h = h + dh
        carry = h >= g
        h = np.where(carry, h - g, h)
        rem, q = rem + dr + carry, q + dq
        over = rem >= vl
        rem, q = np.where(over, rem - vl, rem), q + over
        while (q >= nb).any():
            q = np.where(q >= nb, q - nb, q)
    return offs


def warp_kernel_np(spec, t: np.ndarray, depth: int, edge: str = "periodic"
                   ) -> tuple[np.ndarray, np.ndarray]:
    """One launch's output and how often each (sub-)column was stored."""
    nb, m_layout, vl = t.shape
    assert sk.sweep1d_route(vl, m_layout, depth, spec.r, len(spec.taps)) == "warp"
    m, g = sk.sub_columns(m_layout)              # m: the instance's M from here on
    B, R = sk.WARP_BLOCKS[m], spec.r
    assert depth * R <= LANES * m                # one launch's corruption fits its halo slot
    S = B + 2
    span, K = -(-R // m), min(R, m)              # lanes a halo reaches a side; rows it takes
    C = nb * vl * g                              # C' sub-columns
    taps = [(off[0], np.float32(coeff(c, torch.float32))) for off, c in spec.taps]
    nruns = -(-(-(-C // LANES)) // B)
    ctas = -(-nruns // K_WARPS)
    w = np.arange(ctas * K_WARPS)[:, None]                  # (warps, 1)
    lane = np.arange(LANES)[None, :]                        # (1, lanes)
    live = w < nruns
    ub = (np.where(live, w, nruns - 1) * B - 1) * LANES     # lane 0's column in slot 0
    first_run = ub < 0
    u0 = ub + lane                                          # slot 0's columns
    flat = t.reshape(-1)

    def col_offset(u):           # element 0 of column u (g = 1); element s is s·vl on
        return u // vl * (m * vl) + u % vl

    # the lanes' offsets in slots 0 .. S-1 (loads) and 1 .. B (stores): at
    # g = 1 col_offset of each, at g > 1 a SubWalk from slot 0 and from 1,
    # held against the layout's map ((c // vl)·m + h·M)·vl + c % vl
    if g == 1:
        load_offs = [col_offset((u0 + i * LANES) % C) for i in range(S)]
        store_offs = load_offs[1:B + 1]
    else:
        load_offs = sub_walk(u0, nb, vl, g, m, S)
        store_offs = sub_walk(u0 + LANES, nb, vl, g, m, B)
        for i, off in enumerate(load_offs):
            c, h = (u0 + i * LANES) % C // g, (u0 + i * LANES) % C % g
            np.testing.assert_array_equal(off, c // vl * (m_layout * vl) + h * m * vl + c % vl)

    def u(i):                    # the lanes' unwrapped columns in slot i
        return u0 + i * LANES

    def beyond(i):
        return (u(i) < 0) | (u(i) >= C)

    # v[i][s]: (warps, lanes) registers, row s of slot i; open: zeros beyond
    # the ends; ring: NaN there, which must not matter
    fill = {"periodic": None, "open": np.float32(0), "ring": np.float32(np.nan)}[edge]
    v = [[flat[load_offs[i] + s * vl] for s in range(m)] for i in range(S)]
    if fill is not None:
        v = [[np.where(beyond(i), fill, row) for row in v[i]] for i in range(S)]
    if edge == "ring":
        # the first K rows of the first run's slot 1 (columns u < span) and
        # the last K of the slot hi_slot holding one of the last span
        # columns (C - 1 - hi_e)
        ring_lo = [v[1][p] for p in range(K)]
        ring_hi = [np.zeros_like(v[0][0]) for _ in range(K)]
        hi_slot = np.full(v[0][0].shape, -1)
        hi_e = np.zeros(v[0][0].shape, dtype=np.int64)
        for i in range(1, S):
            e = C - 1 - u(i)
            at = (e >= 0) & (e < span)
            hi_slot, hi_e = np.where(at, i, hi_slot), np.where(at, e, hi_e)
            ring_hi = [np.where(at, v[i][m - K + p], ring_hi[p]) for p in range(K)]

    def shfl(x, src):
        return np.take_along_axis(x, np.broadcast_to(src, x.shape), axis=1)

    for _ in range(depth):
        tail = [v[0][m - 1 - p] for p in range(K)]
        for i in range(S):
            nxt = i + 1 if i < S - 1 else S - 1
            ext = [None] * (m + 2 * R)
            for q in range(R):
                d, p = 1 + q // m, q % m             # the lane distance and the row
                to_right = np.where(lane >= LANES - d, tail[p], v[i][m - 1 - p])
                ext[R - 1 - q] = shfl(to_right, (lane - d) % LANES)
                to_left = np.where(lane < d, v[nxt][p], v[i][p])
                ext[R + m + q] = shfl(to_left, (lane + d) % LANES)
            for s in range(m):
                ext[R + s] = v[i][s]
            for p in range(K):
                tail[p] = v[i][m - 1 - p]
            acc = [None] * m
            for n, (o, cf) in enumerate(taps):
                for s in range(m):
                    term = ext[R + s + o] * cf
                    acc[s] = term if n == 0 else acc[s] + term
            if edge == "ring":
                lo = (i == 1) & first_run & (lane < span)
                hi = hi_slot == i
                for p in range(K):
                    acc[p] = np.where(lo & (lane * m + p < R), ring_lo[p], acc[p])
                    acc[m - K + p] = np.where(hi & (hi_e * m + K - p <= R), ring_hi[p],
                                              acc[m - K + p])
            if edge == "open":
                hold = beyond(i)
                acc = [np.where(hold, v[i][s], acc[s]) for s in range(m)]
            v[i] = acc
    out = np.full_like(flat, np.nan)
    stores = np.zeros(C, dtype=np.int64)
    for i in range(1, B + 1):
        ok = live & (u(i) < C)
        cols = u(i)[ok]
        np.add.at(stores, cols, 1)
        for s in range(m):
            out[store_offs[i - 1][ok] + s * vl] = v[i][s][ok]
    return out.reshape(t.shape), stores


def warp_sweep_np(spec, t: np.ndarray, depth: int, edge: str = "periodic"
                  ) -> tuple[np.ndarray, np.ndarray]:
    """A depth-``depth`` sweep as the wrappers run it: the launches of
    ``sweep1d_launches``, one after another, each storing every column
    once (the store counts summed over the launches)."""
    plan = sk.sweep1d_launches(t.shape[1], depth, spec.r)
    assert sum(d for _, _, d in plan) == depth
    counts = []
    for _, _, d in plan:
        t, stores = warp_kernel_np(spec, t, d, edge)
        counts.append(stores)
    assert all(np.array_equal(c, counts[0]) for c in counts)
    return t, counts[0]


def _t(nb, m, seed, vl=VL):
    x = np.random.default_rng(seed).standard_normal(nb * vl * m).astype(np.float32)
    return tlay.to_transpose_layout(torch.from_numpy(x), vl, m).numpy()


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
    np.testing.assert_array_equal(stores, np.ones(nb * VL, dtype=np.int64))
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
    (32, 8, 256, 1, "warp"),      # depth·r = 32·m: the halo warp row just holds it
    (32, 8, 257, 1, "warp"),      # depth·r > 32·m: two launches (256 + 1)
    (32, 2, 16, 2, "warp"),
    (32, 2, 33, 2, "warp"),       # 32 + 1
    (32, 1, 32, 1, "warp"),
    (32, 1, 33, 1, "warp"),       # 32 + 1
    (128, 8, 4, 1, "warp"),       # a plan carried over from the JAX package
    (8, 8, 4, 1, "warp"),         # the reference tuner's vl 8
    (32, 3, 2, 1, "warp"),        # m = 3: sub-columns of 1
    (32, 16, 2, 1, "warp"),       # m = 16: sub-columns of 8
    (32, 8, 2, 5, "far"),         # beyond the kernel's reach
    (4, 1, 32, 1, "warp"),
    (16, 2, 16, 2, "warp"),
    (64, 4, 128, 1, "warp"),
    (128, 8, 256, 1, "warp"),     # one launch up to 32·m whatever vl is
    (128, 8, 257, 1, "warp"),
    (4, 2, 65, 1, "warp"),        # 64 + 1
    (8, 16, 4, 1, "warp"),        # a reference tuner pair: sub-columns of 8
    (128, 5, 2, 1, "warp"),
    (32, 3, 2, 2, "warp"),        # 1d5p at m = 3: r = 2 > M = 1, halo from two lanes
    (8, 5, 1, 2, "warp"),
    (8, 6, 32, 2, "warp"),        # 1d5p at m = 6: M = 2, depth·r = 32·M
    (8, 6, 33, 2, "warp"),        # 32 + 1
    (8, 16, 256, 1, "warp"),      # depth·r = 32·M at m = 16
    (8, 16, 257, 1, "warp"),
    (16, 32, 257, 1, "warp"),
    (32, 3, 32, 1, "warp"),       # depth·r = 32·M at M = 1
    (32, 3, 33, 1, "warp"),
    (8, 0, 2, 1, "far"),          # no column
])
def test_sweep1d_route(vl, m, depth, r, route):
    assert sk.sweep1d_route(vl, m, depth, r, 2 * r + 1) == route
    # more taps than the kernel holds (16) take the far-reach kernel
    assert sk.sweep1d_route(vl, m, depth, r, sk.WARP_MAX_TAPS + 1) == "far"


@pytest.mark.parametrize("r", [1, 2, 3, 4])
def test_sweep1d_route_takes_every_shape_of_its_reach(r):
    """Every vl 1–256, m 1–32 and depth 1–300 of a reach up to
    ``WARP_MAX_R`` takes the warp kernel; reach 5 the far-reach one."""
    for vl in range(1, 257):
        for m in range(1, 33):
            for depth in range(1, 301):
                assert sk.sweep1d_route(vl, m, depth, r, 2 * r + 1) == "warp", (vl, m, depth)
    assert sk.WARP_MAX_R == 4
    assert {sk.sweep1d_route(vl, m, d, 5, 11) for vl in (1, 32) for m in (5, 8)
            for d in (1, 300)} == {"far"}


@pytest.mark.parametrize("m,depth,r,launches", [
    (8, 4, 1, ((8, 1, 4),)),
    (1, 34, 1, ((1, 1, 32), (1, 1, 2))),             # the former K1-smem row
    (5, 16, 2, ((1, 5, 16),)),                       # 1d5p at its odd-m tile, fused 16
    (5, 17, 2, ((1, 5, 16), (1, 5, 1))),
    (3, 4, 2, ((1, 3, 4),)),
    (6, 33, 2, ((2, 3, 32), (2, 3, 1))),
    (8, 600, 1, ((8, 1, 256), (8, 1, 256), (8, 1, 88))),
    (16, 257, 1, ((8, 2, 256), (8, 2, 1))),
    (5, 25, 3, ((1, 5, 10), (1, 5, 10), (1, 5, 5))),  # 32·M // r = 10
    (6, 17, 4, ((2, 3, 16), (2, 3, 1))),
    (12, 64, 4, ((4, 3, 32), (4, 3, 32))),
    (3, 0, 2, ((1, 3, 0),)),                         # depth 0: one launch that copies
])
def test_sweep1d_launches(m, depth, r, launches):
    """Consecutive launches of the largest M dividing m, each at most
    ``32·M // r`` deep (its corruption within one halo warp row)."""
    got = sk.sweep1d_launches(m, depth, r)
    assert got == launches
    assert sum(d for _, _, d in got) == depth
    assert all(d * r <= sk.WARP_LANES * mm and mm * g == m for mm, g, d in got)


def test_cpu_wrapper_counts_no_route():
    spec = tst.make("1d3p")
    t = torch.from_numpy(_t(4, 8, 1))
    sk.reset_launches()
    got = sk.stencil1d_sweep_ttile(spec, t, 2, 2)
    multi = sk.stencil1d_multistep(spec, t, 2, True)
    assert sk.LAUNCHES == dict.fromkeys(sk.LAUNCHES, 0)       # CPU: no kernel
    assert torch.equal(got, sk.stencil1d_sweep_ttile_ref(spec, t, 2, 2))
    assert torch.equal(multi, sk.stencil1d_multistep_ref(spec, t, 2, True))
    assert {"sweep_1d", "sweep_far", "multistep_1d", "multistep_far"} <= set(sk.LAUNCHES)


# ---------------------------------------------------------------------------
# K4a: the ring and open ends
# ---------------------------------------------------------------------------

def _edge_check(name, m, nb, depth, edge, seed, vl=VL):
    spec = tst.make(name)
    t = _t(nb, m, seed, vl)
    got, stores = warp_sweep_np(spec, t, depth, edge)
    np.testing.assert_array_equal(stores, np.ones(nb * vl, dtype=np.int64))
    assert np.isfinite(got).all()                # no NaN from beyond the ends
    want = sk.stencil1d_multistep_ref(spec, torch.from_numpy(t), depth, edge == "ring").numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("edge", ["ring", "open"])
@pytest.mark.parametrize("depth", [1, 2, 3, 5, 8, 12])
@pytest.mark.parametrize("name,m,nb", CASES)
def test_warp_kernel_edges_bitwise(name, m, nb, depth, edge):
    _edge_check(name, m, nb, depth, edge, seed=nb * 16 + m + depth)


@pytest.mark.parametrize("edge", ["ring", "open"])
@pytest.mark.parametrize("name,m,nb", [("1d3p", 1, 3), ("1d3p", 2, 1), ("1d5p", 2, 33),
                                       ("heat1d", 4, 17), ("1d5p", 8, 9), ("1d3p", 8, 2)])
def test_warp_kernel_edges_deepest(name, m, nb, edge):
    """At the deepest launch (depth·r = vl·m) the corruption from a run's
    ends fills its halo slots; one step more is two launches, bit for bit
    one deeper plain sweep."""
    r = tst.make(name).r
    depth = VL * m // r
    assert sk.sweep1d_launches(m, depth, r) == ((m, 1, depth),)
    assert sk.sweep1d_launches(m, depth + 1, r) == ((m, 1, depth), (m, 1, 1))
    _edge_check(name, m, nb, depth, edge, seed=m + nb)
    _edge_check(name, m, nb, depth + 1, edge, seed=m + nb + 1)


@pytest.mark.parametrize("edge_mask", [True, False])
@pytest.mark.parametrize("name,m,nb,k", [("1d3p", 8, 11, 2), ("1d5p", 4, 3, 3)])
def test_warp_kernel_edges_match_pallas(name, m, nb, k, edge_mask):
    """Against the JAX package's Pallas kernel: the whole array with the
    ring, and at k·r or more from the ends with open ends."""
    t = _t(nb, m, seed=5)
    want = np.asarray(jlay.from_transpose_layout(
        jsk.stencil1d_multistep(jst.make(name), jnp.asarray(t), k, interpret=True,
                                edge_mask=edge_mask), VL, m))
    got, _ = warp_kernel_np(tst.make(name), t, k, "ring" if edge_mask else "open")
    got = tlay.from_transpose_layout(torch.from_numpy(got), VL, m).numpy()
    width = 0 if edge_mask else k * tst.make(name).r
    np.testing.assert_allclose(got[width:got.size - width], want[width:want.size - width],
                               rtol=2e-6, atol=2e-6)


# ---------------------------------------------------------------------------
# any vl: a warp row is 32 columns of the layout
# ---------------------------------------------------------------------------

def _vl_nbs(vl, m):
    """nb for a vl case: C = nb·vl near 5 and 20 columns (below a warp row
    where vl allows), near 32·B + 40 (several warp rows, the last one
    partial unless vl is 64 or more) and over several CTAs."""
    B = sk.WARP_BLOCKS[m]
    return sorted({-(-c // vl) for c in (5, 20, 32 * B + 40, 32 * B * K_WARPS + 72)})


VL_CASES = [("1d3p", 1), ("1d5p", 2), ("heat1d", 4), ("1d3p", 8)]


def _vl_check(name, m, nb, vl, depth, edge, seed, spec=None):
    spec = spec or tst.make(name)
    t = _t(nb, m, seed, vl)
    got, stores = warp_sweep_np(spec, t, depth, edge)
    np.testing.assert_array_equal(stores, np.ones(nb * vl * sk.sub_columns(m)[1], dtype=np.int64))
    assert np.isfinite(got).all()                # no NaN from beyond the ends
    if edge == "periodic":
        want = sk.stencil1d_sweep_ttile_ref(spec, torch.from_numpy(t), depth, 1)
    else:
        want = sk.stencil1d_multistep_ref(spec, torch.from_numpy(t), depth, edge == "ring")
    np.testing.assert_array_equal(got, want.numpy(), err_msg=f"vl={vl} nb={nb} depth={depth}")


@pytest.mark.parametrize("edge", ["periodic", "ring", "open"])
@pytest.mark.parametrize("vl", VLS)
@pytest.mark.parametrize("name,m", VL_CASES)
def test_warp_kernel_any_vl_bitwise(name, m, vl, edge):
    """Every vl, at C below 32, no multiple of 32 and over several CTAs."""
    for nb in _vl_nbs(vl, m):
        for depth in (1, 3):
            _vl_check(name, m, nb, vl, depth, edge, seed=nb * 8 + vl + depth)


@pytest.mark.parametrize("edge", ["periodic", "ring", "open"])
@pytest.mark.parametrize("vl", VLS)
def test_warp_kernel_any_vl_deepest(vl, edge):
    """The deepest launch (depth·r = 32·m) at every vl."""
    name, m = "1d5p", 2
    depth = LANES * m // tst.make(name).r
    assert sk.sweep1d_launches(m, depth, tst.make(name).r) == ((m, 1, depth),)
    assert len(sk.sweep1d_launches(m, depth + 1, tst.make(name).r)) == 2
    for nb in _vl_nbs(vl, m)[:3]:
        _vl_check(name, m, nb, vl, depth, edge, seed=nb + vl)


@pytest.mark.parametrize("name,m,nb,vl,depth", [
    ("1d3p", 8, 5, 8, 4), ("1d5p", 4, 3, 16, 3), ("1d3p", 2, 2, 128, 2), ("heat1d", 1, 7, 4, 2),
])
def test_warp_kernel_any_vl_matches_pallas(name, m, nb, vl, depth):
    t = _t(nb, m, seed=11, vl=vl)
    want = np.asarray(jsk.stencil1d_sweep_ttile(jst.make(name), jnp.asarray(t), depth, 1,
                                                interpret=True))
    got, _ = warp_kernel_np(tst.make(name), t, depth)
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=2e-6)


@pytest.mark.parametrize("edge_mask", [True, False])
@pytest.mark.parametrize("name,m,nb,vl,k", [("1d3p", 8, 11, 8, 2), ("1d5p", 2, 3, 16, 3)])
def test_warp_kernel_any_vl_edges_match_pallas(name, m, nb, vl, k, edge_mask):
    """Against the JAX package's Pallas kernel at the same (vl, m): the
    whole array with the ring, and at k·r or more from the ends with open
    ends."""
    t = _t(nb, m, seed=6, vl=vl)
    want = np.asarray(jlay.from_transpose_layout(
        jsk.stencil1d_multistep(jst.make(name), jnp.asarray(t), k, interpret=True,
                                edge_mask=edge_mask), vl, m))
    got, _ = warp_kernel_np(tst.make(name), t, k, "ring" if edge_mask else "open")
    got = tlay.from_transpose_layout(torch.from_numpy(got), vl, m).numpy()
    width = 0 if edge_mask else k * tst.make(name).r
    np.testing.assert_allclose(got[width:got.size - width], want[width:want.size - width],
                               rtol=2e-6, atol=2e-6)


# ---------------------------------------------------------------------------
# any m: a column of m = g·M points is g sub-columns of M
# ---------------------------------------------------------------------------

SUB_MS = (3, 5, 6, 12, 16, 32)      # M = 1, 1, 2, 4, 8, 8


def _sub_nbs(vl, m):
    """nb for a sub-column case: C' = nb·vl·g near 5 and 20 sub-columns
    (below a warp row where vl and g allow), near 32·B + 40 (several warp
    rows, the last one partial) and over several CTAs."""
    big, g = sk.sub_columns(m)
    B = sk.WARP_BLOCKS[big]
    return sorted({-(-c // (vl * g)) for c in (5, 20, 32 * B + 40, 32 * B * K_WARPS + 72)})


@pytest.mark.parametrize("edge", ["periodic", "ring", "open"])
@pytest.mark.parametrize("vl", [1, 4, 8, 32])
@pytest.mark.parametrize("m", SUB_MS)
def test_warp_kernel_sub_columns_bitwise(m, vl, edge):
    """m off {1, 2, 4, 8} on the instance M with g = m / M sub-columns a
    column (vl = 32 too: the any-vl instances): 1d3p at depths 1 and 3 on
    every grid, 1d5p (at M = 1 with a halo of two lanes) at depth 2 and the
    deepest launch (depth·r = 32·M) on the smallest two, bit for bit the
    plain versions, every sub-column stored once."""
    big, g = sk.sub_columns(m)
    nbs = _sub_nbs(vl, m)
    cases = [("1d3p", nb, depth) for nb in nbs for depth in (1, 3)]
    cases += [("1d5p", nb, depth) for nb in nbs[:2] for depth in (2, LANES * big // 2)]
    for name, nb, depth in cases:
        _vl_check(name, m, nb, vl, depth, edge, seed=nb * 8 + vl + m + depth)


@pytest.mark.parametrize("name,m,nb,vl,k", [("1d3p", 16, 3, 8, 2), ("1d3p", 5, 7, 8, 3),
                                            ("1d5p", 6, 4, 4, 2), ("1d5p", 5, 3, 32, 2),
                                            ("1d5p", 3, 7, 8, 3)])
def test_warp_kernel_sub_columns_match_pallas(name, m, nb, vl, k):
    """Against the JAX package's Pallas kernel in interpret mode at the
    same (vl, m) (rtol = atol = 2e-6, as above): the periodic sweep, the
    ring over the whole array and open ends at k·r or more from them."""
    spec, jspec = tst.make(name), jst.make(name)
    t = _t(nb, m, seed=13, vl=vl)
    want = np.asarray(jsk.stencil1d_sweep_ttile(jspec, jnp.asarray(t), k, 1, interpret=True))
    got, _ = warp_kernel_np(spec, t, k)
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=2e-6)
    for edge_mask in (True, False):
        want = np.asarray(jlay.from_transpose_layout(
            jsk.stencil1d_multistep(jspec, jnp.asarray(t), k, interpret=True,
                                    edge_mask=edge_mask), vl, m))
        got, _ = warp_kernel_np(spec, t, k, "ring" if edge_mask else "open")
        got = tlay.from_transpose_layout(torch.from_numpy(got), vl, m).numpy()
        width = 0 if edge_mask else k * spec.r
        np.testing.assert_allclose(got[width:got.size - width], want[width:want.size - width],
                                   rtol=2e-6, atol=2e-6)


# ---------------------------------------------------------------------------
# r > M: a lane's halo from the lanes up to ceil(r / M) away
# ---------------------------------------------------------------------------

def _star(r):
    """A reach-r 1-D star (0, -1, 1, ..., -r, r); at r > M off (M, r) = (1,
    2) the kernel reads it at run time."""
    return tst.StencilSpec(f"star1d-r{r}", 1, r, "star", tst._star_taps(1, r))


# (stencil, m): 1d5p at M = 1 (m = 3, 5, 7: a halo of two lanes), reach 3
# and 4 at M = 1 (three and four lanes) and M = 2 (two lanes)
BEYOND_M = [("1d5p", 3), ("1d5p", 5), ("1d5p", 7), ("r3", 3), ("r3", 5), ("r3", 6),
            ("r4", 5), ("r4", 6), ("r4", 10)]


def _beyond_spec(name):
    return _star(int(name[1])) if name.startswith("r") else tst.make(name)


@pytest.mark.parametrize("edge", ["periodic", "ring", "open"])
@pytest.mark.parametrize("vl", [1, 8, 32])
@pytest.mark.parametrize("name,m", BEYOND_M)
def test_warp_kernel_reach_beyond_m_bitwise(name, m, vl, edge):
    """The instances with r > M, bit for bit the plain versions, every
    sub-column stored once: C' below 32 (wrapping within a slot), a
    partial warp row, several runs and several CTAs; depths 1, 3, the
    deepest launch (32·M // r) and one step past it (two launches)."""
    spec = _beyond_spec(name)
    big, g = sk.sub_columns(m)
    assert spec.r > big
    deepest = LANES * big // spec.r
    assert len(sk.sweep1d_launches(m, deepest + 1, spec.r)) == 2
    nbs = _sub_nbs(vl, m)
    for nb in nbs:
        for depth in (1, 3) if nb == nbs[-1] else (1, 3, deepest, deepest + 1):
            _vl_check(name, m, nb, vl, depth, edge, seed=nb * 8 + vl + m + depth, spec=spec)


@pytest.mark.parametrize("name,m,nb,vl", [("1d5p", 3, 2, 4), ("r3", 5, 1, 4), ("r4", 6, 1, 2),
                                          ("r4", 5, 3, 1)])
def test_warp_kernel_reach_beyond_m_ring_spans_lanes(name, m, nb, vl):
    """C' below 32 with the ring over several lanes at each end (ceil(r /
    M) of them) and, at the smallest grids, the two rings meeting: every
    ring cell kept at every step, in one launch and in a chain."""
    spec = _beyond_spec(name)
    big, _ = sk.sub_columns(m)
    assert nb * vl * m < 2 * LANES and spec.r > big
    for depth in (1, 2, LANES * big // spec.r + 3):
        _vl_check(name, m, nb, vl, depth, "ring", seed=depth, spec=spec)


@pytest.mark.parametrize("edge_mask", [True, False])
@pytest.mark.parametrize("name,m,nb,vl,k", [("1d5p", 5, 5, 32, 2), ("1d5p", 3, 9, 8, 3),
                                            ("1d5p", 7, 2, 16, 4)])
def test_warp_kernel_reach_beyond_m_edges_match_pallas(name, m, nb, vl, k, edge_mask):
    """K4a at r > M against the JAX package's Pallas kernel in interpret
    mode (2e-6, as above): the whole array with the ring, and at k·r or
    more from the ends with open ends."""
    t = _t(nb, m, seed=8, vl=vl)
    want = np.asarray(jlay.from_transpose_layout(
        jsk.stencil1d_multistep(jst.make(name), jnp.asarray(t), k, interpret=True,
                                edge_mask=edge_mask), vl, m))
    got, _ = warp_kernel_np(tst.make(name), t, k, "ring" if edge_mask else "open")
    got = tlay.from_transpose_layout(torch.from_numpy(got), vl, m).numpy()
    width = 0 if edge_mask else k * tst.make(name).r
    np.testing.assert_allclose(got[width:got.size - width], want[width:want.size - width],
                               rtol=2e-6, atol=2e-6)


@pytest.mark.parametrize("sweep,ttile", [("resident", 2), ("resident", 1), ("roundtrip", 1)])
@pytest.mark.parametrize("steps,remainder", [(16, "fused"), (7, "native")])
def test_main_path_1d5p_odd_m_matches_reference(sweep, ttile, steps, remainder):
    """``StencilProblem.run`` on 1d5p (800,), whose picker tile is vl=32,
    m=5 (sub-columns of 1: r = 2 > M = 1, the warp kernel's route), against
    the JAX package's run under the same explicit plan with Pallas in
    interpret mode, within 1e-6 in f32 (the reference may contract a
    multiply-add; at most 1.8e-7 was seen on 1d5p)."""
    from repro.core import api as japi
    from repro_torch.core.api import StencilPlan, StencilProblem
    from repro_torch.kernels import ops
    name, shape = "1d5p", (800,)
    vl, m, _ = ops.pick_tile(tst.make(name), shape)
    assert (vl, m) == (32, 5) and sk.sub_columns(m) == (1, 5)
    assert sk.sweep1d_route(vl, m, 2 * ttile, 2, 5) == "warp"
    x = np.random.default_rng(17).standard_normal(shape).astype(np.float32)
    jplan = japi.StencilPlan(scheme="transpose", backend="pallas", sweep=sweep, k=2,
                             remainder=remainder, ttile=ttile, vl=vl, m=m)
    want = np.asarray(japi.StencilProblem(name, shape).run(jnp.asarray(x), steps, jplan))
    plan = StencilPlan(backend="pallas", sweep=sweep, k=2, remainder=remainder, ttile=ttile,
                       vl=vl, m=m)
    got = StencilProblem(name, shape, device="cpu").run(torch.from_numpy(x), steps, plan)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    # the kernel's transcription on the same tile: the resident run's sweeps
    t = _t(800 // (vl * m), m, seed=17, vl=vl)
    got_np, _ = warp_sweep_np(tst.make(name), t, 2 * ttile)
    np.testing.assert_array_equal(
        got_np, sk.stencil1d_sweep_ttile_ref(tst.make(name), torch.from_numpy(t), 2, ttile).numpy())
