"""K3's and K4b's 2-D warp-register kernel (``csrc/sweep2d_warp.cu``),
transcribed into numpy line for line and held bit for bit against the plain
versions ``stencil_nd_sweep_ttile_ref`` (periodic) and
``stencil_nd_multistep_ref`` (the ring and open ends of axis 0), and the
route that picks it, at every reach r = 1..4.

The CPU has no CUDA compiler, so this transcription checks the kernel's
schedule: CTAs of ``kWarps`` warps on consecutive warp rows with the two
end warps as halo, lanes as an array axis, each lane's column (warp row v,
lane j: column 32·v + j mod C of a row's C = nb·vl columns) and its offset
in the (n0, nb, m, vl) layout at any m (the instance M =
``sub_columns(m)``: a layout column of m = g·M elements is g sub-columns
of M, sub-column u = g·c + h's element s at ((c // vl)·m + h·M + s)·vl +
c % vl of its row, C' = g·C of them; "column" below means sub-column, m
the instance's M and C the C'), a shuffle as a gather along the lane axis
with the select after it (halo element q of a column from the lane
d = 1 + q // M away, the lanes within d of a warp row's end taking the
neighbouring warp row's published edge element instead), the edge exchange
between warps through the edge slots (the r first and r last elements of
each warp row, from its ceil(r / M) end lanes), the segment's warm-up rows
with wrapped row
indices, the per-level skew of r + 1 rows with the levels run from the
deepest down, the ring of input rows filled ``kStages`` steps ahead, and
the store rule (a lane of a middle warp stores when its unwrapped column
lies in [0, C): each (row, column) written exactly once, also when C is
below 32 or no multiple of it); in the ring and open modes, the unwrapped
row indices, the input rows beyond the ends left unloaded (their ring
slots hold NaN here), and the CTA-uniform selects per level and step
(open: zeros beyond the ends, the input included; ring: the previous
level's row on the r first and last rows).  Two claims the kernel leans on
are checked as it runs: no edge slot is read and written in the same step
(there is one barrier per step), and no value made before a level's first
needed row, nor any row beyond the ends in ring mode, reaches a stored one
(windows, edge slots and unfilled ring slots start as NaN here; the kernel
zeroes its registers and edge slots).  A copy lands at once here, the
earliest the hardware could land it, so a ring slot reused too early would
show.  It runs in float32 with the float32-rounded coefficients summed in
the spec's order, as the kernel does under ``-fmad=false``.  CTAs run
together as an array axis; the kernel's loop over a shorter last segment
ends early, which the store guard's ``i < steps`` stands for.  A few cases
are also held against the JAX package's Pallas kernel in interpret mode at
the same (vl, m) (2e-6: XLA's CPU backend may contract a multiply-add into
an FMA); with open ends only at k·r or more rows from them, where the
reference's values are specified.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import stencils as jst
from repro.kernels import stencil_kernels as jsk
from repro_torch.core import layouts as tlay
from repro_torch.core import stencils as tst
from repro_torch.core.stencils import coeff
from repro_torch.kernels import stencil_kernels as sk

K_STAGES = 6     # csrc/sweep2d_warp.cu's kStages
LANES = 32       # a warp row: one column per lane
VL = 32
VLS = (1, 2, 4, 8, 16, 32, 64, 128)


def _needs_x(taps, r):
    """Which window rows take the lanes' x halo: at r = 1
    csrc/sweep2d_warp.cu's tap_order and needs_x (in the star order only the
    centre row; in any other, every row); at r > 1 the rows of a run of taps
    with one off x = 0 (Taps2's runs), here the rows with such a tap."""
    if r > 1:
        rows = {oy for oy, ox, _ in taps if ox != 0}
        return lambda oy: oy in rows
    star = [(0, 0)] + [(s * g, 0) for s in range(1, r + 1) for g in (-1, 1)] + \
        [(0, s * g) for s in range(1, r + 1) for g in (-1, 1)]
    if [(oy, ox) for oy, ox, _ in taps] == star:
        return lambda oy: oy == 0
    return lambda oy: True


def _spec(name):
    """A registry stencil, or ``star2d-r<r>`` / ``box2d-r<r>``: the star of
    reach r (``_star_taps``) and the box (``_box_taps``, at most 64 taps:
    the kernels' limit)."""
    if name.startswith(("star2d-r", "box2d-r")):
        r = int(name[-1])
        taps = tst._star_taps(2, r) if name.startswith("star") else tst._box_taps(2, r)
        return tst.StencilSpec(name, 2, r, name[:4], taps)
    return tst.make(name)


def warp2d_kernel_np(spec, t: np.ndarray, depth: int, seg: int, edge: str = "periodic"):
    """One launch of the kernel (a depth its instance has): its output and
    how often each (row, column) was stored."""
    n0, nb, m_layout, vl = t.shape
    assert sk.sweep2d_route(vl, m_layout, depth, spec.r, len(spec.taps)) == "warp"
    assert sk.sweep2d_launches(m_layout, depth, spec.r) == (sk.sub_columns(m_layout) + (depth,),)
    m, g = sk.sub_columns(m_layout)              # m: the instance's M from here on
    W, R, D = sk.WARP2D_WARPS, spec.r, depth
    NW, E, P = 2 * R + 1, 2 * R + 2, K_STAGES
    NS = P + 1
    taps = [(off[0], off[1], np.float32(coeff(c, torch.float32))) for off, c in spec.taps]
    needs_x = _needs_x(taps, R)
    C = nb * vl * g                              # C' sub-columns a row
    ncol, nseg = -(-sk.warp_rows(C) // (W - 2)), -(-n0 // seg)
    # CTA c = (column c % ncol, segment c // ncol), an array axis
    cta = np.arange(ncol * nseg)
    col, y0 = cta % ncol, cta // ncol * seg
    rows = np.minimum(seg, n0 - y0)
    steps, nload = rows + D * NW, rows + 2 * D * R
    base = y0 - D * R
    # level rows outside [lo, hi) are the ends' (ring: kept; open: zeros)
    lo, hi = (R, n0 - R) if edge == "ring" else (0, n0)
    w = np.arange(W)
    lane = np.arange(LANES)
    # each lane's column, unwrapped, and the offset of its element 0 in a row
    u = (col[:, None, None] * (W - 2) + w[None, :, None] - 1) * LANES + lane   # (ctas, W, lanes)
    c, h = u % C // g, u % C % g                 # column, its sub-column
    lane_col = c // vl * (m_layout * vl) + h * m * vl + c % vl
    elems = lane_col[:, :, None, :] + np.arange(m)[:, None] * vl             # (ctas, W, m, lanes)
    stores = ((w >= 1) & (w <= W - 2))[None, :, None] & (u < C)
    wl, wr = np.maximum(w - 1, 0), np.minimum(w + 1, W - 1)
    nan = np.float32(np.nan)
    rows_in = t.reshape(n0, -1)
    ring = np.full((NS, len(cta), W, m, LANES), nan, np.float32)
    edges = np.full((D, E, len(cta), W, 2, R), nan, np.float32)
    win = np.full((D, NW, len(cta), W, m, LANES), nan, np.float32)
    out = np.full_like(rows_in, np.nan)
    stored = np.zeros((n0, C), dtype=np.int64)

    def issue(p):
        y = base + p
        go = p < nload
        if edge != "periodic":
            ring[p % NS][go & ((y < 0) | (y >= n0))] = nan     # beyond the ends: not loaded
            go = go & (y >= 0) & (y < n0)
        ring[p % NS][go] = rows_in[(y % n0)[:, None, None, None], elems][go]

    def beyond(y, lo, hi):       # a CTA's row outside [lo, hi), over (W, m, lanes)
        return ((y < lo) | (y >= hi))[:, None, None, None]

    def shfl(x, src):
        return x[..., src]

    hh = np.arange(R)

    def publish(l, i, q, v, written):
        # the first R elements of each warp row (element h: lane h // m,
        # row h % m) and the last R (h from the end: lane 31 - h // m, row
        # m - 1 - h % m), from the ceil(R / m) lanes at each end
        win[l, q] = v
        edges[l, i % E, :, :, 0, :] = v[:, :, hh % m, hh // m]
        edges[l, i % E, :, :, 1, :] = v[:, :, m - 1 - hh % m, LANES - 1 - hh // m]
        written.add((l, i % E))

    for p in range(P):
        issue(p)
    for i in range(int(steps.max())):
        ph = i % NW
        cur = ring[i % NS].copy()
        if edge == "open":
            cur = np.where(beyond(base + i, 0, n0), np.float32(0), cur)
        read, written = set(), set()
        for lv in range(D, 0, -1):
            ext = []
            for k in range(NW):
                v = win[lv - 1, (ph + k) % NW]
                e = np.full(v.shape[:2] + (m + 2 * R, LANES), nan, np.float32)
                e[:, :, R:R + m] = v
                if needs_x(k - R):
                    es = (i + 1 + k) % E
                    read.add((lv - 1, es))
                    for q in range(R):
                        # halo element q from the lane d away; the lanes
                        # within d of the warp row's end take the
                        # neighbouring warp row's edge element instead
                        d, p = 1 + q // m, q % m
                        from_left = shfl(v[:, :, m - 1 - p], (lane - d) % LANES)
                        from_right = shfl(v[:, :, p], (lane + d) % LANES)
                        last = edges[lv - 1, es][:, wl, 1][..., np.maximum(d - 1 - lane, 0) * m + p]
                        first = edges[lv - 1, es][:, wr, 0][..., np.maximum(lane + d - LANES, 0) * m + p]
                        e[:, :, R - 1 - q] = np.where(lane < d, last, from_left)
                        e[:, :, R + m + q] = np.where(lane >= LANES - d, first, from_right)
                ext.append(e)
            acc = None
            for oy, ox, cf in taps:
                term = ext[R + oy][:, :, R + ox:R + ox + m] * cf
                acc = term if acc is None else acc + term
            if edge != "periodic":
                keep = ext[R][:, :, R:R + m] if edge == "ring" else np.float32(0)
                acc = np.where(beyond(base + i - lv * (R + 1), lo, hi), keep, acc)
            if lv == D:
                ok = stores & ((i >= D * NW) & (i < steps))[:, None, None]
                c_idx, w_idx, l_idx = np.nonzero(ok)
                y = y0[c_idx] + i - D * NW
                np.add.at(stored, (y, u[c_idx, w_idx, l_idx]), 1)
                for s_ in range(m):
                    out[y, lane_col[c_idx, w_idx, l_idx] + s_ * vl] = acc[c_idx, w_idx, s_, l_idx]
            else:
                publish(lv, i, ph, acc, written)
        publish(0, i, ph, cur, written)
        issue(i + P)
        assert not read & written, (i, read & written)   # one barrier per step
    return out.reshape(t.shape), stored


def _t(n0, nb, m, seed, vl=VL):
    x = np.random.default_rng(seed).standard_normal((n0, nb * vl * m)).astype(np.float32)
    return tlay.to_transpose_layout(torch.from_numpy(x), vl, m).numpy()


L = 4              # rows per segment in the transcription's cases
NB = sk.WARP2D_WARPS - 2
# (n0, nb) pairs: every n0 in {1, 2, L-1, L, L+1, 3L+2} and nb around the
# stored blocks of a CTA, several columns included
GRIDS = ((1, 1), (2, NB - 1), (L - 1, NB), (L, NB + 1), (L + 1, 2 * NB + 1), (3 * L + 2, NB))
# a layout m whose instance is M at reach r (m >= r): M itself where it
# reaches r, else sub-columns (M = 1: m = 3 or 5; M = 2: m = 6)
REACH_M = {(mm, r): mm if mm >= r else {1: 3 if r <= 3 else 5, 2: 6}[mm]
           for mm in sk.SUB_M for r in range(2, sk.WARP2D_MAX_R + 1)}
CASES = [(name, m, depth) for name in ("2d5p", "2d9p", "heat2d") for m in (1, 2, 4, 8)
         for depth in range(1, sk.WARP2D_DEPTH[m, 1] + 1)] + [
    (f"star2d-r{r}", REACH_M[mm, r], depth) for r in range(2, sk.WARP2D_MAX_R + 1)
    for mm in sk.SUB_M for depth in range(1, sk.WARP2D_DEPTH[mm, r] + 1)] + [
    ("box2d-r2", REACH_M[mm, 2], depth) for mm in sk.SUB_M
    for depth in range(1, sk.WARP2D_DEPTH[mm, 2] + 1)]


@pytest.mark.parametrize("name,m,depth", CASES)
def test_warp2d_kernel_schedule_bitwise(name, m, depth):
    """Every instance's depths on the transcription's grids, bit for bit
    the plain version, every element stored once; at r = 2..4 the star of
    reach r on every instance M (r > M on sub-columns: a halo from
    ceil(r / M) lanes) and the box of reach 2 (25 taps, 5 runs)."""
    spec = _spec(name)
    for n0, nb in GRIDS:
        t = _t(n0, nb, m, seed=n0 * 64 + nb * 4 + m)
        got, stored = warp2d_kernel_np(spec, t, depth, L)
        np.testing.assert_array_equal(stored, np.ones((n0, nb * VL * sk.sub_columns(m)[1]),
                                                      dtype=np.int64))
        want = sk.stencil_nd_sweep_ttile_ref(spec, torch.from_numpy(t), depth, 1, 1).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"n0={n0} nb={nb}")


# tap lists in no order the kernel knows at compile time: it reads them at
# run time (the registry's 2-D stencils all take a compile-time order; at
# r > 1 every list is read at run time, in runs of taps on one row: rows
# revisited, runs with no tap off x = 0, duplicates)
RUNTIME_TAPS = (
    (((0, 1), 0.125), ((0, -1), 0.125), ((1, 0), 0.125), ((-1, 0), 0.125), ((0, 0), 0.5)),
    (((0, 0), 0.375), ((-1, 1), 0.25), ((1, -1), 0.25), ((0, 0), 0.125)),     # (0,0) twice
    tuple(((oy, ox), (2 + oy + 3 * ox) / 40) for ox in (-1, 0, 1) for oy in (-1, 0, 1)),
    (((0, 2), 0.125), ((-2, 0), 0.125), ((0, -1), 0.0625), ((0, 0), 0.25), ((2, -2), 0.125),
     ((2, 1), 0.0625), ((-1, 0), 0.125), ((0, 2), 0.125)),                  # r = 2
    (((1, -3), 0.125), ((1, 3), 0.125), ((0, 0), 0.25), ((-3, 0), 0.125), ((-3, 0), 0.125),
     ((0, 4), 0.0625), ((-4, -4), 0.0625), ((2, 0), 0.125)),                # r = 4
)


def _reach(taps):
    return max(abs(o) for off, _ in taps for o in off)


@pytest.mark.parametrize("depth", [1, 3, 5])
@pytest.mark.parametrize("taps", RUNTIME_TAPS)
def test_warp2d_kernel_schedule_runtime_taps(taps, depth):
    """A sweep past the instance's deepest (r > 1) is the chain of
    ``sweep2d_launches``."""
    spec = tst.StencilSpec("custom2d", 2, _reach(taps), "box", taps)
    t = _t(2 * L + 1, NB + 3, 4, seed=9)
    got = warp2d_chain_np(spec, t, depth, L)
    want = sk.stencil_nd_sweep_ttile_ref(spec, torch.from_numpy(t), depth, 1, 1).numpy()
    np.testing.assert_array_equal(got, want)


def test_warp2d_kernel_schedule_matches_pallas():
    t = _t(8, 3, 2, seed=7)
    want = np.asarray(jsk.stencil_nd_sweep_ttile(jst.make("2d5p"), jnp.asarray(t), 2, 2, 4,
                                                 interpret=True))
    got, _ = warp2d_kernel_np(tst.make("2d5p"), t, 4, 3)
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=2e-6)


@pytest.mark.parametrize("vl,m,depth,r,route", [
    (32, 8, 4, 1, "warp"),        # the main path: 2d5p at 8192², k=2, ttile=2
    (32, 8, 1, 1, "warp"),
    (32, 8, 5, 1, "warp"),        # past the deepest m=8 instance: consecutive launches
    (32, 4, 8, 1, "warp"),
    (32, 4, 9, 1, "warp"),        # consecutive launches
    (32, 1, 8, 1, "warp"),
    (32, 2, 0, 1, "far"),         # depth 0: no instance
    (128, 8, 4, 1, "warp"),       # a plan carried over from the JAX package
    (16, 4, 2, 1, "warp"),
    (8, 8, 4, 1, "warp"),         # the reference tuner's vl 8
    (32, 3, 2, 1, "warp"),        # m = 3: sub-columns of 1
    (32, 16, 2, 1, "warp"),       # m = 16: sub-columns of 8
    (32, 8, 2, 2, "warp"),        # reach 2 on the warp kernel
    (32, 8, 2, 5, "far"),         # beyond the kernel's reach
    (4, 1, 8, 1, "warp"),
    (64, 2, 8, 1, "warp"),
    (128, 8, 5, 1, "warp"),       # past the deepest m=8 instance at any vl
    (8, 16, 4, 1, "warp"),        # a reference tuner pair: sub-columns of 8
    (16, 3, 2, 1, "warp"),        # the picker's 2d5p 64x48 tile: sub-columns of 1
    (8, 16, 5, 1, "warp"),        # past the deepest M = 8 instance
    (16, 32, 4, 1, "warp"),
    (16, 3, 8, 1, "warp"),        # the deepest M = 1 instance
    (16, 3, 9, 1, "warp"),
    (8, 6, 8, 1, "warp"),
    (8, 12, 9, 1, "warp"),
    (8, 8, 16, 1, "warp"),        # the reference tuner's deepest plan (k=4, ttile=4)
    (8, 8, 32, 1, "warp"),
    (8, 16, 2, 2, "warp"),        # reach 2 at any m
    (8, 16, 2, 5, "far"),         # beyond the kernel's reach at any m
    (8, 8, 4, 2, "warp"),         # the former K3-smem row's star: two depth-2 launches
    (8, 8, 16, 2, "warp"),        # the deepest plan at reach 2: eight launches
    (8, 3, 4, 3, "warp"),         # reach 3 > M = 1: a halo from three lanes
    (8, 5, 9, 4, "warp"),         # reach 4 > M = 1, past the deepest: a chain
    (1, 4, 300, 4, "warp"),
    (128, 8, 1, 4, "warp"),
    (8, 8, 1, 5, "far"),
    (8, 0, 2, 1, "far"),          # no column
])
def test_sweep2d_route(vl, m, depth, r, route):
    assert sk.sweep2d_route(vl, m, depth, r, 4 * r + 1) == route
    # more taps than the kernel holds (64) take the far-reach kernel
    assert sk.sweep2d_route(vl, m, depth, r, sk.ND_MAX_TAPS + 1) == "far"


@pytest.mark.parametrize("m,depth,launches", [
    (8, 4, ((8, 1, 4),)),                    # the main path's depth, on M = 8
    (8, 5, ((8, 1, 4), (8, 1, 1))),          # past M = 8's depth 4: two launches
    (8, 8, ((8, 1, 4),) * 2),                # the tuner's k=4, ttile=2
    (8, 16, ((8, 1, 4),) * 4),               # the tuner's k=4, ttile=4
    (8, 32, ((8, 1, 4),) * 8),
    (4, 8, ((4, 1, 8),)),
    (4, 16, ((4, 1, 8),) * 2),
    (2, 16, ((2, 1, 16),)),                  # the deep M = 2 instance
    (2, 32, ((2, 1, 16),) * 2),
    (2, 20, ((2, 1, 16), (2, 1, 4))),
    (1, 16, ((1, 1, 8),) * 2),
    (3, 9, ((1, 3, 8), (1, 3, 1))),
    (16, 8, ((8, 2, 4),) * 2),
    (32, 4, ((8, 4, 4),)),
    (6, 16, ((2, 3, 16),)),
    (12, 5, ((4, 3, 5),)),
    (12, 12, ((4, 3, 8), (4, 3, 4))),
])
def test_sweep2d_launches(m, depth, launches):
    """The largest M dividing m, each of its depths one launch (every depth
    up to WARP2D_DEPTH[M], and 16 at M = 2), deeper sweeps split."""
    assert sk.sweep2d_launches(m, depth, 1) == launches
    assert sum(d for _, _, d in launches) == depth
    assert all(big * g == m for big, g, _ in launches)


@pytest.mark.parametrize("n0,wrows,ctas,seg", [
    (8192, 32, 132, 249),         # 2d5p at 8192², m=8 on 132 SMs: 4 × 33 CTAs
    (8192, 32, 264, 125),
    (8192, 32, 8, 4096),
    (64, 32, 264, 32),            # no segment below WARP2D_SEG_MIN rows
    (1, 1, 264, 1),
    (100, 9, 264, 25),
])
def test_sweep2d_segment(n0, wrows, ctas, seg):
    assert sk.sweep2d_segment(n0, wrows, ctas) == seg


def test_cpu_wrapper_counts_no_route():
    spec = tst.make("2d5p")
    t = torch.from_numpy(_t(8, 4, 8, 1))
    sk.reset_launches()
    got = sk.stencil_nd_sweep_ttile(spec, t, 2, 2, 4)
    multi = sk.stencil_nd_multistep(spec, t, 2, 4, True)
    halo = sk.stencil_nd_sweep_halo(spec, t, 2, 4, 4)
    assert sk.LAUNCHES == dict.fromkeys(sk.LAUNCHES, 0)       # CPU: no kernel
    assert torch.equal(got, sk.stencil_nd_sweep_ttile_ref(spec, t, 2, 2, 4))
    assert torch.equal(multi, sk.stencil_nd_multistep_ref(spec, t, 2, 4, True))
    assert torch.equal(halo, sk.stencil_nd_multistep_ref(spec, t, 2, 4, False))
    assert {"sweep_2d", "sweep_far", "multistep_2d", "multistep_far"} <= set(sk.LAUNCHES)


# ---------------------------------------------------------------------------
# K4b: the ring and open ends of axis 0
# ---------------------------------------------------------------------------

def _edge_grids(depth, r=1):
    """GRIDS, and n0 where a segment of L rows starts or ends within
    depth·r rows of an end or the whole grid is no more than 2·depth·r
    rows: n0 = L + 1 (a one-row last segment), 2L + depth·r, and 2·depth·r
    (and 2·depth·r + 1)."""
    dr = depth * r
    extra = {(L + 1, 3), (2 * L + dr, NB + 2), (2 * dr, 2), (2 * dr + 1, NB)}
    return sorted(set(GRIDS) | extra)


def _edge_check(spec, t, depth, edge, seg=L):
    """One launch (or, past the instance's deepest, the chain) with the
    ends ``edge``, bit for bit the plain version; a launch stores every
    element once."""
    if len(sk.sweep2d_launches(t.shape[2], depth, spec.r)) > 1:
        got = warp2d_chain_np(spec, t, depth, seg, edge)
        assert np.isfinite(got).all()
        want = sk.stencil_nd_multistep_ref(spec, torch.from_numpy(t), depth, 1,
                                           edge == "ring").numpy()
        np.testing.assert_array_equal(got, want)
        return
    got, stored = warp2d_kernel_np(spec, t, depth, seg, edge)
    n0, nb, m, vl = t.shape
    np.testing.assert_array_equal(stored, np.ones((n0, nb * vl * sk.sub_columns(m)[1]),
                                                  dtype=np.int64))
    assert np.isfinite(got).all()            # nothing from beyond the ends (NaN there)
    want = sk.stencil_nd_multistep_ref(spec, torch.from_numpy(t), depth, 1,
                                       edge == "ring").numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("edge", ["ring", "open"])
@pytest.mark.parametrize("name,m,depth", CASES)
def test_warp2d_kernel_edges_bitwise(name, m, depth, edge):
    spec = _spec(name)
    for n0, nb in _edge_grids(depth, spec.r):
        _edge_check(spec, _t(n0, nb, m, seed=n0 * 64 + nb * 4 + m + depth), depth, edge)


@pytest.mark.parametrize("edge", ["ring", "open"])
@pytest.mark.parametrize("depth", [1, 3, 5])
@pytest.mark.parametrize("taps", RUNTIME_TAPS)
def test_warp2d_kernel_edges_runtime_taps(taps, depth, edge):
    spec = tst.StencilSpec("custom2d", 2, _reach(taps), "box", taps)
    _edge_check(spec, _t(2 * L + 1, NB + 3, 4, seed=9), depth, edge)


@pytest.mark.parametrize("edge_mask", [True, False])
def test_warp2d_kernel_edges_match_pallas(edge_mask):
    """Against the JAX package's Pallas kernel (k=2, t0=4): the whole
    array with the ring, and at k·r or more rows from the ends with open
    ends."""
    k, t = 2, _t(12, 3, 2, seed=5)
    want = np.asarray(jsk.stencil_nd_multistep(jst.make("2d5p"), jnp.asarray(t), k, 4,
                                               interpret=True, edge_mask=edge_mask))
    got, _ = warp2d_kernel_np(tst.make("2d5p"), t, k, 3, "ring" if edge_mask else "open")
    width = 0 if edge_mask else k * tst.make("2d5p").r
    np.testing.assert_allclose(got[width:t.shape[0] - width], want[width:t.shape[0] - width],
                               rtol=2e-6, atol=2e-6)


# ---------------------------------------------------------------------------
# any vl: a warp covers 32 columns of a row
# ---------------------------------------------------------------------------

def _vl_grids(vl):
    """(n0, nb) for a vl case: C = nb·vl near 5 and 20 columns (below a
    warp row where vl allows) and near 32·(kWarps - 2) + 40 (two CTA
    columns, the last warp row partial unless vl is 64 or more)."""
    return [(n0, -(-c // vl)) for n0, c in ((3, 5), (L + 1, 20), (2 * L + 3, 32 * NB + 40))]


VL_CASES = [("2d5p", 1), ("2d9p", 2), ("heat2d", 4), ("2d5p", 8)]


@pytest.mark.parametrize("edge", ["periodic", "ring", "open"])
@pytest.mark.parametrize("vl", VLS)
@pytest.mark.parametrize("name,m", VL_CASES)
def test_warp2d_kernel_any_vl_bitwise(name, m, vl, edge):
    """Every vl, at C below 32, no multiple of 32 and over two CTA
    columns; depth 1 and the deepest instance."""
    spec = tst.make(name)
    for n0, nb in _vl_grids(vl):
        for depth in (1, sk.WARP2D_DEPTH[m, 1]):
            t = _t(n0, nb, m, seed=n0 * 64 + nb * 4 + vl + depth, vl=vl)
            if edge == "periodic":
                got, stored = warp2d_kernel_np(spec, t, depth, L)
                np.testing.assert_array_equal(stored, np.ones((n0, nb * vl), dtype=np.int64))
                want = sk.stencil_nd_sweep_ttile_ref(spec, torch.from_numpy(t), depth, 1, 1)
                np.testing.assert_array_equal(got, want.numpy(),
                                              err_msg=f"vl={vl} n0={n0} nb={nb} d={depth}")
            else:
                _edge_check(spec, t, depth, edge)


@pytest.mark.parametrize("vl,m,k,ttile", [(8, 2, 2, 2), (16, 4, 3, 1), (128, 1, 2, 2),
                                          (4, 8, 2, 1)])
def test_warp2d_kernel_any_vl_matches_pallas(vl, m, k, ttile):
    t = _t(8, 3, m, seed=7, vl=vl)
    want = np.asarray(jsk.stencil_nd_sweep_ttile(jst.make("2d5p"), jnp.asarray(t), k, ttile, 4,
                                                 interpret=True))
    got, _ = warp2d_kernel_np(tst.make("2d5p"), t, k * ttile, 3)
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=2e-6)


@pytest.mark.parametrize("edge_mask", [True, False])
@pytest.mark.parametrize("vl,m", [(8, 4), (128, 1)])
def test_warp2d_kernel_any_vl_edges_match_pallas(vl, m, edge_mask):
    """Against the JAX package's Pallas kernel at the same (vl, m) (k=2,
    t0=4): the whole array with the ring, and at k·r or more rows from the
    ends with open ends."""
    k, t = 2, _t(12, 3, m, seed=5, vl=vl)
    want = np.asarray(jsk.stencil_nd_multistep(jst.make("2d5p"), jnp.asarray(t), k, 4,
                                               interpret=True, edge_mask=edge_mask))
    got, _ = warp2d_kernel_np(tst.make("2d5p"), t, k, 3, "ring" if edge_mask else "open")
    width = 0 if edge_mask else k * tst.make("2d5p").r
    np.testing.assert_allclose(got[width:t.shape[0] - width], want[width:t.shape[0] - width],
                               rtol=2e-6, atol=2e-6)


# ---------------------------------------------------------------------------
# any m: a column of m = g·M points is g sub-columns of M
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("edge", ["periodic", "ring", "open"])
@pytest.mark.parametrize("vl", [1, 4, 8, 32])
@pytest.mark.parametrize("m", [3, 5, 6, 12, 16, 32])
def test_warp2d_kernel_sub_columns_bitwise(m, vl, edge):
    """m off {1, 2, 4, 8} on the instance M with g = m / M sub-columns a
    column (vl = 32 too: the any-vl instances): 2d5p at depth 1 and the
    deepest instance of M, 2d9p at depth 2, on grids of C' = nb·vl·g
    sub-columns near 5 and 20 (below a warp row where vl and g allow) and
    near 32·(kWarps - 2) + 40 (two CTA columns, the last warp row
    partial), bit for bit the plain versions, every element stored once."""
    big, g = sk.sub_columns(m)
    cases = [("2d5p", 1), ("2d5p", sk.WARP2D_DEPTH[big, 1]), ("2d9p", 2)]
    for n0, c in ((3, 5), (L + 1, 20), (2 * L + 3, 32 * NB + 40)):
        nb = -(-c // (vl * g))
        for name, depth in cases:
            spec = tst.make(name)
            t = _t(n0, nb, m, seed=n0 * 64 + nb * 4 + vl + m + depth, vl=vl)
            if edge == "periodic":
                got, stored = warp2d_kernel_np(spec, t, depth, L)
                np.testing.assert_array_equal(stored, np.ones((n0, nb * vl * g), dtype=np.int64))
                want = sk.stencil_nd_sweep_ttile_ref(spec, torch.from_numpy(t), depth, 1, 1)
                np.testing.assert_array_equal(got, want.numpy(),
                                              err_msg=f"{name} n0={n0} nb={nb} d={depth}")
            else:
                _edge_check(spec, t, depth, edge)


@pytest.mark.parametrize("vl,m", [(8, 16), (16, 3)])
def test_warp2d_kernel_sub_columns_match_pallas(vl, m):
    """Against the JAX package's Pallas kernel in interpret mode at the
    same (vl, m) (rtol = atol = 2e-6, as above; k=2, t0=4): the periodic
    sweep at ttile 2, the ring over the whole array and open ends at k·r or
    more rows from them."""
    k, t = 2, _t(12, 3, m, seed=17, vl=vl)
    spec, jspec = tst.make("2d5p"), jst.make("2d5p")
    want = np.asarray(jsk.stencil_nd_sweep_ttile(jspec, jnp.asarray(t), k, 2, 4, interpret=True))
    got, _ = warp2d_kernel_np(spec, t, 2 * k, 3)
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=2e-6)
    for edge_mask in (True, False):
        want = np.asarray(jsk.stencil_nd_multistep(jspec, jnp.asarray(t), k, 4, interpret=True,
                                                   edge_mask=edge_mask))
        got, _ = warp2d_kernel_np(spec, t, k, 3, "ring" if edge_mask else "open")
        width = 0 if edge_mask else k * spec.r
        np.testing.assert_allclose(got[width:t.shape[0] - width],
                                   want[width:t.shape[0] - width], rtol=2e-6, atol=2e-6)


# ---------------------------------------------------------------------------
# deep sweeps: the instances of M < 8 past M = 8's depth 4 (the deep M = 2
# at depth 16 too), and the split into consecutive launches
# ---------------------------------------------------------------------------

# (m, depth): one launch of the instance M of m (the largest dividing it):
# M = 4 at depths 5 and 8 (g = 3, 1), M = 2 at 16 and 6 (g = 3, 1, 5), M = 1
# at 8 (g = 3)
DEEP_CASES = [(12, 5), (4, 8), (6, 16), (6, 6), (3, 8), (2, 16), (10, 16)]


@pytest.mark.parametrize("edge", ["periodic", "ring", "open"])
@pytest.mark.parametrize("m,depth", DEEP_CASES)
def test_warp2d_kernel_deep_bitwise(m, depth, edge):
    """One launch of the instance ``M`` at ``m = g·M``, bit for bit the
    plain versions, every element stored once; grids whose segments start
    or end within depth·r rows of an end, and of two CTA columns."""
    spec = tst.make("2d5p")
    _, g = sk.sub_columns(m)
    for n0, c in ((3, 20), (2 * depth + 1, 32 * NB + 40), (2 * L + depth, 40)):
        nb = -(-c // (8 * g))
        t = _t(n0, nb, m, seed=n0 * 64 + nb * 4 + m + depth, vl=8)
        got, stored = warp2d_kernel_np(spec, t, depth, L, edge)
        np.testing.assert_array_equal(stored, np.ones((n0, nb * 8 * g), dtype=np.int64))
        if edge == "periodic":
            want = sk.stencil_nd_sweep_ttile_ref(spec, torch.from_numpy(t), depth, 1, 1)
        else:
            assert np.isfinite(got).all()
            want = sk.stencil_nd_multistep_ref(spec, torch.from_numpy(t), depth, 1,
                                               edge == "ring")
        np.testing.assert_array_equal(got, want.numpy(), err_msg=f"n0={n0} nb={nb}")


def warp2d_chain_np(spec, t: np.ndarray, depth: int, seg: int, edge: str = "periodic"):
    """The launches ``sweep2d_launches`` names, one after another (the
    wrapper's chain through a scratch buffer)."""
    for _, _, d in sk.sweep2d_launches(t.shape[2], depth, spec.r):
        t, _ = warp2d_kernel_np(spec, t, d, seg, edge)
    return t


@pytest.mark.parametrize("edge", ["periodic", "ring", "open"])
@pytest.mark.parametrize("m,depth", [(8, 12), (8, 32), (1, 16), (3, 9), (2, 20)])
def test_warp2d_kernel_split_bitwise(m, depth, edge):
    """A depth no instance has: consecutive launches, bit for bit one
    depth-``depth`` plain sweep."""
    assert len(sk.sweep2d_launches(m, depth, 1)) > 1
    spec = tst.make("2d9p")
    t = _t(2 * depth + 3, 5, m, seed=depth + m, vl=8)
    got = warp2d_chain_np(spec, t, depth, L, edge)
    if edge == "periodic":
        want = sk.stencil_nd_sweep_ttile_ref(spec, torch.from_numpy(t), depth, 1, 1)
    else:
        want = sk.stencil_nd_multistep_ref(spec, torch.from_numpy(t), depth, 1, edge == "ring")
    np.testing.assert_array_equal(got, want.numpy())


# the reference tuner's deep plans (k = 4, ttile = 2 and 4) on the JAX
# package's Pallas kernel in interpret mode: 2d5p (64, 256) at vl=8, m=8,
# t0 = 16 (rtol = atol = 2e-6, as above)
@pytest.mark.parametrize("k,ttile", [(4, 2), (4, 4)])
def test_deep_sweep_matches_pallas(k, ttile):
    """Against the port's ``stencil_nd_sweep_ttile`` (its plain version on
    the CPU) and the launches ``sweep2d_launches`` names, transcribed."""
    spec, jspec = tst.make("2d5p"), jst.make("2d5p")
    t = _t(64, 4, 8, seed=k * ttile, vl=8)
    want = np.asarray(jsk.stencil_nd_sweep_ttile(jspec, jnp.asarray(t), k, ttile, 16,
                                                 interpret=True))
    port = sk.stencil_nd_sweep_ttile(spec, torch.from_numpy(t), k, ttile, 16).numpy()
    np.testing.assert_allclose(port, want, rtol=2e-6, atol=2e-6)
    np.testing.assert_array_equal(warp2d_chain_np(spec, t, k * ttile, 16), port)


@pytest.mark.parametrize("edge_mask", [True, False])
@pytest.mark.parametrize("k", [8, 16])
def test_deep_multistep_matches_pallas(k, edge_mask):
    """K4b at k = 8 and 16: the ring over the whole array, open ends at k·r
    or more rows from them (ROADMAP C)."""
    spec, jspec = tst.make("2d5p"), jst.make("2d5p")
    t = _t(64, 4, 8, seed=k + edge_mask, vl=8)
    want = np.asarray(jsk.stencil_nd_multistep(jspec, jnp.asarray(t), k, 16, interpret=True,
                                               edge_mask=edge_mask))
    port = sk.stencil_nd_multistep(spec, torch.from_numpy(t), k, 16, edge_mask).numpy()
    width = 0 if edge_mask else k * spec.r
    np.testing.assert_allclose(port[width:64 - width], want[width:64 - width],
                               rtol=2e-6, atol=2e-6)
    got = warp2d_chain_np(spec, t, k, 16, "ring" if edge_mask else "open")
    np.testing.assert_array_equal(got, port)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5])
def test_chain_alternates_buffers(n):
    """The wrappers' chain of n launches: each reads the last one's output,
    none writes its own input, the last writes ``dst``."""
    t, dst = torch.arange(3.0), torch.zeros(3)
    outs = []

    def launch(src, out, d):
        assert src.data_ptr() != out.data_ptr()
        out.copy_(src + d)
        outs.append(out)
    sk._chain(launch, t, dst, ((8, 1, 2),) * n)
    assert len(outs) == n and outs[-1] is dst
    assert torch.equal(dst, torch.arange(3.0) + 2 * n) and torch.equal(t, torch.arange(3.0))


# ---------------------------------------------------------------------------
# reach r = 2..4: the launch plans, any vl, chains, and the Pallas kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,depth,r,launches", [
    (8, 4, 2, ((8, 1, 2),) * 2),             # the former K3-smem row: two depth-2 launches
    (8, 2, 2, ((8, 1, 2),)),
    (8, 5, 2, ((8, 1, 2), (8, 1, 2), (8, 1, 1))),
    (8, 16, 2, ((8, 1, 2),) * 8),            # the tuner's deepest plan
    (8, 3, 3, ((8, 1, 1),) * 3),
    (8, 2, 4, ((8, 1, 1),) * 2),
    (4, 4, 2, ((4, 1, 2),) * 2),
    (4, 7, 3, ((4, 1, 2),) * 3 + ((4, 1, 1),)),
    (4, 4, 4, ((4, 1, 2),) * 2),
    (2, 4, 2, ((2, 1, 2),) * 2),
    (6, 9, 3, ((2, 3, 2),) * 4 + ((2, 3, 1),)),
    (5, 8, 4, ((1, 5, 2),) * 4),             # r = 4 > M = 1: depth-2 launches
    (3, 5, 3, ((1, 3, 2), (1, 3, 2), (1, 3, 1))),
    (16, 4, 2, ((8, 2, 2),) * 2),
    (16, 1, 4, ((8, 2, 1),)),
])
def test_sweep2d_launches_reach(m, depth, r, launches):
    """At r > 1 the deepest instance of (M, r) is WARP2D_DEPTH[M, r]
    (its windows hold depth·(2r + 1)·M values a lane); deeper sweeps split."""
    assert sk.sweep2d_launches(m, depth, r) == launches
    assert sum(d for _, _, d in launches) == depth
    assert all(d * r <= LANES * big for big, _, d in launches)


def test_sweep2d_reach_tables():
    """Every (M, r) up to WARP2D_MAX_R has depths 1..WARP2D_DEPTH[M, r]
    within its halo warps (depth·r <= 32·M), and only r > 4 leaves the
    register kernel at any vl, m >= 1 and depth >= 1."""
    for r in range(1, sk.WARP2D_MAX_R + 1):
        for big in sk.SUB_M:
            assert sk.WARP2D_DEPTH[big, r] >= 1
            assert all(d * r <= LANES * big for d in sk.sweep2d_depths(r)[big])
    assert sk.WARP2D_MAX_R == sk.WARP_MAX_R == 4
    for vl in (1, 3, 8, 32, 128):
        for m in (1, 2, 3, 5, 8, 16):
            for depth in (1, 2, 5, 33):
                for r in range(1, 7):
                    assert sk.sweep2d_route(vl, m, depth, r, 4 * r + 1) == \
                        ("warp" if r <= 4 else "far")


REACH_VL_CASES = [(r, vl, m) for r, m in ((2, 8), (2, 2), (3, 3), (4, 4), (4, 5), (3, 6))
                  for vl in (1, 8, 128)]


@pytest.mark.parametrize("edge", ["periodic", "ring", "open"])
@pytest.mark.parametrize("r,vl,m", REACH_VL_CASES)
def test_warp2d_kernel_reach_any_vl_bitwise(r, vl, m, edge):
    """The star of reach r off vl = 32 (the r > 1 instances' one form), at
    C' near 20 and over two CTA columns, at depth 1 and the deepest
    instance, bit for bit the plain versions, every element stored once."""
    spec = _spec(f"star2d-r{r}")
    big, g = sk.sub_columns(m)
    for n0, c in ((L + 1, 20), (2 * L + 3, 32 * NB + 40)):
        nb = -(-c // (vl * g))
        for depth in sorted({1, sk.WARP2D_DEPTH[big, r]}):
            t = _t(n0, nb, m, seed=n0 + nb + vl + m + depth + r, vl=vl)
            if edge == "periodic":
                got, stored = warp2d_kernel_np(spec, t, depth, L)
                np.testing.assert_array_equal(stored, np.ones((n0, nb * vl * g), dtype=np.int64))
                want = sk.stencil_nd_sweep_ttile_ref(spec, torch.from_numpy(t), depth, 1, 1)
                np.testing.assert_array_equal(got, want.numpy())
            else:
                _edge_check(spec, t, depth, edge)


@pytest.mark.parametrize("edge", ["periodic", "ring", "open"])
@pytest.mark.parametrize("r,m,depth", [(2, 8, 5), (3, 4, 7), (4, 5, 9), (2, 6, 10)])
def test_warp2d_kernel_reach_split_bitwise(r, m, depth, edge):
    """Past the deepest instance of (M, r): the chain of
    ``sweep2d_launches``, bit for bit one depth-``depth`` plain sweep."""
    spec = _spec(f"star2d-r{r}")
    assert len(sk.sweep2d_launches(m, depth, r)) > 1
    t = _t(2 * depth * r + 3, 5, m, seed=depth + m + r, vl=8)
    got = warp2d_chain_np(spec, t, depth, L, edge)
    if edge == "periodic":
        want = sk.stencil_nd_sweep_ttile_ref(spec, torch.from_numpy(t), depth, 1, 1)
    else:
        want = sk.stencil_nd_multistep_ref(spec, torch.from_numpy(t), depth, 1, edge == "ring")
    np.testing.assert_array_equal(got, want.numpy())


@pytest.mark.parametrize("edge", ["periodic", "ring", "open"])
@pytest.mark.parametrize("r,vl,m", [(2, 8, 8), (3, 8, 3), (4, 4, 4), (2, 16, 6)])
def test_warp2d_kernel_reach_matches_pallas(r, vl, m, edge):
    """The star of reach r (each package's own ``_star_taps(2, r)``) against
    the JAX package's Pallas kernel in interpret mode at the same (vl, m)
    (rtol = atol = 2e-6, as above; k=2, t0 = 2r): the periodic sweep at
    ttile 2 (depth 4, the chain of ``sweep2d_launches``), the ring over the
    whole array, open ends at k·r or more rows from them."""
    k, t0 = 2, 2 * r
    t = _t(4 * t0, 3, m, seed=r + vl + m, vl=vl)
    spec = _spec(f"star2d-r{r}")
    jspec = jst.StencilSpec(f"star2d-r{r}", 2, r, "star", jst._star_taps(2, r))
    if edge == "periodic":
        want = jsk.stencil_nd_sweep_ttile(jspec, jnp.asarray(t), k, 2, t0, interpret=True)
        got = warp2d_chain_np(spec, t, 2 * k, 3)
        width = 0
    else:
        want = jsk.stencil_nd_multistep(jspec, jnp.asarray(t), k, t0, interpret=True,
                                        edge_mask=edge == "ring")
        got = warp2d_chain_np(spec, t, k, 3, edge)
        width = k * r if edge == "open" else 0
    want = np.asarray(want)
    n0 = t.shape[0]
    np.testing.assert_allclose(got[width:n0 - width], want[width:n0 - width],
                               rtol=2e-6, atol=2e-6)


def test_register_kernels_tap_limit():
    """A 2-D or 3-D stencil of more taps than the register kernels hold
    (``ND_MAX_TAPS``) takes the far-reach kernel and runs: the box of reach
    4 (81 taps) as four depth-1 launches, the far-reach kernel's schedule
    (transcribed in ``test_torch_sweep_far.py``) bit for bit the plain
    version on the CPU; that of reach 3 (49) stays on the warp kernel."""
    from test_torch_sweep_far import far_chain_np
    for r, route in ((3, "warp"), (4, "far")):
        spec = tst.StencilSpec(f"box2d-r{r}", 2, r, "box", tst._box_taps(2, r))
        assert sk.sweep2d_route(8, 8, 4, r, len(spec.taps)) == route
    assert sk.far_launches(2, 8, 4, 4, 81) == ((8, 1, 1),) * 4
    t = torch.from_numpy(_t(16, 2, 8, 4))
    got = far_chain_np(spec, t, 4)
    assert torch.equal(got, sk.stencil_nd_sweep_ttile(spec, t, 2, 2, 8))
    assert bool(torch.isfinite(got).all())