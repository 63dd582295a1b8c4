"""K3's and K4b's 3-D streaming kernel (``csrc/sweep3d.cu``), transcribed
into numpy line for line and held bit for bit against the plain versions
``stencil_nd_sweep_ttile_ref`` (periodic) and ``stencil_nd_multistep_ref``
(the ring and open ends of axis 0), and the route that picks it, at every
reach r = 1..4.

The CPU has no CUDA compiler, so this transcription checks the kernel's
schedule: CTAs over (column tile, row tile, z segment) with ``Hx`` halo
columns and ``Hy`` halo rows per side (columns wrapped mod C' = g·nb·vl,
rows mod n1), the threads of a CTA as an array axis (thread t owns column
t % Cx of row t // Cx), each thread's device-memory offsets at any vl and
m (the instance M = ``sub_columns(m)``: a layout column of m = g·M
elements is g sub-columns of M, sub-column u = g·c + h's element s at
((c // vl)·m + h·M + s)·vl + c % vl of its row: loads and stores through
those flat offsets; "column" below means sub-column), the shared-memory
planes stored [element][thread] with r·Cx + ceil(r / M)
unwritten words on each side, the input ring filled ``kStages`` planes
ahead, the segment's warm-up planes with wrapped plane indices, the
per-level skew of r + 1 planes with the levels run from the deepest down,
each level's own column of its last 2r + 1 planes in registers (at r > 1
only for the star of reach 2: any other tap list of r > 1 reads every tap
from shared memory), its published planes (the star r steps late into 2
slots, the others at once into 2r + 2),
a warp skipping a level whose rows it makes no stored row needs (its
registers and published rows of that level keep what they held), and the
store guard (each element written exactly once, also when C is below
the 16 stored columns of a tile or no multiple of them); in
the ring and open modes, the unwrapped plane indices, the input planes
beyond the ends left unloaded (ring: their slots hold NaN here) or written
as zeros (open), and the CTA-uniform selects per level and step (open:
zeros beyond the ends; ring: the previous level's plane on the r first and
last planes).  The claims the kernel leans on are checked as it runs: every
slot a step reads holds the plane the schedule says (a copy lands at once
here, the earliest the hardware could land it, so a slot reused too early
would show), no slot is read and written in one step (there is one barrier
per step), and nothing unwritten reaches a stored value (shared memory,
pads and registers start as NaN here; the kernel zeroes them).  It runs in
float32 with the float32-rounded coefficients summed in the spec's order,
as the kernel does under ``-fmad=false``.  CTAs run together as an array
axis; the kernel's loop over a shorter last segment ends early, which the
store guard's ``i < steps`` stands for.  A case per mode is also held
against the JAX package's Pallas kernel in interpret mode (2e-6: XLA's CPU
backend may contract a multiply-add into an FMA); with open ends only at
k·r or more planes from them, where the reference's values are specified.
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

VL = 32
VLS = (1, 4, 8, 16, 64, 128)     # the any-vl cases' vl (vl = 32: the cases above them)


def sweep3d_kernel_np(spec, t: np.ndarray, depth: int, seg: int, edge: str = "periodic"):
    """One launch of the kernel (a depth it has): its output and how often
    each of its elements was stored."""
    n0, n1, nb, m_layout, vl = t.shape
    R = spec.r
    assert sk.sweep3d_route(vl, m_layout, depth, R, len(spec.taps)) == "stream"
    assert sk.sweep3d_launches(m_layout, depth, R) == (sk.sub_columns(m_layout) + (depth,),)
    order = sk.sweep3d_order(spec)
    m, g = sk.sub_columns(m_layout)            # m: the instance's M from here on
    Ty, Cx, Hx, Hy = sk.sweep3d_tile(m, depth, order, R)
    D, NW, L, NS = depth, 2 * R + 1, sk.SWEEP3D_LANES, sk.sweep3d_slots(depth, R)
    STAGES = NS - 2 * R - 2      # input planes in flight beyond the landed one
    star_pub = order == "star"                   # publish R steps late, 2 slots
    # a level keeps its column's planes in registers, unless the taps of
    # r > 1 are read at run time
    regs = R == 1 or order != "runtime"
    E = 2 if star_pub else 2 * R + 2
    A, P = Ty * Cx, R * Cx - (-R // m)           # threads; unwritten words per side
    taps = [(off, np.float32(coeff(c, torch.float32))) for off, c in spec.taps]
    ncol = nb * vl * g                           # C' sub-columns a row
    ntx, nty, nseg = -(-ncol // L), -(-n1 // (Ty - 2 * Hy)), -(-n0 // seg)
    cta = np.arange(ntx * nty * nseg)
    xt, yt, z0 = cta % ntx, cta // ntx % nty, cta // ntx // nty * seg
    rows = np.minimum(seg, n0 - z0)
    steps, nload = rows + D * NW, rows + 2 * D * R
    base = z0 - D * R
    lo, hi = (R, n0 - R) if edge == "ring" else (0, n0)
    th = np.arange(A)
    ty, cx = th // Cx, th % Cx
    wrow0, wrow1 = (th & ~31) // Cx, np.minimum(th | 31, A - 1) // Cx   # a warp's rows
    gu = xt[:, None] * L - Hx + cx[None, :]                  # (ctas, A)
    yu = yt[:, None] * (Ty - 2 * Hy) - Hy + ty[None, :]
    u, y = gu % ncol, yu % n1
    c, h = u // g, u % g                                     # column, its sub-column
    stores = (cx >= Hx) & (cx < Cx - Hx) & (gu < ncol) & (ty >= Hy) & (ty < Ty - Hy) & (yu < n1)
    row = nb * vl * m_layout
    plane = n1 * row
    col = y * row + c // vl * (vl * m_layout) + h * m * vl + c % vl   # element 0 in plane 0
    elems = col[:, None, :] + np.arange(m)[:, None] * vl     # (ctas, m, A): s·vl on
    flat_in = t.reshape(-1)
    nan = np.float32(np.nan)
    # shared memory: [slot][cta][element][P + thread], and the slots' tags
    ring = np.full((NS, len(cta), m, A + 2 * P), nan, np.float32)
    ring_tag = np.full((NS, len(cta)), -10**9)
    levels = np.full((max(D - 1, 1), E, len(cta), m, A + 2 * P), nan, np.float32)
    level_tag = np.full((max(D - 1, 1), E, len(cta)), -10**9)
    win = np.full((max(D - 1, 1), NW, len(cta), A, m), nan, np.float32)
    out = np.full(t.size, np.nan, np.float32)
    stored = np.zeros(t.size, dtype=np.int64)

    def issue(p):
        z = base + p
        slot = ring[p % NS]
        slot[:] = nan                                    # not loaded: unknown
        go = p < nload
        if edge != "periodic":
            beyond = go & ((z < 0) | (z >= n0))
            if edge == "open":
                slot[beyond, :, P:P + A] = 0             # written as zeros
            go = go & ~beyond
        slot[go, :, P:P + A] = flat_in[(z % n0)[:, None, None] * plane + elems][go]
        ring_tag[p % NS] = p

    def beyond(zz, lo, hi):      # a CTA's plane outside [lo, hi), over (A, m)
        return ((zz < lo) | (zz >= hi))[:, None, None]

    def column(src, e, dc):      # element e of column t + dc of a plane, every thread
        return src[:, e, P + dc:P + dc + A]

    reach = {}                   # (k, oy): the taps' least and largest ox
    for (oz, oy, ox), _ in taps:
        lo_hi = reach.get((oz + R, oy), (ox, ox))
        reach[oz + R, oy] = (min(lo_hi[0], ox), max(lo_hi[1], ox))
    for p in range(STAGES):
        issue(p)
    for i in range(int(steps.max())):
        ph = i % NW
        read, written = set(), set()
        ring_slot = [(i - 1 - 2 * R + k) % NS for k in range(NW)]
        pub = [(i + 1) % E if star_pub else (i - 1 - 2 * R + k) % E for k in range(NW)]
        for lv in range(D, 0, -1):
            # the warps with rows of [lv r, Ty - lv r) make level lv; the
            # others skip it (their rows of level lv stay as they were)
            live = ~((wrow1 < lv * R) | (wrow0 >= Ty - lv * R))
            # ext[(k, oy)][..., x + 1]: element x = -1..m of the column at
            # row offset oy of the source level's plane k (made at step
            # i - 1 - 2r + k): registers for its own column, shared memory
            # for the rest
            def ext(k, oy, lv=lv):
                made = i - 1 - 2 * R + k
                if lv == 1:
                    src = ring[ring_slot[k]]
                    read.add(("ring", ring_slot[k]))
                    assert (ring_tag[ring_slot[k]] == made).all() or made < 0, (i, k)
                    own = None
                else:
                    own = win[lv - 2, (ph + k) % NW] if regs else None
                    src = levels[lv - 2, pub[k]]
                e = np.full((len(cta), A, m + 2 * R), nan, np.float32)
                for x in range(reach[k, oy][0], m + reach[k, oy][1]):   # what the taps read
                    if own is not None and oy == 0 and 0 <= x < m:
                        e[..., x + R] = own[..., x]
                        continue
                    if lv > 1:
                        read.add((lv - 2, pub[k]))
                        assert not star_pub or k == R, "the star reads neighbours on the centre"
                        want = i - 2 * R - 1 + k if not star_pub else i - 1 - R
                        assert (level_tag[lv - 2, pub[k]] == want).all() or want < 0, (i, lv, k)
                    e[..., x + R] = column(src, x % m, oy * Cx + (x // m))
                return e

            cache = {}
            acc = None
            for (oz, oy, ox), cf in taps:
                key = (oz + R, oy)
                if key not in cache:
                    cache[key] = ext(*key)
                term = cache[key][..., R + ox:R + ox + m] * cf
                acc = term if acc is None else acc + term
            if edge != "periodic":
                if edge == "ring":     # the source's own column of the centre plane
                    if (R, 0) not in reach:
                        reach[R, 0] = (0, 0)
                    keep = (cache[R, 0] if (R, 0) in cache else ext(R, 0))[..., R:R + m]
                else:
                    keep = np.float32(0)
                acc = np.where(beyond(base + i - lv * (R + 1), lo, hi), keep, acc)
            if lv == D:
                ok = stores & live & ((i >= D * NW) & (i < steps))[:, None]
                c_idx, t_idx = np.nonzero(ok)
                zz = z0[c_idx] + i - D * NW
                for s_ in range(m):
                    dst = zz * plane + col[c_idx, t_idx] + s_ * vl
                    np.add.at(stored, dst, 1)
                    out[dst] = acc[c_idx, t_idx, s_]
            else:
                slot = i % E
                written.add((lv - 1, slot))
                # the star publishes the plane it made R steps ago
                pubv = win[lv - 1, (ph + R + 1) % NW] if star_pub else acc
                levels[lv - 1, slot][:, :, P + th[live]] = np.moveaxis(pubv[:, live], -1, 1)
                level_tag[lv - 1, slot] = i - R if star_pub else i
                if regs:
                    win[lv - 1, ph][:, live] = acc[:, live]
        written.add(("ring", (i + STAGES) % NS))
        issue(i + STAGES)
        assert not read & written, (i, read & written)   # one barrier per step
    return out.reshape(t.shape), stored.reshape(t.shape)


def _t(n0, n1, nb, m, seed, vl=VL):
    x = np.random.default_rng(seed).standard_normal((n0, n1, nb * vl * m)).astype(np.float32)
    return tlay.to_transpose_layout(torch.from_numpy(x), vl, m).numpy()


S = 3              # planes per segment in the transcription's cases
# (n0, n1, nb): every n0 in {1, 2, S, S+1, 3S+1}, n1 below, at and above a
# tile's stored rows (the tile's rows exceed 2·depth + 12 at every instance
# but one), nb 1 (the tile wraps onto its own block) and 2, 3 (several
# column tiles)
GRIDS = ((1, 1, 1), (2, 5, 2), (S, 3, 1), (S + 1, 13, 3), (3 * S + 1, 2, 1))
# a layout m whose instance is M at reach r (m >= r): M itself where it
# reaches r, else sub-columns (M = 1: m = 3 or 5; M = 2: m = 6)
REACH_M = {(mm, r): mm if mm >= r else {1: 3 if r <= 3 else 5, 2: 6}[mm]
           for mm in sk.SUB_M for r in range(2, sk.SWEEP3D_MAX_R + 1)}
CASES = [(name, m, depth) for name in ("3d7p", "3d27p") for m in sk.SUB_M
         for depth in range(1, sk.SWEEP3D_DEPTH[m, 1] + 1)] + [
    (f"star3d-r{r}", REACH_M[mm, r], depth) for r in range(2, sk.SWEEP3D_MAX_R + 1)
    for mm in sk.SUB_M for depth in range(1, sk.SWEEP3D_DEPTH[mm, r] + 1)]


def _spec(name):
    """A registry stencil, or ``star3d-r<r>``: the star of reach r
    (``_star_taps``)."""
    if name.startswith("star3d-r"):
        r = int(name[-1])
        return tst.StencilSpec(name, 3, r, "star", tst._star_taps(3, r))
    return tst.make(name)


def _check(spec, t, depth, edge, seg=S):
    got, stored = sweep3d_kernel_np(spec, t, depth, seg, edge)
    np.testing.assert_array_equal(stored, np.ones(t.shape, dtype=np.int64))
    assert np.isfinite(got).all()            # nothing unwritten (NaN here) stored
    tt = torch.from_numpy(t)
    want = sk.stencil_nd_sweep_ttile_ref(spec, tt, depth, 1, 1) if edge == "periodic" else \
        sk.stencil_nd_multistep_ref(spec, tt, depth, 1, edge == "ring")
    np.testing.assert_array_equal(got, want.numpy())


@pytest.mark.parametrize("edge", ["periodic", "ring", "open"])
@pytest.mark.parametrize("name,m,depth", CASES)
def test_sweep3d_kernel_bitwise(name, m, depth, edge):
    """Every instance's depths on the transcription's grids, bit for bit
    the plain versions, every element stored once; at r = 2..4 the star of
    reach r (run-time taps, every tap from shared memory) on every M (r > M
    on sub-columns)."""
    spec = _spec(name)
    for n0, n1, nb in GRIDS:
        _check(spec, _t(n0, n1, nb, m, seed=n0 * 64 + n1 * 4 + nb + m), depth, edge)


def test_sweep3d_kernel_tall_tile():
    """n1 above two of a tile's stored rows and n0 beyond several segments,
    3d7p at m = 8 (the main path's tile) at depth 4."""
    spec = tst.make("3d7p")
    ty, _, _, hy = sk.sweep3d_tile(8, 4, "star", 1)
    for edge in ("periodic", "ring", "open"):
        _check(spec, _t(7, 2 * (ty - 2 * hy) + 3, 1, 8, seed=3), 4, edge, seg=2)


# the any-vl cases: (n0, n1) grids, each with its own C = nb·vl columns a
# row, one below a tile's 16 stored columns (5 or one block), one no multiple
# of 16 (20), one over several column tiles (40; vl = 64, 128: one block)
ANY_VL_GRIDS = ((1, 1, 5), (S + 1, 5, 20), (3 * S + 1, 13, 40))


@pytest.mark.parametrize("edge", ["periodic", "ring", "open"])
@pytest.mark.parametrize("m", [1, 2, 8])
@pytest.mark.parametrize("vl", VLS)
def test_sweep3d_kernel_any_vl_bitwise(vl, m, edge):
    """Off vl = 32: 3d7p at every depth (each on one of the grids) and
    3d27p at depth 4 on the widest, bit for bit the plain versions, every
    element stored once."""
    _check_any_vl(vl, m, edge, ANY_VL_GRIDS[2])


def _check_any_vl(vl, m, edge, box_grid):
    cases = [("3d7p", depth, ANY_VL_GRIDS[depth % 3]) for depth in range(1, 5)]
    for name, depth, (n0, n1, c) in cases + [("3d27p", 4, box_grid)]:
        nb = -(-c // vl)
        _check(tst.make(name), _t(n0, n1, nb, m, seed=n0 + n1 + nb + vl + m, vl=vl), depth,
               edge)


@pytest.mark.parametrize("edge", ["periodic", "ring", "open"])
@pytest.mark.parametrize("m", [3, 6, 16, 32])
@pytest.mark.parametrize("vl", [1, 4, 8, 32])
def test_sweep3d_kernel_sub_columns_bitwise(vl, m, edge):
    """m off {1, 2, 4, 8}: the instance M with g = m / M sub-columns a
    column (m = 3 on M = 1, 6 on 2, 16 and 32 on 8), vl = 32 too (the
    any-vl instances); 3d7p at every depth on the any-vl grids (C' = g·C
    sub-columns: below 16 at vl = 1 on the first, over several column
    tiles on the last) and 3d27p at depth 4 on the second, bit for bit the
    plain versions, every element stored once."""
    _check_any_vl(vl, m, edge, ANY_VL_GRIDS[1])


# tap lists in no order the kernel knows at compile time: it reads them at
# run time (the registry's 3-D stencils all take a compile-time order)
RUNTIME_TAPS = (
    (((0, 0, 1), 0.125), ((0, 0, -1), 0.125), ((1, 0, 0), 0.125), ((-1, 0, 0), 0.125),
     ((0, 1, 0), 0.125), ((0, -1, 0), 0.125), ((0, 0, 0), 0.25)),
    (((0, 0, 0), 0.375), ((-1, 1, 1), 0.25), ((1, -1, -1), 0.25), ((0, 0, 0), 0.125)),
    tuple(((oz, oy, ox), (3 + oz + 2 * oy + 5 * ox) / 80)
          for ox in (-1, 0, 1) for oz in (-1, 0, 1) for oy in (-1, 0, 1)),
    (((0, 0, 2), 0.125), ((-2, 1, 0), 0.125), ((0, -2, -1), 0.0625), ((0, 0, 0), 0.25),
     ((2, -2, -2), 0.125), ((1, 2, 1), 0.0625), ((0, 0, 2), 0.125)),        # r = 2
    (((3, -3, 1), 0.125), ((0, 0, 0), 0.25), ((-4, 0, 0), 0.125), ((0, 4, -4), 0.0625),
     ((0, 0, 3), 0.125), ((-1, -2, -3), 0.0625), ((2, 0, -1), 0.125)),      # r = 4
)


@pytest.mark.parametrize("edge", ["periodic", "ring", "open"])
@pytest.mark.parametrize("depth", [1, 4])
@pytest.mark.parametrize("taps", RUNTIME_TAPS)
def test_sweep3d_kernel_runtime_taps(taps, depth, edge):
    """Past the deepest instance (r > 1) the chain of ``sweep3d_launches``."""
    r = max(abs(o) for off, _ in taps for o in off)
    spec = tst.StencilSpec("custom3d", 3, r, "box", taps)
    assert sk.sweep3d_order(spec) == "runtime"
    t = _t(2 * S + 1, 4, 2, 4, seed=9)
    if len(sk.sweep3d_launches(4, depth, r)) == 1:
        _check(spec, t, depth, edge)
        return
    got = sweep3d_chain_np(spec, t, depth, S, edge)
    tt = torch.from_numpy(t)
    want = sk.stencil_nd_sweep_ttile_ref(spec, tt, depth, 1, 1) if edge == "periodic" else \
        sk.stencil_nd_multistep_ref(spec, tt, depth, 1, edge == "ring")
    np.testing.assert_array_equal(got, want.numpy())


@pytest.mark.parametrize("edge", ["periodic", "ring", "open"])
def test_sweep3d_kernel_matches_pallas(edge):
    """Against the JAX package's Pallas kernel (k=2, t0=4; periodic at
    ttile 2, depth 4): the whole array, and with open ends at k·r or more
    planes from the ends."""
    spec_t, spec_j = tst.make("3d7p"), jst.make("3d7p")
    t = _t(8, 5, 1, 4, seed=5)
    if edge == "periodic":
        want = jsk.stencil_nd_sweep_ttile(spec_j, jnp.asarray(t), 2, 2, 4, interpret=True)
        got, _ = sweep3d_kernel_np(spec_t, t, 4, S)
        width = 0
    else:
        want = jsk.stencil_nd_multistep(spec_j, jnp.asarray(t), 2, 4, interpret=True,
                                        edge_mask=edge == "ring")
        got, _ = sweep3d_kernel_np(spec_t, t, 2, S, edge)
        width = 2 * spec_t.r if edge == "open" else 0
    want = np.asarray(want)
    n0 = t.shape[0]
    np.testing.assert_allclose(got[width:n0 - width], want[width:n0 - width],
                               rtol=2e-6, atol=2e-6)


@pytest.mark.parametrize("edge", ["periodic", "ring", "open"])
@pytest.mark.parametrize("vl,m,nb", [(8, 8, 1), (128, 4, 1), (8, 2, 3), (8, 16, 1),
                                     (16, 32, 1), (4, 3, 2)])
def test_sweep3d_kernel_any_vl_matches_pallas(vl, m, nb, edge):
    """Off vl = 32 against the JAX package's Pallas kernel, as above: the
    tuner's tile (8 columns a row, below a tile's 16), the JAX package's
    3-D tile, 24 columns, and sub-columns: the tuner's pairs (8, 16) and
    (16, 32) (16 and 64 sub-columns of 8) and an odd m (24 of 1)."""
    spec_t, spec_j = tst.make("3d7p"), jst.make("3d7p")
    t = _t(8, 5, nb, m, seed=vl + m, vl=vl)
    if edge == "periodic":
        want = jsk.stencil_nd_sweep_ttile(spec_j, jnp.asarray(t), 2, 2, 4, interpret=True)
        got, _ = sweep3d_kernel_np(spec_t, t, 4, S)
        width = 0
    else:
        want = jsk.stencil_nd_multistep(spec_j, jnp.asarray(t), 2, 4, interpret=True,
                                        edge_mask=edge == "ring")
        got, _ = sweep3d_kernel_np(spec_t, t, 2, S, edge)
        width = 2 * spec_t.r if edge == "open" else 0
    want = np.asarray(want)
    n0 = t.shape[0]
    np.testing.assert_allclose(got[width:n0 - width], want[width:n0 - width],
                               rtol=2e-6, atol=2e-6)


@pytest.mark.parametrize("vl,m,depth,r,route", [
    (32, 8, 4, 1, "stream"),      # the main path: 3d7p at 512³, k=2, ttile=2
    (32, 8, 2, 1, "stream"),
    (32, 8, 1, 1, "stream"),
    (32, 8, 5, 1, "stream"),      # past the deepest instance: consecutive launches
    (32, 8, 8, 1, "stream"),
    (32, 4, 4, 1, "stream"),
    (32, 2, 3, 1, "stream"),
    (32, 1, 4, 1, "stream"),
    (32, 2, 0, 1, "far"),         # depth 0: no instance
    (128, 4, 4, 1, "stream"),     # the JAX package's 3-D tile: any vl streams
    (16, 8, 2, 1, "stream"),
    (8, 2, 1, 1, "stream"),
    (8, 8, 4, 1, "stream"),       # the tuner's tile, the StencilPlan default vl
    (4, 8, 4, 1, "stream"),
    (1, 1, 3, 1, "stream"),
    (64, 4, 2, 1, "stream"),
    (12, 2, 1, 1, "stream"),      # vl no power of two
    (8, 16, 4, 1, "stream"),      # m = 16: sub-columns of 8 (the tuner's pair (8, 16))
    (128, 16, 2, 1, "stream"),
    (8, 5, 2, 1, "stream"),       # odd m: sub-columns of 1
    (8, 8, 5, 1, "stream"),       # past the deepest instance: consecutive launches
    (128, 4, 5, 1, "stream"),
    (8, 8, 2, 2, "stream"),       # the former K3-smem 3-D row's star
    (8, 8, 2, 5, "far"),          # beyond the kernel's reach
    (128, 4, 1, 2, "stream"),
    (128, 4, 1, 5, "far"),
    (32, 3, 2, 1, "stream"),      # m = 3 on the instance M = 1
    (32, 16, 2, 1, "stream"),
    (32, 8, 2, 2, "stream"),      # reach 2 on the streaming kernel
    (32, 8, 2, 5, "far"),         # beyond the kernel's reach
    (16, 32, 4, 1, "stream"),     # the tuner's pair (16, 32): sub-columns of 8
    (8, 16, 5, 1, "stream"),      # m = 16 past the deepest instance
    (16, 32, 8, 1, "stream"),     # the former K3-smem 3-D row's depth
    (8, 8, 16, 1, "stream"),      # the reference tuner's deepest plan (k=4, ttile=4)
    (8, 8, 32, 1, "stream"),      # ROADMAP D2's depth: eight launches
    (8, 16, 2, 2, "stream"),      # m = 16 at reach 2
    (8, 16, 2, 5, "far"),         # m = 16 beyond the kernel's reach
    (4, 6, 1, 2, "stream"),
    (4, 6, 1, 5, "far"),
    (8, 8, 8, 2, "stream"),       # raised before (no shared-memory tile): four launches
    (8, 8, 4, 3, "stream"),       # likewise: four depth-1 launches
    (8, 8, 4, 4, "stream"),
    (8, 5, 3, 4, "stream"),       # r = 4 > M = 1 on sub-columns
    (8, 0, 2, 1, "far"),          # no column
])
def test_sweep3d_route(vl, m, depth, r, route):
    assert sk.sweep3d_route(vl, m, depth, r, 6 * r + 1) == route
    # more taps than the kernel holds (64: the box of reach 2 has 125) take
    # the far-reach kernel
    assert sk.sweep3d_route(vl, m, depth, r, sk.ND_MAX_TAPS + 1) == "far"


@pytest.mark.parametrize("m,depth,order,tile", [
    (8, 4, "star", (28, 18, 1, 4)),     # 512³: 504 threads, 208128 bytes
    (8, 4, "box", (20, 18, 1, 4)),      # the shared memory caps the rows
    (8, 3, "box", (26, 18, 1, 3)),
    (8, 1, "runtime", (28, 18, 1, 1)),  # 3 planes in flight at depth 1
    (4, 4, "star", (28, 18, 1, 4)),
    (2, 4, "star", (25, 20, 2, 4)),     # depth·r beyond m: two halo columns
    (1, 4, "box", (21, 24, 4, 4)),
])
def test_sweep3d_tile(m, depth, order, tile):
    assert sk.sweep3d_tile(m, depth, order, 1) == tile
    ty, cx, _, hy = tile
    planes = sk.sweep3d_slots(depth, 1) + (depth - 1) * (2 if order == "star" else 4)
    assert ty * cx <= sk.SWEEP3D_THREADS
    assert ty > 2 * hy
    assert planes * m * (ty * cx + 2 * (cx + 1)) * 4 <= sk.SWEEP3D_SMEM


@pytest.mark.parametrize("n0,n1,nb,m,depth,ctas,seg", [
    (512, 512, 2, 8, 4, 132, 103),   # 3d7p at 512³: 104 tiles, 5 segments in 4 waves
    (512, 512, 2, 8, 2, 132, 171),
    (512, 512, 2, 8, 1, 132, 64),
    (544, 512, 2, 8, 2, 132, 182),   # the roundtrip's padded 3d7p
    (16, 16, 1, 8, 4, 132, 8),       # no segment below SWEEP3D_SEG_MIN planes
    (1, 1, 1, 1, 1, 132, 1),
])
def test_sweep3d_segment(n0, n1, nb, m, depth, ctas, seg):
    assert sk.sweep3d_segment(n0, n1, nb * VL, m, depth, "star", ctas, 1) == seg


@pytest.mark.parametrize("n0,n1,nb,vl,m,depth,seg", [
    (512, 512, 8, 8, 8, 4, 103),     # the tuner's tile: 64 columns a row, as at vl = 32
    (512, 512, 1, 128, 4, 4, 171),   # the JAX package's: 128 columns, 8 column tiles
    (512, 512, 16, 4, 8, 1, 64),
    (16, 16, 2, 1, 8, 2, 8),         # 2 columns: one column tile
])
def test_sweep3d_segment_any_vl(n0, n1, nb, vl, m, depth, seg):
    """Column tiles are ceil(nb·vl / 16) whatever vl is."""
    assert sk.sweep3d_segment(n0, n1, nb * vl, m, depth, "star", 132, 1) == seg


@pytest.mark.parametrize("m,split", [
    (1, (1, 1)), (2, (2, 1)), (4, (4, 1)), (8, (8, 1)),    # an instance of their own
    (16, (8, 2)), (32, (8, 4)), (24, (8, 3)),               # the tuner's m: sub-columns of 8
    (3, (1, 3)), (5, (1, 5)), (6, (2, 3)), (12, (4, 3)),    # the picker's C1 tiles
])
def test_sweep3d_split(m, split):
    assert sk.sub_columns(m) == split


@pytest.mark.parametrize("n0,n1,nb,vl,m,depth,seg", [
    (512, 512, 4, 8, 16, 4, 103),    # the tuner's pair (8, 16): 64 sub-columns, as at m = 8
    (512, 512, 1, 16, 32, 4, 103),   # (16, 32): 64 sub-columns of 8
    (512, 512, 4, 8, 16, 1, 64),
])
def test_sweep3d_segment_sub_columns(n0, n1, nb, vl, m, depth, seg):
    """The wrapper sizes segments on the instance M and C' = g·nb·vl."""
    big, g = sk.sub_columns(m)
    assert sk.sweep3d_segment(n0, n1, nb * vl * g, big, depth, "star", 132, 1) == seg


@pytest.mark.parametrize("m,depth,launches", [
    (8, 4, ((8, 1, 4),)),                     # the main path's depth
    (8, 8, ((8, 1, 4), (8, 1, 4))),           # the tuner's k=4, ttile=2: two launches
    (8, 16, ((8, 1, 4),) * 4),                # k=4, ttile=4
    (8, 32, ((8, 1, 4),) * 8),                # ROADMAP D2's depth
    (8, 6, ((8, 1, 4), (8, 1, 2))),
    (16, 8, ((8, 2, 4), (8, 2, 4))),
    (3, 5, ((1, 3, 4), (1, 3, 1))),
    (2, 8, ((2, 1, 4), (2, 1, 4))),
    (1, 3, ((1, 1, 3),)),
    (1, 8, ((1, 1, 4), (1, 1, 4))),
    (2, 16, ((2, 1, 4),) * 4),
    (4, 7, ((4, 1, 4), (4, 1, 3))),
    (6, 9, ((2, 3, 4), (2, 3, 4), (2, 3, 1))),
    (32, 12, ((8, 4, 4),) * 3),
    (5, 1, ((1, 5, 1),)),
])
def test_sweep3d_launches(m, depth, launches):
    """Depths 1 to 4 on the largest M dividing m, deeper sweeps split (a
    depth-8 instance at M = 1 or 2 lost to two depth-4 launches on an
    H100)."""
    assert sk.sweep3d_launches(m, depth, 1) == launches
    assert sum(d for _, _, d in launches) == depth


def test_sweep3d_order():
    assert sk.sweep3d_order(tst.make("3d7p")) == "star"
    assert sk.sweep3d_order(tst.make("3d27p")) == "box"
    assert sk.sweep3d_order(tst.StencilSpec("c", 3, 1, "box", RUNTIME_TAPS[0])) == "runtime"


def test_cpu_wrapper_counts_no_route():
    spec = tst.make("3d7p")
    t = torch.from_numpy(_t(8, 4, 1, 8, 1))
    sk.reset_launches()
    got = sk.stencil_nd_sweep_ttile(spec, t, 2, 2, 4)
    multi = sk.stencil_nd_multistep(spec, t, 2, 4, True)
    halo = sk.stencil_nd_sweep_halo(spec, t, 2, 4, 4)
    assert sk.LAUNCHES == dict.fromkeys(sk.LAUNCHES, 0)       # CPU: no kernel
    assert torch.equal(got, sk.stencil_nd_sweep_ttile_ref(spec, t, 2, 2, 4))
    assert torch.equal(multi, sk.stencil_nd_multistep_ref(spec, t, 2, 4, True))
    assert torch.equal(halo, sk.stencil_nd_multistep_ref(spec, t, 2, 4, False))
    assert {"sweep_3d", "sweep_far", "multistep_3d", "multistep_far"} <= set(sk.LAUNCHES)


# ---------------------------------------------------------------------------
# deep sweeps: the split into consecutive launches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("edge", ["periodic", "ring", "open"])
@pytest.mark.parametrize("name", ["3d7p", "3d27p"])
@pytest.mark.parametrize("m", [8, 2, 3, 6])
def test_sweep3d_kernel_deep_bitwise(m, name, edge):
    """Depth 8 (the reference tuner's k=4, ttile=2) as two depth-4 launches
    on the instance M of ``m`` (8, 2, 1, 2), on a grid of more rows than a
    tile stores and several column tiles, bit for bit the plain versions,
    every element stored once a launch."""
    spec = tst.make(name)
    big, g = sk.sub_columns(m)
    assert sk.sweep3d_launches(m, 8, 1) == ((big, g, 4),) * 2
    ty, _, _, hy = sk.sweep3d_tile(big, 4, sk.sweep3d_order(spec), 1)
    for n0, n1, c in ((2, 3, 5), (2 * S + 3, ty - 2 * hy + 3, 40)):
        nb = -(-c // (8 * g))
        t = _t(n0, n1, nb, m, seed=n0 + n1 + nb + m + big, vl=8)
        got = t
        for _ in range(2):
            got, stored = sweep3d_kernel_np(spec, got, 4, S, edge)
            np.testing.assert_array_equal(stored, np.ones(t.shape, dtype=np.int64))
        assert np.isfinite(got).all()
        tt = torch.from_numpy(t)
        want = sk.stencil_nd_sweep_ttile_ref(spec, tt, 8, 1, 1) if edge == "periodic" else \
            sk.stencil_nd_multistep_ref(spec, tt, 8, 1, edge == "ring")
        np.testing.assert_array_equal(got, want.numpy(), err_msg=f"{n0} {n1} {nb}")


def sweep3d_chain_np(spec, t: np.ndarray, depth: int, seg: int, edge: str = "periodic"):
    """The launches ``sweep3d_launches`` names, one after another (the
    wrapper's chain through a scratch buffer)."""
    for _, _, d in sk.sweep3d_launches(t.shape[3], depth, spec.r):
        t, _ = sweep3d_kernel_np(spec, t, d, seg, edge)
    return t


@pytest.mark.parametrize("edge", ["periodic", "ring", "open"])
@pytest.mark.parametrize("m,depth", [(8, 8), (8, 16), (3, 6)])
def test_sweep3d_kernel_split_bitwise(m, depth, edge):
    """Past depth 4: consecutive launches, bit for bit one depth-``depth``
    plain sweep (n0 below and above 2·depth)."""
    spec = tst.make("3d7p")
    for n0 in (2 * S, 2 * depth + 1):
        t = _t(n0, 5, 2, m, seed=depth + m + n0, vl=8)
        got = sweep3d_chain_np(spec, t, depth, S, edge)
        tt = torch.from_numpy(t)
        want = sk.stencil_nd_sweep_ttile_ref(spec, tt, depth, 1, 1) if edge == "periodic" else \
            sk.stencil_nd_multistep_ref(spec, tt, depth, 1, edge == "ring")
        np.testing.assert_array_equal(got, want.numpy())


# the reference tuner's deep plans (k = 4, ttile = 2 and 4) on the JAX
# package's Pallas kernel in interpret mode: 3d7p (32, 16, 64) at vl=8,
# m=8, t0 = 16 (rtol = atol = 2e-6, as above)
@pytest.mark.parametrize("k,ttile", [(4, 2), (4, 4)])
def test_deep_sweep_matches_pallas(k, ttile):
    """Against the port's ``stencil_nd_sweep_ttile`` (its plain version on
    the CPU) and the launches ``sweep3d_launches`` names, transcribed."""
    spec, jspec = tst.make("3d7p"), jst.make("3d7p")
    t = _t(32, 16, 1, 8, seed=k * ttile, vl=8)
    want = np.asarray(jsk.stencil_nd_sweep_ttile(jspec, jnp.asarray(t), k, ttile, 16,
                                                 interpret=True))
    port = sk.stencil_nd_sweep_ttile(spec, torch.from_numpy(t), k, ttile, 16).numpy()
    np.testing.assert_allclose(port, want, rtol=2e-6, atol=2e-6)
    np.testing.assert_array_equal(sweep3d_chain_np(spec, t, k * ttile, 8), port)


@pytest.mark.parametrize("edge_mask", [True, False])
@pytest.mark.parametrize("k", [8, 16])
def test_deep_multistep_matches_pallas(k, edge_mask):
    """K4b at k = 8 and 16: the ring over the whole array, open ends at k·r
    or more planes from them (ROADMAP C)."""
    spec, jspec = tst.make("3d7p"), jst.make("3d7p")
    t = _t(32, 16, 1, 8, seed=k + edge_mask, vl=8)
    want = np.asarray(jsk.stencil_nd_multistep(jspec, jnp.asarray(t), k, 16, interpret=True,
                                               edge_mask=edge_mask))
    port = sk.stencil_nd_multistep(spec, torch.from_numpy(t), k, 16, edge_mask).numpy()
    width = 0 if edge_mask else k * spec.r
    np.testing.assert_allclose(port[width:32 - width], want[width:32 - width],
                               rtol=2e-6, atol=2e-6)
    edge = "ring" if edge_mask else "open"
    np.testing.assert_array_equal(sweep3d_chain_np(spec, t, k, 8, edge), port)


# ---------------------------------------------------------------------------
# reach r = 2..4: tiles, launch plans, any vl, chains, and the Pallas kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,depth,r,tile", [
    (8, 2, 2, (24, 18, 1, 4)),          # the former K3-smem row's star: 432 threads
    (8, 1, 2, (28, 18, 1, 2)),
    (4, 3, 2, (25, 20, 2, 6)),
    (1, 2, 2, (21, 24, 4, 4)),
    (8, 1, 3, (28, 18, 1, 3)),
    (4, 2, 3, (25, 20, 2, 6)),
    (8, 1, 4, (22, 18, 1, 4)),          # the shared memory caps the rows
    (1, 1, 4, (21, 24, 4, 4)),
])
def test_sweep3d_tile_reach(m, depth, r, tile):
    """The run-time order's tile at reach r: 2r + 2 slots a published level,
    r·Cx + ceil(r / M) unwritten words a side of each element row."""
    assert sk.sweep3d_tile(m, depth, "runtime", r) == tile
    ty, cx, hx, hy = tile
    assert (hx, hy) == (-(-depth * r // m), depth * r)
    planes = sk.sweep3d_slots(depth, r) + (depth - 1) * (2 * r + 2)
    assert ty * cx <= sk.SWEEP3D_THREADS and ty > 2 * hy
    assert planes * m * (ty * cx + 2 * (r * cx - (-r // m))) * 4 <= sk.SWEEP3D_SMEM


def test_sweep3d_reach_tables():
    """Depth 1 at every (M, r); every depth of the table fits a tile that
    stores rows, and the next one stores less than 0.4 of what it computes
    or does not fit; only r > 4 leaves the streaming kernel."""
    def kept(m, depth, r):
        ty, cx, _, hy = sk.sweep3d_tile(m, depth, "star" if r == 1 else "runtime", r)
        return (ty - 2 * hy) * sk.SWEEP3D_LANES / (ty * cx) if ty > 2 * hy else 0.0
    for r in range(2, sk.SWEEP3D_MAX_R + 1):
        for m in sk.SUB_M:
            top = sk.SWEEP3D_DEPTH[m, r]
            assert top >= 1 and all(kept(m, d, r) >= 0.4 for d in range(1, top + 1))
            assert kept(m, top + 1, r) < 0.4
    for vl in (1, 8, 32, 128):
        for m in (1, 3, 8, 16):
            for r in range(1, 7):
                assert sk.sweep3d_route(vl, m, 5, r, 6 * r + 1) == ("stream" if r <= 4 else "far")


@pytest.mark.parametrize("m,depth,r,launches", [
    (8, 2, 2, ((8, 1, 2),)),                 # the former K3-smem row: one launch
    (8, 8, 2, ((8, 1, 2),) * 4),             # raised before: four launches
    (8, 16, 2, ((8, 1, 2),) * 8),
    (8, 4, 3, ((8, 1, 1),) * 4),             # raised before
    (8, 4, 4, ((8, 1, 1),) * 4),             # raised before
    (4, 7, 2, ((4, 1, 3), (4, 1, 3), (4, 1, 1))),
    (4, 4, 3, ((4, 1, 2),) * 2),
    (16, 5, 2, ((8, 2, 2), (8, 2, 2), (8, 2, 1))),
    (5, 3, 4, ((1, 5, 1),) * 3),
    (6, 3, 2, ((2, 3, 2), (2, 3, 1))),
])
def test_sweep3d_launches_reach(m, depth, r, launches):
    assert sk.sweep3d_launches(m, depth, r) == launches
    assert sum(d for _, _, d in launches) == depth


@pytest.mark.parametrize("edge", ["periodic", "ring", "open"])
@pytest.mark.parametrize("r,vl,m", [(2, 8, 8), (2, 1, 2), (3, 16, 3), (4, 4, 4), (4, 128, 5)])
def test_sweep3d_kernel_reach_any_vl_bitwise(r, vl, m, edge):
    """The star of reach r off vl = 32 (the r > 1 instances' one form) at
    every depth of its instance, on the any-vl grids, bit for bit the plain
    versions, every element stored once."""
    spec = _spec(f"star3d-r{r}")
    big, _ = sk.sub_columns(m)
    for depth in range(1, sk.SWEEP3D_DEPTH[big, r] + 1):
        n0, n1, c = ANY_VL_GRIDS[(depth + r) % 3]
        nb = -(-c // vl)
        _check(spec, _t(n0, n1, nb, m, seed=n0 + n1 + nb + vl + m + r, vl=vl), depth, edge)


@pytest.mark.parametrize("edge", ["periodic", "ring", "open"])
@pytest.mark.parametrize("r,m,depth", [(2, 8, 8), (3, 8, 4), (4, 8, 4), (2, 6, 5)])
def test_sweep3d_kernel_reach_split_bitwise(r, m, depth, edge):
    """Sweeps that raised before (no shared-memory tile: reach 2 at depth 8,
    reach 3 and 4 at depth 4, m = 8) as the chain of ``sweep3d_launches``,
    bit for bit one depth-``depth`` plain sweep (n0 below and above
    2·depth·r)."""
    spec = _spec(f"star3d-r{r}")
    assert len(sk.sweep3d_launches(m, depth, r)) > 1
    for n0 in (2 * S, 2 * depth * r + 1):
        t = _t(n0, 5, 1, m, seed=depth + m + n0 + r, vl=8)
        got = sweep3d_chain_np(spec, t, depth, S, edge)
        tt = torch.from_numpy(t)
        want = sk.stencil_nd_sweep_ttile_ref(spec, tt, depth, 1, 1) if edge == "periodic" else \
            sk.stencil_nd_multistep_ref(spec, tt, depth, 1, edge == "ring")
        np.testing.assert_array_equal(got, want.numpy())


@pytest.mark.parametrize("edge", ["periodic", "ring", "open"])
@pytest.mark.parametrize("r,vl,m", [(2, 8, 8), (3, 8, 3), (4, 4, 4)])
def test_sweep3d_kernel_reach_matches_pallas(r, vl, m, edge):
    """The star of reach r (each package's own ``_star_taps(3, r)``) against
    the JAX package's Pallas kernel in interpret mode at the same (vl, m)
    (rtol = atol = 2e-6, as above; k=2, t0 = 2r): the periodic sweep at
    ttile 2 and the ring / open multistep, each as the chain of
    ``sweep3d_launches``; open ends at k·r or more planes from them."""
    k, t0 = 2, 2 * r
    spec = _spec(f"star3d-r{r}")
    jspec = jst.StencilSpec(f"star3d-r{r}", 3, r, "star", jst._star_taps(3, r))
    t = _t(2 * t0, 2 * r + 3, 1, m, seed=r + vl + m, vl=vl)
    if edge == "periodic":
        want = jsk.stencil_nd_sweep_ttile(jspec, jnp.asarray(t), k, 2, t0, interpret=True)
        got = sweep3d_chain_np(spec, t, 2 * k, S)
        width = 0
    else:
        want = jsk.stencil_nd_multistep(jspec, jnp.asarray(t), k, t0, interpret=True,
                                        edge_mask=edge == "ring")
        got = sweep3d_chain_np(spec, t, k, S, edge)
        width = k * r if edge == "open" else 0
    want = np.asarray(want)
    n0 = t.shape[0]
    np.testing.assert_allclose(got[width:n0 - width], want[width:n0 - width],
                               rtol=2e-6, atol=2e-6)
