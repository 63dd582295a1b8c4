"""The far-reach sweep kernel (``csrc/sweep_far.cu``), which K1, K3 and K4
take past the register kernels' reach (r > 4) or taps (16 at 1-D, 64 at
2-D and 3-D), transcribed and held bit for bit against the plain versions
``stencil{1d,_nd}_sweep_ttile_ref`` (periodic) and ``stencil{1d,_nd}_multistep_ref``
(the ring and open ends of axis 0); its routes, launch plans and tiles;
the shapes that raised before it (reach 5–8 at every depth, the 3-D box of
reach 2, the 2-D box of reach 5) and K5 past its former register forms, held
against the JAX package's Pallas kernels in interpret mode.

The CPU has no CUDA compiler, so the transcription checks the kernel's
schedule as written: CTAs over (column tile, row tile, axis-0 segment),
the tables a CTA builds (each tap's offset in a plane for every row s of a
column and the offset of its plane in the ring, the loaded plane's device
offsets with rows and columns wrapped, the output tile's offsets, the 3-D
tile's points), a plane as [row][s][column] with the column pitch the
wrapper picks; in 2-D and 3-D one step a launch: the input plane i + 1
copied during step i into a ring of 2r + 3 planes and the plane ``r + 1``
behind it made from the 2r + 1 about it; in 1-D levels of a step each
alternating two planes; the segment's warm-up positions, the output guard (rows, columns and positions past the
grid), and the ends (2-D, 3-D: planes beyond them zero, ring planes
copied; 1-D: each point of the CTAs that reach them checked).  Elements
are float32 or bfloat16 torch tensors, so each product and sum rounds to
the dtype as the kernel's ``mul`` / ``add`` do.  The claims the kernel
leans on are checked as it runs: no word is read and written in one step
(one barrier a step), and nothing unwritten reaches a stored value (the
planes start as NaN here).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import stencils as jst
from repro.kernels import stencil_kernels as jsk
from repro_torch.core import stencils as tst
from repro_torch.core.api import sweep_schedule
from repro_torch.core.autotune import _launch_ok, pallas_routes_legal
from repro_torch.kernels import stencil_kernels as sk
from repro_torch.roofline.stencil import launch_depths

F32, BF16 = torch.float32, torch.bfloat16
# the port's plain path against the reference's Pallas kernels in interpret
# mode: XLA's CPU backend may contract a multiply and an add into an FMA
TOL = dict(rtol=2e-6, atol=2e-6)


def _star(nd, r):
    return tst.StencilSpec(f"star{nd}d-r{r}", nd, r, "star", tst._star_taps(nd, r))


def _box(nd, r):
    return tst.StencilSpec(f"box{nd}d-r{r}", nd, r, "box", tst._box_taps(nd, r))


def _ring20():
    """A 1-D stencil of 20 taps (offsets -10..-1, 1..10), reach 10."""
    offs = [o for o in range(-10, 11) if o]
    taps = tuple(((o,), 1.0 / (20 + abs(o))) for o in offs)
    return tst.StencilSpec("ring20", 1, 10, "star", taps)


def _jspec(spec):
    return jst.StencilSpec(spec.name, spec.ndim, spec.r, spec.kind, spec.taps)


def _t(shape, seed, dtype=F32):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape)
                            .astype(np.float32)).to(dtype)


# ---------------------------------------------------------------------------
# the kernel, transcribed
# ---------------------------------------------------------------------------

def _col_offset(c, vl, m):
    return (c // vl) * m * vl + c % vl


def far_kernel_np(spec, t, depth, edge="periodic", tile=None, seg=None):
    """One launch of ``csrc/sweep_far.cu`` at depth ``depth`` (at most 1 in
    2-D and 3-D; the wrapper's tile unless ``tile`` = (ty, tc); one segment
    a CTA unless ``seg``)."""
    nb, m, vl = t.shape[-3:]
    nd, r, ntaps = spec.ndim, spec.r, len(spec.taps)
    lead = tuple(t.shape[:-3])
    nx, ncols = nb * m * vl, nb * vl
    nz, ny = (1, 1) if nd == 1 else (lead[0], 1) if nd == 2 else lead
    rz, ry = sk._far_reach(nd, r)
    assert rz == 0 or depth <= 1
    hc = -(-r // m)
    isz = t.element_size()
    if tile is None:
        ty, tc, ncp, smem = sk.far_tile(nd, (nz, ny, nx), m, r, depth, ntaps, isz)
    else:
        ty, tc = tile
        ncp = sk.far_pitch(ty, tc, tc + 2 * depth * hc, m, isz)
        smem = sk.far_smem(m, rz, ry, r, depth, ty, tc, ncp, ntaps, isz)
    assert smem <= sk.FAR_SMEM
    if seg is None:
        seg = nz if rz else 1
    levels = max(depth, 1)
    py, nc = ty + 2 * depth * ry, tc + 2 * depth * hc
    slots = 2 * rz + 3 if rz else 1          # 2r + 1 read, one landing, one in flight
    plane = py * m * ncp
    planes = slots if rz else min(levels, 2)
    ringsz = slots * plane
    hy, hcol = depth * ry, depth * hc
    flat = t.reshape(-1)
    out = torch.full_like(flat, float("nan"))
    written = torch.zeros(flat.numel(), dtype=torch.int64)
    zstride = ny * nx
    taps3 = []
    for off, c in spec.taps:
        oz, oy, ox = ((0, 0, off[0]) if nd == 1 else (off[0], 0, off[1]) if nd == 2
                      else tuple(off))
        taps3.append((oz, oy, ox, torch.tensor(tst.coeff(c, t.dtype), dtype=t.dtype)))
    # the tap table: row s, tap t -> (offset in a plane, ring offset, coefficient)
    tab = []
    for s in range(m):
        row = []
        for oz, oy, ox, c in taps3:
            ss = s + ox
            dc = ss // m
            row.append(((oy * m + ss - dc * m - s) * ncp + dc, (oz + rz) * plane, c))
        tab.append(row)

    def slot_of(p):             # the ring's slots counted from the first position
        return ((p - zs) % slots) * plane

    def region(lv):
        ext = max(depth - lv, 0)
        rows, cols = ty + 2 * ext * ry, tc + 2 * ext * hc
        rlo, clo = hy - ext * ry, hcol - ext * hc
        q = torch.arange(rows * cols)
        return (rlo + q // cols) * m * ncp + clo + q % cols

    for bz in range(-(-nz // seg)):
        for by in range(-(-ny // ty)):
            for bx in range(-(-ncols // tc)):
                z0, y0, c0 = bz * seg, by * ty, bx * tc
                ring = torch.full((planes * plane,), float("nan"), dtype=t.dtype)
                q = torch.arange(py * nc)
                ly, lc = q // nc, q % nc
                lq = ly * m * ncp + lc
                gc = c0 - hcol + lc
                lg = ((y0 - hy + ly) % ny) * nx + _col_offset(gc % ncols, vl, m)
                if edge != "periodic" and nd == 1:
                    lg = torch.where((gc < 0) | (gc >= ncols), -1, lg)
                qo = torch.arange(ty * tc)
                oy_, oc = qo // tc, qo % tc
                og = torch.where((y0 + oy_ < ny) & (c0 + oc < ncols),
                                 (y0 + oy_) * nx + _col_offset(c0 + oc, vl, m), -1)
                xedge = edge != "periodic" and nd == 1 and (
                    (c0 - hcol) * m < r or (c0 + tc + hcol) * m > nx - r)
                zs = z0 - depth * rz
                load_end = z0 + seg - 1 + depth * rz
                iters = seg + levels * (rz + 1) + depth * rz

                def load(z, writes):
                    dst = slot_of(z)
                    inside = edge == "periodic" or nd == 1 or 0 <= z < nz
                    src = (z % nz) * zstride
                    for s in range(m):
                        idx = dst + lq + s * ncp
                        if inside:
                            g = lg + s * vl
                            val = torch.where(lg >= 0, flat[(src + g).clamp(min=0)],
                                              torch.zeros((), dtype=t.dtype))
                        else:
                            val = torch.zeros(idx.numel(), dtype=t.dtype)
                        ring[idx] = val
                        writes.append(idx)
                load(zs, [])
                for i in range(iters):
                    zi = zs + i
                    reads, writes = [], []
                    snap = ring.clone()
                    if zi + 1 <= load_end:          # in flight through the step
                        load(zi + 1, writes)
                    for lv in range(1, levels + 1):
                        p = zi - lv * (rz + 1)
                        idx0 = region(lv)
                        if p < z0 or p >= z0 + seg or p >= nz:
                            continue
                        last = lv == levels
                        mode = "copy" if depth == 0 else "compute"
                        if edge != "periodic" and nd != 1 and mode == "compute":
                            if p < 0 or p >= nz:
                                mode = "zero"
                            elif edge == "ring" and (p < rz or p >= nz - rz):
                                mode = "copy"
                        pbase = 0 if rz else ((lv - 1) & 1) * plane
                        q0p = slot_of(p - rz)
                        czo = q0p + rz * plane
                        czo -= ringsz if czo >= ringsz else 0
                        dbase = (lv & 1) * plane        # 1-D: the other plane
                        for s in range(m):
                            idx = idx0 + s * ncp
                            if mode == "compute":
                                acc = None
                                for ip, zoff, c in tab[s]:
                                    zo = q0p + zoff
                                    zo -= ringsz if zo >= ringsz else 0
                                    a = pbase + zo + ip + idx
                                    reads.append(a)
                                    term = snap[a] * c
                                    acc = term if acc is None else acc + term
                                if xedge:
                                    x = (c0 - hcol + idx - s * ncp) * m + s
                                    ctr = pbase + czo + idx
                                    reads.append(ctr)
                                    acc = torch.where((x < 0) | (x >= nx),
                                                      torch.zeros((), dtype=t.dtype), acc)
                                    if edge == "ring":
                                        acc = torch.where((x >= 0) & (x < nx) &
                                                          ((x < r) | (x >= nx - r)),
                                                          snap[ctr], acc)
                            elif mode == "copy":
                                reads.append(pbase + czo + idx)
                                acc = snap[pbase + czo + idx]
                            else:
                                acc = torch.zeros(idx.numel(), dtype=t.dtype)
                            if last:
                                keep = og >= 0
                                dst_g = p * zstride + og[keep] + s * vl
                                out[dst_g] = acc[keep]
                                written[dst_g] += 1
                            else:
                                ring[dbase + idx] = acc
                                writes.append(dbase + idx)
                    if reads and writes:
                        clash = set(torch.cat(reads).tolist()) & set(torch.cat(writes).tolist())
                        assert not clash, f"step {i}: words read and written in one step"
    assert bool((written == 1).all()), "an element stored other than once"
    return out.reshape(t.shape)


def far_chain_np(spec, t, depth, edge="periodic", **kw):
    """The launches :func:`far_launches` names, one after another."""
    for _, _, d in sk.far_launches(spec.ndim, t.shape[-2], depth, spec.r, len(spec.taps),
                                   t.element_size()):
        t = far_kernel_np(spec, t, d, edge, **kw)
    return t


def _plain(spec, t, depth, edge):
    if edge == "periodic":
        if spec.ndim == 1:
            return sk.stencil1d_sweep_ttile_ref(spec, t, depth, 1)
        return sk.stencil_nd_sweep_ttile_ref(spec, t, depth, 1, spec.r)
    return sk._multistep_ref(spec, t, depth, edge == "ring")


def _same(got, want):
    assert torch.equal(got, want), float((got.double() - want.double()).abs().max())


# the layouts of the transcription cases: (n0, n1,) nb, m, vl
SHAPES = {1: (6, 8, 4), 2: (14, 3, 8, 2), 3: (9, 7, 2, 8, 2)}


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("edge", ["periodic", "ring", "open"])
@pytest.mark.parametrize("nd,r,depth", [(1, 5, 1), (1, 5, 4), (1, 8, 3), (2, 5, 1), (2, 6, 2),
                                        (3, 5, 1), (3, 6, 1), (3, 8, 1)])
def test_far_kernel_bitwise_plain(nd, r, depth, edge, dtype):
    """The launches of a sweep (one, but 2-D depth 2 as 1 + 1) at the
    wrapper's tile on a grid smaller than the tile: rows and columns wrap
    onto themselves, axis 0 is one segment."""
    spec = _star(nd, r)
    t = _t(SHAPES[nd], seed=nd * 10 + r + depth, dtype=dtype)
    _same(far_chain_np(spec, t, depth, edge), _plain(spec, t, depth, edge))


@pytest.mark.parametrize("edge", ["periodic", "ring", "open"])
@pytest.mark.parametrize("nd,r,depth,tile,seg", [
    (1, 5, 2, (1, 3), None),      # 1-D: 8 tiles of 3 columns, the last one short
    (1, 6, 1, (1, 5), None),
    (2, 5, 2, (1, 3), 4),         # 2-D: column tiles and segments of 4 rows
    (2, 7, 1, (1, 4), 5),
    (3, 5, 1, (2, 3), 4),         # 3-D: row, column and axis-0 tiles, none dividing
    (3, 5, 2, (3, 2), 3),
])
def test_far_kernel_tiles_and_segments(nd, r, depth, tile, seg, edge):
    """Tiles and segments that do not divide the grid (each launch of the
    chain at them): each element stored once, each bit for bit the plain
    version."""
    spec = _star(nd, r)
    shape = {1: (3, 8, 3), 2: (13, 2, 8, 2), 3: (10, 7, 1, 8, 3)}[nd]
    t = _t(shape, seed=r + depth)
    _same(far_chain_np(spec, t, depth, edge, tile=tile, seg=seg),
          _plain(spec, t, depth, edge))


@pytest.mark.parametrize("edge", ["periodic", "ring", "open"])
@pytest.mark.parametrize("spec,shape,depth", [
    (_box(3, 2), (6, 5, 1, 4, 2), 1),    # 125 taps
    (_box(3, 2), (6, 5, 1, 4, 2), 2),
    (_box(2, 5), (13, 1, 8, 2), 1),      # 121 taps
    (_box(2, 4), (12, 1, 4, 4), 2),      # 81 taps, reach 4
    (_ring20(), (2, 16, 2), 2),          # 20 taps at 1-D
])
def test_far_kernel_many_taps(spec, shape, depth, edge):
    t = _t(shape, seed=len(spec.taps) + depth)
    _same(far_chain_np(spec, t, depth, edge), _plain(spec, t, depth, edge))


@pytest.mark.parametrize("nd", [2, 3])
def test_far_kernel_one_step_a_launch_along_a_stream_axis(nd):
    """In 2-D and 3-D the kernel keeps one ring of input planes: a launch
    is one step, its shared memory 2r + 3 planes, and a deeper launch has
    no size."""
    r, ntaps = 5, 10 * nd + 1
    rz, ry = sk._far_reach(nd, r)
    ty, tc, ncp = (1, 16, 18) if nd == 2 else (4, 8, 11)
    py = ty + 2 * ry
    one = sk.far_smem(8, rz, ry, r, 1, ty, tc, ncp, ntaps, 4)
    two = sk.far_smem(8, rz, ry, r, 1, ty, tc, ncp, ntaps, 2)
    assert one - two == 2 * (py * 8 * ncp * (2 * r + 3) + (64 if py == 1 else 0))
    with pytest.raises(ValueError, match="one step a launch"):
        sk.far_smem(8, rz, ry, r, 2, ty, tc, ncp, ntaps, 4)
    assert sk.far_depth(nd, 8, r, ntaps) == 1


@pytest.mark.parametrize("nd", [1, 2, 3])
def test_far_kernel_depth0_copies(nd):
    spec = _star(nd, 5)
    t = _t(SHAPES[nd], seed=nd)
    _same(far_kernel_np(spec, t, 0), t)


@pytest.mark.parametrize("edge", ["periodic", "ring", "open"])
@pytest.mark.parametrize("nd,depth", [(1, 17), (2, 5), (3, 3)])
def test_far_chain_bitwise_plain(nd, depth, edge):
    """A sweep deeper than one launch: the chain :func:`far_launches` names
    (1-D 8 + 8 + 1, 2-D five of depth 1, 3-D 1 + 1 + 1) equals the deep
    plain sweep bit for bit."""
    spec = _star(nd, 5)
    plan = sk.far_launches(nd, 8, depth, 5, len(spec.taps))
    assert [d for *_, d in plan] == {1: [8, 8, 1], 2: [1] * 5, 3: [1, 1, 1]}[nd]
    t = _t(SHAPES[nd], seed=depth)
    _same(far_chain_np(spec, t, depth, edge), _plain(spec, t, depth, edge))


# ---------------------------------------------------------------------------
# routes, launch plans, tiles
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("r", [5, 6, 7, 8])
@pytest.mark.parametrize("depth", [1, 2, 4, 16])
def test_routes_past_reach_4_take_the_far_kernel(r, depth):
    ntaps = 2 * r + 1
    assert sk.sweep1d_route(8, 8, depth, r, ntaps) == "far"
    assert sk.sweep2d_route(8, 8, depth, r, 4 * r + 1) == "far"
    assert sk.sweep3d_route(8, 8, depth, r, 6 * r + 1) == "far"
    assert sk.sweep1d_route(8, 8, depth, 4, 9) == "warp"
    assert sk.sweep2d_route(8, 8, depth, 4, 17) == "warp"
    assert sk.sweep3d_route(8, 8, depth, 4, 25) == "stream"


@pytest.mark.parametrize("nd,r,ntaps,route", [
    (1, 4, 16, "warp"), (1, 4, 17, "far"), (1, 3, 20, "far"),
    (2, 3, 49, "warp"), (2, 4, 64, "warp"), (2, 4, 81, "far"), (2, 5, 121, "far"),
    (3, 1, 27, "stream"), (3, 2, 64, "stream"), (3, 2, 125, "far"),
])
def test_routes_past_the_register_kernels_taps(nd, r, ntaps, route):
    fn = (sk.sweep1d_route, sk.sweep2d_route, sk.sweep3d_route)[nd - 1]
    assert fn(32, 8, 2, r, ntaps) == route


@pytest.mark.parametrize("nd,r,depth,want", [
    (1, 5, 4, [4]), (1, 5, 16, [8, 8]), (1, 8, 20, [8, 8, 4]),
    (2, 5, 4, [1] * 4), (2, 8, 16, [1] * 16), (2, 6, 3, [1] * 3),
    (3, 5, 4, [1] * 4), (3, 8, 16, [1] * 16), (3, 6, 2, [1, 1]),
    (2, 5, 0, [0]),
])
def test_far_launch_plans(nd, r, depth, want):
    spec = _star(nd, r)
    plan = sk.far_launches(nd, 8, depth, r, len(spec.taps))
    assert [d for *_, d in plan] == want
    assert sum(want) == depth
    assert launch_depths(spec, 8, 8, depth) == tuple(want)


@pytest.mark.parametrize("nd,nat,r", [
    (1, (1, 1, 1 << 26), 5), (2, (8192, 1, 8192), 5), (2, (8192, 1, 8192), 8),
    (3, (512, 512, 512), 5), (3, (512, 512, 512), 6), (3, (512, 512, 512), 8),
])
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_far_tile_fits_at_every_launch_depth(nd, nat, r, dtype):
    """Every launch of a depth-16 sweep on the chip_smoke.py grids takes a
    tile within the card's shared memory, no larger than the grid."""
    isz = torch.empty((), dtype=dtype).element_size()
    ntaps = 2 * nd * r + 1
    for d in {d for *_, d in sk.far_launches(nd, 8, 16, r, ntaps, isz)} | {1}:
        ty, tc, ncp, smem = sk.far_tile(nd, nat, 8, r, d, ntaps, isz)
        assert smem <= sk.FAR_SMEM_AIM
        assert 1 <= ty <= nat[1] and 1 <= tc <= nat[2] // 8
        assert ncp >= tc + 2 * d * -(-r // 8)
        assert smem == sk.far_smem(8, r if nd > 1 else 0, r if nd == 3 else 0, r, d, ty, tc,
                                   ncp, ntaps, isz)


def test_far_tile_names_the_limit():
    """Depth 1 fits at the reaches the usual tiles reach (r <= m <= 16 at
    3-D; at r = m = 16 in bfloat16 only: 34 planes of 33 rows of 16·3
    words); where it cannot, the error names the shared memory, not a
    ROADMAP item."""
    for m, r in ((8, 8), (16, 12), (16, 5)):
        assert sk.far_depth(3, m, r, 6 * r + 1) >= 1
    assert sk.far_depth(3, 16, 16, 97, 2) == 1
    for m, r in ((16, 16), (32, 32)):
        with pytest.raises(ValueError, match="shared memory") as err:
            sk.far_depth(3, m, r, 6 * r + 1)
        assert "ROADMAP" not in str(err.value) and "D2" not in str(err.value)


def test_far_pitch_spreads_a_warps_rows():
    """3-D: the pitch puts a warp's output points (4 rows of 8 columns at
    m = 8) on 32 distinct banks; 1-D and 2-D keep the plane's width."""
    ncp = sk.far_pitch(16, 8, 10, 8, 4)
    banks = {((q // 8) * 8 * ncp + q % 8) % 32 for q in range(32)}
    assert len(banks) == 32
    assert sk.far_pitch(1, 256, 260, 8, 4) == 260


def test_far_segment():
    assert sk.far_segment(1, 64, 40000, 4, 0, 132) == 1
    seg = sk.far_segment(8192, 32, 100000, 2, 5, 132)
    assert 1 <= seg <= 8192
    # a segment fewer than the grid's positions: more CTAs than tiles
    assert -(-8192 // seg) * 32 >= 132


def test_autotune_gate_follows_the_far_routes():
    """The tuner's gate (``_launch_ok``) takes the far route's launches:
    the 3-D reach-5 star at every depth, the 125-tap box, and a launch no
    tile fits is refused."""
    star5 = _star(3, 5)
    for depth in (1, 2, 4, 16):
        assert _launch_ok(star5, (512, 512, 512), 8, 8, 16, depth, F32)
    assert _launch_ok(_box(3, 2), (64, 64, 512), 8, 8, 16, 2, F32)
    assert _launch_ok(_box(2, 5), (64, 4096), 8, 8, 16, 2, BF16)
    assert not _launch_ok(_star(3, 32), (64, 64, 1024), 1, 32, 32, 1, F32)
    assert pallas_routes_legal(_star(2, 5), (64, 4096), 8, 8, 32, k=16, ttile=4)
    assert pallas_routes_legal(star5, (32, 32, 512), 8, 8, 16, k=4, ttile=2)


# ---------------------------------------------------------------------------
# the shapes that raised, against the reference (interpret mode)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("edge", ["periodic", "ring", "open"])
@pytest.mark.parametrize("nd,r", [(2, 5), (2, 6), (3, 5), (3, 6)])
def test_star_k2_matches_pallas(nd, r, edge):
    """Stars of reach 5 and 6 at k = 2 (periodic at ttile 2, depth 4): the
    port's plain path and the far-reach launches transcribed, against the
    reference's Pallas kernel; open ends compared at k·r or more rows from
    them (the reference leaves those unspecified)."""
    spec = _star(nd, r)
    shape = (16, 1, 8, 2) if nd == 2 else (16, 5, 1, 8, 2)
    t = _t(shape, seed=nd * r)
    t0 = 16
    if edge == "periodic":
        want = jsk.stencil_nd_sweep_ttile(_jspec(spec), jnp.asarray(t.numpy()), 2, 2, t0,
                                          interpret=True)
        port = sk.stencil_nd_sweep_ttile(spec, t, 2, 2, t0)
        got = far_chain_np(spec, t, 4)
        width = 0
    else:
        want = jsk.stencil_nd_multistep(_jspec(spec), jnp.asarray(t.numpy()), 2, t0,
                                        interpret=True, edge_mask=edge == "ring")
        port = sk.stencil_nd_multistep(spec, t, 2, t0, edge_mask=edge == "ring")
        got = far_chain_np(spec, t, 2, edge)
        width = 2 * r if edge == "open" else 0
    _same(got, port)
    want = np.asarray(want)
    n0 = t.shape[0]
    np.testing.assert_allclose(port.numpy()[width:n0 - width], want[width:n0 - width], **TOL)


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("spec,shape", [(_box(3, 2), (8, 6, 1, 4, 2)),
                                        (_box(2, 5), (10, 2, 8, 2))])
def test_box_matches_pallas(spec, shape, k):
    """The 3-D box of reach 2 (125 taps) and the 2-D box of reach 5 (121
    taps) at k = 1, 2, periodic and with the ring."""
    t = _t(shape, seed=k + len(spec.taps))
    t0 = shape[0] // 2
    want = jsk.stencil_nd_sweep_ttile(_jspec(spec), jnp.asarray(t.numpy()), k, 1, t0,
                                      interpret=True)
    port = sk.stencil_nd_sweep_ttile(spec, t, k, 1, t0)
    _same(far_chain_np(spec, t, k), port)
    np.testing.assert_allclose(port.numpy(), np.asarray(want), **TOL)
    want = jsk.stencil_nd_multistep(_jspec(spec), jnp.asarray(t.numpy()), k, t0,
                                    interpret=True, edge_mask=True)
    port = sk.stencil_nd_multistep(spec, t, k, t0, edge_mask=True)
    _same(far_chain_np(spec, t, k, "ring"), port)
    np.testing.assert_allclose(port.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("r", [5, 8])
def test_1d_star_matches_pallas(r):
    """1-D stars of reach 5 and 8 at k = 2, ttile 2 (depth 4; the reference
    asks r <= vl)."""
    spec = _star(1, r)
    t = _t((4, 8, 8), seed=r)
    want = jsk.stencil1d_sweep_ttile(_jspec(spec), jnp.asarray(t.numpy()), 2, 2,
                                     interpret=True)
    port = sk.stencil1d_sweep_ttile(spec, t, 2, 2)
    _same(far_chain_np(spec, t, 4), port)
    np.testing.assert_allclose(port.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("spec,m", [(_star(1, 6), 8), (_ring20(), 16), (_star(1, 6), 6),
                                    (_ring20(), 24), (_star(1, 16), 16)])
def test_onestep_past_the_register_forms_matches_pallas(spec, m):
    """K5 at reach 6 and at 20 taps, the shapes past the register forms
    before they held reach 16 and 64 taps at any m (r = m, m past 16 and
    reach 16 too), against the reference's kernels; the form the card
    takes."""
    vl = 4
    x = _t((8 * m * vl,), seed=len(spec.taps))
    want = np.asarray(jsk.stencil1d_naive_onestep(_jspec(spec), jnp.asarray(x.numpy()), vl,
                                                  interpret=True))
    np.testing.assert_allclose(sk.stencil1d_naive_onestep(spec, x, vl).numpy(), want, **TOL)
    t = torch.from_numpy(np.ascontiguousarray(
        x.numpy().reshape(8, vl, m).transpose(0, 2, 1)))
    want = np.asarray(jsk.stencil1d_transpose_onestep(_jspec(spec), jnp.asarray(t.numpy()),
                                                      interpret=True))
    np.testing.assert_allclose(sk.stencil1d_transpose_onestep(spec, t).numpy(), want, **TOL)
    for dtype in (torch.float32, torch.bfloat16):
        assert sk.onestep_form("naive", spec, dtype) == \
            sk.onestep_form("transpose", spec, dtype) == "reg"


def test_onestep_forms():
    for dtype in (torch.float32, torch.bfloat16):
        for kind in ("naive", "transpose"):
            assert sk.onestep_form(kind, tst.make("1d5p"), dtype) == "reg"
            assert sk.onestep_form(kind, _star(1, 16), dtype) == "reg"          # 33 taps
        far = tst.StencilSpec("far", 1, 33, "star", (((0,), 0.5), ((33,), 0.25), ((-33,), 0.25)))
        assert sk.onestep_form("naive", far, dtype) == \
            sk.onestep_form("transpose", far, dtype) == "mem"
        assert sk.onestep_form("naive", _star(1, 17), dtype) == "lane"
        assert sk.onestep_form("transpose", _star(1, 17), dtype) == "mem"


@pytest.mark.parametrize("nd", [1, 2, 3])
def test_resident_run_on_the_far_route(nd):
    """``ops.stencil_sweep_periodic`` of a reach-5 star (fused 16 steps at
    k = 2, ttile = 2) on the CPU, its schedule's chunks each a far-route
    sweep on the card (the route asserted), against the float64 oracle."""
    from repro_torch.kernels import ops
    spec = _star(nd, 5)
    shape = {1: (512,), 2: (16, 128), 3: (12, 10, 64)}[nd]
    x = _t(shape, seed=nd)
    vl, m, t0 = ops.pick_tile(spec, shape, 8, 8)
    for depth, _ in sweep_schedule(2, 16, "fused", 2)[0]:
        route = (sk.sweep1d_route, sk.sweep2d_route, sk.sweep3d_route)[nd - 1](
            vl, m, depth, 5, len(spec.taps))
        assert route == "far"
    y = ops.stencil_sweep_periodic(spec, x, 16, k=2, ttile=2, vl=vl, m=m, t0=t0)
    oracle = x.double().numpy()
    for _ in range(16):
        oracle = tst.numpy_apply_once(spec, oracle, "periodic")
    assert np.abs(y.double().numpy() - oracle).max() < 16 * 2 * len(spec.taps) * 2.0 ** -24 * \
        float(x.abs().max())
