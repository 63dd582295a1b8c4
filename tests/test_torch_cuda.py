"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every stencil case compares bit for bit (``torch.equal``): the kernels sum
the taps in the spec's order with one multiply and one add each (built with
``-fmad=false``), each rounded to the tensor's dtype (float32 or
bfloat16), as the plain versions do.  K6 (the SSD chunk scan) sums
its products in another order than the plain version's einsums and is held
at the reference's tolerances: 2e-4 in float32, 5e-2 in bfloat16.  The
jnp plans (plain PyTorch on the card) equal the resident run bit for bit;
the mxu engine (one cuBLAS product a sweep) is held at the reference's
conformance tolerances of the f64 oracle, with the TF32 and bf16-reduction
flags set both ways.  Without a CUDA device every test skips; run them
where there is one with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.core import layouts, stencils
from repro_torch.core.api import StencilPlan, StencilProblem, sweep_schedule
from repro_torch.kernels import build, ops
from repro_torch.kernels import ssd_kernel as ssd
from repro_torch.kernels import stencil_kernels as sk

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


def _x(shape, seed, device):
    rng = np.random.default_rng(seed)
    return torch.tensor(rng.standard_normal(shape).astype(np.float32), device=device)


@pytest.mark.parametrize("shape,vl,m", [
    ((256,), 8, 8), ((4096,), 32, 8), ((6, 8192), 32, 4), ((3, 5, 512), 32, 2),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.float16])
def test_transpose_kernel_bitwise(cuda, shape, vl, m, dtype):
    x = _x(shape, 0, cuda).to(dtype)
    t = sk.block_transpose(x, vl, m)
    assert torch.equal(t, sk.block_transpose_ref(x, vl, m))
    back = sk.block_untranspose(t, vl, m)
    assert torch.equal(back, x)


_INT_OF = {torch.float16: torch.int16, torch.bfloat16: torch.int16, torch.float32: torch.int32,
           torch.float64: torch.int64}


def _bits(shape, dtype, seed, device):
    """Random bits (NaN patterns included) as ``dtype``: a move is held bit
    for bit through an integer view."""
    info = np.iinfo({torch.int16: np.int16, torch.int32: np.int32,
                     torch.int64: np.int64}[_INT_OF[dtype]])
    raw = np.random.default_rng(seed).integers(info.min, info.max, shape, dtype=info.dtype)
    return torch.from_numpy(raw).to(device).view(dtype)


def _same_bits(a, b):
    return a.shape == b.shape and torch.equal(a.view(_INT_OF[a.dtype]), b.view(_INT_OF[b.dtype]))


# the register kernel's tiles with every stride fixed (vl a power of two, m
# 1 to 8, 16 and 32: the tuner's pairs (8, 16), (16, 32) and the picker's odd
# m), those with G and vl at run time (m 25 and 12, vl 256 and 96), and
# those of vl below 4 (a thread a sub-block: 2d5p 8192x8190's (2, 7), the
# former shared-memory route's (3, 5) and (2, 8), G > 1 at m 16, 24, 25)
TRANSPOSE_TILES = [(vl, m) for vl in (4, 8, 16, 32, 128) for m in (1, 3, 8, 16, 32)] + [
    (8, 5), (16, 6), (32, 7), (8, 25), (3, 5), (8, 12), (256, 8), (96, 8), (2, 8)] + [
    (vl, m) for vl in (1, 2, 3) for m in (1, 2, 3, 4, 6, 7, 16, 24, 25)]


@pytest.mark.parametrize("dtype", [torch.float16, torch.float32, torch.float64])
@pytest.mark.parametrize("vl,m", TRANSPOSE_TILES)
def test_transpose_routes_bitwise(cuda, vl, m, dtype):
    x = _bits((2, 3, 37 * vl * m), dtype, vl + m, cuda)    # 37 blocks: a partial last CTA
    assert sk.transpose_route(vl, m, x.element_size(), x.numel()) == "reg"
    sk.reset_launches()
    t = sk.block_transpose(x, vl, m)
    back = sk.block_untranspose(t, vl, m)
    torch.cuda.synchronize()
    assert sk.LAUNCHES == dict.fromkeys(sk.LAUNCHES, 0) | {"transpose": 2}
    assert _same_bits(t, sk.block_transpose_ref(x, vl, m))
    assert _same_bits(back, x)


@pytest.mark.parametrize("dtype", [torch.float16, torch.float32, torch.float64])
@pytest.mark.parametrize("vl,m", [(32, 8), (8, 16), (16, 32), (8, 6), (2, 8), (3, 5), (1, 16),
                                  (2, 24)])
def test_transpose_unaligned_pointers(cuda, vl, m, dtype):
    """A contiguous view one element into its storage: the natural side
    moves element by element, bit for bit the same."""
    x = _bits((1 + 9 * vl * m,), dtype, 11, cuda)[1:]
    t = sk.block_transpose(x, vl, m)
    assert _same_bits(t, sk.block_transpose_ref(x, vl, m))
    out = torch.empty(1 + x.numel(), dtype=dtype, device=cuda)[1:]
    sk.reset_launches()
    back = sk.block_untranspose(t, vl, m, out=out)
    torch.cuda.synchronize()
    assert back.data_ptr() == out.data_ptr() and _same_bits(back, x)
    assert sk.LAUNCHES == dict.fromkeys(sk.LAUNCHES, 0) | {"transpose": 1}


def test_transpose_reg_refuses_off_route(cuda):
    """The register kernel's entry point refuses a vl, an m or an M off its
    route (vl below 1, m below 1, M not dividing m or above 8, vl not
    dividing the columns, 1-byte elements), a table of parts past
    ``TRANSPOSE_MAX_PARTS`` or out of the layout, and takes vl = 24 and
    m = 9 and 64 (transpose_any, on the M of ``transpose_sub``) and vl = 2
    (transpose_small)."""
    import ctypes
    lib = build.load("transpose")
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    x = _bits((41 * 32 * 8,), torch.float32, 12, cuda)
    t = torch.empty_like(x)
    for ncols, vl, m, mi, size in ((32, 0, 8, 8, 4), (32, 32, 0, 1, 4), (32, 32, 8, 3, 4),
                                   (32, 32, 16, 16, 4), (32, 32, 8, 0, 4), (40, 24, 8, 8, 4),
                                   (32, 32, 8, 8, 1), (33, 2, 8, 8, 4)):
        assert lib.repro_transpose_reg(x.data_ptr(), t.data_ptr(), ncols, vl, m, mi, size, 1,
                                       None, 0, stream) != 0, (ncols, vl, m, mi, size)
    many = sk.TRANSPOSE_MAX_PARTS + 1
    table = (ctypes.c_void_p * many)(*[x.data_ptr()] * many)
    for nparts, to_layout in ((many, 1), (1, 0), (-1, 1)):
        assert lib.repro_transpose_reg(x.data_ptr(), t.data_ptr(), 32, 32, 8, 8, 4, to_layout,
                                       table, nparts, stream) != 0, (nparts, to_layout)
    for ncols, vl, m in ((x.numel() // 8 // 24 * 24, 24, 8), (32, 32, 9), (32, 32, 64),
                         (32, 2, 8)):
        assert lib.repro_transpose_reg(x.data_ptr(), t.data_ptr(), ncols, vl, m,
                                       sk.transpose_sub(m)[0], 4, 1, None, 0, stream) == 0
    torch.cuda.synchronize()


@pytest.mark.parametrize("depth", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("name,shape,vl,m,t0", [
    ("1d3p", (1 << 16,), 32, 8, None),
    ("1d3p", (64,), 8, 4, None),            # nb=2: halo wraps past the grid
    ("1d5p", (5 * 1024,), 32, 4, None),
    ("2d5p", (96, 1024), 32, 8, 32),
    ("2d5p", (4, 64), 8, 4, 2),             # halo deeper than the grid
    ("2d9p", (64, 512), 32, 8, 16),
    ("3d7p", (16, 12, 256), 32, 8, 8),
    ("3d27p", (8, 6, 128), 32, 4, 4),
])
def test_sweep_kernel_bitwise(cuda, name, shape, vl, m, t0, depth):
    spec = stencils.make(name)
    t = layouts.to_transpose_layout(_x(shape, 1, cuda), vl, m)
    if spec.ndim == 1:
        got = sk.stencil1d_sweep_ttile(spec, t, depth, 1)
        want = sk.stencil1d_sweep_ttile_ref(spec, t, depth, 1)
    else:
        got = sk.stencil_nd_sweep_ttile(spec, t, depth, 1, t0)
        want = sk.stencil_nd_sweep_ttile_ref(spec, t, depth, 1, t0)
    torch.cuda.synchronize()
    assert torch.equal(got, want), (got - want).abs().max().item()


def test_sweep_kernel_counts_and_raises(cuda):
    spec = stencils.make("3d7p")
    t = layouts.to_transpose_layout(_x((8, 8, 256), 2, cuda), 32, 8)
    sk.reset_launches()
    sk.stencil_nd_sweep_ttile(spec, t, 2, 1, 8)
    assert sk.LAUNCHES == dict.fromkeys(sk.LAUNCHES, 0) | {"sweep_3d": 1}
    with pytest.raises(NotImplementedError, match="D1"):
        sk.stencil_nd_sweep_ttile(spec, t.double(), 2, 1, 8)
    # depth 32 (ROADMAP D2, which raised on the shared-memory kernel): eight
    # consecutive depth-4 launches, bit for bit one plain 32-step sweep
    sk.reset_launches()
    got = sk.stencil_nd_sweep_ttile(spec, t, 32, 1, 8)
    torch.cuda.synchronize()
    assert sk.LAUNCHES == dict.fromkeys(sk.LAUNCHES, 0) | {"sweep_3d": 8}
    assert torch.equal(got, sk.stencil_nd_sweep_ttile_ref(spec, t, 32, 1, 8))
    with pytest.raises(ValueError, match="in place"):
        sk.stencil_nd_sweep_ttile(spec, t, 1, 1, 8, out=t)


def _warp_cases():
    """The CPU transcription's grid (tests/test_torch_sweep1d_warp.py):
    every m with m >= r, and nb in {1, 2, B-1, B, B+1, 3B+2}."""
    cases = []
    for name in ("1d3p", "1d5p", "heat1d"):
        for m, blocks in sk.WARP_BLOCKS.items():
            if m >= stencils.make(name).r:
                cases += [(name, m, nb) for nb in
                          sorted({1, 2, blocks - 1, blocks, blocks + 1, 3 * blocks + 2})]
    return cases + [("1d3p", 8, (1 << 20) // 256), ("1d5p", 4, (1 << 20) // 128)]


@pytest.mark.parametrize("name,m,nb", _warp_cases())
def test_sweep1d_warp_kernel_bitwise(cuda, name, m, nb):
    spec = stencils.make(name)
    t = layouts.to_transpose_layout(_x((nb * 32 * m,), nb + m, cuda), 32, m)
    out = torch.empty_like(t)
    for depth in range(1, 13):
        sk.reset_launches()
        got = sk.stencil1d_sweep_ttile(spec, t, depth, 1, out=out)
        torch.cuda.synchronize()
        assert sk.LAUNCHES == dict.fromkeys(sk.LAUNCHES, 0) | {"sweep_1d": 1}
        want = sk.stencil1d_sweep_ttile_ref(spec, t, depth, 1)
        assert torch.equal(got, want), (depth, (got - want).abs().max().item())


@pytest.mark.parametrize("taps", [
    (((1,), 0.25), ((0,), 0.5), ((-1,), 0.25)),
    (((0,), 0.375), ((-1,), 0.25), ((1,), 0.25), ((0,), 0.125)),     # 0 twice
    (((2,), 0.125), ((-1,), 0.25), ((0,), 0.25), ((1,), 0.25), ((-2,), 0.125)),
])
def test_sweep1d_warp_kernel_runtime_taps(cuda, taps):
    """Tap lists in no order the warp kernel knows at compile time."""
    r = max(abs(off[0]) for off, _ in taps)
    spec = stencils.StencilSpec("custom1d", 1, r, "star", taps)
    t = layouts.to_transpose_layout(_x((35 * 32 * 4,), 9, cuda), 32, 4)
    for depth in (1, 5, 12):
        sk.reset_launches()
        got = sk.stencil1d_sweep_ttile(spec, t, depth, 1)
        torch.cuda.synchronize()
        assert sk.LAUNCHES == dict.fromkeys(sk.LAUNCHES, 0) | {"sweep_1d": 1}
        assert torch.equal(got, sk.stencil1d_sweep_ttile_ref(spec, t, depth, 1))


def _star(ndim, r):
    """The star of reach r (``_star_taps(ndim, r)``), named ``star<ndim>d-r<r>``:
    reach 5 is beyond the register kernels'."""
    return stencils.StencilSpec(f"star{ndim}d-r{r}", ndim, r, "star",
                                stencils._star_taps(ndim, r))


def test_sweep1d_routes_count_and_raise(cuda):
    """The warp kernel at every depth of reach up to 4 (past 32·M // r as
    consecutive launches, each counted: depth 33 at m = 1 is 32 + 1, 257
    at m = 16 is 256 + 1), the far-reach kernel at reach 5 (depth 20: 8 +
    8 + 4)."""
    x = _x((1 << 15,), 3, cuda)
    for spec, vl, m, depth, key, launches in (
            (stencils.make("1d3p"), 32, 8, 4, "sweep_1d", 1),
            (stencils.make("1d3p"), 128, 8, 4, "sweep_1d", 1),
            (stencils.make("1d3p"), 32, 1, 33, "sweep_1d", 2),
            (stencils.make("1d3p"), 8, 16, 4, "sweep_1d", 1),
            (stencils.make("1d3p"), 8, 16, 257, "sweep_1d", 2),
            (_star(1, 5), 8, 8, 4, "sweep_far", 1),
            (_star(1, 5), 8, 8, 20, "sweep_far", 3)):
        t = layouts.to_transpose_layout(x, vl, m)
        if key == "sweep_1d":
            assert len(sk.sweep1d_launches(m, depth, spec.r)) == launches
        else:
            assert len(sk.far_launches(1, m, depth, spec.r, len(spec.taps))) == launches
        sk.reset_launches()
        got = sk.stencil1d_sweep_ttile(spec, t, depth, 1)
        torch.cuda.synchronize()
        assert sk.LAUNCHES == dict.fromkeys(sk.LAUNCHES, 0) | {key: launches}
        assert torch.equal(got, sk.stencil1d_sweep_ttile_ref(spec, t, depth, 1))
        with pytest.raises(ValueError, match="in place"):
            sk.stencil1d_sweep_ttile(spec, t, depth, 1, out=t)
    spec = stencils.make("1d3p")
    with pytest.raises(NotImplementedError, match="D1"):
        sk.stencil1d_sweep_ttile(spec, layouts.to_transpose_layout(x, 32, 8).double(), 2, 2)
    lib = build.load("sweep1d_warp")
    assert {m: lib.repro_sweep1d_warp_blocks(m) for m in sk.WARP_BLOCKS} == sk.WARP_BLOCKS


# vl off 32: a warp row is 32 columns, C = nb·vl columns (no multiple of
# 32 below vl = 32), a partial last warp row, C below 32
ANY_VL = (4, 8, 16, 64, 128)


def _any_vl_nbs(vl, m):
    """C' = nb·vl·g sub-columns (g = 1 at m in {1, 2, 4, 8}) near 5, 20,
    32·B + 40 and 4680, and a grid of 2^18 points."""
    big, g = sk.sub_columns(m)
    return sorted({-(-c // (vl * g)) for c in (5, 20, 32 * sk.WARP_BLOCKS[big] + 40, 4680)} |
                  {(1 << 18) // (vl * m) + 1})


@pytest.mark.parametrize("edge", ["periodic", "ring", "open"])
@pytest.mark.parametrize("vl", ANY_VL)
@pytest.mark.parametrize("name,m", [("1d3p", 8), ("1d5p", 2), ("heat1d", 4), ("1d3p", 1)])
def test_sweep1d_warp_any_vl_bitwise(cuda, name, m, vl, edge):
    """K1 and K4a on the warp kernel off vl = 32, bit for bit the plain
    versions, at depths up to the route's deepest."""
    _sweep1d_bitwise(cuda, name, m, vl, edge)


@pytest.mark.parametrize("edge", ["periodic", "ring", "open"])
@pytest.mark.parametrize("vl", [4, 8, 32])
@pytest.mark.parametrize("m", [3, 5, 6, 12, 16, 32])
def test_sweep1d_warp_sub_columns_bitwise(cuda, m, vl, edge):
    """The same at m off {1, 2, 4, 8}: the instance M = sub_columns(m)
    with g = m / M sub-columns a column (vl = 32 on the any-vl instances);
    1d3p, and 1d5p where r = 2 <= M."""
    for name in ("1d3p", "1d5p"):
        if stencils.make(name).r <= sk.sub_columns(m)[0]:
            _sweep1d_bitwise(cuda, name, m, vl, edge)


def _sweep1d_bitwise(cuda, name, m, vl, edge, dtype=torch.float32, spec=None, past=False):
    """K1 (periodic) or K4a (ring, open) at depths 1, 2, 5 and the deepest
    launch (and, ``past``, one step more: two launches), each counted."""
    spec = spec or stencils.make(name)
    big = sk.sub_columns(m)[0]
    deepest = 32 * big // spec.r
    for nb in _any_vl_nbs(vl, m):
        t = layouts.to_transpose_layout(_x((nb * vl * m,), nb + vl, cuda).to(dtype), vl, m)
        out = torch.empty_like(t)
        for depth in (1, 2, 5, deepest) + ((deepest + 1,) if past else ()):
            sk.reset_launches()
            if edge == "periodic":
                got = sk.stencil1d_sweep_ttile(spec, t, depth, 1, out=out)
                want = sk.stencil1d_sweep_ttile_ref(spec, t, depth, 1)
                key = "sweep_1d"
            else:
                got = sk.stencil1d_multistep(spec, t, depth, edge == "ring", out=out)
                want = sk.stencil1d_multistep_ref(spec, t, depth, edge == "ring")
                key = "multistep_1d"
            torch.cuda.synchronize()
            launches = len(sk.sweep1d_launches(m, depth, spec.r))
            assert sk.LAUNCHES == dict.fromkeys(sk.LAUNCHES, 0) | {key: launches}
            assert torch.equal(got, want), (nb, depth, (got - want).abs().max().item())


# the instances with r > M: (stencil, m, M, r), each (M, r) pair once or more
BEYOND_M = (("1d5p", 3, 1, 2), ("1d5p", 5, 1, 2), ("star3", 3, 1, 3), ("star4", 5, 1, 4),
            ("star3", 6, 2, 3), ("star4", 6, 2, 4), ("star4", 10, 2, 4))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("edge", ["periodic", "ring", "open"])
@pytest.mark.parametrize("vl", [4, 8, 32])
@pytest.mark.parametrize("name,m,mm,r", BEYOND_M)
def test_sweep1d_warp_reach_beyond_m_bitwise(cuda, name, m, mm, r, vl, edge, dtype):
    """The warp kernel's instances with r > M (a halo from ceil(r / M)
    lanes a side; the ring over as many lanes at each end) on its route,
    bit for bit the plain versions at every end, and one step past the
    deepest launch as two launches."""
    spec = _star(1, r) if name.startswith("star") else stencils.make(name)
    assert sk.sub_columns(m)[0] == mm and spec.r == r > mm
    assert sk.sweep1d_route(vl, m, 1000, r, len(spec.taps)) == "warp"
    _sweep1d_bitwise(cuda, name, m, vl, edge, dtype, spec=spec, past=True)


@pytest.mark.parametrize("edge", ["periodic", "ring", "open"])
@pytest.mark.parametrize("vl", ANY_VL)
@pytest.mark.parametrize("name,m", [("2d5p", 8), ("2d9p", 2), ("heat2d", 4), ("2d5p", 1)])
def test_sweep2d_warp_any_vl_bitwise(cuda, name, m, vl, edge):
    """K3 and K4b on the 2-D warp kernel off vl = 32, bit for bit the
    plain versions, at every depth of the route, at the wrapper's segment
    and at 4 rows."""
    _sweep2d_bitwise(cuda, name, m, vl, edge)


@pytest.mark.parametrize("edge", ["periodic", "ring", "open"])
@pytest.mark.parametrize("vl", [4, 8, 32])
@pytest.mark.parametrize("m", [3, 5, 6, 12, 16, 32])
def test_sweep2d_warp_sub_columns_bitwise(cuda, m, vl, edge):
    """The same at m off {1, 2, 4, 8}: the instance M = sub_columns(m)
    with g = m / M sub-columns a column (vl = 32 on the any-vl
    instances); 2d5p and 2d9p."""
    for name in ("2d5p", "2d9p"):
        _sweep2d_bitwise(cuda, name, m, vl, edge)


def _sweep2d_bitwise(cuda, name, m, vl, edge, dtype=torch.float32):
    """Every depth of the instance (M, r), at the wrapper's segment and at 4
    rows; ``name`` a registry stencil or ``star2d-r<r>`` (grids of at least
    r rows, t0 = n0)."""
    spec = _star(2, int(name[-1])) if name.startswith("star2d-r") else stencils.make(name)
    big, g = sk.sub_columns(m)
    grids = [(3, -(-5 // (vl * g))), (9, -(-20 // (vl * g))),
             (14, -(-(32 * 8 + 40) // (vl * g))), (2048 + 64, 2048 // (vl * m) + 1)]
    for n0, nb in grids:
        if n0 < spec.r:
            continue
        t0 = 1 if spec.r == 1 else n0
        t = layouts.to_transpose_layout(_x((n0, nb * vl * m), n0 + nb + vl, cuda).to(dtype),
                                        vl, m)
        out = torch.empty_like(t)
        for depth in range(1, sk.WARP2D_DEPTH[big, spec.r] + 1):
            sk.reset_launches()
            if edge == "periodic":
                got = sk.stencil_nd_sweep_ttile(spec, t, depth, 1, t0, out=out)
                want = sk.stencil_nd_sweep_ttile_ref(spec, t, depth, 1, t0)
                key = "sweep_2d"
            else:
                got = sk.stencil_nd_multistep(spec, t, depth, t0, edge == "ring", out=out)
                want = sk.stencil_nd_multistep_ref(spec, t, depth, t0, edge == "ring")
                key = "multistep_2d"
            torch.cuda.synchronize()
            assert sk.LAUNCHES == dict.fromkeys(sk.LAUNCHES, 0) | {key: 1}
            assert torch.equal(got, want), (n0, nb, depth, (got - want).abs().max().item())
            if n0 < 2048:
                sk._warp2d_launch(spec, t, out, depth, edge, seg_rows=4)
                torch.cuda.synchronize()
                assert torch.equal(out, want), (n0, nb, depth, "seg 4")


def _warp2d_grids():
    """The CPU transcription's (n0, nb) grid (tests/test_torch_sweep2d_warp.py),
    at its segment of 4 rows."""
    nb = sk.WARP2D_WARPS - 2
    return ((1, 1), (2, nb - 1), (3, nb), (4, nb + 1), (5, 2 * nb + 1), (14, nb))


@pytest.mark.parametrize("m", sk.SUB_M)
@pytest.mark.parametrize("name", ["2d5p", "2d9p", "heat2d"])
def test_sweep2d_warp_kernel_bitwise(cuda, name, m):
    """Every depth of the route on the transcription's grid (at its segment
    of 4 rows and at the wrapper's own) and at 2048², bit for bit the plain
    version; the wrapper launches the warp kernel alone."""
    spec = stencils.make(name)
    for n0, nb in _warp2d_grids() + ((2048, 2048 // (32 * m)),):
        t = layouts.to_transpose_layout(_x((n0, nb * 32 * m), n0 + nb + m, cuda), 32, m)
        out = torch.empty_like(t)
        for depth in range(1, sk.WARP2D_DEPTH[m, 1] + 1):
            want = sk.stencil_nd_sweep_ttile_ref(spec, t, depth, 1, 1)
            sk.reset_launches()
            got = sk.stencil_nd_sweep_ttile(spec, t, depth, 1, 1, out=out)
            torch.cuda.synchronize()
            assert sk.LAUNCHES == dict.fromkeys(sk.LAUNCHES, 0) | {"sweep_2d": 1}
            assert torch.equal(got, want), (n0, nb, depth, (got - want).abs().max().item())
            if n0 < 2048:
                sk._warp2d_launch(spec, t, out, depth, seg_rows=4)
                torch.cuda.synchronize()
                assert torch.equal(out, want), (n0, nb, depth, "seg 4")


@pytest.mark.parametrize("taps", [
    (((0, 1), 0.125), ((0, -1), 0.125), ((1, 0), 0.125), ((-1, 0), 0.125), ((0, 0), 0.5)),
    (((0, 0), 0.375), ((-1, 1), 0.25), ((1, -1), 0.25), ((0, 0), 0.125)),     # (0,0) twice
    tuple(((oy, ox), (2 + oy + 3 * ox) / 40) for ox in (-1, 0, 1) for oy in (-1, 0, 1)),
])
def test_sweep2d_warp_kernel_runtime_taps(cuda, taps):
    """Tap lists in no order the 2-D warp kernel knows at compile time."""
    spec = stencils.StencilSpec("custom2d", 2, 1, "box", taps)
    t = layouts.to_transpose_layout(_x((37, 11 * 32 * 4), 9, cuda), 32, 4)
    for depth in (1, 5, 8):
        sk.reset_launches()
        got = sk.stencil_nd_sweep_ttile(spec, t, depth, 1, 1)
        torch.cuda.synchronize()
        assert sk.LAUNCHES == dict.fromkeys(sk.LAUNCHES, 0) | {"sweep_2d": 1}
        assert torch.equal(got, sk.stencil_nd_sweep_ttile_ref(spec, t, depth, 1, 1))


def test_sweep2d_routes_count_and_raise(cuda):
    spec = stencils.make("2d5p")
    x = _x((64, 4096), 3, cuda)
    for vl, m, depth, key in ((32, 8, 4, "sweep_2d"), (128, 8, 4, "sweep_2d"),
                              (32, 8, sk.WARP2D_DEPTH[8, 1] + 1, "sweep_2d"),    # 4, then 1
                              (16, 4, 2, "sweep_2d"), (8, 16, 2, "sweep_2d"),
                              (8, 16, sk.WARP2D_DEPTH[8, 1] + 1, "sweep_2d")):
        t = layouts.to_transpose_layout(x, vl, m)
        sk.reset_launches()
        got = sk.stencil_nd_sweep_ttile(spec, t, depth, 1, 32)
        torch.cuda.synchronize()
        assert sk.LAUNCHES == dict.fromkeys(sk.LAUNCHES, 0) | {
            key: len(sk.sweep2d_launches(m, depth, 1))}
        assert torch.equal(got, sk.stencil_nd_sweep_ttile_ref(spec, t, depth, 1, 32))
        with pytest.raises(ValueError, match="in place"):
            sk.stencil_nd_sweep_ttile(spec, t, depth, 1, 32, out=t)
    with pytest.raises(NotImplementedError, match="D1"):
        sk.stencil_nd_sweep_ttile(spec, layouts.to_transpose_layout(x, 32, 8).double(), 2, 2, 32)
    lib = build.load("sweep2d_warp")
    assert lib.repro_sweep2d_warp_warps() == sk.WARP2D_WARPS
    assert {(m, r): lib.repro_sweep2d_warp_max_depth(m, r)
            for m, r in sk.WARP2D_DEPTH} == sk.WARP2D_DEPTH


# the tiles the reference takes and the GPU picker used to refuse: vl 8 and
# 16, odd m, an explicit m of 25 and a t0 lowered to a divisor of n0
C1_TILES = [
    ("1d3p", (1000,), None, None, None),         # (8, 5)
    ("1d3p", (1000,), 8, 25, None),
    ("1d5p", (96,), None, None, None),           # (32, 3)
    ("2d5p", (64, 48), None, None, None),        # (16, 3, 32)
    ("2d5p", (60, 48), None, None, 7),           # t0 7 -> 6
    ("3d7p", (16, 8, 16), None, None, None),     # (16, 1, 16)
    ("3d7p", (12, 8, 80), 16, None, 5),          # (16, 5, 4)
]


@pytest.mark.parametrize("name,shape,vl,m,t0", C1_TILES)
def test_c1_tiles_on_the_card(cuda, name, shape, vl, m, t0):
    """K2, K1/K3 and K4 at the repaired picker's tiles, each bit for bit
    its plain version: the register kernels at odd m on sub-columns of 1
    (12x8x80's m = 5 at 3-D too; 1d5p 96's m = 3, where r = 2 > M = 1, on
    the 1-D warp kernel's halo of two lanes)."""
    spec = stencils.make(name)
    vl, m, t0 = ops.pick_tile(spec, shape, vl, m, t0)
    x = _x(shape, 10, cuda)
    t = sk.block_transpose(x, vl, m)
    assert torch.equal(t, sk.block_transpose_ref(x, vl, m))
    assert torch.equal(sk.block_untranspose(t, vl, m), x)
    for depth in (1, 2, 4):
        sk.reset_launches()
        if spec.ndim == 1:
            got = sk.stencil1d_sweep_ttile(spec, t, depth, 1)
            want = sk.stencil1d_sweep_ttile_ref(spec, t, depth, 1)
            keys = {"sweep_1d" if sk.sweep1d_route(vl, m, depth, spec.r, len(spec.taps)) ==
                    "warp" else "sweep_far": 1}
        else:
            got = sk.stencil_nd_sweep_ttile(spec, t, depth, 1, t0)
            want = sk.stencil_nd_sweep_ttile_ref(spec, t, depth, 1, t0)
            keys = {"sweep_3d" if spec.ndim == 3 else "sweep_2d": 1}
        torch.cuda.synchronize()
        assert sk.LAUNCHES == dict.fromkeys(sk.LAUNCHES, 0) | keys
        assert torch.equal(got, want), (depth, (got - want).abs().max().item())
        for edge_mask in (True, False):
            if spec.ndim == 1:
                got = sk.stencil1d_multistep(spec, t, depth, edge_mask)
                want = sk.stencil1d_multistep_ref(spec, t, depth, edge_mask)
            else:
                got = sk.stencil_nd_multistep(spec, t, depth, t0, edge_mask)
                want = sk.stencil_nd_multistep_ref(spec, t, depth, t0, edge_mask)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (depth, edge_mask)
    for sweep in ("resident", "roundtrip"):
        plan = StencilPlan(backend="pallas", sweep=sweep, k=2, vl=vl, m=m, t0=t0,
                           ttile=2 if sweep == "resident" else 1)
        got = StencilProblem(name, shape).run(x, 7, plan)
        want = stencils.apply_steps(spec, x, 7)
        assert torch.equal(got, want), (sweep, (got - want).abs().max().item())


def _k2_key(vl, m):
    assert sk.transpose_route(vl, m, 4) == "reg"
    return "transpose"


@pytest.mark.parametrize("vl,m,key", [(32, 8, "sweep_1d"), (128, 8, "sweep_1d"),
                                      (8, 8, "sweep_1d"), (8, 16, "sweep_1d"),
                                      (16, 32, "sweep_1d")])
def test_main_path_1d_route_counts(cuda, vl, m, key):
    prob = StencilProblem("1d3p", (1 << 15,))
    x = prob.init(0)
    sk.reset_launches()
    got = prob.run(x, 16, StencilPlan(backend="pallas", sweep="resident", k=2, ttile=2,
                                      vl=vl, m=m))
    assert sk.LAUNCHES == dict.fromkeys(sk.LAUNCHES, 0) | {_k2_key(vl, m): 2, key: 4}
    want = stencils.apply_steps(prob.spec, x, 16)
    assert torch.equal(got, want), (got - want).abs().max().item()


@pytest.mark.parametrize("vl,m,key", [(32, 8, "sweep_2d"), (128, 8, "sweep_2d"),
                                      (8, 8, "sweep_2d"), (8, 16, "sweep_2d"),
                                      (16, 32, "sweep_2d")])
def test_main_path_2d_route_counts(cuda, vl, m, key):
    prob = StencilProblem("2d5p", (64, 2048))
    x = prob.init(0)
    sk.reset_launches()
    got = prob.run(x, 16, StencilPlan(backend="pallas", sweep="resident", k=2, ttile=2,
                                      vl=vl, m=m))
    assert sk.LAUNCHES == dict.fromkeys(sk.LAUNCHES, 0) | {_k2_key(vl, m): 2, key: 4}
    want = stencils.apply_steps(prob.spec, x, 16)
    assert torch.equal(got, want), (got - want).abs().max().item()


@pytest.mark.parametrize("remainder", ["fused", "native"])
@pytest.mark.parametrize("name,shape", [
    ("1d3p", (1 << 15,)), ("2d5p", (64, 1024)), ("3d7p", (16, 16, 256)),
])
def test_main_path_matches_plain(cuda, name, shape, remainder):
    prob = StencilProblem(name, shape)
    x = prob.init(0)
    plan = StencilPlan(backend="pallas", sweep="resident", k=2, ttile=2,
                       remainder=remainder)
    sk.reset_launches()
    got = prob.run(x, 7, plan)
    chunks, _ = sweep_schedule(2, 7, remainder, 2)
    key = {1: "sweep_1d", 2: "sweep_2d", 3: "sweep_3d"}[prob.spec.ndim]
    assert sk.LAUNCHES == dict.fromkeys(sk.LAUNCHES, 0) | {
        "transpose": 2, key: sum(n for _, n in chunks)}
    want = stencils.apply_steps(prob.spec, x, 7)
    assert torch.equal(got, want), (got - want).abs().max().item()
    donated = ops.stencil_sweep_periodic(prob.spec, x.clone(), 7, k=2, ttile=2,
                                         remainder=remainder, donate=True)
    assert torch.equal(donated, got)


@pytest.mark.parametrize("edge_mask", [True, False])
@pytest.mark.parametrize("depth", [1, 2, 3])
@pytest.mark.parametrize("name,shape,vl,m,t0", [
    ("1d3p", (1 << 16,), 32, 8, None),
    ("1d3p", (64,), 8, 4, None),            # nb=2: the halo reaches past both ends
    ("1d5p", (5 * 1024,), 32, 4, None),
    ("2d5p", (96, 1024), 32, 8, 32),
    ("2d5p", (6, 64), 8, 4, 1),             # ring and halo span several tiles
    ("2d9p", (64, 512), 32, 8, 16),
    ("3d7p", (16, 12, 256), 32, 8, 8),
    ("3d7p", (4, 6, 128), 32, 4, 1),        # ring and halo span several tiles
    ("3d27p", (8, 6, 128), 32, 4, 4),
])
def test_multistep_kernel_bitwise(cuda, name, shape, vl, m, t0, depth, edge_mask):
    spec = stencils.make(name)
    t = layouts.to_transpose_layout(_x(shape, 4, cuda), vl, m)
    sk.reset_launches()
    if spec.ndim == 1:
        got = sk.stencil1d_multistep(spec, t, depth, edge_mask)
        want = sk.stencil1d_multistep_ref(spec, t, depth, edge_mask)
        key = "multistep_1d" if sk.sweep1d_route(vl, m, depth, spec.r, len(spec.taps)) == \
            "warp" else "multistep_far"
    else:
        got = sk.stencil_nd_multistep(spec, t, depth, t0, edge_mask)
        want = sk.stencil_nd_multistep_ref(spec, t, depth, t0, edge_mask)
        key = "multistep_2d" if spec.ndim == 2 and \
            sk.sweep2d_route(vl, m, depth, spec.r, len(spec.taps)) == "warp" else \
            "multistep_3d" if spec.ndim == 3 and \
            sk.sweep3d_route(vl, m, depth, spec.r, len(spec.taps)) == "stream" else \
            "multistep_far"
    torch.cuda.synchronize()
    assert sk.LAUNCHES == dict.fromkeys(sk.LAUNCHES, 0) | {key: 1}
    assert torch.equal(got, want), (got - want).abs().max().item()


@pytest.mark.parametrize("edge_mask", [True, False])
@pytest.mark.parametrize("depth", [1, 2, 5])
@pytest.mark.parametrize("name,m", [("1d3p", 8), ("1d3p", 1), ("1d5p", 4), ("heat1d", 2)])
def test_multistep_1d_warp_route_bitwise(cuda, name, m, depth, edge_mask):
    """K4a on K1's warp kernel: one block (both ends in one slot), a
    partial last run, whole runs; the ring and open ends."""
    spec = stencils.make(name)
    B = sk.WARP_BLOCKS[m]
    for nb in (1, 2, B + 1, 3 * B + 2, 4 * sk.WARP_BLOCKS[m] * 9):
        t = layouts.to_transpose_layout(_x((nb * 32 * m,), nb + depth, cuda), 32, m)
        sk.reset_launches()
        got = sk.stencil1d_multistep(spec, t, depth, edge_mask)
        torch.cuda.synchronize()
        assert sk.LAUNCHES == dict.fromkeys(sk.LAUNCHES, 0) | {"multistep_1d": 1}
        want = sk.stencil1d_multistep_ref(spec, t, depth, edge_mask)
        assert torch.equal(got, want), (nb, (got - want).abs().max().item())


def test_multistep_1d_routes_count(cuda):
    """The counters tell K4a's two routes apart, and the halo wrapper
    follows the route of its depth."""
    spec = stencils.make("1d3p")
    for spec, vl, m, k, key in (
            (stencils.make("1d3p"), 32, 8, 2, "multistep_1d"),
            (stencils.make("1d3p"), 32, 1, 33, "multistep_1d"),       # 32 + 1
            (stencils.make("1d3p"), 8, 4, 2, "multistep_1d"),
            (stencils.make("1d3p"), 32, 3, 2, "multistep_1d"),
            (stencils.make("1d3p"), 8, 16, 2, "multistep_1d"),
            (stencils.make("1d3p"), 8, 16, 257, "multistep_1d"),      # 256 + 1
            (_star(1, 5), 8, 8, 2, "multistep_far")):
        assert sk.sweep1d_route(vl, m, k, spec.r, len(spec.taps)) == \
            ("warp" if key == "multistep_1d" else "far")
        launches = len(sk.sweep1d_launches(m, k, spec.r)) if key == "multistep_1d" else 1
        t = layouts.to_transpose_layout(_x((5 * vl * m,), 13, cuda), vl, m)
        for edge_mask in (True, False):
            sk.reset_launches()
            got = sk.stencil1d_multistep(spec, t, k, edge_mask)
            torch.cuda.synchronize()
            assert sk.LAUNCHES == dict.fromkeys(sk.LAUNCHES, 0) | {key: launches}
            assert torch.equal(got, sk.stencil1d_multistep_ref(spec, t, k, edge_mask))
        sk.reset_launches()
        halo = sk.stencil1d_sweep_halo(spec, t, k, k * spec.r)
        assert sk.LAUNCHES == dict.fromkeys(sk.LAUNCHES, 0) | {key: launches}
        assert torch.equal(halo, sk.stencil1d_multistep_ref(spec, t, k, False))


def _edge2d_grids(m):
    """The CPU transcription's (n0, nb) grids with their ends
    (tests/test_torch_sweep2d_warp.py), at every depth of the route, and a
    grid at real size: the roundtrip's padded 2048² (n0 + 64 rows)."""
    nb = sk.WARP2D_WARPS - 2
    grids = set(_warp2d_grids()) | {(5, 3)}
    for depth in range(1, sk.WARP2D_DEPTH[m, 1] + 1):
        grids |= {(8 + depth, nb + 2), (2 * depth, 2), (2 * depth + 1, nb)}
    return sorted(grids) + [(2048 + 64, 2048 // (32 * m))]


@pytest.mark.parametrize("edge_mask", [True, False])
@pytest.mark.parametrize("m", sk.SUB_M)
@pytest.mark.parametrize("name", ["2d5p", "2d9p", "heat2d"])
def test_multistep_2d_warp_route_bitwise(cuda, name, m, edge_mask):
    """K4b on the 2-D warp kernel: every depth of the route on grids whose
    segments start or end near the ends of axis 0 (at the transcription's
    segment of 4 rows and at the wrapper's own), and at real size; the
    ring and open ends.  The wrapper launches the warp kernel alone."""
    spec = stencils.make(name)
    edge = "ring" if edge_mask else "open"
    for n0, nb in _edge2d_grids(m):
        t = layouts.to_transpose_layout(_x((n0, nb * 32 * m), n0 + nb + m, cuda), 32, m)
        out = torch.empty_like(t)
        for depth in range(1, sk.WARP2D_DEPTH[m, 1] + 1):
            want = sk.stencil_nd_multistep_ref(spec, t, depth, 1, edge_mask)
            sk.reset_launches()
            got = sk.stencil_nd_multistep(spec, t, depth, 1, edge_mask, out=out)
            torch.cuda.synchronize()
            assert sk.LAUNCHES == dict.fromkeys(sk.LAUNCHES, 0) | {"multistep_2d": 1}
            assert torch.equal(got, want), (n0, nb, depth, (got - want).abs().max().item())
            if n0 < 2048:
                sk._warp2d_launch(spec, t, out, depth, edge, seg_rows=4)
                torch.cuda.synchronize()
                assert torch.equal(out, want), (n0, nb, depth, "seg 4")


@pytest.mark.parametrize("taps", [
    (((0, 1), 0.125), ((0, -1), 0.125), ((1, 0), 0.125), ((-1, 0), 0.125), ((0, 0), 0.5)),
    (((0, 0), 0.375), ((-1, 1), 0.25), ((1, -1), 0.25), ((0, 0), 0.125)),     # (0,0) twice
    tuple(((oy, ox), (2 + oy + 3 * ox) / 40) for ox in (-1, 0, 1) for oy in (-1, 0, 1)),
])
def test_multistep_2d_warp_runtime_taps(cuda, taps):
    """Tap lists in no order the 2-D warp kernel knows at compile time,
    with the ring and open ends."""
    spec = stencils.StencilSpec("custom2d", 2, 1, "box", taps)
    t = layouts.to_transpose_layout(_x((37, 11 * 32 * 4), 10, cuda), 32, 4)
    for depth in (1, 5, 8):
        for edge_mask in (True, False):
            sk.reset_launches()
            got = sk.stencil_nd_multistep(spec, t, depth, 1, edge_mask)
            torch.cuda.synchronize()
            assert sk.LAUNCHES == dict.fromkeys(sk.LAUNCHES, 0) | {"multistep_2d": 1}
            assert torch.equal(got, sk.stencil_nd_multistep_ref(spec, t, depth, 1, edge_mask))


def test_multistep_2d_routes_count(cuda):
    """The counters tell K4b's routes apart at 2-D and 3-D (the register
    kernels at any vl, m and depth, past the deepest instance in
    consecutive launches, each counted, reach 2 included; the far-reach
    kernel at r = 5 and at 81 taps, likewise), and the halo wrapper follows
    the route of its depth."""
    r2 = stencils.StencilSpec("2d9p-star-r2", 2, 2, "star", stencils._star_taps(2, 2))
    r5 = stencils.StencilSpec("2d-star-r5", 2, 5, "star", stencils._star_taps(2, 5))
    cases = ((stencils.make("2d5p"), (64, 4096), 32, 8, 2, "multistep_2d"),
             (stencils.make("2d9p"), (64, 4096), 32, 1, 8, "multistep_2d"),
             (stencils.make("2d5p"), (64, 4096), 128, 8, 2, "multistep_2d"),
             (stencils.make("2d5p"), (64, 4096), 8, 16, 2, "multistep_2d"),
             (stencils.make("2d5p"), (64, 4096), 8, 16, 5, "multistep_2d"),
             (stencils.make("2d5p"), (64, 4080), 16, 3, 2, "multistep_2d"),
             (r2, (64, 4096), 32, 8, 2, "multistep_2d"),
             (r2, (64, 4096), 8, 8, 5, "multistep_2d"),                         # 2 + 2 + 1
             (r5, (64, 4096), 32, 8, 2, "multistep_far"),
             (r5, (64, 4096), 8, 8, 3, "multistep_far"),                      # three launches
             (stencils.StencilSpec("box2d-r4", 2, 4, "box", stencils._box_taps(2, 4)),
              (64, 4096), 32, 8, 2, "multistep_far"),                          # 81 taps
             (_star(3, 5), (16, 8, 256), 8, 8, 3, "multistep_far"),             # 1 + 1 + 1
             (_star(3, 2), (16, 8, 256), 8, 8, 5, "multistep_3d"),              # 2 + 2 + 1
             (stencils.make("2d5p"), (64, 4096), 32, 8, sk.WARP2D_DEPTH[8, 1] + 1,
              "multistep_2d"),
             (stencils.make("2d5p"), (64, 4096), 8, 8, 16, "multistep_2d"),
             (stencils.make("2d5p"), (64, 4096), 8, 8, 12, "multistep_2d"),   # 8 + 4
             (stencils.make("3d7p"), (16, 8, 256), 32, 8, 2, "multistep_3d"),
             (stencils.make("3d7p"), (16, 8, 256), 32, 8, 5, "multistep_3d"),  # 4 + 1
             (stencils.make("3d7p"), (16, 8, 256), 8, 16, 2, "multistep_3d"),
             (stencils.make("3d7p"), (16, 8, 256), 8, 16, 5, "multistep_3d"),
             (stencils.make("3d7p"), (16, 8, 192), 16, 3, 2, "multistep_3d"),
             (stencils.make("3d7p"), (16, 8, 256), 128, 2, 2, "multistep_3d"),
             (stencils.make("3d7p"), (16, 8, 256), 64, 4, 1, "multistep_3d"),
             (stencils.make("3d7p"), (16, 8, 256), 16, 8, 2, "multistep_3d"),
             (stencils.make("3d7p"), (16, 8, 64), 8, 8, 2, "multistep_3d"),     # 8 columns
             (stencils.make("3d7p"), (16, 8, 40), 4, 2, 2, "multistep_3d"),     # 20 columns
             (stencils.make("3d7p"), (16, 8, 256), 128, 2, 5, "multistep_3d"),
             (stencils.make("3d7p"), (16, 8, 256), 8, 8, 16, "multistep_3d"))
    for spec, shape, vl, m, k, key in cases:
        ntaps = len(spec.taps)
        launches = len(sk.far_launches(spec.ndim, m, k, spec.r, ntaps)) \
            if key == "multistep_far" else len(
                (sk.sweep2d_launches if spec.ndim == 2 else sk.sweep3d_launches)(m, k, spec.r))
        if spec.ndim == 2:
            assert sk.sweep2d_route(vl, m, k, spec.r, ntaps) == \
                ("warp" if key == "multistep_2d" else "far")
        else:
            assert sk.sweep3d_route(vl, m, k, spec.r, ntaps) == \
                ("stream" if key == "multistep_3d" else "far")
        t = layouts.to_transpose_layout(_x(shape, 13, cuda), vl, m)
        for edge_mask in (True, False):
            sk.reset_launches()
            got = sk.stencil_nd_multistep(spec, t, k, 16, edge_mask)
            torch.cuda.synchronize()
            assert sk.LAUNCHES == dict.fromkeys(sk.LAUNCHES, 0) | {key: launches}, \
                (spec.name, vl, m, k)
            assert torch.equal(got, sk.stencil_nd_multistep_ref(spec, t, k, 16, edge_mask))
        sk.reset_launches()
        halo = sk.stencil_nd_sweep_halo(spec, t, k, 16, 16)
        assert sk.LAUNCHES == dict.fromkeys(sk.LAUNCHES, 0) | {key: launches}
        assert torch.equal(halo, sk.stencil_nd_multistep_ref(spec, t, k, 16, False))
    t = layouts.to_transpose_layout(_x((64, 4096), 14, cuda), 32, 8)
    with pytest.raises(ValueError, match="in place"):
        sk.stencil_nd_multistep(stencils.make("2d5p"), t, 2, 16, out=t)
    with pytest.raises(NotImplementedError, match="D1"):
        sk.stencil_nd_multistep(stencils.make("2d5p"), t.double(), 2, 16)


# tap lists in no order the 3-D streaming kernel knows at compile time
RUNTIME_TAPS3 = (
    (((0, 0, 1), 0.125), ((0, 0, -1), 0.125), ((1, 0, 0), 0.125), ((-1, 0, 0), 0.125),
     ((0, 1, 0), 0.125), ((0, -1, 0), 0.125), ((0, 0, 0), 0.25)),
    tuple(((oz, oy, ox), (3 + oz + 2 * oy + 5 * ox) / 80)
          for ox in (-1, 0, 1) for oz in (-1, 0, 1) for oy in (-1, 0, 1)),
)
# (n0, n1, nb): the CPU transcription's grids (tests/test_torch_sweep3d.py),
# the card tests' 3-D shapes, and a grid of several row and column tiles
GRIDS3 = ((1, 1, 1), (2, 5, 2), (3, 3, 1), (4, 13, 3), (10, 2, 1), (4, 6, 1), (16, 12, 1),
          (37, 45, 2))
# off vl = 32 the same (n0, n1) with C = nb·vl columns a row: below a tile's
# 16 stored columns, no multiple of 16, and over several column tiles
COLS3 = (5, 20, 8, 40, 24, 100, 12, 70)


def _grids3(vl):
    if vl == 32:
        return GRIDS3
    return tuple((n0, n1, -(-c // vl)) for (n0, n1, _), c in zip(GRIDS3, COLS3))


@pytest.mark.parametrize("vl", (32,) + ANY_VL)
@pytest.mark.parametrize("m", sk.SUB_M)
@pytest.mark.parametrize("name", ["3d7p", "3d27p", "runtime0", "runtime1"])
def test_sweep3d_route_bitwise(cuda, name, m, vl):
    """K3 and K4b on the 3-D streaming kernel at every vl: every depth of
    the route, periodic, ring and open, on grids with one block a row, n1
    below a tile and n0 below the warm-up, at the wrapper's segment and at
    3 planes per CTA.  The wrappers launch the streaming kernel alone."""
    _sweep3d_bitwise(cuda, name, m, vl)


@pytest.mark.parametrize("vl", [4, 8, 32])
@pytest.mark.parametrize("m", [3, 16, 32])
@pytest.mark.parametrize("name", ["3d7p", "3d27p", "runtime0"])
def test_sweep3d_sub_columns_bitwise(cuda, name, m, vl):
    """The same at m off {1, 2, 4, 8}: the instance M = 1 (m = 3) or 8
    (m = 16, 32) with g = m / M sub-columns a column, vl = 32 on the
    any-vl instances."""
    assert sk.sub_columns(m) == ((1, 3) if m == 3 else (8, m // 8))
    _sweep3d_bitwise(cuda, name, m, vl)


def _sweep3d_bitwise(cuda, name, m, vl, dtype=torch.float32):
    """Every depth of the instance (M, r), periodic, ring and open, at the
    wrapper's segment and at 3 planes; ``name`` a registry stencil,
    ``runtime<i>`` (RUNTIME_TAPS3[i]) or ``star3d-r<r>`` (grids of at least
    r planes, t0 = n0)."""
    spec = stencils.make(name) if name.startswith("3d") else \
        _star(3, int(name[-1])) if name.startswith("star3d-r") else \
        stencils.StencilSpec(name, 3, 1, "box", RUNTIME_TAPS3[int(name[-1])])
    big, _ = sk.sub_columns(m)
    for n0, n1, nb in _grids3(vl):
        if n0 < spec.r:
            continue
        t0 = 1 if spec.r == 1 else n0
        x = _x((n0, n1, nb * vl * m), n0 + n1 + nb + m, cuda).to(dtype)
        t = layouts.to_transpose_layout(x, vl, m)
        out = torch.empty_like(t)
        for depth in range(1, sk.SWEEP3D_DEPTH[big, spec.r] + 1):
            for edge in ("periodic", "ring", "open"):
                sk.reset_launches()
                if edge == "periodic":
                    want = sk.stencil_nd_sweep_ttile_ref(spec, t, depth, 1, t0)
                    got = sk.stencil_nd_sweep_ttile(spec, t, depth, 1, t0, out=out)
                    key = "sweep_3d"
                else:
                    want = sk.stencil_nd_multistep_ref(spec, t, depth, t0, edge == "ring")
                    got = sk.stencil_nd_multistep(spec, t, depth, t0, edge == "ring", out=out)
                    key = "multistep_3d"
                torch.cuda.synchronize()
                assert sk.LAUNCHES == dict.fromkeys(sk.LAUNCHES, 0) | {key: 1}
                assert torch.equal(got, want), (n0, n1, nb, depth, edge,
                                                (got - want).abs().max().item())
                sk._sweep3d_launch(spec, t, out, depth, edge, seg=3)
                torch.cuda.synchronize()
                assert torch.equal(out, want), (n0, n1, nb, depth, edge, "seg 3")


@pytest.mark.parametrize("vl,m,key", [(32, 8, "sweep_3d"), (128, 4, "sweep_3d"),
                                      (8, 8, "sweep_3d"), (4, 2, "sweep_3d"),
                                      (8, 16, "sweep_3d"), (16, 32, "sweep_3d"),
                                      (32, 16, "sweep_3d")])
def test_main_path_3d_route_counts(cuda, vl, m, key):
    """The resident run of 3d7p at the plans' tiles: the 3-D streaming
    kernel at any vl and m (m = 16, 32 on sub-columns of 8), K2 on its
    register kernel."""
    assert _k2_key(vl, m) == "transpose"
    prob = StencilProblem("3d7p", (16, 24, 1024))
    x = prob.init(0)
    sk.reset_launches()
    got = prob.run(x, 16, StencilPlan(backend="pallas", sweep="resident", k=2, ttile=2,
                                      vl=vl, m=m))
    assert sk.LAUNCHES == dict.fromkeys(sk.LAUNCHES, 0) | {_k2_key(vl, m): 2, key: 4}
    want = stencils.apply_steps(prob.spec, x, 16)
    assert torch.equal(got, want), (got - want).abs().max().item()


def test_sweep3d_raises_beyond_its_columns(cuda):
    """Off vl = 32 the column math is 32-bit: a row of 2^30 columns or more
    raises before the launch (checked on a zero-size stand-in)."""
    spec = stencils.make("3d7p")
    t = torch.empty((1, 0, sk.MAX_COLS // 8, 1, 8), device=cuda)
    with pytest.raises(ValueError, match="columns a row"):
        sk._sweep3d_launch(spec, t, torch.empty_like(t), 1)
    # sub-columns count: 2^30 of them at m = 16 (g = 2), also at vl = 32
    for vl in (8, 32):
        t = torch.empty((1, 0, sk.MAX_COLS // (2 * vl), 16, vl), device=cuda)
        with pytest.raises(ValueError, match="columns a row"):
            sk._sweep3d_launch(spec, t, torch.empty_like(t), 1)


def test_warp_kernels_raise_beyond_their_columns(cuda):
    """Off m = M the 1-D and 2-D warp kernels' sub-column math is 32-bit
    (and the 2-D kernel's off vl = 32 too): 2^30 sub-columns or more raise
    before the launch (checked on stand-ins that hold no such array)."""
    for vl in (8, 32):
        nb = sk.MAX_COLS // (2 * vl)                # 2^30 sub-columns at m = 16 (g = 2)
        t = torch.empty(1, device=cuda).expand(nb, 16, vl)
        with pytest.raises(ValueError, match="columns at"):
            sk._warp_launch(stencils.make("1d3p"), t, torch.empty(1, device=cuda).expand(
                nb, 16, vl), 1)
        t = torch.empty(1, device=cuda).expand(1, nb, 16, vl)
        with pytest.raises(ValueError, match="columns a row"):
            sk._warp2d_launch(stencils.make("2d5p"), t, torch.empty(1, device=cuda).expand(
                1, nb, 16, vl), 1)


def test_sweep3d_tile_matches_library(cuda):
    """The library's tiles are the ones ``sweep3d_tile`` computes (the
    segment choice and the CPU transcription use the Python copy)."""
    lib = build.load("sweep3d")
    for (m, r), top in sk.SWEEP3D_DEPTH.items():
        assert lib.repro_sweep3d_max_depth(m, r) == top, (m, r)
        orders = (("runtime", 0), ("star", 1), ("box", 2)) if r == 1 else (("runtime", 0),)
        for depth in range(1, top + 1):
            for order, code in orders:
                ty, cx, _, _ = sk.sweep3d_tile(m, depth, order, r)
                got = [lib.repro_sweep3d_tile(m, r, depth, code, w) for w in range(4)]
                assert got[:3] == [ty, cx, ty * cx], (m, r, depth, order)
                assert got[3] <= sk.SWEEP3D_SMEM
        assert lib.repro_sweep3d_tile(m, r, top + 1, 0, 0) == -1


def test_sweep3d_main_path_shape(cuda):
    """3d7p at 128 x 96 x 512 (nb = 2, several row tiles), m = 8: the
    resident sweep at depths 4, 2, 1 and the ring and open sweeps at 2
    and 1, bit for bit."""
    spec = stencils.make("3d7p")
    t = layouts.to_transpose_layout(_x((128, 96, 512), 21, cuda), 32, 8)
    for depth in (4, 2, 1):
        kk, tt = (2, depth // 2) if depth > 2 else (depth, 1)
        got = sk.stencil_nd_sweep_ttile(spec, t, kk, tt, 16)
        assert torch.equal(got, sk.stencil_nd_sweep_ttile_ref(spec, t, kk, tt, 16)), depth
    for depth in (2, 1):
        for edge_mask in (True, False):
            got = sk.stencil_nd_multistep(spec, t, depth, 16, edge_mask)
            want = sk.stencil_nd_multistep_ref(spec, t, depth, 16, edge_mask)
            assert torch.equal(got, want), (depth, edge_mask)


# K5's stencils and their reach: the registry's, the star of reach 6, 8
# and 16, 20 taps of reach 10, 5 taps reaching 16 on one side (_k5_spec)
K5_REACH = {"1d3p": 1, "1d5p": 2, "heat1d": 1, "star1d-r6": 6, "star1d-r8": 8, "taps20": 10,
            "star1d-r16": 16, "lopsided": 16}


def _k5_spec(name):
    if name.startswith("star1d-r"):
        return _star(1, int(name[len("star1d-r"):]))
    if name == "taps20":
        return _taps20()
    if name == "lopsided":
        return stencils.StencilSpec("lopsided", 1, 16, "star", (
            ((3,), 0.125), ((-16,), 0.25), ((0,), 0.5), ((16,), 0.0625), ((-1,), 0.0625)))
    return stencils.make(name)


@pytest.mark.parametrize("name", list(K5_REACH))
@pytest.mark.parametrize("n,vl", [(1 << 20, 32), (96, 8), (40, 8), (16384 + 64, 32),
                                  (96 * 41, 41)])
def test_onestep_naive_kernel_bitwise(cuda, name, n, vl):
    """K5a's register form, in 16-byte words and (input and output one
    element into their storage) element by element, bit for bit its plain
    version (the 5 taps of "lopsided" on the lane form)."""
    spec = _k5_spec(name)
    x = _x((n,), 5, cuda)
    assert sk.onestep_form("naive", spec, x.dtype) == ("lane" if name == "lopsided" else "reg")
    for src, out in ((x, None), (_offset_by_one(x), _offset_by_one(torch.empty_like(x)))):
        sk.reset_launches()
        got = sk.stencil1d_naive_onestep(spec, src, vl, out=out)
        want = sk.stencil1d_naive_onestep_ref(spec, src, vl)
        torch.cuda.synchronize()
        assert sk.LAUNCHES["onestep_naive"] == 1
        assert torch.equal(got, want), (got - want).abs().max().item()


K5B_TILES = [(32, 8, 4096), (8, 4, 5), (4, 2, 7), (32, 2, 33), (3, 5, 4), (4, 32, 3),
             (8, 16, 5), (41, 6, 3), (1, 12, 9), (32, 3, 2), (5, 7, 1), (3, 40, 7), (64, 16, 2)]


@pytest.mark.parametrize("name,vl,m,nb", [(name, *tile) for name in K5_REACH
                                          for tile in K5B_TILES if K5_REACH[name] <= tile[1]])
def test_onestep_transpose_kernel_bitwise(cuda, name, vl, m, nb):
    """K5b's register form on runs of 8, 4, 2 and 1 rows, m past 16, r = m,
    nb = 1, vl = 1 and off 32, bit for bit its plain version."""
    spec = _k5_spec(name)
    t = layouts.to_transpose_layout(_x((nb * vl * m,), 6, cuda), vl, m)
    sk.reset_launches()
    got = sk.stencil1d_transpose_onestep(spec, t)
    want = sk.stencil1d_transpose_onestep_ref(spec, t)
    torch.cuda.synchronize()
    assert sk.LAUNCHES["onestep_transpose"] == 1
    assert torch.equal(got, want), (got - want).abs().max().item()


@pytest.mark.parametrize("remainder", ["fused", "native"])
@pytest.mark.parametrize("name,shape", [
    ("1d3p", (1 << 15,)), ("1d5p", (4096,)), ("2d5p", (64, 1024)), ("3d7p", (16, 16, 256)),
])
def test_roundtrip_equals_resident(cuda, name, shape, remainder):
    prob = StencilProblem(name, shape)
    x = prob.init(1)
    steps = 7
    sk.reset_launches()
    got = prob.run(x, steps, StencilPlan(backend="pallas", sweep="roundtrip", k=2,
                                         remainder=remainder))
    chunks = sweep_schedule(2, steps, remainder, 1)[0]
    vl, m, _ = ops.pick_tile(prob.spec, shape)
    want = {"transpose": 2 * sum(n for _, n in chunks)}
    for depth, n in chunks:
        if prob.spec.ndim == 1:
            key = "multistep_1d"
        elif prob.spec.ndim == 2 and sk.sweep2d_route(vl, m, depth, prob.spec.r,
                                                      len(prob.spec.taps)) == "warp":
            key = "multistep_2d"
        elif prob.spec.ndim == 3 and sk.sweep3d_route(vl, m, depth, prob.spec.r,
                                                      len(prob.spec.taps)) == "stream":
            key = "multistep_3d"
        else:
            key = "multistep_far"
        want[key] = want.get(key, 0) + n
    assert sk.LAUNCHES == dict.fromkeys(sk.LAUNCHES, 0) | want
    for ttile in (1, 2):
        res = prob.run(x, steps, StencilPlan(backend="pallas", sweep="resident", k=2,
                                             remainder=remainder, ttile=ttile))
        assert torch.equal(got, res), (got - res).abs().max().item()


def test_stencil_run_dirichlet_matches_plain(cuda):
    spec = stencils.make("2d5p")
    x = _x((64, 1024), 7, cuda)
    got = ops.stencil_run(spec, x, 6, k=2)
    want = stencils.apply_steps(spec, x, 6, bc=("dirichlet", "periodic"))
    assert torch.equal(got, want), (got - want).abs().max().item()


def test_onestep_kernels_raise(cuda):
    spec = stencils.make("1d3p")
    x = _x((4096,), 8, cuda)
    t = layouts.to_transpose_layout(x, 32, 8)
    with pytest.raises(NotImplementedError, match="D1"):
        sk.stencil1d_naive_onestep(spec, x.double(), 32)
    with pytest.raises(ValueError, match="in place"):
        sk.stencil1d_naive_onestep(spec, x, 32, out=x)
    with pytest.raises(ValueError, match="in place"):
        sk.stencil1d_transpose_onestep(spec, t, out=t)


def _ssd_inputs(nc, b, q, h, p, n, device, dtype=torch.float32, shared_bc=False, seed=0):
    """K6's inputs; ``shared_bc`` gives B and C a head axis of stride 0."""
    g = torch.Generator(device=device).manual_seed(seed)
    hb = 1 if shared_bc else h
    xh = (0.5 * torch.randn(nc, b, q, h, p, generator=g, device=device)).to(dtype)
    bm = 0.5 * torch.randn(nc, b, q, hb, n, generator=g, device=device)
    cm = 0.5 * torch.randn(nc, b, q, hb, n, generator=g, device=device)
    if shared_bc:
        bm, cm = bm.expand(nc, b, q, h, n), cm.expand(nc, b, q, h, n)
    dt = torch.nn.functional.softplus(torch.randn(nc, b, q, h, generator=g, device=device))
    a_neg = -torch.linspace(0.5, 2.0, h, device=device)
    return xh, bm, cm, dt, a_neg


SSD_TOL = {torch.float32: dict(rtol=2e-4, atol=2e-4), torch.bfloat16: dict(rtol=5e-2, atol=5e-2)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,shared_bc", [
    ((16, 1, 128, 80, 64, 128), True),      # mamba2-2.7b, a 2048-token prompt
    ((16, 1, 128, 80, 64, 64), True),       # zamba2-2.7b (N = 64), a 2048-token prompt
    ((8, 1, 125, 80, 64, 64), True),        # zamba2-2.7b, a 1000-token prompt at Q = 125
    ((271, 1, 1, 80, 64, 64), True),        # zamba2-2.7b, 256 + 15 tokens (a prime) at Q = 1
    ((8, 1, 125, 80, 64, 128), True),       # a 1000-token prompt runs at Q = 125
    ((37, 2, 1, 4, 64, 128), False),        # a prime length runs at Q = 1
    ((4, 2, 8, 2, 8, 4), False),            # the reference test's shapes
    ((2, 1, 16, 4, 20, 8), False),          # P not a multiple of the 16-column tile
    ((3, 2, 33, 8, 16, 16), True),
    ((251, 1, 1, 8, 64, 128), True),        # a prime length past one internal chunk, Q = 1
    ((3, 2, 125, 4, 64, 128), False),       # Q = 125 across internal chunks, B = 2
    ((4, 2, 100, 8, 64, 128), True),        # B = 2 with a head axis of stride 0
    ((3, 1, 50, 2, 24, 4), False),          # P and N off the 16-column and 8-row tiles
    ((5, 1, 30, 2, 20, 6), True),           # rows of 80 / 24 bytes: element loads
    ((2, 1, 128, 2, 96, 16), False),        # P past one 64-column tile
])
def test_ssd_kernel_matches_plain(cuda, shape, shared_bc, dtype):
    args = _ssd_inputs(*shape, cuda, dtype, shared_bc)
    ssd.reset_launches()
    y, state = ssd.ssd_chunk_scan(*args, return_state=True)
    torch.cuda.synchronize()
    assert ssd.LAUNCHES == {"ssd_state": 1, "ssd_out": 1}
    y_ref, state_ref = ssd.ssd_chunk_scan_ref(*args, return_state=True)
    assert y.dtype == dtype and y.shape == args[0].shape
    torch.testing.assert_close(y.float(), y_ref.float(), **SSD_TOL[dtype])
    torch.testing.assert_close(state, state_ref, **SSD_TOL[torch.float32])


@pytest.mark.parametrize("shape", [(4, 2, 8, 2, 8, 4), (12, 1, 1, 3, 16, 8), (3, 1, 7, 8, 24, 16)])
def test_ssd_kernel_matches_oracle(cuda, shape):
    args = _ssd_inputs(*shape, cuda, seed=1)
    y, state = ssd.ssd_chunk_scan(*args, return_state=True)
    y_o, state_o = ssd.ssd_chunk_ref(*args, return_state=True)
    torch.testing.assert_close(y, y_o, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(state, state_o, rtol=2e-4, atol=2e-4)


def test_ssd_kernel_writes_strided_out(cuda):
    xh, bm, cm, dt, a = _ssd_inputs(4, 2, 16, 4, 32, 16, cuda, seed=2)
    buf = torch.full((2, 4, 16, 4, 32), float("nan"), device=cuda)
    ssd.ssd_chunk_scan(xh.transpose(0, 1).contiguous().transpose(0, 1), bm, cm, dt, a,
                       out=buf.transpose(0, 1))
    torch.testing.assert_close(buf.transpose(0, 1), ssd.ssd_chunk_scan_ref(xh, bm, cm, dt, a),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel_writes_strided_out_across_chunks(cuda, dtype):
    xh, bm, cm, dt, a = _ssd_inputs(3, 2, 100, 4, 64, 128, cuda, dtype, shared_bc=True, seed=3)
    buf = torch.full((2, 3, 100, 4, 64), float("nan"), device=cuda, dtype=dtype)
    y, state = ssd.ssd_chunk_scan(xh, bm, cm, dt, a, out=buf.transpose(0, 1), return_state=True)
    assert y.data_ptr() == buf.data_ptr()
    y_ref, state_ref = ssd.ssd_chunk_scan_ref(xh, bm, cm, dt, a, return_state=True)
    torch.testing.assert_close(buf.transpose(0, 1).float(), y_ref.float(), **SSD_TOL[dtype])
    torch.testing.assert_close(state, state_ref, **SSD_TOL[torch.float32])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel_two_calls_equal_bitwise(cuda, dtype):
    """No atomics: the same inputs give the same bits."""
    args = _ssd_inputs(16, 1, 128, 80, 64, 128, cuda, dtype, shared_bc=True, seed=4)
    y1, s1 = ssd.ssd_chunk_scan(*args, return_state=True)
    y2, s2 = ssd.ssd_chunk_scan(*args, return_state=True)
    assert torch.equal(y1, y2) and torch.equal(s1, s2)


def test_ssd_kernel_bf16_state(cuda):
    """The final state of a bfloat16 layer is held at the float32 tolerance
    (the state product is split in three TF32 products in both dtypes)."""
    args = _ssd_inputs(32, 1, 128, 80, 64, 128, cuda, torch.bfloat16, shared_bc=True, seed=5)
    _, state = ssd.ssd_chunk_scan(*args, return_state=True)
    _, state_ref = ssd.ssd_chunk_scan_ref(*args, return_state=True)
    torch.testing.assert_close(state, state_ref, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,shared_bc", [((16, 1, 128, 80, 64, 128), True),
                                             ((251, 2, 1, 4, 24, 6), False)])
def test_ssd_kernels_each_match_their_plain_version(cuda, shape, shared_bc, dtype):
    """``ssd_state``'s h_in and final state against ``ssd_state_ref``, and
    ``ssd_out`` from that h_in against ``ssd_out_ref``."""
    xh, bm, cm, dt, a = _ssd_inputs(*shape, cuda, dtype, shared_bc, seed=6)
    n = shape[-1]
    state = torch.empty(shape[1], shape[3], shape[4], n, device=cuda)
    ssd.reset_launches()
    h_in = ssd.ssd_state(xh, bm, dt, a, state=state)
    y = ssd.ssd_out(xh, bm, cm, dt, a, h_in)
    torch.cuda.synchronize()
    assert ssd.LAUNCHES == {"ssd_state": 1, "ssd_out": 1}
    h_ref, state_ref = ssd.ssd_state_ref(xh, bm, dt, a)
    assert not h_in[..., n:].any()
    torch.testing.assert_close(h_in[..., :n], h_ref, **SSD_TOL[torch.float32])
    torch.testing.assert_close(state, state_ref, **SSD_TOL[torch.float32])
    torch.testing.assert_close(y.float(), ssd.ssd_out_ref(xh, bm, cm, dt, a, h_in).float(),
                               **SSD_TOL[dtype])


def test_ssd_tf32_rounding_is_cvt_rna(cuda):
    """The kernels round TF32 operands on the integer pipe; over every
    non-NaN float32 bit pattern the bits equal ``cvt.rna.tf32.f32``'s."""
    assert ssd.tf32_rounding_mismatches(cuda) == 0


def test_ssd_kernel_raises(cuda):
    args = _ssd_inputs(2, 1, 8, 2, 8, 4, cuda)
    xh, bm, cm, dt, a = args
    with pytest.raises(ValueError, match="at most 128"):
        ssd.ssd_chunk_scan(*_ssd_inputs(1, 1, 129, 2, 8, 4, cuda))
    with pytest.raises(ValueError, match="at most 128"):
        ssd.ssd_chunk_scan(*_ssd_inputs(1, 1, 8, 2, 8, 129, cuda))
    with pytest.raises(ValueError, match="CUDA device"):
        ssd.ssd_chunk_scan(xh, bm.cpu(), cm, dt, a)
    with pytest.raises(ValueError, match="CUDA device"):
        ssd._launch(xh.cpu(), bm.cpu(), cm.cpu(), dt.cpu(), a.cpu(), xh.cpu(), None)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ssd.ssd_chunk_scan(xh.half(), bm, cm, dt, a)
    with pytest.raises(TypeError, match="bm must be float32"):
        ssd.ssd_chunk_scan(xh, bm.double(), cm, dt, a)


def test_ssd_counter_per_prefill(cuda):
    from repro_torch.configs.base import get_arch
    from repro_torch.models import transformer, zoo
    from repro_torch.serve.engine import ContinuousBatcher, Request
    cfg = get_arch("mamba2-2.7b").smoke()
    model = zoo.build(cfg)
    params = transformer.cast_params(model.init(torch.Generator(device=cuda).manual_seed(0)))
    eng = ContinuousBatcher(model, params, n_slots=2, max_seq=64)
    rng = np.random.default_rng(0)
    for rid, n in enumerate((5, 17, 9)):
        eng.submit(Request(rid=rid, prompt=rng.integers(0, cfg.vocab, n), max_new=4))
    ssd.reset_launches()
    done = eng.run(max_steps=64)
    assert len(done) == 3
    # one of each kernel per layer and prefill; decode launches no K6
    assert ssd.LAUNCHES == {"ssd_state": 3 * cfg.n_layers, "ssd_out": 3 * cfg.n_layers}
    full, _ = model.forward(params, {"tokens": torch.tensor(done[0].prompt[None], device=cuda)})
    assert torch.isfinite(full).all()


def test_batcher_past_eight_slots_matches_single_slot_engines(cuda):
    """ROADMAP C2: an engine of 9 slots decodes at 16 lanes, a request alone
    at 8.  Eleven requests through 9 slots (two wait for a free slot) give
    the greedy tokens of fresh 1-slot engines on the card."""
    from repro_torch.configs.base import get_arch
    from repro_torch.models import transformer, zoo
    from repro_torch.serve.engine import ContinuousBatcher, Request, decode_lanes
    cfg = get_arch("mamba2-2.7b").smoke()
    model = zoo.build(cfg)
    params = transformer.cast_params(model.init(torch.Generator(device=cuda).manual_seed(0)))
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, cfg.vocab, n) for n in (4, 11, 6, 9, 3, 14, 7, 5, 12, 8, 10)]
    max_new = 8

    def alone(prompt):
        eng = ContinuousBatcher(model, params, n_slots=1, max_seq=64)
        eng.submit(Request(rid=0, prompt=prompt, max_new=max_new))
        return eng.run(max_steps=64)[0].out
    expected = [alone(p) for p in prompts]
    eng = ContinuousBatcher(model, params, n_slots=9, max_seq=64)
    assert eng.lanes == decode_lanes(9) == 16
    for rid, p in enumerate(prompts):
        eng.submit(Request(rid=rid, prompt=p, max_new=max_new))
    done = sorted(eng.run(max_steps=64), key=lambda r: r.rid)
    assert [r.rid for r in done] == list(range(len(prompts)))
    for req, want in zip(done, expected):
        assert req.out == want, (req.rid, req.out, want)


@pytest.mark.parametrize("name", ["zamba2-2.7b", "gemma-2b", "starcoder2-7b"])
def test_lm_on_card_matches_cpu(cuda, name):
    """The hybrid (K6 in each SSM layer's prefill, the shared attention
    block) and dense families at ``smoke()`` size, float32: forward, then
    prefill and decode at per-sequence positions, on the card against the
    same model's plain path on the CPU, within 1e-4; each prefill launches
    K6 once a SSM layer and decode never."""
    from repro_torch.configs.base import get_arch
    from repro_torch.models import transformer, zoo
    cfg = get_arch(name).smoke()
    model = zoo.build(cfg, act_dtype=torch.float32)
    params = model.init(torch.Generator().manual_seed(0))
    on_card = transformer.tree_map(lambda a: a.to(cuda), params)
    toks = torch.tensor(np.random.default_rng(1).integers(0, cfg.vocab, (2, 14)))
    tol = dict(rtol=1e-4, atol=1e-4)
    ssm_layers = cfg.n_layers if cfg.family == "hybrid" else 0
    ssd.reset_launches()
    full = model.forward(on_card, {"tokens": toks.to(cuda)})[0]
    torch.testing.assert_close(full.cpu(), model.forward(params, {"tokens": toks})[0], **tol)
    last, cache = model.prefill(on_card, {"tokens": toks[:, :9].to(cuda)}, max_seq=14)
    last_cpu, cache_cpu = model.prefill(params, {"tokens": toks[:, :9]}, max_seq=14)
    torch.cuda.synchronize()
    assert ssd.LAUNCHES == {"ssd_state": 2 * ssm_layers, "ssd_out": 2 * ssm_layers}
    torch.testing.assert_close(last.cpu(), last_cpu, **tol)
    for got, want in zip(transformer.tree_leaves(cache), transformer.tree_leaves(cache_cpu)):
        torch.testing.assert_close(got.cpu(), want, **tol)
    for i in range(9, 14):
        pos = torch.tensor([i, i])
        logits, cache = model.decode_step(on_card, cache, {"tokens": toks[:, i:i + 1].to(cuda)},
                                          pos.to(cuda))
        want, cache_cpu = model.decode_step(params, cache_cpu, {"tokens": toks[:, i:i + 1]}, pos)
        torch.testing.assert_close(logits.cpu(), want, **tol)
        torch.testing.assert_close(logits[:, 0].cpu(), full[:, i].cpu(), **tol)
    torch.cuda.synchronize()
    assert ssd.LAUNCHES == {"ssd_state": 2 * ssm_layers, "ssd_out": 2 * ssm_layers}


@pytest.mark.parametrize("name", ["zamba2-2.7b", "gemma-2b"])
def test_lm_batcher_on_card_matches_single_slot_engines(cuda, name):
    """Ragged prompts through a 3-slot batcher on the card (bf16 weights)
    give the greedy tokens of fresh 1-slot engines; K6 launches once a SSM
    layer and prefill."""
    from repro_torch.configs.base import get_arch
    from repro_torch.models import transformer, zoo
    from repro_torch.serve.engine import ContinuousBatcher, Request
    cfg = get_arch(name).smoke()
    model = zoo.build(cfg)
    params = transformer.cast_params(model.init(torch.Generator(device=cuda).manual_seed(0)))
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab, n) for n in (5, 17, 9, 12)]

    def alone(prompt):
        eng = ContinuousBatcher(model, params, n_slots=1, max_seq=64)
        eng.submit(Request(rid=0, prompt=prompt, max_new=6))
        return eng.run(max_steps=64)[0].out
    expected = [alone(p) for p in prompts]
    eng = ContinuousBatcher(model, params, n_slots=3, max_seq=64)
    for rid, p in enumerate(prompts):
        eng.submit(Request(rid=rid, prompt=p, max_new=6))
    ssd.reset_launches()
    done = sorted(eng.run(max_steps=64), key=lambda r: r.rid)
    torch.cuda.synchronize()
    ssm_layers = cfg.n_layers if cfg.family == "hybrid" else 0
    assert ssd.LAUNCHES == {"ssd_state": 4 * ssm_layers, "ssd_out": 4 * ssm_layers}
    for req, want in zip(done, expected):
        assert req.out == want, (req.rid, req.out, want)


@pytest.mark.parametrize("seq,chunk", [(24, 8), (20, 8), (13, 8)])    # Q = 8, 5, 1
def test_ssd_full_on_card_matches_cpu(cuda, seq, chunk):
    """``ssd_full`` hands K6 chunk-major views of the projection (and B, C
    with a head stride of 0): on the card it matches the plain path on the
    CPU, output and final state, in float32."""
    import dataclasses

    from repro_torch.configs.base import get_arch
    from repro_torch.models import ssm, transformer
    cfg = dataclasses.replace(get_arch("mamba2-2.7b").smoke(), ssm_chunk=chunk)
    p = ssm.init_ssm(torch.Generator().manual_seed(0), cfg)
    x = 0.5 * torch.randn(2, seq, cfg.d_model, generator=torch.Generator().manual_seed(1))
    want, st_want = ssm.ssd_full(p, x, cfg, return_state=True)
    ssd.reset_launches()
    got, st_got = ssm.ssd_full(transformer.tree_map(lambda a: a.to(cuda), p), x.to(cuda), cfg,
                               return_state=True)
    assert ssd.LAUNCHES == {"ssd_state": 1, "ssd_out": 1}
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(st_got.h.cpu(), st_want.h, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(st_got.conv.cpu(), st_want.conv, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# K2 at every vl >= 4 and m (transpose_any), and K3/K4b past the register
# kernels' deepest instances
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float16, torch.float32, torch.float64])
@pytest.mark.parametrize("m", [3, 5, 9, 12, 24, 25, 64])
@pytest.mark.parametrize("vl", [4, 5, 8, 96, 256])
def test_transpose_any_bitwise(cuda, vl, m, dtype):
    """The register route's run-time G and vl (and the fixed instances
    where vl is a power of two and m = 3, 5): both directions bit for bit,
    over a partial last CTA, each a launch of ``transpose``."""
    x = _bits((2, 7 * vl * m), dtype, vl * 100 + m, cuda)
    assert sk.transpose_route(vl, m, x.element_size(), x.numel()) == "reg"
    sk.reset_launches()
    t = sk.block_transpose(x, vl, m)
    back = sk.block_untranspose(t, vl, m)
    torch.cuda.synchronize()
    assert sk.LAUNCHES == dict.fromkeys(sk.LAUNCHES, 0) | {"transpose": 2}
    assert _same_bits(t, sk.block_transpose_ref(x, vl, m))
    assert _same_bits(back, x)


@pytest.mark.parametrize("vl,m", [(96, 8), (8, 12), (5, 24), (256, 25)])
def test_transpose_any_unaligned_pointers(cuda, vl, m):
    x = _bits((1 + 9 * vl * m,), torch.float32, 13, cuda)[1:]
    t = sk.block_transpose(x, vl, m)
    assert _same_bits(t, sk.block_transpose_ref(x, vl, m))
    out = torch.empty(1 + x.numel(), dtype=x.dtype, device=cuda)[1:]
    assert _same_bits(sk.block_untranspose(t, vl, m, out=out), x)


def test_instance_tables_match_kernels(cuda):
    """The Python tables of the 2-D and 3-D kernels' instances at every
    reach are the libraries' own."""
    lib2, lib3 = build.load("sweep2d_warp"), build.load("sweep3d")
    for r in range(1, sk.WARP2D_MAX_R + 2):
        for mm in sk.SUB_M:
            for depth in range(0, 34):
                want = r <= sk.WARP2D_MAX_R and depth in sk.sweep2d_depths(r)[mm]
                assert bool(lib2.repro_sweep2d_warp_has_depth(mm, r, depth)) == want, \
                    (mm, r, depth)
            assert lib3.repro_sweep3d_max_depth(mm, r) == sk.SWEEP3D_DEPTH.get((mm, r), 0)


def _deep_check(cuda, spec, shape, vl, m, depth, edge, launch=None, dtype=torch.float32):
    """``depth`` steps with the ends ``edge`` through the wrapper (counted:
    one launch per instance of the route's plan) and, given ``launch``,
    through ``launch`` alone; bit for bit the plain version."""
    t = layouts.to_transpose_layout(_x(shape, depth + m + vl, cuda).to(dtype), vl, m)
    out = torch.empty_like(t)
    kind = "sweep" if edge == "periodic" else "multistep"
    plan = (sk.sweep2d_launches if spec.ndim == 2 else sk.sweep3d_launches)(m, depth, spec.r)
    t0 = 1 if spec.r == 1 else shape[0]
    if edge == "periodic":
        want = sk.stencil_nd_sweep_ttile_ref(spec, t, depth, 1, t0)
    else:
        want = sk.stencil_nd_multistep_ref(spec, t, depth, t0, edge == "ring")
    sk.reset_launches()
    if edge == "periodic":
        got = sk.stencil_nd_sweep_ttile(spec, t, depth, 1, t0, out=out)
    else:
        got = sk.stencil_nd_multistep(spec, t, depth, t0, edge == "ring", out=out)
    torch.cuda.synchronize()
    assert got.data_ptr() == out.data_ptr()
    assert sk.LAUNCHES == dict.fromkeys(sk.LAUNCHES, 0) | {f"{kind}_{spec.ndim}d": len(plan)}
    assert torch.equal(got, want), (shape, vl, m, depth, edge, (got - want).abs().max().item())
    if launch is not None:
        out.zero_()
        launch(spec, t, out, depth, edge)
        torch.cuda.synchronize()
        assert torch.equal(out, want), (shape, vl, m, depth, edge, "one launch")


@pytest.mark.parametrize("edge", ["periodic", "ring", "open"])
@pytest.mark.parametrize("m,depth", [(12, 5), (4, 8), (6, 16), (3, 8), (10, 16), (2, 16),
                                     (4, 6)])
@pytest.mark.parametrize("name", ["2d5p", "2d9p", "heat2d"])
def test_sweep2d_deep_bitwise(cuda, name, m, depth, edge):
    """The 2-D warp kernel past M = 8's depth: one launch of the instance
    M < 8 of m (the deep M = 2 at depth 16 too), through the route and
    alone at a 4-row segment, on grids near the CTA's columns and at 2048²
    (vl 8 and 32)."""
    spec = stencils.make(name)
    assert len(sk.sweep2d_launches(m, depth, 1)) == 1

    def launch(spec, t, out, d, edge):
        sk._warp2d_launch(spec, t, out, d, edge, seg_rows=4)
    for n0, cols, vl in ((2 * depth + 1, 296, 8), (37, 40, 32), (2048, 2048, 8)):
        nb = -(-cols // (vl * m))
        _deep_check(cuda, spec, (n0, nb * vl * m), vl, m, depth, edge,
                    launch if n0 < 2048 else None)


@pytest.mark.parametrize("edge", ["periodic", "ring", "open"])
@pytest.mark.parametrize("m,depth", [(8, 12), (8, 32), (1, 16), (3, 9), (16, 20)])
def test_sweep2d_split_bitwise(cuda, m, depth, edge):
    """Depths no instance has: consecutive launches, each counted."""
    assert len(sk.sweep2d_launches(m, depth, 1)) > 1
    _deep_check(cuda, stencils.make("2d5p"), (2 * depth + 5, 64 * 8 * m), 8, m, depth, edge)


@pytest.mark.parametrize("edge", ["periodic", "ring", "open"])
@pytest.mark.parametrize("m", [2, 1, 3, 6, 10, 16])
@pytest.mark.parametrize("name", ["3d7p", "3d27p", "runtime0"])
def test_sweep3d_deep_sub_columns_bitwise(cuda, name, m, edge):
    """Depth 8 as two depth-4 launches of the instance M of m (1, 2, or 8
    on two sub-columns), on grids of several row and column tiles, bit for
    bit the plain version."""
    spec = stencils.make(name) if name.startswith("3d") else \
        stencils.StencilSpec(name, 3, 1, "box", RUNTIME_TAPS3[int(name[-1])])
    big, g = sk.sub_columns(m)
    assert sk.sweep3d_launches(m, 8, 1) == ((big, g, 4),) * 2
    for n0, n1, cols, vl in ((3, 5, 5, 8), (19, 45, 70, 8), (6, 12, 40, 32)):
        nb = -(-cols // (vl * g))
        _deep_check(cuda, spec, (n0, n1, nb * vl * m), vl, m, 8, edge)


@pytest.mark.parametrize("edge", ["periodic", "ring", "open"])
@pytest.mark.parametrize("m,depth", [(8, 8), (8, 16), (8, 32), (3, 6), (16, 8)])
def test_sweep3d_split_bitwise(cuda, m, depth, edge):
    """Past depth 4: consecutive launches, each counted."""
    _deep_check(cuda, stencils.make("3d7p"), (2 * depth + 3, 20, 32 * 8 * m), 8, m, depth,
                edge)


@pytest.mark.parametrize("k,ttile", [(4, 2), (4, 4)])
@pytest.mark.parametrize("vl,m", [(32, 8), (8, 8)])
@pytest.mark.parametrize("name,shape", [("2d5p", (64, 2048)), ("3d7p", (16, 24, 1024))])
def test_main_path_deep_plans(cuda, name, shape, vl, m, k, ttile):
    """The resident run at the reference tuner's deep plans (depth 8 and
    16): its launches by the route's plan, bit for bit the depth-4 run."""
    prob = StencilProblem(name, shape)
    x = prob.init(0)
    spec = prob.spec
    depth = k * ttile
    plan = (sk.sweep2d_launches if spec.ndim == 2 else sk.sweep3d_launches)(m, depth, spec.r)
    chunks = sweep_schedule(k, 16, "fused", ttile)[0]
    assert chunks == [(depth, 16 // depth)]
    sk.reset_launches()
    got = prob.run(x, 16, StencilPlan(backend="pallas", sweep="resident", k=k, ttile=ttile,
                                      vl=vl, m=m))
    torch.cuda.synchronize()
    assert sk.LAUNCHES == dict.fromkeys(sk.LAUNCHES, 0) | {
        _k2_key(vl, m): 2, f"sweep_{spec.ndim}d": len(plan) * 16 // depth}
    want = prob.run(x, 16, StencilPlan(backend="pallas", sweep="resident", k=2, ttile=2,
                                       vl=32, m=8))
    assert torch.equal(got, want), (got - want).abs().max().item()


# ---------------------------------------------------------------------------
# bfloat16 in every stencil kernel (each product and sum rounded to
# bfloat16, bit for bit the plain versions), f64 still raising (ROADMAP D1),
# and K2 past 2^31 threads
# ---------------------------------------------------------------------------

BF16 = torch.bfloat16


@pytest.mark.parametrize("edge", ["periodic", "ring", "open"])
@pytest.mark.parametrize("name,vl,m", [("1d3p", 32, 8), ("1d3p", 8, 3), ("1d5p", 32, 4),
                                       ("heat1d", 4, 16), ("1d5p", 3, 2), ("1d3p", 64, 1)])
def test_bf16_sweep1d_warp_bitwise(cuda, name, vl, m, edge):
    """K1 and K4a on the warp kernel in bfloat16 (vl = 32 on the any-vl
    instances), every end, at depths up to the route's deepest."""
    _sweep1d_bitwise(cuda, name, m, vl, edge, BF16)


@pytest.mark.parametrize("edge", ["periodic", "ring", "open"])
@pytest.mark.parametrize("name,vl,m", [("2d5p", 32, 8), ("2d9p", 8, 2), ("heat2d", 16, 4),
                                       ("2d5p", 3, 5), ("2d5p", 8, 16), ("2d9p", 2, 7)])
def test_bf16_sweep2d_warp_bitwise(cuda, name, vl, m, edge):
    """K3 and K4b on the 2-D warp kernel in bfloat16: the copies of
    bfloat16 words, rows of an odd length (vl=3, m=5 and vl=2, m=7: the
    element's half changes row by row), every depth of the instance."""
    _sweep2d_bitwise(cuda, name, m, vl, edge, BF16)


@pytest.mark.parametrize("vl,m", [(32, 8), (8, 4), (3, 5), (16, 2), (8, 16), (5, 1)])
@pytest.mark.parametrize("name", ["3d7p", "3d27p", "runtime0"])
def test_bf16_sweep3d_bitwise(cuda, name, vl, m):
    """K3 and K4b on the 3-D streaming kernel in bfloat16: star, box and
    run-time orders, periodic, ring and open, every depth, odd rows and
    planes (vl=3, m=5; vl=5, m=1)."""
    _sweep3d_bitwise(cuda, name, m, vl, BF16)


@pytest.mark.parametrize("edge", ["periodic", "ring", "open"])
@pytest.mark.parametrize("name,shape,vl,m,depth", [
    ("2d5p", (21, 320), 8, 8, 8), ("2d5p", (37, 256), 32, 2, 16),
    ("heat2d", (19, 240), 8, 6, 16), ("3d7p", (19, 20, 512), 8, 8, 8),
    ("3d27p", (11, 9, 96), 32, 3, 6)])
def test_bf16_deep_bitwise(cuda, name, shape, vl, m, depth, edge):
    """Deep sweeps in bfloat16: consecutive launches (2-D M=8, 3-D) and the
    deep M=2 instance, bit for bit one plain deep sweep."""
    _deep_check(cuda, stencils.make(name), shape, vl, m, depth, edge, dtype=BF16)


@pytest.mark.parametrize("edge_mask", [None, True, False])
@pytest.mark.parametrize("spec,shape,vl,m,t0,depth", [
    (_star(1, 5), (32 * 8 * 5,), 8, 5, None, 2),                 # r = 5 > 4: beyond the
    (_star(1, 5), (96 * 10,), 32, 6, None, 3),                   # register kernels' reach
    (_star(2, 5), (24, 512), 8, 8, 8, 3),
    (_star(3, 5), (8, 12, 256), 8, 8, 8, 2),
])
def test_bf16_smem_routes_bitwise(cuda, spec, shape, vl, m, t0, depth, edge_mask):
    """The far-reach kernel (``sweep_far.cu``) in bfloat16 on the shapes its
    routes take (reach 5 at every rank, chains past its deepest launch):
    periodic (``edge_mask`` None), ring and open."""
    t = layouts.to_transpose_layout(_x(shape, 3, cuda).to(BF16), vl, m)
    nd = spec.ndim
    route = (sk.sweep1d_route if nd == 1 else sk.sweep2d_route if nd == 2 else
             sk.sweep3d_route)(vl, m, depth, spec.r, len(spec.taps))
    assert route == "far"
    launches = len(sk.far_launches(nd, m, depth, spec.r, len(spec.taps), 2))
    sk.reset_launches()
    if edge_mask is None:
        got = sk.stencil1d_sweep_ttile(spec, t, depth, 1) if nd == 1 else \
            sk.stencil_nd_sweep_ttile(spec, t, depth, 1, t0)
        want = sk.stencil1d_sweep_ttile_ref(spec, t, depth, 1) if nd == 1 else \
            sk.stencil_nd_sweep_ttile_ref(spec, t, depth, 1, t0)
        key = "sweep_far"
    else:
        got = sk.stencil1d_multistep(spec, t, depth, edge_mask) if nd == 1 else \
            sk.stencil_nd_multistep(spec, t, depth, t0, edge_mask)
        want = sk.stencil1d_multistep_ref(spec, t, depth, edge_mask) if nd == 1 else \
            sk.stencil_nd_multistep_ref(spec, t, depth, t0, edge_mask)
        key = "multistep_far"
    torch.cuda.synchronize()
    assert sk.LAUNCHES == dict.fromkeys(sk.LAUNCHES, 0) | {key: launches}
    assert got.dtype == BF16 and torch.equal(got, want), (got.float() - want.float()).abs().max()


@pytest.mark.parametrize("name", list(K5_REACH))
def test_bf16_onestep_kernels_bitwise(cuda, name):
    """K5a and K5b in bfloat16: K5a in 16-byte words and (one element into
    its storage) element by element, K5b at every run length, m past 16
    and r = m, each counted."""
    spec = _k5_spec(name)
    for n, vl in ((1 << 20, 32), (96, 8), (16384 + 64, 32), (96 * 41, 41)):
        x = _x((n,), 5, cuda).to(BF16)
        for src in (x, _offset_by_one(x)):
            sk.reset_launches()
            got = sk.stencil1d_naive_onestep(spec, src, vl)
            torch.cuda.synchronize()
            assert sk.LAUNCHES["onestep_naive"] == 1
            assert torch.equal(got, sk.stencil1d_naive_onestep_ref(spec, src, vl)), (n, vl)
    for vl, m, nb in K5B_TILES:
        if K5_REACH[name] > m:
            continue
        t = layouts.to_transpose_layout(_x((nb * vl * m,), 6, cuda).to(BF16), vl, m)
        sk.reset_launches()
        got = sk.stencil1d_transpose_onestep(spec, t)
        torch.cuda.synchronize()
        assert sk.LAUNCHES["onestep_transpose"] == 1
        assert torch.equal(got, sk.stencil1d_transpose_onestep_ref(spec, t)), (vl, m, nb)


def _offset_by_one(t):
    """``t`` copied into a contiguous view one element into its storage:
    bfloat16 words then hold the element in their other half."""
    view = torch.empty(1 + t.numel(), dtype=t.dtype, device=t.device)[1:].view(t.shape)
    return view.copy_(t)


@pytest.mark.parametrize("name,shape,vl,m", [("2d5p", (13, 3 * 3 * 5), 3, 5),
                                             ("2d5p", (9, 512), 32, 8),
                                             ("3d7p", (6, 5, 5 * 7), 5, 7),
                                             ("3d27p", (5, 6, 256), 32, 8)])
def test_bf16_unaligned_views(cuda, name, shape, vl, m):
    """The 2-D and 3-D kernels on bfloat16 views one element into their
    storage (input and output), bit for bit the plain versions."""
    spec = stencils.make(name)
    t = _offset_by_one(layouts.to_transpose_layout(_x(shape, 4, cuda).to(BF16), vl, m))
    assert t.data_ptr() % 4 == 2
    for depth in (1, 3):
        out = _offset_by_one(torch.zeros_like(t))
        for edge in ("periodic", "ring", "open"):
            if edge == "periodic":
                got = sk.stencil_nd_sweep_ttile(spec, t, depth, 1, 1, out=out)
                want = sk.stencil_nd_sweep_ttile_ref(spec, t, depth, 1, 1)
            else:
                got = sk.stencil_nd_multistep(spec, t, depth, 1, edge == "ring", out=out)
                want = sk.stencil_nd_multistep_ref(spec, t, depth, 1, edge == "ring")
            torch.cuda.synchronize()
            assert torch.equal(got, want), (depth, edge)


@pytest.mark.parametrize("name,shape", [("1d3p", (1 << 15,)), ("1d5p", (4096,)),
                                        ("heat1d", (4096,)), ("2d5p", (64, 1024)),
                                        ("2d9p", (32, 512)), ("heat2d", (64, 1024)),
                                        ("3d7p", (16, 16, 256)), ("3d27p", (8, 8, 256))])
def test_bf16_main_path_matches_plain(cuda, name, shape):
    """``StencilProblem(..., dtype=bfloat16).run`` resident (k=2, ttile=2,
    fused and native) and roundtrip, and ``ops.stencil_run``: the kernels
    each run implies, bit for bit the same run on the CPU's plain
    versions."""
    prob = StencilProblem(name, shape, dtype=BF16)
    cpu = StencilProblem(name, shape, dtype=BF16, device="cpu")
    x = prob.init(2)
    assert x.dtype == BF16
    for sweep, ttile, remainder in (("resident", 2, "fused"), ("resident", 2, "native"),
                                    ("roundtrip", 1, "fused")):
        plan = StencilPlan(backend="pallas", sweep=sweep, k=2, ttile=ttile, remainder=remainder)
        sk.reset_launches()
        got = prob.run(x, 7, plan)
        torch.cuda.synchronize()
        assert sk.LAUNCHES["transpose"] >= 2
        assert sum(sk.LAUNCHES.values()) > sk.LAUNCHES["transpose"]
        assert got.dtype == BF16 and torch.equal(got.cpu(), cpu.run(x.cpu(), 7, plan)), sweep
    got = ops.stencil_run(prob.spec, x, 6, k=2)
    assert torch.equal(got.cpu(), ops.stencil_run(prob.spec, x.cpu(), 6, k=2))


@pytest.mark.parametrize("vl,m", [(5, 11), (1, 1)])
def test_transpose_past_2_31_threads(cuda, vl, m):
    """K2 past 2^31 elements (about 4 GiB a side in bfloat16):
    transpose_any's wide instance (vl=5, m=11: 2^31 sub-columns of 1) and
    transpose_small (vl=1, m=1: warp spans at 64-bit offsets), both
    directions bit for bit, one launch each."""
    numel = -(-((1 << 31) + 1) // (vl * m)) * vl * m
    assert numel // sk.transpose_sub(m)[0] >= sk.TRANSPOSE_MAX_SUB
    x = torch.empty(numel, dtype=torch.int16, device=cuda).random_(-(1 << 15), (1 << 15) - 1)
    x = x.view(BF16)
    sk.reset_launches()
    t = sk.block_transpose(x, vl, m)
    torch.cuda.synchronize()
    assert _same_bits(t, sk.block_transpose_ref(x, vl, m))
    back = sk.block_untranspose(t, vl, m)
    torch.cuda.synchronize()
    assert sk.LAUNCHES == dict.fromkeys(sk.LAUNCHES, 0) | {"transpose": 2}
    assert _same_bits(back, x)
    del x, t, back
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# The jnp backend (the paper's schemes, multistep_fused, tessellation,
# plan="default") and the mxu engine on CUDA tensors
# ---------------------------------------------------------------------------

JNP_PLANS = [StencilPlan(scheme=s, k=1, vl=8, m=4) for s in
             ("multiload", "reorg", "fused", "dlt", "transpose")] + [
    StencilPlan(scheme="transpose", k=2), StencilPlan(scheme="transpose", k=3, remainder="native"),
    StencilPlan(scheme="transpose", tiling="tessellate", height=2, vl=8),
    StencilPlan(scheme="dlt", tiling="tessellate", height=4, vl=8, remainder="native"),
    StencilPlan(scheme="fused", tiling="tessellate", height=3), "default"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name,shape", [("1d3p", (1 << 14,)), ("1d5p", (4096,)),
                                        ("2d5p", (64, 512)), ("2d9p", (48, 256)),
                                        ("3d7p", (16, 16, 128)), ("3d27p", (8, 16, 64))])
def test_jnp_plans_bitwise_resident(cuda, name, shape, dtype):
    """Every jnp plan and ``plan="default"`` on a CUDA tensor equals the
    resident pallas run (the CUDA kernels) bit for bit, and launches no
    kernel."""
    prob = StencilProblem(name, shape, dtype=dtype)
    x = prob.init(4)
    want = prob.run(x, 7, StencilPlan(backend="pallas", k=2, ttile=2))
    for plan in JNP_PLANS:
        sk.reset_launches()
        got = prob.run(x, 7, plan)
        torch.cuda.synchronize()
        assert sk.LAUNCHES == dict.fromkeys(sk.LAUNCHES, 0), plan
        assert got.dtype == dtype and torch.equal(got, want), plan


MXU_SHAPES = {1: (128,), 2: (8, 64), 3: (4, 4, 64)}      # the reference's conformance sizes


@pytest.fixture(params=["ieee", "reduced"])
def matmul_flags(request):
    """The process-wide cuBLAS flags set to IEEE, or the wrong way (TF32 on,
    bf16 reduced-precision reductions on); restored after the test."""
    mm = torch.backends.cuda.matmul
    tf32, bf16 = mm.allow_tf32, mm.allow_bf16_reduced_precision_reduction
    mm.allow_tf32 = request.param == "reduced"
    mm.allow_bf16_reduced_precision_reduction = request.param == "reduced"
    yield request.param
    assert mm.allow_tf32 == (request.param == "reduced")       # untouched by the engine
    mm.allow_tf32, mm.allow_bf16_reduced_precision_reduction = tf32, bf16


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-6), (torch.bfloat16, 4e-2)])
@pytest.mark.parametrize("name", ["1d3p", "2d5p", "3d7p"])
def test_mxu_one_step_matches_f64_oracle(cuda, matmul_flags, name, dtype, tol):
    """The conformance matrix's one-step cell (vl=8, m=4, k=1) within the
    reference's tolerance of the f64 oracle, whatever the flags say; one
    product between two K2 launches."""
    spec = stencils.make(name)
    x = _x(MXU_SHAPES[spec.ndim], 0, cuda).to(dtype)
    sk.reset_launches()
    got = ops.stencil_sweep_mxu(spec, x, 1, k=1, vl=8, m=4)
    torch.cuda.synchronize()
    assert sk.LAUNCHES == dict.fromkeys(sk.LAUNCHES, 0) | {"transpose": 2, "mxu": 1}
    want = stencils.apply_steps(spec, x.double(), 1)
    assert got.dtype == dtype
    np.testing.assert_allclose(got.double().cpu().numpy(), want.cpu().numpy(), rtol=tol, atol=tol)


@pytest.mark.parametrize("remainder", ["fused", "native"])
@pytest.mark.parametrize("steps,k,ttile", [(4, 2, 1), (5, 2, 1), (3, 4, 1), (9, 2, 2)])
@pytest.mark.parametrize("name", ["1d3p", "2d5p", "3d7p"])
def test_mxu_multistep_matches_f64_oracle(cuda, matmul_flags, name, steps, k, ttile, remainder):
    """The conformance matrix's multistep cells (and a temporal tile):
    within 1e-4 of the f64 oracle in float32, one product a schedule
    launch."""
    spec = stencils.make(name)
    x = _x(MXU_SHAPES[spec.ndim], 1, cuda)
    prob = StencilProblem(name, x.shape)
    plan = StencilPlan(backend="mxu", k=k, vl=8, m=4, ttile=ttile, remainder=remainder)
    sk.reset_launches()
    got = prob.run(x, steps, plan)
    torch.cuda.synchronize()
    launches = sum(n for _, n in sweep_schedule(k, steps, remainder, ttile)[0])
    assert sk.LAUNCHES == dict.fromkeys(sk.LAUNCHES, 0) | {"transpose": 2, "mxu": launches}
    want = stencils.apply_steps(spec, x.double(), steps)
    np.testing.assert_allclose(got.double().cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-4, atol=1e-4)


def test_mxu_table_uploaded_once(cuda):
    from repro_torch.core import matrixize
    spec = stencils.make("2d5p")
    x = _x((64, 512), 2, cuda)
    ops.stencil_sweep_mxu(spec, x, 6, k=2, vl=8, m=8)
    op = matrixize.operator(spec, 8, 8, 2)
    tab = op.table_tensor(torch.float32, cuda)
    ops.stencil_sweep_mxu(spec, x, 6, k=2, vl=8, m=8)
    assert op.table_tensor(torch.float32, cuda) is tab and tab.device.type == "cuda"


# ---------------------------------------------------------------------------
# plan="auto": the autotuner times the kernels on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,shape", [("1d3p", (1 << 16,)), ("2d5p", (256, 256)),
                                        ("3d7p", (32, 32, 64))])
def test_auto_tunes_on_the_card_and_runs_its_plan(cuda, tmp_path, monkeypatch, name, shape):
    """``run(x, steps)`` with the default plan tunes on the card, caches the
    winner under torch's device name, times a pallas and an mxu candidate
    with none failing, and is bit for bit the explicit run of the cached
    plan; a second run measures nothing."""
    import json

    from repro_torch.core import autotune
    cache = str(tmp_path / "plans.json")
    monkeypatch.setenv(autotune.CACHE_ENV, cache)
    monkeypatch.setattr(autotune, "_caches", {})
    prob = StencilProblem(name, shape)
    x = prob.init(1)
    y = prob.run(x, 16)
    (key, rec), = json.load(open(cache))["entries"].items()
    kind = torch.cuda.get_device_name(cuda).lower().replace(" ", "_")
    assert autotune.device_kind(cuda) == kind
    assert f"|{kind}x{torch.cuda.device_count()}|s*|" in key
    assert rec["failed"] == []
    assert {"jnp", "pallas", "mxu"} <= {m["plan"]["backend"] for m in rec["measurements"]}
    plan = autotune.plan_from_dict(rec["plan"])
    assert torch.equal(y, prob.run(x, 16, plan))
    monkeypatch.setattr(autotune, "_default_timer", lambda *a, **k: pytest.fail("measured"))
    assert torch.equal(prob.run(x, 16), y)


# ---------------------------------------------------------------------------
# reach r = 2..4 on the 2-D warp and 3-D streaming kernels: every instance
# (M, r) in float32 and bfloat16 at each end, the sweeps that raised for
# want of a shared-memory tile, and the halo wrapper
# ---------------------------------------------------------------------------

# (r, vl, m): each instance M of each reach (M = 8 at m = 8 and 16, 4 at
# m = 4, 2 at m = 2 and 6, 1 at m = 3 and 5: r > M on sub-columns), vl = 32
# and others
REACH_TILES = [(2, 32, 8), (2, 8, 4), (2, 16, 2), (2, 8, 3), (2, 8, 16),
               (3, 32, 8), (3, 8, 4), (3, 4, 6), (3, 8, 3),
               (4, 32, 8), (4, 8, 4), (4, 8, 6), (4, 3, 5)]


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
@pytest.mark.parametrize("edge", ["periodic", "ring", "open"])
@pytest.mark.parametrize("r,vl,m", REACH_TILES)
def test_sweep2d_warp_reach_bitwise(cuda, r, vl, m, edge, dtype):
    """The star of reach r on the 2-D warp kernel: every depth of its
    instance (M, r), at the wrapper's segment and at 4 rows, one counted
    launch each, bit for bit the plain versions."""
    _sweep2d_bitwise(cuda, f"star2d-r{r}", m, vl, edge, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
@pytest.mark.parametrize("r,vl,m", REACH_TILES)
def test_sweep3d_reach_bitwise(cuda, r, vl, m, dtype):
    """The star of reach r on the 3-D streaming kernel (run-time taps from
    shared memory): every depth of its instance (M, r), periodic, ring and
    open, at the wrapper's segment and at 3 planes, bit for bit."""
    _sweep3d_bitwise(cuda, f"star3d-r{r}", m, vl, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
@pytest.mark.parametrize("edge", ["periodic", "ring", "open"])
@pytest.mark.parametrize("ndim,r,shape,vl,m,depth", [
    (3, 2, (19, 20, 512), 8, 8, 8),      # raised before: no shared-memory tile
    (3, 3, (13, 20, 512), 8, 8, 4),      # likewise
    (3, 4, (13, 20, 512), 8, 8, 4),      # likewise
    (3, 2, (16, 24, 1024), 32, 8, 16),
    (2, 2, (37, 2048), 8, 8, 16),
    (2, 4, (41, 1280), 8, 5, 9),         # r > M = 1 past its deepest
])
def test_reach_deep_bitwise(cuda, ndim, r, shape, vl, m, depth, edge, dtype):
    """Sweeps of reach r deeper than their instance's deepest, as the
    counted launches of ``sweep2d_launches`` / ``sweep3d_launches``, bit
    for bit one plain deep sweep."""
    _deep_check(cuda, _star(ndim, r), shape, vl, m, depth, edge, dtype=dtype)


@pytest.mark.parametrize("ndim,shape", [(2, (64, 4096)), (3, (16, 8, 512))])
def test_sweep_halo_reach2(cuda, ndim, shape):
    """``stencil_nd_sweep_halo`` at r = 2 (open ends, halo >= k·r in whole
    t0-row tiles) on the register kernels: their counted launches, bit for
    bit the open multistep's plain version."""
    spec, k, t0 = _star(ndim, 2), 2, 4
    t = layouts.to_transpose_layout(_x(shape, 17, cuda), 8, 8)
    key = f"multistep_{ndim}d"
    launches = len((sk.sweep2d_launches if ndim == 2 else sk.sweep3d_launches)(8, k, 2))
    sk.reset_launches()
    got = sk.stencil_nd_sweep_halo(spec, t, k, t0, 4)
    torch.cuda.synchronize()
    assert sk.LAUNCHES == dict.fromkeys(sk.LAUNCHES, 0) | {key: launches}
    assert torch.equal(got, sk.stencil_nd_multistep_ref(spec, t, k, t0, False))
    with pytest.raises(ValueError, match="halo"):
        sk.stencil_nd_sweep_halo(spec, t, k, t0, 2)


# ---------------------------------------------------------------------------
# the far-reach kernel (csrc/sweep_far.cu) and K5's forms that read their
# taps from device memory
# ---------------------------------------------------------------------------

def _box(ndim, r):
    return stencils.StencilSpec(f"box{ndim}d-r{r}", ndim, r, "box", stencils._box_taps(ndim, r))


def _taps20():
    """A 1-D stencil of 20 taps (offsets -10..-1, 1..10), reach 10."""
    return stencils.StencilSpec("ring20", 1, 10, "star", tuple(
        ((o,), 1.0 / (20 + abs(o))) for o in range(-10, 11) if o))


def _t0(n0, r):
    """An axis-0 tile the wrappers accept (it divides n0 and reaches r; the
    kernels ignore it)."""
    return min(d for d in range(r, n0 + 1) if n0 % d == 0)


def _far_check(cuda, spec, shape, vl, m, depth, edge, dtype):
    """One sweep on the far-reach route, its launches counted, bit for bit
    its plain version."""
    nd, ntaps = spec.ndim, len(spec.taps)
    route = (sk.sweep1d_route, sk.sweep2d_route, sk.sweep3d_route)[nd - 1](
        vl, m, depth, spec.r, ntaps)
    assert route == "far"
    t = layouts.to_transpose_layout(_x(shape, depth + ntaps, cuda).to(dtype), vl, m)
    t0 = _t0(shape[0], spec.r)
    launches = len(sk.far_launches(nd, m, depth, spec.r, ntaps, t.element_size()))
    sk.reset_launches()
    if edge == "periodic":
        got = sk.stencil1d_sweep_ttile(spec, t, depth, 1) if nd == 1 else \
            sk.stencil_nd_sweep_ttile(spec, t, depth, 1, t0)
        key = "sweep_far"
    else:
        got = sk.stencil1d_multistep(spec, t, depth, edge == "ring") if nd == 1 else \
            sk.stencil_nd_multistep(spec, t, depth, t0, edge == "ring")
        key = "multistep_far"
    torch.cuda.synchronize()
    assert sk.LAUNCHES == dict.fromkeys(sk.LAUNCHES, 0) | {key: launches}
    if edge == "periodic":
        want = sk.stencil1d_sweep_ttile_ref(spec, t, depth, 1) if nd == 1 else \
            sk.stencil_nd_sweep_ttile_ref(spec, t, depth, 1, t0)
    else:
        want = sk._multistep_ref(spec, t, depth, edge == "ring")
    assert torch.equal(got, want), (got.float() - want.float()).abs().max().item()


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
@pytest.mark.parametrize("edge", ["periodic", "ring", "open"])
@pytest.mark.parametrize("spec,shape,vl,m,depth", [
    (_star(1, 5), (1 << 16,), 8, 8, 4),
    (_star(1, 8), (3 * 8 * 8 * 50,), 8, 8, 11),         # 8 + 3
    (_star(1, 5), (5 * 32 * 7,), 32, 5, 1),              # odd m, m = r
    (_star(2, 5), (96, 2048), 8, 8, 2),
    (_star(2, 6), (70, 1088), 8, 8, 5),                  # five launches, no divisible tiles
    (_star(2, 5), (40, 768), 32, 6, 1),
    (_star(3, 5), (24, 40, 256), 8, 8, 1),
    (_star(3, 6), (19, 23, 192), 8, 8, 3),               # 1 + 1 + 1
    (_star(3, 8), (20, 17, 128), 16, 8, 2),
    (_box(3, 2), (12, 20, 256), 8, 8, 2),                # 125 taps
    (_box(2, 5), (40, 1024), 8, 8, 2),                   # 121 taps
    (_box(2, 4), (40, 1024), 32, 8, 3),                  # 81 taps at reach 4
    (_taps20(), (16 * 8 * 40,), 8, 16, 3),               # 20 taps at 1-D
])
def test_far_kernel_bitwise(cuda, spec, shape, vl, m, depth, edge, dtype):
    """Every instance of the far-reach kernel (float32 and bfloat16 by the
    three ends) at every rank: reach 5-8, 81-125 taps, chains past its
    deepest launch, tiles and segments that do not divide the grid."""
    _far_check(cuda, spec, shape, vl, m, depth, edge, dtype)


@pytest.mark.parametrize("nd", [1, 2, 3])
def test_far_kernel_depth0_copies(cuda, nd):
    spec = _star(nd, 5)
    shape = {1: (4096,), 2: (32, 512), 3: (12, 10, 128)}[nd]
    t = layouts.to_transpose_layout(_x(shape, 2, cuda), 8, 8)
    got = sk.stencil1d_sweep_ttile(spec, t, 0, 1) if nd == 1 else \
        sk.stencil_nd_sweep_ttile(spec, t, 0, 1, _t0(shape[0], 5))
    assert torch.equal(got, t)


def test_far_smem_matches_the_kernel(cuda):
    """The wrapper's shared-memory formula (``far_smem``) is the kernel's
    ``layout``."""
    lib = build.load("sweep_far")
    for args in ((8, 0, 0, 5, 8, 1, 512, 528, 11, 4), (8, 5, 0, 5, 1, 1, 128, 130, 21, 4),
                 (8, 5, 5, 5, 1, 16, 4, 7, 31, 4), (8, 2, 2, 2, 1, 16, 8, 11, 125, 2),
                 (16, 8, 8, 8, 1, 3, 5, 9, 49, 4), (8, 5, 0, 5, 0, 1, 64, 64, 21, 2)):
        assert lib.repro_sweep_far_smem(*args) == sk.far_smem(*args), args


@pytest.mark.parametrize("r", [5, 6, 8])
@pytest.mark.parametrize("nd", [1, 2, 3])
def test_far_c3_shapes_at_size(cuda, nd, r):
    """The shapes that raised before the far-reach kernel: stars of reach
    5, 6 and 8 at every depth 1-16 on chip_smoke.py's grids (2^26, 8192²,
    512³, vl=8, m=8), periodic, ring and open, each bit for bit the plain
    version (built a step at a time beside the kernel's sweeps)."""
    spec = _star(nd, r)
    shape = {1: (1 << 26,), 2: (8192, 8192), 3: (512, 512, 512)}[nd]
    t = layouts.to_transpose_layout(_x(shape, r, cuda), 8, 8)
    t0 = _t0(shape[0], r)
    for edge in ("periodic", "ring", "open"):
        want = t
        for depth in range(1, 17):
            if edge == "periodic":
                want = sk.stencil1d_sweep_ttile_ref(spec, want, 1, 1) if nd == 1 else \
                    sk.stencil_nd_sweep_ttile_ref(spec, want, 1, 1, t0)
                got = sk.stencil1d_sweep_ttile(spec, t, depth, 1) if nd == 1 else \
                    sk.stencil_nd_sweep_ttile(spec, t, depth, 1, t0)
            else:
                want = sk._multistep_ref(spec, want, 1, edge == "ring")
                got = sk.stencil1d_multistep(spec, t, depth, edge == "ring") if nd == 1 else \
                    sk.stencil_nd_multistep(spec, t, depth, t0, edge == "ring")
            assert torch.equal(got, want), (edge, depth)
            del got
        del want
    torch.cuda.empty_cache()


def test_onestep_forms_match_the_kernels(cuda):
    lib = build.load("onestep")
    assert (lib.repro_onestep_max_taps(), lib.repro_onestep_max_reach(),
            lib.repro_onestep_naive_max_reach(), lib.repro_onestep_lane_taps()) == \
        (sk.ONESTEP_MAX_TAPS, sk.ONESTEP_REACH, sk.ONESTEP_NAIVE_REACH, sk.ONESTEP_LANE_TAPS)


def _k5_offsets(name, *offs):
    return stencils.StencilSpec(name, 1, max(abs(o) for o in offs), "star",
                                tuple(((o,), 1.0 / (len(offs) + i)) for i, o in enumerate(offs)))


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
@pytest.mark.parametrize("spec,forms", [
    (_star(1, 6), ("reg", "reg")), (_taps20(), ("reg", "reg")), (_star(1, 16), ("reg", "reg")),
    (_star(1, 17), ("lane", "lane")), (_k5_offsets("r20-3taps", -20, 0, 20), ("lane", "lane")),
    (_k5_offsets("ends32", 32, 0, -31, 17), ("lane", "lane")),
    (_k5_offsets("all64", *range(-32, 32)), ("lane", "lane")),
    (_k5_offsets("r5-3taps", -5, 0, 5), ("lane", "reg")),
    (_k5_offsets("r5-7taps", -5, -2, -1, 0, 1, 2, 5), ("lane", "reg")),
    (_k5_offsets("r16-3taps", 0, 16, 9), ("lane", "lane")),
    (stencils.StencilSpec("far40", 1, 40, "star", (((0,), 0.5), ((-40,), 0.25), ((33,), 0.25))),
     ("mem", "mem"))])
def test_onestep_mem_forms_bitwise(cuda, spec, forms, dtype):
    """K5 at reach 6, 20 taps and reach 16 (33 taps), which the register
    windows take, K5a's lane form at reach 17 to 32 (K5b there on its
    memory form), at 3 and 7 taps of reach 5 (float32; bfloat16 and K5b on
    the windows) and at 3 of reach 16, and past it (offsets past 32: the
    forms that read their taps from device memory), each bit for bit its
    plain version at every m.  ``forms``: K5a's form in float32 and in
    bfloat16."""
    assert sk.onestep_form("naive", spec, dtype) == forms[dtype == BF16]
    assert sk.onestep_form("transpose", spec, dtype) == ("reg" if spec.r <= 16 else "mem")
    for n, vl in ((1 << 20, 32), (96 * 41, 41), (40, 8)):
        x = _x((n,), 5, cuda).to(dtype)
        sk.reset_launches()
        got = sk.stencil1d_naive_onestep(spec, x, vl)
        torch.cuda.synchronize()
        assert sk.LAUNCHES["onestep_naive"] == 1
        assert torch.equal(got, sk.stencil1d_naive_onestep_ref(spec, x, vl))
    for vl, m, nb in ((32, 8, 4096), (8, 16, 5), (4, 32, 3), (3, 40, 7)):
        if spec.r > m:
            continue
        t = layouts.to_transpose_layout(_x((nb * vl * m,), 6, cuda).to(dtype), vl, m)
        sk.reset_launches()
        got = sk.stencil1d_transpose_onestep(spec, t)
        torch.cuda.synchronize()
        assert sk.LAUNCHES["onestep_transpose"] == 1
        assert torch.equal(got, sk.stencil1d_transpose_onestep_ref(spec, t))


# ---------------------------------------------------------------------------
# a batch of grids as a launch dimension of every sweep kernel
# ---------------------------------------------------------------------------

# (spec, one grid's shape, m, depth): K1 / K4a on the 1-D warp kernel (r =
# 1 and r > M), K3 / K4b on the 2-D warp kernel (star, box, deep) and on the
# 3-D streaming kernel (star and box order), the far-reach kernel at each rank
BATCH_CASES = [
    (stencils.make("1d3p"), (4096,), 8, 4),
    (stencils.make("1d5p"), (3 * 32 * 40,), 3, 2),
    (stencils.make("2d5p"), (40, 512), 8, 4),
    (stencils.make("2d9p"), (33, 256), 2, 8),
    (stencils.make("3d7p"), (20, 9, 256), 8, 4),
    (stencils.make("3d27p"), (12, 10, 256), 4, 2),
    (_star(1, 5), (8192,), 8, 4),
    (_star(2, 5), (40, 512), 8, 2),
    (_star(3, 5), (12, 10, 256), 8, 1),
]


def _batch_sweep(spec, t, depth, edge, t0):
    if edge == "periodic":
        return sk.stencil1d_sweep_ttile(spec, t, depth, 1) if spec.ndim == 1 else \
            sk.stencil_nd_sweep_ttile(spec, t, depth, 1, t0)
    return sk.stencil1d_multistep(spec, t, depth, edge == "ring") if spec.ndim == 1 else \
        sk.stencil_nd_multistep(spec, t, depth, t0, edge == "ring")


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
@pytest.mark.parametrize("edge", ["periodic", "ring", "open"])
@pytest.mark.parametrize("vl", [32, 8])
@pytest.mark.parametrize("spec,shape,m,depth", BATCH_CASES,
                         ids=[f"{c[0].name}-m{c[2]}-d{c[3]}" for c in BATCH_CASES])
def test_batched_sweep_bitwise_single_launches(cuda, spec, shape, m, depth, vl, edge, dtype):
    """B = 3 grids in one launch (a grid dimension of the kernel): bit for
    bit three launches of one grid each, and the plain version; counted
    once per launch, not once per grid."""
    xb = _x((3,) + shape, 17, cuda).to(dtype)
    t = sk.block_transpose(xb, vl, m)
    t0 = _t0(shape[0], spec.r) if spec.ndim > 1 else None
    key, plan = sk.sweep_plan(spec, vl, m, depth, t.element_size())
    counter = f"{'sweep' if edge == 'periodic' else 'multistep'}_{key}"
    sk.reset_launches()
    got = _batch_sweep(spec, t, depth, edge, t0)
    torch.cuda.synchronize()
    assert sk.LAUNCHES == dict.fromkeys(sk.LAUNCHES, 0) | {counter: len(plan)}
    for i in range(3):
        single = _batch_sweep(spec, t[i].contiguous(), depth, edge, t0)
        assert torch.equal(got[i], single), (i, (got[i].float() - single.float()).abs().max())
    want = sk.stencil1d_sweep_ttile_ref(spec, t, depth, 1) if edge == "periodic" and \
        spec.ndim == 1 else sk.stencil_nd_sweep_ttile_ref(spec, t, depth, 1, t0) \
        if edge == "periodic" else sk._multistep_ref(spec, t, depth, edge == "ring")
    assert torch.equal(got, want)


@pytest.mark.parametrize("spec,shape,m,depth", [c for c in BATCH_CASES if c[0].ndim > 1],
                         ids=[f"{c[0].name}" for c in BATCH_CASES if c[0].ndim > 1])
def test_batched_segments_do_not_change_results(cuda, spec, shape, m, depth):
    """The axis-0 segment of a batched launch (sized for one grid, for the
    batch, or one CTA a grid) never changes a result."""
    t = sk.block_transpose(_x((4,) + shape, 5, cuda), 8, m)
    key = sk.sweep_plan(spec, 8, m, depth)[0]
    launch = {"2d": sk._warp2d_launch, "3d": sk._sweep3d_launch, "far": sk._far_launch}[key]
    d = sk.sweep_plan(spec, 8, m, depth)[1][0][2]
    outs = []
    for seg in (1 if key == "far" else sk.WARP2D_SEG_MIN if key == "2d" else sk.SWEEP3D_SEG_MIN,
                shape[0], None):
        out = torch.empty_like(t)
        launch(spec, t, out, d, "periodic", seg)
        outs.append(out)
    torch.cuda.synchronize()
    assert all(torch.equal(o, outs[-1]) for o in outs)


@pytest.mark.parametrize("spec,shape,t0,dtype,n", [
    (stencils.make("1d3p"), (1 << 26,), None, torch.float32, 17),
    (stencils.make("3d7p"), (256, 512, 512), 16, torch.float32, 17),
    (stencils.make("1d3p"), (1 << 27,), None, BF16, 33),
    (stencils.make("2d5p"), (8192, 16384), 32, BF16, 33),
    (stencils.make("3d7p"), (256, 512, 1024), 16, BF16, 33),
    (_star(1, 5), (1 << 27,), None, BF16, 33),
], ids=lambda v: getattr(v, "name", None))
def test_batched_offsets_past_2_32_bytes(cuda, spec, shape, t0, dtype, n):
    """n grids of 256 MiB: the last grid starts past 2^32 bytes, and (in
    bfloat16, 33 grids of 2^27 elements) at element 2^32, where an offset
    in 32-bit elements, signed or unsigned, would wrap.  K2 reads the n
    grids where they lie (a table of parts) and the sweep kernel takes
    them as one batch: the last grid's layout and sweep equal its own K2
    and its own launch."""
    xs = [torch.randn(shape, device=cuda).to(dtype) for _ in range(n)]
    t = sk.block_transpose_parts(xs, 32, 8)
    last = (t[n - 1].data_ptr() - t.data_ptr()) // t.element_size()
    assert last * t.element_size() >= 1 << 32
    assert dtype == torch.float32 or last >= 1 << 32
    assert torch.equal(t[n - 1], sk.block_transpose(xs[n - 1], 32, 8))
    got = _batch_sweep(spec, t, 2, "periodic", t0)
    for i in (0, n - 1):
        assert torch.equal(got[i], _batch_sweep(spec, t[i].contiguous(), 2, "periodic", t0))


@pytest.mark.parametrize("dtype", [torch.float32, BF16, torch.float64])
@pytest.mark.parametrize("vl,m", [(32, 8), (8, 16), (4, 3), (24, 8), (8, 12), (2, 8), (1, 5)])
@pytest.mark.parametrize("nparts", [1, 3, sk.TRANSPOSE_MAX_PARTS + 2])
def test_transpose_parts_bitwise(cuda, vl, m, dtype, nparts):
    """K2 into the layout from B grids where they lie, on every form
    (transpose_reg, transpose_any, transpose_small): bit for bit K2 of
    their stack; one launch a ``TRANSPOSE_MAX_PARTS`` grids.  Every third
    grid is a view one element off its buffer's start (the natural side
    then moves element by element)."""
    n = 6 * 24 * 16 * vl * m // math.gcd(vl * m, 6 * 24 * 16)
    base = [_bits((n + 1,), dtype, 40 + i, cuda) for i in range(nparts)]
    xs = [b[1:] if i % 3 == 2 else b[:n] for i, b in enumerate(base)]
    sk.reset_launches()
    got = sk.block_transpose_parts(xs, vl, m)
    torch.cuda.synchronize()
    assert sk.LAUNCHES["transpose"] == -(-nparts // sk.TRANSPOSE_MAX_PARTS)
    assert _same_bits(got, sk.block_transpose(torch.stack(xs), vl, m))


def test_transpose_parts_refuses_mixed_grids(cuda):
    x = torch.zeros(256, device=cuda)
    for other in (torch.zeros(512, device=cuda), torch.zeros(256, device=cuda, dtype=BF16),
                  torch.zeros(256)):
        with pytest.raises(ValueError, match="differ"):
            sk.block_transpose_parts([x, other], 8, 4)


def test_batch_limit_raises_naming_it(cuda):
    spec = stencils.make("1d3p")
    t = torch.empty((sk.MAX_BATCH + 1, 1, 1, 32), device=cuda)
    with pytest.raises(ValueError, match=str(sk.MAX_BATCH)):
        sk.stencil1d_sweep_ttile(spec, t, 1, 1)


@pytest.mark.parametrize("plan", [
    StencilPlan(backend="pallas", sweep="resident", k=2, ttile=2),
    StencilPlan(backend="pallas", sweep="resident", k=2, vl=8, m=8, remainder="native"),
    StencilPlan(backend="pallas", sweep="roundtrip", k=2, vl=8, m=8),
    StencilPlan(backend="mxu", k=2, vl=8, m=8),
    StencilPlan(scheme="transpose", k=2, vl=8, m=8),
    StencilPlan(scheme="fused", k=1),
], ids=lambda p: f"{p.backend}-{p.sweep}-{p.scheme}-{p.remainder}")
@pytest.mark.parametrize("name,shape", [("1d3p", (1 << 14,)), ("2d5p", (64, 512)),
                                        ("3d7p", (16, 16, 256))])
def test_run_batched_on_the_card(cuda, name, shape, plan):
    """``run_batched`` of 4 grids: K2 twice and each sweep once for the
    whole batch; each grid bit for bit its own ``run`` (mxu: 2e-6)."""
    prob = StencilProblem(name, shape)
    xb = _x((4,) + shape, 23, cuda)
    sk.reset_launches()
    yb = prob.run_batched(xb, 7, plan)
    torch.cuda.synchronize()
    batched = dict(sk.LAUNCHES)
    sk.reset_launches()
    singles = [prob.run(xb[i], 7, plan) for i in range(4)]
    torch.cuda.synchronize()
    assert {k: 4 * v for k, v in batched.items()} == sk.LAUNCHES
    if plan.backend == "pallas":
        assert batched["transpose"] == 2 * (1 if plan.sweep == "resident" else 4)
    for y, s in zip(yb, singles):
        if plan.backend == "mxu":
            torch.testing.assert_close(y, s, rtol=2e-6, atol=2e-6)
        else:
            assert torch.equal(y, s)
