"""K2's register kernel (``csrc/transpose.cu``: ``transpose_reg``,
``transpose_any`` with its wide instance, and ``transpose_small``)
transcribed into numpy and held bit for bit against the plain versions
``block_transpose_ref`` / ``block_untranspose_ref``, and the route that
names it.

The CPU has no CUDA compiler, so this transcription checks the kernel's
address map: CTAs of ``kRegThreads`` threads, one sub-column of M
elements per thread (M the largest of 1..8 dividing m, G = m / M
sub-columns to a column: G = 1 at m <= 8), the guard on the last CTA, the
natural side moved in chunks of ``chunk_elems`` elements (each chunk
aligned to its own size), and the layout side's row addresses
``((g / vl) * G + h) * M + s) * vl + g % vl`` (sub-column h of column g):
in ``transpose_reg`` (vl a power of two, m in 1..8, 16, 32) by shifts and
masks, ``(((g >> lv) * G + h) * M + s) << lv | g & mask``; in
``transpose_any`` (every other vl >= 4 and m) by one division by G and one
by vl, past 2^31 sub-columns in super-chunks of whole blocks.  At vl < 4
``transpose_small`` gives a warp a span of whole blocks instead: lane l
stores output elements l, l + 32, ... of it, each loaded from its place
in the same block.  Every instance (vl from 1, powers of two and not, m =
1..8, 16, 32 and off them, elements of 2, 4 and 8 bytes, both directions,
leading axes) must read each element once and write each once, to the
position the plain version gives.  Inputs are random integer bits, so
"equal" is bit for bit.
One case is also held against the JAX package's Pallas kernel in
interpret mode.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import stencil_kernels as jsk
from repro_torch.kernels import stencil_kernels as sk

REG_THREADS = 256            # csrc/transpose.cu's kRegThreads
SMALL_K = 16                 # and its kSmallK
INTS = {2: np.int16, 4: np.int32, 8: np.int64}


def chunk_elems(itemsize: int, m: int) -> int:
    """csrc/transpose.cu's chunk_elems<T, M>."""
    v = 1
    while m % (2 * v) == 0 and 2 * v * itemsize <= 16:
        v *= 2
    return v


def reg_kernel_np(src: np.ndarray, vl: int, m: int, to_layout: bool, aligned: bool = True,
                  chunk: int | None = None):
    """The kernel on the flat array ``src``: its output and how often each
    element was read and written.  ``chunk``: blocks a super-chunk of
    transpose_any's wide instance (by default the kernel's, which it takes
    past ``TRANSPOSE_MAX_SUB`` sub-columns)."""
    assert sk.transpose_route(vl, m, src.itemsize, src.size) == "reg"
    if vl < sk.TRANSPOSE_MIN_VL:
        return small_kernel_np(src, vl, m, to_layout, aligned, chunk)
    out = np.zeros_like(src)
    reads = np.zeros(src.size, np.int64)
    writes = np.zeros(src.size, np.int64)
    ncols = src.size // m
    assert ncols % vl == 0
    big, sub = sk.transpose_sub(m)              # the instance's M and G
    nsub = ncols * sub
    fixed = vl & (vl - 1) == 0 and m in sk.TRANSPOSE_M
    if fixed or (chunk is None and nsub < sk.TRANSPOSE_MAX_SUB):
        _reg_threads(src, out, reads, writes, vl, m, to_layout, aligned, 0, nsub, fixed)
        return out, reads, writes
    # the wide instance: super-chunk y of `chunk` whole blocks along blockIdx.y
    nblocks = ncols // vl
    chunk = chunk or (sk.TRANSPOSE_MAX_SUB - 1) // (vl * sub)
    for y in range(-(-nblocks // chunk)):
        q0 = y * chunk
        nsub_y = min(nblocks - q0, chunk) * vl * sub
        assert nsub_y < sk.TRANSPOSE_MAX_SUB
        _reg_threads(src, out, reads, writes, vl, m, to_layout, aligned, q0 * vl * m, nsub_y,
                     False)
    return out, reads, writes


def _reg_threads(src, out, reads, writes, vl, m, to_layout, aligned, first, nsub, fixed):
    """``nsub`` threads of transpose_reg (``fixed``) or transpose_any on the
    arrays from element ``first`` on."""
    big, sub = sk.transpose_sub(m)
    kvec = chunk_elems(src.itemsize, big) if aligned else 1
    ctas = -(-nsub // REG_THREADS)
    u = np.arange(ctas * REG_THREADS)           # one thread per sub-column
    u = u[u < nsub]                             # the guard
    natural = first + u * big
    if fixed:                                   # transpose_reg: shifts
        lv, lg = vl.bit_length() - 1, sub.bit_length() - 1
        assert 1 << lg == sub
        g, h = u >> lg, u & (sub - 1)
        row0 = ((((g >> lv) * sub + h) * big) << lv) + (g & (vl - 1))
    else:                                       # transpose_any: 32-bit divisions
        u32 = u.astype(np.uint32)
        g = u32 // np.uint32(sub)
        h = u32 - g * np.uint32(sub)
        q = g // np.uint32(vl)
        rem = g - q * np.uint32(vl)
        row0 = (q.astype(np.int64) * sub + h) * big * vl + rem
    row0 = first + row0
    m = big                                     # elements a thread moves
    v = []
    if to_layout:
        for c in range(m // kvec):
            at = natural + c * kvec
            assert (at % kvec == 0).all()       # a whole, aligned chunk
            for e in range(kvec):
                np.add.at(reads, at + e, 1)
                v.append(src[at + e])
        for s in range(m):
            np.add.at(writes, row0 + s * vl, 1)
            out[row0 + s * vl] = v[s]
    else:
        for s in range(m):
            np.add.at(reads, row0 + s * vl, 1)
            v.append(src[row0 + s * vl])
        for c in range(m // kvec):
            at = natural + c * kvec
            assert (at % kvec == 0).all()
            for e in range(kvec):
                np.add.at(writes, at + e, 1)
                out[at + e] = v[c * kvec + e]


def small_kernel_np(src: np.ndarray, vl: int, m: int, to_layout: bool, aligned: bool = True,
                    chunk: int | None = None):
    """transpose_small (vl < 4) on the flat array ``src``: warp w owns
    ``per_warp`` whole blocks of bs = vl·m elements (``chunk``, by default
    the kernel's: kSmallK·32 / bs, at least 1), and in rounds of
    kSmallK·32 elements lane l stores output elements l + 32·k of the span
    (consecutive lanes, consecutive addresses), each loaded from input
    element b·bs + perm(i) of its block b, (b, i) stepped by (32 // bs, 32
    % bs) with a carry from the lane's first element.  ``aligned`` is
    unused: the kernel moves single elements."""
    out = np.zeros_like(src)
    reads = np.zeros(src.size, np.int64)
    writes = np.zeros(src.size, np.int64)
    bs = vl * m
    assert src.size % bs == 0
    nblocks = src.size // bs
    per_warp = chunk or max(1, SMALL_K * 32 // bs)
    db, di = 32 // bs, 32 % bs
    for q0 in range(0, nblocks, per_warp):
        span = min(nblocks - q0, per_warp) * bs
        base = q0 * bs
        lane = np.arange(32)
        b, i = lane // bs, lane % bs
        for o0 in range(0, span, SMALL_K * 32):
            live, srcs = [], []
            for k in range(SMALL_K):
                o = o0 + k * 32 + lane
                ok = o < span
                if to_layout:                   # layout place s·vl + j <- natural j·m + s
                    s_, j = i // vl, i % vl
                    at = b * bs + j * m + s_
                else:                           # natural place j·m + s <- layout s·vl + j
                    j = (i >= m).astype(int) + ((vl == 3) & (i >= 2 * m)).astype(int)
                    at = b * bs + (i - j * m) * vl + j
                np.add.at(reads, base + at[ok], 1)
                live.append((o[ok], src[base + at[ok]]))
                b, i = b + db, i + di
                carry = i >= bs
                i, b = np.where(carry, i - bs, i), np.where(carry, b + 1, b)
            for o, v in live:                   # each store: consecutive addresses
                assert (np.diff(o) == 1).all()
                np.add.at(writes, base + o, 1)
                out[base + o] = v
    return out, reads, writes


def _bits(shape, itemsize, seed):
    info = np.iinfo(INTS[itemsize])
    return np.random.default_rng(seed).integers(info.min, info.max, shape, dtype=INTS[itemsize],
                                                endpoint=True)


def _check(x: np.ndarray, vl: int, m: int, **kw):
    """Both directions of the transcription on ``x`` (lead..., N)."""
    lead, n = x.shape[:-1], x.shape[-1]
    want = sk.block_transpose_ref(torch.from_numpy(x), vl, m).contiguous().numpy()
    assert want.shape == lead + (n // (vl * m), m, vl)
    got, reads, writes = reg_kernel_np(x.ravel(), vl, m, True, **kw)
    np.testing.assert_array_equal(reads, 1)
    np.testing.assert_array_equal(writes, 1)
    np.testing.assert_array_equal(got.reshape(want.shape), want)
    back, reads, writes = reg_kernel_np(want.ravel(), vl, m, False, **kw)
    np.testing.assert_array_equal(reads, 1)
    np.testing.assert_array_equal(writes, 1)
    plain = sk.block_untranspose_ref(torch.from_numpy(want), vl, m).contiguous().numpy()
    np.testing.assert_array_equal(back.reshape(x.shape), plain)
    np.testing.assert_array_equal(plain, x)


@pytest.mark.parametrize("itemsize", [2, 4, 8])
@pytest.mark.parametrize("m", sorted(sk.TRANSPOSE_M))
@pytest.mark.parametrize("vl", [4, 8, 16, 32, 64, 128])
def test_reg_kernel_address_map(vl, m, itemsize):
    # two leading axes; 15 blocks of vl·m: the last CTA is partial
    x = _bits((3, 1, 5 * vl * m), itemsize, seed=vl * 64 + m * 8 + itemsize)
    _check(x, vl, m)


@pytest.mark.parametrize("itemsize", [2, 4, 8])
@pytest.mark.parametrize("vl", [4, 8, 16, 32, 64, 128])
def test_reg_kernel_unaligned_pointer(vl, itemsize):
    """The element-wise instance a natural-side pointer off its chunk's
    alignment takes (m = 8), over more than one CTA."""
    x = _bits((2, 37 * vl * 8), itemsize, seed=itemsize)
    _check(x, vl, 8, aligned=False)


@pytest.mark.parametrize("itemsize", [2, 4, 8])
@pytest.mark.parametrize("vl,m", [(8, 16), (16, 32), (4, 3), (32, 5), (8, 6), (128, 7)])
def test_reg_kernel_unaligned_pointer_new_m(vl, m, itemsize):
    """The element-wise instances of m = 16, 32 (the tuner's pairs) and
    odd m, over more than one CTA."""
    x = _bits((2, 19 * vl * m), itemsize, seed=itemsize + m)
    _check(x, vl, m, aligned=False)


# transpose_any: vl off the powers of two (and 256, a shift above 128) x
# m off 1..8, 16, 32 (m = G * M: 3 and 5 at G = 1, 9 = 3 * 3, 12 = 2 * 6,
# 24 = 4 * 6 and 25 = 5 * 5, the reference picker's _fit_m, 64 = 8 * 8)
ANY_VLS = (4, 5, 8, 96, 256)
ANY_MS = (3, 5, 9, 12, 24, 25, 64)


@pytest.mark.parametrize("itemsize", [2, 4, 8])
@pytest.mark.parametrize("m", ANY_MS)
@pytest.mark.parametrize("vl", ANY_VLS)
def test_reg_kernel_any_address_map(vl, m, itemsize):
    """Every (vl, m) of the any-vl, any-m map, both directions: 3 blocks
    and a leading axis of 2, the last CTA partial."""
    x = _bits((2, 3 * vl * m), itemsize, seed=vl * 64 + m * 8 + itemsize)
    _check(x, vl, m)


@pytest.mark.parametrize("itemsize", [2, 4, 8])
@pytest.mark.parametrize("vl,m", [(96, 8), (8, 12), (5, 24), (256, 25)])
def test_reg_kernel_any_unaligned_pointer(vl, m, itemsize):
    """The element-wise instances of transpose_any, over more than one
    CTA."""
    x = _bits((2, 7 * vl * m), itemsize, seed=itemsize + m)
    _check(x, vl, m, aligned=False)


@pytest.mark.parametrize("vl,m,nb", [(32, 8, 3), (8, 5, 7), (128, 8, 2), (8, 16, 3),
                                     (16, 32, 2), (96, 8, 2), (8, 12, 3), (8, 25, 5),
                                     (256, 8, 1), (5, 24, 2)])
def test_reg_kernel_matches_pallas(vl, m, nb):
    x = np.random.default_rng(nb).standard_normal(nb * vl * m).astype(np.float32)
    want = np.asarray(jsk.block_transpose(jnp.asarray(x), vl, m, interpret=True))
    got, _, _ = reg_kernel_np(x, vl, m, True)
    np.testing.assert_array_equal(got.reshape(want.shape), want)
    back = np.asarray(jsk.block_untranspose(jnp.asarray(want), vl, m, interpret=True))
    got_back, _, _ = reg_kernel_np(want.ravel(), vl, m, False)
    np.testing.assert_array_equal(got_back, back)


@pytest.mark.parametrize("vl,m,itemsize,route", [
    (32, 8, 4, "reg"),          # the main path: 1d3p / 2d5p / 3d7p at the GPU tile
    (128, 8, 4, "reg"),         # the JAX package's tile
    (4, 1, 2, "reg"),
    (8, 5, 8, "reg"),           # the picker's odd-m tiles off vl = 32
    (16, 3, 4, "reg"),
    (64, 7, 2, "reg"),
    (8, 25, 4, "reg"),          # m > 8 and not 16 or 32: sub-columns of 5
    (32, 16, 4, "reg"),         # m = 16, 32: the tuner's pairs (8, 16), (16, 32)
    (8, 16, 2, "reg"),
    (16, 32, 8, "reg"),
    (8, 12, 4, "reg"),          # sub-columns of 6
    (16, 64, 4, "reg"),         # sub-columns of 8
    (12, 16, 4, "reg"),         # vl not a power of two
    (96, 8, 4, "reg"),
    (256, 8, 4, "reg"),         # the former K2-smem row's tile (vl above 128)
    (3, 5, 4, "reg"),           # vl below 4: transpose_small, no shared memory
    (2, 4, 4, "reg"),
    (1, 8, 8, "reg"),
    (256, 2, 4, "reg"),
    (32, 8, 1, "reg"),          # K2's one route (the wrapper raises on 1-byte elements)
    (32, 0, 4, "reg"),
])
def test_transpose_route(vl, m, itemsize, route):
    assert sk.transpose_route(vl, m, itemsize) == route


@pytest.mark.parametrize("vl,m,numel,route", [
    (96, 8, (1 << 31) * 8 - 8 * 96, "reg"),    # just under 2^31 sub-columns of 8
    (96, 8, (1 << 31) * 8, "reg"),             # transpose_any's wide instance
    (8, 25, (1 << 31) * 5, "reg"),
    (8, 8, 1 << 40, "reg"),                    # transpose_reg's 64-bit index
    (8, 16, 1 << 40, "reg"),
])
def test_transpose_route_sub_column_limit(vl, m, numel, route):
    assert sk.transpose_route(vl, m, 4, numel) == route


@pytest.mark.parametrize("m,split", [(1, (1, 1)), (7, (7, 1)), (8, (8, 1)), (9, (3, 3)),
                                     (12, (6, 2)), (16, (8, 2)), (24, (6, 4)), (25, (5, 5)),
                                     (32, (8, 4)), (64, (8, 8)), (11, (1, 11)), (49, (7, 7)),
                                     (40, (5, 8)), (20, (5, 4)), (48, (6, 8)), (18, (6, 3))])
def test_transpose_sub(m, split):
    assert sk.transpose_sub(m) == split


def test_cpu_wrapper_counts_no_route():
    x = torch.from_numpy(_bits((2, 4 * 32 * 8), 4, seed=3))
    sk.reset_launches()
    t = sk.block_transpose(x, 32, 8)
    back = sk.block_untranspose(t, 32, 8)
    assert sk.LAUNCHES == dict.fromkeys(sk.LAUNCHES, 0)       # CPU: no kernel
    assert torch.equal(back, x)
    assert "transpose" in sk.LAUNCHES and "transpose_smem" not in sk.LAUNCHES


@pytest.mark.parametrize("itemsize", [2, 4, 8])
@pytest.mark.parametrize("m", range(1, 34))
@pytest.mark.parametrize("vl", [1, 2, 3])
def test_small_kernel_address_map(vl, m, itemsize):
    """transpose_small at every m from 1 to 33 (blocks of 1 to 99
    elements: many a warp, and at m = 33, vl = 3 a block past the 32
    lanes), both directions, over a partial last warp and a leading
    axis."""
    x = _bits((2, 131 * vl * m), itemsize, seed=vl * 64 + m * 8 + itemsize)
    _check(x, vl, m)


@pytest.mark.parametrize("vl,m", [(2, 8), (3, 5), (1, 16), (2, 7), (3, 24), (2, 300)])
def test_small_kernel_spans(vl, m):
    """transpose_small with spans of 1, 2 and 5 blocks a warp (one block
    of vl = 2, m = 300 takes two rounds of 512 elements)."""
    x = _bits((2, 23 * vl * m), 4, seed=m)
    for chunk in (1, 2, 5):
        _check(x, vl, m, chunk=chunk)


@pytest.mark.parametrize("vl,m", [(96, 8), (5, 11), (8, 25), (12, 3)])
def test_any_kernel_super_chunks(vl, m):
    """transpose_any's wide instance: super-chunks of whole blocks along
    blockIdx.y, each with its own sub-column count and offset."""
    x = _bits((3, 7 * vl * m), 4, seed=vl + m)
    for chunk in (1, 2, 4):
        _check(x, vl, m, chunk=chunk)
