"""The layout A/B one-step kernels' plain versions (K5) against the JAX
package: ``ops.stencil_onestep_naive`` / ``stencil_onestep_transpose``
(Pallas in interpret mode) and ``ref.onestep_periodic_ref``, for 1d3p and
1d5p as the reference's ``tests/test_kernels.py`` runs them, f32 within
2e-6 (XLA's CPU backend may contract a multiply-add into an FMA).  Within
the port both plain versions equal the periodic oracle bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import stencils as jst
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels import stencil_kernels as jsk
from repro_torch.core import layouts as tlay
from repro_torch.core import stencils as tst
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import stencil_kernels as sk

TOL = dict(rtol=2e-6, atol=2e-6)


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("name", ["1d3p", "1d5p"])
def test_onestep_entry_points_match_reference(name):
    x = _x((8 * 8 * 4,), 6)
    jspec, spec = jst.make(name), tst.make(name)
    oracle = np.asarray(jref.onestep_periodic_ref(jspec, jnp.asarray(x)))
    want_naive = np.asarray(jops.stencil_onestep_naive(jspec, jnp.asarray(x), 8, interpret=True))
    want_tr = np.asarray(jops.stencil_onestep_transpose(jspec, jnp.asarray(x), 8, 8,
                                                        interpret=True))
    sk.reset_launches()
    got_naive = ops.stencil_onestep_naive(spec, torch.from_numpy(x), 8)
    got_tr = ops.stencil_onestep_transpose(spec, torch.from_numpy(x), 8, 8)
    assert sk.LAUNCHES == dict.fromkeys(sk.LAUNCHES, 0)       # CPU: no kernel
    for got, want in ((got_naive, want_naive), (got_tr, want_tr)):
        np.testing.assert_allclose(got.numpy(), want, **TOL)
        np.testing.assert_allclose(got.numpy(), oracle, **TOL)
    periodic = tref.onestep_periodic_ref(spec, torch.from_numpy(x))
    assert torch.equal(got_naive, periodic) and torch.equal(got_tr, periodic)


@pytest.mark.parametrize("name", ["1d3p", "1d5p", "heat1d"])
@pytest.mark.parametrize("vl,m,nb", [(8, 8, 4), (32, 8, 3), (8, 4, 5), (4, 2, 7), (3, 5, 2)])
def test_onestep_plain_versions(name, vl, m, nb):
    spec = tst.make(name)
    x = torch.from_numpy(_x((vl * m * nb,), 7))
    periodic = tref.onestep_periodic_ref(spec, x)
    assert torch.equal(sk.stencil1d_naive_onestep(spec, x, vl), periodic)
    t = tlay.to_transpose_layout(x, vl, m)
    got = sk.stencil1d_transpose_onestep(spec, t)
    assert torch.equal(tlay.from_transpose_layout(got, vl, m), periodic)
    assert torch.equal(ops.stencil_onestep_transpose(spec, x, vl, m), periodic)


def test_onestep_defaults_and_checks():
    spec = tst.make("1d3p")
    x = torch.from_numpy(_x((64,), 8))
    periodic = tref.onestep_periodic_ref(spec, x)
    assert torch.equal(ops.stencil_onestep_naive(spec, x), periodic)          # vl=8
    assert torch.equal(ops.stencil_onestep_transpose(spec, x), periodic)      # m=vl=8
    out = torch.empty_like(x)
    assert sk.stencil1d_naive_onestep(spec, x, 8, out=out).data_ptr() == out.data_ptr()
    with pytest.raises(ValueError, match="multiple of vl"):
        sk.stencil1d_naive_onestep(spec, x, 24)
    with pytest.raises(ValueError, match="1-D"):
        sk.stencil1d_naive_onestep(tst.make("2d5p"), x.reshape(8, 8), 8)
    with pytest.raises(ValueError, match="not a 1-D"):
        sk.stencil1d_transpose_onestep(tst.make("2d5p"), torch.zeros(2, 2, 4, 8))
    with pytest.raises(ValueError, match="radius"):
        sk.stencil1d_transpose_onestep(tst.make("1d5p"), torch.zeros(4, 1, 16))
    with pytest.raises(ValueError, match="no kernel"):
        sk.stencil1d_transpose_onestep(spec, torch.zeros(2, 4, 8, device="meta"))


# ---------------------------------------------------------------------------
# csrc/onestep.cu's register forms, transcribed
# ---------------------------------------------------------------------------
#
# The CPU has no CUDA compiler, so each kernel's index map is transcribed as
# written, a thread a row of numpy index arrays: CTAs of 256 threads, each
# thread's run of E points and its window of R (4, 8 or 16) halo points a
# side (unloaded slots NaN), K5a's runs of 32 bytes (16 points past R = 4)
# with halos shuffled from the lanes d = 1 + q / E away within a warp or
# loaded (wrapped) by the warp's d edge lanes, its 16-byte words only where
# a run lies inside the array (``aligned``), K5b's runs of E rows (16 where
# 16 divides m, else the most up to 8 that divide m) on 32 consecutive
# columns (two groups of 32 a warp at E <= 8) and their halo
# rows from the columns beside, wrapped.  The
# taps are summed in the spec's order in the element type (torch tensors,
# so each product and sum rounds as ``mul`` / ``add`` do), and every output
# must be stored exactly once, bit for bit the plain version.

THREADS = 256


def _star(r):
    return tst.StencilSpec(f"star1d-r{r}", 1, r, "star", tst._star_taps(1, r))


def _taps20():
    """20 taps (offsets -10..-1, 1..10), reach 10."""
    return tst.StencilSpec("taps20", 1, 10, "star", tuple(
        ((o,), 1.0 / (20 + abs(o))) for o in range(-10, 11) if o))


def _lopsided():
    """Reach 16 on one side only, 5 taps."""
    return tst.StencilSpec("lopsided", 1, 16, "star", (
        ((3,), 0.125), ((-16,), 0.25), ((0,), 0.5), ((16,), 0.0625), ((-1,), 0.0625)))


SPECS = {"1d3p": lambda: tst.make("1d3p"), "1d5p": lambda: tst.make("1d5p"),
         "heat1d": lambda: tst.make("heat1d"), "r6": lambda: _star(6), "r8": lambda: _star(8),
         "taps20": _taps20,
         "r16": lambda: _star(16), "lopsided": _lopsided}


def _window(r):
    """The window's reach R: the narrowest of 4, 8, 16 that holds r."""
    return 4 if r <= 4 else 8 if r <= 8 else 16


def _step_np(spec, win, big_r, e, dtype):
    """The threads' E outputs from their windows (threads, E + 2R): each
    tap a slice, summed in order in ``dtype``."""
    acc = None
    for off, c in spec.taps:
        o = off[-1]
        term = win[:, big_r + o:big_r + o + e] * tst.coeff(c, dtype)
        acc = term if acc is None else acc + term
    return acc


def k5a_np(spec, x, aligned=True):
    """``onestep_naive<T, R>`` on the flat array ``x`` (a torch tensor)."""
    n, dtype = x.numel(), x.dtype
    r = max(abs(off[-1]) for off, _ in spec.taps)      # the kernel's own reach
    big_r = _window(r)
    e = 16 if big_r > 4 else 32 // x.element_size()   # a run: 32 bytes, 16 points past R = 4
    threads = -(-n // (THREADS * e)) * THREADS
    tid = np.arange(threads)
    lane = tid % 32
    k0 = tid * e
    whole = aligned & (k0 + e <= n)
    own = k0[:, None] + np.arange(e)
    assert (own[whole] < n).all()                 # a 16-byte run lies inside
    flat = x.reshape(-1)
    win = torch.full((threads, e + 2 * big_r), float("nan"), dtype=dtype)
    win[:, big_r:big_r + e] = flat[torch.from_numpy(own % n)]
    for q in range(r):
        d = 1 + q // e
        src_l = tid - lane + (lane - d) % 32      # the lane the shuffle reads
        src_r = tid - lane + (lane + d) % 32
        left = win[src_l, big_r + e - 1 - q % e].clone()
        right = win[src_r, big_r + q % e].clone()
        edge_l, edge_r = torch.from_numpy(lane < d), torch.from_numpy(lane >= 32 - d)
        left[edge_l] = flat[torch.from_numpy((k0 - 1 - q) % n)][edge_l]
        right[edge_r] = flat[torch.from_numpy((k0 + e + q) % n)][edge_r]
        win[:, big_r - 1 - q] = left
        win[:, big_r + e + q] = right
    acc = _step_np(spec, win, big_r, e, dtype)
    y = torch.full((n,), float("nan"), dtype=dtype)
    stored = np.zeros(n, dtype=np.int64)
    live = own < n
    y[torch.from_numpy(own[live])] = acc[torch.from_numpy(live)]
    np.add.at(stored, own[live], 1)
    assert (stored == 1).all()
    return y


def k5b_np(spec, t):
    """``onestep_transpose<T, E, R, P>`` on the (nb, m, vl) layout ``t``."""
    nb, m, vl = t.shape
    dtype = t.dtype
    r = spec.r                                      # the reach the wrapper passes
    assert r <= m
    e = 16 if m % 16 == 0 else next(d for d in range(8, 0, -1) if m % d == 0)
    big_r = _window(r)
    groups = 2 if e <= 8 else 1                     # column groups of 32 a warp
    g, ncols = m // e, nb * vl
    warps = -(-ncols // (32 * groups)) * g
    threads = -(-warps * 32 // THREADS) * THREADS
    tid = np.arange(threads)
    lane, warp = tid % 32, tid // 32
    group = warp // g
    s0 = (warp - group * g) * e
    c0 = group * groups * 32 + lane
    live = c0 < ncols                              # the other threads return
    s0, c0 = s0[live], c0[live]
    out = torch.full((nb * m * vl,), float("nan"), dtype=dtype)
    stored = np.zeros(nb * m * vl, dtype=np.int64)
    flat = t.reshape(-1)
    block = m * vl
    for p in range(groups):
        c = c0 + 32 * p
        keep = c < ncols                           # the others compute column c0
        c = np.where(keep, c, c0)
        b, j = c // vl, c % vl
        at = b * block + j
        left = np.where(j > 0, at - 1, np.where(b > 0, b - 1, nb - 1) * block + vl - 1)
        right = np.where(j < vl - 1, at + 1, np.where(b < nb - 1, b + 1, 0) * block)
        win = torch.full((len(c), e + 2 * big_r), float("nan"), dtype=dtype)
        rows = at[:, None] + (s0[:, None] + np.arange(e)) * vl
        win[:, big_r:big_r + e] = flat[torch.from_numpy(rows)]
        for q in range(r):
            wl, wr = s0 - 1 - q, s0 + e + q
            win[:, big_r - 1 - q] = flat[torch.from_numpy(
                np.where(wl >= 0, at + wl * vl, left + (wl + m) * vl))]
            win[:, big_r + e + q] = flat[torch.from_numpy(
                np.where(wr < m, at + wr * vl, right + (wr - m) * vl))]
        acc = _step_np(spec, win, big_r, e, dtype)
        rows, acc = rows[keep].reshape(-1), acc[torch.from_numpy(keep)].reshape(-1)
        out[torch.from_numpy(rows)] = acc
        np.add.at(stored, rows, 1)
    assert (stored == 1).all()
    return out.reshape(nb, m, vl)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("n", [40, 96 * 41, 2 * THREADS * 16 + 24])
@pytest.mark.parametrize("name", list(SPECS))
def test_k5a_transcription_matches_plain(name, n, aligned, dtype):
    """K5a's register forms at every window, a run of 8 float32 or 16
    bfloat16 points a thread (16 of either at reach 16; the lane form at
    float32's few taps past reach 4), at arrays shorter than a warp's runs,
    past a CTA's and not a multiple of a run, bit for bit the plain
    version."""
    spec = SPECS[name]()
    x = torch.from_numpy(_x((n,), n % 97)).to(dtype)
    assert torch.equal(k5a_run_np(spec, x, aligned), sk.stencil1d_naive_onestep_ref(spec, x))


LANE_RUN = 8


def k5a_lane_np(spec, x):
    """``onestep_naive_lane<T>`` on the flat array ``x``: a warp a run of
    LANE_RUN vectors of 32 points, lane L point L of each and of the
    vectors beside the run (wrapped); tap o a shuffle a vector from lane
    (L + o) % 32, which sends its next (o > 0, lanes below o) or previous
    (o < 0, lanes from 32 + o) vector's point."""
    n, dtype = x.numel(), x.dtype
    warps = -(-n // (32 * LANE_RUN))
    threads = -(-warps * 32 // THREADS) * THREADS
    tid = np.arange(threads)
    lane = tid % 32
    base = tid // 32 * 32 * LANE_RUN + lane
    flat = x.reshape(-1)
    v = flat[torch.from_numpy((base[:, None] + (np.arange(LANE_RUN + 2) - 1) * 32) % n)]
    rows = torch.arange(threads)[:, None]
    acc = None
    for off, c in spec.taps:
        o = off[-1]
        assert abs(o) <= 32
        side = (lane < o).astype(np.int64) if o > 0 else -(lane >= 32 + o).astype(np.int64)
        sent = v[rows, torch.from_numpy(np.arange(LANE_RUN)[None, :] + 1 + side[:, None])]
        term = sent[torch.from_numpy(tid - lane + (lane + o) % 32)] * tst.coeff(c, dtype)
        acc = term if acc is None else acc + term
    own = base[:, None] + np.arange(LANE_RUN) * 32
    live = own < n
    y = torch.full((n,), float("nan"), dtype=dtype)
    stored = np.zeros(n, dtype=np.int64)
    y[torch.from_numpy(own[live])] = acc[torch.from_numpy(live)]
    np.add.at(stored, own[live], 1)
    assert (stored == 1).all()
    return y


def k5a_run_np(spec, x, aligned=True):
    """The K5a form ``onestep_form`` names for ``spec`` on ``x``'s dtype,
    transcribed: a register window or the lane form."""
    form = sk.onestep_form("naive", spec, x.dtype)
    assert form in ("reg", "lane")
    return k5a_np(spec, x, aligned) if form == "reg" else k5a_lane_np(spec, x)


def _offsets(name, *offs):
    """Equal-weight taps at ``offs``, in that order."""
    return tst.StencilSpec(name, 1, max(abs(o) for o in offs), "star",
                           tuple(((o,), 1.0 / (len(offs) + i)) for i, o in enumerate(offs)))


# K5a past its windows: reach 17 (35 taps), 3 taps at +-20, the ends of the
# lane form on one side each, every offset from -32 to 31 (64 taps); and
# past the narrow window at up to 7 taps (reach 5, 3 and 7 taps: float32
# only; reach 16, 3 taps one-sided)
LANE_SPECS = {"r17": lambda: _star(17), "r20-3taps": lambda: _offsets("r20-3taps", -20, 0, 20),
              "r5-3taps": lambda: _offsets("r5-3taps", -5, 0, 5),
              "r5-7taps": lambda: _offsets("r5-7taps", -5, -2, -1, 0, 1, 2, 5),
              "r16-3taps": lambda: _offsets("r16-3taps", 0, 16, 9),
              "ends32": lambda: _offsets("ends32", 32, 0, -31, 17),
              "all64": lambda: _offsets("all64", *range(-32, 32))}


@pytest.mark.parametrize("n", [40, 96 * 41, 2 * THREADS * LANE_RUN * 32 + 24])
@pytest.mark.parametrize("name,dtype", [
    (name, dtype) for name in LANE_SPECS for dtype in (torch.float32, torch.bfloat16)
    if LANE_SPECS[name]().r > 8 or dtype == torch.float32])
def test_k5a_lane_transcription_matches_plain(name, n, dtype):
    """K5a's lane form (reach 17 to 32 up to 64 taps; reach 5 to 16 up to 7
    taps, bfloat16 from reach 9) at arrays shorter than a vector, not a
    multiple of a warp's run and past two CTAs, bit for bit the plain
    version."""
    spec = LANE_SPECS[name]()
    assert sk.onestep_form("naive", spec, dtype) == "lane"
    x = torch.from_numpy(_x((n,), n % 89)).to(dtype)
    assert torch.equal(k5a_lane_np(spec, x), sk.stencil1d_naive_onestep_ref(spec, x))


K5B_TILES = [(32, 8, 4), (8, 4, 5), (4, 2, 7), (3, 5, 4), (4, 32, 3), (8, 16, 5), (41, 6, 3),
             (1, 12, 9), (32, 3, 2), (5, 7, 1), (2, 16, 1), (7, 24, 2), (3, 40, 7),
             (64, 16, 2), (6, 20, 1), (4, 11, 3), (2, 13, 2), (5, 9, 2), (8, 14, 1)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name,vl,m,nb", [
    (name, *tile) for name in SPECS for tile in K5B_TILES if SPECS[name]().r <= tile[1]])
def test_k5b_transcription_matches_plain(name, vl, m, nb, dtype):
    """K5b's register form on runs of 16 rows (m = 16, 32) and of every
    length 1 to 8 (the most rows up to 8 that divide m: m = 8, 24, 40; 7,
    14; 6, 12; 5, 20; 4; 3, 9; 2; the primes 11 and 13 on runs of one row),
    r = m, nb = 1, vl = 1 and off 32, bit for bit the plain version (a
    reach beyond m has no layout step)."""
    spec = SPECS[name]()
    t = tlay.to_transpose_layout(torch.from_numpy(_x((nb * m * vl,), vl + m)).to(dtype), vl, m)
    assert torch.equal(k5b_np(spec, t), sk.stencil1d_transpose_onestep_ref(spec, t))


def _jspec(spec):
    return jst.StencilSpec(spec.name, spec.ndim, spec.r, spec.kind, spec.taps)


@pytest.mark.parametrize("name,vl,m,nb", [
    ("r6", 32, 8, 3), ("r6", 4, 6, 5), ("r6", 5, 7, 1), ("taps20", 4, 16, 8),
    ("taps20", 3, 10, 4), ("taps20", 32, 40, 1), ("r16", 8, 16, 2), ("r16", 6, 24, 1),
    ("lopsided", 7, 16, 3), ("1d5p", 32, 3, 2), ("1d5p", 5, 2, 3), ("heat1d", 41, 1, 2)])
def test_onestep_register_forms_match_pallas(name, vl, m, nb):
    """Both register forms, transcribed, and the port's entry points at
    reach 6, 20 taps, reach 16, r = m, m = 16 and past it, nb = 1, odd m
    and vl off 32, against the reference's kernels (Pallas in interpret
    mode) within 2e-6."""
    spec = SPECS[name]()
    assert sk.onestep_form("transpose", spec, torch.float32) == "reg"
    x = torch.from_numpy(_x((nb * m * vl,), m + nb))
    jx = jnp.asarray(x.numpy())
    want = np.asarray(jsk.stencil1d_naive_onestep(_jspec(spec), jx, vl, interpret=True))
    np.testing.assert_allclose(k5a_run_np(spec, x).numpy(), want, **TOL)
    np.testing.assert_allclose(sk.stencil1d_naive_onestep(spec, x, vl).numpy(), want, **TOL)
    t = tlay.to_transpose_layout(x, vl, m)
    want = np.asarray(jsk.stencil1d_transpose_onestep(_jspec(spec), jnp.asarray(t.numpy()),
                                                      interpret=True))
    np.testing.assert_allclose(k5b_np(spec, t).numpy(), want, **TOL)
    np.testing.assert_allclose(sk.stencil1d_transpose_onestep(spec, t).numpy(), want, **TOL)
    np.testing.assert_allclose(ops.stencil_onestep_transpose(spec, x, vl, m).numpy(),
                               np.asarray(jops.stencil_onestep_transpose(
                                   _jspec(spec), jx, vl, m, interpret=True)), **TOL)


def test_onestep_form_limits():
    """The register windows take every |offset| up to 16 and up to 64 taps,
    whatever m, K5a's past the narrow one only above 7 taps (bfloat16: any
    taps within the middle one); K5a's lane form every |offset| up to 32;
    past either the memory forms."""
    f32, bf16 = torch.float32, torch.bfloat16
    assert (sk.ONESTEP_REACH, sk.ONESTEP_NAIVE_REACH, sk.ONESTEP_MAX_TAPS,
            sk.ONESTEP_LANE_TAPS) == (16, 32, 64, 7)
    for name in SPECS:
        for dtype in (f32, bf16):
            assert sk.onestep_form("transpose", SPECS[name](), dtype) == "reg"
        for dtype in (f32, bf16):                                    # lopsided: 5 taps, reach 16
            assert sk.onestep_form("naive", SPECS[name](), dtype) == \
                ("lane" if name == "lopsided" else "reg")
    past = tst.StencilSpec("far17", 1, 17, "star", (((0,), 0.5), ((17,), 0.5)))
    for spec in (_star(17), past, _star(31), _offsets("r32", 0, -32)):
        for dtype in (f32, bf16):
            assert (sk.onestep_form("naive", spec, dtype),
                    sk.onestep_form("transpose", spec, dtype)) == ("lane", "mem")
    for spec in (_offsets("r5-3taps", -5, 0, 5), _offsets("r8-7taps", -8, -2, -1, 0, 1, 2, 5)):
        assert (sk.onestep_form("naive", spec, f32), sk.onestep_form("naive", spec, bf16),
                sk.onestep_form("transpose", spec, f32)) == ("lane", "reg", "reg")
    for spec in (_offsets("r9-3taps", -9, 0, 9), _offsets("r16-2taps", 16, -3)):
        assert (sk.onestep_form("naive", spec, f32), sk.onestep_form("naive", spec, bf16),
                sk.onestep_form("transpose", spec, bf16)) == ("lane", "lane", "reg")
    for spec in (_offsets("r4-3taps", -4, 0, 4), _offsets("r5-8taps", *range(-5, 3))):
        for dtype in (f32, bf16):
            assert sk.onestep_form("naive", spec, dtype) == \
                sk.onestep_form("transpose", spec, dtype) == "reg"
    far = _offsets("far33", 0, -33)
    many = tst.StencilSpec("taps65", 1, 16, "star", tuple(((o % 33 - 16,), 1.0 / 65)
                                                          for o in range(65)))
    for spec in (far, many):
        for dtype in (f32, bf16):
            assert sk.onestep_form("naive", spec, dtype) == \
                sk.onestep_form("transpose", spec, dtype) == "mem"


@pytest.mark.parametrize("name,vl,m,nb", [
    ("r17", 32, 17, 2), ("r20-3taps", 4, 20, 3), ("r20-3taps", 5, 40, 1), ("ends32", 7, 32, 2),
    ("all64", 8, 32, 2), ("r5-3taps", 8, 5, 3), ("r16-3taps", 3, 16, 1)])
def test_onestep_lane_form_matches_pallas(name, vl, m, nb):
    """K5a's lane form, transcribed, and the port's entry points at reach 17
    to 32 (K5b there on its memory form) and at 3 taps of reach 5 and 16,
    r = m, nb = 1 and vl off 32, against the reference's kernels (Pallas
    in interpret mode) within 2e-6."""
    spec = LANE_SPECS[name]()
    x = torch.from_numpy(_x((nb * m * vl,), m + nb))
    jx = jnp.asarray(x.numpy())
    want = np.asarray(jsk.stencil1d_naive_onestep(_jspec(spec), jx, vl, interpret=True))
    np.testing.assert_allclose(k5a_lane_np(spec, x).numpy(), want, **TOL)
    np.testing.assert_allclose(sk.stencil1d_naive_onestep(spec, x, vl).numpy(), want, **TOL)
    t = tlay.to_transpose_layout(x, vl, m)
    want = np.asarray(jsk.stencil1d_transpose_onestep(_jspec(spec), jnp.asarray(t.numpy()),
                                                      interpret=True))
    np.testing.assert_allclose(sk.stencil1d_transpose_onestep(spec, t).numpy(), want, **TOL)
