"""K6 on the CPU against the JAX package's Pallas SSD chunk scan
(``interpret=True``) and its token-recurrence oracle ``ssd_chunk_ref``:
the plain version (``ssd_chunk_scan_ref``), and the card's two kernels
transcribed (``ssd_state_ref`` then ``ssd_out_ref``: 128-token chunks of
their own, the state entering each chunk, then every chunk's output at
once); and the kernels' TF32 precision plan, emulated.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances are the reference's own (``tests/test_kernels_ssd.py``): rtol =
atol = 2e-4 in float32 (chunked and recurrent sums differ in order), 5e-2
in bfloat16 (``y`` is rounded to bfloat16 at the store).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ssd_kernel as jssd
from repro_torch.kernels import ssd_kernel as ssd

F32 = dict(rtol=2e-4, atol=2e-4)
BF16 = dict(rtol=5e-2, atol=5e-2)


def _inputs(nc, b, q, h, p, n, seed=0, groups=None):
    """xh, bm, cm, dt, a_neg as numpy float32; ``groups=1`` draws one B/C
    per token and broadcasts it over the heads."""
    rng = np.random.default_rng(seed)
    hb = h if groups is None else groups
    xh = 0.5 * rng.standard_normal((nc, b, q, h, p))
    bm = 0.5 * rng.standard_normal((nc, b, q, hb, n))
    cm = 0.5 * rng.standard_normal((nc, b, q, hb, n))
    dt = np.log1p(np.exp(rng.standard_normal((nc, b, q, h))))
    a_neg = -np.linspace(0.5, 2.0, h)
    return [a.astype(np.float32) for a in (xh, bm, cm, dt, a_neg)]


def _torch(arrays, h, dtype=torch.float32):
    xh, bm, cm, dt, a = (torch.tensor(v) for v in arrays)
    if bm.shape[3] != h:                      # a head axis of stride 0
        bm = bm.expand(*bm.shape[:3], h, bm.shape[4])
        cm = cm.expand(*cm.shape[:3], h, cm.shape[4])
    return xh.to(dtype), bm, cm, dt, a


def _jax(arrays, h, dtype=jnp.float32):
    xh, bm, cm, dt, a = (jnp.asarray(v) for v in arrays)
    if bm.shape[3] != h:
        bm = jnp.broadcast_to(bm, bm.shape[:3] + (h, bm.shape[4]))
        cm = jnp.broadcast_to(cm, cm.shape[:3] + (h, cm.shape[4]))
    return xh.astype(dtype), bm, cm, dt, a


SHAPES = [
    ((4, 2, 8, 2, 8, 4), None),      # the reference test's three shapes
    ((2, 1, 16, 4, 4, 8), None),
    ((6, 2, 4, 1, 16, 16), None),
    ((12, 2, 1, 2, 8, 4), None),     # Q = 1: every token its own chunk
    ((3, 1, 7, 3, 8, 6), None),      # an odd Q
    ((3, 2, 8, 8, 8, 4), 1),         # H = 8 heads sharing one group's B and C
    ((131, 1, 1, 2, 8, 4), None),    # Q = 1 past one kernel chunk: 128 + 3 tokens
    ((20, 1, 7, 2, 8, 4), None),     # Q = 7 across the kernel chunk boundary at token 128
    ((2, 1, 125, 2, 8, 4), None),    # Q = 125: kernel chunks of 128 and 122
    ((3, 2, 50, 4, 8, 4), 1),        # 150 tokens, B = 2, head stride 0
]


@pytest.mark.parametrize("shape,groups", SHAPES, ids=lambda v: str(v))
def test_plain_matches_pallas_and_oracle(shape, groups):
    nc, b, q, h, p, n = shape
    arrays = _inputs(*shape, groups=groups)
    got = ssd.ssd_chunk_scan(*_torch(arrays, h)).numpy()
    jargs = _jax(arrays, h)
    pallas = np.asarray(jssd.ssd_chunk_scan(*jargs, interpret=True))
    oracle = np.asarray(jssd.ssd_chunk_ref(*jargs))
    np.testing.assert_allclose(got, pallas, **F32)
    np.testing.assert_allclose(got, oracle, **F32)
    np.testing.assert_allclose(ssd.ssd_chunk_ref(*_torch(arrays, h)).numpy(), oracle, **F32)


def test_chunk_count_invariance():
    """The same sequence in 2 chunks and in 8 gives the same output."""
    arrays = _inputs(8, 1, 4, 2, 8, 4, seed=1)

    def rechunk(t, nc2):
        s = t.shape
        flat = t.transpose(0, 1).reshape((s[1], s[0] * s[2]) + tuple(s[3:]))
        return flat.reshape((s[1], nc2, s[0] * s[2] // nc2) + tuple(s[3:])).transpose(0, 1)

    xh, bm, cm, dt, a = _torch(arrays, 2)
    y8 = ssd.ssd_chunk_scan(xh, bm, cm, dt, a)
    y2 = ssd.ssd_chunk_scan(*(rechunk(t, 2) for t in (xh, bm, cm, dt)), a)
    np.testing.assert_allclose(rechunk(y8, 2).numpy(), y2.numpy(), **F32)


def test_bf16_matches_pallas():
    arrays = _inputs(4, 2, 8, 2, 8, 4, seed=2)
    got = ssd.ssd_chunk_scan(*_torch(arrays, 2, torch.bfloat16))
    assert got.dtype == torch.bfloat16
    jargs = _jax(arrays, 2, jnp.bfloat16)
    want = jssd.ssd_chunk_scan(*jargs, interpret=True)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **BF16)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(jssd.ssd_chunk_ref(*jargs), np.float32), **BF16)


@pytest.mark.parametrize("shape,groups", [((4, 2, 8, 2, 8, 4), None), ((5, 1, 3, 8, 8, 4), 1)])
def test_return_state_equals_oracle_state(shape, groups):
    nc, b, q, h, p, n = shape
    arrays = _inputs(*shape, seed=3, groups=groups)
    args = _torch(arrays, h)
    y, state = ssd.ssd_chunk_scan(*args, return_state=True)
    y_o, state_o = ssd.ssd_chunk_ref(*args, return_state=True)
    assert state.shape == (b, h, p, n) and state.dtype == torch.float32
    np.testing.assert_allclose(state.numpy(), state_o.numpy(), **F32)
    np.testing.assert_allclose(y.numpy(), y_o.numpy(), **F32)
    # the oracle's state, by numpy, from the reference's recurrence
    xh, bm, cm, dt, a = (np.asarray(v, np.float64) for v in _jax(arrays, h))
    st = np.zeros((b, h, p, n))
    for c in range(nc):
        for t in range(q):
            da = np.exp(dt[c, :, t] * a)
            st = st * da[..., None, None] + \
                (dt[c, :, t][..., None] * xh[c, :, t])[..., None] * bm[c, :, t][:, :, None, :]
    np.testing.assert_allclose(state.numpy(), st, **F32)


def test_out_view_and_cpu_counts_nothing():
    """``out`` may be any strided view; the plain version launches nothing."""
    arrays = _inputs(3, 2, 4, 2, 8, 4, seed=4)
    args = _torch(arrays, 2)
    buf = torch.zeros(2, 3, 4, 2, 8)
    ssd.reset_launches()
    y = ssd.ssd_chunk_scan(*args, out=buf.transpose(0, 1))
    assert ssd.LAUNCHES == {"ssd_state": 0, "ssd_out": 0}
    assert torch.equal(buf.transpose(0, 1), ssd.ssd_chunk_scan_ref(*args))
    assert y.data_ptr() == buf.data_ptr()
    with pytest.raises(ValueError, match="out must be"):
        ssd.ssd_chunk_scan(*args, out=torch.zeros(3, 2, 4, 2, 8, dtype=torch.float64))
    with pytest.raises(ValueError, match="dt must be"):
        ssd.ssd_chunk_scan(args[0], args[1], args[2], args[3][:, :, :2], args[4])


# ---------------------------------------------------------------------------
# the card's two kernels, transcribed
# ---------------------------------------------------------------------------

def _two_pass(xh, bm, cm, dt, a, **kw):
    """y and the final state through the two kernels' plain versions."""
    h_in, state = ssd.ssd_state_ref(xh, bm, dt, a, **kw.get("state", {}))
    return ssd.ssd_out_ref(xh, bm, cm, dt, a, h_in, **kw.get("out", {})), state


@pytest.mark.parametrize("shape,groups", SHAPES + [((5, 1, 3, 8, 8, 4), 1)],
                         ids=lambda v: str(v))
def test_two_pass_matches_pallas_and_oracle(shape, groups):
    nc, b, q, h, p, n = shape
    arrays = _inputs(*shape, groups=groups)
    args = _torch(arrays, h)
    y, state = _two_pass(*args)
    jargs = _jax(arrays, h)
    np.testing.assert_allclose(y.numpy(), np.asarray(jssd.ssd_chunk_scan(*jargs, interpret=True)),
                               **F32)
    np.testing.assert_allclose(y.numpy(), np.asarray(jssd.ssd_chunk_ref(*jargs)), **F32)
    y_o, state_o = ssd.ssd_chunk_ref(*args, return_state=True)
    np.testing.assert_allclose(state.numpy(), state_o.numpy(), **F32)


@pytest.mark.parametrize("shape,groups", [((4, 2, 8, 2, 8, 4), None),
                                          ((2, 1, 125, 2, 8, 4), None),
                                          ((3, 2, 50, 4, 8, 4), 1)], ids=lambda v: str(v))
def test_two_pass_bf16_matches_pallas(shape, groups):
    nc, b, q, h, p, n = shape
    arrays = _inputs(*shape, seed=2, groups=groups)
    y, _ = _two_pass(*_torch(arrays, h, torch.bfloat16))
    assert y.dtype == torch.bfloat16 and y.shape == (nc, b, q, h, p)
    jargs = _jax(arrays, h, jnp.bfloat16)
    for want in (jssd.ssd_chunk_scan(*jargs, interpret=True), jssd.ssd_chunk_ref(*jargs)):
        np.testing.assert_allclose(y.float().numpy(), np.asarray(want, np.float32), **BF16)


@pytest.mark.parametrize("q", [1, 7, 125])
def test_h_in_is_the_state_entering_each_chunk(q):
    """``h_in[:, k]`` is the oracle's state after the first 128 k tokens."""
    nc = -(-300 // q)
    arrays = _inputs(nc, 2, q, 3, 8, 4, seed=5)
    xh, bm, cm, dt, a = _torch(arrays, 3)
    h_in, state = ssd.ssd_state_ref(xh, bm, dt, a)
    assert h_in.shape == (2, ssd.n_chunks(xh), 3, 8, 4) == (2, -(-nc * q // 128), 3, 8, 4)
    assert not h_in[:, 0].any()

    def tokens(t, count):     # the first `count` tokens as one caller chunk
        flat = t.transpose(0, 1).reshape(t.shape[1], -1, *t.shape[3:])[:, :count]
        return flat[None]

    for k in range(1, h_in.shape[1]):
        _, want = ssd.ssd_chunk_ref(*(tokens(t, 128 * k) for t in (xh, bm, cm, dt)), a,
                                    return_state=True)
        np.testing.assert_allclose(h_in[:, k].numpy(), want.numpy(), **F32)


def test_cpu_wrappers_take_the_plain_versions():
    """On the CPU each kernel's wrapper returns its plain version and
    counts nothing."""
    arrays = _inputs(3, 2, 50, 2, 8, 4, seed=6)
    xh, bm, cm, dt, a = _torch(arrays, 2)
    ssd.reset_launches()
    state = torch.empty(2, 2, 8, 4)
    h_in = ssd.ssd_state(xh, bm, dt, a, state=state)
    want_h, want_state = ssd.ssd_state_ref(xh, bm, dt, a)
    assert h_in.shape == (2, 2, 2, 8, 16) and h_in.dtype == torch.float32
    assert torch.equal(h_in[..., :4], want_h) and not h_in[..., 4:].any()
    assert torch.equal(state, want_state)
    buf = torch.zeros(2, 3, 50, 2, 8)
    y = ssd.ssd_out(xh, bm, cm, dt, a, h_in, out=buf.transpose(0, 1))
    assert y.data_ptr() == buf.data_ptr()
    assert torch.equal(buf.transpose(0, 1), ssd.ssd_out_ref(xh, bm, cm, dt, a, h_in))
    assert ssd.LAUNCHES == {"ssd_state": 0, "ssd_out": 0}
    with pytest.raises(ValueError, match="h_in must be"):
        ssd.ssd_out(xh, bm, cm, dt, a, want_h)


# ---------------------------------------------------------------------------
# the precision plan: cvt.rna.tf32.f32 operands on the tensor cores
# ---------------------------------------------------------------------------

def _tf32(v):
    """``cvt.rna.tf32.f32``: the mantissa rounded to 10 bits, ties away from
    zero (the low 13 bits of the float's bits cleared after adding half)."""
    bits = v.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _tf32_einsum(split: int):
    """An einsum whose operands enter as TF32: rounded once (``split`` 1), or
    split in three, lo·hi + hi·lo + hi·hi with lo = rna(v − hi) (3)."""
    def einsum(eq, a, b):
        ah, bh = _tf32(a), _tf32(b)
        if split == 1:
            return torch.einsum(eq, ah, bh)
        al, bl = _tf32(a - ah), _tf32(b - bh)
        return torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bl) + torch.einsum(eq, ah, bh)
    return einsum


def test_tf32_rounding():
    v = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -(1.0 + 2 ** -11),
                      1.0 + 2 ** -11 - 2 ** -23, 3.0e-3])
    got = _tf32(v)
    assert got.tolist()[:5] == [1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -9, -(1.0 + 2 ** -10), 1.0]
    assert abs(got[5].item() - 3.0e-3) <= 3.0e-3 * 2 ** -11
    assert not (got.view(torch.int32) & 0x1FFF).any()


def _excess(got, want, rtol, atol) -> float:
    """Largest ``|got − want| − (atol + rtol·|want|)``: > 0 fails."""
    got, want = got.float(), want.float()
    return ((got - want).abs() - (atol + rtol * want.abs())).max().item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tf32_precision_plan(dtype):
    """At ``chip_smoke.py``'s K6 shape cut to 8 heads (2048 tokens, Q=128,
    P=64, N=128, B and C shared): the kernels' plan (state product split in
    three; y products split for float32 x, rounded once for bfloat16) holds
    the reference's tolerances against the plain version, y and the final
    state at 2e-4; the state product rounded once does not hold the state."""
    nc, b, q, h, p, n = 16, 1, 128, 8, 64, 128
    rng = np.random.default_rng(0)
    xh = torch.tensor(0.5 * rng.standard_normal((nc, b, q, h, p)), dtype=torch.float32).to(dtype)
    bm = torch.tensor(0.5 * rng.standard_normal((nc, b, q, 1, n)), dtype=torch.float32)
    cm = torch.tensor(0.5 * rng.standard_normal((nc, b, q, 1, n)), dtype=torch.float32)
    bm, cm = bm.expand(nc, b, q, h, n), cm.expand(nc, b, q, h, n)
    dt = torch.nn.functional.softplus(
        torch.tensor(rng.standard_normal((nc, b, q, h)), dtype=torch.float32) - 2.0)
    a = -torch.linspace(1.0, 16.0, h)
    y_ref, state_ref = ssd.ssd_chunk_scan_ref(xh, bm, cm, dt, a, return_state=True)
    y_tol = F32 if dtype == torch.float32 else BF16

    plan = {"state": {"einsum": _tf32_einsum(3)},
            "out": {"einsum": _tf32_einsum(3 if dtype == torch.float32 else 1)}}
    y, state = _two_pass(xh, bm, cm, dt, a, **plan)
    assert y.dtype == dtype
    assert _excess(y, y_ref, **y_tol) <= 0
    assert _excess(state, state_ref, **F32) <= 0

    _, state1 = _two_pass(xh, bm, cm, dt, a, state={"einsum": _tf32_einsum(1)})
    assert _excess(state1, state_ref, **F32) > 0
    if dtype == torch.float32:     # nor do y products rounded once in float32
        y1, _ = _two_pass(xh, bm, cm, dt, a, out={"einsum": _tf32_einsum(1)})
        assert _excess(y1, y_ref, **F32) > 0
