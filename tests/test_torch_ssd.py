"""K6's plain version (``repro_torch.kernels.ssd_kernel``) against the JAX
package's Pallas SSD chunk scan (``interpret=True``) and its
token-recurrence oracle ``ssd_chunk_ref``, on the CPU.

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
    assert ssd.LAUNCHES == {"ssd_scan": 0}
    assert torch.equal(buf.transpose(0, 1), ssd.ssd_chunk_scan_ref(*args))
    assert y.data_ptr() == buf.data_ptr()
    with pytest.raises(ValueError, match="out must be"):
        ssd.ssd_chunk_scan(*args, out=torch.zeros(3, 2, 4, 2, 8, dtype=torch.float64))
    with pytest.raises(ValueError, match="dt must be"):
        ssd.ssd_chunk_scan(args[0], args[1], args[2], args[3][:, :, :2], args[4])
