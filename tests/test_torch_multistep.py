"""The multistep kernels' plain versions (K4) against the JAX package's Pallas
kernels, run in interpret mode as the reference's own tests run them.

Same numpy inputs at the same (vl, m, t0), over the shapes of the
reference's ``tests/test_kernels.py``:
  * ``edge_mask=True`` (Dirichlet ring along axis 0): the whole array
    within 2e-6 in f32 (XLA's CPU backend may contract a multiply-add into
    an FMA);
  * ``edge_mask=False``: the cells at least k·r from both axis-0 edges
    within 2e-6 — the Pallas kernel leaves unspecified values nearer the
    edges, where the port defines zeros beyond the edges; that exterior is
    held to a literal numpy transcription in f64 within 1e-12.
Also ``sweep_halo_blocks`` against the reference, the halo wrappers'
checks, and that a CPU tensor launches nothing.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import layouts as jlay
from repro.core import stencils as jst
from repro.kernels import ref as jref
from repro.kernels import stencil_kernels as jsk
from repro_torch.core import layouts as tlay
from repro_torch.core import stencils as tst
from repro_torch.kernels import ref as tref
from repro_torch.kernels import stencil_kernels as sk

TOL = dict(rtol=2e-6, atol=2e-6)


def _x(shape, seed, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _interior(a, width):
    """The cells at least ``width`` from both ends of axis 0."""
    return a[width:a.shape[0] - width]


@pytest.mark.parametrize("edge_mask", [True, False])
@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("name,vl,m,nb", [
    ("1d3p", 8, 8, 6), ("1d3p", 8, 4, 8), ("1d3p", 16, 8, 5),
    ("1d5p", 8, 8, 6), ("1d5p", 8, 4, 8),
])
def test_multistep_1d_matches_pallas(name, vl, m, nb, k, edge_mask):
    x = _x((vl * m * nb,), 1)
    t = jlay.to_transpose_layout(jnp.asarray(x), vl, m)
    want = np.asarray(jlay.from_transpose_layout(
        jsk.stencil1d_multistep(jst.make(name), t, k, interpret=True, edge_mask=edge_mask),
        vl, m))
    spec = tst.make(name)
    sk.reset_launches()
    got_t = sk.stencil1d_multistep(spec, tlay.to_transpose_layout(torch.from_numpy(x), vl, m),
                                   k, edge_mask)
    assert sk.LAUNCHES == dict.fromkeys(sk.LAUNCHES, 0)       # CPU: no kernel
    got = tlay.from_transpose_layout(got_t, vl, m).numpy()
    if edge_mask:
        np.testing.assert_allclose(got, want, **TOL)
        # the plain version is the natural-layout Dirichlet oracle, bit for bit
        assert np.array_equal(got, tref.multistep_ref(spec, torch.from_numpy(x), k).numpy())
    else:
        w = k * spec.r
        np.testing.assert_allclose(_interior(got, w), _interior(want, w), **TOL)


@pytest.mark.parametrize("edge_mask", [True, False])
@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("name,shape,vl,m,t0", [
    ("2d5p", (16, 64), 8, 4, 4),
    ("2d5p", (24, 64), 8, 8, 8),
    ("2d9p", (16, 64), 8, 4, 4),
    ("3d7p", (8, 6, 64), 8, 4, 4),
    ("3d27p", (8, 6, 64), 8, 4, 2),
])
def test_multistep_nd_matches_pallas(name, shape, vl, m, t0, k, edge_mask):
    x = _x(shape, 3)
    t = jlay.to_transpose_layout(jnp.asarray(x), vl, m)
    want = np.asarray(jlay.from_transpose_layout(
        jsk.stencil_nd_multistep(jst.make(name), t, k, t0, interpret=True,
                                 edge_mask=edge_mask), vl, m))
    spec = tst.make(name)
    got_t = sk.stencil_nd_multistep(spec, tlay.to_transpose_layout(torch.from_numpy(x), vl, m),
                                    k, t0, edge_mask)
    got = tlay.from_transpose_layout(got_t, vl, m).numpy()
    if edge_mask:
        np.testing.assert_allclose(got, want, **TOL)
        assert np.array_equal(got, tref.multistep_ref(spec, torch.from_numpy(x), k).numpy())
    else:
        w = k * spec.r
        np.testing.assert_allclose(_interior(got, w), _interior(want, w), **TOL)


def _numpy_open(spec, x, k):
    """Literal transcription of ``edge_mask=False``: each step reads zeros
    beyond either end of axis 0 and wraps every other axis."""
    r = spec.r
    for _ in range(k):
        xp = np.pad(x, [(r, r)] + [(0, 0)] * (x.ndim - 1))
        acc = np.zeros_like(x)
        for off, c in spec.taps:
            sl = xp[r + off[0]:r + off[0] + x.shape[0]]
            for axis, o in enumerate(off[1:], start=1):
                sl = np.roll(sl, -o, axis=axis)
            acc = acc + sl * c
        x = acc
    return x


@pytest.mark.parametrize("name,shape,vl,m,t0", [
    ("1d3p", (64,), 8, 4, None), ("1d5p", (96,), 8, 4, None),
    ("2d9p", (6, 32), 8, 2, 1), ("3d7p", (4, 3, 32), 8, 4, 2),
])
@pytest.mark.parametrize("k", [1, 4])
def test_open_edges_equal_numpy_transcription(name, shape, vl, m, t0, k):
    spec = tst.make(name)
    x = _x(shape, 8, np.float64)
    t = tlay.to_transpose_layout(torch.from_numpy(x), vl, m)
    if spec.ndim == 1:
        got = sk.stencil1d_multistep(spec, t, k, edge_mask=False)
    else:
        got = sk.stencil_nd_multistep(spec, t, k, t0, edge_mask=False)
    np.testing.assert_allclose(tlay.from_transpose_layout(got, vl, m).numpy(),
                               _numpy_open(spec, x, k), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("name,shape", [("1d5p", (96,)), ("2d9p", (8, 32)), ("3d7p", (4, 3, 32))])
def test_multistep_oracle_equals_reference_f64(name, shape):
    x = _x(shape, 9, np.float64)
    with jax.enable_x64(True):
        want = np.asarray(jref.multistep_ref(jst.make(name), jnp.asarray(x), 3))
    assert tref.kernel_bc(len(shape)) == jref.kernel_bc(len(shape))
    got = tref.multistep_ref(tst.make(name), torch.from_numpy(x), 3).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_sweep_halo_blocks_equals_reference():
    for r in (1, 2, 3):
        for k in (1, 2, 3, 5, 8):
            for block in (1, 2, 4, 8, 64, 256):
                assert sk.sweep_halo_blocks(r, k, block) == jsk.sweep_halo_blocks(r, k, block)


def test_halo_wrappers():
    spec1, spec2 = tst.make("1d5p"), tst.make("2d5p")
    t1 = tlay.to_transpose_layout(torch.from_numpy(_x((128,), 10)), 8, 4)
    t2 = tlay.to_transpose_layout(torch.from_numpy(_x((16, 64), 11)), 8, 4)
    assert torch.equal(sk.stencil1d_sweep_halo(spec1, t1, 2, 4),
                       sk.stencil1d_multistep(spec1, t1, 2, edge_mask=False))
    assert torch.equal(sk.stencil_nd_sweep_halo(spec2, t2, 3, 4, 4),
                       sk.stencil_nd_multistep(spec2, t2, 3, 4, edge_mask=False))
    with pytest.raises(ValueError, match="k\\*r"):
        sk.stencil1d_sweep_halo(spec1, t1, 2, 3)               # 3 < k*r = 4
    with pytest.raises(ValueError, match="k\\*r"):
        sk.stencil_nd_sweep_halo(spec2, t2, 3, 4, 2)           # 2 < 3
    with pytest.raises(ValueError, match="multiple of t0"):
        sk.stencil_nd_sweep_halo(spec2, t2, 1, 4, 6)           # 6 % 4


def test_multistep_argument_checks():
    t = torch.zeros(8, 2, 4, 8)
    with pytest.raises(ValueError, match="t0=3"):
        sk.stencil_nd_multistep(tst.make("2d5p"), t, 1, 3)
    with pytest.raises(ValueError, match="not a 1-D"):
        sk.stencil1d_multistep(tst.make("2d5p"), t, 1)
    with pytest.raises(ValueError, match="not a 2-D"):
        sk.stencil_nd_multistep(tst.make("1d3p"), torch.zeros(2, 4, 8), 1, 2)
    with pytest.raises(ValueError, match="no kernel"):
        sk.stencil_nd_multistep(tst.make("2d5p"), t.to("meta"), 1, 4)
    out = torch.empty_like(t)
    got = sk.stencil_nd_multistep(tst.make("2d5p"), t, 1, 4, out=out)
    assert got.data_ptr() == out.data_ptr()
