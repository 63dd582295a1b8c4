"""The plain versions of the port's kernels (K1, K2, K3) against the JAX
package's Pallas kernels, run in interpret mode as the reference's own
tests run them.

Same numpy inputs at the same (vl, m, t0):
  * K2 ``block_transpose`` / ``block_untranspose`` — bitwise;
  * K1 ``stencil1d_sweep_ttile`` / K3 ``stencil_nd_sweep_ttile`` — f32
    within 2e-6 (XLA's CPU backend may contract a multiply-add into an
    FMA), including nb=1, the p >= n0t regime, r=2, box stencils and
    ttile in {1, 2}.

On a CPU tensor each wrapper is its plain version and counts no launch.
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
from repro_torch.kernels import ref as tref
from repro_torch.kernels import stencil_kernels as sk

TOL = dict(rtol=2e-6, atol=2e-6)


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("n,vl,m", [(256, 8, 8), (96, 8, 4), (64, 8, 8)])
def test_block_transpose_bitwise(n, vl, m):
    x = _x((n,), 0)
    want = np.asarray(jsk.block_transpose(jnp.asarray(x), vl, m, interpret=True))
    sk.reset_launches()
    got = sk.block_transpose(torch.from_numpy(x), vl, m)
    np.testing.assert_array_equal(got.numpy(), want)
    back = sk.block_untranspose(got, vl, m)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jsk.block_untranspose(jnp.asarray(want), vl, m, interpret=True)))
    assert sk.LAUNCHES == dict.fromkeys(sk.LAUNCHES, 0)


def test_block_transpose_leading_axes_and_out():
    x = torch.from_numpy(_x((3, 2, 64), 1))
    out = torch.empty(3, 2, 2, 4, 8)
    got = sk.block_transpose(x, 8, 4, out=out)
    assert got.data_ptr() == out.data_ptr()
    assert torch.equal(got, tlay.to_transpose_layout(x, 8, 4))
    dst = torch.empty_like(x)
    assert torch.equal(sk.block_untranspose(got, 8, 4, out=dst), x)
    with pytest.raises(ValueError, match="out must be"):
        sk.block_transpose(x, 8, 4, out=torch.empty(3, 2, 2, 8, 4))
    with pytest.raises(ValueError, match="multiple"):
        sk.block_transpose(x, 8, 16)


@pytest.mark.parametrize("ttile", [1, 2])
@pytest.mark.parametrize("name,vl,m,nb,k", [
    ("1d3p", 8, 8, 6, 2), ("1d3p", 8, 4, 1, 3),       # nb=1: halo wraps the grid
    ("1d5p", 8, 4, 3, 2),                              # r=2
])
def test_sweep_1d_plain_matches_pallas(name, vl, m, nb, k, ttile):
    x = _x((vl * m * nb,), 2)
    t = np.array(jlay.to_transpose_layout(jnp.asarray(x), vl, m))
    want = np.asarray(jsk.stencil1d_sweep_ttile(jst.make(name), jnp.asarray(t), k, ttile,
                                                interpret=True))
    spec = tst.make(name)
    got = sk.stencil1d_sweep_ttile(spec, torch.from_numpy(t), k, ttile)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # the plain version is the natural-layout oracle, bit for bit
    natural = tref.sweep_periodic_ref(spec, torch.from_numpy(x), k * ttile)
    assert torch.equal(tlay.from_transpose_layout(got, vl, m), natural)
    if ttile == 1:
        assert torch.equal(sk.stencil1d_sweep_periodic(spec, torch.from_numpy(t), k), got)


@pytest.mark.parametrize("ttile", [1, 2])
@pytest.mark.parametrize("name,shape,vl,m,t0,k", [
    ("2d5p", (16, 64), 8, 4, 4, 2),
    ("2d5p", (4, 32), 8, 4, 2, 2),                     # p >= n0t regime
    ("2d9p", (8, 64), 8, 4, 4, 1),                     # box
    ("3d7p", (8, 6, 64), 8, 4, 4, 2),
    ("3d27p", (4, 3, 64), 8, 4, 2, 1),                 # box, p >= n0t
])
def test_sweep_nd_plain_matches_pallas(name, shape, vl, m, t0, k, ttile):
    x = _x(shape, 3)
    t = np.array(jlay.to_transpose_layout(jnp.asarray(x), vl, m))
    want = np.asarray(jsk.stencil_nd_sweep_ttile(jst.make(name), jnp.asarray(t), k, ttile,
                                                 t0, interpret=True))
    spec = tst.make(name)
    got = sk.stencil_nd_sweep_ttile(spec, torch.from_numpy(t), k, ttile, t0)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    natural = tref.sweep_periodic_ref(spec, torch.from_numpy(x), k * ttile)
    assert torch.equal(tlay.from_transpose_layout(got, vl, m), natural)
    if ttile == 1:
        assert torch.equal(sk.stencil_nd_sweep_periodic(spec, torch.from_numpy(t), k, t0), got)


def test_onestep_ref_matches_reference():
    x = _x((8, 64), 4)
    want = np.asarray(jst.apply_once(jst.make("2d9p"), jnp.asarray(x)))
    got = tref.onestep_periodic_ref(tst.make("2d9p"), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_sweep_tile_sizing():
    """The CUDA tile is sized from depth: the minor (then mid) extent
    shrinks until two buffers fit, and a depth no tile fits raises."""
    spec = tst.make("3d7p")
    (tz, ty, tx), (hz, hy, hx), smem = sk.sweep_tile(spec, (512, 512, 512), 8, 4, 16)
    assert (tz, ty, tx) == (16, 16, 32) and (hz, hy, hx) == (4, 4, 8)
    assert smem == 2 * 24 * 24 * 48 * 4 <= sk.SMEM_MAX
    (tz, ty, tx), _, smem = sk.sweep_tile(spec, (512, 512, 512), 8, 8, 16)
    assert (tz, ty, tx) == (16, 16, 8) and smem <= sk.SMEM_MAX
    (tz, ty, tx), _, _ = sk.sweep_tile(spec, (4, 3, 64), 4, 1, 2)
    assert (tz, ty, tx) == (2, 3, 32)
    with pytest.raises(ValueError, match="D2"):
        sk.sweep_tile(spec, (512, 512, 512), 8, 32, 16)
    (tz, ty, tx), (hz, hy, hx), _ = sk.sweep_tile(tst.make("1d5p"), (1, 1, 1 << 20), 4, 3, None)
    assert (tz, ty, tx) == (1, 1, 4096) and (hz, hy, hx) == (0, 0, 8)
    _, (hz, hy, hx), _ = sk.sweep_tile(tst.make("2d9p"), (1, 64, 512), 8, 2, 16)
    assert (hz, hy, hx) == (0, 2, 8)


def test_wrapper_argument_checks():
    spec = tst.make("2d5p")
    t = torch.zeros(8, 2, 4, 8)
    with pytest.raises(ValueError, match="t0=3"):
        sk.stencil_nd_sweep_ttile(spec, t, 1, 1, 3)
    with pytest.raises(ValueError, match="not a 1-D"):
        sk.stencil1d_sweep_ttile(spec, t, 1)
    with pytest.raises(ValueError, match="radius"):
        sk.stencil1d_sweep_ttile(tst.make("1d5p"), torch.zeros(2, 1, 8), 1)
    with pytest.raises(ValueError, match="no kernel"):
        sk.stencil_nd_sweep_ttile(spec, t.to("meta"), 1, 1, 4)
