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
    """The far-reach kernel's CUDA tile is sized from depth: from
    ``FAR_TILE`` the columns (then the rows) halve until the planes fit two
    CTAs an SM, no larger than the grid; a depth no tile fits raises,
    naming the shared memory, and along a stream axis a launch is one
    step."""
    star = {nd: tst.StencilSpec(f"s{nd}", nd, 5, "star", tst._star_taps(nd, 5))
            for nd in (1, 2, 3)}
    ty, tc, ncp, smem = sk.far_tile(3, (512, 512, 512), 8, 5, 1, 31, 4)
    # 16 x 8 columns fill a warp's lanes 4 times; the pitch that fits two
    # CTAs an SM (10) leaves a 2-way bank conflict that 11 would not
    assert (ty, tc, ncp) == (16, 8, 10) and smem <= sk.FAR_SMEM_AIM
    assert sk.far_tile(3, (512, 512, 512), 8, 5, 1, 31, 2)[:2] == (16, 8)   # bfloat16
    assert sk.far_tile(3, (512, 512, 512), 8, 6, 1, 37, 4)[:2] == (16, 4)
    assert sk.far_tile(2, (8192, 1, 8192), 8, 5, 1, 21, 4)[:3] == (1, 256, 258)
    assert sk.far_tile(2, (8192, 1, 8192), 8, 8, 1, 33, 4)[:3] == (1, 128, 130)   # reach 8
    with pytest.raises(ValueError, match="one step a launch"):       # a stream axis: depth 1
        sk.far_tile(2, (8192, 1, 8192), 8, 5, 2, 21, 4)
    assert sk.far_tile(1, (1, 1, 1 << 20), 8, 5, 8, 11, 4)[:3] == (1, 512, 528)
    assert sk.far_tile(3, (4, 3, 64), 8, 5, 1, 31, 4)[:2] == (3, 8)          # the grid's
    assert sk.far_tile(1, (1, 1, 96), 8, 5, 4, 11, 4)[:2] == (1, 12)
    for nd, spec in star.items():
        assert sk.far_depth(nd, 8, 5, len(spec.taps)) == sk.FAR_DEPTH[nd]
    with pytest.raises(ValueError, match="shared memory"):
        sk.far_tile(3, (512, 512, 512), 32, 32, 1, 193, 4)


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
