"""The port's layout transforms and layout step against the JAX reference.

Layout transforms are pure data movement and must be bitwise equal to
``repro.core.layouts`` / ``vectorize.extend_vs`` / ``ref.block_transpose_ref``;
``step_in_layout`` is held to the reference's within 2e-6 in f32 (XLA may
contract a multiply-add into an FMA) and to the port's own natural-layout
oracle bit for bit (same taps, same order, same rounding).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import layouts as jlay
from repro.core import stencils as jst
from repro.core import vectorize as jvec
from repro.kernels import ref as jref
from repro_torch.core import layouts as tlay
from repro_torch.core import stencils as tst
from repro_torch.core import vectorize as tvec
from repro_torch.kernels import ref as tref

CASES = [((64,), 8, 8), ((96,), 4, 3), ((32,), 8, 4), ((6, 64), 8, 2),
         ((4, 40), 4, 5), ((3, 5, 32), 8, 4), ((2, 2, 256), 32, 8)]


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("shape,vl,m", CASES)
def test_transpose_layout_bitwise(shape, vl, m):
    x = _x(shape)
    want = np.array(jlay.to_transpose_layout(jnp.asarray(x), vl, m))
    got = tlay.to_transpose_layout(torch.from_numpy(x), vl, m)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tref.block_transpose_ref(torch.from_numpy(x), vl, m).numpy(),
                                  np.asarray(jref.block_transpose_ref(jnp.asarray(x), vl, m)))
    back = tlay.from_transpose_layout(got, vl, m)
    np.testing.assert_array_equal(back.numpy(), x)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jlay.from_transpose_layout(jnp.asarray(want), vl, m)))
    np.testing.assert_array_equal(tref.block_untranspose_ref(got, vl, m).numpy(), x)


@pytest.mark.parametrize("shape,vl,m", CASES)
@pytest.mark.parametrize("r", [1, 2])
def test_extend_vs_bitwise(shape, vl, m, r):
    x = _x(shape, 1)
    t = np.array(jlay.to_transpose_layout(jnp.asarray(x), vl, m))
    want = np.asarray(jvec.extend_vs(jnp.asarray(t), r))
    got = tvec.extend_vs(torch.from_numpy(t), r).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,vl,m", [(64, 8, 8), (96, 4, 3), (512, 32, 8)])
def test_index_map_and_shift_bitwise(n, vl, m):
    np.testing.assert_array_equal(tlay.transpose_index_map(n, vl, m),
                                  jlay.transpose_index_map(n, vl, m))
    x = _x((n,), 2)
    t = np.array(jlay.to_transpose_layout(jnp.asarray(x), vl, m))
    for shift in (-2, -1, 0, 1, 3):
        want = np.asarray(jlay.shift_in_layout(jnp.asarray(t), shift))
        got = tlay.shift_in_layout(torch.from_numpy(t), shift).numpy()
        np.testing.assert_array_equal(got, want)
        # a shift in layout is a periodic roll of the natural array
        np.testing.assert_array_equal(
            tlay.from_transpose_layout(torch.from_numpy(got), vl, m).numpy(),
            np.roll(x, -shift))


@pytest.mark.parametrize("name,shape,vl,m", [
    ("1d3p", (64,), 8, 4), ("1d5p", (96,), 4, 3), ("heat1d", (32,), 8, 4),
    ("2d5p", (6, 64), 8, 2), ("2d9p", (4, 40), 4, 5), ("heat2d", (5, 32), 8, 4),
    ("3d7p", (3, 5, 32), 8, 4), ("3d27p", (4, 3, 64), 8, 8),
])
def test_step_in_layout(name, shape, vl, m):
    spec = tst.make(name)
    x = _x(shape, 3)
    t = np.array(jlay.to_transpose_layout(jnp.asarray(x), vl, m))
    want = np.asarray(jvec.step_in_layout(jst.make(name), jnp.asarray(t), len(shape)))
    got = tvec.step_in_layout(spec, torch.from_numpy(t), len(shape))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-6, atol=2e-6)
    natural = tst.apply_once(spec, torch.from_numpy(x))
    assert torch.equal(tlay.from_transpose_layout(got, vl, m), natural)


def test_layout_shape_errors():
    with pytest.raises(ValueError, match="multiple"):
        tlay.to_transpose_layout(torch.zeros(30), 8, 4)
    with pytest.raises(ValueError, match="does not end"):
        tlay.from_transpose_layout(torch.zeros(2, 4, 8), 4, 8)
