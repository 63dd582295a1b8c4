"""The port's specs and oracles against the JAX reference (core/stencils).

Same inputs, made with numpy from a seed, through both packages:
  * registry taps carried across with ``spec_from_reference`` are equal;
  * ``apply_steps`` in f32 within 2e-6 (XLA's CPU backend may contract a
    tap's multiply-add into an FMA where torch rounds twice), and in f64
    within 1e-12, under periodic, dirichlet and per-axis BCs;
  * ``interior_mask``, ``numpy_apply_once``, ``model_flops``/``model_bytes``
    are equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import stencils as jst
from repro_torch.convert import spec_from_reference
from repro_torch.core import stencils as tst

NAMES = jst.names()
SHAPES = {1: (48,), 2: (12, 16), 3: (6, 5, 8)}


def _x(ndim, seed, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(SHAPES[ndim]).astype(dtype)


def _bcs(ndim):
    per_axis = tuple("dirichlet" if a % 2 == 0 else "periodic" for a in range(ndim))
    return ["periodic", "dirichlet", per_axis]


def test_registry_names_equal():
    assert tst.names() == NAMES


@pytest.mark.parametrize("name", NAMES)
def test_registry_taps_equal(name):
    ref = jst.make(name)
    port = tst.make(name)
    assert spec_from_reference(dataclasses.asdict(ref)) == port
    assert port.taps == ref.taps and port.r == ref.r and port.kind == ref.kind
    assert port.npoints == ref.npoints and port.flops_per_point == ref.flops_per_point
    np.testing.assert_array_equal(port.coeff_array(), ref.coeff_array())


@pytest.mark.parametrize("name", NAMES)
def test_apply_steps_f32_matches_reference(name):
    spec = tst.make(name)
    x = _x(spec.ndim, 1)
    for bc in _bcs(spec.ndim):
        want = np.asarray(jst.apply_steps(jst.make(name), jnp.asarray(x), 3, bc))
        got = tst.apply_steps(spec, torch.from_numpy(x), 3, bc).numpy()
        np.testing.assert_allclose(got, want, rtol=2e-6, atol=2e-6, err_msg=str(bc))


@pytest.mark.parametrize("name", NAMES)
def test_apply_steps_f64_matches_reference(name):
    spec = tst.make(name)
    x = _x(spec.ndim, 2, np.float64)
    with jax.enable_x64(True):
        for bc in _bcs(spec.ndim):
            want = np.asarray(jst.apply_steps(jst.make(name), jnp.asarray(x), 3, bc))
            got = tst.apply_steps(spec, torch.from_numpy(x), 3, bc).numpy()
            np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12, err_msg=str(bc))


@pytest.mark.parametrize("name", ["1d5p", "2d9p", "3d7p"])
def test_numpy_oracle_and_mask_equal(name):
    spec = tst.make(name)
    x = _x(spec.ndim, 3, np.float64)
    for bc in _bcs(spec.ndim):
        np.testing.assert_array_equal(tst.numpy_apply_once(spec, x, bc),
                                      jst.numpy_apply_once(jst.make(name), x, bc))
        np.testing.assert_array_equal(tst.interior_mask(spec, x.shape, bc).numpy(),
                                      np.asarray(jst.interior_mask(jst.make(name), x.shape, bc)))
    # the torch oracle agrees with the port's own numpy oracle in f64
    np.testing.assert_allclose(tst.apply_once(spec, torch.from_numpy(x)).numpy(),
                               tst.numpy_apply_once(spec, x), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("name", NAMES)
def test_model_counts_equal(name):
    shape = SHAPES[tst.make(name).ndim]
    for steps, k, itemsize in [(1, 1, 4), (7, 2, 4), (16, 4, 8)]:
        assert tst.model_flops(tst.make(name), shape, steps) == \
            jst.model_flops(jst.make(name), shape, steps)
        assert tst.model_bytes(tst.make(name), shape, steps, itemsize, k) == \
            jst.model_bytes(jst.make(name), shape, steps, itemsize, k)


def test_bad_inputs_raise():
    spec = tst.make("2d5p")
    with pytest.raises(ValueError, match="unknown stencil"):
        tst.make("4d9p")
    with pytest.raises(ValueError, match="unknown bc"):
        tst.apply_once(spec, torch.zeros(4, 4), "reflect")
    with pytest.raises(ValueError, match="2-D"):
        tst.apply_once(spec, torch.zeros(4))
