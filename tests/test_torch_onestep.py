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
