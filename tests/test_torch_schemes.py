"""The paper's five vectorization schemes in the port (``core/vectorize.py``)
against the JAX reference, on the CPU.

  * each step function (``multiload``, ``reorg``, ``fused``, ``dlt`` at vl 4
    and 8, ``transpose`` at the reference's conformance tiles (4, 4), (8, 4),
    (8, 8)) on all eight registry stencils, in float32 and bfloat16: within
    the reference's conformance tolerance of the reference's step (2e-6 f32,
    4e-2 bf16; ``tests/test_scheme_conformance.py``) — in fact bit for bit,
    which is asserted — and within the port bit for bit ``fused``;
  * ``run_scheme``, every scheme and stencil, at 1, 3 and 5 steps in
    float32 (within 1e-4 of the reference's, its multistep tolerance) and
    3 in bfloat16 (4e-2), and bit for bit the port's fused run; the layout
    schemes stay layout-resident;
  * ``wrap_pad`` at every axis and pad, beyond the extent too.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import stencils as jst
from repro.core import vectorize as jvec
from repro_torch.core import stencils as tst
from repro_torch.core import vectorize as tvec

NAMES = ["1d3p", "1d5p", "2d5p", "2d9p", "3d7p", "3d27p", "heat1d", "heat2d"]
SHAPES = {1: (128,), 2: (8, 64), 3: (4, 4, 64)}
VLMS = [(4, 4), (8, 4), (8, 8)]
TOL = {"float32": 2e-6, "bfloat16": 4e-2}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# (scheme, vl, m): the tile matters to dlt (vl) and transpose (vl, m) only
CASES = [("multiload", None, None), ("reorg", None, None), ("fused", None, None),
         ("dlt", 4, None), ("dlt", 8, None)] + [("transpose", vl, m) for vl, m in VLMS]


def _inputs(name, dtype):
    """The same grid on both sides: float32 numpy from the seed, rounded to
    the dtype by each framework (exact in both)."""
    spec = tst.make(name)
    x = np.random.default_rng(0).standard_normal(SHAPES[spec.ndim]).astype(np.float32)
    return spec, jst.make(name), x, torch.from_numpy(x).to(TORCH_DT[dtype]), \
        jnp.asarray(x).astype(jnp.dtype(dtype))


def _port(scheme, spec, x, vl, m):
    if scheme == "transpose":
        return tvec.step_transpose(spec, x, vl=vl, m=m)
    if scheme == "dlt":
        return tvec.step_dlt(spec, x, vl=vl)
    return tvec.get_scheme(scheme)(spec, x)


def _ref(scheme, spec, x, vl, m):
    if scheme == "transpose":
        return jvec.step_transpose(spec, x, vl=vl, m=m)
    if scheme == "dlt":
        return jvec.step_dlt(spec, x, vl=vl)
    return jvec.get_scheme(scheme)(spec, x)


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t.astype(jnp.float32))


def test_registry_and_cases_cover_everything():
    assert sorted(NAMES) == tst.names()
    assert sorted(tvec.SCHEMES) == sorted(jvec.SCHEMES)
    assert {c[0] for c in CASES} == set(tvec.SCHEMES)
    with pytest.raises(ValueError, match="unknown scheme"):
        tvec.get_scheme("simd")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("scheme,vl,m", CASES)
@pytest.mark.parametrize("name", NAMES)
def test_step_matches_reference(name, scheme, vl, m, dtype):
    spec, jspec, _, xt, xj = _inputs(name, dtype)
    got = _port(scheme, spec, xt, vl, m)
    assert got.dtype == xt.dtype and got.shape == xt.shape
    want = _np(_ref(scheme, jspec, xj, vl, m))
    np.testing.assert_allclose(_np(got), want, rtol=TOL[dtype], atol=TOL[dtype])
    # the same taps in the same order, each rounded once: bit for bit
    np.testing.assert_array_equal(_np(got), want)
    assert torch.equal(got, tvec.step_fused(spec, xt))


# (steps, dtype): the reference compiles a program a case
RUN_CASES = [(1, "float32"), (3, "float32"), (5, "float32"), (3, "bfloat16")]


@pytest.mark.parametrize("scheme", sorted(tvec.SCHEMES))
@pytest.mark.parametrize("steps,dtype", RUN_CASES)
@pytest.mark.parametrize("name", NAMES)
def test_run_scheme_matches_reference(name, steps, dtype, scheme):
    spec, jspec, _, xt, xj = _inputs(name, dtype)
    got = tvec.run_scheme(scheme, spec, xt, steps, 8, 4)
    want = _np(jvec.run_scheme(scheme, jspec, xj, steps, 8, 4))
    tol = 1e-4 if dtype == "float32" else TOL[dtype]
    np.testing.assert_allclose(_np(got), want, rtol=tol, atol=tol)
    assert got.dtype == xt.dtype and torch.equal(got, tst.apply_steps(spec, xt, steps))


def test_run_scheme_is_layout_resident(monkeypatch):
    """dlt and transpose enter the layout once a run, not once a step."""
    from repro_torch.core import layouts
    calls = []
    real = layouts.to_transpose_layout
    monkeypatch.setattr(layouts, "to_transpose_layout",
                        lambda *a, **k: calls.append(a[1:]) or real(*a, **k))
    spec, _, _, xt, _ = _inputs("2d5p", "float32")
    tvec.run_scheme("transpose", spec, xt, 5, 8, 4)
    tvec.run_scheme("dlt", spec, xt, 5, 8, 4)
    assert calls == [(8, 4), (8, 8)]     # dlt: m = 64 // vl
    with pytest.raises(ValueError, match="multiple of vl"):
        tvec.run_scheme("dlt", spec, xt, 1, 48)


@pytest.mark.parametrize("pad", [0, 1, 2, 3, 7, 12])
def test_wrap_pad_every_axis(pad):
    x = np.arange(3 * 5 * 4).reshape(3, 5, 4)
    for axis in range(3):
        want = np.pad(x, [(pad, pad) if a == axis else (0, 0) for a in range(3)], mode="wrap")
        np.testing.assert_array_equal(tvec.wrap_pad(torch.from_numpy(x), pad, axis).numpy(), want)
