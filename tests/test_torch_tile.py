"""The GPU tile picker (``repro_torch.kernels.ops.pick_tile``) against the
reference's (``repro.kernels.ops.pick_tile``), and runs at the tiles it
picks.

  * Grid check: over every registry stencil, minor extents {8 … 1000},
    ``m`` ∈ {auto, 1..9}, ``n0`` ∈ {2, 3, 8, 12, 17, 64}, ``t0`` ∈ {auto,
    1..9} and ``vl`` ∈ {auto, 4, 8, 16, 32}, every request the reference
    accepts the port accepts, with a legal tile: ``vl·m`` divides the
    minor extent, ``m >= r``, ``t0`` divides ``n0`` and ``t0 >= r``; an
    explicit ``vl`` is kept, and ``m`` and ``t0`` are no larger than the
    ones asked for.
  * Run parity: shapes whose minor extent is no multiple of 32 run through
    the port's ``StencilProblem.run`` on the CPU (resident and roundtrip,
    fused and native remainders) and match the reference's run with an
    explicit ``StencilPlan(backend="pallas")`` in interpret mode within
    1e-5 (float32; XLA's CPU backend may contract a multiply-add into an
    FMA) and the float64 numpy oracle within 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import api as japi
from repro.core import stencils as jst
from repro.kernels import ops as jops
from repro_torch.core import stencils as tst
from repro_torch.core.api import StencilPlan, StencilProblem
from repro_torch.kernels import ops
from repro_torch.kernels import stencil_kernels as sk

MINOR = (8, 16, 24, 32, 40, 48, 64, 96, 120, 128, 200, 256, 1000)
N0 = (2, 3, 8, 12, 17, 64)
OPT = (None,) + tuple(range(1, 10))       # m and t0: auto, then 1..9
VLS = (None, 4, 8, 16, 32)


def _shapes(ndim):
    if ndim == 1:
        return [((n,), None) for n in MINOR]
    mid = (4,) * (ndim - 2)
    return [((n0,) + mid + (n,), t0) for n0 in N0 for n in MINOR for t0 in OPT]


def _accepts(fn, *args):
    try:
        return fn(*args)
    except ValueError:
        return None


@pytest.mark.parametrize("vl", VLS)
@pytest.mark.parametrize("name", tst.names())
def test_port_accepts_what_the_reference_accepts(name, vl):
    spec, jspec = tst.make(name), jst.make(name)
    r = spec.r
    accepted = 0
    for shape, t0 in _shapes(spec.ndim):
        for m in OPT:
            if _accepts(jops.pick_tile, jspec, shape, vl, m, t0) is None:
                continue
            accepted += 1
            got = _accepts(ops.pick_tile, spec, shape, vl, m, t0)
            assert got is not None, f"port refuses {shape} vl={vl} m={m} t0={t0}"
            pvl, pm, pt0 = got
            assert shape[-1] % (pvl * pm) == 0 and pm >= r, (shape, vl, m, t0, got)
            assert vl is None or pvl == vl, (shape, vl, got)
            assert m is None or pm <= m, (shape, m, got)
            if spec.ndim == 1:
                assert pt0 is None
            else:
                assert shape[0] % pt0 == 0 and pt0 >= r, (shape, t0, got)
                assert t0 is None or pt0 <= t0, (shape, t0, got)
    assert accepted > 0


def test_pick_tile_c1_shapes():
    """The shapes the picker used to refuse, and the main path's tiles."""
    spec = tst.make
    assert ops.pick_tile(spec("1d3p"), (1000,)) == (8, 5, None)
    assert ops.pick_tile(spec("1d5p"), (96,)) == (32, 3, None)
    assert ops.pick_tile(spec("2d5p"), (64, 48)) == (16, 3, 32)
    assert ops.pick_tile(spec("3d7p"), (16, 8, 16)) == (16, 1, 16)
    assert ops.pick_tile(spec("1d3p"), (1000,), vl=8, m=25) == (8, 25, None)
    assert ops.pick_tile(spec("1d3p"), (1 << 26,)) == (32, 8, None)
    assert ops.pick_tile(spec("2d5p"), (8192, 8192)) == (32, 8, 32)
    assert ops.pick_tile(spec("3d7p"), (512, 512, 512)) == (32, 8, 16)
    with pytest.raises(ValueError, match=r"\(2,\)"):
        ops.pick_tile(spec("1d5p"), (2,))                 # no m >= r=2 at any vl


C1_SHAPES = (("1d3p", (1000,)), ("1d5p", (96,)), ("2d5p", (64, 48)), ("3d7p", (16, 8, 16)))
K, STEPS = 3, 8           # two 3-step blocks and a 2-step remainder


def _f64_oracle(name, x, steps):
    spec = tst.make(name)
    out = x.astype(np.float64)
    for _ in range(steps):
        out = tst.numpy_apply_once(spec, out)
    return out


@pytest.mark.parametrize("sweep,ttile", [("resident", 2), ("roundtrip", 1)])
@pytest.mark.parametrize("remainder", ["fused", "native"])
@pytest.mark.parametrize("name,shape", C1_SHAPES)
def test_c1_shapes_run_match_reference_and_oracle(name, shape, remainder, sweep, ttile):
    x = np.random.default_rng(11).standard_normal(shape).astype(np.float32)
    fields = dict(backend="pallas", sweep=sweep, k=K, remainder=remainder, ttile=ttile)
    want = np.asarray(japi.StencilProblem(name, shape).run(
        jnp.asarray(x), STEPS, japi.StencilPlan(**fields)))
    prob = StencilProblem(name, shape, device="cpu")
    x_in = torch.from_numpy(x.copy())
    sk.reset_launches()
    got = prob.run(x_in, STEPS, StencilPlan(**fields)).numpy()
    assert sk.LAUNCHES == dict.fromkeys(sk.LAUNCHES, 0)      # CPU: no kernel
    np.testing.assert_array_equal(x_in.numpy(), x)           # the input is not written
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, _f64_oracle(name, x, STEPS), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name,shape", C1_SHAPES)
def test_c1_shapes_dirichlet_match_reference(name, shape):
    """``ops.stencil_run`` (the Dirichlet ring along axis 0) at the picked
    tile against the reference's, which picks its own."""
    x = np.random.default_rng(12).standard_normal(shape).astype(np.float32)
    want = np.asarray(jops.stencil_run(jst.make(name), jnp.asarray(x), 6, k=K))
    got = ops.stencil_run(tst.make(name), torch.from_numpy(x), 6, k=K).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
