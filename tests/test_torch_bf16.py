"""bfloat16 on the port's stencil path (ROADMAP D1), on the CPU.

  * ``StencilProblem(..., dtype=bfloat16).run`` on the CPU (the plain
    versions) equals the reference's bfloat16 run (Pallas in interpret
    mode) bit for bit, resident and roundtrip, on every registry stencil;
  * the register kernels' bfloat16 recipe, transcribed in torch (one
    bfloat16 multiply and one bfloat16 add a tap in the spec's order, each
    rounded once, as ``mul.rn.bf16`` / ``add.rn.bf16`` do, on
    coefficients rounded to bfloat16), equals ``apply_once`` in bfloat16
    bit for bit on every registry stencil, and so does one layout step of
    the plain sweep; the plain versions' float32 sum of two bfloat16
    values, rounded to bfloat16, is the exact sum rounded once;
  * ``_taps`` rounds the coefficients to the dtype it is given, and
    ``_kernel_io`` takes float32 and bfloat16 and refuses float64 naming
    D1.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import api as japi
from repro.core import autotune as jtune
from repro_torch.convert import plan_from_reference
from repro_torch.core import layouts
from repro_torch.core import stencils as tst
from repro_torch.core.api import StencilProblem
from repro_torch.core.vectorize import step_in_layout
from repro_torch.kernels import stencil_kernels as sk

BF16 = torch.bfloat16
SHAPES = {"1d3p": (128,), "1d5p": (96,), "heat1d": (128,), "2d5p": (8, 64), "2d9p": (8, 32),
          "heat2d": (8, 64), "3d7p": (4, 4, 64), "3d27p": (4, 4, 32)}
TILES = {"1d3p": dict(vl=8, m=8), "1d5p": dict(vl=8, m=4), "heat1d": dict(vl=4, m=4),
         "2d5p": dict(vl=8, m=4, t0=4), "2d9p": dict(vl=8, m=4, t0=2),
         "heat2d": dict(vl=8, m=2, t0=4), "3d7p": dict(vl=8, m=4, t0=4),
         "3d27p": dict(vl=8, m=4, t0=2)}


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_every_registry_stencil_is_covered():
    assert sorted(SHAPES) == sorted(TILES) == tst.names()


# each (sweep, k, remainder, ttile, steps) costs a few seconds of interpret mode
@pytest.mark.parametrize("sweep,k,remainder,ttile,steps", [
    ("resident", 2, "fused", 2, 7), ("roundtrip", 2, "native", 1, 5)])
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_bf16_run_matches_reference(name, sweep, k, remainder, ttile, steps):
    """The same bfloat16 grid (float32 numpy rounded to bfloat16 on both
    sides) through the reference's Pallas kernels and the port's plain
    path: bit for bit."""
    x = _x(SHAPES[name], 11)
    jplan = japi.StencilPlan(scheme="transpose", backend="pallas", sweep=sweep, k=k,
                             remainder=remainder, ttile=ttile, **TILES[name])
    jprob = japi.StencilProblem(name, SHAPES[name], dtype=jnp.bfloat16)
    want = jprob.run(jnp.asarray(x, jnp.bfloat16), steps, jplan)
    assert want.dtype == jnp.bfloat16
    prob = StencilProblem(name, SHAPES[name], dtype=BF16, device="cpu")
    got = prob.run(torch.from_numpy(x).to(BF16), steps,
                   plan_from_reference(jtune.plan_to_dict(jplan)))
    assert got.dtype == BF16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


def round_bf16(v: np.ndarray) -> np.ndarray:
    """float64 ``v`` rounded once to bfloat16's 8 significant bits (to
    nearest, ties to even), as float64: what ``mul.rn.bf16`` /
    ``add.rn.bf16`` return for an exact product or sum (normal range)."""
    frac, exp = np.frexp(v)
    return np.ldexp(np.rint(np.ldexp(frac, 8)), exp - 8)


def kernel_recipe(spec: tst.StencilSpec, x: torch.Tensor) -> torch.Tensor:
    """One periodic step of bfloat16 ``x`` as the register kernels compute
    it (csrc/elem.cuh): coefficients rounded to bfloat16, then per tap in
    the spec's order one multiply and one add, each the exact result
    (float64 holds it) rounded once to bfloat16, nothing fused."""
    xd = x.double().numpy()
    acc = None
    for off, c in spec.taps:
        cf = torch.tensor(c, dtype=BF16).item()      # _taps(spec, width, bfloat16)
        axes = tuple(a for a, o in enumerate(off) if o)
        shifted = np.roll(xd, tuple(-o for o in off if o), axes) if axes else xd
        term = round_bf16(shifted * cf)
        acc = term if acc is None else round_bf16(acc + term)
    return torch.from_numpy(acc).to(BF16)


def test_bf16_sum_of_float32_rounds_once():
    """The plain versions add two bfloat16 values in float32 and round the
    float32 sum to bfloat16; the kernels round the exact sum once.  The
    two agree (24 >= 2·8 + 2), here on pairs of every exponent gap from 0
    to 20 and both signs, ties included."""
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.standard_normal(1 << 16).astype(np.float32)).to(BF16)
    b = torch.from_numpy((rng.standard_normal(1 << 16) *
                          2.0 ** -rng.integers(0, 21, 1 << 16)).astype(np.float32)).to(BF16)
    plain = (a.float() + b.float()).to(BF16)
    once = round_bf16(a.double().numpy() + b.double().numpy())
    np.testing.assert_array_equal(plain.double().numpy(), once)
    prod = (a.float() * b.float()).to(BF16)
    np.testing.assert_array_equal(prod.double().numpy(),
                                  round_bf16(a.double().numpy() * b.double().numpy()))


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_kernel_recipe_equals_apply_once(name):
    """The recipe equals the plain step in bfloat16 bit for bit, on values
    of several magnitudes (so that sums round), and on layout data the
    plain layout step does too."""
    spec = tst.make(name)
    shape = SHAPES[name]
    rng = np.random.default_rng(3)
    x = torch.from_numpy((rng.standard_normal(shape) *
                          10.0 ** rng.integers(-3, 4, shape)).astype(np.float32)).to(BF16)
    want = tst.apply_once(spec, x)
    assert want.dtype == BF16
    assert torch.equal(kernel_recipe(spec, x), want)
    vl, m = TILES[name]["vl"], TILES[name]["m"]
    t = layouts.to_transpose_layout(x, vl, m)
    assert torch.equal(step_in_layout(spec, t, ndim=spec.ndim),
                       layouts.to_transpose_layout(want, vl, m))


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_taps_round_to_the_dtype(dtype):
    """``_taps`` gives every registry stencil's offsets and its coefficients
    rounded to the tensor's dtype, as floats."""
    for name in tst.names():
        spec = tst.make(name)
        ntaps, offs, coeffs = sk._taps(spec, spec.ndim, dtype)
        assert ntaps == len(spec.taps)
        assert list(coeffs) == [torch.tensor(c, dtype=dtype).item() for _, c in spec.taps]
        assert list(offs) == [o for off, _ in spec.taps for o in off]
    # 3d7p's 1/12 differs between the two
    f32, b16 = (sk._taps(tst.make("3d7p"), 3, d)[2][1] for d in (torch.float32, BF16))
    assert b16 == torch.tensor(1 / 12, dtype=BF16).item() != f32


def test_kernel_io_takes_bf16_and_refuses_f64():
    a, b = torch.zeros(8), torch.zeros(8)
    for dtype in (torch.float32, BF16):
        sk._kernel_io(a.to(dtype), b.to(dtype), "k")
    for dtype in (torch.float64, torch.float16):
        with pytest.raises(NotImplementedError, match="D1"):
            sk._kernel_io(a.to(dtype), b.to(dtype), "k")
    c = a.to(BF16)
    with pytest.raises(ValueError, match="in place"):
        sk._kernel_io(c, c, "k")


def test_bf16_wrappers_on_the_cpu_take_the_plain_versions():
    """A bfloat16 CPU tensor takes each wrapper's plain version (no launch
    counted), in bfloat16."""
    spec = tst.make("2d5p")
    t = layouts.to_transpose_layout(torch.from_numpy(_x((8, 64), 2)).to(BF16), 8, 4)
    sk.reset_launches()
    got = sk.stencil_nd_sweep_ttile(spec, t, 2, 2, 4)
    assert sk.LAUNCHES == dict.fromkeys(sk.LAUNCHES, 0)
    assert got.dtype == BF16 and torch.equal(got, sk.stencil_nd_sweep_ttile_ref(spec, t, 2, 2, 4))
