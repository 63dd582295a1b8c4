"""Tessellate tiling in the port (``core/tessellate.py``) against the JAX
reference, on the CPU.

  * ``fit_tile`` (strict and not) equals the reference's over a grid of
    stencils, shapes and heights;
  * the port's legality proof ``numpy_tessellate_check`` passes and returns
    the reference's array exactly on the reference's cases
    (``tests/test_core_vectorize.py``);
  * ``tessellate_round`` (inner fused; transpose and dlt at 1-D, 2-D and
    3-D) is within 2e-5 of the
    reference's (its tolerance) and bit for bit the port's ``apply_steps``,
    and the caller's tensor is unchanged after a round;
  * ``tessellate_run``: the "error" remainder raises, "native" and "fused"
    are within 1e-4 of the reference's and bit for bit ``apply_steps``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import stencils as jst
from repro.core import tessellate as jtess
from repro_torch.core import stencils as tst
from repro_torch.core import tessellate as ttess

# the reference's cases, plus heat1d, heat2d and 3d27p
CASES = [("1d3p", (96,), (24,), 4), ("1d3p", (96,), (16,), 2), ("1d5p", (128,), (32,), 3),
         ("2d5p", (24, 32), (12, 16), 2), ("2d9p", (24, 32), (12, 16), 2),
         ("3d7p", (8, 8, 16), (8, 8, 8), 2), ("3d27p", (8, 8, 16), (8, 8, 8), 2),
         ("heat1d", (64,), (16,), 3), ("heat2d", (16, 32), (8, 16), 2)]


def _x(shape, seed=3):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_fit_tile_matches_reference():
    for name in tst.names():
        spec, jspec = tst.make(name), jst.make(name)
        for shape in ((7,), (12,), (64,), (96,), (100,), (128,), (24, 32), (5, 9), (8, 8, 16)):
            if len(shape) != spec.ndim:
                continue
            for height in (1, 2, 3, 4, 8):
                for strict in (False, True):
                    assert ttess.fit_tile(spec, shape, height, strict) == \
                        jtess.fit_tile(jspec, shape, height, strict), (name, shape, height, strict)


@pytest.mark.parametrize("name,shape,tile,h", CASES)
def test_legality_proof_matches_reference(name, shape, tile, h):
    x = _x(shape)
    got = ttess.numpy_tessellate_check(tst.make(name), x, tile, h)
    want = jtess.numpy_tessellate_check(jst.make(name), x, tile, h)
    np.testing.assert_array_equal(got, want)
    oracle = tst.apply_steps(tst.make(name), torch.from_numpy(x), h).numpy()
    np.testing.assert_allclose(got, oracle, rtol=2e-5, atol=2e-5)


# the reference compiles a program a case: inner fused on every case, the
# layout inners on one case a dimension
ROUND_CASES = [case + ("fused",) for case in CASES] + \
    [CASES[i] + (inner,) for i in (0, 3, 5) for inner in ("transpose", "dlt")]


@pytest.mark.parametrize("name,shape,tile,h,inner", ROUND_CASES)
def test_round_matches_reference(name, shape, tile, h, inner):
    spec = tst.make(name)
    x = _x(shape)
    xt = torch.from_numpy(x.copy())
    got = ttess.tessellate_round(spec, xt, tile, h, inner, vl=4)
    want = np.asarray(jtess.tessellate_round(jst.make(name), jnp.asarray(x), tile, h, inner, 4))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    assert torch.equal(got, tst.apply_steps(spec, xt, h))
    np.testing.assert_array_equal(xt.numpy(), x)       # the input is untouched


def test_round_int8_count_and_schedule():
    spec = tst.make("2d5p")
    masks = ttess.make_schedule(spec, (24, 32), (12, 16), 2)
    jmasks = jtess.make_schedule(jst.make("2d5p"), (24, 32), (12, 16), 2)
    assert [(st, s) for st, s, _ in masks] == [(st, s) for st, s, _ in jmasks]
    for (_, _, a), (_, _, b) in zip(masks, jmasks):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(np.broadcast_to(a.numpy(), (24, 32)),
                                          np.broadcast_to(np.asarray(b), (24, 32)))
    with pytest.raises(ValueError, match="does not divide"):
        ttess.make_schedule(spec, (24, 30), (12, 16), 2)
    with pytest.raises(ValueError, match="inner"):
        ttess.tessellate_round(spec, torch.zeros(24, 32), (12, 16), 2, inner="multiload")


@pytest.mark.parametrize("remainder", ["native", "fused"])
@pytest.mark.parametrize("inner", ["fused", "transpose", "dlt"])
@pytest.mark.parametrize("name,steps,tile,h", [
    ("1d3p", 7, (32,), 4), ("2d5p", 5, (12, 16), 2), ("3d7p", 3, (8, 8, 8), 2)])
def test_run_remainders_match_reference(name, steps, tile, h, inner, remainder):
    spec = tst.make(name)
    shape = {1: (128,), 2: (24, 32), 3: (8, 8, 16)}[spec.ndim]
    x = _x(shape, 5)
    got = ttess.tessellate_run(spec, torch.from_numpy(x), steps, tile, h, inner, 4, remainder)
    want = np.asarray(jtess.tessellate_run(jst.make(name), jnp.asarray(x), steps, tile, h,
                                           inner, 4, remainder))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    assert torch.equal(got, tst.apply_steps(spec, torch.from_numpy(x), steps))


def test_run_error_remainder_raises():
    x = _x((128,), 5)
    with pytest.raises(AssertionError):
        jtess.tessellate_run(jst.make("1d3p"), jnp.asarray(x), 7, (32,), 4)
    with pytest.raises(ValueError, match="not a multiple of height"):
        ttess.tessellate_run(tst.make("1d3p"), torch.from_numpy(x), 7, (32,), 4)
    with pytest.raises(ValueError, match="remainder"):
        ttess.tessellate_run(tst.make("1d3p"), torch.from_numpy(x), 8, (32,), 4,
                             remainder="tail")
