"""The roundtrip engine (``sweep="roundtrip"``) and the Dirichlet engine
(``ops.stencil_run``) of the port against the JAX reference and the f64
oracle.

  * ``StencilProblem(..., device="cpu").run`` with a roundtrip plan equals
    the reference ``StencilProblem.run`` with the same explicit plan
    (Pallas in interpret mode) within 2e-6 in f32, on a lean matrix over
    1d3p/1d5p/2d5p/2d9p/3d7p × k∈{1,2,3} × both remainders × divisible and
    ragged steps;
  * the port's f64 roundtrip run equals the numpy f64 oracle within 1e-12
    on the full matrix;
  * within the port roundtrip equals resident bit for bit at ttile 1 and 2;
  * ``ops.stencil_run`` / ``stencil_multistep`` equal the reference's and
    ``ref.multistep_ref`` (f32 within 2e-6, and bit for bit the port's
    oracle);
  * a reference roundtrip plan dict, carried over, runs.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import api as japi
from repro.core import autotune as jtune
from repro.core import stencils as jst
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.convert import grid_from_reference, plan_from_reference
from repro_torch.core import stencils as tst
from repro_torch.core.api import StencilPlan, StencilProblem, sweep_schedule
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import stencil_kernels as sk

TOL = dict(rtol=2e-6, atol=2e-6)
SHAPES = {"1d3p": (128,), "1d5p": (96,), "2d5p": (8, 64), "2d9p": (8, 32),
          "3d7p": (4, 4, 64)}
TILES = {"1d3p": dict(vl=8, m=8), "1d5p": dict(vl=8, m=4), "2d5p": dict(vl=8, m=4, t0=4),
         "2d9p": dict(vl=8, m=4, t0=2), "3d7p": dict(vl=8, m=4, t0=4)}


def _x(shape, seed, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _plan(name, k, remainder, sweep="roundtrip", ttile=1):
    return StencilPlan(backend="pallas", sweep=sweep, k=k, remainder=remainder,
                       ttile=ttile, **TILES[name])


def _oracle(name, x, steps):
    spec = tst.make(name)
    out = x.astype(np.float64)
    for _ in range(steps):
        out = tst.numpy_apply_once(spec, out)
    return out


# lean JAX-side matrix: interpret mode costs about a second a case
@pytest.mark.parametrize("name,k,remainder,steps", [
    ("1d3p", 2, "native", 7), ("1d5p", 3, "fused", 5), ("2d5p", 2, "fused", 4),
    ("2d9p", 1, "native", 3), ("3d7p", 3, "native", 5), ("3d7p", 2, "fused", 3),
])
def test_roundtrip_matches_reference(name, k, remainder, steps):
    x = _x(SHAPES[name], 5)
    jplan = japi.StencilPlan(scheme="transpose", backend="pallas", sweep="roundtrip", k=k,
                             remainder=remainder, **TILES[name])
    want = np.asarray(japi.StencilProblem(name, SHAPES[name]).run(jnp.asarray(x), steps, jplan))
    prob = StencilProblem(name, SHAPES[name], device="cpu")
    plan = plan_from_reference(jtune.plan_to_dict(jplan))
    assert plan == _plan(name, k, remainder)
    got = prob.run(grid_from_reference(x, "cpu"), steps, plan)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_roundtrip_f64_matrix_matches_oracle(name):
    """Full stencil × k × remainder × steps matrix, f64 vs numpy."""
    x = _x(SHAPES[name], 6, np.float64)
    prob = StencilProblem(name, SHAPES[name], dtype=torch.float64, device="cpu")
    for k in (1, 2, 3):
        for remainder in ("fused", "native"):
            for steps in (2 * k, 2 * k + max(1, k - 1)):
                got = prob.run(torch.from_numpy(x), steps, _plan(name, k, remainder))
                np.testing.assert_allclose(got.numpy(), _oracle(name, x, steps),
                                           rtol=1e-12, atol=1e-12,
                                           err_msg=f"k={k} {remainder} steps={steps}")


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_roundtrip_is_bitwise_resident(name):
    x = torch.from_numpy(_x(SHAPES[name], 7))
    prob = StencilProblem(name, SHAPES[name], device="cpu")
    for k, steps in ((1, 3), (2, 7), (3, 11)):
        for remainder in ("fused", "native"):
            got = prob.run(x, steps, _plan(name, k, remainder))
            for ttile in (1, 2):
                res = prob.run(x, steps, _plan(name, k, remainder, "resident", ttile))
                assert torch.equal(got, res), (k, remainder, ttile)


def test_roundtrip_default_tile_pads_past_the_grid():
    """GPU default tile (t0 = 4 on four rows) at k=5: the axis-0 pad (two
    tiles) is wider than the grid, so the wrap-pad repeats it."""
    prob = StencilProblem("2d5p", (4, 64), device="cpu")
    x = prob.init(1)
    got = prob.run(x, 7, StencilPlan(backend="pallas", sweep="roundtrip", k=5,
                                     remainder="native"))
    assert torch.equal(got, prob.reference(x, 7))
    assert torch.equal(ops.wrap_pad(torch.arange(3), 7),
                       torch.tensor([2, 0, 1, 2, 0, 1, 2, 0, 1, 2, 0, 1, 2, 0, 1, 2, 0]))


def test_roundtrip_launch_schedule_and_remainder():
    prob = StencilProblem("3d7p", (4, 4, 64), device="cpu")
    x = prob.init(2)
    calls = []

    def step(v, n, k):
        calls.append((n, k))
        return ops.stencil_run_periodic(prob.spec, v, n, k=k, vl=8, m=4, t0=4)

    for remainder, want in (("fused", [(6, 3), (2, 1)]), ("native", [(6, 3), (2, 2)])):
        calls.clear()
        got = prob._chunked(x, 8, 3, step, remainder)
        assert calls == want
        assert torch.equal(got, prob.run(x, 8, _plan("3d7p", 3, remainder)))
        sweeps = sum(n // k for n, k in calls)
        assert sweeps == sum(n for _, n in sweep_schedule(3, 8, remainder, 1)[0])
    with pytest.raises(ValueError, match="remainder"):
        prob.run(x, 4, _plan("3d7p", 3, "tail"))
    with pytest.raises(ValueError, match="ttile"):
        prob.run(x, 4, _plan("3d7p", 2, "fused", ttile=2))
    with pytest.raises(ValueError, match="multiple of k"):
        ops.stencil_run_periodic(prob.spec, x, 5, k=2)
    sk.reset_launches()
    prob.run(x, 5, _plan("3d7p", 2, "native"))
    assert sk.LAUNCHES == dict.fromkeys(sk.LAUNCHES, 0)       # CPU: no kernel


@pytest.mark.parametrize("name,shape,tile", [
    ("1d3p", (8 * 8 * 6,), dict(vl=8, m=8)), ("1d5p", (512,), dict(vl=8, m=8)),
    ("2d5p", (16, 64), dict(vl=8, m=4, t0=4)), ("3d7p", (8, 4, 64), dict(vl=8, m=4, t0=4)),
])
def test_stencil_run_matches_reference(name, shape, tile):
    x = _x(shape, 4)
    want = np.asarray(jops.stencil_run(jst.make(name), jnp.asarray(x), steps=4, k=2,
                                       interpret=True, **tile))
    spec = tst.make(name)
    got = ops.stencil_run(spec, torch.from_numpy(x), steps=4, k=2, **tile)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    oracle = np.asarray(jref.multistep_ref(jst.make(name), jnp.asarray(x), 4))
    np.testing.assert_allclose(got.numpy(), oracle, **TOL)
    assert torch.equal(got, tref.multistep_ref(spec, torch.from_numpy(x), 4))
    one = ops.stencil_multistep(spec, torch.from_numpy(x), 2, **tile)
    assert torch.equal(one, tref.multistep_ref(spec, torch.from_numpy(x), 2))
    with pytest.raises(ValueError, match="multiple of k"):
        ops.stencil_run(spec, torch.from_numpy(x), steps=3, k=2)


def test_roundtrip_plan_dict_from_reference_runs():
    d = jtune.plan_to_dict(japi.StencilPlan(backend="pallas", sweep="roundtrip", k=3,
                                            vl=8, m=4, t0=2, remainder="native"))
    plan = plan_from_reference(d)
    prob = StencilProblem("2d9p", (8, 32), device="cpu")
    x = prob.init(3)
    assert torch.equal(prob.run(x, 7, plan), prob.reference(x, 7))
