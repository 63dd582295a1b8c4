"""The port's main path — ``StencilProblem.run`` with a resident sweep plan —
against the JAX reference and the f64 oracle.

  * ``sweep_schedule`` equals the reference's over a (k, steps, remainder,
    ttile) grid; plan dicts round-trip between the packages;
  * the GPU ``pick_tile`` picks, honours explicit tiles and raises;
  * ``run`` on the CPU equals the reference ``StencilProblem.run`` (Pallas in
    interpret mode) within 2e-6 in f32 on a lean matrix over all eight
    registry stencils, and the port's f64 run equals the numpy f64 oracle
    within 1e-12 on the full matrix (every registry stencil × k∈{1,2,3} ×
    both remainders × ttile∈{1,2} × divisible and ragged steps);
  * within the port any ttile is bitwise equal to ttile=1.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import api as japi
from repro.core import autotune as jtune
from repro.core import stencils as jst
from repro_torch.convert import grid_from_reference, plan_from_reference, spec_from_reference
from repro_torch.core import api as tapi
from repro_torch.core import stencils as tst
from repro_torch.core.api import StencilPlan, StencilProblem
from repro_torch.kernels import ops
from repro_torch.kernels import stencil_kernels as sk

SHAPES = {"1d3p": (128,), "1d5p": (96,), "2d5p": (8, 64), "2d9p": (8, 32),
          "3d7p": (4, 4, 64), "3d27p": (4, 4, 32), "heat1d": (128,), "heat2d": (8, 64)}
TILES = {"1d3p": dict(vl=8, m=8), "1d5p": dict(vl=8, m=4), "2d5p": dict(vl=8, m=4, t0=4),
         "2d9p": dict(vl=8, m=4, t0=2), "3d7p": dict(vl=8, m=4, t0=4),
         "3d27p": dict(vl=8, m=4, t0=2), "heat1d": dict(vl=4, m=4),
         "heat2d": dict(vl=8, m=2, t0=4)}


def _x(shape, seed, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _plan(name, k, remainder, ttile):
    return StencilPlan(backend="pallas", sweep="resident", k=k, remainder=remainder,
                       ttile=ttile, **TILES[name])


def _oracle(name, x, steps):
    spec = tst.make(name)
    out = x.astype(np.float64)
    for _ in range(steps):
        out = tst.numpy_apply_once(spec, out)
    return out


def test_sweep_schedule_equals_reference():
    for k in (1, 2, 3, 4):
        for steps in (None, 0, 1, 2, 3, 5, 7, 8, 16, 17, 31):
            for remainder in ("fused", "native"):
                for ttile in (1, 2, 3, 4):
                    assert tapi.sweep_schedule(k, steps, remainder, ttile) == \
                        japi.sweep_schedule(k, steps, remainder, ttile)


@pytest.mark.parametrize("plan", [
    japi.StencilPlan(),
    japi.StencilPlan(backend="pallas", k=3, vl=8, m=4, t0=2, remainder="native", ttile=2),
    japi.StencilPlan(scheme="fused", tiling="tessellate", tile=(8, 16), height=2),
    japi.StencilPlan(backend="distributed", decomp=(2, 2), overlap=True, sweep="roundtrip"),
])
def test_plan_round_trips(plan):
    d = jtune.plan_to_dict(plan)
    port = plan_from_reference(d)
    assert dataclasses.asdict(port) == dataclasses.asdict(plan)
    assert tapi.plan_to_dict(port) == d
    assert jtune.plan_from_dict(tapi.plan_to_dict(port)) == plan
    assert [f.name for f in dataclasses.fields(StencilPlan)] == \
        [f.name for f in dataclasses.fields(japi.StencilPlan)]


def test_pick_tile():
    spec = tst.make
    assert ops.pick_tile(spec("1d3p"), (1 << 26,)) == (32, 8, None)
    assert ops.pick_tile(spec("1d5p"), (320,)) == (32, 5, None)     # any integer m <= 8
    assert ops.pick_tile(spec("2d5p"), (8192, 8192)) == (32, 8, 32)
    assert ops.pick_tile(spec("2d5p"), (12, 64)) == (32, 2, 12)
    assert ops.pick_tile(spec("3d7p"), (512, 512, 512)) == (32, 8, 16)
    assert ops.pick_tile(spec("3d7p"), (6, 4, 96)) == (32, 3, 6)
    assert ops.pick_tile(spec("3d7p"), (24, 4, 256)) == (32, 8, 12)
    # explicit tiles are honoured
    assert ops.pick_tile(spec("2d9p"), (8, 32), vl=8, m=4, t0=2) == (8, 4, 2)
    assert ops.pick_tile(spec("1d3p"), (96,), vl=4, m=3) == (4, 3, None)
    # what the reference accepts: vl falls back, m and t0 are upper bounds
    assert ops.pick_tile(spec("1d3p"), (48,)) == (16, 3, None)     # vl=32 does not divide
    assert ops.pick_tile(spec("1d5p"), (32,)) == (16, 2, None)     # at vl=32 only m=1 fits
    assert ops.pick_tile(spec("1d3p"), (80,), vl=8, m=4) == (8, 2, None)
    assert ops.pick_tile(spec("2d5p"), (8, 64), t0=3) == (32, 2, 2)
    with pytest.raises(ValueError, match=r"\(2,\)"):
        ops.pick_tile(spec("1d5p"), (2,))                 # no m >= r=2 at any vl


# lean JAX-side matrix: interpret mode costs about a second a case
@pytest.mark.parametrize("name,k,remainder,ttile,steps", [
    ("1d3p", 2, "native", 2, 7), ("1d5p", 3, "fused", 1, 5), ("2d5p", 2, "fused", 2, 9),
    ("2d9p", 1, "native", 2, 3), ("3d7p", 2, "native", 2, 7), ("3d7p", 3, "fused", 1, 4),
    ("3d27p", 2, "fused", 2, 7), ("heat1d", 3, "native", 1, 8), ("heat2d", 2, "native", 2, 9),
])
def test_run_matches_reference(name, k, remainder, ttile, steps):
    x = _x(SHAPES[name], 5)
    jplan = japi.StencilPlan(scheme="transpose", backend="pallas", sweep="resident", k=k,
                             remainder=remainder, ttile=ttile, **TILES[name])
    want = np.asarray(japi.StencilProblem(name, SHAPES[name]).run(jnp.asarray(x), steps, jplan))
    prob = StencilProblem(name, SHAPES[name], device="cpu")
    assert prob.spec == spec_from_reference(dataclasses.asdict(jst.make(name)))
    plan = plan_from_reference(jtune.plan_to_dict(jplan))
    got = prob.run(grid_from_reference(x, "cpu"), steps, plan)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-6, atol=2e-6)


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_run_f64_matrix_matches_oracle(name):
    """Full stencil × k × remainder × ttile × steps matrix, f64 vs numpy."""
    x = _x(SHAPES[name], 6, np.float64)
    prob = StencilProblem(name, SHAPES[name], dtype=torch.float64, device="cpu")
    for k in (1, 2, 3):
        for remainder in ("fused", "native"):
            for ttile in (1, 2):
                for steps in (2 * k, 2 * k + max(1, k - 1)):
                    got = prob.run(torch.from_numpy(x), steps, _plan(name, k, remainder, ttile))
                    np.testing.assert_allclose(got.numpy(), _oracle(name, x, steps),
                                               rtol=1e-12, atol=1e-12,
                                               err_msg=f"k={k} {remainder} ttile={ttile} "
                                                       f"steps={steps}")


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_ttile_is_bitwise_ttile1(name):
    x = torch.from_numpy(_x(SHAPES[name], 7))
    prob = StencilProblem(name, SHAPES[name], device="cpu")
    for k, steps in ((1, 5), (2, 9), (3, 13)):
        for remainder in ("fused", "native"):
            base = prob.run(x, steps, _plan(name, k, remainder, 1))
            for ttile in (2, 3, 4):
                assert torch.equal(prob.run(x, steps, _plan(name, k, remainder, ttile)), base)


def test_driver_donate_and_zero_steps():
    spec = tst.make("2d5p")
    x = torch.from_numpy(_x((8, 64), 8))
    want = ops.stencil_sweep_periodic(spec, x, 5, k=2, vl=8, m=4, t0=4)
    y = x.clone()
    got = ops.stencil_sweep_periodic(spec, y, 5, k=2, vl=8, m=4, t0=4, donate=True)
    assert got.data_ptr() == y.data_ptr() and torch.equal(y, want)
    assert ops.stencil_sweep_periodic(spec, x, 0) is x
    with pytest.raises(ValueError, match="remainder"):
        ops.stencil_sweep_periodic(spec, x, 3, remainder="tail")
    sk.reset_launches()
    ops.stencil_sweep_periodic(spec, x, 7, k=2, ttile=2, vl=8, m=4, t0=4)
    assert sk.LAUNCHES == dict.fromkeys(sk.LAUNCHES, 0)   # CPU: no kernel


def test_problem_device_default_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        StencilProblem("2d5p", (8, 64))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        StencilProblem("2d5p", (8, 64), device="cuda")
    assert StencilProblem("2d5p", (8, 64), device="cpu").device == torch.device("cpu")


def test_problem_init_reference_and_counts():
    prob = StencilProblem("3d7p", (4, 4, 64), device="cpu")
    a, b = prob.init(3), prob.init(3)
    assert torch.equal(a, b) and a.shape == (4, 4, 64) and a.dtype == torch.float32
    assert not torch.equal(a, prob.init(4))
    assert torch.equal(prob.reference(a, 2), tst.apply_steps(prob.spec, a, 2))
    ref = japi.StencilProblem("3d7p", (4, 4, 64))
    assert prob.model_flops(9) == ref.model_flops(9)
    assert prob.model_bytes(9, k=2) == ref.model_bytes(9, k=2)
    assert StencilProblem("3d7p", (4, 4, 64), dtype=torch.float64, device="cpu") \
        .model_bytes(9) == japi.StencilProblem("3d7p", (4, 4, 64), jnp.float64).model_bytes(9)


@pytest.mark.parametrize("plan,match", [
    (StencilPlan(backend="distributed", decomp=(2,)), "A9"),
    (StencilPlan(backend="mxu", decomp=(2,)), "A9"),
])
def test_unported_plans_raise(plan, match):
    prob = StencilProblem("1d3p", (128,), device="cpu")
    with pytest.raises(NotImplementedError, match=match):
        prob.run(prob.init(0), 4, plan)


def test_invalid_plans_raise():
    prob = StencilProblem("1d3p", (128,), device="cpu")
    x = prob.init(0)
    with pytest.raises(ValueError, match="unknown plan"):
        prob.run(x, 4, "fastest")
    with pytest.raises(ValueError, match="ttile"):
        prob.run(x, 4, StencilPlan(backend="pallas", sweep="roundtrip", ttile=2))
    with pytest.raises(ValueError, match="overlap"):
        prob.run(x, 4, StencilPlan(backend="pallas", overlap=True))
    with pytest.raises(ValueError, match="shape"):
        prob.run(torch.zeros(64), 4, StencilPlan(backend="pallas"))
