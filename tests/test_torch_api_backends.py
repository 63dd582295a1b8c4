"""``StencilProblem.run`` on the jnp and mxu backends and ``plan="default"``,
on the CPU, against the JAX reference's ``run`` with the same plan.

  * jnp plans: every scheme at k=1, ``multistep_fused`` blocks at k > 1
    (both remainders), tessellation with each inner scheme and both
    remainders; mxu plans (k, ttile, remainder); ``plan="default"``:
    within the reference's tolerances of its run (2e-6 at one step a
    scheme, 1e-4 multistep) — on the conformance stencils (1d3p, 2d5p,
    3d7p) every plan, on the other five the default plan, one scheme, one
    tessellation and one mxu plan;
  * within the port every jnp plan and the default plan are bit for bit the
    resident pallas run, and the mxu plans within 1e-4 of it;
  * ``default_plan()`` equals the reference's through ``plan_to_dict``;
  * the jnp backend is plain PyTorch: no launch is counted.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import api as japi
from repro.core import autotune as jtune
from repro_torch.convert import plan_from_reference
from repro_torch.core import api as tapi
from repro_torch.core.api import StencilPlan, StencilProblem
from repro_torch.kernels import stencil_kernels as sk

SHAPES = {"1d3p": (128,), "1d5p": (128,), "heat1d": (128,), "2d5p": (16, 64),
          "2d9p": (16, 64), "heat2d": (16, 64), "3d7p": (8, 4, 64), "3d27p": (8, 4, 64)}
STEPS = 5
J = japi.StencilPlan
SCHEMES = [J(scheme=s, k=1, vl=8, m=4) for s in ("multiload", "reorg", "fused", "dlt",
                                                  "transpose")]
MULTI = [J(scheme="transpose", k=3, remainder=r) for r in ("fused", "native")]
TESS = [J(scheme=s, tiling="tessellate", height=2, vl=4, remainder=r)
        for s in ("fused", "transpose", "dlt") for r in ("fused", "native")]
MXU = [J(backend="mxu", k=2, vl=8, m=4, remainder="fused"),
       J(backend="mxu", k=2, vl=8, m=4, ttile=2, remainder="native"),
       J(backend="mxu", k=3, remainder="native")]
CONFORMANCE = ("1d3p", "2d5p", "3d7p")
CASES = [(n, p) for n in CONFORMANCE for p in SCHEMES + MULTI + TESS + MXU + ["default"]] + \
    [(n, p) for n in sorted(SHAPES) if n not in CONFORMANCE
     for p in (SCHEMES[0], TESS[3], MXU[0], "default")]


def _id(case):
    name, plan = case
    if plan == "default":
        return f"{name}-default"
    return (f"{name}-{plan.backend}-{plan.scheme}-{plan.tiling}-k{plan.k}-t{plan.ttile}-"
            f"{plan.remainder}")


def _x(shape):
    return np.random.default_rng(9).standard_normal(shape).astype(np.float32)


def test_default_plan_equals_reference():
    prob = StencilProblem("2d5p", (16, 64), device="cpu")
    jprob = japi.StencilProblem("2d5p", (16, 64))
    assert tapi.plan_to_dict(prob.default_plan()) == jtune.plan_to_dict(jprob.default_plan())
    assert prob._default_tile(2) == jprob._default_tile(2)


@pytest.mark.parametrize("name,plan", CASES, ids=[_id(c) for c in CASES])
def test_run_matches_reference(name, plan):
    shape = SHAPES[name]
    x = _x(shape)
    want = np.asarray(japi.StencilProblem(name, shape).run(jnp.asarray(x), STEPS, plan))
    prob = StencilProblem(name, shape, device="cpu")
    port_plan = plan if plan == "default" else plan_from_reference(jtune.plan_to_dict(plan))
    xt = torch.from_numpy(x)
    sk.reset_launches()
    got = prob.run(xt, STEPS, port_plan)
    assert sk.LAUNCHES == dict.fromkeys(sk.LAUNCHES, 0)
    tol = 2e-6 if plan != "default" and plan.k == 1 and plan.tiling == "none" \
        and plan.backend == "jnp" else 1e-4
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)
    np.testing.assert_array_equal(xt.numpy(), x)
    resident = prob.run(xt, STEPS, StencilPlan(backend="pallas", k=2, vl=8, m=4))
    if plan != "default" and plan.backend == "mxu":
        np.testing.assert_allclose(got.numpy(), resident.numpy(), rtol=1e-4, atol=1e-4)
    else:
        assert torch.equal(got, resident)
