"""The port's autotuner (``repro_torch.core.autotune``) against the
reference's (``repro.core.autotune``), on the CPU.

  * ``candidate_plans`` for jnp and mxu equals the reference's, in order,
    on all eight registry stencils, two shapes each, ``steps`` ∈ {None, 5,
    7, 16}; for pallas the two lists differ by exactly the ttile plans that
    the port's route gate and the reference's VMEM gate judge differently;
  * ``normalize_steps``, ``_auto_measure_steps``, ``_pallas_pairs``,
    ``_layout_pairs`` and ``mxu_plan_legal`` agree on a grid of inputs;
  * ``tune`` with one stub timer (a function of the plan's dict) picks the
    reference's plan and measures the same plans; a second call is a cache
    hit with no timer call; ``force=True`` measures again;
  * the reference's tuner, cache and invalidation tests
    (``tests/test_autotune.py``, ``tests/test_plan_cache_invalidation.py``)
    against the port's modules, a kernel-source edit staling the
    fingerprint, and the departures named in the module's docstring;
  * ``StencilProblem.run(x, 5, plan="auto")`` caches one entry keyed
    ``…|s5|<fingerprint>``, is bit for bit the explicit run of the plan it
    cached, and matches the reference's ``run``.

Reference ``tune`` calls run with ``REPRO_PLAN_AUDIT=0``: its audit gate
needs ``jax.core.ClosedJaxpr``, which this jax lacks (ROADMAP C).
"""
import dataclasses
import hashlib
import json
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import api as japi
from repro.core import autotune as jtune
from repro.core import stencils as jstencils
from repro_torch.core import autotune, stencils, vectorize
from repro_torch.core.api import StencilPlan, StencilProblem
from repro_torch.kernels import build
from repro_torch.kernels import stencil_kernels as sk

NAMES = sorted(stencils.names())
SHAPES = {1: ((128,), (160,)), 2: ((16, 64), (24, 96)), 3: ((8, 4, 64), (8, 8, 48))}
STEPS = (None, 5, 7, 16)
CPU = torch.device("cpu")


@pytest.fixture()
def cache_path(tmp_path, monkeypatch):
    path = str(tmp_path / "plans.json")
    monkeypatch.setattr(autotune, "_caches", {})
    monkeypatch.setattr(jtune, "_caches", {})
    monkeypatch.setenv("REPRO_PLAN_AUDIT", "0")
    return path


def _dicts(plans):
    return [dict(autotune.plan_to_dict(p)) for p in plans]


def _jdicts(plans):
    return [jtune.plan_to_dict(p) for p in plans]


def _ref(plan):
    return jtune.plan_from_dict(autotune.plan_to_dict(plan))


def _stub(fn, plan):
    """A timer that is a function of the plan's dict alone, no two plans alike."""
    d = json.dumps(dataclasses.asdict(plan), sort_keys=True, default=list)
    return 1.0 + int(hashlib.sha256(d.encode()).hexdigest()[:12], 16) / 2 ** 48


# ---------------------------------------------------------------------------
# candidate pools against the reference
# ---------------------------------------------------------------------------

CAND_CASES = [(n, i, s) for n in NAMES for i in (0, 1) for s in STEPS]


@pytest.mark.parametrize("backend", ["jnp", "mxu"])
@pytest.mark.parametrize("name,which,steps", CAND_CASES,
                         ids=[f"{n}-{i}-s{s}" for n, i, s in CAND_CASES])
def test_jnp_and_mxu_candidates_equal_reference(name, which, steps, backend):
    spec = stencils.make(name)
    shape = SHAPES[spec.ndim][which]
    got = autotune.candidate_plans(spec, shape, torch.float32, backend, steps, device=CPU)
    want = jtune.candidate_plans(jstencils.make(name), shape, jnp.float32, backend, steps,
                                 n_devices=1)
    assert got and _dicts(got) == _jdicts(want)


def _vmem_ok(spec_name, shape, plan):
    jspec = jstencils.make(spec_name)
    depth = plan.ttile * plan.k
    return jtune._ttile_window_bytes(jspec, shape, depth, plan.vl, plan.m,
                                     plan.t0) <= jtune.TTILE_VMEM_BUDGET


def _route_ok(spec_name, shape, plan, steps):
    return autotune.pallas_routes_legal(
        stencils.make(spec_name), shape, plan.vl, plan.m, plan.t0, plan.sweep, k=plan.k,
        steps=steps, remainder=plan.remainder, ttile=plan.ttile)


PALLAS_CASES = [(n, SHAPES[stencils.make(n).ndim][0], s) for n in NAMES for s in STEPS] + [
    ("1d3p", (1 << 26,), 16), ("2d5p", (8192, 8192), 16), ("3d7p", (512, 512, 512), 16),
    ("3d7p", (512, 512, 512), 7), ("3d27p", (256, 256, 256), None), ("2d9p", (4096, 4096), 5)]


@pytest.mark.parametrize("name,shape,steps", PALLAS_CASES,
                         ids=[f"{n}-{'x'.join(map(str, sh))}-s{s}" for n, sh, s in PALLAS_CASES])
def test_pallas_candidates_differ_only_where_the_gates_do(name, shape, steps):
    """The port's pallas pool is the reference's, in its order, except the
    ttile plans its route gate admits and the VMEM window refuses (and the
    reverse)."""
    spec = stencils.make(name)
    got = autotune.candidate_plans(spec, shape, torch.float32, "pallas", steps, device=CPU)
    want = [autotune.plan_from_dict(d) for d in _jdicts(jtune.candidate_plans(
        jstencils.make(name), shape, jnp.float32, "pallas", steps, n_devices=1))]
    extra = [p for p in got if p not in want]
    missing = [p for p in want if p not in got]
    for p in extra:
        assert p.ttile > 1 and _route_ok(name, shape, p, steps) and \
            not _vmem_ok(name, shape, p), p
    for p in missing:
        assert p.ttile > 1 and _vmem_ok(name, shape, p) and \
            not _route_ok(name, shape, p, steps), p
    assert [p for p in got if p not in extra] == [p for p in want if p not in missing]
    if spec.ndim == 3 and shape[0] >= 256:
        assert extra, "the VMEM window refuses every 3-D ttile plan at size"


def test_pallas_pool_sizes_at_the_smoke_grids():
    """The reference enumerates 132 / 253 / 132 pallas plans at 1d3p 2^26,
    2d5p 8192², 3d7p 512³ (steps=16); the port adds the ttile plans its
    routes run."""
    sizes = {}
    for name, shape in (("1d3p", (1 << 26,)), ("2d5p", (8192, 8192)),
                        ("3d7p", (512, 512, 512))):
        spec = stencils.make(name)
        sizes[name] = (len(jtune.candidate_plans(jstencils.make(name), shape, jnp.float32,
                                                 "pallas", 16, n_devices=1)),
                       len(autotune.candidate_plans(spec, shape, torch.float32, "pallas",
                                                    16, device=CPU)))
    assert sizes == {"1d3p": (132, 132), "2d5p": (253, 264), "3d7p": (132, 264)}


# ---------------------------------------------------------------------------
# helpers and gates against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("steps", [None, 0, 1, 2, 3, 4, 5, 7, 8, 11, 12, 16, 17, 100, 10001])
def test_step_helpers_equal_reference(steps):
    assert autotune.normalize_steps(steps) == jtune.normalize_steps(steps)
    if steps != 0:
        assert autotune._auto_measure_steps(steps) == jtune._auto_measure_steps(steps)
    assert autotune._BLOCK_LCM == jtune._BLOCK_LCM


@pytest.mark.parametrize("r", [1, 2, 3])
def test_pair_helpers_equal_reference(r):
    for n in (8, 12, 48, 64, 96, 100, 128, 160, 256, 768, 1000, 4096, 1 << 20, 3 << 24):
        assert autotune._pallas_pairs(n, r) == jtune._pallas_pairs(n, r), n
        assert autotune._layout_pairs(n, r) == jtune._layout_pairs(n, r), n


MXU_SHAPES = {"1d3p": (256,), "1d5p": (96,), "2d5p": (16, 64), "2d9p": (8, 48),
              "3d7p": (4, 4, 64), "3d27p": (4, 8, 32), "heat1d": (128,), "heat2d": (8, 32)}


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float64,
                                   torch.float16])
def test_mxu_gate_equals_reference(name, dtype):
    spec, jspec, shape = stencils.make(name), jstencils.make(name), MXU_SHAPES[name]
    jdtype = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
              torch.float64: jnp.float64, torch.float16: jnp.float16}[dtype]
    seen = set()
    for vl in (1, 2, 4, 8, 16, 32):
        for m in (1, 2, 3, 4, 8, 16):
            for k in (None, 1, 2, 4, 8):
                for steps in (None, 3, 7, 16):
                    for rem in ("fused", "native"):
                        for tt in (1, 2, 4):
                            got = autotune.mxu_plan_legal(spec, shape, vl, m, dtype, k=k,
                                                          steps=steps, remainder=rem,
                                                          ttile=tt, device=CPU)
                            want = jtune.mxu_plan_legal(jspec, shape, vl, m, jdtype, k=k,
                                                        steps=steps, remainder=rem,
                                                        ttile=tt, n_devices=1)
                            assert got == want, (vl, m, k, steps, rem, tt)
                            seen.add(got)
    assert seen == ({True, False} if dtype != torch.float16 else {False})


@pytest.mark.parametrize("name", NAMES)
def test_pallas_gate_equals_reference_off_ttile(name):
    """At ttile 1 the port's pallas gate is the reference's on small grids."""
    spec, jspec = stencils.make(name), jstencils.make(name)
    for shape in SHAPES[spec.ndim]:
        for vl in (1, 2, 4, 8, 16):
            for m in (1, 2, 3, 4, 8):
                for t0 in (None, 1, 2, 4, 8):
                    for sweep in ("resident", "roundtrip", "bogus"):
                        for k in (None, 1, 2, 4, 16):
                            for steps, rem in ((None, "fused"), (7, "native"), (12, "native")):
                                args = (shape, vl, m, t0, sweep)
                                kw = dict(k=k, steps=steps, remainder=rem)
                                assert autotune.pallas_plan_legal(spec, *args, **kw, device=CPU) \
                                    == jtune.pallas_plan_legal(jspec, *args, **kw), (args, kw)


def test_mxu_gate_bounds_card_memory(monkeypatch):
    """On the card the operand (n_off copies of the grid) and
    ``MXU_EXTRA_COPIES`` more must fit ``MEMORY_SHARE`` of the free memory;
    on the CPU the gate is the reference's."""
    from repro_torch.core import matrixize
    spec, shape = stencils.make("3d7p"), (512, 512, 512)
    cuda = torch.device("cuda")
    n_off = matrixize.operator(spec, 8, 8, 2).n_off
    assert n_off == 23
    need = (n_off + autotune.MXU_EXTRA_COPIES) * 512 ** 3 * 4
    for free, ok in ((80 << 30, True), (int(need / autotune.MEMORY_SHARE) - 1, False)):
        monkeypatch.setattr(autotune, "_free_bytes", lambda dev, free=free: free)
        assert autotune.mxu_plan_legal(spec, shape, 8, 8, torch.float32, k=2,
                                       device=cuda) == ok
    assert autotune.mxu_plan_legal(spec, shape, 8, 8, torch.float32, k=2, device=CPU)
    assert jtune.mxu_plan_legal(jstencils.make("3d7p"), shape, 8, 8, jnp.float32, k=2)
    # a depth-8 band at B=8 passes the operator budget but not the memory
    monkeypatch.setattr(autotune, "_free_bytes", lambda dev: 80 << 30)
    assert autotune.mxu_plan_legal(spec, shape, 4, 2, k=4, ttile=2, device=CPU)
    assert not autotune.mxu_plan_legal(spec, shape, 4, 2, k=4, ttile=2, device=cuda)


def test_route_gate_refuses_what_the_kernels_raise_on():
    """``pallas_routes_legal`` refuses a plan whose launch the wrappers
    would raise on: the register kernels' column limit off their fixed
    forms, and a far-reach launch no tile fits; a reach-2 sweep of any
    depth takes the register kernels' launches, a deep reach-5 sweep the
    far-reach kernel's."""
    s1 = stencils.make("1d3p")
    # 1-D at m=3: sub-columns of 1, 2^33 / 24 blocks · 8 · 3 >= 2^30 columns
    assert not autotune.pallas_routes_legal(s1, (1 << 33,), 8, 3, None, k=2)
    assert autotune.pallas_routes_legal(s1, (1 << 33,), 8, 8, None, k=2)
    s2 = stencils.make("2d5p")
    # 2-D any-vl form past 2^30 columns a row; vl=32, m=8 float32 is the fixed form
    assert not autotune.pallas_routes_legal(s2, (8, 1 << 33), 8, 8, 8, k=2)
    assert autotune.pallas_routes_legal(s2, (8, 1 << 33), 32, 8, 8, k=2)
    assert not autotune.pallas_routes_legal(s2, (8, 1 << 33), 32, 8, 8, k=2,
                                            dtype=torch.bfloat16)
    star = stencils.StencilSpec("star2d_r2", 2, 2, "star", stencils._star_taps(2, 2))
    assert sk.sweep2d_route(8, 8, 4, 2, len(star.taps)) == "warp"
    assert autotune.pallas_routes_legal(star, (64, 4096), 8, 8, 32, k=4)
    assert autotune.pallas_routes_legal(star, (64, 4096), 8, 8, 32, k=16, ttile=4)
    assert autotune.ttile_plan_legal(
        star, (256, 4096), StencilPlan(backend="pallas", k=16, ttile=4, vl=8, m=8, t0=32))
    # reach 2 at 2-D and 3-D on the register kernels' any-vl form only:
    # past 2^30 columns a row even at vl=32, m=8 float32
    assert not autotune.pallas_routes_legal(star, (8, 1 << 33), 32, 8, 8, k=2)
    star3 = stencils.StencilSpec("star3d_r2", 3, 2, "star", stencils._star_taps(3, 2))
    assert sk.sweep3d_route(8, 8, 8, 2, len(star3.taps)) == "stream"
    assert autotune.pallas_routes_legal(star3, (32, 32, 512), 8, 8, 16, k=4, ttile=2)
    star5 = stencils.StencilSpec("star2d_r5", 2, 5, "star", stencils._star_taps(2, 5))
    assert sk.sweep2d_route(8, 8, 4, 5, len(star5.taps)) == "far"
    assert autotune.pallas_routes_legal(star5, (64, 4096), 8, 8, 32, k=4)
    # a deep reach-5 sweep is consecutive far-reach launches (it raised
    # before them), and legal
    assert sk.far_launches(2, 8, 64, 5, len(star5.taps)) == ((8, 1, 1),) * 64
    assert autotune.pallas_routes_legal(star5, (64, 4096), 8, 8, 32, k=16, ttile=4)
    assert autotune.ttile_plan_legal(
        star5, (512, 4096), StencilPlan(backend="pallas", k=16, ttile=4, vl=8, m=8, t0=32))
    # (the reference's rule: the depth-64 halo slope of reach 5 exceeds 256 rows)
    assert not autotune.ttile_plan_legal(
        star5, (256, 4096), StencilPlan(backend="pallas", k=16, ttile=4, vl=8, m=8, t0=32))
    # where one step of the far-reach kernel fits no tile, the gate refuses
    star32 = stencils.StencilSpec("star3d_r32", 3, 32, "star", stencils._star_taps(3, 32))
    with pytest.raises(ValueError, match="shared memory"):
        sk.far_launches(3, 32, 1, 32, len(star32.taps))
    assert not autotune.pallas_routes_legal(star32, (64, 64, 1024), 1, 32, 32, k=1)
    # the roundtrip engine sweeps the padded grid
    assert autotune.pallas_routes_legal(s1, (4096,), 8, 8, None, "roundtrip", k=4)
    # 1-D at r > M (1d5p at odd m) and past 32·M // r: the warp kernel's
    # consecutive launches, under the same column limit off m = M
    s5 = stencils.make("1d5p")
    assert sk.sweep1d_route(32, 5, 64, 2, len(s5.taps)) == "warp"
    assert autotune.pallas_routes_legal(s5, (800,), 32, 5, None, k=16, ttile=4)
    assert autotune.pallas_routes_legal(s5, (800,), 32, 5, None, "roundtrip", k=16)
    assert not autotune.pallas_routes_legal(s5, (1 << 33,), 8, 5, None, k=16, ttile=4)
    assert autotune.pallas_routes_legal(s1, (1 << 33,), 8, 1, None, k=16, ttile=4)


def test_pallas_gate_on_the_card_takes_the_kernels_dtypes():
    spec = stencils.make("1d3p")
    for dtype, ok in ((torch.float32, True), (torch.bfloat16, True), (torch.float64, False)):
        assert autotune.pallas_plan_legal(spec, (256,), 8, 8, dtype=dtype,
                                          device="cuda") == ok
        assert autotune.pallas_plan_legal(spec, (256,), 8, 8, dtype=dtype, device=CPU)


# ---------------------------------------------------------------------------
# tune against the reference
# ---------------------------------------------------------------------------

TUNE_CASES = [("1d3p", (256,), None), ("1d5p", (96,), 16), ("2d5p", (16, 64), 5),
              ("heat2d", (8, 32), 7), ("3d7p", (8, 8, 64), 7), ("3d27p", (4, 8, 32), None)]


@pytest.mark.parametrize("name,shape,steps", TUNE_CASES)
def test_tune_picks_and_measures_as_reference(cache_path, tmp_path, monkeypatch, name, shape,
                                              steps):
    consts = str(tmp_path / "consts.json")
    monkeypatch.setenv("REPRO_TORCH_ROOFLINE_CONSTANTS", consts)
    monkeypatch.setenv("REPRO_ROOFLINE_CONSTANTS", consts)
    calls = []

    def timer(fn, plan):
        calls.append(plan)
        return _stub(fn, plan)

    want = jtune.tune(japi.StencilProblem(name, shape), steps=steps,
                      cache_path=str(tmp_path / "ref.json"), timer=_stub, max_measure=500)
    prob = StencilProblem(name, shape, device="cpu")
    got = autotune.tune(prob, steps=steps, cache_path=cache_path, timer=timer,
                        max_measure=500)
    assert autotune.plan_to_dict(got.plan) == jtune.plan_to_dict(want.plan)
    assert not got.cached and got.n_candidates == want.n_candidates
    key = lambda m: json.dumps(m["plan"], sort_keys=True)      # noqa: E731
    assert sorted(map(key, got.measurements)) == sorted(map(key, want.measurements))
    assert got.seconds_per_step == pytest.approx(want.seconds_per_step)
    assert (got.n_pruned_static, got.audit_seconds, got.pruned, got.failed) == (0, 0.0, [], [])
    # a second call is a cache hit: the timer is never called
    n = len(calls)
    again = autotune.tune(prob, steps=steps, cache_path=cache_path, timer=timer,
                          max_measure=500)
    assert again.cached and again.plan == got.plan and len(calls) == n
    # force=True measures again
    forced = autotune.tune(prob, steps=steps, cache_path=cache_path, timer=timer,
                           max_measure=500, force=True)
    assert not forced.cached and len(calls) == 2 * n and forced.plan == got.plan
    # the record is the reference's format, with the port's failures beside it
    rec = json.load(open(cache_path))["entries"][got.key]
    jrec = json.load(open(str(tmp_path / "ref.json")))["entries"][want.key]
    assert set(rec) == set(jrec) | {"failed"} and rec["failed"] == []
    assert got.key.split("|")[:4] == want.key.split("|")[:4]
    assert got.key.split("|")[4] == "cpux1"


def test_record_and_key_format(cache_path):
    prob = StencilProblem("2d5p", (16, 64), device="cpu")
    res = autotune.tune(prob, steps=5, cache_path=cache_path, timer=_stub)
    assert res.key == "|".join(["2d5p", "16x64", "float32", "auto", "cpux1", "s5",
                                autotune.code_fingerprint()])
    raw = json.load(open(cache_path))
    assert raw["version"] == autotune.CACHE_VERSION == jtune.CACHE_VERSION == 2
    rec = raw["entries"][res.key]
    assert rec["fingerprint"] == autotune.code_fingerprint()
    assert (rec["n_pruned_static"], rec["audit_seconds"], rec["pruned"]) == (0, 0.0, [])
    bf16 = StencilProblem("2d5p", (16, 64), dtype=torch.bfloat16, device="cpu")
    assert "|bfloat16|" in autotune.tune(bf16, cache_path=cache_path, timer=_stub).key


# ---------------------------------------------------------------------------
# the reference's tuner tests, against the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,shape", [("1d3p", (128,)), ("1d5p", (256,)), ("2d5p", (32, 64)),
                                        ("3d7p", (8, 8, 64))])
def test_candidates_are_legal(name, shape):
    spec = stencils.make(name)
    cands = autotune.candidate_plans(spec, shape, device=CPU)
    assert {p.backend for p in cands} == {"jnp", "pallas", "mxu"}
    n = shape[-1]
    for p in cands:
        if p.backend == "pallas":
            assert autotune.pallas_plan_legal(spec, shape, p.vl, p.m, p.t0, p.sweep,
                                              ttile=p.ttile), p
        elif p.backend == "mxu":
            assert autotune.mxu_plan_legal(spec, shape, p.vl, p.m, k=p.k, ttile=p.ttile), p
        elif p.scheme in ("transpose", "dlt") and p.k == 1 and p.tiling == "none":
            m = p.m or (n // p.vl if p.scheme == "dlt" else p.vl)
            assert n % (p.vl * m) == 0 and m >= spec.r, p
        if p.tiling == "tessellate":
            h = p.height or p.k
            for dim, t in zip(shape, p.tile):
                assert dim % t == 0 and t >= 2 * h * spec.r + 1, p
    assert StencilPlan(scheme="transpose", k=2, vl=8) == \
        StencilProblem(name, shape, device="cpu").default_plan()


def test_every_jnp_candidate_runs_and_is_correct():
    prob = StencilProblem("2d5p", (16, 32), device="cpu")
    x = prob.init(0)
    want = prob.reference(x, 3)
    for p in autotune.candidate_plans(prob.spec, prob.shape, backend="jnp", steps=3,
                                      device=CPU):
        torch.testing.assert_close(prob.run(x, 3, p), want, rtol=2e-5, atol=2e-5, msg=str(p))


def test_pallas_and_mxu_candidates_run_and_are_correct():
    for name, shape in [("1d3p", (32,)), ("2d5p", (8, 64)), ("3d7p", (8, 4, 32))]:
        prob = StencilProblem(name, shape, device="cpu")
        x = prob.init(0)
        want = prob.reference(x, 3)
        cands = autotune.candidate_plans(prob.spec, shape, backend="pallas", steps=3,
                                         device=CPU)
        assert {p.remainder for p in cands if p.k > 1} == {"fused", "native"}
        resident = prob.run(x, 3, StencilPlan(backend="pallas", k=1, vl=8, m=4,
                                              t0=cands[0].t0))
        for p in cands[::5] + cands[-1:]:
            assert torch.equal(prob.run(x, 3, p), resident), p
        torch.testing.assert_close(resident, want, rtol=2e-5, atol=2e-5)
        for p in autotune.candidate_plans(prob.spec, shape, backend="mxu", steps=3,
                                          device=CPU)[::3]:
            torch.testing.assert_close(prob.run(x, 3, p), want, rtol=1e-4, atol=1e-4)


def test_pallas_pool_covers_nd_and_non_power_of_two_blocks():
    cands = autotune.candidate_plans(stencils.make("2d5p"), (32, 64), backend="pallas",
                                     device=CPU)
    assert cands and all(p.backend == "pallas" for p in cands)
    assert all(p.t0 is not None and 32 % p.t0 == 0 for p in cands)
    cands = autotune.candidate_plans(stencils.make("1d3p"), (160,), backend="pallas",
                                     device=CPU)
    assert any((p.vl * p.m) & (p.vl * p.m - 1) for p in cands)
    assert all(160 % (p.vl * p.m) == 0 for p in cands)


def test_pallas_legality_gate_rejects_bad_blocks():
    spec1, spec2 = stencils.make("1d5p"), stencils.make("2d5p")
    assert not autotune.pallas_plan_legal(spec1, (160,), 8, 6)
    assert not autotune.pallas_plan_legal(spec1, (160,), 8, 1)
    assert not autotune.pallas_plan_legal(spec2, (30, 64), 8, 4, t0=4)
    assert not autotune.pallas_plan_legal(spec2, (32, 64), 8, 4, t0=None)
    assert not autotune.pallas_plan_legal(spec1, (128,), 8, 8, sweep="bogus")
    assert autotune.pallas_plan_legal(spec1, (160,), 8, 5)
    assert autotune.pallas_plan_legal(spec2, (32, 64), 8, 4, t0=4)


def test_pallas_pool_fans_out_along_sweep_and_ttile_axes():
    from repro_torch.roofline.stencil import estimate_plan_time
    for name, shape in [("1d3p", (2048,)), ("2d5p", (32, 64))]:
        spec = stencils.make(name)
        cands = autotune.candidate_plans(spec, shape, backend="pallas", steps=16, device=CPU)
        assert {p.sweep for p in cands} == {"resident", "roundtrip"}
        assert {p.ttile for p in cands if p.sweep == "resident"} >= {1, 2, 4}
        assert all(p.ttile == 1 for p in cands if p.sweep == "roundtrip")
        keys = {(p.vl, p.m, p.t0, p.k, p.remainder, p.sweep) for p in cands}
        for p in cands:
            twin = "roundtrip" if p.sweep == "resident" else "resident"
            assert (p.vl, p.m, p.t0, p.k, p.remainder, twin) in keys, p
            if p.ttile > 1:
                assert autotune.ttile_plan_legal(spec, shape, p, steps=16), p
            if p.sweep == "resident" and p.ttile == 1:
                rt = dataclasses.replace(p, sweep="roundtrip")
                assert estimate_plan_time(spec, shape, 4, p, steps=16) < \
                    estimate_plan_time(spec, shape, 4, rt, steps=16), p


def test_ttile_legality_gate():
    spec = stencils.make("1d3p")
    base = StencilPlan(scheme="transpose", k=2, vl=8, m=8, backend="pallas", sweep="resident")
    tiled = dataclasses.replace(base, ttile=4)
    assert autotune.ttile_plan_legal(spec, (2048,), base)
    assert autotune.ttile_plan_legal(spec, (2048,), tiled, steps=16)
    assert not autotune.ttile_plan_legal(spec, (2048,), tiled, steps=6)
    assert not autotune.ttile_plan_legal(spec, (2048,), dataclasses.replace(tiled,
                                                                            sweep="roundtrip"))
    assert not autotune.ttile_plan_legal(spec, (2048,), StencilPlan(scheme="fused", k=2,
                                                                    ttile=2))
    spec2 = stencils.make("2d5p")
    deep = StencilPlan(scheme="transpose", k=2, vl=8, m=4, t0=4, backend="pallas",
                       sweep="resident", ttile=4)
    assert not autotune.ttile_plan_legal(spec2, (4, 64), deep)
    assert autotune.ttile_plan_legal(spec2, (64, 64), deep)
    # no VMEM window: a deep tile on a fat block is legal where the routes run it
    fat = dataclasses.replace(base, vl=128, m=8, ttile=4)
    spec3, big3 = stencils.make("3d7p"), (512, 512, 512)
    plan3 = StencilPlan(backend="pallas", k=4, ttile=4, vl=8, m=8, t0=8)
    assert autotune.ttile_plan_legal(spec, (1 << 20,), fat)
    assert autotune.ttile_plan_legal(spec3, big3, plan3, steps=16)
    assert not jtune.ttile_plan_legal(jstencils.make("3d7p"), big3, _ref(plan3), steps=16)
    with pytest.raises(NotImplementedError, match="A9"):
        autotune.ttile_plan_legal(spec, (256,), StencilPlan(scheme="fused", k=2,
                                                            backend="distributed",
                                                            decomp=(8,), ttile=4))


def test_native_remainder_gate_is_schedule_aware():
    spec = stencils.make("1d3p")
    assert autotune.pallas_plan_legal(spec, (2048,), 8, 8, None, "resident", k=16, steps=12,
                                      remainder="native")
    spec2 = stencils.make("2d5p")
    for p in autotune.candidate_plans(spec2, (8, 64), backend="pallas", steps=7, device=CPU):
        assert autotune._schedule_max_depth(p.k, 7, p.remainder, p.ttile) * spec2.r <= 8, p


def test_distributed_backend_raises_naming_a9():
    spec = stencils.make("1d3p")
    with pytest.raises(NotImplementedError, match="A9"):
        autotune.candidate_plans(spec, (256,), backend="distributed", device=CPU)
    with pytest.raises(NotImplementedError, match="A9"):
        autotune.mxu_plan_legal(spec, (256,), 8, 8, decomp=(2,))
    with pytest.raises(ValueError, match="unknown backend"):
        autotune.candidate_plans(spec, (256,), backend="tpu", device=CPU)


def test_cpu_budget_gate_never_gates_on_the_card(monkeypatch):
    """A CPU problem's auto pool leaves pallas out above
    ``INTERPRET_MAX_POINTS`` (the plain versions are slow to measure); a
    card's never does, and the ranking carries no interpret penalty."""
    spec = stencils.make("1d3p")
    big = (autotune.INTERPRET_MAX_POINTS * 2,)
    auto = autotune.candidate_plans(spec, big, device=CPU)
    assert auto and {p.backend for p in auto} == {"jnp", "mxu"}
    assert autotune.candidate_plans(spec, big, backend="pallas", device=CPU)
    monkeypatch.setattr(autotune, "_free_bytes", lambda dev: 80 << 30)
    card = autotune.candidate_plans(spec, big, device="cuda")
    assert {p.backend for p in card} == {"jnp", "pallas", "mxu"}
    assert not hasattr(autotune, "INTERPRET_PENALTY")
    p = next(p for p in card if p.backend == "pallas")
    from repro_torch.roofline.stencil import estimate_plan_time
    assert autotune._rank_time(spec, big, 4, p, None) == estimate_plan_time(spec, big, 4, p)


def test_per_steps_remainder_axis():
    spec = stencils.make("1d3p")
    assert all(p.remainder == "fused"
               for p in autotune.candidate_plans(spec, (128,), steps=8, device=CPU))
    ragged = autotune.candidate_plans(spec, (128,), steps=5, device=CPU)
    assert {p.remainder for p in ragged if p.backend == "pallas" and p.k == 2} == \
        {"fused", "native"}
    assert {p.remainder for p in ragged
            if p.backend == "jnp" and p.k == 2 and p.tiling == "none"} == {"fused"}


def test_unified_pool_measures_every_backend(cache_path):
    prob = StencilProblem("1d3p", (128,), device="cpu")
    seen = []

    def pallas_wins(fn, plan):
        seen.append(plan)
        return 0.001 if plan.backend == "pallas" else 1.0

    res = autotune.tune(prob, cache_path=cache_path, timer=pallas_wins)
    assert {p.backend for p in seen} == {"jnp", "pallas", "mxu"}
    assert res.plan.backend == "pallas"
    res2 = autotune.tune(prob, cache_path=cache_path, timer=pallas_wins)
    assert res2.cached and res2.plan.backend == "pallas"


def test_backend_restriction_is_honored(cache_path):
    prob = StencilProblem("1d3p", (128,), device="cpu")
    for backend in ("jnp", "pallas", "mxu"):
        res = autotune.tune(prob, backend=backend, cache_path=cache_path,
                            timer=lambda fn, p: 1.0)
        assert all(m["plan"]["backend"] == backend for m in res.measurements)


def test_default_plan_always_in_measured_pool(cache_path):
    prob = StencilProblem("2d5p", (32, 64), device="cpu")
    seen = []
    autotune.tune(prob, cache_path=cache_path, timer=lambda fn, p: (seen.append(p), 1.0)[1],
                  max_measure=3)
    assert prob.default_plan() in seen


def test_per_steps_key_separates_tunings(cache_path):
    prob = StencilProblem("1d3p", (128,), device="cpu")
    r5 = autotune.tune(prob, steps=5, cache_path=cache_path, timer=lambda fn, p: 1.0)
    rg = autotune.tune(prob, cache_path=cache_path, timer=lambda fn, p: 1.0)
    assert r5.key != rg.key
    assert autotune.tune(prob, steps=5, cache_path=cache_path, timer=lambda fn, p: 1.0).cached
    assert autotune.tune(prob, cache_path=cache_path, timer=lambda fn, p: 1.0).cached


def test_measure_window_does_not_scale_with_steps(cache_path):
    prob = StencilProblem("1d3p", (128,), device="cpu")
    timer = lambda fn, p: 100.0                          # noqa: E731
    assert autotune.tune(prob, steps=100, cache_path=cache_path,
                         timer=timer).seconds_per_step == pytest.approx(100.0 / 4)
    assert autotune.tune(prob, steps=5, cache_path=cache_path,
                         timer=timer).seconds_per_step == pytest.approx(100.0 / 5)
    assert autotune.tune(prob, steps=10001, cache_path=cache_path,
                         timer=timer).seconds_per_step == pytest.approx(100.0 / 5)


def test_divisible_steps_collapse_to_generic_key(cache_path):
    prob = StencilProblem("1d3p", (128,), device="cpu")
    timer = lambda fn, p: 1.0                            # noqa: E731
    r8 = autotune.tune(prob, steps=8, cache_path=cache_path, timer=timer)
    assert not r8.cached and "|s*|" in r8.key
    for steps in (12, 16, None):
        assert autotune.tune(prob, steps=steps, cache_path=cache_path, timer=timer).cached
    assert autotune.cached_plan(prob, steps=12, cache_path=cache_path) is not None


def test_injected_timer_failures_are_skipped_and_recorded(cache_path):
    prob = StencilProblem("1d3p", (256,), device="cpu")

    def flaky(fn, plan):
        if plan.k == 1:
            raise RuntimeError("boom")
        return 1.0

    res = autotune.tune(prob, cache_path=cache_path, timer=flaky)
    assert res.plan.k > 1 and res.failed
    assert all(f["error"] == "RuntimeError: boom" and f["plan"]["k"] == 1 for f in res.failed)
    rec = json.load(open(cache_path))["entries"][res.key]
    assert rec["failed"] == res.failed


def test_refused_plans_are_skipped_other_errors_propagate(cache_path, monkeypatch):
    """A plan the port's own checks refuse (ValueError, NotImplementedError
    from ``problem.run``) is skipped and recorded; any other error of a
    run — a CUDA error, a failed kernel build — stops the tuning."""
    prob = StencilProblem("1d3p", (256,), device="cpu")
    run = StencilProblem.run

    def refusing(self, x, steps, plan="auto"):
        if plan.backend == "mxu":
            raise NotImplementedError("no mxu here")
        if plan.backend == "pallas" and plan.ttile > 1:
            raise ValueError("no deep tiles here")
        return run(self, x, steps, plan)

    def timer(fn, plan):
        fn()
        return 1.0 if plan.backend == "jnp" else 0.5

    monkeypatch.setattr(StencilProblem, "run", refusing)
    res = autotune.tune(prob, cache_path=cache_path, timer=timer, max_measure=500)
    kinds = {f["error"].split(":")[0] for f in res.failed}
    assert kinds == {"NotImplementedError", "ValueError"}
    assert res.plan.backend == "pallas" and res.plan.ttile == 1
    assert autotune.tune(prob, cache_path=cache_path, timer=timer).cached

    def broken(self, x, steps, plan="auto"):
        if plan.backend == "pallas":
            raise RuntimeError("sweep kernel: CUDA error 700")
        return run(self, x, steps, plan)

    monkeypatch.setattr(StencilProblem, "run", broken)
    for t in (timer, None):
        with pytest.raises(RuntimeError, match="CUDA error 700"):
            autotune.tune(prob, cache_path=cache_path, timer=t, force=True)


def test_every_candidate_failing_raises(cache_path):
    prob = StencilProblem("1d3p", (128,), device="cpu")

    def fail(fn, plan):
        raise ValueError("nothing runs")

    with pytest.raises(RuntimeError, match="every candidate failed"):
        autotune.tune(prob, cache_path=cache_path, timer=fail)


def test_default_timer_times_real_runs_on_the_problems_device(cache_path, monkeypatch):
    prob = StencilProblem("1d3p", (64,), device="cpu")
    seen = []
    real = autotune.bench

    def spy(fn, *args, device, **kw):
        seen.append((device, kw))
        return real(fn, *args, device=device, warmup=0, iters=1, min_time_s=0.0)

    monkeypatch.setattr(autotune, "bench", spy)
    res = autotune.tune(prob, cache_path=cache_path, max_measure=2)
    assert seen and all(d == CPU for d, _ in seen)
    assert seen[0][1] == {"warmup": 1, "iters": 2, "min_time_s": 0.05}
    assert res.n_measured == len(seen) and not res.failed


def test_ttile_winner_round_trips_and_dispatches(cache_path):
    prob = StencilProblem("1d3p", (128,), device="cpu")

    def ttile_wins(fn, plan):
        return 0.001 if (plan.ttile, plan.backend) == (2, "pallas") else 1.0

    res = autotune.tune(prob, steps=16, cache_path=cache_path, timer=ttile_wins,
                        max_measure=500)
    assert res.plan.ttile == 2 and res.plan.sweep == "resident", res.plan
    res2 = autotune.tune(prob, steps=16, cache_path=cache_path, timer=ttile_wins)
    assert res2.cached and res2.plan == res.plan
    x = prob.init(0)
    got = prob.run(x, 16, res2.plan)
    assert torch.equal(got, prob.run(x, 16, dataclasses.replace(res2.plan, ttile=1)))
    torch.testing.assert_close(got, prob.reference(x, 16), rtol=5e-5, atol=5e-5)


def test_measured_search_prefers_ttile1_when_tiling_times_slower(cache_path):
    prob = StencilProblem("1d3p", (128,), device="cpu")
    res = autotune.tune(prob, steps=16, cache_path=cache_path,
                        timer=lambda fn, p: 1.0 + 10.0 * (p.ttile - 1), max_measure=500)
    assert res.plan.ttile == 1


def test_plan_batch_invariant_matches_reference():
    for backend in ("jnp", "pallas", "mxu", "distributed", "tpu"):
        plan = StencilPlan(backend=backend)
        assert autotune.plan_batch_invariant(plan) == jtune.plan_batch_invariant(_ref(plan))


# ---------------------------------------------------------------------------
# the plan cache (tests/test_autotune.py, test_plan_cache_invalidation.py)
# ---------------------------------------------------------------------------

def test_cache_roundtrip(cache_path):
    plan = StencilPlan(scheme="transpose", k=4, vl=8, m=4, tiling="tessellate", tile=(16, 16),
                       height=4, remainder="native")
    c = autotune.PlanCache(cache_path)
    c.put("k1", {"plan": autotune.plan_to_dict(plan), "seconds_per_step": 1e-5,
                 "n_candidates": 9, "n_measured": 3, "measurements": []})
    c.save()
    got = autotune.PlanCache(cache_path).get("k1")
    assert autotune.plan_from_dict(got["plan"]) == plan
    assert got["seconds_per_step"] == 1e-5
    raw = json.load(open(cache_path))
    assert raw["version"] == autotune.CACHE_VERSION and "k1" in raw["entries"]
    # a plan dict the reference wrote reads back as the same plan
    assert autotune.plan_from_dict(jtune.plan_to_dict(_ref(plan))) == plan


def test_cache_save_merges_concurrent_writers(cache_path):
    rec = lambda s: {"plan": autotune.plan_to_dict(StencilPlan(scheme=s)),  # noqa: E731
                     "seconds_per_step": 1.0}
    a, b = autotune.PlanCache(cache_path), autotune.PlanCache(cache_path)
    a.put("ka", rec("reorg"))
    a.save()
    b.put("kb", rec("fused"))
    b.save()
    c = autotune.PlanCache(cache_path)
    assert c.get("ka") is not None and c.get("kb") is not None


def test_cached_plan_sees_external_writer(cache_path):
    prob = StencilProblem("1d3p", (128,), device="cpu")
    assert autotune.cached_plan(prob, cache_path=cache_path) is None
    key = autotune.plan_key("1d3p", (128,), prob.dtype, "auto", device="cpux1")
    for plan, t in ((StencilPlan(scheme="reorg", k=1), 1e-5),
                    (StencilPlan(scheme="multiload", k=1), 1e-6)):
        writer = autotune.PlanCache(cache_path)
        writer.put(key, {"plan": autotune.plan_to_dict(plan), "seconds_per_step": t})
        writer.save()
        assert autotune.cached_plan(prob, cache_path=cache_path) == plan


def test_cached_plan_per_steps_falls_back_to_generic(cache_path):
    prob = StencilProblem("1d3p", (128,), device="cpu")
    generic, specific = StencilPlan(scheme="reorg", k=1), StencilPlan(scheme="multiload", k=1)
    w = autotune.PlanCache(cache_path)
    w.put(autotune.plan_key("1d3p", (128,), prob.dtype, "auto", device="cpux1"),
          {"plan": autotune.plan_to_dict(generic), "seconds_per_step": 1.0})
    w.put(autotune.plan_key("1d3p", (128,), prob.dtype, "auto", device="cpux1", steps=7),
          {"plan": autotune.plan_to_dict(specific), "seconds_per_step": 1.0})
    w.save()
    assert autotune.cached_plan(prob, steps=7, cache_path=cache_path) == specific
    assert autotune.cached_plan(prob, steps=9, cache_path=cache_path) == generic
    assert autotune.cached_plan(prob, cache_path=cache_path) == generic
    assert autotune.cached_plan(prob, steps=9, cache_path=cache_path,
                                generic_fallback=False) is None


def test_cache_keys_carry_the_problems_device(cache_path, monkeypatch):
    """A CPU problem's plans never serve a card's problem of the same
    signature, and the reverse."""
    prob = StencilProblem("1d3p", (128,), device="cpu")
    autotune.tune(prob, cache_path=cache_path, timer=lambda fn, p: 1.0)
    assert autotune.cached_plan(prob, cache_path=cache_path) is not None
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda dev=None: "NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    key = autotune.plan_key("1d3p", (128,), torch.float32, "auto",
                            device=autotune.device_signature("cuda"))
    assert "|nvidia_h100_80gb_hbm3x1|" in key
    assert autotune.get_cache(cache_path).get(key) is None


def test_cache_tolerates_corrupt_file(cache_path):
    with open(cache_path, "w") as f:
        f.write("{not json")
    assert autotune.PlanCache(cache_path).get("anything") is None


def test_cache_version_bump_discards_old_files(cache_path):
    with open(cache_path, "w") as f:
        json.dump({"version": autotune.CACHE_VERSION - 1, "entries": {"k": {"plan": {}}}}, f)
    assert autotune.PlanCache(cache_path).get("k") is None


def _mutate_scheme(mp):
    orig = vectorize.SCHEMES["reorg"]

    def patched_reorg(spec, x):
        return orig(spec, x)

    mp.setitem(vectorize.SCHEMES, "reorg", patched_reorg)


def test_fingerprint_is_stable_within_a_process():
    assert autotune.code_fingerprint() == autotune.code_fingerprint()
    assert len(autotune.code_fingerprint()) == 12


def test_plan_key_changes_when_scheme_kernel_changes(monkeypatch):
    k1 = autotune.plan_key("1d3p", (128,), torch.float32, "auto")
    with monkeypatch.context() as mp:
        _mutate_scheme(mp)
        k2 = autotune.plan_key("1d3p", (128,), torch.float32, "auto")
        assert k1 != k2 and k1.rsplit("|", 1)[0] == k2.rsplit("|", 1)[0]
    assert autotune.plan_key("1d3p", (128,), torch.float32, "auto") == k1


def test_csrc_edit_changes_the_fingerprint(tmp_path, monkeypatch):
    """Every CUDA source and header of kernels/csrc enters the fingerprint:
    an edit to one stales every plan; restoring it restores the key."""
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    base, base_dir = autotune.code_fingerprint(), build.build_dir()
    monkeypatch.setattr(build, "CSRC", csrc)
    assert autotune.code_fingerprint() == base and build.build_dir() == base_dir
    for name in ("sweep2d_warp.cuh", "transpose.cu"):
        path = csrc / name
        text = path.read_text()
        path.write_text(text + "\n// an edit\n")
        assert autotune.code_fingerprint() != base, name
        assert build.build_dir() != base_dir, name      # the kernels build anew too
        path.write_text(text)
        assert autotune.code_fingerprint() == base, name


def test_stale_plan_refused_after_kernel_change(cache_path, monkeypatch):
    prob = StencilProblem("1d3p", (128,), device="cpu")
    calls = []
    timer = lambda fn, p: (calls.append(p), 1.0)[1]      # noqa: E731
    res = autotune.tune(prob, cache_path=cache_path, timer=timer)
    assert not res.cached and calls
    assert autotune.cached_plan(prob, cache_path=cache_path) is not None
    _mutate_scheme(monkeypatch)
    assert autotune.cached_plan(prob, cache_path=cache_path) is None
    n = len(calls)
    res2 = autotune.tune(prob, cache_path=cache_path, timer=timer)
    assert not res2.cached and len(calls) > n and res2.key != res.key
    raw = json.load(open(cache_path))
    assert res2.key in raw["entries"] and res.key not in raw["entries"]


def test_save_prunes_retired_fingerprints_keeps_fingerprintless(cache_path):
    w = autotune.PlanCache(cache_path)
    for key, fp in (("stale", "deadbeefdead"), ("current", autotune.code_fingerprint()),
                    ("nofp", None)):
        rec = {"plan": autotune.plan_to_dict(StencilPlan()), "seconds_per_step": 1.0}
        if fp:
            rec["fingerprint"] = fp
        w.put(key, rec)
    w.save()
    fresh = autotune.PlanCache(cache_path)
    assert fresh.get("stale") is None
    assert fresh.get("current") is not None and fresh.get("nofp") is not None


def test_a_shared_file_would_lose_the_other_packages_plans(cache_path):
    """Why the port keeps its own cache file: a save prunes every
    fingerprint but its own, so the reference's entries would go."""
    jw = jtune.PlanCache(cache_path)
    jw.put("ref", {"plan": jtune.plan_to_dict(japi.StencilPlan()), "seconds_per_step": 1.0,
                   "fingerprint": jtune.code_fingerprint()})
    jw.save()
    w = autotune.PlanCache(cache_path)
    w.put("port", {"plan": autotune.plan_to_dict(StencilPlan()), "seconds_per_step": 1.0,
                   "fingerprint": autotune.code_fingerprint()})
    w.save()
    fresh = autotune.PlanCache(cache_path)
    assert fresh.get("ref") is None and fresh.get("port") is not None


def test_fingerprint_memo_holds_live_references():
    base = autotune.code_fingerprint()
    for i in range(3):
        ns = {}
        exec(f"def _tmp_scheme(spec, x):\n    return x * {i}\n", ns)
        vectorize.SCHEMES["_tmp"] = ns["_tmp_scheme"]
        try:
            assert autotune.code_fingerprint() != base
        finally:
            del vectorize.SCHEMES["_tmp"]
    assert autotune.code_fingerprint() == base


def test_concurrent_save_merge_interleaved_writers(cache_path):
    def rec(scheme):
        return {"plan": autotune.plan_to_dict(StencilPlan(scheme=scheme)),
                "seconds_per_step": 1.0}
    a, b, c = (autotune.PlanCache(cache_path) for _ in range(3))
    a.put("shared", rec("reorg"))
    a.put("ka", rec("fused"))
    a.save()
    b.put("shared", rec("multiload"))
    b.put("kb", rec("fused"))
    b.save()
    c.put("kc", rec("dlt"))
    c.save()
    fresh = autotune.PlanCache(cache_path)
    assert len(fresh) == 4
    assert fresh.get("shared")["plan"]["scheme"] == "multiload"
    # a second save without new puts resurrects nothing
    a.save()
    assert autotune.PlanCache(cache_path).get("shared")["plan"]["scheme"] == "multiload"


# ---------------------------------------------------------------------------
# plan="auto" through StencilProblem.run
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,shape", [("1d3p", (128,)), ("2d5p", (16, 64)),
                                        ("3d7p", (8, 4, 64))])
def test_run_auto_caches_runs_its_plan_and_matches_reference(cache_path, tmp_path, monkeypatch,
                                                             name, shape):
    monkeypatch.setenv(autotune.CACHE_ENV, cache_path)
    monkeypatch.setenv(jtune.CACHE_ENV, str(tmp_path / "ref_plans.json"))
    x = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    prob = StencilProblem(name, shape, device="cpu")
    xt = torch.from_numpy(x)
    got = prob.run(xt, 5)                                  # plan="auto" is the default
    raw = json.load(open(cache_path))
    (key, rec), = raw["entries"].items()
    assert key.startswith(f"{name}|{'x'.join(map(str, shape))}|float32|auto|cpux1|s5|")
    assert key.endswith(f"|s5|{autotune.code_fingerprint()}")
    assert rec["fingerprint"] == autotune.code_fingerprint()
    assert rec["n_measured"] >= 3 and not rec["failed"]
    assert {m["plan"]["backend"] for m in rec["measurements"]} == {"jnp", "pallas", "mxu"}
    plan = autotune.plan_from_dict(rec["plan"])
    assert torch.equal(got, prob.run(xt, 5, plan))
    assert torch.equal(xt, torch.from_numpy(x))
    want = japi.StencilProblem(name, shape).run(jnp.asarray(x), 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
    # a second run is a cache hit: no measurement
    monkeypatch.setattr(autotune, "_default_timer", lambda *a, **k: pytest.fail("measured"))
    assert torch.equal(prob.run(xt, 5, "auto"), got)
