"""Stencil serving of the port on the CPU: ``StencilSweepBatcher`` and
``StencilProblem.run_batched`` (the reference's tests/test_serve_batcher.py,
and parity with the reference).

  * the reference's batcher tests, each on the port: coalescing into one
    program built once per slot count, distinct signatures apart, fixed
    slot counts, shape buckets (bit for bit the unbucketed run), tenant
    round-robin, backpressure, batched bit for bit sequential on every
    parity plan and dtype (mxu within 2e-6 f32 / 8e-3 bf16), the
    service's cached pallas plan, the batch-invariance gate, failures fanned
    out to every future, the async facade and its lifecycle.  Two wait for
    the distributed runtime (ROADMAP A9): the 2-D mesh mxu plan and the
    exclusive mesh claim; here a distributed plan raises naming A9;
  * the port's ``run_batched`` against the reference's ``run_batched`` on
    the same numpy inputs (Pallas in interpret mode, as the reference's
    tests run it): every parity plan on 1d3p (4, 128) and the 2-D resident
    plan on 2d5p (3, 16, 128), within rtol = atol = 2e-6 in float32 and
    4e-2 in bfloat16 (the port's bfloat16 limit, tests/test_torch_schemes.py);
  * K2 on a batch is K2 on each grid: the register kernel's address map
    (transcribed in tests/test_torch_transpose_reg.py) indexes the whole
    array by ``numel // m``, and the plain version is a reshape;
  * the plain versions of the sweeps (periodic, ring, open) on a batch
    equal them on each grid, bit for bit, and the batched program's tile,
    schedule and route are resolved once.
"""
from __future__ import annotations

import dataclasses
import os
import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import api as japi
from repro.core import autotune as jtune
from repro_torch.convert import plan_from_reference
from repro_torch.core import autotune, stencils
from repro_torch.core.api import StencilPlan, StencilProblem
from repro_torch.kernels import ops
from repro_torch.kernels import stencil_kernels as sk
from repro_torch.serve.batcher import BatcherFull, StencilSweepBatcher, bucket_shape
from repro_torch.serve.engine import StencilService

CPU = "cpu"
TOL = {"float32": 2e-6, "bfloat16": 4e-2}
MXU_TOL = {"float32": 2e-6, "bfloat16": 8e-3}
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float64": torch.float64}


@pytest.fixture
def cache_path(tmp_path):
    return os.path.join(tmp_path, "plan_cache.json")


def _service(cache_path) -> StencilService:
    return StencilService(cache_path=cache_path, device=CPU)


def _np(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _rand(shape, dtype=torch.float32, seed=0):
    return torch.from_numpy(_np(shape, seed)).to(dtype)


# ---------------------------------------------------------------------------
# coalescing and the build count
# ---------------------------------------------------------------------------

def test_coalesces_same_signature_into_one_program(cache_path):
    svc = _service(cache_path)
    batcher = StencilSweepBatcher(svc, start=False)
    xs = [_rand((128,), seed=i) for i in range(4)]
    futs = [batcher.submit("1d3p", x, 6) for x in xs]
    batcher.run_pending()
    got = [f.result(timeout=0) for f in futs]
    st = batcher.stats
    assert st["batches"] == 1 and st["served"] == 4
    assert st["programs"] == 1
    for x, y in zip(xs, got):
        assert torch.equal(y, svc.sweep("1d3p", x, 6))


def test_never_rebuilds_after_slot_count_warmup(cache_path):
    """After one batch a slot count, more traffic at the same (signature,
    steps, slots) reuses the same program: the census stays flat, and the
    problem holds one program for (steps, plan), built exactly once, that
    serves every slot count (the reference pins one jit executable a slot
    count)."""
    svc = _service(cache_path)
    batcher = StencilSweepBatcher(svc, start=False)
    for _ in range(3):
        for n in (1, 3, 4):                 # slot counts 1, 4, 4
            futs = [batcher.submit("1d3p", _rand((128,), seed=i), 6) for i in range(n)]
            batcher.run_pending()
            for f in futs:
                f.result(timeout=0)
    st = batcher.stats
    assert st["batches"] == 9
    assert st["programs"] == 2
    prob = svc._problems[("1d3p", (128,), "float32")]
    assert {slots for (_, slots, _) in batcher._programs} == {1, 4}
    (steps, plan), = prob._programs
    assert steps == 6 and {p for (_, _, p) in batcher._programs} == {plan}
    assert dict(prob._program_builds) == {(6, plan): 1}


def test_distinct_signatures_do_not_coalesce(cache_path):
    svc = _service(cache_path)
    batcher = StencilSweepBatcher(svc, start=False)
    f1 = batcher.submit("1d3p", _rand((128,)), 6)
    f2 = batcher.submit("1d3p", _rand((256,)), 6)     # another shape
    f3 = batcher.submit("1d3p", _rand((128,)), 9)     # other steps
    f4 = batcher.submit("1d3p", _rand((128,), torch.bfloat16), 6)   # another dtype
    batcher.run_pending()
    for f in (f1, f2, f3, f4):
        f.result(timeout=0)
    assert batcher.stats["batches"] == 4


def test_fixed_slot_admission_pads_to_static_sizes(cache_path):
    svc = _service(cache_path)
    batcher = StencilSweepBatcher(svc, start=False)
    futs = [batcher.submit("1d3p", _rand((128,), seed=i), 6) for i in range(3)]
    batcher.run_pending()
    for f in futs:
        f.result(timeout=0)
    (batch,) = batcher.stats["batch_log"]
    assert batch["n"] == 3 and batch["slots"] == 4
    assert batcher.stats["padded_slots"] == 1


# ---------------------------------------------------------------------------
# shape-bucketed admission
# ---------------------------------------------------------------------------

def test_bucket_shape_rules():
    assert bucket_shape((128,)) == ((128,), 1)
    assert bucket_shape((256,)) == ((256,), 1)
    assert bucket_shape((96,)) == ((384,), 4)
    assert bucket_shape((192,)) == ((384,), 2)
    assert bucket_shape((64,)) == ((128,), 2)
    assert bucket_shape((16, 96)) == ((16, 384), 4)
    assert bucket_shape((100,)) == ((100,), 1)
    assert bucket_shape((1024, 960)) == ((1024, 1920), 2)


def test_near_miss_shapes_share_one_program(cache_path):
    """(96,) and (192,) both bucket to (384,): one group, one program, and
    the cropped results are bit for bit the unbucketed runs."""
    svc = _service(cache_path)
    batcher = StencilSweepBatcher(svc, start=False)
    x1, x2 = _rand((96,), seed=1), _rand((192,), seed=2)
    f1 = batcher.submit("1d3p", x1, 6)
    f2 = batcher.submit("1d3p", x2, 6)
    batcher.run_pending()
    st = batcher.stats
    assert st["batches"] == 1 and st["programs"] == 1
    assert st["bucketed"] == 2
    (batch,) = st["batch_log"]
    assert batch["sig"][1] == (384,) and batch["n"] == 2
    y1, y2 = f1.result(timeout=0), f2.result(timeout=0)
    assert y1.shape == (96,) and y2.shape == (192,)
    spec = stencils.make("1d3p")
    assert torch.equal(y1, stencils.apply_steps(spec, x1, 6, bc="periodic"))
    assert torch.equal(y2, stencils.apply_steps(spec, x2, 6, bc="periodic"))


def test_near_miss_2d_bucket_is_exact(cache_path):
    """2d5p (16, 96) buckets to (16, 384): the crop is bit for bit the
    service's sweep of the original shape."""
    svc = _service(cache_path)
    batcher = StencilSweepBatcher(svc, start=False)
    xs = [_rand((16, 96), seed=i) for i in range(2)]
    futs = [batcher.submit("2d5p", x, 5) for x in xs]
    batcher.run_pending()
    for x, f in zip(xs, futs):
        assert torch.equal(f.result(timeout=0), svc.sweep("2d5p", x, 5))


def test_replication_padding_is_exact():
    spec = stencils.make("1d5p")
    x = _rand((64,), seed=3)
    xr = torch.cat([x, x], dim=-1)
    yr = stencils.apply_steps(spec, xr, 5, bc="periodic")
    y = stencils.apply_steps(spec, x, 5, bc="periodic")
    assert torch.equal(yr[:64], y)
    assert torch.equal(yr[64:], yr[:64])


# ---------------------------------------------------------------------------
# fairness
# ---------------------------------------------------------------------------

def test_greedy_tenant_cannot_starve_others(cache_path):
    svc = _service(cache_path)
    batcher = StencilSweepBatcher(svc, slot_counts=(1, 2, 4), start=False)
    greedy = [batcher.submit("1d3p", _rand((128,), seed=i), 6, tenant="greedy")
              for i in range(8)]
    quiet = batcher.submit("1d3p", _rand((128,), seed=99), 6, tenant="quiet")
    batcher.run_pending()
    for f in greedy + [quiet]:
        f.result(timeout=0)
    log = batcher.stats["batch_log"]
    assert log[0]["tenants"].count("quiet") == 1
    assert log[0]["tenants"].count("greedy") == 3
    assert sum(b["n"] for b in log) == 9


def test_round_robin_interleaves_tenants(cache_path):
    svc = _service(cache_path)
    batcher = StencilSweepBatcher(svc, slot_counts=(4,), start=False)
    for i in range(2):
        batcher.submit("1d3p", _rand((128,), seed=i), 6, tenant="a")
    for i in range(2):
        batcher.submit("1d3p", _rand((128,), seed=10 + i), 6, tenant="b")
    batcher.run_pending()
    (batch,) = batcher.stats["batch_log"]
    assert batch["tenants"] == ["a", "b", "a", "b"]


# ---------------------------------------------------------------------------
# backpressure
# ---------------------------------------------------------------------------

def test_backpressure_rejects_with_retry_after(cache_path):
    svc = _service(cache_path)
    batcher = StencilSweepBatcher(svc, max_queue=4, start=False)
    futs = [batcher.submit("1d3p", _rand((128,), seed=i), 6) for i in range(4)]
    with pytest.raises(BatcherFull) as exc:
        batcher.submit("1d3p", _rand((128,), seed=9), 6)
    assert exc.value.retry_after > 0
    assert batcher.stats["rejected"] == 1
    batcher.run_pending()
    for f in futs:
        f.result(timeout=0)
    retry = batcher.submit("1d3p", _rand((128,), seed=9), 6)
    batcher.run_pending()
    retry.result(timeout=0)
    assert batcher.stats["served"] == 5


# ---------------------------------------------------------------------------
# batched bit for bit sequential, every plan and dtype
# ---------------------------------------------------------------------------

_PARITY_PLANS = [
    StencilPlan(scheme="fused", k=1),
    StencilPlan(scheme="multiload", k=1),
    StencilPlan(scheme="dlt", k=1, vl=4),
    StencilPlan(scheme="transpose", k=2, vl=8, m=8),
    StencilPlan(scheme="transpose", k=2, vl=8, m=4, backend="pallas", sweep="resident"),
    StencilPlan(scheme="transpose", k=2, vl=8, m=4, backend="pallas", sweep="resident",
                ttile=2),
    StencilPlan(scheme="transpose", k=2, vl=8, m=4, backend="pallas", sweep="roundtrip"),
]
_RESIDENT_2D = StencilPlan(scheme="transpose", k=2, vl=8, m=4, t0=4, backend="pallas",
                           sweep="resident")


def _plan_id(p):
    return f"{p.backend}-{p.scheme}-k{p.k}-{p.sweep}-tt{p.ttile}"


@pytest.mark.parametrize("plan", _PARITY_PLANS, ids=_plan_id)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_batched_bitwise_equals_sequential(plan, dtype):
    prob = StencilProblem("1d3p", (128,), DTYPES[dtype], device=CPU)
    xb = _rand((4, 128), DTYPES[dtype], seed=42)
    yb = prob.run_batched(xb, 7, plan)            # 7 steps: the remainder too
    assert yb.dtype == DTYPES[dtype] and yb.shape == xb.shape
    for i in range(xb.shape[0]):
        assert torch.equal(yb[i], prob.run(xb[i], 7, plan)), f"grid {i} diverged"


@pytest.mark.parametrize("name,shape,t0", [("2d5p", (16, 128), 4), ("2d9p", (8, 64), 2),
                                           ("3d7p", (8, 4, 64), 4), ("3d27p", (4, 4, 32), 2)])
@pytest.mark.parametrize("sweep", ["resident", "roundtrip"])
def test_batched_bitwise_equals_sequential_nd(name, shape, t0, sweep):
    plan = StencilPlan(scheme="transpose", k=2, vl=8, m=4, t0=t0, backend="pallas",
                       sweep=sweep, ttile=2 if sweep == "resident" else 1)
    prob = StencilProblem(name, shape, device=CPU)
    xb = _rand((3,) + shape, seed=1)
    yb = prob.run_batched(xb, 5, plan)
    for i in range(3):
        assert torch.equal(yb[i], prob.run(xb[i], 5, plan))


@pytest.mark.parametrize("ttile", [1, 2], ids=lambda t: f"tt{t}")
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batched_mxu_parity(dtype, ttile):
    plan = StencilPlan(scheme="transpose", k=2, vl=8, m=8, backend="mxu", ttile=ttile)
    prob = StencilProblem("1d3p", (128,), DTYPES[dtype], device=CPU)
    xb = _rand((4, 128), DTYPES[dtype], seed=42)
    yb = prob.run_batched(xb, 7, plan)
    assert yb.dtype == DTYPES[dtype]
    tol = MXU_TOL[dtype]
    for i in range(xb.shape[0]):
        np.testing.assert_allclose(yb[i].float().numpy(), prob.run(xb[i], 7, plan).float().numpy(),
                                   rtol=tol, atol=tol, err_msg=f"grid {i} diverged")


def test_batched_mxu_parity_2d():
    plan = StencilPlan(scheme="transpose", k=2, vl=4, m=4, backend="mxu")
    prob = StencilProblem("2d5p", (16, 128), device=CPU)
    xb = _rand((3, 16, 128), seed=7)
    yb = prob.run_batched(xb, 5, plan)
    for i in range(3):
        np.testing.assert_allclose(yb[i].numpy(), prob.run(xb[i], 5, plan).numpy(),
                                   rtol=MXU_TOL["float32"], atol=MXU_TOL["float32"])


def test_service_level_bit_identity_with_cached_pallas_plan(cache_path):
    """A pallas winner in the plan cache serves both the synchronous and
    the batched path, bit for bit alike."""
    prob = StencilProblem("1d3p", (128,), device=CPU)
    autotune.tune(prob, cache_path=cache_path,
                  timer=lambda fn, p: 0.001 if p.backend == "pallas" else 1.0)
    svc = _service(cache_path)
    assert svc.plan_for("1d3p", (128,)).backend == "pallas"
    batcher = StencilSweepBatcher(svc, start=False)
    xs = [_rand((128,), seed=i) for i in range(4)]
    futs = [batcher.submit("1d3p", x, 4) for x in xs]
    batcher.run_pending()
    for x, f in zip(xs, futs):
        assert torch.equal(f.result(timeout=0), svc.sweep("1d3p", x, 4))


# ---------------------------------------------------------------------------
# the batch-invariance gate and the distributed plans
# ---------------------------------------------------------------------------

def test_plan_batch_invariance_gate():
    spec = stencils.make("1d3p")
    for plan in autotune.candidate_plans(spec, (128,), device=CPU):
        assert autotune.plan_batch_invariant(plan), plan
    assert autotune.plan_batch_invariant(StencilPlan(scheme="transpose", backend="mxu"))
    bogus = dataclasses.replace(StencilPlan(), backend="quantum")
    assert not autotune.plan_batch_invariant(bogus)
    with pytest.raises(ValueError, match="not batch-invariant"):
        StencilProblem("1d3p", (128,), device=CPU).run_batched(_rand((2, 128)), 4, bogus)


@pytest.mark.parametrize("plan", [StencilPlan(scheme="fused", k=2, backend="distributed"),
                                  StencilPlan(backend="mxu", decomp=(2,))])
def test_distributed_plans_raise_naming_a9(plan):
    prob = StencilProblem("1d3p", (128,), device=CPU)
    with pytest.raises(NotImplementedError, match="A9"):
        prob.run_batched(_rand((2, 128)), 4, plan)
    with pytest.raises(NotImplementedError, match="A9"):
        prob.run_batched_parts([_rand((128,))], 4, plan)


def test_batched_request_errors_propagate_to_all_futures(cache_path):
    svc = _service(cache_path)
    batcher = StencilSweepBatcher(svc, start=False)
    futs = [batcher.submit("nope-not-a-stencil", _rand((128,), seed=i), 4) for i in range(2)]
    batcher.run_pending()
    for f in futs:
        with pytest.raises(Exception):
            f.result(timeout=0)


def test_run_batched_refuses_other_shapes():
    prob = StencilProblem("2d5p", (16, 64), device=CPU)
    with pytest.raises(ValueError, match="expects"):
        prob.run_batched(_rand((16, 64)), 2, _RESIDENT_2D)
    with pytest.raises(ValueError, match="expects"):
        prob.run_batched(_rand((2, 16, 32)), 2, _RESIDENT_2D)
    with pytest.raises(ValueError, match="expects"):
        prob.run_batched_parts([_rand((16, 64)), _rand((16, 32))], 2, _RESIDENT_2D)


# ---------------------------------------------------------------------------
# the async facade and its lifecycle
# ---------------------------------------------------------------------------

def test_sweep_async_facade_background_thread(cache_path):
    svc = _service(cache_path)
    xs = [_rand((128,), seed=i) for i in range(6)]
    futs = [svc.sweep_async("1d3p", x, 6, tenant=f"t{i % 3}") for i, x in enumerate(xs)]
    got = [f.result(timeout=60) for f in futs]
    for x, y in zip(xs, got):
        assert torch.equal(y, svc.sweep("1d3p", x, 6))
    svc.close()
    with pytest.raises(RuntimeError):
        svc.sweep_async("1d3p", xs[0], 6)
    assert torch.equal(svc.sweep("1d3p", xs[0], 6), got[0])


def test_close_drains_queued_requests(cache_path):
    svc = _service(cache_path)
    fut = svc.sweep_async("1d3p", _rand((128,)), 6)
    svc.close()
    assert fut.done() and fut.exception() is None


def test_concurrent_submitters_lose_nothing(cache_path):
    """16 threads submit 6 requests each (two signatures, three tenants)
    to a running batcher with 4 workers while the interpreter switches
    threads every microsecond: every future resolves to its own sweep,
    the counters add up, and each batched program was built once."""
    svc = _service(cache_path)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        batcher = StencilSweepBatcher(svc, max_queue=1000, max_wait_s=0.001, n_workers=4)
        results, lock = [], threading.Lock()

        def client(k):
            for j in range(6):
                name, shape = (("1d3p", (128,)), ("2d5p", (8, 64)))[j % 2]
                x = _rand(shape, seed=100 * k + j)
                fut = batcher.submit(name, x, 3, tenant=f"t{k % 3}")
                with lock:
                    results.append((name, x, fut))
        threads = [threading.Thread(target=client, args=(k,)) for k in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
        for name, x, fut in results:
            assert torch.equal(fut.result(timeout=120), svc.sweep(name, x, 3))
        batcher.close()
    finally:
        sys.setswitchinterval(old)
    st = batcher.stats
    assert len(results) == st["submitted"] == st["served"] == 96
    assert st["n_queued"] == 0 and sum(b["n"] for b in st["batch_log"]) == 96
    assert {b["sig"][1] for b in st["batch_log"]} == {(128,), (8, 128)}   # (8, 64) buckets
    assert all(n == 1 for p in svc._problems.values() for n in p._program_builds.values())


def test_batcher_context_manager(cache_path):
    svc = _service(cache_path)
    with StencilSweepBatcher(svc, start=False) as batcher:
        fut = batcher.submit("1d3p", _rand((128,)), 6)
    assert fut.done() and fut.exception() is None


# ---------------------------------------------------------------------------
# the port's run_batched against the reference's
# ---------------------------------------------------------------------------

_JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _reference_plan(plan: StencilPlan):
    return japi.StencilPlan(**{f.name: getattr(plan, f.name)
                               for f in dataclasses.fields(japi.StencilPlan)})


@pytest.mark.parametrize("plan", _PARITY_PLANS, ids=_plan_id)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_run_batched_matches_reference(plan, dtype):
    x = _np((4, 128), seed=42)
    jplan = _reference_plan(plan)
    jprob = japi.StencilProblem("1d3p", (128,), _JNP[dtype])
    want = np.asarray(jprob.run_batched(jnp.asarray(x, _JNP[dtype]), 7, jplan), np.float32)
    prob = StencilProblem("1d3p", (128,), DTYPES[dtype], device=CPU)
    assert plan_from_reference(jtune.plan_to_dict(jplan)) == plan
    got = prob.run_batched(torch.from_numpy(x).to(DTYPES[dtype]), 7, plan)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_run_batched_2d_matches_reference(dtype):
    x = _np((3, 16, 128), seed=1)
    jprob = japi.StencilProblem("2d5p", (16, 128), _JNP[dtype])
    want = np.asarray(jprob.run_batched(jnp.asarray(x, _JNP[dtype]), 5,
                                        _reference_plan(_RESIDENT_2D)), np.float32)
    prob = StencilProblem("2d5p", (16, 128), DTYPES[dtype], device=CPU)
    got = prob.run_batched(torch.from_numpy(x).to(DTYPES[dtype]), 5, _RESIDENT_2D)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=TOL[dtype], atol=TOL[dtype])


# ---------------------------------------------------------------------------
# K2 and the plain sweeps on a batch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("vl,m", [(8, 8), (32, 4), (4, 3), (16, 32), (96, 8), (2, 7)])
def test_k2_batched_equals_per_element(vl, m):
    """K2's register kernel on (B, …, N), transcribed (it moves
    ``numel // m`` sub-columns of the flat array), equals K2 on each grid;
    the plain version is the reshape of each grid."""
    from test_torch_transpose_reg import reg_kernel_np
    n = 5 * vl * m
    xb = np.random.default_rng(3).integers(-2**31, 2**31 - 1, (3, 2, n), dtype=np.int32)
    whole, reads, writes = reg_kernel_np(xb.ravel(), vl, m, True)
    np.testing.assert_array_equal(reads, 1)
    np.testing.assert_array_equal(writes, 1)
    per = np.concatenate([reg_kernel_np(x.ravel(), vl, m, True)[0] for x in xb])
    np.testing.assert_array_equal(whole, per)
    t = sk.block_transpose(torch.from_numpy(xb), vl, m)
    assert tuple(t.shape) == (3, 2, 5, m, vl)
    np.testing.assert_array_equal(whole, t.contiguous().numpy().ravel())
    for i in range(3):
        assert torch.equal(t[i], sk.block_transpose_ref(torch.from_numpy(xb[i]), vl, m))
    back, reads, writes = reg_kernel_np(whole, vl, m, False)
    np.testing.assert_array_equal(reads, 1)
    np.testing.assert_array_equal(back.reshape(xb.shape), xb)
    assert torch.equal(sk.block_untranspose(t, vl, m), torch.from_numpy(xb))


@pytest.mark.parametrize("vl,m", [(8, 8), (4, 3), (16, 32), (96, 8), (2, 7)])
def test_k2_parts_equals_k2_of_the_stack(vl, m):
    """K2 from B grids where they lie (a table of their pointers, part z
    moved as one array into slice z of the layout; transcribed) equals K2
    of their stack; the plain version is that; grids that differ raise."""
    from test_torch_transpose_reg import reg_kernel_np
    n = 5 * vl * m
    xs = [np.random.default_rng(i).integers(-2**31, 2**31 - 1, (2, n), dtype=np.int32)
          for i in range(3)]
    per = np.concatenate([reg_kernel_np(x.ravel(), vl, m, True)[0] for x in xs])
    np.testing.assert_array_equal(per, reg_kernel_np(np.stack(xs).ravel(), vl, m, True)[0])
    t = sk.block_transpose_parts([torch.from_numpy(x) for x in xs], vl, m)
    assert tuple(t.shape) == (3, 2, 5, m, vl)
    np.testing.assert_array_equal(per, t.contiguous().numpy().ravel())
    with pytest.raises(ValueError, match="differ"):
        sk.block_transpose_parts([torch.zeros(n), torch.zeros(2 * n)], vl, m)


@pytest.mark.parametrize("plan", _PARITY_PLANS + [StencilPlan(backend="mxu", k=2, vl=8, m=4)],
                         ids=lambda p: f"{p.backend}-{p.sweep}-{p.scheme}-k{p.k}-tt{p.ttile}")
def test_run_batched_parts_equals_run(plan):
    """The parts of a batch (the resident and mxu engines read them where
    they lie, the others stack them) give each grid its own ``run``: bit
    for bit, the mxu product within 2e-6."""
    prob = StencilProblem("1d3p", (128,), device=CPU)
    xs = [_rand((128,), seed=i) for i in range(3)]
    ys = prob.run_batched_parts(xs, 5, plan)
    for x, y in zip(xs, ys):
        if plan.backend == "mxu":
            torch.testing.assert_close(y, prob.run(x, 5, plan), rtol=2e-6, atol=2e-6)
        else:
            assert torch.equal(y, prob.run(x, 5, plan))


def _star(ndim, r):
    return stencils.StencilSpec(f"star{ndim}d-r{r}", ndim, r, "star", stencils._star_taps(ndim, r))


@pytest.mark.parametrize("edge", ["periodic", "ring", "open"])
@pytest.mark.parametrize("spec,shape,m,t0", [
    (stencils.make("1d3p"), (256,), 8, None), (stencils.make("1d5p"), (96,), 3, None),
    (stencils.make("2d5p"), (16, 64), 4, 4), (stencils.make("2d9p"), (8, 32), 2, 2),
    (stencils.make("3d7p"), (8, 4, 64), 4, 4), (stencils.make("3d27p"), (4, 4, 32), 4, 2),
    (_star(1, 5), (512,), 8, None), (_star(2, 5), (16, 64), 8, 8), (_star(3, 5), (10, 4, 64), 8, 5),
], ids=lambda v: getattr(v, "name", None))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_sweeps_batched_equal_per_grid(spec, shape, m, t0, edge, dtype):
    """The sweeps' plain versions on a batch of three grids in layout, each
    grid bit for bit its own sweep: periodic (K1 / K3), ring and open (K4)."""
    xb = _rand((3,) + shape, DTYPES[dtype], seed=5)
    t = sk.block_transpose(xb, 8, m)
    depth = 3

    def sweep(v):
        if edge == "periodic":
            if spec.ndim == 1:
                return sk.stencil1d_sweep_ttile(spec, v, depth, 1)
            return sk.stencil_nd_sweep_ttile(spec, v, depth, 1, t0)
        if spec.ndim == 1:
            return sk.stencil1d_multistep(spec, v, depth, edge_mask=edge == "ring")
        return sk.stencil_nd_multistep(spec, v, depth, t0, edge_mask=edge == "ring")
    yb = sweep(t)
    assert yb.shape == t.shape and sk.batch_of(spec, t) == 3
    for i in range(3):
        assert torch.equal(yb[i], sweep(t[i]))


def test_batched_program_resolves_tile_schedule_route():
    prob = StencilProblem("2d5p", (16, 128), device=CPU)
    plan = dataclasses.replace(_RESIDENT_2D, ttile=2)
    prob.run_batched(_rand((2, 16, 128)), 7, plan)
    (key, program), = prob._programs.items()
    assert key == (7, plan) and program.engine == "resident"
    assert program.tile == ops.pick_tile(prob.spec, (16, 128), 8, 4, 4)
    assert program.schedule == ((4, 1), (2, 1), (1, 1))
    assert program.route == ("2d", "2d", "2d")
    # one grid, another batch size and the parts of a batch run the same
    # program: one dispatch, built once
    prob.run(_rand((16, 128)), 7, plan)
    prob.run_batched(_rand((5, 16, 128)), 7, plan)
    prob.run_batched_parts([_rand((16, 128))] * 3, 7, plan)
    assert dict(prob._program_builds) == {(7, plan): 1}
    mxu = StencilPlan(backend="mxu", k=2, vl=8, m=4)
    prob.run_batched(_rand((2, 16, 128)), 4, mxu)
    assert prob._programs[(4, mxu)].route == ("mxu",)
    jnp_plan = StencilPlan(scheme="fused", k=1)
    prob.run_batched_parts([_rand((16, 128))] * 3, 4, jnp_plan)
    assert prob._programs[(4, jnp_plan)].route == ("jnp",)
    roundtrip = StencilPlan(backend="pallas", sweep="roundtrip", k=2, vl=8, m=4, t0=4)
    prob.run_batched_parts([_rand((16, 128))] * 2, 4, roundtrip)
    assert prob._programs[(4, roundtrip)].route == ("2d",)


def test_run_batched_parts_returns_views_of_one_output():
    prob = StencilProblem("1d3p", (128,), device=CPU)
    plan = _PARITY_PLANS[4]
    xs = [_rand((128,), seed=i) for i in range(3)]
    ys = prob.run_batched_parts(xs, 5, plan)
    assert len({y.untyped_storage().data_ptr() for y in ys}) == 1
    for x, y in zip(xs, ys):
        assert torch.equal(y, prob.run(x, 5, plan))


def test_layout_rank_checks():
    spec = stencils.make("2d5p")
    t = torch.zeros(2, 3, 16, 4, 4, 8)      # rank ndim + 4: no layout
    with pytest.raises(ValueError, match="layout"):
        sk.stencil_nd_sweep_ttile(spec, t, 2, 1, 4)
    with pytest.raises(ValueError, match="grid"):
        ops.stencil_sweep_periodic(spec, torch.zeros(2, 2, 16, 64), 2, vl=8, m=4)
