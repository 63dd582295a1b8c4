"""``StencilService`` of the port on the CPU (the reference's service tests
in tests/test_autotune.py).

  * plans come from the plan cache and the serving path never measures;
    a cold signature serves the static default;
  * a per-``steps`` request served by the generic entry does not pin that
    step count: a later per-``steps`` tuning is served next;
  * a cached pallas winner reaches the kernels' wrappers;
  * ``warm_async`` tunes on its worker thread (a stub timer), publishes
    into the cache file and the memo, coalesces in-flight duplicates,
    ``close`` cancels the queued warms, and a tune still running at
    ``close(wait=False)`` keeps its future but leaves no entry in the
    closed service;
  * the LRU of problems drops its plans with it, distributed plans that
    this host cannot run degrade to the default, and the service's
    problems live on its device.
"""
from __future__ import annotations

import os
import threading

import numpy as np
import pytest
import torch

from repro_torch.core import autotune
from repro_torch.core.api import StencilPlan, StencilProblem
from repro_torch.serve import engine
from repro_torch.serve.engine import StencilService

CPU = "cpu"
TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture
def cache_path(tmp_path):
    return os.path.join(tmp_path, "plan_cache.json")


def _prob(shape=(128,)):
    return StencilProblem("1d3p", shape, device=CPU)


def _check_sweep(svc):
    prob = _prob()
    x = prob.init(0)
    np.testing.assert_allclose(svc.sweep("1d3p", x, 4).numpy(), prob.reference(x, 4).numpy(),
                               **TOL)


def test_stencil_service_uses_cached_plan_never_measures(cache_path, monkeypatch):
    tuned = StencilPlan(scheme="reorg", k=1)
    autotune.tune(_prob(), cache_path=cache_path, max_measure=500,
                  timer=lambda fn, p: 0.001 if p == tuned else 1.0)
    svc = StencilService(cache_path=cache_path, device=CPU)
    assert svc.plan_for("1d3p", (128,)) == tuned

    def no_measure(*a, **kw):
        raise AssertionError("serving path must not measure")
    monkeypatch.setattr(autotune, "tune", no_measure)
    _check_sweep(svc)
    # a cold signature serves the static default
    assert svc.plan_for("1d3p", (256,)) == _prob((256,)).default_plan()


def test_stencil_service_picks_up_later_per_steps_tuning(cache_path):
    prob = _prob()
    generic = StencilPlan(scheme="reorg", k=1)
    w = autotune.PlanCache(cache_path)
    w.put(autotune.plan_key("1d3p", (128,), prob.dtype, "auto",
                            device=autotune.device_signature(prob.device)),
          {"plan": autotune.plan_to_dict(generic), "seconds_per_step": 1.0})
    w.save()
    svc = StencilService(cache_path=cache_path, device=CPU)
    assert svc.plan_for("1d3p", (128,), steps=7) == generic
    specific = StencilPlan(scheme="multiload", k=1)
    w2 = autotune.PlanCache(cache_path)
    w2.put(autotune.plan_key("1d3p", (128,), prob.dtype, "auto",
                             device=autotune.device_signature(prob.device), steps=7),
           {"plan": autotune.plan_to_dict(specific), "seconds_per_step": 1.0})
    w2.save()
    assert svc.plan_for("1d3p", (128,), steps=7) == specific
    assert svc.plan_for("1d3p", (128,), steps=9) == generic


def test_stencil_service_dispatches_pallas_backend(cache_path, monkeypatch):
    autotune.tune(_prob(), cache_path=cache_path,
                  timer=lambda fn, p: 0.001 if p.backend == "pallas" else 1.0)
    svc = StencilService(cache_path=cache_path, device=CPU)
    assert svc.plan_for("1d3p", (128,)).backend == "pallas"
    monkeypatch.setattr(autotune, "tune", lambda *a, **kw: (_ for _ in ()).throw(
        AssertionError("no measuring")))
    _check_sweep(svc)


# ---------------------------------------------------------------------------
# background warm tuning
# ---------------------------------------------------------------------------

def test_warm_async_tunes_off_request_path(cache_path, monkeypatch):
    svc = StencilService(cache_path=cache_path, device=CPU)
    main_thread = threading.current_thread()
    tuned = StencilPlan(scheme="reorg", k=1)
    measured_on = []

    def stub_timer(fn, plan):
        measured_on.append(threading.current_thread())
        return 0.001 if plan == tuned else 1.0

    # cold: the request path serves the default and never waits on the warm
    assert svc.plan_for("1d3p", (128,)) == _prob().default_plan()
    fut = svc.warm_async("1d3p", (128,), timer=stub_timer, max_measure=500)
    assert fut.result(timeout=60) == tuned
    assert measured_on and all(t is not main_thread for t in measured_on)
    monkeypatch.setattr(autotune, "tune", lambda *a, **kw: (_ for _ in ()).throw(
        AssertionError("serving must not measure")))
    assert svc.plan_for("1d3p", (128,)) == tuned
    _check_sweep(svc)
    assert autotune.cached_plan(_prob(), cache_path=cache_path) == tuned
    svc.close()


def test_warm_async_coalesces_inflight_duplicates(cache_path):
    svc = StencilService(cache_path=cache_path, device=CPU)
    release = threading.Event()
    calls = []

    def slow_timer(fn, plan):
        calls.append(plan)
        release.wait(timeout=30)
        return 1.0

    f1 = svc.warm_async("1d3p", (128,), steps=5, timer=slow_timer)
    f2 = svc.warm_async("1d3p", (128,), steps=5, timer=slow_timer)
    assert f1 is f2
    release.set()
    f1.result(timeout=60)
    n = len(calls)
    f3 = svc.warm_async("1d3p", (128,), steps=5, timer=slow_timer)
    assert f3.result(timeout=60) is not None
    assert len(calls) == n              # a re-warm is a cache hit
    svc.close()


def test_warm_async_close_cancels_queued_warms(cache_path):
    svc = StencilService(cache_path=cache_path, device=CPU)
    started = threading.Event()
    release = threading.Event()

    def slow_timer(fn, plan):
        started.set()
        release.wait(timeout=30)
        return 1.0

    inflight = svc.warm_async("1d3p", (128,), timer=slow_timer)
    assert started.wait(timeout=30)
    queued = svc.warm_async("1d3p", (256,), timer=slow_timer)
    svc.close(wait=False)
    assert queued.cancelled()
    release.set()
    assert inflight.result(timeout=60) is not None
    with pytest.raises(RuntimeError, match="closed"):
        svc.warm_async("1d3p", (128,))
    _check_sweep(svc)
    svc.close()                          # idempotent


def test_warm_async_close_race_late_publish_is_noop(cache_path):
    svc = StencilService(cache_path=cache_path, device=CPU)
    started = threading.Event()
    release = threading.Event()

    def slow_timer(fn, plan):
        started.set()
        release.wait(timeout=30)
        return 0.001

    fut = svc.warm_async("1d3p", (128,), timer=slow_timer)
    assert started.wait(timeout=30)
    svc.close(wait=False)
    with svc._lock:
        assert not svc._warming
    release.set()
    plan = fut.result(timeout=60)
    assert isinstance(plan, StencilPlan)
    assert autotune.cached_plan(_prob(), cache_path=cache_path) == plan
    with svc._lock:
        assert not svc._plans
        assert not svc._warming
    svc.close()


def test_context_manager_closes(cache_path):
    with StencilService(cache_path=cache_path, device=CPU) as svc:
        svc.plan_for("1d3p", (128,))
    with pytest.raises(RuntimeError, match="closed"):
        svc.sweep_async("1d3p", torch.zeros(128), 2)


# ---------------------------------------------------------------------------
# the memo and the device
# ---------------------------------------------------------------------------

def test_lru_evicts_problems_and_their_plans(cache_path, monkeypatch):
    monkeypatch.setattr(StencilService, "MAX_SIGNATURES", 2)
    autotune.tune(_prob(), cache_path=cache_path,
                  timer=lambda fn, p: 0.001 if p.scheme == "reorg" and p.k == 1 else 1.0)
    svc = StencilService(cache_path=cache_path, device=CPU)
    svc.plan_for("1d3p", (128,))
    assert any(k[0] == ("1d3p", (128,), "float32") for k in svc._plans)
    svc.plan_for("1d3p", (256,))
    svc.plan_for("1d3p", (512,))
    assert list(svc._problems) == [("1d3p", (256,), "float32"), ("1d3p", (512,), "float32")]
    assert not any(k[0] == ("1d3p", (128,), "float32") for k in svc._plans)


def test_unexecutable_distributed_plan_degrades_to_default(cache_path):
    prob = _prob()
    dist = StencilPlan(scheme="transpose", k=2, backend="distributed", decomp=(64,))
    w = autotune.PlanCache(cache_path)
    w.put(autotune.plan_key("1d3p", (128,), prob.dtype, "auto",
                            device=autotune.device_signature(prob.device)),
          {"plan": autotune.plan_to_dict(dist), "seconds_per_step": 1.0})
    w.save()
    assert not engine._plan_executable(dist)
    assert engine._plan_executable(StencilPlan(backend="pallas"))
    svc = StencilService(cache_path=cache_path, device=CPU)
    assert svc.plan_for("1d3p", (128,)) == prob.default_plan()


def test_service_problems_live_on_its_device(cache_path):
    svc = StencilService(cache_path=cache_path, device=CPU)
    prob, plan = svc.resolve("2d5p", (16, 64), torch.bfloat16, steps=3)
    assert prob.device == torch.device("cpu") and prob.dtype == torch.bfloat16
    assert plan == prob.default_plan()
    assert ("2d5p", (16, 64), "bfloat16") in svc._problems
    y = svc.sweep("2d5p", np.ones((16, 64), np.float32), 3)
    assert y.device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            StencilService(cache_path=cache_path)
