"""Serving engine: per-request prefill and batched decode with continuous
batching (the reference's ``serve/engine.ContinuousBatcher``), and the
stencil sweep service ``StencilService`` (the reference's, below).

  * continuous batching: a fixed-slot batch; finished sequences release
    their slot, queued requests claim it (the slot's cache lane is
    overwritten by the new request's prefill);
  * greedy or temperature sampling (temperature from an explicit
    ``torch.Generator``);
  * per-slot position counters.

Decode runs at a fixed width of ``decode_lanes(n_slots)`` lanes, a
multiple of 8, whatever the number of slots.  The card's matrix-product
and reduction kernels choose their algorithm by shape, so one row's
result can depend on how many rows share the call (decoding at
``n_slots`` lanes, a mamba2-2.7b request gave other greedy tokens in a
4-slot batch than alone on an H100; PERF.md); at a fixed width a request
decodes to the same tokens in a 1-slot engine as in a batch of up to 8.
Lanes past ``n_slots`` carry token 0 and are never read.

``StencilService`` serves stencil sweeps with plans from the autotuner's
persistent plan cache (tuned offline, or off the request path by
``warm_async``); the serving path itself never measures, and a cold cache
serves the static default plan.  ``sweep_async`` queues requests onto a
``serve/batcher.StencilSweepBatcher``, which coalesces them into batched
runs (``StencilProblem.run_batched``).

Entry points run on the card unless the caller passes ``device="cpu"``;
there is no fallback from a failed kernel to the CPU.
"""
from __future__ import annotations

import collections
import concurrent.futures
import dataclasses
import threading
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core.api import resolve_device
from repro_torch.models import transformer

LANE_MULTIPLE = 8


def decode_lanes(n_slots: int) -> int:
    return -(-n_slots // LANE_MULTIPLE) * LANE_MULTIPLE


def make_serve_step(model: transformer.Model, temperature: float = 0.0):
    """(params, cache, batch1, pos, generator) → (next_token, logits, cache)."""
    def step(params, cache, batch1, pos, generator=None):
        logits, cache = model.decode_step(params, cache, batch1, pos)
        logits = logits[:, 0].to(torch.float32)
        if temperature > 0.0:
            probs = torch.softmax(logits / temperature, dim=-1)
            tok = torch.multinomial(probs, 1, generator=generator)[:, 0]
        else:
            tok = torch.argmax(logits, dim=-1)
        return tok, logits, cache
    return step


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # (S,) int
    max_new: int
    out: list = dataclasses.field(default_factory=list)
    done: bool = False


class ContinuousBatcher:
    """Fixed-slot continuous batching over one shared decode step.

    ``stats`` accumulates prefill tokens and seconds and decode steps and
    seconds (host clock; each phase ends in a read of its result on the
    host, so the device work is inside the window)."""

    def __init__(self, model: transformer.Model, params, n_slots: int, max_seq: int,
                 temperature: float = 0.0, device=None, seed: int = 0):
        transformer.check_family(model.cfg)
        if model.cfg.frontend != "token":
            raise NotImplementedError("non-token frontends (audio frames, VLM patches) "
                                      "are not ported yet (ROADMAP A11)")
        self.model, self.params = model, params
        self.cfg = model.cfg
        self.device = resolve_device(device)
        self.n_slots, self.max_seq = n_slots, max_seq
        self.lanes = decode_lanes(n_slots)
        self.cache = model.init_cache(self.lanes, max_seq, device=self.device)
        self.pos = np.zeros(n_slots, np.int64)
        self.active: list[Optional[Request]] = [None] * n_slots
        self.queue: list[Request] = []
        self.step_fn = make_serve_step(model, temperature)
        self.prefill_fn = lambda p, b: model.prefill(p, b, max_seq=max_seq)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self._next_tok = np.zeros(self.lanes, np.int64)
        self.stats = {"prefills": 0, "prefill_tokens": 0, "prefill_s": 0.0,
                      "decode_steps": 0, "decode_s": 0.0}

    def submit(self, req: Request):
        self.queue.append(req)

    def _admit(self):
        for slot in range(self.n_slots):
            if self.active[slot] is None and self.queue:
                req = self.queue.pop(0)
                self.active[slot] = req
                start = time.perf_counter()
                tokens = torch.as_tensor(np.asarray(req.prompt)[None, :], dtype=torch.int64,
                                         device=self.device)
                logits, cache1 = self.prefill_fn(self.params, {"tokens": tokens})
                _write_slot(self.cache, cache1, slot)
                self._next_tok[slot] = int(torch.argmax(logits[0, 0]))
                self.stats["prefill_s"] += time.perf_counter() - start
                self.stats["prefills"] += 1
                self.stats["prefill_tokens"] += len(req.prompt)
                self.pos[slot] = len(req.prompt)

    def run(self, max_steps: int = 256) -> list[Request]:
        finished = []
        self._admit()
        for _ in range(max_steps):
            if not any(r is not None for r in self.active):
                break
            start = time.perf_counter()
            batch1 = {"tokens": torch.as_tensor(self._next_tok[:, None], device=self.device)}
            pos = torch.as_tensor(np.pad(self.pos, (0, self.lanes - self.n_slots)),
                                  device=self.device)
            tok, _, self.cache = self.step_fn(self.params, self.cache, batch1, pos,
                                              self.generator)
            tok = tok.cpu().numpy()
            self.stats["decode_s"] += time.perf_counter() - start
            self.stats["decode_steps"] += 1
            for slot, req in enumerate(self.active):
                if req is None:
                    continue
                req.out.append(int(tok[slot]))
                self.pos[slot] += 1
                self._next_tok[slot] = tok[slot]
                if len(req.out) >= req.max_new or self.pos[slot] >= self.max_seq - 1:
                    req.done = True
                    finished.append(req)
                    self.active[slot] = None
                    self.pos[slot] = 0
                    self._next_tok[slot] = 0
            self._admit()
        return finished


def _write_slot(cache, cache1, slot: int):
    """Copy a 1-batch cache into lane ``slot`` of the batched cache, in
    place: big (L, B, ...), small (L, 1, ...)."""
    transformer.tree_map(lambda big, small: big[:, slot:slot + 1].copy_(small), cache, cache1)
    return cache


def dtype_name(dtype) -> str:
    """``torch.float32`` → ``"float32"``: the dtype's part of a serving
    signature, as the reference's ``jnp.dtype(dtype).name``."""
    return str(dtype).removeprefix("torch.")


class StencilService:
    """Serve stencil sweep requests with cached autotuned plans.

    One ``StencilProblem`` per (stencil, shape, dtype) signature is kept hot
    (an LRU of ``MAX_SIGNATURES``), on the service's device: the card unless
    it is built with ``device="cpu"``.  A signature's plan is resolved from
    the plan cache (:func:`repro_torch.core.autotune.cached_plan`), the
    per-``steps`` key first, then the generic one, then the static default;
    ``warm=True`` may tune on a miss.

    :meth:`warm_async` tunes a signature off the request path on one
    background worker and publishes the winner into the plan cache and
    this service's memo; requests arriving meanwhile are served with what
    is already resolvable.  :meth:`sweep_async` is the continuous-batched
    entry: requests go to a lazily made
    :class:`~repro_torch.serve.batcher.StencilSweepBatcher`, are coalesced
    by (signature, steps) into one batched run and come back as futures.
    """

    MAX_SIGNATURES = 256      # LRU bound on memoized problems and plans

    def __init__(self, cache_path: str | None = None, device=None):
        self.cache_path = cache_path
        self.device = resolve_device(device)
        self._problems: collections.OrderedDict[tuple, Any] = collections.OrderedDict()
        self._plans: dict[tuple, Any] = {}       # (sig, steps) -> StencilPlan
        self._lock = threading.Lock()    # guards _problems, _plans, _warming
        self._warming: dict[tuple, concurrent.futures.Future] = {}
        self._executor: concurrent.futures.ThreadPoolExecutor | None = None
        self._batcher = None
        self._closed = False

    def _problem(self, name: str, shape: tuple, dtype):
        from repro_torch.core.api import StencilProblem
        key = (name, tuple(shape), dtype_name(dtype))
        with self._lock:
            if key in self._problems:
                self._problems.move_to_end(key)
            else:
                self._problems[key] = StencilProblem(name, shape, dtype, device=self.device)
                while len(self._problems) > self.MAX_SIGNATURES:
                    old, _ = self._problems.popitem(last=False)
                    for pk in [pk for pk in self._plans if pk[0] == old]:
                        del self._plans[pk]
            return key, self._problems[key]

    def warm_async(self, name: str, shape: tuple, dtype=torch.float32,
                   steps: int | None = None, **tune_kw) -> concurrent.futures.Future:
        """Tune a (possibly cold) signature on a background worker; the
        future resolves to the tuned plan, which is persisted to the plan
        cache and published into this service's memo, so that the next
        ``sweep`` / ``plan_for`` serves it without measuring.  Duplicate
        in-flight warms of one (signature, steps) share one future;
        distinct warms queue on ONE worker thread (no timing contention).
        The worker is not a daemon (a thread torn out of a kernel launch or
        a build could leave the card mid-call): call :meth:`close`, or use
        the service as a context manager, before exiting; it cancels the
        queued warms and awaits only the one in flight.  ``tune_kw`` goes
        to :func:`repro_torch.core.autotune.tune` (tests pass a stub
        ``timer``)."""
        sig = (name, tuple(shape), dtype_name(dtype))
        with self._lock:
            if self._closed:
                raise RuntimeError("StencilService is closed")
            fut = self._warming.get((sig, steps))
            if fut is not None:
                return fut
            if self._executor is None:
                self._executor = concurrent.futures.ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix="stencil-warm")
            fut = self._executor.submit(self._warm_one, name, tuple(shape), dtype, steps,
                                        tune_kw)
            self._warming[(sig, steps)] = fut
        # drop the in-flight marker once done (a re-warm is a cache hit)
        fut.add_done_callback(lambda f: self._warming.pop((sig, steps), None))
        return fut

    def close(self, wait: bool = True) -> None:
        """Shut the warm worker and the batcher down: queued warms are
        cancelled; the in-flight tune, if any, is awaited when ``wait`` (it
        still publishes); sweep requests already queued are drained (their
        futures resolve) before the batcher stops.  ``sweep`` and
        ``plan_for`` keep working; ``warm_async`` and ``sweep_async``
        refuse.  Idempotent."""
        with self._lock:
            self._closed = True
            ex, self._executor = self._executor, None
            batcher, self._batcher = self._batcher, None
            # a warm_async racing this close either saw _closed or already
            # registered its future: clearing here hands no stale future to
            # a later caller (the done-callbacks' pops become no-ops)
            self._warming.clear()
        # outside the lock: the batcher's workers call resolve(), which takes it
        if batcher is not None:
            batcher.close(wait=wait)
        if ex is not None:
            ex.shutdown(wait=wait, cancel_futures=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _warm_one(self, name, shape, dtype, steps, tune_kw):
        from repro_torch.core import autotune
        sig, prob = self._problem(name, shape, dtype)
        result = autotune.tune(prob, steps=steps, cache_path=self.cache_path, **tune_kw)
        # The reference re-proves a cached winner's layout invariants here
        # (its static audit, repro.analysis); the port has no audit yet
        # (ROADMAP A10) and publishes the plan as its tune() does.
        # Publish for exact hits, under the lock, only while the signature
        # is still memoized and the service open: a warm that outlives its
        # problem's LRU entry or close() still returns its plan (tune()
        # persisted it) but leaves no entry behind.
        with self._lock:
            if not self._closed and sig in self._problems:
                self._plans[(sig, steps)] = result.plan
                if steps is not None and autotune.normalize_steps(steps) is None:
                    self._plans[(sig, None)] = result.plan
        return result.plan

    def plan_for(self, name: str, shape: tuple, dtype=torch.float32,
                 steps: int | None = None, warm: bool = False):
        """The plan for a signature and, when given, a step count: the
        per-``steps`` cache key, the generic key, the static default.  Only
        exact hits are memoized, each under its own key, so that a later
        per-``steps`` tuning is served on the next request.  A cached plan
        this host cannot run (:func:`_plan_executable`) degrades to the
        default."""
        key, prob = self._problem(name, shape, dtype)
        return self._plan_for(key, prob, steps, warm)

    def resolve(self, name: str, shape: tuple, dtype=torch.float32,
                steps: int | None = None, warm: bool = False):
        """(problem, plan) of a signature with one lookup: what ``sweep``
        and the batcher run."""
        key, prob = self._problem(name, shape, dtype)
        return prob, self._plan_for(key, prob, steps, warm)

    def _plan_for(self, key: tuple, prob, steps: int | None, warm: bool):
        from repro_torch.core import autotune
        plan = self._plans.get((key, steps))
        if plan is None and steps is not None:
            plan = autotune.cached_plan(prob, steps=steps, cache_path=self.cache_path,
                                        generic_fallback=False)
            if plan is None and warm:
                plan = autotune.best_plan(prob, steps=steps, cache_path=self.cache_path)
            if plan is not None:
                with self._lock:
                    self._plans[(key, steps)] = plan
            else:
                plan = self._plans.get((key, None))
        if plan is None:
            plan = autotune.cached_plan(prob, cache_path=self.cache_path)
            if plan is None and warm and steps is None:
                plan = autotune.best_plan(prob, cache_path=self.cache_path)
            if plan is not None:
                with self._lock:
                    self._plans[(key, None)] = plan
        if plan is not None and not _plan_executable(plan):
            plan = None
        return plan or prob.default_plan()

    def sweep(self, name: str, x, steps: int, warm: bool = False) -> torch.Tensor:
        """Advance ``x`` by ``steps`` under the cached plan of its
        (signature, steps), on the service's device."""
        x = torch.as_tensor(x, device=self.device)
        prob, plan = self.resolve(name, x.shape, x.dtype, steps=steps, warm=warm)
        return prob.run(x, steps, plan)

    def sweep_async(self, name: str, x, steps: int, tenant: str = "default",
                    **batcher_kw) -> concurrent.futures.Future:
        """The continuous-batched entry: queue the request on this
        service's :class:`~repro_torch.serve.batcher.StencilSweepBatcher`
        (made on first use; ``batcher_kw`` configures it) and return a
        future of the advanced grid, bit for bit :meth:`sweep`'s.  A full
        queue raises :class:`~repro_torch.serve.batcher.BatcherFull` with a
        ``retry_after``.  Never measures."""
        with self._lock:
            if self._closed:
                raise RuntimeError("StencilService is closed")
            if self._batcher is None:
                from repro_torch.serve.batcher import StencilSweepBatcher
                self._batcher = StencilSweepBatcher(self, **batcher_kw)
            batcher = self._batcher
        return batcher.submit(name, x, steps, tenant=tenant)


def _plan_executable(plan) -> bool:
    """Can this host run the plan?  A distributed plan needs as many
    visible cards as its decomposition has shards (and the distributed
    runtime, ROADMAP A9, which ``run`` names when asked)."""
    if getattr(plan, "backend", "jnp") != "distributed":
        return True
    decomp = getattr(plan, "decomp", None)
    if not decomp:
        return True
    return int(np.prod(decomp)) <= torch.cuda.device_count()
