"""Continuous batching for stencil sweep serving: ``StencilSweepBatcher``
(the reference's ``serve/batcher.py``).

``StencilService.sweep`` serves one request at a time, so every request
pays its own transpose into the layout and out of it and every launch of
its sweep schedule.  This batcher queues requests and serves them in
batches:

  * **coalescing**: queued requests with the same ``(signature, steps)``,
    signature = (stencil, shape, dtype), are merged into ONE
    ``StencilProblem.run_batched_parts`` run.  The batch is a launch
    dimension of every sweep kernel, so the grids share one K2 in, one K2
    out and each launch of the ``sweep_schedule``, and each result is bit
    for bit that request's own ``sweep`` (the batch-invariance rule,
    :func:`repro_torch.core.autotune.plan_batch_invariant`);
  * **fixed-slot admission**: a batch of n requests runs at the smallest
    slot count of ``slot_counts`` (default 1, 2, 4, 8) at or above n,
    padded with copies of its first grid (computed and dropped: the grids
    of a batch never mix), so a (signature, steps) has at most
    ``len(slot_counts)`` batched programs, each resolved once;
  * **shape-bucketed admission**: a request whose minor extent is not a
    multiple of :data:`BUCKET_QUANTUM` joins the bucket of the smallest
    ``c`` copies of its grid along the minor axis that is (at most
    :data:`BUCKET_MAX_REPLICAS`).  A c-periodic grid stays c-periodic
    under a shift-invariant periodic stencil, so the first copy of the
    result, cropped out, is bit for bit the request's own run: near-miss
    shapes ((96,) and (192,), both (384,)) share one group and one
    program;
  * **backpressure**: the queue is bounded; a submit against a full queue
    raises :class:`BatcherFull` with a ``retry_after`` estimate (the
    moving mean of a batch's seconds times the batches queued);
  * **per-tenant fairness**: within a group, slots are filled round-robin
    across tenants, so a tenant flooding the queue cannot starve another;
  * **plan-aware scheduling**: the plan of a (signature, steps) is
    resolved once through ``StencilService.resolve`` (the cache or the
    static default: the batcher never measures) and pinned for the
    batcher's life.  A mesh-decomposed plan would claim every device
    exclusively (:class:`_MeshClaim`); the port runs none yet (ROADMAP
    A9), so single-device batches take the shared claim and pack onto the
    worker pool.

A batch's device work is synchronized before its seconds are read and its
futures are set; a failure is set on every future of the batch.  A
batcher built with ``start=False`` runs no thread: ``run_pending`` drains
it in the caller's thread (tests, offline use).
"""
from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import dataclasses
import threading
import time
from typing import Any, Optional

import torch

from repro_torch.serve.engine import dtype_name

__all__ = ["BatcherFull", "StencilSweepBatcher", "bucket_shape"]

SLOT_COUNTS = (1, 2, 4, 8)

# shape-bucketed admission: minor extents are padded, by periodic
# replication, up to a multiple of this quantum.  It is the reference's,
# the lane width of its TPU kernels, kept so that groups form as there;
# the card's own quantum is an open question (ROADMAP A8).  A shape that
# would need more than BUCKET_MAX_REPLICAS copies keeps its own signature.
BUCKET_QUANTUM = 128
BUCKET_MAX_REPLICAS = 8


def bucket_shape(shape: tuple) -> tuple[tuple, int]:
    """(bucketed shape, replicas): the admission bucket ``shape`` joins.
    Minor extents that are multiples of :data:`BUCKET_QUANTUM`, and shapes
    whose bucket needs more than :data:`BUCKET_MAX_REPLICAS` copies, map
    to themselves with 1 replica."""
    n = shape[-1]
    if n % BUCKET_QUANTUM == 0:
        return shape, 1
    for c in range(2, BUCKET_MAX_REPLICAS + 1):
        if (c * n) % BUCKET_QUANTUM == 0:
            return shape[:-1] + (c * n,), c
    return shape, 1


class BatcherFull(RuntimeError):
    """Queue-full rejection; ``retry_after`` (seconds) estimates when
    capacity frees up."""

    def __init__(self, retry_after: float):
        super().__init__(f"sweep queue full; retry after {retry_after:.3f}s")
        self.retry_after = retry_after


@dataclasses.dataclass
class _SweepRequest:
    tenant: str
    name: str
    x: torch.Tensor
    steps: int
    future: concurrent.futures.Future
    seq: int
    t_submit: float
    reps: int = 1          # minor-axis copies joining a shape bucket


class _Group:
    """Pending requests of one (signature, steps) key, a queue a tenant
    for the fair dequeue."""

    __slots__ = ("tenants", "total", "first_seq", "t_first")

    def __init__(self):
        self.tenants: collections.OrderedDict[str, collections.deque] = \
            collections.OrderedDict()
        self.total = 0
        self.first_seq = 0
        self.t_first = 0.0

    def add(self, req: _SweepRequest):
        if not self.total:
            self.first_seq, self.t_first = req.seq, req.t_submit
        dq = self.tenants.get(req.tenant)
        if dq is None:
            dq = self.tenants[req.tenant] = collections.deque()
        dq.append(req)
        self.total += 1

    def take(self, n: int) -> list[_SweepRequest]:
        """Dequeue up to ``n`` requests, one a tenant a rotation."""
        out: list[_SweepRequest] = []
        while self.total and len(out) < n:
            tenant, dq = next(iter(self.tenants.items()))
            out.append(dq.popleft())
            self.total -= 1
            del self.tenants[tenant]
            if dq:                          # back at the END: the next
                self.tenants[tenant] = dq   # rotation starts elsewhere
        if self.total:
            head = min((dq[0] for dq in self.tenants.values()), key=lambda r: r.seq)
            self.first_seq, self.t_first = head.seq, head.t_submit
        return out


class _MeshClaim:
    """A shared or exclusive claim on the devices: single-device batches
    hold it shared and run side by side; a mesh-decomposed batch would
    hold it alone (its program spans every device)."""

    def __init__(self):
        self._cv = threading.Condition()
        self._shared = 0
        self._exclusive = False

    @contextlib.contextmanager
    def shared(self):
        with self._cv:
            while self._exclusive:
                self._cv.wait()
            self._shared += 1
        try:
            yield
        finally:
            with self._cv:
                self._shared -= 1
                if not self._shared:
                    self._cv.notify_all()

    @contextlib.contextmanager
    def exclusive(self):
        with self._cv:
            while self._exclusive or self._shared:
                self._cv.wait()
            self._exclusive = True
        try:
            yield
        finally:
            with self._cv:
                self._exclusive = False
                self._cv.notify_all()


class StencilSweepBatcher:
    """Continuous batcher over a :class:`~repro_torch.serve.engine.StencilService`
    (the module docstring has the policy).

    Parameters
    ----------
    service:     the StencilService that resolves problems and plans.
    slot_counts: the batch sizes batches are padded to; the largest is
                 also the most requests a batch coalesces.
    max_queue:   queued (unstarted) requests before submits raise
                 :class:`BatcherFull`.
    max_wait_s:  how long the first request of a group waits for others
                 before its batch runs anyway.
    n_workers:   threads running batches (several let batches of other
                 signatures run side by side).
    start:       run the scheduler thread; ``False`` gives a passive
                 batcher that :meth:`run_pending` drains.
    """

    def __init__(self, service, slot_counts=SLOT_COUNTS, max_queue: int = 64,
                 max_wait_s: float = 0.002, n_workers: int = 2, start: bool = True):
        if not slot_counts or any(s < 1 for s in slot_counts):
            raise ValueError(f"bad slot_counts {slot_counts!r}")
        self.service = service
        self.slot_counts = tuple(sorted(set(int(s) for s in slot_counts)))
        self.max_slots = self.slot_counts[-1]
        self.max_queue = int(max_queue)
        self.max_wait_s = float(max_wait_s)
        self._cv = threading.Condition()
        self._groups: dict[tuple, _Group] = {}
        self._n_queued = 0
        self._seq = 0
        self._closed = False
        self._ema_batch_s = 0.05        # seed of the retry_after estimate
        # (sig, steps) -> (problem, plan), resolved once and pinned: a
        # retuned plan cache does not change the plan of a running key
        self._resolved: dict[tuple, tuple] = {}
        self._programs: set[tuple] = set()
        self._stats = collections.Counter()
        self._batch_log: list[dict] = []
        self._mesh = _MeshClaim()
        self._pool: Optional[concurrent.futures.ThreadPoolExecutor] = None
        self._thread: Optional[threading.Thread] = None
        if start:
            self._pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=n_workers, thread_name_prefix="stencil-batch")
            self._thread = threading.Thread(target=self._loop, name="stencil-batcher",
                                            daemon=True)
            self._thread.start()

    # ------------------------------------------------------------- submit
    def submit(self, name: str, x, steps: int,
               tenant: str = "default") -> concurrent.futures.Future:
        """Queue one sweep request; the future resolves to the advanced
        grid.  Raises :class:`BatcherFull` when the queue is full."""
        x = torch.as_tensor(x, device=self.service.device)
        # the group's signature carries the BUCKETED shape: near-miss minor
        # extents share a group (replicated at the batch's run, cropped at
        # its fan-out)
        bshape, reps = bucket_shape(tuple(x.shape))
        sig = (name, bshape, dtype_name(x.dtype))
        fut: concurrent.futures.Future = concurrent.futures.Future()
        with self._cv:
            if self._closed:
                raise RuntimeError("StencilSweepBatcher is closed")
            if self._n_queued >= self.max_queue:
                self._stats["rejected"] += 1
                raise BatcherFull(self._retry_after_locked())
            self._seq += 1
            req = _SweepRequest(tenant, name, x, int(steps), fut, self._seq,
                                time.monotonic(), reps)
            if reps > 1:
                self._stats["bucketed"] += 1
            group = self._groups.get((sig, steps))
            if group is None:
                group = self._groups[(sig, steps)] = _Group()
            group.add(req)
            self._n_queued += 1
            self._stats["submitted"] += 1
            # wake the scheduler only where this submit changes what it
            # would do: a new group opens its window, or a batch is full
            if group.total == 1 or group.total == self.max_slots:
                self._cv.notify_all()
        return fut

    def _retry_after_locked(self) -> float:
        n_batches = max(1, -(-self._n_queued // self.max_slots))
        return self._ema_batch_s * n_batches

    # ---------------------------------------------------------- scheduler
    def _ready_locked(self, now: float, force: bool) -> Optional[tuple]:
        """The oldest group whose batch should run now: it is full, its
        window ran out, or the batcher is draining."""
        best = None
        for key, g in self._groups.items():
            if not g.total:
                continue
            if force or g.total >= self.max_slots or now - g.t_first >= self.max_wait_s:
                if best is None or g.first_seq < self._groups[best].first_seq:
                    best = key
        return best

    def _next_deadline_locked(self, now: float) -> Optional[float]:
        ts = [g.t_first + self.max_wait_s for g in self._groups.values() if g.total]
        return max(0.0, min(ts) - now) if ts else None

    def _form_batch_locked(self, force: bool = False) -> Optional[tuple]:
        key = self._ready_locked(time.monotonic(), force)
        if key is None:
            return None
        group = self._groups[key]
        reqs = group.take(self.max_slots)
        if not group.total:
            del self._groups[key]
        self._n_queued -= len(reqs)
        return key, reqs

    def _loop(self):
        while True:
            with self._cv:
                batch = self._form_batch_locked(force=self._closed)
                if batch is None:
                    if self._closed:
                        return
                    self._cv.wait(self._next_deadline_locked(time.monotonic()))
                    continue
            self._pool.submit(self._run_batch, *batch)

    def run_pending(self):
        """Form and run every queued batch in the calling thread (the
        passive ``start=False`` mode; a deterministic drain in tests)."""
        while True:
            with self._cv:
                batch = self._form_batch_locked(force=True)
            if batch is None:
                return
            self._run_batch(*batch)

    # ---------------------------------------------------------- execution
    def _slots_for(self, n: int) -> int:
        for s in self.slot_counts:
            if s >= n:
                return s
        return self.max_slots

    def _run_batch(self, key: tuple, reqs: list[_SweepRequest]):
        (name, shape, dtype), steps = key
        try:
            resolved = self._resolved.get(key)
            if resolved is None:        # two workers may both resolve: same result
                resolved = self.service.resolve(name, shape, getattr(torch, dtype),
                                                steps=steps)
                self._resolved[key] = resolved
            prob, plan = resolved
            n_slots = self._slots_for(len(reqs))
            # pad to the slot count with the first request's grid: at most
            # len(slot_counts) programs a key; the grids of a batch never
            # mix, so the pad cannot change a result
            xs = [r.x if r.reps == 1 else torch.cat([r.x] * r.reps, dim=-1) for r in reqs]
            xs += [xs[0]] * (n_slots - len(xs))
            exclusive = plan.backend == "distributed" or plan.decomp is not None
            claim = self._mesh.exclusive if exclusive else self._mesh.shared
            t0 = time.monotonic()
            with claim():
                ys = prob.run_batched_parts(xs, steps, plan)
                if prob.device.type == "cuda":
                    torch.cuda.synchronize(prob.device)
            dt = time.monotonic() - t0
        except Exception as e:          # noqa: BLE001 — every coalesced
            for r in reqs:              # caller gets the failure
                if not r.future.cancelled():
                    r.future.set_exception(e)
            return
        with self._cv:
            self._ema_batch_s += 0.25 * (dt - self._ema_batch_s)
            self._programs.add((key, n_slots, plan))
            self._stats["batches"] += 1
            self._stats["served"] += len(reqs)
            self._stats["padded_slots"] += n_slots - len(reqs)
            self._batch_log.append({
                "sig": (name, shape, dtype), "steps": steps, "n": len(reqs), "slots": n_slots,
                "exclusive_mesh": exclusive, "tenants": [r.tenant for r in reqs],
                "wall_s": dt})
        for r, y in zip(reqs, ys):
            if not r.future.cancelled():
                if r.reps > 1:          # the first periodic copy
                    y = y[..., :r.x.shape[-1]]
                r.future.set_result(y)

    # ------------------------------------------------------------- status
    @property
    def stats(self) -> dict[str, Any]:
        """Counters, the per-batch log and the number of distinct programs
        (key, slots, plan) run."""
        with self._cv:
            out = dict(self._stats)
            out["n_queued"] = self._n_queued
            out["programs"] = len(self._programs)
            out["batch_log"] = list(self._batch_log)
            return out

    def close(self, wait: bool = True):
        """Stop admitting, run everything already queued (every future
        resolves), then stop the scheduler and workers.  Idempotent."""
        with self._cv:
            if self._closed:
                return
            self._closed = True
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join()
            self._pool.shutdown(wait=wait)
        else:
            self.run_pending()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
