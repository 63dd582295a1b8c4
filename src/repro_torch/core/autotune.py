"""The measured-search autotuner behind ``plan="auto"`` (reference:
``core/autotune.py``).

  1. :func:`candidate_plans` enumerates every legal ``StencilPlan`` for the
     problem: ``backend="auto"`` pools the jnp schemes, the pallas sweep
     engines (the port's CUDA kernels) and the mxu engine, each behind its
     legality gate (:func:`pallas_plan_legal`, :func:`ttile_plan_legal`,
     :func:`mxu_plan_legal`).
  2. the roofline of :mod:`repro_torch.roofline.stencil`, with constants
     fitted from earlier measured runs (:mod:`repro_torch.roofline.calibrate`,
     the H100 data sheet until samples exist), ranks them; the top
     ``max_measure`` survive, with at least one candidate of every backend
     in the pool, and the problem's default plan.
  3. each survivor is timed with ``problem.run`` (:func:`repro_torch.core.timing.bench`,
     CUDA events on the card) over a short window, and the fastest wins;
     every timed sample also feeds the calibration.
  4. the winner is written to a JSON plan cache keyed by problem signature,
     device signature, step count and code fingerprint, so that a later run
     reuses it without measuring.

Step counts, remainders, the key and the cache's record format
(``CACHE_VERSION = 2``) are the reference's; see its module docstring.

Where the port departs from the reference, each a GPU fact:

  * **its own files**: the plan cache at ``REPRO_TORCH_PLAN_CACHE`` or
    ``~/.cache/repro_torch/plan_cache.json``, the fitted constants beside it
    (``REPRO_TORCH_ROOFLINE_CONSTANTS``).  ``PlanCache.save`` drops every
    entry whose fingerprint is not its own, so a file shared with the
    reference would lose the other package's plans at each save.
  * :func:`device_signature` is torch's name of the card × the number of
    cards (``nvidia_h100_80gb_hbm3x1``), or ``cpux1`` for a CPU problem.
  * :func:`code_fingerprint` hashes the port's registry, schemes and
    modules, and every CUDA source and header of ``kernels/csrc``
    (``kernels/build.source_hash``, no compiler run): a kernel edit stales
    the plans.
  * **no interpret-mode penalty**: the ranking is the roofline's.
    :data:`INTERPRET_MAX_POINTS` keeps pallas out of the auto pool only for
    a CPU problem, where the port runs the kernels' plain versions; it
    never gates on the card.
  * **no TPU VMEM window gate**: :func:`pallas_plan_legal` and
    :func:`ttile_plan_legal` admit a plan exactly where the port's routes
    run it (:func:`pallas_routes_legal`), refusing what the kernels'
    wrappers would raise on; on the card the kernels take float32 and
    bfloat16 only.
  * :func:`mxu_plan_legal` also bounds device memory on the card: the
    operand is ``n_off`` copies of the grid.
  * **no static audit** (ROADMAP A10): ``tune`` behaves as the reference's
    does with ``REPRO_PLAN_AUDIT=0``; ``n_pruned_static``, ``audit_seconds``
    and ``pruned`` stay in the result and the record, 0 and empty.
  * **no distributed candidates** (ROADMAP A9): ``backend="distributed"``
    raises.
  * **a failing candidate**: only a plan that the port's own checks refuse
    (``ValueError``, ``NotImplementedError`` from ``problem.run``) or an
    error of an injected timer is skipped, and recorded under ``failed``
    in the cache record; any other error (the CUDA runtime, a kernel
    build) propagates, so that a kernel that fails never turns into a
    quietly chosen other plan.
"""
from __future__ import annotations

import dataclasses
import hashlib
import inspect
import logging
import math
import os
import threading
from typing import Sequence

import torch

from repro_torch.core import locked_json, stencils
from repro_torch.core.api import StencilPlan, plan_from_dict, plan_to_dict
from repro_torch.core.timing import bench
from repro_torch.roofline import calibrate
from repro_torch.roofline.stencil import estimate_plan_time, plan_terms

logger = logging.getLogger("repro_torch.autotune")

CACHE_VERSION = 2          # keys carry steps + code fingerprint
CACHE_ENV = "REPRO_TORCH_PLAN_CACHE"

# search space knobs (the reference's)
_VLS = (4, 8, 16)
_KS = (1, 2, 4)
_TTILES = (2, 4)           # temporal-tile factors of resident candidates
_HEIGHTS = (2, 4)          # tessellation heights
_MEASURE_STEPS = 4         # lcm-friendly with every k in _KS
_BLOCK_LCM = math.lcm(*_KS, *_HEIGHTS)
_MAX_M_PER_VL = 4          # cap on the pallas m axis per vector length
_MAX_T0 = 2                # cap on the pallas pipeline-tile axis

# a CPU problem runs the kernels' plain versions, whose measurement on a
# large grid costs minutes: the auto pool enumerates pallas there only up
# to this many points (an explicit backend="pallas" bypasses it)
INTERPRET_MAX_POINTS = 1 << 18

# the element types the CUDA stencil kernels take (``_kernel_io``), and
# the mxu engine's accumulation contracts (``matrixize.accum_dtype``)
KERNEL_DTYPES = (torch.float32, torch.bfloat16)
MXU_DTYPES = (torch.float32, torch.bfloat16, torch.float64)
# grid copies an mxu run holds beside its operand (the layout, a sweep's
# output, the untransposed result, a spare), and the share of the card's
# free memory a candidate may plan to take
MXU_EXTRA_COPIES = 4
MEMORY_SHARE = 0.9

_A9 = "distributed plans are not ported yet: they need the distributed runtime (ROADMAP A9)"


def default_cache_path() -> str:
    env = os.environ.get(CACHE_ENV)
    if env:
        return env
    return os.path.join(os.path.expanduser("~"), ".cache", "repro_torch",
                        "plan_cache.json")


device_kind = calibrate.device_kind


def device_signature(device=None) -> str:
    """Device component of the plan key: kind × visible device count."""
    dev = calibrate.default_device(device)
    if dev.type != "cuda":
        return "cpux1"
    return f"{device_kind(dev)}x{torch.cuda.device_count()}"


# ---------------------------------------------------------------------------
# code fingerprint — the self-invalidation hash
# ---------------------------------------------------------------------------

_fp_memo: dict[tuple, str] = {}


def _source_of(obj) -> str:
    try:
        return inspect.getsource(obj)
    except (OSError, TypeError):
        return repr(obj)


def code_fingerprint() -> str:
    """12-hex content hash of the stencil registry, the scheme registry
    (``vectorize.SCHEMES``, the source of each scheme), the modules a plan
    dispatches to (``core/vectorize``, ``unroll_jam``, ``tessellate``,
    ``layouts``, ``matrixize``, ``api``, ``kernels/stencil_kernels``,
    ``kernels/ops``) and every CUDA source and header of ``kernels/csrc``.

    Memoized on the registry objects themselves and the sources' hash."""
    from repro_torch.core import (api, layouts, matrixize, tessellate, unroll_jam,
                                  vectorize)
    from repro_torch.kernels import build
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import stencil_kernels

    memo_key = (
        tuple(sorted(vectorize.SCHEMES.items())),
        tuple(sorted(stencils._REGISTRY.items())),
        build.source_hash(),
    )
    hit = _fp_memo.get(memo_key)
    if hit is not None:
        return hit
    if len(_fp_memo) > 64:          # bound hot-reload / monkeypatch churn
        _fp_memo.clear()
    h = hashlib.sha256()
    for name, spec in sorted(stencils._REGISTRY.items()):
        h.update(repr((name, spec.ndim, spec.r, spec.kind, spec.taps)).encode())
    for name in sorted(vectorize.SCHEMES):
        h.update(name.encode())
        h.update(_source_of(vectorize.SCHEMES[name]).encode())
    for mod in (vectorize, unroll_jam, tessellate, layouts, matrixize, api,
                stencil_kernels, kops):
        h.update(_source_of(mod).encode())
    h.update(memo_key[-1].encode())
    fp = h.hexdigest()[:12]
    _fp_memo[memo_key] = fp
    return fp


def normalize_steps(steps: int | None) -> int | None:
    """Collapse step counts every candidate block divides to the generic
    (``steps=None``) plan: they have identical pools and remainders."""
    if steps is not None and steps % _BLOCK_LCM == 0:
        return None
    return steps


def plan_key(spec_name: str, shape: Sequence[int], dtype, backend: str,
             device: str | None = None, steps: int | None = None) -> str:
    """Cache key: signature | device signature | step count | fingerprint
    (``device`` a :func:`device_signature` string; ``None``: this host's
    default device)."""
    device = device_signature() if device is None else device
    return "|".join([spec_name, "x".join(str(n) for n in shape),
                     str(dtype).rsplit(".", 1)[-1], backend, device,
                     f"s{'*' if steps is None else steps}",
                     code_fingerprint()])


# ---------------------------------------------------------------------------
# persistent plan cache
# ---------------------------------------------------------------------------

class PlanCache:
    """On-disk JSON plan cache; load-once, explicit save, atomic write.

    Thread-safe within the process (every access to the entries and the
    dirty set goes through ``_tlock``); across processes the file lock of
    :mod:`repro_torch.core.locked_json`.  A ``put()`` racing a ``save()``
    is never lost: only keys whose written record is still current are
    marked clean."""

    def __init__(self, path: str | None = None):
        self.path = path or default_cache_path()
        self._tlock = threading.Lock()
        self._entries: dict[str, dict] = {}
        self._mtime: int | None = None
        self._dirty: set[str] = set()      # put() since last load/save
        self._load()

    def _load(self):
        self._entries = {}
        self._mtime = None
        try:
            self._mtime = os.stat(self.path).st_mtime_ns
        except OSError:
            return
        raw = locked_json.read_json(self.path)
        if raw is not None and raw.get("version") == CACHE_VERSION:
            self._entries = dict(raw.get("entries", {}))

    def refresh(self):
        """Re-read the file if another process wrote it since our last
        read.  Only unsaved local entries shadow the disk."""
        try:
            mtime = os.stat(self.path).st_mtime_ns
        except OSError:
            return
        with self._tlock:
            if mtime == self._mtime:
                return
            dirty = {k: self._entries[k] for k in self._dirty if k in self._entries}
            self._load()
            self._entries.update(dirty)

    def get(self, key: str) -> dict | None:
        with self._tlock:
            return self._entries.get(key)

    def put(self, key: str, record: dict):
        with self._tlock:
            self._entries[key] = record
            self._dirty.add(key)

    def save(self):
        """Read-merge-write under an exclusive file lock: our unsaved
        entries win on a key collision, the file wins for everything else;
        entries tuned against another fingerprint are dropped (their keys
        can never match again), records without one are kept."""
        written: dict[str, dict] = {}     # what THIS save persisted
        payload_entries: dict[str, dict] = {}

        def merge(raw: dict | None) -> dict:
            merged: dict[str, dict] = {}
            if raw is not None and raw.get("version") == CACHE_VERSION:
                merged = dict(raw.get("entries", {}))
            with self._tlock:
                written.update({k: self._entries[k] for k in self._dirty
                                if k in self._entries})
            merged.update(written)
            fp = code_fingerprint()
            merged = {k: v for k, v in merged.items()
                      if v.get("fingerprint") in (None, fp)}
            payload_entries.update(merged)
            return {"version": CACHE_VERSION, "entries": merged}

        def snapshot():       # file lock still held: no cross-process races
            with self._tlock:
                fresh = {k: self._entries[k] for k in self._dirty if k in self._entries}
                self._entries = dict(payload_entries)
                self._entries.update(fresh)
                self._dirty = {k for k in self._dirty
                               if self._entries.get(k) is not written.get(k)}
                try:
                    self._mtime = os.stat(self.path).st_mtime_ns
                except OSError:
                    pass

        locked_json.locked_update(self.path, merge, on_written=snapshot)

    def __len__(self):
        return len(self._entries)


_caches: dict[str, PlanCache] = {}


def get_cache(path: str | None = None) -> PlanCache:
    """Process-wide cache instance per path."""
    path = path or default_cache_path()
    if path not in _caches:
        _caches[path] = PlanCache(path)
    return _caches[path]


# ---------------------------------------------------------------------------
# candidate enumeration + backend legality gates
# ---------------------------------------------------------------------------

def _layout_pairs(n: int, r: int):
    """Legal (vl, m) for jnp layout schemes on a unit-stride extent n:
    blocks of vl·m must tile n and the halo must fit one vector set."""
    out = []
    for vl in _VLS:
        for m in dict.fromkeys((vl, max(vl // 2, 1), 2 * vl)):
            if m < r:
                continue
            if n % (vl * m):
                continue
            out.append((vl, m))
    return out


def _schedule_max_depth(k: int, steps: int | None, remainder: str,
                        ttile: int = 1) -> int:
    """Deepest single launch of the run's sweep schedule (a ``steps < k``
    run never executes the main k-block)."""
    from repro_torch.core.api import sweep_schedule
    chunks, _ = sweep_schedule(k, steps, remainder, ttile)
    return max((d for d, _ in chunks), default=1)


def _schedule_depths(k: int, steps: int | None, remainder: str, ttile: int,
                     sweep: str) -> set[int]:
    """Every launch depth a run of the plan can take: the schedule's
    chunks, and without a step count also the k-blocks and single steps a
    run of any length falls back to."""
    from repro_torch.core.api import sweep_schedule
    if sweep != "resident":
        ttile = 1
    depths = {d for d, _ in sweep_schedule(k, steps, remainder, ttile)[0]}
    if steps is None:
        depths |= {max(k, 1), 1}
    return depths


def _launch_ok(spec, nat: tuple[int, ...], vl: int, m: int, t0: int | None,
               depth: int, dtype) -> bool:
    """Whether one depth-``depth`` sweep (periodic, or the ring/open
    multistep: the same routes) of the natural grid ``nat`` at tile (vl, m,
    t0) runs on the card: the route and launches
    ``stencil_kernels.sweep_plan`` names, and the limits at which the
    wrappers raise (the register kernels' column count off their fixed
    forms; the far-reach kernel's fit of one step, each launch's tile, its
    tile count and 2^31 columns)."""
    from repro_torch.kernels import stencil_kernels as sk
    if spec.ndim > 3:
        return False
    r, n, ntaps = spec.r, nat[-1], len(spec.taps)
    nb = n // (vl * m)
    _, g = sk.sub_columns(m)
    f32 = dtype == torch.float32
    itemsize = torch.empty((), dtype=dtype).element_size()
    try:
        key, plan = sk.sweep_plan(spec, vl, m, depth, itemsize)
    except ValueError:
        return False
    if key == "1d":
        return not (g != 1 and nb * vl * g >= sk.MAX_COLS)
    if key == "2d":
        for mm, gg, d in plan:
            any_form = (vl != sk.WARP_LANES or gg != 1 or r != 1 or d > sk.WARP2D_DEPTH[mm, 1]
                        or not f32)
            if any_form and nb * vl * gg >= sk.MAX_COLS:
                return False
        return True
    if key == "3d":
        any_form = vl != sk.WARP_LANES or g != 1 or r != 1 or not f32
        return not (any_form and nb * vl * g >= sk.MAX_COLS)
    nz, ny = (1, 1) if spec.ndim == 1 else (nat[0], 1) if spec.ndim == 2 else tuple(nat[:2])
    try:
        for _, _, d in plan:
            ty, _, _, _ = sk.far_tile(spec.ndim, (nz, ny, n), m, r, d, ntaps, itemsize)
            if -(-ny // ty) > 65535:
                return False
    except ValueError:
        return False
    return nb * vl < 2 ** 31


def pallas_routes_legal(spec: stencils.StencilSpec, shape: Sequence[int], vl: int, m: int,
                        t0: int | None = None, sweep: str = "resident", *, k: int = 1,
                        steps: int | None = None, remainder: str = "fused", ttile: int = 1,
                        dtype=torch.float32) -> bool:
    """The port's gate in place of the reference's VMEM window: every
    launch of the plan's run takes a route of ``kernels/stencil_kernels``
    that does not raise at this shape.  The resident engine sweeps the grid
    itself; the roundtrip engine sweeps it wrap-padded along axis 0 by the
    whole blocks (1-D) or axis-0 tiles (n-D) that cover each sweep's
    depth·r (``ops.stencil_multistep_periodic``)."""
    from repro_torch.kernels import stencil_kernels as sk
    shape = tuple(shape)
    for depth in _schedule_depths(k, steps, remainder, ttile, sweep):
        nat = shape
        if sweep == "roundtrip":
            unit = vl * m if spec.ndim == 1 else t0
            pad = sk.sweep_halo_blocks(spec.r, depth, unit) * unit
            nat = (shape[0] + 2 * pad,) + shape[1:]
        if not _launch_ok(spec, nat, vl, m, t0, depth, dtype):
            return False
    return True


def pallas_plan_legal(spec: stencils.StencilSpec, shape: Sequence[int],
                      vl: int, m: int, t0: int | None = None,
                      sweep: str = "resident", *, ttile: int = 1,
                      k: int | None = None, steps: int | None = None,
                      remainder: str = "fused", dtype=torch.float32,
                      device=None) -> bool:
    """Backend legality gate for the pallas sweep engines.

    The reference's rules: the sweep engine is ``resident`` or
    ``roundtrip``; ``ttile > 1`` only on ``resident``; ``vl·m`` divides the
    minor extent; the halo fits a block (``r <= m``, ``r <= vl``); n-D: a
    pipeline tile ``t0 >= r`` dividing ``shape[0]``; with ``k`` given, the
    deepest launch of the schedule keeps ``depth·r`` within the pipelined
    extent.  The port's: every launch takes a route that runs
    (:func:`pallas_routes_legal`), and on the card the element type is one
    the kernels take."""
    if sweep not in ("resident", "roundtrip"):
        return False
    if ttile > 1 and sweep != "resident":
        return False
    n = shape[-1]
    r = spec.r
    if n % (vl * m) or m < r or vl < r:
        return False
    if spec.ndim > 1:
        if t0 is None or t0 < r or shape[0] % t0:
            return False
    if k is not None:
        kmax = _schedule_max_depth(k, steps, remainder, ttile)
        n_pipe = shape[0] if spec.ndim > 1 else n
        if kmax * r > n_pipe:
            return False
    if calibrate.default_device(device).type == "cuda" and dtype not in KERNEL_DTYPES:
        return False
    return pallas_routes_legal(spec, shape, vl, m, t0, sweep, k=k or 1, steps=steps,
                               remainder=remainder, ttile=ttile, dtype=dtype)


def _pallas_pairs(n: int, r: int) -> list[tuple[int, int]]:
    """(vl, m) pairs for the pallas backend: m over divisors of n/vl
    (non-power-of-two blocks reachable), at most ``_MAX_M_PER_VL`` a vl."""
    pairs = []
    for vl in _VLS:
        if vl < r or n % vl:
            continue
        q = n // vl
        divisors = [m for m in range(max(r, 2), min(2 * vl, q) + 1) if q % m == 0]
        # the square-ish tiles first, then the other divisors
        keep = [m for m in (vl, vl // 2, 2 * vl) if m in divisors]
        for m in divisors:
            if len(keep) >= _MAX_M_PER_VL:
                break
            if m not in keep:
                keep.append(m)
        pairs += [(vl, m) for m in sorted(keep)]
    return pairs


def _with_remainder(plan: StencilPlan, steps: int | None, block: int,
                    native_ok: bool = True) -> list[StencilPlan]:
    """Per-``steps`` axis: a remainder fans the plan out over both
    remainder policies; otherwise only the canonical (``fused``) one."""
    if steps is None or block <= 1 or steps % block == 0:
        return [plan]
    out = [dataclasses.replace(plan, remainder="fused")]
    if native_ok:
        out.append(dataclasses.replace(plan, remainder="native"))
    return out


def _free_bytes(device: torch.device) -> int:
    """Device memory a candidate may still take: free on the card, and
    what torch's allocator holds unused."""
    free, _ = torch.cuda.mem_get_info(device)
    return free + torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(device)


def mxu_plan_legal(spec: stencils.StencilSpec, shape: Sequence[int],
                   vl: int, m: int, dtype=torch.float32, *,
                   decomp: Sequence[int] | None = None,
                   k: int | None = None, steps: int | None = None,
                   remainder: str = "fused", ttile: int = 1,
                   device=None) -> bool:
    """Backend legality gate for the mxu (banded-operator) engine.

    The reference's rules: float32, bfloat16 or float64; ``vl·m`` divides
    the minor extent; the deepest launch's band ``depth·r`` fits one tile
    ``vl·m``; the construction-free operator bound fits
    ``matrixize.OPERATOR_BUDGET``.  The port's: on the card, the operand
    (``n_off`` copies of the grid, at the deepest launch) and
    ``MXU_EXTRA_COPIES`` more fit ``MEMORY_SHARE`` of the free memory.  A
    ``decomp`` needs the distributed runtime (ROADMAP A9)."""
    from repro_torch.core import matrixize
    if decomp is not None:
        raise NotImplementedError(_A9)
    if dtype not in MXU_DTYPES:
        return False
    shape = tuple(shape)
    if vl < 1 or m < 1 or shape[-1] % (vl * m):
        return False
    depth = _schedule_max_depth(k if k is not None else 1, steps, remainder, ttile)
    if depth * spec.r > vl * m:
        return False
    if matrixize.operator_bytes_bound(spec, vl, m, depth) > matrixize.OPERATOR_BUDGET:
        return False
    dev = calibrate.default_device(device)
    if dev.type == "cuda":
        n_off = matrixize.operator(spec, vl, m, depth).n_off
        need = (n_off + MXU_EXTRA_COPIES) * math.prod(shape) * dtype.itemsize
        if need > MEMORY_SHARE * _free_bytes(dev):
            return False
    return True


def _mxu_candidates(spec: stencils.StencilSpec, shape: tuple[int, ...],
                    dtype, steps: int | None, device=None) -> list[StencilPlan]:
    """The mxu axis of the pool: (vl, m) operator tiles × k × remainder ×
    ttile, single-device (the reference's ``decomp=None`` slice)."""
    shape = tuple(shape)
    cands: list[StencilPlan] = []
    for vl, m in _pallas_pairs(shape[-1], spec.r)[:2]:
        for k in _KS:
            base = StencilPlan(scheme="transpose", k=k, vl=vl, m=m, backend="mxu")
            variants = [p for p in _with_remainder(base, steps, k)
                        if mxu_plan_legal(spec, shape, vl, m, dtype, k=k, steps=steps,
                                          remainder=p.remainder, device=device)]
            cands += _ttile_fanout(spec, shape, variants, steps, dtype, device)
    return cands


def ttile_plan_legal(spec: stencils.StencilSpec, shape: Sequence[int],
                     plan: StencilPlan, steps: int | None = None,
                     dtype=torch.float32, device=None) -> bool:
    """Legality gate for the temporal-tile axis of a resident plan.

    ``ttile = 1`` is always legal.  For ``ttile > 1`` (the reference's
    rules): only the resident engines time-tile (pallas ``resident``, mxu);
    with ``steps`` given, one full ``ttile·k`` block must run; the
    depth-``ttile·k`` halo slope fits the pipelined extent; an mxu plan is
    then :func:`mxu_plan_legal` at that depth.  In place of the reference's
    VMEM window: a pallas plan's launches take routes that run
    (:func:`pallas_routes_legal`).  Distributed plans need ROADMAP A9."""
    tt = plan.ttile
    if tt < 1:
        return False
    if tt == 1:
        return True
    if plan.backend == "distributed":
        raise NotImplementedError(_A9)
    if steps is not None and steps // max(plan.k, 1) < tt:
        return False
    if plan.backend == "mxu":
        vl = plan.vl if plan.m is not None else 8
        m = plan.m if plan.m is not None else 8
        return mxu_plan_legal(spec, shape, vl, m, dtype, decomp=plan.decomp, k=plan.k,
                              steps=steps, remainder=plan.remainder, ttile=tt, device=device)
    if plan.backend != "pallas" or plan.sweep != "resident":
        return False
    depth = tt * max(plan.k, 1)
    shape = tuple(shape)
    n_pipe = shape[0] if spec.ndim > 1 else shape[-1]
    if depth * spec.r > n_pipe:
        return False
    vl = plan.vl if plan.m is not None else 8
    m = plan.m if plan.m is not None else 8
    return pallas_routes_legal(spec, shape, vl, m, plan.t0, plan.sweep, k=plan.k, steps=steps,
                               remainder=plan.remainder, ttile=tt, dtype=dtype)


def _ttile_fanout(spec: stencils.StencilSpec, shape: Sequence[int],
                  plans: list[StencilPlan], steps: int | None, dtype=torch.float32,
                  device=None) -> list[StencilPlan]:
    """Each legal base plan also enumerates its ``ttile`` ∈ ``_TTILES``
    variants that pass :func:`ttile_plan_legal`; the base plans stay."""
    out = list(plans)
    for plan in plans:
        for tt in _TTILES:
            cand = dataclasses.replace(plan, ttile=tt)
            if ttile_plan_legal(spec, shape, cand, steps, dtype, device):
                out.append(cand)
    return out


def _pallas_candidates(spec: stencils.StencilSpec, shape: tuple[int, ...],
                       steps: int | None, dtype=torch.float32, device=None,
                       budget_gate: bool = False) -> list[StencilPlan]:
    if budget_gate and calibrate.default_device(device).type == "cpu" and \
            math.prod(shape) > INTERPRET_MAX_POINTS:
        return []          # the plain versions' measurement too costly
    n0 = shape[0]
    cands: list[StencilPlan] = []
    if spec.ndim == 1:
        t0s: list[int | None] = [None]
    else:
        t0s = [t for t in (8, 4, 2) if t <= n0 and n0 % t == 0 and t >= spec.r][:_MAX_T0]
    for vl, m in _pallas_pairs(shape[-1], spec.r):
        for t0 in t0s:
            for sweep in ("resident", "roundtrip"):
                if not pallas_plan_legal(spec, shape, vl, m, t0, sweep, dtype=dtype,
                                         device=device):
                    continue
                for k in _KS:
                    plan = StencilPlan(scheme="transpose", k=k, vl=vl, m=m,
                                       t0=t0, backend="pallas", sweep=sweep)
                    variants = [
                        p for p in _with_remainder(plan, steps, k)
                        if pallas_plan_legal(spec, shape, vl, m, t0, sweep, k=k, steps=steps,
                                             remainder=p.remainder, dtype=dtype,
                                             device=device)]
                    cands += _ttile_fanout(spec, shape, variants, steps, dtype, device)
    return cands


def candidate_plans(spec: stencils.StencilSpec, shape: Sequence[int],
                    dtype=torch.float32, backend: str = "auto",
                    steps: int | None = None, device=None) -> list[StencilPlan]:
    """Every legal StencilPlan for (spec, shape, dtype, backend) on
    ``device`` (``None``: the card when there is one).

    ``backend="auto"`` pools the jnp, pallas and mxu candidates in one
    list.  When ``steps`` is given, k>1 candidates whose block does not
    divide it fan out along the remainder-policy axis."""
    shape = tuple(shape)
    n = shape[-1]

    if backend == "auto":
        return (candidate_plans(spec, shape, dtype, "jnp", steps, device)
                + _pallas_candidates(spec, shape, steps, dtype, device, budget_gate=True)
                + _mxu_candidates(spec, shape, dtype, steps, device))
    if backend == "pallas":
        return _pallas_candidates(spec, shape, steps, dtype, device)
    if backend == "mxu":
        return _mxu_candidates(spec, shape, dtype, steps, device)
    if backend == "distributed":
        raise NotImplementedError(_A9)
    if backend != "jnp":
        raise ValueError(f"unknown backend {backend!r}")

    # jnp backend -----------------------------------------------------------
    cands = []
    for scheme in ("fused", "reorg", "multiload"):
        cands.append(StencilPlan(scheme=scheme, k=1))
    if n % min(_VLS) == 0:
        cands.append(StencilPlan(scheme="dlt", k=1, vl=min(_VLS)))
    for vl, m in _layout_pairs(n, spec.r):
        cands.append(StencilPlan(scheme="transpose", k=1, vl=vl, m=m))
    # multistep_fused blocks: the scheme is not used and both remainder
    # policies run the same single steps, so no native variant
    for k in _KS[1:]:
        cands += _with_remainder(StencilPlan(scheme="transpose", k=k), steps, k,
                                 native_ok=False)
    from repro_torch.core.tessellate import fit_tile
    for h in _HEIGHTS:
        tile = fit_tile(spec, shape, h, strict=True)
        if tile is not None:
            cands += _with_remainder(
                StencilPlan(scheme="fused", k=1, tiling="tessellate", tile=tile, height=h),
                steps, h)
    return cands


# ---------------------------------------------------------------------------
# search
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TuneResult:
    key: str
    plan: StencilPlan
    seconds_per_step: float
    n_candidates: int
    n_measured: int
    cached: bool                       # True: served from the plan cache
    measurements: list[dict] = dataclasses.field(default_factory=list)
    n_pruned_static: int = 0           # no static audit yet (ROADMAP A10)
    audit_seconds: float = 0.0
    pruned: list = dataclasses.field(default_factory=list)
    failed: list[dict] = dataclasses.field(default_factory=list)  # skipped candidates


def _default_timer(fn, plan: StencilPlan, device=None) -> float:
    return bench(fn, device=calibrate.default_device(device), warmup=1, iters=2, min_time_s=0.05)


def _rank_time(spec, shape, itemsize, plan, steps, constants=None) -> float:
    return estimate_plan_time(spec, shape, itemsize, plan, steps=steps, constants=constants)


def _auto_measure_steps(steps: int | None) -> int:
    """Measurement window: congruent to ``steps`` mod every block size
    (``_BLOCK_LCM + steps % _BLOCK_LCM``), so tuning cost never scales
    with the run length."""
    if steps is None:
        return _MEASURE_STEPS
    return min(steps, _BLOCK_LCM + steps % _BLOCK_LCM)


def _stratify(survivors: list[StencilPlan], ranked: list[StencilPlan]):
    """Every backend in the ranked pool keeps at least one measured
    candidate (its best-ranked one)."""
    have = {p.backend for p in survivors}
    for p in ranked:
        if p.backend not in have:
            survivors.append(p)
            have.add(p.backend)
    return survivors


def tune(problem, backend: str = "auto", steps: int | None = None,
         cache_path: str | None = None, timer=None, max_measure: int = 8,
         measure_steps: int | None = None, force: bool = False,
         calibrate_samples: bool | None = None) -> TuneResult:
    """Resolve the best plan for ``problem`` (a StencilProblem) on its
    device.

    Cache hit → returns at once.  Miss (or ``force=True``) → enumerate,
    roofline-prune to ``max_measure`` (at least one candidate of each
    backend, and the default plan), time each survivor with ``timer(fn,
    plan)`` (seconds per ``measure_steps`` steps; by default
    ``timing.bench``, CUDA events on the card), persist the winner.

    A survivor that the port's own checks refuse (``ValueError``,
    ``NotImplementedError`` raised by ``problem.run``), or whose injected
    timer raises, is skipped and listed under ``failed``; any other error
    propagates.  ``calibrate_samples``: whether the measured samples feed
    the persistent calibration (default: only with the real timer)."""
    spec = problem.spec
    dev = problem.device
    if calibrate_samples is None:
        calibrate_samples = timer is None
    steps = normalize_steps(steps)
    key = plan_key(spec.name, problem.shape, problem.dtype, backend,
                   device=device_signature(dev), steps=steps)
    cache = get_cache(cache_path)
    if not force:
        cache.refresh()
        hit = cache.get(key)
        if hit is not None:
            return TuneResult(key=key, plan=plan_from_dict(hit["plan"]),
                              seconds_per_step=hit["seconds_per_step"],
                              n_candidates=hit.get("n_candidates", 0),
                              n_measured=hit.get("n_measured", 0),
                              cached=True)

    injected = timer is not None
    if timer is None:
        def timer(fn, plan):
            return _default_timer(fn, plan, device=dev)
    cands = candidate_plans(spec, problem.shape, problem.dtype, backend, steps=steps,
                            device=dev)
    if not cands:
        raise ValueError(f"no legal plans for {key}")
    itemsize = problem.dtype.itemsize
    # per-device-kind peaks fitted from earlier runs (the H100 data sheet
    # until samples exist)
    constants = calibrate.load_constants(device=device_kind(dev), cache_path=cache.path)
    ranked = sorted(cands, key=lambda p: _rank_time(spec, problem.shape, itemsize, p, steps,
                                                    constants))
    survivors = _stratify(ranked[:max_measure], ranked)
    # the static default stays in the pool, so the tuned plan never loses to it
    default = problem.default_plan()
    if backend in ("jnp", "auto") and default not in survivors:
        survivors.append(default)

    measure_steps = measure_steps or _auto_measure_steps(steps)
    x = problem.init(seed=0)
    measurements, failed = [], []
    best, best_t = None, float("inf")
    for plan in survivors:
        run_errors: list[BaseException] = []

        def fn(p=plan):
            try:
                return problem.run(x, measure_steps, p)
            except Exception as e:
                run_errors.append(e)
                raise
        try:
            t = float(timer(fn, plan)) / measure_steps
        except Exception as e:
            from_run = any(e is r for r in run_errors)
            if from_run and not isinstance(e, (ValueError, NotImplementedError)):
                raise
            if not from_run and not injected:
                raise
            failed.append({"plan": plan_to_dict(plan), "error": f"{type(e).__name__}: {e}"})
            logger.warning("candidate %s skipped: %s", plan, e)
            continue
        measurements.append({"plan": plan_to_dict(plan), "seconds_per_step": t})
        logger.info("measured %s: %.3es/step", plan, t)
        if t < best_t:
            best, best_t = plan, t
    del x
    if best is None:
        raise RuntimeError(f"every candidate failed for {key}: {failed}")

    if calibrate_samples:
        # a grid that fits a cache measures the cache's rate: its samples
        # do not fit the bandwidth term
        working_set = 2.0 * math.prod(problem.shape) * itemsize
        fit_bw = working_set >= calibrate.min_bandwidth_working_set(dev)
        samples = []
        for row in measurements:
            p = plan_from_dict(row["plan"])
            f, b, c = plan_terms(spec, problem.shape, itemsize, p, steps)
            sample = {"flops": f, "bytes": b if fit_bw else 0.0, "coll_bytes": c,
                      "seconds": row["seconds_per_step"]}
            if p.backend == "mxu":
                # GEMM flops fit the mxu peak of their element type
                field = "mxu_bf16_flops" if itemsize == 2 else "mxu_flops"
                sample[field], sample["flops"] = sample["flops"], 0.0
            samples.append(sample)
        try:
            calibrate.record_samples(samples, device=device_kind(dev), cache_path=cache.path)
        except OSError as e:                  # calibration is best-effort
            logger.warning("roofline calibration not persisted: %s", e)

    record = {"plan": plan_to_dict(best), "seconds_per_step": best_t,
              "fingerprint": code_fingerprint(),
              "n_candidates": len(cands), "n_measured": len(measurements),
              "n_pruned_static": 0, "audit_seconds": 0.0, "pruned": [],
              "failed": failed, "measurements": measurements}
    cache.put(key, record)
    cache.save()
    logger.info("tuned %s → %s (%.3es/step, %d measured of %d, %d failed)", key, best,
                best_t, len(measurements), len(cands), len(failed))
    return TuneResult(key=key, plan=best, seconds_per_step=best_t,
                      n_candidates=len(cands), n_measured=len(measurements),
                      cached=False, measurements=measurements, failed=failed)


def best_plan(problem, backend: str = "auto", steps: int | None = None,
              cache_path: str | None = None, **kw) -> StencilPlan:
    return tune(problem, backend=backend, steps=steps, cache_path=cache_path, **kw).plan


def plan_batch_invariant(plan: StencilPlan) -> bool:
    """May a plan tuned for the unbatched (stencil, shape, dtype)
    signature serve a leading-batch-axis run unchanged?  The reference's
    rule (plan keys carry no batch size): the layout axes, k-blocking,
    temporal tiling and sweep schedule of jnp, pallas and mxu plans never
    absorb the batch, and distributed plans run elements one after
    another.  Stencil serving (ROADMAP A8) consults it; unknown backends
    fail closed."""
    return plan.backend in ("jnp", "pallas", "mxu", "distributed")


def cached_plan(problem, backend: str = "auto", steps: int | None = None,
                cache_path: str | None = None,
                generic_fallback: bool = True) -> StencilPlan | None:
    """Cache lookup only — never measures (the serving path's).  The
    per-``steps`` key first, then (unless ``generic_fallback=False``) the
    generic key."""
    cache = get_cache(cache_path)
    cache.refresh()
    steps = normalize_steps(steps)
    device = device_signature(problem.device)
    keys = [plan_key(problem.spec.name, problem.shape, problem.dtype, backend,
                     device=device, steps=steps)]
    if steps is not None and generic_fallback:
        keys.append(plan_key(problem.spec.name, problem.shape, problem.dtype, backend,
                             device=device, steps=None))
    for key in keys:
        hit = cache.get(key)
        if hit is not None:
            return plan_from_dict(hit["plan"])
    return None
