"""Public stencil API of the port.

    from repro_torch.core.api import StencilPlan, StencilProblem
    p = StencilProblem("2d5p", shape=(512, 512))                 # on cuda
    y = p.run(x, steps=100, plan=StencilPlan(backend="pallas"))

``StencilPlan`` keeps the reference's field set and values, so a plan dict
round-trips between the two packages (:func:`plan_to_dict`,
:func:`plan_from_dict`).  The port runs every single-device backend:

  * ``backend="jnp"`` (the default, and ``plan="default"``): the paper's
    vectorization schemes (``core/vectorize.py``), ``multistep_fused`` for
    k > 1 (``core/unroll_jam.py``) and ``tiling="tessellate"``
    (``core/tessellate.py``) — plain PyTorch programs on either device, as
    the reference's jnp backend is plain XLA;
  * ``backend="pallas"``: the layout-resident sweep engine
    (``sweep="resident"``) and the per-sweep roundtrip engine
    (``sweep="roundtrip"``), whose kernels here are hand-written CUDA for
    Hopper rather than Pallas — the backend keeps its reference name so
    that plans stay interchangeable;
  * ``backend="mxu"``: the banded-operator engine (``core/matrixize.py``),
    one matrix product a sweep.

``plan="auto"``, the default of :meth:`StencilProblem.run`, runs the
autotuner (``core/autotune.py``): it times the best-ranked jnp, pallas and
mxu candidates on the problem's device (the CUDA kernels on the card, their
plain versions on the CPU) for the run's step count, and caches the winner
in ``~/.cache/repro_torch/plan_cache.json`` (``REPRO_TORCH_PLAN_CACHE``
elsewhere), so that a later run of the same signature does not measure.
``backend="distributed"`` and an mxu plan with a ``decomp`` (the
distributed runtime, ROADMAP A9) raise ``NotImplementedError`` naming the
item that ports them; the other backends ignore ``decomp``, as the
reference's do.

:meth:`StencilProblem.run_batched` advances a batch of grids, ``(B,) +
shape``, under one plan: the serving path's entry
(``serve/batcher.py``).  The batch is a launch dimension of every sweep
kernel, so B grids share one K2 in, one K2 out and each launch of the
sweep schedule; each grid's result is bit for bit its own ``run`` (mxu:
within the rounding of a product with more rows).
"""
from __future__ import annotations

import collections
import dataclasses
import threading
from typing import Callable, Sequence

import torch

from repro_torch.core import stencils, tessellate, unroll_jam, vectorize


def sweep_schedule(k: int, steps: int | None,
                   remainder: str = "fused", ttile: int = 1
                   ) -> tuple[list[tuple[int, int]], int]:
    """The (depth, n_launches) blocks a ``steps``-long k-blocked run
    executes: the ``ttile``-grouped main k-blocks, the ungrouped k-block
    leftovers, then the remainder policy ("native": one k=rem sweep;
    "fused": rem single-step sweeps).  ``steps=None`` yields one canonical
    depth-``ttile·k`` block.  Returns (chunks, total steps to amortize
    over).  ``ttile`` only regroups the main k-blocks, so any (steps, k,
    remainder) run is bit-identical at every ttile."""
    k = max(k, 1)
    ttile = max(ttile, 1)
    if steps is None:
        return [(k * ttile, 1)], k * ttile
    n_main, rem = divmod(steps, k)
    n_tt, tt_rem = divmod(n_main, ttile)
    chunks = []
    if n_tt:
        chunks.append((k * ttile, n_tt))
    if tt_rem:
        chunks.append((k, tt_rem))
    if rem:
        chunks.append((rem, 1) if remainder == "native" else (1, rem))
    return chunks, steps


@dataclasses.dataclass(frozen=True)
class StencilPlan:
    """An execution plan; the field set and values are the reference's.

    ``backend="pallas"`` names the sweep engines (``sweep``), which the
    port runs on hand-written CUDA kernels (``kernels/csrc``) on a CUDA
    tensor and on their plain PyTorch versions on a CPU tensor.
    """
    scheme: str = "transpose"
    k: int = 2
    tiling: str = "none"           # none | tessellate
    tile: tuple[int, ...] | None = None
    height: int | None = None      # tessellation height (defaults to k)
    vl: int = 8
    m: int | None = None
    backend: str = "jnp"           # jnp | pallas | mxu | distributed
    t0: int | None = None          # n-D axis-0 rows per kernel tile
    remainder: str = "fused"       # fused | native — steps % k policy
    sweep: str = "resident"        # resident | roundtrip
    decomp: tuple[int, ...] | None = None   # distributed: shards per axis
    ttile: int = 1                 # temporal tile: k-blocks per launch
    overlap: bool = False          # distributed resident: halo overlap


def plan_to_dict(plan: StencilPlan) -> dict:
    d = dataclasses.asdict(plan)
    d["tile"] = list(plan.tile) if plan.tile is not None else None
    d["decomp"] = list(plan.decomp) if plan.decomp is not None else None
    return d


def plan_from_dict(d: dict) -> StencilPlan:
    d = dict(d)
    if d.get("tile") is not None:
        d["tile"] = tuple(d["tile"])
    if d.get("decomp") is not None:
        d["decomp"] = tuple(d["decomp"])
    return StencilPlan(**d)


# ROADMAP items that port what the reference runs for these plan values.
_NOT_PORTED = {
    "distributed": "the distributed runtime (ROADMAP A9)",
}


def resolve_device(device) -> torch.device:
    """``None`` means the card.  Without a CUDA device that raises: the
    caller asks for the CPU explicitly, it is never chosen quietly."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    return dev


@dataclasses.dataclass(frozen=True)
class Program:
    """One resolved run of ``(steps, plan)`` on a problem's shape: what
    :meth:`StencilProblem.run`, :meth:`~StencilProblem.run_batched` and
    :meth:`~StencilProblem.run_batched_parts` build once and reuse, the
    port's counterpart of the reference's jitted executable.  ``engine`` is
    "jnp", "mxu", "resident" or "roundtrip"; ``tile`` the engine's (vl, m,
    t0) (None on the jnp backend); ``schedule`` the (depth, sweeps) chunks
    of :func:`sweep_schedule`.  ``fn`` takes one grid, a batch ``(B,) +
    shape``, or a sequence of B grids, the parts of a batch (the resident
    and mxu engines' K2 reads them where they lie; the others stack them
    first), and returns a grid or a batch."""
    spec: stencils.StencilSpec
    engine: str
    tile: tuple[int, int, int | None] | None
    schedule: tuple[tuple[int, int], ...]
    itemsize: int
    fn: Callable

    def __call__(self, x):
        return self.fn(x)

    @property
    def route(self) -> tuple[str, ...]:
        """The kernel each chunk's sweeps launch: ``stencil_kernels.
        sweep_plan``'s key ("1d", "2d", "3d" or "far"), or the engine
        ("jnp", "mxu") where it has no sweep kernel."""
        if self.engine in ("jnp", "mxu"):
            return (self.engine,)
        from repro_torch.kernels import stencil_kernels as sk
        vl, m, _ = self.tile
        return tuple(sk.sweep_plan(self.spec, vl, m, depth, self.itemsize)[0]
                     for depth, _ in self.schedule)


def _stacked(x):
    """A batch given as a sequence of grids, stacked; a tensor as it is."""
    return x if isinstance(x, torch.Tensor) else torch.stack(list(x))


class StencilProblem:
    def __init__(self, name: str, shape: Sequence[int],
                 dtype: torch.dtype = torch.float32, device=None):
        self.spec = stencils.make(name)
        if len(shape) != self.spec.ndim:
            raise ValueError(f"{name} needs a {self.spec.ndim}-D shape, got {tuple(shape)}")
        self.shape = tuple(shape)
        self.dtype = dtype
        self.device = resolve_device(device)
        # the programs, one per (steps, plan), and how often
        # _build_program ran for each (once, unless the memo missed a key)
        self._programs: dict[tuple, Program] = {}
        self._program_builds: collections.Counter = collections.Counter()
        self._programs_lock = threading.Lock()

    # ------------------------------------------------------------------
    def init(self, seed: int = 0) -> torch.Tensor:
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return torch.randn(self.shape, generator=gen, dtype=self.dtype,
                           device=self.device)

    def reference(self, x: torch.Tensor, steps: int, bc="periodic") -> torch.Tensor:
        return stencils.apply_steps(self.spec, x, steps, bc)

    # ------------------------------------------------------------------
    def run(self, x: torch.Tensor, steps: int,
            plan: StencilPlan | str = "auto") -> torch.Tensor:
        """Advance ``x`` by ``steps`` Jacobi steps (periodic BC) under
        ``plan``: a ``StencilPlan``; ``"default"``, the static plan; or
        ``"auto"``, the autotuner's cached or freshly measured plan for
        this (stencil, shape, dtype, device, steps) signature
        (``core/autotune.py``).  Any step count is valid: the ``steps % k``
        remainder runs under ``plan.remainder`` (inside the same resident
        run, or as further roundtrip sweeps)."""
        plan = self._resolve(plan, steps)
        if tuple(x.shape) != self.shape:
            raise ValueError(f"expected a grid of shape {self.shape}, got {tuple(x.shape)}")
        self._check_plan(plan)
        return self._program(steps, plan)(x)

    def _resolve(self, plan: StencilPlan | str, steps: int) -> StencilPlan:
        """A plan argument as a ``StencilPlan``: ``"auto"`` the tuner's,
        ``"default"`` :meth:`default_plan`."""
        if isinstance(plan, str):
            if plan == "auto":
                from repro_torch.core import autotune
                plan = autotune.best_plan(self, steps=steps)
            elif plan == "default":
                plan = self.default_plan()
            else:
                raise ValueError(f"unknown plan {plan!r}; expected 'auto', "
                                 f"'default' or a StencilPlan")
        if not isinstance(plan, StencilPlan):
            raise TypeError(f"plan must be a StencilPlan, got {type(plan).__name__}")
        return plan

    def _check_plan(self, plan: StencilPlan) -> None:
        """Refuse what no engine of the port runs as the plan asks."""
        if plan.ttile > 1 and not (
                plan.backend in ("distributed", "mxu")
                or (plan.backend == "pallas" and plan.sweep == "resident")):
            raise ValueError(
                f"ttile={plan.ttile} requires a resident sweep engine "
                "(backend='pallas' with sweep='resident', backend='mxu', "
                "or backend='distributed')")
        if plan.overlap and not (plan.backend == "distributed"
                                 and plan.scheme == "transpose"
                                 and plan.sweep == "resident"):
            raise ValueError(
                "overlap=True requires the distributed shard-resident "
                "engine (backend='distributed', scheme='transpose', "
                "sweep='resident')")
        if plan.backend == "distributed" or (plan.backend == "mxu"
                                             and plan.decomp is not None):
            raise NotImplementedError(
                f"backend={plan.backend!r} with decomp={plan.decomp} is not ported "
                f"yet: it needs {_NOT_PORTED['distributed']}")
        if plan.backend == "pallas" and plan.sweep not in ("resident", "roundtrip"):
            raise ValueError(f"unknown sweep engine {plan.sweep!r}")
        if plan.backend not in ("jnp", "pallas", "mxu"):
            raise ValueError(f"unknown backend {plan.backend!r}")

    # ------------------------------------------------------------------
    def run_batched(self, xb: torch.Tensor, steps: int,
                    plan: StencilPlan | str = "auto") -> torch.Tensor:
        """Advance a batch of grids, ``xb`` of shape ``(B,) + shape``, by
        ``steps`` under one plan: the continuous-batching entry of stencil
        serving.  The batch is a launch dimension of every sweep kernel, so
        the B grids share one K2 into the layout, one out of it and each
        launch of the ``sweep_schedule`` (``LAUNCHES`` counts each launch
        once, not B times); the jnp backend is ``torch.func.vmap`` over the
        one-grid run; the mxu engine's product takes the batch as more
        rows.  Each grid's result is bit for bit its own :meth:`run`
        (mxu: within the rounding of the larger product).  It runs the
        :class:`Program` :meth:`run` runs, resolved once per (steps, plan)
        for every batch size.  Distributed plans raise, naming ROADMAP A9."""
        plan = self._batched_plan(plan, steps)
        if tuple(xb.shape[1:]) != self.shape or xb.ndim != len(self.shape) + 1:
            raise ValueError(f"run_batched expects (B,) + {self.shape}, got {tuple(xb.shape)}")
        return self._program(steps, plan)(xb)

    def run_batched_parts(self, xs: Sequence[torch.Tensor], steps: int,
                          plan: StencilPlan | str = "auto") -> list[torch.Tensor]:
        """:meth:`run_batched` on a sequence of B grids of this shape, run
        as one batch where they lie: the resident and mxu engines' first K2
        reads each grid through a table of pointers (no stacking copy), the
        others stack them once.  The B results come back as views of the
        batch's output."""
        for x in xs:
            if tuple(x.shape) != self.shape:
                raise ValueError(f"run_batched_parts expects grids of shape {self.shape}, "
                                 f"got {tuple(x.shape)}")
        plan = self._batched_plan(plan, steps)
        return list(self._program(steps, plan)(list(xs)).unbind(0))

    def _batched_plan(self, plan: StencilPlan | str, steps: int) -> StencilPlan:
        """Resolve a plan for the batched entries and hold it to the
        batch-invariance gate (:func:`autotune.plan_batch_invariant`)."""
        plan = self._resolve(plan, steps)
        from repro_torch.core import autotune
        if not autotune.plan_batch_invariant(plan):
            raise ValueError(f"plan {plan} is not batch-invariant; "
                             "it cannot serve a batched run unchanged")
        self._check_plan(plan)
        return plan

    def _program(self, steps: int, plan: StencilPlan) -> Program:
        """The memoized :class:`Program` of ``(steps, plan)``, built under
        a lock on first use."""
        key = (steps, plan)
        with self._programs_lock:
            program = self._programs.get(key)
            if program is None:
                program = self._programs[key] = self._build_program(steps, plan)
        return program

    def _build_program(self, steps: int, plan: StencilPlan) -> Program:
        """Resolve the engine, tile and schedule of ``plan`` once; the
        program runs them on a grid, a batch or the parts of a batch."""
        self._program_builds[(steps, plan)] += 1
        from repro_torch.kernels import ops
        spec, ndim = self.spec, len(self.shape)
        itemsize = torch.empty((), dtype=self.dtype).element_size()
        if plan.backend == "jnp":
            block = (plan.height or plan.k) if plan.tiling == "tessellate" else plan.k
            chunks = sweep_schedule(block, steps, plan.remainder)[0]

            def one(v):
                return self._run_jnp(v, steps, plan)

            def fn(x):
                x = _stacked(x)
                return one(x) if x.ndim == ndim else torch.func.vmap(one)(x)
            return Program(spec, "jnp", None, tuple(chunks), itemsize, fn)
        # m=None means "pick the tile"; an explicit (vl, m) pair is honored.
        vl = plan.vl if plan.m is not None else None
        if plan.backend == "mxu":
            vl, m, _ = ops.pick_tile(spec, self.shape, vl, plan.m)
            chunks = sweep_schedule(plan.k, steps, plan.remainder, plan.ttile)[0]

            def fn(x):
                return ops.stencil_sweep_mxu(spec, x, steps, k=plan.k, vl=vl, m=m,
                                             remainder=plan.remainder, ttile=plan.ttile)
            return Program(spec, "mxu", (vl, m, None), tuple(chunks), itemsize, fn)
        vl, m, t0 = ops.pick_tile(spec, self.shape, vl, plan.m, plan.t0)
        if plan.sweep == "resident":
            chunks = sweep_schedule(plan.k, steps, plan.remainder, plan.ttile)[0]

            def fn(x):
                return ops.stencil_sweep_periodic(spec, x, steps, k=plan.k, vl=vl, m=m, t0=t0,
                                                  remainder=plan.remainder, ttile=plan.ttile)
        else:
            chunks = sweep_schedule(plan.k, steps, plan.remainder)[0]

            def fn(x):
                return self._chunked(
                    _stacked(x), steps, plan.k,
                    lambda v, n, k: ops.stencil_run_periodic(spec, v, n, k=k, vl=vl, m=m, t0=t0),
                    remainder=plan.remainder)
        return Program(spec, plan.sweep, (vl, m, t0), tuple(chunks), itemsize, fn)

    def _run_jnp(self, x: torch.Tensor, steps: int, plan: StencilPlan) -> torch.Tensor:
        """The jnp backend: tessellation rounds, k-step ``multistep_fused``
        blocks (the scheme is then not used, as in the reference) or
        ``run_scheme``; plain PyTorch on either device."""
        if plan.tiling == "tessellate":
            h = plan.height or plan.k
            tile = plan.tile or self._default_tile(h)
            inner = plan.scheme if plan.scheme in ("fused", "transpose", "dlt") else "fused"

            def tess(v, n, k):
                if k == 1:          # the remainder: fused single steps
                    return vectorize.run_scheme("fused", self.spec, v, n, plan.vl, plan.m)
                return tessellate.tessellate_run(self.spec, v, n, tile, k, inner=inner,
                                                 vl=plan.vl)
            return self._chunked(x, steps, h, tess, remainder=plan.remainder)
        if plan.k > 1:
            def fused(v, n, k):
                for _ in range(n // k):
                    v = unroll_jam.multistep_fused(self.spec, v, k)
                return v
            return self._chunked(x, steps, plan.k, fused, remainder=plan.remainder)
        return vectorize.run_scheme(plan.scheme, self.spec, x, steps, plan.vl, plan.m)

    def _chunked(self, x: torch.Tensor, steps: int, k: int, step,
                 remainder: str = "fused") -> torch.Tensor:
        """Run ``steps`` as k-blocked sweeps plus a remainder:
        ``step(x, n_steps, k)`` advances x by n_steps in k-step sweeps.
        ``remainder="fused"`` runs the leftover steps one at a time (k=1),
        ``"native"`` as one k=remainder sweep."""
        if remainder not in ("fused", "native"):
            raise ValueError(f"unknown remainder policy {remainder!r}")
        main = steps - steps % k
        if main:
            x = step(x, main, k)
        rem = steps - main
        if rem:
            x = step(x, rem, rem if remainder == "native" else 1)
        return x

    def default_plan(self) -> StencilPlan:
        """The static plan before any tuning, the reference's: the local
        transpose scheme's k=2 ``multistep_fused`` blocks on the jnp
        backend — also the baseline the reference's tuner measures
        against."""
        return StencilPlan(scheme="transpose", k=2, vl=8)

    def _default_tile(self, h: int) -> tuple[int, ...]:
        return tessellate.fit_tile(self.spec, self.shape, h)

    # ------------------------------------------------------------------
    def model_flops(self, steps: int) -> int:
        return stencils.model_flops(self.spec, self.shape, steps)

    def model_bytes(self, steps: int, k: int = 1) -> int:
        itemsize = torch.empty((), dtype=self.dtype).element_size()
        return stencils.model_bytes(self.spec, self.shape, steps,
                                    itemsize=itemsize, k=k)
