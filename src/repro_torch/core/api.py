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
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

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


class StencilProblem:
    def __init__(self, name: str, shape: Sequence[int],
                 dtype: torch.dtype = torch.float32, device=None):
        self.spec = stencils.make(name)
        if len(shape) != self.spec.ndim:
            raise ValueError(f"{name} needs a {self.spec.ndim}-D shape, got {tuple(shape)}")
        self.shape = tuple(shape)
        self.dtype = dtype
        self.device = resolve_device(device)

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
        if tuple(x.shape) != self.shape:
            raise ValueError(f"expected a grid of shape {self.shape}, got {tuple(x.shape)}")
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
        from repro_torch.kernels import ops
        # m=None means "pick the tile"; an explicit (vl, m) pair is honored.
        vl = plan.vl if plan.m is not None else None
        if plan.backend == "mxu":
            return ops.stencil_sweep_mxu(
                self.spec, x, steps, k=plan.k, vl=vl, m=plan.m,
                remainder=plan.remainder, ttile=plan.ttile)
        if plan.backend == "pallas":
            if plan.sweep == "resident":
                return ops.stencil_sweep_periodic(
                    self.spec, x, steps, k=plan.k, vl=vl, m=plan.m, t0=plan.t0,
                    remainder=plan.remainder, ttile=plan.ttile)
            if plan.sweep != "roundtrip":
                raise ValueError(f"unknown sweep engine {plan.sweep!r}")
            return self._chunked(
                x, steps, plan.k,
                lambda v, n, k: ops.stencil_run_periodic(
                    self.spec, v, n, k=k, vl=vl, m=plan.m, t0=plan.t0),
                remainder=plan.remainder)
        if plan.backend != "jnp":
            raise ValueError(f"unknown backend {plan.backend!r}")
        return self._run_jnp(x, steps, plan)

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
