"""The sweep engines and the GPU tile picker, natural layout in and out.

  * ``stencil_sweep_periodic`` is what ``StencilProblem.run`` calls for
    ``backend="pallas", sweep="resident"``: transpose into the
    (…, nb, m, vl) layout once (K2), run every chunk of
    ``core.api.sweep_schedule`` as sweep launches of that depth (K1 in
    1-D, K3 in 2-D/3-D), transpose out once.  The grid stays in layout for
    the whole run; two layout buffers are ping-ponged between launches.
  * ``stencil_run_periodic`` is the roundtrip engine (``sweep="roundtrip"``):
    every k-step sweep wrap-pads axis 0 by whole blocks / axis-0 tiles
    covering k·r, transposes (K2), runs the multistep kernel (K4), transposes
    back (K2) and crops.  Bit for bit the resident engine's result.
  * ``stencil_run`` / ``stencil_multistep``: the same sweep with the
    Dirichlet ring along axis 0 (periodic elsewhere), no pad.
  * ``stencil_onestep_naive`` / ``stencil_onestep_transpose``: one periodic
    1-D step in the natural and in the transpose layout (K5), the paper's
    layout A/B.
  * ``stencil_sweep_mxu`` is ``backend="mxu"``: the resident engine's shape
    (K2 in, every ``sweep_schedule`` chunk, K2 out) with each depth-d launch
    ONE matrix product against the banded operator ``A^d``.

Every engine but the one-step ones also takes a batch of grids, ``x`` of
shape ``(B,) + grid``: the tile is the one grid's, K2 moves the whole
batch once in and once out, and each sweep is one launch over all B grids
(a grid dimension of the kernel; the mxu product's rows), each grid
advanced bit for bit as alone.  ``stencil_sweep_periodic`` and
``stencil_sweep_mxu`` also take the batch as a sequence of B grids, each
where it lies (the requests of a served batch): their first K2 reads them
through a table of pointers, so no copy stacks them.
"""
from __future__ import annotations

import torch

from repro_torch.core.api import sweep_schedule
from repro_torch.core.stencils import StencilSpec
from repro_torch.core.vectorize import wrap_pad
from repro_torch.kernels import stencil_kernels as sk

DEFAULT_VL = 32                  # one warp of lanes: a 128-byte f32 row
MAX_AUTO_M = 8                   # largest vectors per set an auto pick takes
DEFAULT_T0 = {2: 32, 3: 16}      # axis-0 rows of a sweep kernel's tile


def grid_shape(spec: StencilSpec, x) -> tuple[int, ...]:
    """The shape of one grid of ``x``: ``x`` itself (rank ``spec.ndim``), a
    leading batch of grids (rank ``spec.ndim + 1``) or a sequence of grids
    of one shape."""
    if not isinstance(x, torch.Tensor):
        shapes = {tuple(v.shape) for v in x}
        if len(shapes) != 1 or len(next(iter(shapes))) != spec.ndim:
            raise ValueError(f"{spec.name}: expected a sequence of {spec.ndim}-D grids of one "
                             f"shape, got shapes {sorted(shapes)}")
        return shapes.pop()
    if x.ndim not in (spec.ndim, spec.ndim + 1):
        raise ValueError(f"{spec.name}: expected a {spec.ndim}-D grid or a batch of them, "
                         f"got shape {tuple(x.shape)}")
    return tuple(x.shape[x.ndim - spec.ndim:])


def _fit_m(n_minor: int, vl: int, r: int, m: int) -> int | None:
    """The largest ``m' <= m`` with ``m' >= r`` and ``vl·m'`` dividing
    ``n_minor``, or None."""
    while m >= max(r, 1):
        if n_minor % (vl * m) == 0:
            return m
        m -= 1
    return None


def pick_tile(spec: StencilSpec, shape, vl: int | None = None,
              m: int | None = None, t0: int | None = None):
    """GPU tile ``(vl, m, t0)``.  ``vl``: 32, halved (16, 8, …, down to
    ``r``) until some ``m`` fits; an explicit ``vl`` is kept.  ``m``: the
    largest integer ``m <= MAX_AUTO_M`` (an explicit ``m`` is the bound
    instead) with ``m >= r`` and ``vl·m`` dividing the minor extent.
    ``t0`` (n-D grids): ``DEFAULT_T0`` or the explicit value, lowered until
    it divides ``shape[0]``; it must stay ``>= r``.  A ValueError names the
    shape where no tile is legal."""
    n_minor, r = shape[-1], spec.r
    m_cap = m or MAX_AUTO_M
    cands = (vl,) if vl else [DEFAULT_VL >> i for i in range(6)
                              if DEFAULT_VL >> i >= max(r, 1)]
    for cand in cands:
        fit = _fit_m(n_minor, cand, r, m_cap)
        if fit is not None:
            vl, m = cand, fit
            break
    else:
        raise ValueError(
            f"no legal GPU tile for stencil {spec.name!r} on shape {tuple(shape)}: "
            f"need m >= r={r}, m <= {m_cap}, with vl*m dividing n_minor={n_minor} "
            + (f"at vl={vl}" if vl else f"for any vl in {tuple(cands)}"))
    if len(shape) == 1:
        return vl, m, None
    n0 = shape[0]
    t0 = min(t0 or DEFAULT_T0[len(shape)], n0)
    while n0 % t0:
        t0 -= 1
    if t0 < r:
        raise ValueError(
            f"no legal axis-0 tile for stencil {spec.name!r} on shape "
            f"{tuple(shape)}: need t0 >= r={r} dividing n0={n0}")
    return vl, m, t0


def _into_layout(x, vl: int, m: int) -> torch.Tensor:
    """K2 into the layout of a grid, a batch, or a sequence of grids read
    where they lie (:func:`stencil_kernels.block_transpose_parts`)."""
    if isinstance(x, torch.Tensor):
        return sk.block_transpose(x.contiguous(), vl, m)
    return sk.block_transpose_parts([v.contiguous() for v in x], vl, m)


def stencil_sweep_periodic(spec: StencilSpec, x: torch.Tensor, steps: int,
                           k: int = 2, vl: int | None = None,
                           m: int | None = None, t0: int | None = None,
                           remainder: str = "fused", donate: bool = False,
                           ttile: int = 1) -> torch.Tensor:
    """Advance ``x`` by ``steps`` periodic steps, layout-resident.

    The run is the chunks of ``sweep_schedule(k, steps, remainder,
    ttile)``: a depth-``ttile·k`` chunk is one time-tiled launch, plain
    k-blocks and the remainder ("native": one k=rem sweep, "fused": rem
    single steps) run at ``ttile=1``.  ``donate=True`` writes the result
    into ``x``'s storage (the input is then overwritten) instead of a new
    tensor; a sequence of grids returns the batch of their results."""
    if remainder not in ("fused", "native"):
        raise ValueError(f"unknown remainder policy {remainder!r}")
    vl, m, t0 = pick_tile(spec, grid_shape(spec, x), vl, m, t0)
    if donate and not isinstance(x, torch.Tensor):
        raise ValueError("donate=True needs one tensor to write the result into")
    if steps <= 0:
        return x if isinstance(x, torch.Tensor) else torch.stack(list(x))
    chunks, _ = sweep_schedule(k, steps, remainder, ttile)
    if spec.ndim == 1:
        def sweep(v, kk, tt, out):
            return sk.stencil1d_sweep_ttile(spec, v, kk, tt, out=out)
    else:
        def sweep(v, kk, tt, out):
            return sk.stencil_nd_sweep_ttile(spec, v, kk, tt, t0, out=out)
    a = _into_layout(x, vl, m)
    b = torch.empty_like(a)
    for depth, n in chunks:
        kk, tt = (k, depth // k) if depth > k and depth % k == 0 else (depth, 1)
        for _ in range(n):
            a, b = sweep(a, kk, tt, b), a
    return sk.block_untranspose(a, vl, m, out=x if donate else None)


def stencil_sweep_mxu(spec: StencilSpec, x: torch.Tensor, steps: int, k: int = 2,
                      vl: int | None = None, m: int | None = None,
                      remainder: str = "fused", ttile: int = 1) -> torch.Tensor:
    """Advance ``x`` by ``steps`` periodic steps on the banded-operator
    engine: the (steps, k, remainder, ttile) chunks of :func:`sweep_schedule`
    as :func:`stencil_sweep_periodic` runs them, each launch ONE product
    against ``A^depth`` (``core/matrixize.py``), between one K2 into the
    layout and one out of it.  The tile is :func:`pick_tile`'s where ``vl``
    is None.  Within the dtype's rounding of the f64 oracle, not bit for
    bit the other engines: the product reassociates the tap sum."""
    if remainder not in ("fused", "native"):
        raise ValueError(f"unknown remainder policy {remainder!r}")
    vl, m, _ = pick_tile(spec, grid_shape(spec, x), vl, m)
    if steps <= 0:
        return x if isinstance(x, torch.Tensor) else torch.stack(list(x))
    chunks, _ = sweep_schedule(k, steps, remainder, ttile)
    sweep = sk.stencil1d_sweep_mxu if spec.ndim == 1 else sk.stencil_nd_sweep_mxu
    t = _into_layout(x, vl, m)
    for depth, n in chunks:
        for _ in range(n):
            t = sweep(spec, t, depth)
    return sk.block_untranspose(t, vl, m)


def stencil_multistep(spec: StencilSpec, x: torch.Tensor, k: int,
                      vl: int | None = None, m: int | None = None,
                      t0: int | None = None) -> torch.Tensor:
    """Advance ``x`` by k steps in one multistep launch: Dirichlet along
    axis 0 (the r first and last cells keep their value; in 1-D the
    spatial axis itself), periodic along every other axis."""
    vl, m, t0 = pick_tile(spec, grid_shape(spec, x), vl, m, t0)
    t = sk.block_transpose(x.contiguous(), vl, m)
    if spec.ndim == 1:
        out = sk.stencil1d_multistep(spec, t, k)
    else:
        out = sk.stencil_nd_multistep(spec, t, k, t0)
    return sk.block_untranspose(out, vl, m)


def stencil_run(spec: StencilSpec, x: torch.Tensor, steps: int, k: int = 2,
                vl: int | None = None, m: int | None = None,
                t0: int | None = None) -> torch.Tensor:
    """``steps / k`` Dirichlet sweeps of :func:`stencil_multistep`; steps
    must divide into k-step sweeps."""
    if steps % k:
        raise ValueError(f"steps={steps} is not a multiple of k={k}")
    for _ in range(steps // k):
        x = stencil_multistep(spec, x, k, vl, m, t0)
    return x


def stencil_multistep_periodic(spec: StencilSpec, x: torch.Tensor, k: int,
                               vl: int | None = None, m: int | None = None,
                               t0: int | None = None) -> torch.Tensor:
    """Advance ``x`` by k periodic steps: wrap-pad axis 0 by whole layout
    blocks (1-D, open edges) or whole axis-0 tiles (n-D, Dirichlet ring)
    covering k·r, run the multistep kernel in layout, crop.  What the
    edges disturb lies within k·r of them, inside the pad.  Axis 0 is the
    grid's: a leading batch is neither padded nor cropped."""
    vl, m, t0 = pick_tile(spec, grid_shape(spec, x), vl, m, t0)
    axis = x.ndim - spec.ndim
    n0, r = x.shape[axis], spec.r
    if spec.ndim == 1:
        pad = sk.sweep_halo_blocks(r, k, vl * m) * vl * m
        t = sk.block_transpose(wrap_pad(x, pad, axis), vl, m)
        out = sk.stencil1d_multistep(spec, t, k, edge_mask=False)
    else:
        pad = sk.sweep_halo_blocks(r, k, t0) * t0
        t = sk.block_transpose(wrap_pad(x, pad, axis), vl, m)
        out = sk.stencil_nd_multistep(spec, t, k, t0)
    return sk.block_untranspose(out, vl, m).narrow(axis, pad, n0)


def stencil_run_periodic(spec: StencilSpec, x: torch.Tensor, steps: int, k: int = 2,
                         vl: int | None = None, m: int | None = None,
                         t0: int | None = None) -> torch.Tensor:
    """``steps / k`` periodic roundtrip sweeps; steps must divide into
    k-step sweeps (``StencilProblem`` runs the remainder as sweeps of
    another k)."""
    if steps % k:
        raise ValueError(f"steps={steps} is not a multiple of k={k}")
    for _ in range(steps // k):
        x = stencil_multistep_periodic(spec, x, k, vl, m, t0)
    return x


def stencil_onestep_naive(spec: StencilSpec, x: torch.Tensor, vl: int = 8) -> torch.Tensor:
    """One periodic 1-D step in the natural layout (K5a)."""
    return sk.stencil1d_naive_onestep(spec, x.contiguous(), vl)


def stencil_onestep_transpose(spec: StencilSpec, x: torch.Tensor, vl: int = 8,
                              m: int | None = None) -> torch.Tensor:
    """One periodic 1-D step in the transpose layout (K2, K5b, K2)."""
    m = m or vl
    t = sk.block_transpose(x.contiguous(), vl, m)
    return sk.block_untranspose(sk.stencil1d_transpose_onestep(spec, t), vl, m)
