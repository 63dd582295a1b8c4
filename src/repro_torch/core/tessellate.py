"""Tessellate tiling (paper §3.4; tiles of Yuan et al., SC'17), as plain
PyTorch (reference: ``core/tessellate.py``).

The (space × time) iteration plane is tessellated by triangles and inverted
triangles (1-D); in d dimensions there are d+1 stages — stage 1 updates
shrinking hypercubes ("pyramids"), stage j+1 recombines the sub-tiles split
from adjacent stage-j tiles along dimension j-1.  Every cell is updated
exactly H times a round with no redundant update, and the tiles of one stage
are independent of each other.

Rendering: a masked ping-pong Jacobi evolution.

  * two buffers hold values at even and odd time levels; a cell updated
    from time s-1 to s reads buf[(s-1) % 2] and writes buf[s % 2], so the
    inverted tiles read the slope values of the right earlier level (the
    paper's two-array Jacobi storage is what makes tessellation legal).
  * stage j, sub-step s (s = 1..H) updates the cells with

        c == s-1   AND   margin_d >= s*r   for every dim d >= j-1

    where margin_d is the cell's distance to its tile face along dim d and
    c the cell's count of completed steps (int8).

Every buffer update is out of place (``torch.where``), so the two buffers,
which start as the caller's ``x``, never write into it.  Periodic BC (the
tiles tile the torus).  ``numpy_tessellate_check`` re-runs the schedule in
numpy, asserting that every masked update reads only neighbours whose count
is s-1 or s — the legality proof the tests run.

The inner sub-step may be any of the schemes ``fused``, ``transpose`` and
``dlt`` (the latter two convert at the tile boundary, the layout round
trip of §3.4).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import vectorize
from repro_torch.core.stencils import StencilSpec, apply_once, numpy_apply_once


def _margins(shape, tile: tuple[int, ...], device=None) -> list[torch.Tensor]:
    """Per-axis distance-to-tile-face tensors, each broadcastable to ``shape``."""
    outs = []
    for axis, (n, w) in enumerate(zip(shape, tile)):
        if n % w:
            raise ValueError(f"dim {axis}: tile {w} does not divide {n}")
        pos = torch.arange(n, dtype=torch.int32, device=device) % w
        margin = torch.minimum(pos, w - 1 - pos)
        b = [1] * len(shape)
        b[axis] = n
        outs.append(margin.reshape(b))
    return outs


def make_schedule(spec: StencilSpec, shape, tile, height: int, device=None):
    """The (stage, substep, margin mask or None) list of one round: the
    c-condition is applied as the round runs."""
    r = spec.r
    margins = _margins(shape, tile, device)
    d = spec.ndim
    masks = []
    for stage in range(1, d + 2):
        for s in range(1, height + 1):
            cond = None
            for dd in range(stage - 1, d):
                mm = margins[dd] >= s * r
                cond = mm if cond is None else cond & mm
            masks.append((stage, s, cond))
    return masks


def _inner_step(spec: StencilSpec, inner: str, vl: int):
    if inner == "fused":
        return lambda v: apply_once(spec, v, bc="periodic")
    if inner == "transpose":
        return lambda v: vectorize.step_transpose(spec, v, vl=vl)
    if inner == "dlt":
        return lambda v: vectorize.step_dlt(spec, v, vl=vl)
    raise ValueError(f"unknown inner scheme {inner!r}")


def tessellate_round(spec: StencilSpec, x: torch.Tensor, tile: tuple[int, ...],
                     height: int, inner: str = "fused", vl: int = 8) -> torch.Tensor:
    """Advance the whole grid ``height`` steps by one tessellation round."""
    step = _inner_step(spec, inner, vl)
    bufs = [x, x]
    c = torch.zeros(x.shape, dtype=torch.int8, device=x.device)
    for _, s, mcond in make_schedule(spec, x.shape, tile, height, x.device):
        cand = step(bufs[(s - 1) % 2])
        upd = c == s - 1
        if mcond is not None:
            upd = upd & mcond
        bufs[s % 2] = torch.where(upd, cand, bufs[s % 2])
        c = c.masked_fill(upd, s)
    return bufs[height % 2]


def fit_tile(spec: StencilSpec, shape, height: int,
             strict: bool = False) -> tuple[int, ...] | None:
    """Largest tile of target edge ``max(4·height·r, 8)`` that divides
    every grid dim.  ``strict=True`` returns None when a dim cannot fit a
    tile big enough for the halo ramp (``2·height·r + 1``); ``strict=False``
    clamps instead (the API's default tile)."""
    r = spec.r
    w = max(4 * height * r, 8)
    tile = []
    for n in shape:
        t = min(w, n)
        while n % t:
            t -= 1
        if strict and t < 2 * height * r + 1:
            return None
        tile.append(t if strict else max(t, 2 * height * r))
    return tuple(tile)


def tessellate_run(spec: StencilSpec, x: torch.Tensor, steps: int,
                   tile: tuple[int, ...], height: int, inner: str = "fused",
                   vl: int = 8, remainder: str = "error") -> torch.Tensor:
    """Run ``steps // height`` full-height rounds, then the remainder:

    remainder="error"  — steps must be a multiple of height;
    remainder="native" — one more round of height ``steps % height``
                         (legal: a shorter round only weakens the margin
                         condition the tile was fitted for);
    remainder="fused"  — the leftover steps as plain single steps.
    """
    if remainder not in ("error", "native", "fused"):
        raise ValueError(f"unknown remainder policy {remainder!r}")
    rem = steps % height
    if rem and remainder == "error":
        raise ValueError(f"steps={steps} is not a multiple of height={height} "
                         "(pass remainder='native' or 'fused')")
    for _ in range(steps // height):
        x = tessellate_round(spec, x, tuple(tile), height, inner, vl)
    if rem:
        if remainder == "native":
            x = tessellate_round(spec, x, tuple(tile), rem, inner, vl)
        else:
            for _ in range(rem):
                x = apply_once(spec, x, bc="periodic")
    return x


# ---------------------------------------------------------------------------
# numpy legality checker — proves the schedule is a valid tessellation.
# ---------------------------------------------------------------------------

def numpy_tessellate_check(spec: StencilSpec, x: np.ndarray,
                           tile: tuple[int, ...], height: int) -> np.ndarray:
    """Run one round in numpy, raising AssertionError unless every update
    reads only neighbours at the required time level.  Returns the final
    array."""
    r = spec.r
    d = spec.ndim
    margins = [m.numpy() for m in _margins(x.shape, tile)]
    bufs = [x.copy(), x.copy()]
    c = np.zeros(x.shape, np.int64)
    for stage in range(1, d + 2):
        for s in range(1, height + 1):
            cond = np.ones(x.shape, bool)
            for dd in range(stage - 1, d):
                cond = cond & (margins[dd] >= s * r)
            upd = (c == s - 1) & cond
            # legality: every cell read by an updated cell must hold a live
            # time-(s-1) value in buf[(s-1)%2].  That value was written at
            # update s-1 (or is the initial state for s=1) and survives
            # until the cell's time-(s+1) write, so the neighbour's count
            # must lie in [s-1, s] (c == s is the inverted tile reading the
            # slope, which the two-array storage makes legal).
            for off, _ in spec.taps:
                shifted_c = c
                for axis, o in enumerate(off):
                    if o:
                        shifted_c = np.roll(shifted_c, -o, axis=axis)
                bad = upd & ((shifted_c < s - 1) | (shifted_c > s))
                if bad.any():
                    raise AssertionError(
                        f"illegal read: stage {stage} substep {s} offset {off}: "
                        f"{int(bad.sum())} cells")
            cand = numpy_apply_once(spec, bufs[(s - 1) % 2])
            bufs[s % 2] = np.where(upd, cand, bufs[s % 2])
            c = np.where(upd, s, c)
    if not (c == height).all():
        raise AssertionError("some cells did not reach the full height")
    return bufs[height % 2]
