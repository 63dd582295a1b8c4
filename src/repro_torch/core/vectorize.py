"""The vectorization schemes discussed by the paper, as plain PyTorch programs.

Five schemes, all computing one Jacobi step with periodic BC, each written so
that its data movement mirrors the paper's CPU implementation (reference:
``core/vectorize.py``):

  * ``multiload``  — §2.1 first solution: unaligned overlapping vector loads
                     (wrap-pad + one slice a tap; re-reads each input 2r+1×).
  * ``reorg``      — §2.1 second solution: aligned loads + inter-register
                     permutes (whole-array rolls on the unit-stride axis).
  * ``dlt``        — §2.2 Henretty's global dimension-lifting transpose:
                     single-block transpose layout, locality destroyed.
  * ``transpose``  — §3.2 the paper's scheme: local (vl×m) transpose per
                     block; neighbour access = contiguous second-minor slices
                     of an extended tile (``step_in_layout``).
  * ``fused``      — the roll oracle (= ``stencils.apply_once``).

Every scheme sums the taps in ``spec.taps`` order, each a product with the
coefficient rounded to the dtype, so each equals ``apply_once`` bit for bit.
For d-dimensional stencils the layout only affects the unit-stride (last)
axis; offsets on the other axes are plain rolls.  These are plain tensor
programs on either device: no kernel of ``kernels/csrc`` runs here.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core import layouts
from repro_torch.core.stencils import StencilSpec, apply_once, coeff

SchemeFn = Callable[..., torch.Tensor]


def wrap_pad(x: torch.Tensor, pad: int, axis: int = 0) -> torch.Tensor:
    """``x`` with ``pad`` periodic copies of its cells along ``axis`` on each
    side (``pad`` may exceed the extent), by concatenating slices."""
    n = x.shape[axis]
    pieces, i, end = [], -pad, n + pad
    while i < end:
        start = i % n
        size = min(n - start, end - i)
        pieces.append(x.narrow(axis, start, size))
        i += size
    return torch.cat(pieces, dim=axis)


# ---------------------------------------------------------------------------
# multiload: wrap-pad, then one contiguous (unaligned) slice per tap.
# ---------------------------------------------------------------------------

def step_multiload(spec: StencilSpec, x: torch.Tensor) -> torch.Tensor:
    r = spec.r
    xp = x
    for axis in range(x.ndim):
        xp = wrap_pad(xp, r, axis)
    acc = None
    for off, c in spec.taps:
        sl = xp
        for axis, o in enumerate(off):
            sl = sl.narrow(axis, r + o, x.shape[axis])
        term = sl * coeff(c, x.dtype)
        acc = term if acc is None else acc + term
    return acc


# ---------------------------------------------------------------------------
# reorg: aligned loads once, rolls (permute networks) for every tap.
# ---------------------------------------------------------------------------

def step_reorg(spec: StencilSpec, x: torch.Tensor) -> torch.Tensor:
    return apply_once(spec, x, bc="periodic")


step_fused = step_reorg  # semantic oracle


# ---------------------------------------------------------------------------
# dlt: global dimension-lifting transpose on the unit-stride axis.
# ---------------------------------------------------------------------------

def _dlt_m(x: torch.Tensor, vl: int) -> int:
    """DLT's m: the whole minor axis is one (vl, n/vl) block."""
    n = x.shape[-1]
    if n % vl:
        raise ValueError(f"dlt: minor extent {n} is not a multiple of vl={vl}")
    return n // vl


def step_dlt(spec: StencilSpec, x: torch.Tensor, vl: int = 128) -> torch.Tensor:
    return _layout_step(spec, x, vl, _dlt_m(x, vl))


# ---------------------------------------------------------------------------
# transpose (the paper's): local per-block transpose layout.
# ---------------------------------------------------------------------------

def step_transpose(spec: StencilSpec, x: torch.Tensor, vl: int = 128,
                   m: int | None = None) -> torch.Tensor:
    return _layout_step(spec, x, vl, vl if m is None else m)


def _layout_step(spec: StencilSpec, x: torch.Tensor, vl: int, m: int) -> torch.Tensor:
    """One step in (local or global) transpose layout, round trip."""
    t = layouts.to_transpose_layout(x, vl, m)          # (..., nb, m, vl)
    out = step_in_layout(spec, t, ndim=x.ndim)
    return layouts.from_transpose_layout(out, vl, m)


def step_in_layout(spec: StencilSpec, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """One periodic step on a layout-RESIDENT array (..., nb, m, vl): build
    the extended tile [left r rows | VS | right r rows], sum contiguous
    second-minor slices (taps in ``spec.taps`` order), roll the leading
    spatial axes.  The ``ndim - 1`` leading spatial axes are the ones just
    before (nb, m, vl): a batch of grids ahead of them is never rolled."""
    r = spec.r
    m = t.shape[-2]
    ext = extend_vs(t, r)                              # (..., nb, m+2r, vl)
    acc = None
    for off, c in spec.taps:
        sl = ext.narrow(ext.ndim - 2, r + off[-1], m)
        axes = [a - ndim - 2 for a, o in enumerate(off[:-1]) if o]
        if axes:
            sl = torch.roll(sl, [-o for o in off[:-1] if o], axes)
        term = sl * coeff(c, t.dtype)
        acc = term if acc is None else acc + term
    return acc


def extend_vs(t: torch.Tensor, r: int) -> torch.Tensor:
    """Extend each vector set with r assembled rows on each side.

    t: (..., nb, m, vl).  Row -q (q=1..r) is the lane-carried copy of row
    m-q of the left-neighbour block; row m-1+q the lane-carried copy of
    row q-1 of the right neighbour.  The carry wraps within each leading
    (…) row, never across rows."""
    nb, m, vl = t.shape[-3:]
    lead = t.shape[:-3]
    left_rows, right_rows = [], []
    for q in range(1, r + 1):
        # left row -q: element x[b*vl*m + j*m - q] = (b, m-q, j-1)|(b-1, ...)
        flat = t[..., m - q, :].reshape(lead + (nb * vl,))
        left_rows.insert(0, torch.roll(flat, 1, -1).reshape(lead + (nb, 1, vl)))
        # right row m-1+q: x[b*vl*m + j*m + m-1+q] = (b, q-1, j+1)|(b+1, ...)
        flat = t[..., q - 1, :].reshape(lead + (nb * vl,))
        right_rows.append(torch.roll(flat, -1, -1).reshape(lead + (nb, 1, vl)))
    return torch.cat(left_rows + [t] + right_rows, dim=-2)


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

SCHEMES: dict[str, SchemeFn] = {
    "multiload": step_multiload,
    "reorg": step_reorg,
    "fused": step_fused,
    "dlt": step_dlt,
    "transpose": step_transpose,
}


def get_scheme(name: str) -> SchemeFn:
    try:
        return SCHEMES[name]
    except KeyError:
        raise ValueError(f"unknown scheme {name!r}; have {sorted(SCHEMES)}") from None


def run_scheme(name: str, spec: StencilSpec, x: torch.Tensor, steps: int,
               vl: int = 128, m: int | None = None) -> torch.Tensor:
    """``steps`` applications of the named scheme.

    The layout schemes (dlt, transpose) stay layout-RESIDENT for the whole
    run: transpose in once, step ``steps`` times, transpose out — the
    paper's amortization (DLT pays one global transpose a run, the local
    scheme one transpose a block a run)."""
    if name in ("dlt", "transpose"):
        mm = _dlt_m(x, vl) if name == "dlt" else (m or vl)
        t = layouts.to_transpose_layout(x, vl, mm)
        for _ in range(steps):
            t = step_in_layout(spec, t, ndim=x.ndim)
        return layouts.from_transpose_layout(t, vl, mm)
    fn = get_scheme(name)
    for _ in range(steps):
        x = fn(spec, x)
    return x
