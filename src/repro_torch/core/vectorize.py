"""One Jacobi step on a layout-resident array — the paper's execution model.

Only the layout step of the reference's ``core/vectorize.py`` is ported
here: ``extend_vs`` (the Assemble lane carry) and ``step_in_layout``.  The
five vectorization schemes are still to be ported (ROADMAP A5).
"""
from __future__ import annotations

import torch

from repro_torch.core.stencils import StencilSpec, coeff


def step_in_layout(spec: StencilSpec, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """One periodic step on a layout-RESIDENT array (..., nb, m, vl): build
    the extended tile [left r rows | VS | right r rows], sum contiguous
    second-minor slices (taps in ``spec.taps`` order), roll the leading
    spatial axes."""
    r = spec.r
    m = t.shape[-2]
    ext = extend_vs(t, r)                              # (..., nb, m+2r, vl)
    acc = None
    for off, c in spec.taps:
        sl = ext.narrow(ext.ndim - 2, r + off[-1], m)
        axes = [a for a, o in enumerate(off[:-1]) if o]
        if axes:
            sl = torch.roll(sl, [-off[a] for a in axes], axes)
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
