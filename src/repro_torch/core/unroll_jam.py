"""Time-loop unroll-and-jam (paper §3.3, Algorithm 1), as plain PyTorch.

Advance every element k time steps per memory round trip.  Two renderings
(reference: ``core/unroll_jam.py``):

* ``multistep_fused`` — ``for _ in range(k): step(x)``; the "normal
  execution" (k=1) generalized: a full-array barrier between steps, no
  in-register reuse.  What ``StencilProblem.run`` runs for a jnp plan with
  k > 1.

* ``multistep_pipelined`` — the paper's Algorithm 1: a software pipeline
  over vector sets.  A window of k live vector sets slides left→right; per
  slide one VS is loaded, one fully-updated VS is stored, and each live VS
  advances one step.  Window position i always holds a block at time
  (k-1-i) before its update.  The update of position i needs

    - left rows: its own tail rows (before the update) lane-rolled +1,
      lane 0 fed by the left block's tail at the same time — kept from the
      previous slide in ``vrl[i]``;
    - right rows: its own head rows lane-rolled -1, lane vl-1 fed by the
      right block's just-updated head (position i+1 is processed first and
      then sits at the same time level).

  Boundary condition: Dirichlet (a ring of width r keeps its value), as
  masked restores on the first and last block.  It is the semantic model
  of the multistep kernels (K4), held against ``apply_steps``; its Python
  loop over the blocks is a model, not an engine.
"""
from __future__ import annotations

import torch

from repro_torch.core import layouts
from repro_torch.core.stencils import StencilSpec, apply_once, coeff


def multistep_fused(spec: StencilSpec, x: torch.Tensor, k: int,
                    bc="periodic") -> torch.Tensor:
    for _ in range(k):
        x = apply_once(spec, x, bc)
    return x


# ---------------------------------------------------------------------------
# Algorithm 1 — pipelined k-step update over vector sets (1-D, Dirichlet).
# ---------------------------------------------------------------------------

def _stencil_vs(spec: StencilSpec, ext: torch.Tensor, m: int) -> torch.Tensor:
    """Weighted window sum over the extended tile ext (m+2r, vl)."""
    r = spec.r
    acc = None
    for off, c in spec.taps:
        term = ext.narrow(0, r + off[-1], m) * coeff(c, ext.dtype)
        acc = term if acc is None else acc + term
    return acc


def _left_rows(own_tail: torch.Tensor, left_tail: torch.Tensor) -> torch.Tensor:
    """Assemble rows -r..-1.  own_tail / left_tail: (r, vl) rows m-r..m-1 of
    this block / the left block, both at the VS's time before the update:
    lane-roll +1, lane 0 from the left block's last lane."""
    return torch.cat([left_tail[:, -1:], own_tail[:, :-1]], dim=-1)


def _right_rows(own_head: torch.Tensor, right_head: torch.Tensor) -> torch.Tensor:
    """Assemble rows m..m+r-1 from own / right-neighbour head rows 0..r-1."""
    return torch.cat([own_head[:, 1:], right_head[:, :1]], dim=-1)


def _ring_masks(vl: int, m: int, r: int, device=None):
    """(m, vl) bool masks of the Dirichlet ring cells inside the first and
    last block.  Element e of a block sits at (row e % m, lane e // m)."""
    fm = torch.zeros((m, vl), dtype=torch.bool, device=device)
    lm = torch.zeros((m, vl), dtype=torch.bool, device=device)
    for e in range(r):
        fm[e % m, e // m] = True
        le = vl * m - 1 - e
        lm[le % m, le // m] = True
    return fm, lm


def multistep_pipelined(spec: StencilSpec, x: torch.Tensor, k: int,
                        vl: int = 8, m: int | None = None) -> torch.Tensor:
    """Advance the 1-D ``x`` by ``k`` Dirichlet steps through Algorithm 1's
    window of k vector sets; needs r ≤ m and at least k+1 blocks."""
    if spec.ndim != 1:
        raise ValueError(f"{spec.name}: Algorithm 1 is modelled for 1-D stencils")
    m = vl if m is None else m
    r = spec.r
    if r > m:
        raise ValueError(f"the halo r={r} must fit within one vector set (m={m})")
    t = layouts.to_transpose_layout(x, vl, m)          # (nb, m, vl)
    nb = t.shape[0]
    if nb < k + 1:
        raise ValueError(f"need at least k+1={k + 1} blocks, got {nb}")
    first_mask, last_mask = _ring_masks(vl, m, r, x.device)

    def compute(vs, left_tail, right_head, b_idx):
        """Advance one VS one step; Dirichlet masks on the domain's edge blocks."""
        ext = torch.cat([_left_rows(vs[m - r:], left_tail), vs,
                         _right_rows(vs[:r], right_head)], dim=0)
        new = _stencil_vs(spec, ext, m)
        if b_idx == 0:
            new = torch.where(first_mask, vs, new)
        if b_idx == nb - 1:
            new = torch.where(last_mask, vs, new)
        return new

    zeros_tail = torch.zeros((r, vl), dtype=x.dtype, device=x.device)

    # ---- boot: window[i] = block i must reach time k-1-i -------------------
    # sweep s = 0..k-2 advances blocks 0..k-2-s (all at time s) by one step.
    window = [t[i] for i in range(k)]
    vrl = [zeros_tail for _ in range(k)]
    for s in range(k - 1):
        snapshot = list(window)
        for i in range(k - 1 - s):
            if i == k - 2 - s:                    # the block's last boot update:
                vrl[i + 1] = snapshot[i][m - r:]  # keep its tail before it
            left_tail = snapshot[i - 1][m - r:] if i > 0 else zeros_tail
            right_head = (snapshot[i + 1] if i + 1 < k else t[k])[:r]
            window[i] = compute(snapshot[i], left_tail, right_head, i)
    # vrl[0] feeds window[0], whose left block lies outside the domain.

    # ---- steady slides ------------------------------------------------------
    out_blocks = []
    for j in range(k, nb + k):
        ws = window + [t[min(j, nb - 1)]]
        new_vr = [None] * k
        for i in range(k - 1, -1, -1):            # the paper's i = k..1
            new_vr[i] = ws[i][m - r:]             # keep the tail before the update
            ws[i] = compute(ws[i], vrl[i], ws[i + 1][:r], j - (k - i))
        out_blocks.append(ws[0])                  # updated k times: store
        window, vrl = ws[1:k + 1], new_vr
    return layouts.from_transpose_layout(torch.stack(out_blocks), vl, m)
