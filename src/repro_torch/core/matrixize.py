"""Banded-operator matrixization of stencil sweeps — the ``mxu`` engine
(reference: ``core/matrixize.py``).

The transpose layout (``core/layouts.py``) folds the minor axis into
(nb, m, vl) blocks, and one Jacobi step is a fixed linear map over that
layout: every output element of block ``b`` is a coefficient-weighted sum of
elements of blocks ``b-1, b, b+1`` (for r ≤ vl·m).  That map is a small
banded matrix, so a whole sweep is ONE matrix product against a precomputed
operator, and the paper's time unroll-and-jam becomes a matrix power: the
depth-d operator ``A^d`` (one product advances d steps) is built by
repeated squaring on the band representation, in float64 numpy, before
anything runs.

Representation
--------------
A band is a dict ``{offsets: (B, B) float64 matrix}`` with ``B = vl·m`` and
``offsets = (lead-axis shifts…, block shift)``:

    out[i0.., b][:] = Σ_off  band[off] @ x[i0+o0.., b+ob][:]

where ``[:]`` is the block tile flattened in LAYOUT order (row s, lane j →
flat ``s·vl + j``; natural in-block index ``j·m + s``).  Leading-axis taps
of an n-D stencil are diagonal in the tile coordinate; only the minor-axis
taps couple tile positions (including the lane carries that read the
neighbour block, the paper's Assemble, in the ``ob = ±1`` matrices).  Band
products convolve offsets (``C[oa+ob] += A[oa] @ B[ob]``).

Application (:func:`apply_banded`) gathers the offset neighbourhood —
periodic shifts on undecomposed axes, ghost-halo slices on decomposed axes,
each a few slice copies — into one ``(rows, n_off·B)`` operand and multiplies it by the packed
``(n_off·B, B)`` table: ONE 2-D ``torch.matmul`` (on the card, one cuBLAS
GEMM).  The table is uploaded once per (operator, dtype, device).

Accumulation: float32 inputs contract in IEEE float32 (no TF32), bfloat16
inputs contract a bfloat16-rounded table with a float32 accumulator and
round once (no reduced-precision reductions), float64 in float64
(:func:`exact_products` holds cuBLAS to this whatever the process-wide
flags say).  The operator itself is always built in float64.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import itertools
import os

import numpy as np
import torch

from repro_torch.core.stencils import StencilSpec

Offsets = tuple[int, ...]  # (leading-axis offsets…, block-axis offset)

# Legality budget for the packed f32 operator table (the band of a depth-d
# power of an n-D stencil has up to (2dr+1)^(ndim-1)·(2p+1) offsets of B²
# coefficients each): a planner bounds a candidate with
# :func:`operator_bytes_bound` before it builds anything.
OPERATOR_BUDGET = int(os.environ.get("REPRO_MXU_OPERATOR_BUDGET", 2 << 20))


def layout_perm(vl: int, m: int) -> np.ndarray:
    """natural in-block index ``j·m + s`` → layout-flat index ``s·vl + j``."""
    i = np.arange(vl * m)
    return (i % m) * vl + (i // m)


def one_step_band(spec: StencilSpec, vl: int, m: int) -> dict[Offsets, np.ndarray]:
    """The single-step linear map of ``stencils.apply_once`` (periodic) on
    one (m, vl) tile, as a band of (B, B) float64 matrices."""
    B = vl * m
    perm = layout_perm(vl, m)
    band: dict[Offsets, np.ndarray] = {}
    for off, c in spec.taps:
        lead, om = tuple(off[:-1]), off[-1]
        for i in range(B):
            j_nat = i + om
            key = lead + (j_nat // B,)
            mat = band.setdefault(key, np.zeros((B, B), np.float64))
            mat[perm[i], perm[j_nat % B]] += c
    return band


def band_mul(a: dict[Offsets, np.ndarray],
             b: dict[Offsets, np.ndarray]) -> dict[Offsets, np.ndarray]:
    """Composition (apply ``b`` first, then ``a``): offsets convolve,
    coefficient matrices multiply."""
    out: dict[Offsets, np.ndarray] = {}
    for oa, ma in a.items():
        for ob, mb in b.items():
            key = tuple(x + y for x, y in zip(oa, ob))
            prod = ma @ mb
            out[key] = out[key] + prod if key in out else prod
    return out


def band_power(band: dict[Offsets, np.ndarray], d: int) -> dict[Offsets, np.ndarray]:
    """``band^d`` by repeated squaring — O(log d) band products."""
    if d < 1:
        raise ValueError(f"a band power needs d >= 1, got {d}")
    result = None
    sq = band
    while d:
        if d & 1:
            result = sq if result is None else band_mul(result, sq)
        d >>= 1
        if d:
            sq = band_mul(sq, sq)
    return {k: v for k, v in result.items() if v.any()}


@dataclasses.dataclass(frozen=True, eq=False)
class BandedOperator:
    """A packed depth-``depth`` advance operator for one (vl, m) layout.

    ``table[kidx·B + j, i] = A_off[i, j]`` for ``off = offsets[kidx]`` —
    pre-transposed so that application is ``X_neighbourhood @ table``."""
    ndim: int
    vl: int
    m: int
    depth: int
    offsets: tuple[Offsets, ...]
    table: np.ndarray            # (n_off·B, B) float64
    # the table as a tensor, by (dtype, device): uploaded at first use
    _tensors: dict = dataclasses.field(default_factory=dict, init=False, repr=False)

    @property
    def B(self) -> int:
        return self.vl * self.m

    @property
    def n_off(self) -> int:
        return len(self.offsets)

    def block_reach(self) -> int:
        """Max |block-axis offset| — ghost blocks needed a side."""
        return max(abs(o[-1]) for o in self.offsets)

    def lead_reach(self, axis: int) -> int:
        """Max |offset| along leading axis ``axis`` — ghost rows needed."""
        return max(abs(o[axis]) for o in self.offsets)

    def table_tensor(self, dtype: torch.dtype, device) -> torch.Tensor:
        """The table rounded to ``dtype`` on ``device``, uploaded once."""
        key = (dtype, torch.device(device))
        if key not in self._tensors:
            self._tensors[key] = torch.from_numpy(self.table).to(dtype).to(device)
        return self._tensors[key]


@functools.lru_cache(maxsize=256)
def operator(spec: StencilSpec, vl: int, m: int, depth: int) -> BandedOperator:
    """The depth-``depth`` banded advance operator, built once per (spec,
    vl, m, depth) and cached."""
    band = band_power(one_step_band(spec, vl, m), depth)
    offsets = tuple(sorted(band))
    table = np.concatenate([band[o].T for o in offsets], axis=0)
    return BandedOperator(spec.ndim, vl, m, depth, offsets, np.ascontiguousarray(table))


def operator_bytes_bound(spec: StencilSpec, vl: int, m: int, depth: int) -> int:
    """Upper bound on the packed f32 operator size, without building it:
    (2·depth·r+1)^(ndim-1) leading offsets × (2p+1) block offsets × B²
    coefficients (p = ghost blocks the band can reach)."""
    B = vl * m
    p = -(-depth * spec.r // B)
    n_off = (2 * depth * spec.r + 1) ** (spec.ndim - 1) * (2 * p + 1)
    return n_off * B * B * 4


def accum_dtype(dtype: torch.dtype) -> torch.dtype:
    """Accumulation rule: bf16 and f32 accumulate in f32, f64 in f64."""
    return torch.float64 if dtype == torch.float64 else torch.float32


@contextlib.contextmanager
def exact_products():
    """cuBLAS products in IEEE float32 (no TF32) and bfloat16 products with
    float32 reductions (split-K allowed, its partial sums in float32: the
    split-K switch needs the cuBLASLt backend), whatever the process-wide
    flags say; the flags are as they were on exit.

    The legacy flag (``set_float32_matmul_precision``) and the newer
    per-backend one (``torch.backends.cuda.matmul.fp32_precision``) are set
    together, so that the product sees one consistent state whichever of
    the two the caller used, and each is put back as it was.  The flags are
    process-wide: a product another thread runs meanwhile is held to IEEE
    too."""
    mm = torch.backends.cuda.matmul
    bf16 = torch._C._get_cublas_allow_bf16_reduced_precision_reduction()
    try:
        new = mm.fp32_precision
    except AttributeError:                  # a PyTorch without the newer flag
        new = None
    try:
        legacy = torch.get_float32_matmul_precision()
    except RuntimeError:                    # the newer flag was set alone
        legacy = None
    torch.set_float32_matmul_precision("highest")
    if new is not None:
        mm.fp32_precision = "ieee"
    torch._C._set_cublas_allow_bf16_reduced_precision_reduction(False, True)
    try:
        yield
    finally:
        torch._C._set_cublas_allow_bf16_reduced_precision_reduction(*bf16)
        if legacy is not None:
            torch.set_float32_matmul_precision(legacy)
        if new is not None:
            mm.fp32_precision = new


def _gather_into(dst: torch.Tensor, tb: torch.Tensor, off: Offsets, nlead: int,
                 lead_halo, block_halo: int) -> None:
    """Write the (lead…, nb, B) tiles ``tb`` shifted by ``off`` into ``dst``:
    on an axis without halo a periodic shift, as the two slice copies of
    its wrap; on one with, the slice of the interior's neighbours.  Each
    element is read once and written once, with no temporary."""
    nd = tb.ndim
    axes = [(nd - 2 - nlead + a, o, lead_halo[a]) for a, o in enumerate(off[:-1])]
    axes.append((nd - 2, off[-1], block_halo))
    pieces = []                     # per axis: (axis, dst start, src start, length)
    for ax, o, h in axes:
        n = dst.shape[ax]
        if h:
            pieces.append([(ax, 0, h + o, n)])
        else:
            s = o % n
            pieces.append([(ax, 0, s, n - s)] + ([(ax, n - s, 0, s)] if s else []))
    for combo in itertools.product(*pieces):
        d, src = dst, tb
        for ax, d0, s0, length in combo:
            d, src = d.narrow(ax, d0, length), src.narrow(ax, s0, length)
        d.copy_(src)


def neighbourhood(op: BandedOperator, t: torch.Tensor, lead_halo=None,
                  block_halo: int = 0) -> tuple[torch.Tensor, list[int]]:
    """The gathered operand of :func:`apply_banded`: a ``(rows, n_off·B)``
    tensor, ``n_off`` times the grid written once into one buffer, and the
    (lead…, nb) shape of its rows."""
    nlead = op.ndim - 1
    lead_halo = tuple(lead_halo or (0,) * nlead)
    if len(lead_halo) != nlead:
        raise ValueError(f"lead_halo {lead_halo} does not name {nlead} leading axes")
    if tuple(t.shape[-2:]) != (op.m, op.vl):
        raise ValueError(f"layout shape {tuple(t.shape)} does not end in "
                         f"(m={op.m}, vl={op.vl})")
    B = op.B
    tb = t.reshape(t.shape[:-2] + (B,))     # (lead…, nb, B) layout-flat tiles
    rows = list(tb.shape[:-1])
    for a, h in enumerate(lead_halo):
        rows[a - nlead - 1] -= 2 * h
    rows[-1] -= 2 * block_halo
    x = torch.empty(rows + [op.n_off * B], dtype=t.dtype, device=t.device)
    for i, off in enumerate(op.offsets):
        _gather_into(x.narrow(-1, i * B, B), tb, off, nlead, lead_halo, block_halo)
    return x.view(-1, op.n_off * B), rows


def apply_banded(op: BandedOperator, t: torch.Tensor, lead_halo=None,
                 block_halo: int = 0) -> torch.Tensor:
    """Advance the resident layout ``t`` by ``op.depth`` steps with ONE
    matrix product.

    t: (lead axes…, nb, m, vl) — possibly ghost-extended.  Per axis the
    neighbourhood gathers by periodic shift (halo 0: the axis wraps) or by
    ghost-halo slice (halo > 0: a decomposed axis whose ghosts a halo
    exchange filled; the output drops them, so only interior blocks are
    computed).  ``lead_halo``: ghost rows a side per leading axis;
    ``block_halo``: ghost blocks a side on the block axis."""
    x, rows = neighbourhood(op, t, lead_halo, block_halo)
    with exact_products():
        out = torch.matmul(x, op.table_tensor(t.dtype, t.device))
    return out.view(rows + [op.m, op.vl])
