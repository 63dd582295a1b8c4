"""Stencil pattern definitions and plain-torch oracles.

The six stencils of the paper (Table 1) plus two heat-equation extras:
1D3P, 1D5P (star, r=1/2), 2D5P (star r=1), 2D9P (box r=1), 3D7P (star
r=1), 3D27P (box r=1).  A d-dimensional star stencil of order ``r`` reads
``2*d*r + 1`` points, a box stencil ``(2r+1)**d``.

``apply_once`` is the semantic oracle of the port: every layout step and
kernel sums the taps in ``spec.taps`` order with each coefficient rounded
to the working dtype first, so a layout step equals it bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

Offset = tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class StencilSpec:
    """A constant-coefficient symmetric stencil.

    taps: tuple of (offset, coeff) — offset is a d-tuple in [-r, r]^d.
    """

    name: str
    ndim: int
    r: int
    kind: str  # 'star' | 'box'
    taps: tuple[tuple[Offset, float], ...]

    @property
    def npoints(self) -> int:
        return len(self.taps)

    @property
    def flops_per_point(self) -> int:
        # one multiply per tap + (taps-1) adds — the standard stencil count.
        return 2 * len(self.taps) - 1

    def halo(self) -> int:
        return self.r

    def coeff_array(self) -> np.ndarray:
        """Dense (2r+1)^d coefficient cube (zeros where no tap)."""
        side = 2 * self.r + 1
        cube = np.zeros((side,) * self.ndim, dtype=np.float64)
        for off, c in self.taps:
            cube[tuple(o + self.r for o in off)] = c
        return cube


def _star_taps(ndim: int, r: int) -> tuple[tuple[Offset, float], ...]:
    """Symmetric star stencil; diffusion-like, coefficients sum to 1."""
    taps: list[tuple[Offset, float]] = []
    n_off = 2 * ndim * r
    w_center = 0.5
    w_other = (1.0 - w_center) / n_off
    taps.append(((0,) * ndim, w_center))
    for d in range(ndim):
        for s in range(1, r + 1):
            for sign in (-1, 1):
                off = [0] * ndim
                off[d] = sign * s
                # distance-decayed weights keep high-order stencils non-degenerate
                taps.append((tuple(off), w_other * (1.0 + 0.25 * (r - s)) /
                             (1.0 + 0.25 * (r - 1) / 2 if r > 1 else 1.0)))
    total = sum(c for _, c in taps)
    return tuple((o, c / total) for o, c in taps)


def _box_taps(ndim: int, r: int) -> tuple[tuple[Offset, float], ...]:
    side = 2 * r + 1
    taps: list[tuple[Offset, float]] = []
    for idx in np.ndindex(*((side,) * ndim)):
        off = tuple(int(i) - r for i in idx)
        taps.append((off, 1.0 / (1.0 + sum(abs(o) for o in off))))
    total = sum(c for _, c in taps)
    return tuple((o, c / total) for o, c in taps)


_REGISTRY: dict[str, StencilSpec] = {}


def _register(spec: StencilSpec) -> StencilSpec:
    _REGISTRY[spec.name] = spec
    return spec


_register(StencilSpec("1d3p", 1, 1, "star", _star_taps(1, 1)))
_register(StencilSpec("1d5p", 1, 2, "star", _star_taps(1, 2)))
_register(StencilSpec("2d5p", 2, 1, "star", _star_taps(2, 1)))
_register(StencilSpec("2d9p", 2, 1, "box", _box_taps(2, 1)))
_register(StencilSpec("3d7p", 3, 1, "star", _star_taps(3, 1)))
_register(StencilSpec("3d27p", 3, 1, "box", _box_taps(3, 1)))
# extras used by examples (heat equation with physical coefficients)
_register(StencilSpec("heat1d", 1, 1, "star",
                      (((-1,), 0.25), ((0,), 0.5), ((1,), 0.25))))
_register(StencilSpec("heat2d", 2, 1, "star",
                      (((0, 0), 0.5), ((-1, 0), 0.125), ((1, 0), 0.125),
                       ((0, -1), 0.125), ((0, 1), 0.125))))


def make(name: str) -> StencilSpec:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown stencil {name!r}; have {sorted(_REGISTRY)}")


def names() -> list[str]:
    return sorted(_REGISTRY)


def coeff(c: float, dtype: torch.dtype) -> float:
    """``c`` rounded to ``dtype`` (as the reference's ``jnp.asarray(c,
    dtype)``), returned as a Python float so that a product with a tensor
    of ``dtype`` rounds once, exactly as the kernels' product does."""
    return torch.tensor(c, dtype=dtype).item()


# ---------------------------------------------------------------------------
# Oracles
# ---------------------------------------------------------------------------

BC = "periodic | dirichlet — a str applies to every axis, a tuple per-axis"


def _bc_tuple(bc, ndim: int) -> tuple[str, ...]:
    if isinstance(bc, str):
        bcs = (bc,) * ndim
    else:
        bcs = tuple(bc)
        if len(bcs) != ndim:
            raise ValueError(f"bc {bc!r} does not name {ndim} axes")
    for b in bcs:
        if b not in ("periodic", "dirichlet"):
            raise ValueError(f"unknown bc {b!r}")
    return bcs


def apply_once(spec: StencilSpec, x: torch.Tensor, bc="periodic") -> torch.Tensor:
    """One Jacobi step. bc: 'periodic' (wraparound) or 'dirichlet' (a ring
    of width r keeps its current value and only feeds neighbors); may be a
    per-axis tuple."""
    if x.ndim != spec.ndim:
        raise ValueError(f"{spec.name} needs a {spec.ndim}-D grid, got {tuple(x.shape)}")
    bcs = _bc_tuple(bc, spec.ndim)
    acc = None
    for off, c in spec.taps:
        shifts = [-o for o in off if o]
        axes = [a for a, o in enumerate(off) if o]
        shifted = torch.roll(x, shifts, axes) if axes else x
        term = shifted * coeff(c, x.dtype)
        acc = term if acc is None else acc + term
    if "dirichlet" in bcs:
        acc = torch.where(interior_mask(spec, x.shape, bcs, x.device), acc, x)
    return acc


def interior_mask(spec: StencilSpec, shape: Sequence[int], bc="dirichlet",
                  device=None) -> torch.Tensor:
    """True where the cell updates (≥ r from every dirichlet face)."""
    r = spec.r
    bcs = _bc_tuple(bc, len(shape))
    out = torch.ones(tuple(shape), dtype=torch.bool, device=device)
    for axis, n in enumerate(shape):
        if bcs[axis] != "dirichlet":
            continue
        idx = torch.arange(n, device=device)
        bshape = [1] * len(shape)
        bshape[axis] = n
        out = out & ((idx >= r) & (idx < n - r)).reshape(bshape)
    return out


def apply_steps(spec: StencilSpec, x: torch.Tensor, steps: int,
                bc="periodic") -> torch.Tensor:
    for _ in range(steps):
        x = apply_once(spec, x, bc)
    return x


def numpy_apply_once(spec: StencilSpec, x: np.ndarray, bc="periodic") -> np.ndarray:
    """Pure-numpy oracle (independent from torch for double-checking)."""
    acc = np.zeros_like(x)
    for off, c in spec.taps:
        shifted = x
        for axis, o in enumerate(off):
            if o != 0:
                shifted = np.roll(shifted, -o, axis=axis)
        acc = acc + shifted * x.dtype.type(c)
    bcs = _bc_tuple(bc, x.ndim)
    if "dirichlet" in bcs:
        mask = interior_mask(spec, x.shape, bcs).numpy()
        acc = np.where(mask, acc, x)
    return acc


def model_flops(spec: StencilSpec, shape: Sequence[int], steps: int) -> int:
    """Useful (algorithmic) flops: flops_per_point × points × steps."""
    return spec.flops_per_point * int(np.prod(shape)) * steps


def model_bytes(spec: StencilSpec, shape: Sequence[int], steps: int,
                itemsize: int = 4, k: int = 1) -> int:
    """Minimum device-memory traffic for a k-step-blocked sweep: one read
    + one write of the grid per k steps (the paper's flops/byte × k
    claim)."""
    sweeps = -(-steps // k)
    return 2 * int(np.prod(shape)) * itemsize * sweeps
