"""The paper's local transpose layout (§3.2) as explicit tensor transforms.

A 1-D array of length N is chunked into blocks of ``vl*m`` contiguous
elements.  Each block is viewed as a (vl, m) matrix (row-major: element
(j, s) = block[j*m + s]) and transposed to (m, vl) — the "vector set" (VS)
of m vectors, each vl lanes wide:

    VS[s, j]  =  x[b*vl*m + j*m + s]          (block b)

A spatial +1 shift maps vector s → vector s+1, except the last vector,
whose right neighbour is the lane-rolled vector 0 with a one-lane carry
from the next block — the paper's Assemble.  For an n-D grid the layout
applies to the minor (unit-stride) axis only: (..., N) → (..., nb, m, vl).
"""
from __future__ import annotations

import numpy as np
import torch


def to_transpose_layout(x: torch.Tensor, vl: int, m: int | None = None) -> torch.Tensor:
    """(..., N) → (..., nblocks, m, vl): per-block local transpose."""
    m = vl if m is None else m
    n = x.shape[-1]
    if n % (vl * m):
        raise ValueError(f"minor extent {n} is not a multiple of vl*m={vl * m}")
    b = x.reshape(x.shape[:-1] + (n // (vl * m), vl, m))
    return b.transpose(-1, -2).contiguous()


def from_transpose_layout(t: torch.Tensor, vl: int, m: int | None = None) -> torch.Tensor:
    """Inverse of :func:`to_transpose_layout`."""
    m = vl if m is None else m
    if t.shape[-2:] != (m, vl):
        raise ValueError(f"layout shape {tuple(t.shape)} does not end in (m={m}, vl={vl})")
    n = t.shape[-3] * vl * m
    return t.transpose(-1, -2).contiguous().reshape(t.shape[:-3] + (n,))


def transpose_index_map(n: int, vl: int, m: int) -> np.ndarray:
    """perm such that x[perm] == flattened transpose layout (for testing)."""
    idx = np.arange(n).reshape(n // (vl * m), vl, m)
    return np.ascontiguousarray(np.swapaxes(idx, -1, -2)).reshape(-1)


def shift_in_layout(t: torch.Tensor, shift: int) -> torch.Tensor:
    """Spatially shift by ``shift`` *in the transpose layout*, periodic over
    the full array.  t: (nblocks, m, vl).

    +1 is: vector s ← vector s+1 (roll on the m axis) and vector m-1 ←
    lane-rolled vector 0 with block carry (blend + permute, the 2
    reorganization ops of the paper)."""
    sign = 1 if shift > 0 else -1
    out = t
    for _ in range(abs(shift)):
        out = _shift1(out, sign)
    return out


def _shift1(t: torch.Tensor, sign: int) -> torch.Tensor:
    nb, m, vl = t.shape
    if sign > 0:
        rolled = torch.roll(t, -1, 1)                          # vector s ← s+1
        carry = torch.roll(t[:, 0, :].reshape(-1), -1).reshape(nb, vl)
        rolled[:, m - 1, :] = carry
    else:
        rolled = torch.roll(t, 1, 1)                           # vector s ← s-1
        carry = torch.roll(t[:, m - 1, :].reshape(-1), 1).reshape(nb, vl)
        rolled[:, 0, :] = carry
    return rolled
