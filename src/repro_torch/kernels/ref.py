"""Plain-torch oracles of the ported kernels, on the natural layout.

Each kernel's contract (layout, boundary conditions, step count) stated
with plain ops; the plain versions that sit beside the kernels
(``stencil_kernels.*_ref``) are what the card compares against bit for
bit, these are what the tests hold the whole path to."""
from __future__ import annotations

import torch

from repro_torch.core.stencils import StencilSpec, apply_once, apply_steps
from repro_torch.kernels.stencil_kernels import block_transpose_ref, block_untranspose_ref

__all__ = ["block_transpose_ref", "block_untranspose_ref", "kernel_bc", "multistep_ref",
           "onestep_periodic_ref", "sweep_periodic_ref"]


def kernel_bc(ndim: int) -> tuple[str, ...]:
    """BC of the multistep kernels with their Dirichlet ring on: dirichlet
    along axis 0 (in 1-D the blocked spatial axis itself), periodic along
    every other axis."""
    return ("dirichlet",) + ("periodic",) * (ndim - 1)


def multistep_ref(spec: StencilSpec, x: torch.Tensor, k: int) -> torch.Tensor:
    """What ``stencil1d_multistep`` / ``stencil_nd_multistep`` (edge_mask
    on) do to the natural grid."""
    return apply_steps(spec, x, k, bc=kernel_bc(spec.ndim))


def onestep_periodic_ref(spec: StencilSpec, x: torch.Tensor) -> torch.Tensor:
    """One fully periodic step."""
    return apply_once(spec, x, bc="periodic")


def sweep_periodic_ref(spec: StencilSpec, x: torch.Tensor, depth: int) -> torch.Tensor:
    """What a depth-``depth`` resident sweep does to the natural grid."""
    return apply_steps(spec, x, depth, bc="periodic")
