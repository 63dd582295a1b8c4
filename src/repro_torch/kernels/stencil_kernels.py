"""Wrappers of the hand-written CUDA kernels, each beside its plain version.

  * K2 ``block_transpose`` / ``block_untranspose`` — ``csrc/transpose.cu``:
    (..., N) ↔ (..., nb, m, vl), the per-block (vl, m) ↔ (m, vl) transpose
    (reference: ``stencil_kernels.py::_kernel_transpose``).
  * K1 ``stencil1d_sweep_ttile`` and K3 ``stencil_nd_sweep_ttile`` —
    ``csrc/stencil_sweep.cu``: a fully periodic depth-``ttile·k`` advance of
    the layout-resident grid in one launch (reference: ``_kernel_1d`` and
    ``_kernel_nd``).

A wrapper dispatches on the device of the tensor it is given: a CPU tensor
takes the plain PyTorch version (``*_ref``), a CUDA tensor launches the
kernel or raises.  Each launch adds one to ``LAUNCHES[<kernel>]``; the
plain versions count nothing.  Outputs are allocated here (or passed in
as ``out``); the kernels allocate nothing.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import layouts
from repro_torch.core.stencils import StencilSpec, coeff
from repro_torch.core.vectorize import step_in_layout
from repro_torch.kernels import build

# launches per kernel since the last reset_launches()
LAUNCHES = {"transpose": 0, "sweep_1d": 0, "sweep_nd": 0}

SMEM_MAX = 232448 - 1024    # H100 per-block shared memory less static use
_TILE_X = {1: 4096, 2: 256, 3: 32}   # default output tile, minor axis
_TILE_MID = 16                       # default output tile, 3-D mid axis


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def _stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _check_cuda(t: torch.Tensor, what: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{what}: tensors on {t.device} have no kernel")
    if not t.is_contiguous():
        raise ValueError(f"{what}: the kernel needs a contiguous tensor")


def _out(out: torch.Tensor | None, shape, like: torch.Tensor, what: str) -> torch.Tensor:
    if out is None:
        return torch.empty(shape, dtype=like.dtype, device=like.device)
    if tuple(out.shape) != tuple(shape) or out.dtype != like.dtype or out.device != like.device:
        raise ValueError(f"{what}: out must be {tuple(shape)} {like.dtype} on {like.device}, "
                         f"got {tuple(out.shape)} {out.dtype} on {out.device}")
    if not out.is_contiguous():
        raise ValueError(f"{what}: out must be contiguous")
    return out


def _into(out: torch.Tensor | None, value: torch.Tensor, what: str) -> torch.Tensor:
    """The plain version's result, copied into ``out`` when one is given."""
    if out is None:
        return value
    return _out(out, value.shape, value, what).copy_(value)


# ---------------------------------------------------------------------------
# K2: the layout transform
# ---------------------------------------------------------------------------

def block_transpose_ref(x: torch.Tensor, vl: int, m: int) -> torch.Tensor:
    """Plain version of :func:`block_transpose`: reshape + transpose."""
    return layouts.to_transpose_layout(x, vl, m)


def block_untranspose_ref(t: torch.Tensor, vl: int, m: int) -> torch.Tensor:
    """Plain version of :func:`block_untranspose`."""
    return layouts.from_transpose_layout(t, vl, m)


def _transpose_launch(src: torch.Tensor, dst: torch.Tensor, rows: int, cols: int) -> None:
    lib = build.load("transpose")
    size = src.element_size()
    if size not in (2, 4, 8):
        raise ValueError(f"transpose kernel: no {src.dtype} support ({size}-byte elements)")
    smem = lib.repro_transpose_smem_bytes(rows, cols, size)
    if smem > SMEM_MAX:
        raise ValueError(f"transpose kernel: a ({rows}, {cols}) block needs {smem} bytes "
                         f"of shared memory, over the {SMEM_MAX} a CTA may use")
    batch = src.numel() // (rows * cols)
    if batch == 0:
        return
    build.check(lib.repro_transpose(src.data_ptr(), dst.data_ptr(), batch, rows, cols,
                                    size, _stream()), "transpose kernel")
    LAUNCHES["transpose"] += 1


def block_transpose(x: torch.Tensor, vl: int, m: int,
                    out: torch.Tensor | None = None) -> torch.Tensor:
    """(..., N) → (..., N/(vl·m), m, vl) transpose layout."""
    n = x.shape[-1]
    if n % (vl * m):
        raise ValueError(f"minor extent {n} is not a multiple of vl*m={vl * m}")
    shape = tuple(x.shape[:-1]) + (n // (vl * m), m, vl)
    if x.device.type == "cpu":
        return _into(out, block_transpose_ref(x, vl, m), "block_transpose")
    _check_cuda(x, "block_transpose")
    dst = _out(out, shape, x, "block_transpose")
    _transpose_launch(x, dst, vl, m)
    return dst


def block_untranspose(t: torch.Tensor, vl: int, m: int,
                      out: torch.Tensor | None = None) -> torch.Tensor:
    """(..., nb, m, vl) → (..., nb·vl·m), inverse of :func:`block_transpose`.
    ``out`` may be the original natural-layout tensor, which it overwrites."""
    if tuple(t.shape[-2:]) != (m, vl):
        raise ValueError(f"layout shape {tuple(t.shape)} does not end in (m={m}, vl={vl})")
    shape = tuple(t.shape[:-3]) + (t.shape[-3] * vl * m,)
    if t.device.type == "cpu":
        return _into(out, block_untranspose_ref(t, vl, m), "block_untranspose")
    _check_cuda(t, "block_untranspose")
    dst = _out(out, shape, t, "block_untranspose")
    _transpose_launch(t, dst, m, vl)
    return dst


# ---------------------------------------------------------------------------
# K1 / K3: the resident sweeps
# ---------------------------------------------------------------------------

def sweep_depth(k: int, ttile: int) -> int:
    return k * max(ttile, 1)


def stencil1d_sweep_ttile_ref(spec: StencilSpec, t: torch.Tensor, k: int,
                              ttile: int = 1) -> torch.Tensor:
    """Plain version of :func:`stencil1d_sweep_ttile`: ``ttile·k``
    applications of the layout step."""
    for _ in range(sweep_depth(k, ttile)):
        t = step_in_layout(spec, t, ndim=1)
    return t


def stencil_nd_sweep_ttile_ref(spec: StencilSpec, t: torch.Tensor, k: int,
                               ttile: int, t0: int) -> torch.Tensor:
    """Plain version of :func:`stencil_nd_sweep_ttile` (``t0`` only shapes
    the kernel's tile)."""
    for _ in range(sweep_depth(k, ttile)):
        t = step_in_layout(spec, t, ndim=spec.ndim)
    return t


def _check_layout(spec: StencilSpec, t: torch.Tensor) -> None:
    if t.ndim != spec.ndim + 2:
        raise ValueError(f"{spec.name}: expected a ({spec.ndim - 1} lead, nb, m, vl) "
                         f"layout, got shape {tuple(t.shape)}")
    if spec.r > t.shape[-2]:
        raise ValueError(f"{spec.name}: m={t.shape[-2]} is below the stencil radius {spec.r}")


def sweep_tile(spec: StencilSpec, nat: tuple[int, int, int], m: int, depth: int,
               t0: int | None = None) -> tuple[tuple[int, int, int], tuple[int, int, int], int]:
    """Output tile (tz, ty, tx), loaded halo (hz, hy, hx) and dynamic
    shared memory of one CTA of the sweep kernel for a depth-``depth``
    launch on the natural (nz, ny, nx) grid.  The axis-0 rows of an n-D
    tile are ``t0``; the minor (then mid) extent shrinks until the two
    buffers fit.  Raises when no tile fits: a launch is never split."""
    nz, ny, nx = nat
    nd, r = spec.ndim, spec.r
    rz, ry = (r if nd == 3 else 0), (r if nd >= 2 else 0)
    hz, hy = depth * rz, depth * ry
    hx = -(-depth * r // m) * m
    tx = min(-(-_TILE_X[nd] // m) * m, nx)
    if nd == 1:
        tz = ty = 1
    elif nd == 2:
        tz, ty = 1, t0
    else:
        tz, ty = t0, min(_TILE_MID, ny)

    def smem(tz, ty, tx):
        return 2 * (tz + 2 * hz) * (ty + 2 * hy) * (tx + 2 * hx) * 4

    while smem(tz, ty, tx) > SMEM_MAX:
        if tx > m:
            tx = max(m, tx // 2 // m * m)
        elif nd == 3 and ty > 1:
            ty //= 2
        else:
            raise ValueError(
                f"{spec.name}: a depth-{depth} sweep needs a halo of {depth * r} "
                f"per side that no CUDA tile fits in shared memory (axis-0 tile "
                f"t0={t0}); deeper sweeps are ROADMAP D2")
    return (tz, ty, tx), (hz, hy, hx), smem(tz, ty, tx)


def _sweep_launch(spec: StencilSpec, t: torch.Tensor, out: torch.Tensor,
                  depth: int, t0: int | None) -> None:
    if t.dtype != torch.float32:
        raise NotImplementedError(
            f"the CUDA sweep kernel runs float32 only, got {t.dtype}; other "
            "dtypes are ROADMAP D1")
    if out.data_ptr() == t.data_ptr():
        raise ValueError("the sweep kernel cannot update in place: out must be "
                         "another buffer")
    nb, m, vl = t.shape[-3:]
    lead = tuple(t.shape[:-3])
    nat = (1,) * (2 - len(lead)) + lead + (nb * m * vl,)
    (tz, ty, tx), (hz, hy, hx), smem = sweep_tile(spec, nat, m, depth, t0)
    if -(-nat[0] // tz) > 65535 or -(-nat[1] // ty) > 65535:
        raise ValueError(f"{spec.name}: grid {nat} needs more than 65535 tiles on a "
                         "leading axis")
    if nat[2] // m >= 2**31:
        raise ValueError(f"{spec.name}: minor extent {nat[2]} has 2^31 or more "
                         f"columns of m={m}")
    lib = build.load("stencil_sweep")
    ntaps = len(spec.taps)
    if ntaps > lib.repro_stencil_max_taps():
        raise ValueError(f"{spec.name}: {ntaps} taps exceed the kernel's limit")
    offs = (ctypes.c_int32 * (3 * ntaps))()
    coeffs = (ctypes.c_float * ntaps)()
    for i, (off, c) in enumerate(spec.taps):
        offs[3 * i:3 * i + 3] = list((0,) * (3 - len(off)) + tuple(off))
        coeffs[i] = coeff(c, torch.float32)
    nd, r = spec.ndim, spec.r
    build.check(lib.repro_stencil_sweep_f32(
        t.data_ptr(), out.data_ptr(), *nat, vl, m, tz, ty, tx, hz, hy, hx,
        r if nd == 3 else 0, r if nd >= 2 else 0, r, depth, ntaps,
        ctypes.cast(offs, ctypes.c_void_p), ctypes.cast(coeffs, ctypes.c_void_p),
        smem, _stream()), f"{spec.name} sweep kernel")


def stencil1d_sweep_ttile(spec: StencilSpec, t: torch.Tensor, k: int,
                          ttile: int = 1, out: torch.Tensor | None = None
                          ) -> torch.Tensor:
    """``ttile`` fully periodic k-step sweeps (``depth = ttile·k`` steps) of
    the layout-resident (nb, m, vl) array in one launch."""
    _check_layout(spec, t)
    if spec.ndim != 1:
        raise ValueError(f"{spec.name} is not a 1-D stencil")
    if t.device.type == "cpu":
        return _into(out, stencil1d_sweep_ttile_ref(spec, t, k, ttile), "stencil1d_sweep_ttile")
    _check_cuda(t, "stencil1d_sweep_ttile")
    dst = _out(out, t.shape, t, "stencil1d_sweep_ttile")
    _sweep_launch(spec, t, dst, sweep_depth(k, ttile), None)
    LAUNCHES["sweep_1d"] += 1
    return dst


def stencil_nd_sweep_ttile(spec: StencilSpec, t: torch.Tensor, k: int,
                           ttile: int, t0: int, out: torch.Tensor | None = None
                           ) -> torch.Tensor:
    """``ttile`` fully periodic k-step sweeps of the layout-resident
    (n0, *mid, nb, m, vl) array in one launch; ``t0`` is the axis-0 rows of
    the kernel's output tile (it must divide n0 and reach the radius, as
    the reference's pipeline tile must)."""
    _check_layout(spec, t)
    if spec.ndim not in (2, 3):
        raise ValueError(f"{spec.name} is not a 2-D or 3-D stencil")
    n0 = t.shape[0]
    if t0 < spec.r or n0 % t0:
        raise ValueError(f"{spec.name}: axis-0 tile t0={t0} must divide n0={n0} "
                         f"and be at least r={spec.r}")
    if t.device.type == "cpu":
        return _into(out, stencil_nd_sweep_ttile_ref(spec, t, k, ttile, t0),
                     "stencil_nd_sweep_ttile")
    _check_cuda(t, "stencil_nd_sweep_ttile")
    dst = _out(out, t.shape, t, "stencil_nd_sweep_ttile")
    _sweep_launch(spec, t, dst, sweep_depth(k, ttile), t0)
    LAUNCHES["sweep_nd"] += 1
    return dst


def stencil1d_sweep_periodic(spec: StencilSpec, t: torch.Tensor, k: int,
                             out: torch.Tensor | None = None) -> torch.Tensor:
    """One fully periodic k-step sweep — the ``ttile=1`` slice."""
    return stencil1d_sweep_ttile(spec, t, k, 1, out=out)


def stencil_nd_sweep_periodic(spec: StencilSpec, t: torch.Tensor, k: int,
                              t0: int, out: torch.Tensor | None = None) -> torch.Tensor:
    """n-D ``ttile=1`` slice of :func:`stencil_nd_sweep_ttile`."""
    return stencil_nd_sweep_ttile(spec, t, k, 1, t0, out=out)
