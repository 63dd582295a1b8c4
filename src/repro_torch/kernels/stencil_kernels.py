"""Wrappers of the hand-written CUDA kernels, each beside its plain version.

  * K2 ``block_transpose`` / ``block_untranspose`` — ``csrc/transpose.cu``:
    (..., N) ↔ (..., nb, m, vl), the per-block (vl, m) ↔ (m, vl) transpose
    (reference: ``stencil_kernels.py::_kernel_transpose``), on its register
    kernel at every vl and m (one thread per sub-column of a block, or at
    vl < 4 a warp per span of whole blocks; :func:`transpose_route`).
  * K1 ``stencil1d_sweep_ttile`` and K3 ``stencil_nd_sweep_ttile``: a fully
    periodic depth-``ttile·k`` advance of the layout-resident grid in one
    launch (reference: ``_kernel_1d`` and ``_kernel_nd``).  K1 and K3 each
    take one of two kernels, chosen by shape before the launch: a register
    kernel where one applies (:func:`sweep1d_route`:
    ``csrc/sweep1d_warp.cu`` and :func:`sweep2d_route`:
    ``csrc/sweep2d_warp.cu``, a lane on each of 32 consecutive
    sub-columns of the layout; :func:`sweep3d_route`: ``csrc/sweep3d.cu``,
    a thread on each sub-column; all three at any ``vl``, ``m`` and depth,
    on sub-columns of ``M`` points, :func:`sub_columns`; a sweep deeper
    than one launch takes is consecutive launches of them), or the
    shared-memory kernel ``csrc/stencil_sweep.cu`` (reach beyond the
    kernels': r > 4 at every rank).
  * K4 ``stencil1d_multistep`` / ``stencil_nd_multistep`` (and the halo
    wrappers ``stencil{1d,_nd}_sweep_halo``) — the same kernels with a
    Dirichlet ring or open edges along axis 0 (reference: the same Pallas
    bodies with ``edge_mask``): on the routes of K1, and of K3 in 2-D and
    3-D.
  * K5 ``stencil1d_naive_onestep`` / ``stencil1d_transpose_onestep`` —
    ``csrc/onestep.cu``: one periodic 1-D step in the natural layout and in
    the transpose layout, the paper's layout A/B (reference:
    ``_kernel_naive_1d`` and ``_kernel_transpose_1d``).
  * ``stencil1d_sweep_mxu`` / ``stencil_nd_sweep_mxu`` (and their
    ``_halo`` forms): a depth-d sweep as ONE matrix product against the
    banded operator ``A^d`` (``core/matrixize.py``; reference: the
    ``dot_general`` sweeps of ``stencil_kernels.py``, no Pallas kernel).
    The product is ``torch.matmul`` on either device, a cuBLAS GEMM on the
    card, as the reference leaves it to XLA; it has no kernel of its own.

A wrapper dispatches on the device of the tensor it is given: a CPU tensor
takes the plain PyTorch version (``*_ref``), a CUDA tensor launches the
kernel or raises.  The stencil kernels (K1, K3, K4, K5) take float32 and
bfloat16 (each product and sum rounded to the dtype, as the plain versions
do); K2 moves elements of 2, 4 or 8 bytes.  Each launch adds one to
``LAUNCHES[<kernel>]`` (a sweep cut into consecutive launches adds one per
launch; a bfloat16 launch counts as a float32 one), the routes apart: K2
under ``transpose``; K1 under ``sweep_1d`` (warp kernel) and
``sweep_1d_smem``; K4a under
``multistep_1d`` (warp kernel) and ``multistep_1d_smem``; K3 under
``sweep_2d`` (2-D warp kernel), ``sweep_3d`` (3-D streaming kernel) and
``sweep_nd``; K4b under ``multistep_2d``, ``multistep_3d`` (the same
kernels) and ``multistep_nd``; the mxu sweeps' products on the card under
``mxu``.  The plain versions count nothing.  Outputs are allocated here
(or passed in as ``out``); the kernels allocate nothing.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import layouts, matrixize
from repro_torch.core.stencils import StencilSpec, apply_once, coeff
from repro_torch.core.vectorize import step_in_layout
from repro_torch.kernels import build

# launches per kernel since the last reset_launches()
LAUNCHES = {"transpose": 0, "sweep_1d": 0, "sweep_1d_smem": 0,
            "sweep_2d": 0, "sweep_3d": 0, "sweep_nd": 0, "multistep_1d": 0,
            "multistep_1d_smem": 0, "multistep_2d": 0, "multistep_3d": 0, "multistep_nd": 0,
            "onestep_naive": 0, "onestep_transpose": 0, "mxu": 0}

SMEM_MAX = 232448 - 1024    # H100 per-block shared memory less static use
_TILE_X = {1: 4096, 2: 256, 3: 32}   # default output tile, minor axis
_TILE_MID = 16                       # default output tile, 3-D mid axis
# csrc/transpose.cu's forms: vl below TRANSPOSE_MIN_VL a warp a span of
# whole blocks (transpose_small); from it a thread a sub-column of M =
# transpose_sub(m), with every stride fixed (transpose_reg: vl a power of
# two, m in TRANSPOSE_M) or G and vl at run time (transpose_any: sub-columns
# in a grid, or past it in each super-chunk along blockIdx.y, fewer than
# TRANSPOSE_MAX_SUB, for 32-bit indices)
TRANSPOSE_MIN_VL = 4
TRANSPOSE_M = frozenset(range(1, 9)) | {16, 32}
TRANSPOSE_MAX_SUB = 1 << 31
# a warp row of the register kernels: 32 sub-columns of the layout, one a lane
WARP_LANES = 32
# sub-columns a row may have off vl = 32 (or off m = M) in the 2-D and 3-D
# register kernels, and off m = M in the 1-D one (csrc/cols.cuh's kMaxCols:
# 32-bit column math)
MAX_COLS = 1 << 30
# the points M a sub-column holds in the register kernels' instances
# (sweep1d_warp.cu, sweep2d_warp.cu, sweep3d.cu): a layout column of m
# points is m / M sub-columns, :func:`sub_columns`
SUB_M = (1, 2, 4, 8)
# warp rows per warp run of csrc/sweep1d_warp.cu, by M, and its largest reach
WARP_BLOCKS = {1: 32, 2: 32, 4: 16, 8: 8}
WARP_MAX_R = 4
# csrc/sweep2d_warp.cu: warps per CTA (two of them halo), its deepest
# instance by (M, r) (every depth up to it: the register windows hold
# depth·(2r + 1)·M values a lane; at r > 1 at most 2, which keeps the
# build short), its deep instances past that (the any-vl form only), its
# reach and the shortest axis-0 segment a CTA walks
WARP2D_WARPS = 10
WARP2D_DEPTH = {(1, 1): 8, (2, 1): 8, (4, 1): 8, (8, 1): 4, (8, 2): 2, (8, 3): 1, (8, 4): 1,
                **{(mm, r): 2 for mm in (1, 2, 4) for r in (2, 3, 4)}}
WARP2D_DEEP = {(2, 1): (16,)}
WARP2D_MAX_R = 4
WARP2D_SEG_MIN = 32
# csrc/sweep3d.cu: columns a CTA stores per row, its cap on threads, the
# input planes in flight (and at depth 1), the shared memory a CTA may use,
# its deepest instance by (M, r) (every depth up to it; a deeper sweep is
# consecutive launches: at r > 1 the depths whose tile stores at least 0.4
# of what it computes, :func:`sweep3d_tile`), its reach and the shortest z
# segment a CTA walks
SWEEP3D_LANES = 16
SWEEP3D_THREADS = 512
SWEEP3D_STAGES, SWEEP3D_STAGES_D1 = 2, 3
SWEEP3D_SMEM = 232448
SWEEP3D_DEPTH = {**{(mm, 1): 4 for mm in (1, 2, 4, 8)},
                 (1, 2): 2, (2, 2): 2, (4, 2): 3, (8, 2): 2,
                 (1, 3): 1, (2, 3): 1, (4, 3): 2, (8, 3): 1,
                 **{(mm, 4): 1 for mm in (1, 2, 4, 8)}}
SWEEP3D_MAX_R = 4
SWEEP3D_SEG_MIN = 8
# taps a 2-D or 3-D stencil may have on the register kernels (kMaxTaps of
# csrc/sweep2d_warp.cu and csrc/sweep3d.cu, as of csrc/stencil_sweep.cu)
ND_MAX_TAPS = 64
# the tap orders csrc/sweep3d.cu knows at compile time (its Order): the box
# of reach 1 and the star (``stencils._star_taps``' order) of reach 1 and 2
_BOX3 = tuple((oz, oy, ox) for oz in (-1, 0, 1) for oy in (-1, 0, 1) for ox in (-1, 0, 1))
_STAR3 = {r: ((0, 0, 0),) + tuple(tuple(sign * s if a == axis else 0 for a in range(3))
                                  for axis in range(3) for s in range(1, r + 1)
                                  for sign in (-1, 1)) for r in (1, 2)}


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


def _into(out: torch.Tensor | None, value: torch.Tensor, what: str,
          src: torch.Tensor | None = None) -> torch.Tensor:
    """The plain version's result, copied into ``out`` when one is given.
    Without ``out`` a result that is a view of ``src`` (a layout change that
    moves no data, as at ``m = 1``) is copied: like the kernel's, it never
    shares the input's storage."""
    if out is None:
        if src is not None and \
                value.untyped_storage().data_ptr() == src.untyped_storage().data_ptr():
            return value.clone()
        return value
    return _out(out, value.shape, value, what).copy_(value)


# the stencil kernels' element types: the suffix of their C entry points
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


def _kernel_io(t: torch.Tensor, out: torch.Tensor, what: str) -> None:
    """What every stencil kernel needs of its input and output buffers."""
    if t.dtype not in _SUFFIX:
        raise NotImplementedError(f"{what} runs float32 and bfloat16, got {t.dtype}; "
                                  "other dtypes are ROADMAP D1")
    if out.data_ptr() == t.data_ptr():
        raise ValueError(f"{what} cannot update in place: out must be another buffer")


def _entry(source: str, name: str, dtype: torch.dtype):
    """The C entry point ``repro_<name>_<f32|bf16>`` for ``dtype``: in
    ``csrc/<source>.cu``, or for bfloat16 in ``csrc/<source>_bf16.cu``
    where that source exists (the register sweep kernels build their
    bfloat16 instances apart)."""
    suffix = _SUFFIX[dtype]
    lib = f"{source}_bf16" if suffix == "bf16" and f"{source}_bf16" in build.SOURCES else source
    return getattr(build.load(lib), f"repro_{name}_{suffix}")


# ---------------------------------------------------------------------------
# K2: the layout transform
# ---------------------------------------------------------------------------

def block_transpose_ref(x: torch.Tensor, vl: int, m: int) -> torch.Tensor:
    """Plain version of :func:`block_transpose`: reshape + transpose."""
    return layouts.to_transpose_layout(x, vl, m)


def block_untranspose_ref(t: torch.Tensor, vl: int, m: int) -> torch.Tensor:
    """Plain version of :func:`block_untranspose`."""
    return layouts.from_transpose_layout(t, vl, m)


def transpose_sub(m: int) -> tuple[int, int]:
    """``(M, G)``: the elements ``M`` a thread of K2's register kernel moves
    and the ``G = m / M`` sub-columns a column of the layout is cut into:
    ``M`` the largest of 1..8 dividing ``m`` with ``G`` a power of two (a
    warp then covers whole columns; 8 at m = 16 and 32, 6 at m = 24), else
    the largest dividing ``m`` (5 at m = 25)."""
    divisors = [mm for mm in range(1, 9) if m % mm == 0]
    whole = [mm for mm in divisors if (m // mm) & (m // mm - 1) == 0]
    big = max(whole or divisors)
    return big, m // big


def transpose_route(vl: int, m: int, itemsize: int, numel: int = 0) -> str:
    """The kernel a CUDA :func:`block_transpose` / :func:`block_untranspose`
    launches on ``numel`` elements of ``itemsize`` bytes: ``"reg"``, K2's
    one route, at every shape (``csrc/transpose.cu``'s register kernel: at
    ``vl < 4`` a warp a span of whole blocks, else a thread a sub-column of
    ``M`` elements, ``M`` of :func:`transpose_sub`, past
    ``TRANSPOSE_MAX_SUB`` sub-columns in super-chunks).  Its shared-memory
    kernel, which took ``vl < 4``, is gone; the wrapper raises on elements
    of another size."""
    return "reg"


def _transpose_launch(src: torch.Tensor, dst: torch.Tensor, vl: int, m: int,
                      to_layout: bool) -> None:
    lib = build.load("transpose")
    size = src.element_size()
    if size not in (2, 4, 8):
        raise ValueError(f"transpose kernel: no {src.dtype} support ({size}-byte elements)")
    if src.numel() == 0:
        return
    build.check(lib.repro_transpose_reg(src.data_ptr(), dst.data_ptr(), src.numel() // m, vl, m,
                                        transpose_sub(m)[0], size, int(to_layout), _stream()),
                "transpose kernel")
    LAUNCHES["transpose"] += 1


def block_transpose(x: torch.Tensor, vl: int, m: int,
                    out: torch.Tensor | None = None) -> torch.Tensor:
    """(..., N) → (..., N/(vl·m), m, vl) transpose layout."""
    n = x.shape[-1]
    if n % (vl * m):
        raise ValueError(f"minor extent {n} is not a multiple of vl*m={vl * m}")
    shape = tuple(x.shape[:-1]) + (n // (vl * m), m, vl)
    if x.device.type == "cpu":
        return _into(out, block_transpose_ref(x, vl, m), "block_transpose", x)
    _check_cuda(x, "block_transpose")
    dst = _out(out, shape, x, "block_transpose")
    _transpose_launch(x, dst, vl, m, True)
    return dst


def block_untranspose(t: torch.Tensor, vl: int, m: int,
                      out: torch.Tensor | None = None) -> torch.Tensor:
    """(..., nb, m, vl) → (..., nb·vl·m), inverse of :func:`block_transpose`.
    ``out`` may be the original natural-layout tensor, which it overwrites."""
    if tuple(t.shape[-2:]) != (m, vl):
        raise ValueError(f"layout shape {tuple(t.shape)} does not end in (m={m}, vl={vl})")
    shape = tuple(t.shape[:-3]) + (t.shape[-3] * vl * m,)
    if t.device.type == "cpu":
        return _into(out, block_untranspose_ref(t, vl, m), "block_untranspose", t)
    _check_cuda(t, "block_untranspose")
    dst = _out(out, shape, t, "block_untranspose")
    _transpose_launch(t, dst, vl, m, False)
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
    buffers fit.  Raises when no tile fits: this kernel never splits a
    launch (the register kernels' routes take every depth of reach up to 4
    at every rank, a deep sweep as consecutive launches,
    :func:`sweep1d_launches`, :func:`sweep2d_launches`,
    :func:`sweep3d_launches`)."""
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
                f"t0={t0}); the shared-memory kernel serves reach r > 4 only, and "
                "ROADMAP D2 is closed on the register kernels (reach up to 4 at every "
                "rank, consecutive launches past their deepest instance)")
    return (tz, ty, tx), (hz, hy, hx), smem(tz, ty, tx)


# the Edge of stencil_sweep.cu, sweep1d_warp.cu and sweep2d_warp.cu
_EDGES = {"periodic": 0, "ring": 1, "open": 2}


def _taps(spec: StencilSpec, width: int, dtype: torch.dtype):
    """The taps as ctypes arrays: ``width`` int32 offsets per tap (the last
    ``width`` axes, zero-filled in front) and the coefficients rounded to
    ``dtype`` (the tensor's, as the plain versions' ``coeff``), as floats:
    exact for float32 and bfloat16."""
    ntaps = len(spec.taps)
    offs = (ctypes.c_int32 * (width * ntaps))()
    coeffs = (ctypes.c_float * ntaps)()
    for i, (off, c) in enumerate(spec.taps):
        offs[width * i:width * (i + 1)] = list(((0,) * width + tuple(off))[-width:])
        coeffs[i] = coeff(c, dtype)
    return ntaps, offs, coeffs


def _sweep_launch(spec: StencilSpec, t: torch.Tensor, out: torch.Tensor,
                  depth: int, t0: int | None, edge: str = "periodic") -> None:
    _kernel_io(t, out, "the CUDA sweep kernel")
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
    ntaps, offs, coeffs = _taps(spec, 3, t.dtype)
    if ntaps > lib.repro_stencil_max_taps():
        raise ValueError(f"{spec.name}: {ntaps} taps exceed the kernel's limit")
    nd, r = spec.ndim, spec.r
    build.check(_entry("stencil_sweep", "stencil_sweep", t.dtype)(
        t.data_ptr(), out.data_ptr(), *nat, vl, m, tz, ty, tx, hz, hy, hx,
        r if nd == 3 else 0, r if nd >= 2 else 0, r, depth, _EDGES[edge],
        3 - nd,                              # the stencil's axis 0 in (z, y, x)
        ntaps, ctypes.cast(offs, ctypes.c_void_p), ctypes.cast(coeffs, ctypes.c_void_p),
        smem, _stream()), f"{spec.name} sweep kernel")


def sub_columns(m: int) -> tuple[int, int]:
    """``(M, g)``: the instance a layout of ``m`` elements a column runs on
    in the register kernels (``csrc/sweep1d_warp.cu``, ``sweep2d_warp.cu``,
    ``sweep3d.cu``; ``M`` the largest of ``SUB_M`` dividing ``m``) and the
    ``g = m / M`` sub-columns of ``M`` consecutive natural points each
    column is cut into; a row of ``C = nb·vl`` columns is ``C' = g·C``
    sub-columns (``csrc/cols.cuh``)."""
    big = max(mm for mm in SUB_M if m % mm == 0)
    return big, m // big


def _launch_plan(depths: dict[int, tuple[int, ...]], m: int, depth: int
                 ) -> tuple[tuple[int, int, int], ...]:
    """Consecutive launches ``(M, g, D)`` that advance a layout of ``m``
    elements a column by ``depth`` steps on a register kernel: the
    instance ``M`` of :func:`sub_columns` (the largest dividing ``m``, ``g
    = m / M`` sub-columns a column), each launch the deepest of the depths
    ``depths[M]`` that is left.  One launch when ``M`` has the whole depth.
    On an H100 the largest ``M`` won at every depth (a smaller ``M``'s
    deeper instance is issue-bound: 2d5p 8192², m=8, depth 8 on ``M = 4``
    0.82 ms, two depth-4 launches on ``M = 8`` 0.41; at 3-D a depth-8
    instance at ``M = 1`` or ``2`` lost to two depth-4 launches of the same
    ``M``), and at one ``M`` its deepest instance did (PERF.md section 6).
    Jacobi steps compose, and each launch defines the ends at every step,
    so the result is bit for bit that of one deeper launch."""
    big, g = sub_columns(m)
    plan, left = [], depth
    while left > 0:
        d = max(dd for dd in depths[big] if dd <= left)
        plan.append((big, g, d))
        left -= d
    return tuple(plan)


def _chain(launch, t: torch.Tensor, dst: torch.Tensor, plan) -> None:
    """``launch(src, out, D)`` for each ``(M, g, D)`` of ``plan`` in turn,
    ``t`` → … → ``dst``, through one scratch buffer when there are two or
    more (the last launch writes ``dst``; no launch writes its input)."""
    tmp = torch.empty_like(dst) if len(plan) > 1 else None
    src = t
    for i, (_, _, d) in enumerate(plan):
        target = dst if (len(plan) - 1 - i) % 2 == 0 else tmp
        launch(src, target, d)
        src = target


def sweep1d_route(vl: int, m: int, depth: int, r: int) -> str:
    """The kernel a CUDA :func:`stencil1d_sweep_ttile` or
    :func:`stencil1d_multistep` (``depth = k``) launches: ``"warp"``
    (``csrc/sweep1d_warp.cu``, at any ``vl``, ``m`` and depth: a warp row
    is 32 sub-columns of ``M`` points, one per lane, :func:`sub_columns`;
    a lane's halo comes from the lanes up to ``ceil(r / M)`` away, and the
    launches are those :func:`sweep1d_launches` names) when the reach is
    the kernel's (``r <= WARP_MAX_R``); ``"smem"``
    (``csrc/stencil_sweep.cu``) for ``r > 4``, which no registry stencil
    has.  The periodic, ring and open ends take the same route at every
    column count."""
    if vl >= 1 and m >= 1 and depth >= 0 and 1 <= r <= WARP_MAX_R:
        return "warp"
    return "smem"


@functools.lru_cache(maxsize=None)
def sweep1d_launches(m: int, depth: int, r: int) -> tuple[tuple[int, int, int], ...]:
    """The launches ``(M, g, D)`` of ``csrc/sweep1d_warp.cu`` for a
    depth-``depth`` sweep of reach ``r`` at ``m`` (:func:`_launch_plan`):
    a launch corrupts ``D·r`` elements at each end of a warp's span, which
    its halo warp row of ``32·M`` holds, so each launch is at most
    ``32·M // r`` deep (m = 1, r = 1: depth 34 is 32 then 2).  Depth 0 is
    one launch that copies."""
    big, g = sub_columns(m)
    plan = _launch_plan({big: tuple(range(1, WARP_LANES * big // r + 1))}, m, depth)
    return plan or ((big, g, 0),)


def _warp_launch(spec: StencilSpec, t: torch.Tensor, out: torch.Tensor, depth: int,
                 edge: str = "periodic") -> None:
    _kernel_io(t, out, "the warp sweep kernel")
    nb, m, vl = t.shape
    big, g = sub_columns(m)
    if g != 1 and nb * vl * g >= MAX_COLS:
        raise ValueError(f"{spec.name}: {nb * vl * g} columns at vl={vl}, m={m} (sub-columns "
                         f"of {big}); the warp kernel takes fewer than {MAX_COLS} off m in "
                         f"{SUB_M}")
    ntaps, offs, coeffs = _taps(spec, 1, t.dtype)
    build.check(_entry("sweep1d_warp", "sweep1d_warp", t.dtype)(
        t.data_ptr(), out.data_ptr(), nb, m, vl, spec.r, WARP_BLOCKS[big], depth, _EDGES[edge],
        ntaps,
        ctypes.cast(offs, ctypes.c_void_p), ctypes.cast(coeffs, ctypes.c_void_p), _stream()),
        f"{spec.name} warp sweep kernel")


def stencil1d_sweep_ttile(spec: StencilSpec, t: torch.Tensor, k: int,
                          ttile: int = 1, out: torch.Tensor | None = None
                          ) -> torch.Tensor:
    """``ttile`` fully periodic k-step sweeps (``depth = ttile·k`` steps) of
    the layout-resident (nb, m, vl) array, on the kernel
    :func:`sweep1d_route` names: the warp kernel's launches of
    :func:`sweep1d_launches` (one unless the sweep is deeper than
    ``32·M // r``), or one launch of the shared-memory kernel."""
    _check_layout(spec, t)
    if spec.ndim != 1:
        raise ValueError(f"{spec.name} is not a 1-D stencil")
    if t.device.type == "cpu":
        return _into(out, stencil1d_sweep_ttile_ref(spec, t, k, ttile), "stencil1d_sweep_ttile")
    _check_cuda(t, "stencil1d_sweep_ttile")
    dst = _out(out, t.shape, t, "stencil1d_sweep_ttile")
    _launches(spec, t, dst, sweep_depth(k, ttile), None, "periodic")
    return dst


def sweep2d_depths(r: int) -> dict[int, tuple[int, ...]]:
    """The depths of ``csrc/sweep2d_warp.cu``'s instances of reach ``r`` by
    ``M``, all of them on the route."""
    return {mm: tuple(range(1, WARP2D_DEPTH[mm, r] + 1)) + WARP2D_DEEP.get((mm, r), ())
            for mm in SUB_M}


# every instance's depth·r fits its halo warps: depth·r <= 32·M
assert all(d * r <= WARP_LANES * mm for r in range(1, WARP2D_MAX_R + 1)
           for mm, ds in sweep2d_depths(r).items() for d in ds)


def sweep2d_route(vl: int, m: int, depth: int, r: int) -> str:
    """The kernel a CUDA :func:`stencil_nd_sweep_ttile` or
    :func:`stencil_nd_multistep` (``depth = k``) launches for a 2-D
    stencil: ``"warp"`` (``csrc/sweep2d_warp.cu``, at any ``vl``, ``m`` and
    ``depth``: a warp covers 32 sub-columns of ``M`` points of a row, one
    per lane, a lane's x halo from the lanes up to ``ceil(r / M)`` away, on
    the instances :func:`sweep2d_launches` names) when the reach is the
    kernel's (``r <= WARP2D_MAX_R``); ``"smem"`` (``csrc/stencil_sweep.cu``)
    for ``r > 4``, which no registry stencil has."""
    if vl >= 1 and m >= 1 and depth >= 1 and 1 <= r <= WARP2D_MAX_R:
        return "warp"
    return "smem"


@functools.lru_cache(maxsize=None)
def sweep2d_launches(m: int, depth: int, r: int) -> tuple[tuple[int, int, int], ...]:
    """The launches ``(M, g, D)`` of ``csrc/sweep2d_warp.cu`` for a
    depth-``depth`` sweep of reach ``r`` at ``m`` (:func:`_launch_plan`):
    past the deepest instance of ``(M, r)`` consecutive launches (r = 1,
    m = 8: depth 8 two of depth 4, 16 four; m = 2: depth 16 one; r = 2, m =
    8: depth 4 two of depth 2)."""
    return _launch_plan(sweep2d_depths(r), m, depth)


def warp_rows(cols: int) -> int:
    """Warp rows of 32 over a layout row's ``cols`` sub-columns
    (``C' = g·nb·vl``; the last one partial when 32 does not divide
    them)."""
    return -(-cols // WARP_LANES)


def sweep2d_segment(n0: int, wrows: int, ctas: int) -> int:
    """Axis-0 rows per CTA of the 2-D warp kernel: about ``ctas`` CTAs over
    the grid (``WARP2D_WARPS - 2`` of the ``wrows`` warp rows of a row
    each), and no segment shorter than ``WARP2D_SEG_MIN`` rows, whose
    2·depth·r warm-up rows are read twice."""
    ncol = -(-wrows // (WARP2D_WARPS - 2))
    nseg = max(1, min(-(-ctas // ncol), -(-n0 // WARP2D_SEG_MIN)))
    return -(-n0 // nseg)


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _warp2d_launch(spec: StencilSpec, t: torch.Tensor, out: torch.Tensor, depth: int,
                   edge: str = "periodic", seg_rows: int | None = None) -> None:
    """One launch of the 2-D warp kernel with the ends ``edge`` on axis 0,
    ``seg_rows`` axis-0 rows per CTA (by default one CTA per SM, a single
    wave: at 8192², m=8 this beat two waves and the shorter segments' extra
    warm-up rows, ``tools/sweep2d_segments.py``), on the instance
    :func:`sub_columns` names for ``m``, which must have ``depth``."""
    _kernel_io(t, out, "the 2-D warp sweep kernel")
    n0, nb, m, vl = t.shape
    big, g = sub_columns(m)
    any_form = (vl != WARP_LANES or g != 1 or spec.r != 1 or depth > WARP2D_DEPTH[big, 1]
                or t.dtype != torch.float32)
    if any_form and nb * vl * g >= MAX_COLS:
        raise ValueError(f"{spec.name}: {nb * vl * g} columns a row at vl={vl}, m={m} "
                         f"(sub-columns of {big}); the 2-D warp kernel takes fewer than "
                         f"{MAX_COLS} off float32 at vl={WARP_LANES}, m = M, r = 1 and past its "
                         f"depth {WARP2D_DEPTH[big, 1]}")
    if seg_rows is None:
        seg_rows = sweep2d_segment(n0, warp_rows(nb * vl * g), _sm_count(t.device))
    ntaps, offs, coeffs = _taps(spec, 2, t.dtype)
    build.check(_entry("sweep2d_warp", "sweep2d_warp", t.dtype)(
        t.data_ptr(), out.data_ptr(), n0, nb, m, vl, spec.r, depth, _EDGES[edge], seg_rows, ntaps,
        ctypes.cast(offs, ctypes.c_void_p), ctypes.cast(coeffs, ctypes.c_void_p), _stream()),
        f"{spec.name} 2-D warp sweep kernel")


def sweep3d_route(vl: int, m: int, depth: int, r: int) -> str:
    """The kernel a CUDA :func:`stencil_nd_sweep_ttile` or
    :func:`stencil_nd_multistep` (``depth = k``) launches for a 3-D
    stencil: ``"stream"`` (``csrc/sweep3d.cu``, at any ``vl``, ``m`` and
    ``depth``: a thread owns a sub-column of the layout, on the instances
    :func:`sweep3d_launches` names) when the reach is the kernel's (``r <=
    SWEEP3D_MAX_R``); ``"smem"`` (``csrc/stencil_sweep.cu``) for ``r > 4``,
    which no registry stencil has.  The periodic, ring and open ends take
    the same route."""
    if vl >= 1 and m >= 1 and depth >= 1 and 1 <= r <= SWEEP3D_MAX_R:
        return "stream"
    return "smem"


@functools.lru_cache(maxsize=None)
def sweep3d_launches(m: int, depth: int, r: int) -> tuple[tuple[int, int, int], ...]:
    """The launches ``(M, g, D)`` of ``csrc/sweep3d.cu`` for a
    depth-``depth`` sweep of reach ``r`` at ``m`` (:func:`_launch_plan` over
    the depths 1 to ``SWEEP3D_DEPTH[M, r]``): past the deepest consecutive
    launches (r = 1: past depth 4; r = 2, m = 8: past depth 2)."""
    return _launch_plan({mm: tuple(range(1, SWEEP3D_DEPTH[mm, r] + 1)) for mm in SUB_M}, m,
                        depth)


def sweep3d_order(spec: StencilSpec) -> str:
    """The tap order ``csrc/sweep3d.cu`` compiles in for ``spec``:
    ``"star"`` (3d7p's, and the star of reach 2 in ``_star_taps``' order),
    ``"box"`` (3d27p's), else ``"runtime"``."""
    offs = tuple(tuple(off) for off, _ in spec.taps)
    if offs == _STAR3.get(spec.r):
        return "star"
    return "box" if offs == _BOX3 else "runtime"


def sweep3d_slots(depth: int, r: int) -> int:
    """Input planes in the ring of a depth-``depth`` instance of
    ``csrc/sweep3d.cu`` of reach ``r``: those in flight, the landed one,
    and the 2r + 1 the first level reads."""
    return (SWEEP3D_STAGES_D1 if depth == 1 else SWEEP3D_STAGES) + 2 * r + 2


def sweep3d_tile(m: int, depth: int, order: str, r: int) -> tuple[int, int, int, int]:
    """The tile of the ``csrc/sweep3d.cu`` instance ``M = m`` of reach
    ``r`` (its ``Tile``; ``m`` in ``SUB_M``): rows ``ty`` and
    (sub-)columns ``cx`` a CTA computes, and its halo (sub-)columns ``hx =
    ceil(depth·r / M)`` and rows ``hy = depth·r`` per side.  The star's
    levels publish into 2 plane slots, the others' into 2r + 2; each
    element row of a plane has ``r·cx + ceil(r / M)`` unwritten words a
    side; ``ty`` is as many rows as ``SWEEP3D_THREADS`` threads and the
    shared memory allow."""
    hx, hy = -(-depth * r // m), depth * r
    cx = SWEEP3D_LANES + 2 * hx
    planes = sweep3d_slots(depth, r) + (depth - 1) * (2 if order == "star" else 2 * r + 2)
    pad = r * cx - (-r // m)
    ty = min(SWEEP3D_THREADS // cx, (SWEEP3D_SMEM // 4 // (planes * m) - 2 * pad) // cx)
    return ty, cx, hx, hy


def sweep3d_segment(n0: int, n1: int, cols: int, m: int, depth: int, order: str,
                    ctas: int, r: int) -> int:
    """Axis-0 planes per CTA of the 3-D kernel's instance ``M = m`` of
    reach ``r`` on rows of ``cols`` (sub-)columns (``C' = g·nb·vl``): the
    segment length whose waves of ``ctas`` CTAs (one per SM) times the
    steps of a segment (its planes and (2r + 1)·depth warm-up steps) are
    fewest; no segment shorter than ``SWEEP3D_SEG_MIN`` planes unless the
    grid is."""
    ty, _, _, hy = sweep3d_tile(m, depth, order, r)
    tiles = -(-cols // SWEEP3D_LANES) * -(-n1 // (ty - 2 * hy))
    best = None
    for nseg in range(1, -(-n0 // SWEEP3D_SEG_MIN) + 1):
        seg = -(-n0 // nseg)
        cost = -(-tiles * -(-n0 // seg) // ctas) * (seg + (2 * r + 1) * depth)
        if best is None or cost < best[0]:
            best = (cost, seg)
    return best[1]


def _sweep3d_launch(spec: StencilSpec, t: torch.Tensor, out: torch.Tensor, depth: int,
                    edge: str = "periodic", seg: int | None = None) -> None:
    """One launch of the 3-D streaming kernel (depth 1 to
    ``SWEEP3D_DEPTH[M, r]``) with the ends ``edge`` on axis 0, ``seg``
    axis-0 planes per CTA (by default :func:`sweep3d_segment` over the
    card's SMs), on the instance :func:`sub_columns` names for ``m``."""
    n0, n1, nb, m, vl = t.shape
    big, g = sub_columns(m)
    any_form = vl != WARP_LANES or g != 1 or spec.r != 1 or t.dtype != torch.float32
    if any_form and nb * vl * g >= MAX_COLS:
        raise ValueError(f"{spec.name}: {nb * vl * g} columns a row at vl={vl}, m={m} "
                         f"(sub-columns of {big}); the 3-D streaming kernel takes fewer than "
                         f"{MAX_COLS} off float32 at vl={WARP_LANES}, m in {SUB_M}, r = 1")
    _kernel_io(t, out, "the 3-D streaming sweep kernel")
    if seg is None:
        seg = sweep3d_segment(n0, n1, nb * vl * g, big, depth, sweep3d_order(spec),
                              _sm_count(t.device), spec.r)
    ntaps, offs, coeffs = _taps(spec, 3, t.dtype)
    build.check(_entry("sweep3d", "sweep3d", t.dtype)(
        t.data_ptr(), out.data_ptr(), n0, n1, nb, m, vl, spec.r, depth, _EDGES[edge], seg,
        ntaps, ctypes.cast(offs, ctypes.c_void_p), ctypes.cast(coeffs, ctypes.c_void_p),
        _stream()), f"{spec.name} 3-D streaming sweep kernel")


def stencil_nd_sweep_ttile(spec: StencilSpec, t: torch.Tensor, k: int,
                           ttile: int, t0: int, out: torch.Tensor | None = None
                           ) -> torch.Tensor:
    """``ttile`` fully periodic k-step sweeps of the layout-resident
    (n0, *mid, nb, m, vl) array; ``t0`` is the axis-0 rows of the
    shared-memory kernel's output tile (it must divide n0 and reach the
    radius, as the reference's pipeline tile must).  A sweep that
    :func:`sweep2d_route` or :func:`sweep3d_route` sends to a streaming
    kernel runs as the launches :func:`sweep2d_launches` /
    :func:`sweep3d_launches` name and picks its own segment length: results
    never depend on the tile or the split."""
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
    _launches(spec, t, dst, sweep_depth(k, ttile), t0, "periodic")
    return dst


def _launches(spec: StencilSpec, t: torch.Tensor, dst: torch.Tensor, depth: int,
              t0: int | None, edge: str) -> None:
    """A depth-``depth`` sweep with the ends ``edge`` on axis 0
    (``periodic``: K1 / K3; ``ring`` / ``open``: K4a / K4b) on the kernel
    the route names: the register kernels' launches of
    :func:`sweep1d_launches` / :func:`sweep2d_launches` /
    :func:`sweep3d_launches`, one after another, each counted; else one
    launch of the shared-memory kernel (``t0``: its axis-0 tile)."""
    # checked before the chain: its launches read and write other buffers
    _kernel_io(t, dst, "the sweep kernels")
    kind = "sweep" if edge == "periodic" else "multistep"
    nb, m, vl = t.shape[-3:]
    if spec.ndim == 1 and sweep1d_route(vl, m, depth, spec.r) == "warp":
        kernel, key, plan = _warp_launch, "1d", sweep1d_launches(m, depth, spec.r)
    elif spec.ndim == 2 and sweep2d_route(vl, m, depth, spec.r) == "warp":
        _check_nd_taps(spec)
        kernel, key, plan = _warp2d_launch, "2d", sweep2d_launches(m, depth, spec.r)
    elif spec.ndim == 3 and sweep3d_route(vl, m, depth, spec.r) == "stream":
        _check_nd_taps(spec)
        kernel, key, plan = _sweep3d_launch, "3d", sweep3d_launches(m, depth, spec.r)
    else:
        _sweep_launch(spec, t, dst, depth, t0, edge)
        LAUNCHES[f"{kind}_1d_smem" if spec.ndim == 1 else f"{kind}_nd"] += 1
        return

    def launch(src, out, d):
        kernel(spec, src, out, d, edge)
        LAUNCHES[f"{kind}_{key}"] += 1
    _chain(launch, t, dst, plan)


def _check_nd_taps(spec: StencilSpec) -> None:
    if len(spec.taps) > ND_MAX_TAPS:
        raise ValueError(f"{spec.name}: {len(spec.taps)} taps exceed the register kernels' "
                         f"limit of {ND_MAX_TAPS}")


def stencil1d_sweep_periodic(spec: StencilSpec, t: torch.Tensor, k: int,
                             out: torch.Tensor | None = None) -> torch.Tensor:
    """One fully periodic k-step sweep — the ``ttile=1`` slice."""
    return stencil1d_sweep_ttile(spec, t, k, 1, out=out)


def stencil_nd_sweep_periodic(spec: StencilSpec, t: torch.Tensor, k: int,
                              t0: int, out: torch.Tensor | None = None) -> torch.Tensor:
    """n-D ``ttile=1`` slice of :func:`stencil_nd_sweep_ttile`."""
    return stencil_nd_sweep_ttile(spec, t, k, 1, t0, out=out)


# ---------------------------------------------------------------------------
# K4: the multistep sweeps with a Dirichlet ring or open axis-0 edges
# ---------------------------------------------------------------------------

def sweep_halo_blocks(r: int, k: int, block: int) -> int:
    """Whole ``block``-sized units (layout blocks or axis-0 tiles) that
    cover the k·r cells a k-step sweep corrupts next to an axis-0 edge."""
    return -(-(k * r) // block)


def _ring_mask(spec: StencilSpec, t: torch.Tensor) -> torch.Tensor:
    """True on the r cells nearest each end of axis 0, in layout."""
    r = spec.r
    if spec.ndim == 1:
        nb, m, vl = t.shape
        g = (torch.arange(nb, device=t.device)[:, None, None] * (vl * m)
             + torch.arange(vl, device=t.device)[None, None, :] * m
             + torch.arange(m, device=t.device)[None, :, None])     # natural index
        n = nb * vl * m
    else:
        n = t.shape[0]
        g = torch.arange(n, device=t.device).reshape((n,) + (1,) * (t.ndim - 1))
    return (g < r) | (g >= n - r)


def _open_step(spec: StencilSpec, t: torch.Tensor) -> torch.Tensor:
    """One layout step with zeros outside axis 0: a zero block (1-D) or r
    zero rows (n-D) on each side, a periodic step, the domain cut out."""
    width = 1 if spec.ndim == 1 else spec.r
    z = t.new_zeros((width,) + tuple(t.shape[1:]))
    ext = step_in_layout(spec, torch.cat([z, t, z]), ndim=spec.ndim)
    return ext.narrow(0, width, t.shape[0])


def _multistep_ref(spec: StencilSpec, t: torch.Tensor, k: int, edge_mask: bool) -> torch.Tensor:
    if edge_mask:
        ring = _ring_mask(spec, t)
        for _ in range(k):
            t = torch.where(ring, t, step_in_layout(spec, t, ndim=spec.ndim))
        return t
    for _ in range(k):
        t = _open_step(spec, t)
    return t


def stencil1d_multistep_ref(spec: StencilSpec, t: torch.Tensor, k: int,
                            edge_mask: bool = True) -> torch.Tensor:
    """Plain version of :func:`stencil1d_multistep`: k layout steps, with
    the ring restored (``edge_mask``) or zeros read beyond the ends."""
    return _multistep_ref(spec, t, k, edge_mask)


def stencil_nd_multistep_ref(spec: StencilSpec, t: torch.Tensor, k: int, t0: int,
                             edge_mask: bool = True) -> torch.Tensor:
    """Plain version of :func:`stencil_nd_multistep` (``t0`` only shapes
    the kernel's tile)."""
    return _multistep_ref(spec, t, k, edge_mask)


def stencil1d_multistep(spec: StencilSpec, t: torch.Tensor, k: int,
                        edge_mask: bool = True, out: torch.Tensor | None = None
                        ) -> torch.Tensor:
    """k steps of the (nb, m, vl) layout array in one launch.

    ``edge_mask=True``: a Dirichlet ring — at every step the r cells
    nearest each end of the array keep their value.  ``edge_mask=False``:
    no ring; cells beyond either end hold 0 at every step (read as zeros,
    never updated).  The reference's Pallas kernel leaves unspecified
    values within k·r of the ends in that mode, which its callers crop.
    The kernel is the one :func:`sweep1d_route` names for depth k, in the
    launches of :func:`sweep1d_launches` on the warp kernel: each defines
    the ends at every step, so a chain equals one deeper launch."""
    _check_layout(spec, t)
    if spec.ndim != 1:
        raise ValueError(f"{spec.name} is not a 1-D stencil")
    if t.device.type == "cpu":
        return _into(out, stencil1d_multistep_ref(spec, t, k, edge_mask), "stencil1d_multistep")
    _check_cuda(t, "stencil1d_multistep")
    dst = _out(out, t.shape, t, "stencil1d_multistep")
    _launches(spec, t, dst, k, None, "ring" if edge_mask else "open")
    return dst


def stencil_nd_multistep(spec: StencilSpec, t: torch.Tensor, k: int, t0: int,
                         edge_mask: bool = True, out: torch.Tensor | None = None
                         ) -> torch.Tensor:
    """k steps of the (n0, *mid, nb, m, vl) layout array: axis 0 has the
    Dirichlet ring (``edge_mask=True``, its r first and last
    rows keep their value) or open edges (``edge_mask=False``, rows beyond
    either end hold 0), every other axis is periodic.  ``t0`` is the axis-0
    rows of the shared-memory kernel's tile; it must divide n0 and reach the
    radius, as the reference's pipeline tile must.  A sweep that
    :func:`sweep2d_route` or :func:`sweep3d_route` sends to a streaming
    kernel (depth k) runs as the launches of :func:`sweep2d_launches` /
    :func:`sweep3d_launches`, picks its own segment length and ignores
    ``t0``: results never depend on the tile or the split."""
    _check_layout(spec, t)
    if spec.ndim not in (2, 3):
        raise ValueError(f"{spec.name} is not a 2-D or 3-D stencil")
    n0 = t.shape[0]
    if t0 < spec.r or n0 % t0:
        raise ValueError(f"{spec.name}: axis-0 tile t0={t0} must divide n0={n0} "
                         f"and be at least r={spec.r}")
    if t.device.type == "cpu":
        return _into(out, stencil_nd_multistep_ref(spec, t, k, t0, edge_mask),
                     "stencil_nd_multistep")
    _check_cuda(t, "stencil_nd_multistep")
    dst = _out(out, t.shape, t, "stencil_nd_multistep")
    _launches(spec, t, dst, k, t0, "ring" if edge_mask else "open")
    return dst


def stencil1d_sweep_halo(spec: StencilSpec, t: torch.Tensor, k: int, halo: int,
                         out: torch.Tensor | None = None) -> torch.Tensor:
    """One k-step sweep of a halo-extended (nb, m, vl) shard whose edge
    blocks carry ``halo >= k·r`` exchanged ghost elements per side: open
    edges, everything they disturb lies in the ghosts the caller crops."""
    if halo < k * spec.r:
        raise ValueError(f"halo {halo} is below k*r = {k * spec.r}")
    return stencil1d_multistep(spec, t, k, edge_mask=False, out=out)


def stencil_nd_sweep_halo(spec: StencilSpec, t: torch.Tensor, k: int, t0: int,
                          halo: int, out: torch.Tensor | None = None) -> torch.Tensor:
    """n-D analogue of :func:`stencil1d_sweep_halo`: ``halo`` exchanged
    ghost rows per side on axis 0, whole ``t0``-row tiles."""
    if halo < k * spec.r or halo % t0:
        raise ValueError(f"halo {halo} must be at least k*r = {k * spec.r} and a "
                         f"multiple of t0={t0}")
    return stencil_nd_multistep(spec, t, k, t0, edge_mask=False, out=out)


# ---------------------------------------------------------------------------
# K5: one periodic step in the natural and in the transpose layout
# ---------------------------------------------------------------------------

def stencil1d_naive_onestep_ref(spec: StencilSpec, x: torch.Tensor,
                                vl: int = 32) -> torch.Tensor:
    """Plain version of :func:`stencil1d_naive_onestep`: one roll per tap."""
    return apply_once(spec, x, bc="periodic")


def stencil1d_transpose_onestep_ref(spec: StencilSpec, t: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`stencil1d_transpose_onestep`."""
    return step_in_layout(spec, t, ndim=1)


def _check_onestep(spec: StencilSpec) -> None:
    """Raise unless the one-step kernels take ``spec``'s reach and taps."""
    lib = build.load("onestep")
    if spec.r > lib.repro_onestep_max_reach() or len(spec.taps) > lib.repro_onestep_max_taps():
        raise ValueError(f"{spec.name}: the one-step kernels take r <= "
                         f"{lib.repro_onestep_max_reach()} and at most "
                         f"{lib.repro_onestep_max_taps()} taps")


def stencil1d_naive_onestep(spec: StencilSpec, x: torch.Tensor, vl: int = 32,
                            out: torch.Tensor | None = None) -> torch.Tensor:
    """One periodic step of the natural-layout (N,) array, viewed as
    (N/vl, vl) rows: every tap shifts across lanes (the layout A/B's
    baseline)."""
    if spec.ndim != 1 or x.ndim != 1:
        raise ValueError(f"{spec.name}: the natural-layout one-step takes a 1-D stencil "
                         f"and a 1-D array, got shape {tuple(x.shape)}")
    if x.shape[0] % vl:
        raise ValueError(f"extent {x.shape[0]} is not a multiple of vl={vl}")
    if x.device.type == "cpu":
        return _into(out, stencil1d_naive_onestep_ref(spec, x, vl), "stencil1d_naive_onestep")
    _check_cuda(x, "stencil1d_naive_onestep")
    dst = _out(out, x.shape, x, "stencil1d_naive_onestep")
    _kernel_io(x, dst, "the naive one-step kernel")
    _check_onestep(spec)
    ntaps, offs, coeffs = _taps(spec, 1, x.dtype)
    build.check(_entry("onestep", "onestep_naive", x.dtype)(
        x.data_ptr(), dst.data_ptr(), x.shape[0], ntaps, ctypes.cast(offs, ctypes.c_void_p),
        ctypes.cast(coeffs, ctypes.c_void_p), _stream()), f"{spec.name} naive one-step kernel")
    LAUNCHES["onestep_naive"] += 1
    return dst


def stencil1d_transpose_onestep(spec: StencilSpec, t: torch.Tensor,
                                out: torch.Tensor | None = None) -> torch.Tensor:
    """One periodic step of the (nb, m, vl) layout array: shifts inside a
    vector set, the 2r Assembled rows carried across lanes."""
    _check_layout(spec, t)
    if spec.ndim != 1:
        raise ValueError(f"{spec.name} is not a 1-D stencil")
    if t.device.type == "cpu":
        return _into(out, stencil1d_transpose_onestep_ref(spec, t),
                     "stencil1d_transpose_onestep")
    _check_cuda(t, "stencil1d_transpose_onestep")
    dst = _out(out, t.shape, t, "stencil1d_transpose_onestep")
    _kernel_io(t, dst, "the transpose one-step kernel")
    _check_onestep(spec)
    ntaps, offs, coeffs = _taps(spec, 1, t.dtype)
    nb, m, vl = t.shape
    build.check(_entry("onestep", "onestep_transpose", t.dtype)(
        t.data_ptr(), dst.data_ptr(), nb, m, vl, spec.r, ntaps,
        ctypes.cast(offs, ctypes.c_void_p), ctypes.cast(coeffs, ctypes.c_void_p), _stream()),
        f"{spec.name} transpose one-step kernel")
    LAUNCHES["onestep_transpose"] += 1
    return dst


# ---------------------------------------------------------------------------
# mxu: a depth-d sweep as one product against the banded operator A^d
# ---------------------------------------------------------------------------

def _mxu(spec: StencilSpec, t: torch.Tensor, depth: int, lead_halo=None,
         block_halo: int = 0) -> torch.Tensor:
    if t.ndim != spec.ndim + 2:
        raise ValueError(f"{spec.name}: expected a ({spec.ndim - 1} lead, nb, m, vl) "
                         f"layout, got shape {tuple(t.shape)}")
    op = matrixize.operator(spec, t.shape[-1], t.shape[-2], depth)
    if block_halo and block_halo < op.block_reach():
        raise ValueError(f"block_halo {block_halo} is below the operator's block reach "
                         f"{op.block_reach()}")
    out = matrixize.apply_banded(op, t, lead_halo=lead_halo, block_halo=block_halo)
    if t.device.type == "cuda":
        LAUNCHES["mxu"] += 1
    return out


def stencil1d_sweep_mxu(spec: StencilSpec, t: torch.Tensor, depth: int) -> torch.Tensor:
    """Advance the fully periodic resident (nb, m, vl) layout by ``depth``
    steps with ONE product against the banded operator ``A^depth``."""
    return _mxu(spec, t, depth)


def stencil_nd_sweep_mxu(spec: StencilSpec, t: torch.Tensor, depth: int) -> torch.Tensor:
    """n-D analogue: t is (n0, *mid, nb, m, vl); the operator carries the
    leading-axis taps as periodic shifts of the operand and the minor-axis
    coupling (lane carries included) in its block matrices."""
    return _mxu(spec, t, depth)


def stencil1d_sweep_mxu_halo(spec: StencilSpec, t: torch.Tensor, depth: int,
                             block_halo: int) -> torch.Tensor:
    """Depth-``depth`` advance of a ghost-EXTENDED resident shard (nb +
    2·block_halo blocks, ghosts filled by a halo exchange); returns the nb
    interior blocks — no ghost-zone compute, nothing for the caller to
    crop.  ``block_halo`` must cover the operator's block reach."""
    if block_halo < 1:
        raise ValueError(f"block_halo {block_halo}: the halo form needs ghost blocks")
    return _mxu(spec, t, depth, block_halo=block_halo)


def stencil_nd_sweep_mxu_halo(spec: StencilSpec, t: torch.Tensor, depth: int,
                              lead_halo, block_halo: int) -> torch.Tensor:
    """n-D halo form: ``lead_halo[a]`` ghost rows a side on leading axis
    ``a`` (0: the axis is whole and wraps), ``block_halo`` ghost blocks a
    side on the block axis (0: it wraps)."""
    return _mxu(spec, t, depth, lead_halo=lead_halo, block_halo=block_halo)
