"""Wrappers of the hand-written CUDA kernels, each beside its plain version.

  * K2 ``block_transpose`` / ``block_untranspose`` — ``csrc/transpose.cu``:
    (..., N) ↔ (..., nb, m, vl), the per-block (vl, m) ↔ (m, vl) transpose
    (reference: ``stencil_kernels.py::_kernel_transpose``), on its register
    kernel at every vl and m (one thread per sub-column of a block, or at
    vl < 4 a warp per span of whole blocks; :func:`transpose_route`).
  * K1 ``stencil1d_sweep_ttile`` and K3 ``stencil_nd_sweep_ttile``: a fully
    periodic depth-``ttile·k`` advance of the layout-resident grid (reference:
    ``_kernel_1d`` and ``_kernel_nd``).  K1 and K3 each take one of two
    kernels, chosen by shape before the launch: a register kernel where one
    applies (:func:`sweep1d_route`: ``csrc/sweep1d_warp.cu`` and
    :func:`sweep2d_route`: ``csrc/sweep2d_warp.cu``, a lane on each of 32
    consecutive sub-columns of the layout; :func:`sweep3d_route`:
    ``csrc/sweep3d.cu``, a thread on each sub-column; all three at any
    ``vl``, ``m`` and depth, on sub-columns of ``M`` points,
    :func:`sub_columns`), or the far-reach kernel ``csrc/sweep_far.cu``
    (reach r > 4, or more taps than the register kernels hold, at every
    rank: its taps at run time, streamed along axis 0 in 2-D and 3-D).  A
    sweep deeper than one launch takes is consecutive launches of either.
  * K4 ``stencil1d_multistep`` / ``stencil_nd_multistep`` (and the halo
    wrappers ``stencil{1d,_nd}_sweep_halo``) — the same kernels with a
    Dirichlet ring or open edges along axis 0 (reference: the same Pallas
    bodies with ``edge_mask``), on the routes of K1 and K3.
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

Every sweep wrapper (K1, K3, K4 and the far-reach kernel's routes) also
takes a batch of grids, a layout ``(B, …layout)`` of rank ``spec.ndim +
3``: the batch is a grid dimension of the launch (``gridDim.y`` of the
register kernels, folded into ``blockIdx.z`` with the axis-0 segments in
``csrc/sweep_far.cu``; at most ``MAX_BATCH`` grids), each grid advanced
bit for bit as alone, and the launch counts once.  K2 moves a batch as
more rows.

A wrapper dispatches on the device of the tensor it is given: a CPU tensor
takes the plain PyTorch version (``*_ref``), a CUDA tensor launches the
kernel or raises.  The stencil kernels (K1, K3, K4, K5) take float32 and
bfloat16 (each product and sum rounded to the dtype, as the plain versions
do); K2 moves elements of 2, 4 or 8 bytes.  Each launch adds one to
``LAUNCHES[<kernel>]`` (a sweep cut into consecutive launches adds one per
launch; a bfloat16 launch counts as a float32 one), the routes apart: K2
under ``transpose``; K1 under ``sweep_1d`` (warp kernel); K4a under
``multistep_1d``; K3 under ``sweep_2d`` (2-D warp kernel) and ``sweep_3d``
(3-D streaming kernel); K4b under ``multistep_2d`` and ``multistep_3d``;
the far-reach kernel at every rank under ``sweep_far`` (K1, K3) and
``multistep_far`` (K4); the mxu sweeps' products on the card under
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
LAUNCHES = {"transpose": 0, "sweep_1d": 0, "sweep_2d": 0, "sweep_3d": 0, "sweep_far": 0,
            "multistep_1d": 0, "multistep_2d": 0, "multistep_3d": 0, "multistep_far": 0,
            "onestep_naive": 0, "onestep_transpose": 0, "mxu": 0}
# csrc/transpose.cu's forms: vl below TRANSPOSE_MIN_VL a warp a span of
# whole blocks (transpose_small); from it a thread a sub-column of M =
# transpose_sub(m), with every stride fixed (transpose_reg: vl a power of
# two, m in TRANSPOSE_M) or G and vl at run time (transpose_any: sub-columns
# in a grid, or past it in each super-chunk along blockIdx.y, fewer than
# TRANSPOSE_MAX_SUB, for 32-bit indices)
TRANSPOSE_MIN_VL = 4
TRANSPOSE_M = frozenset(range(1, 9)) | {16, 32}
TRANSPOSE_MAX_SUB = 1 << 31
# grids one launch into the layout reads where they lie (csrc/transpose.cu's
# kMaxParts: a table of their pointers as a kernel argument)
TRANSPOSE_MAX_PARTS = 64
# a warp row of the register kernels: 32 sub-columns of the layout, one a lane
WARP_LANES = 32
# grids a sweep launch takes: a leading batch of the layout is a grid
# dimension of every sweep kernel (gridDim.y of the register kernels; folded
# into gridDim.z with the axis-0 segments in csrc/sweep_far.cu), whose limit
# on the card this is (the kernels' kMaxBatch / kMaxZ)
MAX_BATCH = 65535
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
# taps a stencil may have on the register kernels (kMaxTaps of
# csrc/sweep1d_warp.cuh, and of csrc/sweep2d_warp.cuh and csrc/sweep3d.cuh):
# a spec of more takes the far-reach kernel
WARP_MAX_TAPS = 16
ND_MAX_TAPS = 64
# csrc/sweep_far.cu: threads a CTA, the shared memory a CTA may take (the
# card's limit), an SM's, and the share its tile aims at (two CTAs an SM),
# the deepest launch by rank (a deeper sweep is consecutive launches; the
# kernel takes one step a launch along a stream axis), and the output tile
# (rows, columns of m points) it starts from by rank: the columns, then the
# rows, halve until the planes fit the aim.  On an H100 (reach 5,
# tools/kernel_ab.py --only reach5, PERF.md section 6) 1-D depth 16 as 8 + 8
# beat 16 and 4 × 4; 2-D depth 4 as 4 × 1 beat 2 + 2 and one launch (when
# the kernel still kept a ring of 2r + 2 planes a level), and 3-D depth 2 as
# one launch ran 20× 1 + 1; 1-D tiles of 512 columns beat 256 and 1024,
# 2-D 256 beat 128 and tied 512
FAR_THREADS = 256
FAR_SMEM = 232448
FAR_SMEM_SM = 233472
FAR_SMEM_AIM = FAR_SMEM_SM // 2 - 1024
FAR_DEPTH = {1: 8, 2: 1, 3: 1}
FAR_TILE = {1: (1, 512), 2: (1, 256), 3: (16, 8)}
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
                      to_layout: bool, parts: list[torch.Tensor] | None = None) -> None:
    """One K2 launch from ``src`` to ``dst``; with ``parts`` (into the
    layout) the natural side is those grids, each read where it lies, and
    ``src`` the first of them."""
    lib = build.load("transpose")
    size = src.element_size()
    if size not in (2, 4, 8):
        raise ValueError(f"transpose kernel: no {src.dtype} support ({size}-byte elements)")
    if src.numel() == 0:
        return
    table = (ctypes.c_void_p * len(parts))(*[p.data_ptr() for p in parts]) if parts else None
    build.check(lib.repro_transpose_reg(src.data_ptr(), dst.data_ptr(), src.numel() // m, vl, m,
                                        transpose_sub(m)[0], size, int(to_layout), table,
                                        len(parts) if parts else 0, _stream()),
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


def block_transpose_parts(xs, vl: int, m: int) -> torch.Tensor:
    """A batch given as B grids of one shape, dtype and device, each where
    it lies, → ``(B, …, N/(vl·m), m, vl)``: :func:`block_transpose` of
    their stack without the stack.  On the card one launch reads every
    grid through a table of pointers (a launch per ``TRANSPOSE_MAX_PARTS``
    grids past that many)."""
    xs = list(xs)
    if not xs:
        raise ValueError("block_transpose_parts: no grids")
    first = xs[0]
    for x in xs[1:]:
        if x.shape != first.shape or x.dtype != first.dtype or x.device != first.device:
            raise ValueError(f"block_transpose_parts: the grids differ ({tuple(first.shape)} "
                             f"{first.dtype} {first.device} against {tuple(x.shape)} "
                             f"{x.dtype} {x.device})")
    n = first.shape[-1]
    if n % (vl * m):
        raise ValueError(f"minor extent {n} is not a multiple of vl*m={vl * m}")
    if first.device.type == "cpu":
        return block_transpose_ref(torch.stack(xs), vl, m)
    for x in xs:
        _check_cuda(x, "block_transpose_parts")
    dst = torch.empty((len(xs),) + tuple(first.shape[:-1]) + (n // (vl * m), m, vl),
                      dtype=first.dtype, device=first.device)
    for i in range(0, len(xs), TRANSPOSE_MAX_PARTS):
        part = xs[i:i + TRANSPOSE_MAX_PARTS]
        _transpose_launch(part[0], dst[i:i + len(part)], vl, m, True, part)
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


def batch_of(spec: StencilSpec, t: torch.Tensor) -> int:
    """The grids ``t`` holds: ``B`` for a batched ``(B, …layout)`` of rank
    ``spec.ndim + 3``, else 1."""
    return t.shape[0] if t.ndim == spec.ndim + 3 else 1


def _check_layout(spec: StencilSpec, t: torch.Tensor) -> None:
    """A layout of one grid, ``(n0, …, nb, m, vl)`` of rank ``spec.ndim +
    2``, or of a batch of grids, ``(B, n0, …, nb, m, vl)``; every sweep
    advances each grid of a batch on its own, bit for bit as alone."""
    if t.ndim not in (spec.ndim + 2, spec.ndim + 3):
        raise ValueError(f"{spec.name}: expected a ([B,] {spec.ndim - 1} lead, nb, m, vl) "
                         f"layout, got shape {tuple(t.shape)}")
    if spec.r > t.shape[-2]:
        raise ValueError(f"{spec.name}: m={t.shape[-2]} is below the stencil radius {spec.r}")
    if t.device.type == "cuda" and not 1 <= batch_of(spec, t) <= MAX_BATCH:
        raise ValueError(f"{spec.name}: a batch of {batch_of(spec, t)} grids; a sweep launch "
                         f"takes 1 to {MAX_BATCH} (the card's limit on a grid dimension)")


# the Edge of the sweep kernels (sweep_far.cu, sweep1d_warp, sweep2d_warp, sweep3d)
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


def far_smem(m: int, rz: int, ry: int, r: int, depth: int, ty: int, tc: int, ncp: int,
             ntaps: int, itemsize: int) -> int:
    """Dynamic shared memory (bytes) of one CTA of ``csrc/sweep_far.cu``
    (its ``layout``): the tap table (8 bytes a row s and a tap, 4 a tap's
    coefficient), the loaded plane's device offsets (8 bytes) and
    shared-memory indices (4) a point of a row, the output tile's device
    offsets (8), the 3-D tile's point indices (4), then the planes: a ring
    of ``2rz + 3`` along a stream axis (``rz > 0``, one step a launch),
    else one or two shared by the levels.  A plane is ``ty + 2·depth·ry``
    rows of ``m`` runs of ``ncp`` elements; in 1-D and 2-D 64 elements
    more, read and dropped by the lanes past a level's last point."""
    if rz and depth > 1:
        raise ValueError(f"the far-reach kernel takes one step a launch along a stream axis, "
                         f"not {depth}")
    hc = -(-r // m)
    py, nc = ty + 2 * depth * ry, tc + 2 * depth * hc
    qt = 0 if py == 1 else ty * tc
    tab = -(-(8 * m * ntaps + 4 * ntaps) // 8) * 8
    tables = -(-(tab + 12 * py * nc + 8 * ty * tc + 4 * qt) // 16) * 16
    planes = 2 * rz + 3 if rz else min(max(depth, 1), 2)
    return tables + itemsize * (py * m * ncp * planes + (64 if py == 1 else 0))


def far_pitch(ty: int, tc: int, nc: int, m: int, itemsize: int, fits=None) -> int | None:
    """The column pitch ``ncp >= nc`` of ``csrc/sweep_far.cu``'s planes: at
    one row a tile (1-D, 2-D) ``nc`` (a warp's lanes read consecutive
    words); with rows (3-D) the pitch in ``[nc, nc + 32)`` for which
    ``fits(ncp)`` holds whose output points, 32 a warp over the tile's rows
    and columns, fall on the fewest words in one bank (None when none
    fits)."""
    if ty == 1:
        return nc if fits is None or fits(nc) else None
    best = None
    for ncp in range(nc, nc + 32):
        if fits is not None and not fits(ncp):
            continue
        worst = 0
        for q0 in range(0, ty * tc, 32):
            words = {((q // tc) * m * ncp + q % tc) * itemsize // 4
                     for q in range(q0, min(q0 + 32, ty * tc))}
            banks: dict[int, int] = {}
            for w in words:
                banks[w % 32] = banks.get(w % 32, 0) + 1
            worst = max(worst, max(banks.values()))
        if best is None or worst < best[0]:
            best = (worst, ncp)
    return best[1] if best else None


def _far_reach(ndim: int, r: int) -> tuple[int, int]:
    """``(rz, ry)``: the reach along the stream axis (axis 0 of a 2-D or 3-D
    stencil; none in 1-D) and the 3-D mid axis."""
    return (r if ndim >= 2 else 0), (r if ndim == 3 else 0)


def far_depth(ndim: int, m: int, r: int, ntaps: int, itemsize: int = 4) -> int:
    """The deepest launch of ``csrc/sweep_far.cu`` for a stencil of rank
    ``ndim``, reach ``r`` and ``ntaps`` taps at ``m``: at most
    ``FAR_DEPTH[ndim]``, and as deep as a tile of one row and one column
    fits ``FAR_SMEM``.  Raises, naming the limit, when depth 1 does not."""
    rz, ry = _far_reach(ndim, r)
    hc = -(-r // m)
    for depth in range(FAR_DEPTH[ndim], 0, -1):
        smem = far_smem(m, rz, ry, r, depth, 1, 1, 1 + 2 * depth * hc, ntaps, itemsize)
        if smem <= FAR_SMEM:
            return depth
    raise ValueError(f"a {ndim}-D stencil of reach {r} and {ntaps} taps at m={m}: one step of "
                     f"the far-reach kernel needs {smem} bytes of shared memory at its "
                     f"smallest tile (one row, one column), above the {FAR_SMEM} a CTA may take")


@functools.lru_cache(maxsize=None)
def far_launches(ndim: int, m: int, depth: int, r: int, ntaps: int,
                 itemsize: int = 4) -> tuple[tuple[int, int, int], ...]:
    """The launches ``(m, 1, D)`` of ``csrc/sweep_far.cu`` for a
    depth-``depth`` sweep: launches of :func:`far_depth` and the rest.
    Each launch defines the ends at every step, so the chain is bit for bit
    one deeper launch.  Depth 0 is one launch that copies."""
    deepest = far_depth(ndim, m, r, ntaps, itemsize)
    plan, left = [], depth
    while left > 0:
        plan.append((m, 1, min(deepest, left)))
        left -= plan[-1][2]
    return tuple(plan) or ((m, 1, 0),)


def far_tile(ndim: int, nat: tuple[int, int, int], m: int, r: int, depth: int, ntaps: int,
             itemsize: int) -> tuple[int, int, int, int]:
    """``(ty, tc, ncp, smem)``: the output tile of one CTA of
    ``csrc/sweep_far.cu`` (rows ``ty``, columns ``tc`` of ``m`` points; no
    larger than the grid), its planes' column pitch and its shared memory
    for a depth-``depth`` launch on the (nz, ny, nx) grid ``nat``: from
    ``FAR_TILE[ndim]``, the columns (or, when narrower in points, the rows)
    halve until the CTA, at the best pitch that fits, takes
    ``FAR_SMEM_AIM`` (a tile whose points fill a warp's lanes, with a bank
    conflict, beat a narrower one without: 3-D reach 5, PERF.md section
    6).  Raises, naming the limit, when one row and one column exceed
    ``FAR_SMEM``."""
    _, ny, nx = nat
    rz, ry = _far_reach(ndim, r)
    hc = -(-r // m)
    ty, tc = FAR_TILE[ndim]
    ty, tc = min(ty, ny), min(tc, nx // m)

    def size(ty, tc):
        def smem(ncp):
            return far_smem(m, rz, ry, r, depth, ty, tc, ncp, ntaps, itemsize)
        nc = tc + 2 * depth * hc
        ncp = far_pitch(ty, tc, nc, m, itemsize, lambda p: smem(p) <= FAR_SMEM_AIM)
        if ncp is None:
            ncp = far_pitch(ty, tc, nc, m, itemsize)
        return ncp, smem(ncp)
    ncp, smem = size(ty, tc)
    while smem > FAR_SMEM_AIM and (ty > 1 or tc > 1):
        if tc > 1 and (tc * m >= ty or ty == 1):
            tc //= 2
        else:
            ty //= 2
        ncp, smem = size(ty, tc)
    if smem > FAR_SMEM:
        raise ValueError(f"a depth-{depth} launch of the far-reach kernel (reach {r}, {ntaps} "
                         f"taps, m={m}) needs {smem} bytes of shared memory at its smallest "
                         f"tile, above the {FAR_SMEM} a CTA may take")
    return ty, tc, ncp, smem


@functools.lru_cache(maxsize=None)
def far_segment(nz: int, tiles: int, smem: int, depth: int, rz: int, sms: int,
                batch: int = 1) -> int:
    """Axis-0 positions a CTA of ``csrc/sweep_far.cu`` stores: the segment
    whose waves of resident CTAs (``sms`` SMs, as many an SM as the shared
    memory and 2048 threads allow) over one grid times the steps of a
    segment (its positions and the ``2·depth·rz + depth`` steps it starts
    early and ends late) are fewest, with ``batch`` times the segments at
    most ``MAX_BATCH`` (the grids of a batch share blockIdx.z).  One
    grid's segment, not one sized for the batch: 8 grids of the reach-5
    star at 8192² took 5.537 ms at its 125 rows and 5.556 ms at the 1024 of
    a batch-sized one (H100, tools/batch_segments.py, PERF.md section 6).
    1 without a stream axis."""
    if rz == 0:
        return 1
    resident = sms * max(1, min(2048 // FAR_THREADS, FAR_SMEM_SM // (smem + 1024)))
    warm = 2 * depth * rz + max(depth, 1)
    best = None
    for nseg in range(1, max(1, min(nz, MAX_BATCH // batch)) + 1):
        seg = -(-nz // nseg)
        cost = -(-tiles * -(-nz // seg) // resident) * (seg + warm)
        if best is None or cost < best[0]:
            best = (cost, seg)
    return best[1]


@functools.lru_cache(maxsize=256)
def _far_taps(taps, ndim: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """``csrc/sweep_far.cu``'s taps in device memory: an int32 quadruple a
    tap, (axis-0 offset along the stream axis, mid, minor, the coefficient
    rounded to ``dtype`` as that dtype's bits)."""
    rows = []
    for off, c in taps:
        oz, oy, ox = ((0, 0, off[0]) if ndim == 1 else (off[0], 0, off[1]) if ndim == 2
                      else tuple(off))
        bits = torch.tensor([coeff(c, dtype)], dtype=dtype).view(
            torch.int32 if dtype == torch.float32 else torch.int16).item()
        rows.append((oz, oy, ox, bits & 0xFFFF if dtype != torch.float32 else bits))
    return torch.tensor(rows, dtype=torch.int32, device=device)


def _far_launch(spec: StencilSpec, t: torch.Tensor, out: torch.Tensor, depth: int,
                edge: str = "periodic", seg: int | None = None) -> None:
    """One depth-``depth`` launch of ``csrc/sweep_far.cu`` (at most
    :func:`far_depth`) with the ends ``edge`` on axis 0, on every grid of a
    batch, ``seg`` axis-0 positions per CTA (by default
    :func:`far_segment` over the card's SMs and the batch)."""
    _kernel_io(t, out, "the far-reach sweep kernel")
    nb, m, vl = t.shape[-3:]
    nd, r = spec.ndim, spec.r
    batch = batch_of(spec, t)
    lead = tuple(t.shape[t.ndim - nd - 2:-3])
    nx = nb * m * vl
    nz, ny = (1, 1) if nd == 1 else (lead[0], 1) if nd == 2 else lead
    rz, ry = _far_reach(nd, r)
    ty, tc, ncp, smem = far_tile(nd, (nz, ny, nx), m, r, depth, len(spec.taps), t.element_size())
    tiles = -(-(nb * vl) // tc) * -(-ny // ty)
    if seg is None:
        seg = far_segment(nz, tiles, smem, depth, rz, _sm_count(t.device), batch)
    if -(-ny // ty) > 65535 or batch * -(-nz // seg) > MAX_BATCH or nb * vl >= 2**31:
        raise ValueError(f"{spec.name}: {batch} grid(s) {(nz, ny, nx)} at vl={vl}, m={m} need "
                         f"more than 65535 tiles on a leading axis, more than {MAX_BATCH} "
                         "grids times axis-0 segments, or 2^31 columns")
    taps = _far_taps(spec.taps, nd, t.dtype, t.device)
    build.check(_entry("sweep_far", "sweep_far", t.dtype)(
        t.data_ptr(), out.data_ptr(), batch, nz, ny, nx, vl, m, rz, ry, r, depth, ty, tc, ncp,
        seg, _EDGES[edge], int(nd == 1), len(spec.taps), taps.data_ptr(), _stream()),
        f"{spec.name} far-reach sweep kernel")


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


def sweep1d_route(vl: int, m: int, depth: int, r: int, ntaps: int) -> str:
    """The kernel a CUDA :func:`stencil1d_sweep_ttile` or
    :func:`stencil1d_multistep` (``depth = k``) launches for a stencil of
    reach ``r`` and ``ntaps`` taps: ``"warp"`` (``csrc/sweep1d_warp.cu``,
    at any ``vl``, ``m`` and depth: a warp row is 32 sub-columns of ``M``
    points, one per lane, :func:`sub_columns`; a lane's halo comes from the
    lanes up to ``ceil(r / M)`` away, and the launches are those
    :func:`sweep1d_launches` names) when the reach and the taps are the
    kernel's (``r <= WARP_MAX_R``, ``ntaps <= WARP_MAX_TAPS``); else
    ``"far"`` (``csrc/sweep_far.cu``, the launches of :func:`far_launches`),
    which no registry stencil takes.  The periodic, ring and open ends take
    the same route at every column count."""
    if vl >= 1 and m >= 1 and depth >= 0 and 1 <= r <= WARP_MAX_R and ntaps <= WARP_MAX_TAPS:
        return "warp"
    return "far"


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
    nb, m, vl = t.shape[-3:]
    big, g = sub_columns(m)
    if g != 1 and nb * vl * g >= MAX_COLS:
        raise ValueError(f"{spec.name}: {nb * vl * g} columns at vl={vl}, m={m} (sub-columns "
                         f"of {big}); the warp kernel takes fewer than {MAX_COLS} off m in "
                         f"{SUB_M}")
    ntaps, offs, coeffs = _taps(spec, 1, t.dtype)
    build.check(_entry("sweep1d_warp", "sweep1d_warp", t.dtype)(
        t.data_ptr(), out.data_ptr(), batch_of(spec, t), nb, m, vl, spec.r, WARP_BLOCKS[big],
        depth, _EDGES[edge], ntaps,
        ctypes.cast(offs, ctypes.c_void_p), ctypes.cast(coeffs, ctypes.c_void_p), _stream()),
        f"{spec.name} warp sweep kernel")


def stencil1d_sweep_ttile(spec: StencilSpec, t: torch.Tensor, k: int,
                          ttile: int = 1, out: torch.Tensor | None = None
                          ) -> torch.Tensor:
    """``ttile`` fully periodic k-step sweeps (``depth = ttile·k`` steps) of
    the layout-resident (nb, m, vl) array, on the kernel
    :func:`sweep1d_route` names: the warp kernel's launches of
    :func:`sweep1d_launches` (one unless the sweep is deeper than
    ``32·M // r``), or the far-reach kernel's of :func:`far_launches`."""
    _check_layout(spec, t)
    if spec.ndim != 1:
        raise ValueError(f"{spec.name} is not a 1-D stencil")
    if t.device.type == "cpu":
        return _into(out, stencil1d_sweep_ttile_ref(spec, t, k, ttile), "stencil1d_sweep_ttile")
    _check_cuda(t, "stencil1d_sweep_ttile")
    dst = _out(out, t.shape, t, "stencil1d_sweep_ttile")
    _launches(spec, t, dst, sweep_depth(k, ttile), "periodic")
    return dst


def sweep2d_depths(r: int) -> dict[int, tuple[int, ...]]:
    """The depths of ``csrc/sweep2d_warp.cu``'s instances of reach ``r`` by
    ``M``, all of them on the route."""
    return {mm: tuple(range(1, WARP2D_DEPTH[mm, r] + 1)) + WARP2D_DEEP.get((mm, r), ())
            for mm in SUB_M}


# every instance's depth·r fits its halo warps: depth·r <= 32·M
assert all(d * r <= WARP_LANES * mm for r in range(1, WARP2D_MAX_R + 1)
           for mm, ds in sweep2d_depths(r).items() for d in ds)


def sweep2d_route(vl: int, m: int, depth: int, r: int, ntaps: int) -> str:
    """The kernel a CUDA :func:`stencil_nd_sweep_ttile` or
    :func:`stencil_nd_multistep` (``depth = k``) launches for a 2-D
    stencil of reach ``r`` and ``ntaps`` taps: ``"warp"``
    (``csrc/sweep2d_warp.cu``, at any ``vl``, ``m`` and ``depth``: a warp
    covers 32 sub-columns of ``M`` points of a row, one per lane, a lane's x
    halo from the lanes up to ``ceil(r / M)`` away, on the instances
    :func:`sweep2d_launches` names) when the reach and the taps are the
    kernel's (``r <= WARP2D_MAX_R``, ``ntaps <= ND_MAX_TAPS``); else
    ``"far"`` (``csrc/sweep_far.cu``), which no registry stencil takes."""
    if vl >= 1 and m >= 1 and depth >= 1 and 1 <= r <= WARP2D_MAX_R and ntaps <= ND_MAX_TAPS:
        return "warp"
    return "far"


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
    one grid (``WARP2D_WARPS - 2`` of the ``wrows`` warp rows of a row
    each), and no segment shorter than ``WARP2D_SEG_MIN`` rows, whose
    2·depth·r warm-up rows are read twice.  A batch of B grids launches B
    times these CTAs, B whole waves: 8 grids of 2d5p 8192² at depth 4 took
    2.101 ms at one grid's 249 rows (1056 CTAs) and 3.303 ms at the 1639
    rows of about ``ctas`` CTAs over the batch (160 CTAs, a wave and a
    fifth; H100, tools/batch_segments.py, PERF.md section 6)."""
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
    n0, nb, m, vl = t.shape[-4:]
    batch = batch_of(spec, t)
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
        t.data_ptr(), out.data_ptr(), batch, n0, nb, m, vl, spec.r, depth, _EDGES[edge], seg_rows,
        ntaps, ctypes.cast(offs, ctypes.c_void_p), ctypes.cast(coeffs, ctypes.c_void_p), _stream()),
        f"{spec.name} 2-D warp sweep kernel")


def sweep3d_route(vl: int, m: int, depth: int, r: int, ntaps: int) -> str:
    """The kernel a CUDA :func:`stencil_nd_sweep_ttile` or
    :func:`stencil_nd_multistep` (``depth = k``) launches for a 3-D
    stencil of reach ``r`` and ``ntaps`` taps: ``"stream"``
    (``csrc/sweep3d.cu``, at any ``vl``, ``m`` and ``depth``: a thread owns
    a sub-column of the layout, on the instances :func:`sweep3d_launches`
    names) when the reach and the taps are the kernel's (``r <=
    SWEEP3D_MAX_R``, ``ntaps <= ND_MAX_TAPS``); else ``"far"``
    (``csrc/sweep_far.cu``), which no registry stencil takes.  The
    periodic, ring and open ends take the same route."""
    if vl >= 1 and m >= 1 and depth >= 1 and 1 <= r <= SWEEP3D_MAX_R and ntaps <= ND_MAX_TAPS:
        return "stream"
    return "far"


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
                    ctas: int, r: int, batch: int = 1) -> int:
    """Axis-0 planes per CTA of the 3-D kernel's instance ``M = m`` of
    reach ``r`` on rows of ``cols`` (sub-)columns (``C' = g·nb·vl``): the
    segment length whose waves of ``ctas`` CTAs (one per SM) over the
    ``batch`` grids times the steps of a segment (its planes and (2r +
    1)·depth warm-up steps) are fewest; no segment shorter than
    ``SWEEP3D_SEG_MIN`` planes unless the grid is.  Counting the batch
    won: 8 grids of 3d7p 512³ at depth 4 took 7.491 ms at its 171 planes
    and 7.806 ms at one grid's 103 (H100, tools/batch_segments.py, PERF.md
    section 6)."""
    ty, _, _, hy = sweep3d_tile(m, depth, order, r)
    tiles = batch * -(-cols // SWEEP3D_LANES) * -(-n1 // (ty - 2 * hy))
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
    card's SMs and the batch), on the instance :func:`sub_columns` names for ``m``."""
    n0, n1, nb, m, vl = t.shape[-5:]
    batch = batch_of(spec, t)
    big, g = sub_columns(m)
    any_form = vl != WARP_LANES or g != 1 or spec.r != 1 or t.dtype != torch.float32
    if any_form and nb * vl * g >= MAX_COLS:
        raise ValueError(f"{spec.name}: {nb * vl * g} columns a row at vl={vl}, m={m} "
                         f"(sub-columns of {big}); the 3-D streaming kernel takes fewer than "
                         f"{MAX_COLS} off float32 at vl={WARP_LANES}, m in {SUB_M}, r = 1")
    _kernel_io(t, out, "the 3-D streaming sweep kernel")
    if seg is None:
        seg = sweep3d_segment(n0, n1, nb * vl * g, big, depth, sweep3d_order(spec),
                              _sm_count(t.device), spec.r, batch)
    ntaps, offs, coeffs = _taps(spec, 3, t.dtype)
    build.check(_entry("sweep3d", "sweep3d", t.dtype)(
        t.data_ptr(), out.data_ptr(), batch, n0, n1, nb, m, vl, spec.r, depth, _EDGES[edge], seg,
        ntaps, ctypes.cast(offs, ctypes.c_void_p), ctypes.cast(coeffs, ctypes.c_void_p),
        _stream()), f"{spec.name} 3-D streaming sweep kernel")


def stencil_nd_sweep_ttile(spec: StencilSpec, t: torch.Tensor, k: int,
                           ttile: int, t0: int, out: torch.Tensor | None = None
                           ) -> torch.Tensor:
    """``ttile`` fully periodic k-step sweeps of the layout-resident
    (n0, *mid, nb, m, vl) array; ``t0`` shapes only the reference's
    pipeline (it must divide n0 and reach the radius, as the reference
    asserts).  The sweep runs as the launches of the kernel
    :func:`sweep2d_route` or :func:`sweep3d_route` names
    (:func:`sweep2d_launches` / :func:`sweep3d_launches` /
    :func:`far_launches`), each picking its own tile and segment length:
    results never depend on the tile or the split."""
    _check_layout(spec, t)
    if spec.ndim not in (2, 3):
        raise ValueError(f"{spec.name} is not a 2-D or 3-D stencil")
    n0 = t.shape[-spec.ndim - 2]
    if t0 < spec.r or n0 % t0:
        raise ValueError(f"{spec.name}: axis-0 tile t0={t0} must divide n0={n0} "
                         f"and be at least r={spec.r}")
    if t.device.type == "cpu":
        return _into(out, stencil_nd_sweep_ttile_ref(spec, t, k, ttile, t0),
                     "stencil_nd_sweep_ttile")
    _check_cuda(t, "stencil_nd_sweep_ttile")
    dst = _out(out, t.shape, t, "stencil_nd_sweep_ttile")
    _launches(spec, t, dst, sweep_depth(k, ttile), "periodic")
    return dst


def sweep_plan(spec: StencilSpec, vl: int, m: int, depth: int, itemsize: int = 4
               ) -> tuple[str, tuple[tuple[int, int, int], ...]]:
    """``(key, launches)`` of a depth-``depth`` sweep of ``spec`` at the
    tile ``(vl, m)`` on elements of ``itemsize`` bytes: the kernel its
    route takes (``"1d"`` / ``"2d"`` / ``"3d"``, the register kernels of
    :func:`sweep1d_route` / :func:`sweep2d_route` / :func:`sweep3d_route`,
    or ``"far"``, the far-reach kernel; the suffix of its ``LAUNCHES``
    counters) and its consecutive launches ``(M, g, D)``
    (:func:`sweep1d_launches` / :func:`sweep2d_launches` /
    :func:`sweep3d_launches` / :func:`far_launches`).  The one place the
    wrappers, the tuner's gate and the roofline read a route from; raises,
    naming the limit, where no far-reach launch fits."""
    r, ntaps = spec.r, len(spec.taps)
    if spec.ndim == 1 and sweep1d_route(vl, m, depth, r, ntaps) == "warp":
        return "1d", sweep1d_launches(m, depth, r)
    if spec.ndim == 2 and sweep2d_route(vl, m, depth, r, ntaps) == "warp":
        return "2d", sweep2d_launches(m, depth, r)
    if spec.ndim == 3 and sweep3d_route(vl, m, depth, r, ntaps) == "stream":
        return "3d", sweep3d_launches(m, depth, r)
    return "far", far_launches(spec.ndim, m, depth, r, ntaps, itemsize)


def _launches(spec: StencilSpec, t: torch.Tensor, dst: torch.Tensor, depth: int,
              edge: str) -> None:
    """A depth-``depth`` sweep with the ends ``edge`` on axis 0
    (``periodic``: K1 / K3; ``ring`` / ``open``: K4a / K4b) on the kernel
    and launches :func:`sweep_plan` names, one after another, each
    counted."""
    # checked before the chain: its launches read and write other buffers
    _kernel_io(t, dst, "the sweep kernels")
    kind = "sweep" if edge == "periodic" else "multistep"
    _, m, vl = t.shape[-3:]
    key, plan = sweep_plan(spec, vl, m, depth, t.element_size())
    kernel = {"1d": _warp_launch, "2d": _warp2d_launch, "3d": _sweep3d_launch,
              "far": _far_launch}[key]

    def launch(src, out, d):
        kernel(spec, src, out, d, edge)
        LAUNCHES[f"{kind}_{key}"] += 1
    _chain(launch, t, dst, plan)


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
    """True on the r cells nearest each end of axis 0, in layout (of one
    grid; it broadcasts over a batch)."""
    r = spec.r
    if spec.ndim == 1:
        nb, m, vl = t.shape[-3:]
        g = (torch.arange(nb, device=t.device)[:, None, None] * (vl * m)
             + torch.arange(vl, device=t.device)[None, None, :] * m
             + torch.arange(m, device=t.device)[None, :, None])     # natural index
        n = nb * vl * m
    else:
        n = t.shape[-spec.ndim - 2]
        g = torch.arange(n, device=t.device).reshape((n,) + (1,) * (spec.ndim + 1))
    return (g < r) | (g >= n - r)


def _open_step(spec: StencilSpec, t: torch.Tensor) -> torch.Tensor:
    """One layout step with zeros outside axis 0: a zero block (1-D) or r
    zero rows (n-D) on each side, a periodic step, the domain cut out (axis
    0 counted from the end: a leading batch stays as it is)."""
    width = 1 if spec.ndim == 1 else spec.r
    axis = t.ndim - spec.ndim - 2
    shape = list(t.shape)
    shape[axis] = width
    z = t.new_zeros(shape)
    ext = step_in_layout(spec, torch.cat([z, t, z], dim=axis), ndim=spec.ndim)
    return ext.narrow(axis, width, t.shape[axis])


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
    launches of :func:`sweep1d_launches` on the warp kernel or of
    :func:`far_launches`: each defines the ends at every step, so a chain
    equals one deeper launch."""
    _check_layout(spec, t)
    if spec.ndim != 1:
        raise ValueError(f"{spec.name} is not a 1-D stencil")
    if t.device.type == "cpu":
        return _into(out, stencil1d_multistep_ref(spec, t, k, edge_mask), "stencil1d_multistep")
    _check_cuda(t, "stencil1d_multistep")
    dst = _out(out, t.shape, t, "stencil1d_multistep")
    _launches(spec, t, dst, k, "ring" if edge_mask else "open")
    return dst


def stencil_nd_multistep(spec: StencilSpec, t: torch.Tensor, k: int, t0: int,
                         edge_mask: bool = True, out: torch.Tensor | None = None
                         ) -> torch.Tensor:
    """k steps of the (n0, *mid, nb, m, vl) layout array: axis 0 has the
    Dirichlet ring (``edge_mask=True``, its r first and last
    rows keep their value) or open edges (``edge_mask=False``, rows beyond
    either end hold 0), every other axis is periodic.  ``t0`` shapes only
    the reference's pipeline; it must divide n0 and reach the radius, as the
    reference asserts.  The sweep (depth k) runs as the launches of the
    kernel :func:`sweep2d_route` or :func:`sweep3d_route` names, each
    picking its own tile and segment length: results never depend on the
    tile or the split."""
    _check_layout(spec, t)
    if spec.ndim not in (2, 3):
        raise ValueError(f"{spec.name} is not a 2-D or 3-D stencil")
    n0 = t.shape[-spec.ndim - 2]
    if t0 < spec.r or n0 % t0:
        raise ValueError(f"{spec.name}: axis-0 tile t0={t0} must divide n0={n0} "
                         f"and be at least r={spec.r}")
    if t.device.type == "cpu":
        return _into(out, stencil_nd_multistep_ref(spec, t, k, t0, edge_mask),
                     "stencil_nd_multistep")
    _check_cuda(t, "stencil_nd_multistep")
    dst = _out(out, t.shape, t, "stencil_nd_multistep")
    _launches(spec, t, dst, k, "ring" if edge_mask else "open")
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


# csrc/onestep.cu's register forms: a thread's runs of points in registers
# with a window of 4, 8 or ONESTEP_REACH points a side (every |offset|
# within it; kMaxR), a tap a switch on its offset, the taps as kernel
# arguments (kMaxTaps), at any m and vl; K5a's lane form (a vector of 32
# points across a warp, a tap a shuffle: every |offset| up to
# ONESTEP_NAIVE_REACH, kLaneR) past the windows, and past the narrow one
# at up to ONESTEP_LANE_TAPS taps (kLaneTaps; bfloat16: past the middle
# one); past them a form that reads its taps from device memory, one thread
# an element
ONESTEP_MAX_TAPS = 64
ONESTEP_REACH = 16
ONESTEP_NAIVE_REACH = 32
ONESTEP_LANE_TAPS = 7


def onestep_form(kind: str, spec: StencilSpec, dtype: torch.dtype) -> str:
    """The form of ``csrc/onestep.cu`` a CUDA K5a (``kind`` "naive") or
    K5b ("transpose") launches for ``spec`` on ``dtype`` elements:
    ``"reg"`` (taps as kernel arguments, a run of points and its halo in
    registers) within the register windows' taps and reach, K5a's
    ``"lane"`` (taps as kernel arguments, a tap a shuffle) past them up to
    its reach and past the narrow window (bfloat16: the middle one) at a
    few taps, else ``"mem"`` (taps in device memory, any tap count and
    reach)."""
    if len(spec.taps) > ONESTEP_MAX_TAPS:
        return "mem"
    if kind == "naive":
        reach = max(abs(off[-1]) for off, _ in spec.taps)     # the kernel's own
        # 4, 8: the narrow and the middle window
        lane = len(spec.taps) <= ONESTEP_LANE_TAPS and not (dtype == torch.bfloat16 and reach <= 8)
        if reach <= 4 or (reach <= ONESTEP_REACH and not lane):
            return "reg"
        return "lane" if reach <= ONESTEP_NAIVE_REACH else "mem"
    return "reg" if spec.r <= ONESTEP_REACH else "mem"


@functools.lru_cache(maxsize=256)
def _onestep_taps(taps, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """The "mem" forms' taps in device memory: an int32 pair a tap (offset,
    the coefficient rounded to ``dtype`` as float32 bits)."""
    rows = [(off[-1], torch.tensor([coeff(c, dtype)], dtype=torch.float32).view(torch.int32)
             .item()) for off, c in taps]
    return torch.tensor(rows, dtype=torch.int32, device=device)


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
    if onestep_form("naive", spec, x.dtype) != "mem":
        ntaps, offs, coeffs = _taps(spec, 1, x.dtype)
        build.check(_entry("onestep", "onestep_naive", x.dtype)(
            x.data_ptr(), dst.data_ptr(), x.shape[0], ntaps, ctypes.cast(offs, ctypes.c_void_p),
            ctypes.cast(coeffs, ctypes.c_void_p), _stream()), f"{spec.name} naive one-step kernel")
    else:
        build.check(_entry("onestep", "onestep_naive_mem", x.dtype)(
            x.data_ptr(), dst.data_ptr(), x.shape[0], len(spec.taps),
            _onestep_taps(spec.taps, x.dtype, x.device).data_ptr(), _stream()),
            f"{spec.name} naive one-step kernel")
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
    nb, m, vl = t.shape
    if onestep_form("transpose", spec, t.dtype) == "reg":
        ntaps, offs, coeffs = _taps(spec, 1, t.dtype)
        build.check(_entry("onestep", "onestep_transpose", t.dtype)(
            t.data_ptr(), dst.data_ptr(), nb, m, vl, spec.r, ntaps,
            ctypes.cast(offs, ctypes.c_void_p), ctypes.cast(coeffs, ctypes.c_void_p), _stream()),
            f"{spec.name} transpose one-step kernel")
    else:
        build.check(_entry("onestep", "onestep_transpose_mem", t.dtype)(
            t.data_ptr(), dst.data_ptr(), nb, m, vl, len(spec.taps),
            _onestep_taps(spec.taps, t.dtype, t.device).data_ptr(), _stream()),
            f"{spec.name} transpose one-step kernel")
    LAUNCHES["onestep_transpose"] += 1
    return dst


# ---------------------------------------------------------------------------
# mxu: a depth-d sweep as one product against the banded operator A^d
# ---------------------------------------------------------------------------

def _mxu(spec: StencilSpec, t: torch.Tensor, depth: int, lead_halo=None,
         block_halo: int = 0) -> torch.Tensor:
    """One product; a leading batch of grids is more rows of it."""
    if t.ndim not in (spec.ndim + 2, spec.ndim + 3):
        raise ValueError(f"{spec.name}: expected a ([B,] {spec.ndim - 1} lead, nb, m, vl) "
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
