#!/usr/bin/env python3
"""Time the 1-D, 2-D and 3-D paths' kernels and K6 of one source tree of
the port, to hold two trees against each other on one CUDA card.

    python3 tools/kernel_ab.py [--src DIR] [--label NAME]
                               [--only stencils|3d|deep|k2|k6|odd5|reach2|reach5|onestep]
                               [--vl 32[,8,...]] [--m 8[,16,...]] [--tiles 8:16[,16:3,...]]

``--src`` is the ``src`` directory of the tree to time (by default this
checkout's); its kernels are built from that tree's ``csrc``.  Run it once
per tree and in turns (A, B, B, A) within one call: two calls may land on
two cards.  Float32, each kernel timed with CUDA events (median of
repeats after warm-up), each result first held bit for bit against the
plain version.  The stencil rows run at every layout tile (vl, m) of
``--vl`` and ``--m`` (comma-separated lists, 32 and 8 by default), or the
(vl, m) pairs of ``--tiles`` (``vl:m``, comma-separated) in their place,
whose vl·m divides the grid's minor extent; each row names its tile:

- 1d3p: K1 (``stencil1d_sweep_ttile``, depths 4, 2, 1) on 2**26 elements,
  K2 (``block_transpose`` / ``block_untranspose``) on the same grid, and
  K4a (``stencil1d_multistep``, open and ring, depths 2 and 1) on the
  the roundtrip's padded shape (whole blocks of vl·m elements covering
  k·r = 2 on each side: 2**26 + 512 at vl·m = 256);
- 2d5p: K3 (``stencil_nd_sweep_ttile``, depths 4, 2, 1) on 8192², and
  K4b (``stencil_nd_multistep``, open and ring, depths 2 and 1) on
  8256 × 8192, the roundtrip's padded shape, both at the axis-0 tile
  t0 = 32.

A tile whose vl·m does not divide 8192 but does divide 6144 (an odd m,
such as the picker's m = 3) takes the odd-m grids instead: 1d3p on
3·2**24 elements and 2d5p on 8192 × 6144 (``--vl 8,16 --m 3``).

Then the Dirichlet run ``ops.stencil_run(spec, x, 16, k=2)`` of 1d3p on
2**26 elements and of 2d5p on 8192² at the picker's tile (K2, K4 in ring
mode, K2 per sweep), each held bit for bit against its plain
composition, by the median host time of 5 runs after that check's run.

3-D (3d7p): K3 (``stencil_nd_sweep_ttile``, depths 4, 2, 1, t0 = 16) on
512³, K4b (``stencil_nd_multistep``, open and ring, depths 2 and 1) on
544 × 512², the roundtrip's padded shape, and the resident run
``StencilProblem.run`` of 512³, 16 steps (k=2, ttile=2, fused), held
against the plain versions and timed by the median host time of 5 runs,
at each tile; 3d27p (the box order): K3 at depths 4, 2, 1 on 256³ at
each tile; then the Dirichlet run ``ops.stencil_run`` of 512³, 16 steps,
at the picker's tile, as above.

K2 alone (``--only k2``): ``block_transpose`` / ``block_untranspose`` on
2**26 elements (3·2**24 where vl·m does not divide 2**26: vl=96, m=12,
24) and on 512³ at every tile, as in the 1-D group.

The deep plans (``--only deep``), at each tile: K3 at depths 8 and 16 on
2d5p 8192² and 3d7p 512³; on their padded shapes (8256 × 8192, 544 ×
512²) K3 and K4b (open and ring) at depths 4 and 8, so that K4b is timed
beside K3 on the same grid; and the resident run of 16 steps at the
depth-4 plan (k=2, ttile=2) and the reference tuner's deep plans (k=4,
ttile=2 and 4: one sweep chunk of depth 8 or 16), each held against the
plain versions, then timed with CUDA events in turns (one run of each
plan a turn, 9 turns; the median and every turn's time).  A tree whose
route raises at a depth prints the error in place of a time.

1d5p at odd m and the deepest 1-D sweep (``--only odd5``; the tiles
options do not apply): K1 (depths 4, 2, 1) on 3·2**24 elements at vl=8,
m=3 and on 5·10**7 at vl=32, m=5 (the picker's tile there: sub-columns
of 1, r = 2 > M = 1), K4a (open and ring, depths 2 and 1) on the latter's
padded shape (5·10**7 + 320), 1d3p K1 at depth 34 on 2**26 at vl=8, m=1
(past 32·M), and the 1d5p 5·10**7 resident run ``StencilProblem.run`` of
16 steps (k=2, ttile=2, fused, the picker's tile), each held bit for bit
against the plain versions and timed with CUDA events.

Reach 2 at 2-D and 3-D (``--only reach2``; the tiles options do not
apply): the star of reach 2 (``_star_taps(ndim, 2)``) at vl=8, m=8: K3 at
depths 4, 2, 1 on 8192² and 2, 1 on 512³ (the former ``K3-smem`` rows),
in float32 and (the first depth) bfloat16; K4b (open and ring, depths 2
and 1) on the padded shapes 8256 × 8192 and 544 × 512²; K3 at the first
and last of those depths on the same taps in reverse order (``rev``: no
order a kernel compiles in, so the register kernels read them at run
time); K3 on 512³ at depth 8 and, for the stars of reach 3 and 4, depth 4
(a tree whose route raises there prints the error); and the resident
fused-16 run
``ops.stencil_sweep_periodic`` (k=2, ttile=2) of both grids at the
picker's tile, each held bit for bit against the plain versions and timed
with CUDA events.

Reach 5 (``--only reach5``; the tiles options do not apply): the star of
reach 5 (``_star_taps(ndim, 5)``) at vl=8, m=8 on the kernel its route
takes (``sweep_far.cu`` since it exists, ``stencil_sweep.cu`` before):
K1 on 2**26 and K3 on 8192² at depths 4, 2, 1, K3 on 512³ at depths 1,
2, 4 (a tree whose route raises there prints the error), bfloat16 at the
first depth; then, on a tree that has the far-reach kernel, that kernel
called directly at other depths a launch (1-D depth 16 as 16, 8 + 8 and
4 × 4 launches; 2-D and 3-D take one step a launch), at other tiles,
and on the stars of reach 3 and 4 at 512³, depths 4, 2, 1,
beside the route they take (``sweep3d.cu``'s run-time taps), with the
plain version's time and the library's (``conv3d``, circular padding, one
a step) on those rows, each held bit for bit against the plain versions
and timed with CUDA events.

The one-step kernels (``--only onestep``; the tiles options do not
apply): K5a (``stencil1d_naive_onestep``, vl=32) and K5b
(``stencil1d_transpose_onestep``, vl=32) on 2**26 elements, float32 and
bfloat16: 1d3p and 1d5p at m=8, the star of reach 6 (13 taps) at m=8, 20
taps of reach 10 at m=16, K5b of 1d3p at the odd m=3 on 3·2**24, two
probes that part reach from tap count (3 taps of reach 5; 13 taps of reach
1) at m=8, K5a's lane form against its windows (5 and 7 taps of reach 5 at
m=8, 3 taps of reach 12 at m=16), 3 taps of reach 20 at m=32 and of reach
40 at m=64, and K5b of
1d3p at m=6 on 3·2**24 and m=7 on 7·2**23, each held bit for bit against
the plain version and timed with CUDA events, with the library's time
(``conv1d``, circular padding) on each row.

K6: ``ssd_chunk_scan(..., return_state=True)`` at mamba2-2.7b's layer shape
(H=80, P=64, N=128, B and C with a head stride of 0 unless per head) in
the five cases of ``chip_smoke.py``'s ``ssd_kernel`` phase (2048 tokens at
Q=128 bf16 and f32, 1000 at Q=125, 251 at Q=1, 2048 with B and C per
head), each first held against the plain version (rtol = atol = 2e-4
f32, 5e-2 bf16; the state at 2e-4), timed with CUDA events; then one
2048-token ``model.prefill`` of mamba2-2.7b (random bf16 weights from seed
0), CUDA events, median of 3.  ``--only`` picks one group; without it the
stencil, 3-D and K6 groups run.
Prints one JSON line per row, then the card's name and power limit.

``chip_smoke.py`` times the same kernels, but only on the tree it belongs
to: it asserts this tree's route functions and counter keys
(``transpose_route``, ``multistep_far``, ``multistep_2d``), which an
older tree lacks.  This script calls nothing but the entry points both
trees share, so it can time a parent tree beside its child.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N1, N2 = 1 << 26, 8192    # the 1-D extent and the 2-D side


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--src", default=os.path.join(ROOT, "src"))
    parser.add_argument("--label", default="this tree")
    parser.add_argument("--only", choices=("stencils", "3d", "deep", "k2", "k6", "odd5",
                                           "reach2", "reach5", "onestep"), default=None)
    parser.add_argument("--vl", default="32",
                        help="comma-separated vl of the stencil rows' tiles")
    parser.add_argument("--m", default="8", help="comma-separated m of the stencil rows' tiles")
    parser.add_argument("--tiles", default=None,
                        help="comma-separated vl:m pairs, in place of --vl and --m")
    args = parser.parse_args()
    sys.path.insert(0, os.path.abspath(args.src))
    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    tiles = [(int(v), int(m)) for v in args.vl.split(",") for m in args.m.split(",")] \
        if args.tiles is None else [tuple(map(int, p.split(":"))) for p in args.tiles.split(",")]
    if args.only in (None, "stencils"):
        stencil_rows(args.label, dev, tiles)
    if args.only in (None, "3d"):
        stencil3d_rows(args.label, dev, tiles)
    if args.only == "k2":
        k2_rows(args.label, dev, tiles)
    if args.only == "deep":
        deep_rows(args.label, dev, tiles)
    if args.only == "odd5":
        odd5_rows(args.label, dev)
    if args.only == "reach2":
        reach2_rows(args.label, dev)
    if args.only == "reach5":
        reach5_rows(args.label, dev)
    if args.only == "onestep":
        onestep_rows(args.label, dev)
    if args.only in (None, "k6"):
        k6_rows(args.label, dev)
    print(gpu)
    return 0


def _skip(label, what, tile) -> None:
    print(json.dumps({"tree": label, "skipped": f"{what} {tile}: vl·m does not divide the "
                      "minor extent"}), flush=True)


def k2_rows(label: str, dev, tiles) -> None:
    """K2 both ways on 2**26 elements and on 512³ at each (vl, m)."""
    import torch

    from repro_torch.kernels import stencil_kernels as sk

    gen = torch.Generator(device=dev).manual_seed(0)
    for shape, what in (((N1,), "2^26"), ((N1 // 4 * 3,), "3*2^24"), ((512, 512, 512), "512^3")):
        x = torch.randn(shape, generator=gen, device=dev)
        for vl, m in tiles:
            tile = f"vl={vl} m={m}"
            if shape[-1] % (vl * m) or (what == "3*2^24" and N1 % (vl * m) == 0):
                if what != "3*2^24":
                    _skip(label, what, tile)
                continue
            t = sk.block_transpose_ref(x, vl, m)
            buf_t, buf_x = torch.empty_like(t), torch.empty_like(x)
            _row(label, dev, f"K2 block_transpose {what} {tile}",
                 lambda: sk.block_transpose(x, vl, m, out=buf_t),
                 lambda: sk.block_transpose_ref(x, vl, m))
            _row(label, dev, f"K2 block_untranspose {what} {tile}",
                 lambda: sk.block_untranspose(t, vl, m, out=buf_x),
                 lambda: sk.block_untranspose_ref(t, vl, m))
            del t, buf_t, buf_x
        del x
        torch.cuda.empty_cache()


def stencil_rows(label: str, dev, tiles) -> None:
    import torch

    from repro_torch.core import stencils
    from repro_torch.kernels import stencil_kernels as sk

    spec, spec2, t0 = stencils.make("1d3p"), stencils.make("2d5p"), 32
    gen = torch.Generator(device=dev).manual_seed(0)
    for vl, m in tiles:
        # the 1-D extent and the 2-D minor extent: 2**26 and 8192, or the
        # odd-m grids' 3·2**24 and 6144
        n1, nx = (N1, N2) if N2 % (vl * m) == 0 else (N1 // 4 * 3, N2 // 4 * 3)
        tile = f"vl={vl} m={m}" + ("" if n1 == N1 else f" (1-D {n1}, 2-D {N2}x{nx})")
        if nx % (vl * m):
            _skip(label, "1d3p, 2d5p", tile)
            continue

        def row(kernel, fn, plain):
            _row(label, dev, f"{kernel} {tile}", fn, plain)

        x = torch.randn(n1, generator=gen, device=dev)
        t = sk.block_transpose_ref(x, vl, m)
        buf_t, buf_x = torch.empty_like(t), torch.empty_like(x)
        row("K2 block_transpose", lambda: sk.block_transpose(x, vl, m, out=buf_t),
            lambda: sk.block_transpose_ref(x, vl, m))
        row("K2 block_untranspose", lambda: sk.block_untranspose(t, vl, m, out=buf_x),
            lambda: sk.block_untranspose_ref(t, vl, m))
        for depth in (4, 2, 1):
            k, tt = (2, depth // 2) if depth > 2 else (depth, 1)
            row(f"K1 depth={depth}", lambda: sk.stencil1d_sweep_ttile(spec, t, k, tt, out=buf_t),
                lambda: sk.stencil1d_sweep_ttile_ref(spec, t, k, tt))
        del x, t, buf_t, buf_x
        pad = sk.sweep_halo_blocks(spec.r, 2, vl * m) * vl * m
        tp = sk.block_transpose_ref(
            torch.randn(n1 + 2 * pad, generator=gen, device=dev), vl, m)
        buf = torch.empty_like(tp)
        for edge_mask in (False, True):
            for depth in (2, 1):
                row(f"K4a {'ring' if edge_mask else 'open'} depth={depth}",
                    lambda: sk.stencil1d_multistep(spec, tp, depth, edge_mask, out=buf),
                    lambda: sk.stencil1d_multistep_ref(spec, tp, depth, edge_mask))
        del tp, buf

        t = sk.block_transpose_ref(torch.randn(N2, nx, generator=gen, device=dev), vl, m)
        buf = torch.empty_like(t)
        for depth in (4, 2, 1):
            k, tt = (2, depth // 2) if depth > 2 else (depth, 1)
            row(f"K3 2d5p depth={depth}",
                lambda: sk.stencil_nd_sweep_ttile(spec2, t, k, tt, t0, out=buf),
                lambda: sk.stencil_nd_sweep_ttile_ref(spec2, t, k, tt, t0))
        del t, buf
        tp = sk.block_transpose_ref(torch.randn(N2 + 2 * t0, nx, generator=gen, device=dev),
                                    vl, m)
        buf = torch.empty_like(tp)
        for edge_mask in (False, True):
            for depth in (2, 1):
                row(f"K4b 2d5p {'ring' if edge_mask else 'open'} depth={depth}",
                    lambda: sk.stencil_nd_multistep(spec2, tp, depth, t0, edge_mask, out=buf),
                    lambda: sk.stencil_nd_multistep_ref(spec2, tp, depth, t0, edge_mask))
        del tp, buf
        torch.cuda.empty_cache()

    for spec, shape in ((spec, (N1,)), (spec2, (N2, N2))):
        dirichlet_row(label, spec, torch.randn(shape, generator=gen, device=dev))


def odd5_rows(label: str, dev) -> None:
    """1d5p K1 and K4a at odd m (r > M), 1d3p K1 past 32·M, and the 1d5p
    resident run at 5·10**7 points (the group's docstring above)."""
    import torch

    from repro_torch.core import stencils
    from repro_torch.core.api import StencilPlan, StencilProblem
    from repro_torch.kernels import stencil_kernels as sk

    spec, spec3 = stencils.make("1d5p"), stencils.make("1d3p")
    gen = torch.Generator(device=dev).manual_seed(0)
    for sp, n, (vl, m), depths in ((spec, N1 // 4 * 3, (8, 3), (4, 2, 1)),
                                   (spec, 50_000_000, (32, 5), (4, 2, 1)),
                                   (spec3, N1, (8, 1), (34,))):
        t = sk.block_transpose_ref(torch.randn(n, generator=gen, device=dev), vl, m)
        buf = torch.empty_like(t)
        for depth in depths:
            k, tt = (2, depth // 2) if depth > 2 else (depth, 1)
            _row(label, dev, f"K1 {sp.name} {n} vl={vl} m={m} depth={depth}",
                 lambda: sk.stencil1d_sweep_ttile(sp, t, k, tt, out=buf),
                 lambda: sk.stencil1d_sweep_ttile_ref(sp, t, k, tt))
        del t, buf
    n, (vl, m) = 50_000_000, (32, 5)
    pad = sk.sweep_halo_blocks(spec.r, 2, vl * m) * vl * m
    tp = sk.block_transpose_ref(torch.randn(n + 2 * pad, generator=gen, device=dev), vl, m)
    buf = torch.empty_like(tp)
    for edge_mask in (False, True):
        for depth in (2, 1):
            _row(label, dev, f"K4a 1d5p {n + 2 * pad} vl={vl} m={m} "
                 f"{'ring' if edge_mask else 'open'} depth={depth}",
                 lambda: sk.stencil1d_multistep(spec, tp, depth, edge_mask, out=buf),
                 lambda: sk.stencil1d_multistep_ref(spec, tp, depth, edge_mask))
    del tp, buf
    prob = StencilProblem("1d5p", (n,))
    x = prob.init(0)
    plan = StencilPlan(backend="pallas", sweep="resident", k=2, ttile=2, remainder="fused")

    def plain():
        t = sk.block_transpose_ref(x, vl, m)
        for _ in range(4):
            t = sk.stencil1d_sweep_ttile_ref(spec, t, 2, 2)
        return sk.block_untranspose_ref(t, vl, m)
    _row(label, dev, f"resident run 1d5p {n} 16 steps (k=2, ttile=2, fused; vl={vl} m={m})",
         lambda: prob.run(x, 16, plan), plain)
    torch.cuda.empty_cache()


def reach2_rows(label: str, dev) -> None:
    """The stars of reach 2 (and 3, 4) at 2-D and 3-D (the group's
    docstring above)."""
    import torch

    from repro_torch.core import stencils
    from repro_torch.kernels import ops
    from repro_torch.kernels import stencil_kernels as sk

    def star(ndim, r):
        return stencils.StencilSpec(f"star{ndim}d-r{r}", ndim, r, "star",
                                    stencils._star_taps(ndim, r))

    gen = torch.Generator(device=dev).manual_seed(0)
    vl, m = 8, 8
    for ndim, shape, t0, depths in ((2, (N2, N2), 32, (4, 2, 1)),
                                    (3, (512, 512, 512), 16, (2, 1))):
        spec = star(ndim, 2)
        what = "x".join(map(str, shape))
        x = torch.randn(shape, generator=gen, device=dev)
        rev = stencils.StencilSpec(f"{spec.name} rev", ndim, 2, "star", spec.taps[::-1])
        for sp, dtype, ds in ((spec, torch.float32, depths), (spec, torch.bfloat16, depths[:1]),
                              (rev, torch.float32, (depths[0], depths[-1]))):
            t = sk.block_transpose_ref(x.to(dtype), vl, m)
            buf = torch.empty_like(t)
            for depth in ds:
                k, tt = (2, depth // 2) if depth > 2 else (depth, 1)
                _row(label, dev, f"K3 {sp.name} {what} {str(dtype)[6:]} vl={vl} m={m} "
                     f"depth={depth}",
                     lambda: sk.stencil_nd_sweep_ttile(sp, t, k, tt, t0, out=buf),
                     lambda: sk.stencil_nd_sweep_ttile_ref(sp, t, k, tt, t0))
            del t, buf
        xp = torch.randn((shape[0] + 2 * t0,) + shape[1:], generator=gen, device=dev)
        tp = sk.block_transpose_ref(xp, vl, m)
        buf = torch.empty_like(tp)
        for edge_mask in (False, True):
            for depth in (2, 1):
                kname = (f"K4b {spec.name} {'x'.join(map(str, xp.shape))} vl={vl} m={m} "
                         f"{'ring' if edge_mask else 'open'} depth={depth}")
                _row(label, dev, kname,
                     lambda: sk.stencil_nd_multistep(spec, tp, depth, t0, edge_mask, out=buf),
                     lambda: sk.stencil_nd_multistep_ref(spec, tp, depth, t0, edge_mask))
        del xp, tp, buf
        if ndim == 3:
            t = sk.block_transpose_ref(x, vl, m)
            buf = torch.empty_like(t)
            for r, depth in ((2, 8), (3, 4), (4, 4)):
                sp = star(3, r)
                kname = f"K3 {sp.name} {what} vl={vl} m={m} depth={depth}"
                _or_raises(label, kname, lambda: _row(
                    label, dev, kname,
                    lambda: sk.stencil_nd_sweep_ttile(sp, t, depth, 1, t0, out=buf),
                    lambda: sk.stencil_nd_sweep_ttile_ref(sp, t, depth, 1, t0)))
            del t, buf
        tvl, tm, tt0 = ops.pick_tile(spec, shape)

        def plain():
            t = sk.block_transpose_ref(x, tvl, tm)
            for _ in range(4):
                t = sk.stencil_nd_sweep_ttile_ref(spec, t, 2, 2, tt0)
            return sk.block_untranspose_ref(t, tvl, tm)
        _row(label, dev, f"resident run {spec.name} {what} 16 steps (k=2, ttile=2, fused; "
             f"vl={tvl} m={tm})", lambda: ops.stencil_sweep_periodic(spec, x, 16, k=2, ttile=2),
             plain)
        del x
        torch.cuda.empty_cache()


def reach5_rows(label: str, dev) -> None:
    """The star of reach 5 at every rank, and the far-reach kernel's depths
    a launch and its rows at reach 3 and 4 (the group's docstring above)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.core import stencils
    from repro_torch.core.timing import bench
    from repro_torch.kernels import stencil_kernels as sk

    def star(ndim, r):
        return stencils.StencilSpec(f"star{ndim}d-r{r}", ndim, r, "star",
                                    stencils._star_taps(ndim, r))

    def sweep(spec, t, depth, t0, out=None):
        if spec.ndim == 1:
            return sk.stencil1d_sweep_ttile(spec, t, depth, 1, out=out)
        return sk.stencil_nd_sweep_ttile(spec, t, depth, 1, t0, out=out)

    def plain(spec, t, depth, t0):
        if spec.ndim == 1:
            return sk.stencil1d_sweep_ttile_ref(spec, t, depth, 1)
        return sk.stencil_nd_sweep_ttile_ref(spec, t, depth, 1, t0)

    far = hasattr(sk, "far_launches")

    def far_chain(spec, t, out, depths):
        """The far-reach kernel's launches of ``depths``, one after another."""
        sk._chain(lambda s, o, d: sk._far_launch(spec, s, o, d), t, out,
                  tuple((t.shape[-2], 1, d) for d in depths))
        return out

    gen = torch.Generator(device=dev).manual_seed(0)
    vl, m = 8, 8
    for ndim, shape, t0, depths in ((1, (N1,), None, (4, 2, 1)), (2, (N2, N2), 32, (4, 2, 1)),
                                    (3, (512, 512, 512), 16, (1, 2, 4))):
        spec = star(ndim, 5)
        what = "x".join(map(str, shape))
        x = torch.randn(shape, generator=gen, device=dev)
        for dtype, ds in ((torch.float32, depths), (torch.bfloat16, depths[:1])):
            t = sk.block_transpose_ref(x.to(dtype), vl, m)
            buf = torch.empty_like(t)
            for depth in ds:
                kname = (f"{'K1' if ndim == 1 else 'K3'} {spec.name} {what} {str(dtype)[6:]} "
                         f"vl={vl} m={m} depth={depth}")
                _or_raises(label, kname, lambda: _row(
                    label, dev, kname, lambda: sweep(spec, t, depth, t0, buf),
                    lambda: plain(spec, t, depth, t0)))
            del t, buf
        if far:
            t = sk.block_transpose_ref(x, vl, m)
            buf = torch.empty_like(t)
            if ndim == 1:    # 2-D and 3-D take one step a launch
                want = plain(spec, t, 16, t0)
                for launches in ((16,), (8, 8), (4,) * 4):
                    kname = (f"far {spec.name} {what} vl={vl} m={m} depth=16 as "
                             f"{'+'.join(map(str, launches))}")
                    _row(label, dev, kname, lambda: far_chain(spec, t, buf, launches),
                         lambda: want)
            # the tile's choices: the column (then row) tile it starts from
            # and the shared memory it aims at (FAR_SMEM: one CTA an SM), at
            # the first depth (the tile printed: its launches')
            depth = depths[0]
            want = plain(spec, t, depth, t0)
            saved = (dict(sk.FAR_TILE), sk.FAR_SMEM_AIM)
            variants = {1: [("tile 256", {"tile": (1, 256)}), ("tile 1024", {"tile": (1, 1024)})],
                        2: [("tile 128", {"tile": (1, 128)}), ("tile 512", {"tile": (1, 512)})],
                        3: [("aim one CTA an SM", {"aim": sk.FAR_SMEM}),
                            ("tile 16x4", {"tile": (16, 4)})]}[ndim]
            for vname, var in variants:
                sk.FAR_TILE[ndim] = var.get("tile", saved[0][ndim])
                sk.FAR_SMEM_AIM = var.get("aim", saved[1])
                nat = ((1, 1, shape[0]) if ndim == 1 else (shape[0], 1, shape[1]) if ndim == 2
                       else shape)
                tile = sk.far_tile(ndim, nat, m, 5, sk.far_launches(
                    ndim, m, depth, 5, len(spec.taps))[0][2], len(spec.taps), 4)
                kname = (f"far {spec.name} {what} vl={vl} m={m} depth={depth} {vname} "
                         f"(ty, tc, ncp, smem) = {tile}")
                _row(label, dev, kname, lambda: sweep(spec, t, depth, t0, buf), lambda: want)
                sk.FAR_TILE[ndim], sk.FAR_SMEM_AIM = saved[0][ndim], saved[1]
            del t, buf, want
        del x
        torch.cuda.empty_cache()
    # the stars of reach 3 and 4 at 512³: sweep3d.cu's run-time taps (the
    # route) beside the far-reach kernel, with the plain and library times
    if not far:
        return
    x = torch.randn((512, 512, 512), generator=gen, device=dev)
    t = sk.block_transpose_ref(x, vl, m)
    buf = torch.empty_like(t)
    for r in (3, 4):
        spec = star(3, r)
        weight = torch.tensor(spec.coeff_array(), dtype=x.dtype, device=dev)[None, None]
        for depth in (4, 2, 1):
            kname = f"K3 {spec.name} 512x512x512 vl={vl} m={m} depth={depth}"
            _row(label, dev, kname + " (route)", lambda: sweep(spec, t, depth, 16, buf),
                 lambda: plain(spec, t, depth, 16))
            _row(label, dev, kname + " (far-reach kernel)",
                 lambda: far_chain(spec, t, buf, (1,) * depth),
                 lambda: plain(spec, t, depth, 16))

            def conv():
                v = x[None, None]
                for _ in range(depth):
                    v = F.conv3d(F.pad(v, (r,) * 6, mode="circular"), weight)
                return v
            print(json.dumps({
                "tree": label, "kernel": kname,
                "plain_ms": bench(lambda: plain(spec, t, depth, 16), device=dev, warmup=1,
                                  iters=3, min_time_s=0.0) * 1e3,
                "library_ms": bench(conv, device=dev, warmup=1, iters=3,
                                    min_time_s=0.0) * 1e3}), flush=True)
    del x, t, buf
    torch.cuda.empty_cache()


def onestep_rows(label: str, dev) -> None:
    """K5a and K5b (the group's docstring above)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.core import stencils
    from repro_torch.core.timing import bench
    from repro_torch.kernels import stencil_kernels as sk

    taps20 = stencils.StencilSpec("taps20", 1, 10, "star", tuple(
        ((o,), 1.0 / (20 + abs(o))) for o in range(-10, 11) if o))
    star6 = stencils.StencilSpec("star1d-r6", 1, 6, "star", stencils._star_taps(1, 6))
    # probes that part reach from tap count: 3 taps of reach 5, and 13 taps
    # of reach 1 (the offsets -1, 0, 1 in turn)
    r5t3 = stencils.StencilSpec("r5-3taps", 1, 5, "star", (((-5,), 0.25), ((0,), 0.5),
                                                           ((5,), 0.25)))
    r1t13 = stencils.StencilSpec("r1-13taps", 1, 1, "star", tuple(
        ((t % 3 - 1,), 1.0 / 13) for t in range(13)))
    # K5a's lane form against its windows at reach 5 (5 and 7 taps) and 12 (3 taps)
    r5t5 = stencils.StencilSpec("r5-5taps", 1, 5, "star", tuple(
        ((o,), 0.2) for o in (-5, -1, 0, 1, 5)))
    r5t7 = stencils.StencilSpec("r5-7taps", 1, 5, "star", tuple(
        ((o,), 1.0 / 7) for o in (-5, -2, -1, 0, 1, 2, 5)))
    r12t3 = stencils.StencilSpec("r12-3taps", 1, 12, "star", (((-12,), 0.25), ((0,), 0.5),
                                                             ((12,), 0.25)))
    # past the register windows: 3 taps of reach 20 and of reach 40
    r20t3 = stencils.StencilSpec("r20-3taps", 1, 20, "star", (((-20,), 0.25), ((0,), 0.5),
                                                             ((20,), 0.25)))
    far40 = stencils.StencilSpec("far40", 1, 40, "star", (((0,), 0.5), ((-40,), 0.25),
                                                         ((33,), 0.25)))
    p3 = stencils.make("1d3p")
    cases = ((p3, N1, 8, True), (stencils.make("1d5p"), N1, 8, True),
             (star6, N1, 8, True), (taps20, N1, 16, True),
             (p3, N1 // 4 * 3, 3, False), (r5t3, N1, 8, True),
             (r1t13, N1, 8, True), (r5t5, N1, 8, True), (r5t7, N1, 8, True),
             (r12t3, N1, 16, True), (r20t3, N1, 32, True), (far40, N1, 64, True),
             (p3, N1 // 4 * 3, 6, False), (p3, N1 // 8 * 7, 7, False))
    gen = torch.Generator(device=dev).manual_seed(0)
    vl = 32
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype)[6:]
        for spec, n, m, naive in cases:
            x = torch.randn(n, generator=gen, device=dev).to(dtype)
            if naive:
                out = torch.empty_like(x)
                _row(label, dev, f"K5a {spec.name} {n} {dname} vl={vl}",
                     lambda: sk.stencil1d_naive_onestep(spec, x, vl, out=out),
                     lambda: sk.stencil1d_naive_onestep_ref(spec, x, vl))
                del out
            t = sk.block_transpose_ref(x, vl, m)
            tout = torch.empty_like(t)
            _row(label, dev, f"K5b {spec.name} {n} {dname} vl={vl} m={m}",
                 lambda: sk.stencil1d_transpose_onestep(spec, t, out=tout),
                 lambda: sk.stencil1d_transpose_onestep_ref(spec, t))
            weight = torch.tensor(spec.coeff_array(), dtype=dtype, device=dev)[None, None]
            print(json.dumps({
                "tree": label, "kernel": f"K5 {spec.name} {n} {dname}",
                "library_ms": bench(lambda: F.conv1d(F.pad(x[None, None], (spec.r, spec.r),
                                                           mode="circular"), weight),
                                    device=dev, warmup=2, iters=10, min_time_s=0.1) * 1e3}),
                  flush=True)
            del x, t, tout
        torch.cuda.empty_cache()


def _row(label, dev, kernel, fn, plain):
    """One kernel's time (CUDA events), after holding it bit for bit
    against its plain version."""
    import torch

    from repro_torch.core.timing import bench
    if not torch.equal(fn(), plain()):
        raise AssertionError(f"{label} {kernel}: differs from the plain version")
    ms = bench(fn, device=dev, warmup=2, iters=10, min_time_s=0.1) * 1e3
    print(json.dumps({"tree": label, "kernel": kernel, "ms": ms}), flush=True)


def dirichlet_row(label, spec, x) -> None:
    """``ops.stencil_run(spec, x, 16, k=2)``, held against its plain
    composition, then the median host time of 5 runs."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels import stencil_kernels as sk

    tile = ops.pick_tile(spec, tuple(x.shape))
    want = x
    for _ in range(8):
        t = sk.block_transpose_ref(want, *tile[:2])
        t = sk.stencil1d_multistep_ref(spec, t, 2) if spec.ndim == 1 else \
            sk.stencil_nd_multistep_ref(spec, t, 2, tile[2])
        want = sk.block_untranspose_ref(t, *tile[:2])
    if not torch.equal(ops.stencil_run(spec, x, 16, k=2), want):
        raise AssertionError(f"{label} {spec.name} Dirichlet run: differs from the "
                             "plain version")
    del want, t
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        start = time.perf_counter()
        ops.stencil_run(spec, x, 16, k=2)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - start)
    print(json.dumps({"tree": label, "run": f"{spec.name} Dirichlet 16 steps",
                      "seconds_median_of_5": statistics.median(times)}), flush=True)


def stencil3d_rows(label: str, dev, tiles) -> None:
    import torch

    from repro_torch.core import stencils
    from repro_torch.core.api import StencilPlan, StencilProblem
    from repro_torch.kernels import stencil_kernels as sk

    spec, t0, shape = stencils.make("3d7p"), 16, (512, 512, 512)
    box = stencils.make("3d27p")
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(shape, generator=gen, device=dev)
    xp = torch.randn(544, 512, 512, generator=gen, device=dev)
    xb = torch.randn(256, 256, 256, generator=gen, device=dev)
    for vl, m in tiles:
        tile = f"vl={vl} m={m}"
        if shape[-1] % (vl * m):
            _skip(label, "3d7p 512^3", tile)
            continue
        t = sk.block_transpose_ref(x, vl, m)
        buf = torch.empty_like(t)
        for depth in (4, 2, 1):
            k, tt = (2, depth // 2) if depth > 2 else (depth, 1)
            _row(label, dev, f"K3 3d7p 512^3 depth={depth} {tile}",
                 lambda: sk.stencil_nd_sweep_ttile(spec, t, k, tt, t0, out=buf),
                 lambda: sk.stencil_nd_sweep_ttile_ref(spec, t, k, tt, t0))
        del t, buf
        tp = sk.block_transpose_ref(xp, vl, m)
        buf = torch.empty_like(tp)
        for edge_mask in (False, True):
            for depth in (2, 1):
                _row(label, dev, f"K4b 3d7p 544x512^2 {'ring' if edge_mask else 'open'} "
                     f"depth={depth} {tile}",
                     lambda: sk.stencil_nd_multistep(spec, tp, depth, t0, edge_mask, out=buf),
                     lambda: sk.stencil_nd_multistep_ref(spec, tp, depth, t0, edge_mask))
        del tp, buf
        prob = StencilProblem("3d7p", shape)
        plan = StencilPlan(backend="pallas", sweep="resident", k=2, ttile=2, remainder="fused",
                           vl=vl, m=m)
        want = sk.block_transpose_ref(x, vl, m)
        for _ in range(16):
            want = sk.stencil_nd_sweep_ttile_ref(spec, want, 1, 1, t0)
        if not torch.equal(prob.run(x, 16, plan), sk.block_untranspose_ref(want, vl, m)):
            raise AssertionError(f"{label} 3d7p resident fused 16 {tile}: differs from the "
                                 "plain version")
        del want
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            start = time.perf_counter()
            prob.run(x, 16, plan)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - start)
        print(json.dumps({"tree": label, "run": f"3d7p 512^3 resident fused 16 {tile}",
                          "seconds_median_of_5": statistics.median(times)}), flush=True)
        if xb.shape[-1] % (vl * m) == 0:
            t = sk.block_transpose_ref(xb, vl, m)
            buf = torch.empty_like(t)
            for depth in (4, 2, 1):
                k, tt = (2, depth // 2) if depth > 2 else (depth, 1)
                _row(label, dev, f"K3 3d27p 256^3 depth={depth} {tile}",
                     lambda: sk.stencil_nd_sweep_ttile(box, t, k, tt, t0, out=buf),
                     lambda: sk.stencil_nd_sweep_ttile_ref(box, t, k, tt, t0))
            del t, buf
        torch.cuda.empty_cache()
    del xp, xb
    dirichlet_row(label, spec, x)
    torch.cuda.empty_cache()


def _or_raises(label, what, fn) -> None:
    """``fn()``, or a row with the ValueError the tree raises there."""
    try:
        fn()
    except ValueError as err:
        print(json.dumps({"tree": label, "kernel": what, "raises": str(err)}), flush=True)


def _event_turns(label, what, runs, want, turns=9) -> None:
    """Each of ``runs`` (name → ``run()``) held bit for bit against
    ``want``, then timed with CUDA events in turns: one run of each a turn,
    ``turns`` turns; a row per run with the median and every turn's ms.  A
    run whose route raises prints the error instead."""
    import torch
    ok = {}
    for name, run in runs.items():
        try:
            got = run()
        except ValueError as err:
            print(json.dumps({"tree": label, "run": f"{what} {name}", "raises": str(err)}),
                  flush=True)
            continue
        if not torch.equal(got, want):
            raise AssertionError(f"{label} {what} {name}: differs from the plain version")
        ok[name] = run
    times = {name: [] for name in ok}
    for _ in range(turns):
        for name, run in ok.items():
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            run()
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end))
    for name, ms in times.items():
        print(json.dumps({"tree": label, "run": f"{what} {name}",
                          "ms_events_median": statistics.median(ms), "ms_turns": ms}),
              flush=True)


def deep_rows(label: str, dev, tiles) -> None:
    """K3 at depths 8, 16 (2d5p 8192², 3d7p 512³), K3 and K4b at depths 4
    and 8 on the padded shapes, and the resident runs at k=2, ttile=2 and
    k=4, ttile=2 and 4 in turns."""
    import torch

    from repro_torch.core import stencils
    from repro_torch.core.api import StencilPlan, StencilProblem
    from repro_torch.kernels import stencil_kernels as sk

    gen = torch.Generator(device=dev).manual_seed(0)
    for name, shape, t0 in (("2d5p", (N2, N2), 32), ("3d7p", (512, 512, 512), 16)):
        spec = stencils.make(name)
        what = "x".join(map(str, shape))
        x = torch.randn(shape, generator=gen, device=dev)
        xp = torch.randn((shape[0] + 2 * t0,) + shape[1:], generator=gen, device=dev)
        for vl, m in tiles:
            tile = f"vl={vl} m={m}"
            if shape[-1] % (vl * m):
                _skip(label, f"{name} {what}", tile)
                continue
            t = sk.block_transpose_ref(x, vl, m)
            buf = torch.empty_like(t)
            for depth in (8, 16):
                _or_raises(label, f"K3 {name} {what} depth={depth} {tile}", lambda: _row(
                    label, dev, f"K3 {name} {what} depth={depth} {tile}",
                    lambda: sk.stencil_nd_sweep_ttile(spec, t, 4, depth // 4, t0, out=buf),
                    lambda: sk.stencil_nd_sweep_ttile_ref(spec, t, 4, depth // 4, t0)))
            del t, buf
            tp = sk.block_transpose_ref(xp, vl, m)
            buf = torch.empty_like(tp)
            for depth in (4, 8):
                kname = f"K3 {name} padded periodic depth={depth} {tile}"
                _or_raises(label, kname, lambda: _row(
                    label, dev, kname,
                    lambda: sk.stencil_nd_sweep_ttile(spec, tp, depth, 1, t0, out=buf),
                    lambda: sk.stencil_nd_sweep_ttile_ref(spec, tp, depth, 1, t0)))
                for edge_mask in (False, True):
                    kname = (f"K4b {name} padded {'ring' if edge_mask else 'open'} "
                             f"depth={depth} {tile}")
                    _or_raises(label, kname, lambda: _row(
                        label, dev, kname,
                        lambda: sk.stencil_nd_multistep(spec, tp, depth, t0, edge_mask, out=buf),
                        lambda: sk.stencil_nd_multistep_ref(spec, tp, depth, t0, edge_mask)))
            del tp, buf
            prob = StencilProblem(name, shape)
            want = sk.block_transpose_ref(x, vl, m)
            for _ in range(16):
                want = sk.stencil_nd_sweep_ttile_ref(spec, want, 1, 1, t0)
            want = sk.block_untranspose_ref(want, vl, m)
            plans = {f"k={k} ttile={tt}": StencilPlan(backend="pallas", sweep="resident", k=k,
                                                      ttile=tt, remainder="fused", vl=vl, m=m)
                     for k, tt in ((2, 2), (4, 2), (4, 4))}
            _event_turns(label, f"{name} {what} resident fused 16 {tile}",
                         {key: (lambda plan=plan: prob.run(x, 16, plan))
                          for key, plan in plans.items()}, want)
            del want
            torch.cuda.empty_cache()
        del x, xp
        torch.cuda.empty_cache()


def k6_rows(label: str, dev) -> None:
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.configs.base import get_arch
    from repro_torch.core.timing import bench
    from repro_torch.kernels import ssd_kernel as ssd
    from repro_torch.models import transformer, zoo

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_arch("mamba2-2.7b")
    h, p, n = cfg.ssm_nheads, cfg.ssm_head_dim, cfg.ssm_state
    tol = {torch.float32: 2e-4, torch.bfloat16: 5e-2}
    for case, nc, q, dtype, shared in (("2048 tokens Q=128", 16, 128, torch.bfloat16, True),
                                       ("2048 tokens Q=128", 16, 128, torch.float32, True),
                                       ("1000 tokens Q=125", 8, 125, torch.bfloat16, True),
                                       ("251 tokens Q=1", 251, 1, torch.bfloat16, True),
                                       ("2048 tokens Q=128, B and C per head", 16, 128,
                                        torch.bfloat16, False)):
        g = torch.Generator(device=dev).manual_seed(0)
        hb = 1 if shared else h
        xh = (0.5 * torch.randn(nc, 1, q, h, p, generator=g, device=dev)).to(dtype)
        bm = 0.5 * torch.randn(nc, 1, q, hb, n, generator=g, device=dev)
        cm = 0.5 * torch.randn(nc, 1, q, hb, n, generator=g, device=dev)
        dt = F.softplus(torch.randn(nc, 1, q, h, generator=g, device=dev) - 2.0)
        a = -torch.linspace(1.0, 16.0, h, device=dev)
        if shared:
            bm, cm = bm.expand(nc, 1, q, h, n), cm.expand(nc, 1, q, h, n)
        y, state = ssd.ssd_chunk_scan(xh, bm, cm, dt, a, return_state=True)
        y_ref, state_ref = ssd.ssd_chunk_scan_ref(xh, bm, cm, dt, a, return_state=True)
        for got, want, t in ((y, y_ref, tol[dtype]), (state, state_ref, 2e-4)):
            torch.testing.assert_close(got.float(), want.float(), rtol=t, atol=t)
        ms = bench(lambda: ssd.ssd_chunk_scan(xh, bm, cm, dt, a, return_state=True),
                   device=dev, warmup=2, iters=10, min_time_s=0.1) * 1e3
        print(json.dumps({"tree": label, "kernel": f"K6 {case} {str(dtype)[6:]}",
                          "ms": ms}), flush=True)
        del xh, bm, cm, dt, y, state, y_ref, state_ref
    model = zoo.build(cfg)
    params = transformer.cast_params(model.init(torch.Generator(device=dev).manual_seed(0)))
    tokens = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab, 2048),
                             device=dev)[None]
    ms = bench(lambda: model.prefill(params, {"tokens": tokens}), device=dev, warmup=1,
               iters=3, min_time_s=0.0) * 1e3
    print(json.dumps({"tree": label, "run": "mamba2-2.7b prefill 2048 tokens",
                      "ms_median_of_3": ms}), flush=True)
    del model, params
    torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main())
