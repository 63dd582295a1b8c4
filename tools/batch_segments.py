#!/usr/bin/env python3
"""Time a batched sweep launch at the axis-0 segment sized for one grid and
at the one sized for the batch, on one CUDA card.

    python3 tools/batch_segments.py [--batch 8] [--rounds 3]

A batch of grids is a grid dimension of every sweep kernel, so a launch
over B grids has B times the CTAs of one.  ``grid`` is the segment the
wrappers' segment functions (``stencil_kernels.sweep2d_segment``,
``sweep3d_segment``, ``far_segment``) give one grid; ``batch`` the one
they give when their CTA count is spread over the B grids (2-D: a B-th of
the SMs; 3-D: ``batch=B``; far: B times the tiles).  ``default`` names the
one the wrapper launches.  For each case
(2d5p 8192² and 256² on the 2-D warp kernel, 3d7p 512³ on the 3-D
streaming kernel, the reach-5 stars at 8192² and 512³ on the far-reach
kernel; float32, the resident plan's depth on that kernel), both launches
are held bit for bit against each other, then timed with CUDA events
(``timing.bench``) in turns grid, batch, batch, grid, ``--rounds`` times,
beside B launches of one grid each.  Prints one JSON line per case and the
card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "src"))


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("batch_segments: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.core import stencils
    from repro_torch.core.timing import bench
    from repro_torch.kernels import stencil_kernels as sk

    parser = argparse.ArgumentParser()
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--rounds", type=int, default=3)
    args = parser.parse_args()
    dev = torch.device("cuda")
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    sms = sk._sm_count(dev)

    def star(ndim, r):
        return stencils.StencilSpec(f"star{ndim}d-r{r}", ndim, r, "star",
                                    stencils._star_taps(ndim, r))

    cases = [(stencils.make("2d5p"), (8192, 8192), 4), (stencils.make("2d5p"), (256, 256), 4),
             (stencils.make("3d7p"), (512, 512, 512), 4), (star(2, 5), (8192, 8192), 1),
             (star(3, 5), (512, 512, 512), 1)]
    B = args.batch
    for spec, shape, depth in cases:
        vl, m = 32, 8
        key = sk.sweep_plan(spec, vl, m, depth)[0]
        gen = torch.Generator(device=dev).manual_seed(0)
        t = sk.block_transpose(torch.randn((B,) + shape, generator=gen, device=dev), vl, m)
        nb = t.shape[-3]
        if key == "2d":
            launch = sk._warp2d_launch
            wrows = sk.warp_rows(nb * vl)
            segs = {1: sk.sweep2d_segment(shape[0], wrows, sms),
                    B: sk.sweep2d_segment(shape[0], wrows, -(-sms // B))}
            default = 1
        elif key == "3d":
            launch = sk._sweep3d_launch
            segs = {b: sk.sweep3d_segment(shape[0], shape[1], nb * vl, m, depth,
                                          sk.sweep3d_order(spec), sms, spec.r, b)
                    for b in (1, B)}
            default = B
        else:
            launch = sk._far_launch
            nd = spec.ndim
            nat = (shape[0], shape[1] if nd == 3 else 1, shape[-1])
            ty, tc, _, smem = sk.far_tile(nd, nat, m, spec.r, depth, len(spec.taps), 4)
            tiles = -(-(nb * vl) // tc) * -(-nat[1] // ty)
            rz = sk._far_reach(nd, spec.r)[0]
            segs = {1: sk.far_segment(shape[0], tiles, smem, depth, rz, sms, B),
                    B: sk.far_segment(shape[0], tiles * B, smem, depth, rz, sms, B)}
            default = 1
        outs = {}
        for b, seg in segs.items():
            outs[b] = torch.empty_like(t)
            launch(spec, t, outs[b], depth, "periodic", seg)
        if not torch.equal(outs[1], outs[B]):
            raise AssertionError(f"{spec.name} {shape}: the segments disagree")
        single_t = t[0].contiguous()
        single_out = torch.empty_like(single_t)
        times = {1: [], B: [], "singles": []}
        for _ in range(args.rounds):
            for b in (1, B, B, 1):
                times[b].append(bench(lambda: launch(spec, t, outs[b], depth, "periodic", segs[b]),
                                      device=dev, warmup=1, iters=3, min_time_s=0.05) * 1e3)
            times["singles"].append(B * bench(lambda: launch(spec, single_t, single_out, depth),
                                              device=dev, warmup=1, iters=3,
                                              min_time_s=0.05) * 1e3)
        print(json.dumps({
            "case": spec.name, "shape": list(shape), "batch": B, "kernel": key, "depth": depth,
            "seg_grid": segs[1], "seg_batch": segs[B],
            "default": "grid" if default == 1 else "batch",
            "ms_seg_grid": float(np.median(times[1])), "ms_seg_batch": float(np.median(times[B])),
            "ms_seg_grid_all": times[1], "ms_seg_batch_all": times[B],
            "ms_b_single_launches": float(np.median(times["singles"])),
            "bound_ms": 2 * t.numel() * 4 / 3.35e12 * 1e3}), flush=True)
        del t, outs
        torch.cuda.empty_cache()
    print(gpu, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
