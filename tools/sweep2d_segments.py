#!/usr/bin/env python3
"""Time K3's 2-D warp kernel (``csrc/sweep2d_warp.cu``) at several axis-0
segment lengths, on one CUDA card.

    python3 tools/sweep2d_segments.py [--n 8192] [--segs 63,125,249,512]

2d5p on an n × n float32 grid at vl=32, m=8, depths 4, 2 and 1: each launch
is held bit for bit against the plain version once, then timed with CUDA
events (median of repeats after warm-up).  Prints one JSON line per
(segment, depth), with the CTAs the segment gives and the bytes bound, and
the card's name and power limit.  The wrapper's default segment
(``stencil_kernels.sweep2d_segment``) is marked.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "src"))

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory rate (data sheet)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("sweep2d_segments: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.core import layouts, stencils
    from repro_torch.core.timing import bench
    from repro_torch.kernels import stencil_kernels as sk

    parser = argparse.ArgumentParser()
    parser.add_argument("--n", type=int, default=8192)
    parser.add_argument("--segs", default="63,125,249,512,1024")
    args = parser.parse_args()
    dev = torch.device("cuda")
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    spec = stencils.make("2d5p")
    x = torch.randn(args.n, args.n, generator=torch.Generator(device=dev).manual_seed(0),
                    device=dev)
    t = layouts.to_transpose_layout(x, 32, 8)
    out = torch.empty_like(t)
    n0, wrows = t.shape[0], sk.warp_rows(t.shape[1] * t.shape[3])   # m = 8: g = 1
    ncol = -(-wrows // (sk.WARP2D_WARPS - 2))
    default = sk.sweep2d_segment(n0, wrows, sk._sm_count(dev))
    bound_ms = 2 * x.numel() * 4 / HBM_BYTES_PER_S * 1e3
    for seg in sorted({int(s) for s in args.segs.split(",")} | {default}):
        for depth in (4, 2, 1):
            sk._warp2d_launch(spec, t, out, depth, seg_rows=seg)
            if not torch.equal(out, sk.stencil_nd_sweep_ttile_ref(spec, t, depth, 1, 1)):
                raise AssertionError(f"seg={seg} depth={depth}: differs from the plain version")
            ms = bench(lambda: sk._warp2d_launch(spec, t, out, depth, seg_rows=seg), device=dev,
                       warmup=2, iters=10, min_time_s=0.1) * 1e3
            print(json.dumps({"seg": seg, "default": seg == default, "depth": depth,
                              "ctas": ncol * -(-n0 // seg), "ms": ms, "bound_ms": bound_ms}),
                  flush=True)
    print(gpu)
    return 0


if __name__ == "__main__":
    sys.exit(main())
