#!/usr/bin/env python3
"""Count what one warp-wide copy or store of ``csrc/sweep3d.cu`` touches in
device memory, by vl: the distinct 128-byte lines and 32-byte sectors of a
warp's 32 addresses (thread t of a CTA: column t % Cx of tile row t // Cx,
element s of column c at ((c // vl)·m + s)·vl + c % vl of its row).  No
card is needed: this is the kernel's address map, worked out in numpy.

    python3 tools/sweep3d_lines.py [--m 8] [--depth 4] [--cols 64] [--n1 512]

A copy (one ``cp.async`` per thread and element) counts every thread of a
CTA; a store counts the threads that store.  Each line is the mean over the
warps and elements of the CTAs of one plane, for a grid of ``--n1`` rows of
``--cols`` = nb·vl columns (3d7p at 512³ and m=8: 64).  Prints one JSON
line per vl.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "src"))


def main() -> int:
    from repro_torch.kernels import stencil_kernels as sk

    parser = argparse.ArgumentParser()
    parser.add_argument("--m", type=int, default=8)
    parser.add_argument("--depth", type=int, default=4)
    parser.add_argument("--cols", type=int, default=64, help="columns a row, nb·vl")
    parser.add_argument("--n1", type=int, default=512)
    parser.add_argument("--vl", default="4,8,16,32,64,128")
    args = parser.parse_args()
    m, cols, n1 = args.m, args.cols, args.n1
    ty, cx, hx, hy = sk.sweep3d_tile(m, args.depth, "star")
    threads = ty * cx
    t = np.arange(threads)
    row, col = t // cx, t % cx
    ntx, nty = -(-cols // sk.SWEEP3D_LANES), -(-n1 // (ty - 2 * hy))
    for vl in (int(v) for v in args.vl.split(",")):
        if cols % vl:
            continue
        per = {"copy": ([], []), "store": ([], [])}
        for xt in range(ntx):
            for yt in range(nty):
                gu = xt * sk.SWEEP3D_LANES - hx + col
                yu = yt * (ty - 2 * hy) - hy + row
                g, y = gu % cols, yu % n1
                stores = (col >= hx) & (col < cx - hx) & (gu < cols) & (row >= hy) & \
                    (row < ty - hy) & (yu < n1)
                base = y * (cols * m) + g // vl * (vl * m) + g % vl
                for s in range(m):
                    addr = 4 * (base + s * vl)                      # bytes
                    for w in range(0, threads, 32):
                        for kind, live in (("copy", np.ones(32, bool)),
                                           ("store", stores[w:w + 32])):
                            a = addr[w:w + 32][live[:len(addr[w:w + 32])]]
                            if a.size:
                                per[kind][0].append(len(np.unique(a // 128)))
                                per[kind][1].append(len(np.unique(a // 32)))
        print(json.dumps({"vl": vl, "m": m, "depth": args.depth, "cols": cols,
                          "tile": {"ty": ty, "cx": cx},
                          **{f"{kind} lines / sectors a warp": [float(np.mean(v[0])),
                                                               float(np.mean(v[1]))]
                             for kind, v in per.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
