#!/usr/bin/env python3
"""Count what one warp-wide copy or store of ``csrc/sweep3d.cu`` touches in
device memory, by vl: the distinct 128-byte lines and 32-byte sectors of a
warp's 32 addresses (thread t of a CTA: sub-column t % Cx of tile row
t // Cx; at m = g·M, M the instance's elements a sub-column, sub-column
u = g·c + h's element s at ((c // vl)·m + h·M + s)·vl + c % vl of its row;
g = 1 at m in {1, 2, 4, 8}).  No card is needed: this is the kernel's
address map, worked out in numpy.

    python3 tools/sweep3d_lines.py [--m 8] [--depth 4] [--nx 512] [--n1 512]

A copy (one ``cp.async`` per thread and element) counts every thread of a
CTA; a store counts the threads that store.  Each line is the mean over the
warps and elements of the CTAs of one plane, for a grid of ``--n1`` rows of
``--nx`` natural points (nb·vl = nx / m columns, g times as many
sub-columns; 3d7p at 512³ by default).  ``sector use`` is the share of
the bytes of the sectors a whole CTA's copies (or stores) of one element
touch that the CTA itself moves: below 1 where a CTA's columns fill part of
a sector whose rest another CTA reads.  Prints one JSON line per vl.
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
    parser.add_argument("--nx", type=int, default=512, help="natural points a row")
    parser.add_argument("--n1", type=int, default=512)
    parser.add_argument("--vl", default="4,8,16,32,64,128")
    args = parser.parse_args()
    m, n1 = args.m, args.n1
    big, g = sk.sub_columns(m)
    ty, cx, hx, hy = sk.sweep3d_tile(big, args.depth, "star", 1)
    threads = ty * cx
    t = np.arange(threads)
    row, col = t // cx, t % cx
    for vl in (int(v) for v in args.vl.split(",")):
        if args.nx % (vl * m):
            continue
        cols = args.nx // m                  # nb·vl columns, g·cols sub-columns
        subs = cols * g
        ntx, nty = -(-subs // sk.SWEEP3D_LANES), -(-n1 // (ty - 2 * hy))
        per = {"copy": ([], []), "store": ([], [])}
        use = {"copy": [], "store": []}
        for xt in range(ntx):
            for yt in range(nty):
                gu = xt * sk.SWEEP3D_LANES - hx + col
                yu = yt * (ty - 2 * hy) - hy + row
                u, y = gu % subs, yu % n1
                c, h = u // g, u % g
                stores = (col >= hx) & (col < cx - hx) & (gu < subs) & (row >= hy) & \
                    (row < ty - hy) & (yu < n1)
                base = y * (cols * m) + c // vl * (vl * m) + h * big * vl + c % vl
                for s in range(big):
                    addr = 4 * (base + s * vl)                      # bytes
                    for kind, live in (("copy", np.ones(threads, bool)), ("store", stores)):
                        if live.any():
                            sectors = len(np.unique(addr[live] // 32))
                            use[kind].append(4 * live.sum() / (32 * sectors))
                    for w in range(0, threads, 32):
                        for kind, live in (("copy", np.ones(32, bool)),
                                           ("store", stores[w:w + 32])):
                            a = addr[w:w + 32][live[:len(addr[w:w + 32])]]
                            if a.size:
                                per[kind][0].append(len(np.unique(a // 128)))
                                per[kind][1].append(len(np.unique(a // 32)))
        print(json.dumps({"vl": vl, "m": m, "instance_m": big, "sub_columns": g,
                          "depth": args.depth, "cols": cols,
                          "tile": {"ty": ty, "cx": cx},
                          **{f"{kind} lines / sectors a warp": [float(np.mean(v[0])),
                                                               float(np.mean(v[1]))]
                             for kind, v in per.items()},
                          **{f"{kind} sector use a CTA": float(np.mean(v))
                             for kind, v in use.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
