#!/usr/bin/env python3
"""Count the SASS instructions of each ``sweep3d`` instance of a built
``csrc/sweep3d.cu`` library (or of another register kernel's), in all and
by opcode (loads, stores, the FP32 multiplies and adds, integer and address
arithmetic, local memory, shuffles, bfloat16 products and sums, byte
permutes, moves, calls), with ``cuobjdump`` from the CUDA toolkit beside
``nvcc``.

    python3 tools/sweep3d_sass.py [--source NAME] [--lib PATH] [--label NAME]
                                  [--base PATH]

``--source`` is ``sweep3d`` (the default), ``sweep2d_warp``,
``sweep1d_warp``, ``sweep_far`` (instances <edge>, float, and <bf16, edge>),
their bfloat16 sources ``<source>_bf16`` (the kernel
``<source>``, a float instance named by its template arguments without
the element type, as a tree from before the bfloat16 instances named its
``<source>_f32``, so ``--base`` compares the two; a bfloat16 one with
``bf16`` first) or ``transpose`` (K2's ``transpose_reg``, its instances
named <element bytes, M, G, vec, to_layout>).  ``--lib`` is a built
library of that source (by default this checkout's, built if missing).  An
instance is named by its template arguments, for ``sweep3d`` <M, D, R,
order, ends, vl> as in ``chip_smoke.py``'s ``build`` line (a tree older
than the reach argument R has five, one older than the ``vl`` argument
four).  Prints one JSON line per instance.  The loop of a 3-D step is
unrolled over its 2r + 1 phases, so a count is about 2r + 1 steps'
instructions plus the set-up.  ``--base`` is a second library of the
same source (another tree's build): each line then also says whether the
instance's counts by opcode equal the base's, and a last line lists the
instances whose counts differ.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import re
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "src"))

OPCODES = ("LDGSTS", "STG", "LDS", "STS", "LDL", "STL", "SHFL", "FMUL", "FADD", "HMUL2",
           "HADD2", "PRMT", "IMAD", "IADD3", "LEA", "ISETP", "SEL", "MOV", "BRA", "BAR", "CALL")


def sass_counts(lib: str, kernel: str) -> dict:
    """SASS instructions per instance of ``kernel`` in ``lib``, in all and
    by opcode."""
    from repro_torch.kernels import build

    cuobjdump = Path(build.nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", lib], capture_output=True, text=True,
                          check=True).stdout
    counts, fun = {}, None
    for line in sass.splitlines():
        found = re.search(r"Function : (\S+)", line)
        if found:
            name = found.group(1)
            fun = None
            # the kernel's mangled identifier (an older tree's float kernel
            # is <kernel>_f32); the anonymous namespace's name holds the
            # file's name too
            found = re.search(rf"\d+{kernel}(?:_f32)?I", name)
            if found:
                rest = name[found.end() - 1:]
                args = re.findall(r"L[ib](\d+)E", rest)
                typ = re.match(r"I(13__nv_bfloat16|[tjy])", rest)
                if typ:
                    args = [{"t": "2B", "j": "4B", "y": "8B",
                             "13__nv_bfloat16": "bf16"}[typ.group(1)]] + args
                fun = "<" + ", ".join(args) + ">"
                counts[fun] = collections.Counter()
            continue
        ins = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if fun is not None and ins:
            counts[fun]["total"] += 1
            counts[fun][ins.group(1).split(".")[0]] += 1
    return counts


def main() -> int:
    from repro_torch.kernels import build

    parser = argparse.ArgumentParser()
    parser.add_argument("--source", default="sweep3d",
                        choices=("sweep3d", "sweep2d_warp", "sweep1d_warp", "sweep3d_bf16",
                                 "sweep2d_warp_bf16", "sweep1d_warp_bf16", "transpose",
                                 "sweep_far"))
    parser.add_argument("--lib", default=None)
    parser.add_argument("--label", default="this tree")
    parser.add_argument("--base", default=None, help="a library to compare with")
    args = parser.parse_args()
    lib = args.lib
    kernel = "transpose_reg" if args.source == "transpose" else args.source.removesuffix("_bf16")
    if lib is None:
        build.load(args.source)
        lib = str(build.build_dir() / f"{args.source}.so")
    counts = sass_counts(lib, kernel)
    base = sass_counts(args.base, kernel) if args.base else None
    differ = []
    for fun in sorted(counts):
        same = {} if base is None else {"same_as_base": counts[fun] == base.get(fun)}
        if base is not None and not same["same_as_base"]:
            differ.append(fun)
        print(json.dumps({"tree": args.label, "kernel": kernel, "instance": fun,
                          "total": counts[fun]["total"],
                          **{op: counts[fun][op] for op in OPCODES if counts[fun][op]},
                          **same}))
    if base is not None:
        print(json.dumps({"tree": args.label, "kernel": kernel, "instances": len(counts),
                          "base_instances": len(base), "differ_from_base": differ}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
