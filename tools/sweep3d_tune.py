#!/usr/bin/env python3
"""Time variants of the 3-D streaming kernel's constants on one CUDA card.

    python3 tools/sweep3d_tune.py [VARIANT ...]

A variant is ``name:const=value,...`` over the constants of
``csrc/sweep3d.cuh`` (the float entry points are ``csrc/sweep3d.cu``) that
shape its schedule: ``kStages`` and ``kStagesD1``
(input planes in flight, and at depth 1), ``kLanes`` (columns a CTA stores
per row) and ``kMaxThreads`` (the cap on a CTA's threads), e.g.
``s4:kStages=4,kStagesD1=4``.  ``base`` (the source as it is) always
runs.  Each variant is the header with those constants replaced, beside
``sweep3d.cu`` including it, built with the port's nvcc flags (and
``csrc/`` for the other headers) into ``build/sweep3d_tune/`` (all
started together); its ptxas report gives
registers and spills per instance.  Then,
for each variant in turn, 3d7p at vl=32, m=8: K3 (periodic) on 512³ at
depths 4, 2, 1 and K4b (ring) on 544 × 512² at depths 2, 1, each first
held bit for bit against the plain version and then timed with CUDA
events (median of repeats after warm-up), at the segment length
``stencil_kernels.sweep3d_segment`` picks for that variant's tile.  Prints
one JSON line per row, then the card's name and power limit.
"""
from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
CONSTS = {"kStages": "SWEEP3D_STAGES", "kStagesD1": "SWEEP3D_STAGES_D1",
          "kLanes": "SWEEP3D_LANES", "kMaxThreads": "SWEEP3D_THREADS"}


def parse(arg: str) -> tuple[str, dict[str, int]]:
    name, _, rest = arg.partition(":")
    consts = {}
    for item in filter(None, rest.split(",")):
        key, value = item.split("=")
        if key not in CONSTS:
            raise SystemExit(f"unknown constant {key!r}; one of {sorted(CONSTS)}")
        consts[key] = int(value)
    return name, consts


def main() -> int:
    import torch

    from repro_torch.core import stencils
    from repro_torch.core.timing import bench
    from repro_torch.kernels import build
    from repro_torch.kernels import stencil_kernels as sk

    if not torch.cuda.is_available():
        print("sweep3d_tune: no CUDA device", file=sys.stderr)
        return 1
    variants = [("base", {})] + [parse(a) for a in sys.argv[1:]]
    src = (build.CSRC / "sweep3d.cuh").read_text()
    entry = (build.CSRC / "sweep3d.cu").read_text()
    out_dir = os.path.join(ROOT, "build", "sweep3d_tune")
    os.makedirs(out_dir, exist_ok=True)
    jobs = {}
    for name, consts in variants:
        text = src
        for key, value in consts.items():
            text, n = re.subn(rf"constexpr int {key} = \d+;", f"constexpr int {key} = {value};",
                              text)
            assert n == 1, key
        with open(os.path.join(out_dir, f"{name}.cuh"), "w") as f:
            f.write(text)
        cu = os.path.join(out_dir, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(entry.replace('#include "sweep3d.cuh"', f'#include "{name}.cuh"'))
        so = os.path.join(out_dir, f"{name}.so")
        jobs[name] = (subprocess.Popen([build.nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
                                        "-o", so, cu],
                                       stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                       text=True), so)
    libs = {}
    for name, (proc, so) in jobs.items():
        out, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{err}{out}")
        lib = ctypes.CDLL(so)
        build._declare("sweep3d", lib)
        libs[name] = lib
        regs = {}
        for fn, used in re.findall(r"Function properties for (\S+)[\s\S]*?Used (\d+) registers",
                                   err + out):
            m = re.search(r"sweep3dIfLi8ELi(\d)ELi1ELb(\d)", fn)
            if m:
                regs[f"<8, {m.group(1)}, star, ends {m.group(2)}>"] = int(used)
        spills = len(re.findall(r"[1-9]\d* bytes spill", err + out))
        print(json.dumps({"variant": name, "consts": dict(variants)[name],
                          "registers_m8_star": regs, "instances_spilling": spills}), flush=True)

    dev = torch.device("cuda")
    spec = stencils.make("3d7p")
    gen = torch.Generator(device=dev).manual_seed(0)
    grids = {512: sk.block_transpose_ref(torch.randn(512, 512, 512, generator=gen, device=dev),
                                         32, 8),
             544: sk.block_transpose_ref(torch.randn(544, 512, 512, generator=gen, device=dev),
                                         32, 8)}
    cases = [("K3 512^3", 512, d, "periodic") for d in (4, 2, 1)] + \
        [("K4b 544x512^2 ring", 544, d, "ring") for d in (2, 1)]
    plain = {}
    for label, n0, depth, edge in cases:
        t = grids[n0]
        plain[label, depth] = sk.stencil_nd_sweep_ttile_ref(spec, t, depth, 1, 1) \
            if edge == "periodic" else sk.stencil_nd_multistep_ref(spec, t, depth, 1, True)
    saved = {v: getattr(sk, v) for v in CONSTS.values()}
    ntaps, offs, coeffs = sk._taps(spec, 3, torch.float32)
    for name, consts in variants:
        for key, value in consts.items():
            setattr(sk, CONSTS[key], value)
        for label, n0, depth, edge in cases:
            t = grids[n0]
            buf = torch.empty_like(t)
            seg = sk.sweep3d_segment(n0, t.shape[1], t.shape[2] * t.shape[4], 8, depth, "star",
                                     sk._sm_count(dev), 1)

            def launch():
                build.check(libs[name].repro_sweep3d_f32(
                    t.data_ptr(), buf.data_ptr(), 1, *t.shape[:3], 8, 32, 1, depth,
                    sk._EDGES[edge], seg, ntaps, ctypes.cast(offs, ctypes.c_void_p),
                    ctypes.cast(coeffs, ctypes.c_void_p), sk._stream()), name)
                return buf
            if not torch.equal(launch(), plain[label, depth]):
                raise AssertionError(f"variant {name} {label} depth {depth}: differs")
            ms = bench(launch, device=dev, warmup=2, iters=10, min_time_s=0.1) * 1e3
            print(json.dumps({"variant": name, "row": f"{label} depth={depth}", "seg": seg,
                              "tile": sk.sweep3d_tile(8, depth, "star", 1), "ms": ms}), flush=True)
        for attr, value in saved.items():
            setattr(sk, attr, value)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
