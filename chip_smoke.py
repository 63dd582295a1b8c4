#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card.

    python3 chip_smoke.py          # from the root of a checkout

Phases, one JSON line each, and any failure ends the script with a non-zero
exit code:

  build      builds the CUDA kernels from ``src/repro_torch/kernels/csrc``
             (one nvcc per source, started together) and reports the time;
  kernels    at the main path's shapes, each kernel (K2 transpose, K1 1-D
             sweep, K3 n-D sweep) against its plain PyTorch version, bit for
             bit, and its time beside the plain version's, a library call's
             and its bound (CUDA events, median of repeats, after warm-up);
  main_path  ``StencilProblem(name, shape).run(x, steps, plan)`` for 1d3p at
             2**26, 2d5p at 8192**2 and 3d7p at 512**3 (f32, ``init(seed)``),
             each under two resident plans: the launch counters must rise by
             exactly the sweep schedule's launches and the result must match
             the port's plain path on the same tensors;
  small      3d7p at (16, 16, 256) on the card and on the CPU against the
             float64 numpy oracle.

Then the ``kernels`` summary line, the card's name and power limit as
``nvidia-smi`` gives them, and the result line
``{"ok": true, "device": {...}}``.  Without a CUDA device it exits 1 and
prints no result.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory rate (data sheet)
FP32_FLOPS_PER_S = 67e12      # H100 SXM float32 outside the tensor cores
SEED = 0
CASES = (("1d3p", (1 << 26,)), ("2d5p", (8192, 8192)), ("3d7p", (512, 512, 512)))
PLANS = (("fused", 16), ("native", 7))     # (remainder, steps), k=2, ttile=2
SOURCES = {
    "transpose": "src/repro_torch/kernels/csrc/transpose.cu",
    "sweep": "src/repro_torch/kernels/csrc/stencil_sweep.cu",
}
REPLACES = {
    "K1": "src/repro/kernels/stencil_kernels.py:114 (_kernel_1d via stencil1d_sweep_ttile)",
    "K2": "src/repro/kernels/stencil_kernels.py:567 (_kernel_transpose via block_transpose/block_untranspose)",
    "K3": "src/repro/kernels/stencil_kernels.py:339 (_kernel_nd via stencil_nd_sweep_ttile)",
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import numpy as np
    import torch.nn.functional as F

    from repro_torch.core import stencils
    from repro_torch.core.api import StencilPlan, StencilProblem, sweep_schedule
    from repro_torch.core.timing import bench
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import stencil_kernels as sk

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gpu = gpu_line()

    # -- build ------------------------------------------------------------
    t0 = time.perf_counter()
    reports = build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "gpu": gpu,
          "dir": str(build.build_dir().relative_to(ROOT)),
          "ptxas": {n: [ln.strip() for ln in r.splitlines() if "Used" in ln]
                    for n, r in reports.items()}})

    def ms(fn, *args):
        return bench(fn, *args, device=dev, warmup=1, iters=5, min_time_s=0.1) * 1e3

    def plain_path(spec, x, steps, remainder, vl, m, t0):
        """The main path on the plain versions only (no kernel launches)."""
        t = sk.block_transpose_ref(x, vl, m)
        for depth, n in sweep_schedule(2, steps, remainder, 2)[0]:
            for _ in range(n):
                if spec.ndim == 1:
                    t = sk.stencil1d_sweep_ttile_ref(spec, t, depth, 1)
                else:
                    t = sk.stencil_nd_sweep_ttile_ref(spec, t, depth, 1, t0)
        return sk.block_untranspose_ref(t, vl, m)

    def conv_steps(spec, x, depth, weight):
        conv = (F.conv1d, F.conv2d, F.conv3d)[spec.ndim - 1]
        v = x[None, None]
        for _ in range(depth):
            v = conv(F.pad(v, (spec.r,) * (2 * spec.ndim), mode="circular"), weight)
        return v[0, 0]

    entries = []
    for name, shape in CASES:
        prob = StencilProblem(name, shape)
        spec = prob.spec
        x = prob.init(SEED)
        vl, m, t0 = ops.pick_tile(spec, shape)
        numel, itemsize = x.numel(), x.element_size()
        grid_bytes = 2 * numel * itemsize

        # -- main path (counted; one short uncounted run loads the kernels) --
        prob.run(x, 2, StencilPlan(backend="pallas", sweep="resident", k=2))
        sk.reset_launches()
        runs = []
        for remainder, steps in PLANS:
            plan = StencilPlan(backend="pallas", sweep="resident", k=2, ttile=2,
                               remainder=remainder)
            torch.cuda.synchronize()
            start = time.perf_counter()
            y = prob.run(x, steps, plan)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - start
            runs.append((remainder, steps, y, seconds))
        launches = dict(sk.LAUNCHES)
        want_sweeps = sum(n for rem, steps in PLANS
                          for _, n in sweep_schedule(2, steps, rem, 2)[0])
        sweep_key = "sweep_1d" if spec.ndim == 1 else "sweep_nd"
        want = {"transpose": 2 * len(PLANS), "sweep_1d": 0, "sweep_nd": 0}
        want[sweep_key] = want_sweeps
        if launches != want:
            raise AssertionError(f"{name}: launches {launches}, schedule says {want}")
        for remainder, steps, y, seconds in runs:
            ref = plain_path(spec, x, steps, remainder, vl, m, t0)
            if y.shape != x.shape or not bool(torch.isfinite(y).all()):
                raise AssertionError(f"{name} {remainder}: bad output")
            err = (y - ref).abs().max().item()
            if not torch.allclose(y, ref, rtol=1e-6, atol=1e-6):
                raise AssertionError(f"{name} {remainder}: max |kernel - plain| = {err}")
            emit({"phase": "main_path", "case": name, "shape": list(shape),
                  "plan": {"k": 2, "ttile": 2, "remainder": remainder}, "steps": steps,
                  "schedule": sweep_schedule(2, steps, remainder, 2)[0],
                  "tile": {"vl": vl, "m": m, "t0": t0}, "seconds": seconds,
                  "gpoint_updates_per_s": numel * steps / seconds,
                  "max_abs_err_vs_plain": err, "bitwise": bool(torch.equal(y, ref))})
            del ref
        del runs, y

        # -- K2: transpose in and out --------------------------------------
        t = sk.block_transpose(x, vl, m)
        back = sk.block_untranspose(t, vl, m)
        err = max((t - sk.block_transpose_ref(x, vl, m)).abs().max().item(),
                  (back - x).abs().max().item())
        if not (torch.equal(t, sk.block_transpose_ref(x, vl, m)) and torch.equal(back, x)):
            raise AssertionError(f"{name}: transpose kernel differs from its plain version")
        buf = torch.empty_like(t)
        nb_total = numel // (vl * m)
        entries.append({
            "name": f"K2 block_transpose [{name} {'x'.join(map(str, shape))} vl={vl} m={m}]",
            "route": "cuda", "source": SOURCES["transpose"], "replaces": REPLACES["K2"],
            "launches": launches["transpose"], "max_abs_err": err,
            "ms": ms(lambda: sk.block_transpose(x, vl, m, out=buf)),
            "plain_ms": ms(lambda: sk.block_transpose_ref(x, vl, m)),
            "bound_ms": bound(grid_bytes, 0)[0], "bound_by": "bytes",
            "library_ms": ms(lambda: x.view(nb_total, vl, m).transpose(-1, -2).contiguous()),
        })
        emit({"phase": "kernels", **entries[-1]})
        del back

        # -- K1 / K3: the sweep at every depth the main path launches -------
        kid = "K1" if spec.ndim == 1 else "K3"
        weight = torch.tensor(spec.coeff_array(), dtype=x.dtype, device=dev)[None, None]
        for depth in (4, 2, 1):
            kk, tt = (2, depth // 2) if depth > 2 else (depth, 1)
            if spec.ndim == 1:
                def kern():
                    return sk.stencil1d_sweep_ttile(spec, t, kk, tt, out=buf)

                def plain():
                    return sk.stencil1d_sweep_ttile_ref(spec, t, kk, tt)
            else:
                def kern():
                    return sk.stencil_nd_sweep_ttile(spec, t, kk, tt, t0, out=buf)

                def plain():
                    return sk.stencil_nd_sweep_ttile_ref(spec, t, kk, tt, t0)
            got, ref = kern(), plain()
            err = (got - ref).abs().max().item()
            if not torch.equal(got, ref):
                raise AssertionError(f"{name} depth {depth}: sweep kernel differs from "
                                     f"its plain version by {err}")
            del ref
            b_ms, b_by = bound(grid_bytes, depth * spec.flops_per_point * numel)
            fname = "stencil1d_sweep_ttile" if spec.ndim == 1 else "stencil_nd_sweep_ttile"
            entries.append({
                "name": f"{kid} {fname} [{name} {'x'.join(map(str, shape))} depth={depth}]",
                "route": "cuda", "source": SOURCES["sweep"], "replaces": REPLACES[kid],
                "launches": launches[sweep_key], "max_abs_err": err,
                "ms": ms(kern), "plain_ms": ms(plain), "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": ms(conv_steps, spec, x, depth, weight),
            })
            emit({"phase": "kernels", **entries[-1]})
        del x, t, buf, got, weight
        torch.cuda.empty_cache()

    # -- small case on the card and on the CPU against the f64 oracle --------
    spec = stencils.make("3d7p")
    shape, steps = (16, 16, 256), 16
    plan = StencilPlan(backend="pallas", sweep="resident", k=2, ttile=2)
    x = StencilProblem("3d7p", shape).init(SEED)
    y_gpu = StencilProblem("3d7p", shape).run(x, steps, plan).cpu()
    y_cpu = StencilProblem("3d7p", shape, device="cpu").run(x.cpu(), steps, plan)
    oracle = x.cpu().double().numpy()
    for _ in range(steps):
        oracle = stencils.numpy_apply_once(spec, oracle)
    errs = {"gpu_vs_f64": float(np.abs(y_gpu.double().numpy() - oracle).max()),
            "cpu_vs_f64": float(np.abs(y_cpu.double().numpy() - oracle).max()),
            "gpu_vs_cpu": float((y_gpu - y_cpu).abs().max())}
    if max(errs.values()) > 1e-5:
        raise AssertionError(f"small 3d7p case off the f64 oracle: {errs}")
    emit({"phase": "small", "case": "3d7p", "shape": list(shape), "steps": steps, **errs})

    emit({"kernels": entries})
    print(gpu, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
