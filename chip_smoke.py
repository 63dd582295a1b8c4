#!/usr/bin/env python3
"""Drive the PyTorch port's paths on one CUDA card.

    python3 chip_smoke.py          # from the root of a checkout

Phases, one JSON line each, and any failure ends the script with a non-zero
exit code.  Every path is driven with the launch counters set to 0 just
before it and read just after; each path must launch exactly the kernels
its schedule implies (every counter is compared, so a stray launch fails
too).  Cases: 1d3p at 2**26, 2d5p at 8192**2, 3d7p at 512**3 (f32,
``init(seed)``, GPU default tile).

  build      builds the CUDA kernels from ``src/repro_torch/kernels/csrc``
             (one nvcc per source, started together) and reports the time;
  main_path  ``StencilProblem.run(x, steps, plan)`` under two resident plans
             (k=2, ttile=2: fused 16 steps, native 7): K2 in and out, K1/K3
             per sweep; the result equals the port's plain path bit for bit;
  roundtrip  the same two runs under ``sweep="roundtrip"`` (wrap-pad, K2,
             K4, K2, crop per sweep): K4 once and K2 twice per sweep; the
             result equals the resident run at ttile 1 and 2 bit for bit;
  dirichlet  ``ops.stencil_run(spec, x, 16, k=2)`` (K2, K4 with the
             Dirichlet ring, K2 per sweep), bit for bit its plain path;
  onestep    ``ops.stencil_onestep_naive`` / ``stencil_onestep_transpose``
             (K5a; K2, K5b, K2) for 1d3p and 1d5p at 2**26, vl=32, m=8, bit
             for bit the periodic oracle;
  kernels    at those paths' shapes, each kernel against its plain PyTorch
             version, bit for bit, and its time beside the plain version's,
             a library call's and its bound (CUDA events, median of repeats,
             after warm-up);
  small      3d7p at (16, 16, 256) resident, and 2d5p at (64, 256) through
             ``ops.stencil_run``, on the card and on the CPU against the
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
PLANS = (("fused", 16), ("native", 7))     # (remainder, steps), k=2
K = 2
TTILE = 2                                  # the resident plans' temporal tile
DIRICHLET_STEPS = 16
ONESTEP = (("1d3p", 1 << 26), ("1d5p", 1 << 26))   # K5 at vl=32, m=8
SOURCES = {
    "transpose": "src/repro_torch/kernels/csrc/transpose.cu",
    "sweep": "src/repro_torch/kernels/csrc/stencil_sweep.cu",
    "onestep": "src/repro_torch/kernels/csrc/onestep.cu",
}
_SK = "src/repro/kernels/stencil_kernels.py"
REPLACES = {
    "K1": f"{_SK}:114 (_kernel_1d via stencil1d_sweep_ttile)",
    "K2": f"{_SK}:567 (_kernel_transpose via block_transpose/block_untranspose)",
    "K3": f"{_SK}:339 (_kernel_nd via stencil_nd_sweep_ttile)",
    "K4a": f"{_SK}:114 (_kernel_1d via stencil1d_multistep :174, stencil1d_sweep_halo :243)",
    "K4b": f"{_SK}:339 (_kernel_nd via stencil_nd_multistep :398, stencil_nd_sweep_halo :262)",
    "K5a": f"{_SK}:620 (_kernel_naive_1d via stencil1d_naive_onestep :634)",
    "K5b": f"{_SK}:651 (_kernel_transpose_1d via stencil1d_transpose_onestep :669)",
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
    from repro_torch.kernels import ref as kref
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

    def counted(what, fn, owned):
        """Run ``fn`` with every counter at 0 before; the counters after
        must be exactly ``owned`` (all others 0).  Returns (result,
        seconds, counters)."""
        sk.reset_launches()
        torch.cuda.synchronize()
        start = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        got = dict(sk.LAUNCHES)
        want = dict.fromkeys(got, 0) | owned
        if got != want:
            raise AssertionError(f"{what}: launches {got}, the schedule says {want}")
        return out, seconds, got

    def same(what, got, want):
        if got.shape != want.shape or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{what}: bad output")
        err = (got.double() - want.double()).abs().max().item()
        if not torch.equal(got, want):
            raise AssertionError(f"{what}: differs from its reference by {err}")
        return err

    def resident_plain(spec, x, steps, remainder, vl, m, t0):
        """The resident path on the plain versions only (no launches)."""
        t = sk.block_transpose_ref(x, vl, m)
        for depth, n in sweep_schedule(K, steps, remainder, TTILE)[0]:
            for _ in range(n):
                if spec.ndim == 1:
                    t = sk.stencil1d_sweep_ttile_ref(spec, t, depth, 1)
                else:
                    t = sk.stencil_nd_sweep_ttile_ref(spec, t, depth, 1, t0)
        return sk.block_untranspose_ref(t, vl, m)

    def dirichlet_plain(spec, x, steps, vl, m, t0):
        """``ops.stencil_run`` on the plain versions only."""
        for _ in range(steps // K):
            t = sk.block_transpose_ref(x, vl, m)
            if spec.ndim == 1:
                t = sk.stencil1d_multistep_ref(spec, t, K)
            else:
                t = sk.stencil_nd_multistep_ref(spec, t, K, t0)
            x = sk.block_untranspose_ref(t, vl, m)
        return x

    def conv_steps(spec, x, depth, weight, edge=False):
        """``depth`` library convolutions: circular padding on every axis,
        or (``edge``) zeros beyond axis 0 and circular elsewhere."""
        conv = (F.conv1d, F.conv2d, F.conv3d)[spec.ndim - 1]
        v = x[None, None]
        r = spec.r
        for _ in range(depth):
            if edge:
                if spec.ndim > 1:
                    v = F.pad(v, (r,) * (2 * spec.ndim - 2) + (0, 0), mode="circular")
                v = F.pad(v, (0, 0) * (spec.ndim - 1) + (r, r))
            else:
                v = F.pad(v, (r,) * (2 * spec.ndim), mode="circular")
            v = conv(v, weight)
        return v[0, 0]

    entries = []

    def row(kid, fname, label, src, launches, err, kern, plain, b, library):
        entries.append({
            "name": f"{kid} {fname} [{label}]", "route": "cuda", "source": SOURCES[src],
            "replaces": REPLACES[kid], "launches": launches, "max_abs_err": err,
            "ms": ms(kern), "plain_ms": ms(plain), "bound_ms": b[0], "bound_by": b[1],
            "library_ms": library() if library else None,
        })
        emit({"phase": "kernels", **entries[-1]})

    for name, shape in CASES:
        prob = StencilProblem(name, shape)
        spec = prob.spec
        x = prob.init(SEED)
        vl, m, t0 = ops.pick_tile(spec, shape)
        numel, itemsize = x.numel(), x.element_size()
        grid_bytes = 2 * numel * itemsize
        dims = "x".join(map(str, shape))
        sweep_key = "sweep_1d" if spec.ndim == 1 else "sweep_nd"
        multi_key = "multistep_1d" if spec.ndim == 1 else "multistep_nd"
        weight = torch.tensor(spec.coeff_array(), dtype=x.dtype, device=dev)[None, None]

        def plan_of(sweep, remainder, ttile=1):
            return StencilPlan(backend="pallas", sweep=sweep, k=K, ttile=ttile,
                               remainder=remainder)

        # -- main path: resident (one short uncounted run loads the kernels) --
        prob.run(x, 2, plan_of("resident", "fused"))
        resident, counts = {}, {}
        for remainder, steps in PLANS:
            launches = sum(n for _, n in sweep_schedule(K, steps, remainder, TTILE)[0])
            y, seconds, got = counted(
                f"{name} resident {remainder}",
                lambda: prob.run(x, steps, plan_of("resident", remainder, TTILE)),
                {"transpose": 2, sweep_key: launches})
            counts[("resident", remainder)] = got
            err = same(f"{name} resident {remainder} vs plain", y,
                       resident_plain(spec, x, steps, remainder, vl, m, t0))
            resident[remainder] = (y, seconds)
            emit({"phase": "main_path", "case": name, "shape": list(shape),
                  "plan": {"k": K, "ttile": TTILE, "remainder": remainder}, "steps": steps,
                  "schedule": sweep_schedule(K, steps, remainder, TTILE)[0],
                  "tile": {"vl": vl, "m": m, "t0": t0}, "seconds": seconds,
                  "gpoint_updates_per_s": numel * steps / seconds, "launches": got,
                  "max_abs_err_vs_plain": err, "bitwise": True})

        # -- roundtrip: the same runs, one pad/transpose/K4/transpose per sweep
        prob.run(x, 2, plan_of("roundtrip", "fused"))
        for remainder, steps in PLANS:
            sweeps = sum(n for _, n in sweep_schedule(K, steps, remainder, 1)[0])
            y, seconds, got = counted(
                f"{name} roundtrip {remainder}",
                lambda: prob.run(x, steps, plan_of("roundtrip", remainder)),
                {"transpose": 2 * sweeps, multi_key: sweeps})
            counts[("roundtrip", remainder)] = got
            res2, res2_s = resident[remainder]
            same(f"{name} roundtrip {remainder} vs resident ttile={TTILE}", y, res2)
            torch.cuda.synchronize()
            start = time.perf_counter()
            res1 = prob.run(x, steps, plan_of("resident", remainder, 1))
            torch.cuda.synchronize()
            res1_s = time.perf_counter() - start
            err = same(f"{name} roundtrip {remainder} vs resident ttile=1", y, res1)
            emit({"phase": "roundtrip", "case": name, "shape": list(shape),
                  "plan": {"k": K, "remainder": remainder, "sweep": "roundtrip"},
                  "steps": steps, "sweeps": sweeps, "launches": got,
                  "seconds": seconds, "gpoint_updates_per_s": numel * steps / seconds,
                  "resident_seconds": {"ttile=1": res1_s, f"ttile={TTILE}": res2_s},
                  "resident_gpoint_updates_per_s": {
                      "ttile=1": numel * steps / res1_s,
                      f"ttile={TTILE}": numel * steps / res2_s},
                  "roundtrip_over_resident_ttile2": seconds / res2_s,
                  "max_abs_err_vs_resident": err, "bitwise_ttile1_and_2": True})
            del y, res1
        del resident

        # -- dirichlet: ops.stencil_run, the Dirichlet ring along axis 0 ------
        sweeps = DIRICHLET_STEPS // K
        y, seconds, got = counted(
            f"{name} dirichlet",
            lambda: ops.stencil_run(spec, x, DIRICHLET_STEPS, k=K),
            {"transpose": 2 * sweeps, multi_key: sweeps})
        counts["dirichlet"] = got
        err = same(f"{name} dirichlet vs plain", y,
                   dirichlet_plain(spec, x, DIRICHLET_STEPS, vl, m, t0))
        emit({"phase": "dirichlet", "case": name, "shape": list(shape), "k": K,
              "steps": DIRICHLET_STEPS, "launches": got, "seconds": seconds,
              "gpoint_updates_per_s": numel * DIRICHLET_STEPS / seconds,
              "max_abs_err_vs_plain": err, "bitwise": True})
        del y
        launched = {key: sum(c[key] for c in counts.values()) for key in sk.LAUNCHES}

        # -- K2: transpose in and out --------------------------------------
        t = sk.block_transpose(x, vl, m)
        back = sk.block_untranspose(t, vl, m)
        err = max(same(f"{name} transpose", t, sk.block_transpose_ref(x, vl, m)),
                  same(f"{name} untranspose", back, x))
        del back
        buf = torch.empty_like(t)
        nb_total = numel // (vl * m)
        row("K2", "block_transpose", f"{name} {dims} vl={vl} m={m}", "transpose",
            launched["transpose"], err,
            lambda: sk.block_transpose(x, vl, m, out=buf),
            lambda: sk.block_transpose_ref(x, vl, m),
            bound(grid_bytes, 0),
            lambda: ms(lambda: x.view(nb_total, vl, m).transpose(-1, -2).contiguous()))

        # -- K1 / K3: the resident sweep at every depth the main path launches
        kid = "K1" if spec.ndim == 1 else "K3"
        fname = "stencil1d_sweep_ttile" if spec.ndim == 1 else "stencil_nd_sweep_ttile"
        for depth in (4, 2, 1):
            kk, tt = (K, depth // K) if depth > K else (depth, 1)
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
            err = same(f"{name} {kid} depth {depth}", kern(), plain())
            row(kid, fname, f"{name} {dims} depth={depth}", "sweep",
                launched[sweep_key], err, kern, plain,
                bound(grid_bytes, depth * spec.flops_per_point * numel),
                lambda: ms(conv_steps, spec, x, depth, weight))
        del t, buf

        # -- K4: the multistep sweep at the roundtrip's padded shape ---------
        kid = "K4a" if spec.ndim == 1 else "K4b"
        fname = "stencil1d_multistep" if spec.ndim == 1 else "stencil_nd_multistep"
        block = vl * m if spec.ndim == 1 else t0
        pad = sk.sweep_halo_blocks(spec.r, K, block) * block
        xp = ops.wrap_pad(x, pad)
        tp = sk.block_transpose(xp, vl, m)
        bufp = torch.empty_like(tp)
        pdims = "x".join(map(str, xp.shape))
        for edge_mask in (False, True):
            for depth in (K, 1):
                if spec.ndim == 1:
                    def kern():
                        return sk.stencil1d_multistep(spec, tp, depth, edge_mask, out=bufp)

                    def plain():
                        return sk.stencil1d_multistep_ref(spec, tp, depth, edge_mask)
                else:
                    def kern():
                        return sk.stencil_nd_multistep(spec, tp, depth, t0, edge_mask,
                                                       out=bufp)

                    def plain():
                        return sk.stencil_nd_multistep_ref(spec, tp, depth, t0, edge_mask)
                edge = "ring" if edge_mask else "open"
                err = same(f"{name} {kid} {edge} depth {depth}", kern(), plain())
                row(kid, fname,
                    f"{name} {pdims} {edge} depth={depth}; library: zero pad on axis 0, "
                    "no ring restore", "sweep", launched[multi_key], err, kern, plain,
                    bound(2 * xp.numel() * itemsize,
                          depth * spec.flops_per_point * xp.numel()),
                    lambda: ms(conv_steps, spec, xp, depth, weight, True))
        del x, xp, tp, bufp, weight
        torch.cuda.empty_cache()

    # -- onestep: the layout A/B, and its K5 rows --------------------------
    vl, m = 32, 8
    for name, n in ONESTEP:
        spec = stencils.make(name)
        x = StencilProblem(name, (n,)).init(SEED)
        want = kref.onestep_periodic_ref(spec, x)
        ops.stencil_onestep_naive(spec, x, vl)            # uncounted: loads the kernels
        ops.stencil_onestep_transpose(spec, x, vl, m)
        naive, s_naive, c_naive = counted(f"{name} onestep naive",
                                          lambda: ops.stencil_onestep_naive(spec, x, vl),
                                          {"onestep_naive": 1})
        trans, s_trans, c_trans = counted(f"{name} onestep transpose",
                                          lambda: ops.stencil_onestep_transpose(spec, x, vl, m),
                                          {"onestep_transpose": 1, "transpose": 2})
        err_naive = same(f"{name} onestep naive", naive, want)
        err_trans = same(f"{name} onestep transpose", trans, want)
        emit({"phase": "onestep", "case": name, "shape": [n], "vl": vl, "m": m,
              "naive": {"seconds": s_naive, "launches": c_naive},
              "transpose": {"seconds": s_trans, "launches": c_trans},
              "bitwise": True})
        weight = torch.tensor(spec.coeff_array(), dtype=x.dtype, device=dev)[None, None]
        b = bound(2 * n * 4, spec.flops_per_point * n)
        out = torch.empty_like(x)
        row("K5a", "stencil1d_naive_onestep", f"{name} {n} vl={vl}", "onestep",
            c_naive["onestep_naive"], err_naive,
            lambda: sk.stencil1d_naive_onestep(spec, x, vl, out=out),
            lambda: sk.stencil1d_naive_onestep_ref(spec, x, vl), b,
            lambda: ms(conv_steps, spec, x, 1, weight))
        t = sk.block_transpose(x, vl, m)
        tout = torch.empty_like(t)
        row("K5b", "stencil1d_transpose_onestep", f"{name} {n} vl={vl} m={m}", "onestep",
            c_trans["onestep_transpose"], err_trans,
            lambda: sk.stencil1d_transpose_onestep(spec, t, out=tout),
            lambda: sk.stencil1d_transpose_onestep_ref(spec, t), b,
            lambda: ms(conv_steps, spec, x, 1, weight))
        del x, want, naive, trans, t, tout, out
        torch.cuda.empty_cache()

    # -- small cases on the card and on the CPU against the f64 oracle -------
    def small(case, spec, x, run, steps, bc):
        y_gpu = run(x).cpu()
        y_cpu = run(x.cpu())
        oracle = x.cpu().double().numpy()
        for _ in range(steps):
            oracle = stencils.numpy_apply_once(spec, oracle, bc)
        errs = {"gpu_vs_f64": float(np.abs(y_gpu.double().numpy() - oracle).max()),
                "cpu_vs_f64": float(np.abs(y_cpu.double().numpy() - oracle).max()),
                "gpu_vs_cpu": float((y_gpu - y_cpu).abs().max())}
        if max(errs.values()) > 1e-5:
            raise AssertionError(f"small {case} off the f64 oracle: {errs}")
        emit({"phase": "small", "case": case, "shape": list(x.shape), "steps": steps,
              "bc": bc, **errs})

    steps = 16
    plan = StencilPlan(backend="pallas", sweep="resident", k=K, ttile=TTILE)
    shape = (16, 16, 256)
    x = StencilProblem("3d7p", shape).init(SEED)
    small("3d7p", stencils.make("3d7p"), x,
          lambda v: StencilProblem("3d7p", shape, device=v.device).run(v, steps, plan),
          steps, "periodic")
    spec = stencils.make("2d5p")
    x = StencilProblem("2d5p", (64, 256)).init(SEED)
    small("2d5p dirichlet", spec, x, lambda v: ops.stencil_run(spec, v, steps, k=K),
          steps, kref.kernel_bc(2))

    emit({"kernels": entries})
    print(gpu, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
