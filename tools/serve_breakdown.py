#!/usr/bin/env python3
"""Split the host-clock time of a served batch of stencil sweeps into its
parts, on one CUDA card.

    python3 tools/serve_breakdown.py [--slots 8] [--runs 5]

For each case (1d3p 2**26, 2d5p 8192**2 and 2d5p 256**2, float32, 16
steps of the resident plan k=2 ttile=2, as the ``stencil_serve`` phase of
``chip_smoke.py`` serves them) ``--slots`` requests of two tenants go
through a ``StencilService`` whose plan cache holds that plan, and the
script prints one JSON line with these medians of ``--runs`` runs, each
between two synchronizes:

- ``served_ms``: ``sweep_async`` of every request and their results (the
  batcher's scheduler and worker threads), and ``worker_wall_ms``, the
  batch's own wall time as the batcher logs it (run and synchronize);
- ``inline_ms``: the same requests through a batcher that runs the batch
  in the calling thread (``start=False``, ``run_pending``);
- ``parts_ms`` / ``parts_event_ms``: ``StencilProblem.run_batched_parts``
  called directly, on the host clock and between CUDA events;
- ``sequential_ms`` / ``sequential_event_ms``: ``svc.sweep`` of each
  request in turn;
- ``device_allocs``: the caching allocator's new device segments
  (``num_device_alloc``) over the served runs;
- ``profile``: one served batch under ``torch.profiler``: its kernels'
  summed device time, the span from the first kernel's start to the last
  one's end, and the device time of each kernel name.

Each served result is first held bit for bit against ``svc.sweep``.  The
card's name and power limit come first.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "src"))

STEPS = 16
TENANTS = ("tenant-a", "tenant-b")
CASES = (("1d3p", (1 << 26,)), ("2d5p", (8192, 8192)), ("2d5p", (256, 256)))


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("serve_breakdown: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.core import autotune
    from repro_torch.core.api import StencilPlan
    from repro_torch.kernels import build
    from repro_torch.serve.batcher import StencilSweepBatcher
    from repro_torch.serve.engine import StencilService

    parser = argparse.ArgumentParser()
    parser.add_argument("--slots", type=int, default=8)
    parser.add_argument("--runs", type=int, default=5)
    args = parser.parse_args()
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    build.build_all(("transpose", "sweep1d_warp", "sweep2d_warp"))
    plan = StencilPlan(backend="pallas", sweep="resident", k=2, ttile=2)

    def host_median(fn):
        times = []
        for _ in range(args.runs):
            torch.cuda.synchronize()
            start = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - start)
        return float(np.median(times)) * 1e3

    def event_median(fn):
        times = []
        for _ in range(args.runs):
            start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            fn()
            stop.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(stop))
        return float(np.median(times))

    with tempfile.TemporaryDirectory(prefix="serve_breakdown_") as tmp:
        cache_path = os.path.join(tmp, "plan_cache.json")
        cache = autotune.PlanCache(cache_path)
        for name, shape in CASES:
            cache.put(autotune.plan_key(name, shape, torch.float32, "auto",
                                        device=autotune.device_signature(dev),
                                        steps=autotune.normalize_steps(STEPS)),
                      {"plan": autotune.plan_to_dict(plan), "seconds_per_step": 0.0})
        cache.save()
        with StencilService(cache_path=cache_path) as svc:
            for name, shape in CASES:
                gen = torch.Generator(device=dev).manual_seed(0)
                xs = [torch.randn(shape, generator=gen, device=dev) for _ in range(args.slots)]
                prob, got_plan = svc.resolve(name, shape, torch.float32, steps=STEPS)
                assert got_plan == plan, got_plan

                def served():
                    futs = [svc.sweep_async(name, x, STEPS, tenant=TENANTS[i % 2],
                                            max_wait_s=0.05) for i, x in enumerate(xs)]
                    return [f.result(timeout=600) for f in futs]

                inline_batcher = StencilSweepBatcher(svc, start=False)

                def inline():
                    futs = [inline_batcher.submit(name, x, STEPS, tenant=TENANTS[i % 2])
                            for i, x in enumerate(xs)]
                    inline_batcher.run_pending()
                    return [f.result() for f in futs]

                def parts():
                    return prob.run_batched_parts(xs, STEPS, plan)

                def sequential():
                    return [svc.sweep(name, x, STEPS) for x in xs]

                for x, y in zip(xs, served()):
                    if not torch.equal(y, svc.sweep(name, x, STEPS)):
                        raise AssertionError(f"{name} {shape}: served result differs")
                inline()
                torch.cuda.synchronize()
                allocs = torch.cuda.memory_stats(dev)["num_device_alloc"]
                served_ms = host_median(served)
                allocs = torch.cuda.memory_stats(dev)["num_device_alloc"] - allocs
                log = svc._batcher.stats["batch_log"][-args.runs:]
                worker_ms = float(np.median([b["wall_s"] for b in log])) * 1e3
                line = {"case": name, "shape": list(shape), "slots": args.slots,
                        "steps": STEPS, "served_ms": served_ms, "worker_wall_ms": worker_ms,
                        "inline_ms": host_median(inline), "parts_ms": host_median(parts),
                        "parts_event_ms": event_median(parts),
                        "sequential_ms": host_median(sequential),
                        "sequential_event_ms": event_median(sequential),
                        "device_allocs": allocs}
                torch.cuda.synchronize()
                with torch.profiler.profile(activities=[
                        torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
                    served()
                    torch.cuda.synchronize()
                kernels = [e for e in prof.events()
                           if e.device_type == torch.autograd.DeviceType.CUDA]
                per_name: dict[str, float] = {}
                for e in kernels:
                    per_name[e.name] = per_name.get(e.name, 0.0) + e.device_time / 1e3
                line["profile"] = {
                    "kernels": len(kernels),
                    "device_ms": sum(per_name.values()),
                    "span_ms": (max(e.time_range.end for e in kernels)
                                - min(e.time_range.start for e in kernels)) / 1e3
                    if kernels else None,
                    "by_name_ms": {k[:80]: v for k, v in sorted(per_name.items(),
                                                                key=lambda kv: -kv[1])[:8]}}
                inline_batcher.close()
                print(json.dumps(line), flush=True)
                del xs
                torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
