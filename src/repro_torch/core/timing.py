"""Wall-clock measurement for the port.

On a CUDA device a call is timed with CUDA events around a window of
calls, after a synchronize; on the CPU with the host clock.  Each result
is the median time per call over ``iters`` windows.
"""
from __future__ import annotations

import time

import numpy as np
import torch


def bench(fn, *args, device, warmup: int = 2, iters: int = 5,
          min_time_s: float = 0.2) -> float:
    """Median seconds per call of ``fn(*args)`` on ``device``."""
    dev = torch.device(device)
    if dev.type == "cuda":
        def sync():
            torch.cuda.synchronize(dev)
    else:
        def sync():
            pass
    for _ in range(warmup):
        fn(*args)
    sync()
    # calibrate repeats so the measurement window is at least min_time_s
    t0 = time.perf_counter()
    fn(*args)
    sync()
    once = time.perf_counter() - t0
    inner = max(1, int(min_time_s / max(once, 1e-9)))
    times = []
    for _ in range(iters):
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(inner):
                fn(*args)
            stop.record()
            stop.synchronize()
            times.append(start.elapsed_time(stop) / 1e3 / inner)
        else:
            t0 = time.perf_counter()
            for _ in range(inner):
                fn(*args)
            times.append((time.perf_counter() - t0) / inner)
    return float(np.median(times))
