#!/usr/bin/env python3
"""Where one prefill's device time goes, on one CUDA card.

    python3 tools/prefill_profile.py [--models mamba2-2.7b zamba2-2.7b gemma-2b]
                                     [--tokens 2048]

For each model, at full width with random weights from seed 0 and the
bfloat16 copy of the weights that ``chip_smoke.py``'s serving phases use,
one warm-up prefill of ``--tokens`` tokens (drawn from seed 0, as the
serving phases draw their first prompt), then one more under
``torch.profiler``.  One JSON line a model gives the device time of its
kernels by kind: ``K6`` (``ssd_state``, ``ssd_out``), ``gemm`` (kernel
names holding gemm, nvjet, cutlass or xmma: the cuBLAS products),
``softmax``, and ``unclassified``, every other kernel; the kind is read
from the kernel's name alone, so what counts as a product follows how the
libraries name their kernels.  Also the kernel count, the summed device
time, and the six costliest kernel names.  A profile with no device
events gives null.  The card's name and power limit come first.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "src"))

SEED = 0
MAX_SEQ = 4096
KINDS = (("K6", ("ssd_state", "ssd_out")), ("gemm", ("gemm", "nvjet", "cutlass", "xmma")),
         ("softmax", ("softmax",)))


def profile(model, params, tokens) -> dict:
    """One prefill of ``tokens`` under ``torch.profiler``, by kernel kind."""
    import torch
    from torch.autograd import DeviceType

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        model.prefill(params, {"tokens": tokens}, max_seq=MAX_SEQ)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        return {"device_ms_by_kind": None}
    by_kind, by_name = {}, {}
    for e in kernels:
        ms = e.time_range.elapsed_us() / 1e3
        name = e.name.lower()
        kind = next((k for k, keys in KINDS if any(key in name for key in keys)), "unclassified")
        by_kind[kind] = by_kind.get(kind, 0.0) + ms
        total, count = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (total + ms, count + 1)
    top = sorted(by_name.items(), key=lambda item: -item[1][0])[:6]
    return {"kernels": len(kernels), "device_ms": sum(by_kind.values()),
            "device_ms_by_kind": by_kind,
            "top_kernels": [{"name": name[:90], "ms": ms, "launches": count}
                            for name, (ms, count) in top]}


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("prefill_profile: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.configs.base import get_arch
    from repro_torch.kernels import build
    from repro_torch.models import transformer, zoo

    parser = argparse.ArgumentParser()
    parser.add_argument("--models", nargs="+", default=["mamba2-2.7b", "zamba2-2.7b", "gemma-2b"])
    parser.add_argument("--tokens", type=int, default=2048)
    args = parser.parse_args()
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    build.build_all(("ssd_scan",))
    for arch in args.models:
        cfg = get_arch(arch)
        model = zoo.build(cfg)
        params = transformer.cast_params(model.init(torch.Generator(device=dev).manual_seed(SEED)))
        prompt = np.random.default_rng(SEED).integers(0, cfg.vocab, args.tokens)
        tokens = torch.as_tensor(prompt, device=dev)[None]
        model.prefill(params, {"tokens": tokens}, max_seq=MAX_SEQ)
        print(json.dumps({"model": arch, "tokens": args.tokens,
                          **profile(model, params, tokens)}), flush=True)
        del model, params
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
