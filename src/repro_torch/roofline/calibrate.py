"""Measured roofline calibration: per-device-kind constants, persisted
(reference: ``roofline/calibrate.py``).

The analytic plan roofline (:mod:`repro_torch.roofline.stencil`) ranks
plan candidates as ``t >= max(F/peak_flops, B/hbm_bw)``.  Every measured
candidate (modeled flops F and bytes B per step; measured seconds t per
step) certifies ``peak_flops >= F/t`` and ``hbm_bw >= B/t``, so the fitted
constant per device kind is the MAX observed throughput: a monotone
ratchet, which a slow sample can never loosen.

The bound argument holds only when the modeled term reflects real
traffic: a grid whose working set fits in a cache observes the cache's
rate, so the caller (``autotune.tune``) zeroes the ``bytes`` field for
problems under :func:`min_bandwidth_working_set` and those samples feed
only the flops term.  Fitted constants are served only once both the
compute AND memory terms have samples (:func:`load_constants`).

Where the port departs from the reference (each a GPU fact):

  * :data:`STATIC` holds H100 SXM data-sheet rates, not the TPU-v5e ones:
    3.35e12 B/s of HBM3; ``peak_flops`` = 33.5e12, half the 67 TFLOP/s
    FP32 rate outside the tensor cores, because that rate counts a fused
    multiply-add as two operations and the stencil kernels are built
    ``-fmad=false`` (``kernels/build.py``: bit for bit their plain
    versions), so each multiply and each add of the model's ``2·taps − 1``
    is an instruction of its own; ``peak_flops_mxu`` = 67e12, what
    the mxu engine's float32 GEMM runs at in IEEE FP32 (``exact_products``:
    no TF32, so no tensor core), and ``peak_flops_mxu_bf16`` = 989e12, the
    dense bfloat16 tensor-core rate its bfloat16 GEMM runs at;
    ``ici_bw`` = 450e9 B/s, NVLink 4 in one direction (only distributed
    plans, ROADMAP A9, would read it).
  * The mxu peak is fitted per element type: samples of bfloat16 mxu plans
    carry ``mxu_bf16_flops`` and ratchet ``peak_flops_mxu_bf16``.
  * :func:`min_bandwidth_working_set` is at least twice the card's L2
    cache (50 MB on an H100): the reference's 32 MiB floor would let an
    L2-resident grid ratchet ``hbm_bw`` past the card's memory.
  * :func:`device_kind` is torch's device name.

File format (JSON, ``REPRO_TORCH_ROOFLINE_CONSTANTS`` env var, or
``roofline_constants.json`` beside the plan cache)::

    {"version": 1,
     "devices": {
       "nvidia_h100_80gb_hbm3": {"peak_flops": 2.1e12, "hbm_bw": 2.9e12,
               "ici_bw": 0.0, "peak_flops_mxu": 4.1e13,
               "peak_flops_mxu_bf16": 0.0, "n_samples": 24}}}

Writes are read-merge-write under an exclusive lock + atomic replace
(:func:`repro_torch.core.locked_json.locked_update`); corrupt or
version-mismatched files are ignored and overwritten.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Iterable

import torch

from repro_torch.core import locked_json

CONSTANTS_VERSION = 1
CONSTANTS_ENV = "REPRO_TORCH_ROOFLINE_CONSTANTS"
CONSTANTS_BASENAME = "roofline_constants.json"

# H100 SXM data sheet
HBM_BW = 3.35e12             # bytes/s, HBM3
PEAK_FLOPS = 67e12 / 2       # FP32 outside the tensor cores, no FMA (see above)
PEAK_FLOPS_MXU = 67e12       # IEEE FP32 GEMM (FMA on the FP32 units)
PEAK_FLOPS_MXU_BF16 = 989e12  # bfloat16 tensor cores, dense
ICI_BW = 450e9               # NVLink 4, bytes/s in one direction

# the reference's floor: grids whose read+write working set is under this
# are (potentially) cache-resident on any device
MIN_BANDWIDTH_WORKING_SET = 32 << 20
# the L2 of an H100, where the card does not report its own
_L2_FALLBACK = 50 << 20

# until an mxu candidate has been measured on a device kind, fitted
# constants charge its matmul flops at the fitted vector peak divided by
# this penalty (the reference's conservative guess); the static constants
# carry the data-sheet GEMM rates instead
MXU_FALLBACK_PENALTY = 2.0


@dataclasses.dataclass(frozen=True)
class RooflineConstants:
    """Device throughput peaks used by ``estimate_plan_time``; ``source``
    records whether they are the static H100 data-sheet rates or fitted."""

    peak_flops: float = PEAK_FLOPS
    hbm_bw: float = HBM_BW
    ici_bw: float = ICI_BW
    # the mxu engine's GEMM rate: float32 (and float64) operands, and
    # bfloat16 ones; 0.0 = not fitted yet (estimate_plan_time falls back
    # to peak_flops / MXU_FALLBACK_PENALTY)
    peak_flops_mxu: float = PEAK_FLOPS_MXU
    peak_flops_mxu_bf16: float = PEAK_FLOPS_MXU_BF16
    n_samples: int = 0
    source: str = "static"


STATIC = RooflineConstants()


def default_device(device=None) -> torch.device:
    """``device``, or where it is ``None`` the card when there is one (as
    for the port's entry points), else the CPU."""
    if device is not None:
        return torch.device(device)
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def device_kind(device=None) -> str:
    """The device component of calibration and plan-cache keys: torch's
    name of the card, lowercased with ``_`` for spaces
    (``nvidia_h100_80gb_hbm3``), or ``cpu``."""
    dev = default_device(device)
    if dev.type != "cuda":
        return "cpu"
    return torch.cuda.get_device_name(dev).lower().replace(" ", "_")


def min_bandwidth_working_set(device=None) -> int:
    """Smallest read+write working set whose samples may fit ``hbm_bw``:
    the reference's 32 MiB, and on a card at least twice its L2 cache."""
    dev = default_device(device)
    if dev.type != "cuda":
        return MIN_BANDWIDTH_WORKING_SET
    props = torch.cuda.get_device_properties(dev)
    l2 = int(getattr(props, "L2_cache_size", 0) or _L2_FALLBACK)
    return max(MIN_BANDWIDTH_WORKING_SET, 2 * l2)


def constants_path(cache_path: str | None = None) -> str:
    """Resolution order: env var → sibling of the given plan-cache path →
    the port's default cache directory (``~/.cache/repro_torch``), apart
    from the reference's."""
    env = os.environ.get(CONSTANTS_ENV)
    if env:
        return env
    if cache_path:
        return os.path.join(os.path.dirname(os.path.abspath(cache_path)),
                            CONSTANTS_BASENAME)
    return os.path.join(os.path.expanduser("~"), ".cache", "repro_torch",
                        CONSTANTS_BASENAME)


def _load_devices(path: str) -> dict:
    raw = locked_json.read_json(path)
    if raw is not None and raw.get("version") == CONSTANTS_VERSION:
        return dict(raw.get("devices", {}))
    return {}


def load_constants(device: str | None = None,
                   cache_path: str | None = None,
                   path: str | None = None) -> RooflineConstants:
    """Fitted constants for ``device`` (a :func:`device_kind` string;
    default: the local device kind).

    Fitted values are served only once BOTH the compute and memory terms
    have samples: a fitted ``peak_flops`` beside the static ``hbm_bw`` (or
    the reverse) would skew every ranking toward the term still at its
    data-sheet peak.  ``ici_bw`` alone falls back independently."""
    path = path or constants_path(cache_path)
    device = device or device_kind()
    e = _load_devices(path).get(device)
    if not e:
        return STATIC
    pf = float(e.get("peak_flops") or 0.0)
    bw = float(e.get("hbm_bw") or 0.0)
    if pf <= 0.0 or bw <= 0.0:
        return STATIC
    return RooflineConstants(
        peak_flops=pf, hbm_bw=bw,
        ici_bw=float(e.get("ici_bw") or 0.0) or ICI_BW,
        peak_flops_mxu=float(e.get("peak_flops_mxu") or 0.0),
        peak_flops_mxu_bf16=float(e.get("peak_flops_mxu_bf16") or 0.0),
        n_samples=int(e.get("n_samples", 0)),
        source="measured")


def record_samples(samples: Iterable[dict], device: str | None = None,
                   cache_path: str | None = None,
                   path: str | None = None) -> RooflineConstants:
    """Ratchet the fitted constants with measured samples and persist.

    Each sample: ``{"flops": F, "bytes": B, "coll_bytes": C,
    "seconds": t}`` — modeled per-step terms against the measured per-step
    time.  mxu candidates carry their matmul flops under ``"mxu_flops"``
    (float32 and float64 operands) or ``"mxu_bf16_flops"`` (bfloat16),
    with ``"flops": 0.0``.  Returns the post-update constants."""
    path = path or constants_path(cache_path)
    device = device or device_kind()
    pf = bw = ici = pf_mxu = pf_mxu_bf16 = 0.0
    n = 0
    for s in samples:
        t = float(s.get("seconds", 0.0))
        if t <= 0.0:
            continue
        pf = max(pf, float(s.get("flops", 0.0)) / t)
        bw = max(bw, float(s.get("bytes", 0.0)) / t)
        ici = max(ici, float(s.get("coll_bytes", 0.0)) / t)
        pf_mxu = max(pf_mxu, float(s.get("mxu_flops", 0.0)) / t)
        pf_mxu_bf16 = max(pf_mxu_bf16, float(s.get("mxu_bf16_flops", 0.0)) / t)
        n += 1
    if not n:
        return load_constants(device=device, path=path)

    def merge(raw: dict | None) -> dict:
        # re-read under the lock and ratchet against the FRESH entry — a
        # concurrent writer's constants are merged, never clobbered
        devices = {}
        if raw is not None and raw.get("version") == CONSTANTS_VERSION:
            devices = dict(raw.get("devices", {}))
        old = devices.get(device, {})
        devices[device] = {
            "peak_flops": max(pf, float(old.get("peak_flops", 0.0))),
            "hbm_bw": max(bw, float(old.get("hbm_bw", 0.0))),
            "ici_bw": max(ici, float(old.get("ici_bw", 0.0))),
            "peak_flops_mxu": max(pf_mxu, float(old.get("peak_flops_mxu", 0.0) or 0.0)),
            "peak_flops_mxu_bf16": max(
                pf_mxu_bf16, float(old.get("peak_flops_mxu_bf16", 0.0) or 0.0)),
            "n_samples": int(old.get("n_samples", 0)) + n}
        return {"version": CONSTANTS_VERSION, "devices": devices}

    locked_json.locked_update(path, merge)
    # serve the post-update view through the same coherence gate reads use
    return load_constants(device=device, path=path)
