"""Analytic roofline for stencil plan candidates (reference:
``roofline/stencil.py``).

Used by :mod:`repro_torch.core.autotune` to rank the legal ``StencilPlan``
candidates for a problem before measuring any of them.  It follows the
reference's operation accounting (paper §3): per grid point per step a
plan costs ``2·taps − 1`` arithmetic operations plus its scheme's
reorganization work (:func:`reorg_ops_per_point`), and bytes of device
memory.  :func:`plan_terms` returns the raw (flops, hbm_bytes,
collective_bytes) per step; :func:`estimate_plan_time` divides them by
device constants, by default the H100 data-sheet rates of
:data:`repro_torch.roofline.calibrate.STATIC`.

What the port executes, and so prices, where it differs from the
reference's model:

  * **pallas past the deepest register launch.** A depth-``d`` sweep runs
    as the consecutive launches that ``sweep1d_launches(m, d, r)`` (1-D:
    each at most ``32·M // r`` deep) / ``sweep2d_launches(m, d, r)`` /
    ``sweep3d_launches(m, d, r)`` list (``kernels/stencil_kernels.py``; at
    r > 1 the register kernels' deepest launches are shallower: 2-D
    ``WARP2D_DEPTH[M, r]``, 3-D ``SWEEP3D_DEPTH[M, r]``), and
    each launch reads and writes the grid once, with the halo factor ``1 +
    2·D·r/n0`` of its own depth ``D``; the reference charges one pass a
    chunk.
  * **the roundtrip engine's crop is a view** (``narrow``): a sweep pays
    the wrap-pad copy and the layout round trip, 6 grid transfers beside
    the kernel's, not the reference's 8.
  * **the jnp backend is eager PyTorch**: every roll, product, sum, layout
    copy and masked select is a pass of its own over the grid
    (:func:`jnp_transfers_per_step`), whatever ``k`` is; the reference
    charges one fused read and write a k-block, as XLA would run it.  A
    tessellation round of height ``H`` evaluates a whole step at each of
    its ``(ndim + 1)·H`` sub-steps, so its flops are ``ndim + 1`` times a
    step's.  No DLT prefetch penalty: the passes are counted instead.
  * **distributed plans** raise ``NotImplementedError``: their terms
    (ghost rings, the overlap fraction, the collective term) come with the
    distributed runtime, ROADMAP A9.

Everywhere else — mxu plans, pallas within the deepest launch —
:func:`plan_terms` is the reference's, term for term.  The byte counts
are lower bounds of what the port moves, so that a fitted bandwidth
(``roofline/calibrate.py``) never exceeds the card's.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from repro_torch.roofline import calibrate

# Amortization horizon for once-per-RUN costs (the resident engine's single
# layout round-trip) when the plan is ranked without a concrete step count.
RESIDENT_AMORT_STEPS = 16

_A9 = "distributed plans are not ported yet: they need the distributed runtime (ROADMAP A9)"


def reorg_ops_per_point(spec, scheme: str, vl: int, m: int | None) -> float:
    """Data-reorganization ops per grid point per step (paper §2–§3)."""
    r = spec.r
    if scheme == "fused":
        return 0.0
    if scheme == "multiload":
        return 2.0 * r
    if scheme == "reorg":
        return float(spec.npoints - 1)
    if scheme == "dlt":
        return 0.0
    if scheme == "transpose":
        return 4.0 * r / float(m or vl)
    raise ValueError(f"unknown scheme {scheme!r}")


def _sweeps_per_step(k_eff: int, steps: int | None, remainder: str) -> float:
    """Memory round-trips per time step for a k_eff-blocked sweep schedule:
    ``1/k_eff`` when k_eff divides the run (or no step count is given);
    a remainder of ``steps % k_eff`` costs one extra sweep ("native") or
    one a leftover step ("fused")."""
    k_eff = max(k_eff, 1)
    if steps is None or steps % k_eff == 0 or k_eff == 1:
        return 1.0 / k_eff
    main, rem = steps - steps % k_eff, steps % k_eff
    tail = 1.0 if remainder == "native" else float(rem)
    return (main / k_eff + tail) / steps


def pallas_extra_bytes_per_step(pts: float, itemsize: int, sweep: str,
                                sweeps_per_step: float,
                                steps: int | None) -> float:
    """Layout/pad traffic per grid step beyond the kernel sweep itself.

    The layout round trip (K2 in + K2 out) moves 2 copies of the grid each
    way, ``4·pts·itemsize`` bytes.  The ``resident`` engine pays it once
    per RUN, amortized over ``steps`` (or :data:`RESIDENT_AMORT_STEPS`);
    the ``roundtrip`` engine pays it every sweep beside a wrap-pad copy
    (``1.5×`` the round trip: its crop is a view, where the reference
    charges a copy, ``2×``)."""
    roundtrip = 4.0 * pts * itemsize
    if sweep == "resident":
        return roundtrip / float(steps if steps else RESIDENT_AMORT_STEPS)
    return 1.5 * roundtrip * sweeps_per_step


def launch_depths(spec, vl: int, m: int, depth: int, itemsize: int = 4) -> tuple[int, ...]:
    """The depths of the launches one depth-``depth`` pallas sweep of
    ``spec`` at tile ``(vl, m)`` on ``itemsize``-byte elements makes on the
    card, on the route ``stencil_kernels.sweep_plan`` names.  A sweep no
    far-reach launch fits (the tuner's gate refuses its plans) is priced as
    one launch."""
    from repro_torch.kernels import stencil_kernels as sk
    try:
        return tuple(d for *_, d in sk.sweep_plan(spec, vl, m, depth, itemsize)[1])
    except ValueError:
        return (depth,)


def _pallas_tile(spec, shape, plan) -> tuple[int, int]:
    if plan.m is not None:
        return plan.vl, plan.m
    from repro_torch.kernels.ops import pick_tile
    vl, m, _ = pick_tile(spec, tuple(shape))
    return vl, m


def _pallas_terms(spec, shape, itemsize, plan, steps):
    from repro_torch.core.api import sweep_schedule
    pts = float(np.prod(list(shape)))
    n0 = shape[0] if spec.ndim > 1 else shape[-1]
    remainder = plan.remainder
    engine = plan.sweep
    ttile = plan.ttile if engine == "resident" else 1
    arith = float(spec.flops_per_point)
    reorg = reorg_ops_per_point(spec, "transpose", plan.vl, plan.m)
    vl, m = _pallas_tile(spec, shape, plan)
    chunks, total = sweep_schedule(plan.k, steps, remainder, ttile)
    split = any(len(launch_depths(spec, vl, m, d, itemsize)) > 1 for d, _ in chunks)
    if ttile == 1 and not split:
        # the reference's model: HBM once per k-block, its halo ring factor
        sweeps = _sweeps_per_step(plan.k, steps, remainder)
        flops = pts * (arith + reorg)
        mem = 2.0 * pts * itemsize * sweeps * (1.0 + 2.0 * plan.k * spec.r / max(n0, 1))
        return flops, mem + pallas_extra_bytes_per_step(pts, itemsize, engine, sweeps,
                                                        steps), 0.0
    # one pass over the grid a LAUNCH, each with the halo ring (and the
    # redundant halo compute) of its own depth; a chunk that one launch
    # runs is the reference's temporal-tile accounting
    flops = mem = 0.0
    for depth, n in chunks:
        for d in launch_depths(spec, vl, m, depth, itemsize):
            ext = 1.0 + 2.0 * d * spec.r / max(n0, 1)
            flops += n * d * pts * (arith + reorg) * ext
            mem += n * 2.0 * pts * itemsize * ext
    flops /= total
    mem /= total
    sweeps = sum(n for _, n in chunks) / total
    return flops, mem + pallas_extra_bytes_per_step(pts, itemsize, engine, sweeps,
                                                    steps), 0.0


def _mxu_terms(spec, shape, itemsize, plan,
               steps: int | None) -> tuple[float, float, float]:
    """Per-step (matmul_flops, hbm_bytes, 0) for a ``backend="mxu"`` plan,
    the reference's: dense-GEMM flops, ``2·n_off·B`` a point a launch
    (``n_off`` from ``matrixize.operator_bytes_bound``), charged at the
    GEMM rate; one read and write of the grid a launch plus the layout
    round trip once a run."""
    from repro_torch.core import matrixize
    from repro_torch.core.api import sweep_schedule
    if plan.decomp is not None:
        raise NotImplementedError(_A9)
    pts_dev = float(np.prod(list(shape)))
    vl = plan.vl if plan.m is not None else 8
    m = plan.m if plan.m is not None else 8
    B = float(vl * m)
    chunks, total = sweep_schedule(max(plan.k, 1), steps, plan.remainder, plan.ttile)
    flops = mem = 0.0
    for depth, n in chunks:
        n_off = matrixize.operator_bytes_bound(spec, vl, m, depth) / (B * B * 4.0)
        flops += n * 2.0 * n_off * B * pts_dev
        mem += n * 2.0 * pts_dev * itemsize
    flops, mem = flops / total, mem / total
    mem += 4.0 * pts_dev * itemsize / float(steps if steps else RESIDENT_AMORT_STEPS)
    return flops, mem, 0.0


# ---------------------------------------------------------------------------
# the jnp backend: eager PyTorch passes
# ---------------------------------------------------------------------------

def _tap_passes(spec, rolled: int) -> float:
    """Grid transfers of one tap sum: ``rolled`` rolls (read + write), a
    product a tap (read + write), a sum a tap past the first (two reads, a
    write)."""
    t = len(spec.taps)
    return 2.0 * rolled + 2.0 * t + 3.0 * (t - 1)


def _fused_step(spec) -> float:
    """``apply_once``: a roll for every tap off the centre."""
    return _tap_passes(spec, sum(1 for off, _ in spec.taps if any(off)))


def _layout_step(spec) -> float:
    """``step_in_layout`` on the resident layout: the extended tile (a copy
    of the grid), then a roll for every tap off the centre on a leading
    axis."""
    return 2.0 + _tap_passes(spec, sum(1 for off, _ in spec.taps if any(off[:-1])))


def _multiload_step(spec) -> float:
    """``step_multiload``: a wrap-pad copy an axis, then slices (views)."""
    return 2.0 * spec.ndim + _tap_passes(spec, 0)


def jnp_transfers_per_step(spec, plan, steps: int | None = None) -> float:
    """Grid transfers (``numel·itemsize`` bytes each) per step of a jnp
    plan as the port runs it, eagerly: a lower bound (the assembled rows,
    the tessellation's int8 counts and boolean masks are left out)."""
    if plan.tiling == "tessellate":
        h = plan.height or plan.k
        inner = plan.scheme if plan.scheme in ("fused", "transpose", "dlt") else "fused"
        sub = _fused_step(spec) if inner == "fused" else 4.0 + _layout_step(spec)
        # (ndim + 1)·H sub-steps a round of H steps: a whole inner step and
        # a masked select (cand, buffer in; buffer out) each
        rounds, singles = _tessellate_shares(h, steps, plan.remainder)
        return rounds * (spec.ndim + 1) * (sub + 3.0) + singles * _fused_step(spec)
    if plan.k > 1:
        return _fused_step(spec)          # multistep_fused: k apply_once a block
    if plan.scheme == "multiload":
        return _multiload_step(spec)
    if plan.scheme in ("dlt", "transpose"):
        # run_scheme stays in layout for the run: one round trip a run
        return _layout_step(spec) + 4.0 / float(steps if steps else RESIDENT_AMORT_STEPS)
    return _fused_step(spec)


def _tessellate_shares(h: int, steps: int | None, remainder: str) -> tuple[float, float]:
    """Shares of a run's steps taken in tessellation rounds and as fused
    single steps (``remainder="fused"``'s leftover)."""
    if steps is None or steps % h == 0 or remainder == "native":
        return 1.0, 0.0
    rem = steps % h
    return (steps - rem) / steps, rem / steps


def _jnp_terms(spec, shape, itemsize, plan, steps):
    pts = float(np.prod(list(shape)))
    if plan.tiling == "tessellate":
        scheme = plan.scheme
    else:
        scheme = plan.scheme if plan.k == 1 else "fused"
    flops = pts * (float(spec.flops_per_point) + reorg_ops_per_point(spec, scheme, plan.vl,
                                                                     plan.m))
    if plan.tiling == "tessellate":
        rounds, singles = _tessellate_shares(plan.height or plan.k, steps, plan.remainder)
        flops *= rounds * (spec.ndim + 1) + singles
    return flops, jnp_transfers_per_step(spec, plan, steps) * pts * itemsize, 0.0


def plan_terms(spec, shape: Sequence[int], itemsize: int, plan,
               steps: int | None = None) -> tuple[float, float, float]:
    """(flops, hbm_bytes, collective_bytes) for ONE step of ``plan`` — the
    raw roofline terms :func:`estimate_plan_time` divides by the device
    constants, and what the calibrator fits throughputs from.  For
    ``backend="mxu"`` plans the flops slot carries MATMUL flops."""
    backend = plan.backend
    if backend == "distributed":
        raise NotImplementedError(_A9)
    if backend == "mxu":
        return _mxu_terms(spec, shape, itemsize, plan, steps)
    if backend == "pallas":           # the sweep engines ignore ``tiling``
        return _pallas_terms(spec, shape, itemsize, plan, steps)
    if backend != "jnp":
        raise ValueError(f"unknown backend {backend!r}")
    return _jnp_terms(spec, shape, itemsize, plan, steps)


def estimate_plan_time(spec, shape: Sequence[int], itemsize: int,
                       plan, steps: int | None = None,
                       constants=None) -> float:
    """Roofline lower bound (seconds) for ONE step of ``plan``:
    ``max(flops / peak, bytes / hbm_bw)``.  ``constants`` (duck-typed:
    ``peak_flops``, ``hbm_bw``, optionally ``peak_flops_mxu`` and
    ``peak_flops_mxu_bf16``) default to the H100 data-sheet rates; an mxu
    plan's matmul flops are charged at the GEMM rate of its element type
    (``peak_flops_mxu_bf16`` for 2-byte elements), or, where that is not
    fitted yet, at ``peak_flops / MXU_FALLBACK_PENALTY``."""
    flops, mem_bytes, _ = plan_terms(spec, shape, itemsize, plan, steps)
    constants = calibrate.STATIC if constants is None else constants
    pf = constants.peak_flops
    if plan.backend == "mxu":
        field = "peak_flops_mxu_bf16" if itemsize == 2 else "peak_flops_mxu"
        pf = getattr(constants, field, 0.0) or pf / calibrate.MXU_FALLBACK_PENALTY
    return max(flops / pf, mem_bytes / constants.hbm_bw)
