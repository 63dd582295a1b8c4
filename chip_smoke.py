#!/usr/bin/env python3
"""Drive the PyTorch port's paths on one CUDA card.

    python3 chip_smoke.py          # from the root of a checkout

Phases, one JSON line each, and any failure ends the script with a non-zero
exit code.  Every path is driven with the launch counters set to 0 just
before it and read just after; each path must launch exactly the kernels
its schedule implies (every counter is compared, so a stray launch fails
too).  Cases: 1d3p at 2**26, 2d5p at 8192**2, 3d7p at 512**3 (f32,
``init(seed)``, GPU default tile), then the same in bfloat16.

  build      builds the CUDA kernels from ``src/repro_torch/kernels/csrc``
             (one nvcc per source, started together: the register sweep
             kernels' float and bfloat16 entry points are sources of their
             own) and reports the time, and the registers, spills and stack
             per instance of K2's register kernel ``transpose_reg`` /
             ``transpose_any`` (``wide`` 1: past 2^31 sub-columns) /
             ``transpose_small`` (vl < 4) and of the warp kernels
             (K1's and K4a's ``sweep1d_warp <T, ...>``, its r > M ones
             also apart, the 2-D K3's and
             K4b's ``sweep2d_warp <T, ...>``: ``ends`` 0 the periodic K3's
             instances, 1 K4b's ring and open ones; ``vl`` 32 the instances
             of vl=32 (float32 only), 0 those of every other vl; the 3-D
             K3's and K4b's ``sweep3d <T, M, D, order, ends, vl>`` with each
             instance's threads and dynamic shared memory), with the
             instance counts by dtype (``sweep3d`` also by vl) and each
             nvcc's seconds, and of K6's ``ssd_state <T>`` and ``ssd_out
             <T, PT>`` with their dynamic shared memory (a K6 or ``sweep3d``
             instance that spills fails);
  main_path  ``StencilProblem.run(x, steps, plan)`` under two resident plans
             (k=2, ttile=2: fused 16 steps, native 7): K2 in and out, K1/K3
             per sweep; the result equals the port's plain path bit for bit;
             the counted run's seconds, and the median of five more runs;
             1d3p runs K1 on its warp kernel, 2d5p K3 on its 2-D warp
             kernel and 3d7p K3 on the 3-D streaming kernel (vl=32; counted
             as ``sweep_1d`` / ``sweep_2d`` / ``sweep_3d``); then fused 16
             again at other tiles, each equal to the vl=32 run: 1d3p and
             2d5p at the JAX package's vl=128, m=8, at its tuner's vl=8,
             m=8 (the warp kernels at any vl) and at the tuner pairs vl=8,
             m=16 and vl=16, m=32 (the warp kernels on sub-columns of 8,
             ``sweep_1d`` / ``sweep_2d``), then at an odd m at size (1d3p
             3·2^24 at vl=8, m=3; 2d5p 8192x6144 at vl=16, m=3: sub-columns
             of 1), against its plain path; 3d7p at the tuner's vl=8, m=8, the JAX
             package's vl=128, m=4 and the tuner pair vl=8, m=16 (the
             streaming kernel at any vl and m, ``sweep_3d``), each run's
             route asserted before it, K2 on its register kernel
             (``transpose``) at every tile; 2d5p and 3d7p also at the
             reference tuner's deep plans k=4, ttile=2 and 4 (depths 8 and
             16) at vl=32, m=8 and vl=8, m=8, each counted on its register
             kernel (2 or 4 consecutive depth-4 launches on the instance
             M=8 a chunk), and 2d5p at vl=32, m=2 (one launch of M=2 at
             depth 8 and of the deep M=2 instance at depth 16), bit for
             bit the vl=32 depth-4 run; then 3d27p
             at 256**3 (the box order on the
             3-D kernel), fused 16 at vl=32, m=8 and at the tuner's vl=8,
             m=8 (the any-vl instances), each on ``sweep_3d``, asserted,
             the second equal to the first;
  roundtrip  the same two runs under ``sweep="roundtrip"`` (wrap-pad, K2,
             K4, K2, crop per sweep): K4 once and K2 twice per sweep; the
             result equals the resident run at ttile 1 and 2 bit for bit;
             the counted run's seconds, and the median of five more;
             1d3p runs K4a on K1's warp kernel (``multistep_1d``), 2d5p K4b
             on the 2-D warp kernel
             (``multistep_2d``) and 3d7p on the 3-D streaming kernel
             (``multistep_3d``), the fused run also at vl=8, m=8, vl=128,
             m=4 and vl=8, m=16, each equal to the resident run;
  dirichlet  ``ops.stencil_run(spec, x, 16, k=2)`` (K2, K4 with the
             Dirichlet ring, K2 per sweep) after one uncounted 2-step run,
             bit for bit its plain path; seconds as for roundtrip; 3d7p
             also at vl=8, m=8, vl=128, m=4 and vl=8, m=16
             (``multistep_3d``), each equal to the run at the case's tile;
  onestep    ``ops.stencil_onestep_naive`` / ``stencil_onestep_transpose``
             (K5a; K2, K5b, K2) for 1d3p and 1d5p at 2**26, vl=32, m=8, and
             K5b alone for 1d3p at the odd m=3 on 3·2**24, in float32 and
             bfloat16, each counted, bit for bit the periodic step's plain
             version and within 3·taps·u·Σ|c|·max|x| of the float64
             oracle, with the form it took; then a line of the phase's
             seconds (``phase_seconds``);
  kernels    at those paths' shapes, each kernel against its plain PyTorch
             version, bit for bit, and its time beside the plain version's,
             a library call's and its bound (CUDA events, median of repeats,
             after warm-up); K1 and K3 at depths 4, 2, 1 also at vl 4, 8,
             16 and 128 (the case's m), on the warp kernels and the 3-D
             streaming kernel, and at the tuner pairs vl=8, m=16 and vl=16,
             m=32 on sub-columns of 8 (3-D: m=32 at depth 4 only; 3d7p also
             at vl=128 and vl=32, m=4); 1-D and 2-D also at the odd-m grids
             above (sub-columns of 1); 2-D and 3-D K3 at depths 8 and 16
             at vl=32, m=8 and vl=8, m=8 (2-D also at vl=32, m=2; each row
             lists its launches' instances (M, g, D)); 1d3p K1 at vl=8,
             m=1, depth 34 (past 32·M: two warp launches, 32 + 2, which
             the retired shared-memory kernel took until they existed),
             the route asserted before each launch; K4 at the case's
             tile, at vl=8, m=8 and at vl=8, m=16 (2-D, 3-D also at depth
             8); the 3d27p K3 at depth 4 at both its tiles
             (depths 2, 1 and K4b's ring and open bit for bit, untimed);
             K2 in both directions at the tile of every counted run, each
             on its register route (``transpose``, its one route), and bit
             for bit at 2- and 8-byte elements; 1d3p K2 also at tiles no
             counted run reaches: vl=256, m=8 at 2**26 and vl=96, m=8,
             vl=8, m=12 and 24 at 3·2**24 (the register kernel's run-time
             G and vl), and vl=2, m=8 (``transpose_small``); each row names
             its route and source;
             a K2 row counts the launches of the case's runs at its own
             tile, a K1 or K3 row those of its route in the case's runs
             (``launches``) and at its own tile (``launches_at_tile``);
  1d5p_odd   1d5p at 5·10^7 points (200 MB), whose picker tile is vl=32,
             m=5: sub-columns of 1, r = 2 > M = 1, a halo from two lanes a
             side on K1's warp kernel.  ``StencilProblem.run`` resident
             fused 16 and native 7, a roundtrip run (K4a open) and
             ``ops.stencil_run`` (K4a ring), each counted (``sweep_1d`` /
             ``multistep_1d`` and K2 only: no ``sweep_far.cu`` launch)
             and bit for bit the port's plain path (the roundtrip the
             resident run), emitted as ``main_path``, ``roundtrip`` and
             ``dirichlet`` lines; then K1 rows at d=4/2/1 at that tile and
             on 3·2^24 at vl=8, m=3, and K4a open and ring rows at d=2/1,
             each listing its launches (M, g, D);
  reach2     the star of reach 2 (``_star_taps(ndim, 2)``, not in the
             registry) at 2-D 8192**2 and 3-D 512**3, on the register
             kernels (the 2-D warp kernel's halo from ceil(r / M) lanes,
             the 3-D kernel's halo of depth·r rows; both the star's
             compile-time order), in float32 and bfloat16: the resident
             fused run (``ops.stencil_sweep_periodic``, k=2, ttile=2), a
             roundtrip run (``ops.stencil_run_periodic``) and a Dirichlet
             run (``ops.stencil_run``) at the picker's tile, each counted
             with no ``sweep_far.cu`` launch (``sweep_far``,
             ``multistep_far``), the resident run bit for bit the roundtrip
             and the plain path, the Dirichlet run its plain path, each
             within steps·2·taps·u·max|x| of the float64 oracle (u the
             dtype's unit roundoff); then K3 rows at vl=8, m=8 (the
             shared-memory kernel's former rows' shapes first: 2-D depths
             4, 2, 1, 3-D 2, 1, and
             the deep sweeps no one-launch instance has, 2-D 16 and 3-D 8,
             which raised before), bf16 at the first depth, and K4b open
             and ring at depths 2 and 1 on the padded grids, each bit for
             bit its plain version and listing its launches (M, g, D);
  reach5     the star of reach 5 (``_star_taps(ndim, 5)``) at 1-D 2**26,
             2-D 8192**2 and 3-D 512**3 on the far-reach kernel
             ``csrc/sweep_far.cu`` (reach > 4, or more taps than the
             register kernels hold), in float32 and bfloat16: resident
             fused 16, roundtrip and Dirichlet runs as in reach2, each
             counted on ``sweep_far`` / ``multistep_far`` and K2 alone, bit
             for bit the plain path and within the f64 oracle's rounding
             bound; then K1-far / K3-far rows at vl=8, m=8, depths 4, 2, 1
             (3-D 2 and 4 raised before this kernel; bf16 at depth 4) and
             K4a-far / K4b-far open and ring at depths 2 and 1 on the
             padded grid, each listing its launch depths; the shapes that
             raised before it: K3-far on 3-D stars of reach 6 (depths 2, 4)
             and 8 (depth 2) at 512**3, the 3-D box of reach 2 (125 taps,
             512**3) and the 2-D box of reach 5 (121 taps, 8192**2) at
             depths 1 and 2; K5a and K5b (counted, as in the onestep
             phase) on 2**26, in float32 and bfloat16, at reach 6 (m=8)
             and at 20 taps (m=16), past the register forms before their
             reach reached 16 and their taps 64, at 3 taps of reach 20
             (m=32: K5a's lane form, K5b's memory form) and of reach 40
             (m=64: both memory forms), each form asserted;
             every row bit for bit its plain version, whose time and the
             library's are one timed call after one untimed;
  small_vl   2d5p at 8192x8190, whose picker tile is vl=2, m=7: the
             resident fused run counted (K2 on ``transpose_small``, K3 on
             the 2-D warp kernel at sub-columns of 1), bit for bit its plain
             path, and its K2 rows in float32 and (uncounted) bfloat16;
  bf16       each case in bfloat16: the resident fused run, a roundtrip
             and a Dirichlet run, each counted and bit for bit the port's
             plain path (the roundtrip the resident run); K1 / K3 rows at
             depths 4, 2, 1 at the case's tile and at depth 4 at vl=64, m=8
             (a 128-byte bfloat16 layout row), K4 at depth 2 open and ring,
             each on the bfloat16 sources, bounds at 2-byte elements,
             library calls in bfloat16; and 1d5p_odd's resident fused run
             in bfloat16, counted on ``sweep_1d``, bit for bit its plain
             path, with its K1 rows at depths 4, 2, 1;
  tiles      shapes whose minor extent is no multiple of 32 (1d3p 1000,
             1d5p 96, 2d5p 64x48, 3d7p 16x8x16 and 12x8x80) at the tile the
             GPU picker chooses (vl 8 or 16, odd m): ``StencilProblem.run``
             resident (fused 16, native 7) and roundtrip, and
             ``ops.stencil_run``, each bit for bit the same call on the CPU
             (the plain versions), each run's route asserted: the register
             kernels on sub-columns of 1 (1d3p's m=5, 2d5p's m=3, 3d7p's
             m=1 and 5, 1d5p's m=3, where r = 2 > M = 1);
  small      3d7p at (16, 16, 256) resident (nb = 1 on the 3-D streaming
             kernel), and 2d5p at (64, 256) through ``ops.stencil_run``,
             each counted, on the card and on the CPU against the float64
             numpy oracle;
  schemes    the quickstart's plan table on the jnp backend at the cases'
             sizes in float32, 16 steps: each of the paper's five schemes
             (``StencilPlan(scheme=..., k=1, vl=8, m=8)``; DLT at vl=8),
             "ours + 2-step" (``StencilPlan(scheme="transpose", k=2)``,
             ``multistep_fused``) and ``plan="default"``, each counted (plain
             PyTorch: no counter moves), timed (the counted run and the
             median of 3 more, updates/s) and bit for bit the resident
             fused-16 run of the same grid, whose median is beside it;
  tessellate 2d5p 8192**2, ``tiling="tessellate"`` at heights 2 and 4, inner
             transpose, 16 steps, the same way;
  mxu        ``backend="mxu"`` (k=2, vl=8, m=8, fused 16) on the three grids
             in float32 and bfloat16: K2 twice and one product a sweep
             (``mxu``, 8), the counted run's seconds, the median of 3 more,
             peak memory, the resident run's median beside it; against the
             float64 oracle (the port's ``apply_steps`` on the card) within
             1e-4 in float32, and in bfloat16 within Σ over the sweeps of
             2·2^-8 of the sweep's largest value (the operator's
             coefficients and its result each rounded to bfloat16), times
             1 + 2^-6; then an mxu row a grid and dtype in the kernels line:
             one depth-2 sweep against two plain layout steps (1e-4 f32,
             4e-2 bf16), its GEMM alone (``matmul_ms``) beside the operations
             bound (2·rows·n_off·B² at 67 TFLOP/s FP32, or 989 bf16);
             each of these three phases ends with a line of its seconds
             (``phase_seconds``);
  auto       ``StencilProblem.run(x, 16)`` with its default plan, ``"auto"``
             (the autotuner), on 1d3p 2**26, 2d5p 8192**2 and 3d7p 512**3 in
             float32 and 2d5p 8192**2 in bfloat16, the plan cache and fitted
             constants in a private temporary directory: the first run
             tunes (every backend of the pool, jnp, pallas and mxu, has a
             timed candidate, none failed); a second run hits the cache
             (no timer call; counted: only the winner's launches); the
             result is bit for bit the explicit run of the winner, and the
             resident fused-16 run when the winner is jnp or pallas, else
             within the mxu phase's limits of the f64 oracle; the pool's
             size by backend, the measured plans with their seconds per
             step, the winner, the tuning seconds, and the 16-step median
             of 3 of the winner, of ``plan="default"`` and of the picker's
             resident run; then the fitted constants (the fitted
             ``hbm_bw`` at most 1.05 × 3.35e12) and ``phase_seconds``;
  stencil_serve  stencil serving (``serve/batcher.py``): a
             ``StencilService`` on the card whose plan cache (a private
             temporary directory) holds the picker's resident plan (k=2,
             ttile=2) for each signature; ``sweep_async`` serves 8
             requests of two tenants, fused 16 steps, as one batch of 8
             slots for each of 1d3p 2**26, 2d5p 8192**2 and 3d7p 512**3
             (f32; the 3-D batch is 2^32 bytes, its last grid starting at
             3.5 GiB: offsets past 2^31 elements are the card tests'),
             counted: K2 exactly twice (in, from the 8 requests where they
             lie through a table of their pointers; out) and each sweep
             launch once for the batch, every result
             bit for bit ``svc.sweep`` of its grid; the batched seconds
             and the batch's own run (the batcher's log) beside the 8
             sequential ``svc.sweep`` (host clock, median of 3), with the
             card's name and power limit; likewise 2d5p 256**2
             (dispatch, not bytes, sets the time), 2d5p 2048**2 in
             bfloat16, and two near-miss requests 2d5p (1024, 960) that
             bucket to (1024, 1920) by two periodic copies, cropped back
             bit for bit; ``run_batched`` of 4 grids under
             ``sweep="roundtrip"`` (K4, bitwise), ``backend="mxu"``
             (within 2e-6 f32 / 8e-3 bf16) and ``backend="jnp"``
             (bitwise), each counted against the sequential runs; a
             batch of 4 grids of the reach-5 star ``_star_taps(2, 5)``
             through ``ops.stencil_sweep_periodic``, counted on
             ``sweep_far``, bit for bit its plain version; ``kernels``
             rows for each full-width case: K2 from the 8 requests where
             they lie (``block_transpose_parts``, with ``stack_then_k2_ms``,
             the stack it replaced and K2) and the batched sweep launch
             (batch of 8, depth 4) with its plain version, a batched
             library convolution and its bound; ``phase_seconds``;
  ssd_kernel K6 (the Mamba2 SSD chunk scan) at mamba2-2.7b's layer shape
             (H=80, P=64, N=128, B and C shared by the heads through a
             stride of 0): 2048 tokens at Q=128 in bf16 and f32, 1000 at
             Q=125, 251 at Q=1 (a prime length) in bf16 and f32, 4096 at
             Q=128, and B and C per head; each against its plain version on
             the card (TF32 off) at the reference's tolerances (2e-4 f32,
             5e-2 bf16), y and the final state (2e-4 in both dtypes); its
             two kernels each alone against their own plain versions
             (``ssd_state``'s h_in at 2e-4, ``ssd_out``'s y at the dtype's
             tolerance), two calls equal bit for bit; the whole call and
             each kernel timed, bounds at the TF32 tensor-core rate (and,
             ``bound_ms_fp32``, at the float32 rate of earlier rows); the
             kernels' integer TF32 rounding equal to ``cvt.rna.tf32.f32``
             on every non-NaN float32; small shapes against the
             token-recurrence oracle; and zamba2-2.7b's layer (N=64, B
             and C shared) at the chunk lengths its serve run gives K6:
             2048 tokens at Q=128 and 1000 at Q=125 in bf16, 271 at Q=1
             in bf16 and f32; each row's launches those of the serve run
             of the model whose layer it is;
  mamba2_serve  mamba2-2.7b at full width (64 layers, random weights from
             the seed, bf16 copy of the weights) served by
             ``ContinuousBatcher(n_slots=4, max_seq=4096)``, greedy: six
             prompts of 2048, 1024, 512, 1000, 2048 and 256 tokens, 16 new
             tokens each.  Each K6 kernel (``ssd_state``, ``ssd_out``)
             launches exactly 64 times per prefill and never in decode;
             every logit is finite; two requests give the same tokens
             from fresh 1-slot engines; prefill and decode
             logits of one request match ``forward`` — the float32 model
             (``act_dtype=torch.float32``) within rtol = atol = 1e-3, the
             served bf16 model within fixed limits on the mean and the
             largest absolute difference (``BF16_CHECK``; over 64 layers
             bf16 rounding exceeds the 2-layer grain rtol 6e-2, atol 0.2,
             whose excess is reported); prefill tokens/s, decode ms per
             step, a 2048-token prefill (CUDA events), peak memory, and
             (``torch.profiler``) kernels per decode step and the device's
             idle share;
  zamba2_serve  the same for zamba2-2.7b at full width (the hybrid: 54
             Mamba2 layers, d_model 2560, N=64, and one weight-shared
             attention + GeGLU block after every 6, 32 heads of 80, a KV
             cache a super-block): the same prompts, slots and checks,
             each K6 kernel 54 times per prefill and never in decode;
  gemma2b_serve  the same for gemma-2b at full width (dense: 18 layers,
             d_model 2048, MQA 8 heads of 256, vocab 256000), prompts of
             2048, 1000 and 256 tokens, no K6 launch.  Each serving phase
             frees its model before the next.

Then the whole run's and the build's seconds (``total``), the ``kernels``
summary line, the card's name and power limit as
``nvidia-smi`` gives them, and the result line
``{"ok": true, "device": {...}}``.  Without a CUDA device it exits 1 and
prints no result.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory rate (data sheet)
FP32_FLOPS_PER_S = 67e12      # H100 SXM float32 outside the tensor cores
BF16_SIMT_FLOPS_PER_S = 133.8e12   # H100 SXM bfloat16 outside the tensor cores (white paper)
TF32_FLOPS_PER_S = 495e12     # H100 SXM TF32 on the tensor cores, dense (K6's products)
SEED = 0
CASES = (("1d3p", (1 << 26,)), ("2d5p", (8192, 8192)), ("3d7p", (512, 512, 512)))
PLANS = (("fused", 16), ("native", 7))     # (remainder, steps), k=2
K = 2
TTILE = 2                                  # the resident plans' temporal tile
DIRICHLET_STEPS = 16
# K5 at vl=32: (case, points, m, K5a too); K5b alone at the odd m = 3
ONESTEP = (("1d3p", 1 << 26, 8, True), ("1d5p", 1 << 26, 8, True), ("1d3p", 3 << 24, 3, False))
JAX_TILE = (128, 8)      # (vl, m): the JAX package's tile
JAX_TILE_3D = (128, 4)   # (vl, m): the JAX package's 3-D tile (vl·m divides 512)
TUNER_TILE = (8, 8)      # (vl, m): a tile of the reference's tuner (vl in {4, 8, 16})
# (vl, m): the tuner's pairs (vl, 2·vl), on the register kernels'
# sub-columns of 8
PAIR_TILE, PAIR_TILE_32 = (8, 16), (16, 32)
# the far-reach kernel (``csrc/sweep_far.cu``): the star of reach 5
# (``_star_taps(ndim, 5)``, beyond the register kernels') on the cases'
# grids, f32 and bf16: the counted runs, and the K1-far / K3-far rows' tile
# and depths (3-D d=2 and 4 raised before it); the shapes that raised
# before it: 3-D stars of reach 6 and 8 past depth 1, the 3-D box of reach
# 2 (125 taps) on 256³ and the 2-D box of reach 5 (121 taps) at k = 1, 2,
# K5 at reach 6 and at 20 taps
FAR_R = 5
FAR_CASES = ((1, (1 << 26,)), (2, (8192, 8192)), (3, (512, 512, 512)))
FAR_ROW_TILE, FAR_ROW_DEPTHS = (8, 8), (4, 2, 1)
FAR_C3_STARS = ((3, 6, (2, 4)), (3, 8, (2,)))          # (ndim, r, depths) on 512³
FAR_C3_BOXES = ((3, 2, (256, 256, 256)), (2, 5, (8192, 8192)))   # (ndim, r, grid), k = 1, 2
# K5's specs, their m and the forms (K5a, K5b) they must take: 13 taps of
# reach 6; 20 taps of reach 10; 3 taps at -20, 0, 20 (K5a's lane form, K5b's
# memory form) and 3 taps at 0, -40, 33 (both memory forms)
FAR_K5 = (("star1d-r6", 8, ("reg", "reg")), ("taps20", 16, ("reg", "reg")),
          ("r20-3taps", 32, ("lane", "mem")), ("far40", 64, ("mem", "mem")))
# the star of reach 2 (``_star_taps(ndim, 2)``) at 2-D and 3-D on the
# register kernels (the retired shared-memory kernel took it until they reached r = 4):
# the grids, the K3 rows' tile and depths (the former shared-memory rows' shapes
# first), the depth past every one-launch instance that no shared-memory
# tile fitted (3-D: 8, which raised), and the K4b rows' depths
REACH_R = 2
REACH_CASES = ((2, (8192, 8192)), (3, (512, 512, 512)))
REACH_ROWS = {2: ((8, 8), (4, 2, 1)), 3: ((8, 8), (2, 1))}
REACH_DEEP = {2: 16, 3: 8}
# ((vl, m), depth): 1d3p K1 at the shape the shared-memory route took until
# depth·r > 32·M became consecutive warp launches (32 + 2 at m = 1)
DEEP_1D_ROW = ((8, 1), 34)
# 1d5p at 5·10^7 points (200 MB f32), whose picker tile is vl=32, m=5:
# sub-columns of 1, r = 2 > M = 1, the warp kernel's halo of two lanes; its
# K1 rows also on ODD_CASES[1]'s grid and tile (3·2^24, vl=8, m=3)
ODD_REACH_CASE, ODD_REACH_TILE = ("1d5p", (50_000_000,)), (32, 5)
# the reference tuner's deep plans (k, ttile): depths 8 and 16 (2-D, 3-D),
# fused 16 at the case's tile and at the tuner's vl=8, m=8 (2-D also at
# vl=32, m=2: the deep instance M=2 at depth 16)
DEEP_PLANS = ((4, 2), (4, 4))
DEEP_TILES = {2: ((32, 8), (8, 8), (32, 2)), 3: ((32, 8), (8, 8))}
# (shape, (vl, m)) by ndim: an odd m at size, the register kernels on
# sub-columns of 1 (the picker's odd-m tiles at a grid of 2^26 points)
ODD_CASES = {1: ((3 << 24,), (8, 3)), 2: ((8192, 6144), (16, 3))}
# (grid, (vl, m)): 1d3p K2 at tiles no counted run reaches: vl=256 (a power
# of two above 128), vl=96 and m = 12, 24 (run-time G and vl), and vl=2
# (transpose_small, where the retired shared-memory kernel took 0.3030 ms)
K2_EXTRA = (((1 << 26,), (256, 8)), ((3 << 24,), (96, 8)), ((3 << 24,), (8, 12)),
            ((3 << 24,), (8, 24)), ((1 << 26,), (2, 8)))
# a grid on which the picker's tile has vl < 4 (vl=2, m=7): the resident
# fused run counted in float32, with its K2 rows
SMALL_VL_CASE = ("2d5p", (8192, 8190))
# bfloat16: the cases' resident fused, roundtrip and Dirichlet runs, and
# K1 / K3 rows at the case's tile and at vl=64 (a 128-byte bfloat16 row)
BF16_ROW_TILES = ((64, 8),)
# the fused resident run again at other tiles, with the route each takes
# (3-D: also the roundtrip and Dirichlet runs at these)
OTHER_TILES = {1: ((JAX_TILE, "reg"), (TUNER_TILE, "reg"), (PAIR_TILE, "reg"),
                   (PAIR_TILE_32, "reg")),
               2: ((JAX_TILE, "reg"), (TUNER_TILE, "reg"), (PAIR_TILE, "reg"),
                   (PAIR_TILE_32, "reg")),
               3: ((TUNER_TILE, "reg"), (JAX_TILE_3D, "reg"), (PAIR_TILE, "reg"))}
ROW_VLS = (4, 8, 16, 128)  # K1 and K3 rows off vl=32, at the case's m
BOX_CASE = ("3d27p", (256, 256, 256))   # the box order on the 3-D streaming kernel
# template type arguments in mangled names: unsigned short / int / long long, float, bf16
MANGLED_TYPES = {"t": "2B", "j": "4B", "y": "8B", "f": "f32", "13__nv_bfloat16": "bf16"}
# (name, shape, the route of the picker's tile: the register kernels or the
# shared-memory kernel)
TILE_CASES = (("1d3p", (1000,), "reg"), ("1d5p", (96,), "reg"), ("2d5p", (64, 48), "reg"),
              ("3d7p", (16, 8, 16), "reg"), ("3d7p", (12, 8, 80), "reg"))
SOURCES = {
    "transpose": "src/repro_torch/kernels/csrc/transpose.cu",
    "far": "src/repro_torch/kernels/csrc/sweep_far.cu",
    "sweep1d_warp": "src/repro_torch/kernels/csrc/sweep1d_warp.cu",
    "sweep2d_warp": "src/repro_torch/kernels/csrc/sweep2d_warp.cu",
    "sweep3d": "src/repro_torch/kernels/csrc/sweep3d.cu",
    "sweep1d_warp_bf16": "src/repro_torch/kernels/csrc/sweep1d_warp_bf16.cu",
    "sweep2d_warp_bf16": "src/repro_torch/kernels/csrc/sweep2d_warp_bf16.cu",
    "sweep3d_bf16": "src/repro_torch/kernels/csrc/sweep3d_bf16.cu",
    "onestep": "src/repro_torch/kernels/csrc/onestep.cu",
    "ssd": "src/repro_torch/kernels/csrc/ssd_scan.cu",
    "mxu": "src/repro_torch/core/matrixize.py",
}
_SK = "src/repro/kernels/stencil_kernels.py"
REPLACES = {
    "K1": f"{_SK}:114 (_kernel_1d via stencil1d_sweep_ttile)",
    "K1-far": f"{_SK}:114 (_kernel_1d via stencil1d_sweep_ttile)",
    "K2": f"{_SK}:567 (_kernel_transpose via block_transpose/block_untranspose)",
    "K3": f"{_SK}:339 (_kernel_nd via stencil_nd_sweep_ttile)",
    "K3-far": f"{_SK}:339 (_kernel_nd via stencil_nd_sweep_ttile)",
    "K4a-far": f"{_SK}:114 (_kernel_1d via stencil1d_multistep :174, stencil1d_sweep_halo :243)",
    "K4b-far": f"{_SK}:339 (_kernel_nd via stencil_nd_multistep :398, stencil_nd_sweep_halo "
               ":262)",
    "K4a": f"{_SK}:114 (_kernel_1d via stencil1d_multistep :174, stencil1d_sweep_halo :243)",
    "K4b": f"{_SK}:339 (_kernel_nd via stencil_nd_multistep :398, stencil_nd_sweep_halo :262)",
    "K5a": f"{_SK}:620 (_kernel_naive_1d via stencil1d_naive_onestep :634)",
    "K5b": f"{_SK}:651 (_kernel_transpose_1d via stencil1d_transpose_onestep :669)",
    "K6": "src/repro/kernels/ssd_kernel.py:33 (_kernel via ssd_chunk_scan :71)",
    "mxu": f"{_SK}:516 / :526 (stencil1d_sweep_mxu / stencil_nd_sweep_mxu: a dot_general, "
           "no Pallas kernel)",
}
# the paper's schemes (the quickstart's plan table) and the mxu engine, on
# the cases' grids: plans at vl=8, m=8 (DLT: vl=8, m = n/8), 16 steps
SCHEME_TILE = (8, 8)
SCHEME_STEPS = 16
TESS_CASE, TESS_HEIGHTS = ("2d5p", (8192, 8192)), (2, 4)
MXU_K = 2
BF16_FLOPS_PER_S = 989e12     # H100 SXM bfloat16 on the tensor cores, dense
# plan="auto", the autotuner: the cases' grids in float32 and 2d5p in
# bfloat16, 16 steps; a fitted bandwidth past this share of the card's
# memory rate means the model counts bytes the run does not move
AUTO_CASES = (("1d3p", (1 << 26,), "float32"), ("2d5p", (8192, 8192), "float32"),
              ("3d7p", (512, 512, 512), "float32"), ("2d5p", (8192, 8192), "bfloat16"))
AUTO_STEPS = 16
AUTO_HBM_SLACK = 1.05
SERVE_PROMPTS = (2048, 1024, 512, 1000, 2048, 256)    # tokens, drawn from the seed
SERVE_NEW = 16
SERVE_SLOTS, SERVE_MAX_SEQ = 4, 4096
SERVE_SINGLES = (3, 5)          # requests re-served by fresh 1-slot engines
GRAIN = (6e-2, 0.2)             # (rtol, atol): logits at bf16 grain, 2 layers
F32_CHECK = (1e-3, 1e-3)        # (rtol, atol): float32 logits, 64 layers
# bf16 logits (std about 1), 64 layers: limits on the mean and the largest
# absolute difference, set from sound runs (PERF.md §6)
BF16_CHECK = {"mean_abs": 0.15, "max_abs": 1.0}
# the serving phases: (phase, architecture, prompts, requests re-served
# alone); each at full width, random weights from the seed
SERVE_MODELS = (
    ("mamba2_serve", "mamba2-2.7b", SERVE_PROMPTS, SERVE_SINGLES),
    ("zamba2_serve", "zamba2-2.7b", SERVE_PROMPTS, SERVE_SINGLES),
    ("gemma2b_serve", "gemma-2b", (2048, 1000, 256), (1, 2)),
)
SSD_TOL = {"float32": (2e-4, 2e-4), "bfloat16": (5e-2, 5e-2)}
# stencil serving: requests a full-width batch (the batcher's largest slot
# count), its two tenants, the steps, how long the batcher's first request
# waits for the others, and the other batched checks' grids (a small grid,
# bfloat16, a near-miss shape that buckets by two copies, run_batched's
# other engines, the reach-5 star on the far-reach kernel) and batch
STENCIL_SLOTS = 8
STENCIL_TENANTS = ("tenant-a", "tenant-b")
STENCIL_STEPS = 16
STENCIL_WAIT_S = 0.05
STENCIL_SMALL = ("2d5p", (256, 256))
STENCIL_BF16 = ("2d5p", (2048, 2048))
STENCIL_BUCKET = ("2d5p", (1024, 960))
STENCIL_ENGINES = ("2d5p", (1024, 1024))
STENCIL_FAR = (2, (2048, 2048))
STENCIL_BATCH = 4


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def ptxas_kernels(report: str, kernel: str) -> list:
    """Registers, spills and stack of each instance of ``kernel`` from
    nvcc's ``-Xptxas -v`` report (template arguments as in the mangled
    name; an element type as its bytes, or f32 / bf16)."""
    rows, cur = [], None
    for line in report.splitlines():
        found = re.search(r"Function properties for (\S+)", line)
        if found:
            name = found.group(1)
            cur = None
            # the kernel's mangled identifier: its length, its name, its
            # template arguments (the anonymous namespace's name holds the
            # file's name too)
            ident = f"{len(kernel)}{kernel}I"
            if ident in name:
                rest = name.split(ident, 1)[1]
                typ = re.match(r"(13__nv_bfloat16|[tjyf])", rest)
                args = [MANGLED_TYPES[typ.group(1)]] if typ else []
                args += re.findall(r"L[ib](\d+)E", rest)
                cur = {"instance": "<" + ", ".join(args) + ">"}
                rows.append(cur)
            continue
        if cur is None:
            continue
        spill = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                          r"(\d+) bytes spill loads", line)
        if spill:
            cur.update(stack_bytes=int(spill.group(1)), spill_stores=int(spill.group(2)),
                       spill_loads=int(spill.group(3)))
        used = re.search(r"Used (\d+) registers", line)
        if used:
            cur["registers"] = int(used.group(1))
            cur = None
    return rows


def bound(nbytes: float, flops: float, rate: float = FP32_FLOPS_PER_S) -> tuple[float, str]:
    """The least ms for ``nbytes`` moved and ``flops`` done at ``rate``."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def simt_bound(nbytes: float, flops: float, itemsize: int) -> tuple[float, str]:
    """:func:`bound` at the card's peak outside the tensor cores for
    elements of ``itemsize`` bytes (4 float32, 2 bfloat16): the rate of the
    sweep kernels' products and sums."""
    return bound(nbytes, flops, FP32_FLOPS_PER_S if itemsize == 4 else BF16_SIMT_FLOPS_PER_S)


def ssd_phase(dev, ms, close, bound) -> list:
    """K6 against its plain version (and, small, the oracle), the whole call
    and each of its two kernels alone; returns the rows for the kernels
    line, launches to be filled from the serve runs."""
    import torch
    import torch.nn.functional as F

    from repro_torch.configs.base import get_arch
    from repro_torch.kernels import ssd_kernel as ssd

    mismatches = ssd.tf32_rounding_mismatches(dev)
    emit({"phase": "ssd_kernel", "check": "TF32 rounding vs cvt.rna.tf32.f32, all 2^32 "
          "float32 bit patterns but NaN", "mismatches": mismatches})
    if mismatches:
        raise AssertionError(f"K6 TF32 rounding differs from cvt.rna.tf32.f32 on {mismatches} "
                             "float32 values")

    def inputs(nc, b, q, h, p, n, dtype, shared, seed=SEED):
        g = torch.Generator(device=dev).manual_seed(seed)
        hb = 1 if shared else h
        xh = (0.5 * torch.randn(nc, b, q, h, p, generator=g, device=dev)).to(dtype)
        bm = 0.5 * torch.randn(nc, b, q, hb, n, generator=g, device=dev)
        cm = 0.5 * torch.randn(nc, b, q, hb, n, generator=g, device=dev)
        dt = F.softplus(torch.randn(nc, b, q, h, generator=g, device=dev) - 2.0)
        a_neg = -torch.linspace(1.0, 16.0, h, device=dev)
        if shared:
            bm, cm = bm.expand(nc, b, q, h, n), cm.expand(nc, b, q, h, n)
        return xh, bm, cm, dt, a_neg

    rows = []
    # (label, chunks, Q, dtype, B and C shared, the model whose layer it is);
    # zamba2's rows are the chunk lengths its serve run gives K6: a 2048-token
    # prompt, the 1000-token one, and the 256 + 15 tokens (a prime length)
    # the teacher-forced check runs forward in bf16 and f32
    m2, z2 = "mamba2-2.7b", "zamba2-2.7b"
    cases = (("2048 tokens Q=128", 16, 128, torch.bfloat16, True, m2),
             ("2048 tokens Q=128", 16, 128, torch.float32, True, m2),
             ("1000 tokens Q=125", 8, 125, torch.bfloat16, True, m2),
             ("251 tokens Q=1", 251, 1, torch.bfloat16, True, m2),
             ("2048 tokens Q=128, B and C per head", 16, 128, torch.bfloat16, False, m2),
             ("251 tokens Q=1 (a prime length)", 251, 1, torch.float32, True, m2),
             ("4096 tokens Q=128 (max_seq)", 32, 128, torch.bfloat16, True, m2),
             ("2048 tokens Q=128 (zamba2-2.7b's layer)", 16, 128, torch.bfloat16, True, z2),
             ("1000 tokens Q=125 (zamba2-2.7b's layer)", 8, 125, torch.bfloat16, True, z2),
             ("271 tokens Q=1 (zamba2-2.7b's layer)", 271, 1, torch.bfloat16, True, z2),
             ("271 tokens Q=1 (zamba2-2.7b's layer)", 271, 1, torch.float32, True, z2))
    for label, nc, q, dtype, shared, model in cases:
        cfg = get_arch(model)
        h, p, n = cfg.ssm_nheads, cfg.ssm_head_dim, cfg.ssm_state
        args = inputs(nc, 1, q, h, p, n, dtype, shared)
        xh, bm, cm, dt, a_neg = args
        y, state = ssd.ssd_chunk_scan(*args, return_state=True)
        torch.cuda.synchronize()
        y_ref, state_ref = ssd.ssd_chunk_scan_ref(*args, return_state=True)
        dname = str(dtype).split(".")[-1]
        rtol, atol = SSD_TOL[dname]
        err = close(f"K6 {label} {dtype}", y, y_ref, rtol, atol)
        err_state = close(f"K6 {label} {dtype} state", state, state_ref, *SSD_TOL["float32"])

        # each kernel alone, against its own plain version
        h_in, st_buf, y_buf = ssd.state_scratch(xh, n), torch.empty_like(state), torch.empty_like(y)
        ssd.ssd_state(xh, bm, dt, a_neg, h_in=h_in, state=st_buf)
        ssd.ssd_out(xh, bm, cm, dt, a_neg, h_in, out=y_buf)
        torch.cuda.synchronize()
        h_ref, _ = ssd.ssd_state_ref(xh, bm, dt, a_neg)
        err_h = close(f"K6 ssd_state {label} {dtype} h_in", h_in[..., :n], h_ref,
                      *SSD_TOL["float32"])
        err_out = close(f"K6 ssd_out {label} {dtype}", y_buf,
                        ssd.ssd_out_ref(xh, bm, cm, dt, a_neg, h_in), rtol, atol)
        y2, state2 = ssd.ssd_chunk_scan(*args, return_state=True)
        if not (torch.equal(y2, y) and torch.equal(state2, state)):
            raise AssertionError(f"K6 {label} {dtype}: two calls differ")
        del h_ref, y2, state2

        # bytes each input read once and each output written once; operations
        # (K6's function at the caller's Q: the causal Q×Q products over the
        # lower triangle only; each kernel: its own products over its chunks)
        tokens, nk = nc * q, ssd.n_chunks(xh)
        x_bytes = xh.numel() * xh.element_size()
        b_bytes = nc * q * n * 4 * (1 if shared else h)
        io_bytes = dt.numel() * 4 + h * 4
        nbytes = 2 * x_bytes + 2 * b_bytes + io_bytes + state.numel() * 4
        flops = (q * (q + 1) * (n + p) + 4 * q * n * p) * h * nc
        lens = [min(ssd.CHUNK, tokens - ssd.CHUNK * k) for k in range(nk)]
        state_bytes = x_bytes + b_bytes + io_bytes + h_in.numel() * 4 + state.numel() * 4
        state_flops = 2 * tokens * n * p * h
        out_bytes = 2 * x_bytes + 2 * b_bytes + io_bytes + h_in.numel() * 4
        out_flops = sum(t * (t + 1) * (n + p) + 2 * t * n * p for t in lens) * h
        timed = {
            "ssd_chunk_scan": (lambda: ssd.ssd_chunk_scan(*args, return_state=True),
                               lambda: ssd.ssd_chunk_scan_ref(*args, return_state=True),
                               nbytes, flops, err),
            "ssd_state": (lambda: ssd.ssd_state(xh, bm, dt, a_neg, h_in=h_in, state=st_buf),
                          lambda: ssd.ssd_state_ref(xh, bm, dt, a_neg),
                          state_bytes, state_flops, err_h),
            "ssd_out": (lambda: ssd.ssd_out(xh, bm, cm, dt, a_neg, h_in, out=y_buf),
                        lambda: ssd.ssd_out_ref(xh, bm, cm, dt, a_neg, h_in),
                        out_bytes, out_flops, err_out)}
        dims = f"nc={nc} B=1 Q={q} H={h} P={p} N={n} {dname}"
        line = {"phase": "ssd_kernel", "case": label, "model": model, "shape": list(xh.shape),
                "dtype": str(dtype), "head_stride_bc": bm.stride(3), "internal_chunks": nk,
                "max_abs_err": err, "max_abs_err_state": err_state,
                "max_abs_err_h_in": err_h, "max_abs_err_out": err_out,
                "rtol": rtol, "atol": atol, "two_calls_bitwise": True}
        for fname, (kern, plain, nb, fl, e) in timed.items():
            b = bound(nb, fl, TF32_FLOPS_PER_S)
            entry = {
                "name": f"K6 {fname} [{label}: {dims}, return_state; "
                        f"{'head stride 0' if shared else 'B, C per head'}]",
                "route": "cuda", "source": SOURCES["ssd"], "replaces": REPLACES["K6"],
                "launches": None, "max_abs_err": e, "ms": ms(kern), "plain_ms": ms(plain),
                "bound_ms": b[0], "bound_by": b[1],
                "bound_ms_fp32": bound(nb, fl)[0], "library_ms": None, "kernel": fname,
                "model": model}
            rows.append(entry)
            line[fname] = {"ms": entry["ms"], "plain_ms": entry["plain_ms"], "bytes": nb,
                           "flops": fl, "bound_ms": b[0], "bound_by": b[1]}
        emit(line)
        del args, xh, bm, cm, dt, y, state, y_ref, state_ref, h_in, st_buf, y_buf, timed

    # small shapes against the token recurrence, f32
    for shape in ((4, 2, 8, 2, 8, 4), (12, 1, 1, 3, 16, 8), (3, 2, 7, 8, 24, 16)):
        args = inputs(*shape, torch.float32, False, seed=1)
        y, state = ssd.ssd_chunk_scan(*args, return_state=True)
        y_o, state_o = ssd.ssd_chunk_ref(*args, return_state=True)
        emit({"phase": "ssd_kernel", "case": "vs the token recurrence", "shape": list(shape),
              "max_abs_err": close(f"K6 {shape} vs oracle", y, y_o, *SSD_TOL["float32"]),
              "max_abs_err_state": close(f"K6 {shape} state vs oracle", state, state_o,
                                         *SSD_TOL["float32"])})
    torch.cuda.empty_cache()
    return rows


def serve_phase(dev, counted, close, phase, arch, lengths, singles) -> dict:
    """``arch`` at full width served by the continuous batcher: the phase
    ``phase`` (mamba2_serve, zamba2_serve, gemma2b_serve)."""
    import numpy as np
    import torch

    from repro_torch.configs.base import get_arch
    from repro_torch.core.timing import bench
    from repro_torch.models import transformer, zoo
    from repro_torch.serve.engine import ContinuousBatcher, Request

    phase_start = time.perf_counter()
    cfg = get_arch(arch)
    model = zoo.build(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = time.perf_counter()
    params = transformer.cast_params(model.init(torch.Generator(device=dev).manual_seed(SEED)))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - start
    init_peak = torch.cuda.max_memory_allocated()
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab, length) for length in lengths]
    # K6 launches once a SSM layer and prefill, never in decode
    ssm_layers = cfg.n_layers if cfg.family in ("ssm", "hybrid") else 0
    k6 = {"ssd_state": ssm_layers * len(prompts), "ssd_out": ssm_layers * len(prompts)}

    # one short uncounted request loads the libraries and the GEMM handles
    warm = ContinuousBatcher(model, params, n_slots=1, max_seq=SERVE_MAX_SEQ)
    warm.submit(Request(rid=-1, prompt=prompts[-1][:64], max_new=2))
    warm.run()
    del warm
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    eng = ContinuousBatcher(model, params, n_slots=SERVE_SLOTS, max_seq=SERVE_MAX_SEQ)
    finite = []
    step_fn, prefill_fn = eng.step_fn, eng.prefill_fn

    def step_checked(*a):
        tok, logits, cache = step_fn(*a)
        finite.append(bool(torch.isfinite(logits).all()))
        return tok, logits, cache

    def prefill_checked(*a):
        logits, cache = prefill_fn(*a)
        finite.append(bool(torch.isfinite(logits).all()))
        return logits, cache

    eng.step_fn, eng.prefill_fn = step_checked, prefill_checked
    for rid, prompt in enumerate(prompts):
        eng.submit(Request(rid=rid, prompt=prompt, max_new=SERVE_NEW))
    done, seconds, got = counted(f"{arch} serve", lambda: eng.run(max_steps=4 * SERVE_NEW), k6)
    peak = torch.cuda.max_memory_allocated()
    done = sorted(done, key=lambda r: r.rid)
    if [r.rid for r in done] != list(range(len(prompts))) or \
            any(len(r.out) != SERVE_NEW for r in done):
        raise AssertionError(f"{arch} serve: not every request finished with its tokens")
    if not all(finite):
        raise AssertionError(f"{arch} serve: non-finite logits in {finite.count(False)} calls")
    stats, lanes = dict(eng.stats), eng.lanes
    del eng
    torch.cuda.empty_cache()

    # some of the requests again, each in a fresh 1-slot engine
    for rid in singles:
        one = ContinuousBatcher(model, params, n_slots=1, max_seq=SERVE_MAX_SEQ)
        one.submit(Request(rid=rid, prompt=prompts[rid], max_new=SERVE_NEW))
        alone = one.run(max_steps=4 * SERVE_NEW)[0].out
        if alone != done[rid].out:
            raise AssertionError(f"{arch} serve: request {rid} gives {done[rid].out} in the "
                                 f"batch and {alone} alone")
        del one
    torch.cuda.empty_cache()

    # prefill + decode logits of the last request against forward: the
    # float32 model (float32 weights and activations) within F32_CHECK, the
    # served bf16 model within BF16_CHECK
    rid = len(prompts) - 1
    s0 = len(prompts[rid])
    seq = torch.as_tensor(np.concatenate([prompts[rid], done[rid].out[:-1]]),
                          device=dev)[None]
    bf16 = teacher_forced(model, params, seq, s0)
    masters = model.init(torch.Generator(device=dev).manual_seed(SEED))
    f32 = teacher_forced(zoo.build(cfg, act_dtype=torch.float32), masters, seq, s0)
    del masters
    torch.cuda.empty_cache()
    f32_errs = [close(f"{arch} float32 {what} vs forward", got, want, *F32_CHECK)
                for what, got, want in f32["pairs"]]
    served = torch.stack([g.float() for _, g, _ in bf16["pairs"]])
    ref = torch.stack([w.float() for _, _, w in bf16["pairs"]])
    if not bool(torch.isfinite(served).all()):
        raise AssertionError(f"{arch} bf16 prefill/decode: non-finite logits")
    diff = (served - ref).abs()
    bf16_err = {"mean_abs": diff.mean().item(), "max_abs": diff.max().item()}
    noise = (bf16["forward"].float() - f32["forward"].float()).abs()
    noise = {"mean_abs": noise.mean().item(), "max_abs": noise.max().item()}
    if any(bf16_err[k] > limit for k, limit in BF16_CHECK.items()):
        raise AssertionError(f"{arch} bf16 prefill/decode vs forward: {bf16_err}, over "
                             f"{BF16_CHECK} (bf16 forward vs f32 forward: {noise})")
    grain_excess = (diff - (GRAIN[1] + GRAIN[0] * ref.abs())).max().item()
    del bf16, f32, served, ref, diff

    # a 2048-token prefill alone (CUDA events)
    if len(prompts[0]) != 2048:
        raise AssertionError(f"{arch} serve: the first prompt is not 2048 tokens")
    p2048 = torch.as_tensor(prompts[0], device=dev)[None]
    prefill_ms = bench(lambda: model.prefill(params, {"tokens": p2048}, max_seq=SERVE_MAX_SEQ),
                       device=dev, warmup=1, iters=3, min_time_s=0.0) * 1e3

    # kernels per decode step and the device's idle share, under the profiler
    prof_line = profile_decode(model, params, dev, lanes)

    new_tokens = SERVE_NEW * len(prompts)
    out = {"phase": phase, "model": cfg.name, "family": cfg.family, "layers": cfg.n_layers,
           "d_model": cfg.d_model, "params": zoo.param_count(params),
           "weights_dtype": "bfloat16 copy (cast once)", "slots": SERVE_SLOTS,
           "decode_lanes": lanes, "max_seq": SERVE_MAX_SEQ,
           "prompts": list(lengths), "max_new": SERVE_NEW, "seconds": seconds,
           "init_seconds": init_s, "launches": got,
           "prefill_tokens_per_s": stats["prefill_tokens"] / stats["prefill_s"],
           "prefill_seconds": stats["prefill_s"], "prefills": stats["prefills"],
           "decode_steps": stats["decode_steps"],
           "decode_ms_per_step": stats["decode_s"] / stats["decode_steps"] * 1e3,
           "decode_tokens_per_s": new_tokens / stats["decode_s"],
           "prefill_2048_ms": prefill_ms,
           "peak_memory_bytes": peak, "init_peak_memory_bytes": init_peak,
           "singles_match": list(singles),
           "check_positions": len(f32_errs),
           "f32_prefill_decode_vs_forward_max_abs_err": max(f32_errs),
           "f32_check_rtol_atol": F32_CHECK,
           "bf16_prefill_decode_vs_forward": bf16_err, "bf16_check": BF16_CHECK,
           "bf16_forward_vs_f32_forward": noise,
           "bf16_excess_over_grain": grain_excess, "grain_rtol_atol": GRAIN,
           "all_logits_finite": True, **prof_line}
    if cfg.family == "hybrid":
        out["attention_blocks"] = cfg.n_layers // cfg.shared_attn_every
    del model, params
    torch.cuda.empty_cache()
    out["phase_seconds"] = time.perf_counter() - phase_start
    emit(out)
    return out


def teacher_forced(model, params, seq, s0) -> dict:
    """``forward`` over ``seq``, and ``prefill`` of its first ``s0`` tokens
    then ``decode_step`` over the rest; the (what, got, want) logit pairs."""
    import torch
    full, _ = model.forward(params, {"tokens": seq})
    last, cache = model.prefill(params, {"tokens": seq[:, :s0]}, max_seq=SERVE_MAX_SEQ)
    pairs = [("prefill", last[0, 0], full[0, s0 - 1])]
    for i in range(s0, seq.shape[1]):
        logits, cache = model.decode_step(params, cache, {"tokens": seq[:, i:i + 1]},
                                          torch.tensor([i], device=seq.device))
        pairs.append((f"decode {i}", logits[0, 0], full[0, i]))
    return {"forward": full[0], "pairs": pairs}


def profile_decode(model, params, dev, lanes: int, steps: int = 4) -> dict:
    """Kernels per decode step and the device's busy share of the window,
    from ``torch.profiler`` (null, with the reason, where it records no
    device activity)."""
    import torch
    from torch.autograd import DeviceType

    cache = model.init_cache(lanes, SERVE_MAX_SEQ, device=dev)
    tok = {"tokens": torch.zeros(lanes, 1, dtype=torch.int64, device=dev)}
    pos = torch.zeros(lanes, dtype=torch.int64, device=dev)
    model.decode_step(params, cache, tok, pos)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        start = time.perf_counter()
        for _ in range(steps):
            model.decode_step(params, cache, tok, pos)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - start) * 1e6
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        return {"profile": "no device events recorded", "decode_kernels_per_step": None,
                "decode_device_idle_share": None}
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    return {"profile": f"{steps} decode steps, {lanes} lanes, under torch.profiler",
            "decode_kernels_per_step": len(kernels) / steps,
            "decode_profiled_ms_per_step": wall_us / steps / 1e3,
            "decode_device_busy_ms_per_step": busy_us / steps / 1e3,
            "decode_device_idle_share": 1 - busy_us / wall_us}


def paper_phases(dev, counted, same, close, host_median, ms, row, conv_steps) -> None:
    """The ``schemes``, ``tessellate`` and ``mxu`` phases, and the mxu rows
    of the kernels line."""
    import torch

    from repro_torch.core import matrixize, stencils
    from repro_torch.core.api import StencilPlan, StencilProblem
    from repro_torch.core.vectorize import step_in_layout
    from repro_torch.kernels import stencil_kernels as sk

    steps = SCHEME_STEPS
    resident = StencilPlan(backend="pallas", sweep="resident", k=K, ttile=TTILE,
                           remainder="fused")
    vl, m = SCHEME_TILE
    table = [(s, StencilPlan(scheme=s, k=1, vl=vl, m=m))
             for s in ("multiload", "reorg", "dlt", "transpose", "fused")]
    table += [("ours + 2-step", StencilPlan(scheme="transpose", k=2)), ("default", "default")]

    def timed(label, prob, x, plan, owned):
        """A warm-up, the counted run, the median of 3 more."""
        prob.run(x, 2, plan)
        y, seconds, got = counted(label, lambda: prob.run(x, steps, plan), owned)
        return y, seconds, host_median(lambda: prob.run(x, steps, plan), runs=3), got

    def describe(plan):
        return plan if isinstance(plan, str) else {
            "scheme": plan.scheme, "k": plan.k, "vl": plan.vl, "m": plan.m,
            "tiling": plan.tiling, "height": plan.height}

    # -- schemes: the quickstart's plan table, each bit for bit the resident
    # fused-16 run; plain PyTorch, so no counter moves ---------------------
    start = time.perf_counter()
    for name, shape in CASES:
        prob = StencilProblem(name, shape)
        x = prob.init(SEED)
        prob.run(x, 2, resident)
        want = prob.run(x, steps, resident)
        res_s = host_median(lambda: prob.run(x, steps, resident), runs=3)
        for label, plan in table:
            y, seconds, median, got = timed(f"{name} {label}", prob, x, plan, {})
            same(f"schemes {name} {label} vs resident", y, want)
            del y
            emit({"phase": "schemes", "case": name, "shape": list(shape), "plan": label,
                  "spec": describe(plan), "steps": steps, "seconds": seconds,
                  "seconds_median_of_3": median, "ms": median * 1e3,
                  "gpoint_updates_per_s": x.numel() * steps / median / 1e9,
                  "resident_ms_median_of_3": res_s * 1e3, "launches": {}, "bitwise": True})
        del x, want
        torch.cuda.empty_cache()
    emit({"phase": "schemes", "phase_seconds": time.perf_counter() - start})

    # -- tessellate: 2d5p 8192^2, inner transpose, heights 2 and 4 ----------
    start = time.perf_counter()
    name, shape = TESS_CASE
    prob = StencilProblem(name, shape)
    x = prob.init(SEED)
    want = prob.run(x, steps, resident)
    for h in TESS_HEIGHTS:
        plan = StencilPlan(scheme="transpose", tiling="tessellate", height=h, vl=vl)
        y, seconds, median, got = timed(f"{name} tessellate h={h}", prob, x, plan, {})
        same(f"tessellate {name} h={h} vs resident", y, want)
        del y
        emit({"phase": "tessellate", "case": name, "shape": list(shape), "height": h,
              "tile": list(prob._default_tile(h)), "inner": "transpose", "vl": vl,
              "steps": steps, "seconds": seconds, "seconds_median_of_3": median,
              "ms": median * 1e3, "gpoint_updates_per_s": x.numel() * steps / median / 1e9,
              "launches": {}, "bitwise": True})
    del x, want
    torch.cuda.empty_cache()
    emit({"phase": "tessellate", "phase_seconds": time.perf_counter() - start})

    # -- mxu: k=2 at vl=8, m=8, fused 16, f32 and bf16, against the f64
    # oracle on the card; then its rows in the kernels line ----------------
    start = time.perf_counter()
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        for name, shape in CASES:
            prob = StencilProblem(name, shape, dtype=dtype)
            spec = prob.spec
            x = prob.init(SEED)
            plan = StencilPlan(backend="mxu", k=MXU_K, vl=vl, m=m, remainder="fused")
            sweeps = steps // MXU_K
            prob.run(x, 2, plan)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            y, seconds, got = counted(f"{name} {dname} mxu", lambda: prob.run(x, steps, plan),
                                      {"transpose": 2, "mxu": sweeps})
            peak = torch.cuda.max_memory_allocated()
            median = host_median(lambda: prob.run(x, steps, plan), runs=3)
            prob.run(x, 2, resident)
            res_s = host_median(lambda: prob.run(x, steps, resident), runs=3)
            # the f64 oracle, sweep by sweep, with the largest value at the
            # start of each sweep
            oracle, x_max = x.double(), []
            for _ in range(sweeps):
                x_max.append(oracle.abs().max().item())
                oracle = stencils.apply_steps(spec, oracle, MXU_K)
            if dtype == torch.float32:
                rtol = atol = 1e-4
            else:
                # a sweep rounds the operator's coefficients (all >= 0, summing
                # to 1) to bf16 and its result to bf16: each moves a point by
                # at most u = 2^-8 of the sweep's largest value, and the
                # operator carries an earlier error on without growing it;
                # (1 + 2^-6) covers the second-order terms
                rtol, atol = 0.0, (1 + 2.0 ** -6) * sum(2 * 2.0 ** -8 * v for v in x_max)
            err = close(f"mxu {name} {dname} vs the f64 oracle", y, oracle, rtol, atol)
            del y, oracle
            op = matrixize.operator(spec, vl, m, MXU_K)
            emit({"phase": "mxu", "case": name, "shape": list(shape), "dtype": dname,
                  "plan": {"k": MXU_K, "vl": vl, "m": m, "remainder": "fused"},
                  "steps": steps, "n_off": op.n_off, "seconds": seconds,
                  "seconds_median_of_3": median, "ms": median * 1e3,
                  "gpoint_updates_per_s": x.numel() * steps / median / 1e9,
                  "resident_ms_median_of_3": res_s * 1e3, "peak_bytes": peak,
                  "launches": got, "max_abs_err_vs_f64": err,
                  "limit": {"rtol": rtol, "atol": atol}, "max_abs_per_sweep": x_max})

            # the kernels line: one sweep, its matmul alone, its plain version
            t = sk.block_transpose(x, vl, m)
            sweep = sk.stencil1d_sweep_mxu if spec.ndim == 1 else sk.stencil_nd_sweep_mxu

            def plain():
                u = t
                for _ in range(MXU_K):
                    u = step_in_layout(spec, u, spec.ndim)
                return u
            tol = 1e-4 if dtype == torch.float32 else 4e-2
            err = close(f"mxu {name} {dname} sweep vs plain", sweep(spec, t, MXU_K), plain(),
                        tol, tol)
            operand, _ = matrixize.neighbourhood(op, t)
            tab = op.table_tensor(dtype, dev)

            def product():
                with matrixize.exact_products():
                    return torch.matmul(operand, tab)
            matmul_ms = ms(product)
            rows = operand.shape[0]
            item = x.element_size()
            nbytes = 2 * x.numel() * item + tab.numel() * item
            flops = 2 * rows * op.n_off * op.B * op.B
            rate = FP32_FLOPS_PER_S if dtype == torch.float32 else BF16_FLOPS_PER_S
            weight = torch.tensor(spec.coeff_array(), dtype=dtype, device=dev)[None, None]
            dims = "x".join(map(str, shape))
            row("mxu", "stencil1d_sweep_mxu" if spec.ndim == 1 else "stencil_nd_sweep_mxu",
                f"{name} {dims} {dname} vl={vl} m={m} depth={MXU_K}; n_off={op.n_off}", "mxu",
                got["mxu"], err, lambda: sweep(spec, t, MXU_K), plain, bound(nbytes, flops, rate),
                lambda: ms(conv_steps, spec, x, MXU_K, weight), matmul_ms=matmul_ms,
                matmul_bound_ms=flops / rate * 1e3, gemm=[rows, op.n_off * op.B, op.B],
                product="torch.matmul (a cuBLAS GEMM): the mxu engine has no kernel of its own",
                tolerance=tol)
            del x, t, operand, weight
            torch.cuda.empty_cache()
    emit({"phase": "mxu", "phase_seconds": time.perf_counter() - start})


def auto_phase(dev, counted, same, close, host_median, plan_counts) -> None:
    """The ``auto`` phase: ``StencilProblem.run(x, 16)`` with its default
    plan, ``"auto"``, on each of ``AUTO_CASES``, with the tuner's plan cache
    and constants in a private temporary directory."""
    import tempfile

    import torch

    from repro_torch.core import autotune, stencils
    from repro_torch.core.api import StencilPlan, StencilProblem, sweep_schedule
    from repro_torch.roofline import calibrate

    start = time.perf_counter()
    steps = AUTO_STEPS
    resident = StencilPlan(backend="pallas", sweep="resident", k=K, ttile=TTILE,
                           remainder="fused")
    real_timer = autotune._default_timer
    timer_calls = [0]

    def counting_timer(fn, plan, device=None):
        timer_calls[0] += 1
        return real_timer(fn, plan, device=device)

    def describe(plan):
        d = autotune.plan_to_dict(plan)
        return {k: d[k] for k in ("backend", "scheme", "sweep", "k", "ttile", "vl", "m", "t0",
                                  "remainder", "tiling", "height")}

    with tempfile.TemporaryDirectory(prefix="repro_torch_plans_") as tmp:
        cache_path = os.path.join(tmp, "plan_cache.json")
        env = {autotune.CACHE_ENV: cache_path,
               calibrate.CONSTANTS_ENV: os.path.join(tmp, calibrate.CONSTANTS_BASENAME)}
        saved = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        autotune._default_timer = counting_timer
        try:
            for name, shape, dname in AUTO_CASES:
                dtype = getattr(torch, dname)
                prob = StencilProblem(name, shape, dtype=dtype, device=dev)
                spec = prob.spec
                x = prob.init(SEED)
                pool = autotune.candidate_plans(spec, shape, dtype, "auto",
                                                autotune.normalize_steps(steps), device=dev)
                # the first run tunes: every backend of the pool timed, none failed
                timer_calls[0] = 0
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                y = prob.run(x, steps)
                torch.cuda.synchronize()
                tune_s = time.perf_counter() - t0
                key = autotune.plan_key(name, shape, dtype, "auto",
                                        device=autotune.device_signature(dev),
                                        steps=autotune.normalize_steps(steps))
                rec = autotune.get_cache(cache_path).get(key)
                if rec is None or rec["failed"]:
                    raise AssertionError(f"auto {name} {dname}: no record or failed candidates "
                                         f"{rec and rec['failed']}")
                timed = {m["plan"]["backend"] for m in rec["measurements"]}
                if timed != {p.backend for p in pool} or timer_calls[0] != rec["n_measured"]:
                    raise AssertionError(f"auto {name} {dname}: timed {timed} of the pool's "
                                         f"{ {p.backend for p in pool} } in {timer_calls[0]} "
                                         f"timer calls for {rec['n_measured']} measured")
                winner = autotune.plan_from_dict(rec["plan"])
                # the second run hits the cache: no timer call, only the winner's launches
                timer_calls[0] = 0
                y2, cached_s, got = counted(f"auto {name} {dname} cached",
                                            lambda: prob.run(x, steps),
                                            plan_counts(spec, winner, steps))
                if timer_calls[0]:
                    raise AssertionError(f"auto {name} {dname}: the cached run measured")
                same(f"auto {name} {dname} cached vs tuned", y2, y)
                del y2
                same(f"auto {name} {dname} vs the explicit winner", prob.run(x, steps, winner), y)
                if winner.backend in ("jnp", "pallas"):
                    check = {"bitwise_resident": True}
                    same(f"auto {name} {dname} vs resident fused 16", y,
                         prob.run(x, steps, resident))
                else:
                    # the mxu phase's limits against the f64 oracle, launch by launch
                    oracle, x_max = x.double(), []
                    for depth, n in sweep_schedule(winner.k, steps, winner.remainder,
                                                   winner.ttile)[0]:
                        for _ in range(n):
                            x_max.append(oracle.abs().max().item())
                            oracle = stencils.apply_steps(spec, oracle, depth)
                    if dtype == torch.float32:
                        rtol = atol = 1e-4
                    else:
                        rtol, atol = 0.0, (1 + 2.0 ** -6) * sum(2 * 2.0 ** -8 * v for v in x_max)
                    check = {"max_abs_err_vs_f64": close(f"auto {name} {dname} vs the f64 oracle",
                                                         y, oracle, rtol, atol),
                             "limit": {"rtol": rtol, "atol": atol}}
                    del oracle
                del y
                winner_s = host_median(lambda: prob.run(x, steps, winner), runs=3)
                default_s = host_median(lambda: prob.run(x, steps, "default"), runs=3)
                prob.run(x, 2, resident)
                resident_s = host_median(lambda: prob.run(x, steps, resident), runs=3)
                by_backend = {}
                for p in pool:
                    by_backend[p.backend] = by_backend.get(p.backend, 0) + 1
                emit({"phase": "auto", "case": name, "shape": list(shape), "dtype": dname,
                      "steps": steps, "key": key, "candidates": rec["n_candidates"],
                      "candidates_by_backend": by_backend,
                      "measured": [{"plan": describe(autotune.plan_from_dict(m["plan"])),
                                    "seconds_per_step": m["seconds_per_step"]}
                                   for m in rec["measurements"]],
                      "failed": rec["failed"], "winner": describe(winner),
                      "winner_seconds_per_step_measured": rec["seconds_per_step"],
                      "tuning_seconds": tune_s, "timer_calls": rec["n_measured"],
                      "cached_run_seconds": cached_s, "cached_run_timer_calls": 0,
                      "launches_cached_run": {k: n for k, n in got.items() if n},
                      "winner_ms_median_of_3": winner_s * 1e3,
                      "default_ms_median_of_3": default_s * 1e3,
                      "resident_ms_median_of_3": resident_s * 1e3,
                      "winner_over_resident": winner_s / resident_s, **check})
                del x
                torch.cuda.empty_cache()
            kind = autotune.device_kind(dev)
            fitted = calibrate._load_devices(calibrate.constants_path(cache_path)).get(kind, {})
            served = calibrate.load_constants(device=kind, cache_path=cache_path)
            emit({"phase": "auto", "fitted_constants": fitted, "device_kind": kind,
                  "served_constants": {"source": served.source, "peak_flops": served.peak_flops,
                                       "hbm_bw": served.hbm_bw,
                                       "peak_flops_mxu": served.peak_flops_mxu,
                                       "peak_flops_mxu_bf16": served.peak_flops_mxu_bf16},
                  "static_constants": {"peak_flops": calibrate.PEAK_FLOPS,
                                       "hbm_bw": calibrate.HBM_BW,
                                       "peak_flops_mxu": calibrate.PEAK_FLOPS_MXU,
                                       "peak_flops_mxu_bf16": calibrate.PEAK_FLOPS_MXU_BF16},
                  "min_bandwidth_working_set": calibrate.min_bandwidth_working_set(dev)})
            if not fitted.get("hbm_bw") or fitted["hbm_bw"] > AUTO_HBM_SLACK * HBM_BYTES_PER_S:
                raise AssertionError(f"fitted hbm_bw {fitted.get('hbm_bw')} is not within "
                                     f"{AUTO_HBM_SLACK} x {HBM_BYTES_PER_S}")
        finally:
            autotune._default_timer = real_timer
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
    emit({"phase": "auto", "phase_seconds": time.perf_counter() - start})


def stencil_serve_phase(dev, gpu, counted, same, close, host_median, row, ms, ms_slow,
                        resident_counts, k4_counts, resident_plain) -> None:
    """The ``stencil_serve`` phase: the port's stencil serving on the card
    (``StencilService.sweep_async`` and ``StencilProblem.run_batched``)."""
    import tempfile

    import torch
    import torch.nn.functional as F

    from repro_torch.core import autotune, stencils
    from repro_torch.core.api import StencilPlan, StencilProblem, sweep_schedule
    from repro_torch.kernels import ops
    from repro_torch.kernels import stencil_kernels as sk
    from repro_torch.serve.batcher import bucket_shape
    from repro_torch.serve.engine import StencilService

    start = time.perf_counter()
    steps = STENCIL_STEPS
    resident = StencilPlan(backend="pallas", sweep="resident", k=K, ttile=TTILE)

    def grids(shape, dtype, n, seed):
        gen = torch.Generator(device=dev).manual_seed(seed)
        return [torch.randn(shape, generator=gen, device=dev).to(dtype) for _ in range(n)]

    def conv_batch(spec, xb, depth, weight):
        """``depth`` library convolutions of the batch (N = B), circular."""
        conv = (F.conv1d, F.conv2d, F.conv3d)[spec.ndim - 1]
        v = xb[:, None]
        for _ in range(depth):
            v = conv(F.pad(v, (spec.r,) * (2 * spec.ndim), mode="circular"), weight)
        return v[:, 0]

    with tempfile.TemporaryDirectory(prefix="repro_torch_serve_") as tmp:
        cache_path = os.path.join(tmp, "plan_cache.json")
        cache = autotune.PlanCache(cache_path)
        signatures = [(n, sh, torch.float32) for n, sh in CASES + (STENCIL_SMALL,)] + [
            STENCIL_BF16 + (torch.bfloat16,),
            STENCIL_BUCKET + (torch.float32,),
            (STENCIL_BUCKET[0], bucket_shape(STENCIL_BUCKET[1])[0], torch.float32)]
        for name, shape, dtype in signatures:
            cache.put(autotune.plan_key(name, shape, dtype, "auto",
                                        device=autotune.device_signature(dev),
                                        steps=autotune.normalize_steps(steps)),
                      {"plan": autotune.plan_to_dict(resident), "seconds_per_step": 0.0})
        cache.save()
        with StencilService(cache_path=cache_path) as svc:
            def served(what, name, xs, owned):
                """The requests ``xs`` through ``sweep_async``, tenants in
                turn, as one counted batch; (results, seconds, launches)."""
                def go():
                    futs = [svc.sweep_async(name, x, steps, tenant=STENCIL_TENANTS[i % 2],
                                            max_wait_s=STENCIL_WAIT_S)
                            for i, x in enumerate(xs)]
                    return [f.result(timeout=600) for f in futs]
                ys, seconds, got = counted(what, go, owned)
                log = svc._batcher.stats["batch_log"][-1]
                if log["n"] != len(xs) or log["slots"] < len(xs) or \
                        sorted(set(log["tenants"])) != sorted(STENCIL_TENANTS[:len(xs)]):
                    raise AssertionError(f"{what}: not one batch of {len(xs)}: {log}")
                return ys, seconds, got, log, go

            def compare(what, name, xs, ys, go, label, extra=None):
                """Each result bit for bit ``svc.sweep``; the batched and the
                sequential host-clock median of 3, and the batch's own run
                as the batcher logs it (its worker's run and synchronize:
                the batched time less it is the queue's thread hand-off);
                one phase line."""
                for i, (x, y) in enumerate(zip(xs, ys)):
                    same(f"{what} request {i} vs svc.sweep", y, svc.sweep(name, x, steps))
                batched_s = host_median(go, runs=3)
                run_s = sorted(b["wall_s"] for b in svc._batcher.stats["batch_log"][-3:])[1]
                sequential_s = host_median(lambda: [svc.sweep(name, x, steps) for x in xs],
                                           runs=3)
                emit({"phase": "stencil_serve", "case": label, "stencil": name,
                      "shape": list(xs[0].shape), "dtype": str(xs[0].dtype)[6:],
                      "requests": len(xs), "steps": steps, "bitwise_vs_sweep": True,
                      "batched_ms_median_of_3": batched_s * 1e3,
                      "batch_run_ms_median_of_3": run_s * 1e3,
                      f"sequential_{len(xs)}_ms_median_of_3": sequential_s * 1e3,
                      "sequential_over_batched": sequential_s / batched_s, "gpu": gpu,
                      **(extra or {})})

            # -- full width: 8 requests a case, one batch of 8 slots ------
            for name, shape in CASES:
                spec = stencils.make(name)
                vl, m, t0 = ops.pick_tile(spec, shape)
                owned = resident_counts(spec, steps, "fused", vl, m)
                xs = grids(shape, torch.float32, STENCIL_SLOTS, SEED)
                what = f"stencil_serve {name} batch of {STENCIL_SLOTS}"
                if svc.plan_for(name, shape, steps=steps) != resident:
                    raise AssertionError(f"{what}: the service does not serve the resident plan")
                ys, seconds, got, log, go = served(what, name, xs, owned)
                compare(what, name, xs, ys, go, "full_width", {
                    "tile": {"vl": vl, "m": m, "t0": t0}, "launches": got,
                    "counted_seconds": seconds, "batch": {k: log[k] for k in ("n", "slots",
                                                                             "tenants")},
                    "batch_bytes": STENCIL_SLOTS * xs[0].numel() * 4})
                del ys
                # K2 from the 8 requests where they lie, as the served run
                # took them, and the batched sweep launch of the resident
                # chunk as kernels rows
                xb = torch.stack(xs)
                dims = "x".join(map(str, shape))
                err = same(f"{what} K2 from the requests vs its plain version",
                           sk.block_transpose_parts(xs, vl, m), sk.block_transpose_ref(xb, vl, m))
                row("K2", "block_transpose_parts",
                    f"{name} {dims} batch of {STENCIL_SLOTS} requests where they lie vl={vl} "
                    f"m={m}; one launch, a table of their pointers", "transpose",
                    got["transpose"], err, lambda: sk.block_transpose_parts(xs, vl, m),
                    lambda: sk.block_transpose_ref(torch.stack(xs), vl, m),
                    bound(2 * xb.numel() * 4, 0), None,
                    stack_then_k2_ms=ms(lambda: sk.block_transpose(torch.stack(xs), vl, m)))
                del xs
                tb = sk.block_transpose(xb, vl, m)
                buf = torch.empty_like(tb)
                depth = K * TTILE
                if spec.ndim == 1:
                    def kern():
                        return sk.stencil1d_sweep_ttile(spec, tb, K, TTILE, out=buf)

                    def plain():
                        return sk.stencil1d_sweep_ttile_ref(spec, tb, K, TTILE)
                else:
                    def kern():
                        return sk.stencil_nd_sweep_ttile(spec, tb, K, TTILE, t0, out=buf)

                    def plain():
                        return sk.stencil_nd_sweep_ttile_ref(spec, tb, K, TTILE, t0)
                err = same(f"{what} batched sweep vs its plain version", kern(), plain())
                key = sk.sweep_plan(spec, vl, m, depth)[0]
                weight = torch.tensor(spec.coeff_array(), dtype=torch.float32,
                                      device=dev)[None, None]
                row("K1" if spec.ndim == 1 else "K3",
                    "stencil1d_sweep_ttile" if spec.ndim == 1 else "stencil_nd_sweep_ttile",
                    f"{name} {'x'.join(map(str, shape))} batch of {STENCIL_SLOTS} vl={vl} "
                    f"m={m} depth={depth}; one launch, the batch along gridDim.y",
                    {"1d": "sweep1d_warp", "2d": "sweep2d_warp", "3d": "sweep3d"}[key],
                    got[f"sweep_{key}"], err, kern, plain,
                    bound(2 * xb.numel() * 4, depth * spec.flops_per_point * xb.numel()),
                    lambda: ms_slow(conv_batch, spec, xb, depth, weight), slow=True,
                    batch=STENCIL_SLOTS)
                del xb, tb, buf, weight
                torch.cuda.empty_cache()

            # -- a small grid, where dispatch sets the time; bfloat16 -----
            for (name, shape), dtype, label in ((STENCIL_SMALL, torch.float32, "small_grid"),
                                                (STENCIL_BF16, torch.bfloat16, "bf16")):
                spec = stencils.make(name)
                vl, m, _ = ops.pick_tile(spec, shape)
                xs = grids(shape, dtype, STENCIL_SLOTS, SEED + 1)
                what = f"stencil_serve {name} {shape} {label} batch of {STENCIL_SLOTS}"
                ys, _, got, _, go = served(what, name, xs, resident_counts(
                    spec, steps, "fused", vl, m, itemsize=xs[0].element_size()))
                compare(what, name, xs, ys, go, label, {"tile": {"vl": vl, "m": m},
                                                        "launches": got})
                del xs, ys

            # -- a near-miss shape: two periodic copies, cropped back ------
            name, shape = STENCIL_BUCKET
            spec = stencils.make(name)
            bshape, reps = bucket_shape(shape)
            vl, m, _ = ops.pick_tile(spec, bshape)
            xs = grids(shape, torch.float32, 2, SEED + 2)
            what = f"stencil_serve {name} {shape} bucketed to {bshape}"
            before = svc._batcher.stats.get("bucketed", 0)
            ys, _, got, log, go = served(what, name, xs, resident_counts(spec, steps, "fused",
                                                                         vl, m))
            if log["sig"][1] != bshape or reps != 2 or \
                    svc._batcher.stats["bucketed"] - before != 2:
                raise AssertionError(f"{what}: not bucketed by 2 copies: {log}")
            compare(what, name, xs, ys, go, "bucketed", {
                "bucket": list(bshape), "copies": reps, "tile": {"vl": vl, "m": m},
                "launches": got, "batched_ms_includes_admission_window_s": STENCIL_WAIT_S})
            del xs, ys

        # -- run_batched on the other engines, against sequential runs -----
        name, shape = STENCIL_ENGINES
        spec = stencils.make(name)
        for dtype in (torch.float32, torch.bfloat16):
            prob = StencilProblem(name, shape, dtype=dtype)
            xb = torch.stack(grids(shape, dtype, STENCIL_BATCH, SEED + 3))
            plans = [("mxu", StencilPlan(backend="mxu", k=K, vl=8, m=8))]
            if dtype == torch.float32:
                plans = [("roundtrip", StencilPlan(backend="pallas", sweep="roundtrip", k=K)),
                         ("jnp", StencilPlan(scheme="transpose", k=K, vl=8, m=8))] + plans
            for label, plan in plans:
                what = f"stencil_serve run_batched {label} {name} {shape} {str(dtype)[6:]}"
                if label == "roundtrip":
                    vl, m, _ = ops.pick_tile(spec, shape)
                    owned = k4_counts(spec, sweep_schedule(K, steps, "fused", 1)[0], vl, m)
                elif label == "mxu":
                    owned = {"transpose": 2, "mxu": sum(
                        n for _, n in sweep_schedule(K, steps, plan.remainder, 1)[0])}
                else:
                    owned = {}
                yb, seconds, got = counted(what, lambda: prob.run_batched(xb, steps, plan),
                                           owned)
                errs = []
                for i in range(STENCIL_BATCH):
                    one = prob.run(xb[i], steps, plan)
                    if label == "mxu":
                        tol = 2e-6 if dtype == torch.float32 else 8e-3
                        errs.append(close(f"{what} grid {i}", yb[i], one, tol, tol))
                    else:
                        errs.append(same(f"{what} grid {i}", yb[i], one))
                batched_s = host_median(lambda: prob.run_batched(xb, steps, plan), runs=3)
                sequential_s = host_median(
                    lambda: [prob.run(xb[i], steps, plan) for i in range(STENCIL_BATCH)], runs=3)
                emit({"phase": "stencil_serve", "case": f"run_batched {label}", "stencil": name,
                      "shape": list(shape), "dtype": str(dtype)[6:], "batch": STENCIL_BATCH,
                      "steps": steps, "launches": got, "max_abs_err_vs_sequential": max(errs),
                      "bitwise_vs_sequential": label != "mxu",
                      "batched_ms_median_of_3": batched_s * 1e3,
                      f"sequential_{STENCIL_BATCH}_ms_median_of_3": sequential_s * 1e3,
                      "gpu": gpu})
                del yb
            del xb

        # -- the reach-5 star on the far-reach kernel, a batch of 4 --------
        nd, shape = STENCIL_FAR
        spec = stencils.StencilSpec(f"star{nd}d-r{FAR_R}", nd, FAR_R, "star",
                                    stencils._star_taps(nd, FAR_R))
        vl, m, t0 = ops.pick_tile(spec, shape, 8, 8)
        xb = torch.stack(grids(shape, torch.float32, STENCIL_BATCH, SEED + 4))
        what = f"stencil_serve {spec.name} {shape} batch of {STENCIL_BATCH} on sweep_far"
        owned = resident_counts(spec, steps, "fused", vl, m)
        if set(owned) != {"transpose", "sweep_far"}:
            raise AssertionError(f"{what}: off the far-reach route {owned}")
        yb, seconds, got = counted(what, lambda: ops.stencil_sweep_periodic(
            spec, xb, steps, k=K, vl=vl, m=m, ttile=TTILE), owned)
        err = same(what, yb, resident_plain(spec, xb, steps, "fused", vl, m, t0))
        for i in range(STENCIL_BATCH):
            same(f"{what} grid {i}", yb[i], ops.stencil_sweep_periodic(
                spec, xb[i], steps, k=K, vl=vl, m=m, ttile=TTILE))
        emit({"phase": "stencil_serve", "case": "far_reach", "stencil": spec.name,
              "shape": list(shape), "batch": STENCIL_BATCH, "steps": steps, "launches": got,
              "counted_seconds": seconds, "max_abs_err_vs_plain": err, "bitwise": True,
              "gpu": gpu})
        del xb, yb
        torch.cuda.empty_cache()
    emit({"phase": "stencil_serve", "phase_seconds": time.perf_counter() - start})


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import numpy as np
    import torch.nn.functional as F

    from repro_torch.core import stencils
    from repro_torch.core.api import StencilPlan, StencilProblem, sweep_schedule
    from repro_torch.core.stencils import apply_steps
    from repro_torch.core.timing import bench
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import ref as kref
    from repro_torch.kernels import ssd_kernel as ssd
    from repro_torch.kernels import stencil_kernels as sk

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gpu = gpu_line()
    run_start = time.perf_counter()

    # -- build ------------------------------------------------------------
    t0 = time.perf_counter()
    reports = build.build_all()
    build_s = time.perf_counter() - t0
    warp1d = {dt: ptxas_kernels(build.report(f"sweep1d_warp{sfx}"), "sweep1d_warp")
              for dt, sfx in (("f32", ""), ("bf16", "_bf16"))}
    warp2d = {dt: ptxas_kernels(build.report(f"sweep2d_warp{sfx}"), "sweep2d_warp")
              for dt, sfx in (("f32", ""), ("bf16", "_bf16"))}
    sweep3d = ptxas_kernels(build.report("sweep3d"), "sweep3d") + \
        ptxas_kernels(build.report("sweep3d_bf16"), "sweep3d")
    lib3d = build.load("sweep3d")
    for entry in sweep3d:
        m3, d3, r3, order3, _, _ = map(int, entry["instance"][1:-1].split(", ")[1:])
        entry["smem_bytes"] = lib3d.repro_sweep3d_tile(m3, r3, d3, order3, 3)
        entry["threads"] = lib3d.repro_sweep3d_tile(m3, r3, d3, order3, 2)
    # r = 1: m x depth x order x ends x (f32: vl = 32's instances and any
    # vl's; bf16: any vl's); r > 1: (m, r) x depth x ends x (f32, bf16), any
    # vl only, the run-time order and at r = 2 the star's
    want3d = sum(sk.SWEEP3D_DEPTH[mm, 1] for mm in sk.SUB_M) * 3 * 2 * 3 + sum(
        d * (2 if r == 2 else 1) for (mm, r), d in sk.SWEEP3D_DEPTH.items() if r > 1) * 2 * 2
    if len(sweep3d) != want3d or any(row.get("spill_stores", 1) or row.get("spill_loads", 1)
                                     or row.get("stack_bytes", 1) for row in sweep3d):
        raise AssertionError(f"sweep3d build: spills, stack or not {want3d} instances {sweep3d}")
    # the 2-D instances of r > 1 keep depth·(2r + 1)·M window values a lane:
    # their depths are chosen so that no float32 periodic one spills
    spilled2d = [row for row in warp2d["f32"] if int(row["instance"][1:-1].split(", ")[2]) > 1
                 and row["instance"].split(", ")[5] == "0"
                 and (row.get("spill_stores", 1) or row.get("spill_loads", 1))]
    if spilled2d:
        raise AssertionError(f"sweep2d_warp build: float32 periodic r > 1 instances spill "
                             f"{spilled2d}")
    ssd_lib = build.load("ssd_scan")
    k6_ptxas = {f"{kern} <T{', PT' if kern == 'ssd_out' else ''}>":
                ptxas_kernels(build.report("ssd_scan"), kern) for kern in ("ssd_state", "ssd_out")}
    spilled = [row for rows in k6_ptxas.values() for row in rows
               if row.get("spill_stores", 1) or row.get("spill_loads", 1)]
    if spilled or not all(k6_ptxas.values()):
        raise AssertionError(f"K6 build: spills or missing instances {k6_ptxas}")
    emit({"phase": "build", "seconds": build_s, "gpu": gpu,
          "nvcc_seconds": build.SECONDS,
          "dir": str(build.build_dir().relative_to(ROOT)),
          "ptxas": {n: [ln.strip() for ln in r.splitlines() if "Used" in ln]
                    for n, r in reports.items()},
          "transpose_reg <T, M, G, vec, to_layout>": ptxas_kernels(
              build.report("transpose"), "transpose_reg"),
          "transpose_any <T, M, vec, to_layout, wide>": ptxas_kernels(
              build.report("transpose"), "transpose_any"),
          "transpose_small <T, vl, M, natural vec, layout vec, to_layout>": ptxas_kernels(
              build.report("transpose"), "transpose_small"),
          "sweep1d_warp instances": {dt: len(rows) for dt, rows in warp1d.items()},
          "sweep1d_warp r > M <T, M, R, B, order, edge, vl>": {
              dt: [row for row in rows if int(row["instance"][1:-1].split(", ")[2]) >
                   int(row["instance"][1:-1].split(", ")[1])] for dt, rows in warp1d.items()},
          "sweep1d_warp <T, M, R, B, order, edge, vl> (vl 0: any)": warp1d,
          "sweep2d_warp instances": {dt: len(rows) for dt, rows in warp2d.items()},
          "sweep2d_warp <T, M, R, D, order, ends, vl> (vl 0: any)": warp2d,
          "sweep3d instances": {f"{dt} vl {v}": sum(row["instance"].startswith(f"<{dt}")
                                                    and row["instance"].endswith(f", {v}>")
                                                    for row in sweep3d)
                                for dt in ("f32", "bf16") for v in (32, 0)},
          "sweep2d_warp r > 1 <T, M, R, D, order, ends, vl>": {
              dt: [row for row in rows if int(row["instance"][1:-1].split(", ")[2]) > 1]
              for dt, rows in warp2d.items()},
          "sweep3d <T, M, D, R, order, ends, vl> (order 0 run time, 1 star, 2 box; vl 0: any)":
              sweep3d,
          "sweep_far <T, edge> (edge 0 periodic, 1 ring, 2 open)": ptxas_kernels(
              build.report("sweep_far"), "sweep_far"),
          "onestep_naive <T, R>": ptxas_kernels(build.report("onestep"), "onestep_naive"),
          "onestep_naive_lane <T>": ptxas_kernels(build.report("onestep"), "onestep_naive_lane"),
          "onestep_transpose <T, E, R, P>": ptxas_kernels(build.report("onestep"),
                                                          "onestep_transpose"),
          **k6_ptxas,
          "ssd dynamic shared memory bytes at P=64, N=128": {
              f"{kern} {dtype}": ssd_lib.repro_ssd_smem_bytes(i, dtype == "bf16", 64, 128)
              for i, kern in enumerate(("ssd_state", "ssd_out")) for dtype in ("f32", "bf16")}})

    def ms(fn, *args):
        return bench(fn, *args, device=dev, warmup=1, iters=5, min_time_s=0.1) * 1e3

    def counted(what, fn, owned):
        """Run ``fn`` with every counter at 0 before; the counters after
        must be exactly ``owned`` (all others 0).  Returns (result,
        seconds, counters)."""
        sk.reset_launches()
        ssd.reset_launches()
        torch.cuda.synchronize()
        start = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        got = {**sk.LAUNCHES, **ssd.LAUNCHES}
        want = dict.fromkeys(got, 0) | owned
        if got != want:
            raise AssertionError(f"{what}: launches {got}, the schedule says {want}")
        return out, seconds, got

    def host_median(fn, runs=5):
        """Median host-clock seconds of ``runs`` further runs of ``fn``, each
        between two synchronizes (one run alone is at the mercy of the
        shared host)."""
        times = []
        for _ in range(runs):
            torch.cuda.synchronize()
            start = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - start)
        return float(np.median(times))

    def same(what, got, want):
        if got.shape != want.shape or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{what}: bad output")
        err = (got.double() - want.double()).abs().max().item()
        if not torch.equal(got, want):
            raise AssertionError(f"{what}: differs from its reference by {err}")
        return err

    def close(what, got, want, rtol, atol):
        """``got`` within ``atol + rtol·|want|`` of ``want``; the max error."""
        got, want = got.float(), want.float()
        if got.shape != want.shape or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{what}: bad output")
        diff = (got - want).abs()
        excess = (diff - (atol + rtol * want.abs())).max().item()
        if excess > 0:
            raise AssertionError(f"{what}: off its reference by {excess} beyond "
                                 f"rtol={rtol}, atol={atol}")
        return diff.max().item()

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

    def k2_key(vl, m):
        """K2's counter: its one route, the register kernel, at every tile."""
        if sk.transpose_route(vl, m, 4) != "reg":
            raise AssertionError(f"K2 at vl={vl}, m={m} is off its register route")
        return "transpose"

    def on_far(spec, vl, m, depth):
        """Whether a depth-``depth`` sweep of ``spec`` at (vl, m) takes the
        far-reach kernel (``csrc/sweep_far.cu``)."""
        return sk.sweep_plan(spec, vl, m, depth)[0] == "far"

    def launches_at(spec, m, depth, itemsize=4, vl=8):
        """The launches (M, g, D) of a depth-``depth`` sweep of ``spec`` at
        ``m`` on its route (``sweep_plan``)."""
        return sk.sweep_plan(spec, vl, m, depth, itemsize)[1]

    def launches_of(spec, vl, m, depth, kind="sweep", itemsize=4):
        """The counter and the launches of one depth-``depth`` call of K1/K3
        (``kind`` sweep) or K4 (multistep) on its route."""
        key, plan = sk.sweep_plan(spec, vl, m, depth, itemsize)
        return f"{kind}_{key}", len(plan)

    def multi_key(spec, vl, m, depth):
        """K4's counter on the route a depth-``depth`` call takes."""
        return launches_of(spec, vl, m, depth, "multistep")[0]

    def k4_counts(spec, chunks, vl, m, itemsize=4):
        """The launches of roundtrip or Dirichlet sweeps, ``chunks`` of
        (depth, sweeps): K2 twice and K4's launches once per sweep, by
        route."""
        owned = {}
        for depth, n in chunks:
            key, per = launches_of(spec, vl, m, depth, "multistep", itemsize)
            for key, count in ((k2_key(vl, m), 2 * n), (key, per * n)):
                owned[key] = owned.get(key, 0) + count
        return owned

    def resident_counts(spec, steps, remainder, vl, m, k=K, ttile=TTILE, itemsize=4):
        """The launches a resident run makes, by the route of each chunk."""
        owned = {k2_key(vl, m): 2}
        for depth, n in sweep_schedule(k, steps, remainder, ttile)[0]:
            key, per = launches_of(spec, vl, m, depth, itemsize=itemsize)
            owned[key] = owned.get(key, 0) + per * n
        return owned

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

    def ms_slow(fn, *args):
        """One timed call after one untimed (CUDA events): the plain versions
        and library calls that take up to seconds a call."""
        return bench(fn, *args, device=dev, warmup=0, iters=1, min_time_s=0) * 1e3

    def row(kid, fname, label, src, launches, err, kern, plain, b, library, slow=False,
            **extra):
        entries.append({
            "name": f"{kid} {fname} [{label}]", "route": "cuda", "source": SOURCES[src],
            "replaces": REPLACES[kid], "launches": launches, "max_abs_err": err,
            "ms": ms(kern), "plain_ms": (ms_slow if slow else ms)(plain), "bound_ms": b[0],
            "bound_by": b[1], "library_ms": library() if library else None, **extra,
        })
        emit({"phase": "kernels", **entries[-1]})

    def k5_rows(phase, spec, n, m, dtype, naive=True, forms=None):
        """K5a (unless not ``naive``) and K5b of ``spec`` on ``n`` random
        points at vl=32 and ``m``, in ``dtype``: each entry point
        (``ops.stencil_onestep_naive``; K2, ``stencil_onestep_transpose``,
        K2) counted, bit for bit the periodic step's plain version and
        within 3·taps·u·Σ|c|·max|x| of the float64 oracle (u the dtype's
        unit roundoff: a coefficient's rounding, a product's and a sum's a
        tap, each within u of a partial sum's bound), then its row with the
        form it took (``onestep_form``; ``forms``, if given, the (K5a, K5b)
        forms it must take), its bound and the library's circular
        convolution."""
        vl = 32
        x = torch.randn((n,), generator=torch.Generator(device=dev).manual_seed(SEED),
                        device=dev).to(dtype)
        dname = str(dtype).split(".")[-1]
        want = kref.onestep_periodic_ref(spec, x)
        oracle = kref.onestep_periodic_ref(spec, x.double())
        unit = 2.0 ** -24 if dtype == torch.float32 else 2.0 ** -8
        tol = 3 * len(spec.taps) * unit * sum(abs(c) for _, c in spec.taps) * \
            x.abs().max().item()
        weight = torch.tensor(spec.coeff_array(), dtype=dtype, device=dev)[None, None]
        b = simt_bound(2 * n * x.element_size(), spec.flops_per_point * n, x.element_size())
        kinds = [("K5b", "transpose", lambda: ops.stencil_onestep_transpose(spec, x, vl, m),
                  {"onestep_transpose": 1, k2_key(vl, m): 2})]
        if naive:
            kinds.insert(0, ("K5a", "naive", lambda: ops.stencil_onestep_naive(spec, x, vl),
                             {"onestep_naive": 1}))
        for kid, kind, fn, owned in kinds:
            form = sk.onestep_form(kind, spec, dtype)
            if forms and form != forms[kind == "transpose"]:
                raise AssertionError(f"{kid} {spec.name} takes the {form} form, not "
                                     f"{forms[kind == 'transpose']}")
            fn()                                  # uncounted: loads the kernels
            what = f"{phase} {spec.name} {n} {dname} onestep {kind} m={m}"
            y, seconds, got = counted(what, fn, owned)
            err = same(what, y, want)
            oracle_err = (y.double() - oracle).abs().max().item()
            if oracle_err > tol:
                raise AssertionError(f"{what}: {oracle_err} off the float64 oracle, beyond {tol}")
            emit({"phase": phase, "case": spec.name, "kernel": kid, "shape": [n],
                  "dtype": dname, "vl": vl, "m": m, "form": form, "taps": len(spec.taps),
                  "seconds": seconds, "launches": got, "bitwise": True,
                  "max_abs_err_vs_plain": err, "max_abs_err_vs_f64": oracle_err,
                  "f64_bound": tol})
            del y
            if kind == "naive":
                out = torch.empty_like(x)
                row(kid, "stencil1d_naive_onestep", f"{spec.name} {n} {dname} vl={vl}; form "
                    f"{form}", "onestep", got["onestep_naive"], err,
                    lambda: sk.stencil1d_naive_onestep(spec, x, vl, out=out),
                    lambda: sk.stencil1d_naive_onestep_ref(spec, x, vl), b,
                    lambda: ms(conv_steps, spec, x, 1, weight))
                del out
            else:
                t = sk.block_transpose(x, vl, m)
                tout = torch.empty_like(t)
                row(kid, "stencil1d_transpose_onestep", f"{spec.name} {n} {dname} vl={vl} m={m}; "
                    f"form {form}", "onestep", got["onestep_transpose"], err,
                    lambda: sk.stencil1d_transpose_onestep(spec, t, out=tout),
                    lambda: sk.stencil1d_transpose_onestep_ref(spec, t), b,
                    lambda: ms(conv_steps, spec, x, 1, weight))
                del t, tout
        del x, want, oracle
        torch.cuda.empty_cache()

    def k2_rows(name, dims, x, vl, m, launches, grid_bytes):
        """K2's rows in both directions at the (vl, m) tile, on its register
        kernel (at vl < 4 the form ``transpose_small``); ``launches``: the
        case's counted runs at that tile, both directions."""
        route = sk.transpose_route(vl, m, x.element_size())
        kid = "K2"
        t = sk.block_transpose(x, vl, m)
        err = max(same(f"{name} transpose vl={vl} m={m}", t, sk.block_transpose_ref(x, vl, m)),
                  same(f"{name} untranspose vl={vl} m={m}", sk.block_untranspose(t, vl, m), x))
        buf_t, buf_x = torch.empty_like(t), torch.empty_like(x)
        nb_total = x.numel() // (vl * m)
        form = "transpose_small" if vl < sk.TRANSPOSE_MIN_VL else "transpose_reg/any"
        label = f"{name} {dims} {x.dtype} vl={vl} m={m}; route {route} ({form})"
        row(kid, "block_transpose", label, "transpose", launches, err,
            lambda: sk.block_transpose(x, vl, m, out=buf_t),
            lambda: sk.block_transpose_ref(x, vl, m), bound(grid_bytes, 0),
            lambda: ms(lambda: x.view(nb_total, vl, m).transpose(-1, -2).contiguous()))
        row(kid, "block_untranspose", label, "transpose", launches, err,
            lambda: sk.block_untranspose(t, vl, m, out=buf_x),
            lambda: sk.block_untranspose_ref(t, vl, m), bound(grid_bytes, 0),
            lambda: ms(lambda: t.view(nb_total, m, vl).transpose(-1, -2).contiguous()))

    # -- reach5: the star of reach 5 on the far-reach kernel
    # (csrc/sweep_far.cu) at 2^26, 8192² and 512³, f32 and bf16: resident
    # fused 16 (ops.stencil_sweep_periodic, k=2, ttile=2), a roundtrip run
    # (ops.stencil_run_periodic) and ops.stencil_run, each counted on
    # sweep_far / multistep_far and K2 alone, resident bit for bit the
    # roundtrip and the plain path, Dirichlet its plain path, each within
    # the f64 oracle's rounding bound; then the K1-far / K3-far rows at
    # vl=8, m=8 d=4/2/1 (bf16 at d=4), K4-far open and ring d=2/1 on the
    # padded grid, and the shapes that raised before this kernel ----------
    def reach5_phase():
        def star(ndim, r):
            return stencils.StencilSpec(f"star{ndim}d-r{r}", ndim, r, "star",
                                        stencils._star_taps(ndim, r))

        far_launched = {}
        start = time.perf_counter()
        for ndim, shape in FAR_CASES:
            spec = star(ndim, FAR_R)
            vl, m, t0 = ops.pick_tile(spec, shape)
            dims = "x".join(map(str, shape))
            x32 = torch.randn(shape, generator=torch.Generator(device=dev).manual_seed(SEED),
                              device=dev)
            remainder, steps = PLANS[0]
            case_launched = {}          # the case's counted launches, its rows' `launches`
            for dtype in (torch.float32, torch.bfloat16):
                x = x32.to(dtype)
                isz = x.element_size()
                dname = str(dtype).split(".")[-1]
                unit = 2.0 ** -24 if dtype == torch.float32 else 2.0 ** -8
                tol = steps * 2 * len(spec.taps) * unit * x.abs().max().item()
                runs = {
                    "resident": (lambda: ops.stencil_sweep_periodic(spec, x, steps, k=K,
                                                                    ttile=TTILE),
                                 resident_counts(spec, steps, remainder, vl, m, itemsize=isz),
                                 "periodic"),
                    "roundtrip": (lambda: ops.stencil_run_periodic(spec, x, steps, k=K),
                                  k4_counts(spec, [(K, steps // K)], vl, m, isz), "periodic"),
                    "dirichlet": (lambda: ops.stencil_run(spec, x, steps, k=K),
                                  k4_counts(spec, [(K, steps // K)], vl, m, isz),
                                  kref.kernel_bc(ndim)),
                }
                results, oracles = {}, {}
                for run, (fn, owned, bc) in runs.items():
                    if set(owned) - {"transpose", "sweep_far", "multistep_far"}:
                        raise AssertionError(f"reach5 {spec.name} {run}: {owned} leaves the "
                                             "far-reach kernel")
                    fn()
                    y, seconds, got = counted(f"reach5 {spec.name} {dname} {run}", fn, owned)
                    for key, n in got.items():
                        far_launched[key] = far_launched.get(key, 0) + n
                        case_launched[key] = case_launched.get(key, 0) + n
                    if run == "roundtrip":
                        err = same(f"reach5 {spec.name} {dname} roundtrip vs resident", y,
                                   results["resident"])
                    elif run == "resident":
                        err = same(f"reach5 {spec.name} {dname} resident vs plain", y,
                                   resident_plain(spec, x, steps, remainder, vl, m, t0))
                    else:
                        err = same(f"reach5 {spec.name} {dname} dirichlet vs plain", y,
                                   dirichlet_plain(spec, x, steps, vl, m, t0))
                    if bc not in oracles:
                        oracles[bc] = apply_steps(spec, x.double(), steps, bc=bc)
                    oracle_err = (y.double() - oracles[bc]).abs().max().item()
                    if oracle_err > tol:
                        raise AssertionError(f"reach5 {spec.name} {dname} {run}: {oracle_err} off "
                                             f"the float64 oracle, beyond {tol}")
                    results[run] = y
                    emit({"phase": "reach5", "case": spec.name, "shape": list(shape),
                          "dtype": dname, "run": run, "steps": steps,
                          "plan": {"k": K, "ttile": TTILE if run == "resident" else 1,
                                   "remainder": remainder},
                          "tile": {"vl": vl, "m": m, "t0": t0}, "launches": got,
                          "launch_depths": [d for *_, d in launches_at(
                              spec, m, K * TTILE if run == "resident" else K, isz, vl)],
                          "seconds": seconds, "seconds_median_of_5": host_median(fn),
                          "gpoint_updates_per_s": x.numel() * steps / seconds,
                          "max_abs_err_vs_plain" if run != "roundtrip" else
                          "max_abs_err_vs_resident": err, "bitwise": True,
                          "max_abs_err_vs_f64": oracle_err, "f64_bound": tol})
                del results, oracles, y
            # K1-far / K3-far rows (bf16 at the first depth) and K4-far rows
            kid = "K1-far" if ndim == 1 else "K3-far"
            fname = "stencil1d_sweep_ttile" if ndim == 1 else "stencil_nd_sweep_ttile"
            vl2, m2 = FAR_ROW_TILE
            t02 = ops.pick_tile(spec, shape, vl2, m2)[2]
            weight = torch.tensor(spec.coeff_array(), dtype=torch.float32, device=dev)[None, None]
            for dtype, row_depths in ((torch.float32, FAR_ROW_DEPTHS),
                                      (torch.bfloat16, FAR_ROW_DEPTHS[:1])):
                x = x32.to(dtype)
                wgt = weight.to(dtype)
                t = sk.block_transpose(x, vl2, m2)
                buf = torch.empty_like(t)
                for depth in row_depths:
                    if not on_far(spec, vl2, m2, depth):
                        raise AssertionError(f"reach5 {spec.name} depth {depth} is off the far "
                                             "route")

                    def kern(out=None, d=depth):
                        return sk.stencil1d_sweep_ttile(spec, t, d, 1, out=out) if ndim == 1 else \
                            sk.stencil_nd_sweep_ttile(spec, t, d, 1, t02, out=out)

                    def plain(d=depth):
                        return sk.stencil1d_sweep_ttile_ref(spec, t, d, 1) if ndim == 1 else \
                            sk.stencil_nd_sweep_ttile_ref(spec, t, d, 1, t02)
                    err = same(f"reach5 {spec.name} {kid} depth {depth} {dtype}", kern(), plain())
                    row(kid, fname, f"{spec.name} {dims} {str(dtype).split('.')[-1]} vl={vl2} "
                        f"m={m2} depth={depth}; route sweep_far", "far",
                        case_launched.get("sweep_far", 0), err, lambda: kern(buf), plain,
                        simt_bound(2 * x.numel() * x.element_size(),
                                   depth * spec.flops_per_point * x.numel(), x.element_size()),
                        lambda: ms_slow(conv_steps, spec, x, depth, wgt), slow=True,
                        launch_depths=[d for *_, d in launches_at(spec, m2, depth,
                                                                  x.element_size(), vl2)])
                del t, buf
            block = vl2 * m2 if ndim == 1 else t02
            pad = sk.sweep_halo_blocks(spec.r, K, block) * block
            xp = ops.wrap_pad(x32, pad)
            tp = sk.block_transpose(xp, vl2, m2)
            bufp = torch.empty_like(tp)
            k4 = "K4a-far" if ndim == 1 else "K4b-far"
            for edge_mask in (False, True):
                for depth in (K, 1):
                    edge = "ring" if edge_mask else "open"

                    def kern(out=None, d=depth, em=edge_mask):
                        return sk.stencil1d_multistep(spec, tp, d, em, out=out) if ndim == 1 else \
                            sk.stencil_nd_multistep(spec, tp, d, t02, em, out=out)

                    def plain(d=depth, em=edge_mask):
                        return sk._multistep_ref(spec, tp, d, em)
                    err = same(f"reach5 {spec.name} {k4} {edge} depth {depth}", kern(), plain())
                    row(k4, "stencil1d_multistep" if ndim == 1 else "stencil_nd_multistep",
                        f"{spec.name} {'x'.join(map(str, xp.shape))} vl={vl2} m={m2} {edge} "
                        f"depth={depth}; route multistep_far; library: zero pad on axis 0, no "
                        "ring restore", "far", case_launched.get("multistep_far", 0), err,
                        lambda: kern(bufp), plain,
                        bound(2 * xp.numel() * 4, depth * spec.flops_per_point * xp.numel()),
                        lambda: ms_slow(conv_steps, spec, xp, depth, weight, True), slow=True)
            del x, x32, xp, tp, bufp, weight
            torch.cuda.empty_cache()

        # the shapes that raised before the far-reach kernel, each bit for bit
        # its plain version: 3-D stars of reach 6 and 8 past depth 1 on 512³,
        # the boxes of 125 and 121 taps at k = 1, 2, K5 at reach 6 and 20 taps
        vl2, m2 = FAR_ROW_TILE
        c3 = [(star(nd, r), (512, 512, 512), depths) for nd, r, depths in FAR_C3_STARS]
        c3 += [(stencils.StencilSpec(f"box{nd}d-r{r}", nd, r, "box", stencils._box_taps(nd, r)),
                grid, (1, 2)) for nd, r, grid in FAR_C3_BOXES]
        for spec, shape, depths in c3:
            x = torch.randn(shape, generator=torch.Generator(device=dev).manual_seed(SEED),
                            device=dev)
            t02 = ops.pick_tile(spec, shape, vl2, m2)[2]
            t = sk.block_transpose(x, vl2, m2)
            buf = torch.empty_like(t)
            wgt = torch.tensor(spec.coeff_array(), dtype=x.dtype, device=dev)[None, None]
            for depth in depths:
                if not on_far(spec, vl2, m2, depth):
                    raise AssertionError(f"{spec.name} depth {depth} is off the far route")
                # the shape's own counted run: its launches are the row's
                y, _, got = counted(f"{spec.name} K3-far depth {depth}",
                                    lambda: sk.stencil_nd_sweep_ttile(spec, t, depth, 1, t02),
                                    {"sweep_far": len(launches_at(spec, m2, depth, 4, vl2))})
                err = same(f"{spec.name} K3-far depth {depth}", y,
                           sk.stencil_nd_sweep_ttile_ref(spec, t, depth, 1, t02))
                del y
                row("K3-far", "stencil_nd_sweep_ttile",
                    f"{spec.name} {'x'.join(map(str, shape))} ({len(spec.taps)} taps) vl={vl2} "
                    f"m={m2} depth={depth}; route sweep_far; raised before sweep_far.cu", "far",
                    got["sweep_far"], err,
                    lambda: sk.stencil_nd_sweep_ttile(spec, t, depth, 1, t02, out=buf),
                    lambda: sk.stencil_nd_sweep_ttile_ref(spec, t, depth, 1, t02),
                    bound(2 * x.numel() * 4, depth * spec.flops_per_point * x.numel()),
                    lambda: ms_slow(conv_steps, spec, x, depth, wgt), slow=True,
                    launch_depths=[d for *_, d in launches_at(spec, m2, depth, 4, vl2)])
            del x, t, buf
            torch.cuda.empty_cache()
        k5_specs = {
            "star1d-r6": star(1, 6),
            "taps20": stencils.StencilSpec("taps20", 1, 10, "star", tuple(
                ((o,), 1.0 / (20 + abs(o))) for o in range(-10, 11) if o)),
            "r20-3taps": stencils.StencilSpec("r20-3taps", 1, 20, "star", (
                ((-20,), 0.25), ((0,), 0.5), ((20,), 0.25))),
            "far40": stencils.StencilSpec("far40", 1, 40, "star", (
                ((0,), 0.5), ((-40,), 0.25), ((33,), 0.25)))}
        for label, m_k5, forms in FAR_K5:
            for dtype in (torch.float32, torch.bfloat16):
                k5_rows("reach5", k5_specs[label], 1 << 26, m_k5, dtype, forms=forms)
        emit({"phase": "reach5", "launches": far_launched,
              "phase_seconds": time.perf_counter() - start})
        torch.cuda.empty_cache()

    for name, shape in CASES:
        prob = StencilProblem(name, shape)
        spec = prob.spec
        x = prob.init(SEED)
        vl, m, t0 = ops.pick_tile(spec, shape)
        numel, itemsize = x.numel(), x.element_size()
        grid_bytes = 2 * numel * itemsize
        dims = "x".join(map(str, shape))
        sweep_key = {1: "sweep_1d", 2: "sweep_2d", 3: "sweep_3d"}[spec.ndim]
        lib_ms = {}      # a library call's time, once per function of the case's grid

        def library_once(key, fn):
            if key not in lib_ms:
                lib_ms[key] = fn()
            return lib_ms[key]
        weight = torch.tensor(spec.coeff_array(), dtype=x.dtype, device=dev)[None, None]

        def plan_of(sweep, remainder, ttile=1, tile=(None, None)):
            return StencilPlan(backend="pallas", sweep=sweep, k=K, ttile=ttile,
                               remainder=remainder, vl=tile[0] or 8, m=tile[1])

        # -- main path: resident (one short uncounted run loads the kernels) --
        prob.run(x, 2, plan_of("resident", "fused"))
        resident, counts = {}, {}
        for remainder, steps in PLANS:
            y, seconds, got = counted(
                f"{name} resident {remainder}",
                lambda: prob.run(x, steps, plan_of("resident", remainder, TTILE)),
                resident_counts(spec, steps, remainder, vl, m))
            counts[((vl, m), "resident", remainder)] = got
            err = same(f"{name} resident {remainder} vs plain", y,
                       resident_plain(spec, x, steps, remainder, vl, m, t0))
            resident[remainder] = (y, seconds)
            median = host_median(lambda: prob.run(x, steps, plan_of("resident", remainder, TTILE)))
            emit({"phase": "main_path", "case": name, "shape": list(shape),
                  "plan": {"k": K, "ttile": TTILE, "remainder": remainder}, "steps": steps,
                  "schedule": sweep_schedule(K, steps, remainder, TTILE)[0],
                  "tile": {"vl": vl, "m": m, "t0": t0}, "seconds": seconds,
                  "seconds_median_of_5": median,
                  "gpoint_updates_per_s": numel * steps / seconds, "launches": got,
                  "max_abs_err_vs_plain": err, "bitwise": True})
        # the same fused run at other tiles: the JAX package's vl=128 and
        # its tuner's vl=8 and pairs vl=8, m=16 and (1-D, 2-D) vl=16, m=32,
        # all on the register kernels (m=16, 32 on sub-columns of 8)
        remainder, steps = PLANS[0]
        for tile, route in OTHER_TILES[spec.ndim]:
            vl2, m2 = tile
            t02 = ops.pick_tile(spec, shape, vl2, m2)[2]
            plan = plan_of("resident", remainder, TTILE, tile)
            owned = resident_counts(spec, steps, remainder, vl2, m2)
            want_key = sweep_key if route == "reg" else "sweep_far"
            if set(owned) - {k2_key(vl2, m2)} != {want_key}:
                raise AssertionError(f"{name} at vl={vl2}, m={m2}: the schedule's launches "
                                     f"{owned} are not on the {want_key} route")
            prob.run(x, 2, plan)
            y, seconds, got = counted(f"{name} resident {remainder} vl={vl2} m={m2}",
                                      lambda: prob.run(x, steps, plan), owned)
            counts[(tile, "resident", remainder)] = got
            err = same(f"{name} resident {remainder} vl={vl2} m={m2} vs plain", y,
                       resident_plain(spec, x, steps, remainder, vl2, m2, t02))
            same(f"{name} resident {remainder} vl={vl2} m={m2} vs vl={vl}", y,
                 resident[remainder][0])
            emit({"phase": "main_path", "case": name, "shape": list(shape),
                  "plan": {"k": K, "ttile": TTILE, "remainder": remainder}, "steps": steps,
                  "schedule": sweep_schedule(K, steps, remainder, TTILE)[0],
                  "tile": {"vl": vl2, "m": m2, "t0": t02}, "route": want_key,
                  "seconds": seconds,
                  "seconds_median_of_5": host_median(lambda: prob.run(x, steps, plan)),
                  "gpoint_updates_per_s": numel * steps / seconds,
                  "launches": got, "max_abs_err_vs_plain": err, "bitwise": True})
            del y
        # the reference tuner's deep plans (2-D, 3-D): depths 8 and 16 on the
        # register kernels (consecutive depth-4 launches), each bit for bit
        # the vl=32 run
        for kd, td in DEEP_PLANS if spec.ndim > 1 else ():
            for tile in DEEP_TILES[spec.ndim]:
                vl2, m2 = tile
                t02 = ops.pick_tile(spec, shape, vl2, m2)[2]
                plan = StencilPlan(backend="pallas", sweep="resident", k=kd, ttile=td,
                                   remainder=remainder, vl=vl2, m=m2)
                owned = resident_counts(spec, steps, remainder, vl2, m2, kd, td)
                if set(owned) - {k2_key(vl2, m2)} != {sweep_key}:
                    raise AssertionError(f"{name} at vl={vl2}, m={m2}, k={kd}, ttile={td}: the "
                                         f"schedule's launches {owned} are not on {sweep_key}")
                prob.run(x, kd * td, plan)
                y, seconds, got = counted(f"{name} resident {remainder} vl={vl2} m={m2} "
                                          f"k={kd} ttile={td}", lambda: prob.run(x, steps, plan),
                                          owned)
                counts[(tile, "resident", remainder, kd * td)] = got
                err = same(f"{name} resident {remainder} vl={vl2} m={m2} depth {kd * td} vs "
                           f"vl={vl} depth {K * TTILE}", y, resident[remainder][0])
                launcher = sk.sweep2d_launches if spec.ndim == 2 else sk.sweep3d_launches
                emit({"phase": "main_path", "case": name, "shape": list(shape),
                      "plan": {"k": kd, "ttile": td, "remainder": remainder}, "steps": steps,
                      "schedule": sweep_schedule(kd, steps, remainder, td)[0],
                      "instances": [list(p) for p in launcher(m2, kd * td, spec.r)],
                      "tile": {"vl": vl2, "m": m2, "t0": t02}, "route": sweep_key,
                      "seconds": seconds,
                      "seconds_median_of_5": host_median(lambda: prob.run(x, steps, plan)),
                      "gpoint_updates_per_s": numel * steps / seconds, "launches": got,
                      "max_abs_err_vs_depth4_run": err, "bitwise": True})
                del y
        # an odd m at size (1-D, 2-D), against its own plain path
        odd_runs = {}
        if spec.ndim in ODD_CASES:
            oshape, otile = ODD_CASES[spec.ndim]
            oprob = StencilProblem(name, oshape)
            xo = oprob.init(SEED)
            t0o = ops.pick_tile(spec, oshape, *otile)[2]
            plan = plan_of("resident", remainder, TTILE, otile)
            owned = resident_counts(spec, steps, remainder, *otile)
            if set(owned) - {k2_key(*otile)} != {sweep_key}:
                raise AssertionError(f"{name} {oshape} at vl={otile[0]}, m={otile[1]}: the "
                                     f"schedule's launches {owned} are not on {sweep_key}")
            oprob.run(xo, 2, plan)
            y, seconds, got = counted(f"{name} {oshape} resident {remainder} at {otile}",
                                      lambda: oprob.run(xo, steps, plan), owned)
            odd_runs[otile] = (xo, t0o, got)
            err = same(f"{name} {oshape} resident {remainder} at {otile} vs plain", y,
                       resident_plain(spec, xo, steps, remainder, *otile, t0o))
            emit({"phase": "main_path", "case": name, "shape": list(oshape),
                  "plan": {"k": K, "ttile": TTILE, "remainder": remainder}, "steps": steps,
                  "schedule": sweep_schedule(K, steps, remainder, TTILE)[0],
                  "tile": {"vl": otile[0], "m": otile[1], "t0": t0o}, "route": sweep_key,
                  "seconds": seconds,
                  "seconds_median_of_5": host_median(lambda: oprob.run(xo, steps, plan)),
                  "gpoint_updates_per_s": xo.numel() * steps / seconds,
                  "launches": got, "max_abs_err_vs_plain": err, "bitwise": True})
            del y

        # -- roundtrip: the same runs, one pad/transpose/K4/transpose per
        # sweep, each equal to the resident run; 3-D also fused at the plans'
        # other tiles on the streaming kernel (``tiles``: (the plan's tile,
        # the tile it reaches, the plans run there)) -------------------------
        others = [tile for tile, route in OTHER_TILES[3] if route == "reg"] \
            if spec.ndim == 3 else []
        tiles = [((None, None), (vl, m), PLANS)] + [(t, t, PLANS[:1]) for t in others]
        for plan_tile, tile, plans in tiles:
            at = "" if plan_tile[0] is None else f" vl={tile[0]} m={tile[1]}"
            prob.run(x, 2, plan_of("roundtrip", "fused", 1, plan_tile))
            for remainder, steps in plans:
                chunks = sweep_schedule(K, steps, remainder, 1)[0]
                plan = plan_of("roundtrip", remainder, 1, plan_tile)
                owned = k4_counts(spec, chunks, *tile)
                if spec.ndim == 3 and set(owned) - {k2_key(*tile)} != {"multistep_3d"}:
                    raise AssertionError(f"{name} roundtrip{at}: the schedule's launches "
                                         f"{owned} are not on multistep_3d")
                y, seconds, got = counted(f"{name} roundtrip {remainder}{at}",
                                          lambda: prob.run(x, steps, plan), owned)
                counts[(tile, "roundtrip", remainder)] = got
                res2, res2_s = resident[remainder]
                err = same(f"{name} roundtrip {remainder}{at} vs resident ttile={TTILE} "
                           f"vl={vl}", y, res2)
                extra = {}
                if plan_tile[0] is None:      # the case's tile: also resident at ttile 1
                    torch.cuda.synchronize()
                    start = time.perf_counter()
                    res1 = prob.run(x, steps, plan_of("resident", remainder, 1))
                    torch.cuda.synchronize()
                    res1_s = time.perf_counter() - start
                    same(f"{name} roundtrip {remainder} vs resident ttile=1", y, res1)
                    del res1
                    extra = {"resident_seconds": {"ttile=1": res1_s, f"ttile={TTILE}": res2_s},
                             "resident_gpoint_updates_per_s": {
                                 "ttile=1": numel * steps / res1_s,
                                 f"ttile={TTILE}": numel * steps / res2_s},
                             "roundtrip_over_resident_ttile2": seconds / res2_s}
                emit({"phase": "roundtrip", "case": name, "shape": list(shape),
                      "plan": {"k": K, "remainder": remainder, "sweep": "roundtrip"},
                      "tile": {"vl": tile[0], "m": tile[1]}, "steps": steps,
                      "sweeps": sum(n for _, n in chunks), "launches": got,
                      "seconds": seconds, "gpoint_updates_per_s": numel * steps / seconds,
                      "seconds_median_of_5": host_median(lambda: prob.run(x, steps, plan)),
                      **extra, "max_abs_err_vs_resident": err, "bitwise": True})
                del y
        del resident

        # -- dirichlet: ops.stencil_run, the Dirichlet ring along axis 0 (one
        # short uncounted run loads the ring-mode kernels), at the same tiles:
        # the case's against the plain version, the others against it -------
        sweeps = DIRICHLET_STEPS // K
        first = None
        for plan_tile, tile, _ in tiles:
            at = "" if plan_tile[0] is None else f" vl={tile[0]} m={tile[1]}"

            def run_at(steps=DIRICHLET_STEPS):
                return ops.stencil_run(spec, x, steps, k=K, vl=plan_tile[0], m=plan_tile[1])
            owned = k4_counts(spec, [(K, sweeps)], *tile)
            if spec.ndim == 3 and set(owned) - {k2_key(*tile)} != {"multistep_3d"}:
                raise AssertionError(f"{name} dirichlet{at}: the schedule's launches "
                                     f"{owned} are not on multistep_3d")
            run_at(K)
            y, seconds, got = counted(f"{name} dirichlet{at}", run_at, owned)
            counts[(tile, "dirichlet")] = got
            if first is None:
                first = y
                err = same(f"{name} dirichlet vs plain", y,
                           dirichlet_plain(spec, x, DIRICHLET_STEPS, vl, m, t0))
            else:
                err = same(f"{name} dirichlet{at} vs vl={vl}", y, first)
            emit({"phase": "dirichlet", "case": name, "shape": list(shape), "k": K,
                  "steps": DIRICHLET_STEPS, "tile": {"vl": tile[0], "m": tile[1]},
                  "launches": got, "seconds": seconds,
                  "seconds_median_of_5": host_median(run_at),
                  "gpoint_updates_per_s": numel * DIRICHLET_STEPS / seconds,
                  "max_abs_err": err, "bitwise": True})
            del y
        del first
        launched = {key: sum(c[key] for c in counts.values()) +
                    sum(got[key] for _, _, got in odd_runs.values()) for key in sk.LAUNCHES}

        # -- K2: transpose in and out at the tile of every counted run, each
        # on its register route; 1-D also at tiles no run reaches (vl=2) ----
        for tile in sorted({t for (t, *_) in counts}, key=lambda t: (t != (vl, m), t)):
            if k2_key(*tile) != "transpose":
                raise AssertionError(f"{name}: K2 at the counted tile {tile} is not on its "
                                     "register route")
            at_tile = sum(c["transpose"] for (t, *_), c in counts.items() if t == tile)
            k2_rows(name, dims, x, *tile, at_tile, grid_bytes)
        for otile, (xo, _, got) in odd_runs.items():
            k2_rows(name, "x".join(map(str, xo.shape)), xo, *otile, got["transpose"],
                    2 * xo.numel() * itemsize)
        for kshape, ktile in K2_EXTRA if spec.ndim == 1 else ():
            xk = x if kshape == shape else StencilProblem(name, kshape).init(SEED)
            k2_rows(name, "x".join(map(str, kshape)), xk, *ktile,
                    sum(c[k2_key(*ktile)] for (t, *_), c in counts.items() if t == ktile),
                    2 * xk.numel() * itemsize)
            del xk
        for dtype in (torch.float16, torch.float64):
            xd = x.to(dtype)
            td = sk.block_transpose(xd, vl, m)
            err = max(same(f"{name} transpose {dtype}", td, sk.block_transpose_ref(xd, vl, m)),
                      same(f"{name} untranspose {dtype}", sk.block_untranspose(td, vl, m), xd))
            emit({"phase": "kernels", "case": name, "check": "K2 both directions",
                  "dtype": str(dtype), "tile": {"vl": vl, "m": m},
                  "route": sk.transpose_route(vl, m, xd.element_size()),
                  "max_abs_err": err, "bitwise": True})
            del xd, td

        # -- K1 / K3: the resident sweep at every depth the main path launches,
        # at the case's tile and (1-D, 2-D) at the other vl of ROW_VLS
        kid = "K1" if spec.ndim == 1 else "K3"
        fname = "stencil1d_sweep_ttile" if spec.ndim == 1 else "stencil_nd_sweep_ttile"
        src = {1: "sweep1d_warp", 2: "sweep2d_warp", 3: "sweep3d"}[spec.ndim]

        def sweep_row(rkid, tile, depths, source, key, t02, xx=x, at_tile=None, sp=spec):
            """K1 / K3 rows of the stencil ``sp`` (the case's unless given)
            at the (vl, m) tile on the grid ``xx`` (the case's unless
            given), each depth bit for bit the plain version; ``key``: the
            route's counter; ``at_tile``: the counted launches at the tile
            (by default the case's runs')."""
            spec = sp
            wgt = weight if sp is prob.spec else \
                torch.tensor(sp.coeff_array(), dtype=xx.dtype, device=dev)[None, None]
            vl2, m2 = tile
            t2 = sk.block_transpose(xx, vl2, m2)
            buf2 = torch.empty_like(t2)
            xdims = "x".join(map(str, xx.shape))
            if at_tile is None:
                at_tile = sum(c[key] for (t, *_), c in counts.items() if t == tile)
            for depth in depths:
                if on_far(spec, vl2, m2, depth) != (key == "sweep_far"):
                    raise AssertionError(f"{name} vl={vl2} m={m2} depth {depth} does not take "
                                         f"the {key} route")
                kk, tt = (K, depth // K) if depth > K else (depth, 1)

                def kern():
                    if spec.ndim == 1:
                        return sk.stencil1d_sweep_ttile(spec, t2, kk, tt, out=buf2)
                    return sk.stencil_nd_sweep_ttile(spec, t2, kk, tt, t02, out=buf2)

                def plain():
                    if spec.ndim == 1:
                        return sk.stencil1d_sweep_ttile_ref(spec, t2, kk, tt)
                    return sk.stencil_nd_sweep_ttile_ref(spec, t2, kk, tt, t02)
                err = same(f"{spec.name} {rkid} vl={vl2} m={m2} depth {depth}", kern(), plain())
                extra = {"instances": [list(p) for p in launches_at(spec, m2, depth,
                                                                   xx.element_size(), vl2)]}
                row(rkid, fname, f"{spec.name} {xdims} vl={vl2} m={m2} depth={depth}; route {key}",
                    source, launched[key], err, kern, plain,
                    simt_bound(2 * xx.numel() * itemsize,
                               depth * spec.flops_per_point * xx.numel(), itemsize),
                    lambda: library_once(("sweep", spec.name, depth, xdims),
                                         lambda: ms(conv_steps, spec, xx, depth, wgt)),
                    launches_at_tile=at_tile, **extra)
            del t2, buf2

        # where vl·m divides the minor extent, the tuner's pairs on
        # sub-columns (3-D: also the JAX package's tile and vl=32 at its m)
        row_tiles = [(vl2, m) for vl2 in ROW_VLS if shape[-1] % (vl2 * m) == 0] + [PAIR_TILE]
        if spec.ndim == 3:
            row_tiles += [JAX_TILE_3D, (vl, JAX_TILE_3D[1])]
        else:
            row_tiles += [PAIR_TILE_32]
        sweep_row(kid, (vl, m), (4, 2, 1), src, sweep_key, t0)
        for tile in row_tiles:
            sweep_row(kid, tile, (4, 2, 1), src, sweep_key, ops.pick_tile(spec, shape, *tile)[2])
        if spec.ndim == 3:
            sweep_row(kid, PAIR_TILE_32, (K * TTILE,), src, sweep_key,
                      ops.pick_tile(spec, shape, *PAIR_TILE_32)[2])
        for otile, (xo, t0o, got) in odd_runs.items():
            sweep_row(kid, otile, (4, 2, 1), src, sweep_key, t0o, xx=xo, at_tile=got[sweep_key])
        del odd_runs
        # the reference tuner's depths 8 and 16 (2-D, 3-D) on the register
        # kernels, at the deep runs' tiles
        for tile in DEEP_TILES.get(spec.ndim, ()):
            sweep_row(kid, tile, (8, 16), src, sweep_key, ops.pick_tile(spec, shape, *tile)[2])
        # 1-D: the shape the shared-memory route took until depth·r > 32·M
        # became consecutive warp launches (32 + 2)
        if spec.ndim == 1:
            sweep_row(kid, DEEP_1D_ROW[0], (DEEP_1D_ROW[1],), src, sweep_key, None)

        # -- K4: the multistep sweep at the roundtrip's padded shape, at the
        # case's tile, the tuner's and its pair vl=8, m=16 ------------------
        kid = "K4a" if spec.ndim == 1 else "K4b"
        fname = "stencil1d_multistep" if spec.ndim == 1 else "stencil_nd_multistep"
        block = vl * m if spec.ndim == 1 else t0
        pad = sk.sweep_halo_blocks(spec.r, K, block) * block
        xp = ops.wrap_pad(x, pad)
        pdims = "x".join(map(str, xp.shape))
        for vl2, m2 in [(vl, m), TUNER_TILE, PAIR_TILE]:
            tp = sk.block_transpose(xp, vl2, m2)
            bufp = torch.empty_like(tp)
            for edge_mask in (False, True):
                for depth in (K, 1) if spec.ndim == 1 else (K, 1, 8):
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
                    key = multi_key(spec, vl2, m2, depth)
                    source = {"multistep_1d": "sweep1d_warp", "multistep_2d": "sweep2d_warp",
                              "multistep_3d": "sweep3d"}.get(key, "far")
                    route = "far" if source == "far" else \
                        "stream" if source == "sweep3d" else "warp"
                    err = same(f"{name} {kid} vl={vl2} m={m2} {edge} depth {depth}", kern(),
                               plain())
                    extra = {"instances": [list(p) for p in launches_at(spec, m2, depth, 4, vl2)]}
                    row(kid, fname,
                        f"{name} {pdims} vl={vl2} m={m2} {edge} depth={depth}; route {route} "
                        f"({key}); library: zero pad on axis 0, no ring restore", source,
                        launched[key], err, kern, plain,
                        simt_bound(2 * xp.numel() * itemsize,
                                   depth * spec.flops_per_point * xp.numel(), itemsize),
                        lambda: library_once(("edge", depth),
                                             lambda: ms(conv_steps, spec, xp, depth, weight,
                                                        True)), **extra)
            del tp, bufp
        del x, xp, weight
        torch.cuda.empty_cache()

    # -- 1d5p_odd: 1d5p at 5·10^7 points on the picker's tile vl=32, m=5
    # (sub-columns of 1: r = 2 > M = 1, the warp kernel's halo of two lanes):
    # resident fused 16 and native 7, a roundtrip run (K4a open) and
    # ops.stencil_run (K4a ring), each counted on the warp kernel, no
    # launch of sweep_far.cu, and bit for bit the port's plain path;
    # then its K1 rows (and on ODD_CASES[1]'s grid at vl=8, m=3) and K4a rows
    name, shape = ODD_REACH_CASE
    prob = StencilProblem(name, shape)
    spec = prob.spec
    x = prob.init(SEED)
    vl, m, _ = ops.pick_tile(spec, shape)
    if (vl, m) != ODD_REACH_TILE or sk.sub_columns(m)[0] >= spec.r:
        raise AssertionError(f"{name} {shape}: the picker's tile ({vl}, {m}) is not "
                             f"{ODD_REACH_TILE} with r > M")
    dims = "x".join(map(str, shape))
    weight = torch.tensor(spec.coeff_array(), dtype=x.dtype, device=dev)[None, None]

    def on_warp(label, owned, key):
        if set(owned) != {"transpose", key} or any("far" in k for k in owned):
            raise AssertionError(f"1d5p_odd {label}: the schedule's launches {owned} are not "
                                 f"on transpose and {key} alone")
        return owned

    odd_counts, resident = [], None
    for remainder, steps in PLANS:
        plan = StencilPlan(backend="pallas", sweep="resident", k=K, ttile=TTILE,
                           remainder=remainder)
        owned = on_warp(f"resident {remainder}",
                        resident_counts(spec, steps, remainder, vl, m), "sweep_1d")
        prob.run(x, 2, plan)
        y, seconds, got = counted(f"1d5p_odd resident {remainder}",
                                  lambda: prob.run(x, steps, plan), owned)
        err = same(f"1d5p_odd resident {remainder} vs plain", y,
                   resident_plain(spec, x, steps, remainder, vl, m, None))
        odd_counts.append(got)
        emit({"phase": "main_path", "case": "1d5p_odd", "stencil": name, "shape": list(shape),
              "plan": {"k": K, "ttile": TTILE, "remainder": remainder}, "steps": steps,
              "schedule": sweep_schedule(K, steps, remainder, TTILE)[0],
              "tile": {"vl": vl, "m": m}, "sub_columns": list(sk.sub_columns(m)),
              "route": "sweep_1d", "seconds": seconds,
              "seconds_median_of_5": host_median(lambda: prob.run(x, steps, plan)),
              "gpoint_updates_per_s": x.numel() * steps / seconds, "launches": got,
              "max_abs_err_vs_plain": err, "bitwise": True})
        if resident is None:
            resident = y
        else:
            del y
    remainder, steps = PLANS[0]
    rplan = StencilPlan(backend="pallas", sweep="roundtrip", k=K, remainder=remainder)
    owned = on_warp("roundtrip", k4_counts(spec, sweep_schedule(K, steps, remainder, 1)[0],
                                           vl, m), "multistep_1d")
    prob.run(x, 2, rplan)
    y, seconds, got = counted("1d5p_odd roundtrip", lambda: prob.run(x, steps, rplan), owned)
    err = same("1d5p_odd roundtrip vs resident", y, resident)
    odd_counts.append(got)
    emit({"phase": "roundtrip", "case": "1d5p_odd", "stencil": name, "shape": list(shape),
          "plan": {"k": K, "remainder": remainder, "sweep": "roundtrip"},
          "tile": {"vl": vl, "m": m}, "steps": steps, "edge": "open", "launches": got,
          "seconds": seconds,
          "seconds_median_of_5": host_median(lambda: prob.run(x, steps, rplan)),
          "max_abs_err_vs_resident": err, "bitwise": True})
    del y, resident

    def run_ring(n=DIRICHLET_STEPS):
        return ops.stencil_run(spec, x, n, k=K)
    owned = on_warp("dirichlet", k4_counts(spec, [(K, DIRICHLET_STEPS // K)], vl, m),
                    "multistep_1d")
    run_ring(K)
    y, seconds, got = counted("1d5p_odd dirichlet", run_ring, owned)
    err = same("1d5p_odd dirichlet vs plain", y,
               dirichlet_plain(spec, x, DIRICHLET_STEPS, vl, m, None))
    odd_counts.append(got)
    emit({"phase": "dirichlet", "case": "1d5p_odd", "stencil": name, "shape": list(shape),
          "k": K, "steps": DIRICHLET_STEPS, "tile": {"vl": vl, "m": m}, "edge": "ring",
          "launches": got, "seconds": seconds, "seconds_median_of_5": host_median(run_ring),
          "max_abs_err": err, "bitwise": True})
    del y
    odd_launched = {key: sum(c[key] for c in odd_counts) for key in sk.LAUNCHES}
    xo = StencilProblem(name, ODD_CASES[1][0]).init(SEED)
    for xx, tile, at_tile in ((x, (vl, m), odd_launched["sweep_1d"]), (xo, ODD_CASES[1][1], 0)):
        t = sk.block_transpose(xx, *tile)
        buf = torch.empty_like(t)
        xdims = "x".join(map(str, xx.shape))
        for depth in (4, 2, 1):
            if sk.sweep1d_route(*tile, depth, spec.r, len(spec.taps)) != "warp":
                raise AssertionError(f"1d5p_odd K1 at {tile} depth {depth} is off the warp route")
            kk, tt = (K, depth // K) if depth > K else (depth, 1)
            err = same(f"1d5p_odd K1 {xdims} at {tile} depth {depth}",
                       sk.stencil1d_sweep_ttile(spec, t, kk, tt),
                       sk.stencil1d_sweep_ttile_ref(spec, t, kk, tt))
            row("K1", "stencil1d_sweep_ttile",
                f"{name} {xdims} vl={tile[0]} m={tile[1]} depth={depth}; route sweep_1d "
                "(r = 2 > M = 1)", "sweep1d_warp", odd_launched["sweep_1d"], err,
                lambda: sk.stencil1d_sweep_ttile(spec, t, kk, tt, out=buf),
                lambda: sk.stencil1d_sweep_ttile_ref(spec, t, kk, tt),
                bound(2 * xx.numel() * 4, depth * spec.flops_per_point * xx.numel()),
                lambda: ms(conv_steps, spec, xx, depth, weight), launches_at_tile=at_tile,
                instances=[list(p) for p in sk.sweep1d_launches(tile[1], depth, spec.r)])
        del t, buf
    del xo
    block = vl * m
    xp = ops.wrap_pad(x, sk.sweep_halo_blocks(spec.r, K, block) * block)
    tp = sk.block_transpose(xp, vl, m)
    bufp = torch.empty_like(tp)
    for edge_mask in (False, True):
        for depth in (K, 1):
            edge = "ring" if edge_mask else "open"
            err = same(f"1d5p_odd K4a {edge} depth {depth}",
                       sk.stencil1d_multistep(spec, tp, depth, edge_mask),
                       sk.stencil1d_multistep_ref(spec, tp, depth, edge_mask))
            row("K4a", "stencil1d_multistep",
                f"{name} {xp.numel()} vl={vl} m={m} {edge} depth={depth}; route warp "
                "(multistep_1d, r = 2 > M = 1); library: zero pad, no ring restore",
                "sweep1d_warp", odd_launched["multistep_1d"], err,
                lambda: sk.stencil1d_multistep(spec, tp, depth, edge_mask, out=bufp),
                lambda: sk.stencil1d_multistep_ref(spec, tp, depth, edge_mask),
                bound(2 * xp.numel() * 4, depth * spec.flops_per_point * xp.numel()),
                lambda: ms(conv_steps, spec, xp, depth, weight, True),
                instances=[list(p) for p in sk.sweep1d_launches(m, depth, spec.r)])
    del x, xp, tp, bufp, weight
    torch.cuda.empty_cache()

    # -- reach2: the star of reach 2 at 2-D 8192² and 3-D 512³ on the
    # register kernels, in float32 and bfloat16: resident fused 16
    # (ops.stencil_sweep_periodic, k=2, ttile=2), a roundtrip run
    # (ops.stencil_run_periodic: K4b with the ring on the wrap-padded grid)
    # and ops.stencil_run (K4b, the Dirichlet ring), each counted with no
    # sweep_far.cu launch; resident bit for bit the roundtrip and the
    # plain path, Dirichlet its plain path, both within the float64
    # oracle's rounding bound; then the K3 and K4b rows of reach 2 -------
    for ndim, shape in REACH_CASES:
        spec = stencils.StencilSpec(f"star{ndim}d-r{REACH_R}", ndim, REACH_R, "star",
                                    stencils._star_taps(ndim, REACH_R))
        vl, m, t0 = ops.pick_tile(spec, shape)
        dims = "x".join(map(str, shape))
        x32 = torch.randn(shape, generator=torch.Generator(device=dev).manual_seed(SEED),
                          device=dev)
        remainder, steps = PLANS[0]
        reach_counts = {}
        for dtype in (torch.float32, torch.bfloat16):
            x = x32.to(dtype)
            dname = str(dtype).split(".")[-1]
            unit = 2.0 ** -24 if dtype == torch.float32 else 2.0 ** -8
            # |error| <= steps · 2·taps · unit · max|x|: each of a step's
            # products and sums (and coefficients) rounds once, and a step of
            # positive coefficients summing to 1 enlarges no error
            tol = steps * 2 * len(spec.taps) * unit * x.abs().max().item()
            runs = {
                "resident": (lambda: ops.stencil_sweep_periodic(spec, x, steps, k=K,
                                                                ttile=TTILE),
                             resident_counts(spec, steps, remainder, vl, m), "periodic"),
                "roundtrip": (lambda: ops.stencil_run_periodic(spec, x, steps, k=K),
                              k4_counts(spec, [(K, steps // K)], vl, m), "periodic"),
                "dirichlet": (lambda: ops.stencil_run(spec, x, steps, k=K),
                              k4_counts(spec, [(K, steps // K)], vl, m),
                              kref.kernel_bc(ndim)),
            }
            results = {}
            for run, (fn, owned, bc) in runs.items():
                if any(key in owned for key in ("sweep_far", "multistep_far")):
                    raise AssertionError(f"reach2 {spec.name} {run}: {owned} launches "
                                         "sweep_far.cu")
                fn()
                y, seconds, got = counted(f"reach2 {spec.name} {dname} {run}", fn, owned)
                for key, n in got.items():
                    reach_counts[key] = reach_counts.get(key, 0) + n
                if run == "roundtrip":
                    err = same(f"reach2 {spec.name} {dname} roundtrip vs resident", y,
                               results["resident"])
                elif run == "resident":
                    err = same(f"reach2 {spec.name} {dname} resident vs plain", y,
                               resident_plain(spec, x, steps, remainder, vl, m, t0))
                else:
                    err = same(f"reach2 {spec.name} {dname} dirichlet vs plain", y,
                               dirichlet_plain(spec, x, steps, vl, m, t0))
                oracle = apply_steps(spec, x.double(), steps, bc=bc)
                oracle_err = (y.double() - oracle).abs().max().item()
                del oracle
                if oracle_err > tol:
                    raise AssertionError(f"reach2 {spec.name} {dname} {run}: {oracle_err} off "
                                         f"the float64 oracle, beyond {tol}")
                results[run] = y
                emit({"phase": "reach2", "case": spec.name, "shape": list(shape),
                      "dtype": dname, "run": run, "steps": steps,
                      "plan": {"k": K, "ttile": TTILE if run == "resident" else 1,
                               "remainder": remainder},
                      "tile": {"vl": vl, "m": m, "t0": t0}, "launches": got,
                      "instances": [list(p) for p in launches_at(spec, m, K * TTILE
                                                                 if run == "resident" else K)],
                      "seconds": seconds, "seconds_median_of_5": host_median(fn),
                      "gpoint_updates_per_s": x.numel() * steps / seconds,
                      "max_abs_err_vs_plain" if run != "roundtrip" else
                      "max_abs_err_vs_resident": err, "bitwise": True,
                      "max_abs_err_vs_f64": oracle_err, "f64_bound": tol})
            del results, y
        # the K3 rows at the former shared-memory shapes (and their shallower
        # depths), the depth no one-launch instance has, and K4b's, each
        # bit for bit its plain version; bf16 at the first depth
        (vl2, m2), depths = REACH_ROWS[ndim]
        kid, fname = "K3", "stencil_nd_sweep_ttile"
        src, key = ("sweep2d_warp", "sweep_2d") if ndim == 2 else ("sweep3d", "sweep_3d")
        t02 = ops.pick_tile(spec, shape, vl2, m2)[2]
        weight = torch.tensor(spec.coeff_array(), dtype=torch.float32, device=dev)[None, None]
        for dtype, row_depths in ((torch.float32, depths + (REACH_DEEP[ndim],)),
                                  (torch.bfloat16, depths[:1])):
            x = x32.to(dtype)
            wgt = weight.to(dtype)
            t = sk.block_transpose(x, vl2, m2)
            buf = torch.empty_like(t)
            sfx = "" if dtype == torch.float32 else "_bf16"
            for depth in row_depths:
                if on_far(spec, vl2, m2, depth):
                    raise AssertionError(f"reach2 {spec.name} depth {depth} is off the "
                                         "register route")
                kk, tt = (K, depth // K) if depth > K else (depth, 1)
                err = same(f"reach2 {spec.name} K3 depth {depth} {dtype}",
                           sk.stencil_nd_sweep_ttile(spec, t, kk, tt, t02),
                           sk.stencil_nd_sweep_ttile_ref(spec, t, kk, tt, t02))
                row(kid, fname, f"{spec.name} {dims} {str(dtype).split('.')[-1]} vl={vl2} "
                    f"m={m2} depth={depth}; route {key}", src + sfx, reach_counts.get(key, 0),
                    err, lambda: sk.stencil_nd_sweep_ttile(spec, t, kk, tt, t02, out=buf),
                    lambda: sk.stencil_nd_sweep_ttile_ref(spec, t, kk, tt, t02),
                    simt_bound(2 * x.numel() * x.element_size(),
                               depth * spec.flops_per_point * x.numel(), x.element_size()),
                    lambda: ms(conv_steps, spec, x, depth, wgt),
                    instances=[list(p) for p in launches_at(spec, m2, depth)])
            del t, buf
        pad = sk.sweep_halo_blocks(spec.r, K, t0) * t0
        xp = ops.wrap_pad(x32, pad)
        tp = sk.block_transpose(xp, vl2, m2)
        bufp = torch.empty_like(tp)
        mkey = "multistep_2d" if ndim == 2 else "multistep_3d"
        for edge_mask in (False, True):
            for depth in (K, 1):
                edge = "ring" if edge_mask else "open"
                err = same(f"reach2 {spec.name} K4b {edge} depth {depth}",
                           sk.stencil_nd_multistep(spec, tp, depth, t0, edge_mask),
                           sk.stencil_nd_multistep_ref(spec, tp, depth, t0, edge_mask))
                row("K4b", "stencil_nd_multistep",
                    f"{spec.name} {'x'.join(map(str, xp.shape))} vl={vl2} m={m2} {edge} "
                    f"depth={depth}; route {mkey}; library: zero pad on axis 0, no ring "
                    "restore", src, reach_counts.get(mkey, 0), err,
                    lambda: sk.stencil_nd_multistep(spec, tp, depth, t0, edge_mask, out=bufp),
                    lambda: sk.stencil_nd_multistep_ref(spec, tp, depth, t0, edge_mask),
                    bound(2 * xp.numel() * 4, depth * spec.flops_per_point * xp.numel()),
                    lambda: ms(conv_steps, spec, xp, depth, weight, True),
                    instances=[list(p) for p in launches_at(spec, m2, depth)])
        del x, x32, xp, tp, bufp, weight
        torch.cuda.empty_cache()

    reach5_phase()

    # -- a grid whose picker tile has vl < 4: 2d5p 8192x8190 at (2, 7), the
    # resident fused run counted (K2 on transpose_small), then its K2 rows --
    name, shape = SMALL_VL_CASE
    prob = StencilProblem(name, shape)
    spec = prob.spec
    x = prob.init(SEED)
    vl, m, t0 = ops.pick_tile(spec, shape)
    if vl >= sk.TRANSPOSE_MIN_VL:
        raise AssertionError(f"{name} {shape}: the picker's vl={vl} is not below 4")
    remainder, steps = PLANS[0]
    plan = StencilPlan(backend="pallas", sweep="resident", k=K, ttile=TTILE, remainder=remainder)
    prob.run(x, 2, plan)
    y, seconds, got = counted(f"{name} {shape} resident {remainder}",
                              lambda: prob.run(x, steps, plan),
                              resident_counts(spec, steps, remainder, vl, m))
    err = same(f"{name} {shape} resident {remainder} vs plain", y,
               resident_plain(spec, x, steps, remainder, vl, m, t0))
    emit({"phase": "small_vl", "case": name, "shape": list(shape),
          "plan": {"k": K, "ttile": TTILE, "remainder": remainder}, "steps": steps,
          "tile": {"vl": vl, "m": m, "t0": t0}, "seconds": seconds,
          "seconds_median_of_5": host_median(lambda: prob.run(x, steps, plan)),
          "gpoint_updates_per_s": x.numel() * steps / seconds, "launches": got,
          "max_abs_err_vs_plain": err, "bitwise": True})
    k2_rows(name, "x".join(map(str, shape)), x, vl, m, got["transpose"],
            2 * x.numel() * x.element_size())
    xb = x.to(torch.bfloat16)     # K2 at the same tile in bfloat16 (no counted run)
    k2_rows(name, "x".join(map(str, shape)), xb, vl, m, 0, 2 * xb.numel() * xb.element_size())
    del x, xb, y
    torch.cuda.empty_cache()

    # -- bfloat16 (ROADMAP D1): each case's resident fused run, a roundtrip
    # and a Dirichlet run, counted, each bit for bit the port's plain path;
    # K1 / K3 at depths 4, 2, 1 at the case's tile and at depth 4 at vl=64,
    # K4 at depth 2 (open, ring), bounds at 2-byte elements ----------------
    bf16 = torch.bfloat16
    for name, shape in CASES:
        prob = StencilProblem(name, shape, dtype=bf16)
        spec = prob.spec
        x = prob.init(SEED)
        vl, m, t0 = ops.pick_tile(spec, shape)
        remainder, steps = PLANS[0]
        dims = "x".join(map(str, shape))
        sweep_key = {1: "sweep_1d", 2: "sweep_2d", 3: "sweep_3d"}[spec.ndim]
        weight = torch.tensor(spec.coeff_array(), dtype=bf16, device=dev)[None, None]
        plan = StencilPlan(backend="pallas", sweep="resident", k=K, ttile=TTILE,
                           remainder=remainder)
        prob.run(x, 2, plan)
        y, seconds, got = counted(f"{name} bf16 resident {remainder}",
                                  lambda: prob.run(x, steps, plan),
                                  resident_counts(spec, steps, remainder, vl, m))
        err = same(f"{name} bf16 resident {remainder} vs plain", y,
                   resident_plain(spec, x, steps, remainder, vl, m, t0))
        emit({"phase": "bf16", "run": "resident", "case": name, "shape": list(shape),
              "plan": {"k": K, "ttile": TTILE, "remainder": remainder}, "steps": steps,
              "tile": {"vl": vl, "m": m, "t0": t0}, "seconds": seconds,
              "seconds_median_of_5": host_median(lambda: prob.run(x, steps, plan)),
              "gpoint_updates_per_s": x.numel() * steps / seconds, "launches": got,
              "max_abs_err_vs_plain": err, "bitwise": True})
        runs = [got]
        rplan = StencilPlan(backend="pallas", sweep="roundtrip", k=K, remainder=remainder)
        chunks = sweep_schedule(K, steps, remainder, 1)[0]
        prob.run(x, 2, rplan)
        y2, seconds, got = counted(f"{name} bf16 roundtrip {remainder}",
                                   lambda: prob.run(x, steps, rplan),
                                   k4_counts(spec, chunks, vl, m))
        err = same(f"{name} bf16 roundtrip {remainder} vs resident", y2, y)
        emit({"phase": "bf16", "run": "roundtrip", "case": name, "shape": list(shape),
              "plan": {"k": K, "remainder": remainder, "sweep": "roundtrip"},
              "tile": {"vl": vl, "m": m}, "steps": steps, "launches": got,
              "seconds": seconds,
              "seconds_median_of_5": host_median(lambda: prob.run(x, steps, rplan)),
              "max_abs_err_vs_resident": err, "bitwise": True})
        runs.append(got)
        del y, y2

        def run_dirichlet(n=DIRICHLET_STEPS):
            return ops.stencil_run(spec, x, n, k=K)
        run_dirichlet(K)
        y, seconds, got = counted(f"{name} bf16 dirichlet", run_dirichlet,
                                  k4_counts(spec, [(K, DIRICHLET_STEPS // K)], vl, m))
        err = same(f"{name} bf16 dirichlet vs plain", y,
                   dirichlet_plain(spec, x, DIRICHLET_STEPS, vl, m, t0))
        emit({"phase": "bf16", "run": "dirichlet", "case": name, "shape": list(shape),
              "k": K, "steps": DIRICHLET_STEPS, "tile": {"vl": vl, "m": m}, "launches": got,
              "seconds": seconds, "seconds_median_of_5": host_median(run_dirichlet),
              "max_abs_err": err, "bitwise": True})
        runs.append(got)
        del y
        launched = {key: sum(c[key] for c in runs) for key in sk.LAUNCHES}

        kid = "K1" if spec.ndim == 1 else "K3"
        fname = "stencil1d_sweep_ttile" if spec.ndim == 1 else "stencil_nd_sweep_ttile"
        src = {1: "sweep1d_warp_bf16", 2: "sweep2d_warp_bf16", 3: "sweep3d_bf16"}[spec.ndim]
        for tile, depths in [((vl, m), (4, 2, 1))] + [(tt, (4,)) for tt in BF16_ROW_TILES]:
            vl2, m2 = tile
            t02 = ops.pick_tile(spec, shape, vl2, m2)[2]
            t = sk.block_transpose(x, vl2, m2)
            buf = torch.empty_like(t)
            for depth in depths:
                key, per = launches_of(spec, vl2, m2, depth)
                if key != sweep_key:
                    raise AssertionError(f"{name} bf16 vl={vl2} m={m2} depth {depth}: {key}")
                kk, tt = (K, depth // K) if depth > K else (depth, 1)

                def kern():
                    if spec.ndim == 1:
                        return sk.stencil1d_sweep_ttile(spec, t, kk, tt, out=buf)
                    return sk.stencil_nd_sweep_ttile(spec, t, kk, tt, t02, out=buf)

                def plain():
                    if spec.ndim == 1:
                        return sk.stencil1d_sweep_ttile_ref(spec, t, kk, tt)
                    return sk.stencil_nd_sweep_ttile_ref(spec, t, kk, tt, t02)
                err = same(f"{name} bf16 {kid} vl={vl2} m={m2} depth {depth}", kern(), plain())
                row(kid, fname, f"{name} {dims} bf16 vl={vl2} m={m2} depth={depth}; route "
                    f"{key}", src, launched[key], err, kern, plain,
                    simt_bound(2 * x.numel() * 2, depth * spec.flops_per_point * x.numel(), 2),
                    lambda: ms(conv_steps, spec, x, depth, weight),
                    launches_at_tile=launched[key] if tile == (vl, m) else 0)
            del t, buf
        kid = "K4a" if spec.ndim == 1 else "K4b"
        fname = "stencil1d_multistep" if spec.ndim == 1 else "stencil_nd_multistep"
        block = vl * m if spec.ndim == 1 else t0
        xp = ops.wrap_pad(x, sk.sweep_halo_blocks(spec.r, K, block) * block)
        tp = sk.block_transpose(xp, vl, m)
        bufp = torch.empty_like(tp)
        for edge_mask in (False, True):
            def kern():
                if spec.ndim == 1:
                    return sk.stencil1d_multistep(spec, tp, K, edge_mask, out=bufp)
                return sk.stencil_nd_multistep(spec, tp, K, t0, edge_mask, out=bufp)

            def plain():
                if spec.ndim == 1:
                    return sk.stencil1d_multistep_ref(spec, tp, K, edge_mask)
                return sk.stencil_nd_multistep_ref(spec, tp, K, t0, edge_mask)
            key = multi_key(spec, vl, m, K)
            edge = "ring" if edge_mask else "open"
            err = same(f"{name} bf16 {kid} {edge} depth {K}", kern(), plain())
            row(kid, fname, f"{name} {'x'.join(map(str, xp.shape))} bf16 vl={vl} m={m} {edge} "
                f"depth={K}; route {key}; library: zero pad on axis 0, no ring restore",
                src, launched[key], err, kern, plain,
                simt_bound(2 * xp.numel() * 2, K * spec.flops_per_point * xp.numel(), 2),
                lambda: ms(conv_steps, spec, xp, K, weight, True))
        del x, xp, tp, bufp, weight
        torch.cuda.empty_cache()

    # -- bfloat16 1d5p_odd: the resident fused run at the picker's vl=32,
    # m=5 on the warp kernel's r > M instance, counted, bit for bit its plain
    # path; its K1 rows at depths 4, 2, 1 -------------------------------
    name, shape = ODD_REACH_CASE
    prob = StencilProblem(name, shape, dtype=bf16)
    spec = prob.spec
    x = prob.init(SEED)
    vl, m, _ = ops.pick_tile(spec, shape)
    remainder, steps = PLANS[0]
    plan = StencilPlan(backend="pallas", sweep="resident", k=K, ttile=TTILE, remainder=remainder)
    owned = resident_counts(spec, steps, remainder, vl, m)
    if (vl, m) != ODD_REACH_TILE or set(owned) != {"transpose", "sweep_1d"}:
        raise AssertionError(f"1d5p_odd bf16 at ({vl}, {m}): launches {owned} off the warp route")
    prob.run(x, 2, plan)
    y, seconds, got = counted(f"1d5p_odd bf16 resident {remainder}",
                              lambda: prob.run(x, steps, plan), owned)
    err = same(f"1d5p_odd bf16 resident {remainder} vs plain", y,
               resident_plain(spec, x, steps, remainder, vl, m, None))
    emit({"phase": "bf16", "run": "resident", "case": "1d5p_odd", "stencil": name,
          "shape": list(shape), "plan": {"k": K, "ttile": TTILE, "remainder": remainder},
          "steps": steps, "tile": {"vl": vl, "m": m}, "seconds": seconds,
          "seconds_median_of_5": host_median(lambda: prob.run(x, steps, plan)),
          "gpoint_updates_per_s": x.numel() * steps / seconds, "launches": got,
          "max_abs_err_vs_plain": err, "bitwise": True})
    del y
    t = sk.block_transpose(x, vl, m)
    buf = torch.empty_like(t)
    weight = torch.tensor(spec.coeff_array(), dtype=bf16, device=dev)[None, None]
    for depth in (4, 2, 1):
        kk, tt = (K, depth // K) if depth > K else (depth, 1)
        err = same(f"1d5p_odd bf16 K1 depth {depth}", sk.stencil1d_sweep_ttile(spec, t, kk, tt),
                   sk.stencil1d_sweep_ttile_ref(spec, t, kk, tt))
        row("K1", "stencil1d_sweep_ttile",
            f"{name} {x.numel()} bf16 vl={vl} m={m} depth={depth}; route sweep_1d "
            "(r = 2 > M = 1)", "sweep1d_warp_bf16", got["sweep_1d"], err,
            lambda: sk.stencil1d_sweep_ttile(spec, t, kk, tt, out=buf),
            lambda: sk.stencil1d_sweep_ttile_ref(spec, t, kk, tt),
            simt_bound(2 * x.numel() * 2, depth * spec.flops_per_point * x.numel(), 2),
            lambda: ms(conv_steps, spec, x, depth, weight), launches_at_tile=got["sweep_1d"],
            instances=[list(p) for p in sk.sweep1d_launches(m, depth, spec.r)])
    del x, t, buf, weight
    torch.cuda.empty_cache()

    # -- 3d27p: the box order on the 3-D streaming kernel, a resident fused
    # run counted at the picker's tile and at the tuner's (the any-vl
    # instances, equal to the first), then at each tile K3 at depth 4 timed
    # and depths 2, 1 and K4b's ring and open held bit for bit -------------
    name, shape = BOX_CASE
    dims = "x".join(map(str, shape))
    prob = StencilProblem(name, shape)
    spec = prob.spec
    x = prob.init(SEED)
    weight = torch.tensor(spec.coeff_array(), dtype=x.dtype, device=dev)[None, None]
    remainder, steps = PLANS[0]
    box_runs, first = {}, None
    for plan_tile in ((None, None), TUNER_TILE):
        vl, m, t0 = ops.pick_tile(spec, shape, *plan_tile)
        plan = StencilPlan(backend="pallas", sweep="resident", k=K, ttile=TTILE,
                           remainder=remainder, vl=plan_tile[0] or 8, m=plan_tile[1])
        owned = resident_counts(spec, steps, remainder, vl, m)
        if set(owned) - {k2_key(vl, m)} != {"sweep_3d"}:
            raise AssertionError(f"{name} at vl={vl}, m={m}: the schedule's launches {owned} "
                                 "are not on sweep_3d")
        prob.run(x, 2, plan)
        y, seconds, got = counted(f"{name} resident {remainder} vl={vl} m={m}",
                                  lambda: prob.run(x, steps, plan), owned)
        err = same(f"{name} resident {remainder} vl={vl} m={m} vs plain", y,
                   resident_plain(spec, x, steps, remainder, vl, m, t0))
        if first is None:
            first = (y, vl)
        else:
            same(f"{name} resident {remainder} vl={vl} m={m} vs vl={first[1]}", y, first[0])
        box_runs[(vl, m, t0)] = got["sweep_3d"]
        emit({"phase": "main_path", "case": name, "shape": list(shape),
              "plan": {"k": K, "ttile": TTILE, "remainder": remainder}, "steps": steps,
              "tile": {"vl": vl, "m": m, "t0": t0}, "route": "sweep_3d", "seconds": seconds,
              "seconds_median_of_5": host_median(lambda: prob.run(x, steps, plan)),
              "gpoint_updates_per_s": x.numel() * steps / seconds, "launches": got,
              "max_abs_err_vs_plain": err, "bitwise": True})
        del y
    del first
    for (vl, m, t0), at_tile in box_runs.items():
        t = sk.block_transpose(x, vl, m)
        buf = torch.empty_like(t)
        for depth in (2, 1):
            same(f"{name} K3 vl={vl} m={m} depth {depth}",
                 sk.stencil_nd_sweep_ttile(spec, t, depth, 1, t0),
                 sk.stencil_nd_sweep_ttile_ref(spec, t, depth, 1, t0))
            for edge_mask in (True, False):
                same(f"{name} K4b vl={vl} m={m} edge_mask={edge_mask} depth {depth}",
                     sk.stencil_nd_multistep(spec, t, depth, t0, edge_mask),
                     sk.stencil_nd_multistep_ref(spec, t, depth, t0, edge_mask))
        err = same(f"{name} K3 vl={vl} m={m} depth {K * TTILE}",
                   sk.stencil_nd_sweep_ttile(spec, t, K, TTILE, t0),
                   sk.stencil_nd_sweep_ttile_ref(spec, t, K, TTILE, t0))
        row("K3", "stencil_nd_sweep_ttile",
            f"{name} {dims} vl={vl} m={m} depth={K * TTILE}; box order; depths 2, 1 and K4b "
            "ring/open bitwise, untimed", "sweep3d", sum(box_runs.values()), err,
            lambda: sk.stencil_nd_sweep_ttile(spec, t, K, TTILE, t0, out=buf),
            lambda: sk.stencil_nd_sweep_ttile_ref(spec, t, K, TTILE, t0),
            bound(2 * x.numel() * 4, K * TTILE * spec.flops_per_point * x.numel()),
            lambda: ms(conv_steps, spec, x, K * TTILE, weight), launches_at_tile=at_tile)
        del t, buf
    del x, weight
    torch.cuda.empty_cache()

    # -- onestep: the layout A/B, and its K5 rows (float32 and bfloat16) ----
    start = time.perf_counter()
    for dtype in (torch.float32, torch.bfloat16):
        for name, n, m, naive in ONESTEP:
            k5_rows("onestep", stencils.make(name), n, m, dtype, naive, ("reg", "reg"))
    emit({"phase": "onestep", "phase_seconds": time.perf_counter() - start})

    # -- tiles: the GPU picker's tiles off vl=32, each run vs the CPU's ------
    tile_keys = {"reg": {1: {"sweep_1d", "multistep_1d"}, 2: {"sweep_2d", "multistep_2d"},
                         3: {"sweep_3d", "multistep_3d"}},
                 "far": {nd: {"sweep_far", "multistep_far"} for nd in (1, 2, 3)}}
    for name, shape, tile_route in TILE_CASES:
        prob, prob_cpu = StencilProblem(name, shape), StencilProblem(name, shape, device="cpu")
        spec = prob.spec
        x = prob.init(SEED)
        x_cpu = x.cpu()
        vl, m, t0 = ops.pick_tile(spec, shape)
        runs = []
        for sweep, ttile in (("resident", TTILE), ("roundtrip", 1)):
            for remainder, steps in PLANS:
                plan = StencilPlan(backend="pallas", sweep=sweep, k=K, ttile=ttile,
                                   remainder=remainder)
                owned = resident_counts(spec, steps, remainder, vl, m) if sweep == "resident" \
                    else k4_counts(spec, sweep_schedule(K, steps, remainder, 1)[0], vl, m)
                runs.append((f"{sweep} {remainder} {steps}", owned,
                             lambda p, v, n=steps, plan=plan: p.run(v, n, plan)))
        runs.append((f"stencil_run {DIRICHLET_STEPS}",
                     k4_counts(spec, [(K, DIRICHLET_STEPS // K)], vl, m),
                     lambda p, v: ops.stencil_run(spec, v, DIRICHLET_STEPS, k=K)))
        for label, owned, run in runs:
            if set(owned) - {k2_key(vl, m)} - tile_keys[tile_route][spec.ndim]:
                raise AssertionError(f"tiles {name} {label} at vl={vl}, m={m}: the schedule's "
                                     f"launches {owned} leave the {tile_route} route")
            y, seconds, got = counted(f"tiles {name} {label}", lambda: run(prob, x), owned)
            same(f"tiles {name} {label} vs the CPU", y.cpu(), run(prob_cpu, x_cpu))
            emit({"phase": "tiles", "case": name, "shape": list(shape), "run": label,
                  "tile": {"vl": vl, "m": m, "t0": t0},
                  "launches": {key: n for key, n in got.items() if n}, "bitwise": True})
        del x, x_cpu

    # -- small cases on the card and on the CPU against the f64 oracle -------
    def small(case, spec, x, run, steps, bc, owned):
        y_gpu = counted(f"small {case}", lambda: run(x), owned)[0].cpu()
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
    spec = stencils.make("3d7p")
    vl, m, _ = ops.pick_tile(spec, shape)       # nb = 1: a tile wraps onto its own block
    small("3d7p", spec, x,
          lambda v: StencilProblem("3d7p", shape, device=v.device).run(v, steps, plan),
          steps, "periodic", resident_counts(spec, steps, "fused", vl, m))
    spec = stencils.make("2d5p")
    x = StencilProblem("2d5p", (64, 256)).init(SEED)
    vl, m, _ = ops.pick_tile(spec, (64, 256))
    small("2d5p dirichlet", spec, x, lambda v: ops.stencil_run(spec, v, steps, k=K),
          steps, kref.kernel_bc(2), k4_counts(spec, [(K, steps // K)], vl, m))
    del x

    paper_phases(dev, counted, same, close, host_median, ms, row, conv_steps)

    def plan_counts(spec, plan, steps):
        """The launches a run of ``plan`` makes on its engine's routes."""
        if plan.backend == "jnp":
            return {}
        if plan.backend == "mxu":
            return {"transpose": 2,
                    "mxu": sum(n for _, n in sweep_schedule(plan.k, steps, plan.remainder,
                                                            plan.ttile)[0])}
        vl, m = plan.vl, plan.m
        if plan.sweep == "resident":
            return resident_counts(spec, steps, plan.remainder, vl, m, k=plan.k,
                                   ttile=plan.ttile)
        return k4_counts(spec, sweep_schedule(plan.k, steps, plan.remainder, 1)[0], vl, m)
    auto_phase(dev, counted, same, close, host_median, plan_counts)
    stencil_serve_phase(dev, gpu, counted, same, close, host_median, row, ms, ms_slow,
                        resident_counts, k4_counts, resident_plain)
    k6_rows = ssd_phase(dev, ms, close, bound)
    served = {out["model"]: out for out in
              (serve_phase(dev, counted, close, *args) for args in SERVE_MODELS)}
    # K6's launches on the main path: the serve run of the model whose layer
    # the row describes
    for entry in k6_rows:
        kernel, run = entry.pop("kernel"), served[entry["model"]]
        # a call of the whole scan launches each kernel once
        launched = run["launches"][kernel] if kernel in ssd.LAUNCHES else \
            min(run["launches"][k] for k in ssd.LAUNCHES)
        entry["launches"] = launched
        entry["launches_per_prefill"] = launched / run["prefills"]
        entries.append(entry)
        emit({"phase": "kernels", **entry})

    emit({"phase": "total", "seconds": time.perf_counter() - run_start, "build_seconds": build_s})
    emit({"kernels": entries})
    print(gpu, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
