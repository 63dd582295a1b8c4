"""The banded-operator (mxu) engine in the port (``core/matrixize.py``, the
``*_sweep_mxu`` wrappers and ``ops.stencil_sweep_mxu``) against the JAX
reference, on the CPU.  The reference's own ``tests/test_matrixize.py``
does not import on this jax, so its functions are called directly.

  * ``one_step_band``, ``band_power`` and the packed ``operator`` tables
    equal the reference's exactly (float64 numpy) on every registry stencil
    at depths 1–4 and tiles (4, 4), (8, 4);
  * ``operator_bytes_bound``, ``OPERATOR_BUDGET`` (and its environment
    override) and ``accum_dtype`` agree with the reference;
  * ``apply_banded`` against the reference's and the float64 oracle
    (``depth`` layout steps in float64): 2e-6 (f32) at depth 1, 1e-4 (f32)
    deeper, 4e-2 (bf16) — the reference's conformance tolerances; the halo
    forms on ghosts wrapped from the periodic grid equal the periodic
    product bit for bit;
  * ``stencil_sweep_mxu`` over (steps, k, ttile, remainder) against the
    reference's at 1e-4 and the float64 oracle at 1e-4 (float32) and 1e-12
    (float64); no launch is counted on the CPU;
  * ``exact_products`` restores whichever TF32 and bf16-reduction flags a
    caller set (one fresh process each).
"""
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import matrixize as jmx
from repro.core import stencils as jst
from repro.kernels import ops as jops
from repro_torch.core import layouts
from repro_torch.core import matrixize as tmx
from repro_torch.core import stencils as tst
from repro_torch.core.vectorize import step_in_layout
from repro_torch.kernels import ops
from repro_torch.kernels import stencil_kernels as sk

ROOT = Path(__file__).resolve().parents[1]
NAMES = ["1d3p", "1d5p", "2d5p", "2d9p", "3d7p", "3d27p", "heat1d", "heat2d"]
SHAPES = {1: (128,), 2: (8, 64), 3: (4, 4, 64)}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _same_band(a, b):
    assert sorted(a) == sorted(b)
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=str(key))


def _oracle_layout(spec, t, depth):
    """``depth`` periodic layout steps in float64."""
    t = t.double()
    for _ in range(depth):
        t = step_in_layout(spec, t, spec.ndim)
    return t


@pytest.mark.parametrize("vl,m", [(4, 4), (8, 4)])
@pytest.mark.parametrize("depth", [1, 2, 3, 4])
@pytest.mark.parametrize("name", NAMES)
def test_bands_and_operator_match_reference(name, depth, vl, m):
    spec, jspec = tst.make(name), jst.make(name)
    np.testing.assert_array_equal(tmx.layout_perm(vl, m), jmx.layout_perm(vl, m))
    one = tmx.one_step_band(spec, vl, m)
    _same_band(one, jmx.one_step_band(jspec, vl, m))
    _same_band(tmx.band_power(one, depth), jmx.band_power(jmx.one_step_band(jspec, vl, m), depth))
    op, jop = tmx.operator(spec, vl, m, depth), jmx.operator(jspec, vl, m, depth)
    assert (op.ndim, op.vl, op.m, op.depth, op.offsets) == \
        (jop.ndim, jop.vl, jop.m, jop.depth, jop.offsets)
    assert op.table.dtype == np.float64
    np.testing.assert_array_equal(op.table, jop.table)
    assert (op.B, op.n_off, op.block_reach()) == (jop.B, jop.n_off, jop.block_reach())
    assert [op.lead_reach(a) for a in range(spec.ndim - 1)] == \
        [jop.lead_reach(a) for a in range(spec.ndim - 1)]
    assert tmx.operator(spec, vl, m, depth) is op        # cached


def test_bytes_bound_budget_and_accum_dtype():
    for name in NAMES:
        for vl, m in ((4, 4), (8, 8), (32, 8), (2, 1)):
            for depth in (1, 2, 4, 16):
                assert tmx.operator_bytes_bound(tst.make(name), vl, m, depth) == \
                    jmx.operator_bytes_bound(jst.make(name), vl, m, depth)
    assert tmx.OPERATOR_BUDGET == jmx.OPERATOR_BUDGET
    for tdt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16),
                     (torch.float64, jnp.float64)):
        assert str(tmx.accum_dtype(tdt)).split(".")[-1] == jmx.accum_dtype(jdt).name
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), REPRO_MXU_OPERATOR_BUDGET="12345")
    out = subprocess.run([sys.executable, "-c", "from repro_torch.core import matrixize; "
                          "print(matrixize.OPERATOR_BUDGET)"], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.strip() == "12345", out.stderr
    with pytest.raises(ValueError, match="d >= 1"):
        tmx.band_power(tmx.one_step_band(tst.make("1d3p"), 4, 4), 0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("depth", [1, 2, 3])
@pytest.mark.parametrize("name", NAMES)
def test_apply_banded_matches_reference(name, depth, dtype):
    spec, jspec = tst.make(name), jst.make(name)
    vl, m = 8, 4
    x = _x(SHAPES[spec.ndim])
    t = layouts.to_transpose_layout(torch.from_numpy(x).to(TORCH_DT[dtype]), vl, m)
    got = tmx.apply_banded(tmx.operator(spec, vl, m, depth), t)
    assert got.dtype == t.dtype and got.shape == t.shape
    jt = jnp.asarray(t.float().numpy()).astype(jnp.dtype(dtype))
    want = np.asarray(jmx.apply_banded(jmx.operator(jspec, vl, m, depth), jt).astype(jnp.float32))
    oracle = _oracle_layout(spec, t, depth).numpy()
    tol = 4e-2 if dtype == "bfloat16" else (2e-6 if depth == 1 else 1e-4)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)
    np.testing.assert_allclose(got.float().numpy(), oracle, rtol=tol, atol=tol)


def _ghosts(t, axis, h):
    """``t`` with ``h`` periodic ghosts a side along ``axis``."""
    n = t.shape[axis]
    return torch.cat([t.narrow(axis, n - h, h), t, t.narrow(axis, 0, h)], dim=axis)


@pytest.mark.parametrize("name", NAMES)
def test_halo_forms_on_wrapped_ghosts(name):
    """A ghost-extended shard whose ghosts are the periodic neighbours gives
    the periodic product on its interior, on every combination of halo
    axes, bit for bit; the reference's halo form agrees at 1e-4."""
    spec, jspec = tst.make(name), jst.make(name)
    vl, m, depth = 4, 4, 2
    t = layouts.to_transpose_layout(torch.from_numpy(_x(SHAPES[spec.ndim], 1)), vl, m)
    op = tmx.operator(spec, vl, m, depth)
    want = tmx.apply_banded(op, t)
    nlead = spec.ndim - 1
    hb = op.block_reach()
    combos = [(lead, b) for b in (0, hb, hb + 1)
              for lead in ([()] if nlead == 0 else
                           [tuple(h if a == i else 0 for a in range(nlead))
                            for i in range(nlead) for h in (op.lead_reach(i), 3)]
                           + [(0,) * nlead])]
    for lead, block in combos:
        if not block and not any(lead):
            continue
        ext = t
        for a, h in enumerate(lead):
            if h:
                ext = _ghosts(ext, a, h)
        if block:
            ext = _ghosts(ext, ext.ndim - 3, block)
        if nlead == 0:
            got = sk.stencil1d_sweep_mxu_halo(spec, ext, depth, block)
            jgot = jmx.apply_banded(jmx.operator(jspec, vl, m, depth), jnp.asarray(ext.numpy()),
                                    block_halo=block)
        else:
            got = sk.stencil_nd_sweep_mxu_halo(spec, ext, depth, lead, block)
            jgot = jmx.apply_banded(jmx.operator(jspec, vl, m, depth), jnp.asarray(ext.numpy()),
                                    lead_halo=lead, block_halo=block)
        assert torch.equal(got, want), (lead, block)
        np.testing.assert_allclose(got.numpy(), np.asarray(jgot), rtol=1e-4, atol=1e-4)
    if nlead == 0:      # depth 17 reaches two blocks of 16: one ghost block is short
        with pytest.raises(ValueError, match="block reach"):
            sk.stencil1d_sweep_mxu_halo(spec, _ghosts(t, 0, 1), 17, 1)


# (steps, k, ttile, remainder): divisible and ragged steps, both policies,
# a temporal tile; the reference compiles a program a case
SWEEPS = [(4, 2, 1, "fused"), (5, 2, 1, "native"), (9, 2, 2, "fused"), (7, 3, 2, "native")]


@pytest.mark.parametrize("steps,k,ttile,remainder", SWEEPS)
@pytest.mark.parametrize("name", NAMES)
def test_sweep_mxu_matches_reference(name, steps, k, ttile, remainder):
    spec = tst.make(name)
    x = _x(SHAPES[spec.ndim], 2)
    sk.reset_launches()
    got = ops.stencil_sweep_mxu(spec, torch.from_numpy(x), steps, k=k, vl=8, m=4,
                                remainder=remainder, ttile=ttile)
    assert sk.LAUNCHES == dict.fromkeys(sk.LAUNCHES, 0)      # CPU: nothing counted
    want = np.asarray(jops.stencil_sweep_mxu(jst.make(name), jnp.asarray(x), steps, k=k, vl=8,
                                             m=4, remainder=remainder, ttile=ttile))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    oracle = tst.apply_steps(spec, torch.from_numpy(x).double(), steps).numpy()
    np.testing.assert_allclose(got.numpy(), oracle, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", NAMES)
def test_sweep_mxu_f64_matches_oracle(name):
    """In float64 the product runs in float64: the oracle within 1e-12 over
    the (steps, k, ttile, remainder) matrix, and at the picker's tile."""
    spec = tst.make(name)
    x = torch.from_numpy(_x(SHAPES[spec.ndim], 3)).double()
    for k in (1, 2, 3):
        for remainder in ("fused", "native"):
            for ttile in (1, 2):
                for steps in (2 * k, 2 * k + max(1, k - 1)):
                    got = ops.stencil_sweep_mxu(spec, x, steps, k=k, vl=4, m=4,
                                                remainder=remainder, ttile=ttile)
                    np.testing.assert_allclose(got.numpy(), tst.apply_steps(spec, x, steps),
                                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(ops.stencil_sweep_mxu(spec, x, 3).numpy(),
                               tst.apply_steps(spec, x, 3), rtol=1e-12, atol=1e-12)
    assert ops.stencil_sweep_mxu(spec, x, 0) is x
    with pytest.raises(ValueError, match="remainder"):
        ops.stencil_sweep_mxu(spec, x, 3, remainder="tail")


_FLAGS = """
import sys, torch
from repro_torch.core import matrixize
mm = torch.backends.cuda.matmul
setup = sys.argv[1]
if setup == "legacy_tf32": mm.allow_tf32 = True
if setup == "legacy_ieee": mm.allow_tf32 = False
if setup == "new_tf32": mm.fp32_precision = "tf32"
if setup == "medium": torch.set_float32_matmul_precision("medium")
if setup == "bf16_reduced": mm.allow_bf16_reduced_precision_reduction = (True, True)
if setup == "bf16_exact": mm.allow_bf16_reduced_precision_reduction = False
def read(f):
    try:
        return f()
    except RuntimeError:
        return "raises"
def state():
    return (read(lambda: mm.allow_tf32), mm.fp32_precision,
            read(torch.get_float32_matmul_precision),
            torch._C._get_cublas_allow_bf16_reduced_precision_reduction())
before = state()
with matrixize.exact_products():
    inside = state()
after = state()
assert inside[:3] == (False, "ieee", "highest"), inside
assert inside[3] == (False, True), inside
assert after == before, (before, after)
print("ok", before)
"""


SETUPS = ["default", "legacy_tf32", "new_tf32", "medium", "bf16_reduced"]


@pytest.fixture(scope="module")
def flag_runs():
    """One fresh process a setup, all started together."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = {setup: subprocess.Popen([sys.executable, "-c", _FLAGS, setup], env=env, cwd=ROOT,
                                     stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for setup in SETUPS}
    return {setup: (p, *p.communicate(timeout=120)) for setup, p in procs.items()}


@pytest.mark.parametrize("setup", SETUPS)
def test_exact_products_restores_the_flags(flag_runs, setup):
    proc, out, err = flag_runs[setup]
    assert proc.returncode == 0 and out.startswith("ok"), err
