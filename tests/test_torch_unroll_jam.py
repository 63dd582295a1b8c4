"""Time-loop unroll-and-jam in the port (``core/unroll_jam.py``) against the
JAX reference, on the CPU.

  * ``multistep_fused`` at k ∈ {1, 2, 3} on all eight registry stencils,
    periodic and Dirichlet: within 1e-5 of the reference's (its tolerance,
    ``tests/test_core_vectorize.py``) and bit for bit the port's
    ``apply_steps``;
  * ``multistep_pipelined`` (Algorithm 1) on the reference's cases (1d3p and
    1d5p at vl, m ∈ {(4, 4), (8, 8), (8, 4)}, k ∈ {1, 2, 3}, and 37 blocks):
    within 2e-5 of the reference's and of the port's Dirichlet
    ``apply_steps`` — bit for bit the latter, which is asserted;
  * its argument checks.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import stencils as jst
from repro.core import unroll_jam as juj
from repro_torch.core import stencils as tst
from repro_torch.core import unroll_jam as tuj

NAMES = ["1d3p", "1d5p", "2d5p", "2d9p", "3d7p", "3d27p", "heat1d", "heat2d"]
SHAPES = {1: (128,), 2: (16, 64), 3: (8, 4, 64)}


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("bc", ["periodic", "dirichlet"])
@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("name", NAMES)
def test_multistep_fused_matches_reference(name, k, bc):
    spec = tst.make(name)
    x = _x(SHAPES[spec.ndim], 0)
    got = tuj.multistep_fused(spec, torch.from_numpy(x), k, bc)
    want = np.asarray(juj.multistep_fused(jst.make(name), jnp.asarray(x), k, bc))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert torch.equal(got, tst.apply_steps(spec, torch.from_numpy(x), k, bc))


@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("name,vl,m,blocks", [
    ("1d3p", 4, 4, None), ("1d3p", 8, 8, None), ("1d3p", 8, 4, None),
    ("1d5p", 4, 4, None), ("1d5p", 8, 8, None), ("1d3p", 4, 4, 37),
])
def test_multistep_pipelined_matches_reference(name, vl, m, blocks, k):
    spec = tst.make(name)
    x = np.random.default_rng(1).standard_normal(vl * m * (blocks or k + 3)).astype(np.float32)
    got = tuj.multistep_pipelined(spec, torch.from_numpy(x), k, vl=vl, m=m)
    want = np.asarray(juj.multistep_pipelined(jst.make(name), jnp.asarray(x), k, vl=vl, m=m))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    oracle = tst.apply_steps(spec, torch.from_numpy(x), k, bc="dirichlet")
    np.testing.assert_allclose(got.numpy(), oracle.numpy(), rtol=2e-5, atol=2e-5)
    assert torch.equal(got, oracle)


def test_ring_masks_match_reference():
    for vl, m, r in ((4, 4, 1), (8, 4, 2), (8, 8, 3), (4, 2, 2)):
        for got, want in zip(tuj._ring_masks(vl, m, r), juj._ring_masks(vl, m, r)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_multistep_pipelined_checks_its_arguments():
    x = torch.zeros(64)
    with pytest.raises(ValueError, match="1-D"):
        tuj.multistep_pipelined(tst.make("2d5p"), torch.zeros(8, 64), 2)
    with pytest.raises(ValueError, match="halo"):
        tuj.multistep_pipelined(tst.make("1d5p"), x, 2, vl=32, m=1)
    with pytest.raises(ValueError, match="blocks"):
        tuj.multistep_pipelined(tst.make("1d3p"), x, 3, vl=4, m=8)
