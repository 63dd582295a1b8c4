"""The port's Mamba2 / SSD block (``repro_torch.models.ssm``) against the
JAX package's ``models/ssm.py``, in float32 on the CPU.

Parameters come from the reference's ``init_ssm`` and are carried across
with ``convert.tensors_from_reference``; inputs are numpy from a seed.
Tolerances are the reference suite's (``tests/test_ssm.py``): rtol 1e-4,
atol 1e-5 (the chunked scan and the recurrence sum in different orders).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as jax_get_arch
from repro.models import ssm as jssm
from repro_torch import convert
from repro_torch.configs.base import get_arch
from repro_torch.models import ssm

TOL = dict(rtol=1e-4, atol=1e-5)


def _setup(seq=24, batch=2, chunk=8, seed=0):
    jcfg = dataclasses.replace(jax_get_arch("mamba2-2.7b").smoke(), ssm_chunk=chunk)
    cfg = dataclasses.replace(get_arch("mamba2-2.7b").smoke(), ssm_chunk=chunk)
    jp = jssm.init_ssm(jax.random.PRNGKey(seed), jcfg)
    p = convert.tensors_from_reference(jax.tree.map(np.asarray, jp), "cpu")
    x = (0.5 * np.random.default_rng(seed + 1).standard_normal(
        (batch, seq, cfg.d_model))).astype(np.float32)
    return jcfg, cfg, jp, p, x


def test_config_copy_matches_reference():
    assert dataclasses.asdict(get_arch("mamba2-2.7b")) == \
        dataclasses.asdict(jax_get_arch("mamba2-2.7b"))


@pytest.mark.parametrize("chunk", [4, 8, 12, 24])
def test_ssd_full_matches_reference(chunk):
    jcfg, cfg, jp, p, x = _setup(chunk=chunk)
    want = np.asarray(jssm.ssd_full(jp, jnp.asarray(x), jcfg))
    got = ssm.ssd_full(p, torch.tensor(x), cfg).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(ssm.ssd_reference(p, torch.tensor(x), cfg).numpy(), want,
                               **TOL)


def test_return_state_matches_reference():
    jcfg, cfg, jp, p, x = _setup(seq=20, chunk=8)      # 20 tokens run at Q = 5
    jout, jst = jssm.ssd_full(jp, jnp.asarray(x), jcfg, return_state=True)
    out, st = ssm.ssd_full(p, torch.tensor(x), cfg, return_state=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(st.h.numpy(), np.asarray(jst.h), **TOL)
    np.testing.assert_allclose(st.conv.numpy(), np.asarray(jst.conv), **TOL)


def test_state_handoff_prefill_to_decode():
    """Prefill 16 tokens, decode the rest one by one: the outputs and states
    match the reference's ssd_decode chain and the full-sequence output."""
    jcfg, cfg, jp, p, x = _setup(seq=24)
    full = ssm.ssd_full(p, torch.tensor(x), cfg)
    _, st = ssm.ssd_full(p, torch.tensor(x[:, :16]), cfg, return_state=True)
    _, jst = jssm.ssd_full(jp, jnp.asarray(x[:, :16]), jcfg, return_state=True)
    outs = []
    for t in range(16, 24):
        o, st = ssm.ssd_decode(p, torch.tensor(x[:, t:t + 1]), st, cfg)
        jo, jst = jssm.ssd_decode(jp, jnp.asarray(x[:, t:t + 1]), jst, jcfg)
        np.testing.assert_allclose(o.numpy(), np.asarray(jo), **TOL)
        outs.append(o)
    np.testing.assert_allclose(st.h.numpy(), np.asarray(jst.h), **TOL)
    np.testing.assert_allclose(st.conv.numpy(), np.asarray(jst.conv), **TOL)
    np.testing.assert_allclose(torch.cat(outs, dim=1).numpy(), full[:, 16:].numpy(), **TOL)


def test_decode_state_is_constant_size():
    _, cfg, _, p, x = _setup()
    st = ssm.init_ssm_state(cfg, 2, device="cpu")
    sizes = [v.numel() for v in st]
    _, st2 = ssm.ssd_decode(p, torch.tensor(x[:, :1]), st, cfg)
    assert [v.numel() for v in st2] == sizes


def test_decay_stability_long_sequence():
    _, cfg, _, p, x = _setup(seq=96, chunk=16)
    y = ssm.ssd_full(p, torch.tensor(x), cfg)
    assert torch.isfinite(y).all()
    assert float(y.abs().max()) < 1e3


def test_returned_conv_state_owns_its_memory():
    """The conv tail is a copy: a view into the projection would keep every
    layer's (B, S, ·) projection alive until the prefill stacks the states."""
    _, cfg, _, p, x = _setup(seq=24)
    _, st = ssm.ssd_full(p, torch.tensor(x), cfg, return_state=True)
    assert st.conv.shape == (2, cfg.ssm_conv - 1, cfg.d_inner + 2 * cfg.ssm_state)
    assert st.conv.untyped_storage().nbytes() == st.conv.numel() * st.conv.element_size()
