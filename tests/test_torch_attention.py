"""The port's attention, FFN, norms, rotary embeddings (RoPE, M-RoPE) and
activations (``repro_torch.models.attention``, ``ffn``, ``blocks``)
against the JAX package's, on the CPU.

Parameters come from the reference's ``init_*`` and are carried across
with ``convert.tensors_from_reference``; inputs are numpy from a seed.
The configs are ``smoke()`` sizes (d_model 64, 4 heads of 16), with GQA
at kv = 1, 2 and 4 and a sliding window through ``dataclasses.replace``.
Tolerances: 1e-5 in float32; bfloat16 grain (rtol 6e-2, atol 0.2, as
``tests/test_torch_mamba2.py``) in bfloat16, where the two packages round
at other places.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as jax_get_arch
from repro.models import attention as jattn
from repro.models import blocks as jblocks
from repro.models import ffn as jffn
from repro_torch import convert
from repro_torch.configs.base import ArchConfig, get_arch
from repro_torch.models import attention, blocks, ffn

F32 = dict(rtol=1e-5, atol=1e-5)
GRAIN = dict(rtol=6e-2, atol=0.2)
DTYPES = {"float32": (jnp.float32, torch.float32, F32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, GRAIN)}


# the reference's attention jitted once a config (eager dispatch compiles
# every op at every shape)
_J_FULL = jax.jit(jattn.attention_full, static_argnames="cfg")
_J_DECODE = jax.jit(jattn.attention_decode, static_argnames="cfg")


def _cfgs(name="gemma-2b", **changes):
    """The reference's smoke config with ``changes`` and the port's copy."""
    jcfg = dataclasses.replace(jax_get_arch(name).smoke(), **changes)
    return jcfg, ArchConfig(**dataclasses.asdict(jcfg))


def _x(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _both(a, dtype):
    jdt, tdt, _ = DTYPES[dtype]
    return jnp.asarray(a).astype(jdt), torch.tensor(a).to(tdt)


def _np(a):
    return a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a.astype(jnp.float32))


def _params(tree):
    return convert.tensors_from_reference(jax.tree.map(np.asarray, tree), "cpu")


def test_config_copies_match_reference():
    for name in ("zamba2-2.7b", "gemma-2b", "starcoder2-7b", "deepseek-coder-33b",
                 "nemotron-4-15b"):
        assert dataclasses.asdict(get_arch(name)) == dataclasses.asdict(jax_get_arch(name))
        assert get_arch(name).param_count() == jax_get_arch(name).param_count()


# ---------------------------------------------------------------------------
# norms, rotary embeddings, activations
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norm_matches_reference(kind, dtype):
    jx, x = _both(_x((3, 5, 64), 1, 3.0) + 0.5, dtype)
    jp = jblocks.init_norm(kind, 64)
    jp = jax.tree.map(lambda a: a + 0.1 * jnp.asarray(_x(a.shape, 2)), jp)
    p = _params(jp)
    assert p.keys() == blocks.init_norm(kind, 64, "cpu").keys()
    got = blocks.apply_norm(kind, p, x)
    assert got.dtype == x.dtype
    np.testing.assert_allclose(_np(got), _np(jblocks.apply_norm(kind, jp, jx)),
                               **DTYPES[dtype][2])


def test_unknown_norm_raises():
    with pytest.raises(ValueError):
        blocks.init_norm("groupnorm", 8, "cpu")
    with pytest.raises(ValueError):
        blocks.apply_norm("groupnorm", {}, torch.zeros(2, 8))


@pytest.mark.parametrize("theta", [10_000.0, 100_000.0])
@pytest.mark.parametrize("head_dim", [16, 80, 256])
def test_rope_freqs_match_reference(head_dim, theta):
    np.testing.assert_allclose(blocks.rope_freqs(head_dim, theta).numpy(),
                               np.asarray(jblocks.rope_freqs(head_dim, theta)), rtol=1e-6)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("positions", ["shared", "per_sequence"])
def test_rope_matches_reference(positions, dtype):
    b, s, h, d = 2, 7, 3, 16
    jx, x = _both(_x((b, s, h, d), 3), dtype)
    if positions == "shared":
        pos = np.arange(s)[None, :]
    else:
        pos = np.random.default_rng(4).integers(0, 5000, (b, s))
    got = blocks.apply_rope(x, torch.tensor(pos), 10_000.0)
    want = jblocks.apply_rope(jx, jnp.asarray(pos, jnp.int32), 10_000.0)
    assert got.dtype == x.dtype
    np.testing.assert_allclose(_np(got), _np(want), **DTYPES[dtype][2])


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("sections", [(2, 3, 3), (8, 0, 0), (1, 1, 6)])
def test_mrope_matches_reference(sections, dtype):
    b, s, h, d = 2, 6, 2, 16
    jx, x = _both(_x((b, s, h, d), 5), dtype)
    pos3 = np.random.default_rng(6).integers(0, 300, (b, s, 3))
    got = blocks.apply_mrope(x, torch.tensor(pos3), 1e6, sections)
    want = jblocks.apply_mrope(jx, jnp.asarray(pos3, jnp.int32), 1e6, sections)
    np.testing.assert_allclose(_np(got), _np(want), **DTYPES[dtype][2])
    with pytest.raises(ValueError, match="sum"):
        blocks.apply_mrope(x, torch.tensor(pos3), 1e6, (1, 1, 1))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", ["gelu", "sq_relu", "swiglu", "geglu"])
def test_activation_matches_reference(name, dtype):
    jx, x = _both(np.linspace(-4.0, 4.0, 801, dtype=np.float32), dtype)
    got = blocks.act_fn(name)(x)
    np.testing.assert_allclose(_np(got), _np(jblocks.act_fn(name)(jx)),
                               **(dict(rtol=1e-6, atol=1e-6) if dtype == "float32"
                                  else dict(rtol=1e-2, atol=1e-2)))
    assert blocks.is_gated(name) == jblocks.is_gated(name)


def test_unknown_activation_raises():
    with pytest.raises(ValueError):
        blocks.act_fn("relu6")


# ---------------------------------------------------------------------------
# FFN
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("act", ["gelu", "sq_relu", "swiglu", "geglu"])
def test_ffn_matches_reference(act, dtype):
    jp = jffn.init_ffn(jax.random.PRNGKey(1), 64, 128, act)
    p = _params(jp)
    own = ffn.init_ffn(torch.Generator().manual_seed(1), 64, 128, act)
    assert {k: v.shape for k, v in own.items()} == {k: v.shape for k, v in p.items()}
    jx, x = _both(_x((2, 5, 64), 7), dtype)
    np.testing.assert_allclose(_np(ffn.apply_ffn(p, x, act)),
                               _np(jffn.apply_ffn(jp, jx, act)), **DTYPES[dtype][2])


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def _attn_setup(kv, window=None, seed=0):
    jcfg, cfg = _cfgs(n_kv_heads=kv, window=window)
    jp = jattn.init_attention(jax.random.PRNGKey(seed), jcfg)
    return jcfg, cfg, jp, _params(jp)


@pytest.mark.parametrize("window", [None, 5])
def test_causal_mask_matches_reference(window):
    np.testing.assert_array_equal(attention.causal_mask(9, window).numpy(),
                                  np.asarray(jattn.causal_mask(9, window)))


def test_init_attention_shapes():
    _, cfg, _, p = _attn_setup(2)
    own = attention.init_attention(torch.Generator().manual_seed(0), cfg)
    assert {k: v.shape for k, v in own.items()} == {k: v.shape for k, v in p.items()}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("window", [None, 4])
@pytest.mark.parametrize("kv", [1, 2, 4])
def test_attention_full_matches_reference(kv, window, dtype):
    jcfg, cfg, jp, p = _attn_setup(kv, window)
    jx, x = _both(_x((2, 11, cfg.d_model), 8), dtype)
    jout, (jk, jv) = _J_FULL(jp, jx, cfg=jcfg)
    out, (k, v) = attention.attention_full(p, x, cfg)
    assert out.dtype == x.dtype and k.shape == (2, 11, kv, cfg.head_dim)
    tol = DTYPES[dtype][2]
    np.testing.assert_allclose(_np(out), _np(jout), **tol)
    np.testing.assert_allclose(_np(k), _np(jk), **tol)
    np.testing.assert_allclose(_np(v), _np(jv), **tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_attention_full_with_explicit_positions(dtype):
    jcfg, cfg, jp, p = _attn_setup(2)
    jx, x = _both(_x((2, 6, cfg.d_model), 9), dtype)
    pos = np.random.default_rng(10).integers(0, 100, (2, 6))
    jout, _ = _J_FULL(jp, jx, cfg=jcfg, positions=jnp.asarray(pos, jnp.int32))
    out, _ = attention.attention_full(p, x, cfg, positions=torch.tensor(pos))
    np.testing.assert_allclose(_np(out), _np(jout), **DTYPES[dtype][2])


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_mrope_attention_matches_reference(dtype):
    jcfg, cfg = _cfgs("qwen2-vl-2b")
    jp = jattn.init_attention(jax.random.PRNGKey(2), jcfg)
    p = _params(jp)
    jx, x = _both(_x((1, 5, cfg.d_model), 11), dtype)
    pos3 = np.random.default_rng(12).integers(0, 50, (1, 5, 3))
    jout, _ = _J_FULL(jp, jx, cfg=jcfg, pos3=jnp.asarray(pos3, jnp.int32))
    out, _ = attention.attention_full(p, x, cfg, pos3=torch.tensor(pos3))
    np.testing.assert_allclose(_np(out), _np(jout), **DTYPES[dtype][2])
    with pytest.raises(ValueError, match="pos3"):
        attention.attention_full(p, x, cfg)


def _decode_run(kv, window, dtype, positions, steps=6, max_seq=12):
    """Decode ``steps`` tokens from a random cache: the reference's
    outputs and final cache, and the port's (whose cache is updated in
    place)."""
    jcfg, cfg, jp, p = _attn_setup(kv, window, seed=3)
    jdt, tdt, _ = DTYPES[dtype]
    b = len(positions)
    jcache = jattn.init_kv_cache(jcfg, b, max_seq, dtype=jdt)
    cache = attention.init_kv_cache(cfg, b, max_seq, dtype=tdt)
    assert cache.k.shape == jcache.k.shape and cache.k.dtype == tdt
    # the cache holds earlier tokens: the same random contents in both
    k0, v0 = _x(cache.k.shape, 13), _x(cache.v.shape, 14)
    jcache = jattn.KVCache(jnp.asarray(k0).astype(jdt), jnp.asarray(v0).astype(jdt))
    cache.k.copy_(torch.tensor(k0))
    cache.v.copy_(torch.tensor(v0))
    xs = _x((steps, b, 1, cfg.d_model), 15)
    outs, jouts = [], []
    for i in range(steps):
        jx, x = _both(xs[i], dtype)
        if len(set(positions)) == 1:
            jpos, pos = jnp.int32(positions[0] + i), torch.tensor(positions[0] + i)
        else:
            pos_i = np.asarray(positions) + i
            jpos, pos = jnp.asarray(pos_i, jnp.int32), torch.tensor(pos_i)
        jo, jcache = _J_DECODE(jp, jx, jcache, jpos, cfg=jcfg)
        o, same = attention.attention_decode(p, x, cache, pos, cfg)
        assert same is cache
        outs.append(o)
        jouts.append(jo)
    return outs, jouts, cache, jcache


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("window", [None, 4])
@pytest.mark.parametrize("kv", [1, 2, 4])
@pytest.mark.parametrize("positions", [(3, 3), (0, 5, 2)], ids=["scalar", "vector"])
def test_attention_decode_matches_reference(positions, kv, window, dtype):
    outs, jouts, cache, jcache = _decode_run(kv, window, dtype, positions)
    tol = DTYPES[dtype][2]
    for i, (o, jo) in enumerate(zip(outs, jouts)):
        np.testing.assert_allclose(_np(o), _np(jo), **tol, err_msg=f"step {i}")
    np.testing.assert_allclose(_np(cache.k), _np(jcache.k), **tol)
    np.testing.assert_allclose(_np(cache.v), _np(jcache.v), **tol)


def test_window_ring_has_window_slots():
    _, cfg = _cfgs(window=4)
    assert attention.init_kv_cache(cfg, 2, 12).k.shape[1] == 4
    assert attention.init_kv_cache(cfg, 2, 3).k.shape[1] == 3
    _, full = _cfgs()
    assert attention.init_kv_cache(full, 2, 12).k.shape[1] == 12


def test_scalar_and_vector_positions_agree():
    """A vector of equal positions decodes as the scalar position does."""
    a = _decode_run(2, 4, "float32", (5, 5))
    jcfg, cfg, jp, p = _attn_setup(2, 4, seed=3)
    cache = attention.init_kv_cache(cfg, 2, 12, dtype=torch.float32)
    cache.k.copy_(torch.tensor(_x(cache.k.shape, 13)))
    cache.v.copy_(torch.tensor(_x(cache.v.shape, 14)))
    xs = _x((len(a[0]), 2, 1, cfg.d_model), 15)
    for i in range(len(a[0])):
        o, _ = attention.attention_decode(p, torch.tensor(xs[i]), cache,
                                          torch.tensor([5 + i, 5 + i]), cfg)
        torch.testing.assert_close(o, a[0][i], rtol=0, atol=0)
