"""The port's dense family (gemma-2b, starcoder2-7b, deepseek-coder-33b,
nemotron-4-15b: GQA from kv = 1 to 4 heads at ``smoke()``, rmsnorm and
layernorm, GeGLU, GELU, SwiGLU and squared-ReLU) against the JAX
package's, at the ``smoke()`` size (2 layers, d_model 64, 4 heads of 16),
on the CPU, and its serving through ``ContinuousBatcher``.  gemma-2b also
runs with an 8-token sliding window (``dataclasses.replace``): a ring
cache, seeded past its length.

The checks are ``tests/_torch_lm.py``'s: against the reference run in
float32, the port's float32 model within 1e-4 and its served bfloat16
model at bfloat16 grain (rtol 6e-2, atol 0.2).
"""
import numpy as np
import pytest
import torch

import _torch_lm as lm
from repro_torch.models import transformer, zoo

CONFIGS = {"gemma-2b": {}, "starcoder2-7b": {}, "deepseek-coder-33b": {},
           "nemotron-4-15b": {}, "gemma-2b-window8": {"window": 8}}
_PAIRS = {}


@pytest.fixture(scope="module", params=list(CONFIGS))
def pair(request):
    if request.param not in _PAIRS:
        _PAIRS[request.param] = lm.Pair(request.param.removesuffix("-window8"),
                                        **CONFIGS[request.param])
    return _PAIRS[request.param]


def test_smoke_shape(pair):
    cfg = pair.cfg
    assert cfg.family == "dense" and cfg.n_layers == 2 and cfg.d_model == 64
    assert "shared" not in pair.params
    assert pair.params["layers"]["attn"]["wk"].shape == (2, 64, cfg.n_kv_heads * 16)


@pytest.mark.parametrize("dtype", list(lm.TOL))
@pytest.mark.parametrize("vector", [False, True], ids=["scalar", "vector"])
def test_forward_prefill_decode_match_reference(pair, vector, dtype):
    lm.check_forward_prefill_decode(pair, dtype, vector)


@pytest.mark.parametrize("dtype", list(lm.TOL))
def test_kv_cache_after_prefill_matches_reference(pair, dtype):
    jcache, cache = lm.prefill_caches(pair, dtype)
    t = min(20, pair.cfg.window) if pair.cfg.window else 20
    assert cache.k.shape == (2, 2, t, pair.cfg.n_kv_heads, 16)
    lm.check_kv(cache, jcache, dtype)


def test_init_cache_layout(pair):
    cache = pair.model.init_cache(8, 32, device="cpu")
    t = min(32, pair.cfg.window) if pair.cfg.window else 32
    assert cache.k.shape == (2, 8, t, pair.cfg.n_kv_heads, 16)
    assert cache.k.dtype == torch.bfloat16
    assert zoo.build(pair.cfg, act_dtype=torch.float32).init_cache(
        1, 4, device="cpu").v.dtype == torch.float32


def test_cast_copy_gives_the_same_logits(pair):
    cast = lm.check_cast_copy(pair)
    assert cast["layers"]["ffn"]["w_out"].dtype == torch.bfloat16
    assert cast["layers"]["norm1"]["scale"] is pair.params["layers"]["norm1"]["scale"]


def test_float32_model_prefill_decode_match_forward(pair):
    lm.check_float32_prefill_decode(pair)


def test_ragged_prompts_match_single_slot_engines(pair):
    lm.check_ragged_batcher(pair, lengths=(4, 11, 6) if not pair.cfg.window else (4, 13, 9))


def test_param_count_matches_reference(pair):
    lm.check_param_count(pair)


def test_embedding_scale_rounds_its_scalar_first(pair):
    """The reference scales the embedding by a Python float, which stays in
    the activation dtype: √d rounds to bfloat16 before the product."""
    toks = torch.tensor(lm.tokens(pair.cfg, 1, 7))
    got = transformer._embed_in(pair.params, {"tokens": toks}, pair.cfg, torch.bfloat16)
    scale = torch.tensor(np.sqrt(pair.cfg.d_model), dtype=torch.bfloat16)
    want = pair.params["embed"].to(torch.bfloat16)[toks] * scale
    assert torch.equal(got, want)
