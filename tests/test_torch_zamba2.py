"""The port's hybrid family (zamba2: a Mamba2 backbone and one
weight-shared attention + FFN block after every 6 SSM layers) against the
JAX package's, at the ``smoke()`` size (12 layers, d_model 64, state 16,
4 heads of 16), on the CPU, and its serving through ``ContinuousBatcher``.

The checks are ``tests/_torch_lm.py``'s: against the reference run in
float32, the port's float32 model within 1e-4 and its served bfloat16
model at bfloat16 grain (rtol 6e-2, atol 0.2).
"""
import jax
import numpy as np
import pytest
import torch

import _torch_lm as lm
from repro_torch import convert
from repro_torch.models import attention, ssm, zoo

NAME = "zamba2-2.7b"


@pytest.fixture(scope="module")
def pair():
    return lm.Pair(NAME)


def test_smoke_shape(pair):
    cfg = pair.cfg
    assert cfg.family == "hybrid" and cfg.n_layers == 12 and cfg.shared_attn_every == 6
    assert set(pair.params) == {"embed", "norm_f", "layers", "head", "shared"}
    assert pair.params["shared"]["attn"]["wq"].shape == (64, 64)      # not stacked


@pytest.mark.parametrize("dtype", list(lm.TOL))
@pytest.mark.parametrize("vector", [False, True], ids=["scalar", "vector"])
def test_forward_prefill_decode_match_reference(pair, vector, dtype):
    lm.check_forward_prefill_decode(pair, dtype, vector)


@pytest.mark.parametrize("dtype", list(lm.TOL))
def test_caches_after_prefill_match_reference(pair, dtype):
    jcache, cache = lm.prefill_caches(pair, dtype)
    assert set(cache) == {"ssm", "kv"}
    assert isinstance(cache["ssm"], ssm.SSMState) and isinstance(cache["kv"], attention.KVCache)
    # one KV cache a super-block, max_seq long (the hybrid's t is max_seq)
    assert cache["kv"].k.shape == (2, 2, 20, 4, 16)
    lm.check_kv(cache["kv"], jcache["kv"], dtype)
    assert cache["ssm"].h.shape == jcache["ssm"].h.shape == (12, 2, 8, 16, 16)
    h_tol = lm.F32 if dtype == "float32" else dict(rtol=6e-2, atol=6e-2)
    np.testing.assert_allclose(cache["ssm"].h.numpy(), np.asarray(jcache["ssm"].h), **h_tol)
    np.testing.assert_allclose(lm.f32(cache["ssm"].conv), lm.f32(jcache["ssm"].conv),
                               **lm.TOL[dtype])
    assert not cache["kv"].k[:, :, 13:].any()          # zeros past the prompt


def test_init_cache_layout(pair):
    cache = pair.model.init_cache(8, 32, device="cpu")
    assert cache["ssm"].h.shape == (12, 8, 8, 16, 16) and cache["ssm"].h.dtype == torch.float32
    assert cache["ssm"].conv.dtype == torch.bfloat16
    assert cache["kv"].k.shape == (2, 8, 32, 4, 16) and cache["kv"].k.dtype == torch.bfloat16


def test_cast_copy_gives_the_same_logits(pair):
    cast = lm.check_cast_copy(pair)
    assert cast["shared"]["attn"]["wo"].dtype == torch.bfloat16
    assert cast["shared"]["ffn"]["w_gate"].dtype == torch.bfloat16
    assert cast["shared"]["norm1"]["scale"] is pair.params["shared"]["norm1"]["scale"]


def test_float32_model_prefill_decode_match_forward(pair):
    lm.check_float32_prefill_decode(pair)


def test_ragged_prompts_match_single_slot_engines(pair):
    lm.check_ragged_batcher(pair)


def test_param_count_matches_reference(pair):
    lm.check_param_count(pair)
    want = pair.cfg.param_count()
    assert abs(zoo.param_count(pair.params) - want) / want < 0.25


def test_converting_a_tree_without_its_shared_block_raises(pair):
    tree = {k: v for k, v in jax.tree.map(np.asarray, pair.jparams).items() if k != "shared"}
    with pytest.raises(ValueError, match="shared"):
        convert.lm_params_from_reference(tree, pair.cfg, "cpu")
