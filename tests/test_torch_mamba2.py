"""The port's mamba2 model and serving engine against the JAX package, at
the ``smoke()`` size (2 layers, d_model 64, state 16, head_dim 16, chunk
8), on the CPU.

Parameters come from the reference's ``init_params`` through
``convert.lm_params_from_reference``.  Logits are compared at bfloat16
grain (rtol 6e-2, atol 0.2, as ``tests/test_models_smoke.py``): both
packages run bfloat16 activations and round at different places.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as jax_get_arch
from repro.models import zoo as jzoo
from repro_torch import convert
from repro_torch.configs.base import get_arch
from repro_torch.models import transformer, zoo
from repro_torch.serve.engine import ContinuousBatcher, Request, decode_lanes

GRAIN = dict(rtol=6e-2, atol=0.2)


@pytest.fixture(scope="module")
def models():
    jcfg = jax_get_arch("mamba2-2.7b").smoke()
    cfg = get_arch("mamba2-2.7b").smoke()
    jmodel = jzoo.build(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    params = convert.lm_params_from_reference(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return jmodel, jparams, zoo.build(cfg), params


def _f32(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else a.astype(jnp.float32))


def _tokens(cfg, b, s, seed=3):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)).astype(np.int32)


def test_forward_prefill_decode_match_reference(models):
    jmodel, jparams, model, params = models
    cfg = model.cfg
    b, s, n_pre = 2, 16, 12
    toks = _tokens(cfg, b, s)
    jfull, _ = jmodel.forward(jparams, {"tokens": jnp.asarray(toks)})
    full, aux = model.forward(params, {"tokens": torch.tensor(toks)})
    assert full.dtype == torch.bfloat16 and float(aux) == 0.0
    np.testing.assert_allclose(_f32(full), _f32(jfull), **GRAIN)

    jlast, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks[:, :n_pre])},
                                   max_seq=s)
    last, cache = model.prefill(params, {"tokens": torch.tensor(toks[:, :n_pre])}, max_seq=s)
    np.testing.assert_allclose(_f32(last), _f32(jlast), **GRAIN)
    np.testing.assert_allclose(_f32(last[:, 0]), _f32(full[:, n_pre - 1]), **GRAIN)
    np.testing.assert_allclose(cache.h.numpy(), np.asarray(jcache.h), rtol=6e-2, atol=6e-2)
    for i in range(n_pre, s):
        jl, jcache = jmodel.decode_step(jparams, jcache, {"tokens": jnp.asarray(toks[:, i:i + 1])},
                                        jnp.int32(i))
        logits, cache = model.decode_step(params, cache, {"tokens": torch.tensor(toks[:, i:i + 1])},
                                          torch.tensor(i))
        np.testing.assert_allclose(_f32(logits), _f32(jl), **GRAIN, err_msg=f"pos {i}")
        np.testing.assert_allclose(_f32(logits[:, 0]), _f32(full[:, i]), **GRAIN,
                                   err_msg=f"pos {i}")


def test_cast_copy_gives_the_same_logits(models):
    """Holding the bf16 copy of the weights is the rounding the model does
    at every use: the logits are bit for bit the same."""
    _, _, model, params = models
    toks = torch.tensor(_tokens(model.cfg, 2, 9, seed=5))
    cast = transformer.cast_params(params)
    assert cast["layers"]["ssm"]["in_proj"].dtype == torch.bfloat16
    assert cast["layers"]["ssm"]["A_log"] is params["layers"]["ssm"]["A_log"]
    assert torch.equal(model.forward(params, {"tokens": toks})[0],
                       model.forward(cast, {"tokens": toks})[0])


def test_float32_model_prefill_decode_match_forward(models):
    """``act_dtype=torch.float32`` runs the whole model in float32, the
    cache included, with no module global switched: prefill then decode
    equal ``forward`` (other chunk sizes), and the default model stays
    bfloat16."""
    _, _, model, params = models
    cfg = model.cfg
    model32 = zoo.build(cfg, act_dtype=torch.float32)
    toks = torch.tensor(_tokens(cfg, 2, 14, seed=11))
    full, _ = model32.forward(params, {"tokens": toks})
    assert full.dtype == torch.float32
    last, cache = model32.prefill(params, {"tokens": toks[:, :9]}, max_seq=14)
    assert cache.conv.dtype == torch.float32
    torch.testing.assert_close(last[:, 0], full[:, 8], rtol=1e-4, atol=1e-4)
    for i in range(9, 14):
        logits, cache = model32.decode_step(params, cache, {"tokens": toks[:, i:i + 1]},
                                            torch.tensor(i))
        torch.testing.assert_close(logits[:, 0], full[:, i], rtol=1e-4, atol=1e-4)
    assert model32.init_cache(2, 8, device="cpu").conv.dtype == torch.float32
    assert model.init_cache(2, 8, device="cpu").conv.dtype == torch.bfloat16
    assert model.forward(params, {"tokens": toks})[0].dtype == torch.bfloat16


def _run_single(model, params, prompt, max_new, max_seq=64):
    eng = ContinuousBatcher(model, params, n_slots=1, max_seq=max_seq, device="cpu")
    eng.submit(Request(rid=0, prompt=prompt, max_new=max_new))
    done = eng.run(max_steps=max_seq)
    assert len(done) == 1
    return done[0].out


def test_ragged_prompts_match_single_slot_engines(models):
    _, _, model, params = models
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, model.cfg.vocab, 4), rng.integers(0, model.cfg.vocab, 11),
               rng.integers(0, model.cfg.vocab, 6)]
    max_new = 6
    expected = [_run_single(model, params, p, max_new) for p in prompts]
    eng = ContinuousBatcher(model, params, n_slots=2, max_seq=64, device="cpu")
    assert eng.lanes == decode_lanes(2) == 8
    for rid, p in enumerate(prompts):
        eng.submit(Request(rid=rid, prompt=p, max_new=max_new))
    done = sorted(eng.run(max_steps=64), key=lambda r: r.rid)
    assert [r.rid for r in done] == [0, 1, 2]
    for req, exp in zip(done, expected):
        assert req.out == exp, (req.rid, req.out, exp)
    assert eng.stats["prefills"] == 3 and eng.stats["prefill_tokens"] == 21
    assert not eng.pos.any() and eng.active == [None, None]


def test_temperature_sampling_follows_its_generator(models):
    _, _, model, params = models
    prompt = np.random.default_rng(9).integers(0, model.cfg.vocab, 5)

    def sample(seed):
        eng = ContinuousBatcher(model, params, n_slots=1, max_seq=32, temperature=1.0,
                                device="cpu", seed=seed)
        eng.submit(Request(rid=0, prompt=prompt, max_new=8))
        return eng.run(max_steps=32)[0].out

    first = sample(1)
    assert first == sample(1)
    assert all(0 <= t < model.cfg.vocab for t in first)


def test_param_count_matches_reference(models):
    jmodel, jparams, model, params = models
    assert zoo.param_count(params) == jzoo.param_count(jparams)
    want = model.cfg.param_count()
    assert abs(zoo.param_count(params) - want) / want < 0.25
    own = model.init(torch.Generator().manual_seed(0))
    assert zoo.param_count(own) == zoo.param_count(params)
    assert transformer.tree_map(lambda a: (a.shape, a.dtype), own) == \
        transformer.tree_map(lambda a: (a.shape, a.dtype), params)


def test_inputs_follow_their_generator():
    cfg = get_arch("mamba2-2.7b").smoke()
    a = zoo.batch_inputs(cfg, 2, 5, torch.Generator().manual_seed(4))
    b = zoo.batch_inputs(cfg, 2, 5, torch.Generator().manual_seed(4))
    assert a.keys() == {"tokens", "labels"} and torch.equal(a["tokens"], b["tokens"])
    assert a["tokens"].shape == (2, 5) and int(a["tokens"].max()) < cfg.vocab
    assert zoo.decode_inputs(cfg, 3, torch.Generator())["tokens"].shape == (3, 1)


def test_unported_families_raise():
    for name in ("mixtral-8x22b", "qwen2-vl-2b"):       # a MoE and a VLM config
        with pytest.raises(NotImplementedError, match="A11"):
            get_arch(name)
    with pytest.raises(ValueError, match="unknown arch"):
        get_arch("no-such-model")
    moe = dataclasses.replace(get_arch("mamba2-2.7b").smoke(), family="moe")
    with pytest.raises(NotImplementedError, match="A11"):
        zoo.build(moe)
    with pytest.raises(NotImplementedError, match="A11"):
        convert.lm_params_from_reference({}, moe, "cpu")


def test_entry_points_default_to_the_card(models):
    """Without ``device`` the engine and the cache go to the card, and
    raise where there is none: the CPU is never chosen quietly."""
    _, _, model, params = models
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the raise is for machines without one")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ContinuousBatcher(model, params, n_slots=1, max_seq=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init_cache(1, 8)
