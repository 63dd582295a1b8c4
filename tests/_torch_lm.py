"""Checks shared by the port's LM tests (``test_torch_zamba2.py``,
``test_torch_dense.py``): a family's model against the JAX package's at
``smoke()`` size, on the CPU.

Parameters come from the reference's ``init_params`` through
``convert.lm_params_from_reference``; inputs are numpy from a seed.  The
reference's model functions are jitted once a config and activation
dtype (eager dispatch compiles every op at every shape).

Two comparisons, both against the reference run in float32 (its
``blocks.ACT_DTYPE`` set to float32 while it traces and runs, and set
back after):
  * the port's float32 model (``zoo.build(cfg, act_dtype=torch.float32)``)
    within rtol = atol = 1e-4;
  * the port's served bfloat16 model at bfloat16 grain (rtol 6e-2, atol
    0.2, as ``tests/test_torch_mamba2.py``).
The float32 run is the function both bfloat16 models approximate: at
zamba2's 12 smoke layers the reference's own bfloat16 logits stray 0.21
from it, as far as the grain allows, so its bfloat16 run is no yardstick.
"""
import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs.base import get_arch as jax_get_arch
from repro.models import blocks as jblocks
from repro.models import zoo as jzoo
from repro_torch import convert
from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer, zoo
from repro_torch.serve.engine import ContinuousBatcher, Request, decode_lanes

GRAIN = dict(rtol=6e-2, atol=0.2)
F32 = dict(rtol=1e-4, atol=1e-4)
TOL = {"float32": F32, "bfloat16": GRAIN}


@contextlib.contextmanager
def reference_in_float32():
    """The reference's activations in float32 (its embedding, caches and
    everything downstream) for the duration."""
    saved = jblocks.ACT_DTYPE
    jblocks.ACT_DTYPE = jnp.float32
    try:
        yield
    finally:
        jblocks.ACT_DTYPE = saved


class Reference:
    """The reference's forward, prefill and decode in float32, jitted (each
    traced, and so fixed to float32, on its first call)."""

    def __init__(self, jmodel, jparams):
        self.params = jparams
        # fresh partials: a jit cache of its own, apart from any bf16 trace
        self._forward = jax.jit(functools.partial(jmodel.forward))
        self._prefill = jax.jit(functools.partial(jmodel.prefill), static_argnames="max_seq")
        self._decode = jax.jit(functools.partial(jmodel.decode_step))

    def forward(self, toks):
        with reference_in_float32():
            return self._forward(self.params, {"tokens": jnp.asarray(toks)})[0]

    def prefill(self, toks, max_seq):
        with reference_in_float32():
            return self._prefill(self.params, {"tokens": jnp.asarray(toks)}, max_seq=max_seq)

    def decode(self, cache, toks, pos):
        with reference_in_float32():
            return self._decode(self.params, cache, {"tokens": jnp.asarray(toks)}, pos)


class Pair:
    """The reference's model and parameters beside the port's (its bfloat16
    served model and its float32 model)."""

    def __init__(self, name: str, **changes):
        self.jcfg = dataclasses.replace(jax_get_arch(name).smoke(), **changes)
        self.cfg = ArchConfig(**dataclasses.asdict(self.jcfg))
        jmodel = jzoo.build(self.jcfg)
        self.jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
        self.ref = Reference(jmodel, self.jparams)
        self.model = zoo.build(self.cfg)
        self.models = {"bfloat16": self.model,
                       "float32": zoo.build(self.cfg, act_dtype=torch.float32)}
        self.params = convert.lm_params_from_reference(
            jax.tree.map(np.asarray, self.jparams), self.cfg, "cpu")


def f32(a) -> np.ndarray:
    return a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a.astype(jnp.float32))


def tokens(cfg, b, s, seed=3) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)).astype(np.int32)


def check_forward_prefill_decode(pair: Pair, dtype: str, vector: bool, b=2, s=16, n_pre=11):
    """forward, then prefill of ``n_pre`` tokens and decode of the rest, the
    port's ``dtype`` model each against the reference (``vector``:
    per-sequence positions, lane j at i + 2j)."""
    model, tol = pair.models[dtype], TOL[dtype]
    toks = tokens(pair.cfg, b, s)
    full, aux = model.forward(pair.params, {"tokens": torch.tensor(toks)})
    assert full.dtype == getattr(torch, dtype) and full.shape == (b, s, pair.cfg.vocab)
    assert float(aux) == 0.0
    np.testing.assert_allclose(f32(full), f32(pair.ref.forward(toks)), **tol)

    jlast, jcache = pair.ref.prefill(toks[:, :n_pre], max_seq=s)
    last, cache = model.prefill(pair.params, {"tokens": torch.tensor(toks[:, :n_pre])},
                                max_seq=s)
    np.testing.assert_allclose(f32(last), f32(jlast), **tol)
    for i in range(n_pre, s):
        if vector:
            pos = np.minimum(i + 2 * np.arange(b), s - 1)
            jpos, tpos = jnp.asarray(pos, jnp.int32), torch.tensor(pos)
        else:
            jpos, tpos = jnp.int32(i), torch.tensor(i)
        jl, jcache = pair.ref.decode(jcache, toks[:, i:i + 1], jpos)
        logits, same = model.decode_step(pair.params, cache,
                                         {"tokens": torch.tensor(toks[:, i:i + 1])}, tpos)
        assert same is cache                     # updated in place
        np.testing.assert_allclose(f32(logits), f32(jl), **tol, err_msg=f"pos {i}")


def prefill_caches(pair: Pair, dtype: str, b=2, n_pre=13, max_seq=20):
    """The reference's and the port's ``dtype`` model's caches after one
    prefill."""
    toks = tokens(pair.cfg, b, n_pre, seed=4)
    _, jcache = pair.ref.prefill(toks, max_seq=max_seq)
    _, cache = pair.models[dtype].prefill(pair.params, {"tokens": torch.tensor(toks)},
                                          max_seq=max_seq)
    return jcache, cache


def check_kv(kv, jkv, dtype: str):
    assert kv.k.shape == jkv.k.shape and kv.k.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(f32(kv.k), f32(jkv.k), **TOL[dtype])
    np.testing.assert_allclose(f32(kv.v), f32(jkv.v), **TOL[dtype])


def check_float32_prefill_decode(pair: Pair, s=14, n_pre=9):
    """The float32 model: prefill then decode equal its forward (float32
    caches), with no module global switched."""
    model32 = pair.models["float32"]
    toks = torch.tensor(tokens(pair.cfg, 2, s, seed=11))
    full, _ = model32.forward(pair.params, {"tokens": toks})
    assert full.dtype == torch.float32
    last, cache = model32.prefill(pair.params, {"tokens": toks[:, :n_pre]}, max_seq=s)
    assert all(t.dtype in (torch.float32, torch.int64) for t in transformer.tree_leaves(cache))
    torch.testing.assert_close(last[:, 0], full[:, n_pre - 1], rtol=1e-4, atol=1e-4)
    for i in range(n_pre, s):
        logits, cache = model32.decode_step(pair.params, cache, {"tokens": toks[:, i:i + 1]},
                                            torch.tensor([i, i]))
        torch.testing.assert_close(logits[:, 0], full[:, i], rtol=1e-4, atol=1e-4)


def check_cast_copy(pair: Pair):
    """Holding the bf16 copy of the weights is the rounding the model does
    at every use: the logits are bit for bit the same."""
    toks = torch.tensor(tokens(pair.cfg, 2, 9, seed=5))
    cast = transformer.cast_params(pair.params)
    assert any(t.dtype == torch.bfloat16 for t in transformer.tree_leaves(cast["layers"]))
    assert torch.equal(pair.model.forward(pair.params, {"tokens": toks})[0],
                       pair.model.forward(cast, {"tokens": toks})[0])
    return cast


def run_single(model, params, prompt, max_new, max_seq=64):
    eng = ContinuousBatcher(model, params, n_slots=1, max_seq=max_seq, device="cpu")
    eng.submit(Request(rid=0, prompt=prompt, max_new=max_new))
    done = eng.run(max_steps=max_seq)
    assert len(done) == 1
    return done[0].out


def check_ragged_batcher(pair: Pair, lengths=(4, 11, 6), max_new=6, max_seq=40):
    """Ragged prompts through a 2-slot batcher give the tokens of fresh
    1-slot engines."""
    model, params = pair.model, pair.params
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, pair.cfg.vocab, n) for n in lengths]
    expected = [run_single(model, params, p, max_new, max_seq) for p in prompts]
    eng = ContinuousBatcher(model, params, n_slots=2, max_seq=max_seq, device="cpu")
    assert eng.lanes == decode_lanes(2) == 8
    for rid, p in enumerate(prompts):
        eng.submit(Request(rid=rid, prompt=p, max_new=max_new))
    done = sorted(eng.run(max_steps=64), key=lambda r: r.rid)
    assert [r.rid for r in done] == list(range(len(prompts)))
    for req, exp in zip(done, expected):
        assert req.out == exp, (req.rid, req.out, exp)
    assert eng.stats["prefills"] == len(prompts)
    assert eng.stats["prefill_tokens"] == sum(lengths)
    assert not eng.pos.any() and eng.active == [None, None]


def check_param_count(pair: Pair):
    assert zoo.param_count(pair.params) == jzoo.param_count(pair.jparams)
    own = pair.model.init(torch.Generator().manual_seed(0))
    assert zoo.param_count(own) == zoo.param_count(pair.params)
    assert transformer.tree_map(lambda a: (a.shape, a.dtype), own) == \
        transformer.tree_map(lambda a: (a.shape, a.dtype), pair.params)
