"""Decoder stacks for the ssm, dense and hybrid families.

  dense           : [norm→attn→res] [norm→ffn→res] × n_layers
  ssm             : [norm→ssd→res] × n_layers
  hybrid (zamba2) : the ssm backbone, and ONE weight-shared attn+ffn block
                    applied after every ``shared_attn_every`` layers

Parameters are nested dicts of tensors with the layers stacked on a
leading ``n_layers`` axis, the reference's pytree layout, so a converted
reference tree and ``init_params`` have the same structure; the hybrid's
``shared`` block is not stacked.  The layers are run by a Python loop over
that axis (inference only, no remat); the hybrid is a loop of
``n_layers / shared_attn_every`` super-blocks.  The moe, audio and vlm
families raise ``NotImplementedError`` naming ROADMAP A11.

Activations run in ``act_dtype``, an argument of ``forward``, ``prefill``,
``decode_step`` and ``init_cache`` (bfloat16 by default, as the reference;
``zoo.build(cfg, act_dtype=torch.float32)`` gives the float32 model).  The
caches follow ``act_dtype``: the float32 model holds float32 K and V and
SSM conv rows, where the reference casts a seeded KV cache to bfloat16
always.  ``cast_params`` holds the activation-dtype copy of every weight
that the reference casts at each use: the same rounding, paid once instead
of at every call, so a decode step reads bfloat16 weights.
``decode_step`` updates the cache in place and returns it.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.api import resolve_device
from repro_torch.models import attention, blocks, ffn, ssm

FAMILIES = ("ssm", "dense", "hybrid")


class Model(NamedTuple):
    cfg: ArchConfig
    init: Any                 # (generator) -> params
    forward: Any              # (params, batch) -> (logits, aux)
    prefill: Any              # (params, batch, max_seq) -> (logits_last, cache)
    decode_step: Any          # (params, cache, batch1, pos) -> (logits, cache)
    init_cache: Any           # (batch, max_seq, device) -> cache


def check_family(cfg: ArchConfig) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported yet; the port runs the "
            "ssm, dense and hybrid families (MoE and the audio and VLM frontends are "
            "ROADMAP A11)")
    if cfg.family == "hybrid" and (cfg.shared_attn_every < 1
                                   or cfg.n_layers % cfg.shared_attn_every):
        raise ValueError(f"{cfg.name}: {cfg.n_layers} layers are not whole super-blocks "
                         f"of {cfg.shared_attn_every}")


def tree_map(fn, *trees):
    """Apply ``fn`` leaf-wise over nested dicts / NamedTuples of tensors."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, tuple):
        return type(first)(*(tree_map(fn, *leaves) for leaves in zip(*trees)))
    return fn(*trees)


def tree_leaves(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out


def _layer(params, i: int) -> dict:
    return tree_map(lambda a: a[i], params["layers"])


def _stacked(ones: list):
    """A list of same-shaped trees as one tree stacked on a leading axis."""
    return tree_map(lambda *leaves: torch.stack(leaves), *ones)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def _init_layer(gen: torch.Generator, cfg: ArchConfig) -> dict:
    dev = gen.device
    if cfg.family in ("ssm", "hybrid"):
        return {"norm": blocks.init_norm(cfg.norm, cfg.d_model, dev),
                "ssm": ssm.init_ssm(gen, cfg)}
    return {"norm1": blocks.init_norm(cfg.norm, cfg.d_model, dev),
            "norm2": blocks.init_norm(cfg.norm, cfg.d_model, dev),
            "attn": attention.init_attention(gen, cfg),
            "ffn": ffn.init_ffn(gen, cfg.d_model, cfg.d_ff, cfg.act)}


def init_params(gen: torch.Generator, cfg: ArchConfig) -> dict:
    """Float32 master parameters on ``gen``'s device, drawn from ``gen``.
    The stacked layer tensors are filled one layer at a time (peak memory
    is the model plus one layer)."""
    check_family(cfg)
    dev = gen.device
    embed = blocks.truncated_normal_init(gen, (cfg.vocab, cfg.d_model), cfg.d_model ** -0.5)
    layers = None
    for i in range(cfg.n_layers):
        one = _init_layer(gen, cfg)
        if layers is None:
            layers = tree_map(lambda a: a.new_empty((cfg.n_layers,) + a.shape), one)
        tree_map(lambda big, small: big[i].copy_(small), layers, one)
    p = {"embed": embed, "norm_f": blocks.init_norm(cfg.norm, cfg.d_model, dev),
         "layers": layers}
    if not cfg.tie_embeddings:
        p["head"] = blocks.dense_init(gen, cfg.d_model, cfg.vocab)
    if cfg.family == "hybrid":
        p["shared"] = {"norm1": blocks.init_norm(cfg.norm, cfg.d_model, dev),
                       "norm2": blocks.init_norm(cfg.norm, cfg.d_model, dev),
                       "attn": attention.init_attention(gen, cfg),
                       "ffn": ffn.init_ffn(gen, cfg.d_model, cfg.d_ff, cfg.act)}
    return p


# the weights the reference casts to the activation dtype at every use
_CAST = frozenset({"embed", "head", "in_proj", "out_proj", "conv_w", "conv_b", "D",
                   "wq", "wk", "wv", "wo", "w_in", "w_gate", "w_out"})


def cast_params(params: dict, dtype=blocks.ACT_DTYPE) -> dict:
    """A copy of ``params`` with every weight that the model casts to the
    activation dtype at its use held in that dtype already; norm scales and
    biases, ``A_log`` and ``dt_bias`` (used in float32) are shared, not
    copied."""
    def walk(tree):
        return {k: walk(v) if isinstance(v, dict) else (v.to(dtype) if k in _CAST else v)
                for k, v in tree.items()}
    return walk(params)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _embed_in(params, batch, cfg: ArchConfig, act_dtype: torch.dtype) -> torch.Tensor:
    e = params["embed"].to(act_dtype)[batch["tokens"]]
    if cfg.family == "dense":
        # the reference multiplies by a Python float, which stays in the
        # activation dtype: √d rounded to that dtype first
        e = e * torch.tensor(math.sqrt(cfg.d_model), dtype=act_dtype).item()
    return e


def _lm_head(params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    h = blocks.apply_norm(cfg.norm, params["norm_f"], x)
    if cfg.tie_embeddings:
        w = params["embed"].to(h.dtype).T
    else:
        w = params["head"].to(h.dtype)
    return h @ w


def _attn_ffn(p: dict, x: torch.Tensor, cfg: ArchConfig, attend):
    """[norm→attn→res] [norm→ffn→res]; ``attend(p_attn, h)`` → (out, kv)."""
    a, kv = attend(p["attn"], blocks.apply_norm(cfg.norm, p["norm1"], x))
    x = x + a
    x = x + ffn.apply_ffn(p["ffn"], blocks.apply_norm(cfg.norm, p["norm2"], x), cfg.act)
    return x, kv


def _apply_attn_block(p: dict, x: torch.Tensor, cfg: ArchConfig):
    """One dense layer (or the hybrid's shared block) over the full
    sequence; returns (x, (k, v))."""
    return _attn_ffn(p, x, cfg, lambda pa, h: attention.attention_full(pa, h, cfg))


def _ssm_layer(lp: dict, x: torch.Tensor, cfg: ArchConfig, return_state: bool = False):
    h = blocks.apply_norm(cfg.norm, lp["norm"], x)
    if return_state:
        o, st = ssm.ssd_full(lp["ssm"], h, cfg, return_state=True)
        return x + o, st
    return x + ssm.ssd_full(lp["ssm"], h, cfg)


def _seed_kv(k: torch.Tensor, v: torch.Tensor, t: int, cfg: ArchConfig) -> attention.KVCache:
    """Place the last ≤ t keys and values into a length-t cache buffer laid
    out for ``attention_decode`` (ring order where there is a window)."""
    s = k.shape[1]
    if s >= t:
        buf_k, buf_v = k[:, s - t:], v[:, s - t:]
    else:
        pad = (0, 0, 0, 0, 0, t - s)
        buf_k, buf_v = torch.nn.functional.pad(k, pad), torch.nn.functional.pad(v, pad)
    if cfg.window:
        # ring layout: absolute position p lives at slot p % t
        shift = max(0, s - t) % t
        buf_k, buf_v = torch.roll(buf_k, shift, dims=1), torch.roll(buf_v, shift, dims=1)
    return attention.KVCache(buf_k.contiguous(), buf_v.contiguous())


# ---------------------------------------------------------------------------
# forward / prefill / decode
# ---------------------------------------------------------------------------

def forward(params, batch, cfg: ArchConfig, act_dtype: torch.dtype = blocks.ACT_DTYPE):
    """Full-sequence forward → (logits, aux)."""
    check_family(cfg)
    x = _embed_in(params, batch, cfg, act_dtype)
    if cfg.family == "dense":
        for i in range(cfg.n_layers):
            x, _ = _apply_attn_block(_layer(params, i), x, cfg)
    else:
        for i in range(cfg.n_layers):
            x = _ssm_layer(_layer(params, i), x, cfg)
            if cfg.family == "hybrid" and (i + 1) % cfg.shared_attn_every == 0:
                x, _ = _apply_attn_block(params["shared"], x, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return _lm_head(params, x, cfg), aux


def init_cache(cfg: ArchConfig, batch: int, max_seq: int, device=None,
               act_dtype: torch.dtype = blocks.ACT_DTYPE):
    """The decode cache, stacked over layers: ``KVCache`` (dense),
    ``SSMState`` (ssm, constant in ``max_seq``) or, for the hybrid,
    ``{"ssm": SSMState, "kv": KVCache}`` with one KV cache a super-block."""
    check_family(cfg)
    dev = resolve_device(device)

    def stack(one, n):
        return tree_map(lambda a: a.new_zeros((n,) + a.shape), one)

    if cfg.family == "dense":
        return stack(attention.init_kv_cache(cfg, batch, max_seq, act_dtype, dev), cfg.n_layers)
    states = stack(ssm.init_ssm_state(cfg, batch, act_dtype, device=dev), cfg.n_layers)
    if cfg.family == "ssm":
        return states
    return {"ssm": states,
            "kv": stack(attention.init_kv_cache(cfg, batch, max_seq, act_dtype, dev),
                        cfg.n_layers // cfg.shared_attn_every)}


def decode_step(params, cache, batch, pos, cfg: ArchConfig,
                act_dtype: torch.dtype = blocks.ACT_DTYPE):
    """batch: one-token inputs ({'tokens': (B, 1)}); pos: the new token's
    position, a scalar or a ``(B,)`` tensor of per-sequence positions (the
    SSM layers' state carries theirs) → (logits (B, 1, V), cache).  The
    cache is updated in place."""
    check_family(cfg)
    x = _embed_in(params, batch, cfg, act_dtype)

    def attend(kv):
        return lambda pa, h: attention.attention_decode(pa, h, kv, pos, cfg)

    if cfg.family == "dense":
        for i in range(cfg.n_layers):
            kv = attention.KVCache(cache.k[i], cache.v[i])
            x, _ = _attn_ffn(_layer(params, i), x, cfg, attend(kv))
        return _lm_head(params, x, cfg), cache

    states = cache["ssm"] if cfg.family == "hybrid" else cache
    for i in range(cfg.n_layers):
        lp = _layer(params, i)
        h = blocks.apply_norm(cfg.norm, lp["norm"], x)
        o, st = ssm.ssd_decode(lp["ssm"], h, ssm.SSMState(states.h[i], states.conv[i]), cfg)
        states.h[i].copy_(st.h)
        states.conv[i].copy_(st.conv)
        x = x + o
        if cfg.family == "hybrid" and (i + 1) % cfg.shared_attn_every == 0:
            j = i // cfg.shared_attn_every
            kv = attention.KVCache(cache["kv"].k[j], cache["kv"].v[j])
            x, _ = _attn_ffn(params["shared"], x, cfg, attend(kv))
    return _lm_head(params, x, cfg), cache


def prefill(params, batch, cfg: ArchConfig, max_seq: int | None = None,
            act_dtype: torch.dtype = blocks.ACT_DTYPE):
    """Run the full sequence, return (last-token logits, primed cache).  The
    SSM states come from ``ssd_full(return_state=True)``, the KV caches from
    each attention block's K and V, padded to ``max_seq`` (the window's
    ring where there is one; the hybrid's caches are always ``max_seq``
    long)."""
    check_family(cfg)
    x = _embed_in(params, batch, cfg, act_dtype)
    max_seq = max_seq or x.shape[1]
    kvs, states = [], []
    if cfg.family == "dense":
        t = attention.cache_len(cfg, max_seq)
        for i in range(cfg.n_layers):
            x, (k, v) = _apply_attn_block(_layer(params, i), x, cfg)
            kvs.append(_seed_kv(k, v, t, cfg))
        cache = _stacked(kvs)
    else:
        for i in range(cfg.n_layers):
            x, st = _ssm_layer(_layer(params, i), x, cfg, return_state=True)
            states.append(st)
            if cfg.family == "hybrid" and (i + 1) % cfg.shared_attn_every == 0:
                x, (k, v) = _apply_attn_block(params["shared"], x, cfg)
                kvs.append(_seed_kv(k, v, max_seq, cfg))
        cache = _stacked(states)
        if cfg.family == "hybrid":
            cache = {"ssm": cache, "kv": _stacked(kvs)}
    return _lm_head(params, x[:, -1:, :], cfg), cache
