"""Decoder stacks: the SSM family ([norm→ssd→res] × n_layers).

Parameters are nested dicts of tensors with the layers stacked on a
leading ``n_layers`` axis, the reference's pytree layout, so a converted
reference tree and ``init_params`` have the same structure; the layers are
run by a Python loop over that axis (inference only, no remat).  The other
families (dense, moe, audio, vlm, hybrid) raise ``NotImplementedError``
naming ROADMAP A11.

Activations run in ``act_dtype``, an argument of ``forward``, ``prefill``,
``decode_step`` and ``init_cache`` (bfloat16 by default, as the reference;
``zoo.build(cfg, act_dtype=torch.float32)`` gives the float32 model).
``cast_params`` holds the activation-dtype copy of every weight that the
reference casts at each use: the same rounding, paid once instead of at
every call, so a decode step reads bfloat16 weights.  ``decode_step``
updates the cache in place and returns it.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.api import resolve_device
from repro_torch.models import blocks, ssm


class Model(NamedTuple):
    cfg: ArchConfig
    init: Any                 # (generator) -> params
    forward: Any              # (params, batch) -> (logits, aux)
    prefill: Any              # (params, batch, max_seq) -> (logits_last, cache)
    decode_step: Any          # (params, cache, batch1, pos) -> (logits, cache)
    init_cache: Any           # (batch, max_seq, device) -> cache


def check_family(cfg: ArchConfig) -> None:
    if cfg.family != "ssm":
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported yet; the port runs the "
            "SSM family only (attention, MoE and hybrid stacks are ROADMAP A11)")


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


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def _init_layer(gen: torch.Generator, cfg: ArchConfig) -> dict:
    return {"norm": blocks.init_norm(cfg.norm, cfg.d_model, gen.device),
            "ssm": ssm.init_ssm(gen, cfg)}


def init_params(gen: torch.Generator, cfg: ArchConfig) -> dict:
    """Float32 master parameters on ``gen``'s device, drawn from ``gen``.
    The stacked layer tensors are filled one layer at a time (peak memory
    is the model plus one layer)."""
    check_family(cfg)
    embed = blocks.truncated_normal_init(gen, (cfg.vocab, cfg.d_model), cfg.d_model ** -0.5)
    layers = None
    for i in range(cfg.n_layers):
        one = _init_layer(gen, cfg)
        if layers is None:
            layers = tree_map(lambda a: a.new_empty((cfg.n_layers,) + a.shape), one)
        tree_map(lambda big, small: big[i].copy_(small), layers, one)
    p = {"embed": embed, "norm_f": blocks.init_norm(cfg.norm, cfg.d_model, gen.device),
         "layers": layers}
    if not cfg.tie_embeddings:
        p["head"] = blocks.dense_init(gen, cfg.d_model, cfg.vocab)
    return p


# the weights the reference casts to the activation dtype at every use
_CAST = frozenset({"embed", "head", "in_proj", "out_proj", "conv_w", "conv_b", "D"})


def cast_params(params: dict, dtype=blocks.ACT_DTYPE) -> dict:
    """A copy of ``params`` with every weight that the model casts to the
    activation dtype at its use held in that dtype already; norm scales,
    ``A_log`` and ``dt_bias`` (used in float32) are shared, not copied."""
    def walk(tree):
        return {k: walk(v) if isinstance(v, dict) else (v.to(dtype) if k in _CAST else v)
                for k, v in tree.items()}
    return walk(params)


# ---------------------------------------------------------------------------
# forward / decode
# ---------------------------------------------------------------------------

def _embed_in(params, batch, act_dtype: torch.dtype) -> torch.Tensor:
    return params["embed"].to(act_dtype)[batch["tokens"]]


def _lm_head(params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    h = blocks.apply_norm(cfg.norm, params["norm_f"], x)
    if cfg.tie_embeddings:
        w = params["embed"].to(h.dtype).T
    else:
        w = params["head"].to(h.dtype)
    return h @ w


def forward(params, batch, cfg: ArchConfig, act_dtype: torch.dtype = blocks.ACT_DTYPE):
    """Full-sequence forward → (logits, aux)."""
    check_family(cfg)
    x = _embed_in(params, batch, act_dtype)
    for i in range(cfg.n_layers):
        lp = _layer(params, i)
        x = x + ssm.ssd_full(lp["ssm"], blocks.apply_norm(cfg.norm, lp["norm"], x), cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return _lm_head(params, x, cfg), aux


def init_cache(cfg: ArchConfig, batch: int, max_seq: int, device=None,
               act_dtype: torch.dtype = blocks.ACT_DTYPE) -> ssm.SSMState:
    """Per-layer SSM states stacked over layers (constant in ``max_seq``)."""
    check_family(cfg)
    one = ssm.init_ssm_state(cfg, batch, act_dtype, device=resolve_device(device))
    return tree_map(lambda a: a.new_zeros((cfg.n_layers,) + a.shape), one)


def decode_step(params, cache: ssm.SSMState, batch, pos, cfg: ArchConfig,
                act_dtype: torch.dtype = blocks.ACT_DTYPE):
    """batch: one-token inputs ({'tokens': (B, 1)}); pos: per-sequence
    positions (unused by the SSM family, whose state carries them) →
    (logits (B, 1, V), cache).  The cache is updated in place."""
    check_family(cfg)
    x = _embed_in(params, batch, act_dtype)
    for i in range(cfg.n_layers):
        lp = _layer(params, i)
        h = blocks.apply_norm(cfg.norm, lp["norm"], x)
        o, st = ssm.ssd_decode(lp["ssm"], h, ssm.SSMState(cache.h[i], cache.conv[i]), cfg)
        cache.h[i].copy_(st.h)
        cache.conv[i].copy_(st.conv)
        x = x + o
    return _lm_head(params, x, cfg), cache


def prefill(params, batch, cfg: ArchConfig, max_seq: int | None = None,
            act_dtype: torch.dtype = blocks.ACT_DTYPE):
    """Run the full sequence, return (last-token logits, primed cache); the
    SSM states come from ``ssd_full(return_state=True)``."""
    check_family(cfg)
    x = _embed_in(params, batch, act_dtype)
    states = []
    for i in range(cfg.n_layers):
        lp = _layer(params, i)
        h = blocks.apply_norm(cfg.norm, lp["norm"], x)
        o, st = ssm.ssd_full(lp["ssm"], h, cfg, return_state=True)
        states.append(st)
        x = x + o
    cache = ssm.SSMState(torch.stack([s.h for s in states]),
                         torch.stack([s.conv for s in states]))
    return _lm_head(params, x[:, -1:, :], cfg), cache
