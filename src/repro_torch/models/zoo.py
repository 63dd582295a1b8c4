"""Model zoo: ArchConfig → Model (init/forward/prefill/decode) and
synthetic inputs.

Inputs are drawn from an explicit ``torch.Generator`` (on the device the
inputs go to).  The token families (ssm, dense, hybrid) are built;
``loss_fn`` waits for training (ROADMAP A11).
"""
from __future__ import annotations

import functools

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import blocks, transformer


def build(cfg: ArchConfig, act_dtype: torch.dtype = blocks.ACT_DTYPE) -> transformer.Model:
    """The model of ``cfg`` with ``act_dtype`` activations (bfloat16 by
    default, as the reference)."""
    transformer.check_family(cfg)
    return transformer.Model(
        cfg=cfg,
        init=functools.partial(transformer.init_params, cfg=cfg),
        forward=functools.partial(transformer.forward, cfg=cfg, act_dtype=act_dtype),
        prefill=functools.partial(transformer.prefill, cfg=cfg, act_dtype=act_dtype),
        decode_step=functools.partial(transformer.decode_step, cfg=cfg, act_dtype=act_dtype),
        init_cache=functools.partial(transformer.init_cache, cfg, act_dtype=act_dtype),
    )


def batch_inputs(cfg: ArchConfig, batch: int, seq: int, gen: torch.Generator) -> dict:
    """Random token ids and labels on ``gen``'s device (the ported families
    read tokens; embedding and M-RoPE frontends wait for ROADMAP A11)."""
    transformer.check_family(cfg)
    return {name: torch.randint(0, cfg.vocab, (batch, seq), generator=gen, device=gen.device)
            for name in ("tokens", "labels")}


def decode_inputs(cfg: ArchConfig, batch: int, gen: torch.Generator) -> dict:
    return batch_inputs(cfg, batch, 1, gen)


def param_count(params) -> int:
    return sum(t.numel() for t in transformer.tree_leaves(params))
