"""Dense FFN variants: SwiGLU / GeGLU (gated), squared-ReLU / GELU (plain),
as the reference's ``models/ffn.py``.  The products are ``torch.matmul``
in the activation dtype; the weights are cast at their use (a no-op on
``transformer.cast_params``' copy)."""
from __future__ import annotations

import torch

from repro_torch.models import blocks


def init_ffn(gen: torch.Generator, d_model: int, d_ff: int, act: str) -> dict:
    p = {"w_in": blocks.dense_init(gen, d_model, d_ff),
         "w_out": blocks.dense_init(gen, d_ff, d_model)}
    if blocks.is_gated(act):
        p["w_gate"] = blocks.dense_init(gen, d_model, d_ff)
    return p


def apply_ffn(p: dict, x: torch.Tensor, act: str) -> torch.Tensor:
    fn = blocks.act_fn(act)
    h = x @ p["w_in"].to(x.dtype)
    if blocks.is_gated(act):
        h = fn(x @ p["w_gate"].to(x.dtype)) * h
    else:
        h = fn(h)
    return h @ p["w_out"].to(x.dtype)
