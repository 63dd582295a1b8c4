"""Shared model blocks: inits and norms (what the SSM family uses).

``init_*`` builds float32 master parameters from an explicit
``torch.Generator`` on the generator's device; ``apply_norm`` computes in
float32 and returns the input's dtype (bfloat16 activations by default).
Layernorm, rotary embeddings and the activations wait for the attention
families (ROADMAP A11).
"""
from __future__ import annotations

import math

import torch

ACT_DTYPE = torch.bfloat16


def truncated_normal_init(gen: torch.Generator, shape, scale: float) -> torch.Tensor:
    """``scale`` × a normal truncated to [-3, 3], by the inverse CDF (as
    ``jax.random.truncated_normal`` draws it; the bits differ)."""
    lo, hi = math.erf(-3.0 / math.sqrt(2.0)), math.erf(3.0 / math.sqrt(2.0))
    u = torch.empty(shape, dtype=torch.float32, device=gen.device).uniform_(lo, hi, generator=gen)
    z = torch.erfinv(u).mul_(math.sqrt(2.0)).clamp_(-3.0, 3.0)
    return z.mul_(scale)


def dense_init(gen: torch.Generator, d_in: int, d_out: int) -> torch.Tensor:
    return truncated_normal_init(gen, (d_in, d_out), 1.0 / math.sqrt(d_in))


def _check_norm(kind: str) -> None:
    if kind != "rmsnorm":
        raise NotImplementedError(f"{kind!r}: the port has rmsnorm only (ROADMAP A11)")


def init_norm(kind: str, d: int, device) -> dict:
    _check_norm(kind)
    return {"scale": torch.ones(d, dtype=torch.float32, device=device)}


def apply_norm(kind: str, p: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    _check_norm(kind)
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * p["scale"]).to(x.dtype)
