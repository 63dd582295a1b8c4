"""Shared model blocks: inits, norms, rotary embeddings (with M-RoPE) and
activations, as the reference's ``models/blocks.py``.

``init_*`` builds float32 master parameters from an explicit
``torch.Generator`` on the generator's device; ``apply_norm`` and the
rotary embeddings compute in float32 and return the input's dtype
(bfloat16 activations by default).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

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


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def init_norm(kind: str, d: int, device) -> dict:
    if kind == "rmsnorm":
        return {"scale": torch.ones(d, dtype=torch.float32, device=device)}
    if kind == "layernorm":
        return {"scale": torch.ones(d, dtype=torch.float32, device=device),
                "bias": torch.zeros(d, dtype=torch.float32, device=device)}
    raise ValueError(kind)


def apply_norm(kind: str, p: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    if kind == "rmsnorm":
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + eps) * p["scale"]
    elif kind == "layernorm":
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.var(xf, dim=-1, keepdim=True, correction=0)   # jnp.var's
        y = (xf - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    else:
        raise ValueError(kind)
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """(head_dim/2,) inverse frequencies, float32."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def _rotate(x: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    """Rotate the two halves of ``x (..., S, H, D)`` (not interleaved) by
    ``ang (..., S, D/2)``, in float32; the output in ``x``'s dtype."""
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, D); positions: broadcastable to (..., S), integer."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    return _rotate(x, positions[..., None].to(torch.float32) * freqs)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, theta: float,
                sections: tuple[int, int, int]) -> torch.Tensor:
    """Qwen2-VL M-RoPE: ``positions3 (..., S, 3)`` = (t, h, w) ids; the D/2
    frequency slots are split into ``sections``, each rotated by its own
    positional stream.  ``sections`` sums to head_dim/2."""
    d = x.shape[-1]
    if sum(sections) != d // 2:
        raise ValueError(f"M-RoPE sections {sections} must sum to head_dim/2 = {d // 2}")
    freqs = rope_freqs(d, theta, x.device)
    sel = torch.cat([torch.full((s,), i, dtype=torch.int64, device=x.device)
                     for i, s in enumerate(sections)])           # (D/2,)
    pos = positions3.to(torch.float32)[..., sel]                 # (..., S, D/2)
    return _rotate(x, pos * freqs)


# ---------------------------------------------------------------------------
# activations
# ---------------------------------------------------------------------------

def _gelu(v: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(v, approximate="tanh")


def _sq_relu(v: torch.Tensor) -> torch.Tensor:
    return torch.square(F.relu(v))


def act_fn(name: str):
    if name == "gelu":
        return _gelu
    if name == "sq_relu":
        return _sq_relu
    if name in ("swiglu", "geglu"):
        # gate nonlinearity only; the FFN does the gating
        return F.silu if name == "swiglu" else _gelu
    raise ValueError(name)


def is_gated(name: str) -> bool:
    return name in ("swiglu", "geglu")
