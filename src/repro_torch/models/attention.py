"""Attention: MHA / GQA / MQA with RoPE or M-RoPE, causal with an optional
sliding window, full-sequence (prefill) and one-token decode against a KV
cache, as the reference's ``models/attention.py``.

The products are ``torch.einsum`` / ``torch.matmul`` in the activation
dtype, the scores and the softmax in float32, the reference's rounding:
the reference computes attention in jnp, outside any Pallas kernel.  GQA
reshapes the queries to ``(B, S, KV, groups, D)`` (query head ``h`` reads
KV head ``h // groups``), never copying K or V.

Decode caches:
  * full causal: cache length ``max_seq``, written at the absolute position;
  * sliding window W: a ring of ``min(max_seq, W)`` slots, position p at
    slot ``p % W``.
``attention_decode`` writes the new K and V into the cache in place and
returns it.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import blocks

NEG_INF = -1e30


def init_attention(gen: torch.Generator, cfg: ArchConfig) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {"wq": blocks.dense_init(gen, d, h * hd),
            "wk": blocks.dense_init(gen, d, kv * hd),
            "wv": blocks.dense_init(gen, d, kv * hd),
            "wo": blocks.dense_init(gen, h * hd, d)}


def _project_qkv(p: dict, x: torch.Tensor, cfg: ArchConfig, positions, pos3=None):
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ p["wq"].to(x.dtype)).reshape(b, s, h, hd)
    k = (x @ p["wk"].to(x.dtype)).reshape(b, s, kv, hd)
    v = (x @ p["wv"].to(x.dtype)).reshape(b, s, kv, hd)
    if cfg.mrope_sections is not None:
        if pos3 is None:
            raise ValueError(f"{cfg.name}: M-RoPE needs pos3 (B, S, 3)")
        q = blocks.apply_mrope(q, pos3, cfg.rope_theta, cfg.mrope_sections)
        k = blocks.apply_mrope(k, pos3, cfg.rope_theta, cfg.mrope_sections)
    else:
        q = blocks.apply_rope(q, positions, cfg.rope_theta)
        k = blocks.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _sdpa(q, k, v, mask, cfg: ArchConfig) -> torch.Tensor:
    """q: (B, S, H, D); k, v: (B, T, KV, D); mask: (B, 1, S, T) or
    (1, 1, S, T) bool.  The product rounds to the activation dtype, then
    the scaling (by the float32 of √D, as the reference's NumPy scalar),
    the mask (``NEG_INF``, not -inf) and the softmax run in float32; the
    weights are cast back before the second product."""
    h, kv = cfg.n_heads, cfg.n_kv_heads
    groups = h // kv
    b, s, _, hd = q.shape
    qg = q.reshape(b, s, kv, groups, hd)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k).to(torch.float32)
    scores = scores / float(np.float32(math.sqrt(hd)))
    scores = torch.where(mask[:, :, None], scores, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", w, v)
    return out.reshape(b, s, h, hd)


def causal_mask(s: int, window: Optional[int], device=None) -> torch.Tensor:
    """(1, 1, S, S) causal (optionally banded) mask."""
    i = torch.arange(s, device=device)[:, None]
    j = torch.arange(s, device=device)[None, :]
    m = j <= i
    if window is not None:
        m = m & (j > i - window)
    return m[None, None]


def attention_full(p: dict, x: torch.Tensor, cfg: ArchConfig, positions=None, pos3=None):
    """Prefill path. x: (B, S, D) → (B, S, D); returns ``(out, (k, v))`` so
    that prefill can seed the decode cache."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, dtype=torch.int64, device=x.device)[None, :]
    q, k, v = _project_qkv(p, x, cfg, positions, pos3)
    out = _sdpa(q, k, v, causal_mask(s, cfg.window, x.device), cfg)
    out = out.reshape(b, s, cfg.n_heads * cfg.head_dim)
    return out @ p["wo"].to(x.dtype), (k, v)


# ---------------------------------------------------------------------------
# decode (one token, KV cache)
# ---------------------------------------------------------------------------

class KVCache(NamedTuple):
    k: torch.Tensor       # (B, T, KV, D), T = max_seq or the window
    v: torch.Tensor


def cache_len(cfg: ArchConfig, max_seq: int) -> int:
    return min(max_seq, cfg.window) if cfg.window else max_seq


def init_kv_cache(cfg: ArchConfig, batch: int, max_seq: int, dtype=blocks.ACT_DTYPE,
                  device=None) -> KVCache:
    shape = (batch, cache_len(cfg, max_seq), cfg.n_kv_heads, cfg.head_dim)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


def _decode_mask(pos, slot, t: int, cfg: ArchConfig, device) -> torch.Tensor:
    """The cache slots a token at ``pos`` attends to: ``(T,)`` for a scalar
    position, ``(B, T)`` for a vector (``pos`` and ``slot`` then (B, 1))."""
    idx = torch.arange(t, device=device)
    if cfg.window:
        # ring: slot i holds absolute position pos - ((slot - i) mod t); the
        # reference also tests age < t, which the mod makes always true
        return pos - (slot - idx) % t >= 0
    return idx <= pos


def attention_decode(p: dict, x: torch.Tensor, cache: KVCache, pos, cfg: ArchConfig,
                     pos3=None):
    """x: (B, 1, D); pos: the new token's absolute position, a scalar (every
    sequence at the same position) or a ``(B,)`` integer tensor of
    per-sequence positions (continuous batching: each lane writes its K and
    V at its own position and attends to its own prefix).  The new K and V
    go into ``cache`` in place (a ring slot where there is a window)."""
    if isinstance(pos, torch.Tensor) and pos.ndim == 1:
        return _attention_decode_vec(p, x, cache, pos, cfg, pos3)
    b = x.shape[0]
    pos = int(pos)
    positions = torch.full((b, 1), pos, dtype=torch.int64, device=x.device)
    q, k_new, v_new = _project_qkv(p, x, cfg, positions, pos3)
    t = cache.k.shape[1]
    slot = pos % t if cfg.window else pos
    cache.k[:, slot].copy_(k_new[:, 0])
    cache.v[:, slot].copy_(v_new[:, 0])
    mask = _decode_mask(pos, slot, t, cfg, x.device)[None, None, None, :]
    out = _sdpa(q, cache.k, cache.v, mask, cfg).reshape(b, 1, cfg.n_heads * cfg.head_dim)
    return out @ p["wo"].to(x.dtype), cache


def _attention_decode_vec(p: dict, x: torch.Tensor, cache: KVCache, pos: torch.Tensor,
                          cfg: ArchConfig, pos3=None):
    """Per-sequence positions ``pos (B,)``: lane ``b`` writes its new K and V
    at its own cache slot and attends to its own valid prefix, so sequences
    at different depths share one batched step."""
    b = x.shape[0]
    pos = pos.to(device=x.device, dtype=torch.int64)
    q, k_new, v_new = _project_qkv(p, x, cfg, pos[:, None], pos3)
    t = cache.k.shape[1]
    slot = pos % t if cfg.window else pos                   # (B,)
    lane = torch.arange(b, device=x.device)
    cache.k.index_put_((lane, slot), k_new[:, 0].to(cache.k.dtype))
    cache.v.index_put_((lane, slot), v_new[:, 0].to(cache.v.dtype))
    mask = _decode_mask(pos[:, None], slot[:, None], t, cfg, x.device)[:, None, None, :]
    out = _sdpa(q, cache.k, cache.v, mask, cfg).reshape(b, 1, cfg.n_heads * cfg.head_dim)
    return out @ p["wo"].to(x.dtype), cache
