"""Mamba2 / SSD (state-space duality) block: the chunked scan on K6.

Layer structure follows mamba_ssm v2, as the reference's ``models/ssm.py``:
in_proj → causal depthwise conv on (x, B, C) → SSD → gated RMSNorm →
out_proj.  ``ssd_full`` sends the chunked scan (``y_intra + y_inter`` and
the carried state) through ``kernels.ssd_kernel.ssd_chunk_scan``, which
launches K6 on the card; the two projections are ``torch.matmul``, as the
reference leaves them to XLA.  ``ssd_decode`` is the one-token recurrence.

Shapes: B batch, S seq, H heads, P head_dim, N d_state, G groups, Q chunk.
Parameters may be float32 masters or already cast to the activation dtype
(``transformer.cast_params``): every use casts to the activation dtype as
the reference does, which is a no-op on a cast copy.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ssd_kernel
from repro_torch.models import blocks


def init_ssm(gen: torch.Generator, cfg: ArchConfig) -> dict:
    d, di = cfg.d_model, cfg.d_inner
    g, n, h = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_nheads
    convdim = di + 2 * g * n
    dev, f32 = gen.device, torch.float32
    return {
        "in_proj": blocks.dense_init(gen, d, 2 * di + 2 * g * n + h),
        "conv_w": blocks.truncated_normal_init(gen, (cfg.ssm_conv, convdim),
                                               1.0 / math.sqrt(cfg.ssm_conv)),
        "conv_b": torch.zeros(convdim, dtype=f32, device=dev),
        "A_log": torch.log(torch.linspace(1.0, 16.0, h, dtype=f32, device=dev)),
        "D": torch.ones(h, dtype=f32, device=dev),
        "dt_bias": torch.log(torch.expm1(torch.linspace(1e-3, 1e-1, h, dtype=f32, device=dev))),
        "norm": {"scale": torch.ones(di, dtype=f32, device=dev)},
        "out_proj": blocks.dense_init(gen, di, d),
    }


def _split_proj(cfg: ArchConfig, zxbcdt: torch.Tensor):
    di, gn, h = cfg.d_inner, cfg.ssm_groups * cfg.ssm_state, cfg.ssm_nheads
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:di + di + 2 * gn]
    dt = zxbcdt[..., di + di + 2 * gn:]
    assert dt.shape[-1] == h
    return z, xbc, dt


def _causal_conv(p: dict, xbc: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Depthwise causal conv along S. xbc: (B, S, convdim)."""
    kw = cfg.ssm_conv
    w = p["conv_w"].to(xbc.dtype)                       # (kw, convdim)
    pad = F.pad(xbc, (0, 0, kw - 1, 0))
    out = sum(pad[:, i:i + xbc.shape[1], :] * w[i] for i in range(kw))
    return F.silu(out + p["conv_b"].to(xbc.dtype))


def _gated_norm(p: dict, y: torch.Tensor, z: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    yf = (y * F.silu(z)).to(torch.float32)
    var = torch.mean(yf * yf, dim=-1, keepdim=True)
    return (yf * torch.rsqrt(var + eps) * p["scale"]).to(y.dtype)


def _heads(m: torch.Tensor, rep: int) -> torch.Tensor:
    """(…, G, N) → (…, G·rep, N), head h reading group h // rep: a view with
    a head stride of 0 for one group, a copy for several."""
    if m.shape[-2] == 1:
        return m.expand(*m.shape[:-2], rep, m.shape[-1])
    return torch.repeat_interleave(m, rep, dim=-2)


class SSMState(NamedTuple):
    h: torch.Tensor           # (B, H, P, N) f32
    conv: torch.Tensor        # (B, kw-1, convdim)


def init_ssm_state(cfg: ArchConfig, batch: int, dtype=blocks.ACT_DTYPE,
                   device=None) -> SSMState:
    g, n = cfg.ssm_groups, cfg.ssm_state
    convdim = cfg.d_inner + 2 * g * n
    return SSMState(
        torch.zeros(batch, cfg.ssm_nheads, cfg.ssm_head_dim, n, dtype=torch.float32,
                    device=device),
        torch.zeros(batch, cfg.ssm_conv - 1, convdim, dtype=dtype, device=device))


def ssd_full(p: dict, x: torch.Tensor, cfg: ArchConfig, return_state: bool = False):
    """Full-sequence SSD. x: (B, S, D) → (B, S, D) [, final SSMState]."""
    bsz, s, _ = x.shape
    h_heads, pdim, n = cfg.ssm_nheads, cfg.ssm_head_dim, cfg.ssm_state
    g = cfg.ssm_groups
    q = min(cfg.ssm_chunk, s)
    while s % q:
        q -= 1
    nc = s // q

    zxbcdt = x @ p["in_proj"].to(x.dtype)
    z, xbc_raw, dt_raw = _split_proj(cfg, zxbcdt)
    xbc = _causal_conv(p, xbc_raw, cfg)
    xin = xbc[..., :cfg.d_inner]
    b_in = xbc[..., cfg.d_inner:cfg.d_inner + g * n]
    c_in = xbc[..., cfg.d_inner + g * n:]

    # chunked views, (B, nc, Q, ...) — the kernel takes them chunk-major
    xh = xin.reshape(bsz, nc, q, h_heads, pdim)
    bmat = b_in.reshape(bsz, nc, q, g, n).to(torch.float32)
    cmat = c_in.reshape(bsz, nc, q, g, n).to(torch.float32)
    dt = F.softplus(dt_raw.to(torch.float32) + p["dt_bias"]).reshape(bsz, nc, q, h_heads)
    a_neg = -torch.exp(p["A_log"])                       # (H,) < 0
    rep = h_heads // g
    bheads, cheads = _heads(bmat, rep), _heads(cmat, rep)   # (B, nc, Q, H, N)

    # y_intra + y_inter and the final state: K6 on the card
    y = torch.empty(bsz, nc, q, h_heads, pdim, dtype=x.dtype, device=x.device)
    res = ssd_kernel.ssd_chunk_scan(
        xh.transpose(0, 1), bheads.transpose(0, 1), cheads.transpose(0, 1),
        dt.transpose(0, 1), a_neg, return_state=return_state, out=y.transpose(0, 1))

    y = y + xh * p["D"].to(x.dtype)[:, None]
    y = y.reshape(bsz, s, cfg.d_inner)
    y = _gated_norm(p["norm"], y, z)
    out = y @ p["out_proj"].to(x.dtype)
    if return_state:
        return out, SSMState(res[1], xbc_raw_tail(cfg, x, p, zxbcdt))
    return out


def xbc_raw_tail(cfg: ArchConfig, x, p, zxbcdt: torch.Tensor) -> torch.Tensor:
    """Last (kw-1) pre-conv xbc rows — seeds the decode conv state.  A copy:
    a view would keep the layer's whole projection alive in the cache."""
    _, xbc, _ = _split_proj(cfg, zxbcdt)
    return xbc[:, -(cfg.ssm_conv - 1):, :].clone()


def ssd_decode(p: dict, x: torch.Tensor, state: SSMState, cfg: ArchConfig):
    """One-token decode. x: (B, 1, D) → (B, 1, D), new state.  O(1) in
    sequence length."""
    bsz = x.shape[0]
    h_heads, pdim, n = cfg.ssm_nheads, cfg.ssm_head_dim, cfg.ssm_state
    g = cfg.ssm_groups
    f32 = torch.float32
    zxbcdt = x @ p["in_proj"].to(x.dtype)                # (B, 1, ·)
    z, xbc, dt_raw = _split_proj(cfg, zxbcdt)

    # conv ring: append the new row, convolve the last kw rows
    conv_in = torch.cat([state.conv.to(x.dtype), xbc], dim=1)   # (B, kw, convdim)
    w = p["conv_w"].to(x.dtype)
    conv_out = (conv_in * w).sum(dim=1) + p["conv_b"].to(x.dtype)
    conv_out = F.silu(conv_out)[:, None, :]              # (B, 1, convdim)
    new_conv = conv_in[:, 1:, :]

    xin = conv_out[..., :cfg.d_inner]
    b_in = conv_out[..., cfg.d_inner:cfg.d_inner + g * n]
    c_in = conv_out[..., cfg.d_inner + g * n:]

    xh = xin.reshape(bsz, h_heads, pdim).to(f32)
    rep = h_heads // g
    bvec = _heads(b_in.reshape(bsz, g, n).to(f32), rep)  # (B, H, N)
    cvec = _heads(c_in.reshape(bsz, g, n).to(f32), rep)

    dt = F.softplus(dt_raw[:, 0].to(f32) + p["dt_bias"])
    da = torch.exp(dt * (-torch.exp(p["A_log"])))        # (B, H)
    hnew = state.h * da[..., None, None] \
        + (dt[..., None] * xh)[..., None] * bvec[:, :, None, :]
    y = torch.matmul(hnew, cvec[..., None])[..., 0]      # (B, H, P)
    y = y.to(x.dtype) + xh.to(x.dtype) * p["D"].to(x.dtype)[:, None]
    y = y.reshape(bsz, 1, cfg.d_inner)
    y = _gated_norm(p["norm"], y, z)
    out = y @ p["out_proj"].to(x.dtype)
    return out, SSMState(hnew, new_conv)


# ---------------------------------------------------------------------------
# naive O(S·N) recurrence — oracle for tests
# ---------------------------------------------------------------------------

def ssd_reference(p: dict, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Token-by-token recurrence (slow, exact)."""
    bsz, s, _ = x.shape
    state = init_ssm_state(cfg, bsz, x.dtype, device=x.device)
    outs = []
    for t in range(s):
        o, state = ssd_decode(p, x[:, t:t + 1, :], state, cfg)
        outs.append(o)
    return torch.cat(outs, dim=1)
