"""K6, the Mamba2 SSD chunk scan, beside its plain version and its oracle.

  * ``ssd_chunk_scan`` — ``csrc/ssd_scan.cu``: one SSD layer's
    ``y_intra + y_inter`` over ``nc`` chunks of ``Q`` tokens, with the
    float32 state ``h (B, H, P, N)`` carried from chunk to chunk
    (reference: ``ssd_kernel.py::_kernel`` via ``ssd_chunk_scan``).
  * ``ssd_chunk_scan_ref`` — the plain version: the Pallas body
    transcribed chunk by chunk in float32.
  * ``ssd_chunk_ref`` — the token-by-token recurrence oracle.

Shapes are the reference's: ``xh (nc, B, Q, H, P)`` in the activation
dtype, ``bm``/``cm (nc, B, Q, H, N)``, ``dt (nc, B, Q, H)`` and ``a_neg
(H,)`` float32 (negative decay rates); ``y`` is shaped and typed like
``xh``.  The kernel reads every input through its strides, so a view
(a chunk-major permutation, a slice of a wider projection, a head axis of
stride 0 that shares one group's B and C across heads) needs no copy.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises.  Each launch adds one to ``LAUNCHES["ssd_scan"]``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

# launches since the last reset_launches()
LAUNCHES = {"ssd_scan": 0}


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def _check_shapes(xh, bm, cm, dt, a_neg) -> None:
    nc, b, q, h, p = xh.shape
    n = bm.shape[-1]
    if bm.shape != (nc, b, q, h, n) or cm.shape != bm.shape:
        raise ValueError(f"ssd_chunk_scan: bm and cm must be {(nc, b, q, h, n)}, got "
                         f"{tuple(bm.shape)} and {tuple(cm.shape)}")
    if dt.shape != (nc, b, q, h) or a_neg.shape != (h,):
        raise ValueError(f"ssd_chunk_scan: dt must be {(nc, b, q, h)} and a_neg {(h,)}, "
                         f"got {tuple(dt.shape)} and {tuple(a_neg.shape)}")


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def ssd_chunk_scan_ref(xh, bm, cm, dt, a_neg, return_state: bool = False):
    """Plain version of :func:`ssd_chunk_scan`: the Pallas body, chunk by
    chunk, in float32."""
    _check_shapes(xh, bm, cm, dt, a_neg)
    nc, b, q, h, p = xh.shape
    f32 = torch.float32
    state = torch.zeros(b, h, p, bm.shape[-1], dtype=f32, device=xh.device)
    mask = torch.ones(q, q, dtype=torch.bool, device=xh.device).tril()
    a = a_neg.to(f32)
    ys = []
    for j in range(nc):
        x, bj, cj, dtj = xh[j].to(f32), bm[j].to(f32), cm[j].to(f32), dt[j].to(f32)
        da_cs = torch.cumsum(dtj * a, dim=1)                       # (B, Q, H)
        cb = torch.einsum("bqhn,bthn->bhqt", cj, bj)
        da_h = da_cs.transpose(1, 2)                               # (B, H, Q)
        decay = torch.exp(da_h[..., :, None] - da_h[..., None, :])
        att = torch.where(mask, cb * decay, 0.0)
        att = att * dtj.transpose(1, 2)[..., None, :]
        y = torch.einsum("bhqt,bthp->bqhp", att, x)
        y = y + torch.einsum("bqhn,bhpn->bqhp", cj, state) * torch.exp(da_cs)[..., None]
        tail = torch.exp(da_cs[:, -1:, :] - da_cs)
        bx = torch.einsum("bqhn,bqhp->bhpn", bj, x * (dtj * tail)[..., None])
        state = state * torch.exp(da_cs[:, -1, :])[..., None, None] + bx
        ys.append(y.to(xh.dtype))
    y = torch.stack(ys)
    return (y, state) if return_state else y


def ssd_chunk_ref(xh, bm, cm, dt, a_neg, return_state: bool = False):
    """Token-by-token recurrence oracle on the same tensors (with
    ``return_state``, also the state after the last token)."""
    _check_shapes(xh, bm, cm, dt, a_neg)
    nc, b, q, h, p = xh.shape
    n = bm.shape[-1]
    f32 = torch.float32

    def tokens(t, *tail):
        return t.to(f32).transpose(0, 1).reshape(b, nc * q, *tail)

    x2, b2, c2, d2 = tokens(xh, h, p), tokens(bm, h, n), tokens(cm, h, n), tokens(dt, h)
    state = torch.zeros(b, h, p, n, dtype=f32, device=xh.device)
    ys = []
    for t in range(nc * q):
        da = torch.exp(d2[:, t] * a_neg.to(f32))                   # (B, H)
        state = state * da[..., None, None] + \
            (d2[:, t][..., None] * x2[:, t])[..., None] * b2[:, t][:, :, None, :]
        ys.append(torch.einsum("bhn,bhpn->bhp", c2[:, t], state))
    y = torch.stack(ys, dim=1).reshape(b, nc, q, h, p).transpose(0, 1).to(xh.dtype)
    return (y, state) if return_state else y


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

def _launch(xh, bm, cm, dt, a_neg, out, state) -> None:
    tensors = {"xh": xh, "bm": bm, "cm": cm, "dt": dt, "a_neg": a_neg, "out": out}
    for name, t in tensors.items():
        if t.device != xh.device or xh.device.type != "cuda":
            raise ValueError(f"ssd_chunk_scan kernel: {name} is on {t.device}; every "
                             f"tensor must be on one CUDA device")
    if xh.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"ssd_chunk_scan kernel: xh must be float32 or bfloat16, got {xh.dtype}")
    for name in ("bm", "cm", "dt", "a_neg"):
        if tensors[name].dtype != torch.float32:
            raise TypeError(f"ssd_chunk_scan kernel: {name} must be float32, "
                            f"got {tensors[name].dtype}")
    nc, b, q, h, p = xh.shape
    n = bm.shape[-1]
    lib = build.load("ssd_scan")
    if q > lib.repro_ssd_max_chunk() or n > lib.repro_ssd_max_state():
        # the thread layout's limits; at both, a CTA takes 216 KB of shared memory
        raise ValueError(f"ssd_chunk_scan kernel: chunk length {q} and state size {n} must "
                         f"be at most {lib.repro_ssd_max_chunk()} and "
                         f"{lib.repro_ssd_max_state()}")
    if out.numel() == 0:
        if state is not None:
            state.zero_()
        return
    a = a_neg.contiguous()
    strides = (ctypes.c_int64 * 24)(*xh.stride(), *bm.stride(), *cm.stride(), *dt.stride(),
                                    *out.stride())
    stream = ctypes.c_void_p(torch.cuda.current_stream(xh.device).cuda_stream)
    build.check(lib.repro_ssd_scan(
        xh.data_ptr(), bm.data_ptr(), cm.data_ptr(), dt.data_ptr(), a.data_ptr(),
        out.data_ptr(), state.data_ptr() if state is not None else None,
        int(xh.dtype == torch.bfloat16), nc, b, q, h, p, n, strides, stream),
        "ssd_chunk_scan kernel")
    LAUNCHES["ssd_scan"] += 1


def ssd_chunk_scan(xh, bm, cm, dt, a_neg, *, return_state: bool = False,
                   out: torch.Tensor | None = None):
    """``(nc, B, Q, H, P) × (nc, B, Q, H, N)² × (nc, B, Q, H) × (H,) → y``
    (and, with ``return_state``, the final state ``(B, H, P, N)`` float32).

    ``out``, when given, receives ``y``: a tensor of ``xh``'s shape and
    dtype with any strides (``ssd_full`` passes a chunk-major view of a
    batch-major buffer)."""
    _check_shapes(xh, bm, cm, dt, a_neg)
    if out is not None and (out.shape != xh.shape or out.dtype != xh.dtype):
        raise ValueError(f"ssd_chunk_scan: out must be {tuple(xh.shape)} {xh.dtype}, got "
                         f"{tuple(out.shape)} {out.dtype}")
    if xh.device.type == "cpu":
        res = ssd_chunk_scan_ref(xh, bm, cm, dt, a_neg, return_state)
        y = res[0] if return_state else res
        if out is not None:
            y = out.copy_(y)
        return (y, res[1]) if return_state else y
    if out is None:
        out = torch.empty(xh.shape, dtype=xh.dtype, device=xh.device)
    nc, b, q, h, p = xh.shape
    state = None
    if return_state:
        state = torch.empty(b, h, p, bm.shape[-1], dtype=torch.float32, device=xh.device)
    _launch(xh, bm, cm, dt, a_neg, out, state)
    return (out, state) if return_state else out
