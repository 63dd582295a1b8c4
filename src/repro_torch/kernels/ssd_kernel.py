"""K6, the Mamba2 SSD chunk scan, beside its plain versions and its oracle.

  * ``ssd_chunk_scan`` — one SSD layer's ``y_intra + y_inter`` over ``nc``
    chunks of ``Q`` tokens, with the float32 state ``h (B, H, P, N)``
    carried from chunk to chunk (reference: ``ssd_kernel.py::_kernel`` via
    ``ssd_chunk_scan``).  On the card it is two kernels of
    ``csrc/ssd_scan.cu`` that walk the tokens in chunks of their own,
    ``CHUNK`` = 128 tokens, whatever the caller's ``Q``:
      - ``ssd_state`` carries the state through the chunks in order and
        writes the state entering each chunk to a scratch ``h_in``;
      - ``ssd_out`` computes every chunk's ``y`` at once from ``h_in``.
  * ``ssd_chunk_scan_ref`` — the plain version: the Pallas body
    transcribed chunk by chunk in float32.
  * ``ssd_state_ref`` / ``ssd_out_ref`` — the two kernels' plain versions:
    the same two passes over 128-token chunks, in float32.  The main path
    does not call them; the tests and ``chip_smoke.py`` hold each kernel
    against its own.
  * ``ssd_chunk_ref`` — the token-by-token recurrence oracle.

Shapes are the reference's: ``xh (nc, B, Q, H, P)`` in the activation
dtype, ``bm``/``cm (nc, B, Q, H, N)``, ``dt (nc, B, Q, H)`` and ``a_neg
(H,)`` float32 (negative decay rates); ``y`` is shaped and typed like
``xh``.  The kernels read every input through its strides, so a view
(a chunk-major permutation, a slice of a wider projection, a head axis of
stride 0 that shares one group's B and C across heads) needs no copy.

A CPU tensor takes the plain versions; a CUDA tensor launches the kernels
or raises.  Each launch adds one to ``LAUNCHES["ssd_state"]`` or
``LAUNCHES["ssd_out"]``; ``ssd_chunk_scan`` launches each once.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

# launches since the last reset_launches()
LAUNCHES = {"ssd_state": 0, "ssd_out": 0}
CHUNK = 128          # tokens per internal chunk of the kernels


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


def n_chunks(xh) -> int:
    """Internal chunks of ``CHUNK`` tokens over ``xh``'s ``nc · Q`` tokens."""
    return -(-xh.shape[0] * xh.shape[2] // CHUNK)


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


def _internal(t, nk):
    """``(nc, B, Q, ...)`` as ``(B, nk, CHUNK, ...)`` float32: the tokens in
    the kernels' chunks, zeros past the end."""
    nc, b, q = t.shape[:3]
    flat = t.to(torch.float32).transpose(0, 1).reshape(b, nc * q, *t.shape[3:])
    pad = flat.new_zeros(b, nk * CHUNK - nc * q, *t.shape[3:])
    return torch.cat([flat, pad], 1).reshape(b, nk, CHUNK, *t.shape[3:])


def _cumsum(dt, a_neg, nk):
    """dt and the inclusive cumsum of dt · a per internal chunk, (B, nk, CHUNK, H)."""
    d = _internal(dt, nk)
    return d, torch.cumsum(d * a_neg.to(torch.float32), dim=2)


def ssd_state_ref(xh, bm, dt, a_neg, *, einsum=torch.einsum):
    """Plain version of the ``ssd_state`` kernel: ``(h_in, state)``, the
    state entering each internal chunk ``(B, K, H, P, N)`` and the final
    state ``(B, H, P, N)``, float32.  ``einsum`` computes the state product
    (the tests pass one that rounds its operands as the tensor cores do)."""
    nc, b, q, h, p = xh.shape
    nk = n_chunks(xh)
    x, bc = _internal(xh, nk), _internal(bm, nk)
    d, cs = _cumsum(dt, a_neg, nk)
    w = d * torch.exp(cs[:, :, -1:] - cs)                      # (B, K, CHUNK, H)
    state = torch.zeros(b, h, p, bm.shape[-1], dtype=torch.float32, device=xh.device)
    h_in = []
    for k in range(nk):
        h_in.append(state)
        bx = einsum("bthp,bthn->bhpn", x[:, k] * w[:, k, ..., None], bc[:, k])
        state = state * torch.exp(cs[:, k, -1])[..., None, None] + bx
    return torch.stack(h_in, 1), state


def ssd_out_ref(xh, bm, cm, dt, a_neg, h_in, *, einsum=torch.einsum):
    """Plain version of the ``ssd_out`` kernel: ``y`` of every internal
    chunk from the state entering it, ``h_in (B, K, H, P, ≥N)`` (the first N
    columns are read), cast to ``xh``'s dtype.  ``einsum`` computes the three
    y products."""
    nc, b, q, h, p = xh.shape
    n = bm.shape[-1]
    nk = n_chunks(xh)
    x, bc, cc = _internal(xh, nk), _internal(bm, nk), _internal(cm, nk)
    d, cs = _cumsum(dt, a_neg, nk)
    ch = cs.transpose(2, 3)                                    # (B, K, H, CHUNK)
    gap = (ch[..., :, None] - ch[..., None, :]).clamp(max=0.0)
    mask = torch.ones(CHUNK, CHUNK, dtype=torch.bool, device=xh.device).tril()
    att = torch.where(mask, einsum("bkqhn,bkthn->bkhqt", cc, bc) * torch.exp(gap), 0.0)
    att = att * d.transpose(2, 3)[..., None, :]
    y = einsum("bkqhn,bkhpn->bkqhp", cc, h_in[..., :n].to(torch.float32)) * \
        torch.exp(cs)[..., None]
    y = y + einsum("bkhqt,bkthp->bkqhp", att, x)
    y = y.reshape(b, nk * CHUNK, h, p)[:, :nc * q].reshape(b, nc, q, h, p).transpose(0, 1)
    return y.to(xh.dtype)


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
# the kernels
# ---------------------------------------------------------------------------

_limits: dict = {}    # the loaded library and its shape limits


def _library(tensors: dict):
    """Check the tensors a kernel takes; the loaded library."""
    xh = tensors["xh"]
    for name, t in tensors.items():
        if t.device != xh.device or xh.device.type != "cuda":
            raise ValueError(f"ssd_chunk_scan kernel: {name} is on {t.device}; every "
                             f"tensor must be on one CUDA device")
    if xh.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"ssd_chunk_scan kernel: xh must be float32 or bfloat16, got {xh.dtype}")
    for name in ("bm", "cm", "dt", "a_neg", "h_in"):
        if name in tensors and tensors[name].dtype != torch.float32:
            raise TypeError(f"ssd_chunk_scan kernel: {name} must be float32, "
                            f"got {tensors[name].dtype}")
    if not _limits:
        lib = build.load("ssd_scan")
        assert lib.repro_ssd_chunk() == CHUNK, "csrc/ssd_scan.cu's kChunk differs from CHUNK"
        _limits.update(lib=lib, q=lib.repro_ssd_max_chunk(), n=lib.repro_ssd_max_state())
    q, n = xh.shape[2], tensors["bm"].shape[-1]
    if q > _limits["q"] or n > _limits["n"]:
        # ssd_out holds the chunk's rows of C B^T in registers, 128 at most
        raise ValueError(f"ssd_chunk_scan kernel: chunk length {q} and state size {n} must "
                         f"be at most {_limits['q']} and {_limits['n']}")
    return _limits["lib"]


def _rows_vec(t, cols: int) -> bool:
    """Whether rows of ``cols`` elements of ``t`` (its last axis) may be
    copied 16 bytes at a time: unit stride, every row start 16-byte aligned."""
    es = t.element_size()
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0 and cols * es % 16 == 0
            and all(s * es % 16 == 0 for s in t.stride()[:-1]))


def _args(xh, bm, cm, dt, out):
    """The entry points' shape, stride and vector-access arguments."""
    nc, b, q, h, p = xh.shape
    n = bm.shape[-1]
    strides = (ctypes.c_int64 * 24)(*xh.stride(), *bm.stride(), *cm.stride(), *dt.stride(),
                                    *out.stride())
    # y's element pairs (p, p + 1), p even, in one store: unit stride, aligned
    pairs = out.stride(-1) == 1 and all(s % 2 == 0 for s in out.stride()[:-1]) and \
        out.data_ptr() % (2 * out.element_size()) == 0
    vec = int(_rows_vec(xh, p)) | int(_rows_vec(bm, n)) << 1 | int(_rows_vec(cm, n)) << 2 | \
        int(pairs) << 3
    stream = ctypes.c_void_p(torch.cuda.current_stream(xh.device).cuda_stream)
    return [int(xh.dtype == torch.bfloat16), nc, b, q, h, p, n, strides, vec, stream]


def _scratch_shape(xh, n: int) -> tuple:
    nc, b, q, h, p = xh.shape
    return (b, n_chunks(xh), h, p, -(-n // 16) * 16)


def state_scratch(xh, n: int) -> torch.Tensor:
    """The kernels' ``h_in``: ``(B, K, H, P, Npad)`` float32, ``Npad`` = N
    rounded up to 16 (the columns past N hold zeros)."""
    return torch.empty(_scratch_shape(xh, n), dtype=torch.float32, device=xh.device)


def _check_scratch(h_in, xh, n: int) -> None:
    if tuple(h_in.shape) != _scratch_shape(xh, n) or not h_in.is_contiguous():
        raise ValueError(f"ssd_chunk_scan kernel: h_in must be a contiguous "
                         f"{_scratch_shape(xh, n)} (state_scratch), got {tuple(h_in.shape)}")


def _run_state(lib, xh, bm, dt, a, h_in, state, args) -> None:
    build.check(lib.repro_ssd_state(
        xh.data_ptr(), bm.data_ptr(), dt.data_ptr(), a.data_ptr(), h_in.data_ptr(),
        state.data_ptr() if state is not None else None, *args), "ssd_state kernel")
    LAUNCHES["ssd_state"] += 1


def _run_out(lib, xh, bm, cm, dt, a, h_in, out, args) -> None:
    build.check(lib.repro_ssd_out(
        xh.data_ptr(), bm.data_ptr(), cm.data_ptr(), dt.data_ptr(), a.data_ptr(),
        h_in.data_ptr(), out.data_ptr(), *args), "ssd_out kernel")
    LAUNCHES["ssd_out"] += 1


def ssd_state(xh, bm, dt, a_neg, *, h_in=None, state=None):
    """Kernel ``ssd_state``: returns ``h_in``, :func:`state_scratch`'s
    tensor (allocated if not given) holding the state entering each
    internal chunk; ``state``, when given, receives the final state ``(B,
    H, P, N)`` float32.  On the CPU: :func:`ssd_state_ref`, copied out."""
    n = bm.shape[-1]
    if h_in is None:
        h_in = state_scratch(xh, n)
    _check_scratch(h_in, xh, n)
    if xh.device.type == "cpu":
        ref_h, ref_state = ssd_state_ref(xh, bm, dt, a_neg)
        h_in.zero_()[..., :n] = ref_h
        if state is not None:
            state.copy_(ref_state)
        return h_in
    lib = _library({"xh": xh, "bm": bm, "dt": dt, "a_neg": a_neg, "h_in": h_in})
    _run_state(lib, xh, bm, dt, a_neg.contiguous(), h_in, state, _args(xh, bm, bm, dt, xh))
    return h_in


def ssd_out(xh, bm, cm, dt, a_neg, h_in, *, out=None):
    """Kernel ``ssd_out``: ``y`` (into ``out`` when given) from ``h_in``,
    :func:`ssd_state`'s scratch.  On the CPU: :func:`ssd_out_ref`."""
    _check_scratch(h_in, xh, bm.shape[-1])
    if xh.device.type == "cpu":
        y = ssd_out_ref(xh, bm, cm, dt, a_neg, h_in)
        return y if out is None else out.copy_(y)
    lib = _library({"xh": xh, "bm": bm, "cm": cm, "dt": dt, "a_neg": a_neg, "h_in": h_in})
    if out is None:
        out = torch.empty(xh.shape, dtype=xh.dtype, device=xh.device)
    _run_out(lib, xh, bm, cm, dt, a_neg.contiguous(), h_in, out, _args(xh, bm, cm, dt, out))
    return out


def tf32_rounding_mismatches(device) -> int:
    """How many non-NaN float32 bit patterns, of all 2^32, the kernels'
    integer TF32 rounding maps otherwise than ``cvt.rna.tf32.f32`` on the
    card (a check of the kernels, counted by no launch counter)."""
    lib = build.load("ssd_scan")
    counts = torch.empty(lib.repro_ssd_tf32_check_threads(), dtype=torch.int32, device=device)
    stream = ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
    build.check(lib.repro_ssd_tf32_mismatches(counts.data_ptr(), stream), "tf32 check")
    return int(counts.sum().item())


def _launch(xh, bm, cm, dt, a_neg, out, state) -> None:
    """Both kernels: ``out`` receives y, ``state`` (if not None) the final
    state."""
    lib = _library({"xh": xh, "bm": bm, "cm": cm, "dt": dt, "a_neg": a_neg, "out": out})
    if out.numel() == 0:
        if state is not None:
            state.zero_()
        return
    args, a = _args(xh, bm, cm, dt, out), a_neg.contiguous()
    h_in = state_scratch(xh, bm.shape[-1])
    _run_state(lib, xh, bm, dt, a, h_in, state, args)
    _run_out(lib, xh, bm, cm, dt, a, h_in, out, args)


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
