"""Serving engine: per-request prefill and batched decode with continuous
batching (the reference's ``serve/engine.ContinuousBatcher``).

  * continuous batching: a fixed-slot batch; finished sequences release
    their slot, queued requests claim it (the slot's cache lane is
    overwritten by the new request's prefill);
  * greedy or temperature sampling (temperature from an explicit
    ``torch.Generator``);
  * per-slot position counters.

Decode runs at a fixed width of ``decode_lanes(n_slots)`` lanes, a
multiple of 8, whatever the number of slots.  The card's matrix-product
and reduction kernels choose their algorithm by shape, so one row's
result can depend on how many rows share the call (decoding at
``n_slots`` lanes, a mamba2-2.7b request gave other greedy tokens in a
4-slot batch than alone on an H100; PERF.md); at a fixed width a request
decodes to the same tokens in a 1-slot engine as in a batch of up to 8.
Lanes past ``n_slots`` carry token 0 and are never read.

Entry points run on the card unless the caller passes ``device="cpu"``;
there is no fallback from a failed kernel to the CPU.  ``StencilService``
waits for ROADMAP A8.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.core.api import resolve_device
from repro_torch.models import transformer

LANE_MULTIPLE = 8


def decode_lanes(n_slots: int) -> int:
    return -(-n_slots // LANE_MULTIPLE) * LANE_MULTIPLE


def make_serve_step(model: transformer.Model, temperature: float = 0.0):
    """(params, cache, batch1, pos, generator) → (next_token, logits, cache)."""
    def step(params, cache, batch1, pos, generator=None):
        logits, cache = model.decode_step(params, cache, batch1, pos)
        logits = logits[:, 0].to(torch.float32)
        if temperature > 0.0:
            probs = torch.softmax(logits / temperature, dim=-1)
            tok = torch.multinomial(probs, 1, generator=generator)[:, 0]
        else:
            tok = torch.argmax(logits, dim=-1)
        return tok, logits, cache
    return step


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # (S,) int
    max_new: int
    out: list = dataclasses.field(default_factory=list)
    done: bool = False


class ContinuousBatcher:
    """Fixed-slot continuous batching over one shared decode step.

    ``stats`` accumulates prefill tokens and seconds and decode steps and
    seconds (host clock; each phase ends in a read of its result on the
    host, so the device work is inside the window)."""

    def __init__(self, model: transformer.Model, params, n_slots: int, max_seq: int,
                 temperature: float = 0.0, device=None, seed: int = 0):
        transformer.check_family(model.cfg)
        if model.cfg.frontend != "token":
            raise NotImplementedError("non-token frontends serve with the attention "
                                      "families (ROADMAP A11)")
        self.model, self.params = model, params
        self.cfg = model.cfg
        self.device = resolve_device(device)
        self.n_slots, self.max_seq = n_slots, max_seq
        self.lanes = decode_lanes(n_slots)
        self.cache = model.init_cache(self.lanes, max_seq, device=self.device)
        self.pos = np.zeros(n_slots, np.int64)
        self.active: list[Optional[Request]] = [None] * n_slots
        self.queue: list[Request] = []
        self.step_fn = make_serve_step(model, temperature)
        self.prefill_fn = lambda p, b: model.prefill(p, b, max_seq=max_seq)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self._next_tok = np.zeros(self.lanes, np.int64)
        self.stats = {"prefills": 0, "prefill_tokens": 0, "prefill_s": 0.0,
                      "decode_steps": 0, "decode_s": 0.0}

    def submit(self, req: Request):
        self.queue.append(req)

    def _admit(self):
        for slot in range(self.n_slots):
            if self.active[slot] is None and self.queue:
                req = self.queue.pop(0)
                self.active[slot] = req
                start = time.perf_counter()
                tokens = torch.as_tensor(np.asarray(req.prompt)[None, :], dtype=torch.int64,
                                         device=self.device)
                logits, cache1 = self.prefill_fn(self.params, {"tokens": tokens})
                _write_slot(self.cache, cache1, slot)
                self._next_tok[slot] = int(torch.argmax(logits[0, 0]))
                self.stats["prefill_s"] += time.perf_counter() - start
                self.stats["prefills"] += 1
                self.stats["prefill_tokens"] += len(req.prompt)
                self.pos[slot] = len(req.prompt)

    def run(self, max_steps: int = 256) -> list[Request]:
        finished = []
        self._admit()
        for _ in range(max_steps):
            if not any(r is not None for r in self.active):
                break
            start = time.perf_counter()
            batch1 = {"tokens": torch.as_tensor(self._next_tok[:, None], device=self.device)}
            pos = torch.as_tensor(np.pad(self.pos, (0, self.lanes - self.n_slots)),
                                  device=self.device)
            tok, _, self.cache = self.step_fn(self.params, self.cache, batch1, pos,
                                              self.generator)
            tok = tok.cpu().numpy()
            self.stats["decode_s"] += time.perf_counter() - start
            self.stats["decode_steps"] += 1
            for slot, req in enumerate(self.active):
                if req is None:
                    continue
                req.out.append(int(tok[slot]))
                self.pos[slot] += 1
                self._next_tok[slot] = tok[slot]
                if len(req.out) >= req.max_new or self.pos[slot] >= self.max_seq - 1:
                    req.done = True
                    finished.append(req)
                    self.active[slot] = None
                    self.pos[slot] = 0
                    self._next_tok[slot] = 0
            self._admit()
        return finished


def _write_slot(cache, cache1, slot: int):
    """Copy a 1-batch cache into lane ``slot`` of the batched cache, in
    place: big (L, B, ...), small (L, 1, ...)."""
    transformer.tree_map(lambda big, small: big[:, slot:slot + 1].copy_(small), cache, cache1)
    return cache
