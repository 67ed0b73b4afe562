"""Continuous-batching serving engine (counterpart of `repro.serving.engine`).

A fixed pool of ``max_slots`` generation slots shares one decode cache;
requests are admitted into free slots (a per-request prefill writes the
prompt's final states into the slot's cache rows), and one `decode_step`
advances *all* live slots each tick.  Slots can be at different depths
because the cache keeps per-stream positions.  Finished slots (at
``max_new_tokens``) are freed and refilled from the queue.

As in the reference, prefill runs per admission rather than chunked beside
decode, and dead slots still go through decode (their outputs are
discarded).  Unlike it, the slot merge writes into the pool's cache in
place rather than building a new one; a request has no EOS id (no ported
path has a tokenizer); and there is no prompt capacity, since a Mamba1
cache has no sequence length to size.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models import model as M


@dataclasses.dataclass
class Request:
    """One generation request and, once served, its output tokens."""

    uid: int
    prompt: np.ndarray  # (S,) int32
    max_new_tokens: int = 32
    # filled by the engine
    output: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


class ServingEngine:
    """Slot pool over one LM; greedy decoding.

    ``model`` must lie on ``device`` (CUDA by default; raises without one
    unless the caller passes ``device="cpu"``).
    """

    def __init__(self, model: M.LM, max_slots: int = 4, device=None):
        self.device = resolve_device(device)
        self.model = model
        self.max_slots = max_slots
        self.queue: Deque[Request] = deque()
        self.slots: List[Optional[Request]] = [None] * max_slots
        self.finished: List[Request] = []
        self.cache = M.init_cache(model.cfg, max_slots, self.device)
        self.last_tokens = np.zeros((max_slots, 1), np.int64)

    # ------------------------------------------------------------- admission

    def submit(self, req: Request):
        """Queue ``req``; its prompt must be a 1-D token array."""
        if req.prompt.ndim != 1:
            raise ValueError("prompt must be a 1-D token array")
        self.queue.append(req)

    def _merge_slot(self, slot: int, one_cache):
        """Copy a single-stream cache into pool slot ``slot``.

        Cache leaves have the stream dim at index 1 (conv/ssm are stacked
        (L, B, ...)) except ``pos``, which is (B,).
        """
        for name, pool in self.cache.items():
            one = one_cache[name]
            if pool.dim() == 1:  # pos (B,)
                pool[slot] = one[0]
            else:
                pool[:, slot] = one[:, 0]

    def _admit(self):
        free = [i for i, s in enumerate(self.slots) if s is None]
        while free and self.queue:
            slot = free.pop(0)
            req = self.queue.popleft()
            self.slots[slot] = req
            tokens = torch.as_tensor(req.prompt[None, :], dtype=torch.long, device=self.device)
            logits, one_cache = M.prefill(self.model, tokens)
            self._merge_slot(slot, one_cache)
            tok = int(torch.argmax(logits[0, -1]))
            req.output.append(tok)
            self.last_tokens[slot, 0] = tok

    # ----------------------------------------------------------------- step

    def step(self) -> Dict[int, int]:
        """Admit, decode one token for all live slots, retire finished."""
        self._admit()
        live = [i for i, s in enumerate(self.slots) if s is not None]
        if not live:
            return {}
        toks = torch.as_tensor(self.last_tokens, device=self.device)
        logits, self.cache = M.decode_step(self.model, self.cache, toks)
        next_tokens = torch.argmax(logits[:, 0], dim=-1).cpu().numpy()

        emitted = {}
        for i in live:
            req = self.slots[i]
            tok = int(next_tokens[i])
            req.output.append(tok)
            emitted[req.uid] = tok
            self.last_tokens[i, 0] = tok
            if len(req.output) >= req.max_new_tokens:
                req.done = True
                self.finished.append(req)
                self.slots[i] = None
        return emitted

    def run_until_drained(self, max_steps: int = 10_000) -> List[Request]:
        """Step until the queue and every slot are empty; the finished requests."""
        for _ in range(max_steps):
            if not self.queue and all(s is None for s in self.slots):
                break
            self.step()
        return self.finished
