"""Continuous-batching serving engine (counterpart of `repro.serving.engine`).

A fixed pool of ``max_slots`` generation slots shares one decode cache,
sized for ``prompt_capacity + max_new_tokens`` tokens a slot; requests are
admitted into free slots (a per-request prefill lays the prompt's K/V,
its final states, or both for a hybrid, into the slot's cache rows), and one `decode_step`
advances *all* live slots each tick.  Slots can be at different depths
because the cache keeps per-stream positions.  Finished slots (EOS or
``max_new_tokens``) are freed and refilled from the queue.

As in the reference, prefill runs per admission rather than chunked beside
decode, and dead slots still go through decode (their outputs are
discarded).  Unlike it, the slot merge (and an attention model's decode
step) writes into the pool's cache in place rather than building a new
one.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models import model as M
from repro_torch.tree import tree_leaves


@dataclasses.dataclass
class Request:
    """One generation request and, once served, its output tokens."""

    uid: int
    prompt: np.ndarray  # (S,) int32
    max_new_tokens: int = 32
    eos_id: Optional[int] = None
    # filled by the engine
    output: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


class ServingEngine:
    """Slot pool over one LM; greedy decoding.

    ``model`` must lie on ``device`` (CUDA by default; raises without one
    unless the caller passes ``device="cpu"``).  Prompts hold at most
    ``prompt_capacity`` tokens; the cache holds ``prompt_capacity +
    max_new_tokens`` a slot.  Token-only models: a vlm or audio model
    raises `NotImplementedError`, as in the reference.
    """

    def __init__(self, model: M.LM, max_slots: int = 4, prompt_capacity: int = 64,
                 max_new_tokens: int = 64, device=None):
        if model.cfg.arch_type in ("vlm", "audio"):
            raise NotImplementedError("the serving engine covers token-only archs; "
                                      f"{model.cfg.name} is {model.cfg.arch_type}")
        self.device = resolve_device(device)
        self.model = model
        self.max_slots = max_slots
        self.prompt_capacity = prompt_capacity
        self.capacity = prompt_capacity + max_new_tokens
        self.queue: Deque[Request] = deque()
        self.slots: List[Optional[Request]] = [None] * max_slots
        self.finished: List[Request] = []
        self.cache = M.init_cache(model.cfg, max_slots, self.capacity, self.device)
        self.last_tokens = np.zeros((max_slots, 1), np.int64)

    # ------------------------------------------------------------- admission

    def submit(self, req: Request):
        """Queue ``req``; its prompt must be a 1-D array of at most ``prompt_capacity`` tokens."""
        if req.prompt.ndim != 1:
            raise ValueError("prompt must be a 1-D token array")
        if len(req.prompt) > self.prompt_capacity:
            raise ValueError(f"prompt of {len(req.prompt)} tokens exceeds the prompt capacity "
                             f"{self.prompt_capacity}")
        self.queue.append(req)

    def _merge_slot(self, slot: int, one_cache):
        """Copy a single-stream cache into pool slot ``slot``, in place.

        Cache leaves have the stream dim at index 1 (kv/conv/ssm are
        stacked (L, B, ...), a hybrid's kv (invocations, B, ...)) except
        ``pos``, which is (B,).
        """
        for pool, one in zip(tree_leaves(self.cache), tree_leaves(one_cache)):
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
            logits, one_cache = M.prefill(self.model, tokens, max_len=self.capacity)
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
            if (req.eos_id is not None and tok == req.eos_id) or (
                len(req.output) >= req.max_new_tokens
            ):
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
