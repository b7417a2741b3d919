"""Batched serving engine: continuous batching over a shared KV cache.

The port of the reference's `serve/engine.py`, with the same slot semantics:
a fixed pool of `max_batch` slots, each with its own cursor into the shared
(L, B, S, Hkv, Dh) cache; requests join free slots and prefill their prompt
token by token through `decode_step`; each step runs the whole pool (idle
slots are fed token 0 at their own position), picks the greedy argmax and
frees the slots whose request is done. Decoding is greedy only: the
reference's `temperature` argument, which nothing there reads, is not
ported. The cache lives on the engine's device (CUDA unless given) and is
updated in place.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list
    max_new: int
    out: list = dataclasses.field(default_factory=list)
    done: bool = False


class ServeEngine:
    def __init__(self, model_mod, params, cfg, max_batch: int = 8,
                 max_seq: int = 512,
                 device: torch.device | str | None = None):
        self.device = resolve_device(device, "ServeEngine")
        self.mod = model_mod
        self.params = params
        self.cfg = cfg
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.cache = model_mod.init_cache(cfg, max_batch, max_seq,
                                          device=self.device)
        self.pos = np.zeros(max_batch, dtype=np.int32)
        self.slot_req: list = [None] * max_batch
        self.queue: list = []
        # one pool-wide decode step: (params, cache, tokens, pos) -> (logits,
        # cache), the counterpart of the reference's jitted step
        self._step = lambda p, c, t, q: model_mod.decode_step(p, c, t, q, cfg)

    # ------------------------------------------------------------------
    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.tensor(a, device=self.device)    # a copy

    def _admit(self) -> None:
        for slot in range(self.max_batch):
            if self.slot_req[slot] is None and self.queue:
                req = self.queue.pop(0)
                self.slot_req[slot] = req
                self.pos[slot] = 0
                # prefill the prompt token by token through decode (simple,
                # exact; bulk prefill is forward_with_cache)
                for tok in req.prompt[:-1]:
                    self._advance_slot(slot, tok)
                req._next = req.prompt[-1]

    def _advance_slot(self, slot: int, token: int) -> int:
        tokens = np.zeros(self.max_batch, dtype=np.int32)
        tokens[slot] = token
        logits, self.cache = self._step(
            self.params, self.cache, self._tensor(tokens),
            self._tensor(self.pos))
        self.pos[slot] += 1
        return int(torch.argmax(logits[slot]))

    def step(self) -> int:
        """One engine iteration over every active slot; returns #active."""
        self._admit()
        active = [s for s in range(self.max_batch)
                  if self.slot_req[s] is not None]
        if not active:
            return 0
        tokens = np.zeros(self.max_batch, dtype=np.int32)
        for s in active:
            tokens[s] = self.slot_req[s]._next
        logits, self.cache = self._step(
            self.params, self.cache, self._tensor(tokens),
            self._tensor(self.pos))
        nxt = torch.argmax(logits, dim=-1).cpu().numpy()
        for s in active:
            req = self.slot_req[s]
            self.pos[s] += 1
            req.out.append(int(nxt[s]))
            req._next = int(nxt[s])
            if len(req.out) >= req.max_new or self.pos[s] >= self.max_seq - 1:
                req.done = True
                self.slot_req[s] = None
        return len(active)

    def run(self) -> None:
        while self.queue or any(r is not None for r in self.slot_req):
            self.step()
