"""Serving: one-token ``serve_step`` and the slot-based batched server.

Counterpart of ``repro.serving.decode``. The cache is updated in place by
``decode_step``; ``SlotServer`` keeps its f32 cache whatever the params'
dtype and never bounds a slot's position, as the JAX server does.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional

import torch

from repro_torch.models import model as M


def serve_step(params, cache, tokens: torch.Tensor, pos: torch.Tensor, *,
               cfg, rt: M.Runtime, temperature: float = 0.0,
               generator: Optional[torch.Generator] = None):
    """One decode step for a batch of request slots.

    tokens: [B] current token per slot; pos: [B] positions.
    Returns (next_tokens [B] int32, logits [B,V], cache). Greedy unless a
    temperature and a generator are given.
    """
    logits, cache = M.decode_step(params, cache, tokens, pos, cfg, rt)
    if temperature > 0.0 and generator is not None:
        probs = torch.softmax(logits / temperature, dim=-1)
        nxt = torch.multinomial(probs, 1, generator=generator)[:, 0]
    else:
        nxt = torch.argmax(logits, dim=-1)
    return nxt.to(torch.int32), logits, cache


def make_serve_step(cfg, rt: M.Runtime, temperature: float = 0.0):
    return functools.partial(serve_step, cfg=cfg, rt=rt,
                             temperature=temperature)


class SlotServer:
    """Minimal continuous-batching server: fixed B slots, per-slot position,
    requests queue in when slots free up. Runs where ``params`` live."""

    def __init__(self, params: M.DecoderParams, cfg, rt: M.Runtime,
                 n_slots: int, max_len: int, bos: int = 1):
        self.params, self.cfg, self.rt = params, cfg, rt
        self.n_slots, self.max_len, self.bos = n_slots, max_len, bos
        dev = params.embed.device
        self.cache = M.init_cache(cfg, n_slots, max_len, torch.float32, dev)
        self.tokens = torch.full((n_slots,), bos, dtype=torch.int32, device=dev)
        self.pos = torch.zeros((n_slots,), dtype=torch.int32, device=dev)
        self.active = [False] * n_slots
        self.outputs: Dict[int, list] = {}
        self._slot_req: Dict[int, int] = {}
        self._step = make_serve_step(cfg, rt)
        self._next_req = 0

    def submit(self, prompt_token: int) -> int:
        rid = self._next_req
        self._next_req += 1
        for s in range(self.n_slots):
            if not self.active[s]:
                self.active[s] = True
                self.tokens[s] = prompt_token
                self.pos[s] = 0
                self.outputs[rid] = []
                self._slot_req[s] = rid
                return rid
        raise RuntimeError("no free slot")

    def step(self):
        nxt, _, self.cache = self._step(self.params, self.cache, self.tokens,
                                        self.pos)
        active = torch.tensor(self.active, device=self.pos.device)
        self.pos = self.pos + active.to(torch.int32)
        self.tokens = torch.where(active, nxt, self.tokens)
        nxt_host = nxt.tolist()
        for s in range(self.n_slots):
            if self.active[s]:
                self.outputs[self._slot_req[s]].append(nxt_host[s])

    def finish(self, rid: int):
        for s, r in self._slot_req.items():
            if r == rid:
                self.active[s] = False
        return self.outputs.pop(rid)
