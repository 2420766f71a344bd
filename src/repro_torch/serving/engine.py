"""Batched serving engine: continuous batching over a fixed slot pool (the
JAX package's ``serving/engine.py``, with its schedule).

A ``ServeEngine`` owns a ``Model``, a slot-pooled KV cache and the decode
and prefill programs.  Requests queue up; each engine step

  1. admits queued requests into free slots: a B=1 prefill at the prompt's
     exact length fills a fresh cache, which is scattered into the slot's
     cache lane,
  2. runs ONE batched decode step over all slots (per-slot positions: the
     attention cache path takes a ``cache_pos`` vector, so sequences of
     different lengths share one step),
  3. samples (greedy / temperature / top-k), appends, retires finished
     slots and immediately refills them from the queue.

The JAX engine jit-compiles the prefill once per prompt length and the
decode once; the port runs them eagerly.  Greedy sampling is an argmax.
Temperature and top-k sampling draw from the engine's own
``torch.Generator`` seeded from ``EngineConfig.seed``: the same schedule,
but not ``jax.random``'s draws.

Stub-frontend families (``[audio]``/``[vlm]``) take a prompt of (S, D)
frame/patch embeddings and decode each sampled token id through a fixed
(vocab, D) table (``models/frontend.py`` ``stub_token_table``); the
caller may pass that table's standard normal draw as ``stub_table``.  The
JAX engine casts every prompt to int32 before its prefill, which truncates
such embeddings; the port keeps their values (``DESIGN.md``).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..core.data import resolve_device
from ..models.frontend import stub_token_table, uses_stub_frontend
from ..models.model import Model
from ..models.transformer import cache_leaves


@dataclass
class EngineConfig:
    slots: int = 4
    max_seq: int = 512
    temperature: float = 0.0  # 0 = greedy
    top_k: int = 0
    eos_token: int = -1  # -1 = never stops early
    seed: int = 0


@dataclass
class Request:
    rid: int
    prompt: np.ndarray  # (S,) int tokens ((S, D) float embeds for stub-frontend archs)
    max_new_tokens: int = 16
    out_tokens: List[int] = field(default_factory=list)
    done: bool = False
    t_submit: float = field(default_factory=time.time)
    t_first: Optional[float] = None
    t_done: Optional[float] = None


class ServeEngine:
    def __init__(self, cfg: ArchConfig, model: Model, ecfg: Optional[EngineConfig] = None, *,
                 device=None, stub_table=None):
        """``model`` runs on ``device`` (CUDA unless the caller passes
        another; raises without it), and must already lie there.
        ``stub_table``: see the module docstring (stub frontends only)."""
        dev = resolve_device(device)
        if model.device.type != dev.type or dev.index not in (None, model.device.index):
            raise ValueError(f"the model lies on {model.device}, the engine runs on {dev}")
        self.device = model.device
        self.cfg = cfg
        self.ecfg = ecfg or EngineConfig()
        self.model = model
        B, S = self.ecfg.slots, self.ecfg.max_seq
        self.cache = self.model.init_cache(B, S)
        self.slot_req: List[Optional[Request]] = [None] * B
        self.slot_pos = np.zeros(B, dtype=np.int64)  # next write index
        self.slot_tok = np.zeros(B, dtype=np.int64)  # last sampled token
        self.requests: List[Request] = []
        self.queue: List[Request] = []
        self._gen = torch.Generator(device=self.device).manual_seed(self.ecfg.seed)
        self.stub = uses_stub_frontend(cfg)
        self.stub_table = stub_token_table(cfg, self.device, stub_table) if self.stub else None
        self.decode_steps = 0

    # -- programs ------------------------------------------------------------
    def _prefill_fn(self, prompt: torch.Tensor):
        """prompt (1, S) tokens or (1, S, D) embeds -> (last-token logits
        (1, V), a fresh one-row cache holding the prompt)."""
        cache = self.model.init_cache(1, self.ecfg.max_seq)
        return self.model.prefill({"embeds" if self.stub else "tokens": prompt}, cache)

    def _scatter_fn(self, one, slot: int) -> None:
        # every cache leaf has layout (G, B, ...): the batch lane is axis 1
        for pool, new in zip(cache_leaves(self.cache), cache_leaves(one)):
            pool[:, slot] = new[:, 0]

    def _decode_fn(self, tokens: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """tokens (B,), pos (B,) -> next tokens (B,); the cache in place."""
        if self.stub:  # a sampled id enters through its fixed embedding
            batch = {"embeds": self.stub_table[tokens][:, None].to(self.cfg.compute_dtype)}
        else:
            batch = {"tokens": tokens[:, None]}
        logits, self.cache = self.model.decode_step(self.cache, batch, pos)
        e = self.ecfg
        if e.temperature <= 0.0:
            return logits.argmax(-1)
        l = logits / e.temperature
        if e.top_k > 0:
            kth = torch.topk(l, e.top_k, dim=-1).values[:, -1:]
            l = torch.where(l < kth, float("-inf"), l)
        return torch.multinomial(torch.softmax(l, dim=-1), 1, generator=self._gen)[:, 0]

    # -- API -------------------------------------------------------------------
    def submit(self, req: Request) -> None:
        self.requests.append(req)
        self.queue.append(req)

    def _sample_host(self, logits: torch.Tensor) -> int:
        e = self.ecfg
        if e.temperature <= 0.0:
            return int(logits.argmax(-1)[0])
        probs = torch.softmax(logits / e.temperature, dim=-1)
        return int(torch.multinomial(probs, 1, generator=self._gen)[0, 0])

    def _admit(self) -> None:
        for slot in range(self.ecfg.slots):
            if self.slot_req[slot] is not None or not self.queue:
                continue
            req = self.queue.pop(0)
            S = len(req.prompt)
            if S + req.max_new_tokens > self.ecfg.max_seq:
                raise ValueError(f"request {req.rid}: prompt {S} + {req.max_new_tokens} new tokens "
                                 f"exceed max_seq {self.ecfg.max_seq}")
            if self.stub:
                prompt = torch.as_tensor(np.asarray(req.prompt, dtype=np.float32)[None], device=self.device)
            else:
                prompt = torch.as_tensor(np.asarray(req.prompt, dtype=np.int64)[None], device=self.device)
            logits, one_cache = self._prefill_fn(prompt)
            self._scatter_fn(one_cache, slot)
            tok = self._sample_host(logits)
            self.slot_req[slot] = req
            self.slot_pos[slot] = S
            self.slot_tok[slot] = tok
            req.out_tokens.append(tok)
            req.t_first = time.time()

    def step(self) -> int:
        """One engine iteration; returns number of active slots."""
        self._admit()
        active = [i for i, r in enumerate(self.slot_req) if r is not None]
        if not active:
            return 0
        nxt = self._decode_fn(
            torch.as_tensor(self.slot_tok, device=self.device),
            torch.as_tensor(self.slot_pos, device=self.device),
        )
        nxt = nxt.cpu().numpy()
        self.decode_steps += 1
        for i in active:
            req = self.slot_req[i]
            self.slot_pos[i] += 1
            tok = int(nxt[i])
            self.slot_tok[i] = tok
            req.out_tokens.append(tok)
            if len(req.out_tokens) >= req.max_new_tokens or tok == self.ecfg.eos_token:
                req.done = True
                req.t_done = time.time()
                self.slot_req[i] = None
                self.slot_pos[i] = 0
        return len(active)

    def run_until_drained(self, max_steps: int = 10_000) -> List[Request]:
        steps = 0
        while (self.queue or any(r is not None for r in self.slot_req)) and steps < max_steps:
            self.step()
            steps += 1
        return [r for r in self.requests if r.done]
