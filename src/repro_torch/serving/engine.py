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

The JAX engine jit-compiles three programs (``jax.jit`` of ``_decode``,
``_prefill`` with a static ``pad_len`` and ``_scatter`` with a static
``slot``).  The port captures two of their counterparts, each a
``CapturedCall`` (``core/executors/captured.py``), into CUDA graphs on the
card, with the reference's compile counts: one decode graph, one scatter
graph per slot used; every later call replays its graph
(``ServeEngine.stats``).  The decode program takes the slot-pooled cache
as a donated argument, always the same tensors, and writes it in place;
each scatter program copies the one-row prefill cache, also always the
same tensors, into its slot's cache lane.  The engine thus holds 1 +
``slots`` graphs, whatever its traffic.  The weights are read through the
model, by address: replacing a parameter's storage after the first call
is not supported.  A capture that fails raises ``CaptureError`` naming the
program; the decode and the scatters never run eagerly on the card.  On
the CPU every program runs eagerly, counting the same compiles.

The prefill runs eagerly on either device, one call an admission: it is
the one program whose shape follows the traffic (the prompt's length), and
a graph per length pays only where that length comes back.  A capture
costs a warm-up run, the recording and a pool of its own: on an H100 at
starcoder2-7b's widths a length's first call took 485-858 ms against an
eager prefill's 65-107 ms, a length had to come back 10-74 times to pay
that back, and 30 lengths held 17.7 GB of pools
(``scripts/engine_traffic.py``).  The prefill zeroes the one-row cache
before it fills it: the reference builds a fresh zeroed cache, and a
recurrent state must not carry one prompt into the next.

Greedy sampling is an argmax.  Temperature and top-k sampling is a
Gumbel-max draw (``sample``): argmax(logits / T + Gumbel noise), the
noise from the engine's own ``torch.Generator`` seeded from
``EngineConfig.seed`` and registered with the decode graph, so that every
replay draws anew, as an eager call does.  It samples from the same
distribution as the JAX engine's ``jax.random.categorical``, but not its
draws.  The first token of a request is sampled on the host side from the
prefill's logits, outside the programs, as in the reference.

Stub-frontend families (``[audio]``/``[vlm]``) take a prompt of (S, D)
frame/patch embeddings and decode each sampled token id through a fixed
(vocab, D) table (``models/frontend.py`` ``stub_token_table``); the
caller may pass that table's standard normal draw as ``stub_table``.  The
JAX engine casts every prompt to int32 before its prefill, which truncates
such embeddings; the port keeps their values (``DESIGN.md``).
"""

from __future__ import annotations

import functools
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..core.data import resolve_device
from ..core.executors.captured import CapturedCall
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


def sample(logits: torch.Tensor, temperature: float, top_k: int, generator: torch.Generator) -> torch.Tensor:
    """(B, V) logits -> (B,) token ids: the argmax when ``temperature`` is
    0, else a Gumbel-max draw from softmax(logits / temperature) over the
    ``top_k`` largest (all when 0), with uniforms from ``generator``.  It
    reads nothing back to the host, so a CUDA graph can hold it."""
    if temperature <= 0.0:
        return logits.argmax(-1)
    l = logits.float() / temperature
    if top_k > 0:
        kth = torch.topk(l, top_k, dim=-1).values[:, -1:]
        l = torch.where(l < kth, float("-inf"), l)
    u = torch.rand(l.shape, generator=generator, device=l.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))
    return (l + gumbel).argmax(-1)


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
        self._one = self.model.init_cache(1, S)  # the prefills' one-row cache, scattered into a slot
        self.slot_req: List[Optional[Request]] = [None] * B
        self.slot_pos = np.zeros(B, dtype=np.int64)  # next write index
        self.slot_tok = np.zeros(B, dtype=np.int64)  # last sampled token
        self.requests: List[Request] = []
        self.queue: List[Request] = []
        self._gen = torch.Generator(device=self.device).manual_seed(self.ecfg.seed)
        self.stub = uses_stub_frontend(cfg)
        self.stub_table = stub_token_table(cfg, self.device, stub_table) if self.stub else None
        self.decode_steps = 0
        self.prefills = 0  # eager prefill calls
        self._decode = self._compiled(self._decode_fn, "ServeEngine decode", donate=(True,),
                                      generators=(self._gen,))
        self._scatter: Dict[int, CapturedCall] = {}  # slot -> its program

    def _compiled(self, fn, name: str, donate, generators=()) -> CapturedCall:
        """A program of the engine: captured on its first call on the card
        and replayed after; eager on the CPU.  ``generators``: those it
        draws from (the decode's sampler)."""
        return CapturedCall(fn, name, donate=donate, generators=generators)

    # -- programs ------------------------------------------------------------
    def _prefill_fn(self, one, prompt: torch.Tensor) -> torch.Tensor:
        """``one``: the one-row cache, zeroed and then filled in place from
        the prompt (1, S) tokens or (1, S, D) embeds -> the last token's
        logits (1, V)."""
        for leaf in cache_leaves(one):
            leaf.zero_()
        logits, _ = self.model.prefill({"embeds" if self.stub else "tokens": prompt}, one)
        return logits

    @staticmethod
    def _scatter_fn(pool, one, slot: int) -> None:
        # every cache leaf has layout (G, B, ...): the batch lane is axis 1
        for p, new in zip(cache_leaves(pool), cache_leaves(one)):
            p[:, slot] = new[:, 0]

    def _decode_fn(self, cache, tokens: torch.Tensor, pos: torch.Tensor):
        """tokens (B,), pos (B,) -> (next tokens (B,), logits (B, V)); the
        cache written in place."""
        if self.stub:  # a sampled id enters through its fixed embedding
            batch = {"embeds": self.stub_table[tokens][:, None].to(self.cfg.compute_dtype)}
        else:
            batch = {"tokens": tokens[:, None]}
        logits, _ = self.model.decode_step(cache, batch, pos)
        return sample(logits, self.ecfg.temperature, self.ecfg.top_k, self._gen), logits

    def _scatter_call(self, slot: int):
        if slot not in self._scatter:
            fn = functools.partial(self._scatter_fn, slot=slot)
            self._scatter[slot] = self._compiled(fn, f"ServeEngine scatter slot={slot}", donate=(True, True))
        return self._scatter[slot]

    @property
    def stats(self) -> Dict[str, Dict]:
        """Per program (decode, prefill, scatter): its compiles (captures on
        the card, first calls on the CPU), graph replays and pool bytes (the
        device memory its captures reserved; 0 on the CPU), summed over its
        call sites; the prefill, never compiled, also gives its eager
        calls."""
        def tally(calls):
            return {"compiles": sum(c.compiles for c in calls), "graph_replays": sum(c.graph_replays for c in calls),
                    "pool_bytes": sum(c.pool_bytes for c in calls)}

        return {"decode": tally([self._decode]),
                "prefill": {**tally([]), "eager_calls": self.prefills},
                "scatter": tally(list(self._scatter.values()))}

    def release(self) -> None:
        """Drop every program's graph and private pool (the next call on the
        card captures again)."""
        for call in [self._decode, *self._scatter.values()]:
            call.release()

    # -- API -------------------------------------------------------------------
    def submit(self, req: Request) -> None:
        self.requests.append(req)
        self.queue.append(req)

    def _sample_host(self, logits: torch.Tensor) -> int:
        return int(sample(logits, self.ecfg.temperature, 0, self._gen)[0])

    def _admit(self) -> None:
        for slot in range(self.ecfg.slots):
            if self.slot_req[slot] is not None or not self.queue:
                continue
            req = self.queue.pop(0)
            S = len(req.prompt)
            if S + req.max_new_tokens > self.ecfg.max_seq:
                raise ValueError(f"request {req.rid}: prompt {S} + {req.max_new_tokens} new tokens "
                                 f"exceed max_seq {self.ecfg.max_seq}")
            dtype = np.float32 if self.stub else np.int64
            prompt = torch.as_tensor(np.asarray(req.prompt, dtype=dtype)[None], device=self.device)
            logits = self._prefill_fn(self._one, prompt)
            self.prefills += 1
            self._scatter_call(slot)(self.cache, self._one)
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
        nxt, _ = self._decode(
            self.cache,
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
