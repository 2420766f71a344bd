"""Top-level model: embed or stub frontend -> layer groups -> norm -> head
(the JAX package's ``models/model.py``).

The JAX package builds a namespace of pure functions over a parameter
tree; the port's ``Model`` is an ``nn.Module`` that holds its parameters
(frozen: this port runs inference and the forward loss, no backward)::

    forward(batch, positions=None, cache=None, cache_pos=None) -> (hidden, cache)
    loss(batch)                      scalar LM loss + metrics (chunked xent, MoE aux)
    prefill(batch, cache)            fill the cache from position 0
    decode_step(cache, batch, pos)   one token a row with the cache
    lm_logits(h), init_cache(batch, max_seq), param_counts()

Batch convention: {"tokens": (B, S) int} for token-input families, or
{"embeds": (B, S, D)} for the stub-frontend families (``[audio]``/
``[vlm]``); training adds {"labels": (B, S) int}.

Parameters are cast once, at load: every floating parameter of two or more
dimensions is stored in ``cfg.compute_dtype`` and no float32 copy stays on
the device; 1-D scales and biases, and every leaf under a ``router`` (the
MoE router's weights, whose logits decide the routing), stay in
``cfg.param_dtype``.  That is the effect of the JAX package's
``cast_for_forward`` (which ``loss``/``prefill``/``decode_step`` apply per
call, and every layer's ``astype(x.dtype)`` applies inside ``forward``),
so both give the same numbers.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..core.data import resolve_device
from ..kernels.ref import fp32_matmul
from .frontend import uses_stub_frontend
from .layers import (PSpec, count_template, init_tensor, map_template, norm_apply, norm_template, sinusoidal_embed,
                     template_leaves)
from .transformer import group_layout, init_cache, n_groups, stack_apply, stack_template


def model_template(cfg: ArchConfig) -> Dict[str, Any]:
    D, V = cfg.d_model, cfg.vocab
    t: Dict[str, Any] = {}
    if not uses_stub_frontend(cfg):
        t["embed"] = PSpec((V, D), ("vocab", "embed"), init="embed", scale=0.02)
    t["stack"] = stack_template(cfg)
    t["final_norm"] = norm_template(cfg)
    if uses_stub_frontend(cfg) or not cfg.tie_embeddings:
        t["lm_head"] = PSpec((D, V), ("embed", "vocab"))
    return t


def param_counts(cfg: ArchConfig) -> Dict[str, int]:
    """Exact N from the template (no allocation).  A token runs top_k of
    the n_experts experts, so the active count takes top_k / n_experts of
    every leaf with an ``experts`` axis."""
    t = model_template(cfg)
    total = count_template(t)
    embed = count_template(t["embed"]) if "embed" in t else 0
    expert_total = expert_active = 0
    for s in template_leaves(t):
        if "experts" in s.logical:
            n = math.prod(s.shape)
            expert_total += n
            expert_active += (n // cfg.n_experts) * cfg.top_k
    active = total - expert_total + expert_active
    return {
        "total": total,
        "active": active,
        "embed": embed,
        "active_nonembed": active - embed,
        "total_nonembed": total - embed,
    }


class ParamTree(nn.Module):
    """A parameter tree as a module: dicts become ``ParamTree``s, lists
    ``nn.ModuleList``s, tensors frozen parameters; ``p["key"]`` reads a
    child as the JAX code reads its dict."""

    def __init__(self, tree: Dict[str, Any]):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, torch.Tensor):
                self.register_parameter(k, nn.Parameter(v, requires_grad=False))
            elif isinstance(v, dict):
                self.add_module(k, ParamTree(v))
            else:
                self.add_module(k, nn.ModuleList(ParamTree(x) for x in v))

    def __getitem__(self, key: str):
        return getattr(self, key)

    def __contains__(self, key: str) -> bool:
        return key in self._parameters or key in self._modules


def _cast_at_load(cfg: ArchConfig, t: torch.Tensor, path: str) -> torch.Tensor:
    """``cast_for_forward``'s rule: >= 2-D floats to the compute dtype, but
    never a leaf under ``router``."""
    if not t.is_floating_point():
        return t
    if t.dim() >= 2 and "router" not in path.split("/"):
        return t.to(cfg.compute_dtype)
    return t.to(cfg.param_dtype)


class Model(nn.Module):
    def __init__(self, cfg: ArchConfig, params: Dict[str, Any]):
        super().__init__()
        self.cfg = cfg
        self.params = ParamTree(params)

    @property
    def device(self) -> torch.device:
        return self.params["final_norm"]["scale"].device

    # -- embedding / head --------------------------------------------------
    def embed_batch(self, batch: Dict[str, torch.Tensor], positions: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        if "embeds" in batch:
            h = batch["embeds"].to(cfg.compute_dtype)
        else:
            h = F.embedding(batch["tokens"].long(), self.params["embed"]).to(cfg.compute_dtype)
        if cfg.embed_scale:
            # the scale rounded to h's dtype, as jnp.asarray(..., h.dtype), a host scalar
            h = h * torch.tensor(math.sqrt(cfg.d_model), dtype=h.dtype).item()
        if cfg.pos_type == "sinusoidal":
            h = h + sinusoidal_embed(positions, cfg.d_model).to(h.dtype)
        return h

    def _head_weight(self) -> torch.Tensor:
        if "lm_head" in self.params:
            return self.params["lm_head"]  # (D, V)
        return self.params["embed"].T  # tied

    def lm_logits(self, h: torch.Tensor) -> torch.Tensor:
        """float32 logits: bf16 operands give an fp32 product (the JAX
        ``preferred_element_type=float32``).  On the card a bf16 GEMM with an
        fp32 accumulator and fp32 output computes it from the bf16 head as
        it lies; elsewhere (the CPU has no such GEMM) the operands are
        upcast, which copies the head."""
        w = self._head_weight().to(self.cfg.compute_dtype)
        if w.is_cuda and h.dtype == w.dtype == torch.bfloat16:
            out = torch.mm(h.reshape(-1, h.shape[-1]), w, out_dtype=torch.float32)
            return out.reshape(*h.shape[:-1], w.shape[-1])
        with fp32_matmul():
            return h.float() @ w.float()

    # -- forward -----------------------------------------------------------
    def forward(
        self,
        batch: Dict[str, torch.Tensor],
        positions: Optional[torch.Tensor] = None,
        cache=None,
        cache_pos=None,
    ):
        """Returns (hidden (B, S, D), cache); the cache is updated in place."""
        h, cache, _ = self.forward_aux(batch, positions, cache, cache_pos)
        return h, cache

    def forward_aux(self, batch: Dict[str, torch.Tensor], positions=None, cache=None, cache_pos=None):
        """``forward`` that also returns the summed MoE aux loss, as the JAX
        package's ``forward`` does: (hidden, cache, aux)."""
        x0 = batch["embeds"] if "embeds" in batch else batch["tokens"]
        B, S = x0.shape[0], x0.shape[1]
        if positions is None:
            positions = torch.arange(S, device=x0.device)[None, :]
            if torch.is_tensor(cache_pos):
                positions = positions + cache_pos.to(x0.device).reshape(-1, 1)
            elif cache_pos:
                positions = positions + cache_pos
            positions = positions.expand(B, S)
        h = self.embed_batch(batch, positions)
        h, aux = stack_apply(self.cfg, self.params["stack"], h, positions, cache, cache_pos)
        return norm_apply(self.cfg, self.params["final_norm"], h), cache, aux

    def chunked_xent(self, h: torch.Tensor, labels: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Cross-entropy over sequence chunks of ``cfg.loss_chunk``, so the
        (B, S, V) float32 logits never exist whole.  Returns (mean loss,
        token accuracy)."""
        B, S, D = h.shape
        c = min(self.cfg.loss_chunk, S)
        if S % c != 0:
            c = S
        tot = torch.zeros((), dtype=torch.float32, device=h.device)
        acc = torch.zeros((), dtype=torch.int64, device=h.device)
        for hh, yy in zip(h.split(c, dim=1), labels.long().split(c, dim=1)):
            logits = self.lm_logits(hh)
            lse = torch.logsumexp(logits, dim=-1)
            gold = logits.gather(-1, yy[..., None])[..., 0]
            tot = tot + (lse - gold).sum()
            acc = acc + (logits.argmax(-1) == yy).sum()
        n = B * S
        return tot / n, acc.float() / n

    def loss(self, batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        cfg = self.cfg
        h, _, aux = self.forward_aux(batch)
        loss, acc = self.chunked_xent(h, batch["labels"])
        metrics = {"xent": loss, "accuracy": acc}
        if cfg.is_moe:
            n_moe = sum(1 for d in group_layout(cfg) if d.moe) * n_groups(cfg)
            aux = cfg.moe_aux_weight * aux / max(n_moe, 1)
            metrics["moe_aux"] = aux
            loss = loss + aux
        metrics["loss"] = loss
        return loss, metrics

    def prefill(self, batch: Dict[str, torch.Tensor], cache):
        """Run the prompt filling ``cache`` from position 0.  Returns
        (last-token logits (B, V), cache)."""
        h, cache = self.forward(batch, cache=cache, cache_pos=0)
        return self.lm_logits(h[:, -1]), cache

    def decode_step(self, cache, batch: Dict[str, torch.Tensor], pos):
        """One decode step at ``pos`` (a scalar, or (B,) per-row positions).
        Returns (logits (B, V), cache)."""
        h, cache = self.forward(batch, cache=cache, cache_pos=pos)
        return self.lm_logits(h[:, -1]), cache

    def init_cache(self, batch: int, max_seq: int):
        return init_cache(self.cfg, batch, max_seq, device=self.device)

    def param_counts(self) -> Dict[str, int]:
        return param_counts(self.cfg)


def _load(cfg: ArchConfig, template, params, device, path: str = ""):
    """``params`` (the template's tree of tensors or arrays) checked
    against the template's shapes and cast at load, on ``device``."""
    if isinstance(template, PSpec):
        t = torch.as_tensor(params)
        if tuple(t.shape) != template.shape:
            raise ValueError(f"parameter {path}: shape {tuple(t.shape)} != template {template.shape}")
        return _cast_at_load(cfg, t.to(device), path)
    if isinstance(template, dict):
        return {k: _load(cfg, v, params[k], device, f"{path}/{k}") for k, v in template.items()}
    if len(params) != len(template):
        raise ValueError(f"parameter list {path}: {len(params)} entries != template {len(template)}")
    return [_load(cfg, v, p, device, f"{path}/{i}") for i, (v, p) in enumerate(zip(template, params))]


def build_model(cfg: ArchConfig, params: Optional[Dict[str, Any]] = None, *, seed: int = 0,
                device=None) -> Model:
    """A ``Model`` of ``cfg`` on ``device`` (CUDA unless the caller passes
    another; raises without it).  ``params`` is a tree in the port's layout
    (``models/convert.py`` makes one from the JAX package's); without it
    the weights are drawn by the JAX package's init rules from a
    ``torch.Generator`` seeded with ``seed``, on the device, each leaf cast
    as soon as it is drawn."""
    template = model_template(cfg)
    dev = resolve_device(device)
    if params is None:
        gen = torch.Generator(device=dev).manual_seed(seed)
        params = map_template(template, lambda s, path: _cast_at_load(cfg, init_tensor(s, gen, cfg.param_dtype, dev),
                                                                        path))
    else:
        params = _load(cfg, template, params, dev)
    return Model(cfg, params)
