"""Top-level model: embed or stub frontend -> layer groups -> norm -> head
(the JAX package's ``models/model.py``).

The JAX package builds a namespace of pure functions over a parameter
tree; the port's ``Model`` is an ``nn.Module`` that holds its parameters::

    forward(batch, positions=None, cache=None, cache_pos=None) -> (hidden, cache)
    loss(batch)                      scalar LM loss + metrics (chunked xent, MoE aux)
    loss_of(params, batch)           the same over a flat {name: tensor} dict
    value_and_grad(params, batch)    ((loss, metrics), grads) over that dict
    prefill(batch, cache)            fill the cache from position 0
    decode_step(cache, batch, pos)   one token a row with the cache
    lm_logits(h), init_cache(batch, max_seq), param_counts()

Batch convention: {"tokens": (B, S) int} for token-input families, or
{"embeds": (B, S, D)} for the stub-frontend families (``[audio]``/
``[vlm]``); training adds {"labels": (B, S) int}.

Two forms, chosen by ``build_model(..., train=...)``:

- **Serving** (the default): parameters are cast once, at load, and
  frozen: every floating parameter of two or more dimensions is stored in
  ``cfg.compute_dtype`` and no float32 copy stays on the device; 1-D
  scales and biases, and every leaf under a ``router`` (the MoE router's
  weights, whose logits decide the routing), stay in ``cfg.param_dtype``.
  That is the effect of the JAX package's ``cast_for_forward`` (which
  ``loss``/``prefill``/``decode_step`` apply per call, and every layer's
  ``astype(x.dtype)`` applies inside ``forward``), so both give the same
  numbers.
- **Training**: the parameters are ``cfg.param_dtype`` (fp32) masters that
  require grad.  ``value_and_grad(params, batch)`` (and ``loss_of``, its
  forward) applies ``cast_for_forward`` to a flat ``{name: tensor}`` dict
  of masters (the names of ``train_params()``; the same dict is AdamW's
  tree) on every call, as a differentiable ``.to(compute_dtype)``, and
  runs ``loss`` through ``torch.func.functional_call``: the gradients land
  in the fp32 masters, as the reference's backward through its convert
  does.

Over a mesh every method takes ``moe_ctx`` (``models/moe.py`` ``MoeCtx``):
the parameters are this rank's blocks, gathered over the data axes at use
(the embedding, the head once a loss, each group in its rematerialised
body; ``models/spmd.py``), and the batch is this rank's rows.  Over
``model`` the embedding, the head and the loss are vocab-parallel where
the vocab divides it, and under sequence parallelism ``forward`` returns
this rank's chunk of the sequence.  Without it nothing is gathered, as on
one device.  ``call(params, method, ...)`` runs
``prefill``/``decode_step``/``forward`` over a flat dict of parameters, as
``loss_of`` runs ``loss``.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from ..core.data import resolve_device
from ..kernels.ref import fp32_matmul
from .frontend import uses_stub_frontend
from .layers import (PSpec, count_template, init_tensor, map_template, norm_apply, norm_template, sinusoidal_embed,
                     template_leaves)
from .spmd import all_gather, all_reduce, reduce_from, tp_of
from .transformer import group_layout, init_cache, n_groups, stack_apply, stack_template


def _on_card(t: torch.Tensor) -> bool:
    """The card's GEMM forms: a CUDA tensor, or a fake one, which stands for
    a tensor on the card (the dry run traces the card's step on fake CPU
    tensors, ``launch/dryrun.py``: a CPU build of torch runs no autograd on
    fake CUDA ones)."""
    from torch._subclasses.fake_tensor import FakeTensor

    return t.is_cuda or isinstance(t, FakeTensor)


def _mm32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of bf16 operands with an fp32 accumulator and an fp32
    result: one bf16 GEMM on the card; on the CPU (which has no such GEMM)
    the operands upcast, which is exact."""
    if _on_card(a):
        return torch.mm(a, b, out_dtype=torch.float32)
    with fp32_matmul():
        return a.float() @ b.float()


def bf16_head_grads(h: torch.Tensor, w: torch.Tensor, g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fp32 products ``g @ w.T`` and ``h.T @ g`` of the fp32 logit
    gradient ``g`` with the bf16 operands, as the reference's transpose
    contracts them, from bf16 GEMMs: ``g`` splits into ``hi + lo``, each
    bf16, which hold it to 2**-17 of each element, and each product is the
    sum of two GEMMs."""
    hi = g.to(h.dtype)
    lo = (g - hi.float()).to(h.dtype)
    dh, dw = _mm32(hi, w.t()), _mm32(h.t(), hi)
    dh += _mm32(lo, w.t())
    dw += _mm32(h.t(), lo)
    return dh, dw


class _Bf16Head(torch.autograd.Function):
    """bf16 ``h @ w`` with an fp32 accumulator and an fp32 output (the JAX
    ``preferred_element_type=float32``) on the card.  The backward contracts
    the fp32 gradient with the bf16 operands (``bf16_head_grads``) and
    returns each gradient in its operand's dtype, as the reference's
    transpose does."""

    @staticmethod
    def forward(ctx, h, w):
        ctx.save_for_backward(h, w)
        return _mm32(h, w)

    @staticmethod
    def backward(ctx, g):
        h, w = ctx.saved_tensors
        dh, dw = bf16_head_grads(h, w, g)
        return dh.to(h.dtype), dw.to(w.dtype)


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
    ``nn.ModuleList``s, tensors parameters (frozen for serving; masters that
    require grad for training, where floating); ``p["key"]`` reads a child as
    the JAX code reads its dict."""

    def __init__(self, tree: Dict[str, Any], trainable: bool = False):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, torch.Tensor):
                self.register_parameter(k, nn.Parameter(v, requires_grad=trainable and v.is_floating_point()))
            elif isinstance(v, dict):
                self.add_module(k, ParamTree(v, trainable))
            else:
                self.add_module(k, nn.ModuleList(ParamTree(x, trainable) for x in v))

    def __getitem__(self, key: str):
        return getattr(self, key)

    def __contains__(self, key: str) -> bool:
        return key in self._parameters or key in self._modules


def _casts(t: torch.Tensor, keys) -> bool:
    """``cast_for_forward``'s rule: a >= 2-D float goes to the compute
    dtype, unless it lies under a ``router`` (``keys``: its path's keys)."""
    return t.is_floating_point() and t.dim() >= 2 and "router" not in keys


def _cast_at_load(cfg: ArchConfig, t: torch.Tensor, path: str) -> torch.Tensor:
    """The serving form's leaf: ``_casts`` to the compute dtype, any other
    float to ``cfg.param_dtype``."""
    if _casts(t, path.split("/")):
        return t.to(cfg.compute_dtype)
    return t.to(cfg.param_dtype) if t.is_floating_point() else t


def _master(cfg: ArchConfig, t: torch.Tensor, path: str) -> torch.Tensor:
    """A training master: every floating leaf in ``cfg.param_dtype``."""
    return t.to(cfg.param_dtype) if t.is_floating_point() else t


def cast_for_forward(cfg: ArchConfig, params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The reference's ``cast_for_forward`` over a flat {name: tensor} dict:
    >= 2-D floats to the compute dtype (a differentiable ``.to``, so the
    backward casts each gradient back to its master's dtype), leaves under
    a ``router`` unchanged.  The reference's ``cast_params=False`` and
    ``cast_in_scan`` only move its convert (into every layer's
    ``astype``, or into the scan body), which gives the same values."""
    return {k: p.to(cfg.compute_dtype) if _casts(p, k.split(".")) else p for k, p in params.items()}


class _MethodCall(nn.Module):
    """A ``Model`` method as a module call for ``functional_call`` (see
    ``_LossCall``)."""

    def __init__(self, model: "Model", method: str):
        super().__init__()
        self.params = model.params
        object.__setattr__(self, "_fn", getattr(model, method))  # not a submodule

    def forward(self, *args, **kwargs):
        return self._fn(*args, **kwargs)


class _LossCall(nn.Module):
    """``Model.loss`` as a module call for ``torch.func.functional_call``.
    It registers the model's ``ParamTree`` under the same attribute, so a
    substituted name ``params.<name>`` reaches the tensor the model reads.

    With ``wrt`` it also takes the gradients with respect to those tensors
    inside the call: a rematerialised block recomputes its forward during
    the backward and reads the parameters through the module then, so the
    backward must run while the substitution holds.  ``wrt`` is held, not
    passed as an input: a module tracker's hooks on a call's inputs
    (``FlopCounterMode``'s, ``MemTracker``'s) cannot run inside
    ``autograd.grad`` on those same leaves."""

    def __init__(self, model: "Model", wrt=None):
        super().__init__()
        self.params = model.params
        object.__setattr__(self, "_model", model)  # not a submodule
        object.__setattr__(self, "_wrt", wrt)

    def forward(self, batch, moe_ctx=None):
        loss, metrics = self._model.loss(batch, moe_ctx=moe_ctx)
        if self._wrt is None:
            return loss, metrics
        grads = torch.autograd.grad(loss, self._wrt, allow_unused=True, materialize_grads=True)
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def _for_batch(moe_ctx, batch: Dict[str, torch.Tensor]):
    """The parallel context for a batch's sequence length (``MoeCtx.for_seq``)."""
    if moe_ctx is None:
        return None
    x0 = batch["embeds"] if "embeds" in batch else batch["tokens"]
    return moe_ctx.for_seq(x0.shape[1])


class Model(nn.Module):
    def __init__(self, cfg: ArchConfig, params: Dict[str, Any], train: bool = False):
        super().__init__()
        self.cfg = cfg
        self.params = ParamTree(params, trainable=train)

    @property
    def device(self) -> torch.device:
        return self.params["final_norm"]["scale"].device

    # -- training form -----------------------------------------------------
    def train_params(self) -> Dict[str, torch.Tensor]:
        """The parameters as a flat {name: tensor} dict (names relative to
        the parameter tree, "stack.groups.0.layers.0.attn.wq"): the masters
        of the training form, and AdamW's tree."""
        return dict(self.params.named_parameters())

    def _call(self, params: Dict[str, torch.Tensor], batch, wrt=None, moe_ctx=None):
        cast = cast_for_forward(self.cfg, params)
        # a wrapper a call (kept on the model it would make a reference cycle,
        # and the model's parameters would wait for the garbage collector)
        return torch.func.functional_call(_LossCall(self, wrt), {f"params.{k}": v for k, v in cast.items()}, (batch,),
                                          {"moe_ctx": moe_ctx})

    def call(self, params: Dict[str, torch.Tensor], method: str, *args, **kwargs):
        """``method`` (``prefill``, ``decode_step``, ``forward``...) over
        ``params`` (a flat dict of ``train_params()``'s names, in the dtypes
        the method should compute with) in place of the model's tensors."""
        return torch.func.functional_call(_MethodCall(self, method), {f"params.{k}": v for k, v in params.items()},
                                          args, kwargs)

    def loss_of(self, params: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor], moe_ctx=None):
        """``loss`` over ``params`` (a dict of ``train_params()``'s names) in
        place of the model's own tensors, after ``cast_for_forward``.  Take
        gradients through ``value_and_grad``: a backward outside the call
        would recompute rematerialised blocks with the model's own tensors."""
        return self._call(params, batch, moe_ctx=moe_ctx)

    def value_and_grad(self, params: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor], moe_ctx=None):
        """``((loss, metrics), grads)``, the reference's ``jax.value_and_grad(
        loss, has_aux=True)``: ``grads`` maps each name of ``params`` to the
        gradient of the loss with respect to that (master) tensor, zeros
        where the loss does not depend on it.  Functional: nothing
        accumulates into ``.grad``."""
        # fresh leaves over the same storage: the gradients are taken with
        # respect to them, whether or not the caller's tensors require grad
        leaves = {k: v.detach().requires_grad_(v.is_floating_point()) for k, v in params.items()}
        names = [k for k, v in leaves.items() if v.requires_grad]
        with torch.enable_grad():
            loss, metrics, grads = self._call(leaves, batch, wrt=[leaves[k] for k in names], moe_ctx=moe_ctx)
        return (loss, metrics), dict(zip(names, grads))

    # -- embedding / head --------------------------------------------------
    def _param(self, name: str, moe_ctx=None) -> torch.Tensor:
        """A top-level parameter, gathered whole over a mesh."""
        p = self.params[name]
        if moe_ctx is not None and moe_ctx.params is not None:
            p = moe_ctx.params.leaf(name, p)
        return p

    def embed_batch(self, batch: Dict[str, torch.Tensor], positions: torch.Tensor, moe_ctx=None) -> torch.Tensor:
        """(B, S, D), this rank's chunk of the sequence under SP.  An
        embedding split on vocab over ``model`` looks up the ids in this
        rank's range, zeros elsewhere, and sums the ranks' results (the
        reference's ``constrain_logits`` layout): each id's row lies on one
        rank, so the sum is exact."""
        cfg = self.cfg
        tp = tp_of(moe_ctx)
        own = tp.own if tp is not None else (lambda t: t)
        if "embeds" in batch:
            h = own(batch["embeds"].to(cfg.compute_dtype))
        else:
            w, tok = self._param("embed", moe_ctx), batch["tokens"].long()
            if tp is not None and w.shape[0] != cfg.vocab:
                ids = tok - tp.rank * w.shape[0]
                inside = (ids >= 0) & (ids < w.shape[0])
                e = F.embedding(ids.clamp(0, w.shape[0] - 1), w)
                h = tp.leave(torch.where(inside[..., None], e, torch.zeros((), dtype=e.dtype, device=e.device)))
            else:
                h = F.embedding(own(tok), w)
            h = h.to(cfg.compute_dtype)
        positions = own(positions)
        if cfg.embed_scale:
            # the scale rounded to h's dtype, as jnp.asarray(..., h.dtype), a host scalar
            h = h * torch.tensor(math.sqrt(cfg.d_model), dtype=h.dtype).item()
        if cfg.pos_type == "sinusoidal":
            h = h + sinusoidal_embed(positions, cfg.d_model).to(h.dtype)
        return h

    def _head_weight(self, moe_ctx=None) -> torch.Tensor:
        if "lm_head" in self.params:
            return self._param("lm_head", moe_ctx)  # (D, V)
        return self._param("embed", moe_ctx).T  # tied

    def lm_logits(self, h: torch.Tensor, moe_ctx=None, w: Optional[torch.Tensor] = None) -> torch.Tensor:
        """float32 logits: bf16 operands give an fp32 product (the JAX
        ``preferred_element_type=float32``).  On the card a bf16 GEMM with an
        fp32 accumulator and fp32 output computes it from the bf16 head as
        it lies; elsewhere (the CPU has no such GEMM) the operands are
        upcast, which copies the head.  ``w``: the head, already gathered."""
        w = (self._head_weight(moe_ctx) if w is None else w).to(self.cfg.compute_dtype)
        if _on_card(w) and h.dtype == w.dtype == torch.bfloat16:
            out = _Bf16Head.apply(h.reshape(-1, h.shape[-1]), w)
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
        moe_ctx=None,
    ):
        """Returns (hidden (B, S, D), cache); the cache is updated in place."""
        h, cache, _ = self.forward_aux(batch, positions, cache, cache_pos, moe_ctx)
        return h, cache

    def forward_aux(self, batch: Dict[str, torch.Tensor], positions=None, cache=None, cache_pos=None, moe_ctx=None):
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
        moe_ctx = _for_batch(moe_ctx, batch)
        h = self.embed_batch(batch, positions, moe_ctx)
        h, aux = stack_apply(self.cfg, self.params["stack"], h, positions, cache, cache_pos, moe_ctx)
        return norm_apply(self.cfg, self.params["final_norm"], h), cache, aux

    def _chunk_stats(self, hh: torch.Tensor, yy: torch.Tensor, w: Optional[torch.Tensor] = None, tp=None):
        """(summed token loss, correct tokens) of a chunk; with ``tp`` the
        head is this rank's vocab block (``chunked_xent``)."""
        logits = self.lm_logits(hh, w=w)
        if tp is None:
            lse = torch.logsumexp(logits, dim=-1)
            gold = logits.gather(-1, yy[..., None])[..., 0]
            return (lse - gold).sum(), (logits.argmax(-1) == yy).sum()
        Vl = logits.shape[-1]
        v0 = tp.rank * Vl
        m, arg = logits.detach().max(-1)  # the first of equal maxima, as argmax
        M = all_reduce(m.clone(), tp.group, "max")
        lse = M + torch.log(reduce_from(torch.exp(logits - M[..., None]).sum(-1), tp.group))
        ids = yy - v0
        inside = (ids >= 0) & (ids < Vl)
        gold = logits.gather(-1, ids.clamp(0, Vl - 1)[..., None])[..., 0]
        gold = reduce_from(torch.where(inside, gold, torch.zeros((), dtype=gold.dtype, device=gold.device)),
                           tp.group)
        # argmax over the ranks: the lowest index among the ranks at the max
        top = all_reduce(torch.where(m == M, arg + v0, self.cfg.vocab), tp.group, "min")
        return (lse - gold).sum(), (top == yy).sum()

    def chunked_xent(self, h: torch.Tensor, labels: torch.Tensor, moe_ctx=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Cross-entropy over sequence chunks of ``cfg.loss_chunk``, so the
        (B, S, V) float32 logits never exist whole; under grad each chunk is
        rematerialised, so the backward recomputes its logits instead of
        keeping them (the reference's ``jax.checkpoint``).  Over a mesh the
        head is gathered once, before the chunks.  Returns (mean loss, token
        accuracy)."""
        n = labels.numel()
        labels = labels.long()
        w = self._head_weight(moe_ctx) if moe_ctx is not None and moe_ctx.params is not None else None
        tp = tp_of(moe_ctx)
        vocab_tp = None
        if tp is not None:
            if w.shape[-1] != self.cfg.vocab:  # the head split on vocab: every token, this rank's columns
                h, vocab_tp = tp.enter(h), tp
            else:  # the whole head on this rank's tokens (its chunk under SP)
                labels = tp.own(labels)
        B, S, D = h.shape
        c = min(self.cfg.loss_chunk, S)
        if S % c != 0:
            c = S
        tot = torch.zeros((), dtype=torch.float32, device=h.device)
        acc = torch.zeros((), dtype=torch.int64, device=h.device)
        grad = torch.is_grad_enabled() and (h.requires_grad or self._head_weight().requires_grad)
        for hh, yy in zip(h.split(c, dim=1), labels.split(c, dim=1)):
            if grad:
                l, a = checkpoint(self._chunk_stats, hh, yy, w, vocab_tp, use_reentrant=False,
                                  preserve_rng_state=False)
            else:
                l, a = self._chunk_stats(hh, yy, w, vocab_tp)
            tot = tot + l
            acc = acc + a
        if tp is not None and tp.sp and vocab_tp is None:  # the ranks' tokens summed
            tot, acc = reduce_from(tot, tp.group), all_reduce(acc, tp.group)
        return tot / n, acc.float() / n

    def loss(self, batch: Dict[str, torch.Tensor], moe_ctx=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        cfg = self.cfg
        moe_ctx = _for_batch(moe_ctx, batch)
        h, _, aux = self.forward_aux(batch, moe_ctx=moe_ctx)
        loss, acc = self.chunked_xent(h, batch["labels"], moe_ctx)
        metrics = {"xent": loss, "accuracy": acc}
        if cfg.is_moe:
            n_moe = sum(1 for d in group_layout(cfg) if d.moe) * n_groups(cfg)
            aux = cfg.moe_aux_weight * aux / max(n_moe, 1)
            metrics["moe_aux"] = aux
            loss = loss + aux
        metrics["loss"] = loss
        return loss, metrics

    def _last_logits(self, h: torch.Tensor, moe_ctx=None) -> torch.Tensor:
        """(B, V) logits of the last position of ``forward``'s hidden states
        (over ``model``: under SP the last rank's chunk holds it; a head
        split on vocab gives this rank's columns, gathered)."""
        tp = tp_of(moe_ctx)
        last = h[:, -1]
        if tp is not None and tp.sp:
            last = all_gather(h[:, -1:], 1, tp.group, tp.n)[:, -1]
        logits = self.lm_logits(last, moe_ctx)
        if tp is not None and logits.shape[-1] != self.cfg.vocab:
            logits = all_gather(logits, 1, tp.group, tp.n)
        return logits

    def prefill(self, batch: Dict[str, torch.Tensor], cache, moe_ctx=None):
        """Run the prompt filling ``cache`` from position 0.  Returns
        (last-token logits (B, V), cache)."""
        moe_ctx = _for_batch(moe_ctx, batch)
        h, cache = self.forward(batch, cache=cache, cache_pos=0, moe_ctx=moe_ctx)
        return self._last_logits(h, moe_ctx), cache

    def decode_step(self, cache, batch: Dict[str, torch.Tensor], pos, moe_ctx=None):
        """One decode step at ``pos`` (a scalar, or (B,) per-row positions).
        Returns (logits (B, V), cache)."""
        moe_ctx = _for_batch(moe_ctx, batch)
        h, cache = self.forward(batch, cache=cache, cache_pos=pos, moe_ctx=moe_ctx)
        return self._last_logits(h, moe_ctx), cache

    def init_cache(self, batch: int, max_seq: int):
        return init_cache(self.cfg, batch, max_seq, device=self.device)

    def param_counts(self) -> Dict[str, int]:
        return param_counts(self.cfg)


def _load(cfg: ArchConfig, template, params, device, path: str = "", cast=_cast_at_load):
    """``params`` (the template's tree of tensors or arrays) checked
    against the template's shapes and cast (``cast``) at load, on
    ``device``."""
    if isinstance(template, PSpec):
        t = torch.as_tensor(params)
        if tuple(t.shape) != template.shape:
            raise ValueError(f"parameter {path}: shape {tuple(t.shape)} != template {template.shape}")
        return cast(cfg, t.to(device), path)
    if isinstance(template, dict):
        return {k: _load(cfg, v, params[k], device, f"{path}/{k}", cast) for k, v in template.items()}
    if len(params) != len(template):
        raise ValueError(f"parameter list {path}: {len(params)} entries != template {len(template)}")
    return [_load(cfg, v, p, device, f"{path}/{i}", cast) for i, (v, p) in enumerate(zip(template, params))]


def build_model(cfg: ArchConfig, params: Optional[Dict[str, Any]] = None, *, seed: int = 0,
                device=None, train: bool = False, shardings: Optional[Dict[str, Any]] = None) -> Model:
    """A ``Model`` of ``cfg`` on ``device`` (CUDA unless the caller passes
    another; raises without it).  ``params`` is a tree in the port's layout
    (``models/convert.py`` makes one from the JAX package's); without it
    the weights are drawn by the JAX package's init rules from a
    ``torch.Generator`` seeded with ``seed``, on the device, each leaf cast
    as soon as it is drawn.  ``train`` builds the training form: fp32
    masters that require grad, never cast (module docstring).  On the
    ``meta`` device nothing is drawn: the model is a structure for
    ``loss_of`` and ``value_and_grad``, whose parameters the caller
    passes.

    ``shardings`` ({name: ``launch.sharding.NamedSharding``}, the flat
    dict's names) keeps only this rank's block of each leaf: each leaf is
    drawn (or loaded) whole, cast, cut and freed before the next, so the
    blocks are the one-device model's, bit for bit, and no rank holds more
    than one whole leaf at a time."""
    template = model_template(cfg)
    dev = resolve_device(device)
    rule = _master if train else _cast_at_load
    if shardings is not None and dev.type != "meta":
        from ..launch.sharding import shard

        whole = rule
        rule = lambda cfg, t, path: shard(whole(cfg, t, path), shardings[path.lstrip("/").replace("/", ".")]).clone()
    if dev.type == "meta":
        params = map_template(template, lambda s, path: rule(cfg, torch.empty(s.shape, dtype=cfg.param_dtype,
                                                                               device=dev), path))
    elif params is None:
        gen = torch.Generator(device=dev).manual_seed(seed)
        params = map_template(template, lambda s, path: rule(cfg, init_tensor(s, gen, cfg.param_dtype, dev), path))
    else:
        params = _load(cfg, template, params, dev, cast=rule)
    return Model(cfg, params, train=train)
