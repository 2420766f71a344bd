"""Deterministic synthetic LM data pipeline (the JAX package's
``data/pipeline.py``).

The stream has *learnable structure* (a fixed random bigram transition
table blended with noise) so end-to-end training drivers show a real,
monotonically falling loss instead of log(V) forever.  Determinism: batch
``i`` of a given (seed, config) is a pure function of (seed, i), so a
restart needs only the batch index.  ``DataConfig`` and
``SyntheticLMDataset`` are the reference's numpy code, copied, so batches
are bit-identical to the JAX package's.

``sharded_batches`` yields the batches as tensors on one device, or, with
the plan's batch shardings, as ``DTensor``s of which each rank builds only
its own rows (``SyntheticLMDataset.batch(i, rows)``: the same draws, the
token chain run for those rows only), bit for bit the rows of the
reference's ``make_global_array`` shard.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..core.data import host_to_device, resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    branching: int = 4  # bigram successors per token (lower = easier)
    noise: float = 0.05  # fraction of uniform-random tokens


class SyntheticLMDataset:
    """Deterministic bigram-structured token stream."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        # fixed transition table: token t -> branching successors
        self.table = rng.integers(
            0, cfg.vocab, size=(cfg.vocab, cfg.branching), dtype=np.int64
        )

    def batch(self, index: int, rows: slice = slice(None)) -> Dict[str, np.ndarray]:
        """Batch ``index`` (pure function of (seed, index)); ``rows`` of it
        only, from the whole batch's draws."""
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, index))
        B, S = cfg.global_batch, cfg.seq_len
        first = rng.integers(0, cfg.vocab, size=B)[rows]
        branch = rng.integers(0, cfg.branching, size=(B, S))[rows]
        noise = (rng.random((B, S)) < cfg.noise)[rows]
        noise_tok = rng.integers(0, cfg.vocab, size=(B, S))[rows]
        toks = np.empty((first.shape[0], S + 1), dtype=np.int64)
        toks[:, 0] = first
        for s in range(S):
            nxt = self.table[toks[:, s], branch[:, s]]
            toks[:, s + 1] = np.where(noise[:, s], noise_tok[:, s], nxt)
        return {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
        }

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        i = 0
        while True:
            yield self.batch(i)
            i += 1


def _stub_projection(ds: SyntheticLMDataset, d_model: int) -> np.ndarray:
    """The stub frontend's (vocab, D) token-to-embedding table, the
    reference's draw: ``default_rng((seed, 7, 0))``, scaled by 1/sqrt(D)."""
    rng = np.random.default_rng((ds.cfg.seed, 7, 0))
    proj = rng.standard_normal((ds.cfg.vocab, d_model)).astype(np.float32)
    proj /= np.sqrt(d_model)
    return proj


def sharded_batches(
    ds: SyntheticLMDataset,
    device=None,
    start_index: int = 0,
    embeds_cfg: Optional[ArchConfig] = None,
    shardings: Optional[Dict[str, Any]] = None,
) -> Iterator[Dict[str, torch.Tensor]]:
    """Yield batches on ``device`` (CUDA unless the caller names another)
    starting at ``start_index`` (restart-safe), staged through pinned
    memory on the way to the card.

    ``shardings`` (the plan's batch ``NamedSharding``s by key, e.g.
    ``plan.in_shardings[2]``): each rank builds only its own rows and
    yields ``DTensor``s of the global batch (plain tensors on a one-device
    mesh).

    For stub-frontend archs (``embeds_cfg.frontend`` set), tokens are mapped
    to the reference's deterministic synthetic embeddings on the host (the
    stub frontend), in ``embeds_cfg.compute_dtype``.
    """
    dev = resolve_device(device)
    proj = None
    if embeds_cfg is not None and embeds_cfg.frontend:
        proj = torch.from_numpy(_stub_projection(ds, embeds_cfg.d_model))
    return _batches(ds, dev, start_index, embeds_cfg, proj, shardings)


def batch_rows(shardings: Optional[Dict[str, Any]], batch: int) -> slice:
    """This rank's rows of the batch under ``shardings`` (all of them
    without)."""
    if not shardings:
        return slice(None)
    from ..launch import sharding as sh

    s = next(iter(shardings.values()))
    idx = sh.shard(torch.arange(batch), sh.NamedSharding(s.mesh, sh.P(s.spec[0] if s.spec else None)))
    return slice(int(idx[0]), int(idx[-1]) + 1)


def _batches(ds, dev, i, embeds_cfg, proj, shardings):
    B, S = ds.cfg.global_batch, ds.cfg.seq_len
    rows = batch_rows(shardings, B)
    while True:
        host = ds.batch(i, rows)
        out: Dict[str, torch.Tensor] = {}
        if proj is not None:
            emb = proj[torch.from_numpy(host["tokens"]).long()]
            out["embeds"] = host_to_device(emb, dev, embeds_cfg.compute_dtype)
        else:
            out["tokens"] = host_to_device(torch.from_numpy(host["tokens"]), dev)
        out["labels"] = host_to_device(torch.from_numpy(host["labels"]), dev)
        if shardings:
            from ..launch import sharding as sh

            out = {k: sh.place(v, shardings[k], (B, S) + tuple(v.shape[2:])) for k, v in out.items()}
        yield out
        i += 1
