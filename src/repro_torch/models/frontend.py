"""Modality frontends (the JAX package's ``models/frontend.py``).

``[audio]`` / ``[vlm]`` architectures specify the transformer backbone
only; their frontend is a stub that delivers precomputed (B, S, d_model)
frame/patch embeddings, passed as ``{"embeds": ...}``.  This module holds
that contract and the deterministic synthetic embedders that tests and
example programs feed the backbone with:

  musicgen-large : EnCodec frame embeddings (the summed (B, S, d_model)
                   embedding of a 50 Hz frame's four codebooks);
  pixtral-12b    : Pixtral-ViT patch embeddings interleaved with text
                   embeddings, fused to (B, S, d_model).

The JAX package draws its embeddings and fixed projections from
``jax.random``, which torch cannot reproduce.  The port draws them from a
``torch.Generator`` seeded the same way, on the device, and every function
also takes the array as an argument, so a caller (the tests) can pass the
JAX package's arrays and compute the same function (``DESIGN.md``).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from ..configs.base import ArchConfig


def uses_stub_frontend(cfg: ArchConfig) -> bool:
    return cfg.frontend in ("audio", "vision")


def embed_input_shape(cfg: ArchConfig, batch: int, seq: int) -> Tuple[int, int, int]:
    return (batch, seq, cfg.d_model)


def _normal(shape, seed: int, device) -> torch.Tensor:
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, generator=gen, dtype=torch.float32, device=device)


def synth_embeddings(cfg: ArchConfig, seed: int, batch: int, seq: int, device,
                     x: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Deterministic synthetic frame/patch embeddings: N(0, 1) / sqrt(d_model)
    in the compute dtype.  ``x``, a (batch, seq, d_model) standard normal
    draw, replaces the seeded one."""
    if x is None:
        x = _normal((batch, seq, cfg.d_model), seed, device)
    return (torch.as_tensor(x, device=device).float() / math.sqrt(cfg.d_model)).to(cfg.compute_dtype)


def synth_frames_from_audio(cfg: ArchConfig, audio: torch.Tensor, frame: int = 320,
                            proj: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A stand-in EnCodec encoder: a strided frame fold and a fixed
    projection.  audio (B, T) -> (B, T // frame, d_model).  ``proj``, the
    (frame, d_model) standard normal projection, defaults to a draw seeded
    0 (the reference's ``PRNGKey(0)``)."""
    B, T = audio.shape
    S = T // frame
    x = audio[:, : S * frame].reshape(B, S, frame).float()
    k = _normal((frame, cfg.d_model), 0, audio.device) if proj is None else torch.as_tensor(proj, device=audio.device)
    return (x @ (k.float() / math.sqrt(frame))).to(cfg.compute_dtype)


def synth_patches_from_image(cfg: ArchConfig, images: torch.Tensor, patch: int = 16,
                             proj: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A stand-in ViT stem: patchify and a fixed projection.
    images (B, H, W, C) -> (B, (H // patch) * (W // patch), d_model).
    ``proj``, the (patch * patch * C, d_model) standard normal projection,
    defaults to a draw seeded 1 (the reference's ``PRNGKey(1)``)."""
    B, H, W, C = images.shape
    ph, pw = H // patch, W // patch
    x = images[:, : ph * patch, : pw * patch]
    x = x.reshape(B, ph, patch, pw, patch, C).permute(0, 1, 3, 2, 4, 5)
    x = x.reshape(B, ph * pw, patch * patch * C).float()
    n = patch * patch * C
    k = _normal((n, cfg.d_model), 1, images.device) if proj is None else torch.as_tensor(proj, device=images.device)
    return (x @ (k.float() / math.sqrt(n))).to(cfg.compute_dtype)


def stub_token_table(cfg: ArchConfig, device, table: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The (vocab, d_model) fp32 table through which a stub-frontend model
    decodes its sampled token ids: N(0, 1) / sqrt(d_model), drawn seeded 7
    (the reference's ``PRNGKey(7)``).  ``table``, a standard normal draw of
    that shape, replaces the seeded one."""
    if table is None:
        table = _normal((cfg.vocab, cfg.d_model), 7, device)
    return torch.as_tensor(table, device=device).float() / math.sqrt(cfg.d_model)
