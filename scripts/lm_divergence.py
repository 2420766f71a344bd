#!/usr/bin/env python3
"""Flash vs plain attention in starcoder2-7b at full width, layer by layer.

    python3 scripts/lm_divergence.py      # on a machine with one H100

Builds the port's model at its published widths (32 layers, seeded random
weights) in bf16 and then in float32, embeds 4096 random tokens, and walks
the layers three ways: with the flash kernel (``use_pallas=True``), with
the plain attention on the SAME input as the flash layer (teacher-forced),
and with the plain attention on its own previous output (free-running).
Prints, per layer, the relative L2 error of the teacher-forced and of the
free-running output against the flash one, how many positions exceed
2e-2 and the largest per-position error, and at a few layers the
statistics of q, k and the attention scores of the last 256 queries
(standard deviation, top-1 minus top-2 gap).  It shows why
``chip_smoke.py`` checks the LM forward teacher-forced.
"""
import dataclasses
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.attention import _qkv, attention_apply  # noqa: E402
from repro_torch.models.layers import norm_apply  # noqa: E402
from repro_torch.models.transformer import _layer_apply, group_layout  # noqa: E402

if not torch.cuda.is_available():
    sys.exit("lm_divergence: no CUDA device; this script runs on the card only")
_build.build(["flash_attention"])
S = 4096


def rel(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def per_pos(a, b, tol=2e-2):
    """Positions whose relative L2 error exceeds ``tol``, and the largest."""
    e = (a.float() - b.float()).norm(dim=-1) / b.float().norm(dim=-1)
    return f"{int((e > tol).sum())}, max {e.max().item():.3e}"


for dtype in (torch.bfloat16, torch.float32):
    cfg = dataclasses.replace(get_arch("starcoder2-7b"), compute_dtype=dtype, cache_dtype=dtype)
    ck, cp = dataclasses.replace(cfg, use_pallas=True), dataclasses.replace(cfg, use_pallas=False)
    torch.cuda.empty_cache()
    model = build_model(ck, seed=0)
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (1, S))).cuda()
    pos = torch.arange(S, device="cuda")[None]
    layout = group_layout(cfg)
    x = model.embed_batch({"tokens": toks}, pos)
    xk = xp = x
    print(f"== {dtype}", flush=True)
    for g, pg in enumerate(model.params["stack"]["groups"]):
        p = pg["layers"][0]
        if g < 2 or g % 8 == 0 or g == 31:
            h = norm_apply(cfg, p["ln1"], xk)
            q, k, v = _qkv(cfg, p["attn"], h, pos.expand(1, S), 0)
            s = torch.einsum("qd,kd->qk", q[0, -256:, 0].float(), k[0, :, 0].float()) * 128 ** -0.5
            s = s.masked_fill(torch.arange(S, device="cuda")[None] > torch.arange(S - 256, S, device="cuda")[:, None], -1e30)
            top = s.topk(2, dim=-1).values
            ak, _ = attention_apply(ck, p["attn"], h, pos, 0)
            ap, _ = attention_apply(cp, p["attn"], h, pos, 0)
            print(f"layer {g}: |q| std {q.float().std():.2f} |k| std {k.float().std():.2f} |x| std {xk.float().std():.2f} "
                  f"score std {s[s > -1e29].std():.1f} top1-top2 gap median {(top[:, 0] - top[:, 1]).median():.3f} "
                  f"min {(top[:, 0] - top[:, 1]).min():.4f}; attn out teacher-forced rel {rel(ak, ap):.3e} "
                  f"positions>2e-2 {per_pos(ak, ap)} max_abs {(ak.float() - ap.float()).abs().max():.3e}", flush=True)
        yk = _layer_apply(ck, layout[0], p, xk, pos, None, None)
        yt = _layer_apply(cp, layout[0], p, xk, pos, None, None)
        yp = _layer_apply(cp, layout[0], p, xp, pos, None, None)
        print(f"layer {g}: teacher-forced rel {rel(yk, yt):.3e} (positions>2e-2 {per_pos(yk, yt)}); free-running rel "
              f"{rel(yk, yp):.3e} (positions>2e-2 {per_pos(yk, yp)})", flush=True)
        xk, xp = yk, yp
    hk = norm_apply(cfg, model.params["final_norm"], xk)
    hp = norm_apply(cfg, model.params["final_norm"], xp)
    lk, lp = model.lm_logits(hk[:, -1]), model.lm_logits(hp[:, -1])
    print(f"final: hidden rel {rel(hk[:, -128:], hp[:, -128:]):.3e} logits rel {rel(lk, lp):.3e} top1 {bool(lk.argmax() == lp.argmax())}", flush=True)
    del model, x, xk, xp, yk, yt, yp
print("diag done")
