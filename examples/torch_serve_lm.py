"""Batched serving with the PyTorch port: continuous batching over a slot
pool (the counterpart of ``examples/serve_lm.py``).

The architecture's reduced configuration, weights drawn from a seeded
``torch.Generator``; a stub-frontend architecture (``musicgen-large``,
``pixtral-12b``) takes integer-valued frame embeddings as prompts.  The
last line gives the engine's programs' compiles and graph replays: on the
card the decode and each slot's scatter are captured into a CUDA graph on
their first call and replayed after, and the prefill runs eagerly, once a
request; on the CPU every call runs eagerly, with the same compiles and no
replays.

    PYTHONPATH=src python examples/torch_serve_lm.py --arch starcoder2-7b --requests 8           # on the card
    PYTHONPATH=src python examples/torch_serve_lm.py --requests 4 --new-tokens 4 --device cpu
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

import numpy as np


def prompts(cfg, n: int, seed: int = 0):
    """Request i's prompt: 6 + i % 5 tokens (or integer-valued frame
    embeddings for a stub frontend), numpy-seeded."""
    rng = np.random.default_rng(seed)
    if cfg.frontend:
        return [rng.integers(-1, 2, size=(6 + i % 5, cfg.d_model)).astype(np.float32) for i in range(n)]
    return [rng.integers(0, cfg.vocab, size=6 + i % 5) for i in range(n)]


def main(argv=None) -> dict:
    """Returns the printed lines, every request's tokens and the engine's
    decode steps."""
    from repro_torch.configs import get_arch
    from repro_torch.core import resolve_device
    from repro_torch.models import build_model
    from repro_torch.serving import EngineConfig, Request, ServeEngine

    ap = argparse.ArgumentParser(prog="torch_serve_lm.py")
    ap.add_argument("--arch", default="starcoder2-7b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--new-tokens", type=int, default=12)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_arch(args.arch).reduced()
    model = build_model(cfg, seed=0, device=dev)
    eng = ServeEngine(cfg, model, EngineConfig(slots=args.slots, max_seq=128, temperature=args.temperature),
                      device=dev)
    t0 = time.time()
    for i, p in enumerate(prompts(cfg, args.requests)):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=args.new_tokens))
    done = eng.run_until_drained()
    dt = time.time() - t0
    n_tok = sum(len(r.out_tokens) for r in done)
    lines = [f"req {r.rid}: prompt[{len(r.prompt)}] -> {r.out_tokens}" for r in done[:4]]
    ttft = np.mean([r.t_first - r.t_submit for r in done])
    lines.append(f"{len(done)} requests, {n_tok} tokens in {dt:.2f}s ({n_tok / dt:.1f} tok/s, {args.slots} slots, "
                 f"{eng.decode_steps} batched decode steps, mean TTFT {ttft * 1e3:.0f}ms, {dev.type})")
    stats = eng.stats
    lines.append("programs: " + ", ".join(f"{k} compiles={v['compiles']} graph_replays={v['graph_replays']}"
                                          for k, v in stats.items())
                 + f", prefill eager_calls={stats['prefill']['eager_calls']}")
    for line in lines:
        print(line)
    return {"lines": lines, "tokens": {r.rid: list(r.out_tokens) for r in done}, "decode_steps": eng.decode_steps,
            "stats": stats}


if __name__ == "__main__":
    main()
