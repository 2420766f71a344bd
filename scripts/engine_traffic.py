#!/usr/bin/env python3
"""ServeEngine on a stream of mostly new prompt lengths, at starcoder2-7b's
published widths.

    python3 scripts/engine_traffic.py      # on a machine with one H100

Builds the port's model (32 layers, seeded random weights, bf16) and
measures three things, printing each and writing them all to
``chiprun_out/engine_traffic.json``:

1. The stream: REQUESTS requests of NEW new tokens over 4 slots
   (max_seq 2048), prompt lengths drawn as ``chip_smoke.py``'s phase 6d
   draws them (uniform over 64..1024), so nearly every length is new,
   through three engines in turn on the same prompts: the engine as it
   ships (decode and scatter captured, the prefill eager), the same engine
   with each prompt length's prefill captured too (a ``CapturedCall`` a
   length in its own pool: the JAX engine's compile per ``pad_len``), and
   the plain programs, all eager.  For each: wall s, tokens/s, TTFT
   (every request is submitted at the start, so a later request's TTFT
   holds its wait for a slot), each admission's synchronized prefill ms,
   the decode-only step ms, and the device memory reserved after it.
2. Break-even: at prompt lengths 64, 256, 512 and 1024, the eager
   prefill's ms (median of 5), a ``CapturedCall``'s first call (warm-up
   and capture) and its replays (median of 5), held equal to the eager
   logits bit for bit; and the repeats a length needs before its capture
   pays back, n = (first - eager) / (eager - replay), rounded up.
3. Memory: MEMORY_REQUESTS requests of distinct prompt lengths, 2 new
   tokens each, through the shipped engine: the device memory reserved and
   allocated after every fiftieth.
"""
import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core.executors.captured import CapturedCall  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving import EngineConfig, Request, ServeEngine  # noqa: E402

ENGINE = {"slots": 4, "max_seq": 2048}
REQUESTS, NEW, PROMPTS = 32, 32, (64, 1024)
BREAK_EVEN_LENGTHS = (64, 256, 512, 1024)
MEMORY_REQUESTS = 300


class PrefillCaptured(ServeEngine):
    """The engine with its prefill captured too: one ``CapturedCall`` a
    prompt length, each in its own pool, as ``jax.jit`` compiles one
    program a ``pad_len``."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.calls = {}

    def _prefill_fn(self, one, prompt):
        S = prompt.shape[1]
        if S not in self.calls:
            self.calls[S] = CapturedCall(super()._prefill_fn, f"ServeEngine prefill S={S}", donate=(True,))
        return self.calls[S](one, prompt)


class Eager(ServeEngine):
    """The plain programs, every one eager."""

    def _compiled(self, fn, name, donate, generators=()):
        return fn


def synced_ms(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out


def run_stream(eng, prompts, new):
    """Submit one request a prompt and step until drained: the numbers of
    the pass, each admission's prefill ms among them."""
    prefill_ms = []
    plain = eng._prefill_fn

    def timed(one, prompt):
        ms, out = synced_ms(lambda: plain(one, prompt))
        prefill_ms.append((prompt.shape[1], ms))
        return out

    eng._prefill_fn = timed
    reqs = [Request(rid=i, prompt=p, max_new_tokens=new) for i, p in enumerate(prompts)]
    torch.cuda.synchronize()
    t_start = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    decode_ms = []
    while eng.queue or any(r is not None for r in eng.slot_req):
        queued = len(eng.queue)
        t0 = time.perf_counter()
        eng.step()
        if len(eng.queue) == queued:
            decode_ms.append((time.perf_counter() - t0) * 1e3)
    wall = time.perf_counter() - t_start
    del eng._prefill_fn
    ttft = [(r.t_first - r.t_submit) * 1e3 for r in reqs]
    n_tok = sum(len(r.out_tokens) for r in reqs)
    return dict(wall_s=wall, tokens_per_s=n_tok / wall, tokens=[r.out_tokens for r in reqs],
                ttft_ms=dict(mean=float(np.mean(ttft)), median=float(np.median(ttft)),
                             p90=float(np.percentile(ttft, 90)), max=float(np.max(ttft))),
                prefill_ms=prefill_ms, prefill_ms_sum=float(sum(ms for _, ms in prefill_ms)),
                decode_ms=dict(mean=float(np.mean(decode_ms)), median=float(np.median(decode_ms)),
                               steps=len(decode_ms)),
                decode_steps=eng.decode_steps, stats=None if isinstance(eng, Eager) else eng.stats,
                reserved=torch.cuda.memory_reserved())


def break_even(eng, rng, S):
    prompt = torch.from_numpy(rng.integers(0, eng.cfg.vocab, (1, S))).cuda()
    call = CapturedCall(eng._prefill_fn, f"ServeEngine prefill S={S}", donate=(True,))
    first_ms, _ = synced_ms(lambda: call(eng._one, prompt))
    replays = [synced_ms(lambda: call(eng._one, prompt)) for _ in range(5)]
    eager = [synced_ms(lambda: eng._prefill_fn(eng._one, prompt)) for _ in range(6)][1:]
    same = all(torch.equal(r[1], e[1]) for r, e in zip(replays, eager))
    pool = call.pool_bytes
    call.release()
    del call
    eager_ms, replay_ms = float(np.median([e[0] for e in eager])), float(np.median([r[0] for r in replays]))
    gain = eager_ms - replay_ms
    n = math.ceil((first_ms - eager_ms) / gain) if gain > 0 else None
    return dict(S=S, eager_ms=eager_ms, first_ms=first_ms, replay_ms=replay_ms, pool_bytes=pool,
                replay_equals_eager=same, repeats_to_break_even=n)


def main() -> int:
    if not torch.cuda.is_available():
        sys.exit("engine_traffic: no CUDA device; this script runs on the card only")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card)
    cfg = dataclasses.replace(get_arch("starcoder2-7b"), use_pallas=True)
    model = build_model(cfg, seed=0)
    rng = np.random.default_rng(0)
    lengths = rng.integers(PROMPTS[0], PROMPTS[1] + 1, REQUESTS)
    prompts = [rng.integers(0, cfg.vocab, int(n)) for n in lengths]
    out = {"card": card, "lengths": [int(n) for n in lengths], "distinct": len(set(lengths.tolist()))}
    print(f"stream: {REQUESTS} requests of {NEW} new tokens, {out['distinct']} distinct prompt lengths "
          f"{sorted(out['lengths'])}, slots {ENGINE['slots']}, max_seq {ENGINE['max_seq']}")

    run_stream(Eager(cfg, model, EngineConfig(**ENGINE)), prompts[:4], 4)  # loads the libraries
    runs = {}
    for name, kind in (("shipped", ServeEngine), ("prefill_captured", PrefillCaptured), ("eager", Eager)):
        torch.cuda.empty_cache()
        eng = kind(cfg, model, EngineConfig(**ENGINE))
        runs[name] = run_stream(eng, prompts, NEW)
        if isinstance(eng, PrefillCaptured):
            runs[name]["prefill_pool_bytes"] = sum(c.pool_bytes for c in eng.calls.values())
            runs[name]["prefill_compiles"] = sum(c.compiles for c in eng.calls.values())
            for c in eng.calls.values():
                c.release()
        if not isinstance(eng, Eager):
            eng.release()
        del eng
        r = runs[name]
        print(f"{name}: wall_s={r['wall_s']:.3f} tokens_per_s={r['tokens_per_s']:.2f} TTFT ms {r['ttft_ms']} "
              f"prefill ms sum={r['prefill_ms_sum']:.1f} each {[round(ms, 1) for _, ms in r['prefill_ms']]} "
              f"decode-only step ms {r['decode_ms']} decode_steps={r['decode_steps']} stats={r['stats']} "
              f"reserved={r['reserved']} prefill pools={r.get('prefill_pool_bytes')}")
    same = runs["shipped"]["tokens"] == runs["prefill_captured"]["tokens"] == runs["eager"]["tokens"]
    print(f"tokens of the three engines equal: {same}")
    for r in runs.values():
        del r["tokens"]
    out["stream"], out["tokens_equal"] = runs, same

    torch.cuda.empty_cache()
    eng = ServeEngine(cfg, model, EngineConfig(**ENGINE))
    out["break_even"] = [break_even(eng, rng, S) for S in BREAK_EVEN_LENGTHS]
    for b in out["break_even"]:
        print(f"break-even S={b['S']}: eager {b['eager_ms']:.2f} ms, captured first call {b['first_ms']:.2f}, "
              f"replay {b['replay_ms']:.2f}, pool {b['pool_bytes']} bytes, replay = eager bit for bit "
              f"{b['replay_equals_eager']}, repeats to break even {b['repeats_to_break_even']}")

    mem_lengths = rng.choice(np.arange(PROMPTS[0], PROMPTS[1] + 1), MEMORY_REQUESTS, replace=False)
    memory = [dict(done=0, reserved=torch.cuda.memory_reserved(), allocated=torch.cuda.memory_allocated())]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for i, n in enumerate(mem_lengths):
        eng.submit(Request(rid=i, prompt=rng.integers(0, cfg.vocab, int(n)), max_new_tokens=2))
    while eng.queue or any(r is not None for r in eng.slot_req):
        eng.step()
        done = sum(r.done for r in eng.requests)
        if done >= memory[-1]["done"] + 50:
            memory.append(dict(done=done, reserved=torch.cuda.memory_reserved(),
                               allocated=torch.cuda.memory_allocated()))
    if memory[-1]["done"] != MEMORY_REQUESTS:
        memory.append(dict(done=MEMORY_REQUESTS, reserved=torch.cuda.memory_reserved(),
                           allocated=torch.cuda.memory_allocated()))
    out["memory"] = dict(lengths=MEMORY_REQUESTS, wall_s=time.perf_counter() - t0, points=memory,
                         max_reserved=torch.cuda.max_memory_reserved(), stats=eng.stats)
    print(f"memory: {MEMORY_REQUESTS} distinct prompt lengths through the shipped engine in "
          f"{out['memory']['wall_s']:.1f} s: (requests done, reserved, allocated) "
          f"{[(m['done'], m['reserved'], m['allocated']) for m in memory]}; stats {eng.stats}")
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "engine_traffic.json").write_text(json.dumps(out, indent=1))
    return 0 if same and all(b["replay_equals_eager"] for b in out["break_even"]) else 1


if __name__ == "__main__":
    sys.exit(main())
