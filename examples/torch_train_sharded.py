"""Sharded LM training with the PyTorch port over a ``torch.distributed``
mesh (the launch layer: ``launch/sharding.py``, ``launch/steps.py``).

Each rank holds its blocks of the fp32 masters and AdamW moments, as the
resolver places them on the mesh (FSDP over ``data``, storage over
``model``), builds only its own rows of the deterministic batch, gathers
each layer group's bf16 weights whole where the group runs (again in the
rematerialised backward) and reduce-scatters their gradients.

Three parts, each on the same seeded init:

(a) one step of the model (``--layers``, default 2, rounded up to whole
    layer groups: zamba2 takes 6) on the mesh,
    then, on rank 0 alone, the same step on one device from the same seed
    and batch: the loss within ``LOSS_TOL`` (relative), the gradient norm
    within ``GNORM_TOL``, every leaf's gradient within ``GRAD_TOL``
    relative L2 and every leaf's update (the step's change of the
    parameter) within ``UPDATE_TOL``.  The gradient is read from Adam's
    first moment after the first step, (1 - b1) g in fp32 from zero
    moments: the same scaling on both sides, before Adam divides it by its
    size (at step 1 the update is lr g / (|g| + eps), which a wrong scale
    of a leaf's gradient does not move).  The sharded step sums bf16
    gradient blocks over the ranks where one device sums them in one
    product, so the updates of elements whose gradient is within rounding
    of zero move apart;
(b) that state saved (every rank gathers, rank 0 writes the unsharded
    layout) and restored onto a (world / 2, 2) mesh: every leaf bit for
    bit the saved one;
(c) ``--steps`` steps of the model at ``--train-layers`` (default: all of
    the configuration's) on the mesh, no checkpoint: per-card peak memory,
    the first step's ms (each rank's warm-up, whose result is the step's,
    then the capture of the whole step into one CUDA graph with its
    collectives) and the median replay's, tokens/s, MFU (``model_flops``
    / step / (world x 989 TFLOP/s)), each rank's ``compiles`` and
    ``graph_replays`` (1 and steps - 1 on the cards, else the example
    fails; with ``--check-capture`` one more) and the loss.  With
    ``--check-capture`` the seeded state is put back after the first call and the first step replayed (one more
    replay), then run eagerly (``plan.fn``) from the same state on the
    same batch: every rank's parameter blocks, the loss and the grad norm
    within ``CAPTURE_TOL``, the collectives the capture recorded counted
    by operator equal to those the eager step called (reduce-scatters of
    the backward among them), and the loss falling (every step on the
    first batch again, the mean of the last half of the steps below the
    first half's: on fresh random batches the spread between batches,
    about 0.01 at starcoder2-7b's widths, outweighs a few steps' fall);
(d) with ``--decode N``: the serving plans on the mesh, the serving form
    of the whole model: a prefill into a cache (``DECODE_SHAPE``: phase
    9b's on the card; its seq dim split over ``model``), called twice (the
    first call captures each rank's program, collectives inside, into a
    CUDA graph; the second, on the cache zeroed again, replays it, and its
    logits are those checked),
    then N greedy decode steps: on the cards one capture and N - 1 graph
    replays a rank (each rank's ``compiles`` and ``graph_replays``), the
    first step's ms and the median of the replays'; then the same
    at ``--layers`` (2 when 0) in float32, and on rank 0 alone those steps
    on one device fed the same tokens: each step's logits within
    ``DECODE_TOL`` relative L2.

``--mesh D,M`` lays the ranks out as (data, model), (world, 1) by default;
over ``model`` the blocks compute as they lie (``models/spmd.py``), and
the sums over ``model`` round in another order than one device's
products.  The random model amplifies a rounding difference about 100
times a layer at published widths (``scripts/tp_divergence.py``: one
device's own bf16 prefill differs from its float32 one by 0.15 relative
L2 after one layer, 0.49 after two),
so where ``model`` > 1 (a) runs in float32, and (d)'s check always does:
there the ranks' arithmetic agrees with one device's to rounding.  ``scripts/tp_divergence.py`` holds the bf16 step over
``model`` against one device's float32 step instead.

    PYTHONPATH=src python examples/torch_train_sharded.py            # 2 CPU ranks, gloo, reduced starcoder2-7b
    torchrun --standalone --nproc-per-node 4 examples/torch_train_sharded.py --cuda
    torchrun --standalone --nproc-per-node 4 examples/torch_train_sharded.py --cuda --mesh 1,4
    torchrun --standalone --nproc-per-node 4 examples/torch_train_sharded.py --cuda --layers 0   # (c) alone
    torchrun --standalone --nproc-per-node 4 examples/torch_train_sharded.py --cuda --mesh 1,4 --layers 0 \
        --steps 0 --decode 16                                                                    # (d) alone
    torchrun --standalone --nproc-per-node 4 examples/torch_train_sharded.py --cuda --arch zamba2-2.7b \
        --mesh 1,4 --layers 0 --steps 4 --decode 16                                             # (c), (d)
    torchrun --standalone --nproc-per-node 4 examples/torch_train_sharded.py --cuda --arch rwkv6-3b \
        --mesh 1,4 --steps 3 --decode 16                                                         # (a)-(d)
"""

import argparse
import dataclasses
import os
import statistics
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

# relative; GRAD_TOL and UPDATE_TOL are relative L2 a leaf (their sound and
# faulty readings: PERF.md, the four-card run)
LOSS_TOL, GNORM_TOL, GRAD_TOL, UPDATE_TOL = 1e-3, 1e-5, 5e-2, 5e-2
DECODE_TOL = 2e-2  # (d): relative L2 of each step's float32 logits, sharded against one device
# (d): prompt tokens a row and the cache's length, as chip_smoke.py's phase 9b on the card
DECODE_SHAPE = {"cuda": (64, 2048), "cpu": (8, 32)}
H100_BF16_FLOPS = 989e12  # dense bf16 tensor-core peak of one H100 SXM


def _cfg(args):
    from repro_torch.configs import get_arch

    cfg = get_arch(args.arch)
    return cfg if args.cuda else cfg.reduced()


def _depth(cfg, n: int) -> int:
    """``n`` layers rounded up to whole layer groups (zamba2's group is six
    Mamba2 layers and its shared block)."""
    from repro_torch.models.transformer import group_layout

    g = len(group_layout(cfg))
    return -(-n // g) * g


def _state(cfg, plan, opt_cfg, device):
    from repro_torch.launch import steps as st
    from repro_torch.models import build_model

    shardings = plan.in_shardings[0] if plan.in_shardings is not None and plan.mesh.size() > 1 else None
    blocks = build_model(cfg, seed=0, device=device, train=True, shardings=shardings).train_params()
    return st.train_state(plan, blocks, opt_cfg)


def _batch(cfg, shape, plan, device):
    from repro_torch.data.pipeline import DataConfig, SyntheticLMDataset, sharded_batches

    ds = SyntheticLMDataset(DataConfig(vocab=cfg.vocab, seq_len=shape.seq_len, global_batch=shape.global_batch))
    split = plan.mesh is not None and plan.mesh.size() > 1
    return sharded_batches(ds, device, embeds_cfg=cfg, shardings=plan.in_shardings[2] if split else None)


def _whole(x):
    from torch.distributed.tensor import DTensor

    return x.full_tensor() if isinstance(x, DTensor) else x


def _on_rank0(tree, rank):
    """Every leaf gathered whole (all ranks take part), kept on rank 0's host."""
    out = {}
    for k, v in tree.items():
        w = _whole(v)
        if rank == 0:
            out[k] = w.detach().to("cpu", copy=True)
    return out


def _rel(a, b) -> float:
    return (a.double() - b.double()).norm().item() / max(b.double().norm().item(), 1e-30)


def _all_raise(verdict) -> None:
    """Rank 0's verdict ([None] or [message]) on every rank, raised on every
    rank together (a check on rank 0 alone would leave the others waiting)."""
    dist.broadcast_object_list(verdict)
    if verdict[0] is not None:
        raise AssertionError(verdict[0])


def _say(rank, *parts):
    if rank == 0:
        print(*parts, flush=True)


def part_a_b(args, rank, world, device, device_type, mesh, work):
    from repro_torch import optim
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import steps as st
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.train import Checkpointer

    cfg = dataclasses.replace(_cfg(args), n_layers=_depth(_cfg(args), args.layers))
    if mesh.shape[-1] > 1:  # the (data, model) mesh's model axis: float32 (``--mesh``, below)
        cfg = dataclasses.replace(cfg, compute_dtype=torch.float32, cache_dtype=torch.float32)
    shape = ShapeConfig("train", args.seq, args.batch, "train")
    opt_cfg = optim.AdamWConfig(lr=3e-4, clip_norm=0.0, state_dtype=cfg.optim_state_dtype)
    plan = st.make_train_step(cfg, mesh, shape, opt_cfg, device=device)
    p, o = _state(cfg, plan, opt_cfg, device)
    init = _on_rank0(p, rank)
    batch = next(_batch(cfg, shape, plan, device))
    t0 = time.perf_counter()
    _, _, met = plan.jitted()(p, o, batch)
    loss, gnorm = float(met["loss"]), float(met["grad_norm"])
    step_s = time.perf_counter() - t0
    after = _on_rank0(p, rank)
    moment = _on_rank0(o["m"], rank)
    _say(rank, f"(a) {cfg.name} {cfg.n_layers} layers, B={shape.global_batch} S={shape.seq_len}, mesh "
               f"{tuple(mesh.shape)} {device_type}: loss={loss:.6f} grad_norm={gnorm:.6e} step_s={step_s:.3f} "
               f"({'the first call: the warm-up, then the capture' if args.cuda else 'eager'})")

    # (b) save on this mesh, restore onto (world / 2, 2)
    ck = Checkpointer(os.path.join(work, "ckpt"))
    t0 = time.perf_counter()
    ck.save(1, {"params": p, "opt": o})
    dist.barrier()
    save_s = time.perf_counter() - t0
    mesh22 = make_local_mesh(model=2, device_type=device_type)
    plan22 = st.make_train_step(cfg, mesh22, shape, opt_cfg, device=device)
    t0 = time.perf_counter()
    state, step_no = ck.restore({"params": plan22.args[0], "opt": plan22.args[1]}, device=device,
                                shardings={"params": plan22.in_shardings[0], "opt": plan22.in_shardings[1]})
    restore_s = time.perf_counter() - t0
    bad = []
    for tree, ref in ((state["params"], p), (state["opt"]["m"], o["m"]), (state["opt"]["v"], o["v"])):
        for k in ref:
            if not torch.equal(_whole(tree[k]), _whole(ref[k])):
                bad.append(k)
    if bad:
        raise AssertionError(f"(b) restored onto {tuple(mesh22.shape)}: {len(bad)} leaves differ, e.g. {bad[:3]}")
    _say(rank, f"(b) saved on {tuple(mesh.shape)} (step {step_no}, {save_s:.1f} s) and restored onto "
               f"{tuple(mesh22.shape)} ({restore_s:.1f} s): every parameter and moment leaf bit for bit")
    del state, p, o, plan, plan22, batch
    if args.cuda:
        torch.cuda.empty_cache()
    dist.barrier()

    # (a), continued: the same step on one device, rank 0 alone
    verdict = [None]
    if rank == 0:
        one = st.make_train_step(cfg, None, shape, opt_cfg, device=device)
        p1, o1 = _state(cfg, one, opt_cfg, device)
        for k, v in p1.items():
            if not torch.equal(v.cpu(), init[k]):
                raise AssertionError(f"(a) the sharded init's {k} differs from the one-device init")
        _, _, met1 = one.jitted()(p1, o1, next(_batch(cfg, shape, one, device)))
        loss1, gnorm1 = float(met1["loss"]), float(met1["grad_norm"])
        upd = {k: _rel(after[k] - init[k], v.cpu() - init[k]) for k, v in p1.items()}
        grad = {k: _rel(moment[k], v.cpu()) for k, v in o1["m"].items()}
        worst, gworst = max(upd, key=upd.get), max(grad, key=grad.get)
        norms = {k: v for k, v in grad.items() if p1[k].dim() == 1}
        nworst = max(norms, key=norms.get)
        print(f"(a) the fp32 norm leaves ({len(norms)}): grad rel_l2 max {norms[nworst]:.3e} ({nworst}), median "
              f"{statistics.median(norms.values()):.3e}", flush=True)
        print(f"(a) one device: loss={loss1:.6f} grad_norm={gnorm1:.6e}; sharded vs one device: loss rel "
              f"{abs(loss - loss1) / abs(loss1):.3e} (tol {LOSS_TOL}), grad_norm rel {abs(gnorm - gnorm1) / gnorm1:.3e} "
              f"(tol {GNORM_TOL}), grad rel_l2 max {grad[gworst]:.3e} ({gworst}; tol {GRAD_TOL}), median "
              f"{statistics.median(grad.values()):.3e}, update rel_l2 max {upd[worst]:.3e} ({worst}; tol "
              f"{UPDATE_TOL}), median {statistics.median(upd.values()):.3e}", flush=True)
        if abs(loss - loss1) > LOSS_TOL * abs(loss1) or abs(gnorm - gnorm1) > GNORM_TOL * gnorm1 \
                or grad[gworst] > GRAD_TOL or upd[worst] > UPDATE_TOL:
            verdict[0] = "(a) the sharded step disagrees with one device"
        del p1, o1, one
        if args.cuda:
            torch.cuda.empty_cache()
    _all_raise(verdict)


# torch.distributed's functions and the c10d operators they reach (the
# names a captured call records, ``core/executors/captured.py``)
C10D = {"all_gather_into_tensor": "_allgather_base_", "reduce_scatter_tensor": "_reduce_scatter_base_",
        "all_reduce": "allreduce_", "all_to_all_single": "alltoall_base_"}
CAPTURE_TOL = 1e-3  # (c) with --check-capture: relative L2, captured against eager (chip_smoke.py's phase 8b)


class _Calls:
    """Counts the calls of ``torch.distributed``'s collectives while it is
    entered, from any thread (the backward's run on autograd's), by the
    c10d operator each reaches."""

    def __enter__(self):
        self.counts, self.saved = {}, {name: getattr(dist, name) for name in C10D}
        for name, fn in self.saved.items():
            setattr(dist, name, self._wrap(C10D[name], fn))
        return self

    def _wrap(self, op, fn):
        def call(*a, **kw):
            self.counts[op] = self.counts.get(op, 0) + 1
            return fn(*a, **kw)

        return call

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(dist, name, fn)


def _capture_check(rank, plan, step, p, o, batch):
    """The captured step's first call (its warm-up updates the state, then
    the capture), the seeded state put back, a graph replay, and one eager
    step (``plan.fn``) from the same state on the same batch: every
    parameter block, the loss and the grad norm within ``CAPTURE_TOL``
    relative L2 on every rank, and the collectives the first call recorded
    (``step.sequence``, checked on every rank before the capture) counted
    by operator equal to those the eager step called, reduce-scatters among
    them.  Returns the replay's metrics and the first call's seconds."""
    from repro_torch.core.executors.captured import _clone
    from repro_torch.launch.sharding import local
    from repro_torch.tree import tree_map

    p0, o0 = tree_map(_clone, p), tree_map(_clone, o)  # this rank's blocks, in their placements
    t0 = time.perf_counter()
    _, _, first = step(p, o, batch)
    float(first["loss"])  # the host waits for the step
    first_s = time.perf_counter() - t0
    with torch.no_grad():
        tree_map(lambda x, y: local(x).copy_(local(y)) if torch.is_tensor(x) else None, (p, o), (p0, o0))
    _, _, met = step(p, o, batch)
    with _Calls() as calls:
        _, _, me = plan.fn(p0, o0, batch)
    seq = {}
    for op, _, _ in step.sequence:
        seq[op.split(".")[0]] = seq.get(op.split(".")[0], 0) + 1
    rel = max(_rel(local(p[k]), local(p0[k])) for k in p)
    loss = abs(float(met["loss"]) - float(me["loss"])) / abs(float(me["loss"]))
    gnorm = abs(float(met["grad_norm"]) - float(me["grad_norm"])) / abs(float(me["grad_norm"]))
    rows = [None] * dist.get_world_size()
    dist.all_gather_object(rows, (rank, seq, calls.counts, rel, loss, gnorm))
    for r, sq, eager, rl, ls, gn in rows:
        _say(rank, f"(c) rank {r} a replay vs eager from the same state: param rel_l2 max {rl:.3e}, loss rel {ls:.3e}, "
                   f"grad_norm rel {gn:.3e} (tol {CAPTURE_TOL}); recorded collectives {dict(sorted(sq.items()))}, "
                   f"the eager step's {dict(sorted(eager.items()))}")
    bad = [r for r, sq, eager, rl, ls, gn in rows
           if sq != eager or not sq.get("_reduce_scatter_base_") or not max(rl, ls, gn) <= CAPTURE_TOL]
    _all_raise([f"(c) ranks {bad}: the captured step's check failed" if bad else None])
    return met, first_s


def part_c(args, rank, world, device, device_type, mesh):
    from repro_torch import optim
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import roofline
    from repro_torch.launch import steps as st
    from repro_torch.launch.sharding import local

    cfg = _cfg(args)
    if args.train_layers:
        cfg = dataclasses.replace(cfg, n_layers=_depth(cfg, args.train_layers))
    shape = ShapeConfig("train", args.seq, args.batch, "train")
    opt_cfg = optim.AdamWConfig(lr=optim.warmup_cosine(3e-4, 2, args.steps), clip_norm=0.0,
                                state_dtype=cfg.optim_state_dtype)
    plan = st.make_train_step(cfg, mesh, shape, opt_cfg, device=device)
    if args.cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    p, o = _state(cfg, plan, opt_cfg, device)
    if args.cuda:
        torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    state_gb = sum(local(x).numel() * local(x).element_size() for t in (p, o["m"], o["v"]) for x in t.values()) / 1e9
    batches = _batch(cfg, shape, plan, device)
    step = plan.jitted()
    times, losses = [], []
    for i in range(args.steps):
        if i == 0 or not args.check_capture:  # the check trains on its first batch again
            batch = next(batches)
        dist.barrier()
        t0 = time.perf_counter()
        if i == 0 and args.check_capture:
            met, dt = _capture_check(rank, plan, step, p, o, batch)
        else:
            _, _, met = step(p, o, batch)
            float(met["loss"])  # the host waits for the step
            dt = time.perf_counter() - t0
        loss = float(met["loss"])
        times.append(dt)
        losses.append(loss)
        if not torch.isfinite(torch.tensor(loss)):
            raise AssertionError(f"(c) step {i}: loss {loss}")
    peak = torch.cuda.max_memory_allocated() / 1e9 if args.cuda else float("nan")
    peaks, counts = [None] * world, [None] * world
    dist.all_gather_object(peaks, peak)
    dist.all_gather_object(counts, (step.compiles, step.graph_replays))
    ms = statistics.median(times[1:] if len(times) > 1 else times) * 1e3
    tokens = shape.global_batch * shape.seq_len
    flops = roofline.model_flops(cfg, shape)
    _say(rank, f"(c) {cfg.name} {cfg.n_layers} layers, B={shape.global_batch} S={shape.seq_len}, mesh "
               f"{tuple(mesh.shape)} {device_type}: init_s={init_s:.1f}, state {state_gb:.2f} GB a rank; "
               f"step ms first={times[0] * 1e3:.1f} (the warm-up and the capture) median of the rest={ms:.1f}; "
               f"tokens_per_s={tokens / ms * 1e3:.1f}; "
               f"MFU={flops / (ms / 1e3) / (world * H100_BF16_FLOPS):.4f} (model_flops {flops:.4e}); "
               f"peak GB by rank {[round(x, 2) for x in peaks]}; (compiles, graph_replays) by rank {counts}; "
               f"losses {[round(x, 4) for x in losses]}")
    want = (1, (args.steps - 1 + args.check_capture) if args.cuda else 0)  # the check replays once more
    if any(c != want for c in counts):
        raise AssertionError(f"(c) compiles and graph replays {counts}, want {want} on every rank")
    if args.cuda and max(peaks) >= 80:
        raise AssertionError(f"(c) peak {max(peaks):.2f} GB")
    half = len(losses) // 2
    if args.check_capture and not sum(losses[-half:]) / half < sum(losses[:half]) / half:
        raise AssertionError(f"(c) the loss did not fall: {losses}")


def _decode(args, rank, cfg, device, device_type, mesh, check: bool):
    """The serving plans on ``mesh``: a prefill into a cache of
    ``DECODE_SHAPE``, then ``--decode`` greedy steps; with ``check``, the
    same steps on one device (rank 0), fed the same tokens."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import sharding as sh
    from repro_torch.launch import steps as st
    from repro_torch.models import build_model
    from repro_torch.tree import tree_map

    (prompt_len, T), B = DECODE_SHAPE[device_type], args.batch
    pre = st.make_prefill_step(cfg, mesh, ShapeConfig("prefill", T, B, "prefill"), device=device)
    dec = st.make_decode_step(cfg, mesh, ShapeConfig("decode", T, B, "decode"), device=device)
    split = mesh.size() > 1
    p_shard, b_shard, c_shard = pre.in_shardings
    place = st.place_params if split else (lambda t, s: t)
    # this rank's blocks of the seeded serving weights, each leaf drawn whole and cut
    blocks = build_model(cfg, seed=0, device=device, shardings=p_shard if split else None).train_params()
    params = {k: sh.place(v.detach(), p_shard[k], tuple(pre.args[0][k].shape)) if split else v.detach()
              for k, v in blocks.items()}
    del blocks
    cache = place(tree_map(lambda c: torch.zeros(c.shape, dtype=c.dtype, device=device), st.cache_specs(cfg, B, T)),
                  c_shard)
    gen = torch.Generator().manual_seed(10)
    prompt = torch.randint(0, cfg.vocab, (B, prompt_len), generator=gen, dtype=torch.int32)
    prefill = pre.jitted()
    t0 = time.perf_counter()
    logits, cache = prefill(params, place({"tokens": prompt.to(device)}, b_shard), cache)
    first = _whole(logits).float().cpu()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    tree_map(lambda c: sh.local(c).zero_(), cache)  # the recurrent states start from zero again
    if args.cuda:
        torch.cuda.synchronize()
    dist.barrier()
    t0 = time.perf_counter()
    logits, cache = prefill(params, place({"tokens": prompt.to(device)}, b_shard), cache)
    again = _whole(logits).float().cpu()
    prefill_replay_ms = (time.perf_counter() - t0) * 1e3
    step = dec.jitted()
    tok = again.argmax(-1, keepdim=True).to(torch.int32)
    toks, seq, times = [tok], [again], []
    for i in range(args.decode):
        pos = torch.tensor(prompt_len + i, dtype=torch.int32, device=device)
        if args.cuda:
            torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        logits, cache = step(params, cache, place({"tokens": tok.to(device)}, dec.in_shardings[2]), pos)
        full = _whole(logits).float().cpu()  # the host waits for the step
        times.append(time.perf_counter() - t0)
        seq.append(full)
        tok = full.argmax(-1, keepdim=True).to(torch.int32)
        toks.append(tok)
    peak = torch.cuda.max_memory_allocated() / 1e9 if args.cuda else float("nan")
    # a rank's block of the first KV cache and of the first recurrent state
    leaves = {k: t for c in cache["layers"] + [cache.get("shared", {})] for k, t in c.items()}
    block = {k: tuple(sh.local(leaves[k]).shape) for k in ("k", "ssm", "wkv") if k in leaves}
    ms = statistics.median(times[1:] if len(times) > 1 else times) * 1e3
    counts = [None] * dist.get_world_size()
    dist.all_gather_object(counts, (prefill.compiles, prefill.graph_replays, step.compiles, step.graph_replays))
    _say(rank, f"(d) {cfg.name} {cfg.n_layers} layers, serving, {str(cfg.compute_dtype).split('.')[-1]}, mesh "
               f"{tuple(mesh.shape)} {device_type}: B={B} max_seq={T} prompt={prompt_len}; prefill ms first call="
               f"{prefill_ms:.1f} second={prefill_replay_ms:.3f} (rel_l2 between them {_rel(again, first):.3e}); decode ms a step first={times[0] * 1e3:.2f} median "
               f"of the rest={ms:.3f} ({args.decode} steps); (prefill compiles, graph_replays, decode compiles, "
               f"graph_replays) by rank {counts}; a rank's cache blocks {block}; peak GB rank 0 {peak:.2f}")
    verdict = [None]
    want = (1, int(args.cuda), 1, (args.decode - 1) if args.cuda else 0)
    if any(c != want for c in counts):
        verdict[0] = f"(d) compiles and graph replays {counts}, want {want} on every rank"
    _all_raise(verdict)
    del params, cache, pre, dec, step, prefill
    if args.cuda:
        torch.cuda.empty_cache()
    dist.barrier()
    if not check:
        return
    verdict = [None]
    if rank == 0:  # the same steps on one device, fed the same tokens
        one = build_model(cfg, seed=0, device=device)
        c1 = one.init_cache(B, T)
        with torch.no_grad():
            want = [one.prefill({"tokens": prompt.to(device)}, c1)[0].float().cpu()]
            for i in range(args.decode):
                want.append(one.decode_step(c1, {"tokens": toks[i].to(device)}, prompt_len + i)[0].float().cpu())
        rel = [_rel(a, b) for a, b in zip(seq, want)]
        print(f"(d) one device, the same tokens: logits rel_l2 by step max {max(rel):.3e} (tol {DECODE_TOL}), "
              f"first {rel[0]:.3e}, last {rel[-1]:.3e}", flush=True)
        if max(rel) > DECODE_TOL:
            verdict[0] = "(d) the sharded decode disagrees with one device"
        del one, c1
        if args.cuda:
            torch.cuda.empty_cache()
    _all_raise(verdict)


def part_d(args, rank, world, device, device_type, mesh):
    _decode(args, rank, _cfg(args), device, device_type, mesh, check=False)
    # the check: --layers (default 2) in float32 (module docstring)
    small = dataclasses.replace(_cfg(args), n_layers=_depth(_cfg(args), args.layers or 2),
                                compute_dtype=torch.float32, cache_dtype=torch.float32)
    _decode(args, rank, small, device, device_type, mesh, check=True)


def rank_main(rank: int, world: int, args, init: str) -> None:
    from repro_torch.core.executors import release_captured
    from repro_torch.launch.mesh import make_local_mesh

    device_type = "cuda" if args.cuda else "cpu"
    if args.cuda:
        torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group("nccl", device_id=torch.device("cuda", torch.cuda.current_device()))
    else:
        torch.set_num_threads(max(1, (os.cpu_count() or 2) // world))
        dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank, world_size=world)
    device = "cuda" if args.cuda else "cpu"
    try:
        if rank == 0 and args.cuda:
            print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                                 capture_output=True, text=True).stdout.strip())
            print(f"torch {torch.__version__}, NCCL {'.'.join(map(str, torch.cuda.nccl.version()))}", flush=True)
            print(subprocess.run(["nvidia-smi", "topo", "-m"], capture_output=True, text=True).stdout, flush=True)
        data, model = args.mesh if args.mesh else (world, 1)
        mesh = make_local_mesh(model=model, data=data, device_type=device_type)
        with tempfile.TemporaryDirectory() as tmp:
            work = [tmp]
            dist.broadcast_object_list(work)  # rank 0's directory: one checkpoint for every rank
            t0 = time.perf_counter()
            if args.layers:
                part_a_b(args, rank, world, device, device_type, mesh, work[0])
                _say(rank, f"(a, b) s={time.perf_counter() - t0:.1f}")
            t0 = time.perf_counter()
            if args.steps:
                part_c(args, rank, world, device, device_type, mesh)
                _say(rank, f"(c) s={time.perf_counter() - t0:.1f}")
            t0 = time.perf_counter()
            if args.decode:
                part_d(args, rank, world, device, device_type, mesh)
                _say(rank, f"(d) s={time.perf_counter() - t0:.1f}")
            dist.barrier()
    finally:
        release_captured()  # a graph holding NCCL collectives keeps their communicator: drop it first
        dist.destroy_process_group()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cuda", action="store_true", help="a torchrun job, one rank a card, over NCCL")
    ap.add_argument("--ranks", type=int, default=2, help="CPU ranks (without --cuda)")
    ap.add_argument("--arch", default="starcoder2-7b")
    ap.add_argument("--layers", type=int, default=2,
                    help="(a, b) and (d)'s check: the model's depth, in whole layer groups; 0 skips (a, b)")
    ap.add_argument("--train-layers", type=int, default=0,
                    help="(c): the depth, in whole layer groups (0: the configuration's)")
    ap.add_argument("--steps", type=int, default=None, help="(c): steps (0 skips it; default 8, CPU 3)")
    ap.add_argument("--batch", type=int, default=None, help="global batch (default 4)")
    ap.add_argument("--seq", type=int, default=None, help="sequence (default 4096, CPU 32)")
    ap.add_argument("--mesh", default=None, help="D,M: the (data, model) mesh (default: world,1)")
    ap.add_argument("--decode", type=int, default=0, help="(d): greedy decode steps (0 skips it)")
    ap.add_argument("--check-capture", action="store_true",
                    help="(c): the first step eager and captured from the same state, and the loss falling")
    args = ap.parse_args()
    args.mesh = tuple(int(x) for x in args.mesh.split(",")) if args.mesh else None
    args.batch = args.batch or 4
    args.seq = args.seq or (4096 if args.cuda else 32)
    args.steps = (8 if args.cuda else 3) if args.steps is None else args.steps
    if args.cuda:
        if "RANK" not in os.environ:
            raise SystemExit("--cuda runs under torchrun: torchrun --standalone --nproc-per-node N "
                             "examples/torch_train_sharded.py --cuda")
        rank_main(int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]), args, "")
        return
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(rank_main, args=(args.ranks, args, os.path.join(tmp, "init")), nprocs=args.ranks)


if __name__ == "__main__":
    main()
